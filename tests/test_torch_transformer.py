"""Parity of the port's Transformer with the JAX package's.

Weights come from the JAX init (a numpy seed) and reach the port through
``convert.params_from_jax``, so both packages run the same parameters.

- Cache-free logits across norm_type x mlp_style x {GQA, MHA} (plus a
  post-LN / LayerNorm / bias / learned-position variant) against
  ``Transformer.apply``.
- The paged slot path: ``init_paged_slot_cache``, two batched prefill
  rounds of 3 rows at different starts, then 8 greedy decode steps,
  against the JAX slot path run through its own reference bodies
  (``paged_attn_impl="einsum"``, ``paged_prefill_impl="blend"``).

Tolerance 1e-4 on logits: f32 on both sides, two layers of d_model 64,
differing only in summation order.  Greedy tokens must agree exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu.models import decode as jax_decode
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.models import decode as port_decode
from tensorflowonspark_tpu_torch.models import transformer as port_tf

ATOL = RTOL = 1e-4
BASE = dict(vocab_size=96, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq_len=64, dtype="float32", rope=True)


def _pair(seed, **kw):
    """(JAX model, JAX params, port model) sharing one seeded init."""
    cfg = dict(BASE, **kw)
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**cfg))
    params = jm.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    pm = port_tf.build_transformer(**cfg)
    pm.load_state_dict(convert.params_from_jax(params), strict=True)
    return jm, params, pm.eval()


@pytest.mark.parametrize("n_kv", [2, 4], ids=["gqa", "mha"])
@pytest.mark.parametrize("mlp_style", ["plain", "gated"])
@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_cache_free_logits_match_jax(norm_type, mlp_style, n_kv):
    jm, params, pm = _pair(0, n_kv_heads=n_kv, norm_type=norm_type,
                           mlp_style=mlp_style,
                           activation="silu" if mlp_style == "gated"
                           else "gelu_tanh")
    toks = np.random.RandomState(1).randint(0, 96, (2, 11))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = pm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_post_ln_bias_learned_positions_match_jax():
    jm, params, pm = _pair(1, n_kv_heads=2, norm_style="post",
                           use_bias=True, rope=False, ln_eps=1e-5,
                           activation="gelu_exact")
    toks = np.random.RandomState(2).randint(0, 96, (2, 9))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = pm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_apply_rope_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 3, 8).astype(np.float32)
    pos = rng.randint(0, 50, (2, 5))
    want = np.asarray(jax_tf.apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    got = port_tf.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_paged_slot_path_matches_jax_slot_path():
    jm, params, pm = _pair(4, n_kv_heads=2, norm_type="rmsnorm")
    n_slots, page, per_row = 3, 8, 4
    n_pages = n_slots * per_row + 1
    sink = n_pages - 1
    slot_model, jcache = jax_decode.init_paged_slot_cache(
        jm, n_slots, page, n_pages, paged_attn_impl="einsum",
        paged_prefill_impl="blend")
    _, pcache = port_decode.init_paged_slot_cache(pm, n_slots, page, n_pages)
    set_table = jax_decode._jitted_set_row_page_table(slot_model)
    width = 64 // page
    for row in range(n_slots):
        pages = list(range(row * per_row, (row + 1) * per_row))
        entries = pages + [sink] * (width - per_row)
        jcache = set_table(jcache, jnp.asarray(row, jnp.int32),
                           jnp.asarray(entries, jnp.int32))
        port_decode.set_row_page_table(pcache, row, entries)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 96, n).tolist() for n in (12, 15, 12)]
    prefill = jax_decode._jitted_slot_prefill_many(slot_model)
    # two rounds: fresh rows at start 0 with ragged chunks, then the rows
    # continue from different starts (5, 8, 3) in one batched dispatch
    cuts = (5, 8, 3)
    rounds = [[(r, prompts[r][:cuts[r]], 0) for r in range(n_slots)],
              [(r, prompts[r][cuts[r]:], cuts[r]) for r in range(n_slots)]]
    for entries in rounds:
        bucket = max(8, 1 << (max(len(c) for _, c, _ in entries)
                              - 1).bit_length())
        jargs = jax_decode.build_prefill_batch(entries, 4, bucket, n_slots)
        jlast, jcache = prefill(params, jcache, *jargs,
                                jnp.asarray(sink, jnp.int32))
        pargs = port_decode.build_prefill_batch(entries, 4, bucket, n_slots,
                                                "cpu")
        with torch.no_grad():
            plast = port_decode.slot_prefill_many(pm, pcache, *pargs, sink)
        np.testing.assert_allclose(plast.numpy()[:n_slots],
                                   np.asarray(jlast)[:n_slots],
                                   atol=ATOL, rtol=RTOL)
    assert pcache.cache_index.tolist() == [len(p) for p in prompts]

    @jax.jit
    def jstep(cache, toks):
        logits, mut = slot_model.apply({"params": params, "cache": cache},
                                       toks[:, None], mutable=["cache"])
        return logits[:, -1], mut["cache"]

    jtok = jnp.argmax(jlast[:n_slots], axis=-1)
    ptok = torch.argmax(plast[:n_slots], dim=-1)
    for _ in range(8):
        assert ptok.tolist() == np.asarray(jtok).tolist()
        jl, jcache = jstep(jcache, jtok)
        with torch.no_grad():
            pl = pm(ptok[:, None], pcache)[:, -1]
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=RTOL)
        jtok = jnp.argmax(jl, axis=-1)
        ptok = torch.argmax(pl, dim=-1)
    assert ptok.tolist() == np.asarray(jtok).tolist()


@pytest.mark.parametrize("top_k,top_p,min_p", [
    (0, 1.0, 0.0), (3, 1.0, 0.0), (0, 0.7, 0.0), (5, 0.9, 0.2),
    (2, 0.5, 0.5)])
def test_filter_top_k_p_matches_jax(top_k, top_p, min_p):
    # integer-valued logits make ties at the k-th / threshold value,
    # which both filters must keep together
    logits = np.random.RandomState(top_k).randint(
        -4, 5, (3, 24)).astype(np.float32)
    n = logits.shape[0]
    k = np.full(n, top_k, np.int32)
    p = np.full(n, top_p, np.float32)
    m = np.full(n, min_p, np.float32)
    want = np.asarray(jax_decode.filter_top_k_p(
        jnp.asarray(logits), jnp.asarray(k), jnp.asarray(p),
        jnp.asarray(m)))
    got = port_decode.filter_top_k_p(
        torch.from_numpy(logits), torch.from_numpy(k), torch.from_numpy(p),
        torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, want)


def test_unported_config_fields_raise():
    for kw in ({"num_experts": 2}, {"kv_dtype": "int8"},
               {"ring_attention_axis": "tp"},
               {"paged_attn_impl": "einsum"}, {"fused_ln": True}):
        with pytest.raises(NotImplementedError, match="not ported"):
            port_tf.build_transformer(**dict(BASE, **kw))
