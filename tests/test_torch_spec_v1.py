"""Speculation v1 in the port (``decode.slot_spec_round_greedy``) against
the JAX package's ``_jitted_slot_spec_round`` on the same weights and
caches.

A 2-layer f32 target and a 1-layer draft, seeded by the port and carried
to the JAX layout (``convert.params_to_jax``); both packages prefill
their dense slot caches from the same four prompts of different lengths
(rows at different offsets), then run rounds of k = 1, 3 and 4
proposals, with and without the on-device stop walk (``rems`` /
``eoss`` / ``eos_on``):

- ``t_next``, ``commit``, ``new_toks`` and, with the walk, ``n_del``,
  ``done`` and ``rems_new`` equal JAX's exactly, round after round (f32
  on both sides; a tie in an argmax would part them, and none occurs at
  these seeds), and both caches' indices advance to the same per-row
  committed length;
- with the target as its own draft every proposal is accepted (commit
  = k);
- the committed tokens equal the port's greedy ``generate`` of each
  prompt.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorflowonspark_tpu.models import decode as jax_decode
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.models import decode as port_decode
from tensorflowonspark_tpu_torch.models import transformer as port_tf

TARGET = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
              n_layers=2, d_ff=64, max_seq_len=48, dtype="float32",
              rope=True, attention_impl="dense")
DRAFT = dict(TARGET, d_model=16, n_heads=2, n_kv_heads=1, n_layers=1,
             d_ff=32)
PROMPTS = [[1, 2, 3, 1, 2, 3, 1, 2], [5, 4, 3], [9, 8, 7, 9, 8],
           [11, 12, 13, 14, 15, 16]]
ROUNDS = 3


def _pair(cfg, seed):
    pm = port_tf.build_transformer(**cfg)
    pm.reset_parameters(torch.Generator().manual_seed(seed))
    params = convert.params_to_jax(pm.state_dict())
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**cfg))
    return jm, params, pm.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def models():
    return _pair(TARGET, 3), _pair(DRAFT, 8)


def _entries():
    return [(r, p, 0) for r, p in enumerate(PROMPTS)]


def _jax_prefilled(jm, params):
    n = len(PROMPTS)
    slot_model, cache = jax_decode.init_slot_cache(jm, n)
    args = jax_decode.build_prefill_batch(_entries(), n, 8, n)
    last, cache = jax_decode._jitted_slot_prefill_many(slot_model)(
        params, cache, *args, 0)
    return slot_model, cache, jnp.argmax(last, axis=-1).astype(jnp.int32)


def _port_prefilled(pm):
    n = len(PROMPTS)
    _, cache = port_decode.init_slot_cache(pm, n, device="cpu")
    args = port_decode.build_prefill_batch(_entries(), n, 8, n, "cpu")
    with torch.no_grad():
        last = port_decode.slot_prefill_many(pm, cache, *args, 0)
    return cache, torch.argmax(last, dim=-1)


def _jax_index(cache):
    return np.asarray(jax_decode._first_named_leaf(cache, "cache_index"))


def _run_both(models, k, stop, self_draft=False):
    (jt, tparams, pt), (jd, dparams, pd) = models
    if self_draft:
        jd, dparams, pd = jt, tparams, pt
    st, jt_cache, jtoks = _jax_prefilled(jt, tparams)
    sd, jd_cache, _ = _jax_prefilled(jd, dparams)
    pt_cache, ptoks = _port_prefilled(pt)
    pd_cache, _ = _port_prefilled(pd)
    assert np.array_equal(np.asarray(jtoks), ptoks.numpy())
    spec = jax_decode._jitted_slot_spec_round(st, sd, k)
    n = len(PROMPTS)
    rems = np.array([2, 5, 9, 4], np.int32)
    eoss = np.zeros(n, np.int32)
    eos_on = np.array([False, True, True, False])
    rounds = []
    for _ in range(ROUNDS):
        if stop:
            got_j = spec(tparams, dparams, jt_cache, jd_cache, jtoks,
                         rems=jnp.asarray(rems), eoss=jnp.asarray(eoss),
                         eos_on=jnp.asarray(eos_on))
            *vals_j, jt_cache, jd_cache = got_j
            with torch.no_grad():
                *vals_p, pt_cache, pd_cache = \
                    port_decode.slot_spec_round_greedy(
                        pt, pd, pt_cache, pd_cache, ptoks,
                        rems=torch.from_numpy(rems),
                        eoss=torch.from_numpy(eoss),
                        eos_on=torch.from_numpy(eos_on), k=k)
            rems = np.array(vals_j[5])
        else:
            *vals_j, jt_cache, jd_cache = spec(tparams, dparams, jt_cache,
                                               jd_cache, jtoks)
            with torch.no_grad():
                *vals_p, pt_cache, pd_cache = \
                    port_decode.slot_spec_round_greedy(
                        pt, pd, pt_cache, pd_cache, ptoks, k=k)
        for name, vj, vp in zip(("new_toks", "t_next", "commit", "n_del",
                                 "done", "rems_new"), vals_j, vals_p):
            assert np.array_equal(np.asarray(vj), vp.numpy()), (k, name)
        assert np.array_equal(_jax_index(jt_cache),
                              pt_cache.cache_index.numpy())
        assert np.array_equal(pt_cache.cache_index.numpy(),
                              pd_cache.cache_index.numpy())
        rounds.append([v.numpy() for v in vals_p])
        jtoks, ptoks = vals_j[0], vals_p[0]
        if stop:
            # the next round's eos per row: the token a row is fed, so
            # the walk meets it within a round on some rows
            eoss = np.asarray(vals_j[1])[:, -1].astype(np.int32)
    return rounds


@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("stop", [False, True])
def test_round_equals_jax(models, k, stop):
    rounds = _run_both(models, k, stop)
    commits = np.stack([r[2] for r in rounds])
    assert commits.min() >= 1 and commits.max() <= k


def test_target_as_its_own_draft_accepts_every_proposal(models):
    for t_next, commit in ((r[1], r[2]) for r in
                           _run_both(models, 3, False, self_draft=True)):
        assert (commit == 3).all() and t_next.shape == (len(PROMPTS), 3)


@pytest.mark.parametrize("k", [3, 4])
def test_committed_tokens_equal_greedy_generate(models, k):
    (_, _, pt), (_, _, pd) = models
    pt_cache, toks = _port_prefilled(pt)
    pd_cache, _ = _port_prefilled(pd)
    committed = [[int(t)] for t in toks]
    want_new = 12
    with torch.no_grad():
        while min(len(c) for c in committed) < want_new:
            toks, t_next, commit, pt_cache, pd_cache = \
                port_decode.slot_spec_round_greedy(pt, pd, pt_cache,
                                                   pd_cache, toks, k=k)
            for r in range(len(PROMPTS)):
                committed[r] += t_next[r, :int(commit[r])].tolist()
    for r, prompt in enumerate(PROMPTS):
        want = port_decode.generate(pt, [prompt], want_new, device="cpu")
        assert committed[r][:want_new] == want[0, len(prompt):].tolist()
