"""Speculative decoding in the port against the JAX package's spec v2
(``tests/test_spec_v2.py``).

A tiny f32 target LM and a smaller draft, seeded, in both packages'
layouts (``convert.params_to_jax``).  Greedy tokens equal exactly; the
sampled checks are statistical or self-consistency checks (the port's
counter-based noise cannot reproduce ``jax.random``'s bits):

- ``ngram_propose`` equals JAX's on the same random contexts (and on
  the JAX example), and is a pure function of the committed prefix;
- the rejection walk preserves the target's distribution (chi-square,
  df 7, alpha 0.001) for a point-mass and a model proposal, and keeps
  to a top-k filter;
- a mixed burst of greedy and sampled requests, model and n-gram mode,
  on the dense cache, the paged pool and the int8 paged pool: greedy
  rows equal the port's solo decode and JAX's (the same ``kv_dtype``),
  and the JAX batcher's n-gram burst; the spec counters move and k
  stays in range;
- the target as its own draft: every greedy proposal is accepted;
- a sampled burst is seed-deterministic and the same on the dense and
  paged caches and on the serial engine;
- LoRA rows verify under their adapter (n-gram and model drafts), equal
  to JAX solo decode over the merged weights;
- an injected verify fault falls back to plain steps, counted in
  ``spec_draft_fallbacks``, with the same greedy tokens;
- mode validation, and ``speculative_generate`` against ``generate``
  (and JAX's greedy decode).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import lora as jax_lora
from tensorflowonspark_tpu import serve as jax_serve
from tensorflowonspark_tpu.models import decode as jax_decode
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import convert, faults, serve
from tensorflowonspark_tpu_torch.models import decode as port_decode
from tensorflowonspark_tpu_torch.models import transformer as port_tf

TARGET = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
              n_layers=2, d_ff=64, max_seq_len=32, dtype="float32",
              rope=True, attention_impl="dense")
DRAFT = dict(TARGET, d_model=16, n_heads=2, n_kv_heads=1, n_layers=1,
             d_ff=32)
# greedy and sampled (temperature / top-k / top-p) requests; repeated
# spans give the n-gram draft matches; every one leaves draft_k=3 of
# verify headroom inside max_seq_len 32
BURST = [
    ([1, 2, 3, 1, 2, 3, 1, 2], 6, 0.0, 0, {}),
    ([5, 4, 3, 2, 1], 5, 0.0, 0, {}),
    ([9, 8, 7, 9, 8, 7], 6, 0.9, 13, {"top_k": 8}),
    ([2, 3, 2, 3, 2, 3], 5, 0.7, 5, {"top_p": 0.9}),
    (list(range(10, 22)), 4, 0.0, 0, {}),
    ([4, 5, 4, 5, 4], 6, 0.0, 0, {}),
    ([6, 6, 6, 6], 5, 0.9, 11, {}),
]
LAYOUTS = {"dense": {}, "paged": dict(kv_page_size=8, kv_pages=24),
           "paged_int8": dict(kv_page_size=8, kv_pages=24, kv_dtype="int8")}


def _pair(cfg, seed):
    """(JAX module, its numpy parameters, the port's model): seeded
    weights drawn by the port, carried to the JAX layout (``flax.init``
    would compile a program per config)."""
    pm = port_tf.build_transformer(**cfg)
    pm.reset_parameters(torch.Generator().manual_seed(seed))
    params = convert.params_to_jax(pm.state_dict())
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**cfg))
    return jm, params, pm.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def lm():
    return _pair(TARGET, 0)


@pytest.fixture(scope="module")
def draft_lm():
    return _pair(DRAFT, 9)


def _jax_solo(jm, params, prompt, n_new, **kw):
    out = jax_decode.generate(jm, params, jnp.asarray([prompt], jnp.int32),
                              max_new_tokens=n_new, loop="host", **kw)
    return np.asarray(out)[0].tolist()


def _burst(pm, mode, draft=None, draft_k=3, requests=BURST, **kw):
    b = serve.ContinuousBatcher(
        pm, n_slots=4, read_chunk=2, prefill_chunk=8, spec_draft=mode,
        draft_model=draft if mode == "model" else None, draft_k=draft_k,
        device="cpu", **kw)
    try:
        hs = [b.submit(p, n, temperature=t, seed=s, **extra)
              for p, n, t, s, extra in requests]
        return [h.result(timeout=300) for h in hs], b.stats()
    finally:
        b.stop()


def test_ngram_propose_matches_jax():
    rs = np.random.RandomState(0)
    for _ in range(4):
        n, C = 4, 24
        ctx = rs.randint(0, 5, (n, C)).astype(np.int32)
        ln = rs.randint(0, C + 1, n).astype(np.int32)
        want = np.asarray(jax_decode.ngram_propose(jnp.asarray(ctx),
                                                   jnp.asarray(ln), 4))
        got = port_decode.ngram_propose(torch.from_numpy(ctx),
                                        torch.from_numpy(ln), 4)
        assert np.array_equal(got.numpy(), want)
    ctx = torch.zeros((2, 16), dtype=torch.int64)
    ctx[0, :5] = torch.tensor([5, 6, 7, 5, 6])
    ctx[1, :4] = torch.tensor([11, 12, 13, 14])
    props = port_decode.ngram_propose(ctx, torch.tensor([5, 4]), 2)
    assert props.tolist() == [[7, 5], [14, 14]]


def test_ngram_propose_is_prefix_pure():
    ctx = torch.zeros((1, 17), dtype=torch.int64)     # 16 + spare column
    ctx[0, :7] = torch.tensor([3, 1, 4, 1, 5, 3, 1])
    ln = torch.tensor([7])
    once = port_decode.ngram_propose(ctx[:, :-1], ln, 3).tolist()
    first = port_decode.ngram_propose(ctx[:, :-1], ln, 1)
    ln2 = port_decode.ngram_append(ctx, ln, first, torch.tensor([1]))
    rest = port_decode.ngram_propose(ctx[:, :-1], ln2, 2).tolist()
    assert once[0] == first.tolist()[0] + rest[0]


@pytest.mark.parametrize("draft", ["point_mass", "model"])
def test_rejection_sampling_preserves_distribution(draft):
    V, n = 8, 4096
    rng = np.random.default_rng(0)
    p_log = torch.tensor(rng.normal(size=V), dtype=torch.float32)
    temps = torch.full((n,), 0.8)
    seeds, ords = torch.arange(n), torch.zeros(n, dtype=torch.int64)
    t_logits = p_log.expand(n, 1, V)
    if draft == "point_mass":
        props = torch.full((n, 1), int(p_log.argmax()))
        q_logits = None
    else:
        q_log = torch.tensor(rng.normal(size=V), dtype=torch.float32) / 0.8
        q = torch.softmax(q_log, -1).numpy().astype(np.float64)
        props = torch.from_numpy(rng.choice(V, size=(n, 1), p=q / q.sum()))
        q_logits = q_log.expand(n, 1, V)
    c_tok, commit = port_decode.spec_accept_sampled(
        t_logits, props, temps, seeds, ords, q_logits=q_logits)
    assert commit.tolist() == [1] * n
    obs = np.bincount(c_tok[:, 0].numpy(), minlength=V)
    exp = torch.softmax(p_log / 0.8, -1).numpy() * n
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    assert chi2 < 24.32, chi2       # df=7 critical at alpha=0.001


def test_rejection_sampling_respects_top_k_filter():
    V, n = 8, 512
    p_log = torch.tensor([2.0, 1.5, 0.0, -1.0, 0.5, -0.5, 0.2, -2.0])
    c_tok, _ = port_decode.spec_accept_sampled(
        p_log.expand(n, 1, V), torch.full((n, 1), 7), torch.ones(n),
        torch.arange(n), torch.zeros(n, dtype=torch.int64),
        topks=torch.full((n,), 2), topps=torch.ones(n),
        minps=torch.zeros(n))
    assert set(c_tok[:, 0].tolist()) <= {0, 1}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("mode", ["ngram", "model"])
def test_greedy_parity_mixed_burst(lm, draft_lm, mode, layout):
    jm, params, pm = lm
    kw = LAYOUTS[layout]
    outs, st = _burst(pm, mode, draft_lm[2], **kw)
    kv = kw.get("kv_dtype")
    for (p, n, t, s, extra), got in zip(BURST, outs):
        if t == 0.0:                # greedy rows: byte-identical to solo
            assert got == port_decode.generate(
                pm, [p], n, device="cpu", kv_dtype=kv)[0].tolist()
            assert got == _jax_solo(jm, params, p, n, kv_dtype=kv)
        else:
            assert len(got) == len(p) + n
    assert st["spec_mode"] == mode and st["spec_rounds"] > 0
    assert st["spec_tokens_proposed"] >= st["spec_tokens_accepted"] > 0
    assert 0.0 < st["spec_accept_rate"] <= 1.0
    assert 1 <= st["spec_k_current"] <= 3
    assert 1.0 <= st["spec_k_mean"] <= 3.0
    if layout == "dense" and mode == "ngram":
        # the JAX batcher speculating on the greedy rows
        jb = jax_serve.ContinuousBatcher(jm, params, n_slots=4, read_chunk=2,
                                         prefill_chunk=8, spec_draft="ngram",
                                         draft_k=3)
        greedy = [(r, g) for r, g in zip(BURST, outs) if r[2] == 0.0]
        try:
            want = [h.result(timeout=300) for h in
                    [jb.submit(r[0], r[1]) for r, _ in greedy]]
        finally:
            jb.stop()
        assert [g for _, g in greedy] == want


def test_target_as_its_own_draft_accepts_every_greedy_proposal(lm):
    _, _, pm = lm
    n, k = 2, 3
    _, cache = port_decode.init_slot_cache(pm, n, device="cpu")
    _, d_cache = port_decode.init_slot_cache(pm, n, device="cpu")
    prompt = torch.tensor([[1, 2, 3, 4], [9, 8, 7, 6]])
    rows = torch.arange(n)
    z, four = torch.zeros(n, dtype=torch.int32), torch.full((n,), 4,
                                                            dtype=torch.int32)
    with torch.no_grad():
        toks = port_decode.slot_prefill_many(pm, cache, prompt, rows, z,
                                             four, 0).argmax(-1)
        port_decode.slot_prefill_many(pm, d_cache, prompt, rows, z, four, 0)
        zeros = torch.zeros(n, dtype=torch.int64)
        ords, rems = torch.ones(n, dtype=torch.int64), torch.full((n,), 20)
        for _ in range(4):
            toks, _, commit, n_del, _, rems, ords, _ = port_decode.spec_round(
                pm, cache, toks, torch.zeros(n), zeros, ords, rems, zeros,
                torch.zeros(n, dtype=torch.bool), k, draft=pm,
                d_cache=d_cache, sampled=False)
            assert commit.tolist() == [k] * n
    assert cache.cache_index.tolist() == [4 + 4 * k] * n


def test_sampled_spec_is_seed_deterministic_and_layout_invariant(lm):
    _, _, pm = lm
    outs1, _ = _burst(pm, "ngram")
    outs2, _ = _burst(pm, "ngram")
    outs3, _ = _burst(pm, "ngram", **LAYOUTS["paged"])
    outs4, st = _burst(pm, "ngram", engine="serial", **LAYOUTS["paged"])
    assert outs1 == outs2 == outs3 == outs4
    assert st["engine"] == "serial" and st["spec_rounds"] > 0


@pytest.mark.parametrize("mode", ["ngram", "model"])
def test_lora_rows_verify_under_their_adapter(lm, draft_lm, mode):
    jm, params, pm = lm
    ad = jax_lora.init(jax.random.key(3), params, rank=4)
    rs = np.random.RandomState(103)
    ad = {p: {"a": np.asarray(v["a"]),
              "b": rs.randn(*v["b"].shape).astype(np.float32)}
          for p, v in ad.items()}
    b = serve.ContinuousBatcher(
        pm, n_slots=2, read_chunk=1, prefill_chunk=8, lora_rank=4,
        spec_draft=mode, draft_model=draft_lm[2] if mode == "model" else None,
        draft_k=3, device="cpu")
    prompt = [1, 2, 3, 1, 2, 3]
    try:
        b.register_adapter("a", ad, scale=0.5)
        adapted = b.submit(prompt, 6, adapter="a").result(timeout=300)
        base = b.submit(prompt, 6).result(timeout=300)
        st = b.stats()
    finally:
        b.stop()
    assert st["spec_rounds"] > 0
    assert adapted == _jax_solo(jm, jax_lora.merge(params, ad, 0.5),
                                prompt, 6)
    assert base == _jax_solo(jm, params, prompt, 6)
    assert adapted != base


def test_verify_fault_falls_back_to_plain_steps(lm):
    _, _, pm = lm
    greedy = [r for r in BURST if r[2] == 0.0]
    want, _ = _burst(pm, "off", requests=greedy)
    plan = faults.FaultPlan(0).on("serve.spec_verify", kind="oserror",
                                  nth=1, times=3)
    with faults.active(plan):
        got, st = _burst(pm, "ngram", requests=greedy)
    assert got == want
    assert st["spec_draft_fallbacks"] == 3 and st["spec_rounds"] > 0


def test_spec_mode_validation(lm, draft_lm):
    _, _, pm = lm
    draft = draft_lm[2]
    with pytest.raises(ValueError, match="requires a draft model"):
        serve.ContinuousBatcher(pm, n_slots=2, spec_draft="model",
                                device="cpu")
    with pytest.raises(ValueError, match="model-free"):
        serve.ContinuousBatcher(pm, n_slots=2, spec_draft="ngram",
                                draft_model=draft, device="cpu")
    with pytest.raises(ValueError, match="not in"):
        serve.ContinuousBatcher(pm, n_slots=2, spec_draft="bogus",
                                device="cpu")
    with pytest.raises(ValueError, match="draft_k"):
        serve.ContinuousBatcher(pm, n_slots=2, spec_draft="ngram",
                                draft_k=0, device="cpu")
    outs, st = _burst(pm, "off", draft, requests=BURST[:2])
    assert st["spec_mode"] == "off" and st["spec_rounds"] == 0
    for args in (["--spec_draft", "model"],
                 ["--spec_draft", "ngram", "--draft_export_dir", "d"]):
        a = serve.build_argparser().parse_args(
            ["--export_dir", "unused", "--device", "cpu", *args])
        with pytest.raises(ValueError, match="spec_draft"):
            serve.make_server(a)


def test_speculative_generate_equals_generate(lm, draft_lm):
    jm, params, pm = lm
    prompt = [[1, 2, 3, 1, 2], [7, 7, 8, 9, 10]]
    want = port_decode.generate(pm, prompt, 9, device="cpu")
    for draft, k in ((draft_lm[2], 3), (pm, 4)):
        got = port_decode.speculative_generate(pm, draft, prompt, 9, k=k,
                                               device="cpu")
        assert torch.equal(got, want)
    assert want[:, 5:].tolist() == [
        _jax_solo(jm, params, p, 9)[5:] for p in prompt]
