"""The port's ``benchmarks`` builders against the JAX package's, on the
CPU.

The JAX builders read ``FLAGSHIP_LM_V2`` at call time, so the tests swap
it for a 2-layer, d_model 64, f32 config (``TINY``) and hand the same
dict to the port's builders as ``config=``; the port's model then loads
the JAX builder's parameters (``convert.params_from_jax``) before it is
quantised or served, so both packages run the same weights.

- every ``FLAGSHIP_*`` dict equals the JAX package's, key for key, and
  ``FLAGSHIP_QUANT_MATMUL`` is ``FLAGSHIP_QMM``'s shape; ``bf16_peak``
  knows the H100's forms and returns None for any other name;
- ``qmm_weight_bytes`` and ``prefill_chunk_write_bytes`` equal the JAX
  functions' for every mode, and ``qmm_weight_bytes`` equals the bytes
  of the leaf ``make_qmm_op`` builds;
- the read-path switches ("einsum", "blend") raise, and every builder
  needs CUDA unless the CPU is asked for;
- the decode step: greedy picks equal over 3 steps and each step's
  logits within 1e-4 (bf16 weights and int8 ones); the prefill chunk
  step: logits within 1e-4; the qmm op on JAX's operands: within 1e-2
  of the output's scale (int8 / int4) and 1e-3 (bf16);
- the engine burst (async, serial) and the spec burst (off, ngram):
  the same prompts and the same greedy tokens; every other burst: the
  same prompts and the same batcher arguments.
"""
import copy

import numpy as np
import pytest
import torch

import tensorflowonspark_tpu.benchmarks as jb
from tensorflowonspark_tpu_torch import benchmarks as pb
from tensorflowonspark_tpu_torch import convert, quantize, serve

TINY = dict(pb.FLAGSHIP_LM_V2, vocab_size=64, d_model=64, n_heads=4,
            n_kv_heads=2, n_layers=2, d_ff=128, dtype="float32")
STEP = dict(n_slots=4, page_size=8, max_seq=64, fill=20)
CHUNK = dict(n_slots=2, page_size=8, max_seq=64, fill=21, chunk=16)
BURST = dict(prompts=4, prompt_len=16, max_new=8, n_slots=2, max_seq=64)
ATTRS = ("n_slots", "read_chunk", "prefill_chunk", "prefill_rows", "engine",
         "pipeline_depth", "spec_mode", "draft_k", "kv_page_size",
         "_total_pages", "preempt_ms", "park_capacity",
         "long_prompt_threshold", "max_seq")
DICTS = ("FLAGSHIP_LM", "FLAGSHIP_LM_V2", "FLAGSHIP_DECODE", "FLAGSHIP_QMM",
         "FLAGSHIP_PREFILL_KERNEL", "FLAGSHIP_PREFILL", "FLAGSHIP_ENGINE",
         "FLAGSHIP_SPEC", "FLAGSHIP_MIGRATE", "FLAGSHIP_SCHED",
         "FLAGSHIP_WARM", "FLAGSHIP_JOB", "FLAGSHIP_LONG", "FLAGSHIP_BATCH",
         "FLAGSHIP_MU_DTYPE", "FLAGSHIP_OPTIMIZER")


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(jb, "FLAGSHIP_LM_V2", TINY)
    return TINY


def _with_jax_weights(monkeypatch, params, draft_params=None):
    """The port's builders seed their models, then take the JAX
    builder's parameters (the draft, seed 1, the JAX draft's)."""
    seeded = pb._seeded_lm

    def load(config, max_seq, dev, seed=0, **over):
        model = seeded(config, max_seq, dev, seed, **over)
        model.load_state_dict(convert.params_from_jax(
            params if seed == 0 else draft_params), strict=True)
        return model

    monkeypatch.setattr(pb, "_seeded_lm", load)


def _attrs(batcher):
    tier = getattr(batcher, "_host_tier", None)
    return {**{a: getattr(batcher, a, None) for a in ATTRS},
            "host_tier_bytes": tier and tier.capacity_bytes}


@pytest.mark.parametrize("name", DICTS)
def test_flagship_dicts_are_the_jax_packages(name):
    assert getattr(pb, name) == getattr(jb, name)


def test_quant_matmul_shape_is_the_qmm_segments_and_no_tpu_figure():
    assert pb.FLAGSHIP_QUANT_MATMUL == dict(K=2048, N=8192, decode_m=16,
                                            prefill_m=1024, group_size=128)
    q = pb.FLAGSHIP_QMM
    assert (q["in_dim"], q["out_dim"], q["rows"], q["group_size"]) == tuple(
        pb.FLAGSHIP_QUANT_MATMUL[k] for k in ("K", "N", "decode_m",
                                              "group_size"))
    assert not hasattr(pb, "ROUND1_LM_MFU")


def test_bf16_peak_knows_the_h100_forms_and_nothing_else():
    assert pb.bf16_peak("NVIDIA H100 80GB HBM3") == 989e12
    assert pb.bf16_peak("NVIDIA H100 PCIe") == 756e12
    assert pb.bf16_peak("NVIDIA H100 NVL") == 835e12
    for name in ("NVIDIA A100-SXM4-80GB", "TPU v5 lite", "cpu", ""):
        assert pb.bf16_peak(name) is None


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_qmm_weight_bytes_are_the_jax_packages_and_the_leafs(mode):
    for shape in ({}, dict(in_dim=300, out_dim=64, group_size=64),
                  dict(in_dim=4096, out_dim=1024, group_size=256)):
        assert pb.qmm_weight_bytes(mode, **shape) == jb.qmm_weight_bytes(
            mode, **shape)
    fn, x, w = pb.make_qmm_op(mode, device="cpu")
    if mode == "bf16":
        real = w.numel() * w.element_size()
    elif mode == "int8":
        real = w["q"].numel() + w["scale"].numel() * 4
    else:
        real = w.q.numel() + w.scale.numel() * 4
    assert real == pb.qmm_weight_bytes(mode)
    assert x.dtype == torch.bfloat16 and tuple(x.shape) == (16, 2048)
    y = fn(x[:2], w)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (2, 8192)
    with pytest.raises(ValueError, match="unknown qmm mode"):
        pb.qmm_weight_bytes("fp8")


@pytest.mark.parametrize("impl", ["kernel", "blend"])
def test_prefill_write_bytes_are_the_jax_packages(impl, monkeypatch):
    for shape in ({}, dict(n_slots=2, page_size=32, max_seq=1024, chunk=100)):
        assert pb.prefill_chunk_write_bytes(impl, **shape) == \
            jb.prefill_chunk_write_bytes(impl, **shape)
    monkeypatch.setattr(jb, "FLAGSHIP_LM_V2", TINY)
    shape = {k: v for k, v in CHUNK.items() if k != "fill"}
    assert pb.prefill_chunk_write_bytes(impl, config=TINY, **shape) == \
        jb.prefill_chunk_write_bytes(impl, **shape)


def test_read_path_switches_raise():
    with pytest.raises(ValueError, match="take no switch"):
        pb.make_decode_step("einsum", device="cpu", config=TINY, **STEP)
    with pytest.raises(ValueError, match="take no switch"):
        pb.make_prefill_chunk_step("blend", device="cpu", config=TINY,
                                   **CHUNK)
    with pytest.raises(ValueError, match="not in"):
        pb.make_decode_step("gather", device="cpu", config=TINY, **STEP)
    assert serve._NO_SWITCH


BUILDERS = ("make_decode_step", "make_prefill_chunk_step", "make_qmm_op",
            "make_prefill_burst", "make_engine_burst", "make_spec_burst",
            "make_migrate_pair", "make_sched_burst", "make_warm_burst",
            "make_job_burst", "make_long_burst")


@pytest.mark.parametrize("name", BUILDERS)
def test_builders_need_cuda_unless_the_cpu_is_asked_for(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(pb, name)()


def _jax_slot_logits(jax_cfg_kw, params, cache, toks, n_slots, page,
                     n_pages):
    """Logits of one JAX slot forward on a copy of ``cache``."""
    import jax
    import jax.numpy as jnp

    from tensorflowonspark_tpu.models import decode as jdecode
    from tensorflowonspark_tpu.models.transformer import (
        Transformer, TransformerConfig)

    slot_model, _ = jdecode.init_paged_slot_cache(
        Transformer(TransformerConfig(**jax_cfg_kw)), n_slots, page,
        n_pages)
    cache = jax.tree_util.tree_map(jnp.copy, cache)
    logits, _ = slot_model.apply({"params": params, "cache": cache},
                                 toks[:, None], mutable=["cache"])
    return np.asarray(logits[:, -1])


@pytest.mark.parametrize("quant", [None, "int8"])
def test_decode_step_matches_the_jax_step(tiny, monkeypatch, quant):
    step, params, cache, (toks, temps, seeds, ords) = jb.make_decode_step(
        quantize=quant, **STEP)
    if quant:
        # the port quantises the f32 masters itself: seed them as JAX's
        import jax
        import jax.numpy as jnp

        from tensorflowonspark_tpu.models.transformer import (
            Transformer, TransformerConfig)

        masters = Transformer(TransformerConfig(**dict(
            TINY, max_seq_len=STEP["max_seq"]))).init(
                jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
        _with_jax_weights(monkeypatch, masters)
    else:
        _with_jax_weights(monkeypatch, params)
    pstep, model, pcache, (ptoks, ptemps, pseeds, pords) = \
        pb.make_decode_step(quantize=quant, device="cpu", config=TINY,
                            **STEP)
    if quant:
        assert quantize.quantized_modes(model) == (quant,)
    assert pcache.cache_index.tolist() == [STEP["fill"]] * STEP["n_slots"]
    n_pages = pcache.pages_key[0].shape[0]
    cfg_kw = dict(TINY, max_seq_len=STEP["max_seq"])
    for _ in range(3):
        if not quant:
            want = _jax_slot_logits(cfg_kw, params, cache, toks,
                                    STEP["n_slots"], STEP["page_size"],
                                    n_pages)
            with torch.no_grad():
                got = model(ptoks.long()[:, None],
                            copy.deepcopy(pcache))[:, -1]
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4,
                                       rtol=0)
        toks, cache, ords = step(params, cache, toks, temps, seeds, ords)
        ptoks, pcache, pords = pstep(model, pcache, ptoks, ptemps, pseeds,
                                     pords)
        assert ptoks.tolist() == np.asarray(toks).tolist()
        assert pords.tolist() == np.asarray(ords).tolist()
    assert pcache.cache_index.tolist() == [STEP["fill"] + 3] * STEP[
        "n_slots"]


def test_prefill_chunk_step_matches_the_jax_step(tiny, monkeypatch):
    prefill, params, cache, args = jb.make_prefill_chunk_step(**CHUNK)
    _with_jax_weights(monkeypatch, params)
    pprefill, model, pcache, pargs = pb.make_prefill_chunk_step(
        device="cpu", config=TINY, **CHUNK)
    for a, b in zip(args[:4], pargs[:4]):
        assert np.asarray(a).tolist() == b.tolist()
    assert int(args[4]) == pargs[4]
    for _ in range(2):              # re-dispatch is idempotent
        logits, cache = prefill(params, cache, *args)
        plogits, pcache = pprefill(model, pcache, *pargs)
        np.testing.assert_allclose(plogits.numpy(), np.asarray(logits),
                                   atol=1e-4, rtol=0)
        assert pcache.cache_index.tolist() == [
            CHUNK["fill"] + CHUNK["chunk"]] * CHUNK["n_slots"]


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_qmm_op_on_the_jax_operands(mode):
    from tensorflowonspark_tpu import quantize as jquantize

    shape = dict(rows=4, in_dim=256, out_dim=384, group_size=64)
    jfn, jx, jw = jb.make_qmm_op(mode, **shape)
    want = np.asarray(jfn(jx, jw), np.float32)
    x = torch.from_numpy(np.asarray(jx, np.float32)).bfloat16()
    if mode == "bf16":
        w = torch.from_numpy(np.asarray(jw, np.float32)).bfloat16()
    elif mode == "int8":
        w = {k: torch.from_numpy(np.array(v)) for k, v in jw.items()}
    else:
        assert isinstance(jw, jquantize.Int4Weight)
        w = quantize.Int4Weight(torch.from_numpy(np.asarray(jw.q)),
                                torch.from_numpy(np.asarray(jw.scale)),
                                jw.in_dim, jw.group_size)
    fn, px, _ = pb.make_qmm_op(mode, device="cpu", **shape)
    assert px.shape == x.shape and px.dtype == x.dtype
    if mode != "bf16":
        # the port's store of JAX's f32 weight is JAX's store
        import jax
        import jax.numpy as jnp

        _, kw = jax.random.split(jax.random.key(0))
        wf = torch.from_numpy(np.asarray(jax.random.normal(
            kw, (256, 384), jnp.float32)))
        ours = (quantize.quantize_tree({"proj": {"kernel": wf}},
                                       min_elements=0)["proj"]["kernel"]
                if mode == "int8" else quantize.int4_pack(wf, 64))
        for a, b in ((ours["q"], w["q"]), (ours["scale"], w["scale"])) \
                if mode == "int8" else ((ours.q, w.q), (ours.scale, w.scale)):
            assert torch.equal(a, b)
    got = fn(x, w).float().numpy()
    scale = float(np.abs(want).max())
    tol = 1e-3 if mode == "bf16" else 1e-2
    assert np.abs(got - want).max() <= tol * scale


def _drain(batcher, prompts, max_new):
    try:
        handles = [batcher.submit(p, max_new) for p in prompts]
        return [list(h.result(timeout=300)) for h in handles]
    finally:
        batcher.stop()


@pytest.mark.parametrize("fn,kw", [
    ("make_engine_burst", dict(engine="async")),
    ("make_engine_burst", dict(engine="serial")),
    ("make_spec_burst", dict(mode="off")),
    ("make_spec_burst", dict(mode="ngram"))],
    ids=["engine-async", "engine-serial", "spec-off", "spec-ngram"])
def test_bursts_decode_the_jax_batchers_tokens(tiny, monkeypatch, fn, kw):
    jbat, jprompts, jmax = getattr(jb, fn)(**kw, **BURST)
    try:
        _with_jax_weights(monkeypatch, jbat.params)
        pbat, prompts, max_new = getattr(pb, fn)(device="cpu", config=TINY,
                                                 **kw, **BURST)
    except BaseException:
        jbat.stop()
        raise
    assert (prompts, max_new) == (jprompts, jmax)
    assert _attrs(pbat) == _attrs(jbat)
    want = _drain(jbat, jprompts, jmax)
    got = _drain(pbat, prompts, max_new)
    assert got == want
    if kw.get("mode") == "ngram":
        assert pbat.stats()["spec_rounds"] > 0


@pytest.mark.parametrize("fn,kw", [
    ("make_prefill_burst", {}), ("make_prefill_burst", dict(prefill_rows=1)),
    ("make_engine_burst", dict(quantize="int8")),
    ("make_spec_burst", dict(mode="model")),
    ("make_migrate_pair", {}),
    ("make_sched_burst", {}), ("make_sched_burst", dict(preempt=False)),
    ("make_warm_burst", {}), ("make_job_burst", {}),
    ("make_long_burst", {}), ("make_long_burst", dict(armed=False))])
def test_bursts_take_the_jax_batchers_arguments_and_prompts(tiny, fn, kw):
    j = getattr(jb, fn)(**kw)
    try:
        p = getattr(pb, fn)(device="cpu", config=TINY, **kw)
    except BaseException:
        for x in j:
            if hasattr(x, "stop"):
                x.stop()
        raise
    try:
        assert len(p) == len(j)
        for a, b in zip(j, p):
            if hasattr(a, "stop"):
                assert _attrs(b) == _attrs(a)
            else:
                assert b == a
        if fn == "make_long_burst":
            assert len(p[1]) == 32768 and p[0].max_seq == 32800
        if kw.get("quantize"):
            assert quantize.quantized_modes(p[0].model) == ("int8",)
        if kw.get("mode") == "model":
            assert p[0].draft_model.cfg.n_layers == 4
    finally:
        for x in (*j, *p):
            if hasattr(x, "stop"):
                x.stop()
