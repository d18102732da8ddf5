"""The port's serving engines against the JAX package's ContinuousBatcher.

A tiny f32 LM (2 layers, d_model 64, 4 heads, 2 kv heads, max_seq_len
256) is initialised by the JAX package from a seed and carried to the
port by ``convert.params_from_jax``.  A mixed-length burst of prompts
(from ``np.random.RandomState``, more prompts than slots) runs through
the JAX ContinuousBatcher on the CPU and through the port's with
``device="cpu"`` (the plain versions of its kernels).  Tolerance: greedy
f32 tokens equal exactly.

- the dense slot cache (``kv_page_size 0``), f32 and int8 kv: the port's
  async engine against the JAX dense batcher (async);
- the paged cache: the port's async engine against the JAX async engine;
- async against serial in the port on a burst of greedy and seeded
  sampled rows (filtered and not): equal element by element, dense and
  paged;
- ``pipeline_depth`` floors at 1, the pipeline keeps more than one step
  in flight, and the readback goes through host buffers (no copy of the
  token plane per step);
- a mid-flight cancellation drains and returns every page;
- a fault injected in the device thread fails every handle, queued,
  in flight and mid-admission, and later submits raise.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import serve as jax_serve
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import convert, faults, serve
from tensorflowonspark_tpu_torch.models import decode as port_decode
from tensorflowonspark_tpu_torch.models import transformer as port_tf

CFG = dict(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=128, max_seq_len=256, dtype="float32", rope=True,
           norm_type="rmsnorm")
_rs = np.random.RandomState(3)
PROMPTS = [_rs.randint(0, 64, n).tolist() for n in (5, 19, 40, 11, 27)]
MAX_NEW = 6
# 4 slots for 5 prompts: one waits for a row; chunks of 16 tokens
ENGINE = dict(n_slots=4, read_chunk=4, prefill_chunk=16, prefill_rows=2)
PAGED = dict(kv_page_size=8, kv_pages=40)


@pytest.fixture(scope="module")
def lm():
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**CFG))
    params = jm.init(jax.random.key(5), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    pm = port_tf.build_transformer(**CFG)
    pm.load_state_dict(convert.params_from_jax(params), strict=True)
    pm.eval().requires_grad_(False)
    return jm, params, pm


def _burst(batcher, prompts=PROMPTS, kws=None):
    kws = kws or [{}] * len(prompts)
    handles = [batcher.submit(p, MAX_NEW, **kw) for p, kw in zip(prompts, kws)]
    return [h.result(timeout=300) for h in handles]


def _jax_burst(lm, **kw):
    jm, params, _ = lm
    b = jax_serve.ContinuousBatcher(jm, params, **ENGINE, **kw)
    try:
        return _burst(b), b.stats()
    finally:
        b.stop()


def _port(lm, **kw):
    return serve.ContinuousBatcher(lm[2], device="cpu", **dict(ENGINE, **kw))


def _pool_conserved(b):
    """free + cached (refcount 0) + rows' own pages is the whole pool."""
    free = list(b._free_pages)
    cached = list(b._prefix.values())
    owned = [p for rp in b._row_pages if rp for p in rp
             if p not in b._page_rc]
    assert len(set(free)) == len(free) and b._sink not in free
    assert sorted(free + cached + owned) == list(range(b._total_pages))


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_dense_burst_matches_jax_dense_batcher(lm, kv_dtype):
    want, jstats = _jax_burst(lm, kv_dtype=kv_dtype)
    assert jstats["engine"] == "async" and "kv_page_size" not in jstats
    b = _port(lm, kv_dtype=kv_dtype)
    try:
        assert b.engine == "async" and b.kv_page_size == 0
        assert _burst(b) == want
        st = b.stats()
        assert st["requests_served"] == len(PROMPTS)
        assert "kv_pages_total" not in st and st["kernel_launches"] == {}
        assert st.get("kv_dtype", "auto") == kv_dtype
        # int8: [5 rows, 256, 2 kv heads] x (16 payload bytes + a scale)
        per_token = 16 if kv_dtype == "int8" else 16 * 4
        per_token += 4 if kv_dtype == "int8" else 0
        assert st["kv_pool_bytes"] == 2 * 2 * 5 * 256 * 2 * per_token
    finally:
        b.stop()


def test_async_paged_matches_jax_async_paged(lm):
    want, jstats = _jax_burst(lm, **PAGED)
    b = _port(lm, **PAGED)
    try:
        assert _burst(b) == want
        st = b.stats()
        for key in ("prefill_dispatches", "kv_table_width", "kv_table_grows",
                    "prefill_tokens_shared", "prefix_pages_cached"):
            assert st[key] == jstats[key], key
        _pool_conserved(b)
    finally:
        b.stop()


@pytest.mark.parametrize("paged", [False, True])
def test_async_equals_serial_on_greedy_and_sampled_rows(lm, paged):
    kws = [{}, dict(temperature=0.8, seed=11),
           dict(temperature=1.1, seed=12, top_k=20, top_p=0.9), {},
           dict(temperature=0.7, seed=13, min_p=0.05)]
    outs = {}
    for engine in ("serial", "async"):
        b = _port(lm, engine=engine, **(PAGED if paged else {}))
        try:
            outs[engine] = _burst(b, kws=kws)
            assert b.stats()["engine"] == engine
        finally:
            b.stop()
    assert outs["async"] == outs["serial"]
    # greedy rows are the solo decode's tokens
    for i in (0, 3):
        solo = port_decode.generate(lm[2], [PROMPTS[i]], MAX_NEW,
                                    device="cpu")
        assert outs["async"][i] == solo[0].tolist()


def test_pipeline_depth_floors_at_one_and_the_pipeline_overlaps(lm):
    b = _port(lm, pipeline_depth=0)
    try:
        assert b.pipeline_depth == 1
        b.submit(PROMPTS[0], 40).result(timeout=300)
        st = b.stats()
        assert st["pipeline_depth"] == 1 and st["pipeline_depth_peak"] >= 1
    finally:
        b.stop()
    b = _port(lm, pipeline_depth=3)
    try:
        got = b.submit(PROMPTS[0], 40).result(timeout=300)
        solo = port_decode.generate(lm[2], [PROMPTS[0]], 40, device="cpu")
        assert got == solo[0].tolist()
        st = b.stats()
        # more steps dispatched than the host has processed: overlap
        assert st["pipeline_depth_peak"] >= 2
        assert st["host_ticks"] >= 40 // ENGINE["read_chunk"]
        assert 0.0 <= st["device_idle_fraction"] <= 1.0
    finally:
        b.stop()


def test_mid_flight_cancellation_drains_and_returns_every_page(lm):
    b = _port(lm, read_chunk=1, kv_page_size=8, kv_pages=96)
    try:
        # the pool holds all three at once (28 pages each at most)
        handles = [b.submit(p, 200) for p in PROMPTS[:3]]
        for h in handles:
            assert h.tokens.get(timeout=300)        # decoding
        for h in handles:
            h.cancel()
        for p, h in zip(PROMPTS, handles):
            out = h.result(timeout=300)
            assert out[:len(p)] == p and len(out) < len(p) + 200
        assert all(s is None for s in b._slots)
        assert b.stats()["slots_busy"] == 0
        _pool_conserved(b)
        b.drop_prefix_cache()
        assert sorted(b._free_pages) == list(range(96))
        # the engine goes on serving
        assert b.submit(PROMPTS[0], 3).result(timeout=300)[-3:]
    finally:
        b.stop()


@pytest.mark.parametrize("engine", ["async", "serial"])
def test_device_thread_fault_fails_every_handle(lm, engine):
    b = _port(lm, engine=engine, **PAGED)
    plan = faults.FaultPlan(0).on("serve.admission", kind="oserror", nth=2)
    try:
        with faults.active(plan):
            first = b.submit(PROMPTS[1], 200)
            assert first.tokens.get(timeout=300)    # in flight
            later = [b.submit(p, MAX_NEW) for p in PROMPTS[2:]]
            for h in [first] + later:
                with pytest.raises(OSError):
                    h.result(timeout=300)
        assert ("serve.admission", "oserror") in plan.fired
        assert isinstance(b._dead, OSError)
        with pytest.raises(RuntimeError, match="batcher died"):
            b.submit(PROMPTS[0], 2)
    finally:
        b.stop()
