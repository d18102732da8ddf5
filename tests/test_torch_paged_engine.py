"""Growable page tables, the prefix cache and the mega-prompt lane of the
port's ContinuousBatcher, against the JAX package's.

A tiny f32 LM (2 layers, d_model 64, 4 heads, 2 kv heads, max_seq_len
256, so a row's table caps at 32 pages of 8) is initialised by the JAX
package from a seed and carried to the port by
``convert.params_from_jax``; prompts come from ``np.random.RandomState``.
The JAX side runs its own ContinuousBatcher on the CPU, the port's runs
with ``device="cpu"``.  Tolerance: greedy f32 tokens and the named
counters equal exactly.

- growth: the same request sequence (one row decoding while two longer
  prompts force 8 -> 16 -> 32) gives the same table widths,
  ``kv_table_grows`` and tokens as JAX; ``decode.grow_page_table``
  keeps every mapped column and fills the tail with the sink, as JAX's
  ``_jitted_grow_page_table`` does;
- the prefix cache: a repeated prompt skips its full pages'
  prefill with JAX's ``prefill_tokens_shared``, hits, misses and cache
  size, and its tokens equal a run without a cache (a solo decode);
  eviction under pressure, a share that survives its twin's retirement,
  and shared pages never evicted by their own admission (the port's
  counterparts of ``tests/test_paged.py:185-250``);
- the lane (``tests/test_long_context.py:176``): a 96-token prompt above
  the threshold gives the normal path's tokens, greedy and seeded, grows
  the table and reclaims a cold prefix page; with the reclaim denied it
  fails with KVOverflowError, the pool is conserved and the engine
  serves on; the threshold needs the paged cache;
- an admission that shares prefix pages but waits a round for its first
  chunk (behind the budget, normal or in the lane) steps with the free
  rows meanwhile, and its junk writes never reach the shared pages that
  a live row beside it reads: every token equals a run without a cache.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import serve as jax_serve
from tensorflowonspark_tpu.models import decode as jax_decode
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import convert, faults, serve
from tensorflowonspark_tpu_torch.models import decode as port_decode
from tensorflowonspark_tpu_torch.models import transformer as port_tf

CFG = dict(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=128, max_seq_len=256, dtype="float32", rope=True,
           norm_type="rmsnorm")
_rs = np.random.RandomState(11)
DECODING = _rs.randint(0, 64, 10).tolist()       # decodes through growth
GROWERS = [_rs.randint(0, 64, n).tolist() for n in (70, 150)]
PREFIX = list(range(1, 19))                       # 2 full pages + 2
FORK = PREFIX[:8] + [33, 34, 35, 36, 37, 38, 39, 40, 41]
SEQ_ENGINE = dict(n_slots=2, read_chunk=2, prefill_chunk=32, kv_page_size=8,
                  kv_pages=48)
COUNTERS = ("kv_table_width", "kv_table_grows", "prefill_tokens_shared",
            "prefix_hits", "prefix_misses", "prefix_pages_cached",
            "kv_pages_free", "prefill_dispatches")


@pytest.fixture(scope="module")
def lm():
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**CFG))
    params = jm.init(jax.random.key(9), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    pm = port_tf.build_transformer(**CFG)
    pm.load_state_dict(convert.params_from_jax(params), strict=True)
    pm.eval().requires_grad_(False)
    return jm, params, pm


def _solo(pm, prompt, n, **kw):
    return port_decode.generate(pm, [prompt], n, device="cpu",
                                **kw)[0].tolist()


def _sequence(b):
    """One row decodes while two longer prompts grow the tables, then a
    prompt, its repeat and a fork of its first page: (outputs, the
    counters after each request)."""
    outs, snaps = [], []

    def snap():
        st = b.stats()
        snaps.append({k: st[k] for k in COUNTERS})

    h0 = b.submit(DECODING, 60)
    assert h0.tokens.get(timeout=300)          # admitted and decoding
    for p in GROWERS:
        outs.append(b.submit(p, 8).result(timeout=300))
        snap()
    outs.insert(0, h0.result(timeout=300))
    for p in (PREFIX, PREFIX, FORK):
        outs.append(b.submit(p, 5).result(timeout=300))
        snap()
    return outs, snaps


@pytest.fixture(scope="module")
def sequences(lm):
    jm, params, pm = lm
    jb = jax_serve.ContinuousBatcher(jm, params, **SEQ_ENGINE)
    try:
        want = _sequence(jb)
    finally:
        jb.stop()
    b = serve.ContinuousBatcher(pm, device="cpu", **SEQ_ENGINE)
    try:
        got = _sequence(b)
        conserved = _conserved(b)
    finally:
        b.stop()
    return want, got, conserved


def _conserved(b):
    """free + cached (refcount 0) + rows' own pages is the whole pool."""
    free = list(b._free_pages)
    cached = list(b._prefix.values())
    owned = [p for rp in b._row_pages if rp for p in rp
             if p not in b._page_rc]
    return (len(set(free)) == len(free) and b._sink not in free
            and sorted(free + cached + owned) == list(range(b._total_pages)))


def test_table_growth_matches_jax(lm, sequences):
    (want, want_snaps), (got, got_snaps), conserved = sequences
    # the row that decoded across both growths, and the growers
    assert got[:3] == want[:3]
    assert got[0] == _solo(lm[2], DECODING, 60)
    widths = [(s["kv_table_width"], s["kv_table_grows"])
              for s in got_snaps[:2]]
    assert widths == [(16, 1), (32, 2)]
    assert widths == [(s["kv_table_width"], s["kv_table_grows"])
                      for s in want_snaps[:2]]
    assert conserved


def test_grow_page_table_keeps_columns_like_jax(lm):
    jm, _, pm = lm
    sink = 5
    slot_model, jcache = jax_decode.init_paged_slot_cache(jm, 2, 8, 6,
                                                          table_pages=2)
    jcache = jax_decode._jitted_set_row_page_table(slot_model)(
        jcache, jnp.asarray(0, jnp.int32), jnp.asarray([3, 1], jnp.int32))
    jcache = jax_decode._jitted_grow_page_table(slot_model, 4)(
        jcache, jnp.asarray(sink, jnp.int32))
    want = np.asarray(jcache["layer_0"]["attn"]["page_table"])
    _, cache = port_decode.init_paged_slot_cache(pm, 2, 8, 6, table_pages=2)
    port_decode.set_row_page_table(cache, 0, [3, 1])
    port_decode.grow_page_table(cache, 4, sink)
    assert cache.page_table.tolist() == want.tolist()
    with pytest.raises(ValueError, match="grows"):
        port_decode.grow_page_table(cache, 2, sink)


def test_prefix_cache_matches_jax_and_a_cold_run(lm, sequences):
    (want, want_snaps), (got, got_snaps), _ = sequences
    assert got[3:] == want[3:]
    assert got_snaps[2:] == want_snaps[2:]
    first, again = got_snaps[2], got_snaps[3]
    # the repeat shared both full pages: 16 of its 18 tokens skipped
    assert again["prefill_tokens_shared"] - first["prefill_tokens_shared"] \
        == 16
    assert got_snaps[4]["prefill_tokens_shared"] \
        - again["prefill_tokens_shared"] == 8          # the fork: one page
    assert got[3] == got[4] == _solo(lm[2], PREFIX, 5)
    assert got[5] == _solo(lm[2], FORK, 5)


def _batcher(pm, kv_pages, read_chunk=2, **kw):
    return serve.ContinuousBatcher(pm, device="cpu", n_slots=2,
                                   read_chunk=read_chunk, kv_page_size=8,
                                   kv_pages=kv_pages, **kw)


def test_prefix_cache_eviction_under_pressure(lm):
    pm = lm[2]
    b = _batcher(pm, 4)                        # a tiny pool
    try:
        for base in (1, 7, 13, 19, 25):        # distinct 10-token prompts
            p = [base + i for i in range(10)]
            assert b.submit(p, 4).result(timeout=300) == _solo(pm, p, 4)
        s = b.stats()
        assert s["kv_pages_free"] + s["prefix_pages_cached"] == 4
        assert _conserved(b)
    finally:
        b.stop()


def test_prefix_concurrent_share_survives_retirement(lm):
    pm = lm[2]
    b = _batcher(pm, 8, read_chunk=1)
    try:
        prompt = list(range(2, 20))            # 18 tokens, 2 full pages
        b.submit(prompt, 2).result(timeout=300)     # seed the cache
        h_long = b.submit(prompt, 10)          # shares, decodes long
        h_short = b.submit(prompt, 1)          # shares, retires at once
        assert h_short.result(timeout=300) == _solo(pm, prompt, 1)
        assert h_long.result(timeout=300) == _solo(pm, prompt, 10)
        assert b.stats()["prefix_hits"] == 4
        assert _conserved(b)
    finally:
        b.stop()


def test_prefix_shared_pages_not_self_evicted(lm):
    pm = lm[2]
    b = _batcher(pm, 6, read_chunk=1)
    try:
        prompt = list(range(1, 18))            # 17 tokens, 2 full pages
        b.submit(prompt, 2).result(timeout=300)     # seed the cache
        h_live = b.submit([9, 9, 9], 20)       # holds 3 pages, decodes
        # needs 2 shared + 2 fresh with 1 free: parks (its own cached
        # pages are the only refcount-0 ones) until h_live retires
        h_rep = b.submit(prompt, 13)
        assert h_live.result(timeout=300) == _solo(pm, [9, 9, 9], 20)
        assert h_rep.result(timeout=300) == _solo(pm, prompt, 13)
        s = b.stats()
        assert s["kv_pages_free"] + s["prefix_pages_cached"] == 6
        assert _conserved(b)
    finally:
        b.stop()


def _long_prompt(n=96, seed=7):
    return np.random.RandomState(seed).randint(1, 64, n).tolist()


LANE = dict(read_chunk=1, prefill_chunk=32, long_prompt_threshold=24)
SHORT = list(range(1, 19))                    # 2 full prefix pages


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.9, 13)])
def test_lane_matches_the_normal_path_grows_and_reclaims(lm, temperature,
                                                         seed):
    pm = lm[2]
    b = _batcher(pm, 14, **LANE)
    try:
        # a short prompt retires first: its 2 full pages stay cached
        # cold, so the lane's last chunk needs the valve
        assert b.submit(SHORT, 4).result(timeout=300) == _solo(pm, SHORT, 4)
        assert b.stats()["prefix_pages_cached"] == 2
        long = _long_prompt()                  # 3 chunks of 32; 13 pages
        got = b.submit(long, 8, temperature=temperature,
                       seed=seed).result(timeout=300)
        assert got == _solo(pm, long, 8, temperature=temperature,
                            seed=seed)
        st = b.stats()
        assert st["long_prompt_threshold"] == 24
        assert st["kv_table_grows"] == 1 and st["kv_table_width"] == 16
        assert st["kv_pages_demoted_overflow"] >= 1
        assert st["long_chunks_dispatched"] == 3
        assert st["long_prompts_active"] == 0
        assert _conserved(b)
    finally:
        b.stop()


def test_lane_overflow_raises_and_conserves_the_pool(lm):
    pm = lm[2]
    b = _batcher(pm, 14, **LANE)
    long = _long_prompt()
    try:
        cold = b.submit(SHORT, 4).result(timeout=300)
        plan = faults.FaultPlan(0).on("serve.overflow_demote", kind="deny",
                                      nth=1, times=None)
        with faults.active(plan):
            h = b.submit(long, 8)
            with pytest.raises(serve.KVOverflowError, match="kv pages"):
                h.result(timeout=300)
        assert ("serve.overflow_demote", "deny") in plan.fired
        assert issubclass(serve.KVOverflowError, RuntimeError)
        st = b.stats()
        assert st["kv_pages_demoted_overflow"] == 0
        assert st["kv_pages_free"] + st["prefix_pages_cached"] == 14
        assert not any(b._row_pages) and _conserved(b)
        # the engine serves on, and without the fault the lane finishes
        assert b.submit(SHORT, 4).result(timeout=300) == cold
        assert b.submit(long, 8).result(timeout=300) == _solo(pm, long, 8)
        assert b.stats()["long_prompts_active"] == 0
    finally:
        b.stop()


def test_long_threshold_requires_paged_cache(lm, tmp_path):
    with pytest.raises(ValueError, match="paged"):
        serve.ContinuousBatcher(lm[2], device="cpu", n_slots=2,
                                long_prompt_threshold=24)
    args = serve.build_argparser().parse_args([
        "--export_dir", str(tmp_path), "--device", "cpu", "--port", "0",
        "--generate_long_prompt_threshold", "24"])
    with pytest.raises(ValueError, match="paged"):
        serve.make_server(args)


PREFIX4 = np.random.RandomState(5).randint(1, 64, 34).tolist()  # 4 pages + 2


@pytest.mark.parametrize("lane", [False, True])
def test_waiting_share_writes_no_junk_into_shared_pages(lm, lane):
    pm = lm[2]
    # a budget of one token: each round prefills the head's chunk only
    b = serve.ContinuousBatcher(
        pm, device="cpu", n_slots=3, read_chunk=1, prefill_chunk=8,
        prefill_budget=1, kv_page_size=8, kv_pages=40,
        long_prompt_threshold=len(PREFIX4) - 1 if lane else 0)
    try:
        live = b.submit(PREFIX4, 40)           # registers 4 prefix pages
        assert live.tokens.get(timeout=300)    # and decodes across them
        gate = _long_prompt(32, seed=3)        # four rounds at the head
        h_gate = b.submit(gate, 4)
        late = PREFIX4 + [5, 6]                # shares the 4 pages, waits
        h_late = b.submit(late, 6)
        assert h_late.result(timeout=300) == _solo(pm, late, 6)
        assert live.result(timeout=300) == _solo(pm, PREFIX4, 40)
        assert h_gate.result(timeout=300) == _solo(pm, gate, 4)
        st = b.stats()
        assert st["prefill_tokens_shared"] == 32
        assert st["long_chunks_dispatched"] == (
            -(-len(PREFIX4) // 8) + 1 if lane else 0)
        assert _conserved(b)
    finally:
        b.stop()
