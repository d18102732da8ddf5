"""The host page tier of the port's replica (``kvtier`` and the
batcher's demote / promote / peer-pull paths), against the JAX
package's.

- ``HostPageTier``: the same sequence of operations (puts past the
  byte budget, LRU bumps, duplicates, an oversized page, discards, a
  batched demote with ignored pad rows, close) gives the JAX tier's LRU
  order, stats and page bytes; entries are host tensors decoupled from
  the caller's buffers; ``block_name`` / ``split_prefix_blocks`` equal
  the JAX package's.
- a two-turn conversation on the paged pool (f32 and int8 kv) behind
  ``host_cache_mb``: turn 1 retires and demotes its full pages, the
  device cache is dropped, turn 2 promotes them (``host_hits``,
  ``prefill_tokens_shared``) and gives the cold run's tokens and the
  JAX package's tokens and counters for the same turns;
- eviction under pool pressure and the lane's overflow reclaim demote
  before the pages are reused, and a later prompt promotes them;
- a peer's host tier serves a prefix pull (``kv:prefix`` through its
  page server), the pulled pages promote on this replica, tokens equal
  the cold run; LoRA-rooted pages are never served to a peer;
- the flags: ``--generate_host_cache_mb`` needs the paged pool; the
  host tier's stats are present at zero without it.
Tolerance: exact (greedy f32 tokens, page bytes, counters).
"""
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import kvtier as jax_kvtier
from tensorflowonspark_tpu import serve as jax_serve
from tensorflowonspark_tpu_torch import kvtier, kvtransfer, serve

import torch_replica_lm as lm_mod

STAT_KEYS = ("host_cache_bytes", "host_cache_capacity_bytes",
             "host_pages_cached", "host_demotions", "host_evictions",
             "host_demote_apply_count")


def _page(v, shape=(8, 4)):
    return {"k": np.full(shape, v, np.float32),
            "v": np.full(shape, -v, np.float32)}


def _ops(mod):
    """One operation sequence; returns the tier and its trail."""
    one = sum(a.nbytes for a in _page(0).values())
    tier = mod.HostPageTier(4 * one)
    trail = []
    for i in range(4):
        trail.append(tier.put(("k", i), _page(float(i))))
    trail.append(tier.peek(("k", 0)) is not None)       # bump 0 to MRU
    trail.append(tier.put(("k", 4), _page(4.0)))        # evicts 1
    trail.append(tier.put(("k", 0), _page(9.0)))        # duplicate
    trail.append(tier.put(("big",), _page(1.0, (1024, 64))))
    tier.discard(("k", 2))
    trail.append(tier.contains(("k", 2)))
    kv = {"k": np.stack([np.full((8, 4), 10.0 + i, np.float32)
                         for i in range(4)]),
          "v": np.zeros((4, 8, 4), np.float32)}
    trail.append(tier.demote([("d", i) for i in range(3)], kv, 3))
    assert tier.flush(10)
    kv["k"][:] = 99.0                     # the entries are copies
    trail.append(tier.peek(("zz",)))
    return tier, trail


def test_tier_lru_order_stats_and_bytes_equal_jax():
    got, got_trail = _ops(kvtier)
    want, want_trail = _ops(jax_kvtier)
    try:
        assert got_trail == want_trail
        assert list(got._entries) == list(want._entries)
        gs, ws = got.stats(), want.stats()
        assert {k: gs[k] for k in STAT_KEYS} == {k: ws[k] for k in STAT_KEYS}
        for key in want._entries:
            g, w = got.peek(key), want.peek(key)
            assert set(g) == set(w)
            for leaf in w:
                assert isinstance(g[leaf], torch.Tensor)
                np.testing.assert_array_equal(g[leaf].numpy(), w[leaf])
    finally:
        got.close()
        want.close()
    assert not got.put(("late",), _page(1.0))          # closed
    assert got.stats()["host_pages_cached"] == 0
    with pytest.raises(ValueError):
        kvtier.HostPageTier(0)


def test_block_names_split_like_jax():
    blocks = {kvtier.block_name(i, p): np.full((2,), i)
              for i in range(3) for p in ("layer_0/attn/pages_key",
                                          "layer_0/attn/pages_value")}
    assert kvtier.block_name(7, "x") == jax_kvtier.block_name(7, "x")
    meta = {"n_pages": 3}
    got = kvtier.split_prefix_blocks(meta, blocks)
    want = jax_kvtier.split_prefix_blocks(meta, blocks)
    assert [sorted(p) for p in got] == [sorted(p) for p in want]
    assert kvtier.split_prefix_blocks({"n_pages": 5}, blocks) == got


ENGINE = dict(n_slots=2, read_chunk=2, prefill_chunk=16, kv_page_size=8,
              kv_pages=24)
TURN1 = lm_mod.prompts(1, lo=21, hi=22, seed=21)[0]     # 21 tokens
USER2 = [7, 8, 9, 10, 11, 12, 13, 14, 15]


def _conversation(b, flush):
    """Turn 1, drop the device cache, turn 2: (outputs, counter deltas
    of turn 2)."""
    out1 = b.submit(TURN1, 6).result(timeout=300)
    b.drop_prefix_cache()
    flush(b)
    before = b.stats()
    turn2 = out1 + USER2
    out2 = b.submit(turn2, 6).result(timeout=300)
    after = b.stats()
    delta = {k: after[k] - before[k] for k in (
        "host_hits", "prefill_tokens_shared", "prefix_hits")}
    return [out1, out2], delta, after


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_turn_two_promotes_from_the_host_tier(kv_dtype):
    jm, params, pm = lm_mod.tiny_lm()
    kw = dict(ENGINE, kv_dtype=kv_dtype, host_cache_mb=4)
    b = serve.ContinuousBatcher(pm, device="cpu", **kw)
    try:
        got, delta, st = _conversation(
            b, lambda b: b._host_tier.flush(30))
        assert lm_mod.conserved(b)
    finally:
        b.stop()
    # turn 1 retired 3 full pages (26 committed positions) into the tier;
    # turn 2 (35 tokens) promotes them: 24 tokens skip prefill
    assert delta == {"host_hits": 3, "prefill_tokens_shared": 24,
                     "prefix_hits": 0}
    assert st["host_demotions"] >= 3 and st["host_pages_cached"] >= 0
    cold = serve.ContinuousBatcher(pm, device="cpu",
                                   **dict(ENGINE, kv_dtype=kv_dtype))
    try:
        assert got[1] == cold.submit(got[0] + USER2, 6).result(timeout=300)
    finally:
        cold.stop()
    if kv_dtype:
        return      # the JAX package's turns: once, on the f32 pool
    jb = jax_serve.ContinuousBatcher(jm, params, **kw)
    try:
        want, want_delta, _ = _conversation(
            jb, lambda b: b._host_tier.flush(30))
    finally:
        jb.stop()
    assert got == want
    assert delta == want_delta


def test_eviction_and_overflow_demote_then_promote():
    _, _, pm = lm_mod.tiny_lm()
    ps = lm_mod.prompts(4, lo=17, hi=18, seed=8)        # 2 full pages each
    b = serve.ContinuousBatcher(pm, device="cpu", n_slots=2, read_chunk=2,
                                prefill_chunk=16, kv_page_size=8,
                                kv_pages=8, host_cache_mb=4,
                                long_prompt_threshold=40)
    try:
        outs = [b.submit(p, 4).result(timeout=300) for p in ps]
        b._host_tier.flush(30)
        st = b.stats()
        assert st["host_demotions"] >= 8          # retirements, evictions
        # a mega-prompt reclaims the cold pages (they demoted first)
        long_p = lm_mod.prompts(1, lo=50, hi=51, seed=9)[0]
        assert b.submit(long_p, 4).result(timeout=300) == lm_mod.solo(
            pm, long_p, 4)
        assert b.stats()["kv_pages_demoted_overflow"] >= 1
        b._host_tier.flush(30)
        hits = b.stats()["host_hits"]
        assert b.submit(ps[0], 4).result(timeout=300) == outs[0]
        assert b.stats()["host_hits"] - hits == 2
        assert lm_mod.conserved(b)
    finally:
        b.stop()
    assert outs == [lm_mod.solo(pm, p, 4) for p in ps]


def test_peer_prefix_pull_promotes_here():
    _, _, pm = lm_mod.tiny_lm()
    prompt = lm_mod.prompts(1, lo=30, hi=31, seed=13)[0]
    peer = serve.ContinuousBatcher(pm, device="cpu", host_cache_mb=4,
                                   **ENGINE)
    here = serve.ContinuousBatcher(pm, device="cpu", host_cache_mb=4,
                                   **ENGINE)
    server = kvtransfer.PageServer(prefix_provider=peer.host_prefix_provider)
    try:
        peer.submit(prompt, 3).result(timeout=300)
        peer._host_tier.flush(30)
        addr = "%s:%d" % tuple(server.addr)
        assert here.prefetch_prefix(addr, prompt, trace_id="ab12") == 3
        assert here.prefetch_prefix(addr, prompt) == 0   # already warm
        out = here.submit(prompt, 5, trace_id="ab12").result(timeout=300)
        st = here.stats()
        assert st["host_hits"] == 3 and st["prefix_pull_pages"] == 3
        assert out == lm_mod.solo(pm, prompt, 5)
        names = [s["name"] for s in here.trace.spans("ab12")]
        assert "prefix_pull" in names and "promote" in names
        # a malformed peer or a cold replica inserts nothing
        assert here.prefetch_prefix("nonsense", prompt) == 0
        meta, blocks = here.host_prefix_provider(prompt, 4)   # page size
        assert meta["n_pages"] == 0 and blocks == {}
    finally:
        server.close()
        peer.stop()
        here.stop()


def test_lora_pages_are_never_served_to_a_peer():
    _, _, pm = lm_mod.tiny_lm()
    b = serve.ContinuousBatcher(pm, device="cpu", host_cache_mb=4,
                                lora_rank=2, **ENGINE)
    try:
        rs = np.random.RandomState(4)
        b.register_adapter("a", {"layer_0/attn/query/kernel": {
            "a": rs.randn(64, 2).astype(np.float32),
            "b": rs.randn(2, 64).astype(np.float32)}})
        prompt = lm_mod.prompts(1, lo=20, hi=21, seed=14)[0]
        b.submit(prompt, 3, adapter="a").result(timeout=300)
        b._host_tier.flush(30)
        assert b.stats()["host_pages_cached"] >= 2
        meta, blocks = b.host_prefix_provider(prompt, 8)
        assert meta["n_pages"] == 0 and not blocks
        b.submit(prompt, 3).result(timeout=300)
        b._host_tier.flush(30)
        assert b.host_prefix_provider(prompt, 8)[0]["n_pages"] == 2
    finally:
        b.stop()


def test_host_cache_flag_needs_the_paged_pool(tmp_path):
    args = serve.build_argparser().parse_args([
        "--export_dir", str(tmp_path), "--device", "cpu",
        "--generate_host_cache_mb", "4"])
    with pytest.raises(ValueError, match="generate_kv_page_size"):
        serve.make_server(args)
    _, _, pm = lm_mod.tiny_lm()
    b = serve.ContinuousBatcher(pm, device="cpu", **ENGINE)
    try:
        st = b.stats()
        assert {k: st[k] for k in ("host_hits", "host_cache_bytes",
                                   "host_pages_cached", "host_demotions",
                                   "host_evictions")} == dict.fromkeys(
            ("host_hits", "host_cache_bytes", "host_pages_cached",
             "host_demotions", "host_evictions"), 0)
    finally:
        b.stop()
    with pytest.raises(ValueError, match="paged"):
        serve.ContinuousBatcher(pm, device="cpu", host_cache_mb=4)


def test_promotion_past_a_partly_evicted_run_conserves_the_pool():
    # turn 1's prompt pages stay in the device cache at refcount 0 and in
    # the host tier; a filler evicts only the oldest (the run's head), so
    # the device run breaks at page 0 while pages 1-2 are still cached.
    # Turn 2 promotes the whole run from the host tier: the stale device
    # copies of pages 1-2 must go back to the pool, not leak (the JAX
    # batcher remaps their keys and strands the old pages)
    _, _, pm = lm_mod.tiny_lm()
    turn1 = lm_mod.prompts(1, lo=25, hi=26, seed=91)[0]    # 3 full pages
    b = serve.ContinuousBatcher(pm, device="cpu", n_slots=1, read_chunk=2,
                                prefill_chunk=16, kv_page_size=8,
                                kv_pages=8, host_cache_mb=4)
    try:
        out1 = b.submit(turn1, 2).result(timeout=300)
        b._host_tier.flush(30)
        assert b.stats()["prefix_pages_cached"] == 3
        # 6 pages (5 free): evicts k0; 1 prompt page cached after, 5 free
        filler = lm_mod.prompts(1, lo=9, hi=10, seed=92)[0]
        b.submit(filler, 36).result(timeout=300)
        b._host_tier.flush(30)
        assert b.stats()["kv_pages_free"] == 5
        turn2 = out1 + USER2
        hits = b.stats()["host_hits"]
        assert b.submit(turn2, 4).result(timeout=300) == lm_mod.solo(
            pm, turn2, 4)
        assert b.stats()["host_hits"] - hits == 3
        assert lm_mod.conserved(b)
        assert b.drop_prefix_cache() >= 3
        assert b.stats()["kv_pages_free"] == 8
    finally:
        b.stop()
