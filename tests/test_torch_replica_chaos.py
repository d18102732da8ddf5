"""Replica-side chaos of the port: faults injected at the migration,
park, host-tier and trace sites (``faults``) leave every session's
tokens those of a run without the fault, the pool conserved and the
failure counted.  Port counterparts of the JAX package's
``tests/test_chaos.py`` replica cases:

- a pull fault is retried and the migration lands; a dead pull rolls the
  frozen session back to its source; a destination that dies installing
  the pages never acks, and the source rolls back;
- a park whose gather fails rolls back and the session completes in
  place; a restore that fails keeps the session parked and a retry
  goes on with the ORIGINAL handle;
- a denied demote drops the pages (counted) and conserves the pool; a
  denied promote falls back to a cold prefill and the entries survive
  for the next hit; a failed peer prefix pull falls back to local
  prefill;
- a denied trace export drops every span (counted) and costs no token;
- the MigrationEngine over HTTP: a failing ``:resume`` POST is retried
  and lands; with every POST failing the session rolls back and
  finishes on its source.
Tolerance: exact (greedy and seeded sampled f32 tokens).
"""
import pytest

from tensorflowonspark_tpu_torch import faults, kvtransfer, serve, trace

import torch_replica_lm as lm_mod

ENGINE = dict(n_slots=2, read_chunk=1, prefill_chunk=16, kv_page_size=8,
              kv_pages=24)


@pytest.fixture(scope="module")
def pm():
    return lm_mod.tiny_lm()[2]


def _batcher(pm, **kw):
    return serve.ContinuousBatcher(pm, device="cpu", **dict(ENGINE, **kw))


def _frozen_live(b, prompt, n, **kw):
    h = b.submit(prompt, n, **kw)
    h.tokens.get(timeout=300)
    frozen = b.freeze_session(h, timeout_s=60)
    assert frozen is not None
    return h, frozen


def _settled(b):
    s = b.stats()
    return (s["kv_pages_used"] == s["prefix_pages_cached"]
            and lm_mod.conserved(b))


def test_pull_fault_retries_then_lands(pm):
    src, dst = _batcher(pm), _batcher(pm)
    prompt = lm_mod.prompts(1, seed=71)[0]
    try:
        h, frozen = _frozen_live(src, prompt, 12, temperature=0.7, seed=4)
        meta, blocks = kvtransfer.wire_snapshot(frozen, "m", 8)
        server = kvtransfer.PageServer()
        try:
            ticket = server.register(meta, blocks)
            plan = faults.FaultPlan(0).on("kvtransfer.pull", nth=1)
            with faults.active(plan):
                with pytest.raises(OSError):
                    kvtransfer.pull_snapshot(server.addr, ticket)
                meta2, blocks2 = kvtransfer.pull_snapshot(server.addr,
                                                          ticket)
            assert plan.fired == [("kvtransfer.pull", "oserror")]
        finally:
            server.close()
        h2, installed = dst.submit_resume(meta2, blocks2)
        assert installed.wait(300)
        src.complete_migration(frozen)
        got = h2.result(timeout=300)
        ref = _batcher(pm)
        try:
            assert got == ref.submit(prompt, 12, temperature=0.7,
                                     seed=4).result(timeout=300)
        finally:
            ref.stop()
        assert _settled(src) and _settled(dst)
    finally:
        src.stop()
        dst.stop()


def test_dead_pull_rolls_back_to_the_source(pm):
    b = _batcher(pm)
    prompt = lm_mod.prompts(1, seed=72)[0]
    try:
        h, frozen = _frozen_live(b, prompt, 10)
        meta, blocks = kvtransfer.wire_snapshot(frozen, "m", 8)
        server = kvtransfer.PageServer()
        try:
            ticket = server.register(meta, blocks)
            plan = faults.FaultPlan(0).on("kvtransfer.pull", nth=1,
                                          times=None)
            with faults.active(plan):
                for _ in range(2):
                    with pytest.raises(OSError):
                        kvtransfer.pull_snapshot(server.addr, ticket)
        finally:
            server.close()
        assert b.rollback_migration(frozen)
        assert h.result(timeout=300) == lm_mod.solo(pm, prompt, 10)
        assert b.stats()["migrations_completed"] == 0
        assert _settled(b)
    finally:
        b.stop()


def test_failed_resume_install_rolls_back_to_the_source(pm):
    src, dst = _batcher(pm), _batcher(pm)
    prompt = lm_mod.prompts(1, seed=73)[0]
    try:
        h, frozen = _frozen_live(src, prompt, 10)
        meta, blocks = kvtransfer.wire_snapshot(frozen, "m", 8)
        plan = faults.FaultPlan(0).on("serve.resume_install", nth=1)
        with faults.active(plan):
            h2, installed = dst.submit_resume(meta, blocks)
            with pytest.raises(OSError, match="injected fault"):
                h2.result(timeout=300)
        assert plan.fired and not installed.is_set()
        dst._thread.join(timeout=30)         # the destination died
        with pytest.raises(RuntimeError, match="batcher died"):
            dst.submit_replay(meta)
        assert src.rollback_migration(frozen)
        assert h.result(timeout=300) == lm_mod.solo(pm, prompt, 10)
        assert src.stats()["migrations_completed"] == 0
        assert _settled(src)
    finally:
        src.stop()
        dst.stop()


def test_park_gather_fault_rolls_back_and_the_session_completes(pm):
    b = _batcher(pm)
    prompt = lm_mod.prompts(1, seed=74)[0]
    try:
        h = b.submit(prompt, 10, priority="batch")
        h.tokens.get(timeout=300)
        plan = faults.FaultPlan(0).on("serve.park_gather", nth=1)
        with faults.active(plan):
            with pytest.raises(OSError, match="injected fault"):
                b._park_gather(h)
        assert plan.fired == [("serve.park_gather", "oserror")]
        assert h.result(timeout=300) == lm_mod.solo(pm, prompt, 10)
        s = b.stats()
        assert s["sessions_parked"] == 0 and s["parked_sessions"] == 0
        assert _settled(b)
    finally:
        b.stop()


def test_park_restore_fault_stays_parked_then_a_retry_lands(pm):
    b = _batcher(pm)
    prompt = lm_mod.prompts(1, seed=75)[0]
    try:
        h = b.submit(prompt, 10, priority="batch", temperature=0.9, seed=2)
        emitted = list(h.tokens.get(timeout=300))
        entry = b._park_gather(h)
        assert entry is not None
        assert _settled(b)                   # a parked session holds no page
        plan = faults.FaultPlan(0).on("serve.park_restore", nth=1)
        with faults.active(plan):
            with pytest.raises(OSError, match="injected fault"):
                b._park_restore(entry)
        b._park_restore(entry)
        out = h.result(timeout=300)          # the ORIGINAL handle
        assert out[:len(prompt) + len(emitted)] == prompt + emitted
        assert out == b.submit(prompt, 10, temperature=0.9,
                               seed=2).result(timeout=300)
        s = b.stats()
        assert (s["sessions_parked"], s["sessions_unparked"]) == (1, 1)
        assert _settled(b)
    finally:
        b.stop()


def test_denied_demote_drops_pages_and_conserves_the_pool(pm):
    b = _batcher(pm, host_cache_mb=4)
    prompt = lm_mod.prompts(1, lo=18, hi=19, seed=76)[0]
    try:
        plan = faults.FaultPlan(0).on("serve.host_demote", kind="deny",
                                      nth=1, times=None)
        with faults.active(plan):
            cold = b.submit(prompt, 4).result(timeout=300)
            b.drop_prefix_cache()
            b._host_tier.flush(10)
        assert ("serve.host_demote", "deny") in plan.fired
        s = b.stats()
        assert s["host_pages_cached"] == 0 and s["host_demotions"] == 0
        assert s["host_demotions_dropped"] >= 2
        assert b.submit(prompt, 4).result(timeout=300) == cold
        assert b.stats()["host_hits"] == 0
        assert cold == lm_mod.solo(pm, prompt, 4)
        assert _settled(b)
    finally:
        b.stop()


def test_denied_promote_falls_back_to_a_cold_prefill(pm):
    b = _batcher(pm, host_cache_mb=4)
    prompt = lm_mod.prompts(1, lo=18, hi=19, seed=77)[0]
    try:
        cold = b.submit(prompt, 4).result(timeout=300)
        assert b.drop_prefix_cache() > 0
        b._host_tier.flush(10)
        warm = b.stats()["host_pages_cached"]
        assert warm >= 2
        plan = faults.FaultPlan(0).on("serve.host_promote", kind="deny",
                                      nth=1, times=None)
        with faults.active(plan):
            s0 = b.stats()
            assert b.submit(prompt, 4).result(timeout=300) == cold
            assert b.stats()["host_hits"] == s0["host_hits"]
        assert ("serve.host_promote", "deny") in plan.fired
        b.drop_prefix_cache()
        b._host_tier.flush(10)
        assert b.stats()["host_pages_cached"] >= warm
        s0 = b.stats()
        assert b.submit(prompt, 4).result(timeout=300) == cold
        assert b.stats()["host_hits"] - s0["host_hits"] == 2
        assert _settled(b)
    finally:
        b.stop()


def test_failed_prefix_pull_falls_back_to_local_prefill(pm):
    a, b = _batcher(pm, host_cache_mb=4), _batcher(pm, host_cache_mb=4)
    server = kvtransfer.PageServer(prefix_provider=a.host_prefix_provider)
    prompt = lm_mod.prompts(1, lo=18, hi=19, seed=78)[0]
    peer = "%s:%d" % tuple(server.addr)
    try:
        cold = a.submit(prompt, 4).result(timeout=300)
        a._host_tier.flush(10)
        plan = faults.FaultPlan(0).on("kvtransfer.prefix_pull", nth=1)
        with faults.active(plan):
            assert b.prefetch_prefix(peer, prompt) == 0
        assert plan.fired == [("kvtransfer.prefix_pull", "oserror")]
        assert b.counters.get("prefix_pull_failures") == 1
        assert b.submit(prompt, 4).result(timeout=300) == cold
        assert b.stats()["host_hits"] == 0
        b._host_tier.flush(10)
        b._host_tier.clear()
        assert b.prefetch_prefix(peer, prompt) == 2
        assert _settled(a) and _settled(b)
    finally:
        server.close()
        a.stop()
        b.stop()


def test_denied_trace_export_costs_no_tokens(pm):
    b = _batcher(pm)
    prompt = lm_mod.prompts(1, seed=79)[0]
    try:
        want = lm_mod.solo(pm, prompt, 6)
        tid = trace.new_id()
        plan = faults.FaultPlan(0).on("trace.export", kind="deny", nth=1,
                                      times=None)
        with faults.active(plan):
            assert b.submit(prompt, 6, trace_id=tid).result(
                timeout=300) == want
        assert ("trace.export", "deny") in plan.fired
        assert b.trace.spans(tid) == []
        st = b.trace.stats()
        assert st["trace_spans_dropped"] > 0
        assert st["trace_spans_recorded"] == 0
        tid2 = trace.new_id()
        assert b.submit(prompt, 6, trace_id=tid2).result(timeout=300) == want
        names = {s["name"] for s in b.trace.spans(tid2)}
        assert {"submit", "queue", "admit", "prefill", "decode",
                "retire"} <= names
    finally:
        b.stop()


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    return lm_mod.export_lm(tmp_path_factory.mktemp("chaos_lm"))


@pytest.mark.parametrize("times,lands", [(1, True), (None, False)])
def test_resume_post_faults_retry_or_roll_back(pm, export_dir, times,
                                               lands):
    flags = ("--generate_kv_page_size", "8", "--generate_kv_pages", "24")
    with lm_mod.Replica(export_dir, *flags) as a, \
            lm_mod.Replica(export_dir, *flags) as d:
        prompt = lm_mod.prompts(1, seed=80)[0]
        h = a.batcher.submit(prompt, 16)
        h.tokens.get(timeout=300)
        plan = faults.FaultPlan(0).on("kvtransfer.post_resume", nth=1,
                                      times=times)
        with faults.active(plan):
            res = a.service.migration_engine().migrate(
                h, ("127.0.0.1", d.port), timeout_s=60, retries=2)
        assert res["migrated"] == lands
        assert h.result(timeout=300) == lm_mod.solo(pm, prompt, 16)
        st = a.batcher.stats()
        assert st["migrations_failed"] == (0 if lands else 1)
        assert d.batcher.counters.get("migrations_resumed") == int(lands)
        assert _settled(a.batcher)
