"""Priority classes, weighted-fair admission and the preemption
controller of the port's replica, against the JAX package's.

- the weighted-fair pick (``_next_item``: interactive before batch up to
  ``prio_weight`` picks, the mega-prompt lane one level up, at most one
  lane admission mid-prefill) orders the same queued items as the JAX
  batcher's, at several weights;
- a mixed load on two rows (long batch sessions, greedy and seeded
  sampled, then interactive requests) with ``preempt_ms`` armed parks
  batch sessions and resumes them: every parked session equals its run
  without preemption bit for bit (greedy ones also the solo decode),
  interactive requests equal their solo decodes, the park accounting
  returns to zero and the pool is conserved, on the paged pool and the
  dense cache; the interactive queue delay's p95 lies below the
  disarmed run's under the same load;
- over HTTP: ``X-Priority`` and the ``priority`` field (a bad class is
  a 400), per-class windows in the stats, and ``make_server``'s checks
  (weights and capacities >= 1; ``--generate_preempt_ms`` refuses a
  draft model and composes with n-gram speculation); a live request
  whose ``Idempotency-Key`` a second request reuses is cancelled;
  ``POST /v1/fleet:drain`` fences admissions (503 with ``Retry-After``,
  ``/readyz`` 503); ``/v1/debug:profile`` captures a trace (200);
- chip_smoke phase 17's load (every row a batch session, interactive
  requests one per thread) gives the same interactive tokens with the
  controller armed and disarmed, in f32 (ROADMAP §C).
Tolerance: exact.
"""
import collections
import json
import threading
import types

import pytest

from tensorflowonspark_tpu import serve as jax_serve
from tensorflowonspark_tpu_torch import serve
from tensorflowonspark_tpu_torch.metrics import LatencyWindow

import torch_replica_lm as lm_mod


class _Queues:
    """The state `_next_item` reads, bound to either package's method."""

    def __init__(self, cls, weight, items):
        self.prio_weight = weight
        self._batch_credit = self._long_credit = 0
        self._admissions = []
        self._classq = {c: collections.deque() for c in
                        serve.PRIORITY_CLASSES}
        self._longq = collections.deque()
        self._qdelay = {c: LatencyWindow() for c in serve.PRIORITY_CLASSES}
        for it in items:
            (self._longq if it["long"]
             else self._classq[it["cls"]]).append(dict(it))
        self._next_item = types.MethodType(cls._next_item, self)
        self._long_admitting = types.MethodType(cls._long_admitting, self)

    def order(self):
        out = []
        while (item := self._next_item()) is not None:
            out.append(item["id"])
            if item["long"] and len(out) % 3 == 0:
                # a lane admission mid-prefill holds the lane
                self._admissions.append({"item": item})
            elif len(out) % 3 == 0:
                self._admissions.clear()
        return out


@pytest.mark.parametrize("weight", [1, 2, 4])
def test_weighted_fair_pick_orders_like_jax(weight):
    items = ([{"id": f"i{k}", "cls": "interactive", "long": False,
               "t_submit": 0.0} for k in range(7)]
             + [{"id": f"b{k}", "cls": "batch", "long": False,
                 "t_submit": 0.0} for k in range(4)]
             + [{"id": f"L{k}", "cls": "interactive", "long": True,
                 "t_submit": 0.0} for k in range(2)])
    got = _Queues(serve.ContinuousBatcher, weight, items).order()
    want = _Queues(jax_serve.ContinuousBatcher, weight, items).order()
    assert got == want
    assert sorted(got) == sorted(it["id"] for it in items)


BATCH_N, INTER_N = 48, 5


def _mixed_load(pm, preempt_ms, kw):
    """Two rows held by long batch sessions, then three interactive
    requests: (batch outputs, interactive outputs, stats)."""
    b = serve.ContinuousBatcher(pm, device="cpu", n_slots=2, read_chunk=1,
                                prefill_chunk=16, preempt_ms=preempt_ms,
                                **kw)
    try:
        bp = lm_mod.prompts(2, seed=61)
        hb = [b.submit(bp[0], BATCH_N, priority="batch"),
              b.submit(bp[1], BATCH_N, priority="batch", temperature=0.8,
                       seed=9)]
        for h in hb:
            h.tokens.get(timeout=300)
        ip = lm_mod.prompts(3, seed=62)
        hi = [b.submit(p, INTER_N) for p in ip]
        inter = [h.result(timeout=300) for h in hi]
        batch = [h.result(timeout=300) for h in hb]
        st = b.stats()
        if b.kv_page_size:
            assert lm_mod.conserved(b)
        return bp, ip, batch, inter, st
    finally:
        b.stop()


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_parked_sessions_equal_their_runs_and_accounting_returns_to_zero(
        layout):
    _, _, pm = lm_mod.tiny_lm()
    kw = dict(kv_page_size=8, kv_pages=24) if layout == "paged" else {}
    bp, ip, batch, inter, st = _mixed_load(pm, 1.0, kw)
    _, _, base_batch, base_inter, base = _mixed_load(pm, 0.0, kw)
    assert batch == base_batch                 # greedy and sampled
    assert batch[0] == lm_mod.solo(pm, bp[0], BATCH_N)
    assert inter == base_inter == [lm_mod.solo(pm, p, INTER_N) for p in ip]
    assert st["sessions_parked"] >= 1
    assert st["sessions_unparked"] == st["sessions_parked"]
    assert st["parked_sessions"] == 0 and st["parked_sessions_peak"] >= 1
    assert st["park_restore_failures"] == 0
    assert st["slots_busy"] == 0 and st["pending"] == 0
    assert st["qdelay_interactive_count"] == 3
    assert st["qdelay_batch_count"] >= 2
    assert base["sessions_parked"] == 0
    assert st["qdelay_interactive_p95_ms"] < base["qdelay_interactive_p95_ms"]


def _phase17_load(pm, preempt_ms):
    """chip_smoke phase 17's mixed load, small: batch sessions (greedy
    and seeded sampled) on every row of a paged pool, then interactive
    requests that arrive one per thread.  (interactive prompts, their
    outputs, the batch outputs, stats)."""
    b = serve.ContinuousBatcher(pm, device="cpu", n_slots=4, read_chunk=1,
                                prefill_chunk=16, preempt_ms=preempt_ms,
                                kv_page_size=8, kv_pages=64)
    try:
        bp = lm_mod.prompts(4, seed=71)
        hb = [b.submit(p, BATCH_N, priority="batch",
                       **({"temperature": 0.8, "seed": 5 + i} if i % 2
                          else {})) for i, p in enumerate(bp)]
        for h in hb:
            h.tokens.get(timeout=300)
        ip = lm_mod.prompts(4, seed=72)
        inter = [None] * len(ip)

        def run(i):
            inter[i] = b.submit(ip[i], INTER_N).result(timeout=300)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(ip))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        batch = [h.result(timeout=300) for h in hb]
        assert lm_mod.conserved(b)
        return ip, inter, batch, b.stats()
    finally:
        b.stop()


def test_interactive_tokens_equal_with_the_controller_armed_and_disarmed():
    """ROADMAP §C on the CPU in f32: the interactive tokens of phase
    17's load do not depend on whether the controller parks batch
    sessions (both equal the solo decodes), so a parting on the card is
    a bf16 near tie, not a fault of the park / unpark path."""
    _, _, pm = lm_mod.tiny_lm()
    ip, armed, armed_batch, st = _phase17_load(pm, 1.0)
    _, disarmed, base_batch, base = _phase17_load(pm, 0.0)
    assert st["sessions_parked"] >= 1 and base["sessions_parked"] == 0
    assert armed == disarmed == [lm_mod.solo(pm, p, INTER_N) for p in ip]
    assert armed_batch == base_batch


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    return lm_mod.export_lm(tmp_path_factory.mktemp("preempt_lm"))


def test_priority_header_and_field_over_http(export_dir):
    with lm_mod.Replica(export_dir, "--generate_priority_weight", "2",
                        "--generate_preempt_ms", "50",
                        "--generate_park_capacity", "2",
                        "--spec_draft", "ngram", "--draft_k", "2") as r:
        prompt = lm_mod.prompts(1, seed=63)[0]
        plain = r.generate({"inputs": [prompt], "max_new_tokens": 6})
        assert r.generate({"inputs": [prompt], "max_new_tokens": 6,
                           "priority": "batch"}) == plain
        assert r.generate({"inputs": [prompt], "max_new_tokens": 6},
                          headers={"X-Priority": "batch"}) == plain
        status, _, _ = r.post("/v1/models/default:generate",
                              {"inputs": [prompt], "priority": "urgent"})
        assert status == 400
        st = r.batcher.stats()
        assert (st["priority_weight"], st["preempt_ms"],
                st["park_capacity"]) == (2, 50.0, 2)
        assert st["qdelay_batch_count"] == 2
        assert st["ttft_batch_count"] == 2
        assert st["qdelay_interactive_count"] == 1


@pytest.mark.parametrize("flags,match", [
    (["--generate_priority_weight", "0"], "priority_weight"),
    (["--generate_preempt_ms", "-1"], "preempt_ms"),
    (["--generate_park_capacity", "0"], "park_capacity"),
    (["--generate_preempt_ms", "5", "--draft_export_dir", "D"],
     "does not compose")])
def test_make_server_checks_the_scheduling_flags(flags, match):
    args = serve.build_argparser().parse_args([
        "--export_dir", "unused", "--device", "cpu", *flags])
    with pytest.raises(ValueError, match=match):
        serve.make_server(args)


def test_drain_idempotency_and_the_unported_profile(export_dir):
    with lm_mod.Replica(export_dir, "--generate_read_chunk", "1") as r:
        prompt = lm_mod.prompts(1, seed=64)[0]
        # a second live request under the same Idempotency-Key cancels
        # the first (its consumer is gone): it ends early, counted
        box = {}
        t = threading.Thread(target=lambda: box.update(ev=r.generate(
            {"inputs": [prompt], "max_new_tokens": 100, "stream": True},
            headers={"Idempotency-Key": "k1"})))
        t.start()
        b = r.batcher
        while not any(s is not None and len(s["seq"]) > len(prompt) + 2
                      for s in list(b._slots)):
            pass
        twin = r.generate({"inputs": [prompt], "max_new_tokens": 4},
                          headers={"Idempotency-Key": "k1"})
        t.join(timeout=120)
        assert twin == [lm_mod.solo(lm_mod.tiny_lm()[2], prompt, 4)]
        assert len(box["ev"][-1]["output"]) < len(prompt) + 100
        assert b.stats()["idempotency_cancels"] == 1
        status, _, raw = r.post("/v1/debug:profile", {"duration_ms": 20})
        assert status == 200 and json.loads(raw)["artifact"].endswith(
            "trace.json")
        # the drain fences admissions: 503 + Retry-After, /readyz 503
        status, _, raw = r.post("/v1/fleet:drain", {})
        assert status == 200 and json.loads(raw)["drained"]
        status, headers, _ = r.post("/v1/models/default:generate",
                                    {"inputs": [prompt]})
        assert status == 503 and headers["Retry-After"] == "1"
        assert r.get("/readyz")[0] == 503 and r.get("/healthz")[0] == 200
        meta = json.loads(r.get("/v1/models/default")[2])
        assert meta["status"] == "draining" and meta["model"]["role"] == "mixed"
