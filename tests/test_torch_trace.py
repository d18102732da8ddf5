"""Request tracing and the Prometheus scrape of the port's replica
(``trace``, ``metrics.prometheus_text``, ``GET /metrics`` and
``/v1/trace/<id>``), against the JAX package's.

- ``trace.Recorder``: the same calls give the same spans (names, ids,
  attrs and the explicit endpoints of ``span_at``; the host-clock
  endpoints of the others are compared only as ordered), the same
  summaries of explicit spans, the same ring bound and stats; ids are
  judged alike; a ``trace.export`` deny drops spans and counts them.
- ``prometheus_text`` renders the same groups into byte-equal text,
  histograms included; ``merge_histograms`` and
  ``quantile_from_histogram`` give the JAX package's numbers exactly.
- over HTTP on the CPU (the tiny f32 LM of ``torch_replica_lm``): a
  traced stream's token events equal the untraced stream's, its last
  event carries the summary, ``/v1/trace/<id>`` returns the submit,
  queue, admit, prefill, decode and retire spans, ``X-Trace-Id`` works
  like the field, a malformed id is a 400, and ``/metrics`` exposes
  the engine's stats (the trace counters and TTFT histogram included).
Tolerance: exact.
"""
import json

import pytest

from tensorflowonspark_tpu import metrics as jax_metrics
from tensorflowonspark_tpu import trace as jax_trace
from tensorflowonspark_tpu_torch import faults, metrics, trace

import torch_replica_lm as lm_mod


def _drive(mod, rec):
    """The same call sequence on a Recorder of either package."""
    tid = "4f2a"
    s = rec.begin(tid, "prefill", row=1, chunk=8)
    rec.end(s, tokens=8)
    s = rec.begin(tid, "wire", pages=2)
    rec.abandon(s)
    rec.event(tid, "submit", cls="batch")
    rec.event(None, "submit")                     # untraced: nothing
    rec.span_at(tid, "queue", 10.0, 10.25, row=0)
    rec.span_at("beef", "admit", 11.0, 11.5)
    with pytest.raises(KeyError):
        with rec.span(tid, "decode", tick=1):
            raise KeyError("cut")
    with rec.span(tid, "retire", reason="stop"):
        pass
    return rec


def _strip(spans):
    return [{k: v for k, v in s.items() if k not in ("t0_ms", "t1_ms",
                                                     "dur_ms")}
            for s in spans]


@pytest.mark.parametrize("capacity", [64, 4])
def test_recorder_gives_the_jax_spans(capacity):
    got = _drive(trace, trace.Recorder(capacity=capacity, decode_sample=3))
    want = _drive(jax_trace, jax_trace.Recorder(capacity=capacity,
                                                decode_sample=3))
    for tid in ("4f2a", "beef"):
        assert _strip(got.spans(tid)) == _strip(want.spans(tid))
        for s in got.spans(tid):
            assert s["t0_ms"] <= s["t1_ms"]
    explicit = [s for s in got.spans("4f2a") if s["name"] == "queue"]
    assert explicit == [s for s in want.spans("4f2a")
                        if s["name"] == "queue"]
    assert got.summary("beef") == want.summary("beef")
    assert got.stats() == want.stats()
    assert got.decode_sample == want.decode_sample == 3
    # 7 spans, 6 of them 4f2a's; a ring of 4 keeps the last 4
    assert len(got.spans("4f2a")) == (6 if capacity > 4 else 3)


def test_ids_are_judged_like_jax():
    for tid in ("deadbeef", "4f2a-BEEF-0011", "", None, 123, "hello world",
                "a" * trace.MAX_ID_LEN, "a" * (trace.MAX_ID_LEN + 1),
                trace.new_id()):
        assert trace.valid_id(tid) == jax_trace.valid_id(tid)
    assert len(trace.new_id()) == 32
    assert (trace.DEFAULT_RING, trace.DEFAULT_DECODE_SAMPLE) == (
        jax_trace.DEFAULT_RING, jax_trace.DEFAULT_DECODE_SAMPLE)


def test_export_deny_drops_spans_and_counts_them():
    rec = trace.Recorder()
    plan = faults.FaultPlan(0).on("trace.export", kind="deny", nth=2,
                                  times=2)
    with faults.active(plan):
        for i in range(4):
            rec.event("ab", f"e{i}")
    assert [s["name"] for s in rec.spans("ab")] == ["e0", "e3"]
    assert rec.stats()["trace_spans_dropped"] == 2
    assert plan.fired == [("trace.export", "deny")] * 2


def _groups(mod):
    w = mod.LatencyWindow()
    for ms in (0.4, 3.0, 7.5, 90.0, 20000.0):
        w.record(ms / 1000.0)
    stats = {"requests_served": 7, "device_idle_fraction": 0.25,
             "draining": False, "engine": "async", "kernels": ["x"],
             "skip": None, "weird-key.1": 3}
    stats.update(w.stats("ttft"))
    return [("replica", None, stats),
            ("replica", {"replica": 'a"b\\c', "zone": 1},
             {"requests_served": 2, "ttft_hist": w.histogram()}),
            (None, None, {"1up": 1.5})]


def test_prometheus_text_is_byte_equal_to_jax():
    got = metrics.prometheus_text(_groups(metrics))
    assert got == jax_metrics.prometheus_text(_groups(jax_metrics))
    assert "# TYPE tfospark_replica_ttft histogram" in got
    assert 'tfospark_replica_ttft_bucket{le="+Inf"} 5' in got
    assert got == metrics.prometheus_text(_groups(metrics), "tfospark")


def test_histogram_merge_and_quantiles_equal_jax():
    hists = []
    for seed in range(3):
        w = metrics.LatencyWindow()
        for i in range(20):
            w.record(((seed * 37 + i * 11) % 400) / 1000.0)
        hists.append(w.histogram())
    hists.append({"le": [1.0], "counts": [1, 2]})        # foreign layout
    merged = metrics.LatencyWindow.merge_histograms(hists)
    assert merged == jax_metrics.LatencyWindow.merge_histograms(hists)
    assert merged["count"] == 60
    for q in (0.0, 0.5, 0.95, 1.0):
        assert (metrics.LatencyWindow.quantile_from_histogram(merged, q)
                == jax_metrics.LatencyWindow.quantile_from_histogram(
                    merged, q))
    assert metrics.LatencyWindow.merge_histograms([]) is None


@pytest.fixture(scope="module")
def replica(tmp_path_factory):
    d = lm_mod.export_lm(tmp_path_factory.mktemp("trace_lm"))
    with lm_mod.Replica(d, "--generate_kv_page_size", "8",
                        "--generate_kv_pages", "48",
                        "--generate_trace_decode_sample", "2",
                        "--generate_read_chunk", "2") as r:
        yield r


def test_traced_stream_equals_untraced_and_exports_its_spans(replica):
    prompt = lm_mod.prompts(1, seed=5)[0]
    body = {"inputs": [prompt], "max_new_tokens": 9, "stream": True}
    plain = replica.generate(body)
    traced = replica.generate(dict(body, trace="c0ffee01"))
    assert traced[:-1] == plain[:-1]               # token events equal
    assert traced[-1]["output"] == plain[-1]["output"]
    assert "trace" not in plain[-1]
    summ = traced[-1]["trace"]
    assert summ["id"] == "c0ffee01"
    status, _, raw = replica.get("/v1/trace/c0ffee01")
    assert status == 200
    spans = json.loads(raw)["spans"]
    names = [s["name"] for s in spans]
    for name in ("submit", "queue", "admit", "prefill", "decode", "retire"):
        assert name in names, names
    assert summ["spans"] <= len(spans)
    assert spans[names.index("retire")]["attrs"]["reason"] == "stop"
    # the header form, and the non-stream path
    out = replica.generate({"inputs": [prompt], "max_new_tokens": 9},
                           headers={"X-Trace-Id": "c0ffee02"})
    assert out == [plain[-1]["output"]]
    status, _, raw = replica.get("/v1/trace/c0ffee02")
    assert "admit" in [s["name"] for s in json.loads(raw)["spans"]]
    assert json.loads(replica.get("/v1/trace/0000")[2])["spans"] == []


def test_malformed_trace_ids_are_400(replica):
    status, _, _ = replica.post("/v1/models/default:generate",
                                {"inputs": [[1, 2]], "trace": "not hex!"})
    assert status == 400
    assert replica.get("/v1/trace/zzz")[0] == 400


def test_metrics_endpoint_exposes_engine_stats(replica):
    replica.generate({"inputs": [[3, 4, 5]], "max_new_tokens": 3,
                      "trace": "c0ffee03"})
    for path in ("/metrics", "/v1/metrics"):
        status, headers, raw = replica.get(path)
        assert status == 200
        assert headers["Content-Type"].startswith("text/plain")
        text = raw.decode()
        for name in ("tfospark_replica_requests_served",
                     "tfospark_replica_trace_spans_recorded",
                     "tfospark_replica_kv_pages_free",
                     "tfospark_replica_parked_sessions",
                     "tfospark_kernel_paged_attention_launches"):
            assert f"\n{name} " in text, name
        assert "# TYPE tfospark_replica_ttft histogram" in text
        assert "# TYPE tfospark_replica_qdelay_interactive histogram" in text
    plan = faults.FaultPlan(0).on("trace.export", kind="oserror", nth=1)
    with faults.active(plan):
        assert replica.get("/metrics")[0] == 500     # the scrape only
    assert replica.get("/metrics")[0] == 200
