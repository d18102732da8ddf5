"""``chip_smoke.py``'s bookkeeping of the serving kernels' launches by
shape, checked on the CPU.

- ``forward_modules`` counts the modules of one forward that launch a
  serving kernel (attention layers, quantised projections, fused
  LayerNorms): a forward of a two-layer model calls the fused LayerNorm
  and the quantised matmul as many times as it counts.
- ``launch_split`` splits a serving run's launches into decode steps and
  prefill dispatches, and says whether they add up to the wrapper's own
  count, on the figures of a flagship serving run (133 decode steps, 17
  prefill dispatches, 16 layers, 97 quantised projections, 33 fused
  LayerNorms).
- phase 11's helpers: ``frame_records`` gives the seeded one-column
  int32 token records the pipeline phase feeds (``cluster_rows``' rows,
  the same on every call); ``first_difference`` / ``check_bits`` pass
  equal arrays and name the first array whose dtype, shape or bits
  differ (one flipped bit of an f32 logit, a -0.0 against 0.0, a NaN
  payload, a missing array); ``_timed`` yields exactly ``n`` items and
  times each.
- phase 18's helpers: ``stream_output`` takes a stream's ``done``
  output only when its token events spell it; ``tie_or_equal`` passes
  equal runs and divergences at a near tie and fails the rest;
  ``fleet_gateway`` builds the port's gateway with its ejection window
  and the jobs surface; ``affine_prompts`` picks prompts whose prefix
  hashes to the named replica; the legs' sizes are the ones the phase
  reports.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import fleet, quantize
from tensorflowonspark_tpu_torch.models import transformer as port_tf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CFG = dict(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=128, max_seq_len=16, dtype="float32", rope=True,
           norm_type="layernorm", fused_ln=True)


def test_forward_modules_count_the_launches_of_one_forward(monkeypatch):
    model = port_tf.build_transformer(**CFG).eval()
    model.reset_parameters(torch.Generator().manual_seed(0))
    assert chip_smoke.forward_modules(model) == dict(
        attention=2, quantized=0, fused_ln=5)
    # the 64 -> 32 key and value projections stay below quantize's
    # 4096-element floor
    done = quantize.quantize_module(model, "int8")
    modules = chip_smoke.forward_modules(model)
    assert modules == dict(attention=2, quantized=len(done), fused_ln=5)
    calls = {"fused_ln": 0, "quantized": 0}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(port_tf, "fused_layernorm",
                        counting("fused_ln", port_tf.fused_layernorm))
    monkeypatch.setattr(port_tf, "quant_matmul",
                        counting("quantized", port_tf.quant_matmul))
    with torch.no_grad():
        model(torch.tensor([[1, 5, 9, 2]]))
    assert calls == {name: modules[name] for name in calls}


def test_launch_split_of_a_flagship_serving_run():
    modules = dict(attention=16, quantized=97, fused_ln=33)
    launches = {"paged_attention": 2128, "page_write": 272,
                "prefill_read": 272, "paged_attention_int8": 2128,
                "page_write_int8": 2400, "prefill_read_int8": 272,
                "int8_matmul": 14550, "int4_matmul": 14550,
                "layernorm": 4950}
    split = chip_smoke.launch_split(launches, modules, 133, 17)
    assert set(split) == set(launches)
    assert all(s["adds_up"] for s in split.values())
    assert split["layernorm"] == dict(decode=4389, prefill=561,
                                      adds_up=True)
    assert split["page_write_int8"] == dict(decode=2128, prefill=272,
                                            adds_up=True)
    assert split["int8_matmul"]["decode"] == 12901
    for name in ("paged_attention", "paged_attention_int8"):
        assert split[name]["prefill"] == 0
    for name in ("page_write", "prefill_read", "prefill_read_int8"):
        assert split[name]["decode"] == 0
    # a count the shapes do not explain is flagged, not hidden
    off = chip_smoke.launch_split({"page_write": 288}, modules, 133, 17)
    assert off["page_write"] == dict(decode=0, prefill=272, adds_up=False)


def test_pipeline_phase_records_and_bit_checks():
    recs = chip_smoke.frame_records(7, 5, 32000, 1025)
    assert len(recs) == 5 and all(len(r) == 1 for r in recs)
    rows = np.stack([r[0] for r in recs])
    assert rows.shape == (5, 1025) and rows.dtype == np.int32
    assert rows.min() >= 0 and rows.max() < 32000
    np.testing.assert_array_equal(rows, chip_smoke.cluster_rows(7, 5, 32000,
                                                                1024))
    again = np.stack([r[0] for r in chip_smoke.frame_records(7, 5, 32000,
                                                              1025)])
    assert again.tobytes() == rows.tobytes()

    logits = list(np.random.RandomState(0).randn(3, 4, 8).astype(np.float32))
    same = [a.copy() for a in logits]
    assert chip_smoke.first_difference(logits, same) is None
    chip_smoke.check_bits("equal", logits, same)
    flipped = [a.copy() for a in logits]
    flipped[1].view(np.uint32)[2, 3] ^= 1          # one ulp of one logit
    assert chip_smoke.first_difference(logits, flipped).startswith(
        "array 1: the bits differ")
    with pytest.raises(AssertionError, match="transform: array 1"):
        chip_smoke.check_bits("transform", flipped, logits)
    zeros = [np.zeros(2, np.float32)]
    assert chip_smoke.first_difference([-zeros[0]], zeros) is not None
    nan = np.full(2, np.nan, np.float32)
    other_nan = nan.copy()
    other_nan.view(np.uint32)[0] ^= 1
    assert chip_smoke.first_difference([nan], [nan.copy()]) is None
    assert chip_smoke.first_difference([nan], [other_nan]) is not None
    assert "float64" in chip_smoke.first_difference(
        [logits[0].astype(np.float64)], logits[:1])
    assert chip_smoke.first_difference(logits[:2], logits) == \
        "2 arrays against 3"
    losses = [4.5, 4.25]
    assert chip_smoke.first_difference([np.asarray(losses)],
                                       [np.asarray([4.5, 4.25])]) is None

    sink = []
    assert list(chip_smoke._timed(iter(range(10)), 3, sink)) == [0, 1, 2]
    assert len(sink) == 3 and all(t >= 0 for t in sink)
    with pytest.raises(RuntimeError):          # fewer items than asked
        list(chip_smoke._timed(iter(range(2)), 3, []))


def test_replica_phase_bookkeeping():
    # an export summary per burst: every session landed, the largest
    # (most bytes) session's freeze-to-ack time and rate
    results = [
        {"sessions": 4, "migrated": 4, "failed": 0, "completed_locally": 0,
         "details": [{"migrated": True, "pages": 17, "bytes": 71303168,
                      "freeze_to_ack_ms": 250.0},
                     {"migrated": True, "pages": 6, "bytes": 25165824,
                      "freeze_to_ack_ms": 90.0}]},
        {"sessions": 2, "migrated": 1, "failed": 0, "completed_locally": 1,
         "details": [{"migrated": True, "pages": 3, "bytes": 12582912,
                      "freeze_to_ack_ms": 60.0},
                     {"migrated": False, "completed_locally": True}]}]
    got = chip_smoke.migration_numbers(results)
    assert (got["sessions"], got["migrated"], got["failed"],
            got["completed_locally"]) == (6, 3, 0, 1)
    assert got["freeze_to_ack_ms"] == [250.0, 90.0, 60.0]
    assert got["largest"]["pages"] == 17
    assert got["largest"]["mb_per_s"] == pytest.approx(71303168 / 250e3)
    assert chip_smoke.migration_numbers([])["largest"] is None
    # the layouts: a host tick every 2 steps, the paged pool at phase 12's
    # page size, the int8 pool, the dense cache
    layouts = dict(chip_smoke.replica_layouts())
    assert list(layouts) == ["paged_bf16", "paged_int8", "dense"]
    assert layouts["dense"] == ("--generate_read_chunk", "2")
    assert layouts["paged_int8"][-2:] == ("--generate_kv_dtype", "int8")
    assert "64" in layouts["paged_bf16"] and "512" in layouts["paged_bf16"]
    # seeded prompts are the same on every call
    a = chip_smoke.seeded_prompts(torch, 32000, (5, 9), 3)
    assert [len(p) for p in a] == [5, 9]
    assert a == chip_smoke.seeded_prompts(torch, 32000, (5, 9), 3)


def test_replica_phase_waits_on_live_rows_and_request_errors():
    class _Batcher:
        _slots = [None, {"seq": [1, 2, 3, 4, 5, 6], "plen": 1}]

    join = chip_smoke.in_thread(lambda: 7)
    assert join() == 7
    chip_smoke.wait_live(_Batcher(), 1, join, min_new=5, timeout=5)

    def boom():
        raise KeyError("refused")

    failed = chip_smoke.in_thread(boom)
    failed.thread.join(5)
    with pytest.raises(KeyError, match="refused"):
        chip_smoke.wait_live(_Batcher(), 2, failed, timeout=5)
    ended = chip_smoke.in_thread(lambda: None)
    ended.thread.join(5)
    with pytest.raises(AssertionError, match="ended before 2 sessions"):
        chip_smoke.wait_live(_Batcher(), 2, ended, timeout=5)


def test_fleet_phase_stream_and_tie_bookkeeping(monkeypatch):
    prompt = [5, 6, 7]
    events = [{"token": 1}, {"token": 2},
              {"done": True, "output": prompt + [1, 2]}]
    assert chip_smoke.stream_output(events, prompt) == prompt + [1, 2]
    with pytest.raises(AssertionError, match="without its done"):
        chip_smoke.stream_output(events[:2] + [{"error": "boom"}], prompt)
    with pytest.raises(AssertionError, match="differ from its done"):
        chip_smoke.stream_output(events[:1] + events[2:], prompt)
    want = prompt + [1, 2, 3]
    assert chip_smoke.tie_or_equal(torch, None, prompt, want, list(want),
                                   "x") is None
    with pytest.raises(AssertionError, match="tokens against"):
        chip_smoke.tie_or_equal(torch, None, prompt, want, want[:-1], "x")
    with pytest.raises(AssertionError, match="tokens against"):
        chip_smoke.tie_or_equal(torch, None, prompt, want,
                                [9] + want[1:], "x")
    for margin, ok in ((0.0, True), (chip_smoke.SPEC_MARGIN, True),
                       (chip_smoke.SPEC_MARGIN + 0.01, False)):
        monkeypatch.setattr(chip_smoke, "divergence",
                            lambda *a, m=margin: dict(position=1, margin=m))
        got = prompt + [1, 4, 4]
        if ok:
            assert chip_smoke.tie_or_equal(torch, None, prompt, want, got,
                                           "x")["margin"] == margin
        else:
            with pytest.raises(AssertionError, match="top-2 margin"):
                chip_smoke.tie_or_equal(torch, None, prompt, want, got, "x")


def test_fleet_phase_gateway_and_affine_prompts(tmp_path):
    fl = chip_smoke.FLEET
    assert (fl["affinity_n"], fl["job_records"], fl["job_partitions"],
            fl["interactive_n"], len(fl["death"])) == (8, 64, 4, 8, 4)
    assert len(fl["handoff"]) + len(fl["handoff_sampled"]) == 4
    assert fl["heartbeat_s"] * 4 <= fl["heartbeat_timeout_s"]
    gw = chip_smoke.fleet_gateway(str(tmp_path / "jobs"))
    try:
        assert gw.heartbeat_timeout_s == fl["heartbeat_timeout_s"]
        assert gw.ejection_misses == 2 and gw.jobs is not None
        assert gw.jobs.default_workers == fl["job_partitions"]
        assert gw.http_addr[0] == "127.0.0.1"
        members = []
        for port in (8501, 8502, 8503):
            gw._admit({"replica_id": f"127.0.0.1:{port}",
                       "host": "127.0.0.1", "port": port,
                       "features": {"kv_page_size": 64}})
            members.append(type("M", (), {"id": f"127.0.0.1:{port}"})())
        for victim in members:
            prompts = chip_smoke.affine_prompts(torch, gw, victim, (70, 90),
                                                32000, 11)
            assert [len(p) for p in prompts] == [70, 90]
            for p in prompts:
                key = gw.prefix_key({"inputs": [p]})
                assert max(members, key=lambda m: fleet._hrw(
                    m.id, key)) is victim
        assert chip_smoke.gateway_url(gw, "/metrics") == \
            "http://%s:%d/metrics" % gw.http_addr
    finally:
        gw.stop()
