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
- phase 21's models: ``hf_layout`` gives the key names and shapes of the
  ``transformers`` model's own state dict (LLaMA, GPT-2, Mixtral,
  ``BertForPreTraining``; tiny configs), ``hf_state_dict`` draws it the
  same from a seed with tied keys one tensor, ``hf_convert`` of it equals
  ``from_hf_*`` of the HF model holding it, and ``HF_CONFIGS`` are the
  published widths (TinyLlama-1.1B, GPT-2 124M, Mixtral-8x7B's 46.7 B and
  its 2-layer cut, bert-base-uncased).
- phase 23: ``PREDICT_VIT`` is ViT-B/16's published config and the
  traffic the one the phase reports (4 clients x 4 requests x 8 images,
  ``--batch_wait_ms 5 --batch_size 32``); ``PredictServer``,
  ``post_bytes`` and ``predict_burst`` over ``torch_aot_vit``'s export
  on the CPU, one server an engine: every request answered, the
  micro-batcher coalescing, kernel 4's dispatcher op in both artifacts'
  paths, each engine's logits within ``PREDICT_RTOL`` of the builder's;
  ``predict_profile`` on the CPU: the capture starts once the burst has
  executed and the clients post until it returns, so its trace holds
  kernel 4's dispatcher op, and an overlapping capture gets 409;
  ``spec_v1_run`` on a tiny stand-in for the flagship: 8 rows, every one
  committing its 32 tokens equal to ``generate``'s.
- phase 24: its whole traffic is ``bench.py``'s and the smoke's cut
  departs from it in traffic only; ``phase_workloads`` on a tiny
  stand-in for the flagship prints one line a builder, holds every
  check and sums the serving kernels' launches.
- phase 25: its traffic and engine are phase 5's, its kernel check the
  flagship's tp-4 local shapes (4 q and 2 kv heads a rank; kernels 9
  and 10 at the rank's projections, M 16 and 1024); on one card
  ``phase_a3c`` runs the kernel check alone (a tiny stand-in for the
  flagship on the CPU: every read within TOL of its plain version, every
  quantised matmul within QMM_TOL, no launches added); ``a3c_serve`` at
  tp 1 on the tiny stand-in serves the burst and a solo answer with
  bf16, int8 and int4 weights and FLAGSHIP_SPEC's burst with n-gram and
  a draft, and ``a3c_summary`` holds ranks made from it (a solo answer
  parted from its burst twin away from a tie fails), and fails a rank
  whose registers, ``generate`` tokens or speculation counters are not
  the leader's, or that launched no kernel.
"""
import contextlib
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import convert as convert_mod
from tensorflowonspark_tpu_torch import fleet, quantize
from tensorflowonspark_tpu_torch.models import transformer as port_tf

from torch_aot_vit import vit_aot_export  # noqa: F401

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


# --- phase 21: HF-layout state dicts ---------------------------------------

def _tiny_hf(family):
    """A tiny config dict of ``family`` with the published one's fields."""
    c = dict(chip_smoke.HF_CONFIGS[family])
    if family in ("llama", "mixtral"):
        c.update(vocab_size=50, hidden_size=32, intermediate_size=48,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, num_local_experts=3)
    elif family == "gpt2":
        c.update(vocab_size=50, n_embd=32, n_layer=2, n_head=4,
                 n_positions=40)
    else:
        c.update(vocab_size=60, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=48,
                 max_position_embeddings=40)
    if family != "mixtral":
        c.pop("num_local_experts", None)
    return c


def _hf_model(transformers, family, c):
    cls = {"llama": ("LlamaConfig", "LlamaForCausalLM"),
           "gpt2": ("GPT2Config", "GPT2LMHeadModel"),
           "mixtral": ("MixtralConfig", "MixtralForCausalLM"),
           "bert": ("BertConfig", "BertForPreTraining")}[family]
    return getattr(transformers, cls[1])(getattr(transformers, cls[0])(
        **c)).eval()


@pytest.mark.parametrize("family", ["llama", "gpt2", "mixtral", "bert"])
def test_hf_layouts_are_the_transformers_state_dicts(family):
    transformers = pytest.importorskip("transformers")
    c = _tiny_hf(family)
    hf = _hf_model(transformers, family, c)
    want = {k: tuple(v.shape) for k, v in hf.state_dict().items()}
    layout = chip_smoke.hf_layout(family, c)
    assert {k: shape for k, (shape, _) in layout.items()} == want
    # tied keys are the same tensor in the seeded state dict, as in HF's
    gen = torch.Generator().manual_seed(0)
    sd = chip_smoke.hf_state_dict(torch, family, c, "cpu", gen)
    again = chip_smoke.hf_state_dict(torch, family, c, "cpu",
                                     torch.Generator().manual_seed(0))
    for key, (_, kind) in layout.items():
        assert torch.equal(sd[key], again[key])
        if kind.startswith("tied:"):
            assert sd[key] is sd[kind[5:]]
        elif kind == "norm":
            assert torch.equal(sd[key], torch.ones_like(sd[key]))


@pytest.mark.parametrize("family", ["llama", "gpt2", "mixtral", "bert"])
def test_hf_convert_of_the_seeded_dict_is_the_hf_models(family,
                                                        monkeypatch):
    transformers = pytest.importorskip("transformers")
    monkeypatch.setitem(chip_smoke.HF_CONFIGS, family, _tiny_hf(family))
    cfg, sd, seconds = chip_smoke.hf_convert(torch, family, "cpu", 5,
                                             n_layers=1)
    assert seconds >= 0 and cfg.n_layers == 1
    c = chip_smoke.hf_config(family, 1)
    hf = _hf_model(transformers, family, c)
    hf.load_state_dict(chip_smoke.hf_state_dict(
        torch, family, c, "cpu", torch.Generator().manual_seed(5)),
        strict=True)
    want_cfg, want = getattr(convert_mod, "from_hf_" + family)(hf)
    assert cfg == want_cfg
    assert sorted(sd) == sorted(want)
    assert all(torch.equal(sd[k], want[k]) for k in want)


def test_hf_configs_are_the_published_widths():
    cfgs = {f: chip_smoke.hf_config(f) for f in chip_smoke.HF_CONFIGS}
    llama, gpt2, mixtral, bert = (cfgs[f] for f in ("llama", "gpt2",
                                                    "mixtral", "bert"))
    # TinyLlama: head_dim 64, 32 q / 4 kv heads (group 8), ~1.10 B params
    assert llama["hidden_size"] // llama["num_attention_heads"] == 64
    assert llama["num_attention_heads"] // llama["num_key_value_heads"] == 8
    n = sum(math.prod(s) for s, kind in chip_smoke.hf_layout(
        "llama", llama).values() if not kind.startswith("tied:"))
    assert 1.09e9 < n < 1.11e9
    # GPT-2: head_dim 64, MHA, tied lm_head, 124 M params
    assert gpt2["n_embd"] // gpt2["n_head"] == 64
    n = sum(math.prod(s) for s, kind in chip_smoke.hf_layout(
        "gpt2", gpt2).values() if not kind.startswith("tied:"))
    assert 124e6 < n < 125e6
    # Mixtral: head_dim 128, group 4, 46.7 B params whole, ~3.2 B at 2
    assert mixtral["hidden_size"] // mixtral["num_attention_heads"] == 128
    n = sum(math.prod(s) for s, _ in chip_smoke.hf_layout(
        "mixtral", mixtral).values())
    assert 46.6e9 < n < 46.8e9
    cut = chip_smoke.hf_config("mixtral", chip_smoke.HF_MIXTRAL_LAYERS)
    n = sum(math.prod(s) for s, _ in chip_smoke.hf_layout(
        "mixtral", cut).values())
    assert 3.1e9 < n < 3.3e9
    ours = convert_mod.mixtral_config(cut)
    assert ours.moe_capacity_factor == 4.0 and ours.max_seq_len == 32768
    # bert-base-uncased
    assert (bert["hidden_size"], bert["num_hidden_layers"],
            bert["vocab_size"]) == (768, 12, 30522)


def test_full_depth_guard_and_the_export_childs_window(monkeypatch,
                                                      tmp_path):
    """Phases 18 and 21 keep their full depth unless the run reaches
    them after FULL_DEPTH_BY_S; phase 23's export child is joined once,
    and its window is given on the run's ``at_s`` clock."""
    import json
    import time

    for late, fleet_full, hf_full in ((100, True, True),
                                      (500, False, True),
                                      (1000, False, False)):
        monkeypatch.setattr(chip_smoke, "T0", time.monotonic() - late)
        assert chip_smoke.full_depth("fleet") is fleet_full
        assert chip_smoke.full_depth("hf_train") is hf_full
    monkeypatch.setattr(chip_smoke, "T0", time.monotonic() - 300)

    class Proc:
        joins = 0

        def wait(self, timeout=None):
            Proc.joins += 1
            return 0

    child = object.__new__(chip_smoke.PredictExport)
    child.dir, child.proc, child.numbers = str(tmp_path / "vit"), Proc(), None
    child.t0 = chip_smoke.T0 + 100
    with open(child.dir + ".json", "w") as f:
        json.dump({"export_total_s": 90.0, "ended_wall": time.time() - 50},
                  f)
    got = child.wait()
    assert got["export_started_at_s"] == 100.0
    assert abs(got["export_ended_at_s"] - 250.0) <= 1.0
    assert "ended_wall" not in got and got["export_total_s"] == 90.0
    assert child.wait() is got and Proc.joins == 1


def test_predict_phase_is_vit_b16_under_its_traffic():
    from tensorflowonspark_tpu_torch import serve
    from tensorflowonspark_tpu_torch.models import vit

    cfg = vit.ViTConfig(**chip_smoke.PREDICT_VIT)
    base = vit.ViTConfig(dtype="float32")
    assert cfg == base and (cfg.image_size, cfg.patch_size, cfg.d_model,
                            cfg.n_heads, cfg.n_layers, cfg.d_ff,
                            cfg.num_classes) == (224, 16, 768, 12, 12, 3072,
                                                 1000)
    assert cfg.d_model // cfg.n_heads == 64      # kernel 4's head_dim
    assert (chip_smoke.PREDICT_CLIENTS, chip_smoke.PREDICT_REQUESTS,
            chip_smoke.PREDICT_IMAGES, chip_smoke.PREDICT_AOT_BATCH) == (
                4, 4, 8, 8)
    args = serve.build_argparser().parse_args(
        ["--export_dir", "d", *chip_smoke.PREDICT_ARGV])
    assert (args.batch_wait_ms, args.batch_size, args.engine) == (5.0, 32,
                                                                  "auto")
    assert chip_smoke.pct([1, 2, 3, 4], 0.5) == 3
    assert chip_smoke.pct([1, 2, 3, 4], 0.95) == 4


def test_predict_phase_servers_and_burst_on_the_cpu(vit_aot_export,
                                                    monkeypatch):
    import json

    from tensorflowonspark_tpu_torch import ops

    d, _, _ = vit_aot_export
    monkeypatch.setattr(chip_smoke, "PREDICT_REQUESTS", 2)
    rng = np.random.RandomState(7)
    images = rng.randint(0, 256, (chip_smoke.PREDICT_CLIENTS, 3, 8, 8, 3))
    bodies = [json.dumps({"instances": [{"image": i.tolist()} for i in imgs]})
              .encode() for imgs in images]
    ref = None
    for engine in chip_smoke.PREDICT_ENGINES:
        with chip_smoke.PredictServer(d, "cpu", "--engine", engine,
                                      *chip_smoke.PREDICT_ARGV) as srv:
            ops.reset_launch_counts()
            outs, lat, wall = chip_smoke.predict_burst(srv.url, bodies)
            assert len(outs) == len(lat) == 8 and wall > 0
            assert srv.service.requests == 8
            assert 1 <= srv.service._batcher.executions <= 8
            # the CPU runs the plain version through the dispatcher op
            assert ops.launch_counts(("flash_fwd",)) == {"flash_fwd": 0}
            assert srv.service.desc.startswith(
                "builder(" if engine == "builder" else f"aot(engine={engine}")
            # what the phase times on device tensors, at the artifact's
            # batch
            run = chip_smoke.predict_runner(srv)
            with torch.no_grad():
                logits = run(torch.rand(4, 8, 8, 3) * 255)
            assert tuple(logits.shape) == (4, 5)
        ref = ref or outs
        scale = max(float(np.abs(o).max()) for o in ref.values())
        for key, o in outs.items():
            assert o.shape == (3, 5)
            assert np.abs(o - ref[key]).max() <= chip_smoke.PREDICT_RTOL * \
                scale


def test_predict_profile_captures_while_the_server_executes(
        vit_aot_export, monkeypatch):
    import json

    from tensorflowonspark_tpu_torch.utils import profiling

    d, _, _ = vit_aot_export
    rng = np.random.RandomState(8)
    images = rng.randint(0, 256, (chip_smoke.PREDICT_CLIENTS, 3, 8, 8, 3))
    bodies = [json.dumps({"instances": [{"image": i.tolist()} for i in imgs]})
              .encode() for imgs in images]
    # the CPU trace holds neither device events nor the server threads'
    # ops (torch.profiler records host ops of its own thread): count the
    # executions inside the capture, and hand the check one flash row
    during, servers = [], []
    trace = profiling.trace

    @contextlib.contextmanager
    def watched(log_dir):
        with trace(log_dir) as prof:
            n = servers[0].service._batcher.executions
            yield prof
            during.append(servers[0].service._batcher.executions - n)

    monkeypatch.setattr(profiling, "trace", watched)
    monkeypatch.setattr(profiling, "parse_trace",
                        lambda path: [("tos::flash_fwd_kernel", 1.0, 1)])
    monkeypatch.setattr(chip_smoke, "PREDICT_PROFILE_MS", 300)
    with chip_smoke.PredictServer(d, "cpu", "--engine", "builder",
                                  *chip_smoke.PREDICT_ARGV) as srv:
        servers.append(srv)
        prof = chip_smoke.predict_profile(torch, srv, bodies)
        assert not srv.service._profile_lock.locked()
    assert (prof["status"], prof["overlapping_status"],
            prof["duration_ms"]) == (200, 409, 300)
    assert len(during) == 1 and during[0] >= 1


def test_spec_v1_run_on_a_tiny_flagship(monkeypatch):
    from tensorflowonspark_tpu_torch import benchmarks

    tiny = dict(benchmarks.FLAGSHIP_LM_V2, vocab_size=64, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, n_layers=3,
                dtype="float32", attention_impl="dense")
    monkeypatch.setattr(benchmarks, "FLAGSHIP_LM_V2", tiny)
    monkeypatch.setattr(chip_smoke, "SPEC_V1", dict(
        chip_smoke.SPEC_V1, lens=(5, 9, 3, 12, 7, 4, 10, 6)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    out = chip_smoke.spec_v1_run(torch, torch.device("cpu"))
    assert out["rows"] == 8 and out["k"] == 4 and out["new_tokens"] == 32
    assert out["rows_equal"] == 8 and out["dtype"] == "float32"
    assert len(out["commits_per_round"]) == out["rounds"]
    assert 1 <= out["mean_commit"] <= 4


def test_workload_phase_traffic_is_bench_pys_and_its_cut():
    """Phase 24's whole traffic is the JAX package's bench.py segments'
    (steps, windows, bursts a configuration, migrations, configurations),
    the smoke's cut departs only in traffic, and the phase keeps its
    full depth unless the run reaches it after FULL_DEPTH_BY_S."""
    import time

    whole, smoke = chip_smoke.A8D_WHOLE, chip_smoke.A8D_SMOKE
    assert (whole["decode_steps"], whole["prefill_steps"], whole["windows"],
            whole["reps"], whole["migrate_reps"]) == (32, 16, 3, 3, 5)
    assert whole["engines"] == (("async", None), ("serial", None),
                                ("async", "int8"))
    assert whole["spec_modes"] == ("ngram", "model", "off")
    assert whole["sched"] == whole["long"] == (True, False)
    assert whole["prefill_rows"] == (4, 1) and whole["warm_warmup"]
    assert set(smoke) == set(whole) and chip_smoke.a8d_cuts(whole) == {}
    cuts = chip_smoke.a8d_cuts(smoke)
    assert cuts["max_new"] == 24 and cuts["long"] == (True,)
    assert chip_smoke.A8D_DECODE_MODES == (None, "int8", "int4")
    gate = chip_smoke.FULL_DEPTH_BY_S["workloads"]
    for late, full in ((gate - 10, True), (gate + 10, False)):
        chip_smoke.T0, saved = time.monotonic() - late, chip_smoke.T0
        try:
            assert chip_smoke.full_depth("workloads") is full
        finally:
            chip_smoke.T0 = saved


def test_workload_phase_on_a_tiny_flagship(monkeypatch):
    """Phase 24 on the CPU over a tiny stand-in for the flagship and
    small frozen shapes: one ``workload`` line a builder, every check
    held (the steps against their CPU twins, the qmm op against its
    plain version, each burst's handles and counters), the launches of
    kernels 1-3, 9 and 10 summed for the kernels line."""
    import json
    import time

    from tensorflowonspark_tpu_torch import benchmarks as bm
    from tensorflowonspark_tpu_torch import ops

    monkeypatch.setattr(bm, "FLAGSHIP_LM_V2", dict(
        bm.FLAGSHIP_LM_V2, vocab_size=64, d_model=64, n_heads=4,
        n_kv_heads=2, n_layers=2, d_ff=128))
    monkeypatch.setattr(bm, "FLAGSHIP_DECODE", dict(
        bm.FLAGSHIP_DECODE, max_seq=256, fill=100))
    monkeypatch.setattr(bm, "FLAGSHIP_PREFILL_KERNEL", dict(
        bm.FLAGSHIP_PREFILL_KERNEL, max_seq=256, fill=100, chunk=32))
    monkeypatch.setattr(bm, "FLAGSHIP_SPEC", dict(
        bm.FLAGSHIP_SPEC, prompts=4, max_new=12, draft_layers=1))
    monkeypatch.setattr(bm, "FLAGSHIP_QMM", dict(bm.FLAGSHIP_QMM,
                                                 in_dim=256, out_dim=512))
    monkeypatch.setattr(bm, "FLAGSHIP_LONG", dict(
        bm.FLAGSHIP_LONG, long_prompt_len=512, long_prompt_threshold=128,
        kv_pages=40, max_seq=544, host_cache_mb=1))

    class Event:
        def __init__(self, **kw):
            self.t = 0.0

        def record(self):
            self.t = time.perf_counter()

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, reps=25, warmup=3: (fn(), 1.0)[1])
    # the plain versions count no launches: every wrapper "launches" once
    # a read, so the checks on the counts can pass
    kernels = ("paged_attention", "page_write", "prefill_read",
               "int8_matmul", "int4_matmul")
    monkeypatch.setattr(ops, "launch_counts",
                        lambda names=None: {k: 1 for k in kernels})
    printed = []
    monkeypatch.setattr(chip_smoke, "emit", lambda phase, **kw: printed.append(
        json.loads(json.dumps({"phase": phase, **kw}))))
    out, launches = chip_smoke.phase_workloads(torch, torch.device("cpu"),
                                               "card, 700.00 W")
    names = [line["builder"] for line in printed]
    assert names == out["builders"] == [
        "make_decode_step", "make_qmm_op", "make_prefill_chunk_step",
        "make_prefill_burst", "make_engine_burst", "make_spec_burst",
        "make_migrate_pair", "make_sched_burst", "make_warm_burst",
        "make_job_burst", "make_long_burst"]
    assert all(line["nvidia_smi"] == "card, 700.00 W" and line["cuts"]
               for line in printed)
    assert set(launches) == set(kernels) and all(
        n >= 11 for n in launches.values())
    by = {line["builder"]: line for line in printed}
    decode = by["make_decode_step"]["modes"]
    assert set(decode) == {"bf16", "int8", "int4"}
    for mode in decode.values():
        assert mode["check"]["max_abs_diff"] <= mode["check"]["tol"]
    assert by["make_prefill_chunk_step"]["check"]["max_abs_diff"] <= \
        by["make_prefill_chunk_step"]["check"]["tol"]
    assert by["make_spec_burst"]["runs"]["ngram"]["spec_rounds"] > 0
    assert by["make_migrate_pair"]["migrations_completed"] == 2
    assert by["make_sched_burst"]["runs"]["armed"]["sessions_parked"] > 0
    assert by["make_warm_burst"]["host_hits"] > 0
    assert by["make_job_burst"]["records_done"] == 64
    long_run = by["make_long_burst"]["runs"]["armed"]
    assert long_run["long_chunks_dispatched"] > 0
    assert long_run["kv_table_grows"] > 0


def test_tp_serving_phase_is_phase_5s_traffic_at_tp_4s_local_shapes():
    from tensorflowonspark_tpu_torch.benchmarks import FLAGSHIP_LM_V2

    assert chip_smoke.A3C_TPS == (2, 4) and chip_smoke.A3C_KV == (
        "auto", "int8")
    assert chip_smoke.A3C_ENGINE == dict(n_slots=8, prefill_chunk=256,
                                         kv_page_size=64, kv_pages=512)
    assert chip_smoke.ENGINE_LENS == (100, 300, 500, 700, 900, 1100, 1300,
                                      1500) and chip_smoke.ENGINE_NEW == 32
    tp = chip_smoke.A3C_LOCAL_TP
    assert (FLAGSHIP_LM_V2["n_heads"] // tp,
            FLAGSHIP_LM_V2["n_kv_heads"] // tp) == (4, 2)


def _tiny_a3c(monkeypatch):
    """A tiny stand-in for the flagship (8 q over 4 kv heads, so tp 4
    keeps 2 and 1 a rank), small frozen shapes, no card calls."""
    from tensorflowonspark_tpu_torch import benchmarks as bm

    monkeypatch.setattr(bm, "FLAGSHIP_LM_V2", dict(
        bm.FLAGSHIP_LM_V2, vocab_size=64, d_model=64, n_heads=8,
        n_kv_heads=4, n_layers=2, d_ff=128))
    monkeypatch.setattr(bm, "FLAGSHIP_DECODE", dict(
        bm.FLAGSHIP_DECODE, max_seq=256, fill=100))
    monkeypatch.setattr(bm, "FLAGSHIP_PREFILL_KERNEL", dict(
        bm.FLAGSHIP_PREFILL_KERNEL, max_seq=256, fill=100, chunk=32))
    monkeypatch.setattr(bm, "FLAGSHIP_SPEC", dict(
        bm.FLAGSHIP_SPEC, prompts=4, max_new=12, draft_layers=1))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, reps=25, warmup=3: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "bound", lambda nbytes, flops: (1.0,
                                                                    "bytes"))


def test_tp_serving_phase_on_one_card_checks_the_kernels(monkeypatch):
    _tiny_a3c(monkeypatch)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    out, launches = chip_smoke.phase_a3c(torch, torch.device("cpu"),
                                         "card, 700.00 W")
    assert launches == {} and out["cards"] == 1 and "tp1" not in out
    k = out["kernels"]
    assert (k["tp"], k["H"], k["n_kv"]) == (4, 2, 1)
    for kv in ("bf16", "int8"):
        assert set(k[kv]) == {"paged_attention", "page_write",
                              "prefill_read"}
        for row in k[kv].values():
            assert row["max_abs_err"] <= chip_smoke.TOL
    shapes = chip_smoke.a3c_local_projections(tp=4)
    # the tiny flagship's rank: d_model 64 over 8 q / 4 kv heads, d_ff 128
    assert shapes == {"query": (64, 16), "key_value": (64, 8),
                      "out": (16, 64), "wi": (64, 32), "wo": (32, 64),
                      "lm_head": (64, 16)}
    q = k["quant_matmul"]
    assert set(q) == {f"{mode}_{proj}_m{m}" for mode in ("int8", "int4")
                      for proj in shapes for m in chip_smoke.A3C_QMM_M}
    for row in q.values():
        assert (row["K"], row["N"]) in shapes.values()
        assert row["max_abs_err"] <= row["tol"]


def test_tp_serving_phase_summary_holds_the_ranks(monkeypatch):
    import copy

    from tensorflowonspark_tpu_torch import benchmarks as bm
    from tensorflowonspark_tpu_torch import ops

    _tiny_a3c(monkeypatch)
    dev = torch.device("cpu")
    ref = chip_smoke.a3c_serve(torch, dev)
    assert set(ref["runs"]) == {"auto", "int8", "w_int8", "w_int4",
                                "spec_ngram", "spec_model"}
    assert set(ref["weight_bytes"]) == {"bf16", "int8", "int4"}
    assert (ref["weight_bytes"]["int4"] < ref["weight_bytes"]["int8"]
            < ref["weight_bytes"]["bf16"])
    prompts = chip_smoke.engine_prompts(torch,
                                        bm.FLAGSHIP_LM_V2["vocab_size"])
    for label in ("auto", "w_int8", "w_int4"):
        assert all(len(o) == len(p) + chip_smoke.ENGINE_NEW for o, p in
                   zip(ref["runs"][label]["outputs"], prompts))
    for mode in chip_smoke.A3C_SPEC:
        run = ref["runs"][f"spec_{mode}"]
        assert run["spec_rounds"] > 0
        assert run["one_at_a_time"]["spec_rounds"] > 0
    model = chip_smoke.a3c_model(torch, dev)
    ref_models = chip_smoke.A3cRefModels(torch, dev)
    lead = copy.deepcopy(ref)
    lead["generate"] = [o for o in ref["runs"]["auto"]["outputs"][
        :chip_smoke.A3C_GENERATE]]
    lead["device"] = "card"
    for label in lead["runs"]:
        lead["runs"][label]["launches"] = {
            n: 3 for n in chip_smoke.a3c_kernels(label)}
    for label in ("spec_ngram", "spec_model"):
        one = lead["runs"][label]["one_at_a_time"]
        assert one == ref["runs"][label]["one_at_a_time"]
    follower = copy.deepcopy(lead)
    follower.update(rank=1, leader=False)
    numbers, launches = chip_smoke.a3c_summary(torch, 2, [lead, follower],
                                               ref, ref_models)
    assert launches == dict(
        {n: 18 for n in ops.SERVING_KERNELS},
        **{n: 6 for n in ops.SERVING_KERNELS_INT8_KV},
        int8_matmul=6, int4_matmul=6)
    assert numbers["runs"]["auto"]["equal_to_one_card"] == len(prompts)
    assert numbers["runs"]["auto"]["solo_near_tie"] is None
    assert numbers["runs"]["spec_model"]["one_at_a_time"][
        "tokens_equal_to_one_card"]
    for broken in ("registers", "generate", "launches", "solo", "spec",
                   "spec_one_at_a_time"):
        bad, lead2 = copy.deepcopy(follower), copy.deepcopy(lead)
        if broken == "registers":
            bad["runs"]["int8"]["registers"]["_toks"][0] += 1
        elif broken == "generate":
            bad["generate"][0][-1] = (bad["generate"][0][-1] + 1) % 64
        elif broken == "launches":
            bad["runs"]["w_int4"]["launches"]["int4_matmul"] = 0
        elif broken == "spec":
            bad["runs"]["spec_ngram"]["spec_tokens_accepted"] += 1
        elif broken == "spec_one_at_a_time":
            # the leader's counters, off tp 1's with the same tokens
            for r in (lead2, bad):
                r["runs"]["spec_model"]["one_at_a_time"]["spec_rounds"] += 1
        else:
            # a solo answer that parts from its burst twin at the first
            # new position where the model's top-2 margin is no tie
            solo = lead2["runs"]["auto"]["solo"]
            with torch.no_grad():
                for at in range(len(prompts[3]), len(solo)):
                    logits = model(torch.tensor([solo[:at]]))[0, -1].float()
                    top = logits.topk(2).values
                    if (top[0] - top[1]).item() > chip_smoke.SPEC_MARGIN:
                        break
                else:
                    pytest.fail("no position off a tie")
            solo[at] = int(logits.argmin())
        with pytest.raises(AssertionError, match="phase 25"):
            chip_smoke.a3c_summary(torch, 2, [lead2, bad], ref, ref_models)
