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
"""
import importlib.util
import os

import torch

from tensorflowonspark_tpu_torch import quantize
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
