#!/usr/bin/env python3
"""Two checkouts of the port on one card, in one call: the host cost of
the eager kernel wrappers (kernels 4 and 11 through their dispatcher
ops, ``tos::flash_fwd`` and ``tos::layernorm``, against a checkout that
launches them directly).

Each checkout runs in its own process, in the order A B B A, each doing:

- ``fused_layernorm`` at phase 5's decode shape (8 x 2048 bf16): host
  microseconds a call over LN_CALLS eager calls (the launches queue; one
  synchronize at the end), and the launch count;
- a bare decode loop, one thread: ``models.decode.slot_step`` over a
  full-depth ``FLAGSHIP_LM`` with ``fused_ln=True`` (bf16 weights, 8
  rows at position 512 of a paged cache), host and wall ms a step over
  DECODE_STEPS steps;
- ``chip_smoke.phase_main_path`` over a full-depth ``FLAGSHIP_LM`` export
  with ``fused_ln=True`` (phase 5's fused-LN run, the threaded serving
  engine): decode step median, mean and max, burst tokens/s; then again
  with the interpreter's switch interval at SHORT_SWITCH_S (a GIL
  hand-off between the engine's threads waits at most that long);
- ``chip_smoke.phase_train_main`` (phase 8, ``make_flagship_step`` at B 8
  x S 1024): step ms.

    python3 scripts/torch_eager_dispatch_ab.py CHECKOUT_A CHECKOUT_B

Each checkout builds its own kernels under its ``build/``.  Prints the
card's name and power limit, one JSON line a process and a last JSON
line with both checkouts' medians.  Needs one CUDA device; exits 2
without one.
"""
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

LN_CALLS = 2000
LN_SHAPE = (8, 2048)
DECODE_STEPS = 50
SHORT_SWITCH_S = 0.0005


def decode_loop(torch, dev, cfg_kw):
    """Host and wall ms a step of ``slot_step`` alone in one thread."""
    from tensorflowonspark_tpu_torch import quantize
    from tensorflowonspark_tpu_torch.models import decode as dm
    from tensorflowonspark_tpu_torch.models.transformer import (
        Transformer, TransformerConfig)

    cfg = TransformerConfig(**dict(cfg_kw, max_seq_len=1024))
    with torch.device(dev):
        model = Transformer(cfg)
    model.reset_parameters(torch.Generator(dev).manual_seed(0))
    quantize.cast_float_leaves(model.eval().requires_grad_(False),
                               torch.bfloat16)
    rows, page, per = 8, 64, 16
    _, cache = dm.init_paged_slot_cache(model, rows, page, rows * per + 1)
    for r in range(rows):
        dm.set_row_page_table(cache, r, torch.arange(
            r * per, (r + 1) * per, dtype=torch.int32, device=dev))
    dm.set_row_indices(cache, torch.arange(rows, device=dev),
                       torch.full((rows,), 512, dtype=torch.int32,
                                  device=dev))
    toks = torch.zeros(rows, dtype=torch.int64, device=dev)
    temps = torch.zeros(rows, dtype=torch.float32, device=dev)
    seeds = torch.zeros(rows, dtype=torch.int32, device=dev)
    with torch.no_grad():
        for _ in range(5):
            toks = dm.slot_step(model, cache, toks, temps, seeds, seeds)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(DECODE_STEPS):
            toks = dm.slot_step(model, cache, toks, temps, seeds, seeds)
        host = (time.perf_counter() - t) * 1e3 / DECODE_STEPS
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / DECODE_STEPS
    del model, cache
    torch.cuda.empty_cache()
    return host, wall


def one(root):
    import torch

    if not torch.cuda.is_available():
        print("torch_eager_dispatch_ab: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from tensorflowonspark_tpu_torch import ops
    from tensorflowonspark_tpu_torch.benchmarks import FLAGSHIP_LM
    from tensorflowonspark_tpu_torch.ops import _build, layernorm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(LN_SHAPE, generator=gen, device=dev).bfloat16()
    w = torch.randn(LN_SHAPE[1], generator=gen, device=dev).bfloat16()
    b = torch.randn(LN_SHAPE[1], generator=gen, device=dev).bfloat16()
    with torch.no_grad():
        for _ in range(50):
            layernorm.fused_layernorm(x, w, b)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t = time.perf_counter()
        for _ in range(LN_CALLS):
            layernorm.fused_layernorm(x, w, b)
        host_us = (time.perf_counter() - t) * 1e6 / LN_CALLS
        torch.cuda.synchronize()
        ln_launches = ops.launch_counts()["layernorm"]
    loop_host, loop_wall = decode_loop(torch, dev,
                                       dict(FLAGSHIP_LM, fused_ln=True))
    cfg, export_dir, _ = cs.make_flagship_export(
        torch, dev, FLAGSHIP_LM, name="export_fused_ln_ab", fused_ln=True)
    default_switch = sys.getswitchinterval()
    try:
        _, serve = cs.phase_main_path(torch, dev, cfg, export_dir)
        torch.cuda.empty_cache()
        sys.setswitchinterval(SHORT_SWITCH_S)
        _, serve_short = cs.phase_main_path(torch, dev, cfg, export_dir)
    finally:
        sys.setswitchinterval(default_switch)
        import shutil
        shutil.rmtree(export_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    _, train = cs.phase_train_main(torch, dev)
    print(json.dumps({
        "root": root, "ln_host_us_a_call": host_us,
        "ln_launches": ln_launches, "ln_calls": LN_CALLS,
        "decode_loop_host_ms_a_step": loop_host,
        "decode_loop_wall_ms_a_step": loop_wall,
        "fused_ln_decode_step_ms_p50": serve["decode_step_ms_p50"],
        "fused_ln_decode_step_ms": serve["decode_step_ms"],
        "fused_ln_decode_step_ms_max": serve["decode_step_ms_max"],
        "fused_ln_burst_new_tokens_per_s": serve["burst_new_tokens_per_s"],
        "fused_ln_decode_step_ms_p50_short_switch": serve_short[
            "decode_step_ms_p50"],
        "fused_ln_burst_new_tokens_per_s_short_switch": serve_short[
            "burst_new_tokens_per_s"],
        "switch_interval_s": [default_switch, SHORT_SWITCH_S],
        "train_step_ms": train["step_ms"]}), flush=True)
    return 0


def main(a, b):
    import torch

    if not torch.cuda.is_available():
        print("torch_eager_dispatch_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = {a: [], b: []}
    for root in (a, b, b, a):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], capture_output=True, text=True)
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode:
            print(res.stdout[-4000:])
            return res.returncode
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith('{"root"')][-1]
        print(line, flush=True)
        runs[root].append(json.loads(line))
    keys = [k for k in runs[a][0] if k not in ("root", "ln_calls",
                                               "ln_launches",
                                               "switch_interval_s")]
    print(json.dumps({"nvidia_smi": card, **{
        label: {k: statistics.median(r[k] for r in runs[root])
                for k in keys}
        for label, root in (("a", a), ("b", b))}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        sys.exit(one(sys.argv[2]))
    sys.exit(main(*sys.argv[1:3]))
