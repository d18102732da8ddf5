#!/usr/bin/env python3
"""The kernel rows of ``chip_smoke.py`` (phases 3, 5d and 6: paged
decode, page write and prefill read over a bf16 and over an int8 kv pool,
the fused LayerNorm, flash forward, dq, dk/dv and fused AdamW at the
flagship shapes, each against its plain version, with CUDA-event times
beside the bound, the timer's floor and the library call, and its
``-Xptxas -v`` figures), without the main paths, for one checkout of the
port.

    python3 scripts/torch_kernel_rows.py [--root DIR] [--phases LIST]

``--root`` is the checkout whose kernels are built (from a clean build
directory) and timed (default: the one holding this script); the rows
are measured by this script's own ``chip_smoke.py`` whatever the root,
so two versions of a kernel compare on one card in one call, under one
measurement, by running this script in turns over two checkouts (A, B,
B, A).  ``--phases`` picks phases from serving (3), int8 (5d),
layernorm (5d) and train (6); all by default.  Prints the card's name
and power limit, the timer's floor, then one JSON object per row, each
with the checkout it came from.  Needs one CUDA device; exits 2 without
one.
"""
import argparse
import importlib.util
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("serving", "int8", "layernorm", "train")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"--phases takes {PHASES}, got {phases}")
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_kernel_rows: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    # the package (and so the kernels) from the root, the measuring code
    # from this checkout
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from tensorflowonspark_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.nvidia_smi()
    print(card, flush=True)
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    built = chip_smoke.ptxas_kernels(_build.build(force=True)["ptxas"])
    dev = torch.device("cuda")
    floor_ms = chip_smoke.launch_floor_ms()
    print(json.dumps(dict(launch_floor_ms=floor_ms, nvidia_smi=card,
                          root=root)), flush=True)
    runs = dict(serving=chip_smoke.phase_kernels,
                int8=chip_smoke.phase_int8_kernels,
                layernorm=chip_smoke.phase_layernorm_kernel,
                train=chip_smoke.phase_train_kernels)
    rows = {}
    for name in phases:
        rows.update(runs[name](torch, F, dev))
        torch.cuda.empty_cache()
    chip_smoke.attach_ptxas(rows, built)
    chip_smoke.attach_floor(rows, floor_ms)
    for row in rows.values():
        print(json.dumps(dict(row, root=root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
