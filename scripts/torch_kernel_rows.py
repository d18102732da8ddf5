#!/usr/bin/env python3
"""The serving and training kernel rows of ``chip_smoke.py`` (phases 3,
5d and 6: paged decode, page write and prefill read over a bf16 and over
an int8 kv pool, flash forward, dq, dk/dv and fused AdamW at the flagship
shapes, each against its plain version, with CUDA-event times beside the
bound and the library call, and its ``-Xptxas -v`` figures), without the
main paths, for one checkout of the port.

    python3 scripts/torch_kernel_rows.py [--root DIR]

``--root`` is the checkout whose kernels are built (from a clean build
directory) and timed (default: the one holding this script), so two
versions of a kernel compare on one card in one call by running this
script in turns over two checkouts (A, B, B, A).  Prints the card's name
and power limit, then one JSON object per row, each with the checkout it
came from.  Needs one CUDA device; exits 2 without one.
"""
import argparse
import json
import os
import shutil
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_kernel_rows: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke
    from tensorflowonspark_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.nvidia_smi(), flush=True)
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    built = chip_smoke.ptxas_kernels(_build.build(force=True)["ptxas"])
    dev = torch.device("cuda")
    rows = chip_smoke.phase_kernels(torch, F, dev)
    torch.cuda.empty_cache()
    rows.update(chip_smoke.phase_int8_kernels(torch, F, dev))
    torch.cuda.empty_cache()
    rows.update(chip_smoke.phase_train_kernels(torch, F, dev))
    # a checkout whose chip_smoke.py predates the rows' ptxas figures
    # prints its rows without them
    if hasattr(chip_smoke, "attach_ptxas"):
        chip_smoke.attach_ptxas(rows, built)
    for row in rows.values():
        print(json.dumps(dict(row, root=root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
