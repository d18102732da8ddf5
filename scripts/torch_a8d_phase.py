#!/usr/bin/env python3
"""Phase 24 of ``chip_smoke.py`` alone, on one card, with its whole
traffic: every workload builder of the port's ``benchmarks`` module at
the flagship's full width and depth, driven as the JAX package's
``bench.py`` segments drive them (``chip_smoke.A8D_WHOLE``: 32 decode
steps x 3 windows in bf16, int8 and int4; the qmm op in each mode; 16
prefill chunk dispatches x 3 windows; 3 bursts of each configuration of
the prefill, engine and spec bursts; 5 migrations; the sched burst armed
and disarmed; the warm burst's throwaway, cold and warm passes; a
64-record job; the 32,768-token long burst with the lane armed and
disarmed).  Each builder's ``workload`` line holds its check (the steps
against the same step on the CPU at 2 layers, the qmm op against its
plain version, every burst handle complete and its counter moved).

    python3 scripts/torch_a8d_phase.py

Prints the card's name and power limit, the build, one ``workload`` line
a builder, the ``workloads_main_path`` line and the phase's kernel
launches (``a8d_launches``).  Needs one CUDA device; exits 2 without
one.
"""
import importlib.util
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_a8d_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from tensorflowonspark_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.nvidia_smi()
    print(card, flush=True)
    dev = torch.device("cuda")
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    info = _build.build(force=True)
    cs.emit("build", seconds=info["seconds"])
    t0 = time.monotonic()
    lines, launches = cs.phase_workloads(torch, dev, card, whole=True)
    cs.emit("workloads_main_path", nvidia_smi=card, launches=launches,
            **lines)
    cs.emit("a8d_launches", nvidia_smi=card, kernels=launches,
            seconds=time.monotonic() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
