#!/usr/bin/env python3
"""Phase 25 of ``chip_smoke.py`` alone: kernels 1-3, 9 and 10 at the
flagship's tp-4 local shapes against their plain versions, then, with 2
or more visible GPUs, the full-depth flagship served tensor-parallel at
tp 2 and tp 4 (one rank a GPU: ``cluster.run`` over ``LocalBackend(tp,
start_method="spawn")``, nccl), checked against the one-card batcher in
this process: phase 5's traffic with bf16 weights over the bf16 and int8
pools and with int8 and int4 weights, and FLAGSHIP_SPEC's burst with
n-gram and with the 4-layer draft; without the other phases.

    python3 scripts/torch_a3c_phase.py

Prints the cards' names and power limits and a ``peer_access`` line,
builds the kernels from a clean build directory, then prints the
``tp_serving_main_path`` JSON line (per run: tokens/s, decode step
median and max, TTFT, the speculation counters, kv pool bytes a rank,
the leader's device busy share and the header broadcast's host cost;
weight bytes a rank by weight mode; at tp 1, 2 and 4).  Needs a CUDA
device; exits 2 without one.
"""
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_a3c_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    from tensorflowonspark_tpu_torch.ops import _build

    chip_smoke._card_flags(torch)
    card = chip_smoke.nvidia_smi()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(cards.stdout, flush=True)
    n = torch.cuda.device_count()
    chip_smoke.emit("peer_access", matrix=[
        [i == j or torch.cuda.can_device_access_peer(i, j)
         for j in range(n)] for i in range(n)])
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    info = _build.build(force=True)
    chip_smoke.emit("build", seconds=info["seconds"])
    a3c, launches = chip_smoke.phase_a3c(torch, torch.device("cuda"), card)
    chip_smoke.emit("tp_serving_main_path", launches=launches, **a3c)
    return 0


if __name__ == "__main__":
    sys.exit(main())
