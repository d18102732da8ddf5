#!/usr/bin/env python3
"""Phases 13 and 14 of ``chip_smoke.py`` alone: the full-width flagship
trained as one cluster, one rank per visible GPU (``cluster.run`` over
``LocalBackend(n, start_method="spawn")``, nccl), on a dp mesh, an fsdp
mesh and the fsdp mesh with adamw8bit (phase 13), then with its forward
split over tp, tp + sp, ring and Ulysses context parallelism and a
pipeline, and tp with adamw8bit (phase 14), held to the direct
one-process step; without the other phases.

    python3 scripts/torch_sharded_phase.py

Prints the cards' names and power limits, ``nvidia-smi topo -m`` (the
links between the cards; where it fails, ``nvidia-smi nvlink
--status``) and a ``peer_access`` line (``torch.cuda.
can_device_access_peer`` between every two cards), builds the kernels
from a clean build directory, then prints the ``sharded_main_path`` and
``model_parallel_main_path`` JSON lines.  Needs a CUDA device; exits 2
without one.
"""
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_sharded_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    from tensorflowonspark_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.nvidia_smi()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(cards.stdout, flush=True)
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    print(topo.stdout or topo.stderr, flush=True)
    if topo.returncode:
        # the links another way: NVLink state, and peer access by torch
        links = subprocess.run(["nvidia-smi", "nvlink", "--status"],
                               capture_output=True, text=True, timeout=60)
        print(links.stdout or links.stderr, flush=True)
    n = torch.cuda.device_count()
    chip_smoke.emit("peer_access", matrix=[
        [i == j or torch.cuda.can_device_access_peer(i, j)
         for j in range(n)] for i in range(n)])
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    info = _build.build(force=True)
    chip_smoke.emit("build", seconds=info["seconds"])
    dev = torch.device("cuda")
    sharded = chip_smoke.phase_sharded(torch, dev)
    chip_smoke.emit("sharded_main_path", nvidia_smi=card, **sharded)
    chip_smoke.emit("model_parallel_main_path", nvidia_smi=card,
                    **chip_smoke.phase_model_parallel(
                        torch, dev, sharded["direct_losses"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
