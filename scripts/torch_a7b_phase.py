#!/usr/bin/env python3
"""Phase 18 of ``chip_smoke.py`` alone, on one card: the port's fleet
gateway (in process, with ``--jobs_dir``) in front of two full-depth
flagship replicas that join through ``serve``'s ``--fleet`` path:
gateway-driven disaggregation (``--role prefill`` -> ``decode``), the
stitched trace and the scrape, ``/v1/fleet:migrate`` of live sessions,
prefix affinity and the gateway's cost against direct requests, a bulk
job beside interactive traffic, a replica killed mid-stream and its
journals re-driven; then kernels 1 and 3 on a re-driven row's pages.

    python3 scripts/torch_a7b_phase.py

Prints the card's name and power limit, then one ``fleet_leg`` line a
leg, the phase's JSON line (``"phase": "fleet_main_path"``) and the
serving kernels' launches in it.  Needs one CUDA device; exits 2
without one.
"""
import importlib.util
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_a7b_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from tensorflowonspark_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi()
    print(card, flush=True)
    dev = torch.device("cuda")
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    info = _build.build(force=True)
    cs.emit("build", seconds=info["seconds"])
    cfg, export_dir, _ = cs.make_flagship_export(torch, dev)
    try:
        out, launches = cs.phase_fleet(torch, dev, cfg, export_dir, card)
        cs.emit("fleet_main_path", **out)
        cs.emit("fleet_launches", nvidia_smi=card, kernels=launches)
    finally:
        shutil.rmtree(export_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
