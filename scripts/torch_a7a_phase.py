#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` alone, on one card: two replicas of the
flagship (full width, ``REPLICA_LAYERS`` of its layers, as chip_smoke
runs it) in one process move live sessions between them (the
paged pool in bf16 and int8, the dense cache), hand streams from a
prefill replica to a decode replica, serve a traced burst and the
scrape, a two-turn conversation through the host page tier and a peer
pull, and the mixed load with preemption armed and disarmed; then
demote / promote times and kernels 1 and 3 on resumed and promoted
pages.

    python3 scripts/torch_a7a_phase.py

Prints the card's name and power limit, then the phase's JSON line
(``"phase": "replicas_main_path"``) and the serving kernels' launches in
it.  Needs one CUDA device; exits 2 without one.
"""
import importlib.util
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_a7a_phase: no CUDA device", file=sys.stderr)
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
    from tensorflowonspark_tpu_torch.benchmarks import FLAGSHIP_LM_V2

    cfg, export_dir, _ = cs.make_flagship_export(
        torch, dev, n_layers=cs.REPLICA_LAYERS)
    try:
        out, launches = cs.phase_replicas(
            torch, dev, cfg, export_dir, card,
            tier_cfg=dict(cfg, n_layers=FLAGSHIP_LM_V2["n_layers"]))
        cs.emit("replicas_main_path", **out)
        cs.emit("replicas_launches", nvidia_smi=card, kernels=launches)
    finally:
        shutil.rmtree(export_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
