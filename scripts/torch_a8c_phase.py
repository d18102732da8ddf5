#!/usr/bin/env python3
"""Phase 23 of ``chip_smoke.py`` alone, on one card: ViT-B/16 (published
width and depth, seeded f32 weights) exported with the port's AOT
artifacts at batch 8 — the ``torch.export`` program and the AOTInductor
package, kernel 4 inside both as the ``tos::flash_fwd`` op — and served
over ``:predict`` by three servers in turn (``--engine builder``,
``jax``, ``native``; ``--batch_wait_ms 5 --batch_size 32``) to 4
concurrent clients x 4 requests x 8 images; ``/v1/debug:profile``
during a burst; kernel 4 against its plain version at :predict's
shapes; speculation v1 on the full-depth flagship with a 2-layer draft.

    python3 scripts/torch_a8c_phase.py

Prints the card's name and power limit, the build, the profile's top 5
kernels, the phase's JSON line (``predict_main_path``) and kernel 4's
launches in it (``a8c_launches``).  Needs one CUDA device; exits 2
without one.
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
        print("torch_a8c_phase: no CUDA device", file=sys.stderr)
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
    # the export's child starts here and the phase waits for it at once
    predict, launches = cs.phase_predict(torch, dev, card)
    cs.emit("predict_main_path", **predict)
    cs.emit("a8c_launches", nvidia_smi=card, kernels=launches,
            seconds=time.monotonic() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
