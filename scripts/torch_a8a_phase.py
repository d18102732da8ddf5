#!/usr/bin/env python3
"""Phases 19 and 20 of ``chip_smoke.py`` alone, on one card: the model
zoo (MnistMLP, MnistCNN, ResNet-56, ResNet-50, UNet, DeepLabV3,
ViT-B/16, BERT-base) trained through ``make_train_step`` with
``adamw_fused``, each model's 2-block cut against the CPU and kernels
4-6 at the encoders' non-causal shapes; then the MoE flagship
(``make_flagship_step(config="moe")``) beside phase 8's dense step, its
2-layer parity and the fused unembedding loss against ``lm_loss``.

    python3 scripts/torch_a8a_phase.py

Prints the card's name and power limit, one ``zoo_model`` line a model,
then the phases' JSON lines (``zoo_main_path``, ``moe_main_path``) and
the training kernels' launches in them.  Needs one CUDA device; exits 2
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
        print("torch_a8a_phase: no CUDA device", file=sys.stderr)
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
    _, phase8 = cs.phase_train_main(torch, dev, windows=1, profile=False)
    cs.emit("train_main_path", nvidia_smi=card, **phase8)
    torch.cuda.empty_cache()
    launches = {}
    for label, run in (("zoo_main_path", lambda: cs.phase_zoo(
            torch, dev, card)), ("moe_main_path", lambda: cs.phase_moe(
            torch, dev, card, phase8))):
        t0 = cs.time.monotonic()
        out, extra = run()
        cs.emit(label, seconds=cs.time.monotonic() - t0, **out)
        cs.add_launches(launches, extra)
        torch.cuda.empty_cache()
    cs.emit("a8a_launches", nvidia_smi=card, kernels=launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
