#!/usr/bin/env python3
"""Phases 21 and 22 of ``chip_smoke.py`` alone, on one card:
TinyLlama-1.1B, GPT-2 and Mixtral-8x7B (2 of its layers) converted from
seeded HuggingFace-layout state dicts by the port's ``from_hf_*`` and
served by the paged server (kernels 1-3), TinyLlama fine-tuned with an
asynchronous checkpoint round trip, summaries and an eval perplexity
(kernels 4-7), BERT-base converted and trained; then the MNIST example
(``examples/mnist/torch_mnist_spark.py --platform cuda``) trained,
resumed and its export scored.

    python3 scripts/torch_a8b_phase.py

Prints the card's name and power limit, the build, one ``hf_model``
line a model, the phases' JSON lines (``hf_main_path``,
``mnist_main_path``) and the kernels' launches in them.  Needs one CUDA
device; exits 2 without one.
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
        print("torch_a8b_phase: no CUDA device", file=sys.stderr)
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
    hf, launches = cs.phase_hf(torch, dev, card)
    cs.emit("hf_main_path", **hf)
    torch.cuda.empty_cache()
    t = time.monotonic()
    mnist = cs.phase_mnist(torch, dev, card)
    cs.emit("mnist_main_path", seconds=time.monotonic() - t, **mnist)
    cs.emit("a8b_launches", nvidia_smi=card, kernels=launches,
            seconds=time.monotonic() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
