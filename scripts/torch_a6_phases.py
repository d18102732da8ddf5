#!/usr/bin/env python3
"""Phases 15 and 16 of ``chip_smoke.py`` alone, on one card: the
flagship export in the JAX package's format and as a stored int8 export,
then stop sequences, the repetition penalty, the LoRA bank, speculative
decoding and the LoRA fine-tune, with the phase-12 bursts they are held
to (the paged and the dense engine over the port-format export).

    python3 scripts/torch_a6_phases.py [--skip-train]

Prints the card's name and power limit, then one JSON line a phase (the
``phase`` key names it, as in ``chip_smoke.py``).  Needs one CUDA
device; exits 2 without one.
"""
import argparse
import importlib.util
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-train", action="store_true",
                    help="leave out phase 16 (c), the LoRA fine-tune")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_a6_phases: no CUDA device", file=sys.stderr)
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
    prompts = cs.engine_prompts(torch, cfg["vocab_size"])
    root = os.path.join(HERE, "build", "chip_smoke")
    try:
        base = {}
        for name, argv in (("paged", cs.ENGINE_PAGED), ("dense", ())):
            with cs.EngineServer(export_dir, dev, *argv) as srv:
                base[name], _, base[f"{name}_run"] = cs.served(srv, prompts)
            torch.cuda.empty_cache()
        cs.emit("baseline", nvidia_smi=card, runs={
            k: v for k, v in base.items() if k.endswith("_run")})
        exports, _, bf16_dir, int8_outs = cs.phase_exports(
            torch, dev, cfg, export_dir, base["paged"], prompts, card)
        cs.emit("exports_main_path", **exports)
        base["paged_int8w"] = int8_outs
        a6, _ = cs.phase_sampling_lora(torch, dev, cfg, export_dir, bf16_dir,
                                       base, prompts, card)
        cs.emit("controls_lora_main_path", **a6)
        spec_out, _ = cs.phase_spec(torch, dev, cfg, bf16_dir, base, prompts,
                                    card)
        cs.emit("spec_main_path", **spec_out)
    finally:
        for d in ("export", "export_jax_bf16", "export_int8",
                  "export_draft_2layer"):
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)
    torch.cuda.empty_cache()
    if not args.skip_train:
        out, _ = cs.phase_lora_train(torch, dev, None, card)
        cs.emit("lora_train_main_path", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
