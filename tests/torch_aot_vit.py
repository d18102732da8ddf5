"""The one AOTInductor compile of the CPU tier: a 1-block ViT at width 32
(8 x 8 images, patch 4, flash attention, so its graph holds
``tos::flash_fwd``) exported by the port with both artifact forms at
batch 4 — the ``torch.export`` program and the AOTInductor package —
for the CPU.  The compile takes about 40 s on a cold inductor cache.

``vit_aot_export`` (a module fixture; test files import it) makes the
export once a test session: under xdist the workers share it through a
lock in the session's temp root, the first to arrive compiles and the
others wait and read.  It yields ``(export_dir, compile_s, model)``,
``compile_s`` None in a worker that found the export made.
"""
import fcntl
import os
import time

import pytest
import torch

from tensorflowonspark_tpu_torch import export
from tensorflowonspark_tpu_torch.models import vit

VIT = dict(image_size=8, patch_size=4, channels=3, num_classes=5, d_model=32,
           n_heads=2, n_layers=1, d_ff=64, dtype="float32",
           attention_impl="flash")
BUILDER = "tensorflowonspark_tpu_torch.models.vit:ViTBase"
SIGNATURES = {"serving_default": {
    "inputs": {"image": {"shape": [8, 8, 3], "dtype": "float32"}},
    "outputs": ["logits"]}}
BATCH = 4
SEED = 23


def seeded_vit():
    torch.manual_seed(SEED)
    return vit.ViTBase(**VIT).eval().requires_grad_(False)


@pytest.fixture(scope="module")
def vit_aot_export(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    d = root / "torch_aot_vit"
    d.mkdir(exist_ok=True)
    export_dir = str(d / "export")
    model = seeded_vit()
    seconds = None
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (d / "done").exists():
            t = time.monotonic()
            export.export_saved_model(
                export_dir, model.state_dict(), builder=BUILDER,
                builder_kwargs=VIT, signatures=SIGNATURES,
                aot_batch_sizes=[BATCH], device="cpu")
            seconds = time.monotonic() - t
            (d / "done").touch()
    return export_dir, seconds, model
