"""The port's batch-inference CLI against the JAX package's.

- ``python -m tensorflowonspark_tpu_torch.inference --device cpu`` over
  TFRecord shards (written by ``dfutil``; 5 rows, batch 2, so the tail
  chunk is repeat-padded) writes the JSON lines of the JAX CLI's
  ``--engine builder`` on the same weights (carried over by
  ``convert.params_from_jax``), within ``test_torch_transformer.py``'s
  ATOL = RTOL = 1e-4 (f32 on both sides, different summation order),
  with the same keys, row counts and output file names; run once as a
  subprocess, as a user runs it;
- ``--engine native`` and ``--engine jax`` run the port's artifact (the
  AOTInductor package and the ``torch.export`` program of
  ``torch_aot_vit``'s ViT, within 1e-5 of the builder) and raise
  ValueError on an export without one;
- with no ``--device`` and no CUDA it raises.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import export as jax_export
from tensorflowonspark_tpu import inference as jax_inference
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import convert, dfutil, export, inference

from torch_aot_vit import vit_aot_export  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = RTOL = 1e-4
LM = dict(vocab_size=32, d_model=64, n_heads=4, n_kv_heads=2, n_layers=1,
          d_ff=64, max_seq_len=16, dtype="float32", rope=True,
          norm_type="rmsnorm", attention_impl="dense")
JAX_BUILDER = "tensorflowonspark_tpu.models.transformer:build_transformer"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**LM))
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.key(2), jnp.zeros((1, 8), jnp.int32))["params"])
    jdir, pdir = str(root / "jax"), str(root / "port")
    jax_export.export_saved_model(jdir, params, builder=JAX_BUILDER,
                                  builder_kwargs=LM)
    export.export_saved_model(pdir, convert.params_from_jax(params),
                              builder_kwargs=LM)
    data = root / "tfr"
    data.mkdir()
    rng = np.random.RandomState(4)
    for s, n in enumerate((5, 3)):
        dfutil.write_tfrecords(
            ({"tokens": rng.randint(0, 32, 6).astype(np.int32), "id": i}
             for i in range(n)), str(data / f"part-r-{s:05d}"))
    return root, jdir, pdir, str(data)


def _args(export_dir, data, out, *extra):
    return ["--export_dir", export_dir, "--input", data, "--output", out,
            "--schema_hint", "struct<tokens:array<int>,id:long>",
            "--input_mapping", '{"tokens": "input"}',
            "--output_mapping", '{"output": "logits"}',
            "--batch_size", "2", *extra]


def _read(out):
    files = sorted(os.listdir(out))
    return files, [[json.loads(line) for line in open(os.path.join(out, f))]
                   for f in files]


def test_cli_matches_jax_builder_engine(setup):
    root, jdir, pdir, data = setup
    jout, pout = str(root / "jout"), str(root / "pout")
    assert jax_inference.main(_args(jdir, data, jout, "--engine",
                                    "builder")) == 0
    res = subprocess.run(
        [sys.executable, "-m", "tensorflowonspark_tpu_torch.inference",
         *_args(pdir, data, pout, "--device", "cpu")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert "wrote 8 predictions" in res.stdout
    jfiles, want = _read(jout)
    pfiles, got = _read(pout)
    assert pfiles == jfiles == ["part-00000.json", "part-00001.json"]
    assert [len(f) for f in got] == [len(f) for f in want] == [5, 3]
    for gf, wf in zip(got, want):
        for g, w in zip(gf, wf):
            assert set(g) == set(w) == {"logits"}
            np.testing.assert_allclose(np.asarray(g["logits"], np.float32),
                                       np.asarray(w["logits"], np.float32),
                                       atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("engine", ["native", "jax"])
def test_unported_engines_raise_naming_a8(setup, vit_aot_export, engine):
    root, _, pdir, data = setup
    with pytest.raises(ValueError, match="requires an AOT artifact"):
        inference.main(_args(pdir, data, str(root / engine), "--engine",
                             engine, "--device", "cpu"))
    vdir, _, _ = vit_aot_export
    x = np.random.RandomState(5).standard_normal((5, 8, 8, 3)).astype(
        np.float32)
    shard = str(root / f"images-{engine}")
    dfutil.write_tfrecords(({"image": r.reshape(-1)} for r in x), shard)
    out = str(root / f"out-{engine}")
    assert inference.main([
        "--export_dir", vdir, "--input", shard, "--output", out,
        "--schema_hint", "struct<image:array<float>>", "--engine", engine,
        "--device", "cpu"]) == 0
    got = np.asarray([json.loads(line)["logits"] for line in open(
        os.path.join(out, "part-00000.json"))], np.float32)
    want, _ = export.load_saved_model(vdir, device="cpu")
    assert np.abs(got - want(x)).max() <= 1e-5


def test_cli_needs_cuda_unless_cpu_is_asked_for(setup, monkeypatch):
    root, _, pdir, data = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.main(_args(pdir, data, str(root / "nocuda")))
