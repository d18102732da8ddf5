"""The port's ahead-of-time artifacts (``aot``), against the port's own
builder (the JAX package's artifact is StableHLO, which the port does
not run).

- Layout: ``aot/aot_spec.json`` (``"format": "torch"``, batch sizes,
  inputs, outputs, devices) and one ``model_b{N}.{device}.pt2`` (engine
  ``jax``, ``torch.export``) and ``.aoti.pt2`` (engine ``native``,
  AOTInductor) per batch size and device;
- the ``jax`` engine's program equals the builder within 1e-6 (f32, the
  same kernels' plain versions, one graph; measured 0);
- ``predict_batched`` pads the tail chunk by repeating its last row and
  trims the pad;
- ``native`` / ``jax`` without the port's artifact, or with the JAX
  package's StableHLO one, raise ValueError; ``auto`` serves such an
  export through the builder and says so; a ``plugin_path`` raises;
  ``tpu`` platforms, and ``cuda`` without a card, raise; a remote
  ``export_dir`` raises before anything is written; a traced tensor
  never reaches a ctypes launch; the package's C++ compiler must link
  OpenMP (a ``$CXX`` that cannot is passed over for a ``g++`` that
  can);
- the batch CLI over TFRecords with ``--engine auto|jax|native|builder``
  writes the builder's predictions (within 1e-5 for the compiled
  package: Inductor's fused CPU code sums in another order; measured
  about 1e-6);
- a 1-block ViT's exported graph holds ``tos.flash_fwd`` (kernel 4 as
  a dispatcher op) and no ``scaled_dot_product_attention``;
- the ``native`` engine matches the builder within 1e-5.

Every artifact here is ``torch_aot_vit.vit_aot_export``'s, the one
AOTInductor compile of the CPU tier.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax

from tensorflowonspark_tpu import export as jax_export
from tensorflowonspark_tpu.models.linear import Linear as JaxLinear
from tensorflowonspark_tpu_torch import aot, dfutil, export, inference
from tensorflowonspark_tpu_torch.ops import _build

from torch_aot_vit import (BATCH, BUILDER, SIGNATURES, VIT, seeded_vit,
                           vit_aot_export)  # noqa: F401

JAX_ENGINE_TOL = 1e-6
NATIVE_TOL = 1e-5
LINEAR_SIG = {"serving_default": {
    "inputs": {"x": {"shape": [2], "dtype": "float32"}}, "outputs": ["y"]}}


def _images(n, seed):
    return np.random.RandomState(seed).standard_normal(
        (n, 8, 8, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_format(tmp_path_factory):
    """An export of the JAX package with its StableHLO artifact."""
    d = str(tmp_path_factory.mktemp("aot_stablehlo") / "lin")
    params = JaxLinear(features=1).init(
        jax.random.key(0), np.zeros((1, 2), "float32"))["params"]
    jax_export.export_saved_model(
        d, params, builder="tensorflowonspark_tpu.models.linear:Linear",
        builder_kwargs={"features": 1}, signatures=LINEAR_SIG,
        aot_batch_sizes=[2], aot_platforms=["cpu"])
    return d, params


def _builder(export_dir, x):
    predict, _ = export.load_saved_model(export_dir, device="cpu")
    return predict(x)


def test_artifact_layout(vit_aot_export):
    d, _, _ = vit_aot_export
    assert sorted(os.listdir(os.path.join(d, "aot"))) == [
        "aot_spec.json", f"model_b{BATCH}.cpu.aoti.pt2",
        f"model_b{BATCH}.cpu.pt2"]
    spec = aot.read_spec(d)
    seconds = spec.pop("seconds")
    assert seconds["export"] > 0 and seconds["compile"] > 0
    assert spec == {"format": "torch", "batch_sizes": [BATCH],
                    "inputs": [{"name": "image", "shape": [8, 8, 3],
                                "dtype": "float32"}],
                    "outputs": ["logits"], "devices": ["cpu"]}
    assert aot.has_aot(d) and aot.is_torch_artifact(d)
    two = dict(spec, batch_sizes=[2, 4])
    assert [aot._pick_batch_size(two, n) for n in (None, 1, 2, 3, 9)] == [
        4, 2, 2, 4, 4]


def test_jax_engine_equals_the_builder(vit_aot_export):
    d, _, _ = vit_aot_export
    x = _images(7, 1)
    want = _builder(d, x)
    predict, spec, bs = aot.load_aot(d, batch_size=2, engine="jax",
                                     device="cpu")
    assert bs == BATCH and predict.engine == "jax"
    got = aot.predict_batched(predict, [x], bs)[0]
    assert got.shape == want.shape == (7, 5)
    assert np.abs(got - want).max() <= JAX_ENGINE_TOL
    # auto takes the compiled package, which every export writes
    assert aot.find_artifact(d, engine="auto", device="cpu")[2] == "native"


def test_predict_batched_pads_and_trims():
    seen = []

    def predict(chunk):
        seen.append(chunk[0].copy())
        return [chunk[0] * 2, chunk[1][:, :1]]

    a = np.arange(10, dtype=np.float32).reshape(5, 2)
    b = np.arange(15, dtype=np.float32).reshape(5, 3)
    out = aot.predict_batched(predict, [a, b], 4)
    assert [c.shape[0] for c in seen] == [4, 4]
    assert np.array_equal(seen[1], np.stack([a[4]] * 4))   # repeat-padded
    assert np.array_equal(out[0], a * 2) and np.array_equal(out[1], b[:, :1])
    assert aot.predict_batched(predict, [a[:0], b[:0]], 4) == []
    assert inference.predict_batched is aot.predict_batched


def _engine_args(export_dir, engine):
    return type("A", (), dict(
        export_dir=export_dir, engine=engine, device="cpu", batch_size=4,
        input_mapping=None, output_mapping=None,
        signature_def_key=None))()


@pytest.mark.parametrize("engine", ["native", "jax"])
def test_engines_need_the_ports_artifact(tmp_path, jax_format, engine):
    d = str(tmp_path / "plain")
    export.export_saved_model(d, seeded_vit().state_dict(), builder=BUILDER,
                              builder_kwargs=VIT, signatures=SIGNATURES)
    with pytest.raises(ValueError, match="requires an AOT artifact"):
        inference._load_predictor(_engine_args(d, engine))
    jd, params = jax_format
    assert aot.has_aot(jd) and not aot.is_torch_artifact(jd)
    assert aot.jax_artifact_files(jd) == ["model_b2.cpu.jexport",
                                          "model_b2.cpu.stablehlo.mlir"]
    with pytest.raises(ValueError, match="JAX package's StableHLO"):
        inference._load_predictor(_engine_args(jd, engine))
    with pytest.raises(ValueError, match="JAX package's StableHLO"):
        aot.load_aot(jd, engine=engine, device="cpu")
    # auto serves the JAX export through the builder, and says so
    predict_rows, desc = inference._load_predictor(_engine_args(jd, "auto"))
    assert desc.startswith("builder(") and "StableHLO" in desc
    out = predict_rows({"x": [[1.0, 2.0], [3.0, 4.0]]}, 2)
    w = np.asarray(params["dense"]["kernel"]).reshape(2)
    np.testing.assert_allclose(out["y"], np.array([[1.0, 2.0], [3.0, 4.0]])
                               @ w, rtol=1e-6)


def test_plugin_path_platforms_and_remote_dirs_raise(vit_aot_export,
                                                     tmp_path, monkeypatch):
    d, _, model = vit_aot_export
    with pytest.raises(NotImplementedError, match="PJRT plugin"):
        aot.load_aot(d, engine="native", device="cpu",
                     plugin_path="libtpu.so")
    with pytest.raises(ValueError, match="no TPU artifact"):
        aot.export_aot(str(tmp_path / "x"), model, SIGNATURES[
            "serving_default"], batch_sizes=[2], platforms=["tpu"])
    with pytest.raises(FileNotFoundError, match="no artifact for cuda"):
        aot.load_aot(d, engine="jax", device="cuda")
    with pytest.raises(ValueError, match="local export_dir"):
        export.export_saved_model("memory://bucket/m", model.state_dict(),
                                  builder=BUILDER, builder_kwargs=VIT,
                                  signatures=SIGNATURES, aot_batch_sizes=[2])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aot.export_aot(str(tmp_path / "y"), model, SIGNATURES[
            "serving_default"], batch_sizes=[2], platforms=["cuda"])
    assert not os.path.exists(tmp_path / "y")


def test_the_aoti_compiler_must_build_openmp(monkeypatch, tmp_path):
    """AOTInductor's wrapper takes ``-fopenmp``: a ``$CXX`` that cannot
    link OpenMP is passed over for a ``g++`` on PATH that can, and with
    none the export raises."""
    import shutil

    from torch._inductor import cpp_builder

    good = aot.aoti_cxx()
    bad = tmp_path / "g++"
    bad.write_text("#!/bin/sh\necho 'cannot read spec file libgomp.spec' "
                   ">&2\nexit 1\n")
    bad.chmod(0o755)
    monkeypatch.setattr(cpp_builder, "get_cpp_compiler", lambda: str(bad))
    assert aot.aoti_cxx() == shutil.which("g++")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="libgomp.spec"):
        aot.aoti_cxx()
    assert good


def test_a_traced_tensor_never_reaches_a_ctypes_launch():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        t = torch.empty(4)
        with pytest.raises(RuntimeError, match="tos::flash_fwd"):
            _build.ptr(t)


def test_exported_graph_holds_the_flash_kernel(vit_aot_export):
    d, _, _ = vit_aot_export
    program = torch.export.load(os.path.join(d, "aot",
                                             f"model_b{BATCH}.cpu.pt2"))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert "tos.flash_fwd.default" in targets
    assert not any("scaled_dot_product" in t for t in targets)


def test_native_engine_matches_the_builder(vit_aot_export):
    d, seconds, _ = vit_aot_export
    spec = aot.read_spec(d)
    if seconds is not None:
        print(f"AOT export of the 1-block ViT: {seconds:.1f} s, of which "
              f"the AOTInductor compile {spec['seconds']['compile']:.1f} s")
    assert spec["seconds"]["compile"] > 0 and spec["batch_sizes"] == [BATCH]
    assert os.path.exists(os.path.join(d, "aot", f"model_b{BATCH}.cpu.aoti"
                                       ".pt2"))
    x = _images(6, 2)
    want = _builder(d, x)
    predict, _, bs = aot.load_aot(d, engine="native", device="cpu")
    assert predict.engine == "native" and bs == BATCH
    got = aot.predict_batched(predict, [x], bs)[0]
    assert np.abs(got - want).max() <= NATIVE_TOL


@pytest.mark.parametrize("engine", ["auto", "jax", "native", "builder"])
def test_inference_cli_engines(vit_aot_export, tmp_path, engine):
    d, _, _ = vit_aot_export
    x = _images(6, 3)
    shard = str(tmp_path / "part-r-00000")
    dfutil.write_tfrecords(({"image": row.reshape(-1)} for row in x), shard)
    out = str(tmp_path / "out")
    assert inference.main([
        "--export_dir", d, "--input", shard, "--output", out,
        "--schema_hint", "struct<image:array<float>>",
        "--output_mapping", '{"logits": "prediction"}',
        "--batch_size", "4", "--engine", engine, "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in open(os.path.join(
        out, "part-00000.json"))]
    got = np.asarray([r["prediction"] for r in rows], np.float32)
    want = _builder(d, x)
    tol = {"jax": JAX_ENGINE_TOL, "builder": JAX_ENGINE_TOL}.get(engine,
                                                                NATIVE_TOL)
    assert got.shape == want.shape and np.abs(got - want).max() <= tol
    _, desc = inference._load_predictor(_engine_args(d, engine))
    chosen = {"auto": "native"}.get(engine, engine)
    assert desc.startswith("builder(" if chosen == "builder"
                           else f"aot(engine={chosen}")
