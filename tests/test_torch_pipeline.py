"""The port's pipeline API (``pipeline``, ``pipeline_ml``) against the JAX
package's, on the CPU.

- the 19 params: names, defaults and converters equal the JAX package's
  ``_PARAMS``, each documented, each with its ``Has*`` mixin's setter and
  getter; ``Namespace`` and ``merge_args_params`` behave as JAX's;
- ``TFModel.transform`` over plain local partitions (the inline path) on
  a tiny transformer export matches the JAX ``TFModel.transform`` over a
  JAX export of the same weights (carried over by
  ``convert.params_from_jax``) within ``test_torch_transformer.py``'s
  ATOL = RTOL = 1e-4 (f32 on both sides, different summation order);
- a wrong ``input_mapping`` / ``output_mapping`` raises the JAX package's
  exception type with the same words;
- ``TFEstimator.fit`` over ``LocalBackend`` (SPARK mode through the shm
  ring, and NATIVE mode from ``tfrecord_dir`` through ``data.Dataset``)
  trains the tiny model with ``device="cpu"``: its losses equal, bit for
  bit, a direct port loop over the same batches (one intra-op thread on
  both sides, as the node runs);
- ``pipeline_ml.Pipeline([est]).fit(df).transform(df)`` over the port's
  minispark gives a DataFrame whose output column equals, exactly, the
  inline transform's rows (one thread on both sides);
- the device rule: with no device and no CUDA, ``transform`` raises;
- an executor that holds CUDA (faked, as ``test_torch_runtime.py`` fakes
  it) refuses a later SPARK-mode fit with the named error, at startup,
  instead of hanging.

Executors are fork-started (cheap, and the train functions are
module-level here, already imported in the child); a forked process
runs ``torch.set_num_threads(1)`` before any torch op.
"""
import argparse
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import export as jax_export
from tensorflowonspark_tpu import pipeline as jax_pipeline
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import (backend, cluster, convert, data,
                                         dfutil, export, minispark, pipeline,
                                         pipeline_ml)
from tensorflowonspark_tpu_torch import optim as port_optim
from tensorflowonspark_tpu_torch.minispark import sql
from tensorflowonspark_tpu_torch.minispark.sql import types as T
from tensorflowonspark_tpu_torch.models import transformer as port_tf
from tensorflowonspark_tpu_torch.parallel import train as port_train


class ForkContext(minispark.SparkContext):
    """A minispark context whose executors fork: cheap, and the tasks
    here are module-level, already imported in the forked child."""
    _START_METHOD = "fork"

ATOL = RTOL = 1e-4
LM = dict(vocab_size=32, d_model=64, n_heads=4, n_kv_heads=2, n_layers=1,
          d_ff=64, max_seq_len=16, dtype="float32", rope=True,
          norm_type="rmsnorm", attention_impl="dense")
JAX_BUILDER = "tensorflowonspark_tpu.models.transformer:build_transformer"
B, SEQ = 4, 8


def _tokens(seed, n, seq=SEQ + 1):
    return list(np.random.RandomState(seed).randint(
        0, LM["vocab_size"], (n, seq)).astype(np.int32))


# --- params and Namespace ----------------------------------------------------

def test_params_match_jax():
    port = [(p.name, p.default, p.converter) for p in pipeline._PARAMS]
    want = [(p.name, p.default, p.converter) for p in jax_pipeline._PARAMS]
    assert port == want and len(port) == 19
    est = pipeline.TFEstimator(None)
    for p in pipeline._PARAMS:
        assert p.doc
        camel = "".join(w.capitalize() for w in p.name.split("_"))
        mixin = getattr(pipeline, f"Has{camel}")
        assert isinstance(est, mixin) and mixin.PARAM is p
        assert getattr(est, f"get{camel}")() == p.default
    est.setBatchSize("7").setInputMapping({"a": "x"})
    assert est.getBatchSize() == 7 and est.getInputMapping() == {"a": "x"}


def test_namespace_and_merge_behave_as_jax():
    for src in ({"a": 1, "b": [2]}, ["--x", "1"],
                argparse.Namespace(c=3)):
        got, want = pipeline.Namespace(src), jax_pipeline.Namespace(src)
        assert vars(got) == vars(want) and got.argv == want.argv
        assert vars(pipeline.Namespace(got)) == vars(
            jax_pipeline.Namespace(want))
    assert ("a" in pipeline.Namespace({"a": 1})) and (
        "b" not in pipeline.Namespace({"a": 1}))
    for mod in (pipeline, jax_pipeline):
        with pytest.raises(TypeError, match="unsupported Namespace"):
            mod.Namespace(5)
    merged = []
    for mod in (pipeline, jax_pipeline):
        m = mod.TFModel({"batch_size": 3, "extra": "e"}).setBatchSize(9)
        merged.append(vars(m.merge_args_params()))
    assert merged[0] == merged[1] and merged[0]["batch_size"] == 9


# --- transform parity with the JAX package -----------------------------------

@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    root = tmp_path_factory.mktemp("exports")
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**LM))
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.key(5), jnp.zeros((1, 8), jnp.int32))["params"])
    jdir, pdir = str(root / "jax"), str(root / "port")
    jax_export.export_saved_model(jdir, params, builder=JAX_BUILDER,
                                  builder_kwargs=LM)
    export.export_saved_model(pdir, convert.params_from_jax(params),
                              builder_kwargs=LM)
    return jdir, pdir


def test_inline_transform_matches_jax(exports):
    jdir, pdir = exports
    rows = _tokens(6, 7, seq=SEQ)
    parts = [[(r,) for r in rows[:4]], [(r,) for r in rows[4:]]]
    want = jax_pipeline.TFModel({"export_dir": jdir, "batch_size": 3}) \
        .transform(parts)
    got = pipeline.TFModel({"export_dir": pdir, "batch_size": 3,
                            "device": "cpu"}).transform(parts)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.shape == (SEQ, LM["vocab_size"]) and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=RTOL)
    boxed = pipeline.TFModel({"export_dir": pdir, "batch_size": 3,
                              "device": "cpu"}).transform(parts, box=True)
    assert isinstance(boxed[0], list)
    np.testing.assert_array_equal(np.asarray(boxed[0], np.float32), got[0])


@pytest.mark.parametrize("which", ["input_mapping", "output_mapping"])
def test_mapping_errors_match_jax_in_kind(exports, which):
    jdir, pdir = exports
    parts = [[(r,) for r in _tokens(7, 2, seq=SEQ)]]
    bad = ({"tokens": "no_such_input"} if which == "input_mapping"
           else {"no_such_output": "pred"})
    errors = []
    for mod, args in ((jax_pipeline, {"export_dir": jdir}),
                      (pipeline, {"export_dir": pdir, "device": "cpu"})):
        with pytest.raises((KeyError, ValueError)) as info:
            mod.TFModel(dict(args, **{which: bad})).transform(parts)
        errors.append(info.value)
    assert type(errors[0]) is type(errors[1])
    words = "missing" if which == "input_mapping" else "output_mapping"
    assert all(words in str(e) for e in errors)


def test_transform_and_loaders_follow_the_device_rule(exports, monkeypatch):
    _, pdir = exports
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parts = [[(r,) for r in _tokens(8, 2, seq=SEQ)]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.TFModel({"export_dir": pdir}).transform(parts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.load_saved_model(pdir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.load_model(pdir)
    model, _ = export.load_model(pdir, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


# --- fit: SPARK and NATIVE against a direct loop ------------------------------

def _lm_loss(model, batch, rng):
    return port_tf.lm_loss(model(batch[:, :-1]), batch[:, 1:])


def _lm_step(seed):
    model = port_tf.build_transformer(**LM)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    opt, _ = port_optim.make_optimizer("adamw_fused", learning_rate=1e-2,
                                       mu_dtype="bfloat16")
    return (port_train.make_train_step(_lm_loss, opt),
            port_train.create_train_state(model, opt))


def _tokens_of(example):
    return np.asarray(example["tokens"][1], np.int32)


def fn_fit(args, ctx):
    """The estimator's train_fn: the tiny LM step over the SPARK feed or
    the NATIVE TFRecords; losses to ``args.out``; the chief exports."""
    torch.set_num_threads(1)
    step, state = _lm_step(args.seed)
    if args.input_mode == cluster.InputMode.SPARK:
        batches = ctx.get_data_feed().iter_device_batches(args.batch_size,
                                                          device="cpu")
    else:
        batches = (data.Dataset.from_tfrecords(args.tfrecord_dir)
                   .map(_tokens_of).batch(args.batch_size)
                   .prefetch_to_device(device="cpu"))
    losses = []
    for batch in batches:
        if isinstance(batch, (tuple, list)):       # DataFrame rows
            batch = batch[0]
        state, m = step(state, batch.long(), None)
        losses.append(m["loss"].item())
    with open(os.path.join(args.out, f"losses-{args.input_mode}.json"),
              "w") as f:
        json.dump(losses, f)
    if args.export_dir:
        export.export_saved_model(args.export_dir, state.params.state_dict(),
                                  builder_kwargs=LM, is_chief=ctx.is_chief)


def _direct_losses(seed, rows):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)             # the node's setting: same bits
    try:
        step, state = _lm_step(seed)
        out = []
        for i in range(0, len(rows), B):
            batch = torch.from_numpy(np.stack(rows[i:i + B])).long()
            state, m = step(state, batch, None)
            out.append(m["loss"].item())
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("mode", ["spark", "native"])
def test_fit_over_local_backend_matches_direct_loop(tmp_path, mode):
    rows = _tokens(9, 3 * B)
    native = mode == "native"
    tfr = str(tmp_path / "tfr")
    if native:
        os.makedirs(tfr)
        dfutil.write_tfrecords(({"tokens": r} for r in rows),
                               os.path.join(tfr, "part-r-00000"))
    est = (pipeline.TFEstimator(fn_fit, {"out": str(tmp_path), "seed": 2})
           .setClusterSize(1).setBatchSize(B).setGraceSecs(0)
           .setInputMode(cluster.InputMode.NATIVE if native
                         else cluster.InputMode.SPARK))
    if native:
        est.setTfrecordDir(tfr)
    bk = backend.LocalBackend(1, workdir=str(tmp_path / "bk"))
    model = est.fit([rows[:2 * B], rows[2 * B:]], backend=bk)
    assert isinstance(model, pipeline.TFModel)
    with open(tmp_path / f"losses-{est.getInputMode()}.json") as f:
        fed = json.load(f)
    assert fed == _direct_losses(2, rows)


def _one_thread(it):
    torch.set_num_threads(1)


def _fake_cuda_initialized(it):
    torch.cuda.is_initialized = _initialized


def _initialized():
    return True


def test_pipeline_ml_fit_transform_over_minispark(tmp_path):
    rows = _tokens(11, 2 * B)
    score = _tokens(12, 6, seq=SEQ)
    schema = T.StructType([T.StructField("tokens",
                                         T.ArrayType(T.IntegerType()))])
    exp = str(tmp_path / "export")
    with ForkContext(num_executors=1, workdir=str(tmp_path / "ms")) as sc:
        spark = sql.SparkSession.builder.getOrCreate()
        df = spark.createDataFrame(sc.parallelize([(r,) for r in rows], 2),
                                   schema)
        est = (pipeline_ml.TFEstimator(
            fn_fit, {"out": str(tmp_path), "seed": 4, "export_dir": exp,
                     "device": "cpu"})
               .setClusterSize(1).setBatchSize(B).setGraceSecs(0)
               .setInputMapping({"tokens": "input"}))
        fitted = pipeline_ml.Pipeline(stages=[est]).fit(df)
        with open(tmp_path / "losses-1.json") as f:
            assert json.load(f) == _direct_losses(4, rows)
        assert isinstance(fitted.stages[0], pipeline_ml.TFModel)
        sc.parallelize([0], 1).foreachPartition(_one_thread)
        df_score = spark.createDataFrame(
            sc.parallelize([(r,) for r in score], 2), schema)
        out = fitted.transform(df_score)
        assert out.columns == ["output"]
        got = [np.asarray(r.output, np.float32) for r in out.collect()]

        # a fit after the executor initialised CUDA: refused at startup
        sc.parallelize([0], 1).foreachPartition(_fake_cuda_initialized)
        with pytest.raises(RuntimeError,
                           match="initialised CUDA.*fit before transform"):
            est.fit(df)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = pipeline.TFModel({"export_dir": exp, "batch_size": B,
                                 "input_mapping": {"tokens": "input"},
                                 "device": "cpu"}) \
            .transform([[(r,) for r in score[:3]],
                        [(r,) for r in score[3:]]])
    finally:
        torch.set_num_threads(threads)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
