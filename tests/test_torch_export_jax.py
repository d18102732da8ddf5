"""JAX exports in the port, and the port's stored int8 export.

The JAX package writes each export (its builder spec and
``params.msgpack``) of a seeded tiny LM; the port reads it through
``serialization`` (no flax, no msgpack) and ``convert``:

- f32 and bf16 exports: ``export.load_saved_model`` gives logits within
  1e-5 of the JAX ``load_saved_model`` (f32 compute; bf16 storage with
  f32 compute, so both sides hold the same values), 2e-2 for bf16
  compute (CPU bf16 matmuls sum in another order); served by the port's
  HTTP server, greedy tokens equal the JAX ``GenerateService``'s;
- a ``quantize_int8`` export, the JAX package's and the port's (the
  port's stored bytes equal the JAX export's), served with and without
  ``--generate_quantize int8``, mirrors the JAX
  ``test_quantized_export_serves_without_requant``: with the flag the
  stored int8 bytes serve as they are (kernel 9's plain version, no
  requantisation; the resident weight bytes equal load-time int8's),
  without it the export dequantises to its ``dequant_dtype``; greedy
  tokens equal JAX ``decode.generate`` over the stored / dequantised
  tree;
- the batch CLI on a JAX export writes the JAX CLI's logits (1e-4);
- the port writes a JAX-format export (``export_jax_saved_model``) that
  the JAX package loads;
- a JAX builder without a counterpart raises NotImplementedError (the
  zoo's builders map to the port's);
- remote paths: the port's ``fsio`` against JAX ``fsio`` over fsspec's
  ``memory://``, and a JAX export and an adapter file read from there.
"""
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import export as jax_export
from tensorflowonspark_tpu import fsio as jax_fsio
from tensorflowonspark_tpu import inference as jax_inference
from tensorflowonspark_tpu import lora as jax_lora
from tensorflowonspark_tpu import quantize as jax_quant
from tensorflowonspark_tpu import serve as jax_serve
from tensorflowonspark_tpu.models import decode as jax_decode
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import (convert, dfutil, export, fsio,
                                         inference, lora, serve)
from tensorflowonspark_tpu_torch.models import transformer as port_tf

JAX_BUILDER = "tensorflowonspark_tpu.models.transformer:build_transformer"
CFG = dict(vocab_size=41, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_seq_len=32, dtype="float32", rope=True,
           attention_impl="dense")
PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11, 12]]
MAX_NEW = 6


@pytest.fixture(scope="module")
def jax_lm():
    """The JAX module and seeded numpy parameters in its layout (drawn by
    the port: ``flax.init`` would compile a program for each config)."""
    pm = port_tf.build_transformer(**CFG)
    pm.reset_parameters(torch.Generator().manual_seed(3))
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**CFG))
    return jm, convert.params_to_jax(pm.state_dict())


def _export(root, name, params, cfg=CFG, **kw):
    d = str(root / name)
    jax_export.export_saved_model(d, params, builder=JAX_BUILDER,
                                  builder_kwargs=cfg, **kw)
    return d


def _serve_outputs(export_dir, *flags, prompts=PROMPTS):
    args = serve.build_argparser().parse_args(
        ["--export_dir", export_dir, "--port", "0", "--device", "cpu",
         "--generate_slots", "2", *flags])
    srv, svc = serve.make_server(args)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = (f"http://127.0.0.1:{srv.server_address[1]}"
               "/v1/models/default")
        req = urllib.request.Request(url + ":generate", data=json.dumps(
            {"inputs": prompts, "max_new_tokens": MAX_NEW}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            outs = json.loads(r.read())["outputs"]
        with urllib.request.urlopen(url, timeout=30) as r:
            meta = json.loads(r.read())["model"]
        return outs, meta
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)


def _jax_solo(jm, params, prompts=PROMPTS, n=MAX_NEW):
    return [np.asarray(jax_decode.generate(
        jm, params, jnp.asarray([p], jnp.int32), max_new_tokens=n,
        temperature=0.0, loop="host"))[0].tolist() for p in prompts]


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_jax_export_logits_and_served_tokens(jax_lm, tmp_path, store):
    jm, params = jax_lm
    stored = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, store)), params)
    d = _export(tmp_path, store, stored)
    x = np.asarray([[1, 5, 9, 2, 30]], np.int32)
    apply_fn, jparams, _ = jax_export.load_saved_model(d)
    want = np.asarray(apply_fn(jparams, x), np.float32)
    predict, _ = export.load_saved_model(d, device="cpu")
    np.testing.assert_allclose(predict(x), want, atol=1e-5, rtol=1e-5)
    model, _ = export.load_model(d, device="cpu")
    assert str(model.lm_head.weight.dtype) == f"torch.{store}"
    gen = jax_serve.GenerateService(d, slots=2)
    try:
        jax_out = gen.generate({"inputs": PROMPTS,
                                "max_new_tokens": MAX_NEW})
    finally:
        gen.batcher.stop()
    got, _ = _serve_outputs(d)
    assert got == jax_out


def test_bf16_compute_export_logits(jax_lm, tmp_path):
    _, params = jax_lm
    cfg = dict(CFG, dtype="bfloat16")
    stored = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), params)
    d = _export(tmp_path, "bf16c", stored, cfg)
    x = np.asarray([[1, 5, 9, 2, 30]], np.int32)
    apply_fn, jparams, _ = jax_export.load_saved_model(d)
    want = np.asarray(apply_fn(jparams, x), np.float32)
    got = export.load_saved_model(d, device="cpu")[0](x)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_quantized_exports_serve_with_and_without_requant(jax_lm, tmp_path):
    jm, params = jax_lm
    # the default selection (kernels of >= 4096 elements), the one
    # load-time quantisation makes
    jdir = _export(tmp_path, "jq", params, quantize_int8=True)
    pdir = str(tmp_path / "pq")
    export.export_saved_model(pdir, convert.params_from_jax(params),
                              builder_kwargs=CFG, quantize_int8=True)
    jspec = json.load(open(os.path.join(jdir, export.MODEL_SPEC)))
    pspec = json.load(open(os.path.join(pdir, export.MODEL_SPEC)))
    assert (pspec["quantized"], pspec["dequant_dtype"]) == (
        jspec["quantized"], jspec["dequant_dtype"]) == ("int8", "float32")
    stored = jax_export.load_model(jdir, dequantize=False)[1]
    jq = export.load_model(jdir, device="cpu", dequantize=False)[0]
    pq = export.load_model(pdir, device="cpu", dequantize=False)[0]
    for name, t in jq.state_dict().items():     # the same stored bytes
        assert torch.equal(t, pq.state_dict()[name]), name
    # stored row-major, as the card's kernel 9 takes them
    stored_pt = torch.load(os.path.join(pdir, export.PARAMS_FILE))
    assert all(t.is_contiguous() for t in stored_pt.values())
    assert jq.layer_0.attn.query.quant == "int8"
    one = PROMPTS[1:]
    want = {"int8": _jax_solo(jm, stored, one),
            "none": _jax_solo(jm, jax_quant.dequantize_tree(stored), one)}
    load_time, meta_lt = _serve_outputs(
        _export(tmp_path, "f32", params), "--generate_quantize", "int8",
        prompts=one)
    for d, mode in ((jdir, "int8"), (jdir, "none"), (pdir, "int8"),
                    (pdir, "none")):
        flags = ("--generate_quantize", mode) if mode != "none" else ()
        got, meta = _serve_outputs(d, *flags, prompts=one)
        assert got == want[mode], (d, mode)
        if mode == "int8":
            assert meta["generate_quantize"] == meta_lt["generate_quantize"]
            assert got == load_time
    # int4 on a stored int8 export: dequantised to its dequant_dtype, then
    # packed, as the JAX service does
    int4 = serve._load_lm(jdir, "int4", torch.device("cpu"))
    assert int4.layer_0.attn.query.quant == "int4"


def test_batch_cli_on_a_jax_export(jax_lm, tmp_path):
    _, params = jax_lm
    d = _export(tmp_path, "cli", params)
    data = tmp_path / "tfr"
    data.mkdir()
    rng = np.random.RandomState(4)
    dfutil.write_tfrecords(
        ({"tokens": rng.randint(0, 41, 6).astype(np.int32), "id": i}
         for i in range(3)), str(data / "part-r-00000"))

    def args(out, *extra):
        return ["--export_dir", d, "--input", str(data), "--output", out,
                "--schema_hint", "struct<tokens:array<int>,id:long>",
                "--input_mapping", '{"tokens": "input"}',
                "--output_mapping", '{"output": "logits"}',
                "--batch_size", "2", *extra]

    jout, pout = str(tmp_path / "jout"), str(tmp_path / "pout")
    assert jax_inference.main(args(jout, "--engine", "builder")) == 0
    assert inference.main(args(pout, "--device", "cpu")) == 0
    for f in sorted(os.listdir(jout)):
        want = [json.loads(x) for x in open(os.path.join(jout, f))]
        got = [json.loads(x) for x in open(os.path.join(pout, f))]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["logits"], w["logits"], atol=1e-4,
                                       rtol=1e-4)


def test_port_writes_a_jax_format_export(jax_lm, tmp_path):
    jm, params = jax_lm
    pm = convert.params_from_jax(params)
    d = str(tmp_path / "portjax")
    export.export_jax_saved_model(d, pm, builder_kwargs=CFG)
    with open(os.path.join(d, export.MODEL_SPEC)) as f:
        assert json.load(f)["builder"] == JAX_BUILDER
    _, restored, _ = jax_export.load_model(d)
    for path, leaf in zip(jax.tree_util.tree_leaves_with_path(params),
                          jax.tree_util.tree_leaves(restored)):
        assert np.array_equal(np.asarray(leaf), path[1]), path[0]


def test_zoo_builder_raises_naming_a8(tmp_path):
    """A JAX builder without a counterpart raises NotImplementedError
    (the zoo's builders now map: bert's export loads its model)."""
    d = str(tmp_path / "zoo")
    os.makedirs(d)
    with open(os.path.join(d, export.MODEL_SPEC), "w") as f:
        json.dump({"format": "tfos-tpu-saved-model", "version": 1,
                   "builder": "tensorflowonspark_tpu.models.pipelined:"
                   "PipelinedLM", "builder_kwargs": {}, "signatures": {}},
                  f)
    with pytest.raises(NotImplementedError, match="no counterpart"):
        export.load_model(d, device="cpu")
    with pytest.raises(NotImplementedError, match="no counterpart"):
        convert.port_builder("tensorflowonspark_tpu.models.zoo:resnet50")
    assert convert.port_builder(
        "tensorflowonspark_tpu.models.bert:build_bert") == (
        "tensorflowonspark_tpu_torch.models.bert:build_bert")


def test_fsio_memory_paths_match_jax_fsio(jax_lm):
    pytest.importorskip("fsspec")
    _, params = jax_lm
    root = "memory://tos_export_jax"
    d = root + "/lm"
    jax_export.export_saved_model(d, params, builder=JAX_BUILDER,
                                  builder_kwargs=CFG)
    for fn in ("exists", "isdir", "isfile", "getsize"):
        for p in (d, d + "/" + export.MODEL_SPEC, d + "/params.msgpack",
                  root + "/missing"):
            try:
                want = getattr(jax_fsio, fn)(p)
            except FileNotFoundError:
                with pytest.raises(FileNotFoundError):
                    getattr(fsio, fn)(p)
                continue
            assert getattr(fsio, fn)(p) == want, (fn, p)
    assert fsio.glob(d + "/*") == jax_fsio.glob(d + "/*")
    assert fsio.join(root, "a", "b") == jax_fsio.join(root, "a", "b")
    assert fsio.is_remote(d) and not fsio.is_remote("/tmp/x")
    x = np.asarray([[4, 2, 9]], np.int32)
    apply_fn, jparams, _ = jax_export.load_saved_model(d)
    np.testing.assert_allclose(
        export.load_saved_model(d, device="cpu")[0](x),
        np.asarray(apply_fn(jparams, x)), atol=1e-5, rtol=1e-5)
    ad = jax_lora.init(jax.random.key(1), params, rank=2)
    jax_lora.save_adapters(root + "/ad.msgpack", ad, scale=0.25)
    got, scale = lora.load_adapters(root + "/ad.msgpack")
    assert scale == 0.25 and sorted(got) == sorted(ad)
    for k in ad:
        assert np.array_equal(got[k]["a"].numpy(), np.asarray(ad[k]["a"]))
    with jax_fsio.fopen(root + "/ad.msgpack", "rb") as g:
        want = g.read()
    with fsio.fopen(root + "/ad.msgpack", "rb") as f:
        assert f.read() == want
