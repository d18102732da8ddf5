"""The port's sharding rules and shard-aligned 8-bit layouts against the
JAX package's, with no process group (abstract meshes of the port, JAX
meshes over the host devices).

- ``infer_param_shardings``: the spec of every leaf of the tiny flagship
  (``test_torch_train.py``'s config) on ``{dp:8}``, ``{dp:2, fsdp:4}``,
  ``{fsdp:8}`` and ``{dp:4, tp:2}`` (rules only: nothing is placed on a
  tp mesh), name-mapped to flax paths; the port's tensor is marked
  transposed where flax keeps the Dense kernel ``[in, out]``, so square
  weights shard on JAX's dim.  Also JAX's own odd-leaf case.
- ``layouts_for_shardings`` against JAX's, and ``quantize(layout=)``:
  the payload and scales of a full tensor bitwise JAX's, and each
  shard's own quantisation, rows concatenated in shard order, too.
- ``spec_for_path`` over JAX's rule table, and ``convert.flax_path`` as
  the inverse of the converter's naming.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import optim8bit as jax_8bit
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu.parallel import mesh as jax_mesh
from tensorflowonspark_tpu.parallel import sharding as jax_sharding
from tensorflowonspark_tpu_torch import convert, optim8bit
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_mod
from tensorflowonspark_tpu_torch.parallel import sharding as sharding_mod

CFG = dict(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=128, max_seq_len=16, dtype="float32", rope=True,
           norm_type="rmsnorm", attention_impl="flash")
MESHES = {"dp8": dict(dp=8), "dp2fsdp4": dict(dp=2, fsdp=4),
          "fsdp8": dict(dp=1, fsdp=8), "dp4tp2": dict(dp=4, tp=2)}


@pytest.fixture(scope="module")
def flax_params():
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**CFG))
    params = jm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, params["params"])


def _jax_specs(params, spec, fsdp):
    mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(**spec),
                               devices=jax.devices()[:8])
    sh = jax_sharding.infer_param_shardings(
        jax.tree_util.tree_map(jnp.asarray, params), mesh, fsdp=fsdp)
    return sh, {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
                jax.tree_util.tree_leaves_with_path(sh)}


def _key(name, ndim):
    path, _ = convert.flax_path(name, ndim)
    return "".join(f"['{k}']" for k in path.split("/"))


def _port(params, spec, fsdp):
    tensors = convert.params_from_jax(params)
    mesh = mesh_mod.Mesh(mesh_mod.MeshSpec(**spec).resolve(8))
    return tensors, sharding_mod.infer_param_shardings(tensors, mesh,
                                                       fsdp=fsdp)


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "rules"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_flagship_leaf_spec_matches_jax(flax_params, mesh, fsdp):
    _, want = _jax_specs(flax_params, MESHES[mesh], fsdp)
    tensors, got = _port(flax_params, MESHES[mesh], fsdp)
    assert len(got) == len(want) == len(tensors)
    for name, sh in got.items():
        t = tensors[name]
        assert sh.spec == want[_key(name, t.ndim)], name
        assert sh.transposed == (t.ndim == 2 and name.split(".")[-2]
                                 not in ("token_embed", "pos_embed")), name
    if mesh == "dp2fsdp4" and fsdp:
        # the square-weight trap: JAX's tie goes to the later flax dim
        # ([in, out] -> out), which is the port's dim 0
        q = got["layer_0.attn.query.weight"]
        assert q.spec == (None, "fsdp")
        assert q.shard_dim(2) == [(0, ("fsdp",))]
        assert got["layer_0.mlp.wo.weight"].shard_dim(2) == [(1, ("fsdp",))]


def test_placing_tp_specs_raises_naming_a3b(flax_params):
    """tp specs now place (column-parallel splits the port's dim 0, row-
    parallel its dim 1, the tables d_model); what still raises names its
    ROADMAP item: a pp-split leaf (the port keeps a stage as a module,
    A3c) and a dp-split one (MoE experts over ep, A3c)."""
    _, got = _port(flax_params, MESHES["dp4tp2"], False)
    assert got["layer_0.attn.query.weight"].shard_dim(2) == [(0, ("tp",))]
    assert got["layer_0.attn.out.weight"].shard_dim(2) == [(1, ("tp",))]
    assert got["token_embed.weight"].shard_dim(2) == [(1, ("tp",))]
    assert got["lm_head.weight"].shard_dim(2) == [(0, ("tp",))]
    assert got["layer_0.ln1.weight"].shard_dim(1) == []
    mesh = mesh_mod.Mesh(mesh_mod.MeshSpec(dp=4, pp=2).resolve(8))
    for spec, item in ((("pp",), r"ROADMAP A3c"), (("dp",), r"ROADMAP A3c")):
        with pytest.raises(NotImplementedError, match=item):
            mesh_mod.NamedSharding(mesh, spec).shard_dim(1)


def test_odd_leaves_and_fsdp_largest_dim_match_jax():
    """JAX's own case: a kernel shards on its largest divisible dim, the
    bias too (ZeRO-3), an indivisible leaf stays replicated."""
    mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(dp=-1, fsdp=4))
    port_mesh = mesh_mod.Mesh(mesh_mod.MeshSpec(dp=-1, fsdp=4).resolve(8))
    for jtree, ptree in (
            ({"fc1": {"kernel": jnp.zeros((784, 512)),
                      "bias": jnp.zeros(512)}},
             {"fc1.weight": torch.zeros(512, 784),
              "fc1.bias": torch.zeros(512)}),
            ({"w": jnp.zeros((7, 3))}, {"w": torch.zeros(7, 3)})):
        want = {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
                jax.tree_util.tree_leaves_with_path(
                    jax_sharding.infer_param_shardings(jtree, mesh,
                                                       fsdp=True))}
        got = sharding_mod.infer_param_shardings(ptree, port_mesh, fsdp=True)
        for name, sh in got.items():
            assert sh.spec == want[_key(name, ptree[name].ndim)], name
    assert got["w"].spec == ()


def test_rules_and_paths_match_jax():
    for path in ("layer_0/attn/query/kernel", "layer_0/attn/out/kernel",
                 "layer_0/mlp/wi/kernel", "layer_0/mlp/wo/kernel",
                 "token_embed/embedding", "layer_0/ln1/scale",
                 "moe/experts_wi/kernel", "moe/router/kernel", "lm_head/kernel",
                 "some/other/kernel"):
        assert sharding_mod.spec_for_path(path) == tuple(
            jax_sharding.spec_for_path(path))
    for name, ndim in (("layer_3.attn.key.weight", 2), ("ln_f.weight", 1),
                       ("token_embed.weight", 2), ("layer_0.mlp.wi.bias", 1)):
        path, transposed = convert.flax_path(name, ndim)
        assert convert._port_name(tuple(path.split("/"))) == (name,
                                                              transposed)


@pytest.mark.parametrize("mesh", ["dp2fsdp4", "fsdp8", "dp4tp2"])
def test_layouts_and_quantize_bytes_match_jax(flax_params, mesh):
    fsdp = mesh != "dp4tp2"
    jsh, _ = _jax_specs(flax_params, MESHES[mesh], fsdp)
    jl = {jax.tree_util.keystr(p): lo for p, lo in
          jax.tree_util.tree_leaves_with_path(
              jax_8bit.layouts_for_shardings(
                  jax.tree_util.tree_map(jnp.asarray, flax_params), jsh),
              is_leaf=lambda x: x is None or isinstance(x, tuple))}
    tensors, sh = _port(flax_params, MESHES[mesh], fsdp)
    layouts = optim8bit.layouts_for_shardings(tensors, sh)
    rng = np.random.RandomState(3)
    aligned = 0
    for name, layout in layouts.items():
        t = tensors[name]
        want = jl[_key(name, t.ndim)]
        assert (None if layout is None else layout.counts) == want, name
        if layout is None:
            continue
        aligned += 1
        x = rng.randn(*layout.shape).astype(np.float32)   # flax order
        port_x = torch.from_numpy(x.T.copy() if layout.transposed else x)
        for signed in (True, False):
            src = x if signed else np.abs(x)
            px = port_x if signed else port_x.abs()
            jq = jax_8bit.quantize(jnp.asarray(src), 64, signed=signed,
                                   layout=want)
            q = optim8bit.quantize(px, 64, signed=signed, layout=layout)
            np.testing.assert_array_equal(q.q.numpy(), np.asarray(jq.q))
            np.testing.assert_array_equal(q.scale.numpy(),
                                          np.asarray(jq.scale))
            back = optim8bit.dequantize(q, tuple(px.shape), signed=signed,
                                        layout=layout)
            jback = np.asarray(jax_8bit.dequantize(jq, src.shape,
                                                   signed=signed,
                                                   layout=want))
            np.testing.assert_array_equal(
                back.numpy(), jback.T if layout.transposed else jback)
            if not fsdp:
                continue
            # each fsdp shard quantised on its own: the rows of JAX's
            # aligned payload, in shard order
            n = sh[name].mesh.extent("fsdp")
            parts = [optim8bit.quantize(
                convert.shard_of(px, sh[name], i), 64, signed=signed,
                layout=layout) for i in range(n)]
            np.testing.assert_array_equal(
                torch.cat([p.q for p in parts]).numpy(), np.asarray(jq.q))
    assert aligned > 0


def test_layout_errors():
    with pytest.raises(ValueError, match="does not tile"):
        optim8bit.quantize(torch.zeros(4, 6), layout=(4, 4))
    lay = optim8bit.Layout((4, 1), (8, 4), True)
    with pytest.raises(ValueError, match="fits neither"):
        optim8bit.quantize(torch.zeros(3, 3), layout=lay)
    q = optim8bit.quantize(torch.zeros(4, 8), 4, layout=lay)
    assert q.q.shape == (8, 4)
    with pytest.raises(ValueError, match="was not quantized with layout"):
        optim8bit.dequantize(q._replace(q=q.q[:4], scale=q.scale[:4]), (4, 8),
                             layout=lay)
