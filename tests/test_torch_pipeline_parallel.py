"""Parity of the port's pipeline parallelism with the JAX package.

Over four gloo ranks (``tests/torch_model_parallel_world.py``):

- ``pipeline_apply`` with JAX's residual-MLP stage, 4 stages, 8
  micro-batches: the outputs (on every pp rank) and the gradients of
  ``sum(out ** 2)`` in x and in each stage's parameters against JAX's
  ``pipeline_apply`` on a JAX ``{pp: 4}`` mesh within 1e-5 (its test's
  tolerance);
- ``PipelinedLM`` on ``{pp: 4}`` (learned positions) and ``{dp: 2, pp:
  2}`` (RoPE): logits, loss, grad_norm and one step's whole gradient
  against the JAX sequential Transformer within 3e-5, and the logits
  against JAX's ``PipelinedLM`` on the same mesh shape.  The embedding's
  gradient is stage 0's alone, summed over pp by the step: neither
  multiplied by pp nor zero (JAX's ``PipelinedLM`` gradients equal the
  sequential model's as well).

In one process: ``PipelinedLM(n_stages=1, n_micro=4)`` against the JAX
Transformer (the check chip_smoke phase 14 runs on one card), remat,
the JAX layout through ``convert``, and the JAX validation errors.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_model_parallel_world as tpw
from tensorflowonspark_tpu.models.pipelined import PipelinedLM as JaxPipelinedLM
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu.parallel import mesh as jax_mesh
from tensorflowonspark_tpu.parallel.pipeline import (
    pipeline_apply as jax_pipeline_apply)
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.models import transformer as port_tf
from tensorflowonspark_tpu_torch.models.pipelined import PipelinedLM
from tensorflowonspark_tpu_torch.parallel import pipeline as port_pipeline


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tpw.world(tmp_path_factory)


def _stage_fn(params, x):
    return x + jnp.tanh(x @ params["w1"]) @ params["w2"]


def test_pipeline_apply_matches_jax(world):
    pipe = tpw.inputs()["pipe"]
    mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(dp=1, pp=4),
                               devices=jax.devices()[:tpw.WORLD])
    stacked = {k: jnp.asarray(v) for k, v in pipe["stacked"].items()}
    x = jnp.asarray(pipe["x"])

    @jax.jit
    def fwd_bwd(p, x):
        out, vjp = jax.vjp(
            lambda p, x: jax_pipeline_apply(_stage_fn, p, x, mesh), p, x)
        return out, vjp(2 * out)

    out, (gp, gx) = fwd_bwd(stacked, x)
    by_stage = sorted((o["pipeline"] for o in world), key=lambda p: p["stage"])
    assert [p["stage"] for p in by_stage] == [0, 1, 2, 3]
    for s, p in enumerate(by_stage):
        # the last stage's outputs on every pp rank
        np.testing.assert_allclose(p["out"], np.asarray(out),
                                   rtol=tpw.PIPE_TOL, atol=tpw.PIPE_TOL)
        for k, g in p["grads"].items():
            np.testing.assert_allclose(g, np.asarray(gp[k])[s],
                                       rtol=tpw.PIPE_TOL, atol=tpw.PIPE_TOL)
        if s == 0:
            np.testing.assert_allclose(p["dx"], np.asarray(gx),
                                       rtol=tpw.PIPE_TOL, atol=tpw.PIPE_TOL)
        else:
            assert not p["dx"].any()


def test_stack_stage_params():
    per = [{"w": torch.full((2,), float(i))} for i in range(3)]
    stacked = port_pipeline.stack_stage_params(per)
    assert stacked["w"].shape == (3, 2) and stacked["w"][2, 1] == 2.0


@pytest.mark.parametrize("label", ["pp4", "dp2pp2"])
def test_pipelined_lm_matches_jax(world, label):
    tpw.check_model_case(world, label)
    spec, name = tpw.CASES[label][0], tpw.CASES[label][1]
    inp = tpw.inputs()
    cfg = jax_tf.TransformerConfig(**dict(tpw.CFGS[name],
                                          attention_impl="dense"))
    mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(**spec),
                               devices=jax.devices()[:tpw.WORLD])
    plm = JaxPipelinedLM(cfg, n_stages=spec["pp"])
    params = plm.from_transformer(jax.tree_util.tree_map(
        jnp.asarray, inp["params"][name]))
    with jax.set_mesh(mesh):
        want = jax.jit(lambda p, t: plm.apply(p, t, mesh))(
            params, jnp.asarray(inp["tokens"][:, :-1]))
    np.testing.assert_allclose(tpw.joined_logits(world, label),
                               np.asarray(want), rtol=tpw.MODEL_TOL,
                               atol=tpw.MODEL_TOL)
    # each pp rank holds its stage's layers only
    for o in world:
        layers = {n.split(".")[0] for n in o[label]["params"]
                  if n.startswith("layer_")}
        lp = 4 // spec["pp"]
        assert layers == {f"layer_{o[label]['stage'] * lp + j}"
                          for j in range(lp)}


def _port_model(cfg, n_stages, **kw):
    params = tpw.inputs()["params"]["abs"]
    model = PipelinedLM(port_tf.TransformerConfig(**cfg), n_stages, **kw)
    model.load_state_dict(convert.params_from_jax(params))
    return model


@pytest.mark.parametrize("remat", [False, True])
def test_pipelined_one_stage_matches_jax(remat):
    """One stage, 4 micro-batches in one process: logits and the loss's
    gradients against the JAX sequential Transformer."""
    logits, loss, grads, _ = tpw.jax_reference("abs")
    model = _port_model(dict(tpw.CFGS["abs"], remat=remat), 1, n_micro=4)
    tokens = torch.from_numpy(tpw.inputs()["tokens"])
    out = model(tokens[:, :-1])
    got_loss = port_tf.lm_loss(out, tokens[:, 1:])
    names = [n for n, _ in model.named_parameters()]
    got = torch.autograd.grad(got_loss, list(model.parameters()))
    np.testing.assert_allclose(out.detach().numpy(), logits,
                               rtol=tpw.MODEL_TOL, atol=tpw.MODEL_TOL)
    assert got_loss.item() == pytest.approx(loss, rel=tpw.MODEL_TOL)
    for n, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), grads[n], rtol=tpw.MODEL_TOL,
                                   atol=tpw.MODEL_TOL, err_msg=n)


def test_pipelined_layout_converts_from_jax():
    """JAX's ``from_transformer`` layout (stacked ``[n_stages,
    layers/stage, ...]`` blocks) maps to the port's names and back."""
    params = tpw.inputs()["params"]["abs"]
    cfg = jax_tf.TransformerConfig(**tpw.CFGS["abs"])
    tree = jax.tree_util.tree_map(
        np.asarray, JaxPipelinedLM(cfg, n_stages=2).from_transformer(params))
    got = convert.pipelined_from_jax(tree, 2)
    want = convert.params_from_jax(params)
    assert set(got) == set(want)
    for n, t in got.items():
        assert torch.equal(t, want[n]), n
    back = convert.pipelined_to_jax(got, 2)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                jax.tree_util.tree_leaves_with_path(tree)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_pipelined_validation_matches_jax():
    cfg = tpw.CFGS["abs"]
    jcfg = jax_tf.TransformerConfig(**cfg)
    tokens = torch.from_numpy(tpw.inputs()["tokens"][:5, :-1])
    for kw, n_stages, exc, frag in (
            ({}, 3, ValueError, "divisible"),
            ({"num_experts": 2}, 2, ValueError, "num_experts"),
            ({"decode": True}, 2, NotImplementedError, "decode")):
        with pytest.raises(exc, match=frag):
            JaxPipelinedLM(jax_tf.TransformerConfig(**dict(cfg, **kw)),
                           n_stages=n_stages)
        with pytest.raises(exc, match=frag):
            PipelinedLM(port_tf.TransformerConfig(**dict(cfg, **kw)),
                        n_stages)
    # the mesh's pp extent (1 with none) must equal n_stages
    with pytest.raises(ValueError, match="mesh pp axis size 1 must equal "
                       "n_stages=4"):
        PipelinedLM(jcfg, 4)(tokens)
    # n_micro defaults to the pp degree; the batch must split into it
    with pytest.raises(ValueError, match="batch 5 must be divisible by "
                       "n_micro=4"):
        _port_model(cfg, 1, n_micro=4)(tokens)
    assert _port_model(cfg, 1)(tokens).shape == (5, 16, 64)
