"""Parity of the port's tensor-parallel (tp) and sequence-parallel (sp)
forward and train step with the JAX package, over four gloo ranks
(``tests/torch_model_parallel_world.py``).

The 4-layer, d_model 32 LM (4 heads, 2 kv heads of head_dim 8, biases,
LayerNorm) is sharded by the JAX rules on ``{tp: 4}`` (learned
positions) and ``{dp: 2, tp: 2}`` with ``sp_axis="tp"`` (RoPE).  At
tp=4 the key / value projections (16 columns) are split mid-head, as
JAX's rules split them; the forward gathers them.  The logits (the
ranks' vocabulary slices gathered), the loss, the grad_norm and the
whole gradient of one ``make_train_step`` step (SGD at lr 1, so the
parameters' change IS the gradient) are held against the JAX
sequential Transformer on the same numpy weights and batch within 3e-5
(the JAX model tests' f32 tolerance; dense attention on the JAX side,
the flash kernels' plain versions on the port's).  One adamw_fused step
of a 2-layer cut on ``{fsdp: 2, tp: 2}`` (two-dim splits) is held
against the JAX step on a JAX mesh of the same shape, and adamw8bit's
shard-aligned payloads there against JAX's per shard.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_model_parallel_world as tpw
from tensorflowonspark_tpu import optim as jax_optim
from tensorflowonspark_tpu import optim8bit as jax_8bit
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu.parallel import mesh as jax_mesh
from tensorflowonspark_tpu.parallel import sharding as jax_sharding
from tensorflowonspark_tpu.parallel import train as jax_train
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.models import transformer as port_tf
from tensorflowonspark_tpu_torch.parallel import collectives as coll
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_mod
from tensorflowonspark_tpu_torch.parallel import sharding as sharding_mod

GRAD_FLOOR = 1e-5       # of the leaf's largest |gradient| (see A3a's test)
MAX_LEFT_OUT = 1e-3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tpw.world(tmp_path_factory)


def _key(name, ndim):
    path, _ = convert.flax_path(name, ndim)
    return "".join(f"['{k}']" for k in path.split("/"))


@pytest.mark.parametrize("label", ["tp4", "dp2tp2_sp"])
def test_split_forward_and_step_match_jax(world, label):
    tpw.check_model_case(world, label)


@pytest.mark.parametrize("label", ["tp4", "fsdp2tp2_adamw"])
def test_tp_specs_match_jax(world, label):
    """Every leaf's spec is JAX's on the same mesh shape; at tp=4 the kv
    projections split mid-head (16 columns of head_dim 8)."""
    spec, name = tpw.CASES[label][0], tpw.CASES[label][1]
    mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(**spec),
                               devices=jax.devices()[:tpw.WORLD])
    params = jax.tree_util.tree_map(jnp.asarray,
                                    tpw.inputs()["params"][name])
    want = {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_leaves_with_path(
                jax_sharding.infer_param_shardings(
                    params, mesh, fsdp="fsdp" in spec))}
    got = world[0][label]["specs"]
    for n, (s, transposed) in got.items():
        assert s == want[_key(n, 2 if transposed else 1)], n
    if label == "tp4":
        assert got["layer_0.attn.key.weight"] == ((None, "tp"), True)


def _jax_step(label):
    """The JAX package's step for an optimizer case on a JAX mesh of the
    same shape: ``(state after one step, loss, layouts)``."""
    spec, name, _, _, opt_name = tpw.CASES[label]
    inp = tpw.inputs()
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(
        **dict(tpw.CFGS[name], attention_impl="dense")))
    mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(**spec),
                               devices=jax.devices()[:tpw.WORLD])
    params = jax.tree_util.tree_map(jnp.asarray, inp["params"][name])
    shardings = jax_sharding.infer_param_shardings(params, mesh,
                                                   fsdp="fsdp" in spec)
    layouts, kw = None, {}
    if opt_name == "adamw8bit":
        layouts = jax_8bit.layouts_for_shardings(params, shardings)
        kw = dict(example_params=params, layouts=layouts)
    opt, _ = jax_optim.make_optimizer(
        opt_name, decay_mask=jax_optim.default_decay_mask, layouts=layouts,
        **tpw.OPT[opt_name])

    def loss(p, batch, rng):
        return jax_tf.lm_loss(jm.apply({"params": p}, batch[:, :-1]),
                              batch[:, 1:])

    state = jax_train.create_train_state(params, opt, mesh, shardings)
    step = jax_train.make_train_step(loss, opt, mesh, shardings,
                                     donate=False, **kw)
    batch = jax.device_put(jnp.asarray(inp["tokens"]),
                           jax_mesh.batch_sharding(mesh))
    state, m = step(state, batch, jax.random.key(0))
    return state, float(m["loss"]), layouts


def _flat(tree):
    return {n: t.numpy() for n, t in convert.params_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                               tree)).items()}


def test_adamw_fused_step_on_tp_shards_matches_jax(world):
    """One fused-AdamW step (kernel 7's plain version on each rank's
    shard, split over tp and fsdp, two dims on most kernels): loss, parameters and moments against the JAX
    step on the same mesh shape.  Adam's first step moves each element
    by about lr whatever the gradient's size, so the elements whose
    gradient is at rounding level are left out, as in A3a's test, and so
    is a leaf whose whole gradient is."""
    label = "fsdp2tp2_adamw"
    state, loss, _ = _jax_step(label)
    for o in world:
        assert o[label]["loss"] == pytest.approx(loss, rel=tpw.MODEL_TOL)
    _, _, grads, _ = tpw.jax_reference(tpw.CASES[label][1])
    got = tpw.joined(world, label, "params")
    want = _flat(state.params)
    top = max(np.abs(g).max() for g in grads.values())
    # gradients that are rounding noise throughout (the key bias: softmax
    # ignores a shift of a query's every logit), where Adam's step is
    # noise / (|noise| + eps)
    noise = {n for n, g in grads.items() if np.abs(g).max() < GRAD_FLOOR * top}
    assert noise <= {f"layer_{i}.attn.key.bias" for i in range(2)}
    for n, a in got.items():
        if n in noise:
            continue
        g = np.abs(grads[n])
        kept = (g == 0) | (g >= GRAD_FLOOR * g.max())
        # at most a thousandth of a leaf, or one element of a small one
        assert (~kept).sum() <= max(1, MAX_LEFT_OUT * g.size), n
        diff = np.abs(a - want[n])[kept]
        assert diff.max() <= 1e-4 and diff.mean() <= 1e-6, (n, diff.max())
    for key in ("mu", "nu"):
        got = tpw.joined(world, label, key)
        ref = _flat(getattr(state.opt_state, key))
        for n, a in got.items():
            if n not in noise:
                assert np.abs(a - ref[n]).max() <= 1e-2 * np.abs(
                    ref[n]).max(), (key, n)


def _find_8bit(tree):
    if isinstance(tree, jax_8bit.Adam8bitState):
        return tree
    if isinstance(tree, tuple):
        return next((f for f in map(_find_8bit, tree) if f is not None),
                    None)
    return None


def test_adamw8bit_layouts_on_fsdp_tp_match_jax(world):
    """Two-dim layouts (fsdp and tp) equal JAX's, and each rank's 8-bit
    payload is JAX's aligned payload's rows of its shard (shard ``k`` =
    row-major over the flax dims' split indices), within 2.5
    quantisation steps after one step."""
    label = "fsdp2tp2_8bit"
    state, loss, layouts = _jax_step(label)
    jl = {jax.tree_util.keystr(p): lo for p, lo in
          jax.tree_util.tree_leaves_with_path(
              layouts, is_leaf=lambda x: x is None or isinstance(x, tuple))}
    got_layouts = world[0][label]["layouts"]
    assert any(lo and sum(c > 1 for c in lo) == 2
               for lo in got_layouts.values())
    q8 = _find_8bit(state.opt_state)
    mesh = tpw.case_mesh(label)
    for name, counts in got_layouts.items():
        key = _key(name, 2 if world[0][label]["specs"][name][1] else 1)
        assert counts == jl[key], name
        for field, signed, steps in (("mu", True, 127.0),
                                     ("nu_sqrt", False, 254.0)):
            w = getattr(q8, field)
            for part in key[2:-2].split("']['"):
                w = w[part]
            wq, ws = np.asarray(w.q), np.asarray(w.scale)
            off = 0.0 if signed else 127.0
            rows = {}
            for o in world:
                q, s = o[label]["q8"][field][name]
                if counts is None:
                    k, per = 0, wq.shape[0]
                else:
                    spec, transposed = o[label]["specs"][name]
                    sh = mesh_mod.NamedSharding(mesh, spec, transposed)
                    # the shard's index, row-major over the flax dims
                    flax_dims = sh.dim_axes(len(counts))
                    if transposed:
                        flax_dims = flax_dims[::-1]
                    k = 0
                    for axes, c in zip(flax_dims, counts):
                        idx = 0
                        for a in axes:
                            idx = idx * mesh.shape[a] + o[label]["coords"][a]
                        k = k * c + idx
                    per = wq.shape[0] // int(np.prod(counts))
                rows[k] = (q, s)
                a = (q.astype(np.float32) + off) * (s / steps)
                b = (wq[k * per:(k + 1) * per].astype(np.float32) + off) * (
                    ws[k * per:(k + 1) * per] / steps)
                assert a.shape == b.shape, (name, field)
                assert np.abs(a - b).max() <= 2.5 * ws.max() / steps, (
                    name, field)
            assert sum(r[0].shape[0] for r in rows.values()) == wq.shape[0]


def test_eval_step_and_gather_params_on_tp(world):
    """make_eval_step on a tp=4 state: the gathered vocabulary slices are
    the JAX logits; gather_params puts every tp shard back."""
    logits, _, _, _ = tpw.jax_reference("abs")
    for o in world:
        np.testing.assert_allclose(o["misc"]["eval_logits"], logits,
                                   rtol=tpw.MODEL_TOL, atol=tpw.MODEL_TOL)
        full = convert.params_from_jax(tpw.inputs()["params"]["abs"])
        for n, a in o["misc"]["gathered"].items():
            np.testing.assert_array_equal(a, full[n].numpy())


def test_adafactor_over_tp_shards_raises(world):
    for o in world:
        err = o["misc"]["errors"]["adafactor"]
        assert err.startswith("NotImplementedError") and "tp-sharded" in err


def test_vocab_parallel_loss_at_tp1_matches_lm_loss():
    """The vocab-parallel pieces on one rank (tp=1) give lm_loss, and JAX's
    one-hot lm_loss, with ignored targets."""
    rng = np.random.RandomState(5)
    logits = rng.randn(2, 6, 40).astype(np.float32) * 3
    targets = rng.randint(0, 40, (2, 6))
    targets[0, :2] = -1
    want = float(jax_tf.lm_loss(jnp.asarray(logits), jnp.asarray(targets)))
    t = torch.from_numpy(logits).requires_grad_(True)
    split = port_tf.LogitsSplit(coll.SOLO, 0, 40, coll.SOLO)
    got = port_tf.vocab_parallel_lm_loss(t, torch.from_numpy(targets), split)
    plain = port_tf.lm_loss(t, torch.from_numpy(targets))
    assert got.item() == pytest.approx(want, rel=1e-6)
    g1, = torch.autograd.grad(got, t)
    g2, = torch.autograd.grad(plain, t)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-6, atol=1e-7)


def test_shard_of_and_join_shards_over_two_dims():
    """A tp + fsdp leaf (JAX's ``_add_fsdp`` on a dim tp left whole): the
    slices by coords join back to the tensor."""
    mesh = mesh_mod.Mesh(mesh_mod.MeshSpec(dp=1, fsdp=2, tp=2).resolve(4))
    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    sh = mesh_mod.NamedSharding(mesh, ("fsdp", "tp"), transposed=True)
    assert sh.shard_dim(2) == [(0, ("tp",)), (1, ("fsdp",))]
    shards = []
    for f in range(2):
        for p in range(2):
            coords = dict(dp=0, fsdp=f, pp=0, tp=p)
            s = convert.shard_of(t, sh, coords)
            np.testing.assert_array_equal(s.numpy(),
                                          t[4 * p:4 * p + 4, 3 * f:3 * f + 3])
            shards.append(s)
    np.testing.assert_array_equal(convert.join_shards(shards, sh).numpy(),
                                  t.numpy())
    sh_model = sharding_mod.infer_param_shardings(
        {"layer_0.attn.query.weight": t}, mesh, fsdp=True)
    assert sh_model["layer_0.attn.query.weight"].spec == ("fsdp", "tp")
