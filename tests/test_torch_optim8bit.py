"""Parity of the port's 8-bit AdamW (``optim8bit``) with the JAX package's.

- ``quantize`` / ``dequantize``: int8 payloads and f32 scales equal to
  the JAX module's, signed and unsigned, at sizes that are not a block
  multiple, with one block of zeros, at block sizes 256 and 64.
- ``make_optimizer("adamw8bit")`` against the JAX factory's over three
  update steps (weight decay under the decay mask, global-norm clipping,
  a warmup schedule) on a tree whose leaves both packages store alike:
  the updates, the step count and the quantised moments.
- A JAX 8-bit state carried across by ``convert.adam8bit_state_from_jax``
  for a tree with a Dense kernel (which the port stores transposed), and
  two more steps from it.
- shard-aligned ``layouts=``: payloads bitwise JAX's and back, the
  updates of ``adamw8bit(layouts=)`` as JAX's, and the helpers' errors
  (the sharded forms: ``test_torch_sharding.py``).

Tolerances: payloads and scales bitwise (the same f32 divisions, round
half to even on both sides); updates 1e-5 relative (the bias
corrections' ``b ** count`` and the clip's global norm may round
differently in XLA) and 1e-8 absolute: XLA contracts ``u + wd p`` into
an FMA, so where the two terms cancel the difference is an ulp of a
term (lr x O(1) = 0.05, one ulp 3.7e-9), not of the update.  The same
contractions of the moment updates leave the scales within 4 f32 ulps
after three steps; the payloads are equal but for rounding ties (an
ulp can move a value that sits at a .5 step to the neighbouring int8
code): the test counts those and asserts none occur on these inputs.
A carried Dense kernel's moments are quantised once more in the port's
layout: within half a quantisation step of the
block's scale (``s / 254`` signed, ``s / 508`` unsigned); two steps
later the moments lie within 2.5 steps of JAX's, and the other leaves'
updates within the tolerances above.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import optim as jax_optim
from tensorflowonspark_tpu import optim8bit as jax_8bit
from tensorflowonspark_tpu_torch import convert, optim8bit
from tensorflowonspark_tpu_torch import optim as port_optim

KW = dict(learning_rate=0.05, schedule="linear", warmup_steps=1,
          total_steps=8, weight_decay=0.1, clip_norm=1.0)


def _inputs(rng):
    zeros_first = rng.randn(700).astype(np.float32)
    zeros_first[:256] = 0.0                   # one block of zeros
    return [rng.randn(1000).astype(np.float32),
            rng.randn(3, 301).astype(np.float32),
            zeros_first, np.float32(rng.randn()) * np.ones((), np.float32)]


@pytest.mark.parametrize("block", [256, 64])
@pytest.mark.parametrize("signed", [True, False])
def test_quantize_matches_jax(signed, block):
    rng = np.random.RandomState(block + signed)
    for x in _inputs(rng):
        x = x if signed else np.abs(x)
        want = jax_8bit.quantize(jnp.asarray(x), block, signed=signed)
        got = optim8bit.quantize(torch.from_numpy(np.array(x)), block,
                                 signed=signed)
        assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))
        back = optim8bit.dequantize(got, x.shape, signed=signed)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jax_8bit.dequantize(
                want, x.shape, signed=signed)))


def _tree(rng):
    return {"w": rng.randn(40, 70), "b": rng.randn(300), "s": rng.randn(5)}


def _f32(tree, scale=1.0):
    return {n: (scale * x).astype(np.float32) for n, x in tree.items()}


def _payload_mismatches(port_state, jax_state):
    """Elements whose int8 code differs, over both moments; scales
    within 4 f32 ulps (the moments differ by ulps where XLA contracts
    ``b1 mu + (1-b1) g`` and ``b2 v + (1-b2) g g`` into FMAs, over three
    steps)."""
    bad = 0
    for port_tree, jax_tree in ((port_state.mu, jax_state.mu),
                                (port_state.nu_sqrt, jax_state.nu_sqrt)):
        for n, qt in port_tree.items():
            np.testing.assert_array_max_ulp(qt.scale.numpy(),
                                            np.asarray(jax_tree[n].scale), 4)
            bad += int((qt.q.numpy() != np.asarray(jax_tree[n].q)).sum())
    return bad


def test_adamw8bit_matches_jax_over_three_steps():
    rng = np.random.RandomState(0)
    params = _f32(_tree(rng))
    grads = [_f32(_tree(rng), 3.0) for _ in range(3)]
    jopt, _ = jax_optim.make_optimizer(
        "adamw8bit", decay_mask=jax_optim.default_decay_mask, **KW)
    popt, _ = port_optim.make_optimizer(
        "adamw8bit", decay_mask=port_optim.default_decay_mask, **KW)
    jp = {n: jnp.asarray(x) for n, x in params.items()}
    js = jopt.init(jp)
    pp = {n: torch.from_numpy(x.copy()) for n, x in params.items()}
    ps = popt.init(pp)
    for g in grads:
        jupd, js = jopt.update({n: jnp.asarray(x) for n, x in g.items()},
                               js, jp)
        pupd, ps = popt.update({n: torch.from_numpy(x) for n, x in g.items()},
                               ps, pp)
        for n in g:
            np.testing.assert_allclose(pupd[n].numpy(), np.asarray(jupd[n]),
                                       rtol=1e-5, atol=1e-8, err_msg=n)
        jp = {n: jp[n] + jupd[n] for n in jp}
        port_optim.apply_updates(pp, pupd)
    # the chain's states: (clip, (8-bit adam, decay, lr schedule))
    j8, p8 = js[1][0], ps[1][0]
    assert int(p8.count) == int(j8.count) == 3
    assert p8.count.dtype == torch.int32
    assert _payload_mismatches(p8, j8) == 0


def test_adamw8bit_resumes_from_a_carried_jax_state():
    rng = np.random.RandomState(1)
    params = {"layer_0": {"attn": {"query": {"kernel": rng.randn(16, 130)}},
                          "ln1": {"scale": rng.randn(7)}},
              "token_embed": {"embedding": rng.randn(10, 16)}}
    params = jax.tree_util.tree_map(lambda x: x.astype(np.float32), params)
    grads = [jax.tree_util.tree_map(lambda x: 3 * x, params)
             for _ in range(1)]
    grads += [jax.tree_util.tree_map(
        lambda x: rng.randn(*x.shape).astype(np.float32), params)
        for _ in range(2)]
    kw = dict(learning_rate=0.05, weight_decay=0.1)
    jopt, _ = jax_optim.make_optimizer(
        "adamw8bit", decay_mask=jax_optim.default_decay_mask, **kw)
    popt, _ = port_optim.make_optimizer(
        "adamw8bit", decay_mask=port_optim.default_decay_mask, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    upd, js = jopt.update(grads[0], js, jp)
    jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, upd)
    pp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    carried = convert.adam8bit_state_from_jax(
        jax.tree_util.tree_map(np.asarray, js[0]), pp)
    assert int(carried.count) == 1
    # leaves stored alike carry bitwise; the kernel within half a step
    emb = np.asarray(js[0].mu["token_embed"]["embedding"].q)
    np.testing.assert_array_equal(
        carried.mu["token_embed.weight"].q.numpy(), emb)
    for tree, signed, half in ((js[0].mu, True, 254.0),
                               (js[0].nu_sqrt, False, 508.0)):
        qt = tree["layer_0"]["attn"]["query"]["kernel"]
        want = np.asarray(jax_8bit.dequantize(qt, (16, 130),
                                              signed=signed)).T
        ported = (carried.mu if signed else carried.nu_sqrt)[
            "layer_0.attn.query.weight"]
        got = optim8bit.dequantize(ported, (130, 16), signed=signed).numpy()
        step = np.asarray(qt.scale).max() / half
        assert np.abs(got - want).max() <= step * (1 + 1e-6)
    ps = (carried, popt.init(pp)[1],
          port_optim.ScaleByScheduleState(torch.tensor(1, dtype=torch.int32)))
    for g in grads[1:]:
        jupd, js = jopt.update(g, js, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, jupd)
        pupd, ps = popt.update(convert.params_from_jax(g), ps, pp)
        port_optim.apply_updates(pp, pupd)
        got = convert.params_to_jax(pupd)
        flat_w = dict(jax.tree_util.tree_leaves_with_path(jupd))
        for path, a in jax.tree_util.tree_leaves_with_path(got):
            name = jax.tree_util.keystr(path)
            if "kernel" not in name:
                np.testing.assert_allclose(a, np.asarray(flat_w[path]),
                                           rtol=1e-5, atol=1e-8,
                                           err_msg=name)
    # the carried kernel: its moments stay within 2.5 quantisation steps
    # of JAX's (the carry's half step, decayed by b1 / b2, plus up to one
    # step per later re-quantisation, where each side rounds by half a
    # step); its updates are not held elementwise: where sqrt(v) is a
    # few steps, half a step moves the update by a large share
    for port_tree, jax_tree, signed, steps in (
            (ps[0].mu, js[0].mu, True, 127.0),
            (ps[0].nu_sqrt, js[0].nu_sqrt, False, 254.0)):
        qt = jax_tree["layer_0"]["attn"]["query"]["kernel"]
        want = np.asarray(jax_8bit.dequantize(qt, (16, 130),
                                              signed=signed)).T
        got = optim8bit.dequantize(port_tree["layer_0.attn.query.weight"],
                                   (130, 16), signed=signed).numpy()
        assert np.abs(got - want).max() <= 2.5 * np.asarray(
            qt.scale).max() / steps
    assert int(ps[0].count) == 3


def test_layouts_and_sharding_helpers_raise():
    """The layout helpers refuse what JAX's refuse: a layout that does not
    tile the tensor, a payload built without it, and ``mu_dtype``."""
    with pytest.raises(ValueError, match="does not tile"):
        optim8bit.quantize(torch.zeros(4, 4), layout=(3, 1))
    q = optim8bit.quantize(torch.ones(4, 4), 4)
    with pytest.raises(ValueError, match="was not quantized with layout"):
        optim8bit.dequantize(q._replace(q=q.q[:2], scale=q.scale[:2]),
                             (4, 4), layout=(2, 1))
    with pytest.raises(ValueError) as e:
        jax_8bit.quantize(jnp.zeros((4, 4)), layout=(3, 1))
    assert "does not tile" in str(e.value)
    assert optim8bit.shard_layout((4, 4), None) is None
    assert optim8bit.layouts_for_shardings({}, {}) == {}
    with pytest.raises(ValueError, match="mu_dtype"):
        port_optim.make_optimizer("adamw8bit", mu_dtype="bfloat16")


def test_layouts_round_trip_and_equal_jax():
    """A layout tuple over the tensor's own dims: payload and scales
    bitwise JAX's, and back; ``adamw8bit(layouts=)`` updates as JAX's
    over the tree of the three-step test."""
    rng = np.random.RandomState(11)
    x = rng.randn(8, 96).astype(np.float32)
    for layout in ((2, 1), (4, 3), (1, 2)):
        want = jax_8bit.quantize(jnp.asarray(x), 64, layout=layout)
        got = optim8bit.quantize(torch.from_numpy(x), 64, layout=layout)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))
        np.testing.assert_array_equal(
            optim8bit.dequantize(got, x.shape, layout=layout).numpy(),
            np.asarray(jax_8bit.dequantize(want, x.shape, layout=layout)))
    params = {"w": x, "b": rng.randn(96).astype(np.float32)}
    grads = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
    lay = {"w": (4, 1), "b": None}
    jopt, _ = jax_optim.make_optimizer("adamw8bit", layouts=lay, **KW)
    popt, _ = port_optim.make_optimizer("adamw8bit", layouts=lay, **KW)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ps = jopt.init(jp), popt.init(pp)
    for _ in range(2):
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in grads.items()},
                             js, jp)
        pu, ps = popt.update({k: torch.from_numpy(v) for k, v in
                              grads.items()}, ps, pp)
        for k in params:
            np.testing.assert_allclose(pu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-5, atol=1e-8)
    # chain(clip, chain(scale_by_adam_8bit, decay, lr)) on both sides
    for field in ("mu", "nu_sqrt"):
        got, want = getattr(ps[1][0], field)["w"], getattr(js[1][0], field)["w"]
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
