"""Parity of the port's optimizers and schedules with the JAX package's.

- ``adamw_fused`` (kernel 7's plain version on CPU tensors) against the
  JAX ``adamw_fused`` with its Pallas kernel in interpret mode, three
  ``apply`` steps on a small tree: a kernel leaf whose size (16 x 130) is
  not a multiple of 128, a 1-D norm scale, an embedding; global-norm
  clipping engaged, weight decay with ``default_decay_mask``, a bf16
  first moment, a cosine schedule with warmup.  Once from a fresh
  state, once from the JAX state after step 1 carried across by
  ``convert.adamw_state_from_jax``.
- ``adam`` / ``adamw`` / ``sgd`` (plain tensor code) against the optax
  transforms the JAX ``make_optimizer`` builds, three update steps.
- every schedule, with and without warmup, at counts 0..14.

Tolerances: parameters and nu 1e-6 relative (f32 on both sides; XLA may
contract a product and a sum into one FMA where torch rounds twice); a
bf16 mu 1e-2 relative (those f32 differences can round a value to the
neighbouring bf16, 2^-8 apart), and where a mu element turned so, its
parameter may differ by up to lr * 2^-6 (at most 1% of the elements);
schedules 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tensorflowonspark_tpu import optim as jax_optim
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch import optim as port_optim

KW = dict(learning_rate=0.05, schedule="cosine", warmup_steps=2,
          total_steps=10, weight_decay=0.1, clip_norm=1.0,
          mu_dtype="bfloat16")


def _tree(rng):
    return {"layer_0": {"attn": {"query": {"kernel": rng.randn(16, 130)}},
                        "ln1": {"scale": rng.randn(7)}},
            "token_embed": {"embedding": rng.randn(10, 16)}}


def _f32(tree, scale=1.0):
    return jax.tree_util.tree_map(
        lambda x: (scale * x).astype(np.float32), tree)


def _close(got, want, rtol, atol=1e-7):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for path, a in flat_g:
        np.testing.assert_allclose(
            np.asarray(a, np.float32), np.asarray(flat_w[path], np.float32),
            rtol=rtol, atol=atol, err_msg=jax.tree_util.keystr(path))


def _close_params(got, want, lr):
    """Parameters within 1e-6 relative, but for the few elements whose
    bf16 mu rounded to a neighbour: within lr * 2^-6."""
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, a in jax.tree_util.tree_leaves_with_path(got):
        a = np.asarray(a, np.float32)
        b = np.asarray(flat_w[path], np.float32)
        diff = np.abs(a - b)
        off = diff > 1e-7 + 1e-6 * np.abs(b)
        name = jax.tree_util.keystr(path)
        assert off.mean() <= 0.01, (name, off.sum())
        assert diff.max() <= lr * 2**-6, (name, diff.max())


def _jax_steps(opt, params, state, grads):
    for g in grads:
        params, state = opt.apply(g, state, params)
    return params, state


def _port_steps(opt, params, state, grads):
    for g in grads:
        _, state = opt.apply(convert.params_from_jax(g), state, params)
    return params, state


def test_adamw_fused_matches_jax_over_three_steps():
    rng = np.random.RandomState(0)
    params = _f32(_tree(rng))
    grads = [_f32(_tree(rng), 3.0) for _ in range(3)]   # norm >> clip
    jopt, _ = jax_optim.make_optimizer(
        "adamw_fused", decay_mask=jax_optim.default_decay_mask, **KW)
    popt, _ = port_optim.make_optimizer(
        "adamw_fused", decay_mask=port_optim.default_decay_mask, **KW)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jp, js = _jax_steps(jopt, jparams, jopt.init(jparams), grads)
    pparams = convert.params_from_jax(params)
    pp, ps = _port_steps(popt, pparams, popt.init(pparams), grads)
    assert int(ps.count) == int(js.count) == 3
    assert ps.mu["layer_0.attn.query.weight"].dtype == torch.bfloat16
    _close_params(convert.params_to_jax(pp), jp, KW["learning_rate"])
    back = convert.adamw_state_to_jax(ps)
    _close(back.nu, js.nu, 1e-6)
    _close(back.mu, js.mu, 1e-2)


def test_adamw_fused_resumes_from_a_carried_jax_state():
    rng = np.random.RandomState(1)
    params = _f32(_tree(rng))
    grads = [_f32(_tree(rng), 3.0) for _ in range(3)]
    jopt, _ = jax_optim.make_optimizer(
        "adamw_fused", decay_mask=jax_optim.default_decay_mask, **KW)
    popt, _ = port_optim.make_optimizer(
        "adamw_fused", decay_mask=port_optim.default_decay_mask, **KW)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jp1, js1 = _jax_steps(jopt, jparams, jopt.init(jparams), grads[:1])
    carried = convert.adamw_state_from_jax(
        jax.tree_util.tree_map(np.asarray, js1))
    assert carried.mu["layer_0.attn.query.weight"].dtype == torch.bfloat16
    # the round trip is exact
    again = convert.adamw_state_to_jax(carried)
    _close(again.mu, js1.mu, 0.0, 0.0)
    _close(again.nu, js1.nu, 0.0, 0.0)
    pparams = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             jp1))
    pp, ps = _port_steps(popt, pparams, carried, grads[1:])
    jp, js = _jax_steps(jopt, jp1, js1, grads[1:])
    assert int(ps.count) == 3
    _close_params(convert.params_to_jax(pp), jp, KW["learning_rate"])
    _close(convert.adamw_state_to_jax(ps).nu, js.nu, 1e-6)


def test_adamw_fused_update_returns_the_step():
    rng = np.random.RandomState(2)
    params = _f32(_tree(rng))
    g = _f32(_tree(rng), 3.0)
    jopt, _ = jax_optim.make_optimizer("adamw_fused", **KW)
    popt, _ = port_optim.make_optimizer("adamw_fused", **KW)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jparams)
    jp1, js = _jax_steps(jopt, jparams, js, [g])
    jupd, _ = jopt.update(g, js, jp1)
    pparams = convert.params_from_jax(params)
    pp1, ps = _port_steps(popt, pparams, popt.init(pparams), [g])
    before = {n: t.clone() for n, t in pp1.items()}
    pupd, _ = popt.update(convert.params_from_jax(g), ps, pp1)
    for n, t in pp1.items():           # update leaves the params alone
        assert torch.equal(t, before[n])
    _close(convert.params_to_jax(pupd), jupd, 1e-5, 1e-9)


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(weight_decay=0.1, clip_norm=1.0, mu_dtype="bfloat16",
                   schedule="linear", warmup_steps=1, total_steps=8)),
    ("adam", dict(clip_norm=2.0, schedule="rsqrt", warmup_steps=2)),
    ("sgd", dict(momentum=0.9)),
    ("sgd", dict(momentum=None, schedule="cosine", total_steps=5)),
])
def test_plain_optimizers_match_optax(name, kw):
    rng = np.random.RandomState(3)
    params = _f32(_tree(rng))
    grads = [_f32(_tree(rng), 3.0) for _ in range(3)]
    mask = {"weight_decay"} & set(kw)
    jopt, _ = jax_optim.make_optimizer(
        name, learning_rate=0.05,
        decay_mask=jax_optim.default_decay_mask if mask else None, **kw)
    popt, _ = port_optim.make_optimizer(
        name, learning_rate=0.05,
        decay_mask=port_optim.default_decay_mask if mask else None, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    pp = convert.params_from_jax(params)
    ps = popt.init(pp)
    for g in grads:
        upd, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        pupd, ps = popt.update(convert.params_from_jax(g), ps, pp)
        port_optim.apply_updates(pp, pupd)
    _close_params(convert.params_to_jax(pp), jp, 0.05)


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("schedule", ["constant", "cosine", "linear",
                                      "rsqrt"])
def test_schedules_match_optax(schedule, warmup):
    kw = dict(learning_rate=0.3, schedule=schedule, warmup_steps=warmup,
              total_steps=11, end_value=0.01)
    jsched = jax_optim.make_schedule(**kw)
    psched = port_optim.make_schedule(**kw)
    for count in range(15):
        want = float(jsched(jnp.asarray(count, jnp.int32)))
        got = psched(torch.tensor(count, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert got.item() == pytest.approx(want, rel=1e-6, abs=1e-9), count


def test_make_optimizer_validates_like_jax():
    for kw in (dict(name="sgd", weight_decay=0.1),
               dict(name="adam", decay_mask=port_optim.default_decay_mask),
               dict(name="sgd", mu_dtype="bfloat16"),
               dict(name="adamw", layouts={}), dict(name="nope")):
        with pytest.raises(ValueError):
            port_optim.make_optimizer(**kw)
    with pytest.raises(ValueError, match="total_steps"):
        port_optim.make_schedule(0.1, "cosine")
