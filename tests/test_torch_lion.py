"""Parity of the port's Lion optimizers with the JAX package's.

- ``lion_fused`` (kernel 8's plain version on CPU tensors) against the
  JAX ``lion_fused`` with its Pallas kernel in interpret mode, three
  steps on a small tree (a 16 x 130 kernel, a 1-D norm scale, an
  embedding) with global-norm clipping engaged, weight decay under
  ``default_decay_mask`` and a cosine schedule with warmup: f32 and bf16
  mu, through ``apply`` and through ``update``.  Once from a fresh
  state, once from the JAX state after step 1 carried across by
  ``convert.lion_state_from_jax``.
- ``make_optimizer("lion")`` (plain tensor code) against the ``optax.lion``
  the JAX factory builds, three steps, f32 and bf16 mu.
- Two train steps of the tiny transformer with ``lion_fused`` against the
  JAX train step.

Tolerances: the fused optimizer is held per step from identical inputs
(the JAX state and parameters carried in before each step), so
differences do not compound.  The port rounds every product and sum
separately, as kernel 8 does on the card (bitwise equal to
``lion_plain`` there, ``test_torch_cuda.py``); XLA's CPU code contracts
``(1-b2) g + b2 mu``, ``upd + wd p`` and ``p - lr upd`` into FMAs (found
by emulating each contraction: with all three the port's rounding order
gives XLA's bits), and its global norm and cosine schedule may round
differently.  So each output lies within 2 f32 ulps of the largest term
of its expression (``|p|`` and ``lr (1 + wd |p|)`` for the parameter or
update, ``(1-b2) |g| + b2 |mu|`` for mu): an FMA is exact where the
rounded product was not, so under cancellation the difference is an ulp
of the term, not of the result.  A bf16 mu within one bf16 step (rtol
2^-7).  Where no rounding differs (the warm-up step at lr 0) the
outputs are bitwise equal.  Plain ``lion``: 1e-6
relative.  The train steps as ``test_torch_train.py`` states them: loss
and grad_norm 1e-5 relative; parameters within 1e-4 after 2 steps at lr
1e-3 (Lion moves every element by exactly lr, so an element whose
interpolation is near 0 can take the other sign: 2 lr = 2e-3 at most,
on at most 0.1% of the elements) and 1e-6 on average.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tensorflowonspark_tpu import optim as jax_optim
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu.parallel import train as jax_train
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch import optim as port_optim
from tensorflowonspark_tpu_torch.models import transformer as port_tf
from tensorflowonspark_tpu_torch.ops import fused_optim as port_fo
from tensorflowonspark_tpu_torch.parallel import train as port_train

KW = dict(learning_rate=0.05, schedule="cosine", warmup_steps=2,
          total_steps=10, weight_decay=0.1, clip_norm=1.0)


def _tree(rng):
    return {"layer_0": {"attn": {"query": {"kernel": rng.randn(16, 130)}},
                        "ln1": {"scale": rng.randn(7)}},
            "token_embed": {"embedding": rng.randn(10, 16)}}


def _f32(tree, scale=1.0):
    return jax.tree_util.tree_map(
        lambda x: (scale * x).astype(np.float32), tree)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for name, a in got.items():
        np.testing.assert_array_equal(a, want[name], err_msg=name)


def _within(got, want, scale, ulps):
    """|got - want| <= ulps f32 ulps of ``scale`` (per leaf,
    elementwise)."""
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for name, a in got.items():
        bound = ulps * np.spacing(np.abs(scale[name]).astype(np.float32))
        assert np.all(np.abs(a - want[name]) <= bound), (
            name, np.abs(a - want[name]).max())


def _pair(mu_dtype):
    kw = dict(KW, mu_dtype=mu_dtype)
    jopt, _ = jax_optim.make_optimizer(
        "lion_fused", decay_mask=jax_optim.default_decay_mask, **kw)
    popt, _ = port_optim.make_optimizer(
        "lion_fused", decay_mask=port_optim.default_decay_mask, **kw)
    return jopt, popt


def _step(jopt, popt, mode, jp, js, g):
    """One JAX step and one port step from the same parameters and
    state: ``(JAX params, JAX state, port params, port state, JAX out,
    port out)``; out is the parameters (apply) or the update."""
    pp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    ps = convert.lion_state_from_jax(jax.tree_util.tree_map(np.asarray, js))
    tg = convert.params_from_jax(g)
    if mode == "apply":
        jp2, js2 = jopt.apply(g, js, jp)
        _, ps = popt.apply(tg, ps, pp)
        return jp2, js2, pp, ps, jp2, pp
    jupd, js2 = jopt.update(g, js, jp)
    pupd, ps = popt.update(tg, ps, pp)
    port_optim.apply_updates(pp, pupd)
    return optax.apply_updates(jp, jupd), js2, pp, ps, jupd, pupd


def _check_step(mu_dtype, mode, jp, js, g, want_out, want_mu, got_out,
                got_mu, lr, b2=0.99, wd=0.1):
    p, m, gl = _leaves(jp), _leaves(js.mu), _leaves(g)
    dec = {n: wd if "kernel" in n or "embedding" in n else 0.0 for n in p}
    step = {n: lr * (1 + dec[n] * np.abs(p[n])) for n in p}
    scale = ({n: np.maximum(np.abs(p[n]), step[n]) for n in p}
             if mode == "apply" else step)
    _within(convert.params_to_jax(got_out), want_out, scale, 2)
    got_mu = convert.lion_state_to_jax(got_mu).mu
    if mu_dtype == "bfloat16":
        for name, a in _leaves(got_mu).items():
            np.testing.assert_allclose(a, _leaves(want_mu)[name], rtol=2**-7,
                                       atol=0, err_msg=name)
    else:
        _within(got_mu, want_mu, {n: (1 - b2) * np.abs(gl[n])
                                  + b2 * np.abs(m[n]) for n in m}, 2)


@pytest.mark.parametrize("mode", ["apply", "update"])
@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_lion_fused_matches_jax_per_step(mu_dtype, mode):
    rng = np.random.RandomState(0)
    params = _f32(_tree(rng))
    grads = [_f32(_tree(rng), 3.0) for _ in range(3)]   # norm >> clip
    jopt, popt = _pair(mu_dtype)
    _, sched = port_optim.make_optimizer("lion_fused", **KW)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    for i, g in enumerate(grads):
        jp2, js2, pp, ps, want, got = _step(jopt, popt, mode, jp, js, g)
        assert int(ps.count) == int(js2.count) == i + 1
        assert ps.mu["layer_0.attn.query.weight"].dtype == getattr(
            torch, mu_dtype)
        lr = float(sched(i))
        if lr == 0.0:      # the warm-up step: nothing rounds differently
            _equal(convert.params_to_jax(got), want)
        _check_step(mu_dtype, mode, jp, js, g, want, js2.mu, got, ps, lr)
        jp, js = jp2, js2


def test_lion_fused_resumes_from_a_carried_jax_state():
    # step 1 on the JAX side, carried across; steps 2 and 3 on the port
    # from its own state: two steps' roundings, 4 ulps of a scale that
    # covers each term (|p| or lr (1 + wd |p|) <= 0.1; |mu| + 0.1 over
    # (1-b2) |g| + b2 |mu|)
    rng = np.random.RandomState(1)
    params = _f32(_tree(rng))
    grads = [_f32(_tree(rng), 3.0) for _ in range(3)]
    jopt, popt = _pair("float32")
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jp1, js1 = jopt.apply(grads[0], jopt.init(jparams), jparams)
    carried = convert.lion_state_from_jax(
        jax.tree_util.tree_map(np.asarray, js1))
    assert int(carried.count) == 1
    _equal(convert.lion_state_to_jax(carried).mu, js1.mu)
    pp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp1))
    jp, js, ps = jp1, js1, carried
    for g in grads[1:]:
        jp, js = jopt.apply(g, js, jp)
        _, ps = popt.apply(convert.params_from_jax(g), ps, pp)
    assert int(ps.count) == 3
    p1 = _leaves(jp1)
    _within(convert.params_to_jax(pp), jp,
            {n: np.maximum(np.abs(a), 0.1) for n, a in p1.items()}, 4)
    _within(convert.lion_state_to_jax(ps).mu, js.mu,
            {n: np.abs(a) + 0.1 for n, a in _leaves(js.mu).items()}, 4)


def test_lion_fused_update_needs_params_for_decay():
    popt, _ = port_optim.make_optimizer("lion_fused", weight_decay=0.1)
    p = {"w": torch.ones(3)}
    with pytest.raises(ValueError, match="requires params"):
        popt.update(p, popt.init(p))
    with pytest.raises(ValueError, match="requires params"):
        popt.apply(p, popt.init(p), None)


def test_lion_plain_sign_follows_jnp():
    x = torch.tensor([float("nan"), -0.0, 0.0, 2.0, -3.0, float("inf")])
    got = port_fo.sign(x)
    want = np.asarray(jnp.sign(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.array_equal(np.signbit(got.numpy()), np.signbit(want))


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_plain_lion_matches_optax(mu_dtype):
    rng = np.random.RandomState(3)
    params = _f32(_tree(rng))
    grads = [_f32(_tree(rng), 3.0) for _ in range(3)]
    kw = dict(learning_rate=0.05, weight_decay=0.1, clip_norm=1.0,
              schedule="linear", warmup_steps=1, total_steps=8,
              mu_dtype=mu_dtype)
    jopt, _ = jax_optim.make_optimizer(
        "lion", decay_mask=jax_optim.default_decay_mask, **kw)
    popt, _ = port_optim.make_optimizer(
        "lion", decay_mask=port_optim.default_decay_mask, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    pp = convert.params_from_jax(params)
    ps = popt.init(pp)
    for g in grads:
        upd, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        pupd, ps = popt.update(convert.params_from_jax(g), ps, pp)
        port_optim.apply_updates(pp, pupd)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(jp))
    for path, a in jax.tree_util.tree_leaves_with_path(
            convert.params_to_jax(pp)):
        np.testing.assert_allclose(a, np.asarray(flat_w[path]), rtol=1e-6,
                                   atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))


def test_lion_fused_train_steps_match_jax():
    cfg = dict(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2,
               n_layers=2, d_ff=128, max_seq_len=16, dtype="float32",
               rope=True, norm_type="rmsnorm", attention_impl="flash")
    opt_kw = dict(learning_rate=1e-3, weight_decay=0.1, clip_norm=0.5,
                  mu_dtype="bfloat16")
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**cfg))
    tokens = np.random.RandomState(7).randint(0, 64, (4, 17))
    params = jm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])

    def jax_loss(p, batch, rng):
        return jax_tf.lm_loss(jm.apply({"params": p}, batch[:, :-1]),
                              batch[:, 1:])

    jopt, _ = jax_optim.make_optimizer(
        "lion_fused", decay_mask=jax_optim.default_decay_mask, **opt_kw)
    jstate = jax_train.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), jopt)
    jstep = jax_train.make_train_step(jax_loss, jopt)
    pm = port_tf.build_transformer(**cfg)
    pm.load_state_dict(convert.params_from_jax(params), strict=True)
    popt, _ = port_optim.make_optimizer(
        "lion_fused", decay_mask=port_optim.default_decay_mask, **opt_kw)
    pstate = port_train.create_train_state(pm, popt)
    pstep = port_train.make_train_step(
        lambda m, b, r: port_tf.lm_loss(m(b[:, :-1]), b[:, 1:]), popt)
    jbatch, pbatch = jnp.asarray(tokens), torch.from_numpy(tokens)
    for _ in range(2):
        jstate, jm_ = jstep(jstate, jbatch, jax.random.key(0))
        pstate, pm_ = pstep(pstate, pbatch, None)
        for key in ("loss", "grad_norm"):
            assert pm_[key].item() == pytest.approx(float(jm_[key]),
                                                    rel=1e-5), key
    assert int(pstate.opt_state.count) == 2
    want = jax.tree_util.tree_map(np.asarray, jstate.params)
    got = convert.params_to_jax(pstate.params.state_dict())
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, a in jax.tree_util.tree_leaves_with_path(got):
        diff = np.abs(a - flat_w[path])
        name = jax.tree_util.keystr(path)
        assert diff.max() <= 2 * opt_kw["learning_rate"] + 1e-6, name
        assert (diff > 1e-4).mean() <= 1e-3, (name, (diff > 1e-4).sum())
        assert diff.mean() <= 1e-6, (name, diff.mean())
