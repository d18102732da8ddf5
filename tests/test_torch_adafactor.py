"""Parity of the port's Adafactor with ``optax.adafactor``.

``make_optimizer("adafactor")`` on both sides (the JAX factory builds
``optax.adafactor(schedule)`` at its defaults), three update steps on a
tree that holds each case of the factored second moment:

- a 256 x 192 kernel, factored (both axes >= 128);
- a 3-D leaf whose two largest axes (130 and 200) are factored and whose
  first axis is kept;
- a 64 x 300 leaf, not factored (its smaller axis is under 128);
- a 1-D leaf and a scalar, which keep a full ``v``.

Also the factory with ``clip_norm`` (a global-norm clip chained in
front), the step's own decay ``1 - (count + 1)^-0.8`` on the count
before its increment, and two train steps of the tiny transformer
through ``make_train_step`` against the JAX train step.

Tolerances: updates and parameters 1e-5 relative (f32 on both sides;
the means, ``t^-0.8`` and ``x^-0.5`` round differently in XLA and in
PyTorch).  The train steps as ``test_torch_train.py`` holds AdamW's:
loss and grad_norm 1e-5 relative; the parameters within 1e-4 after 2
steps at lr 1e-2 and 1e-6 on average (the update divides the gradient by
its own rms estimate, and the unfactored leaves' first step is
``g / |g|``, so an element whose gradient is near 0, where the two
models' summation orders differ most in relative terms, can move its
update by much more than 1e-5).
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
from tensorflowonspark_tpu_torch.parallel import train as port_train

SHAPES = {"factored": (256, 192), "three_d": (3, 130, 200),
          "narrow": (64, 300), "vector": (50,), "scalar": ()}


def _tree(rng, scale=1.0):
    return {n: np.asarray(scale * rng.randn(*s), np.float32)
            for n, s in SHAPES.items()}


def _run(kw, steps=3):
    rng = np.random.RandomState(0)
    params = _tree(rng)
    grads = [_tree(rng, 2.0) for _ in range(steps)]
    jopt, _ = jax_optim.make_optimizer("adafactor", **kw)
    popt, _ = port_optim.make_optimizer("adafactor", **kw)
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
            assert pupd[n].shape == jupd[n].shape, n
            np.testing.assert_allclose(pupd[n].numpy(), np.asarray(jupd[n]),
                                       rtol=1e-5, atol=1e-9, err_msg=n)
        jp = optax.apply_updates(jp, jupd)
        port_optim.apply_updates(pp, pupd)
    for n in params:
        np.testing.assert_allclose(pp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-5, atol=1e-7, err_msg=n)
    return js, ps


@pytest.mark.parametrize("kw", [
    dict(learning_rate=0.05),
    dict(learning_rate=0.05, clip_norm=1.0, schedule="cosine",
         warmup_steps=1, total_steps=6)], ids=["plain", "clip-schedule"])
def test_adafactor_matches_optax_over_three_steps(kw):
    js, ps = _run(kw)
    factored = ps[-1][0] if "clip_norm" in kw else ps[0]
    jfac = js[-1][0] if "clip_norm" in kw else js[0]
    assert int(factored.count) == int(jfac.count) == 3
    # the factored leaves keep a row and a column estimate, the others v
    assert set(factored.v_row) == {"factored", "three_d"}
    assert set(factored.v) == {"narrow", "vector", "scalar"}
    assert factored.v_row["three_d"].shape == (3, 130)
    assert factored.v_col["three_d"].shape == (3, 200)
    assert factored.v_row["factored"].shape == (192,)
    assert factored.v_col["factored"].shape == (256,)
    for n in factored.v_row:
        np.testing.assert_allclose(factored.v_row[n].numpy(),
                                   np.asarray(jfac.v_row[n]), rtol=1e-5)
        np.testing.assert_allclose(factored.v_col[n].numpy(),
                                   np.asarray(jfac.v_col[n]), rtol=1e-5)
    for n in factored.v:
        np.testing.assert_allclose(factored.v[n].numpy(),
                                   np.asarray(jfac.v[n]), rtol=1e-5)


def test_adafactor_refuses_decay_and_mu_dtype():
    for kw in (dict(weight_decay=0.1), dict(mu_dtype="bfloat16"),
               dict(decay_mask=port_optim.default_decay_mask)):
        with pytest.raises(ValueError):
            port_optim.make_optimizer("adafactor", **kw)


def test_adafactor_train_steps_match_jax():
    cfg = dict(vocab_size=64, d_model=128, n_heads=4, n_kv_heads=2,
               n_layers=2, d_ff=256, max_seq_len=16, dtype="float32",
               rope=True, norm_type="rmsnorm", attention_impl="flash")
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**cfg))
    tokens = np.random.RandomState(7).randint(0, 64, (4, 17))
    params = jm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])

    def jax_loss(p, batch, rng):
        return jax_tf.lm_loss(jm.apply({"params": p}, batch[:, :-1]),
                              batch[:, 1:])

    jopt, _ = jax_optim.make_optimizer("adafactor", learning_rate=1e-2)
    jstate = jax_train.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), jopt)
    jstep = jax_train.make_train_step(jax_loss, jopt)
    pm = port_tf.build_transformer(**cfg)
    pm.load_state_dict(convert.params_from_jax(params), strict=True)
    popt, _ = port_optim.make_optimizer("adafactor", learning_rate=1e-2)
    pstate = port_train.create_train_state(pm, popt)
    pstep = port_train.make_train_step(
        lambda m, b, r: port_tf.lm_loss(m(b[:, :-1]), b[:, 1:]), popt)
    # d_model 128: the attention and MLP kernels are factored
    assert pstate.opt_state[0].v_row
    jbatch, pbatch = jnp.asarray(tokens), torch.from_numpy(tokens)
    for _ in range(2):
        jstate, jm_ = jstep(jstate, jbatch, jax.random.key(0))
        pstate, pm_ = pstep(pstate, pbatch, None)
        for key in ("loss", "grad_norm"):
            assert pm_[key].item() == pytest.approx(float(jm_[key]),
                                                    rel=1e-5), key
    want = jax.tree_util.tree_map(np.asarray, jstate.params)
    got = convert.params_to_jax(pstate.params.state_dict())
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, a in jax.tree_util.tree_leaves_with_path(got):
        diff = np.abs(a - flat_w[path])
        name = jax.tree_util.keystr(path)
        assert diff.max() <= 1e-4 and diff.mean() <= 1e-6, (name, diff.max())
