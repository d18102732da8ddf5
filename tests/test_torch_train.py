"""Parity of the port's train step with the JAX package's.

A 2-layer, d_model 64 LM with ``attention_impl="flash"`` (the JAX side
runs its Pallas flash kernels in interpret mode; the port the plain
versions of kernels 4-6) is trained three steps by ``make_train_step``
with ``adamw_fused`` (clipping engaged, decay mask, bf16 mu) on both
sides, from the same numpy-seeded weights and tokens: with grad_accum 1
and 2, and with remat.  Loss and grad_norm are compared at every step,
the parameters after the last.  Also ``lm_loss`` alone, the eval step,
``feed_consensus`` and the flagship step's construction on the CPU.

Tolerances: loss and grad_norm 1e-5 relative (f32 on both sides,
summation order differs); parameters 1e-4 absolute after 3 steps at lr
1e-2 (each step moves an element by at most ~lr; an element whose bf16
mu rounds to the neighbouring value or whose gradient is near 0 may turn
its update) and 1e-6 on average.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import optim as jax_optim
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu.parallel import train as jax_train
from tensorflowonspark_tpu_torch import benchmarks, convert
from tensorflowonspark_tpu_torch import optim as port_optim
from tensorflowonspark_tpu_torch.models import transformer as port_tf
from tensorflowonspark_tpu_torch.parallel import train as port_train

CFG = dict(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=128, max_seq_len=16, dtype="float32", rope=True,
           norm_type="rmsnorm", attention_impl="flash")
OPT = dict(learning_rate=1e-2, weight_decay=0.1, clip_norm=0.5,
           mu_dtype="bfloat16")


@pytest.mark.parametrize("grad_accum,remat", [(1, False), (2, False),
                                              (2, True)],
                         ids=["ga1", "ga2", "ga2-remat"])
def test_train_steps_match_jax(grad_accum, remat):
    cfg = dict(CFG, remat=remat)
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**cfg))
    tokens = np.random.RandomState(7).randint(0, 64, (4, 17))
    params = jm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])

    def jax_loss(p, batch, rng):
        return jax_tf.lm_loss(jm.apply({"params": p}, batch[:, :-1]),
                              batch[:, 1:])

    jopt, _ = jax_optim.make_optimizer(
        "adamw_fused", decay_mask=jax_optim.default_decay_mask, **OPT)
    jstate = jax_train.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), jopt)
    jstep = jax_train.make_train_step(jax_loss, jopt, grad_accum=grad_accum)

    pm = port_tf.build_transformer(**cfg)
    pm.load_state_dict(convert.params_from_jax(params), strict=True)

    def port_loss(model, batch, rng):
        return port_tf.lm_loss(model(batch[:, :-1]), batch[:, 1:])

    popt, _ = port_optim.make_optimizer(
        "adamw_fused", decay_mask=port_optim.default_decay_mask, **OPT)
    pstate = port_train.create_train_state(pm, popt)
    pstep = port_train.make_train_step(port_loss, popt,
                                       grad_accum=grad_accum)
    jbatch, pbatch = jnp.asarray(tokens), torch.from_numpy(tokens)
    for _ in range(3):
        jstate, jm_ = jstep(jstate, jbatch, jax.random.key(0))
        pstate, pm_ = pstep(pstate, pbatch, None)
        for key in ("loss", "grad_norm"):
            assert pm_[key].item() == pytest.approx(float(jm_[key]),
                                                    rel=1e-5), key
    assert int(pstate.step) == int(jstate.step) == 3
    assert int(pstate.opt_state.count) == 3
    want = jax.tree_util.tree_map(np.asarray, jstate.params)
    got = convert.params_to_jax(pstate.params.state_dict())
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, a in jax.tree_util.tree_leaves_with_path(got):
        diff = np.abs(a - flat_w[path])
        name = jax.tree_util.keystr(path)
        assert diff.max() <= 1e-4 and diff.mean() <= 1e-6, (name, diff.max())


def test_lm_loss_matches_jax():
    rng = np.random.RandomState(2)
    logits = rng.randn(3, 5, 11).astype(np.float32)
    targets = rng.randint(0, 11, (3, 5))
    targets[0, :2] = -1                     # ignored positions
    want = jax_tf.lm_loss(jnp.asarray(logits), jnp.asarray(targets))
    got = port_tf.lm_loss(torch.from_numpy(logits),
                          torch.from_numpy(targets))
    assert got.item() == pytest.approx(float(want), rel=1e-6)


def test_compute_dtype_and_plain_optimizer_step():
    model = port_tf.build_transformer(**CFG)
    tokens = torch.from_numpy(np.random.RandomState(3).randint(0, 64,
                                                               (2, 17)))
    opt, _ = port_optim.make_optimizer("adamw", learning_rate=1e-2)
    state = port_train.create_train_state(model, opt)
    step = port_train.make_train_step(
        lambda m, b, r: port_tf.lm_loss(m(b[:, :-1]), b[:, 1:]), opt,
        compute_dtype="bfloat16")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = step(state, tokens, None)
    assert torch.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32     # the masters stay f32
        assert not torch.equal(p, before[n]), n


def test_eval_step_and_feed_consensus():
    model = port_tf.build_transformer(**CFG)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    out = port_train.make_eval_step(lambda m, b: m(b))(model, tokens)
    assert out.shape == (1, 4, 64) and not out.requires_grad
    assert port_train.feed_consensus(True) is True
    assert port_train.feed_consensus(0) is False


def test_flagship_step_builds_on_the_cpu():
    cfg = dict(benchmarks.FLAGSHIP_LM_V2, vocab_size=64, d_model=64,
               n_heads=4, n_kv_heads=2, n_layers=2, d_ff=128, max_seq_len=16)
    step, state, tokens, n_params = benchmarks.make_flagship_step(
        2, None, cfg, device="cpu")
    assert tokens.shape == (2, 17) and tokens.dtype == torch.int64
    assert n_params == sum(p.numel() for p in state.params.parameters())
    assert all(p.dtype == torch.float32 for p in state.params.parameters())
    assert state.opt_state.mu["lm_head.weight"].dtype == torch.bfloat16
    losses = []
    for _ in range(3):
        state, m = step(state, tokens, None)
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0]
