"""The port's ``utils.checkpoint`` against the JAX package's.

A tiny f32 LM (2 layers, d_model 64, 4 heads, 2 kv heads) is initialised
by the JAX package from a seed and carried to the port by
``convert.params_from_jax``; batches come from ``np.random.RandomState``.

- a ``TrainState`` (parameters, optimizer state, step) of ``adamw``,
  ``adamw_fused`` and ``adamw8bit`` saves and restores into a fresh
  state bit for bit;
- 2 steps, a save, a restore into a fresh state and 2 more steps give the
  4 straight steps' losses and parameters bit for bit on the CPU, and the
  JAX package's 4 steps' losses within 1e-5 (relative; f32 on both
  sides, sums in other orders);
- ``keep`` leaves the JAX package's step directories on the same save
  sequence (orbax there, ``torch.save`` here), saved synchronously and
  asynchronously (each save waited for before the next);
- a save that raises midway leaves no ``step_N``, and ``latest_step``
  ignores a half-written temporary directory;
- ``is_chief=False`` writes nothing; ``asynchronous=True`` then
  ``wait_for_saves`` restores the state as it was when the save returned,
  and a failed asynchronous write raises from ``wait_for_saves``;
- a missing, an extra or a reshaped tensor raises before anything is
  copied; no checkpoint gives ``(None, None)``;
- in a subprocess, SIGTERM runs the preemption handler's save and the
  process exits 143, as under the JAX package's handler.
"""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import optim as jax_optim
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu.parallel import train as jax_train
from tensorflowonspark_tpu.utils import checkpoint as jax_ckpt
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch import optim as port_optim
from tensorflowonspark_tpu_torch.models import transformer as port_tf
from tensorflowonspark_tpu_torch.parallel import train as port_train
from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = dict(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
          d_ff=128, max_seq_len=16, dtype="float32", rope=True,
          norm_type="rmsnorm", attention_impl="dense")
OPT = dict(learning_rate=1e-2, weight_decay=0.1, clip_norm=0.5)
TOKENS = np.random.RandomState(7).randint(0, 64, (16, 17))


@pytest.fixture(scope="module")
def jax_lm():
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**LM))
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.key(1), jnp.zeros((1, 8), jnp.int32))["params"])
    return jm, params


def _lm_loss(model, batch, rng):
    return port_tf.lm_loss(model(batch[:, :-1]), batch[:, 1:])


def _port(params, name="adamw_fused", seed=None):
    model = port_tf.build_transformer(**LM)
    if seed is None:
        model.load_state_dict(convert.params_from_jax(params), strict=True)
    else:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    kw = dict(OPT, decay_mask=port_optim.default_decay_mask)
    if name == "adamw_fused":
        kw["mu_dtype"] = "bfloat16"
    opt, _ = port_optim.make_optimizer(name, **kw)
    return (port_train.make_train_step(_lm_loss, opt),
            port_train.create_train_state(model, opt))


def _batch(i):
    return torch.from_numpy(TOKENS[4 * i:4 * i + 4]).long()


def _assert_equal_states(got, want):
    a, b = ckpt.state_tensors(got), ckpt.state_tensors(want)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", ["adamw", "adamw_fused", "adamw8bit"])
def test_train_state_round_trip_is_bitwise(name, jax_lm, tmp_path):
    step, state = _port(jax_lm[1], name)
    state, _ = step(state, _batch(0), None)
    n = len(ckpt.state_tensors(state))
    assert n > 2 * len(list(state.params.parameters()))   # moments saved
    path = ckpt.save_checkpoint(tmp_path, state, 1)
    assert path == str(tmp_path / "step_1")
    assert os.listdir(path) == [ckpt.STATE_FILE]
    _, fresh = _port(jax_lm[1], name, seed=3)
    restored, at = ckpt.restore_checkpoint(tmp_path, fresh)
    assert at == 1 and restored is fresh
    _assert_equal_states(restored, state)
    assert int(restored.step) == 1


def test_resumed_steps_equal_straight_steps_and_jax(jax_lm, tmp_path):
    jm, params = jax_lm
    step, state = _port(params)
    straight = []
    for i in range(4):
        state, m = step(state, _batch(i), None)
        straight.append(m["loss"].item())

    step, state = _port(params)
    resumed = []
    for i in range(2):
        state, m = step(state, _batch(i), None)
        resumed.append(m["loss"].item())
    ckpt.save_checkpoint(tmp_path, state, 2)
    del state
    step, fresh = _port(params, seed=5)
    fresh, at = ckpt.restore_checkpoint(tmp_path, fresh)
    assert at == 2
    for i in range(2, 4):
        fresh, m = step(fresh, _batch(i), None)
        resumed.append(m["loss"].item())
    assert resumed == straight

    def jax_loss(p, batch, rng):
        return jax_tf.lm_loss(jm.apply({"params": p}, batch[:, :-1]),
                              batch[:, 1:])

    jopt, _ = jax_optim.make_optimizer(
        "adamw_fused", decay_mask=jax_optim.default_decay_mask,
        mu_dtype="bfloat16", **OPT)
    jstate = jax_train.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), jopt)
    jstep = jax_train.make_train_step(jax_loss, jopt)
    for i in range(4):
        jstate, jm_ = jstep(jstate, jnp.asarray(TOKENS[4 * i:4 * i + 4]),
                            jax.random.key(0))
        assert resumed[i] == pytest.approx(float(jm_["loss"]), rel=1e-5), i


def _save_sequence(mod, root, tree, keep, asynchronous):
    os.makedirs(root)       # the JAX package's async pruning lists it
    for s in (1, 2, 3, 5, 8, 13):
        mod.save_checkpoint(root, tree, s, keep=keep,
                            asynchronous=asynchronous)
        # the JAX package prunes only committed steps and does not wait
        # for the save in flight: each one lands before the next here,
        # so its result does not hang on timing
        mod.wait_for_saves()
    return sorted(d for d in os.listdir(root) if d.startswith("step_"))


@pytest.mark.parametrize("asynchronous", [False, True])
@pytest.mark.parametrize("keep", [None, 1, 3])
def test_keep_leaves_the_jax_step_directories(keep, asynchronous, tmp_path):
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.zeros(3, np.float32)}
    want = _save_sequence(jax_ckpt, str(tmp_path / "jax"),
                          jax.tree_util.tree_map(jnp.asarray, tree), keep,
                          asynchronous)
    got = _save_sequence(ckpt, str(tmp_path / "port"),
                         {k: torch.from_numpy(v) for k, v in tree.items()},
                         keep, asynchronous)
    assert got == want
    assert ckpt.latest_step(tmp_path / "port") == jax_ckpt.latest_step(
        str(tmp_path / "jax")) == 13


def test_a_failed_save_leaves_no_step(tmp_path, monkeypatch):
    tree = {"w": torch.ones(4)}
    ckpt.save_checkpoint(tmp_path, tree, 1)
    real_save = torch.save

    def broken(obj, f, *a, **kw):
        f.write(b"half a checkpoint")
        raise OSError("disk went away")

    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError, match="disk went away"):
        ckpt.save_checkpoint(tmp_path, tree, 2)
    assert sorted(os.listdir(tmp_path)) == ["step_1"]
    assert ckpt.latest_step(tmp_path) == 1
    # a killed writer leaves its temporary directory: never a step
    monkeypatch.setattr(torch, "save", real_save)
    os.makedirs(tmp_path / "step_3.tmp-1-deadbeef")
    (tmp_path / "step_3.tmp-1-deadbeef" / ckpt.STATE_FILE).write_bytes(b"x")
    assert ckpt.latest_step(tmp_path) == 1
    restored, at = ckpt.restore_checkpoint(tmp_path, {"w": torch.zeros(4)})
    assert at == 1 and torch.equal(restored["w"], torch.ones(4))
    # an asynchronous write that fails raises from wait_for_saves
    monkeypatch.setattr(torch, "save", broken)
    ckpt.save_checkpoint(tmp_path, tree, 4, asynchronous=True)
    with pytest.raises(OSError, match="disk went away"):
        ckpt.wait_for_saves()
    assert ckpt.latest_step(tmp_path) == 1


def test_non_chief_and_asynchronous_saves(jax_lm, tmp_path):
    step, state = _port(jax_lm[1])
    assert ckpt.save_checkpoint(tmp_path / "x", state, 1,
                                is_chief=False) is None
    assert not (tmp_path / "x").exists()
    state, _ = step(state, _batch(0), None)
    snapshot = {k: v.detach().clone() for k, v in ckpt.state_tensors(state).items()}
    ckpt.save_checkpoint(tmp_path, state, 1, asynchronous=True)
    state, _ = step(state, _batch(1), None)     # moves the live state
    ckpt.wait_for_saves()
    ckpt.wait_for_saves()                       # nothing pending: returns
    _, fresh = _port(jax_lm[1], seed=9)
    fresh, at = ckpt.restore_checkpoint(tmp_path, fresh)
    assert at == 1
    got = ckpt.state_tensors(fresh)
    for k, v in snapshot.items():
        assert torch.equal(got[k], v), k


def test_mismatches_raise_before_copying(tmp_path):
    ckpt.save_checkpoint(tmp_path, {"a": torch.ones(2, 3),
                                    "b": {"c": torch.ones(4)}}, 7)
    for target in ({"a": torch.zeros(2, 3)},
                   {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4)},
                    "d": torch.zeros(1)},
                   {"a": torch.zeros(3, 2), "b": {"c": torch.zeros(4)}}):
        with pytest.raises(ValueError, match="missing|shape"):
            ckpt.restore_checkpoint(tmp_path, target)
        assert all(not t.any() for t in ckpt.state_tensors(target).values())
    # dtype and device follow the target
    target = {"a": torch.zeros(2, 3, dtype=torch.bfloat16),
              "b": {"c": torch.zeros(4, dtype=torch.float64)}}
    restored, _ = ckpt.restore_checkpoint(tmp_path, target, step=7)
    assert restored["a"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], torch.ones(4, dtype=torch.float64))
    assert ckpt.restore_checkpoint(tmp_path / "none", target) == (None, None)


_PREEMPTED = r"""
import sys, time
import torch
from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt
d = sys.argv[1]
state = {"w": torch.arange(5.0), "step": torch.tensor(0)}
handler = ckpt.install_preemption_handler(
    lambda: ckpt.save_checkpoint(d, state, int(state["step"]) + 100))
for i in range(1, 10 ** 6):
    with handler.guard():
        state["w"] += 1
        state["step"] += 1
    if i == 3:
        print("ready", flush=True)
    time.sleep(0.01)
"""


def test_sigterm_writes_the_preemption_checkpoint(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen([sys.executable, "-c", _PREEMPTED,
                             str(tmp_path)], stdout=subprocess.PIPE,
                            env=env, text=True)
    try:
        assert proc.stdout.readline().strip() == "ready"
        time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 128 + signal.SIGTERM == 143
    finally:
        if proc.poll() is None:
            proc.kill()
    step = ckpt.latest_step(tmp_path)
    assert step is not None and step > 103
    restored, _ = ckpt.restore_checkpoint(
        tmp_path, {"w": torch.zeros(5), "step": torch.tensor(0)})
    assert int(restored["step"]) + 100 == step
    assert torch.equal(restored["w"], torch.arange(5.0) + (step - 100))
