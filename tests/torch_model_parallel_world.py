"""The shared world and JAX references of the split-forward parity tests
(``test_torch_tensor_parallel.py``, ``test_torch_context_parallel.py``,
``test_torch_pipeline_parallel.py``).

One world of four gloo ranks (``tests/torch_model_parallel_ranks.py``,
each its own interpreter that imports torch and the port only, joined
through a FileStore) runs every case once per session: under xdist the
workers share it through a lock in the session's temp root, the first
one to take it running the world.  The JAX side runs here, on host
devices, from the same numpy weights and tokens: the sequential
``Transformer`` (dense attention, the plain reference of the flash
kernels) for the whole model's logits and gradients, ``ring_attention``
/ ``ulysses_attention`` / ``pipeline_apply`` on JAX meshes of the same
shape for the functions.
"""
import fcntl
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_mod

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 4
BASE = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=4,
            d_ff=64, max_seq_len=16, dtype="float32", use_bias=True,
            attention_impl="flash")
CFGS = {"abs": BASE, "rope": dict(BASE, rope=True),
        "short": dict(BASE, rope=True, n_layers=2)}
OPT = dict(sgd=dict(learning_rate=1.0),
           adamw_fused=dict(learning_rate=1e-2, weight_decay=0.1,
                            clip_norm=0.5, mu_dtype="bfloat16"),
           adamw8bit=dict(learning_rate=1e-2, weight_decay=0.1,
                          clip_norm=0.5))
# the JAX tests' tolerances: the model in f32, pipeline_apply, the
# attention functions' outputs and their gradients (ring: JAX's 2e-4)
MODEL_TOL = 3e-5
PIPE_TOL = 1e-5
ATTN_TOL = 2e-5
RING_GRAD_TOL = 2e-4
# label -> (mesh spec, config, overrides, kind, optimizer): as the rank
# script's CASES
sys.path.insert(0, HERE)
from torch_model_parallel_ranks import CASES  # noqa: E402

_STATE = {}


def inputs():
    """The flax parameter trees (seed 1) of both configs, the tokens, the
    attention and pipeline inputs (numpy, seeded)."""
    if "inputs" in _STATE:
        return _STATE["inputs"]
    params = {}
    for name, cfg in CFGS.items():
        jm = jax_tf.Transformer(jax_tf.TransformerConfig(**cfg))
        p = jm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))
        params[name] = jax.tree_util.tree_map(np.asarray, p["params"])
    rng = np.random.RandomState(3)
    attn = {k: rng.randn(*shape).astype(np.float32) for k, shape in (
        ("q", (2, 32, 4, 16)), ("k", (2, 32, 2, 16)), ("v", (2, 32, 2, 16)),
        ("do", (2, 32, 4, 16)))}
    prng = np.random.RandomState(0)
    stacked = {"w1": np.stack([prng.randn(16, 32).astype(np.float32) * 0.1
                               for _ in range(4)])}
    stacked["w2"] = np.stack([prng.randn(32, 16).astype(np.float32) * 0.1
                              for _ in range(4)])
    pipe = {"stacked": stacked,
            "x": prng.randn(8, 4, 16).astype(np.float32)}
    _STATE["inputs"] = dict(
        params=params, cfgs=CFGS, opt=OPT, attn=attn, pipe=pipe,
        tokens=np.random.RandomState(7).randint(0, 64, (8, 17)))
    return _STATE["inputs"]


def world(tmp_path_factory):
    """Every rank's results, by rank."""
    if "world" in _STATE:
        return _STATE["world"]
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    d = root / "torch_model_parallel_world"
    d.mkdir(exist_ok=True)
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (d / "done").exists():
            _run_world(d)
            (d / "done").touch()
    out = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    _STATE["world"] = out
    return out


def _run_world(d):
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inputs(), f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    logs = [open(d / f"log{r}", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_model_parallel_ranks.py"),
         str(r), str(WORLD), str(d)], stdout=logs[r],
        stderr=subprocess.STDOUT, env=env) for r in range(WORLD)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    if any(rcs):
        tails = [open(d / f"log{r}").read()[-3000:] for r in range(WORLD)]
        pytest.fail(f"ranks exited {rcs}:\n" + "\n".join(tails))


def case_mesh(label):
    return mesh_mod.Mesh(mesh_mod.MeshSpec(**CASES[label][0]).resolve(WORLD))


def joined(world, label, key):
    """A case's per-rank tree ``key`` (``params``, ``grads``, ``before``,
    ``mu``, ``nu``) joined into full tensors ``{name: numpy}``: the
    shards of the split axes joined in their order, every replica held
    equal to the first."""
    mesh = case_mesh(label)
    outs = [o[label] for o in world]
    full = {}
    names = {n for o in outs for n in o[key]}
    for name in sorted(names):
        holders = [o for o in outs if name in o[key]]
        spec, transposed = holders[0]["specs"][name]
        sh = mesh_mod.NamedSharding(mesh, spec, transposed)
        axes = [a for a in mesh_mod.ALL_AXES
                if a in sh.split_axes(holders[0][key][name].ndim)]
        pieces = {}
        for o in holders:
            idx = tuple(o["coords"][a] for a in axes)
            a = o[key][name]
            if idx in pieces:
                np.testing.assert_array_equal(a, pieces[idx], err_msg=name)
            else:
                pieces[idx] = a
        shards = [torch.from_numpy(pieces[i]) for i in sorted(pieces)]
        full[name] = convert.join_shards(shards, sh).numpy()
    return full


def joined_logits(world, label):
    """The case's logits ``[B, S, vocab]`` from the ranks' blocks (rows by
    batch index; the sequence by tp index under context parallelism)."""
    mesh = case_mesh(label)
    cp = CASES[label][3] == "cp"
    blocks = {}
    for o in world:
        c = o[label]["coords"]
        b = c["dp"] * mesh.shape["fsdp"] + c["fsdp"]
        s = c["tp"] if cp else 0
        a = o[label]["logits"]
        if (b, s) in blocks:
            np.testing.assert_allclose(a, blocks[b, s], rtol=1e-6, atol=1e-6)
        blocks[b, s] = a
    nb = 1 + max(b for b, _ in blocks)
    ns = 1 + max(s for _, s in blocks)
    return np.concatenate([np.concatenate([blocks[b, s] for s in range(ns)],
                                          axis=1) for b in range(nb)])


def jax_reference(name):
    """The JAX sequential model's ``(logits, loss, {port name: gradient},
    grad_norm)`` on the global batch, dense attention."""
    key = ("ref", name)
    if key in _STATE:
        return _STATE[key]
    inp = inputs()
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(
        **dict(CFGS[name], attention_impl="dense")))
    tokens = jnp.asarray(inp["tokens"])
    params = jax.tree_util.tree_map(jnp.asarray, inp["params"][name])

    def loss_fn(p):
        logits = jm.apply({"params": p}, tokens[:, :-1])
        return jax_tf.lm_loss(logits, tokens[:, 1:]), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    grads = jax.tree_util.tree_map(np.asarray, grads)
    norm = float(np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                             for g in jax.tree_util.tree_leaves(grads))))
    port = {n: t.numpy() for n, t in convert.params_from_jax(grads).items()}
    _STATE[key] = (np.asarray(logits), float(loss), port, norm)
    return _STATE[key]


def check_model_case(world, label):
    """A split case's logits, loss, whole gradient (the lr-1 SGD step's
    parameter change) and grad_norm against the JAX sequential model."""
    name = CASES[label][1]
    logits, loss, grads, norm = jax_reference(name)
    np.testing.assert_allclose(joined_logits(world, label), logits,
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    for o in world:
        got = o[label]
        assert got["loss"] == pytest.approx(loss, rel=MODEL_TOL), label
        assert got["grad_norm"] == pytest.approx(norm, rel=MODEL_TOL), label
    got = joined(world, label, "grads")
    assert set(got) == set(grads)
    for n, g in got.items():
        np.testing.assert_allclose(g, grads[n], rtol=MODEL_TOL,
                                   atol=MODEL_TOL, err_msg=n)
