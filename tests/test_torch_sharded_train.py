"""Parity of the port's sharded train step with the JAX package's, over
four gloo ranks.

One world of four ranks (``tests/torch_mesh_ranks.py``, each its own
interpreter that imports torch and the port only, joined through a
FileStore in ``tmp_path``) trains the 2-layer, d_model 64 LM of
``test_torch_train.py`` three steps on each mesh, every rank on its own
rows of one global batch of 8 x 17 tokens: ``dp=4``; ``fsdp=4`` with
``grad_accum=2``; ``dp=2 x fsdp=2`` with ``donate=False``; and
``adamw8bit`` with shard-aligned layouts under ``fsdp=4``.  The dp=4
and dp=2 x fsdp=2 steps are built without ``mesh=`` and take the
state's.  The parameters are sharded by
``infer_param_shardings(fsdp=True)``.  The
JAX package's step runs here on the same mesh shapes over four of the
host devices, from the same numpy weights and tokens.  The same world
also runs the eval step of a freshly sharded state, ``gather_params``,
``put_batch`` and ``device_prefetch(sharding=)``.

Tolerances are ``test_torch_train.py``'s: loss and grad_norm 1e-5
relative (f32 on both sides, summation order differs; the port sums the
ranks' gradients by collectives), parameters 1e-4 absolute after 3
steps at lr 1e-2, 1e-6 on average.  The batch's 8 rows are distinct, so
an element's gradient may cancel to f32 rounding level, where Adam's
normalised update turns the sign of that noise into +-lr: the
parameter check leaves out each element whose reference gradient at the
step is not 0 but below ``GRAD_FLOOR`` of its leaf's largest (f32's
1.2e-7 times the ~100 terms of such a sum), and fails if that leaves
out more than ``MAX_LEFT_OUT`` of a leaf (3 elements of 65,856 are left
out at the first step).  Both sides run flash attention: the JAX side
its Pallas kernels in interpret mode, the port the plain versions of
kernels 4-6.  8-bit moments: within 2.5 quantisation steps
of JAX's, as ``test_torch_optim8bit.py`` holds them.
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

from tensorflowonspark_tpu import optim as jax_optim
from tensorflowonspark_tpu import optim8bit as jax_8bit
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu.parallel import mesh as jax_mesh
from tensorflowonspark_tpu.parallel import sharding as jax_sharding
from tensorflowonspark_tpu.parallel import train as jax_train
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_mod

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 4
CFG = dict(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=128, max_seq_len=16, dtype="float32", rope=True,
           norm_type="rmsnorm", attention_impl="flash")
OPT = dict(adamw_fused=dict(learning_rate=1e-2, weight_decay=0.1,
                            clip_norm=0.5, mu_dtype="bfloat16"),
           adamw8bit=dict(learning_rate=1e-2, weight_decay=0.1,
                          clip_norm=0.5))
# label -> (mesh spec, grad_accum, optimizer), as tests/torch_mesh_ranks.py
CASES = {"dp4": (dict(dp=4), 1, "adamw_fused"),
         "fsdp4": (dict(dp=1, fsdp=4), 2, "adamw_fused"),
         "dp2fsdp2": (dict(dp=2, fsdp=2), 1, "adamw_fused"),
         "fsdp4_8bit": (dict(dp=1, fsdp=4), 1, "adamw8bit")}
STEPS = 3
GRAD_FLOOR = 1e-5       # of the leaf's largest |gradient|
MAX_LEFT_OUT = 1e-3     # of a leaf's elements


@pytest.fixture(scope="module")
def inputs():
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**CFG))
    params = jm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    # 8 distinct rows (the first 4 are test_torch_train.py's batch), so
    # that a step which averages over part of the batch ranks is seen
    tokens = np.random.RandomState(7).randint(0, 64, (8, 17))
    return jm, params, tokens


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    """Every rank's results, by rank.  The world runs once per session:
    under xdist the workers share it through a directory of the
    session's temp root, the first one to take its lock running it."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    d = root / "torch_mesh_world"
    d.mkdir(exist_ok=True)
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (d / "done").exists():
            _run_world(inputs, d)
            (d / "done").touch()
    out = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _run_world(inputs, d):
    _, params, tokens = inputs
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(dict(params=params, tokens=tokens, cfg=CFG, opt=OPT), f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    logs = [open(d / f"log{r}", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mesh_ranks.py"), str(r),
         str(WORLD), str(d)], stdout=logs[r], stderr=subprocess.STDOUT,
        env=env) for r in range(WORLD)]
    try:
        rcs = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    if any(rcs):
        tails = [open(d / f"log{r}").read()[-3000:] for r in range(WORLD)]
        pytest.fail(f"ranks exited {rcs}:\n" + "\n".join(tails))


_JAX = {}


def jax_case(inputs, label):
    """The JAX package's step for a case, on the same mesh shape over
    four host devices: ``(step, initial state, global batch)``."""
    if label in _JAX:
        return _JAX[label]
    jm, params, tokens = inputs
    spec, grad_accum, opt_name = CASES[label]
    mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(**spec),
                               devices=jax.devices()[:WORLD])
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    shardings = jax_sharding.infer_param_shardings(jparams, mesh, fsdp=True)
    layouts = None
    kw = {}
    if opt_name == "adamw8bit":
        layouts = jax_8bit.layouts_for_shardings(jparams, shardings)
        kw = dict(example_params=jparams, layouts=layouts)
    opt, _ = jax_optim.make_optimizer(
        opt_name, decay_mask=jax_optim.default_decay_mask, layouts=layouts,
        **OPT[opt_name])

    def loss(p, batch, rng):
        return jax_tf.lm_loss(jm.apply({"params": p}, batch[:, :-1]),
                              batch[:, 1:])

    state = jax_train.create_train_state(jparams, opt, mesh, shardings)
    step = jax_train.make_train_step(loss, opt, mesh, shardings,
                                     grad_accum=grad_accum, donate=False,
                                     **kw)
    batch = jax.device_put(jnp.asarray(tokens),
                           jax_mesh.batch_sharding(mesh))
    _JAX[label] = (step, state, batch, shardings, layouts)
    return _JAX[label]


def by_coords(world, label):
    return sorted((o[label] for o in world),
                  key=lambda o: (o["coords"]["dp"], o["coords"]["fsdp"]))


def joined(world, label, k, key):
    """A per-rank tree of the case's state after step ``k`` (``params``,
    ``mu``, ``nu``) joined into full tensors: the fsdp shards of the
    ranks at dp index 0, in fsdp order; every dp replica must hold the
    same shards."""
    mesh = mesh_mod.Mesh(mesh_mod.MeshSpec(**CASES[label][0]).resolve(WORLD))
    outs = by_coords(world, label)
    fsdp = mesh.shape["fsdp"]
    for i, o in enumerate(outs[fsdp:]):
        for n, a in o["states"][k][key].items():
            np.testing.assert_array_equal(a, outs[i % fsdp]["states"][k][
                key][n])
    full = {}
    for n in outs[0]["states"][k][key]:
        spec_, transposed = outs[0]["specs"][n]
        sh = mesh_mod.NamedSharding(mesh, spec_, transposed)
        full[n] = convert.join_shards(
            [torch.from_numpy(o["states"][k][key][n]) for o in outs[:fsdp]],
            sh)
    return convert.params_to_jax(full)


def joined_8bit(world, label, k, field):
    """The ranks' 8-bit payloads of one moment after step ``k``, their rows
    concatenated in fsdp order: ``{flax path: Quantized}`` (the JAX
    aligned payload)."""
    outs = by_coords(world, label)
    tree = {}
    for name in outs[0]["states"][k]["q8"][field]:
        path, _ = convert.flax_path(name, 2)
        node = tree
        for part in path.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[path.split("/")[-1]] = jax_8bit.Quantized(
            *(np.concatenate([o["states"][k]["q8"][field][name][i]
                              for o in outs]) for i in (0, 1)))
    return tree


def jax_state(world, label, k, template):
    """The port's state after step ``k`` (joined) as a JAX TrainState."""
    params = jax.tree_util.tree_map(jnp.asarray,
                                    joined(world, label, k, "params"))
    count = jnp.asarray(k, jnp.int32)
    if CASES[label][2] == "adamw_fused":
        mu = jax.tree_util.tree_map(
            lambda a, t: jnp.asarray(a, t.dtype),
            joined(world, label, k, "mu"), template.opt_state.mu)
        opt_state = template.opt_state._replace(
            count=count, mu=mu, nu=jax.tree_util.tree_map(
                jnp.asarray, joined(world, label, k, "nu")))
    else:
        q8 = jax_8bit.Adam8bitState(count,
                                    joined_8bit(world, label, k, "mu"),
                                    joined_8bit(world, label, k, "nu_sqrt"))
        opt_state = _replace_8bit(template.opt_state, q8)
    return template._replace(step=count, params=params, opt_state=opt_state)


def _replace_8bit(tree, q8):
    if isinstance(tree, jax_8bit.Adam8bitState):
        return q8
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_replace_8bit(t, q8) for t in tree))
    if isinstance(tree, tuple):
        return tuple(_replace_8bit(t, q8) for t in tree)
    return tree


def _find_8bit(tree):
    if isinstance(tree, jax_8bit.Adam8bitState):
        return tree
    if isinstance(tree, tuple):
        return next((f for f in map(_find_8bit, tree) if f is not None),
                    None)
    return None


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


_GRAD = []


def reference_grads(inputs, params):
    """The JAX model's gradient of the global batch's mean loss (the
    mean of the micro-batches' too) at ``params``, by dense attention:
    it only picks the elements at rounding level."""
    _, _, tokens = inputs
    if not _GRAD:
        jm = jax_tf.Transformer(jax_tf.TransformerConfig(
            **dict(CFG, attention_impl="dense")))
        _GRAD.append(jax.jit(jax.grad(lambda p, b: jax_tf.lm_loss(
            jm.apply({"params": p}, b[:, :-1]), b[:, 1:]))))
    # host copies: one compile, whatever mesh the state lies on
    return flat(_GRAD[0](jax.tree_util.tree_map(np.asarray, params),
                         tokens))


def close_params(got, want, grads):
    """Parameters against JAX's, but for the elements whose reference
    gradient is at rounding level (see the module doc)."""
    got, want = flat(got), flat(want)
    assert set(got) == set(want)
    for name, a in got.items():
        g = np.abs(grads[name])
        # an exact 0 (a token the batch lacks) is no rounding noise
        kept = (g == 0) | (g >= GRAD_FLOOR * g.max())
        assert (~kept).sum() <= MAX_LEFT_OUT * g.size, (name, (~kept).sum())
        diff = np.abs(a - want[name])[kept]
        assert diff.max() <= 1e-4 and diff.mean() <= 1e-6, (name, diff.max())


def check_case(world, inputs, label):
    """Losses and grad norms of the three steps against JAX's three steps
    from the same weights; then each step's parameters (and moments)
    against JAX's step from the port's state before it."""
    step, state0, batch, shardings, _ = jax_case(inputs, label)
    state, losses, norms = state0, [], []
    for _ in range(STEPS):
        state, m = step(state, batch, jax.random.key(0))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    for o in world:
        got = o[label]
        assert got["step"] == STEPS
        for key, want in (("losses", losses), ("grad_norms", norms)):
            assert got[key] == pytest.approx(want, rel=1e-5), key
    # every leaf's spec (flax order) is JAX's
    want_specs = {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
                  jax.tree_util.tree_leaves_with_path(shardings)}
    for name, (spec, transposed) in world[0][label]["specs"].items():
        path, _ = convert.flax_path(name, 2 if transposed else 1)
        key = "".join(f"['{k}']" for k in path.split("/"))
        assert spec == want_specs[key], name
    for k in range(1, STEPS + 1):
        prev = jax_state(world, label, k - 1, state0)
        want, _ = step(prev, batch, jax.random.key(0))
        close_params(joined(world, label, k, "params"), want.params,
                     reference_grads(inputs, prev.params))
        yield k, want


@pytest.mark.parametrize("label", ["dp4", "fsdp4", "dp2fsdp2"])
def test_sharded_steps_match_jax(world, inputs, label):
    for k, want in check_case(world, inputs, label):
        # the fused AdamW's moments, sharded like their parameters
        for key in ("mu", "nu"):
            got = flat(joined(world, label, k, key))
            ref = flat(getattr(want.opt_state, key))
            for name, a in got.items():
                w = ref[name]
                assert np.abs(a - w).max() <= 1e-2 * np.abs(w).max(), (
                    k, key, name)


def test_adamw8bit_layouts_under_fsdp_match_jax(world, inputs):
    _, _, _, _, layouts = jax_case(inputs, "fsdp4_8bit")
    jl = {jax.tree_util.keystr(p): lo for p, lo in
          jax.tree_util.tree_leaves_with_path(
              layouts, is_leaf=lambda x: x is None or isinstance(x, tuple))}
    for name, counts in world[0]["fsdp4_8bit"]["layouts"].items():
        path, _ = convert.flax_path(name, 2)
        assert counts == jl["".join(f"['{k}']" for k in path.split("/"))]
    for k, want in check_case(world, inputs, "fsdp4_8bit"):
        q8 = _find_8bit(want.opt_state)
        for field, signed, steps in (("mu", True, 127.0),
                                     ("nu_sqrt", False, 254.0)):
            got = joined_8bit(world, "fsdp4_8bit", k, field)
            ref = getattr(q8, field)
            for path, qt in jax.tree_util.tree_leaves_with_path(
                    got, is_leaf=lambda x: isinstance(x, jax_8bit.Quantized)):
                w = ref
                for p in path:
                    w = w[p.key]
                # the ranks' rows, in fsdp order, are JAX's aligned
                # payload: the same blocks, dequantised side by side
                assert qt.q.shape == np.asarray(w.q).shape, path
                off = 0.0 if signed else 127.0
                a = (qt.q.astype(np.float32) + off) * (qt.scale / steps)
                b = (np.asarray(w.q, np.float32) + off) * (
                    np.asarray(w.scale) / steps)
                assert np.abs(a - b).max() <= 2.5 * np.asarray(
                    w.scale).max() / steps, (k, field, path)


def test_declared_layout_that_misses_the_sharding_raises(world):
    for o in world:
        assert "does not match sharding" in o["fsdp4_8bit"]["wrong_layout"]


def test_metrics_hold_no_gradient_buffer(world):
    """The loss rides the gradients' all-reduce; what the step returns
    must not be a view that keeps that buffer alive."""
    for o in world:
        for label in CASES:
            assert o[label]["metric_bytes"] == {"loss": 4, "grad_norm": 4}


def test_donate_false_keeps_the_input_state(world):
    assert all(o["dp2fsdp2"]["input_state_kept"] for o in world)


def test_eval_step_and_gather_params(world, inputs):
    jm, params, tokens = inputs
    want = np.asarray(jm.apply({"params": jax.tree_util.tree_map(
        jnp.asarray, params)}, jnp.asarray(tokens[:, :-1])))
    # fsdp=4 and dp=1: rank r holds row block r
    got = np.concatenate([o["eval"]["logits"] for o in world])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    full = convert.params_from_jax(params)
    for o in world:
        for n, a in o["eval"]["gathered"].items():
            np.testing.assert_array_equal(a, full[n].numpy())


def test_put_batch_and_prefetch_give_each_rank_its_rows(world, inputs):
    tokens = inputs[2]
    by_index = sorted((o["batches"] for o in world), key=lambda b: b["index"])
    assert [b["index"] for b in by_index] == [0, 1, 2, 3]
    np.testing.assert_array_equal(
        np.concatenate([b["put"]["x"] for b in by_index]), tokens)
    np.testing.assert_array_equal(
        np.concatenate([b["put"]["y"] for b in by_index]), tokens[:, 0])
    for b in by_index:
        x = b["put"]["x"]
        np.testing.assert_array_equal(b["prefetched"][0], x)
        np.testing.assert_array_equal(b["prefetched"][1], x + 1)
        assert "same local batch shapes" in b["ragged_error"]
        assert "[(1, 17)], [(2, 17)]" in b["ragged_error"]
        assert "keeps the first batch's local shapes [(2, 17)]; got " \
            "[(1, 17)]" in b["ragged_tail_error"]
