"""The port's cluster runtime across real processes, beside the JAX
package's: ``cluster.run`` over ``LocalBackend``, fed through the shm
ring and ``DataFeed``.

- (a) the numpy-only ``smoke_train_fn`` of ``test_cluster_smoke.py``
  through both packages' clusters over the same partitions: equal
  ``smoke.json`` (rows, batches, ``ring_attached``, ``w`` bit for bit);
- (b) the sum-of-squares inference round trip through both: equal
  outputs in the same order;
- (c) a tiny LM trained 4 steps by a cluster-fed node on ``device="cpu"``:
  its losses equal the port's direct loop over the same batches bit for
  bit, and lie within ``test_torch_train.py``'s stated 1e-5 relative of
  the JAX ``make_train_step`` loop from the same weights (carried over by
  ``convert.params_from_jax``).  The JAX loop runs in the pytest process,
  never in a forked child (see ``test_cluster_smoke.py``);
- (d) two executors over gloo with uneven partitions: ``feed_consensus``
  stops both on the same step;
- (e) a closure under ``start_method="spawn"`` is refused in the driver
  before any process starts;
- (f) a map_fun that raises aborts ``train`` with its traceback text, as
  the JAX cluster reports it;
- (g) a duplicate bootstrap on one executor dir is refused;
- (h) ``run_elastic`` relaunches after a failed attempt and resumes the
  feed from the PROGRESS high-water marks (which cross the reservation
  socket's JSON frames): no record lost, duplicates within the progress
  window, as ``test_elastic.py`` holds the JAX package.

Every multi-process test forks (spawn would re-import torch and this
module in each executor): the executors and node processes inherit the
pytest process, which has not initialised CUDA.  A map_fun that runs
torch ops in such a forked child first calls ``torch.set_num_threads(1)``
— the parent's intra-op thread pool does not survive the fork.  Every
wait is bounded: feed timeouts, ``shutdown(timeout=)``, probes of at
most 30 s.
"""
import json
import multiprocessing as mp
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_cluster_smoke as jax_smoke
from tensorflowonspark_tpu import backend as jax_backend
from tensorflowonspark_tpu import cluster as jax_cluster
from tensorflowonspark_tpu import optim as jax_optim
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu.parallel import train as jax_train
from tensorflowonspark_tpu_torch import (backend, cluster, convert, node,
                                         parallel_runner, reservation)
from tensorflowonspark_tpu_torch import optim as port_optim
from tensorflowonspark_tpu_torch.models import transformer as port_tf
from tensorflowonspark_tpu_torch.parallel import train as port_train

SPARK = cluster.InputMode.SPARK
LM = dict(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
          d_ff=128, max_seq_len=16, dtype="float32", rope=True,
          norm_type="rmsnorm", attention_impl="dense")
OPT = dict(learning_rate=1e-2, weight_decay=0.1, clip_norm=0.5,
           mu_dtype="bfloat16")


def _smoke_parts():
    rng = np.random.RandomState(0)
    X = rng.normal(size=(256, 2)).astype(np.float32)
    y = (X @ [2.0, -3.0] + 0.1 * rng.normal(size=256)).astype(np.float32)
    return [[(float(a), float(b), float(t))
             for (a, b), t in zip(X[i::2], y[i::2])] for i in range(2)]


def _run_smoke(backend_mod, cluster_mod, root):
    c = cluster_mod.run(backend_mod.LocalBackend(1, workdir=str(root)),
                        jax_smoke.smoke_train_fn, tf_args={},
                        num_executors=1, input_mode=cluster_mod.InputMode.SPARK)
    c.train(_smoke_parts(), feed_timeout=30)
    c.shutdown(grace_secs=0, timeout=60)
    with open(os.path.join(str(root), "executor-0", "smoke.json")) as f:
        return json.load(f)


def test_smoke_train_matches_jax_cluster(tmp_path):
    want = _run_smoke(jax_backend, jax_cluster, tmp_path / "jax")
    got = _run_smoke(backend, cluster, tmp_path / "port")
    assert got == want
    assert got["rows"] == 256 and got["ring_attached"]


def fn_square(args, ctx):
    df = ctx.get_data_feed(train_mode=False)
    while not df.should_stop():
        batch = df.next_batch(10)
        if batch:
            df.batch_results([x * x for x in batch])


def test_inference_round_trip_matches_jax_cluster(tmp_path):
    data = list(range(100))
    parts = [data[i::4] for i in range(4)]   # 4 partitions, 2 executors
    outs = []
    for backend_mod, cluster_mod, name in ((jax_backend, jax_cluster, "jax"),
                                           (backend, cluster, "port")):
        c = cluster_mod.run(backend_mod.LocalBackend(
            2, workdir=str(tmp_path / name)), fn_square, tf_args={},
            num_executors=2, input_mode=cluster_mod.InputMode.SPARK)
        outs.append(c.inference(parts))
        c.shutdown(timeout=60)
    assert outs[1] == outs[0]
    assert outs[1] == [x * x for p in parts for x in p]


# --- (c) a tiny LM fed through the cluster -----------------------------------

def _lm_loss(model, batch, rng):
    return port_tf.lm_loss(model(batch[:, :-1]), batch[:, 1:])


def _port_lm_step(state_dict):
    model = port_tf.build_transformer(**LM)
    model.load_state_dict(state_dict, strict=True)
    opt, _ = port_optim.make_optimizer(
        "adamw_fused", decay_mask=port_optim.default_decay_mask, **OPT)
    return (port_train.make_train_step(_lm_loss, opt),
            port_train.create_train_state(model, opt))


def fn_train_lm(args, ctx):
    torch.set_num_threads(1)
    step, state = _port_lm_step(args["state_dict"])
    df = ctx.get_data_feed()
    losses = []
    for batch in df.iter_device_batches(args["batch"], device="cpu"):
        state, m = step(state, batch.long(), None)
        losses.append(m["loss"].item())
    with open(os.path.join(ctx.working_dir, "losses.json"), "w") as f:
        json.dump(losses, f)


def test_cluster_fed_lm_matches_direct_and_jax_loops(tmp_path):
    B, steps = 4, 4
    tokens = np.random.RandomState(7).randint(0, 64, (B * steps, 17))
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**LM))
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.key(1), jnp.zeros((1, 8), jnp.int32))["params"])
    state_dict = convert.params_from_jax(params)

    c = cluster.run(backend.LocalBackend(1, workdir=str(tmp_path)),
                    fn_train_lm, {"state_dict": state_dict, "batch": B},
                    num_executors=1, input_mode=SPARK)
    rows = [r.astype(np.int32) for r in tokens]
    c.train([rows[:8], rows[8:]], feed_timeout=60)
    c.shutdown(timeout=60)
    with open(tmp_path / "executor-0" / "losses.json") as f:
        fed = json.load(f)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)             # the node's setting: same bits
    try:
        step, state = _port_lm_step(state_dict)
        direct = []
        for i in range(steps):
            state, m = step(state, torch.from_numpy(tokens[i * B:(i + 1) * B]),
                            None)
            direct.append(m["loss"].item())
    finally:
        torch.set_num_threads(threads)
    assert fed == direct

    def jax_loss(p, batch, rng):
        return jax_tf.lm_loss(jm.apply({"params": p}, batch[:, :-1]),
                              batch[:, 1:])

    jopt, _ = jax_optim.make_optimizer(
        "adamw_fused", decay_mask=jax_optim.default_decay_mask, **OPT)
    jstate = jax_train.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), jopt)
    jstep = jax_train.make_train_step(jax_loss, jopt)
    for i in range(steps):
        jstate, jm_ = jstep(jstate, jnp.asarray(tokens[i * B:(i + 1) * B]),
                            jax.random.key(0))
        assert fed[i] == pytest.approx(float(jm_["loss"]), rel=1e-5), i


# --- (d) feed_consensus across two gloo ranks --------------------------------

def fn_consensus(args, ctx):
    torch.set_num_threads(1)
    assert ctx.init_distributed(timeout=60)
    import torch.distributed as dist

    df = ctx.get_data_feed()
    steps = 0
    while True:
        cols = None if df.should_stop() else df.next_numpy_batch(2, timeout=30)
        got = 0 if cols is None else len(cols)
        if not port_train.feed_consensus(got > 0):
            break
        steps += 1
    out = {"steps": steps, "rank": dist.get_rank(),
           "world": dist.get_world_size(), "backend": dist.get_backend()}
    dist.destroy_process_group()
    with open(os.path.join(ctx.working_dir, "consensus.json"), "w") as f:
        json.dump(out, f)


def test_feed_consensus_stops_gloo_ranks_on_one_step(tmp_path):
    c = cluster.run(backend.LocalBackend(2, workdir=str(tmp_path)),
                    fn_consensus, {}, num_executors=2, input_mode=SPARK)
    c.train([list(range(6)), list(range(100, 114))], feed_timeout=60)
    c.shutdown(timeout=60)
    outs = []
    for i in range(2):
        with open(tmp_path / f"executor-{i}" / "consensus.json") as f:
            outs.append(json.load(f))
    # executor 0 holds 3 batches of 2, executor 1 holds 7: both stop after 3
    assert [o["steps"] for o in outs] == [3, 3]
    assert sorted(o["rank"] for o in outs) == [0, 1]
    assert {(o["world"], o["backend"]) for o in outs} == {(2, "gloo")}


# --- (e) closures under spawn, (f) a failing map_fun, (g) duplicates -----------

def test_spawn_refuses_a_closure_before_any_process_starts(tmp_path):
    before = set(mp.active_children())
    spawn = backend.LocalBackend(1, workdir=str(tmp_path),
                                 start_method="spawn")
    for fn in (lambda args, ctx: None, _closure()):
        with pytest.raises(TypeError, match="module-level function"):
            cluster.run(spawn, fn, {}, num_executors=1, input_mode=SPARK)
        with pytest.raises(TypeError, match="module-level function"):
            parallel_runner.run(spawn, fn, {}, num_executors=1)
    assert set(mp.active_children()) == before
    assert spawn._bootstrap_procs == []


def _closure():
    seen = []

    def map_fun(args, ctx):
        seen.append(ctx)
    return map_fun


def fn_raises(args, ctx):
    ctx.get_data_feed().next_batch(1)
    raise ValueError("boom from map_fun 7f3a")


def test_failing_map_fun_aborts_train_with_its_traceback(tmp_path,
                                                         monkeypatch):
    # the feed must outgrow the ring (4 MB at TFOS_TPU_RING_MB=1) so the
    # feeder is still writing when the node dies, as in
    # test_cluster.py::test_error_during_feeding_raises
    monkeypatch.setenv("TFOS_TPU_RING_MB", "1")
    row = np.zeros(512, dtype=np.float32)
    errors = []
    for backend_mod, cluster_mod, name in ((jax_backend, jax_cluster, "jax"),
                                           (backend, cluster, "port")):
        c = cluster_mod.run(backend_mod.LocalBackend(
            1, workdir=str(tmp_path / name)), fn_raises, {},
            num_executors=1, input_mode=cluster_mod.InputMode.SPARK)
        try:
            with pytest.raises(RuntimeError) as info:
                c.train([[row] * 4000], feed_timeout=30)
            errors.append(str(info.value))
        finally:
            c.abort()
    for err in errors:
        assert err.startswith("task 0 failed:")
        assert "RuntimeError: training function failed:" in err
        assert 'in fn_raises\n    raise ValueError("boom from map_fun 7f3a")' \
            in err
        assert "ValueError: boom from map_fun 7f3a" in err


def test_duplicate_bootstrap_is_refused(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    server = reservation.Server(1)
    addr = server.start(host="127.0.0.1")
    try:
        meta = {"cluster_id": "c1", "server_addr": list(addr),
                "cluster_template": {"chief": [0]}, "default_fs": "file://"}
        (tmp_path / ".tfos_cluster_id").write_text("c1")   # a live node
        bootstrap = node.run(fn_raises, (), meta)
        with pytest.raises(node.DuplicateBootstrapError, match="duplicate"):
            bootstrap(iter([0]))
        assert server.reservations.get_errors()
        # the original node on executor 0 keeps its heartbeat monitoring
        assert 0 not in server.finished_ids()
    finally:
        server.stop()


# --- (h) run_elastic: relaunch and feed-offset resume -------------------------

def fn_elastic(args, ctx):
    df = ctx.get_data_feed()
    crash = os.path.join(args["dir"], "crashed")
    step = 0
    while not df.should_stop():
        batch = df.next_batch(16, timeout=10)
        if not batch:
            continue
        with open(os.path.join(args["dir"], "consumed.jsonl"), "a") as f:
            f.write(json.dumps(batch) + "\n")
        step += 1
        first_attempt = not os.path.exists(crash)
        if first_attempt:
            # paced (as test_elastic.py paces it) so the feeder's 0.5 s
            # progress polls see the consumption before the failure
            time.sleep(0.25)
        if step == 6 and first_attempt:
            open(crash, "w").close()
            raise RuntimeError("injected failure on attempt 1")


def test_run_elastic_resumes_the_feed_after_a_failure(tmp_path):
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    records = list(range(240))
    attempt = [0]

    def backend_factory():
        attempt[0] += 1
        return backend.LocalBackend(
            1, workdir=str(tmp_path / f"attempt-{attempt[0]}"))

    cluster.run_elastic(
        backend_factory, fn_elastic, {"dir": str(data_dir)},
        train_data=[records[0::2], records[1::2]], feed_timeout=30,
        max_restarts=1, restart_backoff=0.5, progress_every=16)
    assert attempt[0] == 2
    seen = []
    with open(data_dir / "consumed.jsonl") as f:
        for line in f:
            seen.extend(json.loads(line))
    assert set(seen) == set(records), "records lost"
    # attempt 1 consumed 6 x 16; without the resume all 96 come again
    dups = len(seen) - len(set(seen))
    assert dups <= 64, f"duplicate window too wide: {dups}"
