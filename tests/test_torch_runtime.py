"""The port's cluster runtime, in one process: ``util``, ``gpu_info``,
``marker``, the reservation codec and ``Server`` / ``Client``,
``manager``, the ``shm`` ring, ``feed``'s device half, ``compat`` and the
spawn / fork guards of ``backend``.

Where a module has a JAX-package twin the same inputs go through both:
``marker.pack_records`` must give the same columns, and an ``shm``
payload encoded by either package decodes in the other with equal
columns and equal bytes (the ring's payload format is shared).  Every
comparison here is exact.
"""
import os
import pickle
import socket
import struct
import subprocess
import sys
import uuid
from unittest import mock

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import marker as jax_marker
from tensorflowonspark_tpu import shm as jax_shm
from tensorflowonspark_tpu_torch import (backend, compat, feed, gpu_info,
                                         manager, marker, node, reservation,
                                         shm, util)
from tensorflowonspark_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- util ----------------------------------------------------------------

def test_port_helpers(tmp_path):
    assert util.parse_port_spec("8080") == [8080]
    assert util.parse_port_spec("8000-8002") == [8000, 8001, 8002]
    with pytest.raises(ValueError):
        util.parse_port_spec("9-3")
    port = util.get_free_port("127.0.0.1")
    sock = util.bind_socket("127.0.0.1", [port, port + 1])
    try:
        assert sock.getsockname()[1] == port
        # the taken port is skipped for the next candidate
        sock2 = util.bind_socket("127.0.0.1", [port, port + 1])
        assert sock2.getsockname()[1] == port + 1
        sock2.close()
    finally:
        sock.close()
    util.write_executor_id(3, cwd=str(tmp_path))
    assert util.read_executor_id(cwd=str(tmp_path)) == 3
    args = mock.Mock(data_dir="rel/data", model_dir="gs://b/m",
                     export_dir=None, output=None, tfrecord_dir=None,
                     log_dir=None)
    util.absolutize_args(args)
    assert args.data_dir == os.path.abspath("rel/data")
    assert args.model_dir == "gs://b/m"
    policy = util.RetryPolicy(attempts=3, base_delay=0.0)
    assert list(policy.sleeps()) == [0, 1, 2]


def test_pin_platform_hides_gpus_and_refuses_after_cuda(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    util.pin_platform("cuda")
    assert "CUDA_VISIBLE_DEVICES" not in os.environ
    util.pin_platform("cpu")
    assert os.environ["CUDA_VISIBLE_DEVICES"] == ""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="initialised CUDA"):
        util.pin_platform("cpu")
    with pytest.raises(ValueError):
        util.pin_platform("tpu")


# --- gpu_info ------------------------------------------------------------

@pytest.fixture
def gpus(monkeypatch):
    """A host of ``n`` GPUs as the driver's files would show them."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.delenv(gpu_info.LOCAL_GPUS_ENV, raising=False)

    def _host(n):
        monkeypatch.setattr(gpu_info, "_probe_devices", lambda: n)
    return _host


def test_assign_slices_like_tpu_info(gpus, monkeypatch):
    gpus(8)
    assert gpu_info.assign_chips(2, worker_index=0,
                                 fmt=gpu_info.AS_LIST) == [0, 1]
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert gpu_info.assign_chips(2, worker_index=3) == "6,7"
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "6,7"
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert gpu_info.assign_chips(1) == "0"


def test_assign_oversubscription_raises(gpus):
    gpus(1)
    with pytest.raises(RuntimeError, match="oversubscription"):
        gpu_info.assign_chips(1, worker_index=1)
    with pytest.raises(RuntimeError, match="only 1 visible"):
        gpu_info.assign_chips(2)
    assert "CUDA_VISIBLE_DEVICES" not in os.environ


def test_assign_slices_an_already_restricted_host(gpus, monkeypatch):
    gpus(8)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5,6,7")
    assert gpu_info._count_local_chips() == 4
    assert gpu_info.assign_chips(2, worker_index=1) == "6,7"


def test_assign_retries_then_fails(gpus, monkeypatch):
    monkeypatch.setattr(gpu_info, "RETRY_DELAY_SECS", 0)
    calls = {"n": 0}

    def boom():
        calls["n"] += 1
        raise RuntimeError("driver busy")

    monkeypatch.setattr(gpu_info, "_probe_devices", boom)
    with pytest.raises(RuntimeError, match="no GPU devices available"):
        gpu_info.assign_chips(1)
    assert calls["n"] == gpu_info.MAX_RETRIES + 1
    assert gpu_info.is_gpu_available() is False


def test_assign_refuses_after_cuda_and_counts_from_env(gpus, monkeypatch):
    monkeypatch.setenv(gpu_info.LOCAL_GPUS_ENV, "4")
    assert gpu_info._probe_devices() == 4
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="initialised CUDA"):
        gpu_info.assign_chips(1)


def test_accelerator_info_reads_nvidia_smi(gpus, monkeypatch):
    gpus(2)
    rows = ["0, GPU-aa, NVIDIA H100 80GB HBM3, 700.00 W",
            "1, GPU-bb, NVIDIA H100 80GB HBM3, 700.00 W"]
    monkeypatch.setattr(gpu_info, "_nvidia_smi", lambda *q: rows)
    info = gpu_info.get_accelerator_info()
    assert info == {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
                    "num_devices": 2, "power_limit": "700.00 W"}
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert gpu_info.get_accelerator_info()["platform"] == "none"


# --- marker: the same packing as the JAX package --------------------------

@pytest.mark.parametrize("kind", ["fields", "matrix", "scalars", "arrays",
                                  "objects", "ragged"])
def test_pack_records_matches_jax(kind):
    rng = np.random.RandomState(0)
    records = {
        "fields": [(rng.rand(6).astype(np.float32), i) for i in range(10)],
        "matrix": [tuple(float(v) for v in rng.rand(24)) for _ in range(8)],
        "scalars": [1.5, 2.5, 3.25],
        "arrays": [rng.randint(0, 9, 17).astype(np.int32) for _ in range(5)],
        "objects": [{"a": i} for i in range(4)],
        "ragged": [(1, 2), (3,)],
    }[kind]
    got, want = marker.pack_records(records), jax_marker.pack_records(records)
    assert type(got).__name__ == type(want).__name__
    if isinstance(want, jax_marker.PackedChunk):
        assert (got.row_type, got.matrix) == (want.row_type, want.matrix)
        assert len(got.columns) == len(want.columns)
        for a, b in zip(got.columns, want.columns):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    else:
        assert got.items == want.items


# --- reservation: the JSON frame codec -------------------------------------

def test_codec_roundtrips_bytes_and_nested_values():
    msg = {"type": "REG", "node": {
        "executor_id": 0, "authkey": uuid.UUID(int=7).bytes,
        "addr": ("127.0.0.1", 5), "nested": {"x": [b"\x00\xff", None, 1.5]},
        "ok": True}}
    back = reservation.decode_message(reservation.encode_message(msg))
    assert back["node"]["authkey"] == uuid.UUID(int=7).bytes
    assert back["node"]["addr"] == ["127.0.0.1", 5]    # tuples as lists
    assert back["node"]["nested"] == {"x": [b"\x00\xff", None, 1.5]}
    assert back["node"]["ok"] is True


@pytest.mark.parametrize("msg,err", [
    ({"offsets": {1: 5}}, TypeError),                 # int keys refused
    ({"x": object()}, TypeError),                     # no arbitrary objects
    ({"x": {"__bytes__": "AA=="}}, ValueError),       # the tag is reserved
    ({"x": float("nan")}, ValueError),                # strict JSON
])
def test_codec_refuses_what_json_cannot_carry(msg, err):
    with pytest.raises(err):
        reservation.encode_message(msg)


@pytest.mark.parametrize("payload", [
    pickle.dumps({"type": "REG"}),                    # never unpickled
    b"\xc1garb",                                      # not UTF-8
    b'["REG"]',                                       # not a message object
    b'{"a": {"__bytes__": 3}}',                       # a bad bytes tag
    b'{"a": {"__bytes__": "!!"}}',
])
def test_codec_refuses_foreign_frames(payload):
    with pytest.raises(ValueError):
        reservation.decode_message(payload)


def test_frame_cap_on_send_and_receive(monkeypatch):
    monkeypatch.setattr(reservation.MessageSocket, "MAX_FRAME_BYTES", 64)
    a, b = socket.socketpair()
    try:
        ms = reservation.MessageSocket()
        with pytest.raises(ValueError, match="exceeds protocol limit"):
            ms.send(a, {"x": "y" * 100})
        a.sendall(struct.pack(">I", 65))
        with pytest.raises(ValueError, match="exceeds protocol limit"):
            ms.receive(b)
        ms.send(a, {"x": "y"})
        assert ms.receive(b) == {"x": "y"}
    finally:
        a.close()
        b.close()


def test_server_client_protocol():
    server = reservation.Server(2)
    addr = server.start(host="127.0.0.1")
    clients = [reservation.Client(addr) for _ in range(2)]
    try:
        for i, c in enumerate(clients):
            c.register({"executor_id": i, "authkey": bytes([i]) * 16})
        q = clients[0].query()
        assert q == {"type": "QUERY", "done": True, "count": 2,
                     "required": 2}
        nodes = clients[1].await_reservations(timeout=10)
        assert [n["authkey"] for n in nodes] == [b"\x00" * 16, b"\x01" * 16]
        assert server.await_reservations(timeout=10) == nodes
        # PROGRESS: int partition ids cross stringified and come back ints
        clients[0].send_progress({3: 10, 4: 2})
        clients[1].send_progress({3: 7})
        assert server.progress_snapshot() == {3: 10, 4: 2}
        clients[0]._request({"type": "BEAT", "executor_id": 0})
        assert 0 in server.last_beats()
        assert clients[1].bye(1) == {"type": "OK"}
        assert server.finished_ids() == {1}
        clients[0].report_error({"executor_id": 0}, "boom")
        assert server.reservations.get_errors() == [
            {"node": {"executor_id": 0}, "error": "boom"}]
        assert clients[0]._request({"type": "NOPE"})["type"] == "ERR"
        # a foreign frame drops that peer only
        s = socket.create_connection(addr)
        s.sendall(struct.pack(">I", 5) + b"\x80junk")
        s.close()
        assert clients[1].query()["done"]
        clients[0].request_stop()
        assert server.done.wait(5)
    finally:
        for c in clients:
            c.close()
        server.stop()


# --- manager ---------------------------------------------------------------

def test_manager_queues_and_kv_roundtrip():
    authkey = uuid.uuid4().bytes
    mgr = manager.start(authkey, ["input", "output"])
    try:
        other = manager.connect(mgr._tfos_addr, authkey)
        other.get_queue("input").put({"rows": [1, 2]})
        q = mgr.get_queue("input")
        assert q.get(timeout=5) == {"rows": [1, 2]}
        q.task_done()
        other.set("state", "running")
        assert manager.get_value(mgr, "state") == "running"
        assert manager.get_value(mgr, "missing") is None
        assert mgr.has_queue("output")._getvalue() is True
        with pytest.raises(Exception):
            mgr.get_queue("nope")
    finally:
        mgr.shutdown()


# --- shm ring ----------------------------------------------------------------

@pytest.fixture
def ring():
    r = shm.ShmChunkRing.create(slot_bytes=1 << 12, nslots=4)
    yield r
    r.close()
    r.unlink()


def test_ring_wraps_around_and_spans_frames(ring):
    for i in range(11):       # 11 x (1..2 frames) laps the 4-slot ring
        n = 50 + 150 * (i % 3)
        rows = [(np.full(3, i + k, np.float32), k) for k in range(n)]
        parts, count = shm.encode_chunk(marker.pack_records(rows))
        ref = ring.write(parts, count, timeout=5)
        assert ref.nframes == -(-ref.nbytes // ring.slot_bytes)
        out = ring.read(ref)
        np.testing.assert_array_equal(out.columns[1], np.arange(n))
        np.testing.assert_array_equal(out.columns[0][:, 0],
                                      np.arange(n) + i)
    assert ring._produced_seq() > ring.nslots


def test_ring_skip_frees_frames(ring):
    parts, n = shm.encode_chunk(marker.Chunk(list(range(3000))))
    ref = ring.write(parts, n, timeout=5)
    assert ref.nframes == 3
    with pytest.raises(shm.RingTimeout):
        ring.write(parts, n, timeout=0.2)      # ring full until skipped
    ring.skip(ref)
    ref2 = ring.write(parts, n, timeout=5)
    assert ring.read(ref2) == list(range(3000))


def _chunks():
    rng = np.random.RandomState(1)
    return {
        "fields": marker.pack_records(
            [(rng.rand(5).astype(np.float32), i) for i in range(9)]),
        "matrix": marker.pack_records(
            [tuple(float(v) for v in rng.rand(20)) for _ in range(4)]),
        "scalars": marker.pack_records([3, 1, 4, 1, 5]),
        "tokens": marker.pack_records(
            [rng.randint(0, 32000, 1025).astype(np.int32) for _ in range(8)]),
        "objects": marker.Chunk([{"k": i, "s": "x" * i} for i in range(3)]),
    }


def _as_jax(chunk):
    if isinstance(chunk, marker.PackedChunk):
        return jax_marker.PackedChunk(chunk.columns, chunk.row_type,
                                      chunk.matrix)
    return jax_marker.Chunk(chunk.items)


def _same_payload(a, b):
    if isinstance(b, (jax_marker.PackedChunk, marker.PackedChunk)):
        assert (a.row_type, a.matrix) == (b.row_type, b.matrix)
        for x, y in zip(a.columns, b.columns, strict=True):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("kind", list(_chunks()) + ["multi"])
def test_payloads_cross_between_packages(kind):
    chunks = _chunks()
    if kind == "multi":
        port_parts, n = shm.encode_multi(list(chunks.values()))
        jax_parts, m = jax_shm.encode_multi(
            [_as_jax(c) for c in chunks.values()])
    else:
        port_parts, n = shm.encode_chunk(chunks[kind])
        jax_parts, m = jax_shm.encode_chunk(_as_jax(chunks[kind]))
    port_bytes = b"".join(bytes(p) for p in port_parts)
    jax_bytes = b"".join(bytes(p) for p in jax_parts)
    assert n == m and port_bytes == jax_bytes
    from_jax = shm.decode_payload(memoryview(jax_bytes))
    from_port = jax_shm.decode_payload(memoryview(port_bytes))
    if kind == "multi":
        assert isinstance(from_jax, shm.MultiPayload)
        for a, b in zip(from_jax, from_port, strict=True):
            _same_payload(a, b)
    else:
        _same_payload(from_jax, from_port)
        if isinstance(from_jax, marker.PackedChunk):
            _same_payload(from_jax, chunks[kind])


# --- feed: DataFeed over the ring, and the device half ----------------------

def test_datafeed_through_ring_and_device_half(monkeypatch):
    authkey = uuid.uuid4().bytes
    mgr = manager.start(authkey, ["input", "output", "error"])
    ring = shm.ShmChunkRing.create(slot_bytes=1 << 16, nslots=4)
    try:
        mgr.set("shm_ring", ring.info())
        q = mgr.get_queue("input")
        rows = [np.arange(17, dtype=np.int32) + i for i in range(10)]
        assert node._push_chunks(q, iter(rows), mgr=mgr) == 10
        q.put(None)
        df = feed.DataFeed(mgr)
        got = list(df.iter_device_batches(4, device="cpu", pad=True))
        assert df._ring is not None
        assert [tuple(b.shape) for b in got] == [(4, 17)] * 3
        assert all(b.dtype == torch.int32 for b in got)
        np.testing.assert_array_equal(got[2][1].numpy(), rows[9])  # padded
        np.testing.assert_array_equal(
            torch.cat(got)[:10].numpy(), np.stack(rows))
        q.join()
    finally:
        ring.close()
        ring.unlink()
        mgr.shutdown()
    batches = [(np.ones((2, 3), np.float32), np.arange(2)),
               {"x": np.zeros(4)}]
    out = list(feed.device_prefetch(iter(batches), depth=3, device="cpu"))
    assert isinstance(out[0], tuple) and out[0][0].shape == (2, 3)
    assert isinstance(out[1], dict) and out[1]["x"].dtype == torch.float64
    with pytest.raises(NotImplementedError, match="multi-GPU sharding"):
        feed.device_prefetch(iter(batches), sharding=object())
    with pytest.raises(NotImplementedError, match="multi-GPU sharding"):
        feed.DataFeed(None).iter_device_batches(4, sharding=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        feed.device_prefetch(iter(batches))


# --- backend guards, NodeContext, compat ------------------------------------

def _module_level_fn(args, ctx):
    return args


def test_spawn_needs_picklable_fns_and_fork_refuses_cuda(tmp_path,
                                                         monkeypatch):
    spawn = backend.LocalBackend(1, workdir=str(tmp_path),
                                 start_method="spawn")
    spawn.check_shippable(_module_level_fn)
    spawn.check_shippable(node.run(_module_level_fn, None, {}))
    with pytest.raises(TypeError, match="module-level function"):
        spawn.check_shippable(lambda it: None)
    with pytest.raises(TypeError, match="module-level function"):
        spawn.check_shippable(node.run(lambda a, c: None, None, {}))
    fork = backend.LocalBackend(1, workdir=str(tmp_path))
    fork.check_shippable(lambda it: None)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="start_method='spawn'"):
        fork.run_on_executors(_module_level_fn, 1)
    assert fork._bootstrap_procs == []


def test_node_context_ranks_and_single_process_init():
    info = [{"executor_id": 2, "job_name": "worker", "host": "h"},
            {"executor_id": 0, "job_name": "chief", "host": "h",
             "coordinator_port": 1234},
            {"executor_id": 1, "job_name": "evaluator", "host": "h"}]
    ctx = node.NodeContext(executor_id=2, job_name="worker",
                           cluster_info=info)
    assert (ctx.process_id, ctx.num_processes) == (1, 2)
    assert ctx.coordinator_address == "h:1234"
    assert not node.NodeContext(executor_id=1, job_name="evaluator",
                                cluster_info=info).init_distributed()
    assert not node.NodeContext().init_distributed()
    assert compat.export_chief_only(lambda x: x + 1, True, 1) == 2
    assert compat.export_chief_only(lambda x: x + 1, False, 1) is None


# --- ops/_build: the build lock ------------------------------------------------

_FAKE_NVCC = """#!/bin/sh
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
echo "$PROC start $(date +%s.%N)" >> "$LOG"
sleep 0.2
echo built > "$out"
echo "$PROC end $(date +%s.%N)" >> "$LOG"
"""

_BUILD_SCRIPT = """
import sys
from tensorflowonspark_tpu_torch.ops import _build
build_dir, nvcc, force = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
_build.BUILD_DIR = build_dir
_build.LIBRARY = build_dir + "/libtos_kernels.so"
_build.LOCK = build_dir + "/lock"
_build.nvcc_path = lambda: nvcc
if force:
    _build._stale = lambda: True
print(_build.locked_build()["built"])
"""


@pytest.mark.parametrize("force", [True, False],
                         ids=["both-build", "second-finds-it-fresh"])
def test_build_lock_serialises_processes(tmp_path, force):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    log = tmp_path / "log"
    build_dir = tmp_path / "build"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_SCRIPT, str(build_dir), str(nvcc),
         "1" if force else "0"],
        env=dict(os.environ, PYTHONPATH=REPO, PROC=name, LOG=str(log)),
        stdout=subprocess.PIPE, text=True) for name in ("a", "b")]
    outs = [p.communicate(timeout=60)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    spans = {}
    for line in log.read_text().splitlines():
        who, what, t = line.split()
        lo, hi = spans.get(who, (float("inf"), 0.0))
        spans[who] = (min(lo, float(t)), max(hi, float(t)))
    # one nvcc per source, then the link, for each process that built
    assert sorted(o[-1] for o in outs) == (["True", "True"] if force
                                           else ["False", "True"])
    assert len(log.read_text().splitlines()) == \
        2 * (len(_build.SOURCES) + 1) * len(spans)
    if force:
        (a0, a1), (b0, b1) = spans["a"], spans["b"]
        assert a1 < b0 or b1 < a0, spans       # never both at once
    assert (build_dir / "libtos_kernels.so").read_text() == "built\n"
