"""Per-executor node runtime — counterpart of ``tensorflowonspark_tpu/
node.py`` (maps reference TFSparkNode.py:43-636).

`run/train/inference/shutdown` build the callables that the cluster layer
ships to executors through a `Backend`.  They are instances of
module-level classes holding their arguments (not closures), so a
``spawn``-started executor receives them through the standard pickler.
Differences from the reference, by design (SURVEY.md §7):

- No TF_CONFIG / port scouting.  Registration metadata feeds a
  **torch.distributed bootstrap**: the sorted reservation list yields
  ``(rendezvous address, world size, rank)``; `NodeContext.
  init_distributed()` hands these to ``torch.distributed.
  init_process_group``.  Chief (rank 0) offers the rendezvous port at
  registration time.
- Roles are `chief` / `worker` / `evaluator`.  Parameter servers have no
  analog here — async PS gradients are replaced by synchronous
  allreduce; `num_ps > 0` is accepted and scheduled as extra workers
  with a loud divergence warning (SURVEY.md §2.3).
- Data feeding is chunked (`marker.Chunk`) rather than per-record.
- The executor bootstrap never touches CUDA (``torch`` is not imported
  here): the background node process is forked from it, and a process
  forked after CUDA initialised cannot use CUDA.
"""
import logging
from typing import Any, Callable, Dict, Optional
import multiprocessing as mp
import os
import time
import traceback
import uuid

from . import feed as feed_mod
from . import gpu_info, manager, marker, reservation, shm, util

logger = logging.getLogger(__name__)

CHUNK_SIZE = 512  # records per queue item when feeding


class DuplicateBootstrapError(RuntimeError):
    """A task retry tried to bootstrap an executor that already hosts a live
    node for this cluster_id (maps TFSparkNode.py:249-255).  Distinguished
    from other bootstrap failures because the ORIGINAL node is still alive:
    its heartbeat monitoring must not be cancelled on its behalf."""


class NodeContext:
    """Runtime context handed to the user's map_fun (maps TFSparkNode.py:59-99)."""

    def __init__(self, executor_id=0, job_name="chief", task_index=0, num_workers=1,
                 cluster_info=None, default_fs="file://", working_dir=None, mgr=None,
                 num_chips=0):
        self.executor_id = executor_id
        self.num_chips = num_chips  # GPUs assigned to this executor
        self.job_name = job_name
        self.task_index = task_index
        self.num_workers = num_workers
        self.cluster_info = cluster_info or []
        self.default_fs = default_fs
        self.working_dir = working_dir or os.getcwd()
        self.mgr = mgr
        self.user_name = os.environ.get("USER", "user")
        # process_id = rank in the sorted TRAINING node list (chief first).
        # Only chief+workers form the torch.distributed world — an
        # evaluator joining it would deadlock the gradient collectives (it
        # never enters the train step); like the reference's evaluator, it
        # runs outside the cluster's collective group (TFSparkNode.py:261).
        ordered = sorted(
            (n for n in self.cluster_info
             if n.get("job_name") in ("chief", "worker")),
            key=lambda n: (n.get("job_name") != "chief", n.get("executor_id", 0)))
        self.process_id = next(
            (i for i, n in enumerate(ordered)
             if n.get("executor_id") == executor_id), 0)
        self.num_processes = max(len(ordered), 1)
        chief = next((n for n in ordered if n.get("job_name") == "chief"), None)
        self.coordinator_address = None
        if chief is not None and chief.get("coordinator_port"):
            self.coordinator_address = f"{chief['host']}:{chief['coordinator_port']}"

    @property
    def is_chief(self):
        return self.job_name == "chief"

    def get_data_feed(self, train_mode=True, qname_in="input", qname_out="output",
                      input_mapping=None):
        """Build the DataFeed for InputMode.SPARK (maps TFNode.py:221-241)."""
        return feed_mod.DataFeed(self.mgr, train_mode, qname_in, qname_out, input_mapping)

    def absolute_path(self, path):
        """Normalize against the cluster default FS (maps TFNode.hdfs_path)."""
        return feed_mod.hdfs_path(self, path)

    def init_distributed(self, timeout=None):
        """Join the training processes' ``torch.distributed`` default group
        from the reservation-derived identity: ``init_process_group(
        init_method="tcp://<chief host>:<rendezvous port>", world_size=
        num_processes, rank=process_id)``.

        The backend is ``nccl`` when every training process holds its own
        GPU (the cluster ran with ``num_chips`` >= 1 and CUDA is available
        here) and ``gloo`` otherwise: NCCL refuses two ranks on one GPU.  ``timeout`` (seconds) bounds the rendezvous and each
        collective.  No-op for single-process clusters and for the
        evaluator, which runs outside the training world.  Returns
        whether a group was made.
        """
        if self.job_name not in ("chief", "worker"):
            logger.info("%s node runs outside the training world; "
                        "skipping torch.distributed init", self.job_name)
            return False
        if self.num_processes <= 1 or self.coordinator_address is None:
            logger.info("single-process cluster; skipping torch.distributed "
                        "init")
            return False
        import datetime

        import torch
        import torch.distributed as dist

        backend = ("nccl" if self.num_chips and torch.cuda.is_available()
                   else "gloo")
        kw = {}
        if timeout is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout)
        dist.init_process_group(
            backend=backend, init_method=f"tcp://{self.coordinator_address}",
            world_size=self.num_processes, rank=self.process_id, **kw)
        return True


def _get_manager(cluster_info, host, executor_id):
    """Locate the queue manager for (host, executor_id) from the reservation
    list (maps TFSparkNode._get_manager, TFSparkNode.py:119-146)."""
    for node in cluster_info:
        if node["executor_id"] == executor_id and node["host"] == host:
            addr = tuple(node["addr"])
            mgr = manager.connect(addr, node["authkey"])
            logger.debug("connected to manager for executor %d, state=%s",
                         executor_id, manager.get_value(mgr, "state"))
            return mgr
    raise RuntimeError(
        f"no node registered for host={host} executor_id={executor_id}; "
        f"known: {[(n['host'], n['executor_id']) for n in cluster_info]}")


def _wrapper_fn(map_fun, tf_args, ctx):
    """Invoke the user function, re-injecting argv-style args
    (maps TFSparkNode.py:397-401)."""
    if isinstance(tf_args, list):
        import sys
        sys.argv = [sys.argv[0] if sys.argv else "map_fun"] + list(tf_args)
    return map_fun(tf_args, ctx)


def _heartbeat_interval(cluster_meta):
    """Beat-interval resolution.  The DRIVER decides whether heartbeats
    exist (heartbeat_timeout -> cluster_meta['heartbeat_interval'], 0 when
    the monitor is off): the monitor seeds every registered node into its
    beat table, so a node-side switch that disarmed beating while the
    monitor is armed would get every healthy node flagged dead.  The env
    var can therefore only retune the cadence, never disable it — and only
    downward: an override above the driver-computed base would beat wider
    than the monitor's window, which is functionally disabling."""
    base = float(cluster_meta.get("heartbeat_interval", 5.0))
    if base <= 0:
        return 0.0
    env = os.environ.get("TFOS_TPU_HEARTBEAT_INTERVAL")
    if env is not None:
        try:
            override = float(env)
        except ValueError:
            logger.warning("ignoring malformed TFOS_TPU_HEARTBEAT_INTERVAL=%r",
                           env)
            return base
        if override > 0:
            if override > base:
                logger.warning(
                    "TFOS_TPU_HEARTBEAT_INTERVAL=%s exceeds the monitor "
                    "window's cadence %.1fs; clamping", env, base)
            return min(override, base)
    return base


def _wrapper_fn_background(map_fun, tf_args, ctx, error_q_addr, authkey,
                           server_addr=None, hb_interval=5.0):
    """Background-process trampoline: exceptions land on the node's error
    queue instead of vanishing (maps TFSparkNode.py:403-409). This process
    is the liveness principal for the node, so it also owns the heartbeat:
    a silent death here (OOM, SIGKILL) is what the coordinator's monitor
    exists to catch."""
    hb_client = None
    if server_addr is not None:
        # connect=False: the beat thread makes its own connections and
        # retries forever, so a briefly-unreachable server at node start
        # must not leave the node permanently unmonitored (the seeded
        # monitor would flag it dead).  The client exists even with
        # heartbeats disabled: BYE (normal-exit announcement) rides it, and
        # shutdown's wait-for-trainers ordering depends on BYE arriving.
        hb_client = reservation.Client(tuple(server_addr), connect=False)
        if hb_interval > 0:
            hb_client.start_heartbeat(ctx.executor_id, interval=hb_interval)
    mgr = None
    try:
        mgr = manager.connect(error_q_addr, authkey)
        ctx.mgr = mgr
        _wrapper_fn(map_fun, tf_args, ctx)
        if hb_client is not None:
            hb_client.bye(ctx.executor_id)
            hb_client.close()
    except BaseException:
        tb = traceback.format_exc()
        logger.error("background node fn failed:\n%s", tb)
        reported = False
        if mgr is not None:
            try:
                mgr.get_queue("error").put(tb)
                reported = True
            except Exception:
                pass
        if hb_client is not None:
            if reported:
                # BYE only once the death is durably REPORTED: the monitor
                # must not pile a spurious "heartbeat lost" on a reported
                # traceback — but if reporting failed, heartbeat loss is
                # the ONLY signal the driver will ever get; keep it.
                hb_client.bye(ctx.executor_id)
            else:
                resp = hb_client.report_error(
                    {"executor_id": ctx.executor_id}, tb)
                if resp is not None:  # None = report lost too; let the
                    hb_client.bye(ctx.executor_id)  # monitor flag the death
            hb_client.close()
        raise SystemExit(1)


class _NodeBootstrap:
    """The per-executor bootstrap task that `run` builds: called with an
    iterator yielding the executor id (the backend's contract)."""

    def __init__(self, map_fun, tf_args, cluster_meta, tensorboard, queues,
                 background):
        self.map_fun = map_fun
        self.tf_args = tf_args
        self.cluster_meta = cluster_meta
        self.tensorboard = tensorboard
        self.queues = queues
        self.background = background

    def __call__(self, iterator):
        cluster_meta = self.cluster_meta
        executor_id = None
        for item in iterator:
            executor_id = item
        assert executor_id is not None, "bootstrap task received no executor id"

        # 1. role assignment from the template (maps TFSparkNode.py:231-241)
        job_name, task_index = None, -1
        for jname, ids in cluster_meta["cluster_template"].items():
            if executor_id in ids:
                job_name = jname
                task_index = ids.index(executor_id)
                break
        assert job_name is not None, f"executor {executor_id} not in cluster template"
        logger.info("executor %d assigned %s:%d", executor_id, job_name, task_index)

        # Connect to the rendezvous server FIRST so that any bootstrap
        # failure below (duplicate-bootstrap, manager start, GPU probe) is
        # reported to the driver instead of silently burning the full
        # reservation timeout.
        client = reservation.Client(cluster_meta["server_addr"])
        try:
            _bootstrap(executor_id, job_name, task_index, client,
                       self.map_fun, self.tf_args, cluster_meta,
                       self.tensorboard, self.queues, self.background)
        except BaseException as e:
            resp = client.report_error(
                {"executor_id": executor_id, "job_name": job_name}, repr(e))
            if resp is not None and not isinstance(e, DuplicateBootstrapError):
                # Death is durably reported — suppress the monitor's
                # redundant "heartbeat lost" for this node.  If the report
                # was lost (resp None), heartbeat loss stays the only
                # signal the driver gets; keep it.  A duplicate-bootstrap
                # rejection must NOT send BYE: the ORIGINAL node on this
                # executor_id is alive and its heartbeats still matter.
                client.bye(executor_id)
            raise
        finally:
            client.close()


def run(map_fun, tf_args, cluster_meta, tensorboard=False, log_dir=None,
        queues=("input", "output", "error", "control"), background=False):
    """Build the per-executor bootstrap task (maps TFSparkNode.run,
    TFSparkNode.py:149-446).

    `cluster_meta` carries: cluster_id, cluster_template {job_name: [ids]},
    num_executors, default_fs, server_addr, num_chips (GPUs per worker),
    reservation_timeout.
    """
    return _NodeBootstrap(map_fun, tf_args, cluster_meta, tensorboard,
                          tuple(queues), background)


def _bootstrap(executor_id, job_name, task_index, client, map_fun, tf_args,
               cluster_meta, tensorboard, queues, background):
        # 1b. a background node is a fork of this executor, which must not
        #     hold CUDA (a persistent executor that ran a transform or a
        #     NATIVE-mode node does): refuse before registering, so the
        #     driver's startup wait fails with this error at once
        if background:
            from . import backend as backend_mod
            backend_mod.refuse_fork_after_cuda(
                "the background node process",
                hint="this executor ran CUDA work (a TFModel transform or a "
                     "NATIVE-mode node) before this SPARK-mode node; fit "
                     "before transform, or fit on a fresh context")
        # 2. stale-manager detection: a Spark task retry on the same executor
        #    must not double-start a node (maps TFSparkNode.py:249-255).
        state_file = os.path.join(os.getcwd(), ".tfos_cluster_id")
        if os.path.exists(state_file):
            with open(state_file) as f:
                prior = f.read().strip()
            if prior == str(cluster_meta["cluster_id"]):
                raise DuplicateBootstrapError(
                    f"executor {executor_id} already hosts a node for cluster "
                    f"{prior}; refusing duplicate bootstrap (task retry?)")
        with open(state_file, "w") as f:
            f.write(str(cluster_meta["cluster_id"]))

        # 4. queue manager: 'remote' for evaluator so the driver can reach its
        #    control queue (maps TFSparkNode.py:259-268).
        authkey = uuid.uuid4().bytes
        mode = "remote" if job_name == "evaluator" else "local"
        mgr = manager.start(authkey, list(queues), mode=mode)
        mgr.set("state", f"running/{job_name}")
        util.write_executor_id(executor_id)

        # 4b. shared-memory data plane: created BEFORE registration so any
        #     feeder that can discover this manager also finds the ring —
        #     both sides then use one transport for the whole feed (payload
        #     bytes ride /dev/shm; the queue carries ShmRefs + markers).
        if shm.ring_enabled():
            try:
                ring = shm.ShmChunkRing.create()
                mgr.set("shm_ring", ring.info())
                shm.advertise_file(ring.info())
                # Creator-side last-resort unlink.  atexit alone is not
                # enough: multiprocessing children exit via os._exit after
                # running only mp.util finalizers, so in an executor
                # process an atexit hook never fires (leaving the tracker
                # to warn about an already-unlinked segment).  Register
                # both — unlink is idempotent.
                import atexit
                from multiprocessing import util as mp_util
                atexit.register(ring.unlink)
                mp_util.Finalize(None, ring.unlink, exitpriority=10)
            except Exception:
                logger.warning("shm ring unavailable; data feed falls back "
                               "to manager-queue transport", exc_info=True)

        # 5. chief offers the torch.distributed rendezvous port; every node
        #    learns it from the reservation list (replaces TF_CONFIG assembly,
        #    TFSparkNode.py:366-374).
        host = util.get_ip_address()
        coordinator_port = util.get_free_port(host) if job_name == "chief" else None

        # 6. optional profiler server (the TensorBoard-subprocess analog,
        #    TFSparkNode.py:282-319) — started lazily inside the user fn via
        #    utils.profiling; here we only reserve the port on the chief.
        tb_port = None
        if tensorboard and job_name == "chief":
            tb_port = int(os.environ.get("TFOS_TPU_PROFILER_PORT", 0)) or \
                util.get_free_port(host)

        # 7. register & rendezvous (maps TFSparkNode.py:321-360)
        node_meta = {
            "executor_id": executor_id,
            "host": host,
            "job_name": job_name,
            "task_index": task_index,
            "addr": list(mgr._tfos_addr),
            "authkey": authkey,
            "coordinator_port": coordinator_port,
            "tb_port": tb_port,
            "pid": os.getpid(),
        }
        client.register(node_meta)
        cluster_info = client.await_reservations(
            timeout=cluster_meta.get("reservation_timeout", 600))

        # GPU assignment (maps the cluster-aware second GPU pass,
        # TFSparkNode.py:376-378): the worker index must be HOST-LOCAL (my
        # rank among same-host peers), which is only knowable
        # post-rendezvous.  CUDA_VISIBLE_DEVICES set here reaches the node
        # process forked below, which initialises CUDA itself.  num_chips=0
        # means "whole host" — no restriction applied.
        num_chips = cluster_meta.get("num_chips", 0)
        if num_chips:
            peers_here = sorted(n["executor_id"] for n in cluster_info
                                if n["host"] == host)
            local_index = peers_here.index(executor_id)
            gpu_info.assign_chips(num_chips, worker_index=local_index)

        num_workers = sum(len(v) for k, v in cluster_meta["cluster_template"].items()
                          if k in ("chief", "worker"))
        ctx = NodeContext(
            executor_id=executor_id,
            job_name=job_name,
            task_index=task_index,
            num_workers=num_workers,
            cluster_info=cluster_info,
            default_fs=cluster_meta.get("default_fs", "file://"),
            working_dir=os.getcwd(),
            mgr=mgr,
            num_chips=num_chips,
        )

        # 8. dispatch (maps TFSparkNode.py:397-443)
        try:
            if background:
                # SPARK input mode: node runs in a background process so this
                # task can return and free the executor slot for feeder tasks.
                ctx_bg = NodeContext(
                    executor_id=executor_id, job_name=job_name,
                    task_index=task_index, num_workers=num_workers,
                    cluster_info=cluster_info,
                    default_fs=cluster_meta.get("default_fs", "file://"),
                    working_dir=os.getcwd(), mgr=None, num_chips=num_chips)
                # forked: map_fun crosses as the object itself (no pickling),
                # so any callable works here; the fork is safe because this
                # executor has not initialised CUDA (checked at the top; the
                # node process does)
                p = mp.get_context("fork").Process(
                    target=_wrapper_fn_background,
                    args=(map_fun, tf_args, ctx_bg,
                          mgr._tfos_addr, authkey,
                          cluster_meta.get("server_addr"),
                          _heartbeat_interval(cluster_meta)),
                    name=f"node-{job_name}-{task_index}")
                p.start()
                logger.info("started background node process pid=%d", p.pid)
            else:
                # foreground node: this process is the liveness principal
                hb_interval = _heartbeat_interval(cluster_meta)
                if hb_interval > 0:
                    client.start_heartbeat(executor_id, interval=hb_interval)
                _wrapper_fn(map_fun, tf_args, ctx)
                client.bye(executor_id)
        except BaseException:
            tb = traceback.format_exc()
            logger.error("node fn failed on executor %d:\n%s", executor_id, tb)
            try:
                mgr.get_queue("error").put(tb)
            except Exception:
                pass
            raise  # _NodeBootstrap reports to the server, then BYEs


def _push_chunks(q, iterator, mgr=None, timeout=600.0, equeue=None,
                 progress_fn=None, progress_every=512, poll_cb=None):
    """Push records as chunk batches; returns the record count.  Shared by
    the train and inference feeders — inference's 1:1 result accounting
    depends on this count being exact.

    Transport: when the node advertises a shared-memory ring
    (`shm.discover`), chunk payloads are copied into the ring and the
    queue carries tiny `shm.ShmRef` handles — the SURVEY.md §7
    "process-boundary feed throughput" fix.  Packed sub-chunks coalesce
    into ~TFOS_TPU_CHUNK_BYTES payloads first, because each queue
    operation costs a manager round trip and per-item overhead (not
    bandwidth) dominates once bytes ride shared memory.  Without a ring,
    uniform numeric chunks go through the queue as columnar PackedChunks
    (round-1 behavior, still the fallback when rings cannot be created)."""
    ring = None
    if mgr is not None and shm.ring_enabled():
        try:
            info = shm.discover(mgr)
            if info:
                ring = shm.attach_cached(info)
        except Exception:
            logger.warning("could not attach shm ring; using queue "
                           "transport", exc_info=True)
    target_bytes = int(os.environ.get("TFOS_TPU_CHUNK_BYTES", 8 << 20))
    if ring is not None:
        target_bytes = min(target_bytes, ring.capacity_bytes // 4)

    pending = []        # packed sub-chunks awaiting one coalesced write
    pending_bytes = 0

    last_poll = [time.time()]

    def _maybe_poll():
        # progress reports must flow DURING the push too: under ring
        # backpressure the feeder spends the whole epoch here, and a
        # crash would otherwise find an empty high-water map
        if poll_cb is not None and time.time() - last_poll[0] >= 0.5:
            last_poll[0] = time.time()
            try:
                poll_cb()
            except Exception:
                logger.warning("progress poll failed", exc_info=True)

    def _abort_on_error():
        # polled while a ring write blocks on a full ring: a dead/failed
        # consumer should surface its error, not a generic RingTimeout
        # (maps the reference's error polling during queue.join(),
        # TFSparkNode.py:488-495)
        _maybe_poll()
        tb = _peek_error(equeue) if equeue is not None else None
        if tb is not None:
            raise RuntimeError(f"training function failed:\n{tb}")

    def _flush():
        nonlocal pending, pending_bytes, ring
        if not pending:
            return
        subs, pending, pending_bytes = pending, [], 0
        try:
            parts, n = (shm.encode_multi(subs) if len(subs) > 1
                        else shm.encode_chunk(subs[0]))
        except Exception:
            # codec surprise: the queue still works (ring untouched)
            logger.warning("chunk encode failed; chunks ride the queue",
                           exc_info=True)
        else:
            try:
                ref = ring.write(parts, n, timeout=timeout,
                                 should_abort=_abort_on_error)
            except (shm.RingTimeout, RuntimeError):
                raise
            except Exception:
                # write() repaired its frame state, but a transport that
                # failed generically once is not worth retrying — drop to
                # queue transport for the remainder of this task
                logger.warning("ring write failed; disabling ring for this "
                               "task", exc_info=True)
                ring = None
            else:
                # q.put stays OUTSIDE the handler: a manager failure after
                # a successful write must fail the task (its frames are
                # committed; re-sending the subs via the queue would both
                # duplicate records and orphan the FULL frames)
                q.put(ref)
                return
        for sub in subs:
            q.put(sub)

    def _send(records):
        nonlocal pending_bytes
        packed = marker.pack_records(records)
        if ring is None:
            q.put(packed)
            return
        if isinstance(packed, marker.PackedChunk):
            nb = sum(c.nbytes for c in packed.columns)
            if nb > ring.capacity_bytes - (1 << 16):
                # larger than the ring itself: this one rides the queue
                _flush()
                q.put(packed)
                return
            # flush BEFORE the payload would cross the target (the 64 KiB
            # margin covers codec metadata), so each ring write stays
            # within its intended frame budget instead of spilling into
            # an extra mostly-empty slot
            if pending and pending_bytes + nb > target_bytes - (1 << 16):
                _flush()
            pending.append(packed)
            pending_bytes += nb
            if len(pending) >= 64:
                _flush()
        else:
            # object records: size unknowable without pickling; ship the
            # coalesced buffer right away
            pending.append(packed)
            _flush()

    count = 0
    last_mark = 0
    chunk = []
    for item in iterator:
        chunk.append(item)
        # a due progress marker cuts the chunk early: markers must land
        # every ~progress_every records even when that is smaller than
        # the transport chunk
        marker_due = (progress_fn is not None
                      and count + len(chunk) - last_mark >= progress_every)
        if len(chunk) >= CHUNK_SIZE or marker_due:
            _send(chunk)
            count += len(chunk)
            chunk = []
            _maybe_poll()
            if marker_due:
                # records must be IN the queue before the marker claims
                # them (a marker racing ahead of its chunk would confirm
                # consumption of records still in the pending buffer)
                _flush()
                q.put(progress_fn(count))
                last_mark = count
    if chunk:
        _send(chunk)
        count += len(chunk)
    _flush()
    if progress_fn is not None and count > last_mark:
        q.put(progress_fn(count))
    return count


PROGRESS_HEADER = "__tfos_pid__"


def train(cluster_info: Any, cluster_meta: Any, feed_timeout: float = 600,
          qname: str = "input",
          skip_offsets: Optional[Dict[int, int]] = None,
          track_progress: bool = False,
          progress_every: int = 512) -> Callable:
    """Build the feeder task for training data (maps TFSparkNode.train,
    TFSparkNode.py:448-515).

    ``track_progress`` (feed-offset resume, net-new): each partition's
    first record is a ``(PROGRESS_HEADER, pid)`` tag (cluster.train adds
    it); the feeder strips it, skips the first ``skip_offsets[pid]``
    records (already consumed by a previous attempt), interleaves
    consumption-confirmed `marker.Progress` checkpoints every
    ``progress_every`` records, and forwards the high-water marks to the
    driver's reservation server — both while feeding and while waiting
    for consumption — so `cluster.run_elastic` can bound duplicate
    delivery on relaunch to ~one progress window.
    """
    return _TrainFeeder(cluster_info, cluster_meta, feed_timeout, qname,
                        skip_offsets, track_progress, progress_every)


class _TrainFeeder:
    """The feeder task `train` builds: pushes one partition."""

    def __init__(self, cluster_info, cluster_meta, feed_timeout, qname,
                 skip_offsets, track_progress, progress_every):
        self.cluster_info = cluster_info
        self.cluster_meta = cluster_meta
        self.feed_timeout = feed_timeout
        self.qname = qname
        self.skip_offsets = skip_offsets
        self.track_progress = track_progress
        self.progress_every = progress_every

    def __call__(self, iterator):
        import itertools

        cluster_info, cluster_meta = self.cluster_info, self.cluster_meta
        feed_timeout, qname = self.feed_timeout, self.qname
        skip_offsets, track_progress = self.skip_offsets, self.track_progress
        progress_every = self.progress_every
        mgr = _get_manager(cluster_info, util.get_ip_address(), util.read_executor_id())
        state = manager.get_value(mgr, "state") or ""
        if "terminating" in state:
            # Late partitions are skipped fast once training asked to stop
            # (maps TFSparkNode.py:470-476).
            logger.info("node is terminating; skipping partition")
            count = sum(1 for _ in iterator)
            logger.info("skipped %d records", count)
            # Signal the driver that remaining feeding is pointless
            # (maps TFSparkNode.py:499-511).
            try:
                client = reservation.Client(cluster_meta["server_addr"])
                client.request_stop()
                client.close()
            except Exception:
                pass
            return

        q = mgr.get_queue(qname)
        equeue = mgr.get_queue("error")
        progress_fn = poll_cb = None
        client = None
        skip = 0
        if track_progress:
            head = next(iterator, None)
            if not (isinstance(head, tuple) and len(head) == 2
                    and head[0] == PROGRESS_HEADER):
                raise RuntimeError(
                    "track_progress feeder got an untagged partition "
                    "(cluster.train tags partitions when tracking)")
            pid = int(head[1])
            skip = int((skip_offsets or {}).get(pid, 0))
            if skip:
                logger.info("partition %d: skipping %d already-consumed "
                            "records (feed-offset resume)", pid, skip)
                consumed = sum(1 for _ in itertools.islice(iterator, skip))
                skip = consumed      # short partition: skip what exists
            progress_fn = lambda n: marker.Progress(pid, skip + n)  # noqa
            client = reservation.Client(cluster_meta["server_addr"],
                                        connect=False)
            last_sent = {}

            def poll_cb():
                got = manager.get_value(mgr, "feed_progress") or {}
                fresh = {p: o for p, o in got.items()
                         if o > last_sent.get(p, 0)}
                if fresh:
                    client.send_progress(fresh)
                    last_sent.update(fresh)

        count = _push_chunks(q, iterator, mgr=mgr, timeout=feed_timeout,
                             equeue=equeue, progress_fn=progress_fn,
                             progress_every=progress_every, poll_cb=poll_cb)
        logger.info("pushed %d records into %s queue", count, qname)

        _join_with_watchdog(q, equeue, feed_timeout, poll_cb=poll_cb)
        if client is not None:
            # join means every item was DEQUEUED, not that every record
            # was handed to the training fn (drained-but-unreturned
            # segments exist) — so the final report forwards the
            # consumer's own delivered-confirmed kv value, never
            # skip+count; an unconfirmed tail is re-fed next attempt
            # (bounded by one progress window)
            try:
                poll_cb()
            except Exception:
                logger.warning("final progress poll failed", exc_info=True)
            client.close()


def inference(cluster_info: Any, cluster_meta: Any,
              qname: str = "input") -> Callable:
    """Build the feeder/collector task for inference (maps
    TFSparkNode.inference, TFSparkNode.py:518-579).  Returns exactly one
    result per input record, per partition."""
    return _InferenceFeeder(cluster_info, cluster_meta, qname)


class _InferenceFeeder:
    """The feeder/collector task `inference` builds."""

    def __init__(self, cluster_info, cluster_meta, qname):
        self.cluster_info = cluster_info
        self.cluster_meta = cluster_meta
        self.qname = qname

    def __call__(self, iterator):
        cluster_info, qname = self.cluster_info, self.qname
        mgr = _get_manager(cluster_info, util.get_ip_address(), util.read_executor_id())
        q = mgr.get_queue(qname)
        equeue = mgr.get_queue("error")
        count = _push_chunks(q, iterator, mgr=mgr, equeue=equeue)
        q.put(marker.EndPartition())
        logger.info("pushed %d records (+EndPartition) into %s queue", count, qname)
        if count == 0:
            return iter([])

        _join_with_watchdog(q, equeue, timeout=600)

        # Drain exactly `count` results (maps TFSparkNode.py:567-577).
        out = mgr.get_queue("output")
        results = []
        while len(results) < count:
            results.append(out.get())
            out.task_done()
        logger.info("collected %d inference results", len(results))
        return iter(results)


def _peek_error(equeue):
    """Return the first queued error traceback without consuming it
    (get/task_done then re-put, the reference's peek/re-put trick that
    keeps the error visible to the shutdown path too,
    TFSparkNode.py:624-630), or None when the queue is empty."""
    if equeue.empty():
        return None
    tb = equeue.get()
    equeue.task_done()
    equeue.put(tb)
    return tb


def _join_with_watchdog(q, equeue, timeout, poll_cb=None):
    """queue.join() with error propagation + feed timeout (maps
    TFSparkNode.py:485-495).  ``poll_cb`` (feed-offset resume) runs every
    poll tick — most consumption happens while the feeder waits here, so
    this is where high-water marks actually reach the driver."""
    import threading

    joined = threading.Event()

    def _join():
        q.join()
        joined.set()

    t = threading.Thread(target=_join, daemon=True)
    t.start()
    deadline = time.time() + timeout
    while not joined.is_set():
        tb = _peek_error(equeue)
        if tb is not None:
            raise RuntimeError(f"training function failed:\n{tb}")
        if time.time() > deadline:
            raise TimeoutError(
                f"data feed not consumed within {timeout}s — the training "
                f"process is likely dead or stuck")
        if poll_cb is not None:
            try:
                poll_cb()
            except Exception:
                logger.warning("progress poll failed", exc_info=True)
        joined.wait(0.5)


def shutdown(cluster_info: Any, queues: Any = ("input",),
             grace_secs: float = 0) -> Callable:
    """Build the per-executor shutdown task (maps TFSparkNode.shutdown,
    TFSparkNode.py:582-636): push end-of-feed sentinels, wait out the grace
    period (chief may still be exporting), surface late errors, mark stopped."""
    return _Shutdown(cluster_info, tuple(queues), grace_secs)


class _Shutdown:
    """The shutdown task `shutdown` builds."""

    def __init__(self, cluster_info, queues, grace_secs):
        self.cluster_info = cluster_info
        self.queues = queues
        self.grace_secs = grace_secs

    def __call__(self, iterator):
        cluster_info, queues = self.cluster_info, self.queues
        grace_secs = self.grace_secs
        for _ in iterator:
            pass
        mgr = _get_manager(cluster_info, util.get_ip_address(), util.read_executor_id())
        for qname in queues:
            try:
                mgr.get_queue(qname).put(None)
            except Exception:
                logger.warning("could not push sentinel into %s", qname)
        if grace_secs:
            time.sleep(grace_secs)
        # Late-error surfacing (maps TFSparkNode.py:624-630): leave the
        # error visible for other shutdown paths while still raising here.
        late_error = _peek_error(mgr.get_queue("error"))
        # The ring name is removed here (mappings survive on POSIX, so a
        # consumer still draining is unaffected; the creator's atexit
        # unlink is then a no-op).
        try:
            info = shm.discover(mgr)
            if info:
                shm.ShmChunkRing.unlink_by_name(info["name"])
            shm.remove_advertisement()
        except Exception:
            pass
        # Marking 'stopped' is the manager's death warrant: the executor's
        # bootstrap process waits for this state, then stops the manager and
        # exits (backend._bootstrap_trampoline) — the node process gets its
        # full grace window first.
        mgr.set("state", "stopped")
        if late_error is not None:
            raise RuntimeError(f"node failed after feeding completed:\n{late_error}")

