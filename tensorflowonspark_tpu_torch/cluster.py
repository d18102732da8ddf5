"""Cluster lifecycle API — counterpart of ``tensorflowonspark_tpu/
cluster.py`` (maps reference TFCluster.py:40-383).

`run()` turns N executors (Spark or local processes) into a training
cluster — one node process per executor, joined by ``torch.distributed``
when the map_fun asks (`node.NodeContext.init_distributed`); the returned
`GPUCluster` feeds it (`train`), queries it (`inference`), and tears it
down (`shutdown`) with the reference's semantics: epochs-via-repetition,
feed timeouts, grace periods, error propagation that aborts the whole
job, and a duplicate-registration sanity check.  A driver that holds
CUDA starts its executors with ``LocalBackend(n, start_method="spawn")``
and a module-level map_fun (see `backend`).
"""
import logging
from typing import Any, Dict, Optional
import random
import threading
import time

from . import backend as backend_mod
from . import node, reservation

logger = logging.getLogger(__name__)


class InputMode:
    """How the training fn receives data (maps TFCluster.py:43-46).

    NATIVE: the fn reads its own data (tf.data/grain/files) — the
    reference called this InputMode.TENSORFLOW; the alias is kept for
    migration.
    SPARK: partitions are pushed from the data layer through DataFeed.
    """
    NATIVE = 0
    TENSORFLOW = 0  # migration alias
    SPARK = 1


class _StatusView(dict):
    """Driver-side error status that also surfaces executor bootstrap
    failures (reported through the backend's status channel) into
    `await_reservations`'s polling loop, so a node that dies before it can
    reach the rendezvous server aborts the launch immediately instead of
    burning the whole reservation timeout."""

    def __init__(self, backend):
        super().__init__(error=None)
        self._backend = backend
        self._parts = []  # every error message seen, in arrival order
        self._lock = threading.Lock()  # launch thread + driver thread write
        self.server = None  # set once the rendezvous server exists

    def _add_part(self, value):
        with self._lock:
            if value and value not in self._parts:
                self._parts.append(value)
            super().__setitem__("error", "; ".join(self._parts) or None)

    def __setitem__(self, key, value):
        if key == "error":
            self._add_part(value)
        else:
            super().__setitem__(key, value)

    def _refresh(self):
        # Accumulate, don't cache-first-wins: a node that is SIGKILLed
        # produces BOTH a backend exit-code error and (later) a heartbeat-
        # lost error from the monitor; the driver should see both.  The
        # backend status queue is consumed on read, so messages are folded
        # into _parts rather than re-polled.
        if hasattr(self._backend, "check_bootstrap_errors"):
            self._add_part(self._backend.check_bootstrap_errors())
        if self.server is not None:
            for e in self.server.reservations.get_errors():
                self._add_part(e.get("error", str(e)))

    def get(self, key, default=None):
        if key == "error":
            self._refresh()
        return super().get(key, default)

    def __getitem__(self, key):
        if key == "error":
            self._refresh()
        return super().__getitem__(key)


class GPUCluster:
    """Handle to a running cluster (maps the TFCluster object, TFCluster.py:48-212)."""

    sc = None
    meta = None
    server = None
    cluster_info = None
    cluster_meta = None
    input_mode = None
    queues = None
    _backend = None
    _status = None

    def train(self, data_partitions: Any, num_epochs: int = 1,
              feed_timeout: float = 600, qname: str = "input",
              skip_offsets: Optional[Dict[int, int]] = None,
              track_progress: bool = False,
              progress_every: int = 512) -> None:
        """Feed partitions to the cluster (maps TFCluster.train, TFCluster.py:63-94).

        `data_partitions` is an RDD (Spark backend) or a list of record lists.
        Epochs repeat the data, like the reference's RDD union.

        ``track_progress`` (feed-offset resume, used by `run_elastic`):
        partitions are tagged with their index (post-epoch-expansion, so
        ids are unique across epochs), feeders interleave
        consumption-confirmed checkpoints every ``progress_every``
        records and report high-water marks to the reservation server;
        ``skip_offsets`` ({partition id: consumed offset}, from a failed
        attempt's `Server.progress_snapshot`) makes each feeder skip the
        records a previous attempt already delivered.
        """
        assert self.input_mode == InputMode.SPARK, "train() requires InputMode.SPARK"
        logger.info("feeding training data (epochs=%d)", max(num_epochs, 1))
        parts = data_partitions
        if num_epochs > 1:
            if hasattr(parts, "union"):  # RDD path, like sc.union([rdd]*epochs)
                repeated = parts
                for _ in range(num_epochs - 1):
                    repeated = repeated.union(parts)
                parts = repeated
            else:
                parts = [p for _ in range(num_epochs) for p in parts]
        if track_progress:
            # tag AFTER epoch expansion: union renumbers partitions
            # 0..N*epochs-1, so every fed partition id is unique
            if hasattr(parts, "mapPartitionsWithIndex"):
                import itertools
                header = node.PROGRESS_HEADER

                def _tag(i, it):
                    return itertools.chain([(header, i)], it)

                parts = parts.mapPartitionsWithIndex(_tag)
            else:
                parts = [[(node.PROGRESS_HEADER, i)] + list(p)
                         for i, p in enumerate(parts)]
        self._check_driver_error()
        self._backend.foreach_partition(
            parts, node.train(self.cluster_info, self.cluster_meta,
                              feed_timeout=feed_timeout, qname=qname,
                              skip_offsets=skip_offsets,
                              track_progress=track_progress,
                              progress_every=progress_every))

    def train_stream(self, stream: Any, feed_timeout: float = 600,
                     qname: str = "input") -> None:
        """Feed an unbounded stream of data (maps the reference's DStream
        support, TFCluster.py:83-85 + the streaming example
        examples/mnist/estimator/mnist_spark_streaming.py).

        `stream` is either a pyspark DStream (fed via foreachRDD) or any
        iterable yielding *batches* — each batch a list of partitions (or an
        RDD).  Feeding stops when the stream ends or when a STOP message
        reaches the reservation server (`stop_requested()`), which is what
        the stop-streaming CLI sends (reference:
        examples/utils/stop_streaming.py).
        """
        assert self.input_mode == InputMode.SPARK, "train_stream() requires InputMode.SPARK"
        feeder = node.train(self.cluster_info, self.cluster_meta,
                            feed_timeout=feed_timeout, qname=qname)
        if hasattr(stream, "foreachRDD"):  # pyspark DStream
            def _feed(rdd):
                if not self.stop_requested():
                    self._check_driver_error()
                    self._backend.foreach_partition(rdd, feeder)
            stream.foreachRDD(lambda _time, rdd: _feed(rdd))
            return
        for batch in stream:
            if self.stop_requested():
                logger.info("stop requested; ending stream feed")
                break
            self._check_driver_error()
            self._backend.foreach_partition(batch, feeder)

    def stop_requested(self) -> bool:
        """True once a STOP message reached the reservation server (the
        streaming-job termination signal, reference: reservation.py:141-144)."""
        return self.server.done.is_set()

    def inference(self, data_partitions: Any,
                  qname: str = "input") -> list:
        """Run distributed inference over partitions, returning results
        (maps TFCluster.inference, TFCluster.py:96-115)."""
        assert self.input_mode == InputMode.SPARK, "inference() requires InputMode.SPARK"
        self._check_driver_error()
        return self._backend.map_partitions(
            data_partitions, node.inference(self.cluster_info, self.cluster_meta,
                                            qname=qname))

    def shutdown(self, ssc: Any = None, grace_secs: float = 0,
                 timeout: float = 259200) -> None:
        """Stop the cluster (maps TFCluster.shutdown, TFCluster.py:117-205).

        Pushes end-of-feed sentinels to every worker, waits out grace_secs
        (the chief may still be exporting a model), surfaces any node errors
        as an exception on the driver, then stops the reservation server.
        `timeout` bounds the whole teardown (reference used SIGALRM; we use a
        watchdog thread so it also works off the main thread).  `ssc` is an
        optional streaming context, stopped gracefully first (maps
        TFCluster.py:147-153).
        """
        logger.info("shutting down cluster")
        watchdog = threading.Timer(timeout, lambda: (
            logger.error("cluster shutdown timed out after %ds", timeout),
            self._backend.terminate() if hasattr(self._backend, "terminate") else None))
        watchdog.daemon = True
        watchdog.start()
        try:
            if ssc is not None:
                ssc.stop(stopSparkContext=False, stopGraceFully=True)
            workers = [eid for j in ("chief", "worker")
                       for eid in self.cluster_meta["cluster_template"].get(j, [])]
            shutdown_parts = [[eid] for eid in sorted(workers)]
            kwargs = {}
            if isinstance(self._backend, backend_mod.LocalBackend):
                kwargs["timeout"] = timeout  # hard bound on wedged teardown
            self._backend.foreach_partition(
                shutdown_parts,
                node.shutdown(self.cluster_info, queues=self.queues_to_close,
                              grace_secs=grace_secs), **kwargs)
            self._check_driver_error()
            # Before stopping evaluators, wait until every TRAINING node
            # announced its normal exit (BYE) — the evaluator exists to
            # score checkpoints the trainers are still writing (maps the
            # reference's statusTracker poll until only ps/eval tasks
            # remain, TFCluster.py:154-169).  Bounded by `timeout` via the
            # watchdog; node failures surface through the error channel.
            has_eval = any(n["job_name"] == "evaluator"
                           for n in self.cluster_info)
            if has_eval:
                training = {n["executor_id"] for n in self.cluster_info
                            if n["job_name"] in ("chief", "worker")}
                deadline = time.time() + timeout
                while not training <= self.server.finished_ids():
                    self._check_driver_error()
                    if time.time() > deadline:
                        logger.warning(
                            "training nodes %s never announced exit; "
                            "stopping evaluator anyway",
                            sorted(training - self.server.finished_ids()))
                        break
                    time.sleep(0.5)
            # Evaluator nodes run remote-mode managers so the driver can push
            # their stop sentinel directly (maps TFCluster.py:186-194); then
            # mark them 'stopped' so their bootstrap releases the manager.
            from . import manager as manager_mod
            for n in self.cluster_info:
                if n["job_name"] == "evaluator":
                    mgr = manager_mod.connect(tuple(n["addr"]), n["authkey"])
                    for qname in ("control", "input"):
                        try:
                            mgr.get_queue(qname).put(None)
                        except Exception:
                            pass  # user configured a custom queue set
                    mgr.set("state", "stopped")
        finally:
            watchdog.cancel()
            self.server.stop()
        if isinstance(self._backend, backend_mod.LocalBackend):
            self._backend.join(timeout=60)
            err = self._backend.check_bootstrap_errors()
            if err:
                raise RuntimeError(f"node failed during run:\n{err}")

    def tensorboard_url(self) -> Optional[str]:
        """URL of the chief's profiler/TensorBoard endpoint, if enabled
        (maps TFCluster.tensorboard_url, TFCluster.py:207-212)."""
        for n in self.cluster_info:
            if n.get("tb_port"):
                return f"http://{n['host']}:{n['tb_port']}"
        return None

    def abort(self) -> None:
        """Forceful teardown after a node failure: kill executors, stop
        the rendezvous server, best-effort-close every node manager.
        Unlike `shutdown`, never raises — it exists so `run_elastic` can
        clear the ground for a relaunch."""
        logger.warning("aborting cluster (forceful teardown)")
        from . import manager as manager_mod

        def _stop_manager(n):
            try:
                mgr = manager_mod.connect(tuple(n["addr"]), n["authkey"])
                mgr.set("state", "stopped")
            except Exception:
                pass                     # dead node: nothing to stop

        # bounded per node via daemon threads: a preempted host
        # blackholing SYNs must not stall the relaunch for the kernel's
        # ~130 s connect timeout (times N hosts, serially)
        stoppers = []
        for n in self.cluster_info or []:
            t = threading.Thread(target=_stop_manager, args=(n,),
                                 daemon=True)
            t.start()
            stoppers.append(t)
        for t in stoppers:
            t.join(timeout=5)
        try:
            if hasattr(self._backend, "terminate"):
                self._backend.terminate()
            if hasattr(self._backend, "join"):
                self._backend.join(timeout=10)   # bounded reap
        except Exception:
            pass
        try:
            self.server.stop()
        except Exception:
            pass

    def _check_driver_error(self):
        err = self._status.get("error")  # _StatusView folds in backend errors
        if err:
            raise RuntimeError(f"cluster failed:\n{err}")


# the JAX package's name for the handle
TPUCluster = GPUCluster


def run(backend_or_sc: Any, map_fun: Any, tf_args: Any = None,
        num_executors: Optional[int] = None, num_ps: int = 0,
        tensorboard=False, input_mode=InputMode.NATIVE, log_dir=None,
        master_node="chief", reservation_timeout=600,
        queues=("input", "output", "error", "control"), eval_node=False,
        num_chips=0, default_fs="file://", heartbeat_timeout=60):
    """Start a cluster (maps TFCluster.run, TFCluster.py:215-383).

    ``num_chips`` is the number of GPUs each executor takes
    (``CUDA_VISIBLE_DEVICES``, `gpu_info.assign_chips`; 0 leaves the
    visible set alone).  Raises `TypeError` before any process starts
    when the backend cannot ship `map_fun` (a closure under spawn).
    Returns a `GPUCluster` once every node has registered.
    """
    backend = backend_mod.resolve(backend_or_sc)
    num_executors = num_executors or backend.num_executors

    # Role template {job_name: [executor ids]} (maps TFCluster.py:255-270).
    # PS-style async has no analog here: schedule would-be PS nodes as
    # extra synchronous workers (intentional divergence, SURVEY.md §2.3).
    if num_ps:
        logger.warning(
            "num_ps=%d requested, but parameter-server async training is not "
            "supported; scheduling them as synchronous data-parallel workers "
            "(gradient exchange rides torch.distributed all_reduce)", num_ps)
    executors = list(range(num_executors))
    cluster_template = {"chief": [executors[0]]}  # master_node accepted for
    # reference-API compatibility; the role is always named 'chief' here.
    if eval_node:
        assert num_executors >= 2, "eval_node requires at least 2 executors"
        cluster_template["evaluator"] = [executors[-1]]
        workers = executors[1:-1]
    else:
        workers = executors[1:]
    if workers:
        cluster_template["worker"] = workers
    logger.info("cluster template: %s", cluster_template)

    server = reservation.Server(num_executors)

    cluster_meta = {
        "cluster_id": f"{int(time.time())}-{random.randint(0, 1 << 30)}",
        "cluster_template": cluster_template,
        "num_executors": num_executors,
        "server_addr": None,            # set once the server listens
        "default_fs": default_fs,
        "num_chips": num_chips,
        "reservation_timeout": reservation_timeout,
        # Beat 4x per monitor window so one dropped beat can't trip the
        # monitor; 0 disables beating entirely when the monitor is off.
        "heartbeat_interval": heartbeat_timeout / 4.0 if heartbeat_timeout else 0,
    }

    status = _StatusView(backend)
    background = input_mode == InputMode.SPARK
    bootstrap = node.run(map_fun, tf_args, cluster_meta,
                         tensorboard=tensorboard, log_dir=log_dir,
                         queues=queues, background=background)
    # before the server and any process start: a map_fun that cannot
    # reach the executors (a closure under spawn) fails here, typed
    backend.check_shippable(bootstrap)
    cluster_meta["server_addr"] = list(server.start())

    def _launch():
        try:
            backend.run_on_executors(bootstrap, num_executors)
        except Exception as e:  # surfaced to await_reservations via status
            logger.exception("cluster launch failed")
            status["error"] = str(e)

    t = threading.Thread(target=_launch, name="cluster-launch", daemon=True)
    t.start()

    try:
        cluster_info = server.await_reservations(
            timeout=reservation_timeout, status=status)

        # Duplicate (host, executor_id) detection (maps TFCluster.py:355-370):
        # a task retry that re-bootstrapped would corrupt feed routing.
        seen = set()
        for n in cluster_info:
            key = (n["host"], n["executor_id"])
            if key in seen:
                raise RuntimeError(f"duplicate node registered for {key}")
            seen.add(key)
    except BaseException:
        # a failed LAUNCH must not leak the rendezvous server or live
        # executor processes (run_elastic retries; the hung-at-exit
        # alternative is multiprocessing's atexit joining orphans forever)
        try:
            server.stop()
        except Exception:
            pass
        try:
            if hasattr(backend, "terminate"):
                backend.terminate()
        except Exception:
            pass
        raise

    # Failure detection (net-new, SURVEY.md §5): nodes heartbeat to the
    # rendezvous server; the monitor turns silence into a cluster error the
    # driver surfaces on its next train/inference/shutdown call.
    status.server = server
    if heartbeat_timeout:
        server.start_monitor(
            heartbeat_timeout,
            expected=[n["executor_id"] for n in cluster_info])

    cluster = GPUCluster()
    cluster.server = server
    cluster.cluster_info = cluster_info
    cluster.cluster_meta = cluster_meta
    cluster.input_mode = input_mode
    cluster.queues_to_close = [q for q in queues if q in ("input",)]
    cluster._backend = backend
    cluster._status = status
    logger.info("cluster is running: %d nodes", len(cluster_info))
    return cluster


def run_elastic(backend_factory: Any, map_fun: Any, tf_args: Any = None,
                *, train_data: Any = None, num_epochs: int = 1,
                feed_timeout: float = 600, grace_secs: float = 0,
                max_restarts: int = 2, restart_backoff: float = 2.0,
                **run_kwargs: Any) -> None:
    """Run a cluster end-to-end (launch -> feed -> shutdown) with
    automatic RELAUNCH on node failure — the elasticity the reference's
    fixed-size cluster never had (SURVEY.md §5 "no elasticity"), built
    from the parts that already exist: the heartbeat monitor turns a
    SIGKILLed/preempted node into a driver-visible error, and the
    checkpoint layer (utils.checkpoint + a resume-capable ``map_fun``)
    turns a relaunch into a continuation instead of a restart.

    ``backend_factory`` — a zero-arg callable returning a FRESH backend
    per attempt (LocalBackend executor pools do not survive terminate()),
    or a live SparkContext / backend instance to reuse across attempts.
    Teardown strength differs by backend: LocalBackend attempts are
    killed outright; a Spark backend has no executor-kill hook, so a
    surviving node on an aborted attempt exits when its manager is
    marked stopped (abort broadcasts that, bounded at 5 s/node) or at
    its next feed timeout — size ``feed_timeout`` accordingly.

    ``train_data`` — partitions/RDD fed via ``cluster.train`` each
    attempt (InputMode.SPARK).  Delivery across restarts is
    AT-LEAST-ONCE with a BOUNDED duplicate window (feed-offset resume):
    feeders interleave consumption-confirmed checkpoints every
    ``progress_every`` records and report per-partition high-water marks
    to the driver's reservation server; a relaunch skips the records a
    previous attempt already consumed, so duplicates are limited to
    ~one progress window per in-flight partition (plus anything consumed
    after the last driver-side report — reports ride the feeder's 0.5 s
    watchdog poll).  The training fn must still resume model state from
    its checkpoint (step counters and loss continue).
    ``train_data=None`` runs NATIVE mode: nodes read their own
    (resumable) input.

    Raises after ``max_restarts`` failed relaunches.
    """
    input_mode = run_kwargs.pop(
        "input_mode",
        InputMode.SPARK if train_data is not None else InputMode.NATIVE)
    progress_every = run_kwargs.pop("progress_every", 512)
    attempt = 0
    consumed = {}          # partition id -> high-water mark across attempts
    while True:
        backend = backend_factory() if callable(backend_factory) \
            else backend_factory
        c = None
        try:
            c = run(backend, map_fun, tf_args, input_mode=input_mode,
                    **run_kwargs)
            if train_data is not None:
                c.train(train_data, num_epochs=num_epochs,
                        feed_timeout=feed_timeout, track_progress=True,
                        skip_offsets=dict(consumed),
                        progress_every=progress_every)
            c.shutdown(grace_secs=grace_secs)
            return
        except Exception as e:
            attempt += 1
            logger.warning("cluster attempt %d failed: %s", attempt, e)
            if c is not None:
                try:
                    for pid, off in c.server.progress_snapshot().items():
                        consumed[pid] = max(consumed.get(pid, 0), off)
                except Exception:
                    logger.warning("could not read feed progress",
                                   exc_info=True)
                c.abort()
            if attempt > max_restarts:
                raise
            if consumed:
                logger.info("relaunch will skip consumed records: %s",
                            consumed)
            time.sleep(restart_backoff)
