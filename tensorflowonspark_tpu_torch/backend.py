"""Executor substrate abstraction — counterpart of
``tensorflowonspark_tpu/backend.py``.

The reference is hard-wired to Spark: `TFCluster.run` does
`sc.parallelize(range(N), N).foreachPartition(...)` and feeders ride
`dataRDD.foreachPartition` (reference: TFCluster.py:297-334, :94).  This
framework factors that contract into a `Backend` interface with two
implementations:

- `SparkBackend` — thin wrappers over a live SparkContext: real pyspark's
  (which ships the task callables itself) or the port's `minispark`.
- `LocalBackend`  — N real OS processes, one per "executor", each pinned to
  its own working directory.  This is both the test substrate (the
  analog of the reference's 2-worker Spark standalone test cluster,
  tests/README.md:10) and a usable single-host runtime.

The contract every backend provides:
- `run_on_executors(fn, n)`  — launch the node-bootstrap task once per
  executor, asynchronously; `fn` receives an iterator yielding the executor id.
- `foreach_partition(partitions, fn)` — run `fn(iter(partition))` for each
  partition, routed so partition i lands on executor i % n (feeders must land
  where a node's queue manager lives — the executor-id-file discovery trick,
  reference: util.py:77-94).
- `map_partitions(partitions, fn)` — same, collecting each call's result list.
- `check_shippable(fn)` — raise in the driver, before any process starts,
  when `fn` cannot reach an executor.

CUDA and the start method.  A process forked after its parent initialised
CUDA cannot use CUDA ("Cannot re-initialize CUDA in forked subprocess").
So a driver that holds CUDA — one that has run anything on the card —
starts its executors with ``LocalBackend(n, start_method="spawn")``; a
``fork``-started backend refuses to fork from such a driver, with an
error that says so, rather than leave the node to fail (or run somewhere
slower) later.  The executor bootstrap itself never touches CUDA
(`gpu_info` counts GPUs through the driver's files; `node`, `feed` and
`reservation` import no ``torch``), so the background node process,
forked from the executor, may initialise CUDA itself.

Callables and the start method.  This package has no cloudpickle.  Under
``fork`` task callables cross as the objects themselves, so any callable
works.  Under ``spawn`` they cross through the standard pickler, which
sends a function by reference: a user's ``map_fun`` must be importable —
a module-level function, which includes one in a ``__main__`` script
whose launch sits under ``if __name__ == "__main__"``.  A closure or a
lambda under spawn raises `TypeError` in the driver (`check_shippable`).
The runtime's own task callables (`node.run`, `node.train`, ...) are
instances of module-level classes, so they always ship.
"""
import logging
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import tempfile
import threading
import time
import traceback

from . import util

logger = logging.getLogger(__name__)


class Backend:
    """Interface; see module docstring."""

    @property
    def num_executors(self):
        raise NotImplementedError

    def run_on_executors(self, fn, n):
        raise NotImplementedError

    def foreach_partition(self, partitions, fn):
        raise NotImplementedError

    def map_partitions(self, partitions, fn):
        raise NotImplementedError

    def check_shippable(self, fn):
        """Raise in the driver when `fn` cannot reach an executor."""


_SPAWN_HINT = ("start executors with LocalBackend(n, start_method='spawn') "
               "from a driver that holds CUDA")


def refuse_fork_after_cuda(what, hint=_SPAWN_HINT):
    """Raise when this process has initialised CUDA: `what`, forked from
    it, could not use CUDA; `hint` says the way out."""
    if util.cuda_initialized():
        raise RuntimeError(
            f"cannot fork {what}: this process has initialised CUDA, and a "
            f"forked child cannot use CUDA; {hint}")


def check_picklable(fn):
    """Raise `TypeError` naming the spawn rule when `fn` does not pickle
    with the standard pickler (a closure, a lambda, or a function that
    its module does not define at top level)."""
    try:
        pickle.dumps(fn)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise TypeError(
            f"cannot ship {fn!r} to a spawn-started executor: under "
            f"start_method='spawn' task functions cross by reference through "
            f"the standard pickler, so map_fun must be a module-level "
            f"function (in a __main__ script, defined at top level with the "
            f"launch under `if __name__ == '__main__'`); closures and lambdas "
            f"cross only under start_method='fork' ({e})") from e


def _task_trampoline(fn, part, result_q, index, workdir, collect):
    """Child-process shim: chdir to the executor dir, run, ship result/error."""
    try:
        if workdir:
            os.chdir(workdir)
        out = fn(iter(part))
        if collect:
            result_q.put((index, "ok", list(out) if out is not None else []))
        else:
            # foreach: drain any generator for its side effects
            if out is not None:
                for _ in out:
                    pass
            result_q.put((index, "ok", None))
    except BaseException:
        result_q.put((index, "error", traceback.format_exc()))
        raise SystemExit(1)


def _bootstrap_trampoline(fn, executor_id, workdir, status_q, manager_linger=600):
    """Run a node bootstrap in its own process, then keep the executor alive
    while its node process and queue manager are needed — a stand-in for
    Spark's long-lived reused python-worker (reference precondition
    SPARK_REUSE_WORKER, TFSparkNode.py:393-395).

    Lifecycle: join the node process(es) first; then hold the queue manager
    open until the cluster-shutdown closure marks state 'stopped' (feeders
    and the shutdown path still need the queues after the node exits), with
    a linger timeout as a leak guard; then stop the manager and exit.
    """
    from . import manager as manager_mod

    # SIGTERM (cluster.abort / LocalBackend.terminate) must take the
    # queue-manager SERVER down too: BaseManager.start forks it as a
    # separate child process, which would otherwise outlive this executor
    # as an orphan holding the manager port (and every inherited fd)
    import signal as signal_mod

    def _on_term(_signum, _frame):
        # children FIRST (the background node process — a grandchild
        # nothing else tracks; left alive it would keep training and
        # writing checkpoints into a relaunched attempt's resume), then
        # the manager server, then exit.  Async-signal-LEAN: raw os.kill
        # on snapshot-able pids only — no joins (active_children() reaps,
        # which can deadlock if SIGTERM lands while the main thread holds
        # the process lock) and no manager RPCs (shutdown() does a full
        # connection round trip)
        import multiprocessing.process as mp_process

        try:
            children = list(getattr(mp_process, "_children", ()))
        except Exception:
            children = []
        pids = [getattr(c, "pid", None) for c in children]
        for m in manager_mod._started_managers:
            pids.append(getattr(getattr(m, "_process", None), "pid", None))
        for pid in pids:
            if pid:
                try:
                    os.kill(pid, signal_mod.SIGTERM)
                except OSError:
                    pass
        os._exit(143)

    try:
        signal_mod.signal(signal_mod.SIGTERM, _on_term)
    except ValueError:
        pass    # not the main thread (never the case here)
    try:
        os.chdir(workdir)
        fn(iter([executor_id]))
        status_q.put((executor_id, "ok", None))
        node_failed = False
        for child in mp.active_children():
            if child.name.startswith("QueueManager"):
                continue
            child.join()
            if child.exitcode not in (0, None):
                node_failed = True
                status_q.put((executor_id, "error",
                              f"node process {child.name} exited with "
                              f"code {child.exitcode}"))
        deadline = time.time() + manager_linger
        for mgr in manager_mod._started_managers:
            while time.time() < deadline:
                try:
                    state = manager_mod.get_value(mgr, "state")
                except Exception:
                    break  # server already gone
                if state == "stopped":
                    break
                time.sleep(0.5)
            try:
                mgr.shutdown()
            except Exception:
                pass
        if node_failed:
            raise SystemExit(1)
    except SystemExit:
        raise
    except BaseException:
        status_q.put((executor_id, "error", traceback.format_exc()))
        raise SystemExit(1)


class LocalBackend(Backend):
    """N-process local executor pool with per-executor working directories.

    Defaults to ``start_method="fork"`` — cheap for the CPU tests, which
    start dozens of short-lived executors.  A driver that holds CUDA (or a
    long-lived multithreaded driver, given the fork-after-threads hazard)
    passes ``start_method="spawn"``; see the module docstring for what
    each start method asks of the task callables, and why a fork-started
    backend refuses a driver that initialised CUDA.
    """

    def __init__(self, num_executors, workdir=None, start_method="fork"):
        self._n = num_executors
        self._start_method = start_method
        self._ctx = mp.get_context(start_method)
        self._root = workdir or tempfile.mkdtemp(prefix="tfos-gpu-local-")
        self._dirs = []
        for i in range(num_executors):
            d = os.path.join(self._root, f"executor-{i}")
            os.makedirs(d, exist_ok=True)
            self._dirs.append(d)
        self._bootstrap_procs = []
        self._status_q = self._ctx.Queue()

    @property
    def num_executors(self):
        return self._n

    @property
    def executor_dirs(self):
        return list(self._dirs)

    def check_shippable(self, fn):
        """The start method's check: fork refuses a driver that holds
        CUDA, spawn a fn that does not pickle."""
        if self._start_method == "fork":
            refuse_fork_after_cuda("an executor")
        else:
            check_picklable(fn)

    def run_on_executors(self, fn, n):
        assert n == self._n, f"backend has {self._n} executors, asked for {n}"
        self.check_shippable(fn)
        for i in range(n):
            p = self._ctx.Process(
                target=_bootstrap_trampoline,
                args=(fn, i, self._dirs[i], self._status_q),
                name=f"executor-{i}",
            )
            p.start()
            self._bootstrap_procs.append(p)

    def check_bootstrap_errors(self):
        """Non-blocking: return the first bootstrap error traceback, if any."""
        try:
            while True:
                _, kind, payload = self._status_q.get_nowait()
                if kind == "error":
                    return payload
        except queue_mod.Empty:
            return None

    def _run_tasks(self, partitions, fn, collect, timeout=None):
        """Run one task per partition: partitions for different executors run
        concurrently; multiple partitions routed to the SAME executor run
        sequentially.  Serialization per executor matters for correctness —
        Spark schedules one task per executor core (the reference's test
        cluster pins 1 core/executor, tox.ini:33-34), and concurrent feeders
        would interleave records on one queue, breaking the EndPartition
        1:1-result accounting."""
        parts = list(partitions)
        result_q = self._ctx.Queue()
        by_exec = {}
        for i, part in enumerate(parts):
            by_exec.setdefault(i % self._n, []).append((i, list(part)))

        live_procs = []
        cancelled = threading.Event()
        # terminate() reaps in-flight tasks AND stops the serial runners
        # from spawning the next queued one
        self._live_task_procs = live_procs
        self._tasks_cancelled = cancelled
        self.check_shippable(fn)

        def _run_serial(eid, tasks):
            for index, part in tasks:
                if cancelled.is_set():
                    return
                p = self._ctx.Process(
                    target=_task_trampoline,
                    args=(fn, part, result_q, index, self._dirs[eid],
                          collect),
                    name=f"task-{index}",
                )
                p.start()
                live_procs.append(p)
                if cancelled.is_set():
                    # closes the cancel/start race: terminate() set the
                    # event and swept live_procs while we were between
                    # the loop check and p.start()
                    p.terminate()
                p.join()

        # daemon: the normal path joins these explicitly below, but an
        # abandoned run (cluster.abort mid-task, driver exception) must
        # not leave a non-daemon runner blocking interpreter shutdown
        threads = [threading.Thread(target=_run_serial, args=(eid, tasks),
                                    daemon=True)
                   for eid, tasks in by_exec.items()]
        for t in threads:
            t.start()
        results = [None] * len(parts)
        errors = []
        seen = 0
        deadline = None if timeout is None else time.time() + timeout
        while seen < len(parts):
            try:
                index, kind, payload = result_q.get(timeout=1)
            except queue_mod.Empty:
                if deadline is not None and time.time() > deadline:
                    # Bound the teardown: kill wedged task processes so the
                    # caller's timeout contract holds (the reference used
                    # SIGALRM on the driver, TFCluster.py:136-144).
                    cancelled.set()
                    for p in live_procs:
                        if p.is_alive():
                            p.terminate()
                    errors.append((-1, f"tasks exceeded {timeout}s timeout"))
                    break
                if not any(t.is_alive() for t in threads):
                    errors.append((-1, "task process died without reporting "
                                       "(killed or crashed hard)"))
                    break
                continue
            seen += 1
            if kind == "error":
                errors.append((index, payload))
            else:
                results[index] = payload
        for t in threads:
            t.join()
        if errors:
            errors.sort()
            index, tb = errors[0]
            raise RuntimeError(f"task {index} failed:\n{tb}")
        return results

    def foreach_partition(self, partitions, fn, timeout=None):
        self._run_tasks(partitions, fn, collect=False, timeout=timeout)

    def map_partitions(self, partitions, fn):
        nested = self._run_tasks(partitions, fn, collect=True)
        return [item for part in nested if part for item in part]

    def join(self, timeout=None):
        """Wait for all bootstrap (executor) processes to exit."""
        for p in self._bootstrap_procs:
            p.join(timeout)

    def terminate(self):
        # bootstraps AND in-flight task processes: a forceful teardown
        # (cluster.abort) must leave no children for multiprocessing's
        # atexit to join forever.  Cancel FIRST so the serial runner
        # threads don't spawn the next queued task after the kill.
        ev = getattr(self, "_tasks_cancelled", None)
        if ev is not None:
            ev.set()
        procs = list(self._bootstrap_procs) + list(
            getattr(self, "_live_task_procs", []))
        for p in procs:
            if p.is_alive():
                p.terminate()
        # SIGKILL escalation: a SIGTERM handler wedged on a lock (or a
        # process mid-fork) must not survive teardown
        deadline = time.time() + 5.0
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.time()))
            if p.is_alive():
                p.kill()


class _PartitionLists:
    """A record-iterator task for an RDD whose ELEMENTS are partition
    lists (the shape `parallelize(list_of_partitions)` produces): unwraps
    one level so `fn` still sees records.  A module-level class, so the
    task ships through the standard pickler."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, element_iter):
        for part in element_iter:
            out = self.fn(iter(part))
            if out is not None:
                yield from out


class SparkBackend(Backend):
    """Backend over a live SparkContext: real pyspark's, or the port's
    `minispark` (which ships tasks through the standard pickler).

    Maps the reference's direct Spark calls: node bootstrap via
    `sc.parallelize(range(n), n).foreachPartition` on a daemon thread
    (reference: TFCluster.py:297-334), feeding via RDD.foreachPartition, and
    inference via RDD.mapPartitions (reference: TFCluster.py:94,:115).
    """

    def __init__(self, sc):
        self._sc = sc
        self._errors = queue_mod.Queue()

    @property
    def num_executors(self):
        return int(self._sc.defaultParallelism)

    @property
    def spark_context(self):
        return self._sc

    def check_shippable(self, fn):
        """The port's minispark ships tasks through the standard pickler:
        refuse a closure here, in the driver (real pyspark ships it)."""
        from . import minispark

        if isinstance(self._sc, minispark.SparkContext):
            check_picklable(fn)

    def run_on_executors(self, fn, n):
        node_rdd = self._sc.parallelize(range(n), n)
        t = threading.Thread(target=self._bootstrap, args=(node_rdd, fn),
                             daemon=True)
        t.start()

    def _bootstrap(self, node_rdd, fn):
        # a failed bootstrap task (a NATIVE-mode node's error, a refused
        # fork) reaches the driver through check_bootstrap_errors
        try:
            node_rdd.foreachPartition(fn)
        except BaseException:
            self._errors.put(traceback.format_exc())

    def check_bootstrap_errors(self):
        """Non-blocking: the first bootstrap task failure, if any."""
        try:
            return self._errors.get_nowait()
        except queue_mod.Empty:
            return None

    def _as_rdd(self, partitions, fn):
        """(rdd, task) for either a real RDD (`fn` as it is) or a list of
        partition lists (one element a partition, `fn` unwrapping it).
        Materializes generators exactly once so nothing is silently
        consumed before parallelize."""
        if hasattr(partitions, "foreachPartition"):
            return partitions, fn
        parts = [list(p) for p in partitions]
        return (self._sc.parallelize(parts, max(len(parts), 1)),
                _PartitionLists(fn))

    def foreach_partition(self, partitions, fn, timeout=None):
        rdd, task = self._as_rdd(partitions, fn)
        rdd.foreachPartition(task)

    def map_partitions(self, partitions, fn):
        rdd, task = self._as_rdd(partitions, fn)
        return rdd.mapPartitions(task)  # lazy RDD, like the reference


def resolve(backend_or_sc):
    """Accept a Backend, or duck-typed SparkContext, and return a Backend."""
    if isinstance(backend_or_sc, Backend):
        return backend_or_sc
    if hasattr(backend_or_sc, "parallelize"):
        return SparkBackend(backend_or_sc)
    raise TypeError(f"cannot build an executor backend from {type(backend_or_sc)!r}")
