"""Persistent executor worker pool for minispark — counterpart of the JAX
package's ``minispark/executor.py``.

Mirrors the process model the framework's Spark integration depends on
(and the reference assumed via SPARK_REUSE_WORKER, reference:
TFSparkNode.py:393-395): each "executor" is ONE long-lived OS process
with a stable working directory that runs its tasks sequentially.  A
node bootstrap task can therefore start the queue manager and the
background node process and return, and later feeder/shutdown tasks land
in the SAME process, where the executor-id file and the manager's
children are still alive.

Tasks cross to the executors through the standard pickler (this package
has no cloudpickle), which sends a function by reference: every task
callable must be importable — a module-level function, or an instance of
a module-level class (minispark builds its own lineage from such
classes).  Every task of an action is pickled in the driver before the
first one is sent, so a closure or a lambda raises `TypeError` there and
no task starts.  Results ride a single result queue that a driver-side
dispatcher thread routes back to the submitting action, so concurrent
actions (e.g. a bootstrap foreachPartition on a daemon thread while the
driver feeds partitions) never steal each other's results.
"""
import itertools
import logging
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import tempfile
import threading
import traceback

logger = logging.getLogger(__name__)


def dumps_task(task):
    """Pickle one task with the standard pickler; a callable that does not
    pickle (a closure, a lambda, a nested function) raises `TypeError`
    saying what a task callable must be."""
    try:
        return pickle.dumps(task)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise TypeError(
            f"cannot ship a minispark task: tasks cross to the executors "
            f"through the standard pickler, which sends functions by "
            f"reference, so task functions must be module-level functions "
            f"(or instances of module-level classes); closures and lambdas "
            f"do not ship ({e})") from e


def _worker_main(index, workdir, task_q, result_q):
    os.chdir(workdir)
    while True:
        try:
            item = task_q.get()
        except KeyboardInterrupt:
            break          # Ctrl-C must actually stop the pool
        if item is None:
            break
        task_id, blob = item
        try:
            fn, data, collect = pickle.loads(blob)
            out = fn(iter(data))
            if collect:
                result_q.put((task_id, "ok", list(out) if out is not None
                              else []))
            else:
                if out is not None:   # drain generators for side effects
                    for _ in out:
                        pass
                result_q.put((task_id, "ok", None))
        except KeyboardInterrupt:
            result_q.put((task_id, "error", "KeyboardInterrupt"))
            break
        except BaseException:
            # report and KEEP SERVING: the executor (and the node/manager
            # processes it hosts) must survive a failed task, like a real
            # Spark executor surviving a task failure
            result_q.put((task_id, "error", traceback.format_exc()))


class ExecutorPool:
    """N persistent executor processes with stable workdirs."""

    def __init__(self, num_executors, root=None, start_method="spawn"):
        # spawn by default: a spawned executor starts without the driver's
        # threads, its imported torch or its CUDA context, so the node
        # process it forks may initialise CUDA itself.  'fork' starts
        # faster (the CPU tests use it); a forked executor inherits the
        # driver's modules, so it must not run torch ops on a thread pool
        # the driver already started.
        self._n = num_executors
        self._ctx = mp.get_context(start_method)
        self._root = root or tempfile.mkdtemp(prefix="minispark-")
        self._task_qs = []
        self._result_q = self._ctx.Queue()
        self._workers = []
        self._pending = {}
        self._pending_lock = threading.Lock()
        self._ids = itertools.count()
        self._stopped = False
        for i in range(num_executors):
            workdir = os.path.join(self._root, f"executor-{i}")
            os.makedirs(workdir, exist_ok=True)
            tq = self._ctx.Queue()
            w = self._ctx.Process(target=_worker_main,
                                  args=(i, workdir, tq, self._result_q),
                                  name=f"minispark-executor-{i}",
                                  daemon=False)
            w.start()
            self._task_qs.append(tq)
            self._workers.append(w)
        self._dispatcher = threading.Thread(target=self._dispatch,
                                            name="minispark-dispatch",
                                            daemon=True)
        self._dispatcher.start()
        # executors are non-daemon (they parent node/manager processes, and
        # daemonic processes may not have children) — so a driver that
        # exits without sc.stop() would hang at interpreter shutdown on
        # multiprocessing's non-daemon join; the atexit stop prevents that
        import atexit
        atexit.register(self.stop)
        logger.info("minispark: %d executor processes under %s",
                    num_executors, self._root)

    @property
    def num_executors(self):
        return self._n

    @property
    def root(self):
        return self._root

    def _dispatch(self):
        while True:
            try:
                task_id, kind, payload = self._result_q.get(timeout=1)
            except queue_mod.Empty:
                if self._stopped:
                    return
                continue
            with self._pending_lock:
                sink = self._pending.pop(task_id, None)
            if sink is not None:
                sink.put((task_id, kind, payload))

    def run_tasks(self, tasks, collect):
        """Run [(executor_index, fn, data), ...]; tasks for one executor run
        sequentially in submission order, different executors in parallel.
        Returns results in task order (None entries when collect=False);
        raises the first task error.  Every task is pickled before any is
        sent: one that does not pickle raises `TypeError` and none runs."""
        blobs = [(eid, dumps_task((fn, data, collect)))
                 for eid, fn, data in tasks]
        sink = queue_mod.Queue()
        order = []
        for eid, blob in blobs:
            task_id = next(self._ids)
            with self._pending_lock:
                self._pending[task_id] = sink
            order.append(task_id)
            self._task_qs[eid % self._n].put((task_id, blob))
        results = {}
        errors = []
        remaining = len(order)
        while remaining:
            try:
                task_id, kind, payload = sink.get(timeout=1)
            except queue_mod.Empty:
                dead = [w.name for w in self._workers if not w.is_alive()]
                if dead and not self._stopped:
                    # a worker died without reporting (segfault, OOM-kill,
                    # os._exit in user code): fail the action instead of
                    # waiting forever on results that will never come
                    raise RuntimeError(
                        f"minispark executor(s) died mid-task: {dead}")
                continue
            remaining -= 1
            if kind == "error":
                errors.append((task_id, payload))
            else:
                results[task_id] = payload
        if errors:
            errors.sort()
            raise RuntimeError(f"minispark task failed:\n{errors[0][1]}")
        return [results[tid] for tid in order]

    def stop(self):
        self._stopped = True
        for tq in self._task_qs:
            try:
                tq.put(None)
            except Exception:
                pass
        for w in self._workers:
            w.join(10)
            if w.is_alive():
                w.terminate()
