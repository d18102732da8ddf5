"""minispark — a pyspark-API-compatible LOCAL cluster stand-in;
counterpart of the JAX package's ``minispark``.

pyspark need not be installed for the Spark-facing surface (SparkBackend
bootstrap, SPARK-mode feeding, DataFrame⇄TFRecord, ML pipeline
fit/transform, queue-stream feeding) to EXECUTE — the reference took the
same stance with its mandatory 2-worker standalone test cluster
(reference: tests/README.md:10, tox.ini:29-34).  minispark implements
the pyspark subset those code paths call, over REAL separated OS
processes with the executor semantics they rely on:

- persistent executors with stable working directories (the reused
  python-worker model, reference: TFSparkNode.py:393-395) so queue
  managers and background node processes survive between tasks;
- deterministic partition→executor routing (partition i → executor
  i mod n), which the executor-id-file manager discovery requires;
- lazy RDD lineage, sequential per-executor task execution (the
  1-core-per-executor discipline).

Tasks cross through the standard pickler (`executor.ExecutorPool`), so
the lineage is built of instances of the module-level classes below and
every user function in it must be importable (a module-level function).
A closure or a lambda raises `TypeError` in the driver when an action
runs, before any of its tasks starts.

`install()` makes it importable AS `pyspark` — only when the real thing
is absent — so modules written against pyspark run unmodified.  The
port's own modules never need that: they take the port's minispark
directly when `has_real_pyspark()` is false.  It is a stand-in: same
API, same process shape, none of Spark's scheduling, shuffle, or
storage.  Never installed implicitly.
"""
import logging
import sys
import threading

logger = logging.getLogger(__name__)

_active_context = None
_active_lock = threading.Lock()


# -- lineage steps: module-level classes, so a task pickles by reference ----

class _Identity:
    """A root partition's task: the partition's records as they are."""

    def __call__(self, it):
        return it


class _Chained:
    """One transform over its parent's task for partition `index`."""

    def __init__(self, parent_fn, step, index):
        self.parent_fn = parent_fn
        self.step = step
        self.index = index

    def __call__(self, it):
        return self.step(self.index, iter(self.parent_fn(it)))


class _MapPartitions:
    def __init__(self, f):
        self.f = f

    def __call__(self, _index, it):
        return self.f(it)


class _MapPartitionsWithIndex:
    def __init__(self, f):
        self.f = f

    def __call__(self, index, it):
        return self.f(index, it)


class _Map:
    def __init__(self, f):
        self.f = f

    def __call__(self, _index, it):
        return (self.f(x) for x in it)


class _FlatMap:
    def __init__(self, f):
        self.f = f

    def __call__(self, _index, it):
        return (y for x in it for y in self.f(x))


class _Filter:
    def __init__(self, f):
        self.f = f

    def __call__(self, _index, it):
        return (x for x in it if self.f(x))


class _Drain:
    """foreachPartition's task: run `f` and drain a generator it returns
    (generators run for side effects)."""

    def __init__(self, f):
        self.f = f

    def __call__(self, it):
        out = self.f(it)
        if out is not None:
            for _ in out:
                pass


class _EachRecord:
    """foreach's partition function: `f` on every record."""

    def __init__(self, f):
        self.f = f

    def __call__(self, it):
        for x in it:
            self.f(x)


class RDD:
    """Lazy partitioned dataset: a lineage of per-partition transforms."""

    def __init__(self, sc, kind, payload):
        self.context = sc
        self._kind = kind      # "root" | "transform" | "union"
        self._payload = payload

    # -- lineage ------------------------------------------------------

    def _tasks(self):
        """[(task_fn(iterator) -> iterator_or_list, data_list), ...] in
        partition order; indices for mapPartitionsWithIndex are bound at
        the level the transform was applied, like Spark."""
        if self._kind == "root":
            return [(_Identity(), part) for part in self._payload]
        if self._kind == "union":
            tasks = []
            for rdd in self._payload:
                tasks.extend(rdd._tasks())
            return tasks
        parent, step = self._payload
        return [(_Chained(pfn, step, i), data)
                for i, (pfn, data) in enumerate(parent._tasks())]

    def _transform(self, step):
        return RDD(self.context, "transform", (self, step))

    # -- pyspark surface ----------------------------------------------

    def mapPartitions(self, f):
        return self._transform(_MapPartitions(f))

    def mapPartitionsWithIndex(self, f):
        return self._transform(_MapPartitionsWithIndex(f))

    def map(self, f):
        return self._transform(_Map(f))

    def flatMap(self, f):
        return self._transform(_FlatMap(f))

    def filter(self, f):
        return self._transform(_Filter(f))

    def union(self, other):
        return RDD(self.context, "union", [self, other])

    def getNumPartitions(self):
        return len(self._tasks())

    def collect(self):
        nested = self.context._run(self, collect=True)
        return [x for part in nested for x in part]

    def count(self):
        return len(self.collect())

    def foreachPartition(self, f):
        self.context._run(self.mapPartitions(_Drain(f)), collect=False)

    def foreach(self, f):
        self.foreachPartition(_EachRecord(f))

    def __repr__(self):
        return f"minispark.RDD({self._kind}, {self.getNumPartitions()} partitions)"


class SparkContext:
    """Driver handle over a persistent local executor pool."""

    # spawn-started executors hold nothing of the driver (no threads, no
    # torch, no CUDA context), so a node process forked from one may
    # initialise CUDA
    _START_METHOD = "spawn"

    def __init__(self, master=None, appName=None, num_executors=None,
                 workdir=None):
        global _active_context
        from .executor import ExecutorPool

        if num_executors is None:
            # honor local[N] master strings; default 2 (the reference's CI
            # cluster size, reference: tox.ini:33-34)
            num_executors = 2
            if master and master.startswith("local[") and master[6:-1].isdigit():
                num_executors = int(master[6:-1])
        self.master = master or f"local[{num_executors}]"
        self.appName = appName or "minispark"
        self._pool = ExecutorPool(num_executors, root=workdir,
                                  start_method=self._START_METHOD)
        self._stopped = False
        with _active_lock:
            _active_context = self
        logger.warning(
            "minispark SparkContext active: pyspark-compatible LOCAL "
            "stand-in (%d executor processes) — not a real Spark cluster",
            num_executors)

    @property
    def defaultParallelism(self):
        return self._pool.num_executors

    @property
    def executor_root(self):
        return self._pool.root

    def parallelize(self, data, numSlices=None):
        data = list(data)
        n = max(int(numSlices or self.defaultParallelism), 1)
        k, m = divmod(len(data), n)
        parts, start = [], 0
        for i in range(n):
            size = k + (1 if i < m else 0)
            parts.append(data[start:start + size])
            start += size
        return RDD(self, "root", parts)

    def union(self, rdds):
        return RDD(self, "union", list(rdds))

    def _run(self, rdd, collect):
        if self._stopped:
            raise RuntimeError("SparkContext was stopped")
        tasks = [(i, fn, data)
                 for i, (fn, data) in enumerate(rdd._tasks())]
        return self._pool.run_tasks(tasks, collect=collect)

    def stop(self):
        global _active_context
        if self._stopped:
            return
        self._stopped = True
        self._pool.stop()
        with _active_lock:
            if _active_context is self:
                _active_context = None

    # context-manager sugar for tests
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def active_context():
    return _active_context


class BarrierTaskContext:
    """Stub of pyspark's barrier context: `get()` raises (callers such as
    parallel_runner._local_index treat that as 'not in a barrier stage'
    and use their fallback placement math)."""

    @classmethod
    def get(cls):
        raise RuntimeError("minispark does not run barrier stages")


def has_real_pyspark():
    """True when a REAL pyspark distribution is importable — regardless
    of whether a minispark occupies sys.modules.  The path finders are
    consulted directly (find_spec would short-circuit on the sys.modules
    entry and report the stand-in)."""
    try:
        import importlib.machinery
        spec = importlib.machinery.PathFinder.find_spec("pyspark")
    except (ImportError, ValueError):
        return False
    return spec is not None and "minispark" not in str(spec.origin or "")


def sql_module(sc):
    """The ``pyspark.sql`` of `sc`'s flavour: this package's own for its
    SparkContext, else real pyspark's."""
    if isinstance(sc, SparkContext):
        from . import sql
        return sql
    from pyspark import sql
    return sql


_INSTALLED = ("pyspark", "pyspark.sql", "pyspark.sql.types",
              "pyspark.streaming", "pyspark.ml")


def install(force=False):
    """Register this minispark as `pyspark` in sys.modules.

    Refuses when real pyspark is importable (the stand-in must never
    shadow the real thing) unless `force=True`.  Returns True when
    installed.  Only this module counts as installed: another minispark
    in ``sys.modules["pyspark"]`` (the JAX package's) is replaced.
    """
    if not force and has_real_pyspark():
        logger.info("real pyspark present; minispark not installed")
        return False
    me = sys.modules[__name__]
    if sys.modules.get("pyspark") is me:
        return True   # already installed
    from . import ml, sql, streaming
    from .sql import types as sql_types

    me.__is_minispark__ = True
    for name, mod in zip(_INSTALLED, (me, sql, sql_types, streaming, ml)):
        sys.modules[name] = mod
    me.sql = sql
    me.streaming = streaming
    me.ml = ml
    logger.warning("minispark installed as pyspark (stand-in)")
    return True
