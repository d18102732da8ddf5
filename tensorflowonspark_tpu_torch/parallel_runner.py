"""Embarrassingly-parallel runner — counterpart of
``tensorflowonspark_tpu/parallel_runner.py`` (maps reference
TFParallel.py:17-64).

Runs N *independent* single-node instances of a user function — no
rendezvous, no collectives, no data feed — the shape the reference used for
parallel inference under Spark barrier mode.  Each instance gets a minimal
`NodeContext` (executor_id == task_index, every node is a "worker") and,
when several executors share a GPU host, a deterministic GPU slice
(maps the BarrierTaskContext peer-placement GPU math, TFParallel.py:42-49).
"""
import logging

from . import backend as backend_mod
from . import gpu_info, util
from . import node as node_mod

logger = logging.getLogger(__name__)


class _ParallelTask:
    """One executor's instance of `map_fn` (a class, not a closure, so a
    spawn-started backend can ship it)."""

    def __init__(self, map_fn, tf_args, n, num_chips):
        self.map_fn = map_fn
        self.tf_args = tf_args
        self.n = n
        self.num_chips = num_chips

    def __call__(self, iterator):
        executor_id = None
        for item in iterator:
            executor_id = item
        assert executor_id is not None, "parallel task received no executor id"
        if self.num_chips:
            gpu_info.assign_chips(
                self.num_chips,
                worker_index=_local_index(executor_id, self.num_chips))
        util.write_executor_id(executor_id)
        ctx = node_mod.NodeContext(
            executor_id=executor_id, job_name="worker",
            task_index=executor_id, num_workers=self.n,
            num_chips=self.num_chips)
        logger.info("parallel node %d/%d starting", executor_id, self.n)
        out = node_mod._wrapper_fn(self.map_fn, self.tf_args, ctx)
        return [] if out is None else [out]


def run(backend_or_sc, map_fn, tf_args=None, num_executors=None, num_chips=0):
    """Run `map_fn(tf_args, ctx)` once per executor, independently.

    Returns the collected per-node return values (a list; nodes returning
    None contribute nothing), where the reference returned nothing — the
    results channel is free here because inference output need not ride
    a queue manager.  ``num_chips`` is the number of GPUs each executor
    takes (`gpu_info.assign_chips`).
    """
    backend = backend_mod.resolve(backend_or_sc)
    n = num_executors or backend.num_executors
    task = _ParallelTask(map_fn, tf_args, n, num_chips)
    backend.check_shippable(task)
    results = backend.map_partitions([[i] for i in range(n)], task)
    if hasattr(results, "collect"):
        # SparkBackend.map_partitions returns a lazy RDD; the reference's
        # barrier-mode run executed eagerly (TFParallel.py:63-64), and
        # callers ported from it discard the return value — force the jobs.
        results = results.collect()
    return results


def _local_index(executor_id, num_chips):
    """Host-local worker index for GPU slicing.

    Under Spark barrier mode the task infos give exact same-host peer ranks
    (what the reference used, TFParallel.py:42-49); otherwise fall back to
    executor_id modulo the host's worker-slot count (local GPUs / GPUs per
    worker) — exact for LocalBackend (single host) and for contiguous-block
    executor placement.
    """
    try:
        from pyspark import BarrierTaskContext
        tc = BarrierTaskContext.get()
        infos = tc.getTaskInfos()
        host = util.get_ip_address()
        peers = [i for i, ti in enumerate(infos) if ti.address.split(":")[0]
                 in (host, "localhost", "127.0.0.1")]
        return peers.index(tc.partitionId())
    except Exception:
        slots = max(gpu_info._count_local_chips() // max(num_chips, 1), 1)
        return executor_id % slots
