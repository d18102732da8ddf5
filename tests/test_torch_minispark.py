"""The port's minispark: a local pyspark stand-in over persistent
executor processes whose tasks cross through the standard pickler.

- partition i runs on executor i mod n, each executor in its own
  persistent working directory (the same process across actions), and
  ``map`` / ``filter`` / ``flatMap`` / ``union`` /
  ``mapPartitionsWithIndex`` / ``foreachPartition`` give the plain Python
  result (spawn-started executors, as the card runs them);
- a task error is reported in the driver with its traceback, and the
  executor survives it;
- a closure (or a lambda) is refused in the driver with a `TypeError`
  before any task of the action starts;
- ``DataFrame.select`` / ``collect`` and ``Row`` cross the process
  boundary with their field names;
- the ``pyspark`` fixture leaves ``sys.modules`` as it found it, and the
  port's ``install()`` does not take the JAX package's minispark for
  itself (nor does ``pipeline_ml`` take its base classes from it);
- ``SparkBackend`` over minispark (the JAX package's Spark-surface
  bodies, ``tests/spark_surface.py``, on the port): ``cluster.run(sc,
  ...)`` answers ``inference`` with a lazy RDD of every square in order,
  and one cluster takes ``train(rdd, num_epochs=3)`` and then a
  ``queueStream`` through ``train_stream``, every record delivered as
  often as fed; a closure as map_fun is refused before any task starts;
  ``shutdown`` returns only after the node process (which no backend
  joins) announced its exit.

Pools have at most 2 executors; fork-started ones keep the tests cheap
(the functions they run are module-level here, already imported in the
forked child).
"""
import contextlib
import operator
import os
import sys
import time

import pytest

from tensorflowonspark_tpu import minispark as jax_minispark
from tensorflowonspark_tpu_torch import cluster, minispark


class ForkContext(minispark.SparkContext):
    """A minispark context whose executors fork: cheap, and the tasks
    here are module-level, already imported in the forked child."""
    _START_METHOD = "fork"

@contextlib.contextmanager
def pyspark_modules_restored():
    """Save every ``pyspark*`` entry of ``sys.modules`` and put them back
    (removing any added): a minispark installed inside never outlives
    the block, so other test files in this process see what they left."""
    saved = {k: v for k, v in sys.modules.items()
             if k == "pyspark" or k.startswith("pyspark.")}
    try:
        yield
    finally:
        for k in [k for k in sys.modules
                  if k == "pyspark" or k.startswith("pyspark.")]:
            if k not in saved:
                del sys.modules[k]
        sys.modules.update(saved)


@pytest.fixture(autouse=True)
def pyspark_modules():
    """Every test here leaves the ``pyspark*`` modules as it found them."""
    with pyspark_modules_restored():
        yield


@pytest.fixture
def sc(tmp_path):
    context = ForkContext(num_executors=2, workdir=str(tmp_path / "ms"))
    yield context
    context.stop()


def _where(i, it):
    return [(i, os.getpid(), os.path.basename(os.getcwd()), list(it))]


def _square(x):
    return x * x


def _pair(x):
    return [x, -x]


def _even(x):
    return x % 2 == 0


def _boom(it):
    raise ValueError("boom in a task")


def _touch(it):
    for path in it:
        open(path, "w").close()


def test_routing_workdirs_and_lineage(tmp_path):
    """Spawn-started executors (the card's start method): only builtins
    and port functions cross, so nothing heavy is imported there."""
    with minispark.SparkContext(num_executors=2,
                                workdir=str(tmp_path)) as ctx:
        rdd = ctx.parallelize(range(10), 4)
        first = rdd.mapPartitionsWithIndex(_where).collect()
        again = rdd.mapPartitionsWithIndex(_where).collect()
        assert [(i, d, part) for i, _, d, part in first] == [
            (0, "executor-0", [0, 1, 2]), (1, "executor-1", [3, 4, 5]),
            (2, "executor-0", [6, 7]), (3, "executor-1", [8, 9])]
        pids = {d: pid for _, pid, d, _ in first}
        assert pids["executor-0"] != pids["executor-1"]
        assert [(pid, d) for _, pid, d, _ in again] == [
            (pid, d) for _, pid, d, _ in first]          # persistent
        assert rdd.map(_square).collect() == [x * x for x in range(10)]
        assert rdd.flatMap(_pair).collect() == [
            y for x in range(10) for y in (x, -x)]
        assert rdd.filter(_even).map(str).collect() == [
            str(x) for x in range(0, 10, 2)]
        other = ctx.parallelize([10, 11], 1)
        assert rdd.union(other).map(operator.neg).collect() == [
            -x for x in range(12)]
        assert rdd.union(other).getNumPartitions() == 5
        assert rdd.mapPartitionsWithIndex(_where).map(
            operator.itemgetter(0)).collect() == [0, 1, 2, 3]
        marks = [str(tmp_path / f"m{i}") for i in range(3)]
        ctx.parallelize(marks, 3).foreachPartition(_touch)
        assert all(os.path.exists(m) for m in marks)


def test_task_error_reported_and_executor_survives(sc):
    rdd = sc.parallelize(range(4), 2)
    pids = [pid for _, pid, _, _ in rdd.mapPartitionsWithIndex(_where)
            .collect()]
    with pytest.raises(RuntimeError, match="boom in a task"):
        rdd.mapPartitions(_boom).collect()
    assert rdd.map(_square).count() == 4
    assert [pid for _, pid, _, _ in rdd.mapPartitionsWithIndex(_where)
            .collect()] == pids


def test_closure_refused_before_any_task_starts(sc, tmp_path):
    mark = str(tmp_path / "ran")
    scale = 3
    good = sc.parallelize([mark], 1).mapPartitions(_touch)
    bad = sc.parallelize([1, 2], 1).map(lambda x: x * scale)
    with pytest.raises(TypeError, match="module-level functions"):
        good.union(bad).collect()
    with pytest.raises(TypeError, match="closures and lambdas"):
        sc.parallelize([1], 1).foreach(lambda x: None)
    assert not os.path.exists(mark)
    assert sc.parallelize([1, 2], 2).map(_square).collect() == [1, 4]


def test_dataframe_rows_cross_with_field_names(sc):
    from tensorflowonspark_tpu_torch.minispark import sql
    from tensorflowonspark_tpu_torch.minispark.sql import types as T

    spark = sql.SparkSession.builder.getOrCreate()
    assert spark.sparkContext is sc
    schema = T.StructType([T.StructField("a", T.LongType()),
                           T.StructField("b", T.StringType()),
                           T.StructField("c", T.ArrayType(T.FloatType()))])
    df = spark.createDataFrame([(i, str(i), [0.5 * i]) for i in range(5)],
                               schema)
    rows = df.select("c", "a").collect()
    assert [r.asDict() for r in rows] == [{"c": [0.5 * i], "a": i}
                                          for i in range(5)]
    assert df.columns == ["a", "b", "c"] and df.count() == 5
    assert schema.simpleString() == "struct<a:bigint,b:string,c:array<float>>"
    assert sql.Row("x", "y")(1, 2).asDict() == {"x": 1, "y": 2}


def test_pyspark_fixture_and_install_recognise_only_the_port():
    before = {k: v for k, v in sys.modules.items() if k.startswith("pyspark")}
    with pyspark_modules_restored():
        if jax_minispark.has_real_pyspark():
            pytest.skip("real pyspark present")
        assert jax_minispark.install()
        assert sys.modules["pyspark"] is jax_minispark
        assert minispark.install()            # replaces the JAX package's
        assert sys.modules["pyspark"] is minispark
        assert sys.modules["pyspark.sql"] is minispark.sql
        assert minispark.install()            # idempotent
        import pyspark.ml

        from tensorflowonspark_tpu_torch import pipeline_ml
        assert pyspark.ml is minispark.ml
        assert issubclass(pipeline_ml.TFEstimator, minispark.ml.Estimator)
        assert not issubclass(pipeline_ml.TFEstimator,
                              jax_minispark.ml.Estimator)
    assert {k: v for k, v in sys.modules.items()
            if k.startswith("pyspark")} == before


# --- SparkBackend over minispark (the JAX Spark-surface bodies) ---------------

def fn_square(args, ctx):
    df = ctx.get_data_feed(train_mode=False)
    while not df.should_stop():
        batch = df.next_batch(10)
        if batch:
            df.batch_results([x * x for x in batch])


def fn_count_to_file(args, ctx):
    df = ctx.get_data_feed()
    total = 0
    while not df.should_stop():
        total += len(df.next_batch(32))
    with open(os.path.join(args["out_dir"], f"count-{ctx.executor_id}.txt"),
              "w") as f:
        f.write(str(total))


def fn_slow_last_write(args, ctx):
    df = ctx.get_data_feed()
    while not df.should_stop():
        df.next_batch(32)
    time.sleep(1.0)                  # a chief's export after the feed ends
    with open(os.path.join(args["out_dir"], "last.txt"), "w") as f:
        f.write("done")


def test_shutdown_waits_for_the_node_to_exit(sc, tmp_path):
    """No backend joins a SPARK-mode node process (a fork of the
    executor), so ``shutdown`` returns only after the node announced its
    exit: what it wrote last is there, even with ``grace_secs=0``."""
    c = cluster.run(sc, fn_slow_last_write, tf_args={"out_dir": str(tmp_path)},
                    num_executors=1, input_mode=cluster.InputMode.SPARK)
    try:
        c.train(sc.parallelize(range(10), 1), feed_timeout=60)
        c.shutdown(grace_secs=0, timeout=60)
    except BaseException:
        c.abort()
        raise
    assert (tmp_path / "last.txt").read_text() == "done"


def test_spark_backend_inference_is_lazy_and_in_order(sc):
    with pytest.raises(TypeError, match="module-level function"):
        cluster.run(sc, lambda a, c: None, num_executors=2,
                    input_mode=cluster.InputMode.SPARK)
    c = cluster.run(sc, fn_square, tf_args={}, num_executors=2,
                    input_mode=cluster.InputMode.SPARK)
    try:
        out = c.inference(sc.parallelize(range(200), 4))
        assert hasattr(out, "collect")
        assert out.collect() == [x * x for x in range(200)]
        c.shutdown(timeout=60)
    except BaseException:
        c.abort()
        raise


def test_spark_backend_epochs_and_queue_stream(sc, tmp_path):
    from tensorflowonspark_tpu_torch.minispark.streaming import (
        StreamingContext)

    out_dir = str(tmp_path / "counts")
    os.makedirs(out_dir)
    c = cluster.run(sc, fn_count_to_file, tf_args={"out_dir": out_dir},
                    num_executors=2, input_mode=cluster.InputMode.SPARK)
    try:
        c.train(sc.parallelize(range(100), 2), num_epochs=3, feed_timeout=60)
        ssc = StreamingContext(sc, 0.1)
        c.train_stream(ssc.queueStream(
            [sc.parallelize(range(50), 2) for _ in range(4)]),
            feed_timeout=60)
        ssc.start()
        c.shutdown(ssc=ssc, grace_secs=1, timeout=60)
    except BaseException:
        c.abort()
        raise
    counts = [int(open(os.path.join(out_dir, f)).read())
              for f in sorted(os.listdir(out_dir))]
    assert len(counts) == 2 and sum(counts) == 300 + 200
