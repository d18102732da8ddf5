"""The port's dfutil against the JAX package's.

- ``infer_schema``, ``to_feature_dict``, ``schema_from_example`` and
  ``from_example`` give the JAX package's results on the same rows
  (scalars, arrays, bytes / string with ``binary_features``);
- ``saveAsTFRecords`` of a DataFrame over the port's minispark (two
  partitions, fork-started executors) writes one ``part-r-XXXXX`` shard a
  partition, each byte-identical to the JAX package's
  ``write_tfrecords`` of that partition's rows (and with ``index=True``,
  identical sidecars);
- ``loadTFRecords`` with a ``schema_hint`` reads the shards back to the
  same rows (a token column as int64 lists, as TFRecords store them);
  ``isLoadedDF`` knows the DataFrame.

All comparisons are exact.
"""
import os

import numpy as np
import pytest

from tensorflowonspark_tpu import dfutil as jax_dfutil
from tensorflowonspark_tpu_torch import dfutil, minispark
from tensorflowonspark_tpu_torch.minispark import sql
from tensorflowonspark_tpu_torch.minispark.sql import types as T


class ForkContext(minispark.SparkContext):
    """A minispark context whose executors fork: cheap, and the tasks
    here are module-level, already imported in the forked child."""
    _START_METHOD = "fork"

ROWS = [
    {"name": "alice", "blob": b"\x00\x01", "age": 33, "flag": True,
     "score": 1.5, "ids": [1, 2, 3], "xs": [0.25, -1.0],
     "tags": ["a", "b"]},
    {"name": "bob", "blob": b"", "age": -1, "flag": False, "score": 0.0,
     "ids": [], "xs": [], "tags": []},
]


def test_schema_and_row_codecs_match_jax():
    for row in ROWS:
        for bf in ((), ("blob",)):
            assert dfutil.infer_schema(row, bf) == \
                jax_dfutil.infer_schema(row, bf)
        feats = dfutil.to_feature_dict(row)
        assert feats == jax_dfutil.to_feature_dict(row)
        from tensorflowonspark_tpu_torch import tfrecord
        ex = tfrecord.decode_example(tfrecord.encode_example(feats))
        schema = jax_dfutil.infer_schema(row, ("blob",))
        assert dfutil.schema_from_example(ex, ("blob",)) == \
            jax_dfutil.schema_from_example(ex, ("blob",))
        assert dfutil.from_example(ex, schema) == \
            jax_dfutil.from_example(ex, schema)
    # numpy values are taken as their Python values
    tok = np.arange(5, dtype=np.int32)
    assert dfutil.infer_schema({"t": tok}) == {"t": "array<int64>"}
    assert dfutil.to_feature_dict({"t": tok}) == {"t": [0, 1, 2, 3, 4]}


def _token_rows(seed, n):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 1000, 17).astype(np.int32),
             int(rng.randint(0, 5)), f"r{i}") for i in range(n)]


@pytest.mark.parametrize("index", [False, True])
def test_save_and_load_tfrecords_over_minispark(tmp_path, index):
    rows = _token_rows(4, 9)
    schema = T.StructType([
        T.StructField("tokens", T.ArrayType(T.IntegerType())),
        T.StructField("label", T.LongType()),
        T.StructField("name", T.StringType())])
    with ForkContext(num_executors=2, workdir=str(tmp_path / "ms")) as sc:
        spark = sql.SparkSession.builder.getOrCreate()
        df = spark.createDataFrame(sc.parallelize(rows, 2), schema)
        out = str(tmp_path / "tfr")
        assert dfutil.saveAsTFRecords(df, out, index=index) == len(rows)
        shards = sorted(f for f in os.listdir(out)
                        if not f.endswith(".idx"))
        assert shards == ["part-r-00000", "part-r-00001"]
        cols = ("tokens", "label", "name")
        for i, part in enumerate((rows[:5], rows[5:])):
            want = str(tmp_path / f"jax-{i}")
            jax_dfutil.write_tfrecords(
                [{"tokens": t.tolist(), "label": lb, "name": nm}
                 for t, lb, nm in part], want, index=index)
            got = os.path.join(out, shards[i])
            assert open(got, "rb").read() == open(want, "rb").read()
            if index:
                assert open(got + ".idx", "rb").read() == \
                    open(want + ".idx", "rb").read()
            else:
                assert not os.path.exists(got + ".idx")
        hint = {"tokens": "array<int64>", "label": "int64", "name": "string"}
        back = dfutil.loadTFRecords(sc, out, schema_hint=hint)
        assert dfutil.isLoadedDF(back) and back.columns == sorted(cols)
        got_rows = [r.asDict() for r in back.collect()]
        assert got_rows == [{"label": lb, "name": nm, "tokens": t.tolist()}
                            for t, lb, nm in rows]
        inferred = dfutil.loadTFRecords(sc, out)
        assert inferred.schema.simpleString() == \
            "struct<label:bigint,name:string,tokens:array<bigint>>"
        assert dfutil.read_tfrecords(out, schema=hint)[0] == [
            {"label": lb, "name": nm, "tokens": t.tolist()}
            for t, lb, nm in rows]
