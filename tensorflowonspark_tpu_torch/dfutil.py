"""DataFrame / iterator ⇄ TFRecord interchange — counterpart of
``tensorflowonspark_tpu/dfutil.py`` (maps reference dfutil.py:1-212).

The reference converts Spark DataFrames to `tf.train.Example` TFRecords via
the tensorflow-hadoop jar (dfutil.py:29-81) with schema inference and a
`binary_features` hint to disambiguate bytes vs string (dfutil.py:134-168).
This module owns the format (`tfrecord`) and works at two levels:

- iterator level (no Spark needed): `write_tfrecords` / `read_tfrecords` /
  `infer_schema` over dicts of values — this is also what feeds DataFeed.
- Spark level: `saveAsTFRecords` / `loadTFRecords` with the reference's
  semantics — each executor writes its partition as a `part-r-XXXXX`
  shard, schema is inferred from the first record, and `loadedDF` tracks
  provenance for `isLoadedDF` (reference: dfutil.py:15-26).  They run
  over real pyspark or the port's `minispark` (no pyspark needed); their
  executor tasks are module-level classes (`_WritePartition`,
  `_ReadShard`), so they ship through the standard pickler.

numpy values (a token row as an ``ndarray``, numpy scalars) are taken as
their Python values.
"""
import logging
import os

from . import tfrecord

logger = logging.getLogger(__name__)

# DataFrames produced by loadTFRecords, keyed by id (reference: dfutil.py:15-26)
loadedDF = {}


def isLoadedDF(df):
    """True if `df` came from loadTFRecords (reference: dfutil.py:20-26)."""
    return id(df) in loadedDF


# --------------------------------------------------------------------------
# Schema: {column: type} with types 'int64' | 'float32' | 'binary' |
# 'string' | 'array<int64>' | 'array<float32>' | 'array<binary>' | 'array<string>'
# --------------------------------------------------------------------------

_SCALAR_KINDS = {"int64", "float32", "binary", "string"}


def _py(value):
    """numpy arrays and scalars as Python lists and values."""
    return value.tolist() if hasattr(value, "tolist") else value


def infer_schema(row, binary_features=()):
    """Infer {column: type} from one example row (dict of python values).

    Maps reference infer_schema (dfutil.py:134-168): bytes default to
    'string' unless named in `binary_features` (TFRecords don't distinguish).
    """
    schema = {}
    for name, value in row.items():
        value = _py(value)
        is_array = isinstance(value, (list, tuple))
        probe = value[0] if is_array and len(value) else value
        if isinstance(probe, bool):
            kind = "int64"
        elif isinstance(probe, int):
            kind = "int64"
        elif isinstance(probe, float):
            kind = "float32"
        elif isinstance(probe, (bytes, bytearray)):
            kind = "binary" if name in binary_features else "string"
        elif isinstance(probe, str):
            kind = "string"
        elif is_array and not len(value):
            kind = "float32"  # empty array: assume float (reference default)
        else:
            raise TypeError(f"cannot infer TFRecord type for column {name!r} "
                            f"value {value!r}")
        schema[name] = f"array<{kind}>" if is_array else kind
    return schema


def schema_from_example(example, binary_features=()):
    """Infer schema from a decoded example {name: (kind, values)}.

    Single-valued features map to scalars, multi-valued to arrays — the same
    first-record heuristic as the reference (dfutil.py:44-81).
    """
    schema = {}
    for name, (kind, values) in example.items():
        if kind == "bytes":
            col = "binary" if name in binary_features else "string"
        elif kind == "float":
            col = "float32"
        else:
            col = "int64"
        schema[name] = col if len(values) <= 1 else f"array<{col}>"
    return schema


def to_feature_dict(row, schema=None):
    """Convert a python row dict into encode_example-ready values."""
    out = {}
    for name, value in row.items():
        value = _py(value)
        if isinstance(value, str):
            value = value.encode("utf-8")
        elif isinstance(value, (list, tuple)):
            value = [v.encode("utf-8") if isinstance(v, str) else v
                     for v in value]
        elif isinstance(value, bool):
            value = int(value)
        out[name] = value
    return out


def from_example(example, schema):
    """Decode {name: (kind, values)} into a python row dict per `schema`
    (maps reference fromTFExample, dfutil.py:171-212)."""
    row = {}
    for name, coltype in schema.items():
        kind, values = example.get(name, ("bytes", []))
        is_array = coltype.startswith("array<")
        base = coltype[6:-1] if is_array else coltype
        if base == "string":
            values = [v.decode("utf-8", "replace") if isinstance(v, bytes)
                      else v for v in values]
        elif base == "binary":
            values = [bytes(v) for v in values]
        elif base == "float32":
            values = [float(v) for v in values]
        elif base == "int64":
            values = [int(v) for v in values]
        if is_array:
            row[name] = values
        else:
            row[name] = values[0] if values else None
    return row


# --------------------------------------------------------------------------
# Iterator-level API (no Spark required)
# --------------------------------------------------------------------------

def write_tfrecords(rows, path, index=False):
    """Write an iterable of row dicts to one TFRecord file (``index=True``
    adds the random-access sidecar); returns count."""
    return tfrecord.write_examples(
        path, (to_feature_dict(r) for r in rows), index=index)


def read_tfrecords(path_or_dir, binary_features=(), schema=None):
    """Read rows back from a file or a directory of part files.

    Returns (rows, schema); schema is inferred from the first record unless
    given (the reference's loadTFRecords contract, dfutil.py:44-81).
    """
    from . import fsio
    if fsio.isdir(path_or_dir):
        paths = fsio.glob(fsio.join(path_or_dir, "part-*"))
        if not paths:
            paths = [p for p in fsio.glob(fsio.join(path_or_dir, "*"))
                     if fsio.isfile(p) and not
                     os.path.basename(p).startswith(("_", "."))]
        # random-access sidecars live next to the data shards
        paths = [p for p in paths
                 if not p.endswith(tfrecord.INDEX_SUFFIX)]
    else:
        paths = [path_or_dir]
    rows = []
    for p in paths:
        for example in tfrecord.read_examples(p):
            if schema is None:
                schema = schema_from_example(example, binary_features)
            rows.append(from_example(example, schema))
    return rows, (schema or {})


# --------------------------------------------------------------------------
# Spark-level API (gated)
# --------------------------------------------------------------------------

class _WritePartition:
    """saveAsTFRecords' executor task: partition `index` as shard
    ``part-r-XXXXX`` under `output_dir`; yields ``(index, count)``."""

    def __init__(self, output_dir, columns, index):
        self.output_dir = output_dir
        self.columns = tuple(columns)
        self.index = index

    def __call__(self, index, iterator):
        # makedirs must run on the EXECUTOR, not the driver: on a multi-node
        # cluster the driver's filesystem is a different machine.  Remote
        # schemes (gs://, s3://, hdfs://, ...) write through fsio/fsspec —
        # the analog of the reference's Hadoop output format; plain local
        # paths land on a shared filesystem iff output_dir is one.
        from . import fsio
        fsio.makedirs(self.output_dir)
        part = fsio.join(self.output_dir, f"part-r-{index:05d}")
        count = write_tfrecords(
            (dict(zip(self.columns, row)) for row in iterator), part,
            index=self.index)
        yield (index, count)


def saveAsTFRecords(df, output_dir, index=False):
    """Save a Spark DataFrame as sharded TFRecord files (maps reference
    saveAsTFRecords, dfutil.py:29-41 — but writes natively per executor
    instead of through the Hadoop output format).  ``index=True`` also
    writes each shard's random-access sidecar index, so downstream
    readers get Dataset.from_indexed_tfrecords' exact global shuffle
    without a rebuild scan."""
    counts = df.rdd.mapPartitionsWithIndex(
        _WritePartition(output_dir, df.columns, index)).collect()
    total = sum(c for _, c in counts)
    logger.info("wrote %d records to %s in %d shards", total, output_dir,
                len(counts))
    return total


class _ReadShard:
    """loadTFRecords' executor task: one shard's rows, as tuples in
    `columns` order."""

    def __init__(self, schema, columns):
        self.schema = dict(schema)
        self.columns = tuple(columns)

    def __call__(self, path):
        for example in tfrecord.read_examples(path):
            row = from_example(example, self.schema)
            yield tuple(row[c] for c in self.columns)


def loadTFRecords(sc, input_dir, binary_features=(), schema_hint=None):
    """Load TFRecord shards into a Spark DataFrame (maps reference
    loadTFRecords, dfutil.py:44-81).  `schema_hint` is {column: type} using
    this module's type strings."""
    from . import fsio, minispark

    sql = minispark.sql_module(sc)
    spark = sql.SparkSession.builder.getOrCreate()
    paths = [p for p in
             (fsio.glob(fsio.join(input_dir, "part-*")) or [input_dir])
             if not p.endswith(tfrecord.INDEX_SUFFIX)]

    # infer schema from the first record of the first shard
    schema = dict(schema_hint or {})
    if not schema:
        first = next(iter(tfrecord.read_examples(paths[0])), None)
        if first is None:
            raise ValueError(f"no records found under {input_dir}")
        schema = schema_from_example(first, binary_features)
    columns = sorted(schema)

    rdd = sc.parallelize(paths, len(paths)).flatMap(_ReadShard(schema, columns))
    df = spark.createDataFrame(rdd, _spark_schema(schema, columns, sql.types))
    loadedDF[id(df)] = input_dir
    return df


def _spark_schema(schema, columns, T):
    base = {"int64": T.LongType(), "float32": T.FloatType(),
            "binary": T.BinaryType(), "string": T.StringType()}

    fields = []
    for c in columns:
        t = schema[c]
        if t.startswith("array<"):
            fields.append(T.StructField(c, T.ArrayType(base[t[6:-1]])))
        else:
            fields.append(T.StructField(c, base[t]))
    return T.StructType(fields)
