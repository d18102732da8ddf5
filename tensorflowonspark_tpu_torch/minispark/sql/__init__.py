"""minispark.sql — the pyspark.sql subset the framework's DataFrame
surface uses (SparkSession.builder.getOrCreate, createDataFrame, Row,
DataFrame.select/rdd/columns/collect); counterpart of the JAX package's
``minispark/sql``.  Row building and projection are module-level classes
(`_ToRow`, `_Project`), so a DataFrame's lineage ships through the
standard pickler."""
import threading

from . import types as T


class Row(tuple):
    """pyspark-style Row: a tuple with named fields.

    Construct with keywords (`Row(a=1, b=2)`) or pyspark's two-step form
    `Row("a", "b")(1, 2)`; supports attribute access, mapping-style
    access by name, and `asDict()`.
    """

    __fields__ = ()

    def __new__(cls, *args, **kwargs):
        if kwargs:
            names = tuple(kwargs)
            row = super().__new__(cls, tuple(kwargs.values()))
            row.__fields__ = names
            return row
        row = super().__new__(cls, args)
        row.__fields__ = ()
        return row

    @staticmethod
    def with_fields(names, values):
        return _make_row(tuple(names), tuple(values))

    def __reduce__(self):
        # tuple-subclass default pickling calls cls(iterable), which would
        # nest the whole row as one element and drop __fields__ — rows
        # cross the executor/driver process boundary constantly
        return (_make_row, (tuple(self.__fields__), tuple(self)))

    def __call__(self, *values):
        """pyspark's schema-then-values form: Row("a","b")(1,2)."""
        if self.__fields__:
            raise TypeError("cannot call a Row that already has values")
        if not all(isinstance(n, str) for n in self):
            raise TypeError("Row(...) used as a schema must hold field "
                            "names (strings)")
        if len(values) != len(self):
            raise ValueError(f"expected {len(self)} values, got "
                             f"{len(values)}")
        return _make_row(tuple(self), tuple(values))

    def __getattr__(self, name):
        fields = tuple.__getattribute__(self, "__fields__")
        if name in fields:
            return self[fields.index(name)]
        raise AttributeError(name)

    def __getitem__(self, item):
        if isinstance(item, str):
            return self[self.__fields__.index(item)]
        return super().__getitem__(item)

    def asDict(self):
        return dict(zip(self.__fields__, self))

    def __repr__(self):
        if self.__fields__:
            inner = ", ".join(f"{n}={v!r}"
                              for n, v in zip(self.__fields__, self))
            return f"Row({inner})"
        return f"Row{tuple(self)!r}"


def _make_row(names, values):
    row = tuple.__new__(Row, values)
    row.__fields__ = names
    return row


class _ToRow:
    """A record as a Row with the schema's field names (Rows pass)."""

    def __init__(self, names):
        self.names = tuple(names)

    def __call__(self, v):
        return v if isinstance(v, Row) else Row.with_fields(self.names, v)


class _Project:
    """select(): the Row of the chosen columns, by position."""

    def __init__(self, idx, names):
        self.idx = tuple(idx)
        self.names = tuple(names)

    def __call__(self, r):
        return Row.with_fields(self.names, [r[i] for i in self.idx])


class DataFrame:
    """Rows + schema over an RDD; the minimal relational surface."""

    def __init__(self, rdd, schema):
        self._schema = schema                  # T.StructType
        self._rdd = rdd.map(_ToRow(f.name for f in schema.fields))

    @property
    def schema(self):
        return self._schema

    @property
    def columns(self):
        return [f.name for f in self._schema.fields]

    @property
    def rdd(self):
        return self._rdd

    def select(self, *cols):
        cols = [c for group in cols
                for c in (group if isinstance(group, (list, tuple))
                          else [group])]
        idx = [self.columns.index(c) for c in cols]
        fields = [self._schema.fields[i] for i in idx]
        projected = self._rdd.map(_Project(idx, cols))
        return DataFrame(projected, T.StructType(fields))

    def collect(self):
        return self._rdd.collect()

    def count(self):
        return self._rdd.count()

    def first(self):
        rows = self.collect()
        return rows[0] if rows else None

    def show(self, n=20):
        for row in self.collect()[:n]:
            print(row)


class _Builder:
    """SparkSession.builder — chainable no-ops plus getOrCreate."""

    def __init__(self):
        self._conf = {}

    def master(self, m):
        self._conf["master"] = m
        return self

    def appName(self, name):
        self._conf["appName"] = name
        return self

    def config(self, key=None, value=None, conf=None):
        if key is not None:
            self._conf[key] = value
        return self

    def getOrCreate(self):
        return SparkSession._get_or_create(self._conf)


class SparkSession:
    _active = None
    _lock = threading.Lock()

    def __init__(self, sc):
        self.sparkContext = sc

    class _BuilderAccessor:
        def __get__(self, obj, objtype=None):
            return _Builder()

    builder = _BuilderAccessor()

    @classmethod
    def _get_or_create(cls, conf):
        from .. import SparkContext, active_context

        with cls._lock:
            if cls._active is not None and \
                    not cls._active.sparkContext._stopped:
                return cls._active
            sc = active_context()
            if sc is None or sc._stopped:
                sc = SparkContext(master=conf.get("master"),
                                  appName=conf.get("appName"))
            cls._active = cls(sc)
            return cls._active

    def createDataFrame(self, data, schema=None):
        from .. import RDD

        if not isinstance(data, RDD):
            data = self.sparkContext.parallelize(list(data))
        if schema is None:
            raise ValueError("minispark requires an explicit schema "
                             "(StructType or [names])")
        if isinstance(schema, (list, tuple)):
            schema = T.StructType(
                [T.StructField(n, T.StringType()) for n in schema])
        return DataFrame(data, schema)

    def stop(self):
        with SparkSession._lock:
            if SparkSession._active is self:
                SparkSession._active = None
        self.sparkContext.stop()
