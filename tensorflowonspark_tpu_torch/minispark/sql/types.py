"""minispark.sql.types — structural stand-ins for the pyspark SQL types
the schema mapping uses (dfutil._spark_schema; reference dtype tables,
reference: dfutil.py:96-131).  Counterpart of the JAX package's
``minispark/sql/types.py``."""


class DataType:
    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash(type(self).__name__)

    def __repr__(self):
        return type(self).__name__ + "()"

    def simpleString(self):
        return type(self).__name__.replace("Type", "").lower()


class StringType(DataType):
    pass


class BinaryType(DataType):
    pass


class BooleanType(DataType):
    pass


class IntegerType(DataType):
    pass


class LongType(DataType):
    def simpleString(self):
        return "bigint"


class FloatType(DataType):
    pass


class DoubleType(DataType):
    pass


class ArrayType(DataType):
    def __init__(self, elementType, containsNull=True):
        self.elementType = elementType
        self.containsNull = containsNull

    def __repr__(self):
        return f"ArrayType({self.elementType!r})"

    def simpleString(self):
        return f"array<{self.elementType.simpleString()}>"


class StructField:
    def __init__(self, name, dataType, nullable=True, metadata=None):
        self.name = name
        self.dataType = dataType
        self.nullable = nullable
        self.metadata = metadata or {}

    def __eq__(self, other):
        return (isinstance(other, StructField) and self.name == other.name
                and self.dataType == other.dataType)

    def __repr__(self):
        return f"StructField({self.name!r}, {self.dataType!r})"


class StructType(DataType):
    def __init__(self, fields=None):
        self.fields = list(fields or [])

    def add(self, field, dataType=None):
        if isinstance(field, StructField):
            self.fields.append(field)
        else:
            self.fields.append(StructField(field, dataType))
        return self

    def fieldNames(self):
        return [f.name for f in self.fields]

    def __iter__(self):
        return iter(self.fields)

    def __len__(self):
        return len(self.fields)

    def __repr__(self):
        return f"StructType({self.fields!r})"

    def simpleString(self):
        inner = ",".join(f"{f.name}:{f.dataType.simpleString()}"
                         for f in self.fields)
        return f"struct<{inner}>"
