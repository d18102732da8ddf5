"""Schema-string parsing for the data-interchange layer — counterpart of
``tensorflowonspark_tpu/schema.py``.

Maps the reference's Scala parser-combinator SimpleTypeParser
(reference: src/main/scala/com/yahoo/tensorflowonspark/SimpleTypeParser.scala:27-63),
which parses Spark's ``StructType.simpleString`` format:

    struct<name:type,...>   with base types binary/boolean/int/long/bigint/
    float/double/string and 1-D arrays array<base>.

Used by the inference CLI (--schema_hint) and dfutil.loadTFRecords to
disambiguate TFRecord feature decoding (e.g. bytes vs string, float vs
double) the same way the reference's schemaHint does
(reference: DFUtil.scala:35-110).
"""

BASE_TYPES = {
    "binary": "binary",
    "boolean": "bool",
    "int": "int32",
    "long": "int64",
    "bigint": "int64",
    "float": "float32",
    "double": "float64",
    "string": "string",
}


class Field:
    """One parsed column: name, numpy-ish dtype name, is_array flag."""

    def __init__(self, name, dtype, is_array=False):
        self.name = name
        self.dtype = dtype
        self.is_array = is_array

    def __repr__(self):
        inner = f"array<{self.dtype}>" if self.is_array else self.dtype
        return f"Field({self.name}:{inner})"

    def __eq__(self, other):
        return (isinstance(other, Field) and self.name == other.name
                and self.dtype == other.dtype and self.is_array == other.is_array)


def parse_struct(s):
    """``struct<a:int,b:array<float>>`` -> [Field...] (order preserved)."""
    s = s.strip()
    if not (s.startswith("struct<") and s.endswith(">")):
        raise ValueError(f"schema must look like struct<name:type,...>: {s!r}")
    body = s[len("struct<"):-1].strip()
    fields = []
    if not body:
        return fields
    # split on commas not inside array<...>
    parts, depth, cur = [], 0, []
    for ch in body:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))

    for part in parts:
        name, sep, typ = part.partition(":")
        name, typ = name.strip(), typ.strip().lower()
        if not sep or not name or not typ:
            raise ValueError(f"bad field {part!r} (want name:type)")
        if typ.startswith("array<") and typ.endswith(">"):
            base = typ[len("array<"):-1].strip()
            if base not in BASE_TYPES:
                raise ValueError(f"unsupported array element type {base!r}")
            fields.append(Field(name, BASE_TYPES[base], is_array=True))
        elif typ in BASE_TYPES:
            fields.append(Field(name, BASE_TYPES[typ]))
        else:
            raise ValueError(
                f"unsupported type {typ!r}; supported: "
                f"{sorted(BASE_TYPES)} and array<> of those")
    return fields


def to_simple_string(fields):
    """[Field...] -> ``struct<...>`` round trip."""
    inv = {v: k for k, v in BASE_TYPES.items() if k != "bigint"}
    cols = ",".join(
        f"{f.name}:array<{inv[f.dtype]}>" if f.is_array else f"{f.name}:{inv[f.dtype]}"
        for f in fields)
    return f"struct<{cols}>"
