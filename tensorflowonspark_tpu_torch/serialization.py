"""flax's msgpack format on the standard library — the counterpart of
``flax.serialization`` (``to_bytes`` / ``msgpack_serialize`` /
``msgpack_restore``), which the JAX package's exports
(``params.msgpack``) and LoRA adapter files use.

The format is msgpack (https://github.com/msgpack/msgpack/blob/master/
spec.md) over a tree of maps with str keys and leaves that are ints,
floats, bools, str, None, bin or arrays.  flax adds:

- ext 1, an ndarray: the msgpack array ``(shape, dtype name, C-order
  bytes)``;
- ext 3, a numpy scalar: the same encoding of a 0-d array;
- arrays over ``MAX_CHUNK_SIZE`` bytes are written as the map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
  "chunks": {"0": flat0, ...}}`` (msgpack caps a bin at 2**31 - 1).

:func:`dump` / :func:`dumps` write the bytes ``flax.serialization.
to_bytes`` writes for the same tree (map keys in the tree's order; sort
them first for ``msgpack_serialize``'s order).  Leaves may be torch
tensors, numpy arrays or numpy scalars; ``bfloat16`` tensors keep the
dtype name flax writes for ``jnp.bfloat16``.

:func:`load` / :func:`loads` read such bytes into nested dicts whose
array leaves are CPU torch tensors over the read buffer itself
(``torch.frombuffer``): no array payload is copied, so a 3.48 GB f32
export costs one buffer of its size.  An ext code or a dtype name the
format does not define raises ValueError.
"""
import io
import struct

import numpy as np
import torch

from tensorflowonspark_tpu_torch import fsio

MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY = 1
EXT_NPSCALAR = 3

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


# ---- writing ---------------------------------------------------------------

def _uint_header(n, small, fmt8, fmt16, fmt32, small_cap):
    if n < small_cap:
        return bytes([small | n])
    if fmt8 is not None and n < 256:
        return bytes([fmt8, n])
    if n < 65536:
        return struct.pack(">BH", fmt16, n)
    return struct.pack(">BI", fmt32, n)


def _pack_int(n):
    if 0 <= n < 128:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, cap in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32),
                               (0xCF, ">BQ", 1 << 64)):
            if n < cap:
                return struct.pack(fmt, code, n)
    else:
        for code, fmt, cap in ((0xD0, ">Bb", 1 << 7), (0xD1, ">Bh", 1 << 15),
                               (0xD2, ">Bi", 1 << 31),
                               (0xD3, ">Bq", 1 << 63)):
            if n >= -cap:
                return struct.pack(fmt, code, n)
    raise OverflowError(f"{n} does not fit a msgpack integer")


def _pack_str(s):
    data = s.encode("utf-8")
    return _uint_header(len(data), 0xA0, 0xD9, 0xDA, 0xDB, 32) + data


def _bin_header(n):
    if n < 256:
        return bytes([0xC4, n])
    if n < 65536:
        return struct.pack(">BH", 0xC5, n)
    return struct.pack(">BI", 0xC6, n)


def _ext_header(code, n):
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return struct.pack(">Bb", fixed[n], code)
    if n < 256:
        return struct.pack(">BBb", 0xC7, n, code)
    if n < 65536:
        return struct.pack(">BHb", 0xC8, n, code)
    return struct.pack(">BIb", 0xC9, n, code)


def _as_array(x):
    """An array leaf as a contiguous CPU tensor or numpy array, or None
    for any other value."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").contiguous()
    if isinstance(x, (np.ndarray, np.generic)):
        arr = np.asarray(x)     # a 0-d scalar stays 0-d
        return arr if arr.flags.c_contiguous else np.ascontiguousarray(arr)
    return None


def _itemsize(a):
    return a.element_size() if isinstance(a, torch.Tensor) else a.itemsize


def _array_payload(a):
    """``(inner header bytes, payload memoryview)`` of flax's ndarray
    encoding of ``a``: the msgpack array (shape, dtype name, bin)."""
    if isinstance(a, torch.Tensor):
        name = _NAMES.get(a.dtype)
        if name is None:
            raise ValueError(f"dtype {a.dtype} has no flax msgpack name")
        raw = a.reshape(-1).view(torch.uint8).numpy()
    else:
        if a.dtype.hasobject or a.dtype.fields:
            raise ValueError("object and structured dtypes are not "
                             "serializable")
        name = a.dtype.name      # ml_dtypes' bfloat16 names itself so
        raw = a.reshape(-1).view(np.uint8)
    head = bytearray([0x93])
    head += _uint_header(len(a.shape), 0x90, None, 0xDC, 0xDD, 16)
    for d in a.shape:
        head += _pack_int(int(d))
    head += _pack_str(name)
    head += _bin_header(raw.nbytes)
    return bytes(head), memoryview(raw)


def _write_array(write, a, code):
    head, data = _array_payload(a)
    write(_ext_header(code, len(head) + data.nbytes))
    write(head)
    if data.nbytes:
        write(data)


def _chunk(a):
    """flax's chunked form of an oversized array."""
    flat = a.reshape(-1)
    size = max(1, int(MAX_CHUNK_SIZE / _itemsize(a)))
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(a.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _oversized(a):
    n = 1
    for d in a.shape:
        n *= int(d)
    return n * _itemsize(a) > MAX_CHUNK_SIZE


def _write(write, x, in_map):
    if x is None:
        write(b"\xc0")
    elif isinstance(x, bool):
        write(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        write(_pack_int(x))
    elif isinstance(x, float):
        write(struct.pack(">Bd", 0xCB, x))
    elif isinstance(x, str):
        write(_pack_str(x))
    elif isinstance(x, (bytes, bytearray)):
        write(_bin_header(len(x)))
        write(x)
    elif isinstance(x, dict):
        write(_uint_header(len(x), 0x80, None, 0xDE, 0xDF, 16))
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"map key {k!r} is not a str")
            write(_pack_str(k))
            _write(write, v, True)
    elif isinstance(x, np.generic):
        _write_array(write, _as_array(x), EXT_NPSCALAR)
    else:
        a = _as_array(x)
        if a is None:
            raise TypeError(f"cannot serialize {type(x).__name__}")
        if in_map and _oversized(a):
            _write(write, _chunk(a), True)
        else:
            _write_array(write, a, EXT_NDARRAY)


def dump(tree, f):
    """Write ``tree`` to the binary file ``f`` in flax's msgpack format,
    array payloads straight from their tensors' memory."""
    if not isinstance(tree, dict):
        a = _as_array(tree)
        if a is not None and not isinstance(tree, np.generic) \
                and _oversized(a):
            tree = _chunk(a)
    _write(f.write, tree, False)


def dumps(tree):
    """:func:`dump` to bytes."""
    buf = io.BytesIO()
    dump(tree, buf)
    return buf.getvalue()


def save(path, tree):
    """:func:`dump` to ``path`` (any path ``fsio`` opens)."""
    with fsio.fopen(path, "wb") as f:
        dump(tree, f)


# ---- reading ---------------------------------------------------------------

class _Reader:
    """Recursive-descent msgpack decoder over one writable buffer."""

    def __init__(self, buf):
        self.buf = buf
        self.view = memoryview(buf)
        self.pos = 0

    def _take(self, n):
        start = self.pos
        self.pos += n
        if self.pos > len(self.view):
            raise ValueError("truncated msgpack data")
        return start

    def _unpack(self, fmt, n):
        return struct.unpack_from(fmt, self.view, self._take(n))[0]

    def _str(self, n):
        start = self._take(n)
        return str(self.view[start:start + n], "utf-8")

    def _bin(self, n):
        start = self._take(n)
        return bytes(self.view[start:start + n])

    def _array(self, n):
        return [self.read() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, n):
        code = self._unpack(">b", 1)
        end = self.pos + n
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext code {code} is not one of flax's "
                             f"array encodings ({EXT_NDARRAY}, "
                             f"{EXT_NPSCALAR})")
        t = self._ndarray()
        if self.pos != end:
            raise ValueError("malformed flax ndarray extension")
        return t

    def _ndarray(self):
        """flax's ``(shape, dtype name, bytes)``: a tensor over the
        buffer (no copy)."""
        shape, name = self._ndarray_head()
        dtype = _DTYPES.get(name)
        if dtype is None:
            raise ValueError(f"dtype {name!r} is not one the port reads")
        b = self._byte()
        if b == 0xC4:
            n = self._unpack(">B", 1)
        elif b == 0xC5:
            n = self._unpack(">H", 2)
        elif b == 0xC6:
            n = self._unpack(">I", 4)
        else:
            raise ValueError("flax ndarray payload is not a bin")
        start = self._take(n)
        count = 1
        for d in shape:
            count *= d
        itemsize = torch.empty((), dtype=dtype).element_size()
        if count * itemsize != n:
            raise ValueError(f"ndarray of shape {shape} and dtype {name} "
                             f"does not fill its {n} bytes")
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(self.buf, dtype=dtype, count=count,
                                offset=start).reshape(shape)

    def _ndarray_head(self):
        b = self._byte()
        if b != 0x93:
            raise ValueError("flax ndarray encoding is not a 3-array")
        shape = self.read()
        name = self.read()
        if not isinstance(shape, list) or not isinstance(name, str):
            raise ValueError("malformed flax ndarray header")
        return tuple(shape), name

    def _byte(self):
        return self.view[self._take(1)]

    def read(self):
        b = self._byte()
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in fixed:
            fmt = fixed[b]
            return self._unpack(fmt, struct.calcsize(fmt))
        sized = {0xD9: (">B", self._str), 0xDA: (">H", self._str),
                 0xDB: (">I", self._str), 0xC4: (">B", self._bin),
                 0xC5: (">H", self._bin), 0xC6: (">I", self._bin),
                 0xDC: (">H", self._array), 0xDD: (">I", self._array),
                 0xDE: (">H", self._map), 0xDF: (">I", self._map),
                 0xC7: (">B", self._ext), 0xC8: (">H", self._ext),
                 0xC9: (">I", self._ext)}
        if b in sized:
            fmt, fn = sized[b]
            return fn(self._unpack(fmt, struct.calcsize(fmt)))
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")


def _unchunk(node):
    shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    return torch.cat(chunks).reshape(shape)


def _unchunk_tree(node):
    if isinstance(node, dict):
        if CHUNKED in node:
            return _unchunk(node)
        return {k: _unchunk_tree(v) for k, v in node.items()}
    return node


def loads(buf):
    """Decode flax msgpack bytes.  A writable buffer (``bytearray``) is
    shared by the tensors it yields; other bytes are copied once into
    one."""
    if not isinstance(buf, bytearray):
        buf = bytearray(buf)
    reader = _Reader(buf)
    tree = reader.read()
    if reader.pos != len(buf):
        raise ValueError(f"{len(buf) - reader.pos} trailing bytes after the "
                         "msgpack object")
    return _unchunk_tree(tree)


def _read_buffer(path):
    """The bytes of ``path`` (any path ``fsio`` opens) in one writable
    buffer, read in place."""
    size = fsio.getsize(path)
    buf = bytearray(size)
    view = memoryview(buf)
    with fsio.fopen(path, "rb") as f:
        got = 0
        while got < size:
            n = f.readinto(view[got:])
            if not n:
                raise ValueError(f"{path}: short read ({got} of {size})")
            got += n
    return buf


def load(path):
    """:func:`loads` of the file at ``path``."""
    return loads(_read_buffer(path))
