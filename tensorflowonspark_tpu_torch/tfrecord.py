"""TFRecord + tf.train.Example I/O — counterpart of
``tensorflowonspark_tpu/tfrecord.py``.

The reference delegated this format to the prebuilt tensorflow-hadoop jar
(SURVEY.md §2.2: lib/tensorflow-hadoop-1.0-SNAPSHOT.jar, used via
dfutil.py:39,63) and to TF's protobuf classes.  This module owns both
layers so the data path has no TF/JVM dependency:

- record framing: uint64 length (LE) + masked CRC32C of the length + payload
  + masked CRC32C of the payload (the public TFRecord wire format),
- a minimal protobuf wire-format codec for the `tf.train.Example` message
  family (Example/Features/Feature/BytesList/FloatList/Int64List), writing
  the same field numbers as the public schema so files interoperate with
  TF and every other TFRecord reader.

One codec path: the table-driven CRC32C and the varint codec below, in
Python.  The JAX package also carries a C++ fast path
(``native/tfrecord_io.cc``), which the port does not carry and nothing
here looks for: where training reads TFRecords, the decode runs in
``data.Dataset.prefetch``'s thread beside the step, so it is hidden
(on one H100, the pipeline phase of ``chip_smoke.py`` measured 12.35 ms
of decode a step against 0.46 ms of wait).  The bytes written are the
JAX package's, byte for byte, sidecar indexes included.
"""
import io
import logging
import struct

logger = logging.getLogger(__name__)

# --------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven.
# --------------------------------------------------------------------------

_CRC_TABLE = []


def _build_crc_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_crc_table()


def crc32c(data):
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


_MASK_DELTA = 0xA282EAD8


def masked_crc32c(data):
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + _MASK_DELTA & 0xFFFFFFFF




# --------------------------------------------------------------------------
# Record framing
# --------------------------------------------------------------------------

class TFRecordWriter:
    """Writes framed records to a file-like or path.

    `compression="gzip"` writes a gzip stream (the Hadoop/tf.data
    ``TFRecordOptions(compression_type="GZIP")`` format; auto-enabled for
    paths ending in ``.gz``) — the reader auto-detects it by magic bytes.
    """

    def __init__(self, path_or_file, compression=None, index=False):
        # All argument validation happens BEFORE the 'wb' open: opening
        # first would truncate an existing file on a call that then fails.
        if compression not in (None, "", "gzip"):
            raise ValueError(f"unsupported compression {compression!r}")
        is_file_like = hasattr(path_or_file, "write")
        if not is_file_like and compression is None \
                and str(path_or_file).endswith(".gz"):
            compression = "gzip"
        if index and is_file_like:
            raise ValueError("index=True needs a path (the sidecar is "
                             "written next to the data file)")
        if index and compression == "gzip":
            raise ValueError("gzip streams have no random access; "
                             "index=True requires an uncompressed file")
        if is_file_like:
            self._raw = path_or_file
            self._own = False
        else:
            from . import fsio
            self._raw = fsio.fopen(path_or_file, "wb")
            self._own = True
        if compression == "gzip":
            import gzip
            self._f = gzip.GzipFile(fileobj=self._raw, mode="wb")
            self._gz = True
        else:
            self._f = self._raw
            self._gz = False
        # Sidecar index accumulation: payload offsets/lengths tracked as
        # frames are written (we own the framing, so counting is exact).
        self._path = None if hasattr(path_or_file, "write") else path_or_file
        self._index = ([], []) if index else None
        self._pos = 0

    def write(self, record_bytes):
        data = bytes(record_bytes)
        if self._index is not None:
            self._index[0].append(self._pos + 12)   # payload offset
            self._index[1].append(len(data))
        self._pos += len(data) + 16
        length = struct.pack("<Q", len(data))
        self._f.write(length)
        self._f.write(struct.pack("<I", masked_crc32c(length)))
        self._f.write(data)
        self._f.write(struct.pack("<I", masked_crc32c(data)))

    def flush(self):
        self._f.flush()
        if self._gz:
            self._raw.flush()

    def close(self):
        if self._gz:
            self._f.close()         # writes the gzip trailer; leaves _raw open
        if self._own:
            self._raw.close()
        if self._index is not None:
            _write_index_sidecar(default_index_path(self._path), self._path,
                                 self._pos, self._index[0], self._index[1])
            self._index = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _head_is_gzip(head):
    """True when a 12-byte file head is a gzip stream and NOT a plain
    TFRecord.

    The gzip magic (1f 8b) can collide with the little-endian uint64
    length prefix of a plain record, so a valid plain-TFRecord header
    (length CRC checks out — 2^-32 false-positive odds for real gzip
    bytes) wins over the magic."""
    if len(head) == 12:
        (len_crc,) = struct.unpack("<I", head[8:12])
        if masked_crc32c(head[:8]) == len_crc:
            return False            # valid plain TFRecord frame header
    return head[:2] == b"\x1f\x8b"


def _is_gzip(path):
    from . import fsio
    with fsio.fopen(path, "rb") as f:
        return _head_is_gzip(f.read(12))


def read_records(path_or_file, verify_crc=True):
    """Yield raw record payloads from a TFRecord file.

    Gzip-compressed files (tf.data GZIP / Hadoop codec) are auto-detected
    by magic bytes; every file streams through the frame parser below.
    """
    from . import fsio

    if not hasattr(path_or_file, "read") and fsio.is_remote(path_or_file):
        # ONE remote open serves sniff + parse (each open is a round trip
        # on object stores); gzip wraps the same handle
        with fsio.fopen(path_or_file, "rb") as raw:
            head = raw.read(12)
            raw.seek(0)
            if _head_is_gzip(head):
                import gzip
                with gzip.GzipFile(fileobj=raw, mode="rb") as gz:
                    yield from read_records(gz, verify_crc=verify_crc)
            else:
                yield from read_records(raw, verify_crc=verify_crc)
        return
    if not hasattr(path_or_file, "read") and _is_gzip(path_or_file):
        import gzip
        with fsio.fopen(path_or_file, "rb") as raw:
            with gzip.GzipFile(fileobj=raw, mode="rb") as gz:
                yield from read_records(gz, verify_crc=verify_crc)
        return
    f = path_or_file if hasattr(path_or_file, "read") \
        else fsio.fopen(path_or_file, "rb")
    try:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise IOError("truncated TFRecord header")
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:12])
            if verify_crc and masked_crc32c(header[:8]) != len_crc:
                raise IOError("TFRecord length CRC mismatch (corrupt file)")
            data = f.read(length)
            if len(data) < length:
                raise IOError("truncated TFRecord payload")
            crc_bytes = f.read(4)
            if len(crc_bytes) < 4:
                raise IOError("truncated TFRecord payload CRC")
            (data_crc,) = struct.unpack("<I", crc_bytes)
            if verify_crc and masked_crc32c(data) != data_crc:
                raise IOError("TFRecord payload CRC mismatch (corrupt file)")
            yield data
    finally:
        if not hasattr(path_or_file, "read"):
            f.close()


# --------------------------------------------------------------------------
# Minimal protobuf wire codec for tf.train.Example
#
# Schema (public field numbers):
#   Example    { Features features = 1 }
#   Features   { map<string, Feature> feature = 1 }
#   Feature    { BytesList bytes_list = 1 | FloatList float_list = 2 |
#                Int64List int64_list = 3 }
#   BytesList  { repeated bytes value = 1 }
#   FloatList  { repeated float value = 1 [packed] }
#   Int64List  { repeated int64 value = 1 [packed] }
# --------------------------------------------------------------------------

def _write_varint(buf, value):
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _write_tag(buf, field, wire_type):
    _write_varint(buf, (field << 3) | wire_type)


def _write_len_delim(buf, field, payload):
    _write_tag(buf, field, 2)
    _write_varint(buf, len(payload))
    buf.extend(payload)


def _zigzagless_int64(v):
    # int64 fields use two's-complement varints (10 bytes when negative)
    return v & 0xFFFFFFFFFFFFFFFF


def encode_feature(values):
    """Encode one Feature from a list of python values (homogeneous)."""
    buf = bytearray()
    if not values:
        # empty bytes_list by convention
        _write_len_delim(buf, 1, b"")
        return bytes(buf)
    first = values[0]
    inner = bytearray()
    if isinstance(first, (bytes, bytearray, str)):
        for v in values:
            if isinstance(v, str):
                v = v.encode("utf-8")
            _write_len_delim(inner, 1, bytes(v))
        _write_len_delim(buf, 1, bytes(inner))       # bytes_list
    elif isinstance(first, float):
        packed = struct.pack(f"<{len(values)}f", *values)
        _write_len_delim(inner, 1, packed)           # packed floats
        _write_len_delim(buf, 2, bytes(inner))       # float_list
    elif isinstance(first, (int, bool)):
        for v in values:
            _write_varint(inner, _zigzagless_int64(int(v)))
        packed = bytearray()
        _write_tag(packed, 1, 2)
        _write_varint(packed, len(inner))
        packed.extend(inner)                          # packed int64s
        _write_len_delim(buf, 3, bytes(packed))      # int64_list
    else:
        raise TypeError(f"unsupported feature value type {type(first)!r}")
    return bytes(buf)


def encode_example(feature_dict):
    """Encode {name: list-of-values | scalar | bytes} into Example bytes."""
    features_buf = bytearray()
    for name in sorted(feature_dict):
        values = feature_dict[name]
        if isinstance(values, (bytes, bytearray, str)) or not hasattr(
                values, "__iter__"):
            values = [values]
        else:
            values = list(values)
        feat = encode_feature(values)
        entry = bytearray()
        _write_len_delim(entry, 1, name.encode("utf-8"))   # map key
        _write_len_delim(entry, 2, feat)                   # map value
        _write_len_delim(features_buf, 1, bytes(entry))    # Features.feature
    example = bytearray()
    _write_len_delim(example, 1, bytes(features_buf))      # Example.features
    return bytes(example)


def _read_varint(data, pos):
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(data):
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = _read_varint(data, pos)
        field, wt = key >> 3, key & 7
        if wt == 2:
            length, pos = _read_varint(data, pos)
            yield field, data[pos:pos + length]
            pos += length
        elif wt == 0:
            value, pos = _read_varint(data, pos)
            yield field, value
        elif wt == 5:
            yield field, data[pos:pos + 4]
            pos += 4
        elif wt == 1:
            yield field, data[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")


def _signed64(v):
    return v - (1 << 64) if v >= (1 << 63) else v


def decode_feature(data):
    """Decode one Feature into (kind, values) with kind in
    {'bytes','float','int64'}."""
    for field, payload in _iter_fields(data):
        if field == 1:      # BytesList
            return "bytes", [bytes(v) for f, v in _iter_fields(payload) if f == 1]
        if field == 2:      # FloatList (packed or repeated)
            values = []
            for f, v in _iter_fields(payload):
                if f == 1:
                    if isinstance(v, (bytes, bytearray, memoryview)):
                        values.extend(struct.unpack(f"<{len(v)//4}f", v))
                    else:
                        values.append(struct.unpack("<f", struct.pack("<I", v))[0])
            return "float", values
        if field == 3:      # Int64List
            values = []
            for f, v in _iter_fields(payload):
                if f == 1:
                    if isinstance(v, (bytes, bytearray, memoryview)):
                        pos = 0
                        while pos < len(v):
                            value, pos = _read_varint(v, pos)
                            values.append(_signed64(value))
                    else:
                        values.append(_signed64(v))
            return "int64", values
    return "bytes", []


def decode_example(data):
    """Decode Example bytes into {name: (kind, values)}."""
    out = {}
    for field, features in _iter_fields(data):
        if field != 1:
            continue
        for f, entry in _iter_fields(features):
            if f != 1:
                continue
            name, feat = None, b""
            for ef, ev in _iter_fields(entry):
                if ef == 1:
                    name = bytes(ev).decode("utf-8")
                elif ef == 2:
                    feat = ev
            if name is not None:
                out[name] = decode_feature(feat)
    return out


# --------------------------------------------------------------------------
# Convenience: dict-of-values <-> files
# --------------------------------------------------------------------------

def write_examples(path, dicts, compression=None, index=False):
    """Write an iterable of {name: values} dicts as a TFRecord file
    (gzip-compressed when `compression="gzip"` or the path ends in .gz;
    `index=True` also writes the random-access sidecar index)."""
    count = 0
    with TFRecordWriter(path, compression=compression, index=index) as w:
        for d in dicts:
            w.write(encode_example(d))
            count += 1
    return count


def read_examples(path, verify_crc=True):
    """Yield decoded {name: (kind, values)} dicts from a TFRecord file."""
    for record in read_records(path, verify_crc=verify_crc):
        yield decode_example(record)


def read_column(path, name, verify_crc=True):
    """Decode ONE fixed-length numeric feature column of a whole TFRecord
    file of Example records into a numpy array [n_records, feat_len]
    (float32 for FloatList features, int64 for Int64List).

    Decoded with the record codec: the JAX package's native column pass
    is not carried (the module docstring says why).  Ragged features
    (per-record length changes), missing features, and kind mismatches
    raise IOError/TypeError.
    """
    import numpy as np

    first = next(read_examples(path, verify_crc=verify_crc), None)
    if first is None:
        raise ValueError(f"{path}: empty TFRecord file")
    if name not in first:
        raise IOError(f"{path}: feature {name!r} missing from a record")
    kind, values = first[name]
    if kind == "bytes":
        raise TypeError(f"feature {name!r} is a BytesList; read_column "
                        "decodes numeric (float/int64) columns")
    feat_len = len(values)
    np_dtype = np.float32 if kind == "float" else np.int64

    rows = []
    for ex in read_examples(path, verify_crc=verify_crc):
        if name not in ex:
            raise IOError(f"{path}: feature {name!r} missing from a record")
        k, v = ex[name]
        if k != kind:
            raise TypeError("feature holds a different kind than the first "
                            f"record (feature {name!r})")
        if len(v) != feat_len:
            raise IOError(f"{path}: ragged feature: value count differs "
                          "between records")
        rows.append(v)
    return np.asarray(rows, np_dtype).reshape(len(rows), feat_len)


# --------------------------------------------------------------------------
# Indexed random access (the ArrayRecord-style capability, SURVEY.md §2.2:
# the native data layer should own "TFRecord + ArrayRecord I/O").
#
# A TFRecord stream is sequential-only: record N is reachable only by
# scanning records 0..N-1, so global shuffling and balanced record-granular
# sharding require either a full pass per epoch or an index.  This section
# adds the index as a SIDECAR file (`<data>.idx`) so the data file stays a
# byte-for-byte standard TFRecord, readable by TF, Hadoop, and every other
# TFRecord consumer — unlike a footer-based container, nothing about the
# wire format changes.
#
# Sidecar format (little-endian):
#   8B   magic  b"TFRIDX2\0"
#   u64  data file size when indexed   (staleness check)
#   u64  record count N
#   u32  data fingerprint: masked CRC32C over the data file's first and
#        last min(64, size) bytes  (catches same-size rewrites)
#   N*u64  payload offsets
#   N*u64  payload lengths
#   u32  masked CRC32C over everything after the magic
#
# The index is rebuildable from the data alone (one streaming pass), so a
# missing or stale sidecar degrades to a scan, never an error.
# --------------------------------------------------------------------------

INDEX_MAGIC = b"TFRIDX2\0"
_INDEX_MAGIC_V1 = b"TFRIDX1\0"   # still readable: size-only staleness
INDEX_SUFFIX = ".idx"


def default_index_path(path):
    """Sidecar index path for a TFRecord data file."""
    return str(path) + INDEX_SUFFIX


def index_records(path, verify_crc=True):
    """Scan a TFRecord file and return (offsets, lengths) of every record
    payload (one streaming pass of the frame parser)."""
    from . import fsio

    if _is_gzip(path):
        raise ValueError(f"{path}: gzip TFRecord streams have no random "
                         "access (no stable byte offsets); store shards "
                         "uncompressed to index them")
    offsets, lengths = [], []
    with fsio.fopen(path, "rb") as f:
        pos = 0
        while True:
            header = f.read(12)
            if not header:
                break
            if len(header) < 12:
                raise IOError("truncated TFRecord header")
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:12])
            if verify_crc and masked_crc32c(header[:8]) != len_crc:
                raise IOError("TFRecord length CRC mismatch (corrupt file)")
            data = f.read(length)
            crc_bytes = f.read(4)
            if len(data) < length or len(crc_bytes) < 4:
                raise IOError("truncated TFRecord payload")
            if verify_crc and \
                    masked_crc32c(data) != struct.unpack("<I", crc_bytes)[0]:
                raise IOError("TFRecord payload CRC mismatch (corrupt file)")
            offsets.append(pos + 12)
            lengths.append(length)
            pos += 12 + length + 4
    return offsets, lengths


def _data_fingerprint(path, size):
    """CRC over the data file's head+tail bytes.  Catches the rewrite the
    size check alone cannot: a data file replaced by one of the SAME byte
    size, which would otherwise serve wrong payloads silently under
    verify_crc=False (two ranged reads; cheap even on remote FS)."""
    from . import fsio

    if size <= 0:
        return 0
    n = min(64, size)
    with fsio.fopen(path, "rb") as f:
        head = f.read(n)
        f.seek(max(0, size - n))
        tail = f.read(n)
    return masked_crc32c(head + tail)


def _write_index_sidecar(index_path, data_path, data_size, offsets, lengths):
    from . import fsio

    body = io.BytesIO()
    body.write(struct.pack("<QQI", data_size, len(offsets),
                           _data_fingerprint(data_path, data_size)))
    body.write(struct.pack(f"<{len(offsets)}Q", *offsets))
    body.write(struct.pack(f"<{len(lengths)}Q", *lengths))
    payload = body.getvalue()
    with fsio.fopen(index_path, "wb") as f:
        f.write(INDEX_MAGIC)
        f.write(payload)
        f.write(struct.pack("<I", masked_crc32c(payload)))


def write_index(path, index_path=None, verify_crc=True):
    """Build and persist the sidecar index for an existing TFRecord file.
    Returns (offsets, lengths)."""
    from . import fsio

    offsets, lengths = index_records(path, verify_crc=verify_crc)
    _write_index_sidecar(index_path or default_index_path(path), path,
                         fsio.getsize(path), offsets, lengths)
    return offsets, lengths


def read_index(path, index_path=None):
    """Load the sidecar index for `path`.  Returns (offsets, lengths), or
    None when the sidecar is missing, corrupt, or stale (data file size OR
    head/tail content fingerprint changed since it was written) — callers
    rebuild via index_records()."""
    from . import fsio

    idx = index_path or default_index_path(path)
    if not fsio.exists(idx):
        return None
    try:
        with fsio.fopen(idx, "rb") as f:
            blob = f.read()
        magic = blob[:len(INDEX_MAGIC)]
        v1 = magic == _INDEX_MAGIC_V1   # pre-fingerprint sidecars stay
        # readable with their original (size-only) staleness semantics —
        # a format bump must not degrade existing datasets to full scans
        if len(blob) < len(INDEX_MAGIC) + (20 if v1 else 24) \
                or (magic != INDEX_MAGIC and not v1):
            return None
        payload, (crc,) = blob[8:-4], struct.unpack("<I", blob[-4:])
        if masked_crc32c(payload) != crc:
            logger.warning("ignoring corrupt index sidecar %s", idx)
            return None
        header = 16 if v1 else 20
        if v1:
            data_size, count = struct.unpack_from("<QQ", payload, 0)
            fingerprint = None
        else:
            data_size, count, fingerprint = struct.unpack_from(
                "<QQI", payload, 0)
        if header + 16 * count != len(payload):
            return None
        if data_size != fsio.getsize(path) or (
                fingerprint is not None
                and fingerprint != _data_fingerprint(path, data_size)):
            logger.info("index sidecar %s is stale; reindexing", idx)
            return None
        offsets = list(struct.unpack_from(f"<{count}Q", payload, header))
        lengths = list(
            struct.unpack_from(f"<{count}Q", payload, header + 8 * count))
        return offsets, lengths
    except (OSError, struct.error):
        return None


class IndexedTFRecordFile:
    """Random-access reader over one TFRecord shard.

    Uses the sidecar index when present and fresh, else builds the index in
    memory with one scan.  Works over any fsspec filesystem that supports
    seek (local, gs://, hdfs://, s3://, memory:// ...): each `read(i)` is
    one ranged read, and `read_range` fetches a contiguous run of records
    with a single ranged read — the unit the global-shuffle Dataset root
    reads by block.

    This is the capability the ArrayRecord format exists for; here the data
    file stays a standard TFRecord and random access lives in the sidecar.
    """

    def __init__(self, path, index_path=None, verify_crc=True):
        self._path = path
        self._verify = verify_crc
        loaded = read_index(path, index_path)
        if loaded is None:
            loaded = index_records(path, verify_crc=verify_crc)
        self._offsets, self._lengths = loaded
        self._f = None                  # opened lazily on first read

    def _file(self):
        if self._f is None:
            from . import fsio
            self._f = fsio.fopen(self._path, "rb")
        return self._f

    def release(self):
        """Close the underlying file handle, keeping the index; the next
        read reopens transparently.  Lets callers iterate thousands of
        shard files without holding thousands of fds (the Dataset root
        keeps an LRU of open readers and releases the rest)."""
        if self._f is not None:
            self._f.close()
            self._f = None

    def __len__(self):
        return len(self._offsets)

    def read(self, i):
        """Record payload `i` (one seek + one read)."""
        off, ln = self._offsets[i], self._lengths[i]   # IndexError on bad i
        f = self._file()
        f.seek(off)
        data = f.read(ln + 4)
        if len(data) < ln + 4:
            raise IOError(f"{self._path}: truncated record {i}")
        payload, (crc,) = data[:ln], struct.unpack("<I", data[ln:])
        if self._verify and masked_crc32c(payload) != crc:
            raise IOError(f"{self._path}: payload CRC mismatch at record {i}")
        return payload

    __getitem__ = read

    def read_range(self, start, count):
        """Payloads of records [start, start+count) via ONE ranged read."""
        if count <= 0:
            return []
        last = start + count - 1
        span_start = self._offsets[start] - 12       # frame header start
        span_end = self._offsets[last] + self._lengths[last] + 4
        f = self._file()
        f.seek(span_start)
        blob = f.read(span_end - span_start)
        if len(blob) < span_end - span_start:
            raise IOError(f"{self._path}: truncated record range "
                          f"[{start}, {start + count})")
        out = []
        for i in range(start, start + count):
            lo = self._offsets[i] - span_start
            payload = blob[lo:lo + self._lengths[i]]
            if self._verify:
                (crc,) = struct.unpack_from(
                    "<I", blob, lo + self._lengths[i])
                if masked_crc32c(payload) != crc:
                    raise IOError(f"{self._path}: payload CRC mismatch at "
                                  f"record {i}")
            out.append(payload)
        return out

    def example(self, i):
        """Decoded `{name: (kind, values)}` dict for record `i`."""
        return decode_example(self.read(i))

    def close(self):
        self.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
