"""The port's TFRecord codec against the JAX package's.

- ``crc32c`` / ``masked_crc32c`` equal the JAX package's on seeded byte
  strings (and the RFC 3720 vector);
- ``write_examples`` of the same rows (int64, float, bytes; plain with
  ``index=True``, and gzip) gives byte-identical files and sidecars;
- each package reads the other's files to the same decoded records;
- ``IndexedTFRecordFile.read`` / ``read_range`` agree record for record,
  and ``read_column`` returns equal arrays;
- the port has one codec path: no native library is looked for, and a
  corrupt payload or a truncated file raises as in the JAX package.

Everything is compared exactly: both sides run the same integer and byte
arithmetic, and floats cross as IEEE float32 bytes.
"""
import gzip
import os

import numpy as np
import pytest

from tensorflowonspark_tpu import tfrecord as jax_tfr
from tensorflowonspark_tpu_torch import tfrecord as port_tfr


def _rows(seed, n=7):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        out.append({
            "ids": [int(v) for v in rng.randint(-2 ** 40, 2 ** 40, 5)],
            "tokens": [int(v) for v in rng.randint(0, 32000, 9)],
            "x": [float(np.float32(v)) for v in rng.randn(3)],
            "name": f"row-{i}".encode(),
            "label": int(rng.randint(0, 10)),
            "tags": [b"a", bytes(rng.randint(0, 256, 4).astype(np.uint8))],
        })
    return out


def test_crc32c_matches_jax_on_seeded_bytes():
    assert port_tfr.crc32c(b"\x00" * 32) == 0x8A9136AA
    rng = np.random.RandomState(0)
    for n in (0, 1, 7, 64, 1000, 4097):
        data = rng.randint(0, 256, n).astype(np.uint8).tobytes()
        assert port_tfr.crc32c(data) == jax_tfr.crc32c(data)
        assert port_tfr.masked_crc32c(data) == jax_tfr.masked_crc32c(data)


@pytest.mark.parametrize("kind", ["indexed", "gzip"])
def test_write_examples_byte_identical_and_cross_readable(tmp_path, kind):
    rows = _rows(1)
    if kind == "gzip":
        # gzip headers carry an mtime: compare the decompressed streams
        kw = dict(compression="gzip")
        names = ("p.tfrecord.gz", "j.tfrecord.gz")
    else:
        kw = dict(index=True)
        names = ("p.tfrecord", "j.tfrecord")
    p, j = (str(tmp_path / n) for n in names)
    assert port_tfr.write_examples(p, rows, **kw) == len(rows)
    assert jax_tfr.write_examples(j, rows, **kw) == len(rows)
    read = (lambda f: gzip.open(f).read()) if kind == "gzip" else (
        lambda f: open(f, "rb").read())
    assert read(p) == read(j)
    if kind == "indexed":
        assert open(p + ".idx", "rb").read() == open(j + ".idx", "rb").read()
    assert list(port_tfr.read_examples(j)) == list(jax_tfr.read_examples(j))
    assert list(jax_tfr.read_examples(p)) == list(port_tfr.read_examples(p))
    assert port_tfr.decode_example(port_tfr.encode_example(rows[0])) == \
        jax_tfr.decode_example(jax_tfr.encode_example(rows[0]))


def test_indexed_reads_and_columns_agree(tmp_path):
    path = str(tmp_path / "d.tfrecord")
    jax_tfr.write_examples(path, _rows(2, n=11), index=True)
    with port_tfr.IndexedTFRecordFile(path) as pr, \
            jax_tfr.IndexedTFRecordFile(path) as jr:
        assert len(pr) == len(jr) == 11
        assert [pr.read(i) for i in range(11)] == \
            [jr.read(i) for i in range(11)]
        assert pr.read_range(3, 5) == jr.read_range(3, 5)
        assert pr.example(4) == jr.example(4)
    assert port_tfr.read_index(path) == jax_tfr.read_index(path)
    assert list(port_tfr.index_records(path)) == list(
        map(list, jax_tfr.index_records(path)))
    for name in ("tokens", "x"):
        got = port_tfr.read_column(path, name)
        want = jax_tfr.read_column(path, name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_one_codec_path_and_corruption_raises(tmp_path):
    assert not hasattr(port_tfr, "_native")
    path = str(tmp_path / "c.tfrecord")
    port_tfr.write_examples(path, [{"a": 1}, {"a": 2}])
    blob = bytearray(open(path, "rb").read())
    blob[14] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.raises(IOError, match="CRC mismatch"):
        list(port_tfr.read_examples(path))
    open(path, "wb").write(bytes(blob[:-6]))
    with pytest.raises(IOError, match="truncated|CRC"):
        list(port_tfr.read_examples(path, verify_crc=False))
    assert not os.path.exists(path + ".idx")
