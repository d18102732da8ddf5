"""The port's stdlib reader and writer of flax's msgpack format
(``serialization``) against ``flax.serialization``.

- The writer's bytes equal ``flax.serialization.to_bytes`` for f32,
  int8, bf16, numpy-scalar and nested trees (key order included), and
  for a chunked array, with both sides' ``MAX_CHUNK_SIZE`` set small.
- The reader restores what flax wrote, leaf for leaf (bf16 as
  ``torch.bfloat16``, bit for bit), and its tensors share the read
  buffer: the payload is not copied.
- ``msgpack_serialize``'s order (sorted keys) is the writer's over a
  sorted tree; an unknown ext code or dtype raises.
"""
import numpy as np
import pytest
import torch

import flax.serialization as flax_ser
import jax.numpy as jnp

from tensorflowonspark_tpu_torch import serialization

_rs = np.random.RandomState(0)
TREES = {
    "f32": {"kernel": _rs.randn(3, 5).astype(np.float32)},
    "int8": {"q": _rs.randint(-127, 128, (6, 4)).astype(np.int8),
             "scale": _rs.rand(1, 4).astype(np.float32)},
    "bf16": {"w": np.asarray(jnp.asarray(_rs.randn(7, 2), jnp.bfloat16))},
    "scalar": {"s": np.float32(2.5), "i": np.int32(-7)},
    "nested": {"z_last": {"b": {"kernel": _rs.randn(2, 2).astype(np.float32),
                                "bias": np.zeros((2,), np.float32)}},
               "a_first": {"embedding": _rs.randn(9, 3).astype(np.float32)},
               "meta": {"rank": 300, "neg": -40, "scale": 0.5, "on": True,
                        "none": None, "name": "x" * 40},
               "empty": np.zeros((0, 3), np.float32)},
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.float().numpy()
        return x.numpy()
    return x


@pytest.mark.parametrize("name", sorted(TREES))
def test_writer_bytes_equal_flax(name):
    tree = TREES[name]
    assert serialization.dumps(tree) == flax_ser.to_bytes(tree)
    # torch leaves write the same bytes as their numpy twins
    if name == "bf16":
        t = torch.from_numpy(tree["w"].astype(np.float32)).to(torch.bfloat16)
        assert serialization.dumps({"w": t}) == flax_ser.to_bytes(tree)
    if name == "int8":
        t = {k: torch.from_numpy(v) for k, v in tree.items()}
        assert serialization.dumps(t) == flax_ser.to_bytes(tree)


@pytest.mark.parametrize("name", sorted(TREES))
def test_reader_restores_what_flax_wrote(name):
    tree = TREES[name]
    got = serialization.loads(flax_ser.to_bytes(tree))
    want = flax_ser.msgpack_restore(flax_ser.to_bytes(tree))
    fg, fw = _flat(got), _flat(want)
    assert list(fg) == list(fw)
    for path, w in fw.items():
        g = _as_numpy(fg[path])
        if isinstance(w, (np.ndarray, np.generic)):
            w = np.asarray(w)
            assert g.shape == w.shape, path
            assert np.array_equal(g, w.astype(g.dtype)), path
            if w.dtype.name == "bfloat16":
                assert fg[path].dtype == torch.bfloat16
            else:
                assert g.dtype == w.dtype, path
        else:
            assert g == w and type(g) is type(w), path


def test_chunked_arrays_round_trip(monkeypatch):
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"big": _rs.randn(20, 7).astype(np.float32),
            "small": np.arange(4, dtype=np.int32),
            "bf": np.asarray(jnp.asarray(_rs.randn(50), jnp.bfloat16))}
    blob = flax_ser.to_bytes(tree)
    assert serialization.dumps(tree) == blob
    assert b"__msgpack_chunked_array__" in blob
    got = serialization.loads(blob)
    assert np.array_equal(got["big"].numpy(), tree["big"])
    assert np.array_equal(got["bf"].float().numpy(),
                          tree["bf"].astype(np.float32))


def test_reader_shares_the_buffer():
    w = _rs.randn(64, 32).astype(np.float32)
    buf = bytearray(flax_ser.to_bytes({"w": w}))
    got = serialization.loads(buf)["w"]
    assert np.array_equal(got.numpy(), w)
    view = np.frombuffer(buf, np.uint8)
    ptr = got.data_ptr() - view.ctypes.data
    assert 0 <= ptr < len(buf)          # the tensor lies inside the buffer


def test_sorted_tree_matches_msgpack_serialize():
    tree = {"b": {"y": np.ones(2, np.float32), "x": np.zeros(2, np.int8)},
            "a": {"scale": 1.0, "rank": 4}}

    def sort(t):
        return {k: sort(t[k]) if isinstance(t[k], dict) else t[k]
                for k in sorted(t)}

    assert serialization.dumps(sort(tree)) == flax_ser.msgpack_serialize(tree)


def test_unknown_ext_or_dtype_raises():
    import msgpack

    blob = msgpack.packb({"x": msgpack.ExtType(7, b"abc")})
    with pytest.raises(ValueError, match="ext code 7"):
        serialization.loads(blob)
    inner = msgpack.packb(((2,), "complex64", b"\0" * 16), use_bin_type=True)
    blob = msgpack.packb({"x": msgpack.ExtType(1, inner)})
    with pytest.raises(ValueError, match="complex64"):
        serialization.loads(blob)
