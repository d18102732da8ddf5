"""The port's meshes (``parallel.mesh``) against the JAX package's.

Pure functions, with no process group: ``MeshSpec.resolve`` and its
errors, ``hybrid_device_array`` on stand-in devices (grouped by
``slice_index`` and contiguously) with its bad-factoring errors, the
port's raise where JAX's auto mode degrades, meshes of a world of one
(every collective short-circuits), abstract meshes, the batch row
blocks, and ``put_batch`` / ``device_prefetch(sharding=)`` on one rank.
The many-rank forms run in ``test_torch_sharded_train.py``.
"""
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.parallel import mesh as jax_mesh
from tensorflowonspark_tpu_torch import feed
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_mod


class FakeDev:
    def __init__(self, i, slice_index):
        self.id = i
        self.slice_index = slice_index


def test_axes_match_jax():
    assert mesh_mod.ALL_AXES == jax_mesh.ALL_AXES
    assert mesh_mod.BATCH_AXES == jax_mesh.BATCH_AXES


@pytest.mark.parametrize("spec,n", [
    (dict(dp=-1), 8), (dict(dp=-1, fsdp=4), 8), (dict(dp=-1, pp=2, tp=2), 8),
    (dict(dp=2, fsdp=2), 4), (dict(dp=3, tp=3), 8), (dict(dp=-1, fsdp=3), 8),
    (dict(dp=1, fsdp=4), 8)])
def test_mesh_spec_resolve_matches_jax(spec, n):
    try:
        want = jax_mesh.MeshSpec(**spec).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_mod.MeshSpec(**spec).resolve(n)
        assert str(got.value) == str(e)
        return
    got = mesh_mod.MeshSpec(**spec).resolve(n)
    assert got.shape == want.shape
    assert got.batch_size_divisor == want.batch_size_divisor


@pytest.mark.parametrize("grouped", [False, True], ids=["contiguous",
                                                        "slice_index"])
def test_hybrid_device_array_matches_jax(grouped):
    devs = ([FakeDev(i, slice_index=i % 2) for i in range(8)] if grouped
            else list(range(8)))
    for kw in (dict(dp=4, tp=2), dict(dp=2, pp=2, tp=2), dict(dp=2, fsdp=4)):
        spec = mesh_mod.MeshSpec(**kw).resolve(8)
        got = mesh_mod.hybrid_device_array(spec, devs, num_slices=2)
        want = jax_mesh.hybrid_device_array(
            jax_mesh.MeshSpec(**kw).resolve(8), devs, num_slices=2)
        assert got.shape == want.shape == spec.shape
        assert [id(d) for d in got.ravel()] == [id(d) for d in want.ravel()]
        if grouped:
            # every device in dp row i belongs to slice i // (dp / 2)
            for i in range(spec.dp):
                assert {d.slice_index for d in got[i].ravel()} == {
                    i // (spec.dp // 2)}


def test_hybrid_device_array_rejects_bad_factoring():
    spec = mesh_mod.MeshSpec(dp=3).resolve(3)
    with pytest.raises(ValueError, match="divisible by num_slices"):
        mesh_mod.hybrid_device_array(spec, list(range(3)), num_slices=2)
    spec = mesh_mod.MeshSpec(dp=4, tp=2).resolve(8)
    with pytest.raises(ValueError, match="span 4 slices"):
        mesh_mod.hybrid_device_array(
            spec, [FakeDev(i, i % 4) for i in range(8)], num_slices=2)
    spec = mesh_mod.MeshSpec(dp=6).resolve(6)
    with pytest.raises(ValueError, match="slice 0 has 4 devices"):
        mesh_mod.hybrid_device_array(
            spec, [FakeDev(i, 0 if i < 4 else 1) for i in range(6)],
            num_slices=2)


def test_auto_hybrid_raises_where_jax_degrades(monkeypatch):
    """JAX's auto mode falls back to one slice when dp cannot factor over
    the slices; the port raises, as JAX's explicit ``num_slices`` does."""
    devs = [mesh_mod.RankDevice(i, f"h{i // 3}", i // 3) for i in range(6)]
    monkeypatch.setattr(mesh_mod, "rank_devices", lambda: devs)
    with pytest.raises(ValueError, match="divisible by num_slices=2"):
        mesh_mod.build_hybrid_mesh(mesh_mod.MeshSpec(dp=3, tp=2))


def test_world_of_one_mesh_short_circuits():
    m = mesh_mod.build_mesh(device="cpu")
    assert m.shape == {"dp": 1, "fsdp": 1, "pp": 1, "tp": 1}
    assert m.coords == {"dp": 0, "fsdp": 0, "pp": 0, "tp": 0}
    assert m.group(mesh_mod.BATCH_AXES).pg is None
    assert mesh_mod.detect_num_slices(mesh_mod.rank_devices()) == 1
    h = mesh_mod.build_hybrid_mesh(device="cpu")
    assert h.shape == m.shape and h.devices.tolist() == [[[[0]]]]
    assert mesh_mod.local_mesh_spec().shape == (1, 1, 1, 1)
    with pytest.raises(ValueError, match="does not match 1 devices"):
        mesh_mod.build_mesh(mesh_mod.MeshSpec(dp=2), device="cpu")


def test_abstract_mesh_rows_and_placement():
    m = mesh_mod.Mesh(mesh_mod.MeshSpec(dp=2, fsdp=4).resolve(8), rank=6)
    assert m.coords == {"dp": 1, "fsdp": 2, "pp": 0, "tp": 0}
    assert m.index(mesh_mod.BATCH_AXES) == 6 and m.extent("fsdp") == 4
    rows = np.arange(16).reshape(16, 1)
    np.testing.assert_array_equal(mesh_mod.local_rows(rows, m), rows[12:14])
    assert mesh_mod.batch_sharding(m).spec == (("dp", "fsdp"),)
    assert mesh_mod.replicated_sharding(m).spec == ()
    with pytest.raises(ValueError, match="abstract"):
        m.check_placeable()
    # a tp mesh places like any other once it has ranks; abstract, it
    # holds none
    tp = mesh_mod.Mesh(mesh_mod.MeshSpec(dp=4, tp=2).resolve(8), rank=5)
    with pytest.raises(ValueError, match="abstract"):
        tp.check_placeable()
    assert tp.coords == {"dp": 2, "fsdp": 0, "pp": 0, "tp": 1}
    assert tp.neighbor("tp", 1) == 4 and tp.neighbor("dp", -1) == 3
    # tp ranks hold the same rows; a sequence axis also splits dim 1
    np.testing.assert_array_equal(mesh_mod.local_rows(rows, tp), rows[8:12])
    seq = np.arange(16 * 8).reshape(16, 8)
    np.testing.assert_array_equal(
        mesh_mod.local_rows(seq, tp, seq_axis="tp"), seq[8:12, 4:])
    assert mesh_mod.batch_sharding(tp, "tp").spec == (("dp", "fsdp"), "tp")
    with pytest.raises(ValueError, match="divisible by"):
        mesh_mod.local_rows(np.zeros((16, 7)), tp, seq_axis="tp")
    with pytest.raises(ValueError, match="does not split over 8"):
        mesh_mod.local_rows(np.zeros((4, 2)), m)


def test_put_batch_and_prefetch_on_one_rank():
    m = mesh_mod.build_mesh(device="cpu")
    sh = mesh_mod.batch_sharding(m)
    batch = {"x": np.arange(6.0).reshape(3, 2), "y": np.arange(3)}
    got = mesh_mod.put_batch(batch, sh)
    assert isinstance(got["x"], torch.Tensor) and got["x"].device.type == "cpu"
    np.testing.assert_array_equal(got["x"].numpy(), batch["x"])
    out = list(feed.device_prefetch(iter([batch["x"], batch["x"] * 2]),
                                    sharding=sh))
    np.testing.assert_array_equal(out[1].numpy(), batch["x"] * 2)


def test_sharded_prefetch_holds_later_batches_to_the_first_shapes():
    """The prefetch checks the first batch across ranks and every later
    one against it on this rank, so a ragged tail raises (pad it)."""
    sh = mesh_mod.batch_sharding(mesh_mod.build_mesh(device="cpu"))
    a = np.arange(6.0).reshape(3, 2)
    with pytest.raises(ValueError, match=r"first batch's local shapes "
                       r"\[\(3, 2\)\]; got \[\(2, 2\)\]"):
        list(feed.device_prefetch(iter([a, a[:2]]), sharding=sh))
    padded = feed.pad_batch(a[:2], 3)
    out = list(feed.device_prefetch(iter([a, padded]), sharding=sh))
    np.testing.assert_array_equal(out[1].numpy(), padded)
