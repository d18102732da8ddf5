"""The port's ``data.Dataset`` against the JAX package's.

The same pipelines over the same TFRecord shards (written from a numpy
seed) run through both packages and must give the same records in the
same order and equal batch arrays, exactly (the stages are host code:
the same file order, the same ``random.Random`` seeding, the same numpy
stacking):

- ``shard`` (file-granular and record-granular), ``interleave``,
  ``shuffle(seed)`` reseeded across ``repeat`` epochs, ``map`` /
  ``filter`` / ``skip`` / ``cache`` / ``prefetch``;
- ``batch`` with ``drop_remainder`` and with ``pad_tail``;
- ``from_indexed_tfrecords(global_shuffle=True)`` with a ``shard``, and
  ``from_tfrecord_columns``.

``prefetch_to_device(device="cpu")`` yields torch tensors equal to the
numpy batches; with no device and no CUDA it raises.
"""
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import data as jax_data
from tensorflowonspark_tpu import tfrecord as jax_tfr
from tensorflowonspark_tpu_torch import data as port_data
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_mod


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    rng = np.random.RandomState(3)
    paths = []
    for s, n in enumerate((7, 5, 9, 4)):
        rows = [{"tokens": [int(v) for v in rng.randint(0, 100, 6)],
                 "x": [float(np.float32(v)) for v in rng.randn(2)],
                 "label": int(s * 100 + i)} for i in range(n)]
        path = str(root / f"part-r-{s:05d}")
        jax_tfr.write_examples(path, rows, index=True)
        paths.append(path)
    return str(root), paths


def _parse(ex):
    return (np.asarray(ex["tokens"][1], np.int32),
            np.asarray(ex["x"][1], np.float32), ex["label"][1][0])


def _odd_label(rec):
    return rec[2] % 2 == 1


def _pipelines(mod, root, paths):
    D = mod.Dataset
    return {
        "file_shard_shuffle_repeat": (
            D.from_tfrecords(root).shard(2, 1).map(_parse)
            .shuffle(5, seed=11).repeat(3)),
        "interleave_record_shard": (
            D.from_tfrecords(paths).interleave(cycle_length=3,
                                               block_length=2)
            .map(_parse).shard(3, 2).filter(_odd_label)),
        "skip_cache_repeat_batch_drop": (
            D.from_tfrecords(paths).map(_parse).skip(3).cache()
            .shuffle(4, seed=2).repeat(2).batch(4, drop_remainder=True)),
        "batch_pad_tail": (
            D.from_tfrecords(paths).map(_parse)
            .batch(6, drop_remainder=False, pad_tail=True).prefetch(2)),
        "batch_keep_tail": (
            D.from_tfrecords(paths[:2]).map(_parse)
            .batch(5, drop_remainder=False)),
        "indexed_global_shuffle": (
            D.from_indexed_tfrecords(paths, parse=_parse, global_shuffle=True,
                                     seed=5).shard(2, 0).repeat(2)
            .batch(3)),
        "indexed_blocks": (
            D.from_indexed_tfrecords(paths, parse=_parse, global_shuffle=True,
                                     seed=1, shuffle_block=2)),
        "columns": D.from_tfrecord_columns(root, ["tokens", "x"], 4,
                                           drop_remainder=False,
                                           shuffle=True, seed=9),
    }


def _flat(item):
    """A record or a batch as a list of arrays (in structure order)."""
    if isinstance(item, dict):
        return [np.asarray(item[k]) for k in sorted(item)]
    if isinstance(item, (tuple, list)):
        return [np.asarray(v) for v in item]
    return [np.asarray(item)]


@pytest.mark.parametrize("name", list(_pipelines(port_data, "", [])))
def test_pipelines_match_jax(shards, name):
    root, paths = shards
    got = list(_pipelines(port_data, root, paths)[name])
    want = list(_pipelines(jax_data, root, paths)[name])
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        gf, wf = _flat(g), _flat(w)
        assert len(gf) == len(wf)
        for a, b in zip(gf, wf):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_prefetch_to_device_cpu_and_device_rule(shards, monkeypatch):
    _, paths = shards
    ds = port_data.Dataset.from_tfrecords(paths).map(_parse).batch(4)
    want = list(ds)
    got = list(ds.prefetch_to_device(depth=3, device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for t in g)
        for t, a in zip(g, w):
            np.testing.assert_array_equal(t.numpy(), a)
    # sharding= on a mesh of one rank: this rank's rows are every row
    sh = mesh_mod.batch_sharding(mesh_mod.build_mesh(device="cpu"))
    for g, w in zip(ds.prefetch_to_device(sharding=sh), want, strict=True):
        for t, a in zip(g, w):
            np.testing.assert_array_equal(t.numpy(), a)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.prefetch_to_device()
