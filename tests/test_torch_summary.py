"""The port's ``utils.summary`` against the JAX package's.

- the same scalars, steps and wall times (``time.time`` pinned) give an
  event file byte-equal to the JAX package's, under the same file name;
- the JAX package's ``read_scalars`` reads the port's file and the port's
  reads the JAX package's (tags, steps, f32 values equal);
- ``DeferredScalars`` over the same per-step metrics (torch scalars on
  one side, jax arrays on the other, a tag that appears late and
  intermittently, plain numbers) gives the JAX package's flushed values,
  means, counts and lasts, forwards them to its sink, and reads each tag
  back once a flush (one ``.cpu()`` a tag; no ``item()``).
"""
import os
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorflowonspark_tpu.utils import summary as jax_summary
from tensorflowonspark_tpu_torch.utils import summary

POINTS = [("train/loss", 2.5, 1, 1000.25), ("train/loss", 1.75, 2, 1001.5),
          ("eval/accuracy", 0.125, 2, 1002.0), ("train/loss", -3e38, 10 ** 12,
                                                1003.0),
          ("ünïcode/tag", float("inf"), 0, 1004.0)]


def _write(mod, log_dir):
    w = mod.SummaryWriter(str(log_dir))
    for tag, value, step, wall in POINTS:
        w.scalar(tag, value, step, wall_time=wall)
    w.scalars({"a": 1.0, "b": 2}, 7, prefix="m/")
    w.close()
    return w.path


def test_event_files_are_byte_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.5)
    want = _write(jax_summary, tmp_path / "jax")
    got = _write(summary, tmp_path / "port")
    assert os.path.basename(got) == os.path.basename(want)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()


def test_each_reader_reads_the_others_file(tmp_path):
    port_file = _write(summary, tmp_path / "port")
    jax_file = _write(jax_summary, tmp_path / "jax")
    want = [(step, tag, float(np.float32(v))) for tag, v, step, _ in POINTS]
    want += [(7, "m/a", 1.0), (7, "m/b", 2.0)]
    for reader in (summary.read_scalars, jax_summary.read_scalars):
        for path in (port_file, jax_file):
            assert reader(path) == want


def _metrics(step):
    """One step's metrics as (port dict, jax dict)."""
    rs = np.random.RandomState(step)
    loss = np.float32(rs.rand() * 4)
    norm = np.float32(rs.rand())
    port = {"loss": torch.tensor(loss), "grad_norm": torch.tensor(norm)}
    ref = {"loss": jnp.asarray(loss), "grad_norm": jnp.asarray(norm)}
    if step % 3 == 2:                       # a late, intermittent tag
        acc = np.float32(rs.rand())
        port["accuracy"] = torch.tensor(acc).bfloat16()
        ref["accuracy"] = jnp.asarray(acc, jnp.bfloat16)
    return port, ref


class _Sink:
    def __init__(self):
        self.rows, self.flushes = [], 0

    def scalars(self, metrics, step, prefix=""):
        self.rows.append((step, prefix, dict(metrics)))

    def flush(self):
        self.flushes += 1


def test_deferred_scalars_match_jax_and_read_back_once_a_tag(monkeypatch):
    port_sink, jax_sink = _Sink(), _Sink()
    port = summary.DeferredScalars(sink=port_sink, every=4, prefix="train/")
    ref = jax_summary.DeferredScalars(sink=jax_sink, every=4,
                                      prefix="train/")
    reads = []
    real_cpu = torch.Tensor.cpu

    def counted_cpu(self, *a, **kw):
        reads.append(tuple(self.shape))
        return real_cpu(self, *a, **kw)

    def no_item(self):
        raise AssertionError("DeferredScalars read a scalar back alone")

    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)
    monkeypatch.setattr(torch.Tensor, "item", no_item)
    flushed = []
    for step in range(1, 11):
        p, j = _metrics(step)
        n_before = len(port_sink.rows)
        port.append(p, step)
        ref.append(j, step)
        if len(port_sink.rows) != n_before:     # the 4th append flushed
            flushed.append(step)
    assert flushed == [4, 8]
    # flush 1 (steps 1-4): loss, grad_norm, accuracy (step 2); flush 2
    # (steps 5-8): loss, grad_norm, accuracy (steps 5, 8)
    assert reads == [(4,), (4,), (1,), (4,), (4,), (2,)]
    got, want = port.flush(), ref.flush()       # the tail: steps 9, 10
    assert got == want
    monkeypatch.undo()
    assert port.flush() == ref.flush() == []
    assert port_sink.rows == jax_sink.rows
    assert port_sink.flushes == jax_sink.flushes == 3
    for tag in ("loss", "grad_norm", "accuracy", "missing"):
        assert port.count(tag) == ref.count(tag)
        for fn in ("mean", "last"):
            a, b = getattr(port, fn)(tag), getattr(ref, fn)(tag)
            assert (a == b) or (np.isnan(a) and np.isnan(b)), (fn, tag)
    assert port.count("loss") == 10 and port.count("accuracy") == 3


def test_deferred_scalars_take_plain_numbers():
    port, ref = summary.DeferredScalars(), jax_summary.DeferredScalars()
    for step, (a, b) in enumerate(((1.5, 2), (0.1, 3))):
        port.append({"x": a, "n": b}, step)
        ref.append({"x": a, "n": b}, step)
    assert port.flush() == ref.flush()
    assert port.mean("x") == pytest.approx(ref.mean("x"))
    assert port.last("n") == ref.last("n") == 3.0
