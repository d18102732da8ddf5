"""The port's eval metrics against the JAX package's.

The same numpy inputs (``np.random.RandomState`` draws) go through each
JAX function and its port counterpart on CPU tensors, with and without
a mask: accuracy, top-k accuracy (integer-valued logits full of ties, so
the tie order decides hits), cross entropy, perplexity, mean squared
error, the confusion matrix (labels outside the classes give zero rows),
mean IoU (classes absent from labels and predictions) and the IoU of an
accumulated matrix; ``MetricAccumulator`` over uneven batches with
device-scalar and plain weights.  Tolerance 1e-6 (f32 on both sides;
sums in other orders); counts and hits exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorflowonspark_tpu import metrics as jax_metrics
from tensorflowonspark_tpu_torch import metrics

TOL = 1e-6


def _both(fn, *arrays, mask=None, **kw):
    """(port result, JAX result) as numpy for the same arrays."""
    if mask is not None:
        kw["mask"] = mask
    got = getattr(metrics, fn)(*(torch.from_numpy(a) for a in arrays),
                               **{k: torch.from_numpy(v) if isinstance(
                                   v, np.ndarray) else v
                                  for k, v in kw.items()})
    want = getattr(jax_metrics, fn)(*(jnp.asarray(a) for a in arrays),
                                    **{k: jnp.asarray(v) if isinstance(
                                        v, np.ndarray) else v
                                       for k, v in kw.items()})
    return got.numpy(), np.asarray(want)


def _mask(rs, shape):
    m = rs.rand(*shape) < 0.7
    m.flat[0] = True
    return m


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fn", ["accuracy", "cross_entropy", "perplexity"])
def test_classification_metrics_match_jax(fn, masked):
    rs = np.random.RandomState(1)
    logits = rs.randn(4, 9, 11).astype(np.float32)
    labels = rs.randint(0, 11, (4, 9))
    mask = _mask(rs, (4, 9)) if masked else None
    got, want = _both(fn, logits, labels, mask=mask)
    assert got.dtype == np.float32 and got.shape == ()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_topk_accuracy_breaks_ties_as_jax(k, masked):
    rs = np.random.RandomState(2)
    # integer logits in 0..3 over 12 classes: every row is full of ties
    logits = rs.randint(0, 4, (64, 12)).astype(np.float32)
    labels = rs.randint(0, 12, (64,))
    mask = _mask(rs, (64,)) if masked else None
    got, want = _both("topk_accuracy", logits, labels, mask=mask, k=k)
    np.testing.assert_array_equal(got, want)
    # the ties decide: taking the lowest index among tied logits (a
    # stable descending sort) scores these inputs differently
    low = np.argsort(-logits, axis=-1, kind="stable")[:, :k]
    hit = (low == labels[:, None]).any(-1)
    low_first = hit[mask].mean() if masked else hit.mean()
    assert abs(low_first - float(got)) > 1e-3


def test_topk_accuracy_bf16_logits():
    rs = np.random.RandomState(3)
    logits = rs.randint(0, 3, (32, 8)).astype(np.float32)
    labels = rs.randint(0, 8, (32,))
    got = metrics.topk_accuracy(torch.from_numpy(logits).bfloat16(),
                                torch.from_numpy(labels), k=2)
    want = jax_metrics.topk_accuracy(jnp.asarray(logits, jnp.bfloat16),
                                     jnp.asarray(labels), k=2)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True])
def test_mean_squared_error_matches_jax(masked):
    rs = np.random.RandomState(4)
    pred = rs.randn(6, 5).astype(np.float32)
    target = rs.randn(6, 5).astype(np.float32)
    mask = _mask(rs, (6, 5)) if masked else None
    got, want = _both("mean_squared_error", pred, target, mask=mask)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_confusion_matrix_matches_jax(masked):
    rs = np.random.RandomState(5)
    preds = rs.randint(0, 5, (3, 40))
    labels = rs.randint(-1, 5, (3, 40))      # -1: outside the classes
    mask = _mask(rs, (3, 40)) if masked else None
    got, want = _both("confusion_matrix", preds, labels, mask=mask,
                      num_classes=5)
    assert got.shape == (5, 5) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_mean_iou_with_absent_classes_matches_jax(masked):
    rs = np.random.RandomState(6)
    C = 7
    logits = rs.randn(2, 16, 16, C).astype(np.float32)
    logits[..., 5:] -= 100.0                 # classes 5, 6 never predicted
    labels = rs.randint(0, 4, (2, 16, 16))   # ... and 4-6 never labelled
    mask = _mask(rs, (2, 16, 16)) if masked else None
    got, want = _both("mean_iou", logits, labels, mask=mask)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    got, want = _both("mean_iou", logits, labels, mask=mask,
                      num_classes=9)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_iou_from_an_accumulated_confusion_matches_jax():
    rs = np.random.RandomState(7)
    cm = np.zeros((6, 6), np.float32)
    for _ in range(3):
        preds, labels = rs.randint(0, 4, 50), rs.randint(0, 5, 50)
        cm += metrics.confusion_matrix(torch.from_numpy(preds),
                                       torch.from_numpy(labels),
                                       6).numpy()
    got, want = _both("iou_from_confusion", cm)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    got, want = _both("iou_from_confusion", np.zeros((3, 3), np.float32))
    assert got == want == 0.0


def test_metric_accumulator_over_uneven_batches_matches_jax():
    rs = np.random.RandomState(8)
    port, ref = metrics.MetricAccumulator(), jax_metrics.MetricAccumulator()
    for i, n in enumerate((7, 3, 11, 1)):
        logits = rs.randn(n, 10).astype(np.float32)
        labels = rs.randint(0, 10, n)
        mask = _mask(rs, (n,))
        t_logits, t_labels, t_mask = (torch.from_numpy(a)
                                      for a in (logits, labels, mask))
        j_logits, j_labels, j_mask = (jnp.asarray(a)
                                      for a in (logits, labels, mask))
        # device-scalar weights on even batches, plain ints on odd ones
        port.update(n=t_mask.sum() if i % 2 == 0 else int(mask.sum()),
                    accuracy=metrics.accuracy(t_logits, t_labels, t_mask),
                    loss=metrics.cross_entropy(t_logits, t_labels, t_mask))
        ref.update(n=j_mask.sum() if i % 2 == 0 else int(mask.sum()),
                   accuracy=jax_metrics.accuracy(j_logits, j_labels,
                                                 j_mask),
                   loss=jax_metrics.cross_entropy(j_logits, j_labels,
                                                  j_mask))
        port.update(steps=1.0)
        ref.update(steps=1.0)
    got, want = port.result(), ref.result()
    assert sorted(got) == sorted(want) == ["accuracy", "loss", "steps"]
    for tag in want:
        assert got[tag] == pytest.approx(want[tag], rel=TOL, abs=TOL), tag
    assert metrics.MetricAccumulator().result() == {}
