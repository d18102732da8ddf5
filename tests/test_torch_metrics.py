"""The port's serving gauges against the JAX package's.

``metrics.Gauge`` (level and high-water mark) and
``metrics.LatencyWindow`` (bounded window percentiles, monotone count and
sum, the fixed-bucket histogram) are copies in the port.  The same
sequence of updates, drawn from a seed with numpy, goes into the port's
class and the JAX package's; every reading must be equal exactly.
"""
import numpy as np
import pytest

from tensorflowonspark_tpu import metrics as jax_metrics
from tensorflowonspark_tpu_torch import metrics as port_metrics


def test_gauge_level_and_peak_match_jax():
    rng = np.random.RandomState(0)
    port, ref = port_metrics.Gauge(), jax_metrics.Gauge()
    for _ in range(200):
        n = int(rng.randint(-2, 3))
        assert port.add(n) == ref.add(n)
        assert (port.value, port.peak) == (ref.value, ref.peak)
    assert port.peak >= port.value


@pytest.mark.parametrize("window", [1, 8, 512])
def test_latency_window_matches_jax(window):
    rng = np.random.RandomState(window)
    port = port_metrics.LatencyWindow(window=window)
    ref = jax_metrics.LatencyWindow(window=window)
    assert port.stats("ttft") == ref.stats("ttft")     # zeros before data
    # seconds spanning every bucket, the +Inf overflow included
    for s in np.exp(rng.uniform(np.log(1e-4), np.log(20.0), 300)):
        port.record(float(s))
        ref.record(float(s))
    got, want = port.stats("ttft"), ref.stats("ttft")
    assert got == want
    assert got["ttft_count"] == 300 and got["ttft_hist"]["count"] == 300
    assert port.histogram() == ref.histogram()
