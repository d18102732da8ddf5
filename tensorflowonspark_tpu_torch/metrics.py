"""Host-side serving counters, gauges and latency windows: copies of
the JAX package's ``metrics.Counters``, ``Gauge`` and ``LatencyWindow``
(the port imports nothing from that package).  The continuous batcher
reads its pipeline depth from a :class:`Gauge` and its TTFT from a
:class:`LatencyWindow`."""
import bisect
import threading


class Counters:
    """Thread-safe named monotone counters for the host-side serving
    plane.  Unknown names read as 0: dashboards can reference a counter
    before its first event."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = {}

    def inc(self, name, n=1):
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n
            return self._counts[name]

    def get(self, name):
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self):
        """{name: count} copy, safe to serialize."""
        with self._lock:
            return dict(self._counts)


class Gauge:
    """Thread-safe level gauge with a high-water mark: tracks a
    current value that goes up AND down (unlike :class:`Counters`) plus
    the peak it ever reached.  The async decode engine uses one for
    pipeline depth — steps dispatched but not yet host-processed — where
    ``peak`` is the observable proof the double buffer actually kept >1
    step in flight."""

    def __init__(self, value=0):
        self._lock = threading.Lock()
        self._value = value
        self._peak = value

    def add(self, n=1):
        with self._lock:
            self._value += n
            if self._value > self._peak:
                self._peak = self._value
            return self._value

    @property
    def value(self):
        with self._lock:
            return self._value

    @property
    def peak(self):
        with self._lock:
            return self._peak


class LatencyWindow:
    """Thread-safe latency tracker for the serving plane: a
    bounded window of recent samples for percentiles plus MONOTONE
    count/sum that never resets — the fleet gateway aggregates the
    monotone pair across replicas (percentiles don't sum; averages of
    sums do).  Used for admission->first-token (TTFT) in the
    continuous batcher.  Reads before the first sample return zeros so
    dashboards can reference the keys unconditionally."""

    # Fixed bucket upper bounds (ms), shared by every LatencyWindow so
    # per-replica histograms merge by elementwise sum at the gateway —
    # the summable replacement for the window percentiles, which
    # deliberately never aggregate across replicas.
    BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                  500.0, 1000.0, 2500.0, 5000.0, 10000.0)

    def __init__(self, window=512):
        self._lock = threading.Lock()
        self._recent = []          # bounded ring of recent samples (ms)
        self._window = max(1, int(window))
        self._count = 0            # monotone, fleet-aggregable
        self._sum_ms = 0.0
        # per-bucket (non-cumulative) counts; index len(BUCKETS_MS) is
        # the +Inf overflow bucket
        self._bucket_counts = [0] * (len(self.BUCKETS_MS) + 1)

    def record(self, seconds):
        ms = float(seconds) * 1000.0
        with self._lock:
            self._count += 1
            self._sum_ms += ms
            i = bisect.bisect_left(self.BUCKETS_MS, ms)
            self._bucket_counts[i] += 1
            self._recent.append(ms)
            if len(self._recent) > self._window:
                del self._recent[:len(self._recent) - self._window]

    def histogram(self):
        """Prometheus-style cumulative histogram: ``le`` upper bounds
        (``"+Inf"`` last), cumulative ``counts``, monotone ``count`` /
        ``sum_ms``."""
        with self._lock:
            counts, total = list(self._bucket_counts), self._sum_ms
            n = self._count
        cum, acc = [], 0
        for c in counts:
            acc += c
            cum.append(acc)
        return {"le": [*self.BUCKETS_MS, "+Inf"], "counts": cum,
                "count": n, "sum_ms": round(total, 3)}

    @staticmethod
    def _percentile(sorted_ms, q):
        if not sorted_ms:
            return 0.0
        # nearest-rank on the window: exact for the small-N serving case,
        # no interpolation surprises at the extremes
        i = int(round(q * (len(sorted_ms) - 1)))
        return sorted_ms[min(len(sorted_ms) - 1, i)]

    def stats(self, prefix):
        """{prefix}_count / _ms_sum (monotone, summable across replicas)
        + _avg_ms / _p50_ms / _p95_ms (window-local) + _hist (the
        fixed-bucket cumulative histogram, summable across replicas)."""
        with self._lock:
            count, total = self._count, self._sum_ms
            recent = sorted(self._recent)
        return {
            f"{prefix}_count": count,
            f"{prefix}_ms_sum": round(total, 3),
            f"{prefix}_avg_ms": round(total / count, 3) if count else 0.0,
            f"{prefix}_p50_ms": round(self._percentile(recent, 0.50), 3),
            f"{prefix}_p95_ms": round(self._percentile(recent, 0.95), 3),
            f"{prefix}_hist": self.histogram(),
        }
