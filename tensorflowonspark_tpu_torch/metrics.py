"""Host-side serving counters (a copy of the JAX package's
``metrics.Counters``; the port imports nothing from that package)."""
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
