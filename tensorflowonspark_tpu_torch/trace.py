"""Request-scoped distributed tracing for the serving stack: a copy of
``tensorflowonspark_tpu/trace.py`` (the port imports nothing from that
package, and this module imports no torch).

A trace ID is minted (or accepted via ``X-Trace-Id``) at the fleet
gateway, forwarded in the replica-bound body exactly like priority
classes (``fleet.py``), carried inside the batcher's pending item, and
— for the exotic hops — inside the wire-snapshot meta (migration,
park/unpark) and the journal replay meta, so one request keeps one ID
across every process that ever touches it.

Each process holds a :class:`Recorder`: a bounded ring of completed
spans stamped with the host monotonic clock.  Nothing here ever reads
a device value — decode-tick spans are recorded from the host drain
thread (``_host_loop``) at token-commit time, so the async engine
stays hostsync-clean.  The ring is a ``collections.deque(maxlen=...)``:
recording is O(1), old spans fall off the back, and a wedged or
fault-injected exporter can never apply backpressure to serving
(``faults.deny("trace.export")`` makes the recorder drop spans
silently — streams must stay byte-identical).

Span shape (JSON-ready)::

    {"trace": "4f2a…", "name": "prefill", "t0_ms": 12.3,
     "t1_ms": 14.9, "dur_ms": 2.6, "attrs": {"row": 3, "chunk": 256}}

``t0_ms``/``t1_ms`` are ``time.monotonic()`` milliseconds — comparable
within one process only; the gateway's ``GET /v1/trace/<id>`` stitches
per-process timelines side by side (tagged with their source) rather
than pretending clocks align.

Lifecycle discipline: a span handed out by :meth:`Recorder.begin` must
reach exactly one of :meth:`Recorder.end` / :meth:`Recorder.abandon`.
Sites that cannot scope a span inside one function use
:meth:`Recorder.span_at` with explicit endpoints instead — nothing
open ever escapes.
"""
import collections
import contextlib
import threading
import time
import uuid

from tensorflowonspark_tpu_torch import faults

# Hex digits plus dashes: accepts both uuid4().hex and W3C-style
# dashed trace ids from external callers.  Anything else is rejected
# at the door (gateway mints a fresh id; replica _validate 400s).
_ID_CHARS = frozenset("0123456789abcdefABCDEF-")
MAX_ID_LEN = 64

# Stage names recorded by the stack, for reference and docs:
#   gateway.route  gateway.relay  gateway.replay
#   queue  admit  prefill  decode  retire
#   freeze  wire  resume  replay  park  unpark
#   promote  prefix_pull
#   job.submit  job.partition  job.record  job.cancel  job.done
DEFAULT_RING = 4096
DEFAULT_DECODE_SAMPLE = 16


def new_id():
    """A fresh 32-hex-char trace id."""
    return uuid.uuid4().hex


def valid_id(tid):
    """True for a plausible externally-supplied trace id."""
    return (isinstance(tid, str) and 0 < len(tid) <= MAX_ID_LEN
            and not set(tid) - _ID_CHARS)


def _now_ms():
    return time.monotonic() * 1000.0


class Recorder:
    """Bounded per-process span ring.

    Every method tolerates ``trace_id=None`` (untraced request) by
    doing nothing and returning ``None`` — call sites never branch on
    whether tracing is on, which keeps the traced and untraced code
    paths literally the same instructions apart from dict stores.
    """

    def __init__(self, capacity=DEFAULT_RING,
                 decode_sample=DEFAULT_DECODE_SAMPLE):
        self.capacity = int(capacity) if capacity else DEFAULT_RING
        # every Nth committed host tick per traced row gets a decode
        # span; 0/None disables decode sampling entirely
        self.decode_sample = int(decode_sample or 0)
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=self.capacity)
        self.recorded = 0       # spans accepted into the ring
        self.dropped = 0        # spans dropped by the export fault site

    # -- recording ----------------------------------------------------

    def begin(self, trace_id, name, **attrs):
        """Open a span; returns the span token (or None when
        untraced).  Must be balanced by end()/abandon()."""
        if not trace_id:
            return None
        return {"trace": trace_id, "name": name, "t0_ms": _now_ms(),
                "attrs": attrs}

    def end(self, span, **attrs):
        """Close and record a span from begin()."""
        if span is None:
            return
        span["t1_ms"] = _now_ms()
        if attrs:
            span["attrs"].update(attrs)
        self._push(span)

    def abandon(self, span):
        """Close a span whose operation failed; recorded with an
        ``abandoned`` marker so the timeline shows the cut."""
        if span is None:
            return
        span["attrs"]["abandoned"] = True
        span["t1_ms"] = _now_ms()
        self._push(span)

    def event(self, trace_id, name, **attrs):
        """A zero-duration span (point event)."""
        if not trace_id:
            return
        t = _now_ms()
        self._push({"trace": trace_id, "name": name, "t0_ms": t,
                    "t1_ms": t, "attrs": attrs})

    def span_at(self, trace_id, name, t0, t1, **attrs):
        """Record a completed span with explicit monotonic endpoints
        (seconds, as from ``time.monotonic()``) — for stages whose
        start was stamped in another function/thread."""
        if not trace_id:
            return
        self._push({"trace": trace_id, "name": name,
                    "t0_ms": t0 * 1000.0, "t1_ms": t1 * 1000.0,
                    "attrs": attrs})

    @contextlib.contextmanager
    def span(self, trace_id, name, **attrs):
        """Context manager for spans scoped to one block; failures
        inside the block record the span with ``abandoned`` set."""
        s = self.begin(trace_id, name, **attrs)
        try:
            yield s
        except BaseException:
            self.abandon(s)
            raise
        self.end(s)

    def _push(self, span):
        span["dur_ms"] = round(span["t1_ms"] - span["t0_ms"], 3)
        span["t0_ms"] = round(span["t0_ms"], 3)
        span["t1_ms"] = round(span["t1_ms"], 3)
        if faults.deny("trace.export"):
            # chaos site: the observability plane "failing" must cost
            # spans, never tokens — drop silently and count it
            with self._lock:
                self.dropped += 1
            return
        with self._lock:
            self._ring.append(span)
            self.recorded += 1

    # -- querying -----------------------------------------------------

    def spans(self, trace_id):
        """All retained spans for a trace id, oldest first."""
        with self._lock:
            return [dict(s) for s in self._ring
                    if s["trace"] == trace_id]

    def summary(self, trace_id):
        """Compact per-request digest for the final stream event:
        span count and per-stage {count, total ms}."""
        found = self.spans(trace_id)
        if not found:
            return None
        stages = {}
        for s in found:
            st = stages.setdefault(s["name"], {"count": 0, "ms": 0.0})
            st["count"] += 1
            st["ms"] = round(st["ms"] + s["dur_ms"], 3)
        return {"id": trace_id, "spans": len(found), "stages": stages}

    def stats(self):
        with self._lock:
            return {"trace_spans_recorded": self.recorded,
                    "trace_spans_dropped": self.dropped,
                    "trace_ring_len": len(self._ring),
                    "trace_ring_capacity": self.capacity}
