"""Evaluation metrics on torch tensors, and the host-side serving
counters, gauges and latency windows: copies of the JAX package's
``metrics`` (the port imports nothing from that package).

The eval half (``accuracy``, ``topk_accuracy``, ``cross_entropy``,
``perplexity``, ``mean_squared_error``, ``confusion_matrix``,
``mean_iou``, ``iou_from_confusion``, :class:`MetricAccumulator`) takes
tensors on any device and returns f32 scalars on that device, so an
eval loop reads back once, at ``MetricAccumulator.result()``.  Each
takes an optional boolean / 0-1 ``mask`` (padding-aware eval: mask off
the rows ``feed.pad_batch`` repeated).  Accumulation is f32, as in the
JAX package; ``topk_accuracy`` breaks ties as JAX's ``argsort`` does
(ascending and stable, the last k taken: among equal logits the higher
index wins), which ``torch.topk`` does not promise.  torch is imported
inside these functions only.

The serving half:  The continuous batcher
reads its pipeline depth and park-pool depth from a :class:`Gauge` and
its TTFT and per-class queue delays from a :class:`LatencyWindow`.

The scrape surface lives here too, as in the JAX package:
:func:`prometheus_text` renders the flat ``stats()`` dicts of the
serving plane into Prometheus text exposition (gauges for numeric keys,
``_bucket`` / ``_sum`` / ``_count`` triplets for
:meth:`LatencyWindow.histogram` dicts), so ``GET /metrics`` is
generated, not hand-maintained.  Imports no torch: a control-plane
process (the fleet gateway) reads it too."""
import bisect
import threading


def _masked_mean(values, mask):
    """``(mean of values over mask, the count)``, f32."""
    import torch

    values = values.float()
    if mask is None:
        return values.mean(), torch.tensor(float(values.numel()),
                                           device=values.device)
    m = mask.float().reshape(values.shape)
    return (values * m).sum() / m.sum().clamp_min(1.0), m.sum()


def accuracy(logits, labels, mask=None):
    """Top-1 accuracy over ``[..., num_classes]`` logits (the first of
    equal maxima is the prediction, as ``jnp.argmax`` takes it)."""
    return _masked_mean(logits.argmax(-1) == labels, mask)[0]


def topk_accuracy(logits, labels, k=5, mask=None):
    """Top-k accuracy: label within the k highest logits, ties broken as
    JAX's stable ascending ``argsort`` breaks them (the last k of it)."""
    import torch

    topk = torch.argsort(logits, dim=-1, stable=True)[..., -k:]
    hit = (topk == labels[..., None]).any(dim=-1)
    return _masked_mean(hit, mask)[0]


def cross_entropy(logits, labels, mask=None):
    """Mean softmax cross entropy with integer labels (f32)."""
    logits = logits.float()
    logz = logits.logsumexp(-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return _masked_mean(logz - gold, mask)[0]


def perplexity(logits, labels, mask=None):
    """exp(mean token cross entropy) — LM eval."""
    return cross_entropy(logits, labels, mask).exp()


def mean_squared_error(pred, target, mask=None):
    return _masked_mean((pred.float() - target.float()) ** 2, mask)[0]


def _one_hot(ids, num_classes):
    """f32 one-hot rows; an id outside ``[0, num_classes)`` gives a zero
    row, as ``jax.nn.one_hot`` does."""
    import torch

    classes = torch.arange(num_classes, device=ids.device)
    return (ids.reshape(-1, 1) == classes).float()


def confusion_matrix(preds, labels, num_classes, mask=None):
    """``[num_classes, num_classes]`` f32 counts, rows = true class: the
    one-hot product ``t.T @ p``, as the JAX package forms it."""
    t = _one_hot(labels, num_classes)
    p = _one_hot(preds, num_classes)
    if mask is not None:
        t = t * mask.float().reshape(-1, 1)
    return t.T @ p


def mean_iou(logits, labels, mask=None, num_classes=None):
    """Mean intersection-over-union over the classes that APPEAR (in
    labels or predictions); ``mask`` excludes ignore pixels.  For a
    multi-batch eval, sum ``confusion_matrix`` per batch and call
    :func:`iou_from_confusion` once."""
    num_classes = num_classes or logits.shape[-1]
    cm = confusion_matrix(logits.argmax(-1), labels, num_classes, mask)
    return iou_from_confusion(cm)


def iou_from_confusion(cm):
    """Mean IoU from an accumulated confusion matrix (rows = true)."""
    import torch

    cm = cm.float()
    tp = cm.diagonal()
    fn = cm.sum(1) - tp
    fp = cm.sum(0) - tp
    denom = tp + fp + fn
    present = denom > 0
    iou = torch.where(present, tp / denom.clamp_min(1.0),
                      torch.zeros_like(tp))
    return iou.sum() / present.sum().clamp_min(1)


class MetricAccumulator:
    """Running weighted means kept on the device until :meth:`result`.

        acc = MetricAccumulator()
        for x, y in batches:
            logits = eval_step(params, x)
            acc.update(n=y.numel(), accuracy=metrics.accuracy(logits, y),
                       loss=metrics.cross_entropy(logits, y))
        print(acc.result())                        # one readback a tag

    Values and the weight ``n`` may be device scalars or plain numbers;
    ``n`` weights the batch (1 an update by default).  With masked
    metrics pass the VALID count as the weight."""

    def __init__(self):
        self._sums = {}
        self._weights = {}

    def update(self, n=1, **values):
        for tag, v in values.items():
            prev_s, prev_w = self._sums.get(tag), self._weights.get(tag)
            s = v * n
            self._sums[tag] = s if prev_s is None else prev_s + s
            self._weights[tag] = n if prev_w is None else prev_w + n

    def result(self):
        """{tag: float} — the only device-to-host reads."""
        return {tag: float(s) / float(self._weights[tag])
                for tag, s in self._sums.items()}


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

    def set(self, value):
        with self._lock:
            self._value = value
            if value > self._peak:
                self._peak = value

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
        ``sum_ms``.  Merge replicas with :meth:`merge_histograms`."""
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
    def merge_histograms(hists):
        """Elementwise-sum histograms from :meth:`histogram` (same
        bucket layout); entries with a foreign layout are skipped."""
        out = None
        for h in hists:
            if not (isinstance(h, dict) and isinstance(h.get("le"), list)
                    and isinstance(h.get("counts"), list)
                    and len(h["le"]) == len(h["counts"])):
                continue
            if out is None:
                out = {"le": list(h["le"]),
                       "counts": list(h["counts"]),
                       "count": int(h.get("count", 0)),
                       "sum_ms": float(h.get("sum_ms", 0.0))}
                continue
            if h["le"] != out["le"]:
                continue
            out["counts"] = [a + b for a, b in
                             zip(out["counts"], h["counts"])]
            out["count"] += int(h.get("count", 0))
            out["sum_ms"] += float(h.get("sum_ms", 0.0))
        if out is not None:
            out["sum_ms"] = round(out["sum_ms"], 3)
        return out

    @staticmethod
    def quantile_from_histogram(hist, q):
        """histogram_quantile-style estimate: linear interpolation
        inside the bucket holding rank ``q``; the overflow bucket
        reports its lower bound (same convention as Prometheus)."""
        if not hist or not hist.get("counts"):
            return 0.0
        cum, les = hist["counts"], hist["le"]
        total = cum[-1]
        if total <= 0:
            return 0.0
        rank = q * total
        prev_cum = 0
        for i, c in enumerate(cum):
            if c >= rank:
                lo = 0.0 if i == 0 else float(les[i - 1])
                if les[i] == "+Inf":
                    return round(lo, 3)
                hi = float(les[i])
                in_bucket = c - prev_cum
                frac = ((rank - prev_cum) / in_bucket) if in_bucket else 1.0
                return round(lo + (hi - lo) * frac, 3)
            prev_cum = c
        return round(float(les[-2]) if len(les) > 1 else 0.0, 3)

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


def _prom_name(name):
    """Sanitize a stats key into a Prometheus metric name."""
    out = []
    for ch in str(name):
        out.append(ch if (ch.isascii() and (ch.isalnum() or ch == "_"))
                   else "_")
    s = "".join(out)
    return ("_" + s) if s[:1].isdigit() else (s or "_")


def _prom_labels(labels):
    if not labels:
        return ""
    body = ",".join(
        '%s="%s"' % (_prom_name(k),
                     str(v).replace("\\", r"\\").replace('"', r'\"'))
        for k, v in sorted(labels.items()))
    return "{%s}" % body


def _prom_value(v):
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        return repr(v)
    return str(v)


def prometheus_text(groups, namespace="tfospark"):
    """Render ``[(subsystem, labels, stats_dict), ...]`` into the
    Prometheus text exposition format (version 0.0.4).

    Numeric values become gauges; dicts shaped like
    :meth:`LatencyWindow.histogram` become ``_bucket``/``_sum``/
    ``_count`` histogram triplets; strings/lists/None are skipped.
    ``# TYPE`` headers are emitted once per metric name even when the
    same name repeats with different labels (per-replica export)."""
    lines = []
    typed = set()

    def emit_type(full, kind):
        if full not in typed:
            typed.add(full)
            lines.append(f"# TYPE {full} {kind}")

    for subsystem, labels, stats in groups:
        base = namespace + ("_" + _prom_name(subsystem)
                            if subsystem else "")
        lab = _prom_labels(labels)
        for key in sorted(stats or {}):
            val = stats[key]
            full = f"{base}_{_prom_name(key)}"
            if isinstance(val, dict):
                if not (isinstance(val.get("le"), list)
                        and isinstance(val.get("counts"), list)):
                    continue
                stem = full[:-5] if full.endswith("_hist") else full
                emit_type(stem, "histogram")
                for le, c in zip(val["le"], val["counts"]):
                    le_lab = dict(labels or {})
                    le_lab["le"] = le
                    lines.append(f"{stem}_bucket{_prom_labels(le_lab)}"
                                 f" {c}")
                lines.append(f"{stem}_sum{lab}"
                             f" {_prom_value(float(val.get('sum_ms', 0.0)))}")
                lines.append(f"{stem}_count{lab}"
                             f" {int(val.get('count', 0))}")
                continue
            if isinstance(val, (int, float)):
                emit_type(full, "gauge")
                lines.append(f"{full}{lab} {_prom_value(val)}")
    return "\n".join(lines) + "\n"

