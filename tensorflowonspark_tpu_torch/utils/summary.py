"""Dependency-free TensorBoard scalar logging (tfevents format) — a copy
of the JAX package's ``utils/summary.py`` for the port.

`SummaryWriter` emits TensorBoard-readable event files with no
TensorFlow dependency, by hand-encoding the two tiny protos involved
(`Event`, `Summary`) and framing them with the masked-CRC32C record
format of the port's TFRecord layer (``tfrecord``); the same scalars,
steps and wall times give the JAX package's bytes, and each package's
`read_scalars` reads the other's files.  `DeferredScalars` buffers a
train step's metrics as device tensors and reads each tag back once a
flush (one ``torch.stack(...).cpu()``).

Wire format refresher (proto3): each field is a key varint
``(field_number << 3) | wire_type`` followed by the payload; wire types used
here are 0 (varint), 1 (fixed64), 2 (length-delimited), 5 (fixed32).
"""
import os
import socket
import struct
import time

from tensorflowonspark_tpu_torch import tfrecord


def _varint(n):
    out = bytearray()
    n &= (1 << 64) - 1  # proto int64: negatives encode as 10-byte two's complement
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field, wire):
    return _varint((field << 3) | wire)


def _len_delimited(field, payload):
    return _key(field, 2) + _varint(len(payload)) + payload


def _encode_scalar_event(tag, value, step, wall_time):
    # Summary.Value: tag = field 1 (bytes), simple_value = field 2 (float)
    val = (_len_delimited(1, tag.encode("utf-8"))
           + _key(2, 5) + struct.pack("<f", float(value)))
    summary = _len_delimited(1, val)        # Summary.value = repeated field 1
    return (_key(1, 1) + struct.pack("<d", wall_time)   # Event.wall_time
            + _key(2, 0) + _varint(int(step))           # Event.step
            + _len_delimited(5, summary))               # Event.summary


def _encode_file_version(wall_time):
    return (_key(1, 1) + struct.pack("<d", wall_time)
            + _len_delimited(3, b"brain.Event:2"))      # Event.file_version


class SummaryWriter:
    """Writes TensorBoard scalar events under `log_dir`.

    Usage (typically chief-only):

        sw = SummaryWriter(log_dir)
        sw.scalar("train/loss", loss, step)
        sw.close()
    """

    # flush after this many buffered events or this many seconds, whichever
    # first — a live TensorBoard next to the chief sees fresh curves, and an
    # ungracefully-killed worker loses at most one small tail
    FLUSH_EVERY = 16
    FLUSH_SECS = 2.0

    def __init__(self, log_dir, filename_suffix=""):
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}{filename_suffix}")
        self.path = os.path.join(log_dir, name)
        self._writer = tfrecord.TFRecordWriter(self.path)
        self._writer.write(_encode_file_version(time.time()))
        self._pending = 0
        self._last_flush = time.monotonic()
        self.flush()

    def scalar(self, tag, value, step, wall_time=None):
        """Log one scalar point; shows up as a TensorBoard curve per tag."""
        self._writer.write(_encode_scalar_event(
            tag, value, step, time.time() if wall_time is None else wall_time))
        self._pending += 1
        if (self._pending >= self.FLUSH_EVERY
                or time.monotonic() - self._last_flush >= self.FLUSH_SECS):
            self.flush()

    def scalars(self, metrics, step, prefix=""):
        """Log a dict of name -> value at one step (e.g. a train_step's
        metrics dict of scalars).  Flushing rides `scalar`'s
        event-count/age policy so batched callers (DeferredScalars) don't
        pay one file flush per step."""
        for name, value in metrics.items():
            self.scalar(prefix + name, value, step)

    def flush(self):
        self._writer.flush()
        self._pending = 0
        self._last_flush = time.monotonic()

    def close(self):
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class DeferredScalars:
    """Buffers per-step metric dicts as *device* scalars and reads them
    back in batches.

    ``float(metrics["loss"])`` every step forces a host<->device round
    trip per step, serializing dispatch with execution.  Appending the
    raw device scalars instead lets the device run ahead; `flush()`
    stacks each tag's buffered scalars into one tensor and performs ONE
    readback per tag, forwarding the floats to an optional sink
    (`SummaryWriter.scalars`-compatible) and accumulating running means.
    """

    def __init__(self, sink=None, every=64, prefix=""):
        self._sink = sink
        self._every = max(1, int(every))
        self._prefix = prefix
        self._buf = []                      # [(step, {tag: device scalar})]
        self._totals = {}                   # tag -> (sum, count)
        self._last = {}                     # tag -> most recent flushed value

    def append(self, metrics, step):
        """Record one step's metrics dict WITHOUT reading back; flushes
        automatically every `every` appends."""
        self._buf.append((int(step), dict(metrics)))
        if len(self._buf) >= self._every:
            self.flush()

    def flush(self):
        """Read back all buffered scalars (one transfer per tag) and
        forward them to the sink.  Returns [(step, {tag: float})]."""
        if not self._buf:
            return []
        # union of tags across entries: tags may appear late or
        # intermittently (e.g. eval metrics every k steps)
        tags = []
        for _, m in self._buf:
            for tag in m:
                if tag not in tags:
                    tags.append(tag)
        cols = {}                           # tag -> iterator of floats
        for tag in tags:
            vals = [m[tag] for _, m in self._buf if tag in m]
            cols[tag] = iter([float(v) for v in _read_back(vals)])
        out = [(step, {tag: next(cols[tag]) for tag in tags if tag in m})
               for step, m in self._buf]
        # commit before side effects: a sink failure must not leave the
        # buffer re-flushable (double-counting totals, duplicate events)
        self._buf.clear()
        for _, fm in out:
            for tag, v in fm.items():
                s, c = self._totals.get(tag, (0.0, 0))
                self._totals[tag] = (s + v, c + 1)
                self._last[tag] = v
        if self._sink is not None:
            for step, fm in out:
                self._sink.scalars(fm, step, prefix=self._prefix)
            if hasattr(self._sink, "flush"):
                self._sink.flush()  # one file flush per batch, not per step
        return out

    def mean(self, tag):
        """Running mean of a tag over everything flushed so far."""
        s, c = self._totals.get(tag, (0.0, 0))
        return s / c if c else float("nan")

    def count(self, tag):
        s, c = self._totals.get(tag, (0.0, 0))
        return c

    def last(self, tag):
        """Most recently flushed value of a tag (nan before any flush)."""
        return self._last.get(tag, float("nan"))


def _read_back(vals):
    """One tag's buffered values as host numbers: stacked on the device
    and read back in ONE transfer.  Plain numbers join the stack as
    ``jnp.stack`` takes them (a Python float as f32)."""
    import torch

    dev = next((v.device for v in vals if isinstance(v, torch.Tensor)),
               None)
    return torch.stack([torch.as_tensor(v, device=dev).detach().reshape(())
                        for v in vals]).cpu().tolist()


def read_scalars(path):
    """Parse a tfevents file back into [(step, tag, value)] — the symmetric
    reader (used by tests; also handy for headless metric scraping)."""
    out = []
    for record in tfrecord.read_records(path):
        step, summary = 0, None
        for field, wire, payload in _walk(record):
            if field == 2 and wire == 0:
                step = payload
            elif field == 5 and wire == 2:
                summary = payload
        if summary is None:
            continue
        for field, wire, payload in _walk(summary):
            if field == 1 and wire == 2:        # Summary.value entry
                tag, value = None, None
                for f2, w2, p2 in _walk(payload):
                    if f2 == 1 and w2 == 2:
                        tag = p2.decode("utf-8")
                    elif f2 == 2 and w2 == 5:
                        value = struct.unpack("<f", p2)[0]
                if tag is not None and value is not None:
                    out.append((step, tag, value))
    return out


def _walk(buf):
    """Yield (field, wire_type, payload) over one proto message's fields."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            payload, i = _read_varint(buf, i)
        elif wire == 1:
            payload, i = buf[i:i + 8], i + 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            payload, i = buf[i:i + ln], i + ln
        elif wire == 5:
            payload, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, payload


def _read_varint(buf, i):
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7
