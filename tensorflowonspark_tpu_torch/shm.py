"""Shared-memory data plane for the executor feed path — counterpart of
``tensorflowonspark_tpu/shm.py``, whose ring layout and payload format it
keeps byte for byte (a payload encoded by either package decodes in the
other).

The reference moves every record through `multiprocessing.managers`
queue proxies — each put/get serializes the payload through a socket to
the manager server process (reference: TFManager.py:51-65), which tops
out around 10 MB/s. This module keeps that queue for what it is good at
— ordering, `task_done`/`join` accounting, and the `None`/`EndPartition`
marker protocol — and moves the *bytes* through a named
`multiprocessing.shared_memory` slot ring instead (SURVEY.md §7
"process-boundary feed throughput"):

    feeder process                       node (consumer) process
    ------------------                   -----------------------
    encode chunk -> ring.write() ---\\    q.get() -> ShmRef
    q.put(ShmRef(seq, ...))  --------+-> ring.read(ref) -> chunk
                                     |   q.task_done()
         [payload: one memcpy into   |
          /dev/shm, one memcpy out]  |
         [queue: ~100-byte ref]   ---/

Design points:

- **Slot ring, byte-granular frames.** The segment is `nslots` fixed
  slots plus a header page. A payload occupies `ceil(nbytes/slot_bytes)`
  consecutive slots (by sequence number, wrapping). Per-slot state is a
  single byte (0=free, 1=full): single-byte stores are atomic, so no
  cross-process locks are needed for the one-producer-at-a-time /
  one-consumer discipline the executor feed already guarantees (Spark
  runs one task per executor core; LocalBackend serializes tasks per
  executor the same way).
- **Sequence numbers live in the segment**, so successive feeder *tasks*
  (separate short-lived processes) continue where the previous one left
  off. Concurrent producers on one node are NOT supported — same
  constraint the reference's EndPartition accounting already imposes.
- **Refs ride the queue** (`ShmRef`), so FIFO order, backpressure-on-
  join, error propagation, and `terminate()` draining all keep their
  reference semantics; a drained ref is `skip()`ed to free its slots.
- **Payloads are columnar.** `encode_chunk` writes a tiny pickled meta
  header plus the raw column buffers of a `marker.PackedChunk`;
  non-packable chunks fall back to one pickle blob — still a single
  memcpy through the ring rather than a socket write.

The ring is created by the node bootstrap before registration and
advertised through the manager kv store under ``shm_ring``; producers
and consumers attach by name. `TFOS_TPU_SHM_RING=0` disables the data
plane (the queue then carries whole chunks); `TFOS_TPU_RING_MB` sizes it
(default 64).  The pickled parts of a payload are written and read only
by the processes of one node on one host, through a segment whose name
is random: unlike the reservation socket, nothing here reads bytes from
the network.
"""
import json
import logging
import os
import pickle
import struct
import threading
import time
import uuid

from . import marker

logger = logging.getLogger(__name__)

_MAGIC = 0x54464F53524E4731  # "TFOSRNG1"
_HEADER_BYTES = 4096
_STATE_OFF = 64          # per-slot state bytes start here
_FREE, _FULL = 0, 1

DEFAULT_RING_MB = 64
# finer slots bound fragmentation: a payload wastes at most one slot
DEFAULT_NSLOTS = 64


class RingTimeout(TimeoutError):
    """The consumer did not free ring space within the wait budget."""


class ShmRef:
    """Queue-borne reference to a payload in the ring.

    ``seq`` is the first frame's sequence number, ``nframes`` how many
    consecutive frames it spans, ``nbytes`` the payload length, and
    ``count`` the record count (so accounting needs no decode).
    """

    __slots__ = ("seq", "nframes", "nbytes", "count")

    def __init__(self, seq, nframes, nbytes, count):
        self.seq = seq
        self.nframes = nframes
        self.nbytes = nbytes
        self.count = count

    def __len__(self):
        return self.count

    def __repr__(self):
        return (f"ShmRef(seq={self.seq}, frames={self.nframes}, "
                f"bytes={self.nbytes}, n={self.count})")

    def __reduce__(self):
        return (ShmRef, (self.seq, self.nframes, self.nbytes, self.count))


RING_FILE = ".tfos_shm_ring"


def advertise_file(info, workdir=None):
    """Drop the ring coordinates next to the executor-id file, so feeders
    and the node process (whose cwd is the executor dir, like the
    reference's executor-id trick, reference: util.py:77-94) can discover
    the ring without a manager kv round trip (~0.2 s of AutoProxy setup
    per feeder task)."""
    path = os.path.join(workdir or os.getcwd(), RING_FILE)
    with open(path, "w") as f:
        json.dump(info, f)


def remove_advertisement(workdir=None):
    try:
        os.remove(os.path.join(workdir or os.getcwd(), RING_FILE))
    except OSError:
        pass


def discover(mgr=None, workdir=None):
    """Ring info from the cwd file (fast path) or the manager kv store
    (set alongside the file; survives callers with a different cwd)."""
    path = os.path.join(workdir or os.getcwd(), RING_FILE)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        pass
    if mgr is not None:
        try:
            from . import manager as manager_mod
            return manager_mod.get_value(mgr, "shm_ring")
        except Exception:
            return None
    return None

_attach_lock = threading.Lock()


def _supports_track_kwarg():
    import inspect
    from multiprocessing import shared_memory
    try:
        return "track" in inspect.signature(
            shared_memory.SharedMemory.__init__).parameters
    except (TypeError, ValueError):
        return False


_HAS_TRACK = _supports_track_kwarg()


def _attach_untracked(name):
    """Open an existing segment WITHOUT resource-tracker registration.

    Python 3.12's SharedMemory registers ATTACHES with the resource
    tracker too, whose exit handler would unlink the segment when a
    short-lived feeder task exits (bpo-38119). Only the creator may own
    the name — unregister-after-attach would instead delete the creator's
    entry in a fork-shared tracker.

    On 3.13+ attaches pass ``track=False`` natively, so concurrent
    SharedMemory creation on other threads is never affected.  On 3.12
    the fallback patches ``resource_tracker.register`` process-wide for
    the duration of the attach; `_attach_lock` serializes our own
    attaches, and the window is a single shm_open — an unrelated create
    racing it would skip tracker registration (leaking that name on
    abnormal exit), which is why the native kwarg is preferred whenever
    present."""
    from multiprocessing import resource_tracker, shared_memory
    if _HAS_TRACK:
        return shared_memory.SharedMemory(name=name, create=False,
                                          track=False)
    with _attach_lock:
        orig = resource_tracker.register
        resource_tracker.register = lambda name, rtype: None
        try:
            return shared_memory.SharedMemory(name=name, create=False)
        finally:
            resource_tracker.register = orig


class ShmChunkRing:
    """Fixed-slot shared-memory ring; see module docstring for protocol."""

    def __init__(self, shm_obj, nslots, slot_bytes, owner):
        self._shm = shm_obj
        self._buf = shm_obj.buf
        self.nslots = nslots
        self.slot_bytes = slot_bytes
        self._owner = owner
        self._unlinked = False

    # -- lifecycle -----------------------------------------------------

    @classmethod
    def create(cls, slot_bytes=None, nslots=None, name=None):
        from multiprocessing import shared_memory

        if slot_bytes is None or nslots is None:
            total_mb = int(os.environ.get("TFOS_TPU_RING_MB", DEFAULT_RING_MB))
            nslots = nslots or DEFAULT_NSLOTS
            slot_bytes = slot_bytes or max((total_mb << 20) // nslots, 1 << 16)
        assert nslots >= 2 and _STATE_OFF + nslots <= _HEADER_BYTES
        name = name or f"tfos_ring_{uuid.uuid4().hex[:12]}"
        size = _HEADER_BYTES + nslots * slot_bytes
        shm_obj = shared_memory.SharedMemory(name=name, create=True, size=size)
        buf = shm_obj.buf
        struct.pack_into("<QIIQ", buf, 0, _MAGIC, nslots, 0, 0)
        struct.pack_into("<Q", buf, 16, 0)                  # produced_seq
        struct.pack_into("<Q", buf, 24, slot_bytes)
        buf[_STATE_OFF:_STATE_OFF + nslots] = bytes(nslots)  # all free
        ring = cls(shm_obj, nslots, slot_bytes, owner=True)
        logger.info("created shm ring %s (%d slots x %d bytes)",
                    name, nslots, slot_bytes)
        return ring

    @classmethod
    def attach(cls, info):
        shm_obj = _attach_untracked(info["name"])
        buf = shm_obj.buf
        magic, nslots, _, _ = struct.unpack_from("<QIIQ", buf, 0)
        if magic != _MAGIC:
            shm_obj.close()
            raise ValueError(f"{info['name']}: not a tfos ring segment")
        (slot_bytes,) = struct.unpack_from("<Q", buf, 24)
        return cls(shm_obj, nslots, slot_bytes, owner=False)

    def info(self):
        return {"name": self._shm.name, "nslots": self.nslots,
                "slot_bytes": self.slot_bytes}

    @property
    def capacity_bytes(self):
        return self.nslots * self.slot_bytes

    def close(self):
        try:
            self._buf = None
            self._shm.close()
        except Exception:
            pass

    def unlink(self):
        """Remove the name (idempotent). Existing mappings stay valid on
        POSIX; only new attaches fail — safe to call at shutdown while a
        consumer is still draining."""
        if self._unlinked:
            return
        self._unlinked = True
        try:
            self._shm.unlink()
        except FileNotFoundError:
            # somebody else (the cluster shutdown closure) removed the name;
            # still drop the creator's tracker entry so its exit handler
            # doesn't warn about a "leaked" segment
            try:
                from multiprocessing import resource_tracker
                resource_tracker.unregister(self._shm._name, "shared_memory")
            except Exception:
                pass
        except Exception:
            logger.debug("ring unlink failed", exc_info=True)

    @staticmethod
    def unlink_by_name(name):
        """Remove the segment name from a process that never created it.
        Unlinks via the raw syscall: attaching a SharedMemory object here
        would re-enter the tracker bookkeeping this module keeps balanced."""
        try:
            import _posixshmem
            _posixshmem.shm_unlink("/" + name.lstrip("/"))
        except FileNotFoundError:
            pass
        except Exception:
            logger.debug("ring unlink(%s) failed", name, exc_info=True)

    # -- low-level slot protocol ---------------------------------------

    def _state(self, seq):
        return self._buf[_STATE_OFF + (seq % self.nslots)]

    def _set_state(self, seq, value):
        self._buf[_STATE_OFF + (seq % self.nslots)] = value

    def _produced_seq(self):
        return struct.unpack_from("<Q", self._buf, 16)[0]

    def _set_produced_seq(self, seq):
        struct.pack_into("<Q", self._buf, 16, seq)

    def _wait_free(self, seq, deadline, should_abort=None):
        delay = 0.0
        next_abort_check = time.time() + 0.25
        while self._state(seq) != _FREE:
            now = time.time()
            if now > deadline:
                raise RingTimeout(
                    f"ring slot {seq % self.nslots} still unconsumed — the "
                    "consumer process is likely dead or stuck")
            if should_abort is not None and now >= next_abort_check:
                should_abort()   # raises to abort the blocked write
                next_abort_check = now + 0.25
            time.sleep(delay)
            delay = min(delay + 0.0002, 0.002)

    # -- producer ------------------------------------------------------

    def write(self, parts, count, timeout=600.0, should_abort=None):
        """Copy ``parts`` (a list of bytes-like objects, written
        back-to-back) into consecutive frames; returns the ShmRef the
        caller must enqueue. Blocks while the ring is full;
        ``should_abort`` (if given) is polled ~4x/s during the wait and
        may raise to abort — e.g. when the consumer reported an error."""
        nbytes = sum(len(p) for p in parts)
        nframes = max(1, -(-nbytes // self.slot_bytes))
        if nframes > self.nslots:
            raise ValueError(
                f"payload of {nbytes} bytes needs {nframes} frames; ring has "
                f"{self.nslots} (raise TFOS_TPU_RING_MB or shrink chunks)")
        seq0 = self._produced_seq()
        deadline = time.time() + timeout
        frame = 0                      # current frame index
        frame_used = 0                 # bytes already written in it
        marked = 0                     # frames this write has set FULL
        try:
            self._wait_free(seq0, deadline, should_abort)
            base = _HEADER_BYTES + (seq0 % self.nslots) * self.slot_bytes
            for part in parts:
                view = memoryview(part).cast("B")
                off = 0
                while off < len(view):
                    if frame_used == self.slot_bytes:
                        self._set_state(seq0 + frame, _FULL)
                        marked += 1
                        frame += 1
                        frame_used = 0
                        self._wait_free(seq0 + frame, deadline, should_abort)
                        base = _HEADER_BYTES + \
                            ((seq0 + frame) % self.nslots) * self.slot_bytes
                    take = min(len(view) - off, self.slot_bytes - frame_used)
                    dst = base + frame_used
                    self._buf[dst:dst + take] = view[off:off + take]
                    frame_used += take
                    off += take
                view.release()
            self._set_state(seq0 + frame, _FULL)
            marked += 1
        except BaseException:
            # A partial write (timeout/abort on a later frame) has marked
            # frames FULL without advancing produced_seq; since no ShmRef
            # was enqueued the consumer will never free them, and the NEXT
            # write would block in _wait_free forever.  Restore the
            # invariant before propagating — but ONLY for frames this
            # write marked: a slot whose _wait_free raised (on a wrapped
            # ring) still holds an older un-consumed payload, and forcing
            # it FREE would let a retrying feeder overwrite live data.
            for k in range(marked):
                try:
                    self._set_state(seq0 + k, _FREE)
                except Exception:
                    break
            raise
        assert frame + 1 == nframes, (frame, nframes, nbytes)
        self._set_produced_seq(seq0 + nframes)
        return ShmRef(seq0, nframes, nbytes, count)

    # -- consumer ------------------------------------------------------

    def read(self, ref):
        """Decode the payload a ref points at, then free its frames.
        Returns what `decode_payload` returns."""
        if ref.nframes == 1:
            base = _HEADER_BYTES + (ref.seq % self.nslots) * self.slot_bytes
            view = self._buf[base:base + ref.nbytes]
            try:
                out = decode_payload(view)
            finally:
                if isinstance(view, memoryview):
                    view.release()
                self._set_state(ref.seq, _FREE)
            return out
        data = bytearray(ref.nbytes)
        off = 0
        for k in range(ref.nframes):
            take = min(self.slot_bytes, ref.nbytes - off)
            base = _HEADER_BYTES + \
                ((ref.seq + k) % self.nslots) * self.slot_bytes
            data[off:off + take] = self._buf[base:base + take]
            self._set_state(ref.seq + k, _FREE)
            off += take
        # copy=False: the bytearray is privately owned and kept alive by
        # the column arrays referencing it — a second per-column copy
        # (needed for ring-backed views, whose slots get reused) would
        # double the memcpy cost of every multi-frame payload
        return decode_payload(memoryview(data), copy=False)

    def skip(self, ref):
        """Free a ref's frames without decoding (terminate()-style drains)."""
        for k in range(ref.nframes):
            self._set_state(ref.seq + k, _FREE)


# -- payload codec -----------------------------------------------------
#
# payload := u32 meta_len | pickle(meta) | buffer bytes...
# meta    := {"k": "p", "rt": tag, "mx": bool,
#             "cols": [(dtype_str, shape), ...]}      packed columnar
#          | {"k": "o"}                               one pickle blob
#          | {"k": "m", "lens": [...]}                concatenated payloads
#
# The "m" (multi) kind coalesces several chunks into ONE ring write + ONE
# queue ref: each queue operation costs a manager-server round trip
# (~1-5 ms), so per-payload overhead — not bandwidth — dominates once
# the bytes ride shared memory.

_ROWTYPE_TAGS = {tuple: "t", list: "l", int: "i", float: "f",
                 bool: "b", None: "n"}
_TAG_ROWTYPES = {v: k for k, v in _ROWTYPE_TAGS.items()}


class MultiPayload(list):
    """decode_payload result for "m": a list of sub-chunk payloads
    (PackedChunks and/or record lists), distinguishable from a plain
    record list."""


def encode_chunk(chunk):
    """(meta+buffers parts list, record_count) for a Chunk/PackedChunk."""
    import numpy as np

    if isinstance(chunk, marker.PackedChunk):
        cols = [np.ascontiguousarray(c) for c in chunk.columns]
        meta = {"k": "p", "rt": _ROWTYPE_TAGS[chunk.row_type],
                "mx": chunk.matrix,
                "cols": [(c.dtype.str, c.shape) for c in cols]}
        head = pickle.dumps(meta, protocol=5)
        parts = [struct.pack("<I", len(head)), head]
        parts.extend(c.data.cast("B") for c in cols)
        return parts, len(chunk)
    items = chunk.items if isinstance(chunk, marker.Chunk) else list(chunk)
    head = pickle.dumps({"k": "o"}, protocol=5)
    blob = pickle.dumps(items, protocol=5)
    return [struct.pack("<I", len(head)), head, blob], len(items)


def encode_multi(chunks):
    """Coalesce several Chunk/PackedChunks into one payload parts list.

    Returns ``(parts, total_count)``; decode yields a `MultiPayload` with
    one entry per input chunk, in order.
    """
    lens, all_parts, total = [], [], 0
    for chunk in chunks:
        parts, n = encode_chunk(chunk)
        lens.append(sum(len(p) for p in parts))
        all_parts.append(parts)
        total += n
    head = pickle.dumps({"k": "m", "lens": lens}, protocol=5)
    out = [struct.pack("<I", len(head)), head]
    for parts in all_parts:
        out.extend(parts)
    return out, total


def decode_payload(view, copy=True):
    """Inverse of encode_chunk over one contiguous payload buffer.

    Returns a `marker.PackedChunk`, a plain list of records, or a
    `MultiPayload` of those.  ``copy=True`` materializes columns out of
    the buffer — required when ``view`` aliases ring slots that will be
    reused; pass ``copy=False`` only for privately-owned buffers.
    """
    import numpy as np

    (meta_len,) = struct.unpack_from("<I", view, 0)
    meta = pickle.loads(view[4:4 + meta_len])
    off = 4 + meta_len
    if meta["k"] == "o":
        return pickle.loads(view[off:])
    if meta["k"] == "m":
        subs = MultiPayload()
        for sub_len in meta["lens"]:
            subs.append(decode_payload(view[off:off + sub_len], copy=copy))
            off += sub_len
        return subs
    cols = []
    for dtype_str, shape in meta["cols"]:
        dt = np.dtype(dtype_str)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = n * dt.itemsize
        arr = np.frombuffer(view[off:off + nbytes], dtype=dt,
                            count=n).reshape(shape)
        cols.append(arr.copy() if copy else arr)
        off += nbytes
    return marker.PackedChunk(tuple(cols), _TAG_ROWTYPES[meta["rt"]],
                              meta["mx"])


# -- process-local attach cache ---------------------------------------

_attached = {}
_cache_lock = threading.Lock()
_MAX_ATTACHED = 4


def _segment_gone(name):
    """True when the POSIX shm name has been unlinked (Linux exposes
    segments under /dev/shm). Platforms without /dev/shm (macOS) report
    False for everything so we never evict a live mapping."""
    try:
        if not os.path.isdir("/dev/shm"):
            return False
        return not os.path.exists("/dev/shm/" + name.lstrip("/"))
    except OSError:
        return False


def attach_cached(info):
    """Attach once per (process, ring name); feeder tasks and DataFeeds
    call this on every chunk.

    Long-lived executor processes (SPARK_REUSE_WORKER) see a fresh ring
    per cluster.run(); on every new attach, mappings whose segment has
    since been unlinked are closed and dropped so /dev/shm usage stays
    bounded across runs instead of accumulating one dead ~64MB mapping
    per job.
    """
    ring = _attached.get(info["name"])
    if ring is None:
        with _cache_lock:
            ring = _attached.get(info["name"])
            if ring is None:
                for name in [n for n in _attached if _segment_gone(n)]:
                    _attached.pop(name).close()
                # platform-independent bound (covers hosts with no
                # /dev/shm, where _segment_gone cannot see unlinks):
                # tasks run sequentially per executor, so all but the
                # most recent rings are idle — drop the oldest
                while len(_attached) >= _MAX_ATTACHED:
                    _attached.pop(next(iter(_attached))).close()
                ring = ShmChunkRing.attach(info)
                _attached[info["name"]] = ring
    return ring


def ring_enabled():
    return os.environ.get("TFOS_TPU_SHM_RING", "1") not in ("0", "false", "")
