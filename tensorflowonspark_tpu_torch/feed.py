"""User-side data feed & path utilities — counterpart of
``tensorflowonspark_tpu/feed.py`` (maps reference TFNode.py:29-329).

`DataFeed` is the consumer half of InputMode.SPARK: the training process
pulls batches that feeder tasks pushed into the node's queue manager.  The
marker protocol is preserved from the reference (None = end of feed,
EndPartition = partition boundary), with one change: records travel
in `marker.Chunk` batches, one queue item per chunk, because per-record
pickled queue puts are the reference's throughput ceiling (SURVEY.md §7).

`next_batch` returns records; `next_numpy_batch` stacks them into numpy
arrays; `iter_batches` wraps the loop, and `iter_device_batches` /
`device_prefetch` (the device half, the only part that imports ``torch``,
inside the call) copy them to the card.  Feeder processes import this
module without ``torch``.
"""
import logging
from typing import Any, Iterable, Iterator, Optional

from . import marker
from . import shm as shm_mod

logger = logging.getLogger(__name__)


_SHARDING = ("sharding= (placing a batch over several GPUs) is not ported "
             "yet (ROADMAP: multi-GPU sharding)")


def _map_batch(fn, batch):
    """Apply ``fn`` to every array of a batch (one array, or a tuple,
    list or dict of them), keeping the structure."""
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(fn(v) for v in batch)
    return fn(batch)


def _leaves(batch):
    if isinstance(batch, dict):
        return list(batch.values())
    if isinstance(batch, (tuple, list)):
        return list(batch)
    return [batch]


def device_prefetch(batch_iter: Iterable, sharding: Any = None,
                    depth: int = 2, device: Any = None) -> Iterator:
    """Overlap host->device copies with compute.

    Wraps an iterator of host batches (numpy arrays: one, or a tuple,
    list or dict of them) and yields the same structure as tensors on
    ``device`` (``cuda`` unless the caller asks for the CPU), keeping up
    to `depth` copies in flight ahead of the consumer.  On the card each
    batch is staged in pinned host memory and copied ``non_blocking`` on
    a side stream; the consumer's stream waits on the copy's event before
    the batch is yielded, so the consumer may use it at once while later
    copies proceed.  A pinned staging buffer is held until its copy's
    event has fired — the copy reads it asynchronously, so releasing it
    earlier would let the allocator hand the memory to the next batch
    mid-copy.  This is the device half of the feed-throughput redesign
    (SURVEY.md §7; `marker.PackedChunk` and the shm ring fixed the IPC
    half).

    ``sharding`` (a batch spread over several GPUs) raises
    NotImplementedError.
    """
    if sharding is not None:
        raise NotImplementedError(_SHARDING)
    from .device import resolve

    return _prefetch(batch_iter, max(1, int(depth)), resolve(device))


def _prefetch(batch_iter, depth, dev):
    import collections

    import numpy as np
    import torch

    def _host(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    if dev.type != "cuda":
        for batch in batch_iter:
            yield _map_batch(lambda a: _host(a).to(dev), batch)
        return

    side = torch.cuda.Stream(dev)
    in_flight = collections.deque()   # (device batch, copy event)
    pinned = collections.deque()      # (copy event, staging buffers)

    def _put(batch):
        staged = _map_batch(lambda a: _host(a).pin_memory(), batch)
        with torch.cuda.stream(side):
            out = _map_batch(lambda t: t.to(dev, non_blocking=True), staged)
            done = torch.cuda.Event()
            done.record(side)
        pinned.append((done, staged))
        return out, done

    def _release():
        while pinned and pinned[0][0].query():
            pinned.popleft()

    def _hand_over(item):
        out, done = item
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for t in _leaves(out):
            # allocated on the side stream, used on the consumer's: the
            # caching allocator must not reuse it before the consumer
            # is done with it
            t.record_stream(consumer)
        _release()
        return out

    try:
        for batch in batch_iter:
            in_flight.append(_put(batch))
            if len(in_flight) >= depth:
                yield _hand_over(in_flight.popleft())
        while in_flight:
            yield _hand_over(in_flight.popleft())
    finally:
        for done, _ in pinned:
            done.synchronize()
        pinned.clear()


def pad_batch(batch: Any, batch_size: int) -> Any:
    """Repeat-pad every array in a batch (array, tuple, or dict of arrays)
    along axis 0 up to `batch_size`; full batches pass through untouched."""
    import numpy as np

    def _pad(a):
        a = np.asarray(a)
        n = a.shape[0]
        if n >= batch_size:
            return a
        if n == 0:
            raise ValueError("cannot pad an empty batch (no row to repeat)")
        return np.concatenate([a, np.repeat(a[-1:], batch_size - n, axis=0)])

    if isinstance(batch, dict):
        return {k: _pad(v) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return tuple(_pad(v) for v in batch)
    return _pad(batch)


def hdfs_path(ctx: Any, path: str) -> str:
    """Normalize a path per the filesystem schemes the cluster uses.

    Maps reference TFNode.hdfs_path (TFNode.py:29-64): absolute and
    scheme-qualified paths pass through; relative paths are resolved against
    the cluster's default FS (for remote schemes) or the node's working dir.
    """
    schemes = ("hdfs://", "viewfs://", "file://", "gs://", "s3://", "s3a://",
               "s3n://", "wasb://", "abfs://", "maprfs://", "oss://",
               "swift://", "memory://")  # memory:// = fsspec's in-memory FS
    # (all are openable through fsio/fsspec wherever a local path works)
    if path.startswith(schemes):
        return path
    local_fs = ctx.default_fs.startswith("file://") or not ctx.default_fs.startswith(schemes)
    if path.startswith("/"):
        return path if local_fs else ctx.default_fs + path
    if not local_fs:
        return f"{ctx.default_fs.rstrip('/')}/user/{ctx.user_name}/{path}"
    import os
    return os.path.join(ctx.working_dir, path)


class DataFeed:
    """Pulls feeder-pushed records from the node's input queue.

    Maps reference TFNode.DataFeed (TFNode.py:221-329); the public contract
    (`next_batch`, `should_stop`, `batch_results`, `terminate`) is identical.
    """

    def __init__(self, mgr, train_mode=True, qname_in="input", qname_out="output",
                 input_mapping=None):
        self.mgr = mgr
        self.train_mode = train_mode
        self.qname_in = qname_in
        self.qname_out = qname_out
        self.input_mapping = input_mapping
        self.done_feeding = False
        # drained-but-unreturned records, as segments: ("rows", list) or a
        # PackedChunk kept COLUMNAR so next_numpy_batch never materializes
        # python row objects (the packed-transport fast path)
        self._segments = []
        self._partition_break = False
        self._progress = {}         # pid -> PUBLISHED delivered offset
        self._staged_progress = {}  # pid -> offset awaiting batch return
        self._ring = None
        self._ring_checked = False
        # queue proxies are cached: every mgr.get_queue() builds a fresh
        # AutoProxy over a fresh socket (several ms of server round trips)
        self._q_in = None
        self._q_out = None

    def _queue_in(self):
        if self._q_in is None:
            self._q_in = self.mgr.get_queue(self.qname_in)
        return self._q_in

    def _queue_out(self):
        if self._q_out is None:
            self._q_out = self.mgr.get_queue(self.qname_out)
        return self._q_out

    def _ring_handle(self):
        """Attach to the node's shm data plane on first use (the queue then
        carries ShmRefs whose payloads live in the ring)."""
        if not self._ring_checked:
            self._ring_checked = True
            try:
                info = shm_mod.discover(self.mgr)
                if info:
                    self._ring = shm_mod.attach_cached(info)
            except Exception:
                logger.warning("could not attach shm ring; expecting "
                               "queue-borne chunks", exc_info=True)
        return self._ring

    def _resolve_ref(self, ref):
        """ShmRef -> list of segments (PackedChunks / ("rows", list))."""
        ring = self._ring_handle()
        if ring is None:
            raise RuntimeError(
                "received a ShmRef but the node advertises no shm ring — "
                "feeder and consumer disagree about the data plane")
        payload = ring.read(ref)
        if isinstance(payload, shm_mod.MultiPayload):
            return [p if isinstance(p, marker.PackedChunk)
                    else ("rows", list(p)) for p in payload]
        if isinstance(payload, marker.PackedChunk):
            return [payload]
        return [("rows", list(payload))]

    @property
    def _buffer(self):
        """Pending record count (kept as the reference-era name)."""
        return sum(self._seg_len(s) for s in self._segments)

    @staticmethod
    def _seg_len(seg):
        return len(seg[1]) if isinstance(seg, tuple) else len(seg)

    def _take_blocks(self, batch_size, timeout=None):
        """Collect up to `batch_size` records as blocks (row lists or
        columnar PackedChunk slices), handling the marker protocol."""
        import queue as queue_mod

        # staged offsets from the PREVIOUS take are safe now: that batch
        # was returned to the training fn before this call
        if self._staged_progress:
            publish = False
            for pid, off in self._staged_progress.items():
                if off > self._progress.get(pid, 0):
                    self._progress[pid] = off
                    publish = True
            self._staged_progress = {}
            if publish:
                try:
                    self.mgr.set("feed_progress", dict(self._progress))
                except Exception:
                    logger.warning("could not publish feed progress",
                                   exc_info=True)

        q = self._queue_in()
        blocks, n = [], 0
        while n < batch_size:
            if self._segments:
                seg = self._segments[0]
                take = min(batch_size - n, self._seg_len(seg))
                if isinstance(seg, tuple):
                    rows = seg[1]
                    blocks.append(("rows", rows[:take]))
                    rest = rows[take:]
                    if rest:
                        self._segments[0] = ("rows", rest)
                    else:
                        self._segments.pop(0)
                else:  # PackedChunk: slice columns, stay columnar
                    blocks.append(("cols", marker.PackedChunk(
                        tuple(c[:take] for c in seg.columns), seg.row_type,
                        seg.matrix)))
                    if take < len(seg):
                        self._segments[0] = marker.PackedChunk(
                            tuple(c[take:] for c in seg.columns),
                            seg.row_type, seg.matrix)
                    else:
                        self._segments.pop(0)
                n += take
                continue
            if self.done_feeding or self._partition_break:
                break
            try:
                item = q.get(timeout=timeout) if timeout is not None else q.get()
            except queue_mod.Empty:
                break
            if item is None:
                self.done_feeding = True
                q.task_done()
            elif isinstance(item, marker.Progress):
                # DEFERRED high-water mark: records before this marker
                # have been drained into the current batch, but that
                # batch has not been RETURNED to the training fn yet — a
                # crash in that window must re-deliver them.  The offset
                # is staged here and published at the start of the NEXT
                # take (by which time the batch was handed out), so a
                # published offset never covers an undelivered record
                self._staged_progress[item.pid] = max(
                    self._staged_progress.get(item.pid, 0), item.offset)
                q.task_done()
            elif isinstance(item, marker.EndPartition):
                q.task_done()
                if n:
                    self._partition_break = True  # flush current batch first
                    break
                # nothing collected yet: partition boundary is invisible
            elif isinstance(item, shm_mod.ShmRef):
                self._segments.extend(self._resolve_ref(item))
                q.task_done()
            elif isinstance(item, marker.PackedChunk):
                self._segments.append(item)
                q.task_done()
            elif isinstance(item, marker.Chunk):
                self._segments.append(("rows", list(item.items)))
                q.task_done()
            elif blocks and blocks[-1][0] == "rows":
                # coalesce consecutive raw items into one rows block so the
                # numpy path stacks once instead of per record
                blocks[-1][1].append(item)
                n += 1
                q.task_done()
            else:
                blocks.append(("rows", [item]))
                n += 1
                q.task_done()
        if self._partition_break and not self._segments:
            self._partition_break = False
        return blocks

    @staticmethod
    def _rows_of(block):
        """Materialize a block into records.  Array-valued fields of packed
        field-records come back as numpy views (the values are identical;
        only list-vs-ndarray container type differs from what the feeder
        iterated)."""
        kind, data = block
        if kind == "rows":
            return data
        cols, row_type = data.columns, data.row_type
        if row_type is None:
            return list(cols[0])
        if row_type in (int, float, bool):
            # python-scalar records: tolist restores the exact scalar type
            return cols[0].tolist()
        if data.matrix:  # [N, F] matrix of flat rows: tolist is C-speed
            rows = cols[0].tolist()
            return rows if row_type is list else [row_type(r) for r in rows]
        return [row_type(c[i] for c in cols) for i in range(len(data))]

    def next_batch(self, batch_size: int,
                   timeout: Optional[float] = None) -> Any:
        """Return up to `batch_size` records.

        Returns fewer records at a partition boundary (so inference result
        accounting stays 1:1 per partition, reference: TFNode.py:243-288) and
        an empty/short batch at end-of-feed.  With `input_mapping` (a dict
        column_index_or_key -> name), returns {name: [values...]} instead.

        `timeout` (seconds) bounds each blocking wait: when no record
        arrives within `timeout`, returns whatever was collected so far
        (possibly []).
        Synchronous multi-worker consumers need this probe semantics — a
        worker blocked forever in q.get() while its peers sit in a gradient
        collective would deadlock the cluster (see
        parallel.train.feed_consensus); a bounded probe instead lets the
        worker vote "dry" and the cluster stop in lockstep.
        """
        batch = []
        for block in self._take_blocks(batch_size, timeout):
            batch.extend(self._rows_of(block))
        if self.input_mapping:
            return self._apply_mapping(batch)
        return batch

    def _apply_mapping(self, batch):
        cols = {name: [] for name in self.input_mapping.values()}
        for rec in batch:
            for key, name in self.input_mapping.items():
                cols[name].append(rec[key])
        return cols

    def next_numpy_batch(self, batch_size: int, dtype: Any = None,
                         timeout: Optional[float] = None) -> Any:
        """Like next_batch but stacks records into numpy arrays.

        Records that are tuples/lists of fields become a tuple of arrays
        (one per field); scalar/array records become one array; wide flat
        scalar records (feeder-packed as a matrix) become per-field column
        views.  This is the shape `device_prefetch` copies.  Feeder-packed
        chunks (marker.PackedChunk) pass through columnar — no python row
        objects are ever materialized on this path.  `timeout` bounds each
        blocking wait like next_batch's.
        """
        import numpy as np

        if self.input_mapping:
            batch = self.next_batch(batch_size, timeout=timeout)
            return {k: np.asarray(v, dtype=dtype) for k, v in batch.items()}

        blocks = self._take_blocks(batch_size, timeout)
        if not blocks:
            return None
        if all(kind == "cols" and data.matrix for kind, data in blocks):
            # wide flat records: concatenate the [N, F] matrices once and
            # expose per-field column views
            mats = [data.columns[0] for _, data in blocks]
            big = mats[0] if len(mats) == 1 else np.concatenate(mats)
            if dtype is not None:
                big = np.asarray(big, dtype=dtype)
            return tuple(big[:, i] for i in range(big.shape[1]))
        field_blocks = []   # per block: tuple of per-field arrays
        singles = []        # per block: records are single values (not field
        # tuples), so the result is one array instead of a tuple of arrays
        for kind, data in blocks:
            if kind == "cols":
                if data.matrix:
                    # mixed with non-matrix blocks (rare): expand to fields
                    mat = data.columns[0]
                    singles.append(False)
                    field_blocks.append(tuple(
                        mat[:, i] for i in range(mat.shape[1])))
                    continue
                singles.append(data.row_type not in (tuple, list))
                field_blocks.append(data.columns)
            else:
                first = data[0]
                if isinstance(first, (tuple, list)) and not np.isscalar(first):
                    singles.append(False)
                    field_blocks.append(tuple(
                        np.asarray([r[i] for r in data])
                        for i in range(len(first))))
                else:
                    singles.append(True)
                    field_blocks.append((np.asarray(data),))
        nf = len(field_blocks[0])
        if (any(len(fb) != nf for fb in field_blocks)
                or any(s != singles[0] for s in singles)):
            raise ValueError("inconsistent record shapes across feed chunks")
        fields = tuple(
            np.asarray(np.concatenate([fb[i] for fb in field_blocks])
                       if len(field_blocks) > 1 else field_blocks[0][i],
                       dtype=dtype)
            for i in range(nf))
        return fields[0] if singles[0] else fields

    @staticmethod
    def _is_empty(batch):
        """Recognize an empty batch in every shape next_batch can return:
        None, [], {}, a mapping of empty columns, a tuple of empty arrays,
        or a zero-length array."""
        if batch is None:
            return True
        if isinstance(batch, dict):
            return all(len(v) == 0 for v in batch.values()) or not batch
        if isinstance(batch, tuple):
            return all(len(v) == 0 for v in batch) or not batch
        return hasattr(batch, "__len__") and len(batch) == 0

    def iter_batches(self, batch_size: int,
                     numpy: bool = False) -> Iterator:
        """Generator over batches until end-of-feed."""
        while not self.should_stop():
            batch = (self.next_numpy_batch(batch_size) if numpy
                     else self.next_batch(batch_size))
            if self._is_empty(batch):
                if self.should_stop():
                    break
                continue
            yield batch

    def iter_device_batches(self, batch_size, sharding=None, depth=2,
                            pad=False, device=None):
        """Generator over device-resident batches (tensors on ``device``,
        ``cuda`` unless the caller asks for the CPU) with `depth`
        host->device copies kept in flight (see `device_prefetch`).

        `pad` repeat-pads ragged tail batches (end-of-feed / partition
        boundaries) up to `batch_size` so the step keeps one static
        shape.  ``sharding`` raises NotImplementedError (ROADMAP:
        multi-GPU sharding).

        NOTE (multi-process training): padding fixes ragged *shapes*
        only.  When per-process feeds can yield different batch
        *counts*, a process that exhausts its feed early leaves its peers
        blocked in the step's collective — that case needs a
        bounded-probe loop with `parallel.train.feed_consensus` voting
        each step (see examples/mnist/mnist_common.py), not this
        generator.
        """
        if sharding is not None:
            raise NotImplementedError(_SHARDING)
        batches = self.iter_batches(batch_size, numpy=True)
        if pad:
            batches = (pad_batch(b, batch_size) for b in batches)
        return device_prefetch(batches, depth=depth, device=device)

    def should_stop(self):
        """True once the end-of-feed sentinel was consumed (reference: TFNode.py:290)."""
        return self.done_feeding and not self._buffer

    def batch_results(self, results):
        """Push inference results to the output queue (reference: TFNode.py:294-305)."""
        q = self._queue_out()
        for item in results:
            q.put(item)

    def terminate(self):
        """Signal feeders to stop and drain the input queue (reference: TFNode.py:307-329)."""
        logger.info("terminate() requested; marking state terminating")
        self.mgr.set("state", "terminating")
        # Drain whatever is in flight so feeder queue.join() can complete.
        q = self._queue_in()
        import queue as queue_mod
        count = 0
        done = False
        while not done:
            try:
                item = q.get(timeout=3)
                if isinstance(item, shm_mod.ShmRef):
                    # free the ring frames so a feeder blocked on a full
                    # ring unblocks and sees the 'terminating' state
                    ring = self._ring_handle()
                    if ring is not None:
                        ring.skip(item)
                q.task_done()
                count += 1
                if item is None:
                    self.done_feeding = True
            except queue_mod.Empty:
                done = True
            except (OSError, EOFError, BrokenPipeError) as e:
                # the manager is already gone (cluster shutdown won the
                # race): nothing left to drain, feeders are dead too
                logger.info("terminate(): manager closed mid-drain (%s)", e)
                self.done_feeding = True
                done = True
        logger.info("terminate() drained %d in-flight items", count)
