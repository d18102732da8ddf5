"""The input pipeline for InputMode.NATIVE — counterpart of
``tensorflowonspark_tpu/data.py``.

The reference's file-fed path delegates shard/shuffle/repeat/batch/prefetch
to ``tf.data`` inside the user map_fun (reference:
examples/mnist/keras/mnist_tf_ds.py:41-50 — ``ds.shard(num_workers,
worker_index).shuffle(...).batch(...)``; examples/mnist/keras/mnist_tf.py).
This module owns that pipeline instead: a lazy, re-iterable `Dataset`
over TFRecord shards (or any record source) whose terminal stage hands
batches to the train step as tensors on the card through
`feed.device_prefetch`.

Design points:
- **file-granular sharding** before any IO: each process opens only its own
  shards (`shard(n, i)`), the multi-host analog of ``ds.shard``;
- **windowed shuffle** with a fixed-size buffer and a per-epoch seed —
  streaming, O(buffer) memory, deterministic under a fixed seed like
  ``tf.data.Dataset.shuffle``; the seeding is the JAX package's
  (``random.Random(seed * 1_000_003 + epoch)``), so both packages give
  the same record order;
- **static batch shapes**: `batch(..., drop_remainder=True)` is the default
  for training; the ragged tail can instead be repeat-padded
  (`pad_tail=True`) to keep every record;
- **device prefetch** as the terminal stage: `depth` host->device copies
  in flight on a side stream (`feed.device_prefetch`).

The module imports no ``torch``: only `prefetch_to_device` reaches it,
inside the call.

Example::

    ds = (data.Dataset.from_tfrecords(glob_pattern)
              .shard(ctx.num_processes, ctx.process_id)
              .map(parse)
              .shuffle(4096, seed=epoch)
              .repeat(epochs)
              .batch(512, drop_remainder=True))
    for batch in ds.prefetch_to_device():
        state, metrics = step(state, batch, None)
"""
import glob as glob_mod
import logging
import random

logger = logging.getLogger(__name__)


class Dataset:
    """Lazy, composable, re-iterable record pipeline.

    Every transformation returns a NEW Dataset; iterating builds a fresh
    generator chain, so one Dataset can be iterated many times (each
    `repeat`/`shuffle` epoch reseeds deterministically from its base seed).
    """

    def __init__(self, source, parent=None, op=None):
        # source: () -> iterator of records (only for root datasets)
        self._source = source
        self._parent = parent
        self._op = op or (lambda it: it)

    # ---------------------------------------------------------------- roots

    @classmethod
    def from_records(cls, records):
        """Root dataset over an in-memory sequence (list of tuples/dicts)."""
        return cls(lambda: iter(records))

    @classmethod
    def from_generator(cls, gen_fn):
        """Root dataset over `gen_fn() -> iterator` (fresh per iteration)."""
        return cls(gen_fn)

    @classmethod
    def from_files(cls, paths, reader):
        """Root over files: `reader(path) -> iterator of records`.

        `paths` may be a glob pattern, a list, or a directory.  File order
        is sorted for determinism; `shard()` before iteration splits at
        file granularity when possible.
        """
        ds = cls(None)
        ds._files = _expand_paths(paths)
        ds._reader = reader
        ds._shard_spec = None
        ds._source = ds._file_source
        return ds

    @classmethod
    def from_tfrecords(cls, paths, parse=None):
        """Root over TFRecord shards of `tf.train.Example` records.

        Records arrive as `{name: (kind, values)}` dicts (tfrecord module
        decode format); `parse` maps each decoded example (e.g. to a
        (features, label) tuple).  Maps the reference's
        ``TFRecordDataset -> parse_fn`` idiom (mnist_tf_ds.py:41-50).
        """
        from . import tfrecord

        def reader(path):
            it = tfrecord.read_examples(path)
            return (parse(ex) for ex in it) if parse else it

        return cls.from_files(paths, reader)

    @classmethod
    def from_indexed_tfrecords(cls, paths, parse=None, global_shuffle=False,
                               seed=0, shuffle_block=1, verify_crc=True):
        """Root over indexed TFRecord shards with RANDOM access
        (tfrecord.IndexedTFRecordFile; sidecar indexes are used when
        present and built in memory otherwise).

        This is the ArrayRecord-style input path (SURVEY.md §2.2).  Where
        `from_tfrecords` reads shards sequentially (so `shuffle(buffer)`
        only ever mixes records ~buffer apart and `shard()` is
        file-granular), this root addresses every (file, record)
        coordinate directly:

        - ``global_shuffle=True`` draws a fresh uniform permutation of ALL
          records each epoch (`seed` + epoch index, the `shuffle()` reseed
          convention) — exact global shuffle, O(index) memory;
        - ``shard(n, i)`` slices the (permuted) coordinate list, giving
          every worker a disjoint, balanced 1/n of the records regardless
          of file count or file sizes — record-granular, and each worker
          reads ONLY its own records (no scan-and-discard);
        - ``shuffle_block=k`` permutes blocks of k consecutive records
          instead of single records: each block is fetched with one ranged
          read, trading perfect uniformity for sequential IO (the
          ArrayRecord shuffle-granularity tradeoff; k=1 is exact).
        """
        if shuffle_block < 1:
            raise ValueError("shuffle_block must be >= 1")
        cfg = {"parse": parse, "global_shuffle": bool(global_shuffle),
               "seed": int(seed), "block": int(shuffle_block),
               "verify": verify_crc}
        return cls._indexed_root(_expand_paths(paths), cfg, None)

    @classmethod
    def from_tfrecord_columns(cls, paths, features, batch_size,
                              drop_remainder=True, shuffle=False, seed=0):
        """Root of COLUMNAR batches over fixed-schema numeric TFRecord
        shards — for dense training data (MNIST-like: a float feature +
        an int64 label).

        Each shard is decoded column by column (:func:`tfrecord.
        read_column`) and batches are SLICES of the shard columns.  Yields
        ``{name: array[batch_size, feat_len]}`` dicts; remainders carry
        across shard boundaries, so batch shapes are static everywhere
        except an optional final partial batch (``drop_remainder=False``).

        ``shuffle=True`` permutes records within each shard per epoch
        (``seed`` + epoch, the shuffle() reseed convention).  ``shard()``
        slices the file list (call before iteration); downstream
        ``map``/``prefetch``/``prefetch_to_device`` compose per batch.
        """
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if not features:
            raise ValueError("features must name at least one column")
        cfg = {"features": tuple(features), "batch": int(batch_size),
               "drop": bool(drop_remainder), "shuffle": bool(shuffle),
               "seed": int(seed)}
        return cls._columnar_root(_expand_paths(paths), cfg, None)

    @classmethod
    def _columnar_root(cls, files, cfg, shard_spec):
        ds = cls(None)
        ds._files = files
        ds._columnar = cfg
        ds._shard_spec = shard_spec
        ds._epoch_source = ds._columnar_iter
        return ds

    def _columnar_iter(self, epoch):
        import numpy as np

        from . import tfrecord

        files = self._files
        if self._shard_spec:
            n, i = self._shard_spec
            files = files[i::n]
        if not files:
            raise ValueError("dataset matched no input files")
        cfg = self._columnar
        B = cfg["batch"]
        pending = None                   # {name: [rows...]} leftover columns

        def _concat(a, b):
            return b if a is None else {
                k: np.concatenate([a[k], b[k]]) for k in b}

        for fi, path in enumerate(files):
            if next(tfrecord.read_examples(path), None) is None:
                continue                     # valid zero-record shard
            cols = {name: tfrecord.read_column(path, name)
                    for name in cfg["features"]}
            n_rec = len(next(iter(cols.values())))
            for name, c in cols.items():
                if len(c) != n_rec:
                    raise IOError(f"{path}: feature {name!r} has "
                                  f"{len(c)} records, expected {n_rec}")
            if cfg["shuffle"]:
                # stable per-(seed, epoch, file) stream — NOT hash(),
                # which is salted per process
                rng = np.random.default_rng(
                    (cfg["seed"] * 1_000_003 + epoch
                     + fi * 2_654_435_761) % (2 ** 63))
                perm = rng.permutation(n_rec)
                cols = {k: c[perm] for k, c in cols.items()}
            cols = _concat(pending, cols)
            n_rec = len(next(iter(cols.values())))
            n_full = n_rec // B
            for j in range(n_full):
                yield {k: c[j * B:(j + 1) * B] for k, c in cols.items()}
            pending = ({k: c[n_full * B:] for k, c in cols.items()}
                       if n_rec % B else None)
        if pending is not None and not cfg["drop"]:
            yield pending

    @classmethod
    def _indexed_root(cls, files, cfg, shard_spec):
        ds = cls(None)
        ds._files = files
        ds._indexed = cfg
        ds._shard_spec = shard_spec
        ds._epoch_source = ds._indexed_iter
        return ds

    # At most this many shard files keep an open fd during indexed
    # iteration; the rest are release()d LRU and reopen on demand.
    _MAX_OPEN_READERS = 128

    def _indexed_readers(self):
        from . import tfrecord

        readers = getattr(self, "_idx_readers", None)
        if readers is None:
            readers = [tfrecord.IndexedTFRecordFile(
                p, verify_crc=self._indexed["verify"]) for p in self._files]
            self._idx_readers = readers
        return readers

    def _indexed_iter(self, epoch):
        import collections

        from . import tfrecord

        if not self._files:
            raise ValueError("dataset matched no input files")
        cfg = self._indexed
        readers = self._indexed_readers()
        block = cfg["block"]
        coords = []                      # (file_idx, start_record, n_records)
        for fi, r in enumerate(readers):
            n = len(r)
            coords.extend((fi, s, min(block, n - s))
                          for s in range(0, n, block))
        if cfg["global_shuffle"]:
            # same reseed scheme as shuffle(): deterministic per (seed,
            # epoch), identical on every worker so shard slices stay
            # disjoint across processes
            rng = random.Random(cfg["seed"] * 1_000_003 + epoch)
            rng.shuffle(coords)
        if self._shard_spec:
            n_shards, idx = self._shard_spec
            coords = coords[idx::n_shards]
        parse = cfg["parse"]
        open_lru = collections.OrderedDict()     # file_idx -> None
        try:
            for fi, start, count in coords:
                payloads = readers[fi].read_range(start, count)
                open_lru[fi] = None
                open_lru.move_to_end(fi)
                if len(open_lru) > self._MAX_OPEN_READERS:
                    oldest, _ = open_lru.popitem(last=False)
                    readers[oldest].release()
                for payload in payloads:
                    ex = tfrecord.decode_example(payload)
                    yield parse(ex) if parse else ex
        finally:
            # handles reopen on demand, so release everything at epoch end
            # (incl. GeneratorExit) — a finite pass must not pin fds
            for r in readers:
                r.release()

    def _file_source(self):
        files = self._my_files()
        if not files:
            raise ValueError("dataset matched no input files")
        cycle, block = getattr(self, "_interleave", (1, 1))

        def gen():
            if cycle <= 1 or len(files) <= 1:
                for path in files:
                    yield from self._reader(path)
                return
            # deterministic round-robin interleave (tf.data's default
            # ordering): `cycle` files open at once, `block` records
            # pulled from each in turn; an exhausted slot refills with
            # the next file
            pending = iter(files)
            slots = []
            for path in pending:
                slots.append(self._reader(path))
                if len(slots) == cycle:
                    break
            while slots:
                for k in range(len(slots)):
                    if slots[k] is None:
                        continue
                    for _ in range(block):
                        try:
                            yield next(slots[k])
                        except StopIteration:
                            nxt = next(pending, None)
                            slots[k] = (self._reader(nxt)
                                        if nxt is not None else None)
                            break
                slots = [s for s in slots if s is not None]
        return gen()

    @property
    def file_rooted(self):
        """True when this dataset reads straight from a file list (so
        `interleave()` applies and `shard()` is file-granular).  Indexed
        roots are excluded: they address records directly, so interleave
        and file-granular sharding don't apply."""
        return (getattr(self, "_files", None) is not None
                and getattr(self, "_indexed", None) is None
                and getattr(self, "_columnar", None) is None
                and self._parent is None)

    def interleave(self, cycle_length=4, block_length=1):
        """Mix records round-robin from `cycle_length` concurrently-open
        files, `block_length` records at a time (the ordering of
        tf.data's deterministic ``interleave``; reference analog: the
        mnist_tf_ds shard readers).  Only valid directly on a file root
        (call BEFORE map/shuffle).  The point is shuffle quality: with
        file-sequential reading a reservoir shuffle only ever mixes
        records ~buffer_size apart, while interleave spreads each file
        across the whole epoch.  IO/decode parallelism rides
        ``map(fn, num_parallel=N)``, which composes downstream.
        """
        if not self.file_rooted:
            raise ValueError("interleave() applies to a file-rooted "
                             "dataset (from_files/from_tfrecords), before "
                             "other transforms")
        if cycle_length < 1 or block_length < 1:
            raise ValueError("cycle_length and block_length must be >= 1")
        new = Dataset(None)
        new._files = self._files
        new._reader = self._reader
        new._shard_spec = self._shard_spec
        new._interleave = (int(cycle_length), int(block_length))
        new._source = new._file_source
        return new

    def _my_files(self):
        files = self._files
        if self._shard_spec:
            n, i = self._shard_spec
            files = files[i::n]
        return files

    # ------------------------------------------------------------ transforms

    def _chain(self, op):
        return Dataset(None, parent=self, op=op)

    def shard(self, num_shards, index):
        """Keep 1/num_shards of the data for this process.

        File-granular when called directly on a file root (shard FIRST,
        before map/shuffle — then each process only ever opens its own
        shard files) with at least `num_shards` files; record-granular
        (round-robin) otherwise.  The multi-host analog of
        ``ds.shard(num_workers, worker_index)`` (mnist_tf_ds.py:41).
        """
        if not 0 <= index < num_shards:
            raise ValueError(f"shard index {index} not in [0, {num_shards})")
        if (self._parent is None
                and getattr(self, "_columnar", None) is not None
                and self._shard_spec is None):
            # columnar root: file-granular slice (each worker decodes only
            # its own shard files).  Fail FAST when files can't cover the
            # shards — an empty worker would otherwise crash mid-training
            # (and deadlock SPMD collectives); write >= num_shards files
            # or use from_indexed_tfrecords for record-granular sharding.
            if len(self._files) < num_shards:
                raise ValueError(
                    f"shard({num_shards}): only {len(self._files)} shard "
                    "files — the columnar root shards at file granularity; "
                    "write more shard files or use from_indexed_tfrecords")
            return Dataset._columnar_root(self._files, dict(self._columnar),
                                          (num_shards, index))
        if (self._parent is None
                and getattr(self, "_indexed", None) is not None
                and self._shard_spec is None):
            # indexed root: record/block-granular slice of the (permuted)
            # coordinate list — balanced shards regardless of file layout,
            # and this worker reads only its own records
            return Dataset._indexed_root(self._files, dict(self._indexed),
                                         (num_shards, index))
        if (self._parent is None
                and getattr(self, "_files", None) is not None
                and getattr(self, "_indexed", None) is None
                and self._shard_spec is None
                and len(self._files) >= num_shards):
            new = Dataset(None)
            new._files = self._files
            new._reader = self._reader
            new._shard_spec = (num_shards, index)
            if getattr(self, "_interleave", None):
                new._interleave = self._interleave
            new._source = new._file_source
            return new
        return self._chain(
            lambda it: (r for j, r in enumerate(it) if j % num_shards == index))

    def map(self, fn, num_parallel=None):
        """Apply `fn` to every record.

        ``num_parallel=N`` runs `fn` on a bounded thread pool (2N records
        in flight, output order preserved) — the tf.data
        ``num_parallel_calls`` analog.  Worth it when `fn` releases the
        GIL (PIL JPEG decode, numpy resize: the image pipeline); pure-
        Python fns gain nothing.
        """
        if not num_parallel or num_parallel <= 1:
            return self._chain(lambda it: (fn(r) for r in it))

        def op(it, _n=int(num_parallel)):
            import concurrent.futures as cf
            from collections import deque
            with cf.ThreadPoolExecutor(_n) as pool:
                window = deque()
                try:
                    for r in it:
                        window.append(pool.submit(fn, r))
                        if len(window) >= 2 * _n:
                            yield window.popleft().result()
                    while window:
                        yield window.popleft().result()
                finally:
                    for f in window:   # consumer stopped early / fn raised
                        f.cancel()
        return self._chain(op)

    def filter(self, pred):
        """Keep records where `pred(record)` is true."""
        return self._chain(lambda it: (r for r in it if pred(r)))

    def cache(self):
        """Materialize upstream records in memory during the first FULL
        pass; later iterations — including `repeat` epochs — replay from
        memory instead of re-reading/re-parsing files (tf.data
        ``.cache()``).  Place before `shuffle` so per-epoch reshuffling
        still applies.  A partial iteration (early break) does not mark
        the cache complete.

        Replay yields the SAME objects each pass (no defensive copy —
        the same trade tf.data makes): a downstream `map` fn that
        mutates records in place (e.g. ``arr -= mean`` on a cached
        numpy array) would corrupt the cache cumulatively across
        epochs.  Map fns over cached data must return new values —
        the bundled image transforms already do."""
        state = {"filled": False, "records": None}

        def op(it):
            if state["filled"]:
                yield from state["records"]
                return
            buf = []
            for r in it:
                buf.append(r)
                yield r
            state["records"], state["filled"] = buf, True
        return self._chain(op)

    def skip(self, n):
        """Skip the first `n` records — the resume-from-position primitive:
        the pipeline is deterministic for a fixed seed, so a restart that
        knows how many records it consumed (steps x batch_size) skips to
        exactly where training stopped instead of re-seeing data
        (mid-epoch resume; the reference's TF-callback checkpoints could
        only resume on epoch boundaries).

        Placement matters with `repeat()`: upstream of repeat the skip
        re-applies EVERY epoch; for resume, call it on the repeated
        stream — ``ds.repeat(E).skip(total_consumed)`` — so it skips the
        total once.
        """
        if n < 0:
            raise ValueError("skip count must be >= 0")
        import itertools
        return self._chain(lambda it: itertools.islice(it, n, None))

    def shuffle(self, buffer_size, seed=0):
        """Windowed shuffle with an O(buffer_size) reservoir, like
        ``tf.data.Dataset.shuffle``: deterministic for a fixed seed, and
        `repeat()` reseeds per epoch (seed + epoch index)."""
        if buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")

        def op(it, _epoch=0, _seed=seed, _n=buffer_size):
            rng = random.Random(_seed * 1_000_003 + _epoch)
            buf = []
            for r in it:
                buf.append(r)
                if len(buf) >= _n:
                    j = rng.randrange(len(buf))
                    buf[j], buf[-1] = buf[-1], buf[j]
                    yield buf.pop()
            rng.shuffle(buf)
            yield from buf
        return self._chain(op)

    def repeat(self, epochs=None):
        """Iterate the upstream pipeline `epochs` times (None = forever).
        Each epoch rebuilds the chain with the epoch index threaded into
        shuffle ops, so shuffle order differs per epoch but is reproducible."""

        ds = Dataset(None, parent=self, op=None)
        ds._repeat_epochs = epochs
        return ds

    def batch(self, batch_size, drop_remainder=True, pad_tail=False):
        """Stack consecutive records into columnar numpy batches.

        Tuples become tuples of arrays, dicts become dicts of arrays,
        scalars one array (the `DataFeed.next_numpy_batch` conventions).
        `drop_remainder=True` (default) keeps every batch the same shape;
        `pad_tail=True` instead repeat-pads the final short batch up to
        `batch_size`.
        """
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")

        def op(it):
            from .feed import pad_batch
            buf = []
            for r in it:
                buf.append(r)
                if len(buf) == batch_size:
                    yield _stack(buf)
                    buf = []
            if buf and not drop_remainder:
                b = _stack(buf)
                yield pad_batch(b, batch_size) if pad_tail else b
            elif buf and pad_tail:
                yield pad_batch(_stack(buf), batch_size)
        return self._chain(op)

    # ------------------------------------------------------------- terminals

    def __iter__(self):
        return self._build(epoch=0)

    def _build(self, epoch):
        if getattr(self, "_repeat_epochs", _MISSING) is not _MISSING:
            return self._iter_repeated()
        if self._parent is None:
            # epoch-aware roots (indexed global shuffle) get the epoch index
            # like shuffle ops do, so repeat() re-permutes per epoch
            src = getattr(self, "_epoch_source", None)
            return iter(src(epoch)) if src is not None else iter(self._source())
        upstream = self._parent._build(epoch)
        return iter(self._apply_op(upstream, epoch))

    def _apply_op(self, upstream, epoch):
        try:
            return self._op(upstream, _epoch=epoch)
        except TypeError:
            return self._op(upstream)

    def _iter_repeated(self):
        epochs = self._repeat_epochs
        epoch = 0
        while epochs is None or epoch < epochs:
            yield from self._parent._build(epoch)
            epoch += 1

    def prefetch(self, buffer_size=2):
        """Host-side pipeline stage: upstream records are produced by a
        background daemon thread into a bounded queue, so file reads,
        parsing, and batching overlap the consumer's compute (the
        tf.data ``prefetch`` analog, for the host half; pair with
        `prefetch_to_device` for the device half).  Upstream exceptions
        re-raise in the consumer."""
        if buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")

        def op(it):
            import queue as queue_mod
            import threading

            q = queue_mod.Queue(maxsize=buffer_size)
            stop = threading.Event()
            END, ERR = object(), object()

            def _put(item):
                # bounded put that gives up when the consumer is gone, so
                # an abandoned iteration never pins this thread (plus the
                # upstream iterator's open files/buffers) forever
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        return True
                    except queue_mod.Full:
                        continue
                return False

            def producer():
                try:
                    for item in it:
                        if not _put(item):
                            return
                    _put(END)
                except BaseException as e:   # surface in the consumer
                    # single bounded put: the marker and payload travel
                    # together so an abandoned consumer can't strand this
                    # thread between the two enqueues
                    _put((ERR, e))

            t = threading.Thread(target=producer, daemon=True,
                                 name="dataset-prefetch")
            t.start()
            try:
                while True:
                    item = q.get()
                    if item is END:
                        return
                    if type(item) is tuple and len(item) == 2 \
                            and item[0] is ERR:
                        raise item[1]
                    yield item
            finally:
                # consumer done, broken out, or GC'd: release the producer
                stop.set()
        return self._chain(op)

    def prefetch_to_device(self, sharding=None, depth=2, device=None):
        """Terminal stage: batches as tensors on ``device`` (``cuda``
        unless the caller asks for the CPU; without CUDA it raises) with
        `depth` host->device copies in flight (`feed.device_prefetch`).
        ``sharding`` (``parallel.mesh.batch_sharding``): each rank's own
        rows, checked and placed as ``feed.device_prefetch`` does; under
        a sequence axis each batch is cut to the rank's sequence block
        first, as ``DataFeed.iter_device_batches`` cuts it."""
        from .feed import device_prefetch

        batches = iter(self)
        if sharding is not None:
            from .parallel import mesh as mesh_mod

            batches = (mesh_mod.seq_block(b, sharding) for b in batches)
        return device_prefetch(batches, sharding=sharding, depth=depth,
                               device=device)

    def take(self, n):
        """First `n` records (a terminal convenience for tests/debugging)."""
        out = []
        if n <= 0:
            return out
        for r in self:
            out.append(r)
            if len(out) >= n:
                break
        return out


_MISSING = object()


def _expand_paths(paths):
    from .tfrecord import INDEX_SUFFIX
    if isinstance(paths, str):
        import os
        if os.path.isdir(paths):
            out = sorted(
                p for f in os.listdir(paths)
                if not f.startswith(("_", "."))
                and not f.endswith(INDEX_SUFFIX)   # sidecar indexes
                and os.path.isfile(p := os.path.join(paths, f)))
        else:
            out = sorted(p for p in glob_mod.glob(paths)
                         if not p.endswith(INDEX_SUFFIX))
        return out
    return sorted(str(p) for p in paths)


def _stack(records):
    """Columnar stack following the DataFeed conventions."""
    import numpy as np

    first = records[0]
    if isinstance(first, dict):
        return {k: np.asarray([r[k] for r in records]) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(np.asarray([r[i] for r in records])
                     for i in range(len(first)))
    return np.asarray(records)
