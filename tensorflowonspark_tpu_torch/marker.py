"""Sentinel markers placed in data queues — counterpart of
``tensorflowonspark_tpu/marker.py`` (maps reference marker.py:1-18).

The feeder side pushes these into the ``input`` queue to signal structural
events to the consumer (`feed.DataFeed`):

- ``None`` (not a class here, by convention) — end of the entire feed.
- ``EndPartition`` — end of one upstream partition; used during inference so
  the consumer can flush exactly one result per input record before results
  for the next partition begin (reference: TFSparkNode.py:541-546).
- ``Chunk`` — an addition of this framework: a batched list of records pushed as ONE
  queue item.  Per-item pickled queue puts are the reference design's
  throughput ceiling (SURVEY.md §7); chunked transfer amortizes IPC cost.
"""


class Marker:
    """Base class for data-queue sentinels."""


class EndPartition(Marker):
    """Marks the end of one input partition within the feed."""


class Progress(Marker):
    """In-band consumption checkpoint (feed-offset resume, net-new).

    The feeder interleaves these with record chunks; when the consumer
    (`feed.DataFeed`) dequeues one, every record before it has been
    consumed, so ``offset`` is a consumption-CONFIRMED high-water mark
    for partition ``pid`` — exactly what `cluster.run_elastic` needs to
    skip already-delivered records on relaunch without ever skipping an
    unconsumed one."""

    __slots__ = ("pid", "offset")

    def __init__(self, pid, offset):
        self.pid = int(pid)
        self.offset = int(offset)

    def __repr__(self):
        return f"Progress(pid={self.pid}, offset={self.offset})"


class Chunk:
    """A list of records transported as a single queue item.

    Not a Marker: it carries payload.  ``items`` is a plain list so it pickles
    cheaply through the multiprocessing proxy.
    """

    __slots__ = ("items",)

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __repr__(self):
        return f"Chunk(n={len(self.items)})"


class PackedChunk:
    """A record chunk transported as contiguous numpy buffers.

    Pickling a Chunk of N records x F python-object fields costs O(N*F)
    object serialization on both sides of the queue — the dominant feed
    cost.  Packing the chunk first makes the same transfer a handful of
    buffer copies.  Three layouts:

    - field records (``row_type`` tuple/list, ``matrix`` False):
      ``columns`` holds one [N, ...] array per record field — the
      (image_array, label) shape.
    - wide flat records (``row_type`` tuple/list, ``matrix`` True):
      ``columns`` is a single [N, F] matrix (per-field arrays would mean F
      tiny objects each way); fields share one promoted dtype.
    - single-value records (``row_type`` None): ``columns[0]`` is the [N,
      ...] stack.
    """

    __slots__ = ("columns", "row_type", "matrix")

    def __init__(self, columns, row_type, matrix=False):
        self.columns = columns
        self.row_type = row_type
        self.matrix = matrix

    def __len__(self):
        return len(self.columns[0])

    def __repr__(self):
        return (f"PackedChunk(n={len(self)}, fields={len(self.columns)}, "
                f"matrix={self.matrix}, "
                f"row_type={self.row_type and self.row_type.__name__})")


# Field-record packing is per-field; past this many fields a flat scalar
# record packs as one matrix instead (F small arrays each way would cost
# more than they save).
_MAX_FIELDS = 16


def pack_records(items):
    """Return a PackedChunk for a uniform numeric record list, or a plain
    Chunk when the records don't pack (ragged, object-dtype, mixed types).

    Packable shapes: every record a scalar/ndarray of one dtype+shape;
    every record a same-length tuple/list of <= 16 fields each stacking to
    a non-object array; or wide flat scalar rows, packed as one [N, F]
    matrix (fields are promoted to a common dtype there).
    """
    import numpy as np

    if not items:
        return Chunk(items)
    first = items[0]
    try:
        # EXACT tuple/list only: subclasses (namedtuple, pyspark Row, ...)
        # don't reconstruct from an iterable, so they ride plain Chunks
        if type(first) in (tuple, list):
            row_type = type(first)
            nf = len(first)
            if any(type(r) is not row_type or len(r) != nf
                   for r in items):
                return Chunk(items)
            if nf <= _MAX_FIELDS:
                cols = tuple(np.asarray([r[i] for r in items])
                             for i in range(nf))
                if any(c.dtype == object for c in cols):
                    return Chunk(items)
                return PackedChunk(cols, row_type)
            mat = np.asarray(items)
            if mat.dtype == object or mat.ndim < 2:
                return Chunk(items)
            return PackedChunk((mat,), row_type, matrix=True)
        # single-value records: require ONE exact python scalar type (so
        # values round-trip via tolist without int->float promotion) or
        # uniform ndarrays/np scalars (which list() restores exactly);
        # anything else (tuple subclasses, decimals, ...) rides a Chunk
        t0 = type(first)
        if not (t0 in (int, float, bool)
                or isinstance(first, (np.ndarray, np.generic))):
            return Chunk(items)
        if any(type(x) is not t0 for x in items):
            return Chunk(items)
        col = np.asarray(items)
        if col.dtype == object:
            return Chunk(items)
        if t0 in (int, float, bool):
            return PackedChunk((col,), t0)  # row_type = scalar type:
            # materialize via tolist() -> exact python scalars back
        return PackedChunk((col,), None)
    except (ValueError, TypeError, OverflowError):
        return Chunk(items)
