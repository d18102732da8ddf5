"""Host-DRAM page tier behind the paged kv pool (hierarchical kv cache):
the port of ``tensorflowonspark_tpu/kvtier.py``.

The device prefix cache (serve.ContinuousBatcher._prefix) lives in the
card's pool only: under pool pressure refcount-0 pages are evicted
outright, and a retired session's pages go straight back to the free
list, so every multi-turn conversation re-prefills its whole history
each turn.  This module is the second tier: a bounded host-memory LRU
pool of DEMOTED pages, keyed by the exact cumulative-prefix keys the
device cache uses (nested token tuples rooted per adapter: structural
equality, so a host hit is as collision-proof as a device hit).

Data path, in the batcher's terms:

demote (device thread)
    On prefix-page eviction, on the lane's overflow reclaim and on
    retirement the batcher gathers the victim pages into a fresh device
    tensor (``decode.gather_pages``: the pool pages are free at once),
    starts its copy into pinned host memory with ``non_blocking=True``,
    records a CUDA event and hands the host buffers, the event and the
    source tensors to :meth:`HostPageTier.demote`.  A worker thread
    waits on the event OFF the device thread (it takes the place of the
    JAX package's ``copy_to_host_async``), then inserts one entry per
    page, evicting LRU entries to stay under the byte budget.  The
    source tensors and their pinned buffers stay referenced until the
    event has fired.

promote (device thread)
    On a prefix-cache miss that hits the tier, ``_try_allocate`` peeks
    the run of matching entries, scatters them into freshly allocated
    pool pages, splices them into ``_prefix`` and discards the host
    copies: the tokens skip prefill, with the bytes of a cold run (the
    gather -> host -> scatter round trip is exact at any kv dtype).

serve (page-server thread)
    ``kv:prefix`` pulls from peer replicas read entries with
    :meth:`peek` (non-destructive) and ship them over kvtransfer's wire.

Entries hold torch CPU tensors (bf16 included: the card's machine has no
``ml_dtypes``, so numpy has no bfloat16 there); numpy arrays are taken
too.  One lock guards the entry map; every method is safe from any
thread.  The tier never touches device state.
"""
import logging
import queue
import threading
import time

import torch

from tensorflowonspark_tpu_torch import metrics

logger = logging.getLogger(__name__)


def block_name(i, path):
    """Wire block name for page ``i``'s pool leaf ``path`` in a
    ``kv:prefix`` snapshot (sortable: page-major, then leaf name)."""
    return "p%05d/%s" % (i, path)


def split_prefix_blocks(meta, blocks):
    """Inverse of the :func:`block_name` flattening: the per-page block
    dicts of a ``kv:prefix`` snapshot, in page order."""
    pages = []
    for i in range(int(meta.get("n_pages") or 0)):
        prefix = "p%05d/" % i
        page = {name[len(prefix):]: arr for name, arr in blocks.items()
                if name.startswith(prefix)}
        if not page:
            break
        pages.append(page)
    return pages


def _host_copy(arr):
    """A contiguous CPU tensor copy of ``arr`` (a tensor or an array): an
    entry never aliases the caller's buffer (a row of a batched demote
    gather would pin the whole buffer)."""
    t = torch.as_tensor(arr)
    return t.to("cpu", copy=True).contiguous()


class HostPageTier:
    """Bounded LRU pool of demoted kv pages in host memory.

    Entries map a cumulative-prefix key to one page's pool-leaf blocks
    (``{leaf path: tensor[page_size, ...]}``).  ``capacity_bytes`` bounds
    the payload total; inserting past it evicts least-recently-used
    entries first, and an entry larger than the whole budget is refused.
    """

    def __init__(self, capacity_bytes):
        self.capacity_bytes = int(capacity_bytes)
        if self.capacity_bytes < 1:
            raise ValueError("host tier capacity must be >= 1 byte "
                             "(--generate_host_cache_mb)")
        self._lock = threading.Lock()
        self._entries = {}       # key -> {"blocks": ..., "nbytes": n};
        # insertion order is the LRU list (a touch moves to the end)
        self._bytes = 0
        self.demotions = 0       # pages inserted by the demote path
        self.evictions = 0       # entries dropped for capacity
        # demote batch apply latency (worker thread, host clock)
        self._demote_lat = metrics.LatencyWindow()
        self._closed = False
        self._q = queue.Queue()
        self._worker = threading.Thread(target=self._drain,
                                        name="kv-host-tier", daemon=True)
        self._worker.start()

    # ---- entry lifecycle: both run under _lock -------------------------

    def _make_entry(self, blocks):
        entry, nbytes = {}, 0
        for path, arr in blocks.items():
            a = _host_copy(arr)
            entry[path] = a
            nbytes += a.numel() * a.element_size()
        self._bytes += nbytes
        return {"blocks": entry, "nbytes": nbytes}

    def _drop_entry(self, entry):
        self._bytes -= entry["nbytes"]

    # ---- public surface -------------------------------------------------

    def put(self, key, blocks, demotion=False):
        """Insert one page under ``key``; True when stored.  A duplicate
        key keeps the first write (the content is identical by keying);
        an oversized entry is refused.  Inserting past the byte budget
        evicts least-recently-used entries."""
        with self._lock:
            if self._closed or key in self._entries:
                return False
            entry = self._make_entry(blocks)
            nbytes = entry["nbytes"]
            if nbytes > self.capacity_bytes:
                self._drop_entry(entry)
                logger.warning("host tier refused a %d-byte page "
                               "(capacity %d)", nbytes, self.capacity_bytes)
                return False
            self._entries[key] = entry
            while self._bytes > self.capacity_bytes:
                victim = next(iter(self._entries))
                self._drop_entry(self._entries.pop(victim))
                self.evictions += 1
            if key not in self._entries:
                return False         # budget so tight we evicted ourselves
            if demotion:
                self.demotions += 1
            return True

    def contains(self, key):
        with self._lock:
            return key in self._entries

    def peek(self, key):
        """The page blocks for ``key`` (LRU-bumped), or None.  The entry
        STAYS cached: peer pulls and promote lookups read through here;
        only the promote commit discards."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return None
            self._entries[key] = entry        # move to the MRU end
            return entry["blocks"]

    def discard(self, key):
        """Drop ``key``'s entry if present (the promote commit: the page
        lives in the device prefix cache again)."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._drop_entry(entry)

    def clear(self):
        with self._lock:
            for entry in self._entries.values():
                self._drop_entry(entry)
            self._entries.clear()

    # ---- demote path ------------------------------------------------------

    def demote(self, keys, kv, n, event=None, keep=None):
        """Queue ``n`` gathered pages for insertion.  ``kv`` maps pool leaf
        path -> host tensor ``[width, ...]`` (width >= n; rows past n are
        ignored) whose copy from the card may still run: the worker
        waits on ``event`` (a CUDA event recorded after the copy, None
        on the CPU) before it reads them.  ``keep`` holds the source
        device tensors alive until then."""
        if self._closed or n < 1:
            return 0
        self._q.put(("demote", list(keys[:n]), kv, int(n), event, keep))
        return n

    def flush(self, timeout=30.0):
        """Block until every demote queued so far is applied (tests and
        shutdown; the data path never waits on the tier)."""
        ev = threading.Event()
        self._q.put(("flush", ev))
        return ev.wait(timeout)

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                if item[0] == "flush":
                    item[1].set()
                    continue
                _, keys, kv, n, event, keep = item
                t0 = time.monotonic()
                if event is not None:
                    event.synchronize()
                del keep         # the copy has landed: sources may go
                for i, key in enumerate(keys[:n]):
                    self.put(key, {path: a[i] for path, a in kv.items()},
                             demotion=True)
                self._demote_lat.record(time.monotonic() - t0)
            except Exception:
                # a poisoned demote must not kill the worker: the tier
                # degrades to a smaller cache, never to a dead thread
                logger.warning("host tier demote failed", exc_info=True)

    # ---- observability / teardown -----------------------------------------

    def stats(self):
        with self._lock:
            out = {"host_cache_bytes": int(self._bytes),
                   "host_cache_capacity_bytes": self.capacity_bytes,
                   "host_pages_cached": len(self._entries),
                   "host_demotions": int(self.demotions),
                   "host_evictions": int(self.evictions)}
        out.update(self._demote_lat.stats("host_demote_apply"))
        return out

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._q.put(None)
        self._worker.join(timeout=5.0)
        self.clear()
