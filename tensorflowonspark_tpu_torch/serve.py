"""Online :generate server over an exported decoder LM — the port of
``tensorflowonspark_tpu/serve.py`` at its paged, serial-engine
configuration.

    python -m tensorflowonspark_tpu_torch.serve --export_dir D \\
        --generate_kv_page_size 64 --generate_kv_pages N

    POST /v1/models/<name>:generate
        {"inputs": [[ids..]], "max_new_tokens": n, "temperature": t,
         "seed": s, "eos_id": e, "top_k": k, "top_p": p, "min_p": m}
        -> {"outputs": [prompt + new tokens, ...]}
    GET  /v1/models/<name>   -> engine stats and kernel launch counts
    GET  /healthz, /readyz

Every request runs through the ContinuousBatcher: slot-based continuous
batching over a paged kv cache, batched multi-row prefill rounds
interleaved with decode steps, the sink page for free rows and
bucket-pad overshoot.  Runs on ``cuda`` unless ``--device cpu`` is given;
without a CUDA device and without that request it raises.  Flags and
request fields whose feature is not ported raise NotImplementedError
(HTTP 501) naming the ROADMAP item; none is ignored.
"""
import argparse
import collections
import json
import logging
import queue as queue_mod
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from tensorflowonspark_tpu_torch import device as device_mod
from tensorflowonspark_tpu_torch import ops
from tensorflowonspark_tpu_torch.metrics import Counters
from tensorflowonspark_tpu_torch.models import decode as decode_mod

logger = logging.getLogger(__name__)

_ASYNC = "async engine, prefix cache, growable tables and streaming"


def build_argparser():
    p = argparse.ArgumentParser(
        prog="tensorflowonspark_tpu_torch.serve",
        description="online :generate HTTP server over an exported LM "
                    "(PyTorch / CUDA port, paged kv)")
    p.add_argument("--export_dir", required=True)
    p.add_argument("--model_name", default="default",
                   help="name served under /v1/models/<name>")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8501)
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: cuda; 'cpu' "
                        "must be asked for explicitly)")
    p.add_argument("--max_new_tokens_limit", type=int, default=512,
                   help="upper bound a :generate request may ask for")
    p.add_argument("--generate_slots", type=int, default=8,
                   help="decode slots (continuous batching: requests join "
                        "the in-flight batch at token boundaries)")
    p.add_argument("--generate_read_chunk", type=int, default=8,
                   help="decode steps per host readback")
    p.add_argument("--generate_prefill_chunk", type=int, default=512,
                   help="admission prefill chunk (tokens), rounded up to a "
                        "kv page multiple")
    p.add_argument("--generate_prefill_rows", type=int, default=4,
                   help="waiting requests that prefill one chunk each per "
                        "batched dispatch")
    p.add_argument("--generate_prefill_budget", type=int, default=0,
                   help="prefill tokens per scheduler round (0 = "
                        "prefill_rows * prefill_chunk)")
    p.add_argument("--generate_engine", choices=["async", "serial"],
                   default="serial",
                   help="decode engine; the port has the serial engine "
                        "(the async one is a ROADMAP item)")
    p.add_argument("--generate_timeout_s", type=float, default=None,
                   help="wall-time bound on one :generate request")
    p.add_argument("--generate_kv_page_size", type=int, default=0,
                   help="tokens per kv page (the port serves the paged "
                        "cache only: required)")
    p.add_argument("--generate_kv_pages", type=int, default=0,
                   help="pool size (pages) for --generate_kv_page_size")
    p.add_argument("--generate_kv_dtype", choices=["auto", "int8"],
                   default="auto")
    p.add_argument("--generate_quantize", choices=["none", "int8", "int4"],
                   default="none")
    p.add_argument("--spec_draft", choices=["model", "ngram", "off"],
                   default=None)
    p.add_argument("--draft_export_dir", default=None)
    p.add_argument("--generate_lora_rank", type=int, default=0)
    p.add_argument("--generate_host_cache_mb", type=int, default=0)
    p.add_argument("--generate_long_prompt_threshold", type=int, default=0)
    p.add_argument("--generate_preempt_ms", type=float, default=0.0)
    p.add_argument("--fleet", default=None, metavar="HOST:PORT")
    p.add_argument("--verbose", action="store_true")
    return p


# (flag, predicate of "asked for", ROADMAP item)
_UNPORTED_FLAGS = (
    ("generate_engine", lambda v: v == "async", _ASYNC),
    ("generate_kv_dtype", lambda v: v == "int8",
     "int8 kv branch of kernels 1-3"),
    ("generate_quantize", lambda v: v != "none",
     "quantised weights (kernels 9 and 10)"),
    ("spec_draft", lambda v: v in ("model", "ngram"),
     "LoRA and speculation"),
    ("draft_export_dir", bool, "LoRA and speculation"),
    ("generate_lora_rank", lambda v: v > 0, "LoRA and speculation"),
    ("generate_host_cache_mb", lambda v: v > 0,
     "migration, host tier and fleet"),
    ("generate_long_prompt_threshold", lambda v: v > 0, _ASYNC),
    ("generate_preempt_ms", lambda v: v > 0,
     "migration, host tier and fleet"),
    ("fleet", bool, "migration, host tier and fleet"),
)


def _is_int(x):
    """A real int: JSON true/false arrive as bools, which are ints."""
    return isinstance(x, int) and not isinstance(x, bool)


def _bucket_len(n, cap):
    """Padded length of a prefill chunk of `n` tokens: the next power of
    two (floor 8), capped at the configured chunk size."""
    return min(max(8, 1 << (n - 1).bit_length()), cap)


def _pow2_width(n):
    """Padded row count of a batched prefill dispatch: next power of 2."""
    return 1 << (n - 1).bit_length()


def max_table_pages(max_seq_len, kv_page_size):
    """The page-table width of one row: enough entries to map a full
    max_seq_len sequence."""
    return max_seq_len // kv_page_size


def _aligned_prefill_chunk(prefill_chunk, kv_page_size):
    """Effective prefill chunk: floor 8, rounded UP to a page multiple."""
    chunk = max(8, prefill_chunk)
    if kv_page_size and chunk % kv_page_size:
        aligned = -(-chunk // kv_page_size) * kv_page_size
        logger.warning("prefill_chunk %d is not a multiple of kv_page_size "
                       "%d; rounding up to %d", chunk, kv_page_size, aligned)
        return aligned
    return chunk


class SlotHandle:
    """One in-flight generation; ``.result()`` blocks for the full
    sequence (per-token streaming is a ROADMAP item)."""

    def __init__(self):
        self.cancelled = threading.Event()
        self._done = threading.Event()
        self._outcome_lock = threading.Lock()   # first outcome wins
        self._seq = None
        self._err = None

    def cancel(self):
        """Stop decoding for this request: the batcher retires its slot
        at the next readback."""
        self.cancelled.set()

    def _finish(self, seq):
        with self._outcome_lock:
            if self._done.is_set():
                return
            self._seq = seq
            self._done.set()

    def _fail(self, err):
        with self._outcome_lock:
            if self._done.is_set():
                return
            self._err = err
            self._done.set()

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError("generation did not complete in time")
        if self._err is not None:
            raise self._err
        return self._seq


class ContinuousBatcher:
    """The serving decode engine: slot-based continuous batching over the
    paged kv cache (models.decode).  New requests prefill into a free
    slot in chunks, batched across up to ``prefill_rows`` admissions per
    dispatch and interleaved with decode steps; finished slots retire at
    readback boundaries.  One engine thread owns the model and the cache
    (the JAX package's serial engine).

    Pool: ``kv_pages + 1`` pages, the last one the garbage SINK.  Free
    rows keep decoding junk (every step runs all rows) and bucket-pad
    overshoot lands past a row's allocation, so every unallocated table
    entry names the sink, never a page another row owns.  Admission
    takes a row's whole need (``ceil((prompt + max_new) / page)``) from
    the free list; when the pool is short the admission waits at the
    head of the line.

    Greedy rows decode exactly the tokens of a solo ``decode.generate``;
    sampled rows draw the counter-based noise of (seed, ordinal), so a
    seeded request reproduces itself.
    """

    def __init__(self, model, n_slots=8, max_pending=1024, read_chunk=8,
                 prefill_chunk=512, prefill_rows=4, prefill_budget=0,
                 kv_page_size=0, kv_pages=0, kv_dtype=None,
                 engine="serial", device=None):
        if engine != "serial":
            raise NotImplementedError(
                f"engine={engine!r} is not ported yet (ROADMAP: {_ASYNC})")
        if not kv_page_size:
            raise NotImplementedError(
                "the dense slot cache is not ported yet (ROADMAP: "
                f"{_ASYNC}); serve the paged cache (kv_page_size > 0, "
                "--generate_kv_page_size)")
        if int(kv_pages) < 1:
            raise ValueError("kv_page_size > 0 requires kv_pages >= 1")
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.device = device_mod.resolve(device)
        param_dev = next(model.parameters()).device
        if param_dev.type != self.device.type:
            raise ValueError(f"model parameters are on {param_dev}, the "
                             f"batcher runs on {self.device}")
        self.engine = engine
        self.model = model
        self.n_slots = n_slots
        self.kv_page_size = int(kv_page_size)
        self.max_seq = model.cfg.max_seq_len
        self.counters = Counters()
        self._sink = int(kv_pages)
        self._total_pages = int(kv_pages)
        self._table_width = max_table_pages(self.max_seq, self.kv_page_size)
        _, self._cache = decode_mod.init_paged_slot_cache(
            model, n_slots, self.kv_page_size, int(kv_pages) + 1,
            kv_dtype=kv_dtype)
        self._sink_entries = [self._sink] * self._table_width
        for row in range(n_slots):       # unoccupied rows start at the sink
            decode_mod.set_row_page_table(self._cache, row,
                                          self._sink_entries)
        # engine-thread-owned free list; stats() only takes len() of it
        # graftcheck: disable-next-line=thread-race
        self._free_pages = list(range(int(kv_pages)))
        self._row_pages = [None] * n_slots
        self._parked = None    # admission waiting for pool pages (FIFO)
        self.read_chunk = max(1, read_chunk)
        self.prefill_chunk = _aligned_prefill_chunk(prefill_chunk,
                                                    self.kv_page_size)
        self.prefill_rows = max(1, int(prefill_rows or 1))
        self.prefill_budget = (int(prefill_budget or 0)
                               or self.prefill_rows * self.prefill_chunk)
        self._pending = queue_mod.Queue(max_pending)
        self._waiting = collections.deque()   # engine-thread FIFO
        # cells are rebound, never resized; the generation counter makes
        # stale readback entries self-invalidating
        # graftcheck: disable-next-line=thread-race
        self._slots = [None] * n_slots
        self._gen = [0] * n_slots
        # graftcheck: disable-next-line=thread-race
        self._admissions = []        # in-flight chunked admissions
        self._ttft = []              # seconds, submit -> first token
        self._ttft_lock = threading.Lock()
        # per-row decode state: the previous pick on the device, the
        # sampling controls on the host (free rows: greedy, no filter)
        self._toks = torch.zeros((n_slots,), dtype=torch.int64,
                                 device=self.device)
        self._temps = [0.0] * n_slots
        self._seeds = [0] * n_slots
        self._ords = [0] * n_slots
        self._topks = [0] * n_slots
        self._topps = [1.0] * n_slots
        self._minps = [0.0] * n_slots
        self._n_filtered = 0
        self._steps = 0
        self._step_ms = collections.deque(maxlen=1024)   # decode-only chunks
        self._dead = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="slot-batcher", daemon=True)
        self._thread.start()

    # ---- public surface -------------------------------------------------

    def stats(self):
        """Operational snapshot: occupancy, queue depth, dispatch counts,
        pool state, TTFT and the kernels' launch counts (monitoring
        reads; momentary skew is fine)."""
        free = len(self._free_pages)
        with self._ttft_lock:
            ttft = sorted(self._ttft)
        step_ms = list(self._step_ms)
        out = {
            "slots_busy": sum(s is not None for s in self._slots),
            "pending": self._pending.qsize() + len(self._waiting),
            "admissions_inflight": len(self._admissions),
            "prefill_rows": self.prefill_rows,
            "prefill_budget": self.prefill_budget,
            "requests_served": self.counters.get("requests_served"),
            "decode_steps": self._steps,
            "engine": self.engine,
            "device": str(self.device),
            "kv_pages_free": free,
            "kv_pages_total": self._total_pages,
            "kv_pages_used": self._total_pages - free,
            "kv_page_size": self.kv_page_size,
            # host-clock ms per decode step over readback chunks with no
            # prefill or idle wait in them (the readback syncs the card)
            "decode_step_ms_mean": (sum(step_ms) / len(step_ms)
                                    if step_ms else 0.0),
            "ttft_count": len(ttft),
            "ttft_sum_s": sum(ttft),
            "ttft_p50_ms": (1000.0 * ttft[len(ttft) // 2] if ttft else 0.0),
            "ttft_p95_ms": (1000.0 * ttft[min(len(ttft) - 1,
                                              int(0.95 * len(ttft)))]
                            if ttft else 0.0),
            "kernel_launches": ops.launch_counts(ops.SERVING_KERNELS),
        }
        out.update(self.counters.snapshot())
        return out

    def submit(self, prompt, max_new, temperature=0.0, eos_id=None, seed=0,
               top_k=0, top_p=1.0, min_p=0.0):
        if self._dead is not None:
            raise RuntimeError(f"batcher died: {self._dead}")
        decode_mod.check_pick_args(temperature, top_k, top_p, min_p)
        if not prompt or max_new < 1:
            raise ValueError("need a non-empty prompt and max_new >= 1")
        if len(prompt) + max_new > self.max_seq:
            raise ValueError(f"prompt {len(prompt)} + max_new_tokens "
                             f"{max_new} exceeds max_seq_len {self.max_seq}")
        need = self._pages_needed(len(prompt), max_new)
        if need > self._total_pages:
            # a request the whole pool cannot hold would wait forever at
            # the head of the line, wedging every later admission
            raise ValueError(
                f"request needs {need} kv pages but the pool only has "
                f"{self._total_pages}; raise --generate_kv_pages or shorten "
                "the request")
        h = SlotHandle()
        self._pending.put({
            "h": h, "prompt": list(prompt), "max_new": int(max_new),
            "temp": float(temperature), "eos": eos_id, "seed": int(seed),
            "topk": int(top_k), "topp": float(top_p), "minp": float(min_p),
            "t_submit": time.monotonic()})
        if self._dead is not None:
            # the loop may have died between the check and the put
            self._drain_pending(RuntimeError(f"batcher died: {self._dead}"))
        return h

    def stop(self, timeout=30):
        """Shut the engine thread down; queued, in-flight and
        mid-admission requests fail with RuntimeError."""
        self._stop.set()
        self._thread.join(timeout)
        self._fail_all(RuntimeError("batcher stopped"))

    # ---- pool -----------------------------------------------------------

    def _pages_needed(self, prompt_len, max_new):
        return -(-(prompt_len + max_new) // self.kv_page_size)

    def _try_allocate(self, row, item):
        """Reserve `item`'s whole page need for `row`, or False when the
        free list cannot cover it (the caller parks the item)."""
        need = self._pages_needed(len(item["prompt"]), item["max_new"])
        if len(self._free_pages) < need:
            return False
        pages = [self._free_pages.pop() for _ in range(need)]
        if self._sink in pages:
            raise RuntimeError(f"page allocator handed out the sink page "
                               f"{self._sink}; the free list is corrupted")
        decode_mod.set_row_page_table(
            self._cache, row,
            pages + [self._sink] * (self._table_width - len(pages)))
        self._row_pages[row] = pages
        return True

    def _free_row(self, row):
        """Retire `row`: its pages go back to the free list and its table
        points at the sink, so its garbage decode never writes pages a
        later owner holds."""
        s = self._slots[row]
        if s is not None and s["filtered"]:
            self._n_filtered -= 1
        self._slots[row] = None
        self._temps[row] = 0.0           # free rows decode greedily
        self._topks[row], self._topps[row], self._minps[row] = 0, 1.0, 0.0
        if self._row_pages[row] is not None:
            self._free_pages.extend(self._row_pages[row])
            self._row_pages[row] = None
            decode_mod.set_row_page_table(self._cache, row,
                                          self._sink_entries)

    # ---- admission and batched prefill ------------------------------------

    def _prefill_chunk_sizes(self, length):
        sizes, rest = [], length
        while rest > self.prefill_chunk:
            sizes.append(self.prefill_chunk)
            rest -= self.prefill_chunk
        sizes.append(rest)
        return sizes

    def _start_admission(self, row, item):
        h, prompt = item["h"], item["prompt"]
        if h.cancelled.is_set():        # client gone before admission
            h._finish(list(prompt))
            return
        if not self._try_allocate(row, item):
            self._parked = (row, item)  # wait for pages (FIFO)
            return
        self._admissions.append({
            "row": row, "item": item, "offset": 0, "i": 0,
            "sizes": self._prefill_chunk_sizes(len(prompt))})

    def _admit(self, block=False):
        """Pull waiting requests into the admission pipeline until it is
        `prefill_rows` wide (or rows / requests run out)."""
        while True:
            try:
                item = self._pending.get(
                    timeout=0.05 if block and not self._waiting else 0)
            except queue_mod.Empty:
                break
            block = False
            self._waiting.append(item)
        claimed = {adm["row"] for adm in self._admissions}

        def free_row_index():
            return next((r for r in range(self.n_slots)
                         if self._slots[r] is None and r not in claimed),
                        None)

        if self._parked is not None:
            row, item = self._parked
            self._parked = None
            if self._slots[row] is not None or row in claimed:
                row = free_row_index()     # the original row got taken
                if row is None:
                    self._parked = (0, item)
                    return
            self._start_admission(row, item)
            if self._parked is not None:
                return      # still starved: nothing else admits (FIFO)
            claimed.add(row)
        while len(self._admissions) < self.prefill_rows and self._waiting:
            row = free_row_index()
            if row is None:
                return
            self._start_admission(row, self._waiting.popleft())
            if self._parked is not None:
                return
            claimed.add(row)

    def _select_prefill(self):
        """This round's admissions: the head always (a budget caps
        batching, it never blocks progress), then FIFO while the summed
        chunk lengths fit the budget and the width `prefill_rows`."""
        selected, spent = [], 0
        for adm in self._admissions:
            size = adm["sizes"][adm["i"]]
            if selected and (len(selected) >= self.prefill_rows
                             or spent + size > self.prefill_budget):
                break
            selected.append(adm)
            spent += size
        return selected

    def _run_prefill_round(self):
        """One batched prefill dispatch over the admission queue; each
        row whose prompt completes picks its first token and occupies
        its slot.  Returns whether a dispatch ran."""
        live = []
        for adm in self._admissions:
            if adm["item"]["h"].cancelled.is_set():
                self._free_row(adm["row"])
                adm["item"]["h"]._finish(list(adm["item"]["prompt"]))
            else:
                live.append(adm)
        self._admissions = live
        selected = self._select_prefill()
        if not selected:
            return False
        entries, finishing = [], []
        for adm in selected:
            off, size = adm["offset"], adm["sizes"][adm["i"]]
            chunk = adm["item"]["prompt"][off:off + size]
            entries.append((adm["row"], chunk, off))
            adm["offset"] = off + len(chunk)
            adm["i"] += 1
            if adm["offset"] >= len(adm["item"]["prompt"]):
                finishing.append(adm)
        bucket = _bucket_len(max(len(c) for _, c, _ in entries),
                             self.prefill_chunk)
        width = _pow2_width(len(entries))
        pad = (sum(bucket - len(c) for _, c, _ in entries)
               + (width - len(entries)) * bucket)
        if pad:      # bucket overshoot and pad rows write into the sink
            self.counters.inc("kv_sink_writes", pad)
        chunks, rows, starts, n_valids = decode_mod.build_prefill_batch(
            entries, width, bucket, self.n_slots, self.device)
        with torch.no_grad():
            logits = decode_mod.slot_prefill_many(
                self.model, self._cache, chunks, rows, starts, n_valids,
                self._sink)
        self.counters.inc("prefill_dispatches")
        for i, adm in enumerate(selected):
            if adm in finishing:
                self._admissions.remove(adm)
                self._finish_admission(adm, logits[i])
        return True

    def _finish_admission(self, adm, logits_row):
        """Final chunk done: pick the first token (ordinal 0 of the
        request's noise), record TTFT, occupy the row for decode."""
        item, row = adm["item"], adm["row"]
        h, prompt, max_new = item["h"], item["prompt"], item["max_new"]
        filt = bool(item["temp"] > 0 and (item["topk"] or item["topp"] < 1.0
                                          or item["minp"] > 0.0))
        fkw = ({"topks": [item["topk"]], "topps": [item["topp"]],
                "minps": [item["minp"]]} if filt else {})
        tok = int(decode_mod.pick_tokens(
            logits_row[None], [item["temp"]], [item["seed"]], [0],
            **fkw)[0])
        with self._ttft_lock:
            self._ttft.append(time.monotonic() - item["t_submit"])
            del self._ttft[:-1024]        # a bounded recent window
        seq = prompt + [tok]
        eos = item["eos"]
        if max_new <= 1 or (eos is not None and tok == eos):
            self._free_row(row)
            h._finish(seq)
            self.counters.inc("requests_served")
            return
        self._gen[row] += 1
        # a fresh tensor: pending readback entries still hold the old one
        self._toks = self._toks.clone()
        self._toks[row] = tok
        self._temps[row] = item["temp"]
        self._seeds[row] = item["seed"]
        self._ords[row] = 1
        self._topks[row] = item["topk"]
        self._topps[row] = item["topp"]
        self._minps[row] = item["minp"]
        if filt:
            self._n_filtered += 1
        self._slots[row] = {"handle": h, "seq": seq, "remaining": max_new - 1,
                            "eos": eos, "filtered": filt}

    # ---- decode and readback ----------------------------------------------

    def _dispatch(self):
        """One decode step for every row (free rows write the sink)."""
        idle = sum(s is None for s in self._slots)
        if idle:
            self.counters.inc("kv_sink_writes", idle)
        fkw = ({"topks": self._topks, "topps": self._topps,
                "minps": self._minps} if self._n_filtered else {})
        with torch.no_grad():
            self._toks = decode_mod.slot_step(
                self.model, self._cache, self._toks, self._temps,
                self._seeds, self._ords, **fkw)
        self._ords = [o + 1 for o in self._ords]
        self._steps += 1
        return self._toks, tuple(self._gen)

    def _process(self, reads):
        """Read a chunk of steps back and commit its tokens; retire rows
        that were cancelled, ran out of budget or emitted eos."""
        block = torch.stack([t for t, _ in reads]).cpu().tolist()
        for row_toks, (_, gens) in zip(block, reads):
            for r, s in enumerate(self._slots):
                if s is None or self._gen[r] != gens[r]:
                    continue      # freed or re-occupied since dispatch
                if not s["handle"].cancelled.is_set():
                    tok = row_toks[r]
                    s["seq"].append(tok)
                    s["remaining"] -= 1
                    if s["remaining"] > 0 and tok != s["eos"]:
                        continue
                self._free_row(r)
                s["handle"]._finish(s["seq"])
                self.counters.inc("requests_served")
        self.counters.inc("host_ticks")

    def _flush_due(self, n_reads, active):
        if not n_reads:
            return False
        if n_reads >= self.read_chunk or not active:
            return True
        near = min((s["remaining"] for s in self._slots
                    if s is not None and s["remaining"] > 0), default=None)
        return near is not None and near <= n_reads

    def _loop(self):
        try:
            reads = []
            mark, clean = time.monotonic(), False
            while not self._stop.is_set():
                idle = (all(s is None for s in self._slots)
                        and not self._admissions and self._parked is None
                        and not reads)
                self._admit(block=idle)
                if self._run_prefill_round() or idle:
                    clean = False
                active = any(s is not None for s in self._slots)
                if active:
                    reads.append(self._dispatch())
                if self._flush_due(len(reads), active):
                    self._process(reads)
                    now = time.monotonic()
                    if clean:
                        self._step_ms.append(
                            (now - mark) * 1000.0 / len(reads))
                    mark, clean = now, True
                    reads = []
        except BaseException as e:     # device failure: fail everything
            logger.exception("continuous batcher died")
            self._dead = e
            self._stop.set()
            self._fail_all(e)

    def _drain_pending(self, err):
        while self._waiting:
            self._waiting.popleft()["h"]._fail(err)
        while True:
            try:
                item = self._pending.get_nowait()
            except queue_mod.Empty:
                return
            item["h"]._fail(err)

    def _fail_all(self, err):
        adms, self._admissions = self._admissions, []
        for adm in adms:
            adm["item"]["h"]._fail(err)
        parked, self._parked = self._parked, None
        if parked is not None:
            parked[1]["h"]._fail(err)
        for s in self._slots:
            if s is not None:
                s["handle"]._fail(err)
        self._slots = [None] * self.n_slots
        self._drain_pending(err)


# request fields of the JAX package's :generate whose feature is not
# ported: (field, predicate of "asked for", ROADMAP item)
_UNPORTED_FIELDS = (
    ("stream", bool, _ASYNC),
    ("stop", bool, "LoRA and speculation"),
    ("repetition_penalty", lambda v: v != 1.0, "LoRA and speculation"),
    ("adapter", lambda v: v is not None, "LoRA and speculation"),
    ("priority", lambda v: v is not None, "migration, host tier and fleet"),
    ("trace", lambda v: v is not None, "migration, host tier and fleet"),
)


class GenerateService:
    """Autoregressive generation over an exported decoder LM: loads the
    export onto the device at the model's compute width and serves every
    request through one ContinuousBatcher."""

    _I32 = 1 << 31

    def __init__(self, export_dir, max_new_tokens_limit=512, slots=8,
                 read_chunk=8, prefill_chunk=512, prefill_rows=4,
                 prefill_budget=0, request_timeout_s=None, kv_page_size=0,
                 kv_pages=0, engine="serial", device=None):
        from tensorflowonspark_tpu_torch import export as export_mod
        from tensorflowonspark_tpu_torch.models.transformer import (
            Transformer, torch_dtype)

        self.device = device_mod.resolve(device)
        model, _ = export_mod.load_model(export_dir, device=self.device)
        if not isinstance(model, Transformer):
            raise TypeError(f"export builder rebuilds {type(model).__name__}"
                            ", not a Transformer — :generate serves decoder "
                            "LMs only")
        # serving reads every weight once per token: keep them at the
        # model's compute width, as the JAX service does
        self.model = model.to(torch_dtype(model.cfg)).eval()
        self.model.requires_grad_(False)
        self.batcher = ContinuousBatcher(
            self.model, n_slots=slots or 8, read_chunk=read_chunk,
            prefill_chunk=prefill_chunk, prefill_rows=prefill_rows,
            prefill_budget=prefill_budget, kv_page_size=kv_page_size,
            kv_pages=kv_pages, engine=engine, device=self.device)
        self.limit = max_new_tokens_limit
        self.timeout_s = request_timeout_s or max(
            600.0, 2.0 * max_new_tokens_limit)
        self._auto_seed = iter(range(1 << 20, 1 << 31))
        self._seed_lock = threading.Lock()

    def _validate(self, req):
        for field, asked, item in _UNPORTED_FIELDS:
            if field in req and asked(req[field]):
                raise NotImplementedError(
                    f'request field "{field}" is not ported yet (ROADMAP: '
                    f"{item})")
        inputs = req.get("inputs")
        if (not isinstance(inputs, list) or not inputs
                or not all(isinstance(p, list) and p
                           and all(_is_int(t) and 0 <= t < self._I32
                                   for t in p) for p in inputs)):
            raise ValueError('"inputs" must be a non-empty list of non-empty '
                             "lists of token ids in [0, 2^31)")
        max_new = req.get("max_new_tokens", 16)
        if not _is_int(max_new) or not 1 <= max_new <= self.limit:
            raise ValueError(f'"max_new_tokens" must be an int in '
                             f"[1, {self.limit}]")
        temperature = float(req.get("temperature", 0.0))
        if temperature < 0:
            raise ValueError('"temperature" must be >= 0')
        eos_id = req.get("eos_id")
        if eos_id is not None and not (_is_int(eos_id)
                                       and -self._I32 <= eos_id < self._I32):
            raise ValueError('"eos_id" must be an int32')
        seed = req.get("seed")
        if seed is not None and not (
                _is_int(seed) and -self._I32 <= seed < self._I32 - len(inputs)):
            raise ValueError('"seed" must be an int32 (with headroom for '
                             "per-prompt offsets)")
        top_k = req.get("top_k", 0)
        top_p = float(req.get("top_p", 1.0))
        min_p = float(req.get("min_p", 0.0))
        decode_mod.check_pick_args(temperature, top_k, top_p, min_p)
        return inputs, max_new, temperature, eos_id, seed, top_k, top_p, min_p

    def _prompt_seeds(self, n, seed, temperature):
        """Explicit seed s -> s, s+1, ...; unseeded sampling -> a fresh
        seed per prompt; greedy -> 0."""
        if seed is not None:
            return [seed + i for i in range(n)]
        if temperature > 0:
            with self._seed_lock:
                return [next(self._auto_seed) for _ in range(n)]
        return [0] * n

    def generate(self, req):
        (inputs, max_new, temperature, eos_id, seed, top_k, top_p,
         min_p) = self._validate(req)
        seeds = self._prompt_seeds(len(inputs), seed, temperature)
        handles = []
        try:
            for p, s in zip(inputs, seeds):
                handles.append(self.batcher.submit(
                    p, max_new, temperature=temperature, eos_id=eos_id,
                    seed=s, top_k=top_k, top_p=top_p, min_p=min_p))
            outs = [h.result(timeout=self.timeout_s) for h in handles]
        except Exception:
            # a failed request must not leave its other prompts decoding
            for h in handles:
                h.cancel()
            raise
        return outs

    def close(self):
        self.batcher.stop()


class ModelService:
    """The served model: resolves the device at construction (raising
    without CUDA unless the CPU was asked for) and builds the
    GenerateService lazily on the first :generate."""

    def __init__(self, args):
        self.args = args
        self.device = device_mod.resolve(getattr(args, "device", None))
        self.export_dir = args.export_dir
        self.model_name = getattr(args, "model_name", "default")
        self.desc = f"torch-{self.device.type}"
        self._gen = None
        self._gen_lock = threading.Lock()

    def generate_service(self):
        with self._gen_lock:
            if self._gen is None:
                a = self.args
                self._gen = GenerateService(
                    self.export_dir,
                    max_new_tokens_limit=a.max_new_tokens_limit,
                    slots=a.generate_slots, read_chunk=a.generate_read_chunk,
                    prefill_chunk=a.generate_prefill_chunk,
                    prefill_rows=a.generate_prefill_rows,
                    prefill_budget=a.generate_prefill_budget,
                    request_timeout_s=a.generate_timeout_s,
                    kv_page_size=a.generate_kv_page_size,
                    kv_pages=a.generate_kv_pages,
                    engine=a.generate_engine, device=self.device)
            return self._gen

    def metadata(self):
        out = {"model": {"export_dir": self.export_dir, "engine": self.desc,
                         "device": str(self.device)},
               "status": "ok"}
        with self._gen_lock:
            gen = self._gen
        if gen is not None:
            out["model"]["generate"] = "available"
            out["model"]["generate_slots"] = gen.batcher.n_slots
            out["model"]["generate_stats"] = gen.batcher.stats()
        out["model"]["kernel_launches"] = ops.launch_counts(
            ops.SERVING_KERNELS)
        return out

    def close(self):
        with self._gen_lock:
            gen, self._gen = self._gen, None
        if gen is not None:
            gen.close()


class _Handler(BaseHTTPRequestHandler):
    service = None   # injected by make_server
    protocol_version = "HTTP/1.1"

    def _send(self, code, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        name = self.service.model_name
        path = self.path.rstrip("/") or "/"
        if path in ("/healthz", "/readyz"):
            self._send(200, {"status": "ok"})
        elif path == "/" or path == f"/v1/models/{name}":
            self._send(200, self.service.metadata())
        else:
            self._send(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        name = self.service.model_name
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length) if length else b""
        if self.path != f"/v1/models/{name}:generate":
            self._send(404, {"error": f"unknown path {self.path} (serving "
                             f"model {name!r}; the port serves :generate "
                             "only)"})
            return
        try:
            req = json.loads(body or b"{}")
            if not isinstance(req, dict):
                raise ValueError("request body must be a JSON object")
            outs = self.service.generate_service().generate(req)
            self._send(200, {"outputs": outs})
        except NotImplementedError as e:
            self._send(501, {"error": str(e), "type": "not_ported"})
        except (ValueError, KeyError, TypeError) as e:
            self._send(400, {"error": str(e) or type(e).__name__})
        except Exception as e:   # keep the server alive on model errors
            logger.exception("generate failed")
            self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def log_message(self, fmt, *args):
        logger.debug("http: " + fmt, *args)


def make_server(args):
    """Build (server, service); the caller runs serve_forever().  Flags
    whose feature is not ported raise NotImplementedError; the device is
    resolved here, so a missing CUDA device raises before serving."""
    for flag, asked, item in _UNPORTED_FLAGS:
        if asked(getattr(args, flag, None) or 0):
            raise NotImplementedError(
                f"--{flag}={getattr(args, flag)!r} is not ported yet "
                f"(ROADMAP: {item})")
    if getattr(args, "generate_slots", 8) < 1:
        raise ValueError("--generate_slots must be >= 1")
    if not getattr(args, "generate_kv_page_size", 0):
        raise NotImplementedError(
            f"the dense slot cache is not ported yet (ROADMAP: {_ASYNC}); "
            "serve the paged cache with --generate_kv_page_size and "
            "--generate_kv_pages")
    if getattr(args, "generate_kv_pages", 0) < 1:
        raise ValueError("--generate_kv_page_size needs "
                         "--generate_kv_pages >= 1 (the shared pool size)")
    if getattr(args, "generate_prefill_rows", 4) < 1:
        raise ValueError("--generate_prefill_rows must be >= 1")
    if getattr(args, "generate_prefill_budget", 0) < 0:
        raise ValueError("--generate_prefill_budget must be >= 0")
    service = ModelService(args)
    handler = type("BoundHandler", (_Handler,), {"service": service})

    class _Server(ThreadingHTTPServer):
        daemon_threads = True

        def server_close(self):
            super().server_close()
            service.close()

    return _Server((args.host, args.port), handler), service


def main(argv=None):
    args = build_argparser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s")
    server, service = make_server(args)
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port} ({service.desc})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
