"""Online :predict / :generate server over an export — the port of
``tensorflowonspark_tpu/serve.py``.

    python -m tensorflowonspark_tpu_torch.serve --export_dir D \\
        [--engine auto|native|jax|builder] [--batch_size 64] \\
        [--batch_wait_ms MS] [--signature_def_key K] \\
        [--input_mapping JSON] [--output_mapping JSON] \\
        [--generate_kv_page_size 64 --generate_kv_pages N] \\
        [--generate_engine async|serial] [--generate_pipeline_depth 2] \\
        [--generate_long_prompt_threshold T] \\
        [--generate_quantize int8|int4] [--generate_kv_dtype int8] \\
        [--generate_lora_rank R --generate_lora NAME=PATH ...] \\
        [--spec_draft model|ngram --draft_export_dir D2 --draft_k K] \\
        [--generate_host_cache_mb MB] [--role mixed|prefill|decode] \\
        [--generate_priority_weight W --generate_preempt_ms MS \\
         --generate_park_capacity N] \\
        [--generate_trace_ring N --generate_trace_decode_sample N] \\
        [--fleet HOST:PORT --fleet_heartbeat_s S]

    POST /v1/models/<name>:predict
        {"instances": [{feature: value, ..}, ..]} (or bare rows for a
        single-input model) -> {"predictions": [{output: value}, ..]}
    POST /v1/models/<name>:generate
        {"inputs": [[ids..]], "max_new_tokens": n, "temperature": t,
         "seed": s, "eos_id": e, "top_k": k, "top_p": p, "min_p": m,
         "stop": [[ids..]], "repetition_penalty": r, "adapter": "NAME",
         "priority": "interactive"|"batch", "trace": "<hex id>"}
        -> {"outputs": [prompt + new tokens, ...]}
        with "stream": true (one prompt): chunked application/x-ndjson,
        {"token": t} per token, then {"done": true, "output": [...]}
        (headers: X-Priority, X-Trace-Id, Idempotency-Key,
        X-Fleet-Migrate-To: host:port, X-Fleet-KV-Peer: host:port)
    POST /v1/models/<name>:resume   {"meta", "pull"} or {"replay"}:
        ndjson, the first event {"resumed": true} (the splice ack)
    POST /v1/kv:export              {"dest": {"host", "port"}} or "dests"
    POST /v1/fleet:drain            fence admissions, wait for idle
    POST /v1/debug:profile          {"duration_ms": n, "dir": D}: a
        torch.profiler capture -> {"artifact": trace.json, "duration_ms"}
    GET  /v1/models/<name>   -> engine stats and kernel launch counts
    GET  /metrics, /v1/metrics (Prometheus text), /v1/trace/<id>
    GET  /healthz, /readyz (503 + Retry-After while draining)

:predict serves the export's signature as the JAX server does: the
engine of the batch CLI (``inference._load_predictor``: the port's
AOT artifact — ``torch.export`` program or AOTInductor package — or
the rebuilt module), its weights loaded at the first :predict, one
device execution at a time, or coalesced across concurrent requests
over ``--batch_wait_ms`` (up to ``--batch_size`` rows).

Every :generate runs through the ContinuousBatcher, as in the JAX server:
slot-based continuous batching with batched multi-row prefill rounds
interleaved with decode steps, by default on the async engine (a device
thread dispatching, a host thread reading back) over the dense slot
cache.  ``--generate_kv_page_size`` serves a paged pool instead (the
sink page for free rows and bucket-pad overshoot, growable page tables,
the prefix cache, the mega-prompt lane above
``--generate_long_prompt_threshold``).  ``--generate_quantize int8|int4``
serves weight-only quantised projections (W8A16 / W4A16) through kernels
9 and 10; ``--generate_kv_dtype int8`` keeps the kv cache in int8 with
f32 per-(token, head) scales (the int8 branch of kernels 1-3 over a
paged pool).  An export may be the port's or the JAX package's
(``params.msgpack``); a stored int8 export served with
``--generate_quantize int8`` keeps its stored bytes.

As in the JAX server: stop sequences and a repetition penalty per
request (the penalty's ``seen`` table on the device); a bank of LoRA
adapters (``--generate_lora_rank``, ``--generate_lora NAME=PATH``, the
``adapter`` field; rows of several tenants share one batched step, and
prefix-cache keys are rooted at the adapter's registration, so kv
prefilled under one adapter never serves another); speculative decoding
(``--spec_draft model`` with ``--draft_export_dir``, or ``ngram``): k
proposals a row, one target pass over the ``[n, k]`` block, 1..k
committed tokens a row (greedy rows: the target's own argmax; sampled
rows: the rejection walk), the draft k adapted from each row's
acceptance.

The replica side of the fleet, as in the JAX server: live sessions move
between replicas (``kvtransfer``: a freeze at a committed host tick, the
pages over a socket, ``:resume`` on the destination, the source's stream
relayed), which ``--role prefill`` uses to hand sessions to a decode
replica (``X-Fleet-Migrate-To``); a host-memory page tier behind the
pool (``--generate_host_cache_mb``, ``kvtier``: evicted and retired
prefix pages demote and promote back on a later hit, and peers pull
them, ``X-Fleet-KV-Peer``); priority classes with weighted-fair
admission and a preemption controller that parks batch sessions
host-side while interactive work waits (``--generate_preempt_ms``);
request tracing (``trace``) and a Prometheus scrape.  ``--fleet
HOST:PORT`` registers the replica with a port gateway (``fleet``,
``fleet_client``), heartbeats every ``--fleet_heartbeat_s`` and says
BYE at shutdown.  ``POST /v1/debug:profile`` captures a
``torch.profiler`` trace while serving goes on.  Runs on ``cuda``
unless ``--device cpu`` is given; without a CUDA device and without
that request it raises.  Flags and request fields whose feature is not
ported raise NotImplementedError (HTTP 501) naming the ROADMAP item;
none is ignored.
"""
import argparse
import collections
import contextlib
import dataclasses
import itertools
import json
import logging
import os
import queue as queue_mod
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from tensorflowonspark_tpu_torch import device as device_mod
from tensorflowonspark_tpu_torch import faults, ops, trace
from tensorflowonspark_tpu_torch import lora as lora_mod
from tensorflowonspark_tpu_torch import quantize as quantize_mod
from tensorflowonspark_tpu_torch.metrics import Counters, Gauge, LatencyWindow
from tensorflowonspark_tpu_torch.models import decode as decode_mod
from tensorflowonspark_tpu_torch.parallel import collectives as coll
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_mod

logger = logging.getLogger(__name__)

# weight-only quantisation modes of --generate_quantize
QUANTIZE_MODES = ("none",) + quantize_mod.MODES
# :generate priority classes (the "priority" field / X-Priority header)
PRIORITY_CLASSES = ("interactive", "batch")
# the device operations of a tp serving engine, by header code: the
# leader applies each through ContinuousBatcher._devop, which first sends
# it to the followers (parallel.collectives.HeaderChannel), and each
# follower replays it (ContinuousBatcher._dev_<name>) in the same order
_TP_OPS = ("stop", "noop", "step", "prefill", "occupy", "free_row",
           "map_row", "grow", "set_index", "lora", "spec", "draft_prefill")
# an idle tp leader sends a noop this often, so the followers' header
# receive never reaches its group's timeout
_TP_KEEPALIVE_S = 10.0


def build_argparser():
    p = argparse.ArgumentParser(
        prog="tensorflowonspark_tpu_torch.serve",
        description="online :predict / :generate HTTP server over an "
                    "export (PyTorch / CUDA port)")
    p.add_argument("--export_dir", required=True)
    p.add_argument("--model_name", default="default",
                   help="name served under /v1/models/<name>")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8501)
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: cuda; 'cpu' "
                        "must be asked for explicitly)")
    p.add_argument("--engine", choices=["auto", "native", "jax", "builder"],
                   default="auto",
                   help=":predict engine: auto = the port's AOT artifact if "
                        "the export has one (its AOTInductor package), "
                        "else rebuild from the model spec; "
                        "native / jax = the AOTInductor package / "
                        "torch.export program (required); builder = rebuild")
    p.add_argument("--batch_size", type=int, default=64,
                   help=":predict rows per device execution (the builder's "
                        "chunk; an artifact's nearest compiled size), and "
                        "the micro-batcher's row cap")
    p.add_argument("--batch_wait_ms", type=float, default=0.0,
                   help=">0 enables dynamic micro-batching: concurrent "
                        ":predict requests within this window coalesce into "
                        "one device execution (up to --batch_size rows)")
    p.add_argument("--signature_def_key", default=None,
                   help=":predict signature (default serving_default)")
    p.add_argument("--input_mapping", default=None,
                   help='JSON {feature_name: model_input_name} of :predict')
    p.add_argument("--output_mapping", default=None,
                   help='JSON {model_output_name: result_column} of '
                        ':predict')
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
                   default="async",
                   help="decode engine: \"async\" (default) = a device "
                        "thread keeps up to --generate_pipeline_depth "
                        "flushed chunks in flight while a host thread reads "
                        "them back, commits tokens and delivers streams; "
                        "\"serial\" = the one-thread reference loop (the "
                        "same tokens)")
    p.add_argument("--generate_pipeline_depth", type=int, default=2,
                   help="async engine: flushed readback chunks in flight "
                        "between the device and host threads (>= 1)")
    p.add_argument("--generate_timeout_s", type=float, default=None,
                   help="wall-time bound on one :generate request")
    p.add_argument("--generate_kv_page_size", type=int, default=0,
                   help=">0 serves a PAGED kv cache: rows draw pages of "
                        "this many tokens from a shared pool (requires "
                        "--generate_kv_pages); 0 = the dense slot cache")
    p.add_argument("--generate_kv_pages", type=int, default=0,
                   help="pool size (pages) for --generate_kv_page_size")
    p.add_argument("--generate_kv_dtype", choices=["auto", "int8"],
                   default="auto",
                   help="int8 = the kv cache stored as int8 payloads "
                        "with per-(token, head) f32 scales: about half "
                        "the bf16 cache's bytes")
    p.add_argument("--generate_quantize", choices=list(QUANTIZE_MODES),
                   default="none",
                   help="weight-only quantisation of the projections at "
                        "load: int8 (W8A16, per-channel scales) or int4 "
                        "(W4A16, per-128-row group scales), served through "
                        "the fused-dequant matmul kernels")
    p.add_argument("--spec_draft", choices=["model", "ngram", "off"],
                   default=None,
                   help="speculative draft source: 'model' runs the "
                        "--draft_export_dir LM, 'ngram' proposes by "
                        "suffix-matching the row's own context, 'off' "
                        "disables speculation; default: 'model' when "
                        "--draft_export_dir is set, else 'off'")
    p.add_argument("--draft_export_dir", default=None,
                   help="a smaller decoder-LM export proposing the "
                        "speculative draft (greedy outputs identical, "
                        "sampled ones distribution-preserving)")
    p.add_argument("--draft_k", type=int, default=4,
                   help="max draft tokens proposed per verify pass (each "
                        "row's acceptance adapts the round's k between 1 "
                        "and this)")
    p.add_argument("--generate_lora_rank", type=int, default=0,
                   help=">0 enables a multi-adapter LoRA bank: requests "
                        "pick a registered adapter by name "
                        "({\"adapter\": \"x\"}); rows without one run the "
                        "base model exactly")
    p.add_argument("--generate_lora_capacity", type=int, default=8,
                   help="max adapters resident in the bank")
    p.add_argument("--generate_lora", action="append", default=None,
                   metavar="NAME=PATH",
                   help="register adapter NAME from a lora.save_adapters "
                        "file at startup (repeatable)")
    p.add_argument("--generate_host_cache_mb", type=int, default=0,
                   help=">0 puts a host-memory page tier of this many MiB "
                        "behind the paged pool: evicted and retired prefix "
                        "pages demote there and promote back on a later "
                        "prefix hit instead of prefilling (requires "
                        "--generate_kv_page_size)")
    p.add_argument("--generate_long_prompt_threshold", type=int, default=0,
                   help=">0 routes prompts longer than this many tokens "
                        "through the mega-prompt lane: they admit one at a "
                        "time and map kv pages chunk by chunk, evicting "
                        "cold prefix pages when the pool runs dry "
                        "(requires --generate_kv_page_size)")
    p.add_argument("--role", choices=["mixed", "prefill", "decode"],
                   default="mixed",
                   help="disaggregated serving role, advertised in the "
                        "metadata: \"prefill\" replicas hand each session to "
                        "a decode replica once its first tokens flush "
                        "(X-Fleet-Migrate-To), \"decode\" replicas receive "
                        "them; advisory, every replica serves every "
                        "endpoint")
    p.add_argument("--advertise_host", default=None,
                   help="host peers dial this replica's kv page server on "
                        "(default: --host; set when binding 0.0.0.0)")
    p.add_argument("--generate_priority_weight", type=int, default=4,
                   help="weighted-fair admission: up to N interactive "
                        "admissions per batch-class admission while both "
                        "classes wait (and N normal admissions per "
                        "mega-prompt admission)")
    p.add_argument("--generate_preempt_ms", type=float, default=0.0,
                   help=">0 enables the preemption controller: when the "
                        "oldest waiting interactive admission has queued "
                        "longer than this, the batch session with the most "
                        "work left is PARKED (its snapshot held host-side, "
                        "its pages freed) and resumed with the same tokens "
                        "when interactive pressure drops")
    p.add_argument("--generate_park_capacity", type=int, default=8,
                   help="the park pool's bound: at capacity further "
                        "preemptions are skipped (park_spills)")
    p.add_argument("--generate_trace_ring", type=int, default=4096,
                   help="span ring capacity of request tracing; old spans "
                        "fall off the back, recording never blocks serving")
    p.add_argument("--generate_trace_decode_sample", type=int, default=16,
                   help="a decode span every Nth committed host tick of a "
                        "traced row (0 disables decode spans)")
    p.add_argument("--fleet", default=None, metavar="HOST:PORT",
                   help="register this replica with a fleet gateway's "
                        "registry (python -m tensorflowonspark_tpu_torch."
                        "fleet) over the reservation protocol, and "
                        "heartbeat until shutdown")
    p.add_argument("--fleet_heartbeat_s", type=float, default=2.0,
                   help="replica->gateway heartbeat interval (keep well "
                        "under the gateway's --heartbeat_timeout_s)")
    p.add_argument("--verbose", action="store_true")
    # the JAX server's read-path switches: parsed so that its command
    # lines reach the error that says why the port refuses them
    for flag, choices, _ in _READ_PATH_FLAGS:
        p.add_argument("--" + flag, choices=choices, default=None)
    return p


# the JAX server's switches to its plain XLA read paths: (flag, its
# choices, the value the port refuses); each defaults to None, "not
# asked for", and "kernel" is what the port runs
_READ_PATH_FLAGS = (("generate_paged_attn", ("kernel", "einsum"), "einsum"),
                    ("generate_paged_prefill", ("kernel", "blend"), "blend"))
_NO_SWITCH = ("the port's paged kernel wrappers take no switch: a CUDA tensor "
              "always runs the hand-written kernel (no plain read path to "
              "choose)")


def _is_int(x):
    """A real int: JSON true/false arrive as bools, which are ints."""
    return isinstance(x, int) and not isinstance(x, bool)


def _bucket_len(n, cap):
    """Padded length of a prefill chunk of `n` tokens: the next power of
    two (floor 8), capped at the configured chunk size."""
    return min(max(8, 1 << (n - 1).bit_length()), cap)


def _pow2_width(n):
    """Padded row count of a batched prefill dispatch (and the step of a
    page table's growth): the next power of 2."""
    return 1 << (n - 1).bit_length()


def max_table_pages(max_seq_len, kv_page_size):
    """The page-table width CAP of one row: enough entries to map a full
    max_seq_len sequence."""
    return max_seq_len // kv_page_size


# Initial per-row page-table width (entries): rows start this narrow and
# grow geometrically (decode.grow_page_table) only when an admission
# needs more, as in the JAX package.
_INIT_TABLE_PAGES = 8


class KVOverflowError(RuntimeError):
    """The kv pool could not yield the pages a mega-prompt needs even
    with nothing else running: the request cannot fit this replica.  A
    typed 503 over HTTP (retryable elsewhere), not a 400: the request is
    well-formed."""


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
    """One in-flight generation: tokens stream into ``.tokens`` as they
    decode (one list per host tick, then the None sentinel);
    ``.result()`` blocks for the full sequence."""

    def __init__(self, prompt=()):
        self.prompt = list(prompt)
        self.tokens = queue_mod.Queue()
        self.cancelled = threading.Event()
        self._done = threading.Event()
        # first outcome wins: the host thread finishes handles while
        # stop() or the death drain may fail them
        self._outcome_lock = threading.Lock()
        self._seq = None
        self._err = None
        self._on_done = None    # run once at the outcome (adapter refs)
        # kv migration: the engine sets migrate_requested; the host thread
        # makes the freeze cut at its next commit for this row, leaves the
        # snapshot in `frozen` and sets freeze_done.  The row then emits
        # nothing until complete or rollback decides which replica owns
        # the continuation.
        self.migrate_requested = threading.Event()
        self.freeze_done = threading.Event()
        self.frozen = None

    def cancel(self):
        """Stop decoding for this request: the batcher retires its slot
        at the next readback."""
        self.cancelled.set()

    def _finish(self, seq):
        self._settle(seq, None)

    def _fail(self, err):
        self._settle(None, err)

    def _settle(self, seq, err):
        with self._outcome_lock:
            if self._done.is_set():
                return
            self._seq, self._err = seq, err
            on_done, self._on_done = self._on_done, None
            self._done.set()
            self.tokens.put(None)
        if on_done is not None:
            on_done()

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError("generation did not complete in time")
        if self._err is not None:
            raise self._err
        return self._seq


class _HostBuffers:
    """Host buffers of flushed readback chunks: a ``[read_chunk,
    n_slots, width]`` token plane (width 1, or ``draft_k`` when rounds
    speculate), a ``[read_chunk, n_slots]`` count plane (tokens a row
    delivers per entry) and done plane, pinned on the card so that the
    copy runs without blocking.  A buffer goes back to the free list
    only after its chunk was processed, so no copy lands in a buffer the
    host still reads."""

    def __init__(self, read_chunk, n_slots, device, width=1):
        self._shape = (read_chunk, n_slots)
        self._width = width
        self._pin = device.type == "cuda"
        self._free = queue_mod.SimpleQueue()

    def take(self):
        try:
            return self._free.get_nowait()
        except queue_mod.Empty:
            return (torch.empty(self._shape + (self._width,),
                                dtype=torch.int64, pin_memory=self._pin),
                    torch.empty(self._shape, dtype=torch.int64,
                                pin_memory=self._pin),
                    torch.empty(self._shape, dtype=torch.bool,
                                pin_memory=self._pin))

    def give(self, bufs):
        self._free.put(bufs)


class ContinuousBatcher:
    """The serving decode engine: slot-based continuous batching over a
    dense (``kv_page_size 0``) or a paged slot cache (models.decode).
    New requests prefill into a free slot in chunks, batched across up
    to ``prefill_rows`` admissions per dispatch and interleaved with
    decode steps; finished slots retire at readback boundaries.

    Engines, as in the JAX package.  ``"async"`` (the default) splits
    the loop: a device thread (admission, prefill, decode dispatch; owns
    every device buffer) flushes readback chunks into a bounded queue
    (``pipeline_depth``), and a host thread drains them (commits tokens,
    delivers stream batches, retires rows through the device thread).
    ``"serial"`` is the one-thread reference: it processes the PREVIOUS
    chunk while the current one computes.  Both read back without
    blocking: a chunk's tokens and done plane are copied into pinned
    host buffers, and the host waits on a CUDA event recorded after the
    copy.  The two engines give the same tokens.

    Paged pool: ``kv_pages + 1`` pages, the last one the garbage SINK
    (free rows keep decoding junk and bucket-pad overshoot lands past a
    row's allocation, so every unallocated table entry names the sink).
    Tables start ``_INIT_TABLE_PAGES`` wide and grow in pow2 steps.
    Full prompt pages are shared through a prefix cache (refcounted;
    cached at refcount 0, evicted LRU under pressure).  Admission takes
    a row's whole need less its shared pages; when the pool is short the
    admission waits at the head of the line.  Prompts longer than
    ``long_prompt_threshold`` take the mega-prompt lane: they admit one
    at a time and map pages chunk by chunk.

    ``kv_dtype="int8"`` stores the cache as int8 payloads with f32
    per-(token, head) scales ("auto" means the model's compute dtype).
    Greedy rows decode exactly the tokens of a solo ``decode.generate``
    (with the same ``kv_dtype``); sampled rows draw the counter-based
    noise of (seed, ordinal), so a seeded request reproduces itself.
    The per-row sampling controls live on the device.

    ``lora_rank > 0``: a bank of ``lora_capacity`` adapters plus the
    null adapter 0 (``register_adapter``); a request names its adapter
    and its row decodes with that adapter's delta.  ``spec_draft``
    ("model" with ``draft_model``, "ngram", "off"; None: "model" when a
    draft is given): speculative rounds (``decode.spec_round``) of up to
    ``draft_k`` proposals; the draft keeps a dense slot cache of its
    own, the n-gram table lives on the device, and each request
    reserves ``draft_k`` positions of verify headroom.  A penalised row
    gates speculation off while it runs, as in the JAX batcher.

    The replica side of the fleet, as in the JAX batcher.  Migration:
    ``freeze_session`` cuts a live row at a committed host tick and
    gathers its kv (pages or its dense window) into fresh tensors
    copied to pinned host memory; ``submit_resume`` admits such a
    snapshot elsewhere without prefill (``submit_replay`` re-prefills a
    token record), ``complete_migration`` / ``rollback_migration``
    settle the source.  ``host_cache_mb``: the host page tier
    (``kvtier``) behind the prefix cache.  Priority classes
    (``PRIORITY_CLASSES``) queue apart and admit weighted-fair
    (``prio_weight``); ``preempt_ms > 0`` starts the preemption
    controller, which parks batch sessions (at most ``park_capacity``)
    while interactive work waits past it.  ``trace``: a span ring
    (``trace.Recorder``) fed at the JAX package's sites.

    On a tp mesh (``parallel.mesh.MeshSpec(tp=n)``; the engine takes the
    mesh from ``use_mesh`` at construction): every rank builds the
    engine inside ``use_mesh(mesh)`` with the same arguments over its
    split of the model (``parallel.sharding.shard_params``), and the
    ranks check that they agree.  The leader (tp index 0) is the whole
    engine; every device write it makes goes through ``_devop``, which
    first sends the operation to the other ranks (one host header over a
    gloo group), so each follower's device thread replays the leader's
    forwards and writes in its order and every rank issues the
    forward's collectives alike.  Each rank's cache holds its kv heads;
    every pick reads the whole vocabulary, so the followers' tokens are
    the leader's without a readback.  A follower takes no requests
    (``submit`` raises); its ``follow()`` (or ``stop()``) returns once
    the leader's ``stop()`` ended the replay.  Quantised weights split
    with their layers (kernels 9 and 10 on each rank's slice); a draft
    model splits over the same mesh, and each rank's draft cache holds
    its kv heads; the n-gram table and the draft's writes replay like
    every other.  Migration, the host tier and parking raise there,
    naming ROADMAP A3c.
    """

    def __init__(self, model, n_slots=8, max_pending=1024, read_chunk=8,
                 prefill_chunk=512, prefill_rows=4, prefill_budget=0,
                 kv_page_size=0, kv_pages=0, kv_dtype=None,
                 engine="async", pipeline_depth=2, long_prompt_threshold=0,
                 draft_model=None, draft_k=4, spec_draft=None, lora_rank=0,
                 lora_capacity=8, host_cache_mb=0, prio_weight=4,
                 preempt_ms=0.0, park_capacity=8,
                 trace_ring=trace.DEFAULT_RING,
                 trace_decode_sample=trace.DEFAULT_DECODE_SAMPLE,
                 trace_recorder=None, device=None):
        self._mesh, self._chan = self._tp_channel(model, dict(
            n_slots=n_slots, max_pending=max_pending, read_chunk=read_chunk,
            prefill_chunk=prefill_chunk, prefill_rows=prefill_rows,
            prefill_budget=prefill_budget, kv_page_size=kv_page_size,
            kv_pages=kv_pages, kv_dtype=kv_dtype, engine=engine,
            pipeline_depth=pipeline_depth,
            long_prompt_threshold=long_prompt_threshold,
            spec_draft=spec_draft, draft=draft_model is not None,
            draft_k=draft_k, lora_rank=lora_rank,
            lora_capacity=lora_capacity, host_cache_mb=host_cache_mb,
            prio_weight=prio_weight, preempt_ms=preempt_ms,
            park_capacity=park_capacity), draft_model)
        self._follower = (self._chan is not None
                          and not self._chan.is_leader)
        if host_cache_mb or preempt_ms:
            self._refuse_tp("kv migration / host tier / parking")
        self._last_send = time.monotonic()
        if engine not in ("async", "serial"):
            raise ValueError(f"engine={engine!r} not in ('async', 'serial')")
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        mode = spec_draft
        if mode is None:
            mode = "model" if draft_model is not None else "off"
        if mode not in ("model", "ngram", "off"):
            raise ValueError(
                f"spec_draft={mode!r} not in ('model', 'ngram', 'off')")
        if mode == "model" and draft_model is None:
            raise ValueError("spec_draft='model' requires a draft model "
                             "(--draft_export_dir)")
        if mode == "ngram" and draft_model is not None:
            raise ValueError("spec_draft='ngram' is model-free — drop the "
                             "draft model (or pick spec_draft='model')")
        if mode != "off" and int(draft_k) < 1:
            raise ValueError(f"draft_k={draft_k} must be >= 1")
        if mode == "off":
            draft_model = None
        self.kv_page_size = int(kv_page_size or 0)
        if self.kv_page_size and int(kv_pages) < 1:
            raise ValueError("kv_page_size > 0 requires kv_pages >= 1")
        self.long_prompt_threshold = int(long_prompt_threshold or 0)
        if self.long_prompt_threshold < 0:
            raise ValueError("long_prompt_threshold must be >= 0")
        if self.long_prompt_threshold and not self.kv_page_size:
            raise ValueError(
                "long_prompt_threshold > 0 requires a paged kv cache "
                "(--generate_kv_page_size): the mega-prompt lane allocates "
                "pages lazily as chunks land")
        if int(host_cache_mb or 0) < 0:
            raise ValueError("host_cache_mb must be >= 0")
        if int(host_cache_mb or 0) and not self.kv_page_size:
            raise ValueError("host_cache_mb > 0 requires a paged kv cache "
                             "(--generate_kv_page_size): the host tier "
                             "holds demoted pool pages")
        if int(prio_weight) < 1:
            raise ValueError("prio_weight must be >= 1")
        self.prio_weight = int(prio_weight)
        self.preempt_ms = float(preempt_ms or 0.0)
        if self.preempt_ms < 0:
            raise ValueError("preempt_ms must be >= 0")
        if self.preempt_ms and mode == "model":
            raise ValueError(
                "preempt_ms > 0 does not compose with draft speculation "
                "(freeze_session cannot cut a row through the draft "
                "cache) — drop --draft_export_dir or --generate_preempt_ms")
        self.park_capacity = int(park_capacity)
        if self.park_capacity < 1:
            raise ValueError("park_capacity must be >= 1")
        # request tracing: a span ring on the host clock (recording never
        # reads a device value); a shared recorder lets in-process tests
        # pair batchers on one ring
        self.trace = trace_recorder or trace.Recorder(
            capacity=trace_ring, decode_sample=trace_decode_sample)
        self.device = device_mod.resolve(device)
        param_dev = next(model.parameters()).device
        if param_dev.type != self.device.type:
            raise ValueError(f"model parameters are on {param_dev}, the "
                             f"batcher runs on {self.device}")
        self.engine = engine
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.model = model
        self.n_slots = n_slots
        self.max_seq = model.cfg.max_seq_len
        self.vocab_size = model.cfg.vocab_size
        self.counters = Counters()
        kv_dtype = None if kv_dtype == "auto" else kv_dtype
        self.spec_mode = mode
        self.draft_model = draft_model
        self.draft_k = int(draft_k)
        if draft_model is not None:
            if draft_model.cfg.vocab_size != self.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_model.cfg.vocab_size} != target "
                    f"vocab {self.vocab_size}")
            # both caches hold the sequence
            self.max_seq = min(self.max_seq, draft_model.cfg.max_seq_len)
            _, self._d_cache = decode_mod.init_slot_cache(
                draft_model, n_slots, kv_dtype=kv_dtype)
        if mode == "ngram":
            # the rows' committed tokens (prompt + delivered output), one
            # spare column for dropped writes: proposals and appends stay
            # on the device
            self._spec_ctx = torch.zeros((n_slots, self.max_seq + 1),
                                         dtype=torch.int64,
                                         device=self.device)
            self._spec_ctx_len = torch.zeros((n_slots,), dtype=torch.int64,
                                             device=self.device)
        # adaptive draft length: the host thread keeps per-row acceptance
        # averages and publishes a round width through _speck_q; the
        # device thread adopts the latest at dispatch
        self._spec_k = self.draft_k       # device-thread-owned
        self._spec_k_sum = 0
        self._spec_rounds = 0
        self._speck_q = queue_mod.Queue(8)
        self._spec_ewma = [1.0] * n_slots     # host-thread-owned
        self._spec_k_pub = self.draft_k       # host-thread-owned
        self.lora_rank = int(lora_rank or 0)
        if self.lora_rank:
            self._init_lora_bank(int(lora_capacity))
        if self.kv_page_size:
            self._sink = int(kv_pages)
            self._total_pages = int(kv_pages)
            self._table_cap = max_table_pages(self.max_seq,
                                              self.kv_page_size)
            self._table_width = min(self._table_cap, _INIT_TABLE_PAGES)
            _, self._cache = decode_mod.init_paged_slot_cache(
                model, n_slots, self.kv_page_size, int(kv_pages) + 1,
                kv_dtype=kv_dtype, table_pages=self._table_width)
            # sized to the current table width; _grow_table rebuilds it
            self._sink_entries = torch.full(
                (self._table_width,), self._sink, dtype=torch.int32,
                device=self.device)
            for row in range(n_slots):   # unoccupied rows start at the sink
                decode_mod.set_row_page_table(self._cache, row,
                                              self._sink_entries)
            # device-thread-owned pool state; stats() only takes len() of
            # momentary snapshots
            # graftcheck: disable-next-line=thread-race
            self._free_pages = list(range(int(kv_pages)))
            self._row_pages = [None] * n_slots
            # prefix cache: cumulative-prefix key -> pool page, its LRU
            # ticks, and the live-row refcount of every managed page
            # graftcheck: disable-next-line=thread-race
            self._prefix = {}
            self._prefix_lru = {}
            self._page_rc = {}
            self._lru_tick = 0
            self._row_shared_n = [0] * n_slots
            self._row_prefix_keys = [None] * n_slots
            self.prefill_tokens_shared = 0
        else:
            _, self._cache = decode_mod.init_slot_cache(model, n_slots,
                                                        kv_dtype=kv_dtype)
        # the host page tier behind the prefix cache (kvtier): the batcher
        # gathers and scatters on the device thread, the tier only holds
        # host copies
        self._host_tier = None
        if int(host_cache_mb or 0):
            from tensorflowonspark_tpu_torch import kvtier

            self._host_tier = kvtier.HostPageTier(int(host_cache_mb) << 20)
        # "auto" (the CLI default) and None leave the model config's
        # choice; stats() reports what the cache holds
        self.kv_dtype = "int8" if self._cache.key_scales else None
        self.kv_pool_bytes = self._cache.pool_bytes()
        # swap-to-None teardown in stop()/_die() runs after the threads
        # are joined or dead
        # graftcheck: disable-next-line=thread-race
        self._parked = None    # admission waiting for pool pages (FIFO)
        self.read_chunk = max(1, read_chunk)
        self.prefill_chunk = _aligned_prefill_chunk(prefill_chunk,
                                                    self.kv_page_size)
        self.prefill_rows = max(1, int(prefill_rows or 1))
        self.prefill_budget = (int(prefill_budget or 0)
                               or self.prefill_rows * self.prefill_chunk)
        self._pending = queue_mod.Queue(max_pending)
        # device-thread-owned admission queues (one per priority class,
        # and the mega-prompt lane); stats() only len()s them
        # graftcheck: disable-next-line=thread-race
        self._classq = {c: collections.deque() for c in PRIORITY_CLASSES}
        self._batch_credit = 0   # interactive picks since the last batch
        # graftcheck: disable-next-line=thread-race
        self._longq = collections.deque()
        self._long_credit = 0    # normal picks since the last long pick
        # the preemption controller's parked sessions: host-side snapshots
        # holding no device state, shared with the teardown sweeps
        self._park_pool = collections.deque()
        self._park_lock = threading.Lock()
        self._park_depth = Gauge()
        # cells are rebound, never resized; the generation counter makes
        # stale readback entries self-invalidating
        # graftcheck: disable-next-line=thread-race
        self._slots = [None] * n_slots
        # graftcheck: disable-next-line=thread-race
        self._gen = [0] * n_slots
        # graftcheck: disable-next-line=thread-race
        self._admissions = []        # in-flight chunked admissions
        self._ttft = LatencyWindow()   # submit -> first token
        # per class: TTFT, and the queue delay (submit -> admission pick)
        # the preemption controller watches
        self._ttft_cls = {c: LatencyWindow() for c in PRIORITY_CLASSES}
        self._qdelay = {c: LatencyWindow() for c in PRIORITY_CLASSES}
        # per-row decode state on the device: the previous pick, the stop
        # registers, the sampling controls (free rows: greedy, no
        # filter) and the penalty's presence table; the host counts the
        # rows that sample, filter and penalise
        def zeros(dtype, fill=0, shape=(n_slots,)):
            return torch.full(shape, fill, dtype=dtype, device=self.device)

        self._toks = zeros(torch.int64)
        self._rems = zeros(torch.int32)
        self._eoss = zeros(torch.int64)
        self._eos_on = zeros(torch.bool)
        self._temps = zeros(torch.float32)
        self._seeds = zeros(torch.int64)
        self._ords = zeros(torch.int64)
        self._topks = zeros(torch.int64)
        self._topps = zeros(torch.float32, 1.0)
        self._minps = zeros(torch.float32)
        self._reps = zeros(torch.float32, 1.0)
        self._seen = zeros(torch.int8, shape=(n_slots, self.vocab_size))
        # a tp follower's rows still decoding and its count of accepted
        # draft tokens (`_dev_spec`: it reads no tokens back)
        self._live = zeros(torch.bool)
        self._spec_accepted = zeros(torch.int64, shape=())
        self._n_sampled = self._n_filtered = self._n_penalized = 0
        self._steps = 0
        self._step_ms = collections.deque(maxlen=1024)   # decode-only chunks
        self._bufs = _HostBuffers(self.read_chunk, n_slots, self.device,
                                  self.draft_k if mode != "off" else 1)
        # device->host handoff: flushed chunks ride here; the bound IS the
        # pipeline depth (backpressure when the host falls behind)
        self._ready = queue_mod.Queue(self.pipeline_depth)
        # host->device retirement requests (row, gen, ack): _free_row
        # writes a page table on the card, so only the device thread
        # applies it; the host blocks on the ack, so a finished handle
        # always sees consistent pool accounting
        self._retire_q = queue_mod.Queue()
        # other device-thread operations posted from any thread, acked
        # the same way (drop_prefix_cache, the migration freeze and its
        # rollback)
        self._ops_q = queue_mod.Queue()
        self._depth = Gauge()   # steps dispatched but not host-processed
        self._t0 = time.monotonic()   # device_idle_fraction time base
        # the kernels this engine runs: the paged ones for a paged pool,
        # the fused-dequant matmul of each quantisation mode in the
        # model, and the fused LayerNorm of a fused_ln model
        self.kernels = (
            ((ops.SERVING_KERNELS_INT8_KV if self.kv_dtype
              else ops.SERVING_KERNELS) if self.kv_page_size else ())
            + tuple(f"{mode}_matmul"
                    for mode in quantize_mod.quantized_modes(model))
            + (("layernorm",) if model.cfg.fused_ln else ()))
        self._dead = None     # the fatal exception once a thread died
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="slot-batcher", daemon=True)
        self._host_thread = None
        if engine == "async" and not self._follower:
            self._host_thread = threading.Thread(
                target=self._host_loop, name="slot-host", daemon=True)
            self._host_thread.start()
        # the preemption controller has a thread of its own: freezing and
        # resuming block on device-thread acks, which an engine loop
        # cannot wait for
        self._preempt_thread = None
        if self.preempt_ms > 0 and self._chan is None:
            self._preempt_thread = threading.Thread(
                target=self._preempt_loop, name="preempt-controller",
                daemon=True)
            self._preempt_thread.start()
        self._thread.start()

    @staticmethod
    def _tp_channel(model, args, draft=None):
        """``(mesh, channel)`` of an engine built inside ``use_mesh``: the
        serving mesh (``check_serving_mesh``) and, on a tp mesh, the
        header channel, once every rank agreed on ``args``, the model's
        (and the draft's) config, split and quantisation (a mismatch
        raises on every rank).  ``(None or the mesh, None)`` off a tp
        mesh."""
        mesh = mesh_mod.active_mesh()
        tp = mesh_mod.check_serving_mesh(mesh)
        models = {"model": model, "draft": draft}
        for label, m in models.items():
            if m is None:
                continue
            if tp == 1 and m.split():
                raise ValueError(f"a tp-split {label} serves inside "
                                 "parallel.mesh.use_mesh(mesh), on the tp "
                                 "mesh it was split over")
            if tp > 1 and not m.split():
                raise ValueError(f"a tp mesh serves a {label} split over it "
                                 "(parallel.sharding.shard_params)")
        if tp == 1:
            return mesh, None
        chan = coll.HeaderChannel(mesh)
        mine = {k: repr(v) for k, v in args.items()}
        for label, m in models.items():
            if m is None:
                continue
            mine.update({
                f"{label}_config": repr(dataclasses.asdict(m.cfg)),
                f"{label}_split": repr([(n, tuple(p.shape), str(p.dtype))
                                        for n, p in m.named_parameters()]),
                f"{label}_quant": repr(
                    [(n, d.quant, d.group_size)
                     for n, d in quantize_mod.quantized_denses(m)])})
        ranks = chan.gather(mine)
        differ = sorted({k for r in ranks for k in mine if r[k] != mine[k]})
        if differ:
            raise ValueError(
                "the tp ranks built their engines differently: "
                + "; ".join(f"{k}: {[r[k] for r in ranks]}" for k in differ))
        return mesh, chan

    def _on_mesh(self):
        """The engine's mesh around a forward (tp only)."""
        return (mesh_mod.use_mesh(self._mesh) if self._chan is not None
                else contextlib.nullcontext())

    def _refuse_follower(self, what):
        if self._follower:
            raise RuntimeError(f"a tp follower rank takes no {what}: the "
                               "leader (tp index 0) schedules the engine")

    def _refuse_tp(self, what):
        if self._chan is not None:
            raise NotImplementedError(f"{what} on a tp mesh is not ported "
                                      f"yet ({mesh_mod.A3C})")

    # ---- public surface -------------------------------------------------

    def stats(self):
        """Operational snapshot: occupancy, queue depth, dispatch counts,
        the pipeline, pool and prefix-cache state, TTFT and the kernels'
        launch counts (monitoring reads; momentary skew is fine)."""
        step_ms = sorted(self._step_ms)
        elapsed_ms = (time.monotonic() - self._t0) * 1000.0
        wait_ms = self.counters.get("device_wait_ms")
        out = {
            "slots_busy": sum(s is not None for s in self._slots),
            "pending": (self._pending.qsize()
                        + sum(len(q) for q in self._classq.values())
                        + len(self._longq)),
            "admitting": bool(self._admissions),
            "admissions_inflight": len(self._admissions),
            "prefill_rows": self.prefill_rows,
            "prefill_budget": self.prefill_budget,
            "requests_served": self.counters.get("requests_served"),
            "decode_steps": self._steps,
            "spec_rounds": self._spec_rounds,
            "spec_mode": self.spec_mode,
            "engine": self.engine,
            "pipeline_depth": self.pipeline_depth,
            # high-water mark of dispatched-but-unprocessed steps: > 1 is
            # the proof that the pipeline overlapped host work with steps
            "pipeline_depth_peak": self._depth.peak,
            # share of wall time the device thread spent blocked on host
            # work (serial: processing chunks inline; async: waiting for
            # the host to drain a full pipeline)
            "device_idle_fraction": (
                round(min(1.0, wait_ms / elapsed_ms), 4) if elapsed_ms > 0
                else 0.0),
            "device": str(self.device),
            # host-clock ms per decode step between flushes of chunks with
            # no prefill or idle wait in them.  Such a chunk can still
            # wait on earlier work (a prefill's device time, behind a full
            # pipeline), and a short one then skews the mean: the median
            # resists it, the max shows it
            "decode_step_ms_mean": (sum(step_ms) / len(step_ms)
                                    if step_ms else 0.0),
            "decode_step_ms_p50": (step_ms[len(step_ms) // 2]
                                   if step_ms else 0.0),
            "decode_step_ms_max": step_ms[-1] if step_ms else 0.0,
            "kv_pool_bytes": self.kv_pool_bytes,
            "kernel_launches": ops.launch_counts(self.kernels),
            "long_prompt_threshold": self.long_prompt_threshold,
        }
        for key in ("spec_tokens_proposed", "spec_tokens_accepted",
                    "spec_draft_fallbacks"):
            out[key] = self.counters.get(key)
        if self._follower:
            out["spec_tokens_accepted"] = int(self._spec_accepted)
        proposed = out["spec_tokens_proposed"]
        out["spec_accept_rate"] = (
            round(out["spec_tokens_accepted"] / proposed, 4) if proposed
            else 0.0)
        out["spec_k_current"] = self._spec_k
        out["spec_k_mean"] = (round(self._spec_k_sum / self._spec_rounds, 4)
                              if self._spec_rounds else 0.0)
        if self.lora_rank:
            out["lora_rank"] = self.lora_rank
            # registration threads resize the registry: read it locked
            with self._lora_lock:
                out["lora_adapters"] = sorted(self._adapters)
                out["lora_capacity_free"] = len(self._free_lora)
        out.update(self._ttft.stats("ttft"))
        if self.kv_page_size:
            free = len(self._free_pages)
            out["kv_pages_free"] = free
            out["kv_pages_total"] = self._total_pages
            out["kv_pages_used"] = self._total_pages - free
            out["kv_page_size"] = self.kv_page_size
            out["admission_waiting_for_pages"] = self._parked is not None
            out["prefix_pages_cached"] = len(self._prefix)
            out["prefill_tokens_shared"] = self.prefill_tokens_shared
            for key in ("prefix_hits", "prefix_misses", "host_hits",
                        "kv_sink_writes"):
                out[key] = self.counters.get(key)
            # the host tier's gauges, present at zero with the tier off
            tier = self._host_tier
            tstats = tier.stats() if tier is not None else {}
            for key in ("host_cache_bytes", "host_pages_cached",
                        "host_demotions", "host_evictions"):
                out[key] = int(tstats.get(key, 0))
            for k, v in tstats.items():
                if k.startswith("host_demote_apply"):
                    out[k] = v
            out["kv_table_width"] = self._table_width
            out["kv_table_cap"] = self._table_cap
        if self.kv_dtype:
            out["kv_dtype"] = self.kv_dtype
        for key in ("kv_table_grows", "kv_pages_demoted_overflow",
                    "long_chunks_dispatched", "device_wait_ms"):
            out[key] = self.counters.get(key)
        out["long_prompts_active"] = (
            len(self._longq)
            + sum(1 for adm in list(self._admissions) if adm["item"]["long"])
            + sum(1 for s in list(self._slots)
                  if s is not None and s["item"]["long"]))
        # migration, scheduling and preemption, present at zero
        for key in ("migrations_started", "migrations_completed",
                    "migrations_failed", "kv_pages_exported"):
            out[key] = self.counters.get(key)
        out["priority_weight"] = self.prio_weight
        out["preempt_ms"] = self.preempt_ms
        out["park_capacity"] = self.park_capacity
        with self._park_lock:
            out["parked_sessions"] = len(self._park_pool)
        out["parked_sessions_peak"] = self._park_depth.peak
        for key in ("sessions_parked", "sessions_unparked", "park_spills",
                    "park_restore_failures"):
            out[key] = self.counters.get(key)
        for cls in PRIORITY_CLASSES:
            out.update(self._ttft_cls[cls].stats(f"ttft_{cls}"))
            out.update(self._qdelay[cls].stats(f"qdelay_{cls}"))
        if self._chan is not None:
            # headers sent (the leader) or received (a follower), and the
            # host time a header took, the wait for the other side in it
            out["tp_size"] = self._chan.size
            out["tp_headers"] = self._chan.count
            out["tp_header_us_mean"] = (
                self._chan.seconds * 1e6 / self._chan.count
                if self._chan.count else 0.0)
        out.update(self.trace.stats())
        out.update(self.counters.snapshot())
        return out

    def submit(self, prompt, max_new, temperature=0.0, eos_id=None, seed=0,
               top_k=0, top_p=1.0, min_p=0.0, adapter=None, stop=None,
               repetition_penalty=1.0, priority=None, trace_id=None):
        self._refuse_follower("requests")
        if self._dead is not None:
            raise RuntimeError(f"batcher died: {self._dead}")
        # tracing is best-effort: a malformed id is dropped here rather
        # than refusing a generation that would otherwise succeed
        tid = trace_id if trace.valid_id(trace_id) else None
        cls = priority or "interactive"
        if cls not in PRIORITY_CLASSES:
            raise ValueError(f"priority={priority!r} not in "
                             f"{PRIORITY_CLASSES}")
        if adapter is not None and not self.lora_rank:
            raise ValueError("this server has no LoRA bank (start it with "
                             "--generate_lora_rank and --generate_lora)")
        decode_mod.check_pick_args(temperature, top_k, top_p, min_p)
        if not prompt or max_new < 1:
            raise ValueError("need a non-empty prompt and max_new >= 1")
        # an id past the embedding table would raise in the engine thread
        # (a device-side assert on the card) and kill every later request
        if not all(0 <= t < self.vocab_size for t in prompt):
            raise ValueError(f"prompt token ids must lie in [0, "
                             f"{self.vocab_size})")
        stops = []
        for st in (stop or []):
            if (not isinstance(st, (list, tuple)) or not st
                    or not all(_is_int(t) for t in st)):
                raise ValueError('"stop" must be a list of non-empty '
                                 "token-id lists")
            stops.append(list(st))
        if len(stops) > 16 or any(len(st) > 32 for st in stops):
            raise ValueError("at most 16 stop sequences of at most 32 "
                             "tokens each")
        decode_mod.check_penalty(repetition_penalty)
        # speculating requests reserve draft_k positions for the verify
        # block's overshoot; penalised ones never speculate
        headroom = self._headroom(repetition_penalty)
        if len(prompt) + max_new + headroom > self.max_seq:
            raise ValueError(
                f"prompt {len(prompt)} + max_new_tokens {max_new}"
                + (f" + speculation headroom {headroom}" if headroom else "")
                + f" exceeds max_seq_len {self.max_seq}")
        if self.kv_page_size:
            need = self._pages_needed(len(prompt), max_new,
                                      repetition_penalty)
            if need > self._total_pages:
                # a request the whole pool cannot hold would wait forever
                # at the head of the line, wedging every later admission
                raise ValueError(
                    f"request needs {need} kv pages but the pool only has "
                    f"{self._total_pages}; raise --generate_kv_pages or "
                    "shorten the request")
        # the adapter last: its in-flight reference is taken only once
        # every check passed (a refused request must not leak one)
        aidx = 0
        if adapter is not None:
            with self._lora_lock:
                if adapter not in self._adapters:
                    raise ValueError(f"unknown adapter {adapter!r}; "
                                     f"registered: {sorted(self._adapters)}")
                aidx = self._adapters[adapter]
                self._adapter_refs[aidx] = self._adapter_refs.get(aidx, 0) + 1
        h = SlotHandle(prompt)
        if aidx:
            h._on_done = lambda idx=aidx: self._release_adapter(idx)
        # the lane flag is decided once, here: every later hop keys off it
        is_long = bool(self.long_prompt_threshold
                       and len(prompt) > self.long_prompt_threshold)
        self._pending.put({
            "h": h, "prompt": list(prompt), "max_new": int(max_new),
            "temp": float(temperature), "eos": eos_id, "seed": int(seed),
            "topk": int(top_k), "topp": float(top_p), "minp": float(min_p),
            "aidx": aidx, "adapter": adapter, "stops": stops,
            "rep": float(repetition_penalty), "cls": cls, "long": is_long,
            "trace": tid, "t_submit": time.monotonic()})
        self.trace.event(tid, "submit", cls=cls, prompt_len=len(prompt),
                         max_new=max_new)
        if self._dead is not None:
            # the loop may have died between the check and the put
            self._drain_pending(RuntimeError(f"batcher died: {self._dead}"))
        return h

    def stop(self, timeout=30):
        """Shut the engine threads (and the preemption controller) down;
        queued, in-flight, mid-admission and parked requests fail with
        RuntimeError; the host tier closes.  On a tp leader the device
        thread's end also ends the followers' replay; on a follower this
        is :meth:`follow`."""
        if self._follower:
            return self.follow(timeout)
        self._stop.set()
        self._thread.join(timeout)
        if self._host_thread is not None:
            self._host_thread.join(timeout)
        if self._preempt_thread is not None:
            self._preempt_thread.join(timeout)
        err = RuntimeError("batcher stopped")
        self._dead = self._dead or err
        self._fail_all(err)
        if self._host_tier is not None:
            self._host_tier.close()

    def follow(self, timeout=None):
        """A tp follower: wait until the leader's ``stop()`` ends the
        replay of its device operations (TimeoutError after ``timeout``
        seconds, the replay going on; RuntimeError when the replay died);
        then the engine is stopped."""
        if not self._follower:
            raise RuntimeError("follow() is a tp follower's: this rank "
                               "leads the engine")
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"the tp leader did not stop in {timeout}s")
        if self._dead is not None:
            raise RuntimeError(f"tp follower died: {self._dead}")
        self._dead = RuntimeError("batcher stopped")

    def drop_prefix_cache(self, timeout_s=30.0):
        """Evict every refcount-0 page of the prefix cache (each demotes
        to the host tier first when it is armed; pages still shared with
        live rows stay).  From any thread: posts a device thread
        operation and waits for its ack.  Returns the number of pages
        evicted (0 for the dense cache)."""
        self._refuse_follower("prefix-cache operations")
        if not self.kv_page_size:
            return 0
        if self._dead is not None:
            raise RuntimeError(f"batcher died: {self._dead}")
        if threading.current_thread() is self._thread:
            return self._evict_cached_pages(self._total_pages)
        box = {}
        if not self._device_op(("drop_prefix", box), timeout_s):
            return 0    # device thread gone: stop()/_die drain acks
        return box.get("n", 0)

    def _device_op(self, op, timeout_s=None):
        """Post ``op`` (a tuple the device thread applies in
        `_apply_ops`) and wait for its ack.  False when the device
        thread is gone first; TimeoutError past ``timeout_s``."""
        ev = threading.Event()
        self._ops_q.put(op + (ev,))
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while not ev.wait(0.05):
            if self._stop.is_set() or self._dead is not None:
                return False
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"device-thread {op[0]} did not land in "
                                   f"{timeout_s:.1f}s")
        return True

    # ---- the LoRA adapter bank ---------------------------------------------

    def _init_lora_bank(self, capacity):
        """Per-layer banks ``{proj}_a [L, d_in, r]`` / ``{proj}_b [L, r,
        d_out]`` (f32, L = capacity + 1; index 0 the all-zero null
        adapter) for the attention projections, and each row's bank
        index.  Registration writes an index no live row uses."""
        cfg = self.model.cfg
        head_dim = cfg.d_model // cfg.n_heads
        n_kv = cfg.n_heads if cfg.n_kv_heads is None else cfg.n_kv_heads
        self._lora_dims = {
            "query": (cfg.d_model, cfg.d_model),
            "key": (cfg.d_model, n_kv * head_dim),
            "value": (cfg.d_model, n_kv * head_dim),
            "out": (cfg.d_model, cfg.d_model)}
        # on a tp mesh each rank's banks hold its part of every adapter:
        # the part its split layers read (lora.bank_slices)
        self._lora_slices = lora_mod.bank_slices(
            getattr(self.model, self.model.layer_names[0]).attn,
            self._mesh.coords[mesh_mod.AXIS_TP] if self._chan else 0)
        local = {p: (len(range(di)[self._lora_slices[p][0]]),
                     len(range(do)[self._lora_slices[p][1]]))
                 for p, (di, do) in self._lora_dims.items()}
        L, r = capacity + 1, self.lora_rank
        self._lora_banks = {
            f"layer_{i}": {
                **{f"{p}_a": torch.zeros((L, di, r), device=self.device)
                   for p, (di, _) in local.items()},
                **{f"{p}_b": torch.zeros((L, r, do), device=self.device)
                   for p, (_, do) in local.items()}}
            for i in range(cfg.n_layers)}
        self._lora_ids = torch.zeros((self.n_slots,), dtype=torch.int64,
                                     device=self.device)
        self._adapters = {}            # name -> bank index
        self._adapters_pending = set()  # names whose banks are being written
        self._free_lora = list(range(1, L))
        self._adapter_refs = {}        # index -> requests in flight
        # prefix-cache identity of each index: a never-reused token per
        # registration, so pages cached under an earlier tenant of the
        # index never serve a later one
        self._adapter_token = {0: 0}
        self._token_counter = itertools.count(1)
        self._lora_lock = threading.Lock()

    def register_adapter(self, name, adapters, scale=1.0):
        """Install a LoRA adapter under `name` (requests select it with
        ``submit(..., adapter=name)``).  `adapters` is the `lora.init`
        tree ``{"layer_<i>/attn/<proj>/kernel": {"a", "b"}}`` (attention
        projections only); `scale` folds into the stored b.  Paths the
        adapter does not cover stay zero.  Thread-safe; visible from the
        engine's next dispatch.  Returns the bank index.  On a tp mesh
        (the leader's call) the device thread sends the host arrays to
        every rank, and each writes its part of them into its banks."""
        self._refuse_follower("adapter registrations")
        if not self.lora_rank:
            raise ValueError("no LoRA bank configured (lora_rank=0; pass "
                             "lora_rank / --generate_lora_rank)")
        by_slot = {}
        for path, ab in adapters.items():
            parts = path.split("/")
            if (len(parts) != 4 or parts[1] != "attn"
                    or parts[0] not in self._lora_banks
                    or parts[2] not in self._lora_dims
                    or parts[3] != "kernel"):
                raise ValueError(
                    f"adapter path {path!r} is not an attention projection "
                    "of this model (expected layer_<i>/attn/"
                    "<query|key|value|out>/kernel)")
            a, b = (x if isinstance(x, torch.Tensor) else
                    torch.from_numpy(np.array(x, np.float32))
                    for x in (ab["a"], ab["b"]))
            di, do = self._lora_dims[parts[2]]
            if (tuple(a.shape) != (di, self.lora_rank)
                    or tuple(b.shape) != (self.lora_rank, do)):
                raise ValueError(
                    f"adapter {path!r} shapes a{tuple(a.shape)} "
                    f"b{tuple(b.shape)} do not match bank "
                    f"([{di}, {self.lora_rank}], [{self.lora_rank}, {do}])")
            by_slot[(parts[0], parts[2])] = (a, b)
        with self._lora_lock:
            if name in self._adapters or name in self._adapters_pending:
                raise ValueError(f"adapter {name!r} already registered")
            if not self._free_lora:
                raise ValueError(
                    f"adapter bank full ({len(self._adapters)} registered; "
                    "raise lora_capacity / --generate_lora_capacity)")
            idx = self._free_lora.pop()
            self._adapters_pending.add(name)
        try:
            if self._chan is None:
                self._dev_lora(idx, by_slot, scale)
            else:
                # the device thread writes every rank's banks (the lock
                # stays free: that thread takes it at admission)
                host = {k: (a.detach().cpu(), b.detach().cpu())
                        for k, (a, b) in by_slot.items()}
                if not self._device_op(("lora", idx, host, float(scale))):
                    raise RuntimeError(f"batcher stopped: {self._dead}")
        except BaseException:
            with self._lora_lock:
                self._adapters_pending.discard(name)
                self._free_lora.append(idx)   # the index stays in the pool
            raise
        with self._lora_lock:
            self._adapters_pending.discard(name)
            self._adapters[name] = idx
            self._adapter_refs.setdefault(idx, 0)
            self._adapter_token[idx] = next(self._token_counter)
        logger.info("registered LoRA adapter %r at bank index %d (%d paths, "
                    "scale %.3g)", name, idx, len(adapters), scale)
        return idx

    def _dev_lora(self, idx, by_slot, scale):
        """Write adapter ``by_slot`` (``{(layer, projection): (a, b)}``,
        host or device tensors at the whole layer's shapes; missing
        paths zero) into bank index ``idx``: this rank's part of each
        (``lora.bank_slices``), ``scale`` folded into b."""
        with torch.no_grad():
            for layer, bank in self._lora_banks.items():
                for proj, (rows, cols) in self._lora_slices.items():
                    a, b = by_slot.get((layer, proj), (None, None))
                    if a is None:
                        bank[f"{proj}_a"][idx].zero_()
                        bank[f"{proj}_b"][idx].zero_()
                    else:
                        bank[f"{proj}_a"][idx].copy_(a[rows].float())
                        bank[f"{proj}_b"][idx].copy_(
                            b[:, cols].float() * float(scale))

    def unregister_adapter(self, name):
        """Remove `name`; refuses while requests using it are in flight."""
        with self._lora_lock:
            idx = self._adapters.get(name)
            if idx is None:
                raise ValueError(f"adapter {name!r} is not registered")
            if self._adapter_refs.get(idx, 0) > 0:
                raise ValueError(f"adapter {name!r} has "
                                 f"{self._adapter_refs[idx]} requests in "
                                 "flight")
            del self._adapters[name]
            self._free_lora.append(idx)

    def _release_adapter(self, idx):
        with self._lora_lock:
            self._adapter_refs[idx] = max(0,
                                          self._adapter_refs.get(idx, 0) - 1)

    def _lora_prefix_root(self, aidx):
        """Prefix-key root of bank index `aidx`: () for the base model,
        the registration's token otherwise."""
        if not self.lora_rank or not aidx:
            return ()
        with self._lora_lock:
            return ("lora", self._adapter_token.get(aidx, -1))

    # ---- pool, page tables and the prefix cache ----------------------------

    def _headroom(self, rep):
        """Verify-overshoot positions a request reserves: ``draft_k``
        when rounds speculate and it is not penalised."""
        return self.draft_k if (self.spec_mode != "off"
                                and rep == 1.0) else 0

    def _pages_needed(self, prompt_len, max_new, rep=1.0):
        return -(-(prompt_len + max_new + self._headroom(rep))
                 // self.kv_page_size)

    def _prefix_keys(self, prompt, upto_tokens, root=()):
        """Cumulative-prefix keys of each FULL page within `upto_tokens`:
        nested tuples ``(prev_key, page_tokens)``, so a lookup is exact
        (two prefixes never serve each other's kv) and each key shares
        its predecessor's structure.  ``root`` is the request's adapter
        identity (``_lora_prefix_root``): () for the base model."""
        P = self.kv_page_size
        keys, k = [], root
        for i in range(upto_tokens // P):
            k = (k, tuple(prompt[i * P:(i + 1) * P]))
            keys.append(k)
        return keys

    def _prefix_lookup(self, prompt, root=()):
        """(shared pages, keys of every full page): the longest cached
        run of full prompt pages, within len(prompt) - 1 tokens (the last
        prompt token must run through prefill for the first logits)."""
        keys = self._prefix_keys(prompt, len(prompt) - 1, root)
        shared = []
        for key in keys:
            page = self._prefix.get(key)
            if page is None:
                break
            shared.append(page)
            self._lru_tick += 1
            self._prefix_lru[key] = self._lru_tick
        return shared, keys

    def _evict_cached_pages(self, want):
        """Free up to `want` pages by evicting refcount-0 cached prefix
        pages, least recently used first.  Returns the number freed.
        With the host tier armed the victims DEMOTE first: the gather
        copies their bytes out before the pool pages are reused."""
        evictable = sorted(
            (k for k, p in self._prefix.items()
             if self._page_rc.get(p, 0) == 0),
            key=lambda k: self._prefix_lru.get(k, 0))
        victims = [(k, self._prefix[k]) for k in evictable[:max(0, want)]]
        if not victims:
            return 0
        self._demote_pages([k for k, _ in victims], [p for _, p in victims])
        for key, page in victims:
            self._prefix.pop(key)
            self._prefix_lru.pop(key, None)
            self._page_rc.pop(page, None)
            self._free_pages.append(page)
        return len(victims)

    # ---- the host page tier ---------------------------------------------------

    def _copy_to_host(self, kv):
        """Start the copy of device tensors ``kv`` ({name: tensor}) into
        host memory: pinned buffers filled without blocking, a CUDA event
        recorded after.  Returns ``(host dict, event)``; on the CPU the
        tensors are host memory already (event None)."""
        if self.device.type != "cuda":
            return kv, None
        host = {}
        for name, t in kv.items():
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            host[name] = buf
        event = torch.cuda.Event(blocking=True)
        event.record()
        return host, event

    def _demote_pages(self, keys, pages):
        """Device thread: snapshot `pages` (still valid: the caller frees
        them only after this returns) into the host tier.  One gather
        into fresh tensors covers every victim, its copy to pinned host
        memory runs under the continuing decode steps, and the tier's
        worker waits on its event.  Best-effort by design: a denied or
        failed demotion (counted as ``host_demotions_dropped``) means
        those prefixes run cold later."""
        tier = self._host_tier
        if tier is None or not keys:
            return
        todo = [(k, p) for k, p in zip(keys, pages) if not tier.contains(k)]
        if not todo:
            return
        if faults.deny("serve.host_demote"):
            self.counters.inc("host_demotions_dropped", len(todo))
            return
        try:
            kv = decode_mod.gather_pages(self._cache, [p for _, p in todo])
            host, event = self._copy_to_host(kv)
        except Exception:
            logger.warning("host-tier demote gather failed", exc_info=True)
            self.counters.inc("host_demotions_dropped", len(todo))
            return
        tier.demote([k for k, _ in todo], host, len(todo), event=event,
                    keep=kv)

    def _host_tier_lookup(self, keys, start):
        """The contiguous run of host-tier pages extending a device
        prefix-cache run of `start` pages: ``[(key, blocks), ...]``.  The
        entries stay cached until the promote COMMITS (peek, not pop):
        an admission that waits for pages must not strand them outside
        both tiers."""
        tier = self._host_tier
        if tier is None or start >= len(keys):
            return []
        run = []
        for key in keys[start:]:
            blocks = tier.peek(key)
            if blocks is None:
                break
            run.append((key, blocks))
        if run and faults.deny("serve.host_promote"):
            return []        # the tier reads as cold; prefill runs normally
        return run

    def host_prefix_provider(self, tokens, page_size):
        """``kv:prefix`` pull path (the PageServer's callback): the
        longest host-tier run of full-page prefixes of `tokens` as wire
        blocks.  Base-model keys only: LoRA roots are replica-local
        registration tokens, so adapter pages never match across
        replicas."""
        from tensorflowonspark_tpu_torch import kvtier

        meta = {"kind": "prefix", "page_size": int(self.kv_page_size),
                "n_pages": 0}
        tier = self._host_tier
        if (tier is None or not self.kv_page_size
                or int(page_size) != self.kv_page_size):
            return meta, {}
        keys = self._prefix_keys(list(tokens), len(tokens))
        blocks, n = {}, 0
        for i, key in enumerate(keys):
            page = tier.peek(key)
            if page is None:
                break
            for path, arr in page.items():
                blocks[kvtier.block_name(i, path)] = arr
            n += 1
        meta["n_pages"] = n
        return meta, blocks

    def prefetch_prefix(self, peer, prompt, trace_id=None):
        """HTTP-thread warm-up for a kv peer (``X-Fleet-KV-Peer``): pull
        the prefix pages the local host tier lacks from the peer's page
        server and insert them, so this request's admission promotes
        them instead of prefilling.  Any failure (or a cold peer) inserts
        nothing and admission prefills.  Returns the pages inserted."""
        tier = self._host_tier
        if tier is None or not self.kv_page_size or not peer:
            return 0
        host, _, port = str(peer).rpartition(":")
        if not host or not port.isdigit():
            logger.warning("ignoring malformed X-Fleet-KV-Peer %r", peer)
            return 0
        keys = self._prefix_keys(prompt, len(prompt) - 1)
        start = 0
        for key in keys:       # skip the locally warm head of the run
            if not tier.contains(key):
                break
            start += 1
        if start >= len(keys):
            return 0
        from tensorflowonspark_tpu_torch import kvtransfer

        t0 = time.monotonic()
        try:
            _, pages = kvtransfer.pull_prefix(
                (host, int(port)), prompt[:len(keys) * self.kv_page_size],
                self.kv_page_size)
        except (OSError, ValueError) as e:
            self.counters.inc("prefix_pull_failures")
            self.trace.span_at(trace_id, "prefix_pull", t0, time.monotonic(),
                               peer=str(peer), failed=True)
            logger.debug("kv peer prefix pull failed: %s", e)
            return 0
        n = 0
        for i, page in enumerate(pages[:len(keys)]):
            if tier.put(keys[i], page):
                n += 1
        if n:
            self.counters.inc("prefix_pull_pages", n)
        self.trace.span_at(trace_id, "prefix_pull", t0, time.monotonic(),
                           peer=str(peer), pages=n)
        return n

    def _promote_scatter(self, promo, host_run):
        """Device thread: upload `host_run`'s tier blocks into the freshly
        allocated pool pages `promo`, bit for bit (the blocks are gather
        copies at the pool's dtype)."""
        blocks = {path: torch.stack([blk[path] for _, blk in host_run])
                  for path in host_run[0][1]}
        decode_mod.scatter_pages(self._cache, promo, blocks)

    def _assert_no_sink(self, pages):
        """Every allocation passes here: the sink absorbs garbage writes,
        so a row that owned it would see them in its kv."""
        if self._sink in pages:
            raise RuntimeError(f"page allocator handed out the sink page "
                               f"{self._sink} (allocated {pages}); the free "
                               "list or the prefix cache is corrupted")
        return pages

    def _row_entries(self, pages):
        """One row's table entries at the current width: `pages`, then
        the sink for the unallocated tail."""
        return pages + [self._sink] * (self._table_width - len(pages))

    def _grow_table(self, need):
        """Widen every row's table to cover `need` entries: pow2 steps
        (at least doubling) capped at the full-sequence width.  The new
        tail entries name the sink, so no mapped page changes.  Callers
        keep it inside their allocation rollback."""
        faults.check("serve.table_grow")
        new_w = min(self._table_cap,
                    max(_pow2_width(need), 2 * self._table_width))
        if new_w <= self._table_width:
            return
        self._devop("grow", new_w)
        self.counters.inc("kv_table_grows")

    def _dev_grow(self, new_w):
        decode_mod.grow_page_table(self._cache, new_w, self._sink)
        self._table_width = new_w
        self._sink_entries = torch.full((new_w,), self._sink,
                                        dtype=torch.int32, device=self.device)

    def _map_row(self, row, pages):
        """Point `row`'s table at `pages` (growing the tables first when
        they are too narrow)."""
        if len(pages) > self._table_width:
            self._grow_table(len(pages))
        self._devop("map_row", row, self._row_entries(pages))

    def _dev_map_row(self, row, entries):
        decode_mod.set_row_page_table(self._cache, row, entries)

    def _overflow_reclaim(self, want):
        """The mega-prompt lane's overflow valve: free up to `want` pool
        pages by evicting cold (refcount-0) prefix pages, LRU first; with
        the host tier armed they demote first (`_evict_cached_pages`).
        Returns the number freed (0 under a ``serve.overflow_demote``
        fault: the lane then stalls or fails typed)."""
        if want <= 0 or faults.deny("serve.overflow_demote"):
            return 0
        freed = self._evict_cached_pages(want)
        if freed:
            self.counters.inc("kv_pages_demoted_overflow", freed)
        return freed

    def _ensure_long_pages(self, adm):
        """Lane allocation: map pool pages covering the positions `adm`'s
        NEXT chunk writes (plus the decode tail when that chunk is the
        last).  False when the chunk cannot run this round: a stall
        (rows will retire and free pages), or, when the replica is
        otherwise idle and even the valve cannot cover the need, a
        KVOverflowError for the request (pool conserved)."""
        item, row = adm["item"], adm["row"]
        if adm["di"] < len(adm["d_sizes"]):
            return True      # draft catch-up: the dense draft cache
        upto = adm["offset"] + adm["sizes"][adm["i"]]
        if upto >= len(adm["src"]):
            need = self._pages_needed(len(item["prompt"]), item["max_new"],
                                      item["rep"])
        else:
            need = -(-upto // self.kv_page_size)
        have = len(self._row_pages[row] or [])
        if need <= have:
            return True
        k = need - have
        if len(self._free_pages) < k:
            self._overflow_reclaim(k - len(self._free_pages))
        if len(self._free_pages) < k:
            if (all(s is None for s in self._slots)
                    and len(self._admissions) <= 1
                    and self._parked is None):
                # nothing left to retire or evict: no later round can do
                # better, so fail typed instead of wedging the lane
                self._admissions.remove(adm)
                self._free_row(row)
                item["h"]._fail(KVOverflowError(
                    f"mega-prompt needs {k} more kv pages but only "
                    f"{len(self._free_pages)} are free with the replica "
                    "otherwise idle; raise --generate_kv_pages"))
            return False
        fresh = [self._free_pages.pop() for _ in range(k)]
        try:
            pages = self._assert_no_sink((self._row_pages[row] or []) + fresh)
            self._map_row(row, pages)
        except BaseException:
            self._free_pages.extend(fresh)   # conserve the pool
            raise
        self._row_pages[row] = pages
        return True

    def _try_allocate(self, row, item, lazy=False):
        """Reserve `item`'s page need for `row`, sharing cached prefix
        pages where the prompt matches and promoting the host tier's run
        that extends them, or False when the pool (after LRU eviction of
        refcount-0 cached pages) cannot cover the rest (the caller parks
        the item).  ``lazy`` (the lane) maps only the shared and promoted
        pages now; `_ensure_long_pages` maps the rest chunk by chunk."""
        if faults.deny("serve.alloc"):
            return False
        prompt = item["prompt"]
        need = self._pages_needed(len(prompt), item["max_new"], item["rep"])
        shared, keys = self._prefix_lookup(
            prompt, self._lora_prefix_root(item["aidx"]))
        # hold refs BEFORE any eviction: our own shared pages at rc 0
        # would otherwise be evictable by our eviction pass and end up
        # mapped twice in this row's table
        for page in shared:
            self._page_rc[page] = self._page_rc.get(page, 0) + 1
        # host-tier promotion: demoted pages extending the device run
        # fill fresh pool pages from their host copies instead of
        # prefilling, and re-enter the prefix cache at refcount 1
        host_run = self._host_tier_lookup(keys, len(shared))
        if lazy:
            need = len(shared) + len(host_run)
        fresh_need = need - len(shared)
        if len(self._free_pages) < fresh_need:
            self._evict_cached_pages(fresh_need - len(self._free_pages))
        if len(self._free_pages) < fresh_need:
            for page in shared:                  # roll back before parking
                self._page_rc[page] -= 1
            return False
        fresh = [self._free_pages.pop() for _ in range(fresh_need)]
        promo = fresh[:len(host_run)]
        try:
            pages = self._assert_no_sink(shared + fresh)
            self._map_row(row, pages)
            if host_run:
                self._promote_scatter(promo, host_run)
        except BaseException:
            # conservation: free + owned + cached + sink stays the pool
            self._free_pages.extend(fresh)
            for page in shared:
                self._page_rc[page] -= 1
            raise
        # promoted pages publish into the prefix cache now (rc 1, this
        # row): their kv is resident and key-exact; the host copy retires
        for (key, _), page in zip(host_run, promo):
            self._host_tier.discard(key)
            stale = self._prefix.get(key)
            if stale is not None:
                if self._page_rc.get(stale, 0):
                    continue     # held elsewhere: the promoted page is ours
                # a device copy that outlived an evicted predecessor (the
                # run broke before it): the promoted page replaces it, and
                # it goes back to the pool instead of being stranded (the
                # JAX batcher remaps the key and leaks the page)
                self._page_rc.pop(stale)
                self._free_pages.append(stale)
            self._prefix[key] = page
            self._lru_tick += 1
            self._prefix_lru[key] = self._lru_tick
            self._page_rc[page] = 1
        n_shared = len(shared) + len(host_run)
        self._row_pages[row] = pages
        self._row_shared_n[row] = n_shared
        self._row_prefix_keys[row] = keys    # registered after the prefill
        self.prefill_tokens_shared += n_shared * self.kv_page_size
        if shared:
            self.counters.inc("prefix_hits", len(shared))
        if host_run:
            self.counters.inc("host_hits", len(host_run))
            self.trace.event(item.get("trace"), "promote", row=row,
                             pages=len(host_run))
        if len(keys) > n_shared:
            self.counters.inc("prefix_misses", len(keys) - n_shared)
        return True

    def _register_prefix_pages(self, row):
        """After `row`'s prefill, publish its freshly computed full-prefix
        pages so later prompts can share them.  A page is prefix-managed
        iff it is in ``_page_rc``; the count is its LIVE rows.  A twin
        that lost the registration race keeps its copy to itself."""
        keys = self._row_prefix_keys[row] or []
        pages = self._row_pages[row] or []
        for i, key in enumerate(keys[:len(pages)]):
            if i < self._row_shared_n[row]:
                continue                 # already managed and held by us
            if key not in self._prefix:
                self._prefix[key] = pages[i]
                self._lru_tick += 1
                self._prefix_lru[key] = self._lru_tick
                self._page_rc[pages[i]] = 1   # this row's live reference

    def _free_row(self, row):
        """Retire `row` (device thread only): cached prefix pages drop a
        reference (and stay cached at 0), owned pages go back to the free
        list, and the table points at the sink, so the row's garbage
        decode never writes pages a later owner holds."""
        s = self._slots[row]
        if s is not None:
            self._n_filtered -= s["filtered"]
            self._n_sampled -= s["sampled"]
            self._n_penalized -= s["pen"]
        self._slots[row] = None
        table = False
        if self.kv_page_size and self._row_pages[row] is not None:
            if self._host_tier is not None and s is not None:
                self._demote_retiring(row, s)
            for page in self._row_pages[row]:
                if page in self._page_rc:
                    self._page_rc[page] -= 1
                else:
                    self._free_pages.append(page)
            self._row_pages[row] = None
            self._row_shared_n[row] = 0
            self._row_prefix_keys[row] = None
            table = True
        if s is not None or table:
            self._devop("free_row", row, s is not None, table)

    def _dev_free_row(self, row, controls, table):
        """A retired row's device writes: with ``controls`` it decodes
        greedily, unfiltered, unpenalised, on the base model (no sync);
        with ``table`` its page table names the sink."""
        if controls:
            self._temps[row] = 0.0
            self._topks[row], self._topps[row] = 0, 1.0
            self._minps[row], self._reps[row] = 0.0, 1.0
            if self.lora_rank:
                self._lora_ids[row] = 0
            if self._follower:
                self._live[row] = False
        if table:
            decode_mod.set_row_page_table(self._cache, row,
                                          self._sink_entries)

    def _demote_retiring(self, row, s):
        """Cross-turn demotion: the retiring session's full pages (prompt
        AND generated tokens: kv committed for positions [0, len(seq) -
        1), the freeze's cut) go to the host tier while the table is
        still valid, so the conversation's next turn promotes them.  A
        migrated-in row's kv was computed elsewhere: like the prefix
        cache, the tier publishes only pages this replica computed."""
        try:
            item = s.get("item") or {}
            if "kv" in (item.get("resume") or {}):
                return
            seq = s.get("seq") or []
            rkeys = self._prefix_keys(
                seq, len(seq) - 1, self._lora_prefix_root(item.get("aidx",
                                                                   0)))
            owned = self._row_pages[row]
            n = min(len(rkeys), len(owned))
            self._demote_pages(rkeys[:n], owned[:n])
        except Exception:
            logger.warning("retirement demote failed", exc_info=True)

    # ---- admission and batched prefill ------------------------------------

    def _prefill_chunk_sizes(self, length):
        sizes, rest = [], length
        while rest > self.prefill_chunk:
            sizes.append(self.prefill_chunk)
            rest -= self.prefill_chunk
        sizes.append(rest)
        return sizes

    def _start_admission(self, row, item):
        faults.check("serve.admission")
        h, prompt = item["h"], item["prompt"]
        if h.cancelled.is_set():        # client gone before admission
            h._finish(list(prompt))
            return
        if "kv" in (item.get("resume") or {}):
            # a migrated-in session: no prefill; upload its kv and occupy
            # the row mid-sequence (waits for pages like any admission)
            if not self._install_resume(row, item):
                self._parked = (row, item)
            return
        # a kv-less resume is a REPLAY: the committed sequence minus its
        # last token prefills here, then the row state installs as a
        # migration's would
        src = item["resume"]["seq"][:-1] if "resume" in item else prompt
        if self.kv_page_size and not self._try_allocate(
                row, item, lazy=item["long"]):
            self._parked = (row, item)  # wait for pages (FIFO)
            return
        if item["long"]:
            self.trace.event(item.get("trace"), "long.admit", row=row,
                             prompt_len=len(prompt))
        # shared pages already hold their kv: the prefill starts after
        # them, page-aligned
        shared = (self._row_shared_n[row] * self.kv_page_size
                  if self.kv_page_size else 0)
        if self.kv_page_size:
            # the row steps with the free rows until its first chunk
            # runs (a later round under the budget or a lane stall): its
            # write cursor moves past the shared pages, so that junk
            # lands in its own first fresh page, which the prefill
            # overwrites, or the sink, never in a page other rows read
            self._devop("set_index", row, shared)
        # the draft's dense cache shares nothing: it catches up over the
        # shared positions first, chunk by chunk, in rounds of its own
        self._admissions.append({
            "row": row, "item": item, "offset": shared, "i": 0,
            "src": src, "t_admit": time.monotonic(),
            "sizes": self._prefill_chunk_sizes(len(src) - shared),
            "d_off": 0, "di": 0,
            "d_sizes": (self._prefill_chunk_sizes(shared)
                        if shared and self.draft_model is not None
                        else [])})

    def _admit_one(self, row, item):
        """One admission, the handle tied to its fate: a raise here comes
        after the item left the queues and maybe before it joined
        `_admissions`, where `_die` would not find it."""
        try:
            self._start_admission(row, item)
        except BaseException as e:
            item["h"]._fail(e)
            raise

    def _drain_ingress(self, block=False):
        """Move what waits on the thread-safe ingress queue into the
        class queues (or the lane's).  Runs every `_admit`, even with no
        row free, so the class queues (the preemption controller's
        pressure signal) show what waits.  `block` waits briefly for the
        first item (the idle engine's wake-up) unless one already
        waits."""
        if block and (any(self._classq.values()) or self._longq):
            block = False
        while True:
            try:
                item = self._pending.get(timeout=0.05 if block else 0)
            except queue_mod.Empty:
                return
            block = False
            if item["long"]:
                self._longq.append(item)
            else:
                self._classq[item.get("cls") or "interactive"].append(item)

    def _long_admitting(self):
        return sum(1 for adm in self._admissions if adm["item"]["long"])

    def _next_item(self):
        """Weighted-fair pick across the class queues: while both classes
        wait, up to `prio_weight` interactive admissions run per batch
        admission (batch alone drains freely).  The lane rides the same
        credit one level up: while normal requests wait, up to
        `prio_weight` of them run per mega-prompt, and a waiting
        mega-prompt admits at once when nothing else waits; at most one
        is mid-prefill at a time.  Records the picked item's queue
        delay."""
        inter, batch = self._classq["interactive"], self._classq["batch"]
        if self._longq and not self._long_admitting() and (
                self._long_credit >= self.prio_weight
                or not (inter or batch)):
            self._long_credit = 0
            item = self._longq.popleft()
        elif inter and batch:
            if self._batch_credit >= self.prio_weight:
                self._batch_credit = 0
                item = batch.popleft()
            else:
                self._batch_credit += 1
                item = inter.popleft()
        elif inter:
            item = inter.popleft()
        elif batch:
            self._batch_credit = 0
            item = batch.popleft()
        else:
            return None
        if self._longq and not item["long"]:
            self._long_credit += 1
        self._qdelay[item.get("cls") or "interactive"].record(
            time.monotonic() - item["t_submit"])
        return item

    def _admit(self, block=False):
        """Pull waiting requests into the admission pipeline until it is
        `prefill_rows` wide (or rows / requests run out).  A row is free
        when no slot occupies it and no admission prefills it."""
        self._drain_ingress(block=block)
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
            self._admit_one(row, item)
            if self._parked is not None:
                return      # still starved: nothing else admits (FIFO)
            claimed.add(row)
        while len(self._admissions) < self.prefill_rows:
            row = free_row_index()
            if row is None:
                return
            item = self._next_item()
            if item is None:
                return
            self._admit_one(row, item)
            if self._parked is not None:
                return      # pool starved: later arrivals wait (FIFO)
            claimed.add(row)

    def _select_prefill(self):
        """This round's admissions: the head always (a budget caps
        batching, it never blocks progress), then interactive before
        batch-class admissions (FIFO within a class) while the summed
        chunk lengths fit the budget and the width `prefill_rows`.  The
        lane admission (at most one: `_next_item`) ranks after the normal
        ones, and only once its chunk's pages are mapped (a page-starved
        lane head is the one exception to the head rule)."""
        if not self._admissions:
            return []
        head = self._admissions[0]
        if head["item"]["long"] and not self._ensure_long_pages(head):
            head = None
        pool = list(self._admissions)   # the lane may have failed the head
        if head is not None and head not in pool:
            head = None
        rest = [a for a in pool if a is not head]
        order = ([head] if head is not None else [])
        order += [a for a in rest if not a["item"]["long"]
                  and a["item"].get("cls") != "batch"]
        order += [a for a in rest if not a["item"]["long"]
                  and a["item"].get("cls") == "batch"]
        order += [a for a in rest if a["item"]["long"]]
        selected, spent = [], 0
        for adm in order:
            if (adm["item"]["long"] and adm is not head
                    and not self._ensure_long_pages(adm)):
                continue
            size = self._next_chunk_len(adm)
            if selected and (len(selected) >= self.prefill_rows
                             or spent + size > self.prefill_budget):
                break
            selected.append(adm)
            spent += size
        return selected

    def _next_chunk_len(self, adm):
        """The length of the chunk `adm` runs next (a draft catch-up
        chunk counts against the budget like any other)."""
        if adm["di"] < len(adm["d_sizes"]):
            return adm["d_sizes"][adm["di"]]
        return adm["sizes"][adm["i"]]

    def _prefill_shape(self, entries):
        """``(bucket, width)`` of one round's ``(row, chunk, start)``
        entries: rows padded to a power of two, chunks to a power-of-two
        bucket capped at the prefill chunk."""
        return (_bucket_len(max(len(c) for _, c, _ in entries),
                            self.prefill_chunk), _pow2_width(len(entries)))

    def _prefill_batch(self, entries):
        """``(width, tensors)`` of one round's entries at
        :meth:`_prefill_shape` (``decode.build_prefill_batch``)."""
        bucket, width = self._prefill_shape(entries)
        return width, decode_mod.build_prefill_batch(
            entries, width, bucket, self.n_slots, self.device)

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
        # draft catch-up rounds run apart: they advance the draft cache
        # over shared positions the target never recomputes
        catchup = [a for a in selected if a["di"] < len(a["d_sizes"])]
        if catchup:
            entries = []
            for adm in catchup:
                size, off = adm["d_sizes"][adm["di"]], adm["d_off"]
                entries.append((adm["row"],
                                adm["item"]["prompt"][off:off + size], off))
                adm["d_off"], adm["di"] = off + size, adm["di"] + 1
            self._devop("draft_prefill", entries)
            self.counters.inc("prefill_dispatches")
            for (row, chunk, off), adm in zip(entries, catchup):
                self.trace.event(adm["item"].get("trace"), "prefill",
                                 row=row, chunk=len(chunk), offset=off,
                                 draft_catchup=True)
            return True
        entries, finishing = [], []
        for adm in selected:
            off, size = adm["offset"], adm["sizes"][adm["i"]]
            # "src": the prompt, or a replay's committed tokens but the last
            chunk = adm["src"][off:off + size]
            entries.append((adm["row"], chunk, off))
            adm["offset"] = off + len(chunk)
            adm["i"] += 1
            if adm["offset"] >= len(adm["src"]):
                finishing.append(adm)
            tid = adm["item"].get("trace")
            if adm["item"]["long"]:
                self.counters.inc("long_chunks_dispatched")
                self.trace.event(tid, "long.chunk", row=adm["row"],
                                 chunk=len(chunk), offset=off)
            else:
                self.trace.event(tid, "prefill", row=adm["row"],
                                 chunk=len(chunk), offset=off)
        bucket, width = self._prefill_shape(entries)
        if self.kv_page_size:
            # bucket overshoot and pad rows write into the sink
            pad = (sum(bucket - len(c) for _, c, _ in entries)
                   + (width - len(entries)) * bucket)
            if pad:
                self.counters.inc("kv_sink_writes", pad)
        logits = self._devop(
            "prefill", entries, [adm["item"]["aidx"] for adm in selected]
            if self.lora_rank else None)
        self.counters.inc("prefill_dispatches")
        for i, adm in enumerate(selected):
            if adm in finishing:
                self._admissions.remove(adm)
                self._finish_admission(adm, logits[i])
        return True

    def _dev_prefill(self, entries, aidxs):
        """One batched prefill forward over ``entries`` (``aidxs``: each
        entry's adapter, or None without a bank): the last-position
        whole-vocabulary logits of each row."""
        width, batch = self._prefill_batch(entries)
        lora = None
        if aidxs is not None:
            lora = (self._lora_banks, decode_mod.to_device(
                list(aidxs) + [0] * (width - len(aidxs)), self.device))
        with torch.no_grad(), self._on_mesh():
            logits = decode_mod.slot_prefill_many(
                self.model, self._cache, *batch,
                self._sink if self.kv_page_size else 0, lora=lora)
            if self.draft_model is not None:
                # the draft's dense cache mirrors every target chunk
                decode_mod.slot_prefill_many(self.draft_model, self._d_cache,
                                             *batch, 0)
        return logits

    def _dev_draft_prefill(self, entries):
        """One batched prefill of the draft's dense cache alone (its
        catch-up over positions the target shares from the prefix
        cache)."""
        with torch.no_grad(), self._on_mesh():
            decode_mod.slot_prefill_many(
                self.draft_model, self._d_cache,
                *self._prefill_batch(entries)[1], 0)

    def _finish_admission(self, adm, logits_row):
        """Final chunk done: publish the row's prefix pages, pick the
        first token (ordinal 0 of the request's noise), record TTFT,
        deliver it and occupy the row for decode."""
        if "resume" in adm["item"]:
            # a replay: the final chunk's logits are for a token the lost
            # replica already emitted; no pick, the row state installs
            self._finish_replay(adm)
            return
        item, row = adm["item"], adm["row"]
        h, prompt, max_new = item["h"], item["prompt"], item["max_new"]
        if self.kv_page_size:
            self._register_prefix_pages(row)
        filt = bool(item["temp"] > 0 and (item["topk"] or item["topp"] < 1.0
                                          or item["minp"] > 0.0))
        fkw = ({"topks": [item["topk"]], "topps": [item["topp"]],
                "minps": [item["minp"]]} if filt else {})
        pen = item["rep"] != 1.0
        if pen:
            # the first pick's penalty sees the prompt tokens
            seen = decode_mod.seen_from_prompt(decode_mod.to_device(
                [prompt], self.device), self.vocab_size)
            logits_row = decode_mod.apply_repetition_penalty(
                logits_row[None], seen, decode_mod.to_device(
                    [item["rep"]], self.device))[0]
        # deliberate readback: the first token is needed as an int before
        # the row joins the decode chain (one per admission, not per step)
        tok = int(decode_mod.pick_tokens(
            logits_row[None], [item["temp"]], [item["seed"]], [0],
            **fkw)[0])
        now = time.monotonic()
        t0 = item["t_submit"]
        self._ttft.record(now - t0)
        self._ttft_cls[item.get("cls") or "interactive"].record(now - t0)
        tid = item.get("trace")
        if tid:
            t_adm = adm.get("t_admit", now)
            self.trace.span_at(tid, "queue", t0, t_adm)
            self.trace.span_at(tid, "admit", t_adm, now, row=row,
                               prompt_len=len(prompt))
        h.tokens.put([tok])
        seq = prompt + [tok]
        eos = item["eos"]
        if (max_new <= 1 or (eos is not None and tok == eos)
                or self._hit_stop(seq, item["stops"], len(prompt))):
            self._free_row(row)
            h._finish(seq)
            self.counters.inc("requests_served")
            self.trace.event(tid, "retire", row=row, reason="first_token")
            return
        self._gen[row] += 1
        self._devop("occupy", row, tok, max_new - 1, eos, item["temp"],
                    item["seed"], item["topk"], item["topp"], item["minp"],
                    item["aidx"], item["rep"], prompt if pen else None,
                    seq if self.spec_mode == "ngram" else None)
        sampled = item["temp"] > 0
        self._n_filtered += filt
        self._n_sampled += sampled
        self._n_penalized += pen
        self._slots[row] = {"handle": h, "seq": seq, "remaining": max_new - 1,
                            "filtered": filt, "sampled": sampled, "pen": pen,
                            "stops": item["stops"], "plen": len(prompt),
                            "item": item}

    def _dev_occupy(self, row, tok, rems, eos, temp, seed, topk, topp, minp,
                    aidx, rep, prompt, ctx):
        """An admitted row's decode registers: its first token, budget,
        eos, sampling controls, adapter, (``rep != 1``) the penalty's
        seen table of ``prompt`` and (n-gram speculation) the row's
        committed tokens ``ctx`` in the n-gram table."""
        # a fresh tensor: pending readback entries still hold the old one
        self._toks = self._toks.clone()
        self._toks[row] = tok
        self._rems[row] = rems
        self._eoss[row] = eos if eos is not None else 0
        self._eos_on[row] = eos is not None
        self._temps[row] = temp
        self._seeds[row] = seed
        self._ords[row] = 1
        self._topks[row] = topk
        self._topps[row] = topp
        self._minps[row] = minp
        if self.lora_rank:
            self._lora_ids[row] = aidx
        if rep != 1.0:
            self._seen[row] = decode_mod.seen_from_prompt(
                decode_mod.to_device([prompt], self.device),
                self.vocab_size)[0]
            self._reps[row] = rep
        if ctx is not None:
            decode_mod.set_row_ctx(self._spec_ctx, self._spec_ctx_len, row,
                                   ctx)
        if self._follower:
            self._live[row] = True

    @staticmethod
    def _hit_stop(seq, stops, gen_start):
        """True when `seq` ends with one of the request's stop sequences
        lying wholly in the generated region (a stop across the prompt
        boundary does not count); the stop's tokens stay in the
        output, as an eos does."""
        return any(len(seq) - len(st) >= gen_start
                   and seq[-len(st):] == st for st in stops)

    # ---- kv migration (the kvtransfer.MigrationEngine substrate) ------------
    # A live session moves replicas in three acts, as in the JAX batcher.
    # FREEZE (source): the host thread stops committing the row's tokens
    # at a tick, and the device thread bumps its generation (work in
    # flight drops; the destination regenerates it) and gathers its
    # committed kv into fresh tensors copied to pinned host memory.
    # RESUME (destination): an admission without prefill allocates fresh
    # pages, scatters the blocks, maps the table and rebuilds every
    # resident register from the committed sequence.  Then COMPLETE (the
    # source frees the row once the destination acks) or ROLLBACK (the
    # source reinstalls its own registers and decodes on).  Pages are
    # owned by exactly one replica at every instant.

    def _freeze_row(self, row, s):
        """Host-tick side of the freeze cut for `row` (slot dict `s`):
        delegate the device half, then publish the frozen record on the
        handle.  The committed ``seq`` at this instant IS the resume
        point."""
        h = s["handle"]
        box = {}
        if threading.current_thread() is self._thread:
            self._apply_freeze(row, box)     # serial engine: inline
        elif not self._device_op(("freeze", row, box)):
            return
        if not box.get("ok"):
            return
        s["frozen"] = True
        h.frozen = {"row": row, "gen": self._gen[row],
                    "seq": list(s["seq"]), "plen": s["plen"],
                    "remaining": s["remaining"], "item": s["item"],
                    "kind": "paged" if self.kv_page_size else "dense",
                    "kv": box["kv"], "event": box["event"],
                    "keep": box["keep"], "n_pages": box.get("n_pages", 0)}
        self.trace.event(s["item"].get("trace"), "freeze", row=row,
                         committed=len(s["seq"]),
                         n_pages=box.get("n_pages", 0))
        h.freeze_done.set()

    def _apply_freeze(self, row, box):
        """Device thread: bump `row`'s generation and gather its committed
        kv (its first pages, or its dense window) into fresh tensors
        whose copy to pinned host memory starts now.  The pool keeps
        stepping: the garbage the frozen row writes lands past the cut
        (its own pages' tail or the sink), which neither continuation
        reads before overwriting."""
        s = self._slots[row]
        if s is None:
            return
        self._gen[row] += 1
        n_pos = len(s["seq"]) - 1   # kv positions [0, n_pos) committed;
        # position n_pos is written again by the fed token on resume
        if self.kv_page_size:
            owned = self._row_pages[row] or []
            n_have = min(max(1, -(-n_pos // self.kv_page_size)), len(owned))
            kv = decode_mod.gather_pages(self._cache, owned[:n_have])
            box["n_pages"] = n_have
        else:
            kv = decode_mod.gather_row_kv(self._cache, row)
        box["kv"], box["event"] = self._copy_to_host(kv)
        box["keep"] = kv     # alive until the copy's event fires
        box["ok"] = True

    def _apply_rollback(self, row, frozen, box):
        """Device thread: the migration failed before the ack; reinstall
        the row's registers from the frozen cut and let it decode on.
        Its pages never left the row, so the pool is untouched."""
        s = self._slots[row]
        if s is None or self._gen[row] != frozen["gen"]:
            return      # stop() or a death already tore the row down
        self._gen[row] += 1   # drop the frozen period's work in flight
        self._install_row_state(row, frozen["seq"], frozen["plen"],
                                frozen["remaining"], frozen["item"])
        s["frozen"] = False
        box["ok"] = True

    def _install_row_state(self, row, seq, plen, remaining, item):
        """Rebuild every resident device register of `row` from a
        committed sequence (a rollback on the source, a resume or replay
        on the destination): the write cursor at the next position, the
        fed token the last committed one, and the ordinal, budget and
        seen table a row that never moved would hold, so the row goes on
        with its own tokens, sampled ones too ((seed, ordinal) noise)."""
        eos = item["eos"]
        decode_mod.set_row_indices(
            self._cache, decode_mod.to_device([row], self.device),
            decode_mod.to_device([len(seq) - 1], self.device))
        # a fresh tensor: pending readback entries still hold the old one
        self._toks = self._toks.clone()
        self._toks[row] = seq[-1]
        self._rems[row] = remaining
        self._eoss[row] = eos if eos is not None else 0
        self._eos_on[row] = eos is not None
        self._temps[row] = item["temp"]
        self._seeds[row] = item["seed"]
        self._ords[row] = len(seq) - plen
        self._topks[row] = item["topk"]
        self._topps[row] = item["topp"]
        self._minps[row] = item["minp"]
        if item["rep"] != 1.0:
            # the seen table holds everything but the fed token: the step
            # adds it before its pick, as after an admission
            self._seen[row] = decode_mod.seen_from_prompt(
                decode_mod.to_device([seq[:-1]], self.device),
                self.vocab_size)[0]
            self._reps[row] = item["rep"]
        if self.spec_mode == "ngram":
            decode_mod.set_row_ctx(self._spec_ctx, self._spec_ctx_len, row,
                                   seq)

    def _occupy(self, row, item, seq, remaining):
        """Occupy `row` mid-sequence (a resume or a replay): the row
        state, the adapter, the engine's row counts and the slot."""
        self._gen[row] += 1
        self._install_row_state(row, seq, len(item["prompt"]), remaining,
                                item)
        if self.lora_rank:
            self._lora_ids[row] = item["aidx"]
        filt = bool(item["temp"] > 0 and (item["topk"] or item["topp"] < 1.0
                                          or item["minp"] > 0.0))
        sampled = item["temp"] > 0
        pen = item["rep"] != 1.0
        self._n_filtered += filt
        self._n_sampled += sampled
        self._n_penalized += pen
        self._slots[row] = {"handle": item["h"], "seq": list(seq),
                            "remaining": remaining, "filtered": filt,
                            "sampled": sampled, "pen": pen,
                            "stops": item["stops"],
                            "plen": len(item["prompt"]), "item": item}

    def _finish_replay(self, adm):
        """The final replay chunk is done: the row's cache holds kv for
        every committed position but the last token's (the first decode
        step writes it, as after a migration); occupy the row.  Nothing
        is emitted: the lost replica delivered the last token."""
        item, row = adm["item"], adm["row"]
        res = item["resume"]
        self.trace.event(item.get("trace"), "replay", row=row,
                         committed=len(res["seq"]),
                         remaining=res["remaining"])
        if self.kv_page_size:
            self._register_prefix_pages(row)
        self._occupy(row, item, res["seq"], res["remaining"])
        self.counters.inc("replays_resumed")
        res["installed"].set()

    def _install_resume(self, row, item):
        """Device thread: allocate fresh pages (growing the tables first
        when they are too narrow), scatter the migrated kv into them (or
        the dense row), and occupy `row` mid-sequence.  False when the
        pool cannot hold it yet (it waits like any admission).  No prefix
        sharing either way: the prefix cache publishes only pages this
        replica computed."""
        faults.check("serve.resume_install")
        res = item["resume"]
        if self.kv_page_size:
            n_have = res["n_pages"]
            need = max(n_have, self._pages_needed(
                len(item["prompt"]), item["max_new"], item["rep"]))
            if len(self._free_pages) < need:
                self._evict_cached_pages(need - len(self._free_pages))
            if len(self._free_pages) < need:
                return False
            pages = [self._free_pages.pop() for _ in range(need)]
            try:
                self._assert_no_sink(pages)
                self._map_row(row, pages)
                decode_mod.scatter_pages(self._cache, pages[:n_have],
                                         res["kv"])
            except BaseException:
                # conservation, as in _try_allocate
                self._free_pages.extend(pages)
                raise
            self._row_pages[row] = pages
            self._row_shared_n[row] = 0
            self._row_prefix_keys[row] = None
        else:
            decode_mod.scatter_row_kv(self._cache, row, res["kv"])
        self._occupy(row, item, res["seq"], res["remaining"])
        res["kv"] = None     # installed: the host blocks may go
        self.counters.inc("migrations_resumed")
        self.counters.inc("kv_pages_imported", res["n_pages"])
        self.trace.event(item.get("trace"), "resume", row=row,
                         committed=len(res["seq"]), n_pages=res["n_pages"])
        res["installed"].set()
        return True

    def freeze_session(self, h, timeout_s=10.0):
        """Cut a live session for migration: ask the host thread to stop
        committing at its next tick for the row, and return the frozen
        record (the committed seq and its kv on its way to host memory).
        None when the session completed before the cut landed;
        TimeoutError when no cut lands in `timeout_s`, the session
        running on untouched."""
        self._refuse_tp("kv migration / host tier / parking")
        if self._dead is not None:
            raise RuntimeError(f"batcher died: {self._dead}")
        if self.draft_model is not None:
            raise ValueError(
                "kv migration does not compose with speculative decoding "
                "from a draft model (its cache is not shipped)")
        h.migrate_requested.set()
        if not h.freeze_done.wait(timeout_s):
            h.migrate_requested.clear()
            # the cut may have landed concurrently with the clear
            if not h.freeze_done.wait(0.2):
                if h._done.is_set():
                    return None      # finished first: nothing to move
                raise TimeoutError(
                    f"freeze did not land within {timeout_s:.1f}s")
        return h.frozen

    def complete_migration(self, frozen):
        """The destination acked the splice: free the source row through
        the normal retirement path; each side frees only its own
        pages."""
        self._retire(frozen["row"], frozen["gen"])
        self.counters.inc("migrations_completed")
        self.counters.inc("kv_pages_exported", frozen.get("n_pages", 0))

    def rollback_migration(self, frozen):
        """The migration failed before the ack: reinstall the row's
        registers from the frozen cut and decode on HERE; the client's
        stream goes on as if nothing happened.  False only when the
        engine is stopping (the handle then fails through the death
        path)."""
        h = frozen["item"]["h"]
        box = {}
        if threading.current_thread() is self._thread:
            self._apply_rollback(frozen["row"], frozen, box)
        elif not self._device_op(("rollback", frozen["row"], frozen, box)):
            return False
        # clear migrate_requested FIRST: with it down, the host thread
        # cannot enter the freeze branch between the two clears
        h.migrate_requested.clear()
        h.freeze_done.clear()
        h.frozen = None
        return bool(box.get("ok"))

    def live_handles(self):
        """Handles of the sessions occupying rows (the drain-by-migration
        snapshot; a row finishing meanwhile yields a handle whose
        migration reports completed_locally)."""
        return [s["handle"] for s in list(self._slots)
                if s is not None and not s.get("frozen")]

    def _resume_item(self, meta, what):
        """Validate a resume or replay ``meta`` (wire_snapshot's keys) on
        the caller's thread and build its admission item (without the
        ``resume`` record)."""
        if self._dead is not None:
            raise RuntimeError(f"batcher died: {self._dead}")
        if self.draft_model is not None:
            raise ValueError(f"this replica runs speculative decoding "
                             f"from a draft model; it cannot {what} "
                             "sessions")
        seq = [int(t) for t in (meta.get("seq") or ())]
        plen = int(meta.get("plen") or 0)
        max_new = int(meta.get("max_new") or 0)
        remaining = int(meta.get("remaining") or 0)
        if not 0 < plen < len(seq):
            raise ValueError(f"{what} needs a prompt and at least one "
                             "decoded token")
        if any(not 0 <= t < self.vocab_size for t in seq):
            raise ValueError(f"sequence token out of vocab range "
                             f"{self.vocab_size}")
        if remaining <= 0 or remaining != max_new - (len(seq) - plen):
            raise ValueError(
                f"inconsistent budget: remaining={remaining} with "
                f"{len(seq) - plen} of max_new={max_new} decoded")
        if len(seq) + remaining > self.max_seq:
            raise ValueError(
                f"the {what}d sequence needs {len(seq) + remaining} "
                f"positions; this replica's max_seq_len is {self.max_seq}")
        temp = float(meta.get("temp") or 0.0)
        topk, topp = int(meta.get("topk") or 0), float(meta.get("topp", 1.0))
        minp, rep = float(meta.get("minp") or 0.0), float(meta.get("rep",
                                                                   1.0))
        decode_mod.check_pick_args(temp, topk, topp, minp)
        decode_mod.check_penalty(rep)
        if (self.kv_page_size
                and self._pages_needed(plen, max_new, rep)
                > self._total_pages):
            raise ValueError(f"the {what}d request does not fit this "
                             "replica's kv pool; raise --generate_kv_pages")
        eos = meta.get("eos")
        stops = [list(map(int, st)) for st in (meta.get("stops") or ())]
        adapter = meta.get("adapter")
        aidx = 0
        if adapter is not None:
            if not self.lora_rank:
                raise ValueError(f"session uses adapter {adapter!r} but "
                                 "this replica has no LoRA bank")
            with self._lora_lock:
                if adapter not in self._adapters:
                    raise ValueError(f"unknown adapter {adapter!r} on this "
                                     "replica")
                aidx = self._adapters[adapter]
                self._adapter_refs[aidx] = self._adapter_refs.get(aidx, 0) + 1
        h = SlotHandle(seq[:plen])
        if aidx:
            h._on_done = lambda idx=aidx: self._release_adapter(idx)
        prio = meta.get("priority")
        return {
            "h": h, "prompt": seq[:plen], "max_new": max_new, "temp": temp,
            "eos": int(eos) if eos is not None else None,
            "seed": int(meta.get("seed") or 0), "aidx": aidx,
            "adapter": adapter, "topk": topk, "topp": topp, "minp": minp,
            "stops": stops, "rep": rep,
            "cls": prio if prio in PRIORITY_CLASSES else "interactive",
            "long": False,
            "trace": (meta.get("trace") if trace.valid_id(meta.get("trace"))
                      else None),
            "t_submit": time.monotonic()}, seq, remaining

    def _enqueue_resume(self, item):
        self._pending.put(item)
        if self._dead is not None:
            self._drain_pending(RuntimeError(f"batcher died: {self._dead}"))
        return item["h"], item["resume"]["installed"]

    def submit_resume(self, meta, blocks):
        """An admission that SKIPS prefill: occupy a row with a migrated
        session's committed sequence and kv blocks.  Validates eagerly
        (the caller's thread), so a malformed snapshot raises
        ValueError instead of killing the device loop.  Returns
        ``(handle, installed)``: the event sets once the row is live
        (the :resume surface's splice ack)."""
        self._refuse_tp("kv migration / host tier / parking")
        kind = "paged" if self.kv_page_size else "dense"
        if meta.get("kind") != kind:
            raise ValueError(
                f"kv layout mismatch: the snapshot is {meta.get('kind')!r}, "
                f"this replica serves {kind!r} caches")
        if (self.kv_page_size
                and int(meta.get("page_size") or 0) != self.kv_page_size):
            raise ValueError(
                f"page size mismatch: the snapshot uses "
                f"{meta.get('page_size')}, this replica {self.kv_page_size}")
        item, seq, remaining = self._resume_item(meta, "resume")
        try:
            n_pages = int(meta.get("n_pages") or 0)
            if self.kv_page_size:
                expect = max(1, -(-(len(seq) - 1) // self.kv_page_size))
                if n_pages != expect:
                    raise ValueError(
                        f"snapshot ships {n_pages} pages; {len(seq) - 1} "
                        f"committed positions need {expect}")
            leaves = decode_mod.kv_leaves(self._cache)
            missing = sorted(set(leaves) - set(blocks))
            if missing:
                raise ValueError(f"snapshot is missing kv blocks {missing}")
            kv = {}
            for name, leaf in leaves.items():
                want = (((n_pages,) if self.kv_page_size else ())
                        + tuple(leaf.shape[1:]))
                a = torch.as_tensor(blocks[name])
                if tuple(a.shape) != want:
                    raise ValueError(
                        f"kv block {name!r} has shape {tuple(a.shape)}; "
                        f"this replica expects {want}")
                kv[name] = a.contiguous()
        except BaseException:
            item["h"]._fail(RuntimeError("resume refused"))   # adapter ref
            raise
        item["resume"] = {"seq": seq, "remaining": remaining,
                          "n_pages": n_pages, "kv": kv,
                          "installed": threading.Event()}
        return self._enqueue_resume(item)

    def submit_replay(self, meta):
        """An admission that REBUILDS a lost session from its token record
        alone (no kv: the lost replica's pages are gone): the committed
        sequence prefills here and the row state installs as a
        migration's would, so decode goes on with the same tokens.
        ``meta`` uses wire_snapshot's keys minus the kv layout, so a
        record works against any layout.  Returns ``(handle,
        installed)`` like :meth:`submit_resume`."""
        self._refuse_tp("kv migration / host tier / parking")
        item, seq, remaining = self._resume_item(meta, "replay")
        # no "kv" key: _start_admission reads that as "prefill again"
        item["resume"] = {"seq": seq, "remaining": remaining,
                          "installed": threading.Event()}
        return self._enqueue_resume(item)

    # ---- the preemption controller (park / resume) -------------------------
    # Parking reuses the migration machinery end to end: freeze_session
    # cuts the victim at a commit, wire_snapshot flattens the cut
    # host-side, complete_migration frees the row AND its pages (a parked
    # session holds no device state), and submit_resume admits it again
    # with the same tokens when pressure drops.  Parks ride the migration
    # counters too; sessions_parked / _unparked count the preemption
    # traffic itself.

    def _park_gather(self, h):
        """Cut a running session and pull its snapshot host-side.  On
        success the row and its pages are freed and the returned entry
        OWNS the session: it reaches exactly one of `_park_restore` or
        `_park_discard`.  None when the session finished before the cut
        landed; on a snapshot failure the session decodes on in place."""
        from tensorflowonspark_tpu_torch import kvtransfer

        frozen = self.freeze_session(h)
        if frozen is None:
            return None
        try:
            faults.check("serve.park_gather")
            meta, blocks = kvtransfer.wire_snapshot(frozen, "parked",
                                                    self.kv_page_size)
        except BaseException:
            self.rollback_migration(frozen)
            raise
        self.complete_migration(frozen)
        self.counters.inc("sessions_parked")
        self.trace.event(meta.get("trace"), "park",
                         committed=len(meta["seq"]),
                         n_pages=meta.get("n_pages", 0))
        return {"h": h, "meta": meta, "blocks": blocks,
                "t_parked": time.monotonic()}

    def _park_restore(self, entry):
        """Resume a parked session through the :resume admission and
        splice the resumed stream into the original handle, which never
        learns its tokens crossed a park."""
        faults.check("serve.park_restore")
        h2, _ = self.submit_resume(entry["meta"], entry["blocks"])
        self.counters.inc("sessions_unparked")
        self.trace.event(
            entry["meta"].get("trace"), "unpark",
            parked_ms=round((time.monotonic() - entry["t_parked"]) * 1000.0,
                            3))
        threading.Thread(target=self._pump_resumed, args=(entry["h"], h2),
                         name="park-splice", daemon=True).start()
        return h2

    def _park_discard(self, entry, err=None):
        """Drop a parked session without resuming it: fail its handle
        (teardown) or finish it at its parked sequence (the client
        cancelled while parked)."""
        h = entry["h"]
        if err is not None:
            h._fail(err)
        else:
            h._finish([int(t) for t in entry["meta"]["seq"]])

    def _sweep_park_pool(self, err):
        """stop() / _die(): every parked snapshot dies with the engine."""
        with self._park_lock:
            entries = list(self._park_pool)
            self._park_pool.clear()
        for entry in entries:
            self._park_discard(entry, err)

    def _pump_resumed(self, h, h2):
        """Forward the resumed handle's stream into the original (one
        thread per restore; it ends with the resumed stream)."""
        try:
            while True:
                if h.cancelled.is_set():
                    h2.cancel()
                try:
                    batch = h2.tokens.get(timeout=0.1)
                except queue_mod.Empty:
                    continue
                if batch is None:
                    break
                h.tokens.put(batch)
            h._finish(h2.result(timeout=10.0))
        except BaseException as e:
            h._fail(e)

    def _pick_victim(self):
        """The batch-class running session with the most work left (a racy
        scan: the device thread owns the slots; a stale pick only makes
        freeze_session return None)."""
        victim, most = None, -1
        for s in list(self._slots):
            if s is None or s.get("frozen"):
                continue
            if (s["item"].get("cls") or "interactive") != "batch":
                continue
            h = s["handle"]
            if h.migrate_requested.is_set() or h._done.is_set():
                continue
            if s["remaining"] > most:
                victim, most = h, s["remaining"]
        return victim

    def _preempt_loop(self):
        """The controller thread: freeze_session and submit_resume both
        wait on device-thread acks, so preemption watches from here."""
        while not self._stop.is_set():
            try:
                self._preempt_tick()
            except BaseException:
                if self._stop.is_set() or self._dead is not None:
                    return
                logger.warning("preemption tick failed", exc_info=True)
            self._stop.wait(0.02)

    def _preempt_tick(self):
        """One controller decision: park when the oldest waiting
        interactive admission has queued past `preempt_ms`; resume the
        oldest parked session when no interactive work waits and a row
        is free.  The class queues and the slots are read racily (the
        device thread owns them): a stale view shifts a decision by one
        20 ms tick."""
        now = time.monotonic()
        try:
            head = self._classq["interactive"][0]
        except IndexError:
            head = None
        if head is not None:
            if (now - head["t_submit"]) * 1000.0 <= self.preempt_ms:
                return
            with self._park_lock:
                if len(self._park_pool) >= self.park_capacity:
                    self.counters.inc("park_spills")
                    return
            victim = self._pick_victim()
            if victim is None:
                return
            try:
                entry = self._park_gather(victim)
            except TimeoutError:
                return      # no commit landed in time; the session runs on
            except BaseException:
                self.counters.inc("park_failures")
                logger.warning("park failed; session continues",
                               exc_info=True)
                return
            if entry is None:
                return      # finished before the cut landed
            with self._park_lock:
                self._park_pool.append(entry)
                self._park_depth.set(len(self._park_pool))
            return
        # no interactive pressure: resume the oldest into a free row
        if not any(s is None for s in list(self._slots)):
            return
        with self._park_lock:
            if not self._park_pool:
                return
            entry = self._park_pool.popleft()
            self._park_depth.set(len(self._park_pool))
        if entry["h"].cancelled.is_set():
            self._park_discard(entry)   # the client left while parked
            return
        try:
            self._park_restore(entry)
        except BaseException:
            self.counters.inc("park_restore_failures")
            logger.warning("park restore failed; session stays parked",
                           exc_info=True)
            with self._park_lock:
                self._park_pool.appendleft(entry)
                self._park_depth.set(len(self._park_pool))

    # ---- decode, readback and the two engines ------------------------------

    def _dispatch(self):
        """One decode advance for every row (free rows write the sink or
        past their window): a speculative round (``decode.spec_round``)
        unless speculation is off or a penalised row is active, else one
        plain step.  Returns the readback entry (tokens ``[n]`` or ``[n,
        k]``, deliverable counts or None, done plane, generation
        snapshot, the round's k or None); nothing here waits for the
        card."""
        if self.kv_page_size:
            idle = sum(s is None for s in self._slots)
            if idle:
                self.counters.inc("kv_sink_writes", idle)
        use_spec = self.spec_mode != "off" and not self._n_penalized
        if use_spec:
            try:
                faults.check("serve.spec_verify")
            except Exception:
                # a failed round falls back to a plain step: greedy rows
                # give the same tokens, sampled ones the same distribution
                self.counters.inc("spec_draft_fallbacks")
                use_spec = False
        if use_spec:
            return self._dispatch_spec()
        done = self._devop("step", self._n_filtered > 0,
                           self._n_penalized > 0, self._n_sampled > 0)
        return self._toks, None, done, tuple(self._gen), None

    def _dev_step(self, filtered, penalized, sampled):
        """One plain decode step of every row (``decode.slot_step``);
        returns the done plane."""
        fkw = ({"topks": self._topks, "topps": self._topps,
                "minps": self._minps} if filtered else {})
        pkw = {"seen": self._seen, "reps": self._reps} if penalized else {}
        lora = (self._lora_banks, self._lora_ids) if self.lora_rank else None
        with torch.no_grad(), self._on_mesh():
            self._toks, self._rems, done = decode_mod.slot_step(
                self.model, self._cache, self._toks, self._temps,
                self._seeds, self._ords, rems=self._rems, eoss=self._eoss,
                eos_on=self._eos_on, lora=lora, sampled=bool(sampled),
                **fkw, **pkw)
        self._ords = self._ords + 1
        self._steps += 1
        if self._follower:
            self._live = self._live & ~done
        return done

    def _devop(self, name, *args):
        """Apply device operation ``name`` (``_dev_<name>``, one of
        ``_TP_OPS``) on this rank and return its result.  On a tp leader
        the operation first goes to the followers, whose replay issues
        the same forwards, collectives and writes in the same order: a
        header of ints where every argument is one, else a payload."""
        if self._chan is not None:
            code = _TP_OPS.index(name)
            if len(args) <= coll.HeaderChannel.HEADER - 3 and all(
                    isinstance(a, (bool, int)) for a in args):
                self._chan.send(code, (len(args),) + args)
            else:
                self._chan.send(code, payload=args)
            self._last_send = time.monotonic()
        return getattr(self, "_dev_" + name)(*args)

    def _dev_set_index(self, row, value):
        decode_mod.set_row_indices(
            self._cache, decode_mod.to_device([row], self.device),
            decode_mod.to_device([value], self.device))

    def _dev_noop(self):
        pass

    def _tp_keepalive(self):
        """An idle tp leader's noop, every ``_TP_KEEPALIVE_S``."""
        if (self._chan is not None
                and time.monotonic() - self._last_send > _TP_KEEPALIVE_S):
            self._devop("noop")

    def _follow_loop(self):
        """A tp follower's device thread: replay the leader's device
        operations, in its order, until its stop."""
        try:
            while True:
                code, ints, payload = self._chan.recv()
                name = _TP_OPS[code]
                if name == "stop":
                    return
                args = (payload if payload is not None
                        else ints[1:1 + ints[0]])
                getattr(self, "_dev_" + name)(*args)
        except BaseException as e:
            self._die(e, "tp follower died")

    def _dispatch_spec(self):
        """One speculative round at the adaptive k (the host thread's
        latest suggestion, through `_speck_q`; a tp follower replays the
        leader's k from the header)."""
        try:
            while True:
                self._spec_k = self._speck_q.get_nowait()
        except queue_mod.Empty:
            pass
        k = self._spec_k
        c_tok, n_del, done = self._devop("spec", k, self._n_filtered > 0,
                                         self._n_sampled > 0)
        self.counters.inc("spec_tokens_proposed",
                          k * sum(s is not None for s in self._slots))
        return c_tok, n_del, done, tuple(self._gen), k

    def _dev_spec(self, k, filtered, sampled):
        """One speculative round of every row (``decode.spec_round``) at
        ``k``; returns ``(c_tok, n_del, done)``.  A tp follower, which
        reads nothing back, counts the accepted tokens of its live rows
        on the device (as the leader's host thread does from the
        readback)."""
        fkw = ({"topks": self._topks, "topps": self._topps,
                "minps": self._minps} if filtered else {})
        lora = (self._lora_banks, self._lora_ids) if self.lora_rank else None
        if self.spec_mode == "ngram":
            skw = {"ctx": self._spec_ctx, "ctx_len": self._spec_ctx_len}
        else:
            skw = {"draft": self.draft_model, "d_cache": self._d_cache}
        with torch.no_grad(), self._on_mesh():
            (self._toks, c_tok, _, n_del, done, self._rems, self._ords,
             ctx_len) = decode_mod.spec_round(
                self.model, self._cache, self._toks, self._temps,
                self._seeds, self._ords, self._rems, self._eoss,
                self._eos_on, k, lora=lora, sampled=bool(sampled),
                **skw, **fkw)
        if ctx_len is not None:
            self._spec_ctx_len = ctx_len
        self._spec_rounds += 1
        self._spec_k_sum += k
        if self._follower:
            acc = torch.where(n_del >= k, k, (n_del - 1).clamp_min(0))
            self._spec_accepted = self._spec_accepted + (
                acc * self._live).sum()
            self._live = self._live & ~done
        return c_tok, n_del, done

    def _flush(self, reads):
        """Stack a chunk's tokens, counts and done planes and START their
        copy into free host buffers (pinned on the card), with an event
        recorded after the copy.  A plain step's tokens fill column 0
        with count 1; a round of k < width pads.  The chunk is processed
        later, after a wait on that event."""
        n = len(reads)
        toks, counts, done = self._bufs.take()
        width = toks.shape[2]

        def wide(e):
            t = e[0] if e[0].dim() == 2 else e[0][:, None]
            return torch.nn.functional.pad(t, (0, width - t.shape[1]))

        toks[:n].copy_(torch.stack([wide(e) for e in reads]),
                       non_blocking=True)
        if any(e[1] is not None for e in reads):
            ones = torch.ones_like(self._toks)
            counts[:n].copy_(torch.stack([
                ones if e[1] is None else e[1] for e in reads]),
                non_blocking=True)
        else:
            counts[:n].fill_(1)
        done[:n].copy_(torch.stack([e[2] for e in reads]), non_blocking=True)
        event = None
        if self.device.type == "cuda":
            # a blocking-sync event: the waiting host thread sleeps
            # instead of spinning beside the launching device thread
            event = torch.cuda.Event(blocking=True)
            event.record()
        return (toks, counts, done, n, event, [e[3] for e in reads],
                [e[4] for e in reads])

    def _process_batch(self, batch):
        """One flushed chunk -> token commits, stream deliveries and
        retirements, in dispatch order (the host side of the pipeline).
        The wait is on the chunk's copy event (which releases the GIL);
        the device-computed done plane decides retirement, the host
        checks the requests' stop sequences.  Each stream gets the
        chunk's tokens in one put.  Speculative entries also feed the
        adaptive draft length: per-row acceptance averages, and a new
        suggested k to the device thread through `_speck_q`."""
        toks, counts, done, k, event, gens_list, ks_list = batch
        if event is not None:
            event.synchronize()
        block, count_rows = toks[:k].tolist(), counts[:k].tolist()
        done_rows = done[:k].tolist()
        self._bufs.give((toks, counts, done))
        pend = {}       # row -> tokens committed this tick
        spec_pend = {}  # row -> [rounds, accepted, k] this tick

        def emit(r, s):
            toks_r = pend.pop(r, None)
            sp = spec_pend.pop(r, None)
            if not toks_r:
                return
            s["handle"].tokens.put(toks_r)
            tid = s["item"].get("trace")
            n = self.trace.decode_sample
            if tid and n:
                # sampled decode spans, recorded here at commit time: the
                # device thread never sees tracing
                s["_trace_ticks"] = s.get("_trace_ticks", 0) + 1
                if (s["_trace_ticks"] - 1) % n == 0:
                    self.trace.event(tid, "decode", row=r,
                                     tokens=len(toks_r),
                                     seq_len=len(s["seq"]),
                                     tick=s["_trace_ticks"])
                    if sp:
                        self.trace.event(tid, "spec.round", row=r,
                                         rounds=sp[0], accepted=sp[1],
                                         k=sp[2])

        def retire(r, s, gen, reason):
            emit(r, s)
            self._retire(r, gen)         # before the handle finishes
            s["handle"]._finish(s["seq"])
            self.counters.inc("requests_served")
            self.trace.event(s["item"].get("trace"), "retire", row=r,
                             reason=reason, seq_len=len(s["seq"]))

        for gens, row_toks, row_counts, row_done, k_e in zip(
                gens_list, block, count_rows, done_rows, ks_list):
            for r, s in enumerate(self._slots):
                if s is None or self._gen[r] != gens[r]:
                    continue      # freed or re-occupied since dispatch
                if s.get("frozen"):
                    # mid-migration: chunks dispatched after the freeze's
                    # generation bump match it again, but their tokens
                    # continue a cut the destination (or a rollback) owns;
                    # a cancel waits for the relay or the rollback too
                    continue
                h = s["handle"]
                if (h.migrate_requested.is_set()
                        and not h.freeze_done.is_set()
                        and s["remaining"] > 0):
                    # the freeze cut: deliver what this tick committed,
                    # then snapshot, so the committed seq IS the resume
                    # point
                    emit(r, s)
                    self._freeze_row(r, s)
                    continue
                if h.cancelled.is_set():
                    retire(r, s, gens[r], "cancelled")
                    continue
                c = row_counts[r]
                if k_e:           # acceptance feedback (adaptive k)
                    acc = k_e if c >= k_e else max(0, c - 1)
                    self.counters.inc("spec_tokens_accepted", acc)
                    w = self._spec_ewma
                    w[r] = 0.5 * w[r] + 0.5 * (acc / k_e)
                    sp = spec_pend.setdefault(r, [0, 0, k_e])
                    sp[0] += 1
                    sp[1] += acc
                    sp[2] = k_e
                ended = False
                for tok in row_toks[r][:c]:
                    s["seq"].append(tok)
                    s["remaining"] -= 1
                    pend.setdefault(r, []).append(tok)
                    if self._hit_stop(s["seq"], s["stops"], s["plen"]):
                        ended = True
                        break
                if ended or row_done[r]:
                    retire(r, s, gens[r], "stop")
        for r, s in enumerate(self._slots):
            if s is not None and r in pend:
                emit(r, s)
        if any(ks_list):
            # the next round's width: the largest of the rows' desired
            # lengths, in pow2 steps up to draft_k (the tokens do not
            # depend on when the device adopts it)
            desired = max([1] + [
                1 + round(self._spec_ewma[r] * (self.draft_k - 1))
                for r, s in enumerate(self._slots) if s is not None])
            k_next = min(_pow2_width(desired), self.draft_k)
            if k_next != self._spec_k_pub:
                try:
                    self._speck_q.put_nowait(k_next)
                    self._spec_k_pub = k_next
                except queue_mod.Full:
                    pass
        self.counters.inc("host_ticks")

    def _retire(self, row, gen):
        """Retire `row` (occupant generation `gen`).  `_free_row` writes
        device state, so only the device thread runs it; from the host
        thread this posts a request and blocks on its ack."""
        if threading.current_thread() is self._thread:
            if self._slots[row] is not None and self._gen[row] == gen:
                self._free_row(row)
            return
        ev = threading.Event()
        self._retire_q.put((row, gen, ev))
        while not ev.wait(0.05):
            if self._stop.is_set() or self._dead is not None:
                return      # device thread gone: stop()/_die drain acks

    def _apply_ops(self):
        """Device thread: apply the posted operations (a prefix-cache
        drop, a migration freeze or its rollback) and ack each."""
        while True:
            try:
                op = self._ops_q.get_nowait()
            except queue_mod.Empty:
                return
            if op[0] == "drop_prefix":
                op[1]["n"] = self._evict_cached_pages(self._total_pages)
            elif op[0] == "lora":
                self._devop("lora", op[1], op[2], op[3])
            elif op[0] == "freeze":
                self._apply_freeze(op[1], op[2])
            else:
                self._apply_rollback(op[1], op[2], op[3])
            op[-1].set()

    def _apply_retirements(self, timeout=0.0):
        """Device thread: apply the posted operations and retirements and
        ack each; with `timeout`, wait that long for the first
        retirement (the nothing-to-dispatch path)."""
        self._apply_ops()
        while True:
            try:
                row, gen, ev = (self._retire_q.get(timeout=timeout)
                                if timeout else self._retire_q.get_nowait())
            except queue_mod.Empty:
                return
            timeout = 0
            if self._slots[row] is not None and self._gen[row] == gen:
                self._free_row(row)
            ev.set()
            self._apply_ops()

    def _host_loop(self):
        """Host side of the async pipeline: drain flushed chunks."""
        try:
            while not self._stop.is_set():
                try:
                    batch = self._ready.get(timeout=0.05)
                except queue_mod.Empty:
                    continue
                self._process_batch(batch)
                self._depth.add(-batch[3])
        except BaseException as e:
            self._die(e, "continuous batcher host thread died")

    def _flush_due(self, n_reads, active):
        """Whether the reads flush now: a full chunk, nothing left to
        dispatch, or a live slot within `n_reads` tokens of its end
        (rows already at zero only wait for retirement)."""
        if not n_reads:
            return False
        if n_reads >= self.read_chunk or not active:
            return True
        near = min((s["remaining"] for s in self._slots
                    if s is not None and s["remaining"] > 0), default=None)
        return near is not None and near <= n_reads

    def _step_round(self, reads, idle):
        """Admission, one prefill round and one decode step; returns
        (active, clean): whether a row decodes, and whether the round was
        decode-only (no prefill, no idle wait)."""
        self._tp_keepalive()
        self._admit(block=idle)
        prefilled = self._run_prefill_round()
        active = any(s is not None for s in self._slots)
        if active:
            reads.append(self._dispatch())
            self._depth.add(1)
        return active, not (prefilled or idle)

    def _mark_flush(self, mark, clean, n_reads):
        """Record a decode-only chunk's ms per step; returns the new
        flush mark."""
        now = time.monotonic()
        if clean:
            self._step_ms.append((now - mark) * 1000.0 / n_reads)
        return now

    def _loop(self):
        # a new thread starts on device 0: the model's device is made
        # current (events, streams and kernel launches follow it)
        dev = next(self.model.parameters()).device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            if self._follower:
                self._follow_loop()
                return
            try:
                if self.engine == "async":
                    self._loop_async()
                else:
                    self._loop_serial()
            finally:
                if self._chan is not None:
                    try:
                        self._chan.send(_TP_OPS.index("stop"))
                    except Exception:
                        logger.exception("tp leader could not end the "
                                         "followers' replay")

    def _loop_serial(self):
        """The one-thread reference engine: dispatch, flush, and process
        the PREVIOUS chunk inline while the current one computes (its
        copy rode under this chunk's compute).  The inline host work
        counts as device wait."""
        try:
            reads, inflight = [], None
            mark, clean = time.monotonic(), False
            while not self._stop.is_set():
                self._apply_retirements()
                idle = (all(s is None for s in self._slots)
                        and not self._admissions and self._parked is None
                        and not reads and inflight is None)
                active, decode_only = self._step_round(reads, idle)
                clean = clean and decode_only
                if self._flush_due(len(reads), active):
                    n = len(reads)
                    prev, inflight = inflight, self._flush(reads)
                    reads = []
                    if prev is not None:
                        t0 = time.monotonic()
                        self._process_batch(prev)
                        self._depth.add(-prev[3])
                        self.counters.inc("device_wait_ms",
                                          (time.monotonic() - t0) * 1000.0)
                    mark, clean = self._mark_flush(mark, clean, n), True
                elif inflight is not None and not active and not reads:
                    self._process_batch(inflight)   # nothing more to step
                    self._depth.add(-inflight[3])
                    inflight = None
        except BaseException as e:     # device failure: fail everything
            self._die(e, "continuous batcher died")

    def _loop_async(self):
        """Device side of the async pipeline: admission and dispatch
        only.  Flushed chunks go to the host thread through the bounded
        `_ready` queue; the only wait on host progress is a full queue,
        counted as device wait."""
        try:
            reads = []
            mark, clean = time.monotonic(), False
            while not self._stop.is_set():
                self._apply_retirements()
                idle = (all(s is None for s in self._slots)
                        and not self._admissions and self._parked is None
                        and not reads and self._depth.value == 0)
                active, decode_only = self._step_round(reads, idle)
                clean = clean and decode_only
                if self._flush_due(len(reads), active):
                    n = len(reads)
                    chunk = self._flush(reads)
                    reads = []
                    t0, waited = time.monotonic(), False
                    while not self._stop.is_set():
                        try:
                            self._ready.put(chunk, timeout=0.05)
                            break
                        except queue_mod.Full:
                            # the host is behind: keep acks flowing (it
                            # may be blocked on a retirement)
                            waited = True
                            self._apply_retirements()
                    if waited:
                        self.counters.inc("device_wait_ms",
                                          (time.monotonic() - t0) * 1000.0)
                    mark, clean = self._mark_flush(mark, clean, n), True
                elif not active and not reads:
                    self._apply_retirements(timeout=0.002)
        except BaseException as e:     # device failure: fail everything
            self._die(e, "continuous batcher died")

    def _die(self, e, msg):
        """Terminal failure of either engine thread: record the cause,
        stop the other thread, fail every queued, in-flight,
        mid-admission and parked request, and release the waiters on
        device-thread acks."""
        logger.exception(msg)
        self._dead = e
        self._stop.set()
        self._fail_all(e)

    def _ack_retire_waiters(self):
        """Release every waiter on a device-thread ack once that thread
        is gone: their rows are already failed."""
        for q in (self._retire_q, self._ops_q):
            while True:
                try:
                    entry = q.get_nowait()
                except queue_mod.Empty:
                    break
                entry[-1].set()

    def _drain_pending(self, err):
        for q in (*self._classq.values(), self._longq):
            while q:
                q.popleft()["h"]._fail(err)
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
        self._sweep_park_pool(err)
        self._ack_retire_waiters()


class NotADecoderError(TypeError):
    """The export's builder rebuilds no decoder LM: :generate is
    unavailable on it (HTTP 404, as the JAX server answers)."""


def _load_lm(export_dir, quantize_mode, device):
    """An export's decoder LM ready to serve on ``device``: quantised by
    ``quantize_mode`` (int8 / int4) from its stored weights, its other
    floating leaves at the model's compute width.  A stored int8 export
    served with int8 keeps its stored bytes (no dequantise / requantise
    round trip); served otherwise it dequantises into its
    ``dequant_dtype`` first, as the JAX service does."""
    from tensorflowonspark_tpu_torch import export as export_mod
    from tensorflowonspark_tpu_torch.models.transformer import (
        Transformer, torch_dtype)

    model, spec = export_mod.load_model(
        export_dir, device=device, dequantize=quantize_mode != "int8")
    if not isinstance(model, Transformer):
        raise NotADecoderError(
            f"export builder rebuilds {type(model).__name__}, not a "
            "Transformer — :generate serves decoder LMs only")
    stored = quantize_mode == "int8" and spec.get("quantized") == "int8"
    if quantize_mode != "none" and not stored:
        # quantise the stored (f32 master) weights BEFORE the compute-width
        # cast, as the JAX service does: scales derive from the masters,
        # not from rounded copies
        quantize_mod.quantize_module(model, quantize_mode)
    # serving reads every weight once per token: keep the float leaves at
    # the model's compute width; quantisation scales stay f32
    model = quantize_mod.cast_float_leaves(model,
                                           torch_dtype(model.cfg)).eval()
    return model.requires_grad_(False)


class GenerateService:
    """Autoregressive generation over an exported decoder LM (the port's
    export or the JAX package's): loads it onto the device, optionally
    quantises its projections (``quantize_mode`` int8 / int4), stores
    the other floating leaves at the model's compute width and serves
    every request through one ContinuousBatcher (over an int8 kv cache
    with ``kv_dtype="int8"``).  ``draft_export_dir`` loads the
    speculative draft (quantised with the target); ``lora_adapters``
    ``{name: path}`` registers adapter files at start-up.  The host
    tier, priority, preemption and trace options pass to the batcher."""

    _I32 = 1 << 31

    def __init__(self, export_dir, max_new_tokens_limit=512, slots=8,
                 read_chunk=8, prefill_chunk=512, prefill_rows=4,
                 prefill_budget=0, request_timeout_s=None, kv_page_size=0,
                 kv_pages=0, kv_dtype="auto", engine="async",
                 pipeline_depth=2, long_prompt_threshold=0,
                 quantize_mode="none", draft_export_dir=None, draft_k=4,
                 spec_draft=None, lora_rank=0, lora_capacity=8,
                 lora_adapters=None, host_cache_mb=0, prio_weight=4,
                 preempt_ms=0.0, park_capacity=8,
                 trace_ring=trace.DEFAULT_RING,
                 trace_decode_sample=trace.DEFAULT_DECODE_SAMPLE,
                 device=None):
        if quantize_mode not in QUANTIZE_MODES:
            raise ValueError(f"quantize_mode={quantize_mode!r} not in "
                             f"{QUANTIZE_MODES}")
        self.device = device_mod.resolve(device)
        self.model = _load_lm(export_dir, quantize_mode, self.device)
        self.quantize_mode = quantize_mode
        self.weight_bytes = self.float_equivalent_bytes = 0
        if quantize_mode != "none":
            # sizes computed once here; metadata reads them per probe
            self.weight_bytes, self.float_equivalent_bytes = (
                quantize_mod.quantized_bytes(self.model))
        draft = None
        if draft_export_dir and spec_draft != "off":
            # the draft only proposes: its quantisation moves the
            # acceptance rate, never the tokens
            draft = _load_lm(draft_export_dir, quantize_mode, self.device)
        self.batcher = ContinuousBatcher(
            self.model, n_slots=slots or 8, read_chunk=read_chunk,
            prefill_chunk=prefill_chunk, prefill_rows=prefill_rows,
            prefill_budget=prefill_budget, kv_page_size=kv_page_size,
            kv_pages=kv_pages, kv_dtype=kv_dtype, engine=engine,
            pipeline_depth=pipeline_depth,
            long_prompt_threshold=long_prompt_threshold, draft_model=draft,
            draft_k=draft_k, spec_draft=spec_draft, lora_rank=lora_rank,
            lora_capacity=lora_capacity, host_cache_mb=host_cache_mb,
            prio_weight=prio_weight, preempt_ms=preempt_ms,
            park_capacity=park_capacity, trace_ring=trace_ring,
            trace_decode_sample=trace_decode_sample, device=self.device)
        try:
            from tensorflowonspark_tpu_torch import lora as lora_mod

            for name, path in (lora_adapters or {}).items():
                adapters, scale = lora_mod.load_adapters(path)
                self.batcher.register_adapter(name, adapters, scale=scale)
        except BaseException:
            # the engine threads already run: a failed registration must
            # not leak them behind the error
            self.batcher.stop()
            raise
        self.limit = max_new_tokens_limit
        self.timeout_s = request_timeout_s or max(
            600.0, 2.0 * max_new_tokens_limit)
        self._auto_seed = iter(range(1 << 20, 1 << 31))
        self._seed_lock = threading.Lock()
        # Idempotency-Key: the live session of each key, and when keys
        # finished (kept _idem_ttl_s)
        self._idem_lock = threading.Lock()
        self._idem_live = {}
        self._idem_done = {}
        self._idem_ttl_s = 120.0
        self.requests = 0

    def _validate(self, req):
        inputs = req.get("inputs")
        vocab = self.model.cfg.vocab_size
        if (not isinstance(inputs, list) or not inputs
                or not all(isinstance(p, list) and p
                           and all(_is_int(t) and 0 <= t < vocab
                                   for t in p) for p in inputs)):
            raise ValueError('"inputs" must be a non-empty list of non-empty '
                             f"lists of token ids in [0, {vocab})")
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
        adapter = req.get("adapter")
        if adapter is not None and not isinstance(adapter, str):
            raise ValueError('"adapter" must be a registered adapter name '
                             "(string)")
        stop = req.get("stop")
        if stop is not None and (
                not isinstance(stop, list) or len(stop) > 16
                or not all(isinstance(st, list) and st and len(st) <= 32
                           and all(_is_int(t) and -self._I32 <= t < self._I32
                                   for t in st) for st in stop)):
            raise ValueError('"stop" must be a list (<= 16) of non-empty '
                             "token-id lists (<= 32 tokens each)")
        rep = req.get("repetition_penalty", 1.0)
        if not (isinstance(rep, (int, float)) and not isinstance(rep, bool)
                and 0 < rep <= 1e6):
            raise ValueError('"repetition_penalty" must be a number in '
                             "(0, 1e6] (1.0 disables)")
        priority = req.get("priority")
        if priority is not None and priority not in PRIORITY_CLASSES:
            raise ValueError(
                f'"priority" must be one of {list(PRIORITY_CLASSES)}')
        trace_id = req.get("trace")
        if trace_id is not None and not trace.valid_id(trace_id):
            raise ValueError(
                '"trace" must be a hex (dashes allowed) trace id of at '
                f"most {trace.MAX_ID_LEN} chars")
        kw = dict(temperature=temperature, eos_id=eos_id, top_k=top_k,
                  top_p=top_p, min_p=min_p, adapter=adapter, stop=stop,
                  repetition_penalty=float(rep), priority=priority,
                  trace_id=trace_id)
        return inputs, max_new, seed, kw

    def _idem_claim(self, key, h):
        """Register `h` as the live session of Idempotency-Key `key`,
        cancelling an earlier live session under the same key: its
        consumer is gone (a re-driven stream), and decoding it on would
        generate twice."""
        if key is None:
            return
        with self._idem_lock:
            now = time.monotonic()
            for k in [k for k, t in self._idem_done.items()
                      if now - t > self._idem_ttl_s]:
                del self._idem_done[k]
            prior = self._idem_live.get(key)
            if prior is not None and prior is not h:
                self.batcher.counters.inc("idempotency_cancels")
                prior.cancel()
            if key in self._idem_done:
                self.batcher.counters.inc("idempotency_reruns")
            self._idem_live[key] = h

    def _idem_finish(self, key, h):
        """The stream is over: retire the live entry (if still ours) and
        remember the key as recently finished."""
        if key is None:
            return
        with self._idem_lock:
            if self._idem_live.get(key) is h:
                del self._idem_live[key]
            self._idem_done[key] = time.monotonic()

    def _prompt_seeds(self, n, seed, temperature):
        """Explicit seed s -> s, s+1, ...; unseeded sampling -> a fresh
        seed per prompt; greedy -> 0."""
        if seed is not None:
            return [seed + i for i in range(n)]
        if temperature > 0:
            with self._seed_lock:
                return [next(self._auto_seed) for _ in range(n)]
        return [0] * n

    def stream(self, req, on_handle=None, idem_key=None, kv_peer=None):
        """Events of a one-prompt generation: ``{"token": t}`` per decoded
        token, then ``{"done": true, "output": [...]}`` (with the trace's
        summary under ``"trace"`` for a traced request).  The request is
        validated and submitted before the first event, so a malformed
        one raises before any byte is sent.  ``on_handle`` (the
        disaggregation hook) gets the submitted handle first; ``kv_peer``
        (``host:port``) prefetches the prompt's prefix pages from a
        peer's host tier."""
        inputs, max_new, seed, kw = self._validate(req)
        if len(inputs) != 1:
            raise ValueError('"stream": true serves exactly one prompt per '
                             "request")
        if kv_peer:
            self.batcher.prefetch_prefix(kv_peer, inputs[0],
                                         trace_id=kw["trace_id"])
        seed = self._prompt_seeds(1, seed, kw["temperature"])[0]
        h = self.batcher.submit(inputs[0], max_new, seed=seed, **kw)
        self._idem_claim(idem_key, h)
        self.requests += 1
        if on_handle is not None:
            try:
                on_handle(h)
            except Exception:
                logger.warning("stream on_handle hook failed", exc_info=True)
        trace_id = kw["trace_id"]

        def events():
            try:
                while True:
                    batch = h.tokens.get(timeout=self.timeout_s)
                    if batch is None:
                        break
                    for tok in batch:       # one batch per host tick
                        yield {"token": tok}
                done = {"done": True, "output": h.result(timeout=0)}
                if trace_id:
                    # the summary rides the final event only: the token
                    # events equal an untraced stream's
                    summ = self.batcher.trace.summary(trace_id)
                    if summ is not None:
                        done["trace"] = summ
                yield done
            finally:
                # consumer gone or done: free the slot instead of decoding
                # to max_new for nobody
                h.cancel()
                self._idem_finish(idem_key, h)

        return events()

    def generate(self, req, kv_peer=None, idem_key=None):
        inputs, max_new, seed, kw = self._validate(req)
        if kv_peer:
            for p in inputs:
                self.batcher.prefetch_prefix(kv_peer, p,
                                             trace_id=kw["trace_id"])
        seeds = self._prompt_seeds(len(inputs), seed, kw["temperature"])
        handles, claims = [], []
        try:
            for i, (p, s) in enumerate(zip(inputs, seeds)):
                h = self.batcher.submit(p, max_new, seed=s, **kw)
                handles.append(h)
                if idem_key is not None:
                    # a duplicate dispatch under the same key cancels its
                    # orphaned twin instead of generating twice
                    k = idem_key if len(inputs) == 1 else f"{idem_key}/{i}"
                    self._idem_claim(k, h)
                    claims.append((k, h))
            outs = [h.result(timeout=self.timeout_s) for h in handles]
        except Exception:
            # a failed request must not leave its other prompts decoding
            for h in handles:
                h.cancel()
            raise
        finally:
            for k, h in claims:
                self._idem_finish(k, h)
        self.requests += 1
        return outs

    def resume(self, req, idem_key=None):
        """``POST :resume``: go on with a session that left its replica.
        With ``meta`` + ``pull`` (a migration) the kv snapshot is pulled
        from the source's page server and installed without prefill;
        with ``replay`` (recovery) the journaled token record prefills
        here.  Either way the FIRST event, ``{"resumed": true}``, is the
        ack the caller keys off.  Validation and the pull run before any
        response byte, so a bad snapshot gets a 400."""
        from tensorflowonspark_tpu_torch import kvtransfer

        replay = req.get("replay")
        if replay is not None:
            if not isinstance(replay, dict):
                raise ValueError('":resume" "replay" must be a meta object')
            h, installed = self.batcher.submit_replay(replay)
            self._idem_claim(idem_key, h)
            self.requests += 1
            return self._resume_events(h, installed, idem_key)
        meta, pull = req.get("meta"), req.get("pull")
        if not isinstance(meta, dict) or not isinstance(pull, dict):
            raise ValueError(':resume needs "meta" and "pull" objects (or '
                             '"replay")')
        if (not pull.get("host") or not _is_int(pull.get("port"))
                or not pull.get("ticket")):
            raise ValueError('"pull" must carry host, port and ticket')
        _, blocks = kvtransfer.pull_snapshot(
            (str(pull["host"]), int(pull["port"])), str(pull["ticket"]),
            timeout=min(60.0, self.timeout_s or 60.0))
        # the HTTP meta is canonical; the pulled copy comes from the same
        # frozen record
        h, installed = self.batcher.submit_resume(meta, blocks)
        self.requests += 1
        return self._resume_events(h, installed, None)

    def _resume_events(self, h, installed, idem_key):
        def resume_events():
            try:
                deadline = time.monotonic() + min(60.0,
                                                  self.timeout_s or 60.0)
                while not installed.wait(0.1):
                    if h._done.is_set():
                        # failed or cancelled before the row went live
                        try:
                            h.result(timeout=0)
                            yield {"error": "resume admission ended before "
                                            "install"}
                        except Exception as e:
                            yield {"error": f"{type(e).__name__}: {e}"}
                        return
                    if time.monotonic() >= deadline:
                        h.cancel()
                        yield {"error": "resume install timed out"}
                        return
                yield {"resumed": True}   # the splice ack: the source
                # frees its copy of the pages on reading it
                while True:
                    batch = h.tokens.get()
                    if batch is None:
                        break
                    for tok in batch:
                        yield {"token": tok}
                yield {"done": True, "output": h.result()}
            finally:
                h.cancel()
                self._idem_finish(idem_key, h)

        return resume_events()

    def close(self):
        self.batcher.stop()


class PredictUnavailableError(RuntimeError):
    """The export holds no :predict signature to serve (HTTP 404)."""


def _instances_to_columns(instances, input_names=None):
    """[{feature: value}, ...] -> ({feature: [values]}, n).

    Also accepts TF Serving's bare row format ([[...], [...]] or scalars)
    when the model has exactly one input: the values map onto that input.
    """
    if not isinstance(instances, list) or not instances:
        raise ValueError('"instances" must be a non-empty list')
    first = instances[0]
    if not isinstance(first, dict):
        if input_names is not None and len(input_names) == 1:
            return {input_names[0]: list(instances)}, len(instances)
        raise ValueError(
            "each instance must be a {feature: value} object (bare rows are "
            "only accepted for single-input models)")
    cols = {k: [] for k in first}
    for i, inst in enumerate(instances):
        if not isinstance(inst, dict) or set(inst) != set(cols):
            got = sorted(inst) if isinstance(inst, dict) else inst
            raise ValueError(f"instance {i} features {got} differ from "
                             f"instance 0 {sorted(cols)}")
        for k, v in inst.items():
            cols[k].append(v)
    return cols, len(instances)


def _rows_from_outputs(outputs, n):
    """{out_col: array-like [n, ...]} -> [{out_col: value}, ...]."""
    listed = {name: np.asarray(col).tolist() for name, col in outputs.items()}
    return [{name: listed[name][i] for name in listed} for i in range(n)]


class _MicroBatcher:
    """Coalesce concurrent :predict calls into one device execution — the
    TF-Serving request-batching analog of the JAX server.  The first
    request opens a window of ``wait_ms``; requests arriving within it
    are merged (up to ``max_batch`` rows) into one columnar execution,
    and each caller's future receives exactly its row slice.  A
    malformed request fails alone, a predictor failure fails only its
    own window, and the thread never dies (``close`` ends it)."""

    def __init__(self, predict_cols, wait_ms=5.0, max_batch=256):
        self._predict = predict_cols
        self._wait_s = wait_ms / 1e3
        self._max = max_batch
        self._q = queue_mod.Queue()
        self.executions = 0
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-batcher", daemon=True)
        self._thread.start()

    def submit(self, cols, n):
        import concurrent.futures as cf

        fut = cf.Future()
        self._q.put((cols, n, fut))
        return fut.result()

    def close(self, timeout=10.0):
        self._q.put(None)
        self._thread.join(timeout)

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            batch, total = [item], item[1]
            deadline = time.monotonic() + self._wait_s
            while total < self._max:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue_mod.Empty:
                    break
                if item is None:        # close: serve this window first
                    self._q.put(None)
                    break
                batch.append(item)
                total += item[1]
            # per-request validation BEFORE merging: a malformed request
            # fails alone instead of poisoning every future of its window
            head_keys = set(batch[0][0])
            good = []
            for cols, n, fut in batch:
                if set(cols) != head_keys:
                    fut.set_exception(ValueError(
                        f"request features {sorted(cols)} differ from "
                        f"batch head {sorted(head_keys)}"))
                else:
                    good.append((cols, n, fut))
            if not good:
                continue
            try:
                merged = {k: [] for k in head_keys}
                for cols, _, _ in good:
                    for k, v in cols.items():
                        merged[k].extend(v)
                outputs = self._predict(merged, sum(n for _, n, _ in good))
                self.executions += 1
                arrays = {k: np.asarray(v) for k, v in outputs.items()}
                off = 0
                for _, n, fut in good:
                    fut.set_result(
                        {k: a[off:off + n] for k, a in arrays.items()})
                    off += n
            except Exception as e:
                # result distribution included: any escape here would kill
                # the thread and wedge every later submit
                for _, _, fut in good:
                    if not fut.done():
                        fut.set_exception(e)


class ModelService:
    """The served model: resolves the device at construction (raising
    without CUDA unless the CPU was asked for), reads and checks the
    :predict signature (or the artifact's spec) and loads its weights at
    the first :predict, and builds the GenerateService lazily on the
    first :generate (an LM replica holds its weights once); its
    migration engine (page server, relays), the drain fence, the
    profiler and the scrape surface.

    ``--batch_wait_ms`` > 0 coalesces concurrent :predict requests into
    one device execution (`_MicroBatcher`); at 0 a lock serialises the
    executions."""

    def __init__(self, args):
        from tensorflowonspark_tpu_torch import export, fsio, inference

        self.args = args
        self.device = device_mod.resolve(getattr(args, "device", None))
        self.export_dir = args.export_dir
        self.model_name = getattr(args, "model_name", "default")
        self.role = getattr(args, "role", None) or "mixed"
        self.requests = 0                # :predict requests served
        self._predict_rows, self._predict_error = None, None
        spec_path = fsio.join(self.export_dir, export.MODEL_SPEC)
        if fsio.exists(spec_path):
            self._predict_rows, self.desc = inference._load_predictor(
                args, lazy=True)
        else:
            # no export spec here: :predict answers 404 with the reason
            self.desc = f"none(device={self.device})"
            self._predict_error = f"no export spec {spec_path}"
        self._lock = threading.Lock()    # one device: serialise :predict
        self._batcher = None
        wait_ms = getattr(args, "batch_wait_ms", 0.0) or 0.0
        if wait_ms > 0 and self._predict_rows is not None:
            self._batcher = _MicroBatcher(
                self._predict_rows, wait_ms=wait_ms,
                max_batch=getattr(args, "batch_size", 64) or 64)
        self._profile_lock = threading.Lock()   # one capture at a time
        self._lora = {}
        for spec in (getattr(args, "generate_lora", None) or []):
            name, sep, path = spec.partition("=")
            if not sep or not name or not path:
                raise ValueError(f"--generate_lora {spec!r} must be "
                                 "NAME=PATH")
            self._lora[name] = path
        self._bind_host = getattr(args, "host", "127.0.0.1")
        self._advertise_host = getattr(args, "advertise_host", None)
        self._gen = None
        self._gen_error = None      # why :generate is unavailable here
        self._gen_lock = threading.Lock()
        self._migrator = None
        self._draining = threading.Event()

    def predict(self, instances):
        """``POST :predict``: ``instances`` (feature objects, or bare rows
        for a single-input model) -> one prediction object a row."""
        if self._predict_rows is None:
            raise PredictUnavailableError(self._predict_error)
        cols, n = _instances_to_columns(
            instances, getattr(self._predict_rows, "input_names", None))
        if self._batcher is not None:
            outputs = self._batcher.submit(cols, n)
            with self._lock:
                self.requests += 1
            return _rows_from_outputs(outputs, n)
        with self._lock:   # one device: serialise executions
            outputs = self._predict_rows(cols, n)
            self.requests += 1
        return _rows_from_outputs(outputs, n)

    def debug_profile(self, body):
        """``POST /v1/debug:profile``: a time-bounded ``torch.profiler``
        capture (`utils.profiling.trace`) while serving goes on; returns
        ``(status, payload)``: 200 with the trace file (``artifact``) and
        ``duration_ms``, 409 while another capture holds the profiler,
        503 when the profiler itself raises.  ``duration_ms`` must lie in
        (0, 10000] and ``dir`` be a string (ValueError -> 400)."""
        from tensorflowonspark_tpu_torch.utils import profiling

        dur = body.get("duration_ms", 500)
        if (not isinstance(dur, (int, float)) or isinstance(dur, bool)
                or not 0 < dur <= 10000):
            raise ValueError('"duration_ms" must be a number in '
                             "(0, 10000]")
        out_dir = body.get("dir")
        if out_dir is not None and not isinstance(out_dir, str):
            raise ValueError('"dir" must be a string path')
        if not self._profile_lock.acquire(blocking=False):
            return 409, {"error": "a profile capture is already running"}
        try:
            if out_dir is None:
                import tempfile

                out_dir = tempfile.mkdtemp(prefix="torch-profile-")
            try:
                with profiling.trace(out_dir):
                    time.sleep(float(dur) / 1000.0)
            except Exception as e:
                logger.warning("profiler capture failed: %s", e)
                return 503, {"error": "profiler unavailable: "
                             f"{type(e).__name__}: {e}"}
            return 200, {"artifact": os.path.join(out_dir,
                                                  profiling.TRACE_FILE),
                         "duration_ms": float(dur)}
        finally:
            self._profile_lock.release()

    def generate_service(self):
        """The lazily built GenerateService, or None when the export's
        builder rebuilds no decoder LM (probed once)."""
        with self._gen_lock:
            if self._gen is None and self._gen_error is None:
                try:
                    self._gen = self._build_generate(self.args)
                except NotADecoderError as e:
                    logger.info(":generate unavailable: %s", e)
                    self._gen_error = str(e)
            return self._gen

    def _build_generate(self, a):
        return GenerateService(
            self.export_dir,
            max_new_tokens_limit=a.max_new_tokens_limit,
            slots=a.generate_slots, read_chunk=a.generate_read_chunk,
            prefill_chunk=a.generate_prefill_chunk,
            prefill_rows=a.generate_prefill_rows,
            prefill_budget=a.generate_prefill_budget,
            request_timeout_s=a.generate_timeout_s,
            kv_page_size=a.generate_kv_page_size,
            kv_pages=a.generate_kv_pages,
            kv_dtype=a.generate_kv_dtype,
            engine=a.generate_engine,
            pipeline_depth=a.generate_pipeline_depth,
            long_prompt_threshold=a.generate_long_prompt_threshold,
            quantize_mode=a.generate_quantize,
            draft_export_dir=a.draft_export_dir, draft_k=a.draft_k,
            spec_draft=a.spec_draft,
            lora_rank=a.generate_lora_rank,
            lora_capacity=a.generate_lora_capacity,
            lora_adapters=self._lora,
            host_cache_mb=a.generate_host_cache_mb,
            prio_weight=a.generate_priority_weight,
            preempt_ms=a.generate_preempt_ms,
            park_capacity=a.generate_park_capacity,
            trace_ring=a.generate_trace_ring,
            trace_decode_sample=a.generate_trace_decode_sample,
            device=self.device)

    def migration_engine(self):
        """The lazily built kvtransfer.MigrationEngine of this replica
        (its page server binds on first use)."""
        gen = self.generate_service()
        with self._gen_lock:
            if self._migrator is None:
                from tensorflowonspark_tpu_torch import kvtransfer

                host = self._bind_host
                if host in ("", "0.0.0.0", "::"):
                    host = "0.0.0.0"
                self._migrator = kvtransfer.MigrationEngine(
                    gen.batcher, model_name=self.model_name, host=host,
                    advertise_host=(self._advertise_host
                                    or ("127.0.0.1" if host == "0.0.0.0"
                                        else host)),
                    # kv:prefix pulls read the batcher's host tier (an
                    # empty answer when the tier is off or cold)
                    prefix_provider=gen.batcher.host_prefix_provider)
            return self._migrator

    def kv_export(self, body):
        """``POST /v1/kv:export``: move live sessions to the given
        replica(s).  Body: ``{"dest": {"host", "port"}}`` or ``{"dests":
        [...]}``, optional ``timeout_s`` / ``max_sessions``."""
        raw = body.get("dests") or ([body["dest"]] if body.get("dest")
                                    else [])
        dests = []
        for d in raw:
            if (not isinstance(d, dict) or not d.get("host")
                    or not _is_int(d.get("port"))):
                raise ValueError(
                    '"dest(s)" entries must be {"host": ..., "port": ...}')
            dests.append((str(d["host"]), int(d["port"])))
        if not dests:
            raise ValueError('kv:export needs "dest" or "dests"')
        timeout_s = body.get("timeout_s")
        if timeout_s is not None and not (
                isinstance(timeout_s, (int, float))
                and not isinstance(timeout_s, bool) and timeout_s > 0):
            raise ValueError('"timeout_s" must be a positive number')
        max_sessions = body.get("max_sessions")
        if max_sessions is not None and not _is_int(max_sessions):
            raise ValueError('"max_sessions" must be an int')
        return self.migration_engine().migrate_all(
            dests, max_sessions=max_sessions, timeout_s=timeout_s)

    def auto_migrate_hook(self, dest_spec):
        """The per-request handoff of ``X-Fleet-Migrate-To: host:port``
        (planted by the gateway on a prefill-role replica): the session
        migrates to the named decode replica as soon as its first decode
        tokens commit.  None (logged) for a malformed spec: the session
        stays here."""
        host, _, port = str(dest_spec).rpartition(":")
        if not host or not port.isdigit():
            logger.warning("ignoring malformed X-Fleet-Migrate-To %r",
                           dest_spec)
            return None
        eng = self.migration_engine()

        def kick(handle):
            eng.migrate_async(handle, (host, int(port)))
        return kick

    @property
    def draining(self):
        return self._draining.is_set()

    def begin_drain(self):
        """Fence admissions: :generate answers 503 (with Retry-After) and
        /readyz 503, while sessions in flight decode to completion."""
        self._draining.set()

    def drain(self, timeout_s=60.0, poll_s=0.05):
        """``POST /v1/fleet:drain``: fence admissions, then wait until the
        engine is idle (no busy slots, nothing queued, admitting or
        parked).  Returns ``{"drained": bool, "waited_s": s, ...}``."""
        self.begin_drain()
        t0 = time.monotonic()
        deadline = t0 + float(timeout_s)
        with self._gen_lock:
            gen = self._gen      # never build an engine just to watch it
        pending = 0
        while gen is not None:
            st = gen.batcher.stats()
            pending = (st["slots_busy"] + st["pending"]
                       + int(st["admitting"]) + int(st["parked_sessions"]))
            if pending == 0 or time.monotonic() >= deadline:
                break
            time.sleep(poll_s)
        return {"drained": pending == 0, "draining": True,
                "in_flight": pending,
                "waited_s": round(time.monotonic() - t0, 3)}

    def metadata(self):
        out = {"model": {"export_dir": self.export_dir, "engine": self.desc,
                         "device": str(self.device), "role": self.role,
                         "requests_served": self.requests},
               "status": "draining" if self.draining else "ok"}
        if self._batcher is not None:
            out["model"]["batched_executions"] = self._batcher.executions
        with self._gen_lock:
            gen = self._gen
        if gen is not None:
            out["model"]["generate"] = "available"
            out["model"]["requests_served"] += gen.requests
            out["model"]["generate_slots"] = gen.batcher.n_slots
            out["model"]["generate_stats"] = gen.batcher.stats()
            if gen.quantize_mode != "none":
                out["model"]["generate_quantize"] = {
                    "mode": gen.quantize_mode,
                    "weight_bytes": gen.weight_bytes,
                    "float_equivalent_bytes": gen.float_equivalent_bytes}
        out["model"]["kernel_launches"] = ops.launch_counts(
            ops.SERVING_KERNELS if gen is None else gen.batcher.kernels)
        return out

    def metrics_text(self):
        """``GET /metrics``: Prometheus text generated from the same
        ``stats()`` the metadata reports (every counter, gauge and
        latency window, histograms as triplets).  Never builds the
        :generate engine."""
        from tensorflowonspark_tpu_torch import metrics

        groups = [("replica", None, {"draining": self.draining})]
        with self._gen_lock:
            gen = self._gen
        if gen is not None:
            groups[0][2]["http_requests"] = gen.requests
            stats = dict(gen.batcher.stats())
            stats.pop("kernel_launches", None)
            groups.append(("replica", None, stats))
            groups.append(("kernel", None, {
                f"{k}_launches": v
                for k, v in ops.launch_counts(gen.batcher.kernels).items()}))
        return metrics.prometheus_text(groups)

    def trace_spans(self, trace_id):
        """``GET /v1/trace/<id>``: this replica's retained spans of a
        trace (empty when :generate never ran here)."""
        with self._gen_lock:
            gen = self._gen
        return [] if gen is None else gen.batcher.trace.spans(trace_id)

    def close(self):
        if self._batcher is not None:
            self._batcher.close()
        with self._gen_lock:
            gen, self._gen = self._gen, None
            migrator, self._migrator = self._migrator, None
        if migrator is not None:
            try:
                migrator.close()
            except Exception:
                logger.warning("migration engine close failed",
                               exc_info=True)
        if gen is not None:
            gen.close()


class _Handler(BaseHTTPRequestHandler):
    service = None   # injected by make_server
    protocol_version = "HTTP/1.1"

    def _send(self, code, payload, headers=()):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code, text):
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    @staticmethod
    def _json(raw):
        body = json.loads(raw or b"{}")
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        return body

    def do_GET(self):
        name = self.service.model_name
        path = self.path.rstrip("/") or "/"
        if path == "/healthz":
            self._send(200, {"status": "ok"})      # liveness
        elif path == "/readyz":
            # readiness: a draining replica takes no new work
            if self.service.draining:
                self._send(503, {"status": "draining"},
                           headers=[("Retry-After", "1")])
            else:
                self._send(200, {"status": "ok"})
        elif path in ("/metrics", "/v1/metrics"):
            # an injected trace.export fault fails the SCRAPE only
            try:
                faults.check("trace.export")
                text = self.service.metrics_text()
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send_text(200, text)
        elif path.startswith("/v1/trace/"):
            tid = path[len("/v1/trace/"):]
            if not trace.valid_id(tid):
                self._send(400, {"error": "malformed trace id"})
                return
            try:
                faults.check("trace.export")
                spans = self.service.trace_spans(tid)
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send(200, {"id": tid, "spans": spans})
        elif path == "/" or path == f"/v1/models/{name}":
            self._send(200, self.service.metadata())
        else:
            self._send(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        name = self.service.model_name
        path = self.path.rstrip("/")
        length = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(length) if length else b""
        if path == "/v1/fleet:drain":
            self._send(200, self.service.drain())
            return
        if path == "/v1/kv:export":
            # not fenced on draining: a draining replica is the one that
            # exports its sessions
            try:
                self._send(200, self.service.kv_export(self._json(raw)))
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                logger.exception("kv:export failed")
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
            return
        if path == "/v1/debug:profile":
            # a time-bounded torch.profiler capture: the "why is the card
            # idle" layer under device_idle_fraction.  Not fenced on
            # draining: a misbehaving replica is the one worth profiling
            try:
                self._send(*self.service.debug_profile(self._json(raw)))
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                logger.exception("debug:profile failed")
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
            return
        is_predict = self.path == f"/v1/models/{name}:predict"
        is_generate = self.path == f"/v1/models/{name}:generate"
        is_resume = self.path == f"/v1/models/{name}:resume"
        if not (is_predict or is_generate or is_resume):
            self._send(404, {"error": f"unknown path {self.path} (serving "
                             f"model {name!r})"})
            return
        if self.service.draining:
            self._send(503, {"error": "replica is draining",
                             "type": "draining"},
                       headers=[("Retry-After", "1")])
            return
        if is_predict:
            self._predict(raw)
            return
        try:
            req = self._json(raw)
            gen = self.service.generate_service()
            if gen is None:
                self._send(404, {"error": ":generate unavailable: "
                                 + self.service._gen_error})
                return
            idem_key = self.headers.get("Idempotency-Key")
            if is_resume:
                # always streams: the first event is the splice ack
                self._stream_events(gen.resume(req, idem_key=idem_key))
                return
            prio = self.headers.get("X-Priority")
            if prio and "priority" not in req:
                req["priority"] = prio   # validated like the body field
            tid = self.headers.get("X-Trace-Id")
            if tid and "trace" not in req:
                req["trace"] = tid
            kv_peer = self.headers.get("X-Fleet-KV-Peer")
            if req.get("stream"):
                on_handle = None
                migrate_to = self.headers.get("X-Fleet-Migrate-To")
                if migrate_to:
                    # this replica prefills, the named replica decodes
                    on_handle = self.service.auto_migrate_hook(migrate_to)
                self._stream_events(gen.stream(
                    req, on_handle=on_handle, idem_key=idem_key,
                    kv_peer=kv_peer))
            else:
                self._send(200, {"outputs": gen.generate(
                    req, kv_peer=kv_peer, idem_key=idem_key)})
        except NotImplementedError as e:
            self._send(501, {"error": str(e), "type": "not_ported"})
        except (ValueError, KeyError, TypeError) as e:
            self._send(400, {"error": str(e) or type(e).__name__})
        except KVOverflowError as e:
            # well-formed, but this replica's kv pool cannot hold it:
            # retryable elsewhere
            self._send(503, {"error": str(e), "type": "kv_overflow"})
        except Exception as e:   # keep the server alive on model errors
            logger.exception("generate failed")
            self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def _predict(self, raw):
        try:
            preds = self.service.predict(self._json(raw).get("instances"))
        except PredictUnavailableError as e:
            # the export has no :predict signature to serve
            self._send(404, {"error": f":predict unavailable: {e}"})
            return
        except (ValueError, KeyError, TypeError, AttributeError) as e:
            # malformed client input in any shape
            self._send(400, {"error": str(e) or type(e).__name__})
            return
        except Exception as e:   # keep the server alive on model errors
            logger.exception("predict failed")
            self._send(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._send(200, {"predictions": preds})

    def _stream_events(self, events):
        """Newline-delimited JSON events in chunked framing, one chunk per
        event, so clients see tokens as they decode."""
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(data):
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        try:
            for ev in events:
                chunk(json.dumps(ev).encode() + b"\n")
        except Exception as e:   # mid-stream: an error event, a clean end
            logger.exception("stream failed")
            try:
                chunk(json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}).encode() + b"\n")
            except OSError:
                pass
        finally:
            events.close()
        try:
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            pass

    def log_message(self, fmt, *args):
        logger.debug("http: " + fmt, *args)


def make_server(args):
    """Build (server, service); the caller runs serve_forever().  Flags
    whose feature is not ported raise NotImplementedError; the device is
    resolved here, so a missing CUDA device raises before serving."""
    for flag, _, refused in _READ_PATH_FLAGS:
        if getattr(args, flag, None) == refused:
            raise NotImplementedError(f"--{flag}={refused!r} is refused: "
                                      f"{_NO_SWITCH}")
    if getattr(args, "batch_size", 64) < 1:
        raise ValueError("--batch_size must be >= 1")
    if getattr(args, "batch_wait_ms", 0.0) < 0:
        raise ValueError("--batch_wait_ms must be >= 0 (0 disables "
                         "micro-batching)")
    if getattr(args, "generate_slots", 8) < 1:
        raise ValueError("--generate_slots must be >= 1")
    paged = getattr(args, "generate_kv_page_size", 0) > 0
    if paged and getattr(args, "generate_kv_pages", 0) < 1:
        raise ValueError("--generate_kv_page_size needs "
                         "--generate_kv_pages >= 1 (the shared pool size)")
    if getattr(args, "generate_long_prompt_threshold", 0) > 0 and not paged:
        raise ValueError("--generate_long_prompt_threshold needs the paged "
                         "kv cache (--generate_kv_page_size): the lane maps "
                         "pages chunk by chunk")
    if getattr(args, "generate_host_cache_mb", 0) < 0:
        raise ValueError("--generate_host_cache_mb must be >= 0 (0 disables "
                         "the host page tier)")
    if getattr(args, "generate_host_cache_mb", 0) and not paged:
        raise ValueError("--generate_host_cache_mb needs "
                         "--generate_kv_page_size > 0 (the host tier holds "
                         "demoted pages of the paged kv cache)")
    if getattr(args, "generate_prefill_rows", 4) < 1:
        raise ValueError("--generate_prefill_rows must be >= 1")
    if getattr(args, "generate_prefill_budget", 0) < 0:
        raise ValueError("--generate_prefill_budget must be >= 0")
    if getattr(args, "generate_lora", None) and \
            not getattr(args, "generate_lora_rank", 0):
        raise ValueError("--generate_lora needs --generate_lora_rank > 0 "
                         "(the bank's adapter rank)")
    spec, draft_dir = (getattr(args, "spec_draft", None),
                       getattr(args, "draft_export_dir", None))
    if spec == "model" and not draft_dir:
        raise ValueError("--spec_draft model needs --draft_export_dir (the "
                         "draft LM to propose with); use --spec_draft ngram "
                         "for model-free speculation")
    if spec == "ngram" and draft_dir:
        raise ValueError("--spec_draft ngram is model-free — drop "
                         "--draft_export_dir (or pick --spec_draft model)")
    if (spec in ("model", "ngram") or draft_dir) and spec != "off" and \
            getattr(args, "draft_k", 4) < 1:
        raise ValueError("--draft_k must be >= 1")
    model_draft = bool(draft_dir) and spec in (None, "model")
    if getattr(args, "role", "mixed") not in ("mixed", "prefill", "decode"):
        raise ValueError("--role must be 'mixed', 'prefill' or 'decode'")
    if getattr(args, "role", "mixed") != "mixed" and model_draft:
        raise ValueError("--role prefill/decode does not compose with "
                         "--draft_export_dir (kv migration cannot ship the "
                         "draft model's cache); --spec_draft ngram keeps no "
                         "draft cache and composes")
    if getattr(args, "generate_priority_weight", 4) < 1:
        raise ValueError("--generate_priority_weight must be >= 1 "
                         "(interactive admissions per batch admission)")
    if getattr(args, "generate_preempt_ms", 0.0) < 0:
        raise ValueError("--generate_preempt_ms must be >= 0 (0 disables "
                         "the preemption controller)")
    if getattr(args, "generate_preempt_ms", 0.0) and model_draft:
        raise ValueError("--generate_preempt_ms does not compose with "
                         "--draft_export_dir (freeze_session cannot cut a "
                         "row through the draft cache); --spec_draft ngram "
                         "composes")
    if getattr(args, "generate_park_capacity", 8) < 1:
        raise ValueError("--generate_park_capacity must be >= 1 (the "
                         "preemption controller's park pool bound)")
    service = ModelService(args)
    handler = type("BoundHandler", (_Handler,), {"service": service})

    class _Server(ThreadingHTTPServer):
        daemon_threads = True

        def handle_error(self, request, client_address):
            # a relay that read its stream's last event closes without the
            # chunked terminator: a reset, not a fault
            if isinstance(sys.exc_info()[1], ConnectionError):
                logger.debug("client %s went away", client_address)
                return
            super().handle_error(request, client_address)

        def server_close(self):
            super().server_close()
            service.close()

    return _Server((args.host, args.port), handler), service


def _register_with_fleet(args, server, service=None):
    """Join the fleet gateway named by ``--fleet HOST:PORT``: REG this
    replica's advertised endpoint and capacity over the reservation
    plane and start the liveness heartbeat (the JAX server's
    ``_register_with_fleet``, its ``features`` key for key).  Returns the
    live registration; the caller ``deregister()``s it at shutdown so
    the gateway drops the replica at once instead of waiting out the
    heartbeat window."""
    from tensorflowonspark_tpu_torch import fleet_client

    ghost, _, gport = args.fleet.rpartition(":")
    if not ghost or not gport.isdigit():
        raise ValueError(f"--fleet must be HOST:PORT, got {args.fleet!r}")
    features = {}
    if getattr(args, "generate_kv_page_size", 0):
        # the gateway sizes its :generate prefix-affinity hash off this,
        # aligning routing keys with the replica prefix-cache page unit
        features["kv_page_size"] = args.generate_kv_page_size
        features["kv_pages"] = args.generate_kv_pages
        # the port's paged reads are always its CUDA kernels (the plain
        # XLA paths of the JAX server are not ported)
        features["paged_attn_impl"] = "kernel"
        features["paged_prefill_impl"] = "kernel"
    if getattr(args, "generate_host_cache_mb", 0) and \
            getattr(args, "generate_kv_page_size", 0):
        # the host tier's kv:prefix pull endpoint, so the gateway can
        # point spilled requests at this replica's tier (REG features
        # are static: the page server binds now)
        features["host_cache_mb"] = args.generate_host_cache_mb
        eng = service.migration_engine() if service is not None else None
        if eng is not None:
            features["kv_prefix_addr"] = eng.prefix_addr()
    if getattr(args, "generate_long_prompt_threshold", 0):
        # mega-prompt lane: the gateway routes prompts above this to the
        # lane-capable replica with the most kv headroom
        features["long_prompt_threshold"] = (
            args.generate_long_prompt_threshold)
    # speculation: the resolved draft mode, as ContinuousBatcher
    # resolves it (None: "model" with a draft export, else "off")
    spec = getattr(args, "spec_draft", None)
    if spec is None:
        spec = "model" if getattr(args, "draft_export_dir", None) else "off"
    if spec != "off":
        features["speculative"] = spec
        features["draft_k"] = getattr(args, "draft_k", 4)
    if getattr(args, "generate_quantize", "none") != "none":
        features["quantize"] = args.generate_quantize
    if getattr(args, "generate_lora_rank", 0):
        features["lora_rank"] = args.generate_lora_rank
    features["prefill_rows"] = getattr(args, "generate_prefill_rows",
                                       4) or 4
    features["engine"] = getattr(args, "generate_engine", "async") or "async"
    # disaggregation: the gateway routes :generate admissions by role and
    # plants the migrate-to header for prefill replicas
    features["role"] = getattr(args, "role", "mixed") or "mixed"
    if getattr(args, "generate_preempt_ms", 0.0):
        features["preempt_ms"] = args.generate_preempt_ms
    return fleet_client.register_replica(
        (ghost, int(gport)),
        getattr(args, "advertise_host", None) or args.host,
        server.server_address[1],
        model_name=getattr(args, "model_name", "default"),
        n_slots=getattr(args, "generate_slots", 8) or 8,
        features=features,
        heartbeat_interval_s=getattr(args, "fleet_heartbeat_s", 2.0))


def main(argv=None):
    args = build_argparser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s")
    server, service = make_server(args)
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port} ({service.desc})", flush=True)
    registration = None
    try:
        if getattr(args, "fleet", None):
            registration = _register_with_fleet(args, server, service)
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if registration is not None:
            registration.deregister()
        server.server_close()


if __name__ == "__main__":
    main()
