"""Offline bulk-inference jobs: the TFoS data pump reborn at fleet scale
— the port of ``tensorflowonspark_tpu/jobs.py`` (host code: imports no
torch; TFRecord inputs are indexed by the port's own :mod:`tfrecord`).

TensorFlowOnSpark's core trick was pumping RDD partitions through
long-lived workers (DataFeed / ``mapPartitions``, ``InputMode.SPARK``):
the cluster manager split the input into partitions and each executor
streamed its partition's records through a resident model.  The serving
fleet is the modern version of those long-lived workers, so this module
rebuilds the pump on top of it: ``POST /v1/jobs`` names an input file,
the gateway shards it into **byte-offset partition splits** (the same
FileSplit contract Hadoop/Spark text input uses), and a pool of
JobRunner threads streams each partition's records through the fleet as
**batch-class** requests under the WFQ scheduler — interactive traffic
always wins.

Exactly-once contract
---------------------
Every record has a stable identity ``job_id/partition/offset`` (the
byte offset of the record in the input file).  Two mechanisms compose
into exactly-once *output*:

- **Structural**: each partition appends result lines to its own spool
  file and checkpoints ``{next_offset, out_bytes, ...}`` with an atomic
  tmp-file + ``os.replace`` rename every ``checkpoint_every`` records.
  A partition that reruns (replica death mid-dispatch, gateway restart,
  worker crash) first truncates its spool file back to the last durable
  ``out_bytes`` and re-reads the input from ``next_offset`` — results
  that were never checkpointed are re-derived, results that were are
  never re-emitted.
- **Fleet-side**: the record identity rides the request as its
  ``Idempotency-Key``, so a duplicate dispatch (the runner timed out
  and retried while the first attempt was still decoding) cancels the
  orphaned twin on the replica instead of double-generating.

Sampled records are pinned to a per-record seed derived from the record
key, so a re-dispatch after a crash produces byte-identical output.

Checkpoint format (``<jobs_dir>/<job_id>/``)::

    job.json            immutable spec + splits + records_total + state
    parts/<p>.json      {"next_offset": O, "out_bytes": B,
                         "done_n": D, "failed_n": F, "done": bool}
    parts/<p>.out       result lines for partition p (jsonl)
    output.jsonl        the merged result, renamed into place on
                        completion (absent until then)

``job.json`` is rewritten (same atomic rename) only on state
transitions, so a gateway that dies mid-job leaves ``state: running``
on disk and the next gateway's ``--jobs_dir`` rescan resumes the job
from the partition checkpoints.

A terminal state and its counter (``jobs_completed``, ``jobs_failed``,
``jobs_cancelled``) are published together under the manager's lock,
and ``completed`` only once ``output.jsonl`` is in place: a reader that
sees the state sees the count and the file.  (The JAX module bumps the
counter after it releases the lock, and publishes ``completed`` before
the merge, so a poll can read ``failed`` beside ``jobs_failed == 0``.)

Each result line is ``{"offset": O, "p": P, "outputs": [...]}`` (or
``"error"`` instead of ``"outputs"`` for a record that permanently
failed — malformed JSON, oversized, or rejected by every replica), so
output lines correspond 1:1 with input records, in input order within
each partition.
"""
import collections
import hashlib
import json
import logging
import os
import struct
import threading
import time
import uuid

from . import faults
from .metrics import Counters

logger = logging.getLogger(__name__)

TERMINAL_STATES = ("completed", "failed", "cancelled")
FORMATS = ("jsonl", "tfrecord")

MAX_PARTITIONS = 4096
# a single input record larger than this is recorded as a failed record
# (never buffered whole); jsonl scanning stays O(bound) per record
MAX_RECORD_BYTES = 1 << 20


class JobError(RuntimeError):
    """A job-level operational failure (spool I/O exhausted retries)."""


class _Drained(Exception):
    """No partition left to lease (internal control flow)."""


class _Interrupted(Exception):
    """Worker told to stop mid-partition: requeue without attempt
    penalty (gateway shutdown / job cancel, not a partition fault)."""


class _Permanent(Exception):
    """A record the fleet rejected as invalid (4xx): retrying cannot
    help, the record fails and the partition moves on."""


class _Transient(Exception):
    """A dispatch failure worth retrying (replica died, fleet
    saturated, no replica routable right now)."""


# ---------------------------------------------------------------------------
# partition splitting (TFoS / Hadoop FileSplit semantics)


def split_file(path, n_partitions, fmt="jsonl"):
    """Shard `path` into up to `n_partitions` byte ranges
    ``[(start, end), ...]`` covering the file.

    Jsonl follows the Hadoop text FileSplit contract: splits land at
    arbitrary byte offsets, and a partition owns exactly the records
    whose FIRST byte lies in ``[start, end)`` — the reader skips past
    the record straddling ``start`` (the previous partition reads it to
    completion) and reads through the record containing ``end - 1``.
    TFRecord frames cannot be resynced from an arbitrary offset, so
    splits are snapped to record boundaries via the file's index.
    """
    size = os.path.getsize(path)
    n = max(1, min(int(n_partitions), MAX_PARTITIONS))
    if size == 0:
        return [(0, 0)]
    if fmt == "tfrecord":
        return _split_tfrecord(path, size, n)
    step = -(-size // n)              # ceil: at most n ragged ranges
    return [(lo, min(lo + step, size)) for lo in range(0, size, step)]


def _split_tfrecord(path, size, n):
    from . import tfrecord

    payload_offs, _ = tfrecord.index_records(path)
    if not payload_offs:
        return [(0, 0)]
    frame_offs = [off - 12 for off in payload_offs]   # 12B frame header
    step = -(-size // n)
    bounds = [0]
    for k in range(1, n):
        target = k * step
        nxt = next((off for off in frame_offs if off >= target), size)
        if nxt > bounds[-1] and nxt < size:
            bounds.append(nxt)
    bounds.append(size)
    return list(zip(bounds[:-1], bounds[1:]))


def _iter_jsonl(path, start, end, max_record_bytes):
    """Yield ``(offset, next_offset, text)`` for every record owned by
    the split; ``text`` is None for an oversized record (the caller
    emits an error line so output stays 1:1 with input)."""
    with open(path, "rb") as f:
        if start == 0:
            f.seek(0)
        else:
            # the record straddling `start` belongs to the previous
            # partition: position after the newline that ends the
            # record owning byte start-1
            f.seek(start - 1)
            f.readline()
        pos = f.tell()
        while pos < end:
            line = f.readline(max_record_bytes + 1)
            if not line:
                break
            rec_off = pos
            oversized = len(line) > max_record_bytes
            if oversized and not line.endswith(b"\n"):
                while True:          # resync: skip the rest of the record
                    more = f.readline(1 << 20)
                    if not more or more.endswith(b"\n"):
                        break
            pos = f.tell()
            if oversized:
                yield rec_off, pos, None
                continue
            text = line.strip()
            if text:                 # blank lines are not records
                yield rec_off, pos, text.decode("utf-8", "replace")


def _iter_tfrecord(path, start, end, max_record_bytes):
    """Yield ``(offset, next_offset, text)`` TFRecord frames whose
    frame start lies in ``[start, end)`` (splits are already
    boundary-snapped, so ``start`` IS a frame start)."""
    with open(path, "rb") as f:
        f.seek(start)
        pos = start
        while pos < end:
            header = f.read(12)
            if len(header) < 12:
                break
            (length,) = struct.unpack("<Q", header[:8])
            nxt = pos + 12 + length + 4
            if length > max_record_bytes:
                f.seek(nxt)
                yield pos, nxt, None
            else:
                payload = f.read(length)
                f.seek(4, os.SEEK_CUR)           # skip payload CRC
                if len(payload) < length:
                    break
                yield pos, nxt, payload.decode("utf-8", "replace")
            pos = nxt


def iter_partition(path, start, end, fmt="jsonl",
                   max_record_bytes=MAX_RECORD_BYTES):
    """Yield ``(offset, next_offset, text)`` for one partition split.
    ``offset`` keys the record (``job_id/p/offset``), ``next_offset``
    is the durable resume point once the record's result is
    checkpointed."""
    faults.check("jobs.partition_read")
    it = _iter_tfrecord if fmt == "tfrecord" else _iter_jsonl
    return it(path, start, end, max_record_bytes)


def count_records(path, splits, fmt="jsonl"):
    """Total records across `splits` — the denominator for progress and
    ETA.  One sequential pass; no fault probe (counting happens at
    submit, before the job exists to retry)."""
    it = _iter_tfrecord if fmt == "tfrecord" else _iter_jsonl
    return sum(sum(1 for _ in it(path, s, e, MAX_RECORD_BYTES))
               for s, e in splits)


# ---------------------------------------------------------------------------
# records -> requests


def record_seed(key):
    """Deterministic per-record sampling seed: a crashed partition's
    re-dispatch must produce byte-identical output, so an unseeded
    sampled record is pinned to a seed derived from its identity."""
    digest = hashlib.sha256(key.encode()).digest()
    return int.from_bytes(digest[:4], "big") & 0x7FFFFFFF


def record_request(text, template, key):
    """Parse one input record into a ``:generate`` request body.

    A record is either a bare token-id list (sugar for
    ``{"inputs": [<list>]}``) or a JSON object merged OVER the job's
    request template (record fields win).  The merge must resolve to a
    non-empty ``inputs``; anything else is a permanently failed record,
    not a job failure.
    """
    try:
        obj = json.loads(text)
    except ValueError as e:
        raise ValueError(f"record is not JSON: {e}")
    if isinstance(obj, list):
        obj = {"inputs": [obj]}
    if not isinstance(obj, dict):
        raise ValueError("record must be a JSON object or token-id list")
    req = dict(template or {})
    req.update(obj)
    if not req.get("inputs"):
        raise ValueError("record resolves to empty 'inputs'")
    req["priority"] = "batch"        # jobs NEVER compete as interactive
    req.pop("stream", None)          # spool files want the one-shot path
    if (float(req.get("temperature") or 0.0) > 0
            and req.get("seed") is None):
        req["seed"] = record_seed(key)
    return req


# ---------------------------------------------------------------------------
# the job record


class Job:
    """One bulk job: immutable spec + in-memory progress.  All mutable
    containers are guarded by the owning JobManager's lock."""

    def __init__(self, job_id, spec, jobdir):
        self.id = job_id
        self.spec = dict(spec)
        self.dir = jobdir
        self.input = spec["input"]
        self.fmt = spec.get("format") or "jsonl"
        self.model = spec.get("model") or "default"
        self.request = dict(spec.get("request") or {})
        self.tenant = spec.get("tenant") or "anonymous"
        self.trace_id = spec.get("trace")
        self.splits = [tuple(s) for s in spec["splits"]]
        self.records_total = int(spec["records_total"])
        self.workers = int(spec.get("workers") or 0)
        self.output = os.path.join(jobdir, "output.jsonl")
        self.state = spec.get("state") or "running"
        self.error = spec.get("error")
        self.halt = threading.Event()      # cancel/failure -> workers out
        self.finishing = False             # a worker claimed the merge
        # progress (JobManager._lock guards every access)
        self.pending = collections.deque()
        self.leased = set()
        self.done = set()
        self.attempts = {}                 # p -> failed attempts
        self.durable = {}                  # p -> [done_n, failed_n] (ckpt)
        self.live = {}                     # p -> [done, failed] since ckpt
        self.rate = collections.deque(maxlen=128)   # completion stamps

    def counts(self):
        """(records_done, records_failed) — durable + in-flight deltas.
        Caller holds the manager lock."""
        done = sum(v[0] for v in self.durable.values())
        fail = sum(v[1] for v in self.durable.values())
        done += sum(v[0] for v in self.live.values())
        fail += sum(v[1] for v in self.live.values())
        return done, fail


# ---------------------------------------------------------------------------
# the manager


class JobManager:
    """Owns the spool directory, the per-job runner threads, and the
    dispatch of partition records into the fleet.

    ``gateway`` wires dispatch through a live :class:`fleet.Gateway`
    (quota admission, WFQ batch-class routing, breaker accounting).
    ``dispatch`` replaces it with a callable ``(body, key) -> response``
    for benches and tests that drive an engine directly.
    """

    def __init__(self, jobs_dir, gateway=None, dispatch=None,
                 default_workers=2, checkpoint_every=16,
                 record_timeout_s=60.0, record_attempts=4,
                 partition_attempts=3, ckpt_attempts=4,
                 default_partitions=4, max_record_bytes=MAX_RECORD_BYTES,
                 counters=None, trace=None):
        self.jobs_dir = os.path.abspath(jobs_dir)
        os.makedirs(self.jobs_dir, exist_ok=True)
        self._gw = gateway
        self._dispatch_fn = dispatch
        self.default_workers = max(1, int(default_workers))
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.record_timeout_s = float(record_timeout_s or 60.0)
        self.record_attempts = max(1, int(record_attempts))
        self.partition_attempts = max(1, int(partition_attempts))
        self.ckpt_attempts = max(1, int(ckpt_attempts))
        self.default_partitions = max(1, int(default_partitions))
        self.max_record_bytes = int(max_record_bytes)
        self.counters = counters if counters is not None else Counters()
        self.trace = trace
        self._lock = threading.Lock()
        self._jobs = {}
        self._threads = []
        self._stop = threading.Event()

    # ---- spool I/O (atomic rename + bounded retry) -------------------

    def _spool_write(self, path, obj):
        """Atomic JSON write: tmp + fsync + rename, retried a bounded
        number of times.  Exhausting the retries raises JobError — the
        caller's partition is abandoned rather than marked durable."""
        last = None
        for i in range(self.ckpt_attempts):
            try:
                faults.check("jobs.checkpoint_write")
                tmp = path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(obj, f, sort_keys=True)
                    f.write("\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
                return
            except OSError as e:
                last = e
                self.counters.inc("jobs_ckpt_retries")
                time.sleep(min(0.02 * (1 << i), 0.25))
        raise JobError(f"spool write {path} failed after "
                       f"{self.ckpt_attempts} attempts: {last}")

    @staticmethod
    def _parts_dir(job):
        return os.path.join(job.dir, "parts")

    def _ckpt_path(self, job, p):
        return os.path.join(self._parts_dir(job), f"{p}.json")

    def _part_path(self, job, p):
        return os.path.join(self._parts_dir(job), f"{p}.out")

    def _load_ckpt(self, job, p):
        try:
            with open(self._ckpt_path(job, p), encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return {"next_offset": job.splits[p][0], "out_bytes": 0,
                    "done_n": 0, "failed_n": 0, "done": False}

    def _persist_state(self, job):
        """Best-effort durable state transition (job.json rewrite).  A
        persistent spool fault leaves the durable state behind the
        in-memory one; a later rescan then re-drives from checkpoints,
        which is idempotent by construction."""
        with self._lock:
            spec = dict(job.spec, state=job.state, error=job.error)
            job.spec = spec
        try:
            self._spool_write(os.path.join(job.dir, "job.json"), spec)
        except JobError as e:
            logger.error("job %s: state persist failed: %s", job.id, e)

    # ---- submit / rescan / status ------------------------------------

    def submit(self, spec, tenant="anonymous"):
        """Validate, split, count, persist, and start one job.  Returns
        the initial status dict (also the ``POST /v1/jobs`` body)."""
        if self._stop.is_set():
            raise JobError("job manager is stopping")
        if not isinstance(spec, dict):
            raise ValueError("job spec must be a JSON object")
        path = spec.get("input")
        if not path or not isinstance(path, str):
            raise ValueError("job spec wants 'input': path to a record "
                             "file readable by the gateway")
        if not os.path.isfile(path):
            raise ValueError(f"input {path!r} is not a readable file")
        fmt = spec.get("format") or "jsonl"
        if fmt not in FORMATS:
            raise ValueError(f"format {fmt!r} not one of {FORMATS}")
        request = spec.get("request") or {}
        if not isinstance(request, dict):
            raise ValueError("'request' template must be an object")
        n_parts = spec.get("partitions")
        n_parts = (self.default_partitions if n_parts is None
                   else int(n_parts))
        if n_parts < 1:
            raise ValueError("'partitions' must be >= 1")
        workers = int(spec.get("workers") or self.default_workers)
        trace_id = spec.get("trace")
        splits = split_file(path, n_parts, fmt=fmt)
        total = count_records(path, splits, fmt=fmt)
        job_id = uuid.uuid4().hex[:12]
        jobdir = os.path.join(self.jobs_dir, job_id)
        jspec = {"id": job_id, "input": os.path.abspath(path),
                 "format": fmt, "model": spec.get("model") or "default",
                 "request": request, "tenant": tenant,
                 "trace": trace_id if trace_id else None,
                 "workers": workers, "splits": [list(s) for s in splits],
                 "records_total": total, "state": "running",
                 "error": None, "created_s": time.time()}
        os.makedirs(os.path.join(jobdir, "parts"), exist_ok=True)
        # durable BEFORE visible: a gateway crash between these writes
        # leaves a complete job.json that rescan resumes, never a half
        # job that dispatched records with no checkpoint home
        self._spool_write(os.path.join(jobdir, "job.json"), jspec)
        job = Job(job_id, jspec, jobdir)
        with self._lock:
            job.pending.extend(range(len(splits)))
            self._jobs[job_id] = job
        self.counters.inc("jobs_submitted")
        if self.trace is not None:
            self.trace.event(job.trace_id, "job.submit", job=job_id,
                             partitions=len(splits), records=total)
        self._start_workers(job)
        return self.status(job_id)

    def rescan(self):
        """Load every job under ``jobs_dir``; resume the incomplete
        ones from their partition checkpoints (the gateway-restart
        survival path).  Returns the resumed job ids."""
        resumed = []
        try:
            names = sorted(os.listdir(self.jobs_dir))
        except OSError:
            return resumed
        for name in names:
            jobdir = os.path.join(self.jobs_dir, name)
            jf = os.path.join(jobdir, "job.json")
            if not os.path.isfile(jf):
                continue
            with self._lock:
                known = name in self._jobs
            if known:
                continue
            try:
                with open(jf, encoding="utf-8") as f:
                    jspec = json.load(f)
            except (OSError, ValueError) as e:
                logger.warning("jobs rescan: unreadable %s: %s", jf, e)
                continue
            job = Job(jspec.get("id") or name, jspec, jobdir)
            # fold durable per-partition progress back in
            for p in range(len(job.splits)):
                ck = self._load_ckpt(job, p)
                job.durable[p] = [int(ck.get("done_n") or 0),
                                  int(ck.get("failed_n") or 0)]
                if ck.get("done"):
                    job.done.add(p)
            with self._lock:
                if job.state == "running":
                    job.pending.extend(
                        p for p in range(len(job.splits))
                        if p not in job.done)
                self._jobs[job.id] = job
            if job.state != "running":
                continue
            if not os.path.isfile(job.input):
                job.state = "failed"
                job.error = f"input {job.input!r} vanished across restart"
                self._persist_state(job)
                continue
            resumed.append(job.id)
            self.counters.inc("jobs_resumed")
            self._start_workers(job)
        return resumed

    def _get(self, job_id):
        with self._lock:
            job = self._jobs.get(str(job_id))
        if job is None:
            raise KeyError(f"unknown job {job_id!r}")
        return job

    def status(self, job_id):
        """The ``GET /v1/jobs/<id>`` body: progress + drain-rate ETA."""
        job = self._get(job_id)
        with self._lock:
            done, failed = job.counts()
            stamps = list(job.rate)
            out = {"id": job.id, "state": job.state, "error": job.error,
                   "input": job.input, "format": job.fmt,
                   "model": job.model, "tenant": job.tenant,
                   "partitions": len(job.splits),
                   "partitions_done": len(job.done),
                   "records_total": job.records_total,
                   "records_done": done, "records_failed": failed,
                   "output": (job.output if job.state == "completed"
                              else None)}
        # drain-rate ETA, same estimator shape as the gateway's
        # Retry-After: completions/s over a recent window
        rate = 0.0
        if len(stamps) >= 2 and stamps[-1] > stamps[0]:
            rate = (len(stamps) - 1) / (stamps[-1] - stamps[0])
        remaining = max(0, out["records_total"] - done - failed)
        out["records_per_s"] = round(rate, 3)
        out["eta_s"] = (round(remaining / rate, 1)
                        if rate > 0 and out["state"] == "running"
                        else None)
        return out

    def list(self):
        with self._lock:
            ids = sorted(self._jobs)
        return [self.status(i) for i in ids]

    def stats(self):
        """Summable keys for the gateway's fleet totals (and thereby
        ``/metrics``): active jobs + record progress across all known
        jobs this gateway life."""
        with self._lock:
            jobs = list(self._jobs.values())
            active = sum(1 for j in jobs if j.state == "running")
            done = failed = 0
            for j in jobs:
                d, f = j.counts()
                done += d
                failed += f
        return {"jobs_active": active, "jobs_records_done": done,
                "jobs_records_failed": failed}

    def cancel(self, job_id):
        """Teardown: halt the runners, persist the terminal state.  A
        repeat cancel (or cancel of a finished job) is a no-op that
        returns the terminal status."""
        job = self._get(job_id)
        with self._lock:
            # a claimed merge is as good as completed: it publishes
            # "completed" whatever a cancel would say meanwhile
            terminal = job.state in TERMINAL_STATES or job.finishing
            if not terminal:
                job.state = "cancelled"
                self.counters.inc("jobs_cancelled")
        if not terminal:
            job.halt.set()
            self._persist_state(job)
            if self.trace is not None:
                self.trace.event(job.trace_id, "job.cancel", job=job.id)
        return self.status(job_id)

    def stop(self, timeout_s=10.0):
        """Halt every runner WITHOUT marking jobs terminal: durable
        state stays ``running`` so the next gateway's rescan resumes
        from the checkpoints (this is the restart path, not cancel)."""
        self._stop.set()
        with self._lock:
            threads = list(self._threads)
        deadline = time.monotonic() + timeout_s
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))

    # ---- runners -----------------------------------------------------

    def _start_workers(self, job):
        with self._lock:
            n_pending = len(job.pending)
        n = min(max(1, job.workers or self.default_workers),
                max(1, n_pending))
        if n_pending == 0:
            n = 1                     # one worker to notice completion
        for k in range(n):
            t = threading.Thread(target=self._worker, args=(job,),
                                 name=f"job-{job.id}-w{k}", daemon=True)
            with self._lock:
                self._threads.append(t)
            t.start()

    def _worker(self, job):
        try:
            while not self._stop.is_set():
                try:
                    lease = self._lease_partition(job)
                except _Drained:
                    break
                try:
                    self._run_partition(job, lease)
                except BaseException as e:
                    self._abandon_partition(lease, e)
                else:
                    self._commit_partition(lease)
            self._maybe_finish(job)
        except Exception:
            logger.exception("job %s: worker died", job.id)

    def _lease_partition(self, job):
        """Claim the next pending partition for this worker.  The lease
        MUST be returned through :meth:`_commit_partition` or
        :meth:`_abandon_partition`."""
        with self._lock:
            if (self._stop.is_set() or job.halt.is_set()
                    or job.state != "running" or not job.pending):
                raise _Drained()
            p = job.pending.popleft()
            job.leased.add(p)
        return {"job": job, "p": p, "t0": time.monotonic()}

    def _commit_partition(self, lease):
        job, p = lease["job"], lease["p"]
        with self._lock:
            job.leased.discard(p)
            job.done.add(p)
        if self.trace is not None:
            self.trace.span_at(job.trace_id, "job.partition",
                               lease["t0"], time.monotonic(),
                               job=job.id, partition=p, status="done")

    def _abandon_partition(self, lease, err=None):
        """Requeue a partition whose run did not complete.  A genuine
        fault costs an attempt; exhausting ``partition_attempts`` fails
        the JOB (a poisoned partition must not spin forever).  An
        interruption (shutdown, cancel) requeues penalty-free — the
        rerun is the resume path, not a retry."""
        job, p = lease["job"], lease["p"]
        interrupted = isinstance(err, _Interrupted)
        failed = False
        with self._lock:
            job.leased.discard(p)
            job.live.pop(p, None)     # un-checkpointed deltas roll back
            job.pending.append(p)
            if not interrupted:
                n = job.attempts.get(p, 0) + 1
                job.attempts[p] = n
                if n >= self.partition_attempts and job.state == "running":
                    # state and count published together (see the module
                    # docstring)
                    job.state = "failed"
                    job.error = (f"partition {p} failed "
                                 f"{n} attempts: {err}")
                    self.counters.inc("jobs_failed")
                    failed = True
        if self.trace is not None:
            self.trace.span_at(job.trace_id, "job.partition",
                               lease["t0"], time.monotonic(),
                               job=job.id, partition=p,
                               status="interrupted" if interrupted
                               else "abandoned")
        if not interrupted:
            logger.warning("job %s: partition %d abandoned: %s",
                           job.id, p, err)
        if failed:
            job.halt.set()
            self._persist_state(job)

    def _run_partition(self, job, lease):
        p = lease["p"]
        start, end = job.splits[p]
        ck = self._load_ckpt(job, p)
        if ck.get("done"):
            return
        os.makedirs(self._parts_dir(job), exist_ok=True)
        out = open(self._part_path(job, p), "ab")
        try:
            # everything past the last durable byte came from dispatches
            # that never checkpointed; re-deriving them (below) is what
            # makes the output exactly-once across crashes
            out.truncate(int(ck.get("out_bytes") or 0))
            n_since = 0
            for off, nxt, text in iter_partition(
                    job.input, start, end, fmt=job.fmt,
                    max_record_bytes=self.max_record_bytes):
                if off < int(ck.get("next_offset") or 0):
                    continue          # durable already
                if self._stop.is_set() or job.halt.is_set():
                    raise _Interrupted("halted mid-partition")
                out.write(self._score_record(job, p, off, text))
                ck["next_offset"] = nxt
                n_since += 1
                if n_since >= self.checkpoint_every:
                    self._checkpoint(job, p, out, ck)
                    n_since = 0
            ck["done"] = True
            self._checkpoint(job, p, out, ck)
        finally:
            out.close()

    def _checkpoint(self, job, p, out, ck):
        """Make the partition's spool durable, then the checkpoint that
        points at it — strictly in that order, so a crash between the
        two re-derives records instead of losing them."""
        out.flush()
        os.fsync(out.fileno())
        ck["out_bytes"] = os.fstat(out.fileno()).st_size
        with self._lock:
            live = job.live.pop(p, [0, 0])
            ck["done_n"] = int(ck.get("done_n") or 0) + live[0]
            ck["failed_n"] = int(ck.get("failed_n") or 0) + live[1]
            job.durable[p] = [ck["done_n"], ck["failed_n"]]
        self._spool_write(self._ckpt_path(job, p), ck)

    def _score_record(self, job, p, off, text):
        """One record end to end: parse, dispatch (with retry), account.
        Returns the result line (bytes).  Raises only for partition-level
        trouble (interruption, undeliverable record)."""
        key = f"{job.id}/{p}/{off}"
        err = None
        outs = None
        if text is None:
            err = f"record exceeds {self.max_record_bytes} bytes"
        else:
            try:
                body = record_request(text, job.request, key)
            except ValueError as e:
                err = str(e)
            else:
                try:
                    outs = self._dispatch(job, body, key)
                except _Permanent as e:
                    err = str(e)
        if self.trace is not None and off == job.splits[p][0]:
            # one sample span per partition keeps the ring useful
            # without a million-record job flooding it
            self.trace.event(job.trace_id, "job.record", job=job.id,
                             partition=p, offset=off,
                             ok=err is None)
        with self._lock:
            live = job.live.setdefault(p, [0, 0])
            if err is None:
                live[0] += 1
                job.rate.append(time.monotonic())
            else:
                live[1] += 1
        self.counters.inc("jobs_records_done" if err is None
                          else "jobs_records_failed")
        obj = {"p": p, "offset": off}
        if err is None:
            obj["outputs"] = outs
        else:
            obj["error"] = err
        return (json.dumps(obj, sort_keys=True) + "\n").encode()

    # ---- dispatch ----------------------------------------------------

    def _dispatch(self, job, body, key):
        """Deliver one record to the fleet, retrying transient failures
        (replica death, saturation) across attempts.  Returns the
        outputs list, returns an error via _score_record for permanent
        rejections, and raises for an undeliverable record (the
        partition retries later, against a hopefully-healthier
        fleet)."""
        last = None
        for attempt in range(self.record_attempts):
            if self._stop.is_set() or job.halt.is_set():
                raise _Interrupted("halted mid-record")
            try:
                faults.check("jobs.record_dispatch")
                if self._dispatch_fn is not None:
                    resp = self._dispatch_fn(dict(body), key)
                else:
                    resp = self._dispatch_gateway(job, body, key)
                return resp.get("outputs")
            except _Permanent:
                raise
            except (OSError, _Transient) as e:
                last = e
                self.counters.inc("jobs_record_retries")
                job.halt.wait(min(0.05 * (1 << attempt), 1.0))
        raise JobError(f"record {key} undeliverable after "
                       f"{self.record_attempts} attempts: {last}")

    def _dispatch_gateway(self, job, body, key):
        """One batch-class exchange through the owning gateway: quota
        admission, WFQ-degraded routing, breaker accounting — the same
        envelope an external batch client gets, minus the HTTP hop."""
        from . import fleet            # deferred: fleet imports jobs
        gw = self._gw
        try:
            gw._quota_admit(job.tenant)
        except fleet.Saturated as e:
            raise _Transient(str(e))
        try:
            try:
                r = gw._choose_degraded(job.tenant, "batch",
                                        roles=("prefill", "mixed"))
            except (fleet.NoReplica, fleet.Saturated) as e:
                raise _Transient(str(e))
            try:
                conn, resp = gw._request(
                    r, "POST", f"/v1/models/{job.model}:generate",
                    body=json.dumps(body),
                    timeout=self.record_timeout_s,
                    headers={"Idempotency-Key": key,
                             "X-Tenant": job.tenant,
                             "X-Priority": "batch"})
                try:
                    status = resp.status
                    data = resp.read()
                finally:
                    conn.close()
            except OSError:
                gw._release(r, ok=False)
                raise
            # a 4xx is the replica judging the RECORD, not failing:
            # it must not trip the breaker, and retrying cannot help
            gw._release(r, ok=status == 200 or 400 <= status < 500)
            if status == 200:
                return json.loads(data)
            try:
                msg = json.loads(data).get("error") or f"status {status}"
            except ValueError:
                msg = f"status {status}"
            if 400 <= status < 500:
                raise _Permanent(f"replica {r.id}: {msg}")
            raise _Transient(f"replica {r.id}: {msg}")
        finally:
            gw._quota_release(job.tenant)

    # ---- completion --------------------------------------------------

    def _maybe_finish(self, job):
        """Last worker out merges the partition spools into the final
        output (atomic rename) and flips the durable state."""
        with self._lock:
            if (job.state != "running" or job.finishing or job.leased
                    or len(job.done) != len(job.splits)):
                return
            job.finishing = True      # claimed under the lock: exactly
            n_parts = len(job.splits)  # one worker runs the merge
        try:
            tmp = job.output + ".tmp"
            with open(tmp, "wb") as dst:
                for p in range(n_parts):
                    try:
                        with open(self._part_path(job, p), "rb") as src:
                            while True:
                                chunk = src.read(1 << 20)
                                if not chunk:
                                    break
                                dst.write(chunk)
                    except FileNotFoundError:
                        pass          # an empty partition spooled nothing
                dst.flush()
                os.fsync(dst.fileno())
            os.replace(tmp, job.output)
        except OSError as e:
            with self._lock:
                job.state = "failed"
                job.error = f"output merge failed: {e}"
                self.counters.inc("jobs_failed")
            self._persist_state(job)
            return
        with self._lock:
            # published only now that output.jsonl is in place
            job.state = "completed"
            self.counters.inc("jobs_completed")
        self._persist_state(job)
        if self.trace is not None:
            self.trace.event(job.trace_id, "job.done", job=job.id,
                             output=job.output)
        logger.info("job %s: completed -> %s", job.id, job.output)
