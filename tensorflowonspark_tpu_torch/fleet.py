"""Serving fleet gateway: N serving replicas behind ONE endpoint — the
port of ``tensorflowonspark_tpu/fleet.py``.

The paper's essence is cluster orchestration — the TFoS reservation
protocol turns N executors into one addressable cluster.  This module
points the SAME plane at serving: replicas register with the gateway
through the port's :mod:`reservation` ``Server``/``Client`` protocol
(JSON-framed REG/BEAT/BYE — nothing serving-specific was added to the
wire format), announce capacity (``n_slots``, engine features), and
heartbeat for liveness; the gateway fronts them as one HTTP endpoint:

    python -m tensorflowonspark_tpu_torch.fleet --port 8500 \\
        --registry_port 8400
    python -m tensorflowonspark_tpu_torch.serve --export_dir /models/m \\
        --port 8501 --fleet 127.0.0.1:8400        # replica 1
    python -m tensorflowonspark_tpu_torch.serve --export_dir /models/m \\
        --port 8502 --fleet 127.0.0.1:8400        # replica 2

The JAX package's registry frames msgpack, so its replicas and this
gateway (and the other way round) do not register with each other; the
HTTP surface (routes, bodies, headers, typed errors) is the same.  The
gateway is host code: it imports no torch and owns no device.

Routing policy (stdlib-only, no extra deps):

- ``POST /v1/models/<name>:predict`` — least-outstanding-requests, with
  ONE hedged retry to a different replica on connect failure / 5xx
  (predict is idempotent; a duplicate execution is harmless).
- ``POST /v1/models/<name>:generate`` — prefix-affine: the request hashes
  the prompt's first ``prefix_tokens`` tokens (defaulting to the
  replicas' announced ``kv_page_size`` — exactly one paged-KV prefix
  page, the unit the replica-side prefix cache shares) and rendezvous
  hashing (highest-random-weight) maps that key to a replica, so
  follow-ups with a shared prefix land where their KV pages are warm.
  The hash is the JAX gateway's byte for byte, so both route a prompt
  to the same replica id.  When the affine replica's queue depth
  exceeds its bound the request spills to the least-loaded replica (a
  cold prefill beats queueing).  A non-streamed generation is NOT
  idempotent under sampling, so there is no hedged retry: replica
  failure returns a typed 502 (``{"type": "replica_failure",
  "replica": ...}``) and the client decides.  A streamed one is
  journaled and re-driven onto a live peer through ``:resume`` with a
  ``replay`` of the tokens already sent.
- Unhappy paths: heartbeat-miss ejection with automatic re-admission
  when beats resume (or the replica re-registers), per-replica circuit
  breaking (consecutive failures open the breaker for a cooldown),
  bounded per-replica queues with 429 + ``Retry-After`` backpressure,
  and ``POST /v1/fleet:drain?replica=<id>`` for rolling restarts: stop
  new admissions, wait for in-flight work (gateway-proxied AND the
  replica's own slot generations, via the replica drain hook), then
  deregister (``/v1/fleet:migrate`` moves the live sessions first).
- ``GET /v1/fleet`` — per-replica state + proxied ``stats()`` snapshots
  (slots busy, queue depth, prefix-cache sharing) plus the gateway's
  :class:`metrics.Counters` (ejections, re-admissions, hedged retries,
  429s, affinity hits/spills) and fleet-wide totals; ``GET /metrics``
  renders them (and each replica's) as Prometheus text;
  ``GET /v1/trace/<id>`` stitches the gateway's spans with every
  replica's.
- ``POST /v1/jobs`` — offline bulk jobs (:mod:`jobs`) when started with
  ``--jobs_dir``.
- ``GET /healthz`` (gateway liveness) / ``GET /readyz`` (>= 1 routable
  replica) — the same liveness/readiness split the replicas expose.
"""
import argparse
import collections
import hashlib
import heapq
import http.client
import itertools
import json
import logging
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import faults, jobs as jobs_mod, reservation, trace, util
from .metrics import Counters, LatencyWindow, prometheus_text

logger = logging.getLogger(__name__)

# replica states
UP = "up"
EJECTED = "ejected"        # heartbeat lost; auto-readmitted when beats resume
DRAINING = "draining"      # no new admissions; removed once drained


class Replica:
    """Gateway-side view of one registered serving replica."""

    def __init__(self, meta):
        try:
            self.id = str(meta["replica_id"])
            self.host = str(meta["host"])
            self.port = int(meta["port"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"replica meta must carry replica_id/host/"
                             f"port: {meta!r} ({e})")
        self.model_name = str(meta.get("model_name") or "default")
        self.n_slots = int(meta.get("n_slots") or 8)
        self.features = dict(meta.get("features") or {})
        # disaggregation role: advisory routing hint announced by the
        # replica (serve --role) via REG features; absent → "mixed"
        self.role = str(self.features.get("role") or "mixed")
        self.state = UP
        self.outstanding = 0     # gateway-proxied requests in flight
        self.requests = 0        # total forwarded (monotone)
        self.errors = 0          # connect/5xx failures observed (monotone)
        self.failures = 0        # CONSECUTIVE failures (breaker input)
        self.open_until = 0.0    # breaker open until this monotonic time
        self.misses = 0          # CONSECUTIVE over-age monitor sweeps
        self.fresh_since = None  # ejected: when beats turned fresh again
        self.ejections = 0       # times this registration was ejected
        self.readmissions = 0    # times it was readmitted after cooldown
        self.registered_at = time.time()

    def describe(self):
        return {"host": self.host, "port": self.port,
                "model_name": self.model_name, "n_slots": self.n_slots,
                "features": self.features, "role": self.role,
                "state": self.state,
                "outstanding": self.outstanding, "requests": self.requests,
                "errors": self.errors,
                "ejections": self.ejections,
                "readmissions": self.readmissions,
                "breaker_open": self.open_until > time.monotonic()}


class StreamJournal:
    """Per-stream recovery journal: everything needed to re-drive a lost
    session lives here — the (seeded) request body and every token the
    client has already been sent.  Journaling is a tee in the gateway's
    relay loop, so it costs one list append per token; entries close in
    a ``finally`` when their stream ends (delivered, failed, or the
    client went away), so a drained gateway always reports zero entries
    — the invariant the chaos tests' stranded-journal checks pin."""

    def __init__(self):
        self._entries = {}
        self._lock = threading.Lock()

    def journal_open(self, body):
        """Open a journal entry for one streaming :generate.  The
        returned entry's ``key`` doubles as the stream's
        Idempotency-Key: stable across re-drives, unique per stream."""
        entry = {"key": uuid.uuid4().hex, "body": body, "tokens": []}
        with self._lock:
            self._entries[entry["key"]] = entry
        return entry

    def record(self, entry, token):
        # single-writer per entry (the stream's own relay loop), so the
        # append needs no lock
        entry["tokens"].append(int(token))

    def journal_close(self, entry):
        with self._lock:
            self._entries.pop(entry["key"], None)

    def __len__(self):
        with self._lock:
            return len(self._entries)


PRIORITY_CLASSES = ("interactive", "batch")


class WeightedFairQueue:
    """Weighted-fair ordering for requests waiting out a saturated
    fleet — the overload degradation path.  Classic virtual-time WFQ:
    each waiter gets a virtual finish time ``vft = max(vtime,
    tenant's last vft) + cost / weight(class)`` and the waiter with the
    smallest vft goes first, so under sustained overload tenants share
    admission slots in weight proportion (interactive 8 : batch 1 by
    default) instead of one batch-heavy tenant absorbing every freed
    slot — the single-FIFO failure mode this replaces.  Within one
    tenant+class, FIFO (vft is monotone per tenant and ties break on
    arrival sequence).

    Capacity signals arrive via :meth:`wake` (the gateway calls it from
    ``_release``); :meth:`wait_turn` blocks a waiter until it is the
    head or its deadline passes.  Ordering is fully deterministic given
    the enter() sequence — the unit tests drive it without timing."""

    DEFAULT_WEIGHTS = {"interactive": 8.0, "batch": 1.0}

    def __init__(self, weights=None):
        self._cond = threading.Condition()
        self._weights = dict(self.DEFAULT_WEIGHTS)
        if weights:
            self._weights.update(weights)
        self._vtime = 0.0          # virtual clock: advances on departure
        self._last_vft = {}        # tenant -> last assigned finish time
        self._seq = itertools.count()
        self._heap = []            # (vft, seq) — lazy-deleted on leave
        self._live = {}            # (vft, seq) -> ticket

    def enter(self, tenant, cls, cost=1.0):
        """Assign a virtual finish time and join the wait set.  Returns
        the ticket to pass to :meth:`wait_turn` / :meth:`leave`."""
        with self._cond:
            w = self._weights.get(cls) or 1.0
            start = max(self._vtime, self._last_vft.get(tenant, 0.0))
            vft = start + float(cost) / w
            self._last_vft[tenant] = vft
            key = (vft, next(self._seq))
            ticket = {"key": key, "tenant": tenant, "cls": cls}
            heapq.heappush(self._heap, key)
            self._live[key] = ticket
            return ticket

    def _head_key(self):
        while self._heap and self._heap[0] not in self._live:
            heapq.heappop(self._heap)      # lazily drop departed keys
        return self._heap[0] if self._heap else None

    def head(self):
        with self._cond:
            key = self._head_key()
            return self._live.get(key) if key is not None else None

    def leave(self, ticket, served=False):
        """Depart (served or timed out).  A served departure advances
        the virtual clock to the ticket's finish time, so later
        arrivals cannot be assigned finish times in the past."""
        with self._cond:
            self._live.pop(ticket["key"], None)
            if served:
                self._vtime = max(self._vtime, ticket["key"][0])
            self._cond.notify_all()

    def wake(self):
        """Capacity may be free (a request finished): let the head
        waiter retry its admission."""
        with self._cond:
            self._cond.notify_all()

    def wait_turn(self, ticket, timeout):
        """Block until `ticket` is the head waiter (True) or `timeout`
        elapses (False).  Being head only grants the RIGHT to retry
        admission — the caller loops while the fleet stays saturated."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                if self._head_key() == ticket["key"]:
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 0.05))

    def __len__(self):
        with self._cond:
            return len(self._live)


class _Registry(reservation.Server):
    """The TFoS reservation server, re-aimed at serving-replica
    membership: REG admits a replica into the routing table, BYE
    deregisters it, BEAT feeds the ejection monitor — same frames, same
    framing, same heartbeat client on the replica side as the training
    cluster plane.  Base behavior (reservations list, QUERY/QINFO,
    PROGRESS, STOP) is preserved by delegation."""

    def __init__(self, gateway):
        # count=1: the fleet has no fixed size — `done()` semantics are
        # unused; membership is the routing table, not the node list
        super().__init__(count=1)
        self._gateway = gateway

    def _dispatch(self, sock, msg):
        mtype = msg.get("type")
        if mtype == "REG":
            try:
                self._gateway._admit(msg.get("node") or {})
            except ValueError as e:
                # malformed replica meta must 4xx the registrant, not
                # land a broken row in the routing table
                self.send(sock, {"type": "ERR", "error": str(e)})
                return
        elif mtype == "BYE":
            self._gateway._on_bye(msg.get("executor_id"))
        super()._dispatch(sock, msg)


class Gateway:
    """The fleet routing plane.  Construct, :meth:`start`, point
    replicas at ``registry_addr``, serve traffic at ``http_addr``."""

    def __init__(self, host="127.0.0.1", port=0, registry_host=None,
                 registry_port=0, heartbeat_timeout_s=10.0,
                 monitor_interval_s=None, prefix_tokens=None,
                 queue_depth_factor=2.0, breaker_threshold=3,
                 breaker_cooldown_s=5.0, connect_timeout_s=5.0,
                 replica_timeout_s=600.0, probe_timeout_s=5.0,
                 retry_after_s=1.0, ejection_misses=3,
                 readmit_cooldown_s=None, redrive_attempts=3,
                 redrive_deadline_s=30.0, retry_after_cap_s=30.0,
                 tenant_quota=0, tenant_quotas=None, tenant_classes=None,
                 spill_wait_s=0.0, jobs_dir=None, job_workers=2,
                 job_checkpoint_every=16, job_record_timeout_s=60.0):
        self.host, self.port = host, int(port)
        self.registry_host = registry_host or host
        self.registry_port = int(registry_port)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.monitor_interval_s = (monitor_interval_s
                                   or max(self.heartbeat_timeout_s / 4.0,
                                          0.05))
        # K-consecutive-miss ejection + readmission cool-down: one slow
        # GC pause (a single over-age sweep) must not bounce a healthy
        # replica, and a flapping one must hold beats fresh for the
        # cool-down before taking traffic again
        self.ejection_misses = max(1, int(ejection_misses))
        self.readmit_cooldown_s = (float(readmit_cooldown_s)
                                   if readmit_cooldown_s is not None
                                   else self.heartbeat_timeout_s / 2.0)
        # session recovery: total tries per stream and the wall-time
        # bound a mid-stream session may wait for a replica to come back
        self.redrive_attempts = max(1, int(redrive_attempts))
        self.redrive_deadline_s = float(redrive_deadline_s)
        self._redrive_backoff = util.RetryPolicy(
            attempts=self.redrive_attempts, base_delay=0.1,
            cap_delay=1.0, jitter=0.25)
        self.journal = StreamJournal()
        # gateway-assigned seeds for unseeded sampled streams (disjoint
        # from the replicas' own 1<<20 auto-seed range): a re-drive must
        # replay the SAME chain the first replica sampled
        self._auto_seed = itertools.count(1 << 21)
        # None = adopt the first registrant's announced kv_page_size
        # (the replica-side prefix-cache unit), else 64
        self._prefix_tokens = prefix_tokens
        self.queue_depth_factor = float(queue_depth_factor)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.replica_timeout_s = float(replica_timeout_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.retry_after_s = retry_after_s
        # Retry-After is derived from the fleet's observed drain rate
        # (completions per second over a recent window) instead of the
        # flat constant: `retry_after_s` becomes the FLOOR and
        # `retry_after_cap_s` bounds the estimate when the fleet is
        # nearly wedged (a client told "come back in 20 minutes" never
        # comes back)
        self.retry_after_cap_s = float(retry_after_cap_s)
        self._done_times = collections.deque(maxlen=64)
        # ---- multi-tenant identity / admission ------------------------
        # tenant = X-Tenant (or X-API-Key) header, "anonymous" when
        # absent.  Class = X-Priority header when valid, else the
        # server-side tenant->class map, else "interactive".  Quotas
        # bound a tenant's concurrent in-flight requests: tenant_quota
        # is the default cap (0 = off), tenant_quotas per-tenant
        # overrides.  The WFQ orders requests waiting out a saturated
        # fleet (spill_wait_s > 0) by weighted virtual finish time.
        self.tenant_quota = int(tenant_quota or 0)
        self.tenant_quotas = dict(tenant_quotas or {})
        self.tenant_classes = dict(tenant_classes or {})
        self.spill_wait_s = float(spill_wait_s or 0.0)
        self._tenant_inflight = {}
        self._wfq = WeightedFairQueue()
        self.counters = Counters()
        # gateway-side span ring: route/relay/replay spans, stitched
        # with replica spans by GET /v1/trace/<id>
        self.trace = trace.Recorder()
        # ---- offline bulk jobs (POST /v1/jobs) ------------------------
        # jobs_dir arms the subsystem: partition records dispatch as
        # batch-class work through THIS gateway's quota/WFQ/breaker
        # envelope, and a restarted gateway rescans the directory to
        # resume incomplete jobs from their checkpoints
        self.jobs = None
        if jobs_dir:
            self.jobs = jobs_mod.JobManager(
                jobs_dir, gateway=self,
                default_workers=job_workers,
                checkpoint_every=job_checkpoint_every,
                record_timeout_s=job_record_timeout_s,
                counters=self.counters, trace=self.trace)
        self._replicas = {}
        self._lock = threading.RLock()
        self._registry = _Registry(self)
        self._stop = threading.Event()
        self._http = None
        self.http_addr = None
        self.registry_addr = None

    # ---- lifecycle -------------------------------------------------------

    def start(self):
        """Start registry + monitor + HTTP front; return
        (http_addr, registry_addr)."""
        self.registry_addr = self._registry.start(
            host=self.registry_host,
            ports=[self.registry_port] if self.registry_port else None)
        threading.Thread(target=self._monitor, name="fleet-monitor",
                         daemon=True).start()
        gw = self

        class _BoundHandler(_GatewayHandler):
            gateway = gw

        self._http = ThreadingHTTPServer((self.host, self.port),
                                         _BoundHandler)
        self.http_addr = self._http.server_address[:2]
        threading.Thread(target=self._http.serve_forever,
                         name="fleet-http", daemon=True).start()
        logger.info("fleet gateway on http://%s:%d (registry %s:%d)",
                    *self.http_addr, *self.registry_addr)
        if self.jobs is not None:
            # resume bulk jobs a previous gateway life left incomplete
            # (their durable state still says running); runners start
            # dispatching as soon as replicas register
            resumed = self.jobs.rescan()
            if resumed:
                logger.info("fleet gateway resumed %d bulk job(s): %s",
                            len(resumed), ", ".join(resumed))
        return self.http_addr, self.registry_addr

    def stop(self):
        self._stop.set()
        if self.jobs is not None:
            # halt runners BEFORE the HTTP front drops: durable job
            # state stays "running" so the next life's rescan resumes
            self.jobs.stop()
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
        self._registry.stop()

    # ---- membership (driven by the reservation plane) --------------------

    def _admit(self, meta):
        r = Replica(meta)
        with self._lock:
            prior = self._replicas.get(r.id)
            self._replicas[r.id] = r
            if self._prefix_tokens is None:
                # adopt the replica-side prefix-cache unit so affinity
                # keys align with the pages replicas actually share
                kps = int(r.features.get("kv_page_size") or 0)
                self._prefix_tokens = kps if kps > 0 else 64
        # a fresh REG is also the re-admission path for a restarted
        # replica: seed its liveness window so the monitor does not
        # instantly eject a node whose beat thread is still connecting
        self._registry.seed_beat(r.id)
        self.counters.inc("reregistrations" if prior else "registrations")
        logger.info("replica %s %sregistered (%s:%d, %d slots)", r.id,
                    "re-" if prior else "", r.host, r.port, r.n_slots)

    def _on_bye(self, replica_id):
        with self._lock:
            gone = self._replicas.pop(str(replica_id), None)
        if gone is not None:
            self.counters.inc("deregistrations")
            logger.info("replica %s deregistered (BYE)", replica_id)

    def _monitor(self):
        """Eject replicas whose heartbeat went silent; re-admit when
        beats resume.  The beat table is the reservation server's own —
        replicas run the stock `Client.start_heartbeat`.

        Anti-flap discipline: ejection needs `ejection_misses`
        CONSECUTIVE over-age sweeps (one GC pause is one miss, not an
        ejection), and readmission needs beats to stay fresh for
        `readmit_cooldown_s` (a replica limping back for one beat does
        not take traffic).  A fresh REG still readmits immediately —
        a restarted replica announced itself; there is nothing to
        distrust."""
        while not self._stop.is_set():
            beats = self._registry.last_beats()
            now = time.monotonic()
            with self._lock:
                for r in self._replicas.values():
                    age = now - beats.get(r.id, now)
                    fresh = age <= self.heartbeat_timeout_s
                    if r.state == UP:
                        if fresh:
                            r.misses = 0
                            continue
                        r.misses += 1
                        if r.misses < self.ejection_misses:
                            continue
                        r.state = EJECTED
                        r.fresh_since = None
                        r.ejections += 1
                        self.counters.inc("ejections")
                        logger.warning("ejected replica %s (silent %.1fs,"
                                       " %d consecutive misses)",
                                       r.id, age, r.misses)
                    elif r.state == EJECTED:
                        if not fresh:
                            r.fresh_since = None
                            continue
                        if r.fresh_since is None:
                            r.fresh_since = now
                        if now - r.fresh_since < self.readmit_cooldown_s:
                            continue
                        r.state = UP
                        r.misses, r.fresh_since = 0, None
                        r.failures, r.open_until = 0, 0.0
                        r.readmissions += 1
                        self.counters.inc("readmissions")
                        logger.info("re-admitted replica %s (beats fresh "
                                    "for the %.1fs cool-down)", r.id,
                                    self.readmit_cooldown_s)
            self._stop.wait(self.monitor_interval_s)

    # ---- routing ---------------------------------------------------------

    def _max_outstanding(self, r):
        return max(1, int(self.queue_depth_factor * r.n_slots))

    def _routable(self, r, now=None):
        """UP and breaker not open (an expired breaker half-opens: the
        next request is the trial)."""
        if r.state != UP:
            return False
        now = time.monotonic() if now is None else now
        return not (r.failures >= self.breaker_threshold
                    and r.open_until > now)

    def _choose(self, prefix_key=None, exclude=(), roles=None,
                prompt_len=0):
        """Pick a replica, or raise :class:`NoReplica` /
        :class:`Saturated`.  `prefix_key` engages affinity routing.
        `roles` is a soft preference: when at least one routable replica
        carries one of the named roles, the choice is restricted to
        those; otherwise every routable replica stays eligible (a
        prefill-only or decode-only fleet must not go dark).

        `prompt_len` engages mega-prompt headroom routing: when the
        prompt exceeds a routable replica's advertised
        ``long_prompt_threshold`` REG feature, the pick goes to the
        lane-capable replica with the LARGEST kv capacity
        (kv_pages * kv_page_size) instead of by prefix affinity — a
        100k-token prompt cares about fitting, not about a few warm
        prefix pages."""
        with self._lock:
            now = time.monotonic()
            routable = [r for r in self._replicas.values()
                        if r.id not in exclude and self._routable(r, now)]
            if roles is not None:
                preferred = [r for r in routable if r.role in roles]
                if preferred:
                    routable = preferred
            if not routable:
                if not self._replicas:
                    raise NoReplica("no replicas registered")
                if not any(r.state == UP for r in
                           self._replicas.values()):
                    # every replica is dead/draining, not merely busy:
                    # a typed 503 (+ Retry-After) — clients should back
                    # off and retry, not treat it as overload
                    raise NoReplica("all replicas ejected or draining")
                raise Saturated("no routable replica (circuit-open)")
            open_ = [r for r in routable
                     if r.outstanding < self._max_outstanding(r)]
            if not open_:
                raise Saturated("all replica queues at bound")
            if prompt_len:
                lane = [r for r in open_
                        if 0 < int(r.features.get(
                            "long_prompt_threshold") or 0) < prompt_len]
                if lane:
                    self.counters.inc("long_routes")
                    pick = max(lane, key=lambda r: (
                        int(r.features.get("kv_pages") or 0)
                        * int(r.features.get("kv_page_size") or 0),
                        -r.outstanding, r.id))
                    pick.outstanding += 1
                    return pick
            if prefix_key is not None:
                # rendezvous (highest-random-weight) hashing: stateless,
                # deterministic, and a membership change only remaps the
                # keys that pointed at the departed replica
                affine = max(routable, key=lambda r: _hrw(r.id, prefix_key))
                if affine.outstanding < self._max_outstanding(affine):
                    self.counters.inc("affinity_hits")
                    affine.outstanding += 1
                    return affine
                self.counters.inc("affinity_spills")
                open_ = [r for r in open_ if r.id != affine.id]
                if not open_:
                    raise Saturated("affine replica and all fallbacks at "
                                    "queue bound")
            pick = min(open_, key=lambda r: (r.outstanding, r.id))
            pick.outstanding += 1
            return pick

    def _release(self, r, ok):
        with self._lock:
            r.outstanding = max(0, r.outstanding - 1)
            r.requests += 1
            # drain-rate sample for Retry-After, and a capacity signal
            # for anyone waiting out saturation in the WFQ
            self._done_times.append(time.monotonic())
        self._wfq.wake()
        with self._lock:
            if ok:
                r.failures, r.open_until = 0, 0.0
            else:
                r.errors += 1
                r.failures += 1
                if r.failures >= self.breaker_threshold:
                    was_open = r.open_until > time.monotonic()
                    r.open_until = (time.monotonic()
                                    + self.breaker_cooldown_s)
                    if not was_open:
                        self.counters.inc("breaker_opens")
                        logger.warning("circuit OPEN for replica %s "
                                       "(%d consecutive failures)",
                                       r.id, r.failures)

    def _retry_after(self):
        """Retry-After for 429/503, from the fleet's observed drain
        rate: with `waiting` requests already in flight, a client
        should come back roughly when `waiting + 1` completions have
        drained at the recent completions-per-second rate.  Clamped to
        [retry_after_s, retry_after_cap_s]; with fewer than two recent
        completions there is no rate to speak of — return the floor."""
        with self._lock:
            samples = list(self._done_times)
            waiting = sum(r.outstanding for r in self._replicas.values())
        waiting += len(self._wfq)
        if len(samples) < 2:
            return float(self.retry_after_s)
        span = samples[-1] - samples[0]
        if span <= 0:
            return float(self.retry_after_s)
        rate = (len(samples) - 1) / span       # completions per second
        est = (waiting + 1) / rate
        return max(float(self.retry_after_s),
                   min(est, self.retry_after_cap_s))

    # ---- multi-tenant identity + quotas ----------------------------------

    @staticmethod
    def tenant_of(headers):
        """Tenant identity for a request: X-Tenant, else X-API-Key,
        else "anonymous" (unauthenticated traffic shares one bucket)."""
        return (headers.get("X-Tenant")
                or headers.get("X-API-Key") or "anonymous")

    def class_of(self, headers, tenant):
        """Priority class: explicit X-Priority header when valid, else
        the server-side tenant->class map, else interactive (a class
        nobody asked for must not silently deprioritize them)."""
        hdr = headers.get("X-Priority")
        if hdr in PRIORITY_CLASSES:
            return hdr
        mapped = self.tenant_classes.get(tenant)
        if mapped in PRIORITY_CLASSES:
            return mapped
        return "interactive"

    def _quota_for(self, tenant):
        q = self.tenant_quotas.get(tenant)
        return int(q) if q is not None else self.tenant_quota

    def _quota_admit(self, tenant):
        """Count `tenant` in-flight, or raise Saturated when it is at
        its concurrency cap (0 = unlimited).  The caller MUST pair this
        with :meth:`_quota_release` on every exit path."""
        if faults.deny("fleet.quota_check"):
            self.counters.inc("rejected_quota")
            raise Saturated("tenant %r at quota (injected)" % (tenant,))
        quota = self._quota_for(tenant)
        with self._lock:
            cur = self._tenant_inflight.get(tenant, 0)
            if quota > 0 and cur >= quota:
                self.counters.inc("rejected_quota")
                raise Saturated("tenant %r at quota (%d in flight)"
                                % (tenant, cur))
            self._tenant_inflight[tenant] = cur + 1

    def _quota_release(self, tenant):
        with self._lock:
            cur = self._tenant_inflight.get(tenant, 0)
            if cur <= 1:
                self._tenant_inflight.pop(tenant, None)
            else:
                self._tenant_inflight[tenant] = cur - 1

    def _choose_degraded(self, tenant, cls, prefix_key=None,
                         exclude=(), roles=None, prompt_len=0):
        """`_choose`, but a Saturated fleet degrades into a bounded
        weighted-fair wait instead of an instant 429 (overload
        degradation).  With spill_wait_s == 0 this IS `_choose`."""
        try:
            return self._choose(prefix_key, exclude, roles, prompt_len)
        except Saturated:
            if self.spill_wait_s <= 0:
                raise
        ticket = self._wfq.enter(tenant, cls)
        self.counters.inc("wfq_waits")
        deadline = time.monotonic() + self.spill_wait_s
        try:
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._wfq.wait_turn(
                        ticket, remaining):
                    self.counters.inc("wfq_timeouts")
                    raise Saturated("saturated after %.1fs weighted-fair"
                                    " wait" % self.spill_wait_s)
                try:
                    r = self._choose(prefix_key, exclude, roles,
                                     prompt_len)
                except Saturated:
                    continue           # head, but still no room: re-wait
                self._wfq.leave(ticket, served=True)
                ticket = None
                return r
        finally:
            if ticket is not None:
                self._wfq.leave(ticket, served=False)

    def _decode_target(self, exclude_id=None):
        """Least-loaded routable decode/mixed replica other than
        `exclude_id`, or None.  Does NOT bump ``outstanding`` — the
        migrated stream rides the source replica's proxied connection;
        the destination's own admission control meters the resume."""
        with self._lock:
            now = time.monotonic()
            cands = [r for r in self._replicas.values()
                     if r.id != exclude_id and self._routable(r, now)
                     and r.role in ("decode", "mixed")]
            if not cands:
                return None
            return min(cands, key=lambda r: (r.outstanding, r.id))

    def migrate_target(self, r):
        """The decode replica a session admitted on `r` should hand off
        to once first tokens flush, or None when disaggregation is not
        in play (source isn't prefill-role, or no decode-capable peer
        exists)."""
        if r.role != "prefill":
            return None
        return self._decode_target(exclude_id=r.id)

    def kv_peer_for(self, prefix_key, chosen):
        """``host:port`` of the replica most likely to hold this
        prefix's demoted kv pages (hierarchical kv cache), or None.

        The rendezvous hash that drives prefix affinity also names the
        replica whose HOST TIER has seen the prefix before — so when
        routing lands elsewhere (affinity spill, role preference, the
        affine replica saturated), the chosen replica can pull the
        returning conversation's pages from that peer's ``kv:prefix``
        PageServer instead of re-prefilling.  Only replicas advertising
        ``kv_prefix_addr`` qualify; when the choice IS the affine
        replica its own tier is already the warmest, so nothing is
        planted."""
        if prefix_key is None:
            return None
        with self._lock:
            now = time.monotonic()
            cands = [r for r in self._replicas.values()
                     if r.features.get("kv_prefix_addr")
                     and self._routable(r, now)]
        if not cands:
            return None
        affine = max(cands, key=lambda r: _hrw(r.id, prefix_key))
        if affine.id == chosen.id:
            return None
        self.counters.inc("kv_peer_planted")
        return str(affine.features["kv_prefix_addr"])

    def prefix_key(self, body):
        """Affinity key for a :generate body: the first ``prefix_tokens``
        token ids of the first prompt (None when absent/malformed — the
        request falls back to least-loaded and the replica 400s it)."""
        try:
            prompt = body["inputs"][0]
            # _admit rewrites _prefix_tokens under _lock when the first
            # replica registers; routing threads must not read a torn value
            with self._lock:
                n = self._prefix_tokens or 64
            key = tuple(prompt[:n])
            return key if key else None
        except (KeyError, IndexError, TypeError):
            return None

    @staticmethod
    def prompt_len_of(body):
        """Longest prompt (tokens) in a :generate body, for mega-prompt
        headroom routing; 0 when absent/malformed (the replica 400s
        it)."""
        try:
            return max(len(p) for p in body["inputs"])
        except (KeyError, TypeError, ValueError):
            return 0

    # ---- session recovery (streaming :generate) --------------------------

    def _seed_body(self, body):
        """A re-drive must replay the SAME sampling chain the first
        replica used, so unseeded sampled requests get a gateway-chosen
        seed BEFORE journaling (each replica's own auto-seed counter
        would pick a different one on the re-drive).  Greedy and
        explicitly-seeded requests pass through untouched."""
        try:
            if (body.get("seed") is None
                    and float(body.get("temperature") or 0.0) > 0):
                body["seed"] = next(self._auto_seed)
        except (TypeError, ValueError):
            pass   # malformed sampling params: the replica 400s them

    def _replay_meta(self, body, tokens):
        """The ``:resume`` ``replay`` object for a journaled session:
        :func:`kvtransfer.wire_snapshot` key names, minus the kv-layout
        fields a token-record replay does not need."""
        prompt = [int(t) for t in body["inputs"][0]]
        max_new = int(body.get("max_new_tokens", 16))
        return {"seq": prompt + list(tokens), "plen": len(prompt),
                "max_new": max_new, "remaining": max_new - len(tokens),
                "temp": float(body.get("temperature") or 0.0),
                "seed": int(body.get("seed") or 0),
                "eos": body.get("eos_id"),
                "topk": int(body.get("top_k") or 0),
                "topp": float(body.get("top_p", 1.0)),
                "minp": float(body.get("min_p") or 0.0),
                "stops": body.get("stop") or [],
                "rep": float(body.get("repetition_penalty", 1.0)),
                "adapter": body.get("adapter"),
                "priority": body.get("priority"),
                "trace": body.get("trace")}

    def _synth_done(self, body, tokens):
        """The ``done`` event for a journaled session that already saw
        its LAST token (the break ate only the final event), or None
        when the session genuinely needs a replay.  Replaying such a
        session would be wrong, not just wasteful: a spliced row checks
        stop conditions only after its next decoded token, so a
        sequence already ending on a stop would overrun it."""
        if not tokens:
            return None
        try:
            prompt = [int(t) for t in body["inputs"][0]]
            max_new = int(body.get("max_new_tokens", 16))
        except (KeyError, IndexError, TypeError, ValueError):
            return None
        eos = body.get("eos_id")
        stops = body.get("stop") or []
        finished = (len(tokens) >= max_new
                    or (eos is not None and tokens[-1] == eos))
        try:
            finished = finished or any(
                st and len(tokens) >= len(st)
                and tokens[-len(st):] == [int(x) for x in st]
                for st in stops)
        except (TypeError, ValueError):
            pass
        if not finished:
            return None
        return {"done": True, "output": prompt + list(tokens)}

    # ---- replica I/O -----------------------------------------------------

    def _request(self, r, method, path, body=None, timeout=None,
                 headers=None):
        """One HTTP exchange with a replica.  Returns the live
        (connection, response) — the caller relays and closes."""
        conn = http.client.HTTPConnection(
            r.host, r.port, timeout=timeout or self.replica_timeout_s)
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs.update(headers)
        try:
            conn.request(method, path, body=body, headers=hdrs)
            return conn, conn.getresponse()
        except Exception:
            conn.close()
            raise

    def probe(self, r, path, timeout=None):
        """GET `path` on a replica, JSON-decoded (stats aggregation)."""
        conn, resp = self._request(r, "GET", path,
                                   timeout=timeout or self.probe_timeout_s)
        try:
            return resp.status, json.loads(resp.read() or b"{}")
        finally:
            conn.close()

    # ---- drain (rolling restarts) ----------------------------------------

    def drain(self, replica_id, timeout_s=60.0, mode="drain"):
        """Stop new admissions to `replica_id`, wait for in-flight work
        (gateway-proxied requests AND the replica's own slot
        generations, via its drain hook), then deregister.  Returns a
        summary dict; ``drained: False`` when the wait timed out (the
        replica is then left DRAINING — re-issue or restart it).

        ``mode="migrate"`` first asks the replica to move its live
        sessions to decode-capable peers via ``POST /v1/kv:export``
        (the streams keep flowing through the source's relay threads),
        then proceeds with the normal drain wait — rolling upgrades
        without dropping streams."""
        with self._lock:
            r = self._replicas.get(str(replica_id))
            if r is None:
                raise KeyError(f"unknown replica {replica_id!r}")
            r.state = DRAINING
        self.counters.inc("drains_started")
        t0 = time.monotonic()
        deadline = t0 + float(timeout_s)
        migration_report = None
        if mode == "migrate":
            with self._lock:
                now = time.monotonic()
                dests = [{"host": d.host, "port": d.port}
                         for d in self._replicas.values()
                         if d.id != r.id and self._routable(d, now)
                         and d.role in ("decode", "mixed")]
            if not dests:
                migration_report = {
                    "error": "no decode-capable peer to migrate to"}
            else:
                try:
                    conn, resp = self._request(
                        r, "POST", "/v1/kv:export",
                        body=json.dumps({"dests": dests}).encode(),
                        timeout=max(0.1, deadline - time.monotonic()))
                    try:
                        migration_report = json.loads(
                            resp.read() or b"{}")
                    finally:
                        conn.close()
                except (OSError, ValueError) as e:
                    migration_report = {"error": str(e)}
        while r.outstanding > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        replica_report = None
        if time.monotonic() < deadline:
            try:
                # the replica-side hook also fences direct (non-gateway)
                # clients and waits for its continuous-batcher slots
                conn, resp = self._request(
                    r, "POST", "/v1/fleet:drain",
                    timeout=max(0.1, deadline - time.monotonic()))
                try:
                    replica_report = json.loads(resp.read() or b"{}")
                finally:
                    conn.close()
            except (OSError, ValueError) as e:
                replica_report = {"error": str(e)}   # dead replica: fine,
                # deregistering it is exactly what the caller wants
        if r.outstanding > 0:
            out = {"drained": False, "replica": r.id,
                   "in_flight": r.outstanding,
                   "waited_s": round(time.monotonic() - t0, 3)}
            if migration_report is not None:
                out["migration"] = migration_report
            return out
        with self._lock:
            self._replicas.pop(r.id, None)
        self.counters.inc("drains_completed")
        out = {"drained": True, "replica": r.id,
               "waited_s": round(time.monotonic() - t0, 3),
               "replica_report": replica_report}
        if migration_report is not None:
            out["migration"] = migration_report
        return out

    # ---- observability ---------------------------------------------------

    def ready(self):
        with self._lock:
            return any(self._routable(r) for r in self._replicas.values())

    def fleet_stats(self, probe=True):
        """The ``GET /v1/fleet`` body: per-replica state (+ proxied
        replica ``stats()`` when `probe`), gateway counters, and
        fleet-wide totals."""
        beats = self._registry.last_beats()
        now = time.monotonic()
        with self._lock:
            snap = {rid: (r, r.describe())
                    for rid, r in self._replicas.items()}
        totals = {"slots": 0, "slots_busy": 0, "queue_depth": 0,
                  "prefill_tokens_shared": 0, "prefix_pages_cached": 0,
                  "kv_pages_used": 0, "kv_pages_free": 0,
                  "kv_sink_writes": 0,
                  # hierarchical kv cache: page-granular hit/miss and
                  # host-tier traffic sum across replicas (a dense or
                  # tier-less replica contributes 0 to each)
                  "prefix_hits": 0, "prefix_misses": 0, "host_hits": 0,
                  "host_demotions": 0, "host_evictions": 0,
                  "host_cache_bytes": 0, "host_pages_cached": 0,
                  # paged prefill path split: Pallas kernel dispatches
                  # vs blend fallbacks sum across replicas (dense
                  # replicas contribute 0 to both)
                  "prefill_kernel_dispatches": 0,
                  "prefill_blend_fallbacks": 0,
                  # long-context serving: table growth, overflow demote
                  # pressure, and lane traffic sum across replicas (a
                  # replica without the mega-prompt lane contributes 0)
                  "kv_table_grows": 0, "kv_pages_demoted_overflow": 0,
                  "long_prompts_active": 0, "long_chunks_dispatched": 0,
                  "ttft_count": 0, "ttft_ms_sum": 0.0,
                  "decode_steps": 0, "pipeline_depth_peak": 0,
                  "migrations_started": 0, "migrations_completed": 0,
                  "migrations_failed": 0, "kv_pages_exported": 0,
                  # multi-tenant scheduling: park traffic sums across
                  # replicas; per-class latency follows the TTFT rule —
                  # only count/sum are summable (a replica that served
                  # no traffic in a class contributes 0, so an idle
                  # class on one replica can't poison fleet averages)
                  "parked_sessions": 0, "sessions_parked": 0,
                  "sessions_unparked": 0, "park_spills": 0,
                  # weight-only quantization (serve metadata's cached
                  # generate_quantize block): resident quantized weight
                  # bytes and their float-equivalent sum across probed
                  # replicas (unquantized replicas contribute 0)
                  "weight_bytes": 0, "weight_float_equivalent_bytes": 0,
                  # speculative decoding: proposal/acceptance volume
                  # sums across replicas (a spec-off replica contributes
                  # 0); the fleet accept rate derives from the summed
                  # counts below, never from averaging per-replica rates
                  "spec_rounds": 0, "spec_tokens_proposed": 0,
                  "spec_tokens_accepted": 0, "spec_draft_fallbacks": 0,
                  # offline bulk jobs: gateway-side progress (replicas
                  # see only ordinary batch-class requests, so these
                  # keys are filled from the JobManager below, not
                  # summed from probes; 0 when jobs are disabled)
                  "jobs_active": 0, "jobs_records_done": 0,
                  "jobs_records_failed": 0}
        for cls in PRIORITY_CLASSES:
            totals[f"ttft_{cls}_count"] = 0
            totals[f"ttft_{cls}_ms_sum"] = 0.0
            totals[f"qdelay_{cls}_count"] = 0
            totals[f"qdelay_{cls}_ms_sum"] = 0.0
        hist_acc = {}        # "<stem>_hist" -> per-replica histograms
        for rid, (r, desc) in snap.items():
            if rid in beats:
                desc["last_beat_age_s"] = round(now - beats[rid], 3)
            totals["slots"] += desc["n_slots"]
            if probe and r.state != EJECTED:
                try:
                    _, meta = self.probe(
                        r, f"/v1/models/{r.model_name}")
                    model = meta.get("model") or {}
                    desc["model"] = model
                    gstats = model.get("generate_stats") or {}
                    totals["slots_busy"] += int(
                        gstats.get("slots_busy") or 0)
                    totals["queue_depth"] += int(gstats.get("pending") or 0)
                    totals["prefill_tokens_shared"] += int(
                        gstats.get("prefill_tokens_shared") or 0)
                    totals["prefix_pages_cached"] += int(
                        gstats.get("prefix_pages_cached") or 0)
                    qinfo = model.get("generate_quantize") or {}
                    totals["weight_bytes"] += int(
                        qinfo.get("weight_bytes") or 0)
                    totals["weight_float_equivalent_bytes"] += int(
                        qinfo.get("float_equivalent_bytes") or 0)
                    # kv-pool occupancy across the fleet (paged replicas
                    # report these; dense ones contribute 0)
                    for key in ("kv_pages_used", "kv_pages_free",
                                "kv_sink_writes",
                                "prefix_hits", "prefix_misses",
                                "host_hits", "host_demotions",
                                "host_evictions", "host_cache_bytes",
                                "host_pages_cached",
                                "prefill_kernel_dispatches",
                                "prefill_blend_fallbacks",
                                "kv_table_grows",
                                "kv_pages_demoted_overflow",
                                "long_prompts_active",
                                "long_chunks_dispatched",
                                "spec_rounds", "spec_tokens_proposed",
                                "spec_tokens_accepted",
                                "spec_draft_fallbacks"):
                        totals[key] += int(gstats.get(key) or 0)
                    # TTFT: only count/sum are summable across replicas
                    # (exact percentiles aren't — the fleet-wide view
                    # comes from the merged *_hist bucket counts below,
                    # which ARE summable; each replica still keeps its
                    # exact window p50/p95 in its own stats snapshot)
                    totals["ttft_count"] += int(
                        gstats.get("ttft_count") or 0)
                    totals["ttft_ms_sum"] += float(
                        gstats.get("ttft_ms_sum") or 0.0)
                    # decode-engine pipeline health: total steps sum;
                    # depth peak is a high-water mark, so MAX across
                    # replicas (a sum would be meaningless)
                    totals["decode_steps"] += int(
                        gstats.get("decode_steps") or 0)
                    totals["pipeline_depth_peak"] = max(
                        totals["pipeline_depth_peak"],
                        int(gstats.get("pipeline_depth_peak") or 0))
                    # kv-migration traffic: counts sum across replicas
                    # (source counts started/completed/failed + pages
                    # exported; destinations count their own imports in
                    # per-replica stats)
                    for key in ("migrations_started",
                                "migrations_completed",
                                "migrations_failed",
                                "kv_pages_exported",
                                "parked_sessions", "sessions_parked",
                                "sessions_unparked", "park_spills"):
                        totals[key] += int(gstats.get(key) or 0)
                    for cls in PRIORITY_CLASSES:
                        for stem in (f"ttft_{cls}", f"qdelay_{cls}"):
                            totals[f"{stem}_count"] += int(
                                gstats.get(f"{stem}_count") or 0)
                            totals[f"{stem}_ms_sum"] += float(
                                gstats.get(f"{stem}_ms_sum") or 0.0)
                    for key, val in gstats.items():
                        if (key.endswith("_hist")
                                and isinstance(val, dict) and "le" in val):
                            hist_acc.setdefault(key, []).append(val)
                except (OSError, ValueError) as e:
                    desc["probe_error"] = str(e)
        # the fleet-p95 gap: replica-window percentiles don't compose,
        # but fixed-bucket histograms do — merge each latency family's
        # buckets across replicas and estimate quantiles from the sum
        # (histogram_quantile semantics: interpolated within a bucket)
        for key in sorted(hist_acc):
            merged = LatencyWindow.merge_histograms(hist_acc[key])
            if merged is None:
                continue
            stem = key[:-len("_hist")]
            totals[key] = merged
            totals[f"{stem}_p50_est_ms"] = \
                LatencyWindow.quantile_from_histogram(merged, 0.50)
            totals[f"{stem}_p95_est_ms"] = \
                LatencyWindow.quantile_from_histogram(merged, 0.95)
        totals["ttft_ms_sum"] = round(totals["ttft_ms_sum"], 3)
        totals["ttft_avg_ms"] = (
            round(totals["ttft_ms_sum"] / totals["ttft_count"], 3)
            if totals["ttft_count"] else 0.0)
        # fleet accept rate from the summed counts (averaging per-replica
        # rates would weight an idle replica equal to a busy one)
        totals["spec_accept_rate"] = (
            round(totals["spec_tokens_accepted"]
                  / totals["spec_tokens_proposed"], 4)
            if totals["spec_tokens_proposed"] else 0.0)
        for cls in PRIORITY_CLASSES:
            for stem in (f"ttft_{cls}", f"qdelay_{cls}"):
                n = totals[f"{stem}_count"]
                totals[f"{stem}_ms_sum"] = round(
                    totals[f"{stem}_ms_sum"], 3)
                totals[f"{stem}_avg_ms"] = (
                    round(totals[f"{stem}_ms_sum"] / n, 3) if n else 0.0)
        if self.jobs is not None:
            totals.update(self.jobs.stats())
        with self._lock:
            prefix_tokens = self._prefix_tokens
            tenants_inflight = dict(self._tenant_inflight)
        return {"replicas": {rid: desc for rid, (_, desc) in snap.items()},
                "totals": totals,
                "counters": self.counters.snapshot(),
                "gateway": {"prefix_tokens": prefix_tokens,
                            "heartbeat_timeout_s": self.heartbeat_timeout_s,
                            "queue_depth_factor": self.queue_depth_factor,
                            "breaker_threshold": self.breaker_threshold,
                            "ejection_misses": self.ejection_misses,
                            "readmit_cooldown_s": self.readmit_cooldown_s,
                            "journal_depth": len(self.journal),
                            "tenant_quota": self.tenant_quota,
                            "tenants_inflight": tenants_inflight,
                            "spill_wait_s": self.spill_wait_s,
                            "wfq_depth": len(self._wfq),
                            "retry_after_cap_s": self.retry_after_cap_s,
                            "registry": list(self.registry_addr or ())}}

    def metrics_text(self, probe=True):
        """Prometheus text exposition for ``GET /metrics``: the
        gateway's own counters + trace-ring gauges, the merged fleet
        totals (incl. the merged-histogram quantile estimates), and —
        with `probe` — one ``{replica="<id>"}``-labeled group per live
        replica, so a single gateway scrape covers the whole fleet."""
        stats = self.fleet_stats(probe=probe)
        gw_stats = dict(stats["counters"])
        gw_stats.update(self.trace.stats())
        groups = [("gateway", None, gw_stats),
                  ("fleet", None, stats["totals"])]
        for rid, desc in sorted(stats["replicas"].items()):
            gstats = (desc.get("model") or {}).get("generate_stats")
            if gstats:
                groups.append(("replica", {"replica": rid}, gstats))
        return prometheus_text(groups)

    def trace_timeline(self, trace_id):
        """One stitched timeline for `trace_id`: the gateway's own
        route/relay/replay spans plus every replica's — including a
        migration destination's, since the id rides the wire snapshot
        meta — tagged by source and time-sorted.  Clocks are
        per-process monotonic, so cross-source ordering is best-effort;
        within one source it is exact."""
        spans = [dict(s, source="gateway")
                 for s in self.trace.spans(trace_id)]
        with self._lock:
            replicas = list(self._replicas.values())
        errors = {}
        for r in replicas:
            if r.state == EJECTED:
                continue
            try:
                status, out = self.probe(r, f"/v1/trace/{trace_id}")
                if status != 200:
                    raise ValueError(f"status {status}")
            except (OSError, ValueError) as e:
                # a silent replica costs coverage, never the endpoint
                errors[r.id] = str(e)
                continue
            for s in out.get("spans") or ():
                if isinstance(s, dict):
                    spans.append(dict(s, source=r.id))
        spans.sort(key=lambda s: s.get("t0_ms") or 0.0)
        out = {"id": trace_id, "spans": spans,
               "sources": sorted({s["source"] for s in spans}),
               "stages": sorted({s.get("name") for s in spans
                                 if s.get("name")})}
        if errors:
            out["probe_errors"] = errors
        return out


class NoReplica(RuntimeError):
    """Nothing the gateway could route to: no replicas registered, or
    every registered one is dead/draining (typed 503 + Retry-After)."""


class Saturated(RuntimeError):
    """Replicas exist but none can admit right now (429 + Retry-After)."""


def _hrw(replica_id, key):
    """Rendezvous weight of (replica, key) — the affine replica is the
    argmax over replicas.  sha256 for stable cross-process hashing
    (``hash()`` is per-process salted)."""
    h = hashlib.sha256(repr((replica_id, key)).encode())
    return int.from_bytes(h.digest()[:8], "big")


class _GatewayHandler(BaseHTTPRequestHandler):
    gateway = None           # injected by Gateway.start
    protocol_version = "HTTP/1.1"

    # -- helpers --

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
        body = text.encode("utf-8")
        self.send_response(code)
        # the version=0.0.4 content type Prometheus scrapers expect
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reject(self, e):
        gw = self.gateway
        retry_after = str(round(gw._retry_after(), 3))
        if isinstance(e, Saturated):
            gw.counters.inc("rejected_429")
            self._send(429, {"error": str(e), "type": "saturated"},
                       headers=[("Retry-After", retry_after)])
        else:
            gw.counters.inc("rejected_no_replica")
            # Retry-After here too: an all-dead fleet usually heals (a
            # readmission or re-REG), so tell clients when to come back
            self._send(503, {"error": str(e), "type": "no_replica"},
                       headers=[("Retry-After", retry_after)])

    def _relay(self, conn, resp):
        """Copy a replica response through verbatim — streamed chunk by
        chunk when the replica streams (the :generate ndjson path), one
        Content-Length body otherwise."""
        try:
            chunked = "chunked" in (resp.getheader("Transfer-Encoding")
                                    or "").lower()
            ctype = resp.getheader("Content-Type", "application/json")
            self.send_response(resp.status)
            self.send_header("Content-Type", ctype)
            if chunked:
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                while True:
                    piece = resp.read(16384)
                    if not piece:
                        break
                    self.wfile.write(f"{len(piece):X}\r\n".encode()
                                     + piece + b"\r\n")
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")
            else:
                data = resp.read()
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
        finally:
            conn.close()

    def _forward_once(self, r, path, body, headers=None):
        """One proxied POST to `r`.  Returns (ok, conn, resp);
        ``ok=False`` (connect error or 5xx) has already updated the
        breaker and closed the connection."""
        gw = self.gateway
        try:
            faults.check("fleet.forward")
            conn, resp = gw._request(r, "POST", path, body=body,
                                     headers=headers)
        except OSError as e:
            gw._release(r, ok=False)
            return False, None, e
        if resp.status >= 500:
            err = RuntimeError(
                f"replica {r.id} returned {resp.status}: "
                f"{resp.read(2048)!r}")
            conn.close()
            gw._release(r, ok=False)
            return False, None, err
        return True, conn, resp

    # -- streaming :generate with session recovery --

    def _begin_stream(self):
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

    def _chunk(self, data):
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _end_stream(self):
        try:
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            pass

    def _stream_generate(self, body, name, tenant="anonymous",
                         cls="interactive"):
        """Streaming :generate is RECOVERABLE: the journal holds the
        seeded request and every token the client saw, so replica death
        re-drives the session onto a live peer instead of 502ing the
        stream (non-streaming :generate keeps the typed fail-fast —
        its client never saw partial output and can simply retry)."""
        gw = self.gateway
        gw._seed_body(body)
        # priority rides the JOURNALED body: a re-drive after replica
        # death must admit under the same class the first drive did
        body.setdefault("priority", cls)
        # ...and so does the trace id (client-sent via body/X-Trace-Id,
        # minted here otherwise): every re-drive and every migration
        # destination records under the SAME id, which is what lets
        # GET /v1/trace/<id> stitch one timeline out of all of them
        if not trace.valid_id(body.get("trace")):
            hdr = self.headers.get("X-Trace-Id")
            body["trace"] = hdr if trace.valid_id(hdr) else trace.new_id()
        entry = gw.journal.journal_open(body)
        try:
            self._drive_stream(entry, name, tenant, cls)
        finally:
            gw.journal.journal_close(entry)

    def _drive_stream(self, entry, name, tenant="anonymous",
                      cls="interactive"):
        """Drive `entry`'s stream to completion: attempt on a chosen
        replica, and on failure re-drive — fresh :generate when no
        token was emitted yet, ``:resume``-replay otherwise — until the
        done event lands, attempts run out, or the recovery deadline
        passes.  A mid-stream session with NOTHING routable waits (the
        journal is its queue) for a readmission to rescue it."""
        gw, body = self.gateway, entry["body"]
        tid = body.get("trace")
        state = {"started": False}
        deadline = time.monotonic() + gw.redrive_deadline_s
        failed = set()
        attempt = 0
        last_err = None
        while True:
            ev = gw._synth_done(body, entry["tokens"])
            if ev is not None:
                # the break ate only the final done event; rebuild it
                if not state["started"]:
                    self._begin_stream()
                    state["started"] = True
                self._chunk(json.dumps(ev).encode() + b"\n")
                self._end_stream()
                return
            t_route = time.monotonic()
            try:
                try:
                    r = gw._choose_degraded(
                        tenant, cls, prefix_key=gw.prefix_key(body),
                        roles=("prefill", "mixed"), exclude=failed,
                        prompt_len=gw.prompt_len_of(body))
                except (NoReplica, Saturated):
                    if not failed:
                        raise
                    failed = set()   # only known-bad picks left: any
                    r = gw._choose_degraded(
                        tenant, cls, prefix_key=gw.prefix_key(body),
                        roles=("prefill", "mixed"),
                        prompt_len=gw.prompt_len_of(body))
            except (NoReplica, Saturated) as e:
                if not state["started"]:
                    # nothing sent yet: fail FAST (typed 503/429 with
                    # Retry-After), never park a fresh request
                    if attempt == 0:
                        self._reject(e)
                    else:
                        self._finish_failed(state, last_err or e)
                    return
                if time.monotonic() >= deadline:
                    self._finish_failed(state, e)
                    return
                # mid-stream limbo: the journaled session queues here
                # until a replica readmits (or the deadline passes)
                gw.counters.inc("redrive_waits")
                time.sleep(min(0.25,
                               max(0.0, deadline - time.monotonic())))
                continue
            # gateway.route covers the WFQ wait too: _choose_degraded
            # blocks inside the fair queue when the class is saturated
            gw.trace.span_at(tid, "gateway.route", t_route,
                             time.monotonic(), replica=r.id, cls=cls,
                             attempt=attempt)
            if attempt:
                gw.counters.inc("session_redrives")
                gw.trace.event(tid, "gateway.replay", replica=r.id,
                               attempt=attempt,
                               tokens_journaled=len(entry["tokens"]))
            t_relay = time.monotonic()
            ok, err = self._attempt_stream(r, entry, state, name)
            gw.trace.span_at(tid, "gateway.relay", t_relay,
                             time.monotonic(), replica=r.id,
                             attempt=attempt, ok=bool(ok))
            if ok:
                if attempt:
                    gw.counters.inc("sessions_recovered")
                if state["started"]:
                    self._end_stream()
                return
            failed.add(r.id)
            last_err = err
            attempt += 1
            if (attempt >= gw.redrive_attempts
                    or time.monotonic() >= deadline):
                self._finish_failed(state, last_err)
                return
            time.sleep(gw._redrive_backoff.delay(attempt - 1))

    def _attempt_stream(self, r, entry, state, name):
        """One try at `entry`'s stream on `r`.  Returns ``(done, err)``;
        ``done`` means the stream finished (delivered or verdict
        relayed) and must not be re-driven.  Already-emitted tokens
        turn the try into a ``:resume`` replay whose splice ack is
        swallowed — the client's ndjson stream continues seamlessly."""
        gw = self.gateway
        is_replay = bool(entry["tokens"])
        hdrs = {"Idempotency-Key": entry["key"]}
        if is_replay:
            path = f"/v1/models/{name}:resume"
            payload = json.dumps({"replay": gw._replay_meta(
                entry["body"], entry["tokens"])}).encode()
        else:
            path = f"/v1/models/{name}:generate"
            payload = json.dumps(entry["body"]).encode()
            dest = gw.migrate_target(r)
            if dest is not None:
                # disaggregation handoff rides the first drive only; a
                # replay already lands on a decode-capable pick
                hdrs["X-Fleet-Migrate-To"] = f"{dest.host}:{dest.port}"
            peer = gw.kv_peer_for(gw.prefix_key(entry["body"]), r)
            if peer is not None:
                # hierarchical kv cache: the replica pulls the
                # conversation's demoted pages from the affine peer's
                # host tier before prefilling
                hdrs["X-Fleet-KV-Peer"] = peer
        try:
            faults.check("fleet.forward")
            conn, resp = gw._request(r, "POST", path, body=payload,
                                     headers=hdrs)
        except OSError as e:
            gw._release(r, ok=False)
            return False, e
        ok, err = False, None
        expect_ack = is_replay
        try:
            if resp.status >= 500:
                err = RuntimeError(f"replica {r.id} returned "
                                   f"{resp.status}: {resp.read(2048)!r}")
                return False, err
            if resp.status != 200:
                if is_replay:
                    # the peer refused the replay (pool too small, bad
                    # layout): another peer may take it
                    err = RuntimeError(
                        f"replica {r.id} refused replay: "
                        f"{resp.status} {resp.read(2048)!r}")
                    return False, err
                # the replica rejected the request itself (4xx): relay
                # the verdict — a re-drive would be rejected identically
                data = resp.read()
                self.send_response(resp.status)
                self.send_header("Content-Type",
                                 resp.getheader("Content-Type",
                                                "application/json"))
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                ok = True
                return True, None
            while True:
                try:
                    faults.check("fleet.relay")
                    line = resp.readline()
                except (OSError, ValueError) as e:
                    err = e
                    return False, e
                if not line:
                    err = RuntimeError(f"replica {r.id} ended the "
                                       "stream without done")
                    return False, err
                try:
                    ev = json.loads(line)
                except ValueError as e:
                    err = e
                    return False, e
                if "error" in ev:
                    # replica-side engine trouble mid-stream — exactly
                    # the crash shape recovery exists for
                    err = RuntimeError(str(ev["error"]))
                    return False, err
                if expect_ack:
                    expect_ack = False
                    if ev.get("resumed"):
                        continue      # swallow the splice ack
                    err = RuntimeError(f"replica {r.id} did not ack "
                                       "the replay")
                    return False, err
                if "token" in ev:
                    # the journaling tee: recorded BEFORE the client
                    # write, so a token the client may have seen is
                    # never replayed as fresh
                    gw.journal.record(entry, ev["token"])
                if not state["started"]:
                    self._begin_stream()
                    state["started"] = True
                # client-side write failures propagate out: the CLIENT
                # is gone, there is nothing left to recover for
                self._chunk(line if line.endswith(b"\n")
                            else line + b"\n")
                if ev.get("done"):
                    ok = True
                    return True, None
        finally:
            conn.close()
            gw._release(r, ok=ok or err is None)

    def _finish_failed(self, state, err):
        gw = self.gateway
        gw.counters.inc("generate_failures")
        payload = {"error": str(err), "type": "replica_failure",
                   "retryable": True}
        if state["started"]:
            try:
                self._chunk(json.dumps(payload).encode() + b"\n")
            except OSError:
                pass
            self._end_stream()
        else:
            self._send(502, payload)

    # -- HTTP surface --

    def do_GET(self):
        gw = self.gateway
        path = urllib.parse.urlsplit(self.path).path
        if path == "/healthz":               # gateway process liveness
            self._send(200, {"status": "ok"})
        elif path == "/readyz":              # can we route anything?
            if gw.ready():
                self._send(200, {"status": "ok"})
            else:
                self._send(503, {"status": "unavailable",
                                 "error": "no routable replica"})
        elif path in ("/", "/v1/fleet"):
            qs = urllib.parse.parse_qs(urllib.parse.urlsplit(self.path).query)
            probe = qs.get("probe", ["1"])[0] not in ("0", "false")
            self._send(200, gw.fleet_stats(probe=probe))
        elif path in ("/metrics", "/v1/metrics"):
            qs = urllib.parse.parse_qs(urllib.parse.urlsplit(self.path).query)
            probe = qs.get("probe", ["1"])[0] not in ("0", "false")
            try:
                # an exporter failure 500s the SCRAPE only — serving
                # never routes through this path
                faults.check("trace.export")
                text = gw.metrics_text(probe=probe)
            except Exception as e:
                self._send(500, {"error": f"metrics export failed: {e}"})
                return
            self._send_text(200, text)
        elif path.startswith("/v1/trace/"):
            tid = path[len("/v1/trace/"):]
            if not trace.valid_id(tid):
                self._send(400, {"error": "invalid trace id"})
                return
            try:
                faults.check("trace.export")
                out = gw.trace_timeline(tid)
            except Exception as e:
                self._send(500, {"error": f"trace export failed: {e}"})
                return
            self._send(200, out)
        elif path == "/v1/jobs":
            if gw.jobs is None:
                self._send(503, {"error": "bulk jobs disabled (start "
                                 "the gateway with --jobs_dir)"})
                return
            self._send(200, {"jobs": gw.jobs.list()})
        elif path.startswith("/v1/jobs/"):
            if gw.jobs is None:
                self._send(503, {"error": "bulk jobs disabled (start "
                                 "the gateway with --jobs_dir)"})
                return
            jid = path[len("/v1/jobs/"):]
            try:
                self._send(200, gw.jobs.status(jid))
            except KeyError:
                self._send(404, {"error": f"unknown job {jid!r}"})
        elif path.startswith("/v1/models/"):
            # metadata passthrough: any one healthy replica's view
            try:
                r = gw._choose()
            except (NoReplica, Saturated) as e:
                self._reject(e)
                return
            try:
                conn, resp = gw._request(r, "GET", self.path,
                                         timeout=gw.probe_timeout_s)
            except OSError as e:
                gw._release(r, ok=False)
                self._send(502, {"error": f"replica {r.id}: {e}",
                                 "type": "replica_failure",
                                 "replica": r.id})
                return
            try:
                self._relay(conn, resp)
            finally:
                gw._release(r, ok=True)
        else:
            self._send(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        gw = self.gateway
        split = urllib.parse.urlsplit(self.path)
        path = split.path
        if path in ("/v1/fleet:drain", "/v1/fleet:migrate"):
            qs = urllib.parse.parse_qs(split.query)
            rid = (qs.get("replica") or [None])[0]
            if not rid:
                self._send(400, {"error": "missing ?replica=<id>"})
                return
            timeout_s = float((qs.get("timeout_s") or ["60"])[0])
            mode = "migrate" if path.endswith(":migrate") else "drain"
            try:
                out = gw.drain(rid, timeout_s=timeout_s, mode=mode)
            except KeyError as e:
                self._send(404, {"error": str(e)})
                return
            self._send(200 if out["drained"] else 504, out)
            return
        if path == "/v1/jobs" or (path.startswith("/v1/jobs/")
                                  and path.endswith(":cancel")):
            if gw.jobs is None:
                self._send(503, {"error": "bulk jobs disabled (start "
                                 "the gateway with --jobs_dir)"})
                return
            if path == "/v1/jobs":
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length) if length else b"{}"
                try:
                    spec = json.loads(raw)
                except ValueError as e:
                    self._send(400, {"error": f"bad job spec: {e}"})
                    return
                tid_hdr = self.headers.get("X-Trace-Id")
                if (isinstance(spec, dict) and "trace" not in spec
                        and tid_hdr and trace.valid_id(tid_hdr)):
                    # header form of the trace id, mirroring :generate —
                    # job.partition/job.record spans land under it
                    spec["trace"] = tid_hdr
                try:
                    out = gw.jobs.submit(spec,
                                         tenant=gw.tenant_of(self.headers))
                except (ValueError, TypeError) as e:
                    self._send(400, {"error": str(e)})
                    return
                except jobs_mod.JobError as e:
                    self._send(503, {"error": str(e)})
                    return
                self._send(200, out)
            else:
                jid = path[len("/v1/jobs/"):-len(":cancel")]
                try:
                    self._send(200, gw.jobs.cancel(jid))
                except KeyError:
                    self._send(404, {"error": f"unknown job {jid!r}"})
            return
        if path == "/v1/debug:profile":
            # on-demand profiling, proxied to one replica
            # (?replica=<id> pins it; default: any routable pick).
            # Not quota-fenced — operators profile DURING incidents.
            qs = urllib.parse.parse_qs(split.query)
            rid = (qs.get("replica") or [None])[0]
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length else b"{}"
            chosen = False
            if rid:
                with gw._lock:
                    r = gw._replicas.get(rid)
                if r is None:
                    self._send(404, {"error": f"unknown replica {rid!r}"})
                    return
            else:
                try:
                    r = gw._choose()
                    chosen = True
                except (NoReplica, Saturated) as e:
                    self._reject(e)
                    return
            try:
                # direct relay, NOT _forward_once: the replica's verdict
                # (200 with its trace, 409 while a capture runs, 503 when
                # its profiler raises) must reach the operator without
                # tripping the breaker
                conn, resp = gw._request(r, "POST", "/v1/debug:profile",
                                         body=body, timeout=30.0)
            except OSError as e:
                if chosen:
                    gw._release(r, ok=False)
                self._send(502, {"error": f"replica {r.id}: {e}",
                                 "type": "replica_failure",
                                 "replica": r.id})
                return
            try:
                self._relay(conn, resp)
            finally:
                if chosen:
                    gw._release(r, ok=True)
            return
        is_predict = path.startswith("/v1/models/") and \
            path.endswith(":predict")
        is_generate = path.startswith("/v1/models/") and \
            path.endswith(":generate")
        if not (is_predict or is_generate):
            self._send(404, {"error": f"unknown path {self.path}"})
            return
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length) if length else b"{}"
        # tenant identity + admission quota wrap the WHOLE request
        # lifetime (routing through relay), so a tenant's concurrency
        # cap counts streams for as long as they hold a replica slot
        tenant = gw.tenant_of(self.headers)
        cls = gw.class_of(self.headers, tenant)
        try:
            gw._quota_admit(tenant)
        except Saturated as e:
            self._reject(e)
            return
        try:
            self._route_models(gw, path, body, is_generate, tenant, cls)
        finally:
            gw._quota_release(tenant)

    def _route_models(self, gw, path, body, is_generate, tenant, cls):
        prefix_key = None
        if is_generate:
            body_obj = None
            try:
                body_obj = json.loads(body)
            except ValueError:
                pass                # replica will 400 the bad JSON
            if isinstance(body_obj, dict) and body_obj.get("stream"):
                # streaming sessions ride the journaled recovery path:
                # replica death costs latency, not the stream
                name = path[len("/v1/models/"):-len(":generate")]
                self._stream_generate(body_obj, name, tenant, cls)
                return
            if isinstance(body_obj, dict):
                prefix_key = gw.prefix_key(body_obj)
                rewrite = False
                if "priority" not in body_obj:
                    # plant the resolved class so the replica's batcher
                    # admits under it (explicit body values win)
                    body_obj["priority"] = cls
                    rewrite = True
                # a client-sent X-Trace-Id is planted into the body so
                # the replica records under it; absent both, the
                # request runs untraced (non-stream responses have no
                # event to carry a summary, so minting buys nothing)
                tid_hdr = self.headers.get("X-Trace-Id")
                if ("trace" not in body_obj and tid_hdr
                        and trace.valid_id(tid_hdr)):
                    body_obj["trace"] = tid_hdr
                    rewrite = True
                if rewrite:
                    body = json.dumps(body_obj).encode()
        try:
            # :generate prefers prefill-capable replicas; when the pick
            # is a dedicated prefill node, plant the handoff header so
            # the replica migrates the session to a decode peer once
            # first tokens flush (the stream keeps riding this proxied
            # connection via the source's relay thread)
            roles = ("prefill", "mixed") if is_generate else None
            t_route = time.monotonic()
            plen = (gw.prompt_len_of(body_obj)
                    if is_generate and isinstance(body_obj, dict) else 0)
            r = gw._choose_degraded(tenant, cls, prefix_key=prefix_key,
                                    roles=roles, prompt_len=plen)
        except (NoReplica, Saturated) as e:
            self._reject(e)
            return
        if is_generate and isinstance(body_obj, dict):
            gw.trace.span_at(body_obj.get("trace"), "gateway.route",
                             t_route, time.monotonic(), replica=r.id,
                             cls=cls)
        headers = None
        if is_generate:
            dest = gw.migrate_target(r)
            if dest is not None:
                headers = {"X-Fleet-Migrate-To":
                           f"{dest.host}:{dest.port}"}
            peer = gw.kv_peer_for(prefix_key, r)
            if peer is not None:
                headers = headers or {}
                headers["X-Fleet-KV-Peer"] = peer
        ok, conn, resp_or_err = self._forward_once(r, self.path, body,
                                                   headers=headers)
        if ok:
            try:
                self._relay(conn, resp_or_err)
            finally:
                gw._release(r, ok=True)
            return
        if is_generate:
            # NOT idempotent (sampling state, partial streams): fail
            # fast with a typed error instead of silently re-running
            gw.counters.inc("generate_failures")
            self._send(502, {"error": str(resp_or_err),
                             "type": "replica_failure", "replica": r.id,
                             "retryable": True})
            return
        # predict is idempotent, so retrying is safe; the shared
        # RetryPolicy (attempts=2, no backoff) IS the hedged retry —
        # one immediate second try on a DIFFERENT replica
        policy = util.RetryPolicy(attempts=2, base_delay=0.0,
                                  cap_delay=0.0)
        last_err, last_r = resp_or_err, r
        for attempt in policy.sleeps():
            if attempt == 0:
                continue            # the first try already failed above
            gw.counters.inc("hedged_retries")
            try:
                r2 = gw._choose(exclude=(r.id,))
            except (NoReplica, Saturated):
                self._send(502, {"error": f"replica {r.id} failed and "
                                 f"no alternative is admitting: "
                                 f"{resp_or_err}",
                                 "type": "replica_failure",
                                 "replica": r.id})
                return
            ok2, conn2, resp_or_err2 = self._forward_once(r2, self.path,
                                                          body)
            if ok2:
                try:
                    self._relay(conn2, resp_or_err2)
                finally:
                    gw._release(r2, ok=True)
                return
            last_err, last_r = resp_or_err2, r2
        self._send(502, {"error": f"retry on {last_r.id} failed too: "
                         f"{last_err}",
                         "type": "replica_failure", "replica": last_r.id})

    def log_message(self, fmt, *args):
        logger.debug("fleet http: " + fmt, *args)


def build_argparser():
    p = argparse.ArgumentParser(
        prog="tensorflowonspark_tpu_torch.fleet",
        description="multi-replica serving gateway (reservation-based "
                    "registration, prefix-affine routing, graceful drain)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500,
                   help="gateway HTTP port (0 = ephemeral)")
    p.add_argument("--registry_host", default=None,
                   help="bind host of the reservation-plane registry "
                        "(default: --host)")
    p.add_argument("--registry_port", type=int, default=8400,
                   help="registry port replicas register with "
                        "(serve --fleet HOST:THIS; 0 = ephemeral)")
    p.add_argument("--heartbeat_timeout_s", type=float, default=10.0,
                   help="eject a replica silent for this long; beats "
                        "resuming re-admit it")
    p.add_argument("--ejection_misses", type=int, default=3,
                   help="consecutive over-age monitor sweeps before a "
                        "silent replica is ejected (anti-flap)")
    p.add_argument("--readmit_cooldown_s", type=float, default=None,
                   help="how long beats must stay fresh before an "
                        "ejected replica takes traffic again (default: "
                        "heartbeat_timeout_s / 2)")
    p.add_argument("--redrive_attempts", type=int, default=3,
                   help="total tries per streaming :generate session "
                        "(1 = no crash recovery)")
    p.add_argument("--redrive_deadline_s", type=float, default=30.0,
                   help="wall-time bound on recovering one stream, "
                        "including waits for a replica readmission")
    p.add_argument("--prefix_tokens", type=int, default=None,
                   help=":generate affinity-hash prefix length (default: "
                        "the first registrant's announced kv_page_size, "
                        "else 64)")
    p.add_argument("--queue_depth_factor", type=float, default=2.0,
                   help="per-replica queue bound = factor * n_slots; "
                        "beyond it requests spill, then 429")
    p.add_argument("--breaker_threshold", type=int, default=3,
                   help="consecutive failures that open a replica's "
                        "circuit breaker")
    p.add_argument("--breaker_cooldown_s", type=float, default=5.0)
    p.add_argument("--connect_timeout_s", type=float, default=5.0)
    p.add_argument("--replica_timeout_s", type=float, default=600.0,
                   help="read timeout on proxied replica requests "
                        "(:generate can be long)")
    p.add_argument("--retry_after_cap_s", type=float, default=30.0,
                   help="cap on drain-rate-derived Retry-After values "
                        "(429/503); the floor is retry_after_s")
    p.add_argument("--tenant_quota", type=int, default=0,
                   help="default per-tenant concurrent-request cap "
                        "(0 = unlimited); X-Tenant / X-API-Key names "
                        "the tenant")
    p.add_argument("--tenant_class", action="append", default=None,
                   metavar="TENANT=CLASS",
                   help="server-side tenant->priority-class mapping "
                        "(CLASS one of interactive|batch; repeatable); "
                        "X-Priority on a request overrides it")
    p.add_argument("--spill_wait_s", type=float, default=0.0,
                   help="how long a request may wait out a saturated "
                        "fleet in the weighted-fair queue before its "
                        "429 (0 = reject immediately)")
    p.add_argument("--jobs_dir", default=None,
                   help="spool directory arming the offline bulk-job "
                        "surface (POST /v1/jobs); a restarted gateway "
                        "rescans it and resumes incomplete jobs from "
                        "their partition checkpoints")
    p.add_argument("--job_workers", type=int, default=2,
                   help="default concurrent partition runners per bulk "
                        "job (a job spec's 'workers' overrides it)")
    p.add_argument("--job_checkpoint_every", type=int, default=16,
                   help="records between partition checkpoint writes; "
                        "at most this many records re-dispatch after a "
                        "crash (exactly-once output either way)")
    p.add_argument("--job_record_timeout_s", type=float, default=60.0,
                   help="per-record replica read timeout on the bulk "
                        "dispatch path")
    p.add_argument("--verbose", action="store_true")
    return p


def _parse_tenant_classes(pairs):
    """``--tenant_class A=batch --tenant_class B=interactive`` ->
    ``{"A": "batch", "B": "interactive"}``; bad entries are errors."""
    out = {}
    for pair in pairs or ():
        tenant, sep, cls = str(pair).partition("=")
        if not sep or not tenant or cls not in PRIORITY_CLASSES:
            raise ValueError(
                f"--tenant_class wants TENANT=CLASS with CLASS one of "
                f"{PRIORITY_CLASSES}, got {pair!r}")
        out[tenant] = cls
    return out


def make_gateway(args):
    """Build (and start) a Gateway from parsed args."""
    gw = Gateway(host=args.host, port=args.port,
                 registry_host=args.registry_host,
                 registry_port=args.registry_port,
                 heartbeat_timeout_s=args.heartbeat_timeout_s,
                 prefix_tokens=args.prefix_tokens,
                 queue_depth_factor=args.queue_depth_factor,
                 breaker_threshold=args.breaker_threshold,
                 breaker_cooldown_s=args.breaker_cooldown_s,
                 connect_timeout_s=args.connect_timeout_s,
                 replica_timeout_s=args.replica_timeout_s,
                 ejection_misses=getattr(args, "ejection_misses", 3),
                 readmit_cooldown_s=getattr(args, "readmit_cooldown_s",
                                            None),
                 redrive_attempts=getattr(args, "redrive_attempts", 3),
                 redrive_deadline_s=getattr(args, "redrive_deadline_s",
                                            30.0),
                 retry_after_cap_s=getattr(args, "retry_after_cap_s",
                                           30.0),
                 tenant_quota=getattr(args, "tenant_quota", 0),
                 tenant_classes=_parse_tenant_classes(
                     getattr(args, "tenant_class", None)),
                 spill_wait_s=getattr(args, "spill_wait_s", 0.0),
                 jobs_dir=getattr(args, "jobs_dir", None),
                 job_workers=getattr(args, "job_workers", 2),
                 job_checkpoint_every=getattr(args, "job_checkpoint_every",
                                              16),
                 job_record_timeout_s=getattr(args, "job_record_timeout_s",
                                              60.0))
    gw.start()
    return gw


def main(argv=None):
    args = build_argparser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s")
    gw = make_gateway(args)
    print(f"fleet gateway on http://{gw.http_addr[0]}:{gw.http_addr[1]} "
          f"(replicas register at {gw.registry_addr[0]}:"
          f"{gw.registry_addr[1]})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        gw.stop()


if __name__ == "__main__":
    main()
