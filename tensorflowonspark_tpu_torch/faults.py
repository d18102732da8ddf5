"""Deterministic fault injection for the serving/coordination plane —
a copy of ``tensorflowonspark_tpu/faults.py`` (the port's ``reservation``
probes ``reservation.dial`` / ``.rpc`` / ``.heartbeat``; the serving and
fleet sites stay registered so plans written for the JAX package arm
here unchanged).

Crash-tolerance claims are only as good as the failures they were tested
against, and "unplug a replica by hand" does not compose into CI.  This
module is a seeded, registry-driven fault layer: production code threads
cheap probes through its failure-prone sites —

    faults.check("reservation.dial")          # may raise / delay
    if faults.deny("serve.alloc"):            # may report exhaustion
        return False

— and a test arms a :class:`FaultPlan` that fires at exactly the Nth
matching probe (or with a seeded per-probe probability), injecting a
connection error, EOF, delay, or allocation failure.  Off by default:
a disarmed probe is ONE module-global read and a None-compare, so the
hot paths (per-event relay loops, per-admission allocation) pay nothing
in production.

Sites are a closed registry (:data:`SITES`): arming an unknown site is
an error, so a probe that was renamed or deleted can't silently turn a
chaos test into a no-op.  Every fired injection is logged on
``plan.fired``, which tests assert on to prove the failure they meant
to inject actually happened.

Probe placement contract: a ``check`` raise surfaces exactly like the
real failure at that site would — an ``OSError`` at
``reservation.dial`` looks like a refused connect, a raise at
``serve.admission`` (device thread) kills the slot engine the way a
device fault would (that IS the replica-crash simulation), and a
``fleet.relay`` raise breaks one proxied ndjson stream mid-token,
which is what drives the gateway's session-recovery re-drive.
"""
import contextlib
import random
import threading
import time

# The closed site registry.  One entry per failure-prone site a probe
# guards; grow it in the same change that adds the probe.
SITES = frozenset({
    "reservation.dial",        # Client._dial: fresh TCP connect
    "reservation.rpc",         # Client._request: framed RPC exchange
    "reservation.heartbeat",   # Client beat thread: one BEAT round trip
    "kvtransfer.pull",         # pull_snapshot: page pull over TCP
    "kvtransfer.post_resume",  # MigrationEngine: POST :resume + ack read
    "kvtransfer.relay",        # MigrationEngine._relay: per-event read
    "serve.admission",         # ContinuousBatcher._start_admission (device
                               # thread: a raise kills the engine — the
                               # deterministic replica-crash simulation)
    "serve.alloc",             # ContinuousBatcher._try_allocate (deny =
                               # pool reads as exhausted; admission parks)
    "serve.resume_install",    # ContinuousBatcher._install_resume (device
                               # thread: mid-resume death)
    "fleet.forward",           # gateway _forward_once: proxied POST
    "fleet.relay",             # gateway streaming relay: per-event read
                               # (the Nth-token stream-break site)
    "fleet.quota_check",       # gateway _quota_admit (deny = tenant
                               # reads as over quota; request 429s)
    "serve.park_gather",       # ContinuousBatcher._park_gather: snapshot
                               # wire-out of a preempted session (a raise
                               # rolls the freeze back — session keeps
                               # running)
    "serve.park_restore",      # ContinuousBatcher._park_restore: resume
                               # of a parked session (a raise re-parks it
                               # for a later retry)
    "serve.host_demote",       # ContinuousBatcher._demote_pages (deny =
                               # evicted/retired pages are dropped instead
                               # of demoted to the host tier; later turns
                               # just run cold)
    "serve.host_promote",      # ContinuousBatcher._host_tier_lookup (deny
                               # = a host-tier hit reads as a miss; the
                               # pages prefill normally, byte-identically)
    "serve.table_grow",        # ContinuousBatcher._grow_table (device
                               # thread: a raise kills the engine mid-
                               # growth — the mega-prompt-lane crash
                               # simulation; callers' rollback keeps the
                               # pool conserved)
    "serve.overflow_demote",   # ContinuousBatcher._overflow_reclaim (deny
                               # = the overflow valve reads as empty; the
                               # mega-prompt lane stalls, and on an idle
                               # replica fails TYPED — KVOverflowError /
                               # 503 — instead of wedging admission)
    "kvtransfer.prefix_pull",  # pull_prefix: cross-replica kv:prefix pull
                               # (a raise = peer unreachable; the replica
                               # falls back to its own tier + prefill)
    "jobs.partition_read",     # jobs.iter_partition: opening/scanning one
                               # partition split of a job's input file (a
                               # raise abandons the partition — it requeues
                               # and retries from its checkpoint)
    "jobs.record_dispatch",    # jobs.JobManager._dispatch: one record's
                               # fleet delivery attempt (a raise looks like
                               # a replica dying mid-request; the runner
                               # retries against a peer under the same
                               # Idempotency-Key)
    "jobs.checkpoint_write",   # jobs.JobManager._spool_write: the atomic
                               # tmp+rename of a partition checkpoint or
                               # job.json (bounded retry; exhaustion
                               # abandons the partition, never marks it
                               # durable)
    "serve.spec_verify",       # ContinuousBatcher._dispatch spec gate
                               # (deny/raise = the round falls back to a
                               # plain decode step — tokens byte-identical
                               # by the lossless guarantee, only slower;
                               # counted in spec_draft_fallbacks)
    "trace.export",            # trace.Recorder._push (deny = spans are
                               # dropped silently) and the /metrics +
                               # /v1/trace HTTP exporters (a raise = the
                               # endpoint 500s); serving itself must
                               # never notice either way
})

KINDS = ("oserror", "eof", "delay", "deny")

_PLAN = None     # armed plan; None = disarmed (the zero-overhead path)


class FaultPlan:
    """A seeded set of injection rules.

    ``on(site, kind, nth, times)`` fires ``kind`` at the ``nth``
    matching probe of ``site`` (1-based) and keeps firing for ``times``
    consecutive matches (``times=None`` = every later match).  With
    ``p``, the rule instead fires each probe independently with
    probability ``p`` drawn from the plan's own seeded RNG — the same
    seed replays the same failure schedule, which is what makes a
    100-cycle randomized kill/recover loop debuggable.
    """

    def __init__(self, seed=0):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._rules = []
        self.fired = []      # [(site, kind), ...] — every injection shot
        self._lock = threading.Lock()

    def on(self, site, kind="oserror", nth=1, times=1, delay_s=0.05,
           p=None):
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} "
                             f"(registry: {sorted(SITES)})")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(one of {KINDS})")
        if p is None and nth < 1:
            raise ValueError(f"nth={nth} must be >= 1")
        if times is not None and times < 1:
            raise ValueError(f"times={times} must be >= 1 or None")
        if p is not None and not 0.0 <= p <= 1.0:
            raise ValueError(f"p={p} must be in [0, 1]")
        with self._lock:
            self._rules.append({"site": site, "kind": kind,
                                "nth": int(nth), "times": times,
                                "delay_s": float(delay_s), "p": p,
                                "seen": 0})
        return self

    def _match(self, site, want_deny):
        """The rule firing at this probe, or None.  Counting and the
        seeded RNG both advance under the lock: probes race in from
        HTTP, device, and relay threads, and a torn count would make
        the Nth-match contract nondeterministic."""
        if site not in SITES:
            raise ValueError(f"probe names unregistered site {site!r}")
        with self._lock:
            for rule in self._rules:
                if rule["site"] != site:
                    continue
                if (rule["kind"] == "deny") != want_deny:
                    continue
                if rule["p"] is not None:
                    if self._rng.random() >= rule["p"]:
                        continue
                else:
                    rule["seen"] += 1
                    if rule["seen"] < rule["nth"]:
                        continue
                    if (rule["times"] is not None
                            and rule["seen"] >= rule["nth"] + rule["times"]):
                        continue
                self.fired.append((site, rule["kind"]))
                return rule
        return None


def check(site):
    """Probe a raise/delay fault site.  No-op when disarmed."""
    plan = _PLAN
    if plan is None:
        return
    rule = plan._match(site, want_deny=False)
    if rule is None:
        return
    kind = rule["kind"]
    if kind == "delay":
        time.sleep(rule["delay_s"])
        return
    if kind == "eof":
        raise ConnectionError(f"injected EOF at {site}")
    raise OSError(f"injected fault at {site}")


def deny(site):
    """Probe an allocation-failure site: True = pretend the resource is
    exhausted (callers take their normal park/backpressure path).
    Always False when disarmed."""
    plan = _PLAN
    if plan is None:
        return False
    return plan._match(site, want_deny=True) is not None


def arm(plan):
    """Arm `plan` process-wide.  One plan at a time: chaos tests own the
    process while armed (the suite is marker-gated, never parallel)."""
    global _PLAN
    if plan is not None and not isinstance(plan, FaultPlan):
        raise TypeError(f"arm() wants a FaultPlan, got {type(plan)}")
    _PLAN = plan


def disarm():
    global _PLAN
    _PLAN = None


@contextlib.contextmanager
def active(plan):
    """``with faults.active(plan):`` — arm for the body, always disarm."""
    arm(plan)
    try:
        yield plan
    finally:
        disarm()
