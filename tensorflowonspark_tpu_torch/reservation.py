"""Cluster rendezvous: reservation server + client — counterpart of
``tensorflowonspark_tpu/reservation.py``.

Maps the reference's cleanest component (reference: reservation.py:31-301) with
two deliberate re-designs:

1. **JSON framing, never pickle.**  The reference exchanges pickled dicts
   (reference: reservation.py:68-97); pickle over TCP executes arbitrary
   code from untrusted peers.  The JAX package frames msgpack; msgpack is
   not on every host this port runs on, so the frames here carry UTF-8
   JSON behind the same 4-byte big-endian length prefix, with ``bytes``
   (the manager authkey) tagged and base64-encoded.  Decoding builds
   dicts, lists, strings, numbers and bytes only — no code runs.

2. **The server hands out the distributed bootstrap.**  The reference's
   clients scout free ports and the server aggregates them into a TF
   ClusterSpec.  Here nodes register host metadata and the aggregate
   reservation list yields ``(rendezvous address, world size, rank)`` for
   ``torch.distributed.init_process_group`` (`node.NodeContext.
   init_distributed`).

Message types (reference: reservation.py:130-146 had REG/QUERY/QINFO/STOP):

- ``REG``   {node: {...meta}}          -> ``OK``
- ``QUERY`` {}                         -> ``QUERY`` {done: bool, count: int}
- ``QINFO`` {}                         -> ``QINFO`` {nodes: [...]}
- ``ERROR`` {node, error: str}         -> ``OK``       (net-new: failure detection)
- ``BEAT``  {executor_id}              -> ``OK``       (net-new: liveness heartbeat)
- ``BYE``   {executor_id}              -> ``OK``       (net-new: announced exit, so
                                          the monitor won't flag this node)
- ``PROGRESS`` {offsets: {pid: off}}   -> ``OK``       (net-new: feed high-water
                                          marks, consumed-record offsets per
                                          partition; cluster.run_elastic reads
                                          them to bound duplicate delivery on
                                          relaunch)
- ``STOP``  {}                         -> ``OK``, server shuts down
"""
import base64
import json
import logging
import os
import select
import socket
import struct
import threading
import time

from . import faults, util

logger = logging.getLogger(__name__)

# Env overrides for the server bind address (reference: reservation.py:25-26).
SERVER_HOST_ENV = "TFOS_TPU_SERVER_HOST"
SERVER_PORT_ENV = "TFOS_TPU_SERVER_PORT"

CONNECT_RETRIES = 3
CONNECT_RETRY_DELAY_SECS = 2
CONNECT_RETRY_DELAY_CAP_SECS = 15.0
CONNECT_TIMEOUT_SECS = 30.0
RPC_TIMEOUT_SECS = 60.0


def _backoff_delay(attempt, base, cap):
    """Capped exponential delay before connect retry `attempt` (0-based):
    base, 2*base, 4*base, ... never exceeding `cap`.  Delegates to the
    package-wide :class:`util.RetryPolicy` schedule (jitterless here:
    tests pin exact delays through the module knobs)."""
    return util.RetryPolicy(attempts=2, base_delay=base,
                            cap_delay=cap).delay(attempt)


class Reservations:
    """Thread-safe registry of node reservations (reference: reservation.py:31-65)."""

    def __init__(self, required):
        self.required = required
        self._lock = threading.RLock()
        self._nodes = []
        self._errors = []

    def add(self, meta):
        with self._lock:
            self._nodes.append(meta)

    def done(self):
        with self._lock:
            return len(self._nodes) >= self.required

    def get(self):
        with self._lock:
            return list(self._nodes)

    def remaining(self):
        with self._lock:
            return self.required - len(self._nodes)

    def add_error(self, err):
        with self._lock:
            self._errors.append(err)

    def get_errors(self):
        with self._lock:
            return list(self._errors)


# the tag of a bytes value in a frame: {"__bytes__": "<base64>"}
_BYTES_TAG = "__bytes__"


def _tag(obj):
    """JSON-ready copy of a message: bytes tagged, tuples as lists (as
    msgpack sends them); a dict key that is not a str is refused, as
    msgpack's strict map keys refuse it on receipt (send_progress
    stringifies partition ids for that reason)."""
    if isinstance(obj, (bytes, bytearray)):
        return {_BYTES_TAG: base64.b64encode(bytes(obj)).decode("ascii")}
    if isinstance(obj, dict):
        if len(obj) == 1 and _BYTES_TAG in obj:
            raise ValueError(f"a message dict may not be keyed only by "
                             f"{_BYTES_TAG!r} (the bytes tag)")
        out = {}
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"message keys must be str, got {k!r}")
            out[k] = _tag(v)
        return out
    if isinstance(obj, (list, tuple)):
        return [_tag(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot frame a {type(obj).__name__} (JSON values and "
                    f"bytes only)")


def _untag(obj):
    if len(obj) == 1 and _BYTES_TAG in obj:
        if not isinstance(obj[_BYTES_TAG], str):
            raise ValueError("bytes tag without a base64 string")
        return base64.b64decode(obj[_BYTES_TAG], validate=True)
    return obj


def encode_message(msg):
    """One message dict -> its frame payload (UTF-8 JSON)."""
    return json.dumps(_tag(msg), separators=(",", ":"), ensure_ascii=False,
                      allow_nan=False).encode("utf-8")


def decode_message(payload):
    """Frame payload -> message dict; ValueError for anything but a
    UTF-8 JSON object (a malformed or foreign frame)."""
    msg = json.loads(bytes(payload).decode("utf-8"), object_hook=_untag)
    if not isinstance(msg, dict):
        raise ValueError(f"frame holds a {type(msg).__name__}, not a "
                         f"message object")
    return msg


class MessageSocket:
    """Length-prefixed JSON messages over a socket (reference:
    reservation.py:68-97)."""

    MAX_FRAME_BYTES = 64 * 1024 * 1024  # rendezvous messages are small

    def receive(self, sock):
        header = self._recv_exact(sock, 4)
        (length,) = struct.unpack(">I", header)
        if length > self.MAX_FRAME_BYTES:
            raise ValueError(f"frame of {length} bytes exceeds protocol limit")
        return decode_message(self._recv_exact(sock, length))

    def send(self, sock, msg):
        payload = encode_message(msg)
        if len(payload) > self.MAX_FRAME_BYTES:
            raise ValueError(f"frame of {len(payload)} bytes exceeds "
                             f"protocol limit")
        sock.sendall(struct.pack(">I", len(payload)) + payload)

    @staticmethod
    def _recv_exact(sock, n):
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("socket closed mid-message")
            buf.extend(chunk)
        return bytes(buf)


class Server(MessageSocket):
    """Driver-side rendezvous server (reference: reservation.py:100-231).

    Runs a selector loop on a daemon thread; the driver blocks in
    `await_reservations` until all `count` nodes registered (or error/timeout).
    """

    def __init__(self, count):
        assert count > 0
        self.reservations = Reservations(count)
        self.done = threading.Event()
        self._sock = None
        # Heartbeat state (net-new failure detection, SURVEY.md §5: the
        # reference has none and torch.distributed collectives hang on
        # silent peer loss; the coordinator must notice instead).
        self._beats = {}        # executor_id -> last beat monotonic time
        self._finished = set()  # executor_ids that sent BYE (normal exit)
        self._progress = {}     # partition id -> consumed-record high water
        self._flagged = set()   # executor_ids already reported dead
        self._beat_lock = threading.Lock()

    def start(self, host=None, ports=None):
        """Bind and start the listener thread; return (host, port).

        `host`/`ports` (a candidate-port list) override the env knobs —
        a fleet gateway binds an operator-chosen registry address while
        the training driver keeps the env-driven path."""
        if host is None:
            host = os.environ.get(SERVER_HOST_ENV, util.get_ip_address())
        if ports is None:
            port_spec = os.environ.get(SERVER_PORT_ENV)
            ports = util.parse_port_spec(port_spec) if port_spec else None
        self._sock = util.bind_socket(host, ports)
        addr = (host, self._sock.getsockname()[1])
        logger.info("reservation server listening on %s", addr)
        t = threading.Thread(target=self._serve, name="reservation-server", daemon=True)
        t.start()
        return addr

    @property
    def address(self):
        host, port = self._sock.getsockname()
        return (host, port)

    def _serve(self):
        conns = [self._sock]
        while not self.done.is_set():
            try:
                readable, _, _ = select.select(conns, [], [], 1.0)
            except OSError:
                break  # listener closed during shutdown
            for s in readable:
                if s is self._sock:
                    try:
                        client, _ = self._sock.accept()
                        try:
                            # A peer that stalls mid-frame must not wedge the
                            # single serve thread: bound each read so the peer
                            # is dropped instead (select readiness only
                            # guarantees >=1 byte, not a whole frame).
                            client.settimeout(10.0)
                            conns.append(client)
                        except OSError:
                            client.close()
                            raise
                    except OSError:
                        pass
                else:
                    try:
                        msg = self.receive(s)
                        self._dispatch(s, msg)
                    except Exception as e:
                        # A malformed frame from one peer must never kill the
                        # rendezvous loop for everyone else: drop that peer.
                        if not isinstance(e, (ConnectionError, OSError)):
                            logger.warning("dropping connection after bad message: %s", e)
                        conns.remove(s)
                        s.close()
        for s in conns:
            s.close()

    def _dispatch(self, sock, msg):
        mtype = msg.get("type")
        if mtype == "REG":
            self.reservations.add(msg["node"])
            logger.info("registered node: %s", msg["node"])
            self.send(sock, {"type": "OK"})
        elif mtype == "QUERY":
            self.send(sock, {
                "type": "QUERY",
                "done": self.reservations.done(),
                "count": len(self.reservations.get()),
                "required": self.reservations.required,
            })
        elif mtype == "QINFO":
            self.send(sock, {"type": "QINFO", "nodes": self.reservations.get()})
        elif mtype == "BEAT":
            with self._beat_lock:
                self._beats[msg.get("executor_id")] = time.monotonic()
            self.send(sock, {"type": "OK"})
        elif mtype == "BYE":
            with self._beat_lock:
                self._finished.add(msg.get("executor_id"))
            logger.info("node %s finished (BYE)", msg.get("executor_id"))
            self.send(sock, {"type": "OK"})
        elif mtype == "PROGRESS":
            with self._beat_lock:
                for pid, off in (msg.get("offsets") or {}).items():
                    pid = int(pid)
                    self._progress[pid] = max(self._progress.get(pid, 0),
                                              int(off))
            self.send(sock, {"type": "OK"})
        elif mtype == "ERROR":
            logger.error("node reported error: %s", msg.get("error"))
            self.reservations.add_error(
                {"node": msg.get("node"), "error": msg.get("error", "")})
            self.send(sock, {"type": "OK"})
        elif mtype == "STOP":
            logger.info("received STOP, shutting down reservation server")
            self.send(sock, {"type": "OK"})
            self.stop()
        else:
            self.send(sock, {"type": "ERR", "error": f"unknown message {mtype!r}"})

    def await_reservations(self, timeout=600, status=None):
        """Block until all nodes registered (reference: reservation.py:113-128).

        `status` is an optional mutable mapping with an 'error' key set by the
        launch thread (reference TFCluster's tf_status) — aborts early if set.
        Node-reported ERROR messages abort as well (net-new failure detection).
        """
        deadline = time.time() + timeout
        while not self.reservations.done():
            if status is not None and status.get("error"):
                raise RuntimeError(f"cluster launch failed: {status['error']}")
            errs = self.reservations.get_errors()
            if errs:
                raise RuntimeError(f"node(s) failed during startup: {errs}")
            logger.info("waiting for %d reservations", self.reservations.remaining())
            if time.time() > deadline:
                raise TimeoutError(
                    f"timed out waiting for {self.reservations.remaining()} "
                    f"of {self.reservations.required} reservations")
            time.sleep(1)
        logger.info("all %d reservations completed", self.reservations.required)
        return self.reservations.get()

    def progress_snapshot(self):
        """Consumed-record high-water marks {partition id: offset} reported
        via PROGRESS (feed-offset resume, cluster.run_elastic)."""
        with self._beat_lock:
            return dict(self._progress)

    def seed_beat(self, executor_id):
        """Grant `executor_id` a fresh liveness window (as if it just
        beat).  Registration-time seeding: a node whose heartbeat thread
        has not connected yet must not read as instantly dead."""
        with self._beat_lock:
            self._beats[executor_id] = time.monotonic()

    def last_beats(self):
        """Snapshot of {executor_id: last-beat monotonic time}.  The
        fleet gateway's ejection/re-admission monitor reads this (it
        needs beat *recency* for re-admission, not just `dead_nodes`)."""
        with self._beat_lock:
            return dict(self._beats)

    def dead_nodes(self, timeout):
        """Executor ids that heartbeated once but have been silent for
        > `timeout` seconds and did not announce a normal exit (BYE)."""
        now = time.monotonic()
        with self._beat_lock:
            return [eid for eid, t in self._beats.items()
                    if eid not in self._finished and now - t > timeout]

    def finished_ids(self):
        """Snapshot of executor ids that announced a normal exit (BYE) —
        the driver's signal that a node's user fn returned (the analog of
        the reference polling Spark's statusTracker for finished worker
        tasks, TFCluster.py:154-169)."""
        with self._beat_lock:
            return set(self._finished)

    def start_monitor(self, heartbeat_timeout, interval=None, expected=None):
        """Flag silently-dead nodes as cluster errors (net-new vs the
        reference, which only noticed errors nodes *reported*; a SIGKILLed
        or OOMed training process reports nothing). Each dead node is
        reported once, through the same error channel `ERROR` messages use,
        so the driver's existing error surfacing aborts the job.

        `expected` seeds the beat table with every registered executor id
        (as if each had just beaten): a node whose heartbeat client never
        managed to connect is otherwise invisible to `dead_nodes` — exactly
        the unmonitored-node hole this monitor exists to close.  Seeding
        grants each node one full timeout window to start beating.
        """
        if expected:
            now = time.monotonic()
            with self._beat_lock:
                for eid in expected:
                    self._beats.setdefault(eid, now)

        def _watch():
            poll = interval or max(heartbeat_timeout / 4.0, 1.0)
            while not self.done.is_set():
                for eid in self.dead_nodes(heartbeat_timeout):
                    with self._beat_lock:
                        if eid in self._flagged:
                            continue
                        self._flagged.add(eid)
                    logger.error("node %s heartbeat lost (> %ss silent)",
                                 eid, heartbeat_timeout)
                    self.reservations.add_error(
                        {"node": {"executor_id": eid},
                         "error": f"heartbeat lost for executor {eid} "
                                  f"(silent > {heartbeat_timeout}s)"})
                self.done.wait(poll)

        t = threading.Thread(target=_watch, name="heartbeat-monitor",
                             daemon=True)
        t.start()
        return t

    def stop(self):
        self.done.set()
        try:
            self._sock.close()
        except OSError:
            pass


class Client(MessageSocket):
    """Executor-side rendezvous client (reference: reservation.py:234-301)."""

    def __init__(self, server_addr, connect=True, connect_timeout=None,
                 rpc_timeout=None, retries=None, retry_delay=None,
                 retry_delay_cap=None):
        """`connect=False` defers the main-socket connect to the first
        RPC — used by heartbeat-only clients, whose beat thread makes its
        own connections and must start (and keep retrying) even while the
        server is briefly unreachable.

        The timeout knobs bound how long a dead or wedged server can
        stall this client (a serving replica registering with a fleet
        gateway must fail fast, not hang startup): `connect_timeout` /
        `rpc_timeout` are per-dial socket timeouts, `retries` bounds the
        connect attempts, and `retry_delay`/`retry_delay_cap` shape the
        capped exponential backoff between them.  ``None`` defers to the
        module defaults AT CALL TIME (so tests may monkeypatch them)."""
        self.server_addr = (server_addr[0], int(server_addr[1]))
        self._connect_timeout = connect_timeout
        self._rpc_timeout = rpc_timeout
        self._retries = retries
        self._retry_delay = retry_delay
        self._retry_delay_cap = retry_delay_cap
        self._sock = self._connect() if connect else None
        self._lock = threading.Lock()

    def _dial(self, connect_timeout, rpc_timeout):
        """One fresh connection to the server.  The per-RPC timeout bounds
        receive(): if the server host dies without RST, a blocked read must
        not hang the executor forever."""
        faults.check("reservation.dial")
        s = socket.create_connection(self.server_addr,
                                     timeout=connect_timeout)
        try:
            s.settimeout(rpc_timeout)
        except OSError:
            s.close()
            raise
        return s

    def _effective_timeouts(self):
        """(connect_timeout, rpc_timeout) with module defaults filled in.
        Rendezvous RPCs complete in milliseconds; the 60s default covers
        a driver briefly stalled by GC/oversubscription."""
        ct = (self._connect_timeout if self._connect_timeout is not None
              else CONNECT_TIMEOUT_SECS)
        rt = (self._rpc_timeout if self._rpc_timeout is not None
              else RPC_TIMEOUT_SECS)
        return ct, rt

    def _connect(self):
        retries = self._retries if self._retries is not None else \
            CONNECT_RETRIES
        base = (self._retry_delay if self._retry_delay is not None
                else CONNECT_RETRY_DELAY_SECS)
        cap = (self._retry_delay_cap if self._retry_delay_cap is not None
               else CONNECT_RETRY_DELAY_CAP_SECS)
        ct, rt = self._effective_timeouts()
        policy = util.RetryPolicy(attempts=max(1, retries),
                                  base_delay=base, cap_delay=cap)
        last = None
        for attempt in policy.sleeps():
            try:
                return self._dial(connect_timeout=ct, rpc_timeout=rt)
            except OSError as e:
                last = e
                logger.warning("connect to %s failed (%s); retry %d/%d",
                               self.server_addr, e, attempt + 1, retries)
        raise ConnectionError(f"could not reach reservation server at {self.server_addr}: {last}")

    def _request(self, msg):
        with self._lock:
            if self._sock is None:
                self._sock = self._connect()
            try:
                faults.check("reservation.rpc")
                self.send(self._sock, msg)
                return self.receive(self._sock)
            except Exception:
                # A timed-out or half-sent RPC leaves the framed stream
                # mid-message: the socket is wedged for every later call.
                # Close and drop it so the next RPC redials cleanly.
                try:
                    self._sock.close()
                finally:
                    self._sock = None
                raise

    def register(self, node_meta):
        return self._request({"type": "REG", "node": node_meta})

    def query(self):
        return self._request({"type": "QUERY"})

    def get_reservations(self):
        return self._request({"type": "QINFO"})["nodes"]

    def await_reservations(self, timeout=600):
        """Poll until the cluster is fully registered; return the node list."""
        deadline = time.time() + timeout
        while True:
            resp = self.query()
            if resp.get("done"):
                return self.get_reservations()
            if time.time() > deadline:
                raise TimeoutError("timed out awaiting cluster reservations")
            time.sleep(1)

    def report_error(self, node_meta, error):
        try:
            return self._request({"type": "ERROR", "node": node_meta, "error": str(error)})
        except OSError:
            logger.warning("could not report error to reservation server")

    def request_stop(self):
        try:
            return self._request({"type": "STOP"})
        except (ConnectionError, OSError):
            return {"type": "OK"}  # server already gone

    def send_progress(self, offsets):
        """Report consumed-record high-water marks {partition: offset};
        best-effort (a lost report only widens the duplicate window)."""
        if not offsets:
            return
        try:
            # keys stringified: the frame codec refuses non-str keys (as
            # msgpack's strict map keys do); the server re-ints them
            return self._request({"type": "PROGRESS",
                                  "offsets": {str(p): int(o)
                                              for p, o in offsets.items()}})
        except (ConnectionError, OSError):
            logger.warning("could not report feed progress")

    def start_heartbeat(self, executor_id, interval=5.0):
        """Beat on a daemon thread until `stop_heartbeat`/`close`/`bye`.

        Uses a DEDICATED connection: the beat thread must not interleave
        frames with request/response traffic on the main socket.  An
        unreachable server never ends the thread — it retries with capped
        backoff until explicitly stopped.  Giving up would be worse than
        useless: the node may be training fine through a transient blip,
        and a (possibly restarted) monitor would then flag a healthy node
        as dead and abort the whole job.
        """
        self._hb_stop = getattr(self, "_hb_stop", None) or threading.Event()
        self._hb_stop.clear()

        def _beat():
            # Single-attempt reconnects (NOT the Client() constructor, whose
            # retry/backoff sleeps ignore the stop event): stop_heartbeat
            # must end this thread within ~one beat interval.
            hb = None
            ct, rt = self._effective_timeouts()
            while not self._hb_stop.is_set():
                try:
                    faults.check("reservation.heartbeat")
                    if hb is None:
                        hb = self._dial(connect_timeout=min(5.0, ct),
                                        rpc_timeout=min(10.0, rt))
                    self.send(hb, {"type": "BEAT",
                                   "executor_id": executor_id})
                    self.receive(hb)
                except (ConnectionError, OSError):
                    if hb is not None:
                        try:
                            hb.close()
                        except OSError:
                            pass
                        hb = None
                # Constant cadence, no backoff: a BEAT is one tiny frame,
                # and widening the gap during an outage is exactly when
                # liveness proof is most urgent — backoff would let a
                # ~heartbeat_timeout/2 blip trip the monitor.
                self._hb_stop.wait(interval)
            if hb is not None:
                try:
                    hb.close()
                except OSError:
                    pass

        t = threading.Thread(target=_beat, name=f"heartbeat-{executor_id}",
                             daemon=True)
        t.start()
        self._hb_thread = t
        return t

    def stop_heartbeat(self):
        ev = getattr(self, "_hb_stop", None)
        if ev is not None:
            ev.set()

    def bye(self, executor_id):
        """Announce a normal exit so the monitor won't flag this node.

        A lost BYE would convert a successful node into a false
        "heartbeat lost" job failure (beats stop regardless), so it never
        touches the main socket — which sat idle for the whole training
        run and may have been dropped by NAT/conntrack — and uses only
        fresh short-timeout connections.
        """
        self.stop_heartbeat()
        msg = {"type": "BYE", "executor_id": executor_id}
        # Never use the main socket: it sat idle for the whole run and a
        # NAT/conntrack-dropped connection swallows the send and stalls
        # receive() for the full 60s RPC timeout — longer than typical
        # monitor windows, so the "lost heartbeat" this method exists to
        # prevent would fire while BYE is stuck.  Fresh 5s dials only.
        ct, rt = self._effective_timeouts()
        for attempt in range(CONNECT_RETRIES):
            try:
                s = self._dial(connect_timeout=min(5.0, ct),
                               rpc_timeout=min(10.0, rt))
                try:
                    self.send(s, msg)
                    return self.receive(s)
                finally:
                    try:
                        s.close()
                    except OSError:
                        pass
            except ConnectionRefusedError:
                # Fast refusal = the server was stopped on purpose (normal
                # at teardown) — its monitor died with it, so BYE is moot.
                break
            except (ConnectionError, OSError):
                if attempt < CONNECT_RETRIES - 1:
                    time.sleep(0.5)
        return {"type": "OK"}  # server really gone (normal at teardown)

    def close(self):
        self.stop_heartbeat()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
