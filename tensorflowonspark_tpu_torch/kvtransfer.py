"""Page-granular kv migration between serving replicas: the port of
``tensorflowonspark_tpu/kvtransfer.py``.

A session is prefilled on one replica, decodes its first tokens there,
and is then MOVED (its occupied kv pages, the int8 pool's scale blocks,
and the row state every resident sampling register is rebuilt from) to
another replica that continues the stream mid-sequence with the tokens
of a run that never moved.

Three layers, smallest first:

``write_snapshot`` / ``read_snapshot``
    The wire: one header frame (meta and a block manifest), each named
    block as sequential ``block`` frames chunked at ``CHUNK_BYTES``, an
    ``end`` frame.  A frame (:class:`KvSocket`) is a small JSON header
    followed by raw bytes: the port's rendezvous socket frames JSON with
    base64 bytes, which would turn a 1024-token flagship session's
    64 MiB of bf16 kv into about 85 MB.  The wire is not the JAX
    package's msgpack (the card's machine has no msgpack, so the two
    never talk); the ``(meta, blocks)`` each side builds and reads are
    the JAX package's, key for key.

``PageServer`` / ``pull_snapshot``
    A pull socket.  The source registers a frozen snapshot under a
    one-time ticket; the destination dials back and pulls it.  Pull
    (destination-initiated) keeps the HTTP control channel (``POST
    :resume`` carrying the ticket) the one place ordering is decided.
    The server also answers ``kv:prefix`` pulls from its host tier.

``MigrationEngine``
    The source side: freeze the session at a host-tick cut
    (``batcher.freeze_session``), publish the snapshot, POST
    ``/v1/models/<name>:resume`` to the destination, and treat the
    first ndjson event of the response as the splice ack.  On ack the
    source frees the row (``complete_migration``) and a relay thread
    forwards the destination's token events into the original handle,
    so the client's stream never breaks.  On timeout or refusal the
    source reinstalls the row (``rollback_migration``) and decodes on;
    pages are owned by exactly one side at every instant.

Blocks are torch CPU tensors (numpy arrays are taken on the sending
side too); dtypes travel by name (``bfloat16``, ``float32``, ``int8``).
"""
import http.client
import json
import logging
import socket
import struct
import threading
import time
import uuid

import numpy as np
import torch

from tensorflowonspark_tpu_torch import faults, util

logger = logging.getLogger(__name__)

WIRE_VERSION = 1

# Page blocks ship in slices well under the frame cap: smaller chunks
# bound peak memory and keep the receiver's read loop responsive to
# socket timeouts.
CHUNK_BYTES = 8 * 1024 * 1024


class ResumeRefused(ValueError):
    """The destination answered ``:resume`` with a permanent 4xx.

    The replica validates the snapshot eagerly, so a 4xx means THIS
    payload can never land there (wire-version mismatch, malformed meta,
    unknown model): retrying only burns the migration deadline.
    Transient failures (connect errors, 5xx, a refused ack) stay plain
    OSError / ValueError and keep retrying."""


class KvSocket:
    """Frames of ``[header length, payload length]`` (two big-endian
    u32), a JSON header and raw payload bytes."""

    MAX_FRAME_BYTES = 256 * 1024 * 1024

    def send(self, sock, msg, data=b""):
        head = json.dumps(msg).encode()
        if len(head) + len(data) > self.MAX_FRAME_BYTES:
            raise ValueError(f"frame of {len(head) + len(data)} bytes "
                             "exceeds protocol limit")
        sock.sendall(struct.pack(">II", len(head), len(data)) + head)
        if len(data):
            sock.sendall(data)

    def receive(self, sock):
        """``(header dict, payload bytearray)`` of the next frame."""
        n_head, n_data = struct.unpack(">II", self._recv_exact(sock, 8))
        if n_head + n_data > self.MAX_FRAME_BYTES:
            raise ValueError(f"frame of {n_head + n_data} bytes exceeds "
                             "protocol limit")
        head = json.loads(bytes(self._recv_exact(sock, n_head)))
        if not isinstance(head, dict):
            raise ValueError("kv frame header is not an object")
        return head, self._recv_exact(sock, n_data)

    @staticmethod
    def _recv_exact(sock, n):
        buf = bytearray(n)
        view, got = memoryview(buf), 0
        while got < n:
            k = sock.recv_into(view[got:])
            if not k:
                raise ConnectionError("socket closed mid-message")
            got += k
        return buf


def dtype_name(dtype):
    """The wire name of a torch dtype (numpy's name for the same type)."""
    return str(dtype).rpartition(".")[2]


def torch_dtype(name):
    """The torch dtype of a wire name."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown kv block dtype {name!r}")
    return dt


def _as_tensor(arr):
    """A contiguous CPU tensor of a block (a tensor or a numpy array)."""
    if isinstance(arr, np.ndarray):
        arr = torch.from_numpy(np.ascontiguousarray(arr))
    return arr.to("cpu").contiguous()


def _raw_bytes(t):
    """The bytes of contiguous CPU tensor ``t`` without a copy."""
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def write_snapshot(msock, sock, meta, blocks):
    """Stream ``meta`` + named blocks over an open socket.

    Block order on the wire is sorted by name so both sides agree
    without shipping indices twice; each block's bytes go out as
    sequential chunks."""
    names = sorted(blocks)
    tensors = [_as_tensor(blocks[n]) for n in names]
    manifest = [{"name": n, "dtype": dtype_name(t.dtype),
                 "shape": [int(d) for d in t.shape],
                 "nbytes": t.numel() * t.element_size()}
                for n, t in zip(names, tensors)]
    msock.send(sock, {"kind": "header", "version": WIRE_VERSION,
                      "meta": meta, "blocks": manifest})
    for i, t in enumerate(tensors):
        data = _raw_bytes(t)
        for off in range(0, len(data), CHUNK_BYTES):
            msock.send(sock, {"kind": "block", "i": i, "off": off},
                       data[off:off + CHUNK_BYTES])
    msock.send(sock, {"kind": "end", "blocks": len(names)})


def read_snapshot(msock, sock):
    """Inverse of :func:`write_snapshot`: ``(meta, blocks)`` with blocks
    as CPU tensors.  Raises ``ValueError`` on protocol violations (bad
    version, missing bytes, out-of-order chunks) and on an ``err`` frame
    from the peer."""
    head, _ = msock.receive(sock)
    if head.get("kind") == "err":
        raise ValueError(head.get("error") or "kv snapshot refused")
    if head.get("kind") != "header" or head.get("version") != WIRE_VERSION:
        raise ValueError("bad kv snapshot header: kind=%r version=%r"
                         % (head.get("kind"), head.get("version")))
    manifest = head.get("blocks") or []
    bufs = [bytearray(int(m["nbytes"])) for m in manifest]
    fills = [0] * len(manifest)
    while True:
        frame, data = msock.receive(sock)
        kind = frame.get("kind")
        if kind == "end":
            break
        if kind != "block":
            raise ValueError("unexpected %r frame in kv stream" % (kind,))
        i, off = int(frame["i"]), int(frame["off"])
        if not 0 <= i < len(manifest):
            raise ValueError("block index %d out of range" % i)
        if off != fills[i] or off + len(data) > len(bufs[i]):
            raise ValueError("out-of-order chunk for block %r"
                             % manifest[i]["name"])
        bufs[i][off:off + len(data)] = data
        fills[i] += len(data)
    blocks = {}
    for m, buf, fill in zip(manifest, bufs, fills):
        if fill != int(m["nbytes"]):
            raise ValueError("short block %r: %d of %d bytes"
                             % (m["name"], fill, int(m["nbytes"])))
        dt, shape = torch_dtype(m["dtype"]), [int(d) for d in m["shape"]]
        if not buf:
            blocks[m["name"]] = torch.empty(shape, dtype=dt)
            continue
        blocks[m["name"]] = torch.frombuffer(
            buf, dtype=torch.uint8).view(dt).reshape(shape)
    return head.get("meta") or {}, blocks


def wire_snapshot(frozen, model_name, page_size=0):
    """Flatten a ``freeze_session`` record into ``(meta, blocks)``.

    The freeze started the blocks' copy from the card into pinned host
    memory; this waits on its event (``frozen["event"]``), then slices
    paged blocks to the occupied page count."""
    event = frozen.get("event")
    if event is not None:
        event.synchronize()
    item = frozen["item"]
    n_pages = int(frozen.get("n_pages", 0))
    meta = {"version": WIRE_VERSION, "model": model_name,
            "kind": frozen["kind"], "page_size": int(page_size),
            "n_pages": n_pages,
            "seq": [int(t) for t in frozen["seq"]],
            "plen": int(frozen["plen"]),
            "remaining": int(frozen["remaining"]),
            "max_new": int(item["max_new"]), "temp": float(item["temp"]),
            "eos": item["eos"], "seed": int(item["seed"]),
            "topk": int(item["topk"]), "topp": float(item["topp"]),
            "minp": float(item["minp"]), "stops": item["stops"],
            "rep": float(item["rep"]), "adapter": item.get("adapter"),
            # the priority class and trace id cross the wire with the
            # session: the destination re-admits under the same class and
            # its spans join the same timeline
            "priority": item.get("cls"),
            "trace": item.get("trace")}
    blocks = {}
    for name, arr in frozen["kv"].items():
        blocks[name] = arr[:n_pages] if frozen["kind"] == "paged" else arr
    return meta, blocks


def _dial(addr, timeout):
    sock = socket.create_connection((addr[0], int(addr[1])),
                                    timeout=timeout)
    sock.settimeout(timeout)
    return sock


def pull_snapshot(addr, ticket, timeout=30.0):
    """Dial a :class:`PageServer` and pull the snapshot for ``ticket``."""
    faults.check("kvtransfer.pull")
    msock = KvSocket()
    sock = _dial(addr, timeout)
    try:
        msock.send(sock, {"kind": "pull", "ticket": ticket})
        return read_snapshot(msock, sock)
    finally:
        sock.close()


def pull_prefix(addr, tokens, page_size, timeout=10.0):
    """Dial a peer's :class:`PageServer` and pull its host-tier prefix
    pages for ``tokens``: ``(meta, pages)``, ``pages`` a list of per-page
    block dicts in page order (possibly empty: a cold peer is a valid
    answer)."""
    faults.check("kvtransfer.prefix_pull")
    from tensorflowonspark_tpu_torch import kvtier

    msock = KvSocket()
    sock = _dial(addr, timeout)
    try:
        msock.send(sock, {"kind": "prefix",
                          "tokens": [int(t) for t in tokens],
                          "page_size": int(page_size)})
        meta, blocks = read_snapshot(msock, sock)
        return meta, kvtier.split_prefix_blocks(meta, blocks)
    finally:
        sock.close()


class PageServer:
    """Serves registered kv snapshots to destinations that pull them.

    One per replica, bound lazily on the serving interface.  Tickets stay
    registered until the engine releases them, so a retried ``:resume``
    can re-pull the same frozen bytes.  ``kv:prefix`` requests
    (``{"kind": "prefix", "tokens": [...], "page_size": P}``) go to
    ``prefix_provider``, a callback returning ``(meta, blocks)`` for the
    longest run of host-tier prefix pages matching the tokens.  The
    request ships the tokens themselves, not hashes: the provider
    recomputes the exact cumulative keys."""

    def __init__(self, host="127.0.0.1", prefix_provider=None):
        self.prefix_provider = prefix_provider
        self._sock = util.bind_socket(host)
        self.addr = self._sock.getsockname()[:2]
        self._msock = KvSocket()
        self._tickets = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._sock.settimeout(0.2)
        self._thread = threading.Thread(
            target=self._serve, name="kv-page-server", daemon=True)
        self._thread.start()

    def register(self, meta, blocks):
        ticket = uuid.uuid4().hex
        with self._lock:
            self._tickets[ticket] = (meta, blocks)
        return ticket

    def release(self, ticket):
        with self._lock:
            self._tickets.pop(ticket, None)

    def _serve(self):
        while not self._stop.is_set():
            try:
                sock, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve_one, args=(sock,),
                             name="kv-page-pull", daemon=True).start()

    def _serve_one(self, sock):
        try:
            sock.settimeout(60.0)
            req, _ = self._msock.receive(sock)
            if req.get("kind") == "prefix":
                provider = self.prefix_provider
                if provider is None:
                    self._msock.send(sock, {"kind": "err", "error":
                                            "no kv:prefix provider"})
                    return
                try:
                    meta, blocks = provider(
                        [int(t) for t in (req.get("tokens") or [])],
                        int(req.get("page_size") or 0))
                except Exception as e:
                    self._msock.send(sock, {"kind": "err", "error":
                                            f"{type(e).__name__}: {e}"})
                    return
                write_snapshot(self._msock, sock, meta, blocks)
                return
            with self._lock:
                entry = self._tickets.get(req.get("ticket"))
            if req.get("kind") != "pull" or entry is None:
                self._msock.send(sock, {"kind": "err",
                                        "error": "unknown kv ticket"})
                return
            write_snapshot(self._msock, sock, *entry)
        except (OSError, ValueError) as e:
            logger.debug("kv pull aborted: %s", e)
        finally:
            sock.close()

    def close(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)


class MigrationEngine:
    """The source side of moving live sessions to another replica.

    Owns the replica's :class:`PageServer` and the relay threads that
    keep clients' token streams alive across the handoff.  Its methods
    run off the batcher's device thread; the freeze and rollback device
    work goes through the batcher's operation queue."""

    def __init__(self, batcher, model_name="default", host="127.0.0.1",
                 advertise_host=None, timeout_s=30.0, retries=1,
                 prefix_provider=None):
        self.batcher = batcher
        self.model_name = model_name
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self._host = host or "127.0.0.1"
        self._advertise_host = advertise_host or self._host
        self._prefix_provider = prefix_provider
        self._server = None
        self._server_lock = threading.Lock()
        self._closed = False

    @property
    def server(self):
        with self._server_lock:
            if self._server is None:
                if self._closed:
                    raise RuntimeError("migration engine is closed")
                self._server = PageServer(
                    self._host, prefix_provider=self._prefix_provider)
            return self._server

    def prefix_addr(self):
        """``host:port`` peers dial for ``kv:prefix`` pulls (binds the
        lazy PageServer)."""
        return "%s:%d" % (self._advertise_host, self.server.addr[1])

    def migrate(self, handle, dest, timeout_s=None, retries=None):
        """Move one live session to ``dest`` = ``(host, port)``.

        Returns a summary dict; ``{"migrated": False, ...}`` outcomes
        leave the session decoding on this replica (rollback), so the
        caller never cleans up after a failure.  A landed migration's
        summary carries ``freeze_to_ack_ms`` (the cut requested to the
        destination's ack) and the bytes shipped."""
        timeout_s = self.timeout_s if timeout_s is None else float(timeout_s)
        retries = self.retries if retries is None else int(retries)
        b = self.batcher
        t_freeze = time.monotonic()
        deadline = t_freeze + timeout_s
        try:
            frozen = b.freeze_session(handle, timeout_s=timeout_s)
        except (TimeoutError, ValueError, RuntimeError) as e:
            return {"migrated": False, "error": str(e)}
        if frozen is None:
            # finished (or was cancelled) before the cut landed
            return {"migrated": False, "completed_locally": True}
        ticket = None
        last_err = "migration timed out before the first attempt"
        try:
            b.counters.inc("migrations_started")
            t_wire = time.monotonic()
            meta, blocks = wire_snapshot(frozen, self.model_name,
                                         page_size=b.kv_page_size)
            ticket = self.server.register(meta, blocks)
            nbytes = sum(int(a.numel() * a.element_size())
                         for a in blocks.values())
            n_pages = int(frozen.get("n_pages", 0))
            tid = meta.get("trace")
            b.trace.span_at(tid, "wire", t_wire, time.monotonic(),
                            pages=n_pages, bytes=nbytes,
                            dest=f"{dest[0]}:{dest[1]}")
            # jittered backoff between attempts so sources retrying one
            # flapping destination do not synchronise; the deadline still
            # bounds each attempt's budget
            policy = util.RetryPolicy(attempts=retries + 1, base_delay=0.25,
                                      cap_delay=2.0, jitter=0.25,
                                      deadline_s=timeout_s)
            for attempt in policy.sleeps():
                budget = deadline - time.monotonic()
                if budget <= 0:
                    last_err = "migration deadline exhausted"
                    break
                try:
                    conn, resp, first = self._post_resume(
                        dest, meta, ticket, min(budget, timeout_s))
                except ResumeRefused as e:
                    # permanent: fail fast to the rollback
                    last_err = "attempt %d: %s" % (attempt + 1, e)
                    logger.warning("kv migrate to %s refused (%s)",
                                   dest, last_err)
                    break
                except (OSError, ValueError) as e:
                    last_err = "attempt %d: %s" % (attempt + 1, e)
                    logger.warning("kv migrate to %s failed (%s)",
                                   dest, last_err)
                    continue
                if first.get("resumed"):
                    # the ack: the destination owns the pages from here
                    # on.  NEVER roll back past this point: both replicas
                    # would serve the row (though never double-free)
                    ack_ms = (time.monotonic() - t_freeze) * 1000.0
                    b.complete_migration(frozen)
                    frozen = None      # handed off; finally must not roll
                    threading.Thread(
                        target=self._relay, args=(handle, conn, resp),
                        name="kv-migrate-relay", daemon=True).start()
                    b.trace.event(tid, "migrate_ack",
                                  dest=f"{dest[0]}:{dest[1]}",
                                  attempt=attempt + 1)
                    return {"migrated": True,
                            "dest": [dest[0], int(dest[1])],
                            "pages": n_pages, "bytes": nbytes,
                            "freeze_to_ack_ms": round(ack_ms, 3)}
                last_err = str(first.get("error")
                               or "destination refused resume")
                try:
                    conn.close()
                except OSError:
                    pass
        finally:
            if ticket is not None:
                self.server.release(ticket)
            if frozen is not None:
                # every non-acked exit (give-up, deadline or an
                # unexpected raise) resumes decode here: a frozen row is
                # never left stranded
                b.rollback_migration(frozen)
                b.counters.inc("migrations_failed")
        return {"migrated": False, "error": last_err}

    def migrate_async(self, handle, dest, timeout_s=None, retries=None):
        """Fire-and-forget :meth:`migrate` (the prefill-role handoff)."""
        t = threading.Thread(
            target=self.migrate, args=(handle, dest),
            kwargs={"timeout_s": timeout_s, "retries": retries},
            name="kv-migrate", daemon=True)
        t.start()
        return t

    def migrate_all(self, dests, max_sessions=None, timeout_s=None):
        """Migrate every live session, round-robin across ``dests`` (the
        drain-without-dropping-streams path: sessions still in admission
        finish prefill here and are not moved)."""
        handles = self.batcher.live_handles()
        if max_sessions is not None:
            handles = handles[:int(max_sessions)]
        out = {"sessions": len(handles), "migrated": 0, "failed": 0,
               "completed_locally": 0, "details": []}
        for i, h in enumerate(handles):
            res = self.migrate(h, dests[i % len(dests)], timeout_s=timeout_s)
            out["details"].append(res)
            if res.get("migrated"):
                out["migrated"] += 1
            elif res.get("completed_locally"):
                out["completed_locally"] += 1
            else:
                out["failed"] += 1
        return out

    def _post_resume(self, dest, meta, ticket, timeout):
        """POST ``:resume`` and read the first (ack) event of the ndjson
        response.  Returns ``(conn, resp, first_event)``."""
        faults.check("kvtransfer.post_resume")
        body = json.dumps({
            "meta": meta,
            "pull": {"host": self._advertise_host,
                     "port": int(self.server.addr[1]),
                     "ticket": ticket}}).encode()
        conn = http.client.HTTPConnection(dest[0], int(dest[1]),
                                          timeout=max(1.0, timeout))
        try:
            conn.request("POST", "/v1/models/%s:resume" % self.model_name,
                         body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            if resp.status != 200:
                data = resp.read()
                detail = "resume rejected: HTTP %d %s" % (
                    resp.status, data.decode("utf-8", "replace")[:200])
                if 400 <= resp.status < 500:
                    raise ResumeRefused(detail)
                raise ValueError(detail)
            line = resp.readline()
            if not line:
                raise ValueError("resume stream closed before ack")
            return conn, resp, json.loads(line)
        except BaseException:
            conn.close()
            raise

    def _relay(self, handle, conn, resp):
        """Forward the destination's token events into the source handle
        so the client's stream continues uninterrupted."""
        b = self.batcher
        done = threading.Event()

        def _watch_cancel():
            # the client went away mid-relay: closing the connection makes
            # the destination's stream writer fail, and its generator
            # cancels the moved session (the reads below stay blocking)
            while not done.wait(0.25):
                if handle.cancelled.is_set():
                    try:
                        sock = conn.sock
                        if sock is not None:
                            sock.close()
                    except OSError:
                        pass
                    return

        threading.Thread(target=_watch_cancel, name="kv-relay-cancel",
                         daemon=True).start()
        try:
            if conn.sock is not None:
                # the ack read ran under the migrate timeout; token gaps
                # are unbounded, so the relay reads block
                conn.sock.settimeout(None)
            while True:
                try:
                    faults.check("kvtransfer.relay")
                    line = resp.readline()
                except (OSError, ValueError) as e:
                    if handle.cancelled.is_set():
                        handle._finish(list(handle.prompt))
                    else:
                        handle._fail(RuntimeError(
                            "migration relay broke: %s" % (e,)))
                    return
                if handle.cancelled.is_set():
                    handle._finish(list(handle.prompt))
                    return
                if not line:
                    handle._fail(RuntimeError(
                        "destination ended the stream without done"))
                    return
                ev = json.loads(line)
                if "token" in ev:
                    handle.tokens.put([int(ev["token"])])
                elif ev.get("done"):
                    handle._finish([int(t) for t in ev.get("output") or ()])
                    b.counters.inc("requests_served")
                    return
                elif "error" in ev:
                    handle._fail(RuntimeError(str(ev["error"])))
                    return
        except Exception as e:   # json decode, unexpected shapes
            handle._fail(RuntimeError("migration relay broke: %s" % (e,)))
        finally:
            done.set()
            try:
                conn.close()
            except OSError:
                pass

    def close(self):
        with self._server_lock:
            self._closed = True
            server, self._server = self._server, None
        if server is not None:
            server.close()
