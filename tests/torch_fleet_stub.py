"""A model-free stand-in for a port serving replica, shared by the port's
gateway tests: a copy of the JAX package's ``StubReplica``
(``tests/test_fleet.py``) — the replica's HTTP surface (metadata,
readyz, :predict, :generate, :resume, kv:export, the drain hook) with
canned responses — registered with a port gateway through the port's
``fleet_client`` (JSON-framed REG/BEAT/BYE).  Not a test module (no
``test_`` prefix)."""
import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tensorflowonspark_tpu_torch import fleet_client


def wait_until(pred, timeout=5.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


class StubReplica:
    """A serving-replica stand-in: the same HTTP surface (metadata /
    readyz / :predict / :generate / drain hook), no model.  Responses
    carry ``"replica": <id>`` so tests can observe where the gateway
    routed."""

    def __init__(self, generate_delay_s=0.0):
        self.generate_delay_s = generate_delay_s
        self.predict_hits = 0
        self.generate_hits = 0
        self.generate_prompts = []
        self.generate_requests = []  # full :generate body per hit
        self.extra_stats = {}        # merged over canned generate_stats
        self.extra_model = {}        # merged over the metadata model dict
        self.migrate_headers = []   # X-Fleet-Migrate-To seen per :generate
        self.kv_peer_headers = []   # X-Fleet-KV-Peer seen per :generate
        self.idem_keys = []         # Idempotency-Key per :generate/:resume
        self.resume_hits = 0
        self.resume_requests = []   # the replay meta each :resume carried
        self.kv_export_requests = []
        self.fail_next = 0          # respond 500 to this many POSTs
        self.die_after = None       # streaming: drop the socket after
                                    # this many token events (crash sim)
        self.token_delay_s = 0.0    # streaming: pause between tokens
        self.in_flight = 0
        self.draining = False
        self._lock = threading.Lock()
        stub = self

        class _H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _send(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.rstrip("/") or "/"
                if path == "/healthz":
                    self._send(200, {"status": "ok"})
                elif path == "/readyz":
                    self._send(503 if stub.draining else 200,
                               {"status": "draining" if stub.draining
                                else "ok"})
                elif path == "/v1/models/default":
                    gs = {"slots_busy": stub.in_flight,
                          "pending": 0,
                          "prefill_tokens_shared": 7,
                          "prefix_pages_cached": 3,
                          "ttft_count": 4,
                          "ttft_ms_sum": 100.0,
                          "migrations_started": 3,
                          "migrations_completed": 2,
                          "migrations_failed": 1,
                          "kv_pages_exported": 5,
                          # hierarchical kv cache (host-DRAM tier)
                          "prefix_hits": 2,
                          "prefix_misses": 1,
                          "host_hits": 2,
                          "host_demotions": 3,
                          "host_evictions": 1,
                          "host_cache_bytes": 2048,
                          "host_pages_cached": 2,
                          # per-class windows: interactive traffic only —
                          # the batch class is EMPTY on a canned stub (no
                          # batch keys at all), like a replica that never
                          # served that class
                          "ttft_interactive_count": 2,
                          "ttft_interactive_ms_sum": 40.0,
                          "ttft_interactive_p95_ms": 25.0,
                          "qdelay_interactive_count": 2,
                          "qdelay_interactive_ms_sum": 10.0,
                          "sessions_parked": 1,
                          "sessions_unparked": 1,
                          "parked_sessions": 0}
                    gs.update(stub.extra_stats)
                    model = {"engine": "stub", "generate_stats": gs}
                    model.update(stub.extra_model)
                    self._send(200, {"status": "ok", "model": model})
                else:
                    self._send(404, {"error": self.path})

            def _stream_ndjson(self, prefix, start, total, ack=False):
                """A canned token stream, shaped as a replica streams:
                token events then a done event with the full output.
                Token ``i`` of a request is ALWAYS ``100 + i`` — a pure
                function of position, like the real engine's seeded
                chain — so a recovered continuation is
                byte-checkable."""
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def put(obj):
                    data = json.dumps(obj).encode() + b"\n"
                    self.wfile.write(f"{len(data):X}\r\n".encode()
                                     + data + b"\r\n")
                    self.wfile.flush()

                if ack:
                    put({"resumed": True})
                toks = [100 + i for i in range(start, total)]
                for sent, t in enumerate(toks):
                    if (stub.die_after is not None
                            and sent >= stub.die_after):
                        # mid-stream crash: no done event ever (shut
                        # down, not only closed: the handler's file
                        # objects would keep the socket open)
                        self.connection.shutdown(socket.SHUT_RDWR)
                        self.connection.close()
                        return
                    if stub.token_delay_s:
                        time.sleep(stub.token_delay_s)
                    put({"token": t})
                put({"done": True, "output": list(prefix) + toks})
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path.rstrip("/") == "/v1/fleet:drain":
                    stub.draining = True
                    wait_until(lambda: stub.in_flight == 0, timeout=10)
                    self._send(200, {"drained": stub.in_flight == 0,
                                     "draining": True})
                    return
                if self.path.rstrip("/") == "/v1/kv:export":
                    with stub._lock:
                        stub.kv_export_requests.append(req.get("dests"))
                    self._send(200, {"sessions": 2, "migrated": 2,
                                     "failed": 0, "completed_locally": 0})
                    return
                with stub._lock:
                    if stub.fail_next > 0:
                        stub.fail_next -= 1
                        self._send(500, {"error": "injected failure"})
                        return
                if self.path.endswith(":predict"):
                    with stub._lock:
                        stub.predict_hits += 1
                    self._send(200, {"predictions": [{"y": [0.0]}],
                                     "replica": stub.id})
                elif self.path.endswith(":resume"):
                    replay = req.get("replay") or {}
                    with stub._lock:
                        stub.resume_hits += 1
                        stub.resume_requests.append(replay)
                        stub.idem_keys.append(
                            self.headers.get("Idempotency-Key"))
                    seq = list(replay.get("seq", []))
                    plen = int(replay.get("plen", 0))
                    # continue the canned chain at the next new-token
                    # ordinal, exactly like a real seeded replay splice
                    self._stream_ndjson(seq, start=len(seq) - plen,
                                        total=int(replay.get("max_new",
                                                             0)),
                                        ack=True)
                elif self.path.endswith(":generate"):
                    with stub._lock:
                        stub.generate_hits += 1
                        stub.generate_prompts.append(
                            list(req.get("inputs", [[]])[0]))
                        stub.generate_requests.append(dict(req))
                        stub.migrate_headers.append(
                            self.headers.get("X-Fleet-Migrate-To"))
                        stub.kv_peer_headers.append(
                            self.headers.get("X-Fleet-KV-Peer"))
                        stub.idem_keys.append(
                            self.headers.get("Idempotency-Key"))
                        stub.in_flight += 1
                    try:
                        if req.get("stream"):
                            self._stream_ndjson(
                                list(req.get("inputs", [[]])[0]),
                                start=0,
                                total=int(req.get("max_new_tokens", 4)))
                            return
                        if stub.generate_delay_s:
                            time.sleep(stub.generate_delay_s)
                        self._send(200, {"outputs": [[1, 2, 3]],
                                         "replica": stub.id})
                    finally:
                        with stub._lock:
                            stub.in_flight -= 1
                else:
                    self._send(404, {"error": self.path})

            def log_message(self, fmt, *args):
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), _H)
        self.host, self.port = self._server.server_address[:2]
        self.id = f"{self.host}:{self.port}"
        threading.Thread(target=self._server.serve_forever,
                         kwargs={"poll_interval": 0.05},
                         daemon=True).start()

    def close(self):
        self._server.shutdown()
        self._server.server_close()


def spawn(gw, stubs, regs, n=2, n_slots=2, generate_delay_s=0.0,
          heartbeat_s=0.15, role=None, extra_features=None):
    """Start `n` stub replicas and register each with the gateway.
    ``extra_features`` may be a dict (merged into every replica's
    features) or a callable of the replica index returning one."""
    out = []
    for i in range(n):
        s = StubReplica(generate_delay_s=generate_delay_s)
        features = {"kv_page_size": 4}
        if role is not None:
            features["role"] = role
        if extra_features is not None:
            features.update(extra_features(i) if callable(extra_features)
                            else extra_features)
        reg = fleet_client.register_replica(
            gw.registry_addr, s.host, s.port, n_slots=n_slots,
            features=features,
            heartbeat_interval_s=heartbeat_s)
        stubs.append(s)
        regs.append(reg)
        out.append((s, reg))
    assert wait_until(
        lambda: {s.id for s, _ in out}
        <= set(gw.fleet_stats(probe=False)["replicas"]))
    return out
