"""Replica-side fleet helpers: register a serving replica with a
:mod:`fleet` gateway, keep it heartbeating, deregister on exit — the
port of ``tensorflowonspark_tpu/fleet_client.py``.

The registration plane IS the TFoS reservation protocol — a replica is
just a reservation client whose node meta announces a serving endpoint
instead of a training slot: ``reservation.Client.register`` carries the
capacity announcement, ``start_heartbeat`` feeds the gateway's ejection
monitor, ``bye`` is the clean deregistration.  Nothing here opens a new
wire format.  The port's reservation frames JSON where the JAX
package's frames msgpack, so a port replica registers with a port
gateway only (and a JAX replica with a JAX gateway); the HTTP bodies
both gateways exchange with clients and replicas are the same JSON.

Also: :class:`FleetClient`, a minimal stdlib HTTP client for the gateway
(and for any single replica — the surface is the same).  Imports no
torch: a gateway process and its clients stay free of CUDA.
"""
import http.client
import json
import logging
import time

from . import reservation

logger = logging.getLogger(__name__)


def replica_meta(host, port, model_name="default", n_slots=8,
                 features=None):
    """Node meta a serving replica registers with: identity + capacity.

    ``replica_id`` doubles as the reservation-plane ``executor_id`` (one
    id per heartbeat stream); ``features`` carries engine facts the
    gateway routes on — most importantly ``kv_page_size``, which sizes
    the :generate prefix-affinity hash so it matches the replica-side
    prefix-cache page unit."""
    rid = f"{host}:{int(port)}"
    return {"replica_id": rid, "executor_id": rid,
            "host": host, "port": int(port),
            "model_name": model_name, "n_slots": int(n_slots),
            "features": dict(features or {})}


class ReplicaRegistration:
    """One replica's standing registration with the gateway registry.

    Wraps a :class:`reservation.Client` with fail-fast timeouts (a dead
    gateway must not hang replica startup)
    and ties registration + heartbeat + deregistration into one object
    with a context-manager shape::

        reg = ReplicaRegistration(("127.0.0.1", 8400),
                                  replica_meta("10.0.0.5", 8501))
        reg.register()            # REG + start_heartbeat
        ...
        reg.deregister()          # bye() + close()
    """

    def __init__(self, registry_addr, meta, heartbeat_interval_s=2.0,
                 connect_timeout=5.0, rpc_timeout=10.0, retries=3,
                 retry_delay=0.5):
        self.registry_addr = registry_addr
        self.meta = dict(meta)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self._client = reservation.Client(
            registry_addr, connect=False,
            connect_timeout=connect_timeout, rpc_timeout=rpc_timeout,
            retries=retries, retry_delay=retry_delay)
        self._registered = False

    @property
    def replica_id(self):
        return self.meta["replica_id"]

    def register(self):
        """REG with the gateway and start the liveness heartbeat.
        Raises ConnectionError/OSError fast if the gateway is down."""
        resp = self._client.register(self.meta)
        if resp.get("type") == "ERR":
            raise ValueError(f"gateway rejected registration: "
                             f"{resp.get('error')}")
        self._client.start_heartbeat(self.replica_id,
                                     interval=self.heartbeat_interval_s)
        self._registered = True
        logger.info("replica %s registered with fleet at %s",
                    self.replica_id, self.registry_addr)
        return resp

    def stop_heartbeat(self):
        """Stop beating WITHOUT deregistering — the gateway will eject
        this replica after its heartbeat window (crash simulation /
        fencing; tests use this)."""
        self._client.stop_heartbeat()

    def deregister(self):
        """BYE (so the gateway drops the replica immediately rather than
        waiting out the heartbeat window) and close."""
        if self._registered:
            self._client.bye(self.replica_id)
            self._registered = False
        self._client.close()

    def __enter__(self):
        self.register()
        return self

    def __exit__(self, *exc):
        self.deregister()


def register_replica(registry_addr, host, port, model_name="default",
                     n_slots=8, features=None, heartbeat_interval_s=2.0,
                     **client_kw):
    """One-call replica registration: build meta, REG, start heartbeat.
    Returns the live :class:`ReplicaRegistration` (call ``deregister()``
    at shutdown)."""
    reg = ReplicaRegistration(
        registry_addr,
        replica_meta(host, port, model_name=model_name, n_slots=n_slots,
                     features=features),
        heartbeat_interval_s=heartbeat_interval_s, **client_kw)
    reg.register()
    return reg


class FleetClient:
    """Tiny stdlib HTTP client for a fleet gateway (or a bare replica —
    identical surface, which is the point of the gateway)."""

    def __init__(self, host, port, model_name="default", timeout=60.0,
                 tenant=None, priority=None):
        self.host, self.port = host, int(port)
        self.model_name = model_name
        self.timeout = timeout
        # multi-tenant identity: X-Tenant names this client's admission
        # bucket at the gateway; X-Priority picks its default class
        # (interactive | batch) — per-call kwargs override both
        self.tenant = tenant
        self.priority = priority

    def _headers(self, tenant=None, priority=None):
        headers = {"Content-Type": "application/json"}
        tenant = tenant if tenant is not None else self.tenant
        priority = priority if priority is not None else self.priority
        if tenant is not None:
            headers["X-Tenant"] = str(tenant)
        if priority is not None:
            headers["X-Priority"] = str(priority)
        return headers

    def _call(self, method, path, payload=None, timeout=None,
              tenant=None, priority=None):
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout or self.timeout)
        try:
            body = json.dumps(payload).encode() if payload is not None \
                else None
            conn.request(method, path, body=body,
                         headers=self._headers(tenant, priority))
            resp = conn.getresponse()
            data = resp.read()
            try:
                decoded = json.loads(data) if data else {}
            except ValueError:
                decoded = {"raw": data.decode("utf-8", "replace")}
            return resp.status, decoded
        finally:
            conn.close()

    def predict(self, instances, **extra):
        payload = {"instances": instances}
        payload.update(extra)
        return self._call(
            "POST", f"/v1/models/{self.model_name}:predict", payload)

    def generate(self, inputs, tenant=None, priority=None, **extra):
        payload = {"inputs": inputs}
        payload.update(extra)
        return self._call(
            "POST", f"/v1/models/{self.model_name}:generate", payload,
            tenant=tenant, priority=priority)

    def generate_stream(self, prompt, idempotency_key=None, timeout=None,
                        tenant=None, priority=None, **extra):
        """Streaming ``:generate`` for ONE prompt: yield decoded ndjson
        events as they arrive.  Against a gateway this is the
        session-recovery surface — the gateway journals the stream and
        re-drives it onto a live replica if the serving one dies, so the
        iterator keeps yielding byte-identical tokens across a replica
        crash.  Against a bare replica, pass ``idempotency_key`` to make
        retries safe: a re-sent key cancels the prior in-flight run
        instead of double-generating."""
        payload = {"inputs": [list(prompt)], "stream": True}
        payload.update(extra)
        headers = self._headers(tenant, priority)
        if idempotency_key is not None:
            headers["Idempotency-Key"] = str(idempotency_key)
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout or self.timeout)
        try:
            conn.request("POST",
                         f"/v1/models/{self.model_name}:generate",
                         body=json.dumps(payload).encode(),
                         headers=headers)
            resp = conn.getresponse()
            if resp.status != 200:
                data = resp.read()
                try:
                    decoded = json.loads(data) if data else {}
                except ValueError:
                    decoded = {"raw": data.decode("utf-8", "replace")}
                raise RuntimeError(
                    f"streaming generate failed: HTTP {resp.status} "
                    f"{decoded}")
            while True:
                line = resp.readline()
                if not line:
                    break
                line = line.strip()
                if line:
                    yield json.loads(line)
        finally:
            conn.close()

    def metadata(self):
        return self._call("GET", f"/v1/models/{self.model_name}")

    def fleet_stats(self, probe=True):
        return self._call("GET",
                          "/v1/fleet" + ("" if probe else "?probe=0"))

    # -- offline bulk jobs (gateway only) ------------------------------

    def submit_job(self, input_path, request=None, partitions=None,
                   workers=None, fmt=None, **extra):
        """``POST /v1/jobs``: score every record of `input_path`
        through the fleet as batch-class work.  Returns
        ``(status, job_status_dict)``; poll :meth:`job_status` with the
        returned id until the state goes terminal."""
        spec = {"input": input_path,
                "model": self.model_name}
        if request is not None:
            spec["request"] = request
        if partitions is not None:
            spec["partitions"] = int(partitions)
        if workers is not None:
            spec["workers"] = int(workers)
        if fmt is not None:
            spec["format"] = fmt
        spec.update(extra)
        return self._call("POST", "/v1/jobs", spec)

    def job_status(self, job_id):
        return self._call("GET", f"/v1/jobs/{job_id}")

    def jobs(self):
        return self._call("GET", "/v1/jobs")

    def cancel_job(self, job_id):
        return self._call("POST", f"/v1/jobs/{job_id}:cancel")

    def wait_job(self, job_id, timeout_s=60.0, step=0.1):
        """Poll until the job leaves ``running`` (or the wait times
        out); returns the last status body either way."""
        deadline = time.monotonic() + timeout_s
        status = {}
        while time.monotonic() < deadline:
            code, status = self.job_status(job_id)
            if code == 200 and status.get("state") != "running":
                return status
            time.sleep(step)
        return status

    def drain(self, replica_id, timeout_s=60.0):
        rid = replica_id.replace(":", "%3A")
        return self._call(
            "POST", f"/v1/fleet:drain?replica={rid}&timeout_s={timeout_s}",
            timeout=timeout_s + 5.0)

    def migrate(self, replica_id, timeout_s=60.0):
        """Drain `replica_id`, moving its live sessions to decode-capable
        peers instead of waiting them out (rolling upgrade without
        dropping streams)."""
        rid = replica_id.replace(":", "%3A")
        return self._call(
            "POST",
            f"/v1/fleet:migrate?replica={rid}&timeout_s={timeout_s}",
            timeout=timeout_s + 5.0)

    def ready(self):
        try:
            status, _ = self._call("GET", "/readyz", timeout=2.0)
            return status == 200
        except OSError:
            return False

    def alive(self):
        try:
            status, _ = self._call("GET", "/healthz", timeout=2.0)
            return status == 200
        except OSError:
            return False

    def wait_ready(self, timeout_s=30.0, step=0.1):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.ready():
                return True
            time.sleep(step)
        return False
