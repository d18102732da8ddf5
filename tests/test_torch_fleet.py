"""The port's fleet gateway (``tensorflowonspark_tpu_torch.fleet``) and
its client, on the CPU, model-free: the JAX package's gateway scenarios
(``tests/test_fleet.py``, every one not marked slow) run against the
port's gateway over :class:`torch_fleet_stub.StubReplica` replicas that
register through the port's ``fleet_client`` — affinity, spill, the
hedged retry, the breaker, 429 / 503 and ``Retry-After``, drain and
migrate, role routing, the kv-peer header, the fleet totals, the stream
journal and its re-drive, WFQ, quotas, classes and the dark fleet.

Then the pure parts are held to the JAX gateway's on the same inputs
(``_hrw``, ``prefix_key``, ``prompt_len_of``, ``_seed_body`` /
``_replay_meta`` / ``_synth_done``, WFQ order, ``_retry_after``,
``_parse_tenant_classes``, ``build_argparser`` flag for flag), and both
gateways, given the same metas through ``_admit`` (no sockets), pick the
same replica for 200 seeded prompts and give the same ``fleet_stats``
totals, key for key, from the same replica ``stats()`` snapshots.
Tolerance: exact.
"""
import json
import random
import threading
import time
import urllib.error
import urllib.request

import pytest

from tensorflowonspark_tpu import fleet as jax_fleet
from tensorflowonspark_tpu_torch import fleet, fleet_client

from torch_fleet_stub import spawn, wait_until


@pytest.fixture
def gateway():
    gw = fleet.Gateway(heartbeat_timeout_s=0.6, monitor_interval_s=0.05,
                       breaker_threshold=2, breaker_cooldown_s=0.3,
                       connect_timeout_s=2.0, replica_timeout_s=10.0,
                       probe_timeout_s=2.0)
    gw.start()
    stubs, regs = [], []
    try:
        yield gw, stubs, regs
    finally:
        for reg in regs:
            try:
                reg.deregister()
            except Exception:
                pass
        for s in stubs:
            s.close()
        gw.stop()


def _client(gw):
    return fleet_client.FleetClient(*gw.http_addr)


def _affine_stub(gw, stubs, prompt):
    """Which stub the gateway's rendezvous hash maps `prompt` to."""
    key = gw.prefix_key({"inputs": [prompt]})
    return max(stubs, key=lambda s: fleet._hrw(s.id, key))


# ------------------------------------------------- the JAX scenarios --

def test_registration_fleet_stats_and_bye(gateway):
    gw, stubs, regs = gateway
    spawn(gw, stubs, regs, n=2)
    c = _client(gw)
    status, body = c.fleet_stats()     # probing: pulls stub metadata too
    assert status == 200
    assert set(body["replicas"]) == {stubs[0].id, stubs[1].id}
    for desc in body["replicas"].values():
        assert desc["state"] == "up"
        assert desc["model"]["engine"] == "stub"
    # totals aggregate the per-replica generate_stats the stubs report
    assert body["totals"]["slots"] == 4
    assert body["totals"]["prefill_tokens_shared"] == 14
    assert body["totals"]["prefix_pages_cached"] == 6
    # TTFT: count/sum SUM across replicas; the average is recomputed
    # from the fleet-wide sums (per-replica percentiles never sum)
    assert body["totals"]["ttft_count"] == 8
    assert body["totals"]["ttft_ms_sum"] == pytest.approx(200.0)
    assert body["totals"]["ttft_avg_ms"] == pytest.approx(25.0)
    assert body["counters"]["registrations"] == 2
    assert body["gateway"]["prefix_tokens"] == 4   # adopted kv_page_size
    # BYE drops the replica immediately (no heartbeat wait)
    regs[0].deregister()
    assert wait_until(
        lambda: stubs[0].id not in gw.fleet_stats(probe=False)["replicas"])
    assert gw.counters.get("deregistrations") == 1


def test_predict_routes_least_loaded(gateway):
    gw, stubs, regs = gateway
    spawn(gw, stubs, regs, n=2)
    a, b = stubs
    with gw._lock:                       # pin a queue depth on A
        gw._replicas[a.id].outstanding = 3
    status, body = _client(gw).predict([{"x": [1.0, 2.0]}])
    assert status == 200
    assert body["replica"] == b.id       # the less-loaded replica served
    assert b.predict_hits == 1 and a.predict_hits == 0


def test_generate_prefix_affinity_deterministic(gateway):
    gw, stubs, regs = gateway
    spawn(gw, stubs, regs, n=2, n_slots=4)
    c = _client(gw)
    shared = [7, 8, 9, 10]               # kv_page_size=4 -> the hash key
    expect = _affine_stub(gw, stubs, shared)
    served = set()
    for tail in range(5):                # same prefix, different tails
        status, body = c.generate([shared + [100 + tail]])
        assert status == 200
        served.add(body["replica"])
    assert served == {expect.id}         # all on the affine replica
    assert gw.counters.get("affinity_hits") == 5
    # a DIFFERENT prefix may hash elsewhere but is equally deterministic
    status, body = c.generate([[1, 2, 3, 4, 5]])
    assert body["replica"] == _affine_stub(gw, stubs, [1, 2, 3, 4, 5]).id


def test_generate_spills_when_affine_replica_saturated(gateway):
    gw, stubs, regs = gateway
    spawn(gw, stubs, regs, n=2, n_slots=2)
    shared = [7, 8, 9, 10]
    affine = _affine_stub(gw, stubs, shared)
    other = next(s for s in stubs if s.id != affine.id)
    with gw._lock:                       # queue bound = 2.0 * 2 slots
        gw._replicas[affine.id].outstanding = 4
    status, body = _client(gw).generate([shared])
    assert status == 200
    assert body["replica"] == other.id   # cold prefill beats queueing
    assert gw.counters.get("affinity_spills") == 1


def test_predict_hedged_retry_on_5xx(gateway):
    gw, stubs, regs = gateway
    spawn(gw, stubs, regs, n=2)
    a, b = stubs
    with gw._lock:                       # force first pick onto A...
        gw._replicas[b.id].outstanding = 3
    a.fail_next = 1                      # ...which 500s once
    status, body = _client(gw).predict([{"x": [0.0, 0.0]}])
    assert status == 200                 # client never sees the failure
    assert body["replica"] == b.id       # retried on the OTHER replica
    assert gw.counters.get("hedged_retries") == 1
    with gw._lock:                       # A's breaker counted the failure
        assert gw._replicas[a.id].errors == 1


def test_generate_fails_fast_with_typed_error(gateway):
    gw, stubs, regs = gateway
    spawn(gw, stubs, regs, n=2)
    shared = [5, 6, 7, 8]
    affine = _affine_stub(gw, stubs, shared)
    affine.fail_next = 1
    status, body = _client(gw).generate([shared])
    assert status == 502                 # NOT retried: not idempotent
    assert body["type"] == "replica_failure"
    assert body["replica"] == affine.id
    assert body["retryable"] is True
    assert gw.counters.get("generate_failures") == 1
    assert gw.counters.get("hedged_retries") == 0
    assert sum(s.generate_hits for s in stubs) == 0   # nobody re-ran it


def test_circuit_breaker_opens_and_half_opens(gateway):
    gw, stubs, regs = gateway
    spawn(gw, stubs, regs, n=2)
    a, b = stubs
    shared = [5, 6, 7, 8]
    affine = _affine_stub(gw, stubs, shared)
    other = next(s for s in stubs if s.id != affine.id)
    affine.fail_next = 2                 # breaker_threshold=2
    c = _client(gw)
    for _ in range(2):
        status, _ = c.generate([shared])
        assert status == 502
    assert gw.counters.get("breaker_opens") == 1
    # breaker OPEN: affinity ignores the sick replica, no 502s
    status, body = c.generate([shared])
    assert status == 200
    assert body["replica"] == other.id
    # after the cooldown the next request is the half-open trial — it
    # succeeds (fail_next exhausted) and closes the breaker
    time.sleep(0.35)
    status, body = c.generate([shared])
    assert status == 200
    assert body["replica"] == affine.id
    # the breaker reset lands in the handler thread AFTER the response
    # body is relayed, so poll rather than assert immediately
    assert wait_until(
        lambda: gw._replicas[affine.id].failures == 0)


def test_backpressure_429_and_no_replica_503(gateway):
    gw, stubs, regs = gateway
    c = _client(gw)
    # nothing registered at all -> 503
    status, body = c.predict([{"x": [0.0]}])
    assert status == 503
    assert body["type"] == "no_replica"
    (s, _reg), = spawn(gw, stubs, regs, n=1, n_slots=2)
    with gw._lock:                       # saturate the only replica
        gw._replicas[s.id].outstanding = 4
    req = urllib.request.Request(
        "http://%s:%d/v1/models/default:predict" % gw.http_addr,
        data=json.dumps({"instances": [{"x": [0.0]}]}).encode(),
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=5)
    assert e.value.code == 429
    assert e.value.headers["Retry-After"] is not None
    assert json.loads(e.value.read())["type"] == "saturated"
    assert gw.counters.get("rejected_429") == 1
    with gw._lock:                       # back under the bound: serves
        gw._replicas[s.id].outstanding = 0
    status, _ = c.predict([{"x": [0.0]}])
    assert status == 200


def test_drain_waits_for_in_flight_and_deregisters(gateway):
    gw, stubs, regs = gateway
    spawn(gw, stubs, regs, n=2, generate_delay_s=0.5)
    shared = [9, 9, 9, 9]
    affine = _affine_stub(gw, stubs, shared)
    survivor = next(s for s in stubs if s.id != affine.id)
    c = _client(gw)
    results = {}

    def _gen():
        results["gen"] = c.generate([shared])

    t = threading.Thread(target=_gen)
    t.start()
    assert wait_until(lambda: affine.in_flight == 1)   # mid-generation
    t0 = time.monotonic()
    status, out = c.drain(affine.id, timeout_s=10)
    waited = time.monotonic() - t0
    t.join()
    assert status == 200 and out["drained"] is True
    assert waited >= 0.3                 # really waited for the in-flight
    assert results["gen"][0] == 200      # ...which completed normally
    assert out["replica_report"]["draining"] is True
    # drained replica is deregistered; traffic flows to the survivor
    assert affine.id not in gw.fleet_stats(probe=False)["replicas"]
    status, body = c.generate([shared])
    assert status == 200 and body["replica"] == survivor.id
    assert gw.counters.get("drains_started") == 1
    assert gw.counters.get("drains_completed") == 1


def test_drain_unknown_replica_404(gateway):
    gw, stubs, regs = gateway
    status, body = _client(gw).drain("10.0.0.9:1234")
    assert status == 404
    assert "unknown replica" in body["error"]


def test_generate_routes_to_prefill_with_migrate_header(gateway):
    gw, stubs, regs = gateway
    (p, _), = spawn(gw, stubs, regs, n=1, role="prefill")
    (d, _), = spawn(gw, stubs, regs, n=1, role="decode")
    stats = gw.fleet_stats(probe=False)["replicas"]
    assert stats[p.id]["role"] == "prefill"
    assert stats[d.id]["role"] == "decode"
    c = _client(gw)
    status, body = c.generate([[1, 2, 3]])
    assert status == 200
    # :generate prefers prefill-capable replicas and tags the request
    # with the decode peer the replica should hand the session to
    assert body["replica"] == p.id
    assert p.migrate_headers == [d.id]
    assert d.generate_hits == 0
    # :predict is role-blind — the decode replica serves it when the
    # prefill one is busier
    with gw._lock:
        gw._replicas[p.id].outstanding = 3
    status, body = c.predict([{"x": [0.0]}])
    assert status == 200
    assert body["replica"] == d.id


def test_generate_role_preference_is_soft(gateway):
    # a decode-only fleet must not go dark: the preference falls back
    # to every routable replica, and no handoff header is attached
    gw, stubs, regs = gateway
    (d, _), = spawn(gw, stubs, regs, n=1, role="decode")
    status, body = _client(gw).generate([[4, 5, 6]])
    assert status == 200
    assert body["replica"] == d.id
    assert d.migrate_headers == [None]


def test_fleet_migrate_posts_kv_export_and_drains(gateway):
    gw, stubs, regs = gateway
    (p, _), = spawn(gw, stubs, regs, n=1, role="prefill")
    (d, _), = spawn(gw, stubs, regs, n=1, role="decode")
    c = _client(gw)
    status, out = c.migrate(p.id, timeout_s=10)
    assert status == 200
    assert out["drained"] is True
    # the gateway asked the replica to export to its decode peer and
    # attached the replica's own report verbatim
    assert p.kv_export_requests == [[{"host": d.host, "port": d.port}]]
    assert out["migration"] == {"sessions": 2, "migrated": 2,
                                "failed": 0, "completed_locally": 0}
    assert p.id not in gw.fleet_stats(probe=False)["replicas"]
    assert gw.counters.get("drains_completed") == 1
    # no decode-capable peer left: the drain still runs, but the
    # migration report carries the error instead of silently dropping
    status, out = c.migrate(d.id, timeout_s=10)
    assert status == 200
    assert out["drained"] is True
    assert "no decode-capable peer" in out["migration"]["error"]
    assert d.kv_export_requests == []


def test_fleet_stats_migration_totals(gateway):
    gw, stubs, regs = gateway
    spawn(gw, stubs, regs, n=2)
    status, body = _client(gw).fleet_stats()
    assert status == 200
    t = body["totals"]
    # summed across both stubs' generate_stats, like the TTFT keys
    assert t["migrations_started"] == 6
    assert t["migrations_completed"] == 4
    assert t["migrations_failed"] == 2
    assert t["kv_pages_exported"] == 10


def test_fleet_stats_prefill_path_totals(gateway):
    # the kernel/blend prefill dispatch split sums across replicas;
    # replicas that never report the keys (dense, old builds) count 0
    gw, stubs, regs = gateway
    spawn(gw, stubs, regs, n=2)
    stubs[0].extra_stats = {"prefill_kernel_dispatches": 5,
                            "prefill_blend_fallbacks": 1}
    stubs[1].extra_stats = {"prefill_kernel_dispatches": 2}
    status, body = _client(gw).fleet_stats()
    assert status == 200
    t = body["totals"]
    assert t["prefill_kernel_dispatches"] == 7
    assert t["prefill_blend_fallbacks"] == 1


def test_fleet_stats_host_tier_totals(gateway):
    # the hierarchical-kv-cache counters sum into
    # the fleet totals beside prefix_pages_cached
    gw, stubs, regs = gateway
    spawn(gw, stubs, regs, n=2)
    status, body = _client(gw).fleet_stats()
    assert status == 200
    t = body["totals"]
    assert t["prefix_hits"] == 4
    assert t["prefix_misses"] == 2
    assert t["host_hits"] == 4
    assert t["host_demotions"] == 6
    assert t["host_evictions"] == 2
    assert t["host_cache_bytes"] == 4096
    assert t["host_pages_cached"] == 4


def test_fleet_stats_quantized_weight_totals(gateway):
    # quantized replicas advertise their resident weight bytes through
    # metadata's generate_quantize block; the fleet sums them (mixed
    # int8/int4 fleets included), and unquantized replicas contribute 0
    gw, stubs, regs = gateway
    spawn(gw, stubs, regs, n=2)
    stubs[0].extra_model = {"generate_quantize": {
        "mode": "int8", "weight_bytes": 1000,
        "float_equivalent_bytes": 4000}}
    stubs[1].extra_model = {"generate_quantize": {
        "mode": "int4", "weight_bytes": 500,
        "float_equivalent_bytes": 4000}}
    status, body = _client(gw).fleet_stats()
    assert status == 200
    t = body["totals"]
    assert t["weight_bytes"] == 1500
    assert t["weight_float_equivalent_bytes"] == 8000
    stubs[0].extra_model = stubs[1].extra_model = {}
    status, body = _client(gw).fleet_stats()
    assert body["totals"]["weight_bytes"] == 0
    assert body["totals"]["weight_float_equivalent_bytes"] == 0


def test_fleet_stats_job_totals_and_metrics(gateway, tmp_path):
    # bulk-job progress surfaces beside the replica sums: gateway-side
    # keys (filled from the JobManager, not probes) present-and-zero on
    # a jobs-disabled gateway, live counts on a jobs-enabled one — in
    # BOTH /v1/fleet totals and the /metrics exposition
    gw, stubs, regs = gateway
    spawn(gw, stubs, regs, n=1)
    status, body = _client(gw).fleet_stats()
    assert status == 200
    t = body["totals"]
    assert t["jobs_active"] == 0
    assert t["jobs_records_done"] == 0
    assert t["jobs_records_failed"] == 0
    assert "tfospark_fleet_jobs_records_done 0" in gw.metrics_text()

    gw2 = fleet.Gateway(heartbeat_timeout_s=0.6, monitor_interval_s=0.05,
                        connect_timeout_s=2.0, replica_timeout_s=10.0,
                        probe_timeout_s=2.0,
                        jobs_dir=str(tmp_path / "jobs"))
    gw2.start()
    reg2 = None
    try:
        reg2 = fleet_client.register_replica(
            gw2.registry_addr, stubs[0].host, stubs[0].port, n_slots=2,
            features={"kv_page_size": 4}, heartbeat_interval_s=0.15)
        path = tmp_path / "in.jsonl"
        path.write_text("".join(json.dumps([i, 7]) + "\n"
                                for i in range(5)))
        cli = _client(gw2)
        code, st = cli.submit_job(str(path), partitions=2)
        assert code == 200, st
        assert cli.wait_job(st["id"],
                            timeout_s=30.0)["state"] == "completed"
        status, body = cli.fleet_stats()
        assert body["totals"]["jobs_records_done"] == 5
        assert body["totals"]["jobs_records_failed"] == 0
        assert body["totals"]["jobs_active"] == 0
        text = gw2.metrics_text()
        assert "tfospark_fleet_jobs_records_done 5" in text
        assert "tfospark_gateway_jobs_completed 1" in text
    finally:
        if reg2 is not None:
            try:
                reg2.deregister()
            except Exception:
                pass
        gw2.stop()


def test_generate_spill_plants_kv_peer_header(gateway):
    # when routing lands AWAY from the prefix-affine
    # replica (here: it saturated), the gateway hands the chosen one
    # the affine peer's kv:prefix address so it can pull the returning
    # conversation's pages instead of re-prefilling
    gw, stubs, regs = gateway
    spawn(gw, stubs, regs, n=2, n_slots=2,
           extra_features=lambda i: {"kv_prefix_addr":
                                     "10.0.0.%d:7400" % (i + 1)})
    shared = [7, 8, 9, 10]
    affine = _affine_stub(gw, stubs, shared)
    other = next(s for s in stubs if s.id != affine.id)
    with gw._lock:
        affine_addr = \
            gw._replicas[affine.id].features["kv_prefix_addr"]
        gw._replicas[affine.id].outstanding = 4    # saturate affine
    status, body = _client(gw).generate([shared])
    assert status == 200
    assert body["replica"] == other.id
    assert other.kv_peer_headers == [affine_addr]
    assert gw.counters.get("kv_peer_planted") == 1
    # routed TO the affine replica, nothing is planted: its own host
    # tier is already the warmest copy
    with gw._lock:
        gw._replicas[affine.id].outstanding = 0
    status, body = _client(gw).generate([shared])
    assert status == 200
    assert body["replica"] == affine.id
    assert affine.kv_peer_headers == [None]
    assert gw.counters.get("kv_peer_planted") == 1


def test_kv_peer_skipped_without_advertised_addr(gateway):
    # replicas that never advertise kv_prefix_addr (host tier off) are
    # never named as peers, and nothing is planted fleet-wide
    gw, stubs, regs = gateway
    spawn(gw, stubs, regs, n=2, n_slots=2)
    shared = [7, 8, 9, 10]
    affine = _affine_stub(gw, stubs, shared)
    with gw._lock:
        gw._replicas[affine.id].outstanding = 4
    status, body = _client(gw).generate([shared])
    assert status == 200
    for s in stubs:
        assert all(h is None for h in s.kv_peer_headers)
    assert gw.counters.get("kv_peer_planted") == 0


def test_gateway_metadata_passthrough(gateway):
    gw, stubs, regs = gateway
    spawn(gw, stubs, regs, n=1)
    status, body = _client(gw).metadata()
    assert status == 200
    assert body["model"]["engine"] == "stub"


def test_stream_relays_and_journal_drains(gateway):
    gw, stubs, regs = gateway
    spawn(gw, stubs, regs, n=1)
    prompt = [7, 8, 9, 10]
    events = list(_client(gw).generate_stream(prompt, max_new_tokens=3))
    assert [e["token"] for e in events if "token" in e] == [100, 101, 102]
    assert events[-1] == {"done": True, "output": prompt + [100, 101, 102]}
    # the relay tee journaled the stream, and the finally closed it:
    # zero entries outlive their stream (the stranded-journal invariant)
    assert wait_until(lambda: len(gw.journal) == 0)
    assert gw.fleet_stats(probe=False)["gateway"]["journal_depth"] == 0
    # the gateway attached its journal key as the Idempotency-Key
    assert stubs[0].idem_keys != [None]


def test_stream_redrive_resumes_without_double_generate(gateway):
    """A re-driven session must NEVER re-run
    :generate once tokens were emitted — recovery goes through the
    :resume replay (same Idempotency-Key), so nothing double-generates
    and the client's byte stream is seamless across the crash."""
    gw, stubs, regs = gateway
    spawn(gw, stubs, regs, n=2, n_slots=4)
    prompt = [7, 8, 9, 10]
    affine = _affine_stub(gw, stubs, prompt)
    other = next(s for s in stubs if s.id != affine.id)
    affine.die_after = 2            # crash after streaming 2 tokens
    events = list(_client(gw).generate_stream(prompt, max_new_tokens=4))
    toks = [e["token"] for e in events if "token" in e]
    assert toks == [100, 101, 102, 103]   # byte parity across the crash
    assert events[-1]["done"] is True
    assert events[-1]["output"] == prompt + toks
    # exactly one :generate ever ran; the re-drive was a :resume replay
    assert affine.generate_hits == 1 and other.generate_hits == 0
    assert other.resume_hits == 1
    [replay] = other.resume_requests
    assert replay["seq"] == prompt + [100, 101]
    assert replay["plen"] == len(prompt)
    assert replay["remaining"] == 2
    # one journal key identifies the session across both replicas
    assert affine.idem_keys == other.idem_keys != [None]
    assert gw.counters.get("session_redrives") == 1
    assert gw.counters.get("sessions_recovered") == 1
    # entry closes in the handler's finally, a beat after the last chunk
    assert wait_until(lambda: len(gw.journal) == 0)


def test_retry_after_floor_when_no_drain_samples(gateway):
    # a cold gateway (fewer than two completions observed) has
    # no drain rate to derive from -> the flat constant is the FLOOR
    gw, stubs, regs = gateway
    assert gw._retry_after() == gw.retry_after_s
    spawn(gw, stubs, regs, n=1)
    assert gw._retry_after() == gw.retry_after_s


def test_retry_after_tracks_drain_rate_between_bounds(gateway):
    gw, stubs, regs = gateway
    (s, _reg), = spawn(gw, stubs, regs, n=1)
    now = time.monotonic()
    # 11 completions over the last second -> 10/s drain rate; 10 ahead
    # in line -> ~1.1s estimate, between floor (1.0) and cap (30.0)
    gw._done_times.extend(now - 1.0 + i * 0.1 for i in range(11))
    with gw._lock:
        gw._replicas[s.id].outstanding = 10
    est = gw._retry_after()
    assert gw.retry_after_s < est < gw.retry_after_cap_s
    assert est == pytest.approx(1.1, rel=0.05)


def test_retry_after_cap_on_429_header(gateway):
    # a nearly-wedged fleet (slow drain, deep line) must not
    # tell clients "come back in 20 minutes" — the cap bounds the header
    gw, stubs, regs = gateway
    (s, _reg), = spawn(gw, stubs, regs, n=1, n_slots=2)
    now = time.monotonic()
    gw._done_times.extend([now - 1.0, now])          # 1 completion/s
    with gw._lock:
        gw._replicas[s.id].outstanding = 1000        # saturated AND deep
    req = urllib.request.Request(
        "http://%s:%d/v1/models/default:predict" % gw.http_addr,
        data=json.dumps({"instances": [{"x": [0.0]}]}).encode(),
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=5)
    assert e.value.code == 429
    assert float(e.value.headers["Retry-After"]) == gw.retry_after_cap_s


def test_wfq_weighted_order_is_deterministic():
    # pure virtual-time ordering, no timing: a batch-heavy tenant and an
    # interactive tenant enter interleaved; heads depart in weight
    # proportion (interactive 8:1), FIFO within one tenant
    q = fleet.WeightedFairQueue()
    b = [q.enter("bulk", "batch") for _ in range(3)]      # vft 1, 2, 3
    i = [q.enter("chat", "interactive") for _ in range(3)]  # 1/8, 2/8, 3/8
    order = []
    while len(q):
        t = q.head()
        order.append(t)
        q.leave(t, served=True)
    assert order == i + b                  # all interactive first, FIFO
    # wait_turn: the head returns immediately, a non-head times out
    q2 = fleet.WeightedFairQueue()
    first = q2.enter("a", "interactive")
    second = q2.enter("a", "interactive")
    assert q2.wait_turn(first, timeout=0.5)
    assert not q2.wait_turn(second, timeout=0.05)
    q2.leave(first, served=True)
    assert q2.wait_turn(second, timeout=0.5)
    q2.leave(second, served=True)
    # a served departure advances the virtual clock: a tenant arriving
    # AFTER a long-queued one cannot be assigned a finish time in the past
    q3 = fleet.WeightedFairQueue()
    old = q3.enter("a", "batch")           # vft 1.0
    q3.leave(old, served=True)             # vtime -> 1.0
    late = q3.enter("b", "batch")          # vft 2.0, not 1.0
    assert late["key"][0] == pytest.approx(2.0)


def test_tenant_quota_caps_concurrency_and_releases(gateway):
    gw, stubs, regs = gateway
    gw.tenant_quota = 1
    spawn(gw, stubs, regs, n=1, n_slots=4, generate_delay_s=0.4)
    c = _client(gw)
    results = {}

    def _gen():
        results["first"] = c.generate([[1, 2, 3]], tenant="acme")

    t = threading.Thread(target=_gen)
    t.start()
    assert wait_until(lambda: gw._tenant_inflight.get("acme") == 1)
    # same tenant at quota -> 429; a DIFFERENT tenant still admits
    status, body = c.generate([[4, 5, 6]], tenant="acme")
    assert status == 429 and body["type"] == "saturated"
    assert gw.counters.get("rejected_quota") == 1
    status, _ = c.generate([[4, 5, 6]], tenant="other")
    assert status == 200
    t.join()
    assert results["first"][0] == 200
    # the wrap released on every exit path: nothing left in flight
    assert wait_until(lambda: not gw._tenant_inflight)
    status, _ = c.generate([[7, 8]], tenant="acme")
    assert status == 200


def test_priority_class_resolution_and_body_injection(gateway):
    gw, stubs, regs = gateway
    gw.tenant_classes["bulkco"] = "batch"
    (s, _reg), = spawn(gw, stubs, regs, n=1)
    c = _client(gw)
    # header wins; the resolved class is planted into the replica body
    status, _ = c.generate([[1, 2]], priority="batch")
    assert status == 200
    assert s.generate_requests[-1]["priority"] == "batch"
    # server-side tenant->class map when no header
    status, _ = c.generate([[1, 2]], tenant="bulkco")
    assert status == 200
    assert s.generate_requests[-1]["priority"] == "batch"
    # default: interactive
    status, _ = c.generate([[1, 2]])
    assert status == 200
    assert s.generate_requests[-1]["priority"] == "interactive"
    # an explicit body value is never overwritten by the header
    status, _ = c._call("POST", "/v1/models/default:generate",
                        {"inputs": [[1, 2]], "priority": "interactive"},
                        priority="batch")
    assert status == 200
    assert s.generate_requests[-1]["priority"] == "interactive"


def test_wfq_spill_wait_degrades_saturation_into_delay(gateway):
    # overload degradation: with spill_wait_s armed, a saturated fleet
    # parks the request in the weighted-fair queue instead of 429ing;
    # capacity freeing within the window lets it through
    gw, stubs, regs = gateway
    gw.spill_wait_s = 5.0
    (s, _reg), = spawn(gw, stubs, regs, n=1, n_slots=2)
    with gw._lock:
        gw._replicas[s.id].outstanding = 4       # at the queue bound
    c = _client(gw)
    results = {}

    def _gen():
        results["r"] = c.generate([[1, 2, 3]], tenant="acme")

    t = threading.Thread(target=_gen)
    t.start()
    assert wait_until(lambda: len(gw._wfq) == 1)
    assert gw.counters.get("wfq_waits") == 1
    with gw._lock:                               # capacity frees up
        gw._replicas[s.id].outstanding = 0
    gw._wfq.wake()
    t.join(timeout=5)
    assert results["r"][0] == 200
    assert len(gw._wfq) == 0
    assert gw.counters.get("rejected_429") in (None, 0)


def test_fleet_stats_per_class_totals_sum_and_empty_class(gateway):
    # per-class LatencyWindow aggregation — count/ms_sum are
    # summed across replicas, a replica with an EMPTY class contributes
    # zero (its absence must not poison the fleet average), and
    # percentiles are never summed into totals
    gw, stubs, regs = gateway
    spawn(gw, stubs, regs, n=2)
    # one replica served batch traffic too; the other never did
    stubs[0].extra_stats = {"ttft_batch_count": 3,
                            "ttft_batch_ms_sum": 300.0,
                            "ttft_batch_p95_ms": 500.0,
                            "qdelay_batch_count": 3,
                            "qdelay_batch_ms_sum": 30.0}
    status, body = _client(gw).fleet_stats()
    assert status == 200
    t = body["totals"]
    # interactive: both replicas' canned windows summed
    assert t["ttft_interactive_count"] == 4
    assert t["ttft_interactive_ms_sum"] == 80.0
    assert t["ttft_interactive_avg_ms"] == 20.0
    assert t["qdelay_interactive_count"] == 4
    assert t["qdelay_interactive_ms_sum"] == 20.0
    # batch: only the one replica that served it; the empty-class
    # replica contributed 0 rather than skewing the average
    assert t["ttft_batch_count"] == 3
    assert t["ttft_batch_ms_sum"] == 300.0
    assert t["ttft_batch_avg_ms"] == 100.0
    assert t["qdelay_batch_avg_ms"] == 10.0
    # a per-replica p95 is window-local: it never lands in totals
    assert "ttft_batch_p95_ms" not in t
    assert "ttft_interactive_p95_ms" not in t
    # park traffic sums like the migration counters
    assert t["sessions_parked"] == 2
    assert t["sessions_unparked"] == 2
    assert t["parked_sessions"] == 0


def test_stream_rejects_fast_when_fleet_dark(gateway):
    # a fresh streaming request with nothing routable fails FAST with
    # the typed 503 — it is never parked in the journal
    gw, stubs, regs = gateway
    with pytest.raises(RuntimeError) as e:
        list(_client(gw).generate_stream([1, 2, 3]))
    assert "503" in str(e.value)
    assert gw.counters.get("rejected_no_replica") == 1
    assert wait_until(lambda: len(gw.journal) == 0)



# ---------------------------------------- held to the JAX gateway --


def _both(**kw):
    """A JAX gateway and a port gateway built alike, never started (no
    sockets: replicas join through ``_admit``)."""
    return jax_fleet.Gateway(**kw), fleet.Gateway(**kw)


def _metas(n=5, seed=0):
    """Replica metas with mixed roles, page sizes and the lane."""
    rs = random.Random(seed)
    roles = ("prefill", "decode", "mixed")
    out = []
    for i in range(n):
        host, port = f"10.0.{i}.{rs.randint(1, 250)}", 8500 + i
        features = {"kv_page_size": 16, "kv_pages": 64 * (i + 1),
                    "role": roles[i % 3]}
        if i % 2:
            features["long_prompt_threshold"] = 40 + 10 * i
            features["kv_prefix_addr"] = f"{host}:{7400 + i}"
        out.append(fleet_client.replica_meta(host, port,
                                             n_slots=2 + i % 3,
                                             features=features))
    return out


def _prompts(n, seed):
    rs = random.Random(seed)
    return [[rs.randrange(64) for _ in range(rs.randint(1, 90))]
            for _ in range(n)]


def test_hrw_prefix_key_and_prompt_len_match_jax():
    rs = random.Random(1)
    for _ in range(200):
        rid = (f"10.{rs.randrange(256)}.0.{rs.randrange(256)}:"
               f"{rs.randrange(9000)}")
        key = tuple(rs.randrange(32000) for _ in range(rs.randint(1, 64)))
        assert fleet._hrw(rid, key) == jax_fleet._hrw(rid, key)
    bodies = [{"inputs": [p]} for p in _prompts(20, 2)] + [
        {}, {"inputs": []}, {"inputs": [[]]}, {"inputs": "x"},
        {"inputs": [[1, 2], [3, 4, 5, 6]]}, {"inputs": [None]}]
    for prefix_tokens in (None, 4, 16):
        jg, pg = _both(prefix_tokens=prefix_tokens)
        for body in bodies:
            assert pg.prefix_key(body) == jg.prefix_key(body), body
            assert (fleet.Gateway.prompt_len_of(body)
                    == jax_fleet.Gateway.prompt_len_of(body)), body
        # the first registrant's kv_page_size sizes the key alike
        for g in (jg, pg):
            g._admit(_metas(1)[0])
        for body in bodies:
            assert pg.prefix_key(body) == jg.prefix_key(body), body


def test_session_recovery_helpers_match_jax():
    rs = random.Random(3)
    jg, pg = _both()
    bodies = [
        {"inputs": [[1, 2, 3]], "max_new_tokens": 8},
        {"inputs": [[4, 5]], "temperature": 0.8, "max_new_tokens": 6},
        {"inputs": [[4, 5]], "temperature": 0.8, "seed": 11},
        {"inputs": [[7]], "temperature": "hot"},
        {"inputs": [[9, 9, 9]], "temperature": 0.5, "top_k": 5,
         "top_p": 0.9, "min_p": 0.05, "eos_id": 3, "stop": [[1, 2], [4]],
         "repetition_penalty": 1.2, "adapter": "a", "priority": "batch",
         "trace": "ab" * 8, "max_new_tokens": 5},
    ]
    for body in bodies:
        jb, pb = json.loads(json.dumps(body)), json.loads(json.dumps(body))
        jg._seed_body(jb)
        pg._seed_body(pb)
        assert pb == jb
        for _ in range(6):
            toks = [rs.randrange(6) for _ in range(rs.randint(0, 6))]
            try:
                want = jg._replay_meta(jb, toks)
            except (TypeError, ValueError) as e:
                with pytest.raises(type(e)):
                    pg._replay_meta(pb, toks)
            else:
                assert pg._replay_meta(pb, toks) == want
            assert pg._synth_done(pb, toks) == jg._synth_done(jb, toks)
    # the finished shapes: max_new reached, eos last, a stop suffix
    for body, toks in (({"inputs": [[1]], "max_new_tokens": 2}, [5, 6]),
                       ({"inputs": [[1]], "eos_id": 6}, [5, 6]),
                       ({"inputs": [[1]], "stop": [[5, 6]]}, [4, 5, 6])):
        assert pg._synth_done(body, toks) == jg._synth_done(body, toks)
        assert pg._synth_done(body, toks)["done"] is True


def test_wfq_order_matches_jax():
    rs = random.Random(4)
    jq, pq = jax_fleet.WeightedFairQueue(), fleet.WeightedFairQueue()
    order = {"jax": [], "port": []}
    for _ in range(300):
        if rs.random() < 0.6 or not len(pq):
            tenant = f"t{rs.randrange(5)}"
            cls = rs.choice(fleet.PRIORITY_CLASSES)
            cost = rs.choice((1.0, 2.0, 0.5))
            jt, pt = jq.enter(tenant, cls, cost), pq.enter(tenant, cls, cost)
            assert pt == jt
        else:
            served = rs.random() < 0.8
            for name, q in (("jax", jq), ("port", pq)):
                head = q.head()
                order[name].append(head)
                q.leave(head, served=served)
    assert order["port"] == order["jax"] and len(order["port"]) > 50


def test_retry_after_and_tenant_classes_match_jax():
    jg, pg = _both(retry_after_s=0.5, retry_after_cap_s=7.0)
    now = time.monotonic()
    metas = _metas(3)
    for g in (jg, pg):
        for m in metas:
            g._admit(m)
    assert pg._retry_after() == jg._retry_after() == 0.5
    for n_done, outstanding in ((2, 0), (11, 10), (30, 3), (64, 1000)):
        for g in (jg, pg):
            g._done_times.clear()
            g._done_times.extend(now - 1.0 + i / n_done
                                 for i in range(n_done))
            with g._lock:
                for i, r in enumerate(g._replicas.values()):
                    r.outstanding = outstanding + i
        assert pg._retry_after() == jg._retry_after()
    pairs = (["a=batch", "b=interactive"], [], None,
             ["x=batch", "x=interactive"])
    for p in pairs:
        assert (fleet._parse_tenant_classes(p)
                == jax_fleet._parse_tenant_classes(p))
    for bad in (["a"], ["=batch"], ["a=urgent"], ["a:batch"]):
        with pytest.raises(ValueError):
            jax_fleet._parse_tenant_classes(bad)
        with pytest.raises(ValueError):
            fleet._parse_tenant_classes(bad)


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                     a.const, a.choices, a.metavar, type(a).__name__)
            for a in parser._actions}


def test_argparser_matches_jax_flag_for_flag():
    port_p, jax_p = fleet.build_argparser(), jax_fleet.build_argparser()
    assert _actions(port_p) == _actions(jax_p)
    assert vars(port_p.parse_args([])) == vars(jax_p.parse_args([]))
    argv = ["--port", "0", "--registry_port", "0",
            "--heartbeat_timeout_s", "1.5", "--ejection_misses", "2",
            "--readmit_cooldown_s", "0.3", "--redrive_attempts", "5",
            "--redrive_deadline_s", "9", "--prefix_tokens", "32",
            "--queue_depth_factor", "3", "--breaker_threshold", "4",
            "--breaker_cooldown_s", "2", "--tenant_quota", "3",
            "--tenant_class", "a=batch", "--spill_wait_s", "0.5",
            "--jobs_dir", "/tmp/j", "--job_workers", "4",
            "--job_checkpoint_every", "8", "--job_record_timeout_s", "30"]
    assert vars(port_p.parse_args(argv)) == vars(jax_p.parse_args(argv))
    assert port_p.prog == "tensorflowonspark_tpu_torch.fleet"


def test_choose_picks_the_jax_replica_for_seeded_prompts():
    """Both gateways, the same metas admitted alike, pick the same
    replica (affinity, the lane, role preference) and plant the same
    migrate target and kv peer, for 200 seeded prompts; a pick is
    released before the next, so queue bounds stay out of it."""
    jg, pg = _both()
    for g in (jg, pg):
        for m in _metas(5):
            g._admit(m)
    picks = []
    for i, prompt in enumerate(_prompts(200, 5)):
        body = {"inputs": [prompt]}
        roles = (("prefill", "mixed"), None, ("decode",))[i % 3]
        got = []
        for g in (jg, pg):
            key = g.prefix_key(body)
            r = g._choose(prefix_key=key, roles=roles,
                          prompt_len=g.prompt_len_of(body))
            dest = g.migrate_target(r)
            got.append((r.id, dest.id if dest else None,
                        g.kv_peer_for(key, r)))
            g._release(r, ok=True)
        assert got[1] == got[0], (i, prompt)
        picks.append(got[0][0])
    assert len(set(picks)) >= 3
    for name in ("affinity_hits", "long_routes", "kv_peer_planted"):
        assert pg.counters.get(name) == jg.counters.get(name), name


def _snapshot(i):
    """A replica's metadata body: generate_stats (with histograms) and a
    quantised weight block, different per replica."""
    from tensorflowonspark_tpu_torch.metrics import LatencyWindow

    rs = random.Random(10 + i)
    gs = {}
    for key in ("slots_busy", "pending", "prefill_tokens_shared",
                "prefix_pages_cached", "kv_pages_used", "kv_pages_free",
                "kv_sink_writes", "prefix_hits", "prefix_misses",
                "host_hits", "host_demotions", "host_evictions",
                "host_cache_bytes", "host_pages_cached",
                "prefill_kernel_dispatches", "kv_table_grows",
                "long_chunks_dispatched", "decode_steps",
                "pipeline_depth_peak", "migrations_started",
                "migrations_completed", "kv_pages_exported",
                "sessions_parked", "sessions_unparked", "spec_rounds",
                "spec_tokens_proposed", "spec_tokens_accepted",
                "ttft_count", "ttft_interactive_count",
                "qdelay_batch_count"):
        if rs.random() < 0.85:
            gs[key] = rs.randrange(50)
    for key in ("ttft_ms_sum", "ttft_interactive_ms_sum",
                "qdelay_batch_ms_sum"):
        gs[key] = rs.random() * 300.0
    for stem in ("ttft", "qdelay_interactive"):
        w = LatencyWindow()
        for _ in range(rs.randrange(1, 30)):
            w.record(rs.random() * 2.0)
        gs[f"{stem}_hist"] = w.histogram()
    model = {"engine": "torch-cuda", "generate_stats": gs}
    if i % 2:
        model["generate_quantize"] = {"mode": "int8",
                                      "weight_bytes": 1000 * (i + 1),
                                      "float_equivalent_bytes": 4000}
    return {"status": "ok", "model": model}


def test_fleet_stats_totals_match_jax(monkeypatch):
    jg, pg = _both()
    metas = _metas(4)
    snaps = {f"{m['host']}:{m['port']}": _snapshot(i)
             for i, m in enumerate(metas)}
    for g in (jg, pg):
        for m in metas:
            g._admit(m)
        monkeypatch.setattr(
            g, "probe",
            lambda r, path, timeout=None: (200, json.loads(
                json.dumps(snaps[r.id]))))
    j, p = jg.fleet_stats(), pg.fleet_stats()
    assert list(p["totals"]) == list(j["totals"])
    for key in j["totals"]:
        assert p["totals"][key] == j["totals"][key], key
    assert p["totals"]["ttft_hist"]["count"] > 0
    assert p["counters"] == j["counters"]
    strip = ("last_beat_age_s",)          # read off each clock
    for rid in snaps:
        assert ({k: v for k, v in p["replicas"][rid].items()
                 if k not in strip}
                == {k: v for k, v in j["replicas"][rid].items()
                    if k not in strip})
    assert p["gateway"] == j["gateway"]
