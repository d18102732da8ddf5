"""The port's fleet end to end on the CPU: a port gateway
(``fleet.Gateway``) in front of real port replicas of a tiny exported LM
that join through ``serve``'s ``--fleet`` path (REG, 0.1 s heartbeats,
BYE), counterparts of the JAX package's gateway acceptance cases
(``tests/test_kvtransfer.py``, ``test_trace.py``, ``test_preemption.py``,
``test_chaos.py``):

- greedy streams through the gateway, handed from a ``--role prefill``
  replica to a ``--role decode`` one (the gateway plants
  ``X-Fleet-Migrate-To``), give the tokens of the JAX gateway over JAX
  replicas of the same weights (carried across by
  ``convert.params_from_jax``); seeded sampled streams give the port's
  unmoved runs; ``POST /v1/fleet:migrate`` moves a live direct stream
  and its tokens stay those of the unmoved run;
- a traced stream's ``GET /v1/trace/<id>`` on the gateway stitches
  spans of the gateway and both replicas; the gateway's and the
  replicas' ``GET /metrics`` carry the fleet totals and every stats key;
- with preemption armed, the fleet totals carry the replica's
  per-class windows (count and sum, never a window-local p95);
- a replica killed mid-stream (heartbeat stopped, server closed) is
  ejected and every journaled stream is re-driven to the survivor
  through ``:resume`` with ``replay``: the tokens of the unmoved runs; a
  replica that dies holding PARKED sessions fails them and the journal
  re-drives them alike;
- bulk jobs over the replicas: with a replica killed mid-partition,
  and across a gateway restart, ``output.jsonl`` equals direct scoring
  record by record, exactly once;
- ``python -m tensorflowonspark_tpu_torch.serve ... --fleet HOST:PORT``
  registers with ``python -m tensorflowonspark_tpu_torch.fleet``, serves
  through it and deregisters at shutdown.
Every wait is bounded and every test runs under its own time limit.
Tolerance: exact (f32 tokens).
"""
import functools
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import urllib.request

import pytest

from tensorflowonspark_tpu import export as jax_export
from tensorflowonspark_tpu import fleet as jax_fleet
from tensorflowonspark_tpu import fleet_client as jax_fleet_client
from tensorflowonspark_tpu import serve as jax_serve
from tensorflowonspark_tpu_torch import fleet, fleet_client, jobs, serve

import torch_replica_lm as lm_mod
from torch_fleet_stub import wait_until

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGED = ("--generate_kv_page_size", "8", "--generate_kv_pages", "64",
         "--generate_prefill_chunk", "16", "--generate_read_chunk", "1")
N_NEW = 16
TEMP, SEED = 0.8, 5


def time_limit(seconds):
    """Run the test in a thread and fail it past ``seconds``."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            box = {}

            def body():
                try:
                    fn(*args, **kw)
                except BaseException as e:     # re-raised below
                    box["err"] = e

            t = threading.Thread(target=body, daemon=True)
            t.start()
            t.join(seconds)
            if t.is_alive():
                pytest.fail(f"{fn.__name__} ran past its {seconds} s limit")
            if "err" in box:
                raise box["err"]
        return run
    return deco


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    return lm_mod.export_lm(tmp_path_factory.mktemp("fleet_lm"))


def _gateway(**kw):
    # a 2 s window over 0.1 s beats: a loaded machine delays a beat
    # thread by far less, so only a killed replica is ejected
    gw = fleet.Gateway(**dict(dict(
        heartbeat_timeout_s=2.0, monitor_interval_s=0.05,
        ejection_misses=2, connect_timeout_s=5.0, replica_timeout_s=120.0,
        probe_timeout_s=30.0, redrive_deadline_s=60.0), **kw))
    gw.start()
    return gw


class FleetReplica(lm_mod.Replica):
    """A port replica on the CPU that joins ``gw`` through ``serve``'s
    ``--fleet`` path, heartbeating every 0.1 s."""

    def __init__(self, gw, export_dir, *argv):
        super().__init__(export_dir, "--host", "127.0.0.1", "--fleet",
                         "%s:%d" % gw.registry_addr, "--fleet_heartbeat_s",
                         "0.1", *argv)
        self.reg = serve._register_with_fleet(self.args, self.server,
                                              self.service)
        self.id = f"127.0.0.1:{self.port}"
        self.killed = False

    def kill(self):
        """The crash: beats stop and the server (and its engine) goes,
        without a BYE."""
        self.killed = True
        self.reg.stop_heartbeat()
        super().close()

    def close(self):
        if not self.killed:
            self.killed = True
            self.reg.deregister()
            super().close()


def _joined(gw, replicas):
    assert wait_until(lambda: {r.id for r in replicas}
                      <= set(gw.fleet_stats(probe=False)["replicas"]),
                      timeout=30)


def _stream(client, prompt, n=N_NEW, **kw):
    """(tokens, done output, last event) of a streamed :generate."""
    events = list(client.generate_stream(prompt, max_new_tokens=n,
                                         timeout=120, **kw))
    toks = [e["token"] for e in events if "token" in e]
    return toks, events[-1].get("output"), events[-1]


def _direct(replica, prompt, n=N_NEW, **kw):
    """The unmoved run: the prompt alone on ``replica``, no header."""
    return replica.generate({"inputs": [prompt], "max_new_tokens": n,
                             **kw})[0]


@pytest.fixture(scope="module")
def jax_gateway_outputs(tmp_path_factory):
    """Greedy streams through the JAX gateway over a prefill and a decode
    JAX replica of the same weights: {prompt tuple: output}."""
    jm, params, _ = lm_mod.tiny_lm()
    d = str(tmp_path_factory.mktemp("jax_lm"))
    jax_export.export_saved_model(
        d, params,
        builder="tensorflowonspark_tpu.models.transformer:build_transformer",
        builder_kwargs=dict(lm_mod.CFG, dtype="float32"))
    gw = jax_fleet.Gateway(heartbeat_timeout_s=10.0, monitor_interval_s=0.1,
                           replica_timeout_s=120.0, probe_timeout_s=30.0)
    gw.start()
    servers, regs = [], []
    try:
        for role in ("prefill", "decode"):
            args = jax_serve.build_argparser().parse_args([
                "--export_dir", d, "--host", "127.0.0.1", "--port", "0",
                "--generate_slots", "4", *PAGED, "--role", role,
                "--fleet", "%s:%d" % gw.registry_addr,
                "--fleet_heartbeat_s", "0.1"])
            srv, _ = jax_serve.make_server(args)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            servers.append(srv)
            regs.append(jax_serve._register_with_fleet(args, srv))
        assert wait_until(lambda: len(gw.fleet_stats(
            probe=False)["replicas"]) == 2, timeout=30)
        c = jax_fleet_client.FleetClient(*gw.http_addr, timeout=120)
        out = {}
        for p in lm_mod.prompts(4, seed=81):
            events = list(c.generate_stream(p, max_new_tokens=N_NEW))
            out[tuple(p)] = events[-1]["output"]
        assert gw.fleet_stats()["totals"]["migrations_completed"] == 4
        return out
    finally:
        for reg in regs:
            reg.deregister()
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        gw.stop()


@time_limit(120)
def test_handoff_through_the_gateway_gives_the_jax_gateways_tokens(
        export_dir, jax_gateway_outputs):
    gw = _gateway()
    p = d = None
    try:
        p = FleetReplica(gw, export_dir, "--generate_slots", "2", *PAGED,
                         "--role", "prefill")
        d = FleetReplica(gw, export_dir, "--generate_slots", "4", *PAGED,
                         "--role", "decode")
        _joined(gw, [p, d])
        roles = {rid: r["role"] for rid, r in
                 gw.fleet_stats(probe=False)["replicas"].items()}
        assert roles == {p.id: "prefill", d.id: "decode"}
        feats = gw.fleet_stats(probe=False)["replicas"][p.id]["features"]
        assert feats["kv_page_size"] == 8 and feats["kv_pages"] == 64
        assert feats["paged_attn_impl"] == "kernel"
        assert gw.fleet_stats(probe=False)["gateway"]["prefix_tokens"] == 8
        c = fleet_client.FleetClient(*gw.http_addr, timeout=120)
        # greedy: the JAX gateway's outputs, the tokens the client saw
        for prompt, want in jax_gateway_outputs.items():
            toks, out, _ = _stream(c, list(prompt))
            assert out == want
            assert list(prompt) + toks == want
        # seeded sampled: the port's unmoved run on the prefill replica
        for prompt in lm_mod.prompts(2, seed=82):
            toks, out, _ = _stream(c, prompt, temperature=TEMP, seed=SEED)
            want = _direct(p, prompt, temperature=TEMP, seed=SEED)
            assert out == want and prompt + toks == want
        totals = gw.fleet_stats()["totals"]
        assert totals["migrations_started"] == 6
        assert totals["migrations_completed"] == 6
        assert totals["migrations_failed"] == 0
        assert totals["kv_pages_exported"] >= 6
        assert d.batcher.counters.get("migrations_resumed") == 6
        assert gw.counters.get("generate_failures") in (None, 0)
        assert wait_until(lambda: len(gw.journal) == 0)
    finally:
        for r in (p, d):
            if r is not None:
                r.close()
        gw.stop()


@time_limit(120)
def test_fleet_migrate_moves_a_live_stream_and_keeps_its_tokens(export_dir):
    gw = _gateway()
    p = d = None
    try:
        p = FleetReplica(gw, export_dir, "--generate_slots", "2", *PAGED,
                         "--role", "prefill")
        d = FleetReplica(gw, export_dir, "--generate_slots", "4", *PAGED,
                         "--role", "decode")
        _joined(gw, [p, d])
        prompt = lm_mod.prompts(1, seed=83)[0]
        n = 100                      # a long stream: the migrate lands
        want = _direct(p, prompt, n)  # mid-decode
        box = {}
        first = threading.Event()

        def consume():
            events = []
            for ev in fleet_client.FleetClient(
                    "127.0.0.1", p.port, timeout=120).generate_stream(
                        prompt, max_new_tokens=n):
                events.append(ev)
                first.set()
            box["events"] = events

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        assert first.wait(60)
        status, out = fleet_client.FleetClient(
            *gw.http_addr).migrate(p.id, timeout_s=60)
        t.join(60)
        assert not t.is_alive()
        assert status == 200 and out["drained"] is True
        report = out["migration"]
        assert report["failed"] == 0, report
        assert report["sessions"] == 1
        assert report["migrated"] + report["completed_locally"] == 1
        events = box["events"]
        assert events[-1]["output"] == want
        assert prompt + [e["token"] for e in events if "token" in e] == want
        assert p.id not in gw.fleet_stats(probe=False)["replicas"]
        if report["migrated"]:
            assert d.batcher.counters.get("migrations_resumed") == 1
    finally:
        for r in (p, d):
            if r is not None:
                r.close()
        gw.stop()


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.headers.get("Content-Type"), resp.read()


@time_limit(120)
def test_stitched_timeline_and_metrics_through_the_gateway(export_dir):
    gw = _gateway()
    p = d = None
    try:
        p = FleetReplica(gw, export_dir, "--generate_slots", "2", *PAGED,
                         "--role", "prefill")
        d = FleetReplica(gw, export_dir, "--generate_slots", "4", *PAGED,
                         "--role", "decode")
        _joined(gw, [p, d])
        tid = "feedface" * 4
        prompt = lm_mod.prompts(1, seed=84)[0]
        req = urllib.request.Request(
            "http://%s:%d/v1/models/default:generate" % gw.http_addr,
            data=json.dumps({"inputs": [prompt], "max_new_tokens": 24,
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json",
                     "X-Trace-Id": tid})
        with urllib.request.urlopen(req, timeout=120) as r:
            events = [json.loads(line) for line in r]
        assert events[-1]["output"] == _direct(p, prompt, 24)
        _, raw = _get("http://%s:%d/v1/trace/%s" % (*gw.http_addr, tid))
        tl = json.loads(raw)
        assert set(tl["sources"]) == {"gateway", p.id, d.id}
        for stage in ("gateway.route", "gateway.relay", "submit", "prefill",
                      "migrate"):
            assert any(stage in s for s in tl["stages"]), (stage,
                                                          tl["stages"])
        ctype, raw = _get("http://%s:%d/metrics" % gw.http_addr)
        text = raw.decode()
        assert ctype.startswith("text/plain")
        for line in ("tfospark_gateway_registrations 2",
                     "tfospark_fleet_migrations_completed 1",
                     "tfospark_fleet_slots 6",
                     f'tfospark_replica_decode_steps{{replica="{d.id}"}}'):
            assert line in text, line
        stats = d.batcher.stats()
        _, raw = _get(d.url("/metrics"))
        for key, val in stats.items():
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                assert f"tfospark_replica_{key}" in raw.decode(), key
    finally:
        for r in (p, d):
            if r is not None:
                r.close()
        gw.stop()


@time_limit(120)
def test_fleet_totals_carry_the_replicas_per_class_windows(export_dir):
    gw = _gateway()
    r = None
    try:
        r = FleetReplica(gw, export_dir, "--generate_slots", "2", *PAGED,
                         "--generate_preempt_ms", "1")
        _joined(gw, [r])
        assert gw.fleet_stats(probe=False)["replicas"][r.id][
            "features"]["preempt_ms"] == 1.0
        _, _, pm = lm_mod.tiny_lm()
        bp = lm_mod.prompts(2, seed=85)
        c = fleet_client.FleetClient(*gw.http_addr, timeout=120)
        joins = []
        outs = {}

        def batch(i):
            outs[i] = _stream(c, bp[i], 48, priority="batch")[1]

        for i in range(2):
            t = threading.Thread(target=batch, args=(i,), daemon=True)
            t.start()
            joins.append(t)
        assert wait_until(lambda: sum(
            s is not None for s in list(r.batcher._slots)) == 2, timeout=60)
        ip = lm_mod.prompts(3, seed=86)
        inter = [c.generate([p], max_new_tokens=5)[1]["outputs"][0]
                 for p in ip]
        for t in joins:
            t.join(60)
            assert not t.is_alive()
        assert [outs[i] for i in range(2)] == [lm_mod.solo(pm, p, 48)
                                              for p in bp]
        assert inter == [lm_mod.solo(pm, p, 5) for p in ip]
        t = gw.fleet_stats()["totals"]
        st = r.batcher.stats()
        assert t["qdelay_interactive_count"] == st[
            "qdelay_interactive_count"] >= 3
        assert t["qdelay_batch_count"] == st["qdelay_batch_count"] >= 2
        assert t["ttft_interactive_count"] >= 3
        assert t["ttft_interactive_ms_sum"] > 0.0
        assert "qdelay_interactive_p95_ms" not in t
        assert t["sessions_parked"] == st["sessions_parked"] >= 1
        assert t["parked_sessions"] == 0
    finally:
        if r is not None:
            r.close()
        gw.stop()


def _affine_prompts(gw, replica, n, seed):
    """``n`` prompts whose prefix hashes to ``replica``."""
    with gw._lock:
        ids = list(gw._replicas)
    out, k = [], 0
    while len(out) < n:
        p = lm_mod.prompts(1, seed=seed + k)[0]
        k += 1
        key = gw.prefix_key({"inputs": [p]})
        if max(ids, key=lambda rid: fleet._hrw(rid, key)) == replica.id:
            out.append(p)
    return out


@time_limit(150)
def test_replica_killed_mid_stream_is_redriven_through_the_journal(
        export_dir):
    gw = _gateway()
    a = b = None
    try:
        a = FleetReplica(gw, export_dir, "--generate_slots", "4", *PAGED)
        b = FleetReplica(gw, export_dir, "--generate_slots", "4", *PAGED)
        _joined(gw, [a, b])
        prompts = _affine_prompts(gw, a, 3, seed=300)
        kws = [{}, {"temperature": TEMP, "seed": SEED}, {}]
        n = 60
        wants = [_direct(b, p, n, **kw) for p, kw in zip(prompts, kws)]
        c = fleet_client.FleetClient(*gw.http_addr, timeout=120)
        results = queue.Queue()

        def run(i):
            results.put((i, _stream(c, prompts[i], n, **kws[i])))

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        # every stream journaled a few tokens on A
        assert wait_until(lambda: len(gw.journal) == 3 and all(
            len(e["tokens"]) >= 3 for e in list(
                gw.journal._entries.values())), timeout=60)
        assert a.batcher.stats()["slots_busy"] == 3
        a.kill()
        got = {}
        for _ in threads:
            i, res = results.get(timeout=90)
            got[i] = res
        for i, want in enumerate(wants):
            toks, out, last = got[i]
            assert out == want, (i, last)
            assert prompts[i] + toks == want
        assert gw.counters.get("session_redrives") == 3
        assert gw.counters.get("sessions_recovered") == 3
        assert b.batcher.counters.get("replays_resumed") == 3
        assert b.batcher.counters.get("migrations_resumed") in (None, 0)
        # heartbeats stopped: ejected within the window
        assert wait_until(lambda: gw.counters.get("ejections") == 1,
                          timeout=20)
        assert gw.fleet_stats(probe=False)["replicas"][a.id][
            "state"] == fleet.EJECTED
        assert wait_until(lambda: len(gw.journal) == 0)
    finally:
        for r in (a, b):
            if r is not None:
                r.close()
        gw.stop()


@time_limit(90)
def test_replica_death_with_parked_sessions_redrives_via_the_journal():
    _, _, pm = lm_mod.tiny_lm()
    kw = dict(n_slots=2, read_chunk=1, prefill_chunk=8, kv_page_size=8,
              kv_pages=24)
    src = serve.ContinuousBatcher(pm, device="cpu", **kw)
    dst = serve.ContinuousBatcher(pm, device="cpu", **kw)
    journal = fleet.StreamJournal()
    prompt, n_new = [3, 1, 4, 1, 5], 6
    try:
        entry = journal.journal_open({"inputs": [prompt]})
        h = src.submit(prompt, n_new, priority="batch")
        emitted = list(h.tokens.get(timeout=300))
        parked = src._park_gather(h)         # the controller's move
        assert parked is not None
        src._park_pool.append(parked)
        while True:                          # tokens committed pre-park
            try:
                batch = h.tokens.get(timeout=0.2)
            except queue.Empty:
                break
            if batch is None:
                break
            emitted.extend(batch)
        for t in emitted:
            journal.record(entry, t)
        assert src.stats()["parked_sessions"] == 1
        src.stop()                           # the crash: sweep fails h
        with pytest.raises(RuntimeError):
            h.result(timeout=300)
        gw = fleet.Gateway()
        h2, installed = dst.submit_replay(gw._replay_meta(
            dict(entry["body"], max_new_tokens=n_new), entry["tokens"]))
        assert installed.wait(300), "replay install timed out"
        out = h2.result(timeout=300)
        assert out == lm_mod.solo(pm, prompt, n_new)
        assert out[:len(prompt) + len(emitted)] == prompt + emitted
        journal.journal_close(entry)
        assert len(journal) == 0
        s = dst.stats()
        assert s["kv_pages_used"] == s["prefix_pages_cached"]
        assert lm_mod.conserved(dst)
    finally:
        src.stop()
        dst.stop()


def _job_input(path, n, seed=90):
    with open(path, "w", encoding="utf-8") as f:
        for p in lm_mod.prompts(n, lo=3, hi=12, seed=seed):
            f.write(json.dumps(p) + "\n")
    return str(path)


def _job_expected(replica, path, n_partitions, template):
    """Direct scoring on one replica: the bytes a completed job merges."""
    recs = []
    for p, (s, e) in enumerate(jobs.split_file(path, n_partitions)):
        for off, _, text in jobs.iter_partition(path, s, e):
            body = jobs.record_request(text, template, "x")
            recs.append((p, off, body["inputs"][0]))
    outs = replica.generate({"inputs": [r[2] for r in recs],
                             **template})
    return "".join(json.dumps({"p": p, "offset": off, "outputs": [o]},
                              sort_keys=True) + "\n"
                   for (p, off, _), o in zip(recs, outs)).encode()


JOB_TEMPLATE = {"max_new_tokens": 6}


@time_limit(150)
def test_job_with_a_replica_killed_mid_partition_is_exactly_once(
        export_dir, tmp_path):
    path = _job_input(tmp_path / "in.jsonl", 48)
    gw = _gateway(jobs_dir=str(tmp_path / "jobs"), job_workers=3,
                  job_checkpoint_every=4)
    a = b = None
    try:
        a = FleetReplica(gw, export_dir, "--generate_slots", "4", *PAGED)
        b = FleetReplica(gw, export_dir, "--generate_slots", "4", *PAGED)
        _joined(gw, [a, b])
        want = _job_expected(b, path, 4, JOB_TEMPLATE)
        cli = fleet_client.FleetClient(*gw.http_addr)
        code, st = cli.submit_job(path, request=JOB_TEMPLATE, partitions=4,
                                  workers=3)
        assert code == 200, st
        assert st["records_total"] == 48
        assert wait_until(lambda: cli.job_status(st["id"])[1]
                          .get("records_done", 0) >= 8, timeout=60)
        a.kill()
        final = cli.wait_job(st["id"], timeout_s=100.0)
        assert final["state"] == "completed", final
        assert final["records_done"] == 48 and final["records_failed"] == 0
        with open(final["output"], "rb") as f:
            assert f.read() == want
        assert gw.counters.get("jobs_completed") == 1
        assert gw.fleet_stats()["totals"]["jobs_records_done"] == 48
    finally:
        for r in (a, b):
            if r is not None:
                r.close()
        gw.stop()


@time_limit(150)
def test_job_resumes_across_a_gateway_restart_exactly_once(export_dir,
                                                           tmp_path):
    path = _job_input(tmp_path / "in.jsonl", 48, seed=91)
    jobs_dir = str(tmp_path / "jobs")
    gw1 = _gateway(jobs_dir=jobs_dir, job_workers=2, job_checkpoint_every=4)
    gw2 = None
    rs = []
    try:
        rs = [FleetReplica(gw1, export_dir, "--generate_slots", "4", *PAGED)]
        _joined(gw1, rs)
        want = _job_expected(rs[0], path, 4, JOB_TEMPLATE)
        cli = fleet_client.FleetClient(*gw1.http_addr)
        code, st = cli.submit_job(path, request=JOB_TEMPLATE, partitions=4,
                                  workers=2)
        assert code == 200, st
        assert wait_until(lambda: cli.job_status(st["id"])[1]
                          .get("records_done", 0) >= 12, timeout=60)
        rs[0].close()
        gw1.stop()                      # mid-job death: NOT a cancel
        gw2 = fleet.Gateway(heartbeat_timeout_s=2.0, monitor_interval_s=0.05,
                            replica_timeout_s=120.0, jobs_dir=jobs_dir,
                            job_workers=2, job_checkpoint_every=4)
        # rescan runs inside start(), before the replica re-registers:
        # the resumed workers ride out the gap
        gw2.jobs.record_attempts = 20
        gw2.jobs.partition_attempts = 20
        gw2.start()
        rs.append(FleetReplica(gw2, export_dir, "--generate_slots", "4",
                               *PAGED))
        assert gw2.counters.get("jobs_resumed") == 1
        cli2 = fleet_client.FleetClient(*gw2.http_addr)
        final = cli2.wait_job(st["id"], timeout_s=100.0)
        assert final["state"] == "completed", final
        assert final["records_done"] == 48 and final["records_failed"] == 0
        with open(final["output"], "rb") as f:
            assert f.read() == want
        assert gw2.counters.get("jobs_completed") == 1
    finally:
        for r in rs:
            r.close()
        for gw in (gw1, gw2):
            if gw is not None:
                gw.stop()


def _read_line(proc, pattern, timeout):
    """The first stdout line of ``proc`` holding ``pattern``."""
    box = queue.Queue()

    def read():
        for line in proc.stdout:
            if pattern in line:
                box.put(line)
                return

    threading.Thread(target=read, daemon=True).start()
    return box.get(timeout=timeout)


@time_limit(120)
def test_the_cli_replica_registers_with_the_cli_gateway(export_dir):
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = []
    try:
        gw = subprocess.Popen(
            [sys.executable, "-m", "tensorflowonspark_tpu_torch.fleet",
             "--port", "0", "--registry_port", "0",
             "--heartbeat_timeout_s", "2"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, text=True)
        procs.append(gw)
        line = _read_line(gw, "fleet gateway on", 60)
        http = line.split("http://")[1].split(" ")[0]
        registry = line.rsplit("at ", 1)[1].strip().rstrip(")")
        ghost, gport = http.rsplit(":", 1)
        rep = subprocess.Popen(
            [sys.executable, "-m", "tensorflowonspark_tpu_torch.serve",
             "--export_dir", export_dir, "--device", "cpu", "--port", "0",
             *PAGED, "--fleet", registry, "--fleet_heartbeat_s", "0.2"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, text=True)
        procs.append(rep)
        rport = _read_line(rep, "serving on", 60).split(":")[2].split(" ")[0]
        c = fleet_client.FleetClient(ghost, int(gport), timeout=60)
        assert c.wait_ready(timeout_s=30)
        _, body = c.fleet_stats(probe=False)
        rid = f"127.0.0.1:{rport}"
        assert list(body["replicas"]) == [rid]
        assert body["replicas"][rid]["features"]["kv_page_size"] == 8
        prompt = lm_mod.prompts(1, seed=87)[0]
        status, out = c.generate([prompt], max_new_tokens=8)
        assert status == 200
        _, _, pm = lm_mod.tiny_lm()
        assert out["outputs"][0] == lm_mod.solo(pm, prompt, 8)
        rep.send_signal(signal.SIGINT)       # main() says BYE on its way
        assert rep.wait(timeout=30) == 0
        assert wait_until(lambda: not c.fleet_stats(probe=False)[1][
            "replicas"], timeout=10)
        assert c.fleet_stats(probe=False)[1]["counters"][
            "deregistrations"] == 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
                try:
                    p.wait(timeout=20)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=20)
            p.stdout.close()
