"""The port's bulk jobs (``tensorflowonspark_tpu_torch.jobs``) on the CPU,
model-free.

- On the same files, the splits, the records of each split and their
  count equal the JAX module's (jsonl with ragged and blank lines, an
  oversized record, TFRecord frames, an empty file), and so do the
  requests and seeds built from records.
- The JAX package's split, record and local-dispatch manager tests
  (``tests/test_jobs.py``) run against the port's module: exactly-once
  output under duplicate dispatch and across a manager restart, bad
  records, undeliverable partitions, submit validation, the checkpoint
  fault's bounded retry.
- A terminal state and its counter are published together: over 30
  undeliverable jobs, ``jobs_failed`` is 1 whenever ``status()`` reads
  ``failed``, and over 30 good ones ``jobs_completed`` is 1 and
  ``output.jsonl`` exists whenever it reads ``completed`` (the JAX
  module bumps the counter after it publishes the state).
Tolerance: exact.
"""
import json
import os
import sys
import threading
import time

import pytest

from tensorflowonspark_tpu import jobs as jax_jobs
from tensorflowonspark_tpu_torch import faults, jobs, tfrecord


def _wait_until(pred, timeout=5.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def score(prompt):
    """The deterministic 'model': outputs are a pure function of the
    prompt, so solo and fleet runs are byte-comparable."""
    return [t * 2 + 1 for t in prompt]


def local_dispatch(calls=None, fail=None):
    """A JobManager ``dispatch`` callable scoring records in-process.
    ``calls`` (a list) records every ``(key, body)``; ``fail(key, n)``
    may raise to simulate dispatch failures (n = times this key was
    attempted so far, 1-based)."""
    seen = {}
    lock = threading.Lock()

    def dispatch(body, key):
        with lock:
            n = seen[key] = seen.get(key, 0) + 1
            if calls is not None:
                calls.append((key, body))
        if fail is not None:
            fail(key, n)
        return {"outputs": [score(p) for p in body["inputs"]]}

    return dispatch


def write_jsonl(path, prompts, raw_lines=None):
    """One token-id-list record per line (plus optional raw lines)."""
    with open(path, "w", encoding="utf-8") as f:
        for p in prompts:
            f.write(json.dumps(p) + "\n")
        for line in raw_lines or []:
            f.write(line + "\n")
    return str(path)


def expected_output(path, n_partitions, fmt="jsonl"):
    """Solo sequential scoring of `path`, producing exactly the bytes a
    completed fleet job must merge (same splits, same line shape)."""
    splits = jobs.split_file(path, n_partitions, fmt=fmt)
    lines = []
    for p, (s, e) in enumerate(splits):
        for off, _nxt, text in jobs.iter_partition(path, s, e, fmt=fmt):
            obj = {"p": p, "offset": off}
            try:
                body = jobs.record_request(text, {}, f"x/{p}/{off}")
            except ValueError as err:
                obj["error"] = str(err)
            else:
                obj["outputs"] = [score(pr) for pr in body["inputs"]]
            lines.append(json.dumps(obj, sort_keys=True) + "\n")
    return "".join(lines).encode()


# ---------------------------------------------------------------------------
# partition splitting


def test_split_covers_every_record_exactly_once(tmp_path):
    # ragged line lengths so split boundaries land mid-record
    prompts = [[i] * (1 + (i * 7) % 13) for i in range(41)]
    path = write_jsonl(tmp_path / "in.jsonl", prompts)
    size = os.path.getsize(path)
    for n in (1, 2, 3, 5, 9, 64):
        splits = jobs.split_file(path, n)
        assert splits[0][0] == 0 and splits[-1][1] == size
        for (a, b), (c, d) in zip(splits, splits[1:]):
            assert b == c and a < b          # contiguous, non-empty
        seen = []
        for s, e in splits:
            for off, nxt, text in jobs.iter_partition(path, s, e):
                assert s <= off < e          # ownership: first byte in split
                assert off < nxt
                seen.append((off, json.loads(text)))
        assert [p for _, p in sorted(seen)] == prompts
        assert len(seen) == len(set(o for o, _ in seen))


def test_split_empty_file(tmp_path):
    path = write_jsonl(tmp_path / "empty.jsonl", [])
    assert jobs.split_file(path, 8) == [(0, 0)]
    assert jobs.count_records(path, [(0, 0)]) == 0


def test_split_more_partitions_than_records(tmp_path):
    path = write_jsonl(tmp_path / "tiny.jsonl", [[1], [2]])
    splits = jobs.split_file(path, 50)
    # some partitions own zero records (their range starts mid-record);
    # the union must still be every record exactly once
    total = sum(1 for s, e in splits
                for _ in jobs.iter_partition(path, s, e))
    assert total == 2
    assert jobs.count_records(path, splits) == 2


def test_blank_lines_are_not_records(tmp_path):
    path = write_jsonl(tmp_path / "in.jsonl", [[1], [2]],
                       raw_lines=["", "   ", json.dumps([3])])
    splits = jobs.split_file(path, 2)
    assert jobs.count_records(path, splits) == 3


def test_oversized_record_yields_error_marker(tmp_path):
    path = write_jsonl(tmp_path / "in.jsonl", [[1], [9] * 400, [2]])
    recs = list(jobs.iter_partition(path, 0, os.path.getsize(path),
                                    max_record_bytes=64))
    assert len(recs) == 3
    assert recs[1][2] is None                # oversized -> no text
    assert json.loads(recs[0][2]) == [1]     # neighbours intact
    assert json.loads(recs[2][2]) == [2]


def test_tfrecord_split_snaps_to_frames(tmp_path):
    path = str(tmp_path / "in.tfrecord")
    payloads = [json.dumps([i, i + 1]).encode() for i in range(17)]
    w = tfrecord.TFRecordWriter(path, index=True)
    for pl in payloads:
        w.write(pl)
    w.close()
    splits = jobs.split_file(path, 4, fmt="tfrecord")
    assert splits[0][0] == 0
    assert splits[-1][1] == os.path.getsize(path)
    got = [text for s, e in splits
           for _, _, text in jobs.iter_partition(path, s, e,
                                                 fmt="tfrecord")]
    assert got == [pl.decode() for pl in payloads]


# ---------------------------------------------------------------------------
# record -> request


def test_record_request_forms():
    tmpl = {"max_new_tokens": 4, "temperature": 0.0}
    # bare list sugar
    req = jobs.record_request("[1, 2, 3]", tmpl, "j/0/0")
    assert req["inputs"] == [[1, 2, 3]]
    assert req["max_new_tokens"] == 4
    assert req["priority"] == "batch"
    # object merged OVER the template; record fields win; stream dropped
    req = jobs.record_request(
        json.dumps({"inputs": [[7]], "max_new_tokens": 9, "stream": True}),
        tmpl, "j/0/0")
    assert req["max_new_tokens"] == 9
    assert "stream" not in req
    # sampled + unseeded -> pinned per-record seed, stable across calls
    req1 = jobs.record_request("[5]", {"temperature": 0.8}, "j/1/10")
    req2 = jobs.record_request("[5]", {"temperature": 0.8}, "j/1/10")
    assert req1["seed"] == req2["seed"] == jobs.record_seed("j/1/10")
    assert jobs.record_request("[5]", {"temperature": 0.8},
                               "j/1/11")["seed"] != req1["seed"]
    # explicit seed is respected
    assert jobs.record_request(json.dumps({"inputs": [[5]], "seed": 3}),
                               {"temperature": 0.8}, "j/0/0")["seed"] == 3
    with pytest.raises(ValueError):
        jobs.record_request("not json", tmpl, "k")
    with pytest.raises(ValueError):
        jobs.record_request("{}", {}, "k")     # no inputs anywhere
    with pytest.raises(ValueError):
        jobs.record_request('"scalar"', tmpl, "k")


# ---------------------------------------------------------------------------
# manager: local dispatch


def _manager(tmp_path, **kw):
    kw.setdefault("checkpoint_every", 4)
    kw.setdefault("default_workers", 3)
    return jobs.JobManager(str(tmp_path / "jobs"), **kw)


def test_local_job_completes_exactly_once(tmp_path):
    prompts = [[i, i + 1] for i in range(23)]
    path = write_jsonl(tmp_path / "in.jsonl", prompts)
    calls = []
    mgr = _manager(tmp_path, dispatch=local_dispatch(calls))
    st = mgr.submit({"input": path, "partitions": 4, "workers": 3})
    assert st["state"] == "running" and st["records_total"] == 23
    assert _wait_until(
        lambda: mgr.status(st["id"])["state"] != "running", timeout=20)
    final = mgr.status(st["id"])
    assert final["state"] == "completed"
    assert final["records_done"] == 23 and final["records_failed"] == 0
    assert final["partitions_done"] == final["partitions"]
    assert final["output"] and os.path.isfile(final["output"])
    with open(final["output"], "rb") as f:
        assert f.read() == expected_output(path, 4)
    # every record dispatched exactly once, keyed job/p/offset
    keys = [k for k, _ in calls]
    assert len(keys) == 23 and len(set(keys)) == 23
    assert all(k.startswith(st["id"] + "/") for k in keys)
    # every dispatch went out batch-class
    assert all(b["priority"] == "batch" for _, b in calls)
    assert mgr.stats() == {"jobs_active": 0, "jobs_records_done": 23,
                           "jobs_records_failed": 0}
    mgr.stop()


def test_empty_input_completes_with_empty_output(tmp_path):
    path = write_jsonl(tmp_path / "empty.jsonl", [])
    mgr = _manager(tmp_path, dispatch=local_dispatch())
    st = mgr.submit({"input": path})
    assert _wait_until(
        lambda: mgr.status(st["id"])["state"] == "completed", timeout=10)
    with open(mgr.status(st["id"])["output"], "rb") as f:
        assert f.read() == b""
    mgr.stop()


def test_bad_record_fails_record_not_job(tmp_path):
    path = write_jsonl(tmp_path / "in.jsonl", [[1]],
                       raw_lines=["this is not json", json.dumps([2])])
    mgr = _manager(tmp_path, dispatch=local_dispatch())
    st = mgr.submit({"input": path, "partitions": 1})
    assert _wait_until(
        lambda: mgr.status(st["id"])["state"] == "completed", timeout=10)
    final = mgr.status(st["id"])
    assert final["records_done"] == 2 and final["records_failed"] == 1
    with open(final["output"], encoding="utf-8") as f:
        lines = [json.loads(ln) for ln in f]
    assert len(lines) == 3                    # output stays 1:1 with input
    assert "error" in lines[1] and "outputs" not in lines[1]
    assert lines[0]["outputs"] == [score([1])]
    assert lines[2]["outputs"] == [score([2])]
    mgr.stop()


def test_exactly_once_under_duplicate_dispatch(tmp_path):
    """The lost-reply case: the dispatch reaches the 'replica' (the call
    is recorded) but the attempt fails, so the runner re-sends.  The
    retry must carry the SAME Idempotency-Key and the output must hold
    exactly one line per record."""
    prompts = [[i] for i in range(12)]
    path = write_jsonl(tmp_path / "in.jsonl", prompts)
    calls = []

    def fail(key, n):
        if n == 1 and int(key.rsplit("/", 1)[1]) % 3 == 0:
            raise OSError("reply lost after side effect")

    mgr = _manager(tmp_path, dispatch=local_dispatch(calls, fail=fail))
    st = mgr.submit({"input": path, "partitions": 2, "workers": 2})
    assert _wait_until(
        lambda: mgr.status(st["id"])["state"] == "completed", timeout=20)
    keys = [k for k, _ in calls]
    assert len(keys) > len(set(keys))         # duplicates really happened
    with open(mgr.status(st["id"])["output"], "rb") as f:
        data = f.read()
    assert data == expected_output(path, 2)   # ...but output is once-each
    assert mgr.counters.get("jobs_record_retries") > 0
    mgr.stop()


def test_checkpoint_resume_survives_manager_restart(tmp_path):
    """Stop the manager mid-job (the gateway-crash path: durable state
    stays 'running'), rescan with a fresh manager, and the job completes
    with exactly-once output."""
    prompts = [[i] for i in range(40)]
    path = write_jsonl(tmp_path / "in.jsonl", prompts)
    gate = threading.Event()
    n_done = [0]

    def slow_fail(key, n):
        n_done[0] += 1
        if n_done[0] > 12 and not gate.is_set():
            gate.wait(5.0)                    # stall mid-job until stop

    mgr = _manager(tmp_path, checkpoint_every=3,
                   dispatch=local_dispatch(fail=slow_fail))
    st = mgr.submit({"input": path, "partitions": 4, "workers": 2})
    assert _wait_until(lambda: n_done[0] > 12, timeout=10)
    mgr._stop.set()                           # begin shutdown...
    gate.set()                                # ...release stalled workers
    mgr.stop(timeout_s=10)
    assert mgr.status(st["id"])["state"] == "running"   # NOT terminal

    mgr2 = _manager(tmp_path, dispatch=local_dispatch())
    assert mgr2.rescan() == [st["id"]]
    assert mgr2.counters.get("jobs_resumed") == 1
    assert _wait_until(
        lambda: mgr2.status(st["id"])["state"] == "completed", timeout=20)
    with open(mgr2.status(st["id"])["output"], "rb") as f:
        data = f.read()
    assert data == expected_output(path, 4)
    # terminal state is durable: a third rescan resumes nothing
    mgr3 = _manager(tmp_path, dispatch=local_dispatch())
    assert mgr3.rescan() == []
    assert mgr3.status(st["id"])["state"] == "completed"
    mgr2.stop()
    mgr3.stop()


def test_undeliverable_partition_fails_job(tmp_path):
    path = write_jsonl(tmp_path / "in.jsonl", [[1], [2]])

    def fail(key, n):
        raise OSError("fleet is a smoking crater")

    mgr = _manager(tmp_path, dispatch=local_dispatch(fail=fail),
                   record_attempts=2, partition_attempts=2)
    st = mgr.submit({"input": path, "partitions": 1})
    assert _wait_until(
        lambda: mgr.status(st["id"])["state"] == "failed", timeout=20)
    final = mgr.status(st["id"])
    assert "partition 0" in final["error"]
    assert final["output"] is None
    assert mgr.counters.get("jobs_failed") == 1
    assert mgr.stats()["jobs_active"] == 0
    mgr.stop()


def test_submit_validation(tmp_path):
    mgr = jobs.JobManager(str(tmp_path / "jobs"),
                          dispatch=local_dispatch())
    with pytest.raises(ValueError):
        mgr.submit({"input": str(tmp_path / "nope.jsonl")})
    with pytest.raises(ValueError):
        mgr.submit([])
    path = write_jsonl(tmp_path / "in.jsonl", [[1]])
    with pytest.raises(ValueError):
        mgr.submit({"input": path, "format": "parquet"})
    with pytest.raises(ValueError):
        mgr.submit({"input": path, "request": "template"})
    with pytest.raises(ValueError):
        mgr.submit({"input": path, "partitions": 0})
    mgr.stop()


def test_checkpoint_write_fault_is_absorbed_by_retry(tmp_path):
    """A transient checkpoint-write fault must be retried, not fail the
    job; with the bounded retry exhausted the partition abandons and the
    job is NOT marked completed."""
    path = write_jsonl(tmp_path / "in.jsonl", [[i] for i in range(6)])
    plan = faults.FaultPlan(seed=7).on("jobs.checkpoint_write", "oserror",
                                       nth=1, times=2)
    mgr = _manager(tmp_path, dispatch=local_dispatch(),
                   checkpoint_every=2)
    with faults.active(plan):
        st = mgr.submit({"input": path, "partitions": 1})
        assert _wait_until(
            lambda: mgr.status(st["id"])["state"] == "completed",
            timeout=20)
    assert mgr.counters.get("jobs_ckpt_retries") == 2
    assert len(plan.fired) == 2
    mgr.stop()




def test_job_fault_sites_registered():
    for site in ("jobs.partition_read", "jobs.record_dispatch",
                 "jobs.checkpoint_write"):
        assert site in faults.SITES


# ---------------------------------------------------------------------------
# held to the JAX module on the same files


def _ragged(tmp_path):
    prompts = [[i] * (1 + (i * 7) % 13) for i in range(41)]
    return write_jsonl(tmp_path / "ragged.jsonl", prompts), "jsonl", {}


def _blank(tmp_path):
    return write_jsonl(tmp_path / "blank.jsonl", [[1], [2]],
                       raw_lines=["", "   ", json.dumps([3]), "",
                                  json.dumps({"inputs": [[4, 5]]})]), \
        "jsonl", {}


def _oversized(tmp_path):
    return write_jsonl(tmp_path / "big.jsonl",
                       [[1], [9] * 400, [2], [8] * 90, [3]]), "jsonl", \
        {"max_record_bytes": 64}


def _frames(tmp_path):
    path = str(tmp_path / "in.tfrecord")
    w = tfrecord.TFRecordWriter(path, index=True)
    for i in range(17):
        w.write(json.dumps([i, i + 1] * (1 + i % 5)).encode())
    w.close()
    return path, "tfrecord", {}


def _empty(tmp_path):
    return write_jsonl(tmp_path / "empty.jsonl", []), "jsonl", {}


@pytest.mark.parametrize("make", [_ragged, _blank, _oversized, _frames,
                                  _empty])
def test_splits_and_records_match_jax(tmp_path, make):
    path, fmt, kw = make(tmp_path)
    for n in (1, 2, 3, 5, 9, 64):
        splits = jobs.split_file(path, n, fmt=fmt)
        assert splits == jax_jobs.split_file(path, n, fmt=fmt)
        assert (jobs.count_records(path, splits, fmt=fmt)
                == jax_jobs.count_records(path, splits, fmt=fmt))
        for s, e in splits:
            got = list(jobs.iter_partition(path, s, e, fmt=fmt, **kw))
            assert got == list(jax_jobs.iter_partition(path, s, e,
                                                       fmt=fmt, **kw))


def test_record_requests_and_seeds_match_jax():
    keys = [f"job{j}/{p}/{off}" for j in range(3) for p in range(4)
            for off in (0, 17, 4096)]
    for key in keys:
        assert jobs.record_seed(key) == jax_jobs.record_seed(key)
    records = ["[1, 2, 3]", json.dumps({"inputs": [[7]], "stream": True}),
               json.dumps({"inputs": [[5]], "seed": 3}),
               json.dumps({"inputs": [[5]], "temperature": 0.0}),
               "not json", "{}", '"scalar"', "[]",
               json.dumps({"inputs": [[1, 2]], "priority": "interactive"})]
    templates = [{}, {"max_new_tokens": 4, "temperature": 0.0},
                 {"temperature": 0.8}, {"inputs": [[9, 9]]}]
    for text in records:
        for tmpl in templates:
            for key in keys[:4]:
                try:
                    want = jax_jobs.record_request(text, tmpl, key)
                except ValueError as e:
                    with pytest.raises(ValueError, match=str(e)[:12]):
                        jobs.record_request(text, tmpl, key)
                else:
                    assert jobs.record_request(text, tmpl, key) == want


# ---------------------------------------------------------------------------
# a terminal state and its counter, published together


def _poll_terminal(mgr, job_id, seen, timeout=20.0):
    """Poll ``status()`` as fast as it answers until the state is
    terminal; at each read, record (state, the matching counter and
    whether the output file exists) read AFTER the state."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = mgr.status(job_id)
        if st["state"] in jobs.TERMINAL_STATES:
            seen.append((st["state"],
                         mgr.counters.get(f"jobs_{st['state']}"),
                         bool(st["output"]) and os.path.isfile(
                             st["output"])))
            return st
    raise AssertionError(f"job {job_id} never left running")


def test_failed_state_and_jobs_failed_published_together(tmp_path):
    path = write_jsonl(tmp_path / "in.jsonl", [[1]])

    def fail(key, n):
        raise OSError("no replica took the record")

    seen = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)          # more interleavings a poll
    try:
        for rep in range(30):
            mgr = jobs.JobManager(str(tmp_path / f"jobs{rep}"),
                                  dispatch=local_dispatch(fail=fail),
                                  record_attempts=1, partition_attempts=1)
            st = mgr.submit({"input": path, "partitions": 1})
            _poll_terminal(mgr, st["id"], seen)
            mgr.stop()
    finally:
        sys.setswitchinterval(interval)
    assert len(seen) == 30
    assert all(state == "failed" for state, _, _ in seen)
    assert [n for _, n, _ in seen] == [1] * 30


def test_completed_state_count_and_output_published_together(tmp_path):
    path = write_jsonl(tmp_path / "in.jsonl", [[i] for i in range(6)])
    seen = []
    for rep in range(30):
        mgr = jobs.JobManager(str(tmp_path / f"jobs{rep}"),
                              dispatch=local_dispatch(),
                              default_workers=2)
        st = mgr.submit({"input": path, "partitions": 2})
        _poll_terminal(mgr, st["id"], seen)
        mgr.stop()
    assert seen == [("completed", 1, True)] * 30
