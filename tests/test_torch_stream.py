"""The port's server on the JAX server's default command line, and
``"stream": true`` NDJSON over HTTP.

A tiny f32 LM initialised by the JAX package from a seed is exported by
the port (``convert.params_from_jax``).  Tolerance: greedy f32 tokens
equal exactly.

- The JAX server's default argv (no engine, paging or pipeline flag)
  serves: the async engine over the dense slot cache, outputs equal to
  JAX ``decode.generate``.
- A stream request: ``application/x-ndjson`` in chunked framing,
  ``{"token": t}`` events then ``{"done": true, "output": [...]}`` (the
  JAX server's keys); ``prompt + tokens`` equals the done event's output
  and the non-stream ``outputs[0]``.  A malformed stream request (two
  prompts, a bad ``max_new_tokens``) gets 400 before any body.
- The flags and fields this slice ports no longer raise; those of A7
  still raise (HTTP 501) naming their ROADMAP item (A6's fields serve:
  ``tests/test_torch_sampling_controls.py``,
  ``tests/test_torch_lora_serving.py``).
"""
import http.client
import json
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu.models import decode as jax_decode
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import convert, export, serve

CFG = dict(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=128, max_seq_len=128, dtype="float32", rope=True,
           norm_type="rmsnorm")
_rs = np.random.RandomState(21)
PROMPTS = [_rs.randint(0, 64, n).tolist() for n in (7, 23)]
MAX_NEW = 6


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**CFG))
    params = jm.init(jax.random.key(4), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    want = [np.asarray(jax_decode.generate(
        jm, params, np.array([p], np.int32), max_new_tokens=MAX_NEW,
        temperature=0.0, loop="host"))[0].tolist() for p in PROMPTS]
    d = str(tmp_path_factory.mktemp("export"))
    export.export_saved_model(d, convert.params_from_jax(params),
                              builder_kwargs=CFG)
    return d, want


def _serve(argv):
    server, service = serve.make_server(
        serve.build_argparser().parse_args(argv))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, service, thread


def _close(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=60)
    assert not thread.is_alive()


def _post(port, payload, path="/v1/models/default:generate"):
    """(status, headers, body bytes) of one POST."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _get(port, path="/v1/models/default"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def test_default_argv_serves_async_over_the_dense_cache(exported):
    d, want = exported
    server, service, thread = _serve(["--export_dir", d, "--port", "0",
                                      "--device", "cpu"])
    port = server.server_address[1]
    try:
        status, _, body = _post(port, {"inputs": PROMPTS,
                                       "max_new_tokens": MAX_NEW})
        assert status == 200 and json.loads(body)["outputs"] == want
        stats = _get(port)["model"]["generate_stats"]
        assert stats["engine"] == "async" and stats["pipeline_depth"] == 2
        assert "kv_page_size" not in stats          # the dense slot cache
        assert stats["requests_served"] == len(PROMPTS)
    finally:
        _close(server, thread)


@pytest.mark.parametrize("paged", [False, True])
def test_stream_equals_the_non_stream_output(exported, paged):
    d, want = exported
    argv = ["--export_dir", d, "--port", "0", "--device", "cpu",
            "--generate_read_chunk", "2"]
    if paged:
        argv += ["--generate_kv_page_size", "8", "--generate_kv_pages", "32",
                 "--generate_engine", "serial"]
    server, service, thread = _serve(argv)
    port = server.server_address[1]
    try:
        for p, w in zip(PROMPTS, want):
            status, headers, body = _post(port, {
                "inputs": [p], "max_new_tokens": MAX_NEW, "stream": True})
            assert status == 200
            assert headers["Content-Type"] == "application/x-ndjson"
            assert headers["Transfer-Encoding"] == "chunked"
            events = [json.loads(line) for line in body.splitlines()]
            toks = [e["token"] for e in events[:-1]]
            assert all(set(e) == {"token"} for e in events[:-1])
            assert events[-1] == {"done": True, "output": w}
            assert p + toks == w
            status, _, body = _post(port, {"inputs": [p],
                                           "max_new_tokens": MAX_NEW})
            assert json.loads(body)["outputs"][0] == w
    finally:
        _close(server, thread)


def test_malformed_stream_gets_400_before_any_body(exported):
    d, _ = exported
    server, service, thread = _serve(["--export_dir", d, "--port", "0",
                                      "--device", "cpu"])
    port = server.server_address[1]
    try:
        for bad in ({"inputs": PROMPTS, "stream": True},
                    {"inputs": [PROMPTS[0]], "stream": True,
                     "max_new_tokens": 0}):
            status, headers, body = _post(port, bad)
            assert status == 400
            assert headers["Content-Type"] == "application/json"
            assert "error" in json.loads(body)
        # the server goes on streaming
        status, _, body = _post(port, {"inputs": [PROMPTS[0]],
                                       "max_new_tokens": 2, "stream": True})
        assert status == 200 and json.loads(body.splitlines()[-1])["done"]
    finally:
        _close(server, thread)


@pytest.mark.parametrize("flags", [
    ["--generate_engine", "serial"], ["--generate_pipeline_depth", "3"],
    ["--generate_kv_page_size", "8", "--generate_kv_pages", "32",
     "--generate_long_prompt_threshold", "16"]])
def test_ported_flags_serve(exported, flags):
    d, want = exported
    server, service, thread = _serve(["--export_dir", d, "--port", "0",
                                      "--device", "cpu", *flags])
    port = server.server_address[1]
    try:
        status, _, body = _post(port, {"inputs": PROMPTS,
                                       "max_new_tokens": MAX_NEW})
        assert status == 200 and json.loads(body)["outputs"] == want
        stats = _get(port)["model"]["generate_stats"]
        if "--generate_long_prompt_threshold" in flags:
            assert stats["long_prompt_threshold"] == 16
            assert stats["long_chunks_dispatched"] >= 1   # PROMPTS[1]: 23
    finally:
        _close(server, thread)


@pytest.mark.parametrize("field,value,bad", [
    ("priority", "batch", "urgent"),
    ("trace", "abc", "not a hex id")])
def test_a6_and_a7_fields_still_raise(exported, field, value, bad):
    # the A7 fields are ported: a valid value serves the plain tokens (a
    # trace adds its summary to the last stream event), a malformed one
    # is a 400, never ignored
    d, want = exported
    server, service, thread = _serve(["--export_dir", d, "--port", "0",
                                      "--device", "cpu"])
    port = server.server_address[1]
    try:
        for stream in (False, True):
            status, _, body = _post(port, {"inputs": [PROMPTS[0]],
                                           "max_new_tokens": MAX_NEW,
                                           field: value, "stream": stream})
            assert status == 200
            if stream:
                events = [json.loads(line) for line in body.splitlines()]
                assert events[-1]["output"] == want[0]
                assert ("trace" in events[-1]) == (field == "trace")
            else:
                assert json.loads(body)["outputs"] == [want[0]]
            status, _, body = _post(port, {"inputs": [PROMPTS[0]],
                                           field: bad, "stream": stream})
            assert status == 400
    finally:
        _close(server, thread)
