"""The port's serving path on the CPU, against the JAX package.

A tiny f32 LM is initialised by the JAX package from a seed and carried
to the port by ``convert.params_from_jax``.  Greedy outputs of the
port's ContinuousBatcher (a concurrent 3-request burst, one prompt
longer than a prefill chunk) and of its HTTP ``:generate`` endpoint must
equal JAX ``decode.generate`` token for token.  A seeded sampled request
must reproduce itself (and the port's solo ``generate``); the quiesced
pool must conserve its pages.  Served with ``--generate_quantize int8``
or ``int4``, the greedy outputs equal JAX ``decode.generate`` over the
JAX package's ``quantize_tree`` of the same weights.  A prompt with a
token id past the vocabulary gets HTTP 400 (the batcher refuses it too),
and the next request is served.
"""
import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu.models import decode as jax_decode
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import convert, export, serve
from tensorflowonspark_tpu_torch.models import decode as port_decode
from tensorflowonspark_tpu_torch.models import transformer as port_tf

CFG = dict(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=128, max_seq_len=64, dtype="float32", rope=True,
           norm_type="rmsnorm")
PROMPTS = [[5, 9, 2, 40, 7], list(range(3, 22)), [11, 3, 60, 8, 1, 2, 9]]
MAX_NEW = 6


@pytest.fixture(scope="module")
def lm():
    """(port model, JAX greedy reference outputs for PROMPTS)."""
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**CFG))
    params = jm.init(jax.random.key(7), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    pm = port_tf.build_transformer(**CFG)
    pm.load_state_dict(convert.params_from_jax(params), strict=True)
    pm.eval()
    want = [np.asarray(jax_decode.generate(
        jm, params, np.array([p], np.int32), max_new_tokens=MAX_NEW,
        temperature=0.0, loop="host"))[0].tolist() for p in PROMPTS]
    return pm, want


@pytest.fixture(scope="module")
def batcher(lm):
    b = serve.ContinuousBatcher(lm[0], n_slots=4, read_chunk=3,
                                prefill_chunk=8, prefill_rows=2,
                                kv_page_size=8, kv_pages=20, device="cpu")
    yield b
    b.stop()


def test_concurrent_greedy_burst_matches_jax_generate(lm, batcher):
    pm, want = lm
    handles = [batcher.submit(p, MAX_NEW) for p in PROMPTS]
    outs = [h.result(timeout=120) for h in handles]
    assert outs == want
    stats = batcher.stats()
    assert stats["requests_served"] >= 3
    assert stats["prefill_dispatches"] >= 3   # PROMPTS[1] spans 3 chunks


def test_solo_generate_matches_jax_generate(lm):
    pm, want = lm
    got = port_decode.generate(pm, [PROMPTS[0]], MAX_NEW, device="cpu")
    assert got.tolist() == [want[0]]


def test_seeded_sampled_request_reproduces(lm, batcher):
    kw = dict(temperature=0.8, seed=11, top_k=20, top_p=0.9)
    first = batcher.submit(PROMPTS[2], MAX_NEW, **kw).result(timeout=120)
    # again, now riding a batch with a greedy neighbour
    again = batcher.submit(PROMPTS[2], MAX_NEW, **kw)
    other = batcher.submit(PROMPTS[0], MAX_NEW)
    assert again.result(timeout=120) == first
    assert other.result(timeout=120) == lm[1][0]
    solo = port_decode.generate(lm[0], [PROMPTS[2]], MAX_NEW, device="cpu",
                                **kw)
    assert solo.tolist() == [first]


def test_quiesced_pool_conserves_pages(batcher):
    handles = [batcher.submit(p, MAX_NEW) for p in PROMPTS]
    for h in handles:
        h.result(timeout=120)
    free = list(batcher._free_pages)
    assert len(set(free)) == len(free)             # no duplicates
    assert batcher._sink not in free
    owned = [p for pages in batcher._row_pages if pages for p in pages]
    assert sorted(free + owned) == list(range(batcher._total_pages))
    assert batcher.stats()["kv_pages_used"] == 0


def test_http_generate_roundtrip(lm, tmp_path):
    pm, want = lm
    export.export_saved_model(str(tmp_path), pm.state_dict(),
                              builder_kwargs=CFG)
    args = serve.build_argparser().parse_args([
        "--export_dir", str(tmp_path), "--port", "0", "--device", "cpu",
        "--generate_kv_page_size", "8", "--generate_kv_pages", "24",
        "--generate_prefill_chunk", "8", "--generate_slots", "4"])
    server, service = serve.make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}/v1/models/default"
    try:
        body = json.dumps({"inputs": PROMPTS, "max_new_tokens": MAX_NEW,
                           "temperature": 0.0}).encode()
        req = urllib.request.Request(base + ":generate", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert json.loads(resp.read())["outputs"] == want
        with urllib.request.urlopen(base, timeout=30) as resp:
            meta = json.loads(resp.read())["model"]
        assert meta["generate_stats"]["requests_served"] == 3
        assert set(meta["kernel_launches"]) == {
            "paged_attention", "page_write", "prefill_read"}
        bad = urllib.request.Request(
            base + ":generate", data=json.dumps(
                {"inputs": [[1, 2]], "stream": True}).encode())
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=30)
        assert err.value.code == 501        # not ported: never ignored
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_out_of_vocab_prompt_gets_400_and_serving_goes_on(lm, tmp_path):
    pm, want = lm
    export.export_saved_model(str(tmp_path), pm.state_dict(),
                              builder_kwargs=CFG)
    args = serve.build_argparser().parse_args([
        "--export_dir", str(tmp_path), "--port", "0", "--device", "cpu",
        "--generate_kv_page_size", "8", "--generate_kv_pages", "24"])
    server, service = serve.make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{server.server_address[1]}"
           "/v1/models/default:generate")

    def post(prompt):
        return urllib.request.urlopen(urllib.request.Request(
            url, data=json.dumps({"inputs": [prompt], "max_new_tokens": 3})
            .encode()), timeout=120)

    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            post([5, 70, 2])                   # vocab 64
        assert err.value.code == 400
        with pytest.raises(ValueError, match=r"\[0, 64\)"):
            service.generate_service().batcher.submit([5, 70, 2], 3)
        with post(PROMPTS[0]) as resp:
            got = json.loads(resp.read())["outputs"][0]
        assert got == want[0][:len(PROMPTS[0]) + 3]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_pool_backpressure_and_eos(lm):
    """A pool that holds one request at a time: later admissions wait
    for pages (FIFO) and every answer still matches; an eos id ends a
    request at its first occurrence (the JAX reference keeps emitting
    eos to max_new_tokens, so it is cut after the first)."""
    pm, want = lm
    b = serve.ContinuousBatcher(pm, n_slots=4, prefill_chunk=8,
                                kv_page_size=8, kv_pages=3, device="cpu")
    try:
        with pytest.raises(ValueError, match="pool only has"):
            b.submit(PROMPTS[1], MAX_NEW)        # needs 4 pages of 3
        short = [PROMPTS[0], PROMPTS[2], PROMPTS[0]]
        outs = [h.result(timeout=120)
                for h in [b.submit(p, MAX_NEW) for p in short]]
        assert outs == [want[0], want[2], want[0]]
        eos = want[2][len(PROMPTS[2]) + 2]
        got = b.submit(PROMPTS[2], MAX_NEW, eos_id=eos).result(timeout=120)
        cut = want[2][:want[2].index(eos, len(PROMPTS[2])) + 1]
        assert got == cut
        assert sorted(b._free_pages) == [0, 1, 2]
    finally:
        b.stop()


def test_concurrent_submitters_stress(lm, batcher):
    """More submitting threads than cores against one engine thread, with
    a short switch interval: every answer stays exact and the pool comes
    back whole (a lost update in the shared queues would break either)."""
    pm, want = lm
    results, errors = {}, []

    def client(i):
        try:
            p = PROMPTS[i % len(PROMPTS)]
            results[i] = batcher.submit(p, MAX_NEW).result(timeout=120)
        except Exception as e:   # re-raised below, after the joins
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert all(results[i] == want[i % len(PROMPTS)] for i in range(12))
    assert sorted(batcher._free_pages) == list(range(batcher._total_pages))


@pytest.fixture(scope="module")
def quant_want(lm):
    """{mode: JAX greedy outputs for PROMPTS from the quantised tree of the
    same weights} (quantize_tree; its bytes equal the port's)."""
    from tensorflowonspark_tpu import quantize as jq

    params = convert.params_to_jax(lm[0].state_dict())
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**CFG))
    out = {}
    for mode in ("int8", "int4"):
        qtree = jq.quantize_tree(params, mode=mode)
        out[mode] = [np.asarray(jax_decode.generate(
            jm, qtree, np.array([p], np.int32), max_new_tokens=MAX_NEW,
            temperature=0.0, loop="host"))[0].tolist() for p in PROMPTS]
    return out


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_http_generate_quantized_matches_jax(lm, quant_want, mode, tmp_path):
    """``--generate_quantize`` over HTTP on the CPU: greedy outputs equal
    the JAX package's quantised decode, metadata reports the mode and the
    weight bytes, and the plain versions ran (no kernel launch)."""
    export.export_saved_model(str(tmp_path), lm[0].state_dict(),
                              builder_kwargs=CFG)
    args = serve.build_argparser().parse_args([
        "--export_dir", str(tmp_path), "--port", "0", "--device", "cpu",
        "--generate_kv_page_size", "8", "--generate_kv_pages", "24",
        "--generate_prefill_chunk", "8", "--generate_slots", "4",
        "--generate_quantize", mode])
    server, service = serve.make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}/v1/models/default"
    try:
        body = json.dumps({"inputs": PROMPTS, "max_new_tokens": MAX_NEW,
                           "temperature": 0.0}).encode()
        req = urllib.request.Request(base + ":generate", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert json.loads(resp.read())["outputs"] == quant_want[mode]
        with urllib.request.urlopen(base, timeout=30) as resp:
            meta = json.loads(resp.read())["model"]
        qinfo = meta["generate_quantize"]
        assert qinfo["mode"] == mode
        # int8: 1 byte + 4/K of scale per f32 weight (~3.8x smaller);
        # int4 pads these 64-row kernels to one 128-row group
        shrink = {"int8": 3.5, "int4": 4.0}[mode]
        assert 0 < qinfo["weight_bytes"] < (qinfo["float_equivalent_bytes"]
                                            / shrink)
        assert meta["kernel_launches"] == {
            "paged_attention": 0, "page_write": 0, "prefill_read": 0,
            f"{mode}_matmul": 0}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_load_keeps_scales_f32(lm, mode, tmp_path):
    """A bf16 model served quantised: every q is int8, every scale stays
    f32 (the compute-width cast skips them), the other floats are bf16."""
    cfg = dict(CFG, dtype="bfloat16")
    export.export_saved_model(str(tmp_path), lm[0].state_dict(),
                              builder_kwargs=cfg)
    svc = serve.GenerateService(str(tmp_path), kv_page_size=8, kv_pages=8,
                                quantize_mode=mode, device="cpu")
    try:
        state = svc.model.state_dict()
        assert sum(n.endswith(".q") for n in state) == 9   # 4 x 2 + lm_head
        for name, t in state.items():
            if name.endswith(".q"):
                assert t.dtype == torch.int8, name
            elif name.endswith(".scale"):
                assert t.dtype == torch.float32, name
            else:
                assert t.dtype == torch.bfloat16, name
        out = svc.generate({"inputs": [PROMPTS[0]], "max_new_tokens": 3})
        assert out[0][:len(PROMPTS[0])] == PROMPTS[0] and len(out[0]) == 8
    finally:
        svc.close()
    with pytest.raises(ValueError, match="quantize_mode"):
        serve.GenerateService(str(tmp_path), kv_page_size=8, kv_pages=8,
                              quantize_mode="int2", device="cpu")
