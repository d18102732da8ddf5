"""Stop sequences and the repetition penalty in the port, against the
JAX package's ``tests/test_sampling_controls.py`` rules.

A tiny f32 LM, seeded, in both packages' layouts.  Greedy tokens equal
exactly:

- a stop sequence ends the request where the host rule says (the stop's
  tokens kept; a stop on the first token retires the row at
  admission), equal to the JAX batcher's output for the same request;
- a stop never matches across the prompt boundary;
- validation (sampling filters without temperature, stop shapes and
  counts, the penalty's range) in the batcher, the service and HTTP;
- the penalty: the port's solo ``generate`` equals JAX ``generate``
  (greedy) and differs from the plain tokens; the batcher's penalised
  rows (greedy and seeded sampled) equal the port's solo path beside an
  unpenalised row in the same batch, and the greedy one the JAX
  batcher's; the ``seen`` table is reset for the row's next tenant;
- the device-side sampling noise draws the softmax (chi-square), with a
  top-k filter too.
"""
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorflowonspark_tpu import export as jax_export
from tensorflowonspark_tpu import serve as jax_serve
from tensorflowonspark_tpu.models import decode as jax_decode
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import convert, serve
from tensorflowonspark_tpu_torch.models import decode as port_decode
from tensorflowonspark_tpu_torch.models import transformer as port_tf

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_seq_len=32, dtype="float32", rope=True,
           attention_impl="dense")
JAX_BUILDER = "tensorflowonspark_tpu.models.transformer:build_transformer"


@pytest.fixture(scope="module")
def lm():
    """(JAX module, its numpy parameters, the port's model): seeded
    weights drawn by the port, carried to the JAX layout."""
    pm = port_tf.build_transformer(**CFG)
    pm.reset_parameters(torch.Generator().manual_seed(0))
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**CFG))
    return jm, convert.params_to_jax(pm.state_dict()), pm.eval(
        ).requires_grad_(False)


def _solo(jm, params, prompt, n_new, **kw):
    out = jax_decode.generate(jm, params, jnp.asarray([prompt], jnp.int32),
                              max_new_tokens=n_new, loop="host", **kw)
    return np.asarray(out)[0].tolist()


def _port_solo(pm, prompt, n_new, **kw):
    return port_decode.generate(pm, [prompt], n_new, device="cpu",
                                **kw)[0].tolist()


def _batcher(pm, **kw):
    return serve.ContinuousBatcher(pm, n_slots=3, read_chunk=1,
                                   prefill_chunk=8, device="cpu", **kw)


def _first_stop_end(seq, start, st):
    for i in range(start + len(st), len(seq) + 1):
        if seq[:i][-len(st):] == st:
            return i
    return len(seq)


@pytest.mark.parametrize("paged", [False, True])
def test_stop_sequences_end_the_request(lm, paged):
    jm, params, pm = lm
    prompt = [1, 2, 3]
    full = _solo(jm, params, prompt, 10)
    new = full[len(prompt):]
    stop = new[2:4]                                   # a 2-token stop
    kw = dict(kv_page_size=8, kv_pages=12) if paged else {}
    b = _batcher(pm, **kw)
    try:
        got = b.submit(prompt, 10, stop=[stop]).result(timeout=300)
        first = b.submit(prompt, 10, stop=[[new[0]]]).result(timeout=300)
    finally:
        b.stop()
    assert got == full[:_first_stop_end(full, len(prompt), stop)]
    assert got[-2:] == stop
    assert first == prompt + [new[0]]
    if not paged:
        jb = jax_serve.ContinuousBatcher(jm, params, n_slots=2, read_chunk=1,
                                         prefill_chunk=8)
        try:
            assert got == jb.submit(prompt, 10,
                                    stop=[stop]).result(timeout=300)
        finally:
            jb.stop()


def test_stop_never_matches_across_prompt_boundary(lm):
    jm, params, pm = lm
    prompt = [1, 2, 3]
    full = _solo(jm, params, prompt, 8)
    straddle = [prompt[-1], full[len(prompt)]]
    b = _batcher(pm)
    try:
        got = b.submit(prompt, 8, stop=[straddle]).result(timeout=300)
    finally:
        b.stop()
    expect = full
    for i in range(len(prompt) + 2, len(full) + 1):
        if full[i - 2:i] == straddle:
            expect = full[:i]
            break
    assert got == expect
    assert len(got) > len(prompt) + 1      # did NOT fire on token one


def test_validation_rules(lm):
    _, _, pm = lm
    b = _batcher(pm)
    try:
        with pytest.raises(ValueError, match="temperature"):
            b.submit([1, 2], 4, top_k=3)
        with pytest.raises(ValueError, match="top_p"):
            b.submit([1, 2], 4, temperature=0.9, top_p=0.0)
        with pytest.raises(ValueError, match="stop"):
            b.submit([1, 2], 4, stop=[[]])
        with pytest.raises(ValueError, match="16 stop"):
            b.submit([1, 2], 4, stop=[[1]] * 17)
        with pytest.raises(ValueError, match="repetition_penalty"):
            b.submit([1, 2], 4, repetition_penalty=0.0)
        with pytest.raises(ValueError, match="repetition_penalty"):
            b.submit([1, 2], 4, repetition_penalty=float("inf"))
    finally:
        b.stop()
    with pytest.raises(ValueError, match="repetition_penalty"):
        port_decode.generate(pm, [[1]], 2, device="cpu",
                             repetition_penalty=-1.0)


def test_http_stop_and_penalty(lm, tmp_path):
    jm, params, _ = lm
    d = str(tmp_path / "lm")
    jax_export.export_saved_model(d, params, builder=JAX_BUILDER,
                                  builder_kwargs=CFG)
    args = serve.build_argparser().parse_args(
        ["--export_dir", d, "--port", "0", "--device", "cpu",
         "--generate_slots", "2"])
    srv, _ = serve.make_server(args)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = (f"http://127.0.0.1:{srv.server_address[1]}"
           "/v1/models/default:generate")

    def post(payload):
        req = urllib.request.Request(url, data=json.dumps(payload).encode())
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        full = _solo(jm, params, [5, 6], 6)
        stop_tok = full[3]
        cut = next(i for i in range(3, len(full) + 1)
                   if full[i - 1] == stop_tok)
        code, out = post({"inputs": [[5, 6]], "max_new_tokens": 6,
                          "stop": [[stop_tok]]})
        assert code == 200 and out["outputs"][0] == full[:cut]
        code, out = post({"inputs": [[1, 2, 3]], "max_new_tokens": 8,
                          "repetition_penalty": 2.0})
        assert code == 200
        assert out["outputs"][0] == _solo(jm, params, [1, 2, 3], 8,
                                          repetition_penalty=2.0)
        for bad in ({"inputs": [[1]], "top_k": 2},
                    {"inputs": [[1]], "stop": [[]]},
                    {"inputs": [[1]], "stop": "x"},
                    {"inputs": [[1]], "stop": [[1]] * 17},
                    {"inputs": [[1]], "repetition_penalty": 0},
                    {"inputs": [[1]], "repetition_penalty": True},
                    {"inputs": [[1]], "repetition_penalty": 2e6}):
            code, out = post({"max_new_tokens": 2, **bad})
            assert code == 400, (bad, out)
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)


@pytest.mark.parametrize("top_k", [0, 2])
def test_counter_noise_samples_the_softmax(top_k):
    """The port's noise (an integer hash of seed and ordinal, not JAX's
    threefry bits) draws the temperature-scaled softmax: chi-square over
    4096 seeded rows (df 7, alpha 0.001), and with top_k=2 only the two
    largest logits."""
    V, n = 8, 4096
    logits = torch.tensor([2.0, 1.5, 0.0, -1.0, 0.5, -0.5, 0.2, -2.0])
    rows = logits.expand(n, V)
    kw = ({"topks": torch.full((n,), top_k), "topps": torch.ones(n)}
          if top_k else {})
    picks = port_decode.pick_tokens(rows, torch.full((n,), 0.8),
                                    torch.arange(n), torch.full((n,), 3),
                                    **kw)
    again = port_decode.pick_tokens(rows, torch.full((n,), 0.8),
                                    torch.arange(n), torch.full((n,), 3),
                                    **kw)
    assert torch.equal(picks, again)          # a pure function of its key
    obs = np.bincount(picks.numpy(), minlength=V)
    scaled = logits / 0.8
    if top_k:
        scaled = torch.where(logits >= logits.topk(top_k).values[-1],
                             scaled, torch.tensor(-float("inf")))
    exp = torch.softmax(scaled, -1).numpy() * n
    keep = exp > 0
    assert not obs[~keep].any()
    chi2 = float(((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum())
    assert chi2 < (24.32 if not top_k else 10.83), chi2


def test_repetition_penalty_solo_matches_jax(lm):
    jm, params, pm = lm
    prompt = [1, 2, 3]
    plain = _port_solo(pm, prompt, 8)
    pen = _port_solo(pm, prompt, 8, repetition_penalty=2.0)
    assert pen != plain                           # the penalty is real
    assert pen == _solo(jm, params, prompt, 8, repetition_penalty=2.0)
    assert plain == _solo(jm, params, prompt, 8)


def test_repetition_penalty_slots_match_solo(lm):
    jm, params, pm = lm
    prompt = [1, 2, 3]
    solo_greedy = _port_solo(pm, prompt, 8, repetition_penalty=2.0)
    solo_sampled = _port_solo(pm, prompt, 8, temperature=0.9, seed=4,
                              repetition_penalty=1.7)
    b = _batcher(pm)
    try:
        hs = [b.submit(prompt, 8, repetition_penalty=2.0),
              b.submit(prompt, 8, temperature=0.9, seed=4,
                       repetition_penalty=1.7),
              b.submit([7, 8], 8)]          # unpenalised, same batch
        got = [h.result(timeout=300) for h in hs]
        # the rows' next tenants decode unpenalised
        again = [b.submit([7, 8], 8).result(timeout=300) for _ in range(3)]
    finally:
        b.stop()
    assert got[0] == solo_greedy == _solo(jm, params, prompt, 8,
                                          repetition_penalty=2.0)
    assert got[1] == solo_sampled
    assert got[2] == _solo(jm, params, [7, 8], 8)
    assert again == [got[2]] * 3
    jb = jax_serve.ContinuousBatcher(jm, params, n_slots=3, read_chunk=1,
                                     prefill_chunk=8)
    try:
        want = jb.submit(prompt, 8, repetition_penalty=2.0).result(300)
    finally:
        jb.stop()
    assert got[0] == want
