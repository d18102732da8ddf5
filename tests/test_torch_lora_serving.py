"""Multi-adapter LoRA serving in the port against the JAX package.

A tiny f32 LM, seeded, in both packages' layouts; adapters are JAX
``lora.init`` trees with a random ``b`` (big enough to change greedy
tokens), the same arrays on both sides.  Greedy tokens
equal exactly:

- tenants under two adapters and the base model share one batch and
  each matches a solo JAX decode over JAX ``lora.merge`` of its adapter
  (and the JAX batcher's output for the same burst), dense and paged;
- a bank with no adapters is exactly the base model;
- registry rules: unknown adapter, duplicate, bank full, in-flight
  references refuse an unregister, freed capacity is reusable, a
  wrong-rank adapter is refused;
- a refused submit leaks no adapter reference;
- the prefix cache is scoped per adapter (a base request never reuses
  pages prefilled under an adapter; a repeat under the same adapter
  does);
- over HTTP: ``--generate_lora_rank`` / ``--generate_lora NAME=PATH``
  (a JAX ``save_adapters`` file) and the ``adapter`` field, with the
  ``lora_*`` stats.
"""
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import export as jax_export
from tensorflowonspark_tpu import lora as jax_lora
from tensorflowonspark_tpu import serve as jax_serve
from tensorflowonspark_tpu.models import decode as jax_decode
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import convert, serve
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


def _adapter(params, seed, rank=4, scale=0.5):
    ad = jax_lora.init(jax.random.key(seed), params, rank=rank)
    rs = np.random.RandomState(seed + 100)
    return {p: {"a": np.asarray(v["a"]),
                "b": rs.randn(*v["b"].shape).astype(np.float32)}
            for p, v in ad.items()}, scale


def _solo(jm, params, prompt, n_new):
    out = jax_decode.generate(jm, params, jnp.asarray([prompt], jnp.int32),
                              max_new_tokens=n_new, loop="host")
    return np.asarray(out)[0].tolist()


def _batcher(pm, **kw):
    return serve.ContinuousBatcher(pm, n_slots=3, read_chunk=1,
                                   prefill_chunk=8, device="cpu", **kw)


BURST = [([1, 2, 3], "a1"), ([1, 2, 3], None), ([4, 5], "a2")]


@pytest.mark.parametrize("paged", [False, True])
def test_tenants_share_one_batch_and_match_merged_solo(lm, paged):
    jm, params, pm = lm
    ads = {"a1": _adapter(params, 1), "a2": _adapter(params, 2)}
    kw = dict(kv_page_size=8, kv_pages=16) if paged else {}
    b = _batcher(pm, lora_rank=4, lora_capacity=4, **kw)
    try:
        for name, (ad, s) in ads.items():
            b.register_adapter(name, ad, scale=s)
        hs = [b.submit(p, 6, adapter=a) for p, a in BURST]
        got = [h.result(timeout=300) for h in hs]
        st = b.stats()
    finally:
        b.stop()
    for (p, a), g in zip(BURST, got):
        ref = params if a is None else jax_lora.merge(params, *ads[a])
        assert g == _solo(jm, ref, p, 6), a
    assert got[0] != got[1]                 # the delta is real
    assert st["lora_rank"] == 4 and st["lora_adapters"] == ["a1", "a2"]
    assert st["lora_capacity_free"] == 2
    if not paged:
        jb = jax_serve.ContinuousBatcher(jm, params, n_slots=3, read_chunk=1,
                                         prefill_chunk=8, lora_rank=4,
                                         lora_capacity=4)
        try:
            for name, (ad, s) in ads.items():
                jb.register_adapter(name, ad, scale=s)
            want = [h.result(timeout=300) for h in
                    [jb.submit(p, 6, adapter=a) for p, a in BURST]]
        finally:
            jb.stop()
        assert got == want


def test_bank_without_adapters_is_exactly_base(lm):
    _, _, pm = lm
    plain, with_bank = _batcher(pm), _batcher(pm, lora_rank=4)
    try:
        a = plain.submit([7, 8, 9], 6).result(timeout=300)
        c = with_bank.submit([7, 8, 9], 6).result(timeout=300)
    finally:
        plain.stop()
        with_bank.stop()
    assert a == c


def test_registry_rules(lm):
    _, params, pm = lm
    ad, s = _adapter(params, 3)
    b = _batcher(pm, lora_rank=4, lora_capacity=1)
    try:
        with pytest.raises(ValueError, match="unknown adapter"):
            b.submit([1, 2], 4, adapter="nope")
        b.register_adapter("a", ad, scale=s)
        with pytest.raises(ValueError, match="already registered"):
            b.register_adapter("a", ad)
        with pytest.raises(ValueError, match="bank full"):
            b.register_adapter("b", ad)
        h = b.submit([1, 2, 3], 8, adapter="a")
        with pytest.raises(ValueError, match="in flight"):
            b.unregister_adapter("a")
        h.result(timeout=300)
        b.unregister_adapter("a")
        with pytest.raises(ValueError, match="not registered"):
            b.unregister_adapter("a")
        b.register_adapter("c", ad, scale=s)     # freed capacity reused
        with pytest.raises(ValueError, match="not an attention"):
            b.register_adapter("d", {"layer_0/mlp/wi/kernel": ad[
                "layer_0/attn/query/kernel"]})
    finally:
        b.stop()
    b2 = _batcher(pm, lora_rank=8)
    try:
        with pytest.raises(ValueError, match="do not match bank"):
            b2.register_adapter("r4", ad)
    finally:
        b2.stop()
    plain = _batcher(pm)
    try:
        with pytest.raises(ValueError, match="no LoRA bank"):
            plain.submit([1, 2], 4, adapter="a")
    finally:
        plain.stop()


def test_rejected_submit_leaks_no_adapter_ref(lm):
    _, params, pm = lm
    ad, s = _adapter(params, 7)
    b = _batcher(pm, lora_rank=4)
    try:
        b.register_adapter("a", ad, scale=s)
        with pytest.raises(ValueError, match="max_seq_len"):
            b.submit([1] * 30, 30, adapter="a")     # 60 > max_seq 32
        with pytest.raises(ValueError, match="stop"):
            b.submit([1], 4, adapter="a", stop=[[]])
        b.unregister_adapter("a")                   # no leaked ref
    finally:
        b.stop()


def test_prefix_cache_is_adapter_scoped(lm):
    jm, params, pm = lm
    ad, s = _adapter(params, 9)
    prompt = list(range(1, 12))                     # 11 tokens, page 8
    b = _batcher(pm, lora_rank=4, kv_page_size=8, kv_pages=12)
    try:
        b.register_adapter("a", ad, scale=s)
        with_a = b.submit(prompt, 5, adapter="a").result(timeout=300)
        shared_after_a = b.prefill_tokens_shared
        base = b.submit(prompt, 5).result(timeout=300)
        assert b.prefill_tokens_shared == shared_after_a   # no cross hit
        again_a = b.submit(prompt, 5, adapter="a").result(timeout=300)
        assert b.prefill_tokens_shared == shared_after_a + 8
        # a re-registration gets a fresh root: the old pages never serve
        b.unregister_adapter("a")
        b.register_adapter("a", ad, scale=s)
        b.submit(prompt, 5, adapter="a").result(timeout=300)
        assert b.prefill_tokens_shared == shared_after_a + 8
    finally:
        b.stop()
    assert base == _solo(jm, params, prompt, 5)
    assert with_a == _solo(jm, jax_lora.merge(params, ad, s), prompt, 5)
    assert again_a == with_a


def test_http_adapter_bank(lm, tmp_path):
    jm, params, _ = lm
    d = str(tmp_path / "lm")
    jax_export.export_saved_model(d, params, builder=JAX_BUILDER,
                                  builder_kwargs=CFG)
    ad, s = _adapter(params, 5)
    path = str(tmp_path / "a.msgpack")
    jax_lora.save_adapters(path, ad, scale=s)
    args = serve.build_argparser().parse_args(
        ["--export_dir", d, "--port", "0", "--device", "cpu",
         "--generate_slots", "2", "--generate_lora_rank", "4",
         "--generate_lora", f"t1={path}"])
    srv, _ = serve.make_server(args)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/v1/models/default"

    def post(payload):
        req = urllib.request.Request(url + ":generate",
                                     data=json.dumps(payload).encode())
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        code, out = post({"inputs": [[1, 2, 3]], "max_new_tokens": 5,
                          "adapter": "t1"})
        assert code == 200
        assert out["outputs"][0] == _solo(
            jm, jax_lora.merge(params, ad, s), [1, 2, 3], 5)
        assert post({"inputs": [[1]], "adapter": "zz"})[0] == 400
        assert post({"inputs": [[1]], "adapter": 3})[0] == 400
        with urllib.request.urlopen(url, timeout=30) as r:
            st = json.loads(r.read())["model"]["generate_stats"]
        assert st["lora_adapters"] == ["t1"] and st["lora_rank"] == 4
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    bad = serve.build_argparser().parse_args(
        ["--export_dir", d, "--device", "cpu", "--generate_lora", "x=y"])
    with pytest.raises(ValueError, match="generate_lora_rank"):
        serve.make_server(bad)
