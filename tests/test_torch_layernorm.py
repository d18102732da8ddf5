"""The port's fused LayerNorm (kernel 11's plain version on the CPU)
against the JAX package.

- ``fused_layernorm`` on CPU tensors against the JAX Pallas kernel in
  interpret mode (``fused_layernorm(..., interpret=True)``), at 300 rows
  (not a multiple of the kernel's 256-row block, which the JAX version
  pads), in f32 (1e-5: f32 statistics on both sides, summation order
  differs) and bf16 (the same f32 math rounded once to bf16: within one
  bf16 step, rtol 2^-7).
- Gradients through ``torch.autograd`` against ``jax.grad`` through the
  JAX custom VJP, in f32 (1e-5).
- ``Transformer(fused_ln=True)`` against the JAX model: cache-free logits
  within 1e-4 (f32, two layers of width 64), and greedy tokens of the
  port's paged ``generate`` and of its ContinuousBatcher equal to JAX
  ``decode.generate``; the batcher lists the ``layernorm`` kernel.
- ``fused_ln`` with ``norm_type="rmsnorm"`` raises ValueError in both.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu.models import decode as jax_decode
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import convert, serve
from tensorflowonspark_tpu_torch.models import decode as port_decode
from tensorflowonspark_tpu_torch.models import transformer as port_tf
from tensorflowonspark_tpu_torch.ops import layernorm as port_ln

# the JAX ops package binds its kernel functions under the submodules'
# names, so the submodule is fetched by its full name
jax_ln = importlib.import_module("tensorflowonspark_tpu.ops.layernorm")

CFG = dict(vocab_size=96, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=128, max_seq_len=64, dtype="float32", rope=True,
           fused_ln=True)


def _inputs(seed, D=96):
    rng = np.random.RandomState(seed)
    x = (rng.randn(3, 100, D) * 2.0 + 0.5).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(D)).astype(np.float32)
    bias = (0.1 * rng.randn(D)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(dtype):
    x, scale, bias = _inputs(0)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(dtype)
    want = jax_ln.fused_layernorm(xj, jnp.asarray(scale), jnp.asarray(bias),
                                  eps=1e-6, interpret=True)
    got = port_ln.fused_layernorm(xt, torch.from_numpy(scale),
                                  torch.from_numpy(bias), eps=1e-6)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == "float32"
           else dict(atol=1e-2, rtol=2 ** -7))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_gradients_match_jax_custom_vjp():
    x, scale, bias = _inputs(1, D=40)
    w = np.random.RandomState(2).randn(*x.shape).astype(np.float32)

    def jloss(x, s, b):
        return jnp.sum(jax_ln.fused_layernorm(x, s, b, eps=1e-5,
                                              interpret=True) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, scale, bias)]
    loss = (port_ln.fused_layernorm(*leaves, eps=1e-5)
            * torch.from_numpy(w)).sum()
    loss.backward()
    for t, g in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def pair():
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**CFG))
    params = jm.init(jax.random.key(3), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    # the fused modules keep flax LayerNorm's parameter names
    assert set(params["ln_f"]) == {"scale", "bias"}
    pm = port_tf.build_transformer(**CFG)
    pm.load_state_dict(convert.params_from_jax(params), strict=True)
    assert isinstance(pm.ln_f, port_tf.FusedLayerNorm)
    return jm, params, pm.eval()


def test_fused_ln_transformer_logits_match_jax(pair):
    jm, params, pm = pair
    toks = np.random.RandomState(4).randint(0, 96, (2, 11))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = pm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_fused_ln_serving_matches_jax_generate(pair):
    jm, params, pm = pair
    prompts = [[5, 9, 2, 40, 7], list(range(3, 22))]
    want = [np.asarray(jax_decode.generate(
        jm, params, np.array([p], np.int32), max_new_tokens=6,
        temperature=0.0, loop="host"))[0].tolist() for p in prompts]
    with torch.no_grad():
        solo = [port_decode.generate(pm, [p], 6, device="cpu")[0].tolist()
                for p in prompts]
    assert solo == want
    batcher = serve.ContinuousBatcher(pm, n_slots=2, prefill_chunk=8,
                                      kv_page_size=8, kv_pages=12,
                                      device="cpu")
    try:
        assert "layernorm" in batcher.kernels
        handles = [batcher.submit(p, 6) for p in prompts]
        assert [h.result(timeout=120) for h in handles] == want
    finally:
        batcher.stop()


def test_fused_ln_with_rmsnorm_raises():
    cfg = dict(CFG, norm_type="rmsnorm")
    with pytest.raises(ValueError, match="fused_ln"):
        port_tf.build_transformer(**cfg)
    with pytest.raises(ValueError, match="fused_ln"):
        jax_tf.Transformer(jax_tf.TransformerConfig(**cfg)).init(
            jax.random.key(0), jnp.zeros((1, 4), jnp.int32))
