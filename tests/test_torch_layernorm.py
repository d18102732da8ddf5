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
- Kernel 11's layout (``kernel_layout``: chunks of 16 bytes or single
  values, threads a row) depends on D and the dtype alone, keeps at most
  32 values a thread and covers rows of up to 8192; its order of work
  (each thread's sums over its chunks, the xor-butterfly over the row's
  lanes, the warps' totals in order), emulated in f32 on the CPU, agrees
  with the JAX kernel in interpret mode at D 64, 100, 1000, 2048 and
  8192 within the tolerances above.
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


def _fma(a, b, c):
    """f32 ``fmaf`` emulated in f64 (the product is exact there)."""
    return (a.double() * b.double() + c.double()).float()


def _kernel_order_layernorm(x, scale, bias, eps):
    """Kernel 11's arithmetic in its order of work (csrc/layernorm.cu), in
    f32 on the CPU: thread l of a row's ``lanes`` sums its chunks l, l +
    lanes, ... value by value, the lanes' sums meet in an xor butterfly
    (offsets 16 down to 1, below ``lanes``), and rows of more than 32
    lanes add their warps' totals in warp order; mean and variance are
    divided by D; y = fma(xc * rsqrt(var + eps), scale, bias)."""
    N, D = x.shape
    vec, lanes = port_ln.kernel_layout(D, x.dtype)
    chunks = D // vec
    per = -(-chunks // lanes)
    # [lanes, per * vec]: the element each lane takes at each step, -1 past
    # the row
    idx = torch.full((lanes, per * vec), -1, dtype=torch.long)
    for lane in range(lanes):
        for i in range(per):
            c = lane + i * lanes
            if c < chunks:
                idx[lane, i * vec:(i + 1) * vec] = torch.arange(
                    c * vec, (c + 1) * vec)
    valid = idx >= 0
    vals = x.float()[:, idx.clamp_min(0)]             # [N, lanes, steps]

    def row_total(part):
        for o in (16, 8, 4, 2, 1):
            if o < lanes:
                part = part + part[:, torch.arange(lanes) ^ o]
        if lanes <= 32:
            return part[:, :1]
        total = torch.zeros((N, 1))
        for w in range(lanes // 32):
            total = total + part[:, w * 32:w * 32 + 1]
        return total

    part = torch.zeros((N, lanes))
    for j in range(per * vec):
        part = torch.where(valid[:, j], part + vals[:, :, j], part)
    mean = row_total(part) / torch.tensor(float(D))
    xc = vals - mean[:, :, None]
    part = torch.zeros((N, lanes))
    for j in range(per * vec):
        part = torch.where(valid[:, j], _fma(xc[:, :, j], xc[:, :, j], part),
                           part)
    var = row_total(part) / torch.tensor(float(D))
    inv = torch.rsqrt(var + eps)
    y = torch.empty((N, D))
    sel = idx[valid]
    y[:, sel] = _fma(xc[:, valid] * inv, scale.float()[sel],
                     bias.float()[sel])
    return y.to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_layout_depends_on_d_and_dtype_alone(dtype):
    size = torch.empty((), dtype=dtype).element_size()
    for D in list(range(1, 300)) + [1000, 2047, 2048, 4100, 8191, 8192]:
        vec, lanes = port_ln.kernel_layout(D, dtype)
        assert vec == (16 // size if D * size % 16 == 0 else 1)
        assert lanes & (lanes - 1) == 0 and lanes <= port_ln.KERNEL_BLOCK
        per = -(-(D // vec) // lanes)
        assert per * vec <= port_ln.KERNEL_VALUES and lanes * per * vec >= D
    assert port_ln.kernel_layout(2048, torch.bfloat16) == (8, 64)
    with pytest.raises(NotImplementedError):
        port_ln.kernel_layout(8193, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 100, 1000, 2048, 8192])
def test_kernel_order_of_work_matches_jax_kernel(D, dtype):
    rng = np.random.RandomState(D)
    x = (rng.randn(5, D) * 2.0 + 0.5).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(D)).astype(np.float32)
    bias = (0.1 * rng.randn(D)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jax_ln.fused_layernorm(
        jnp.asarray(xt.float().numpy()).astype(dtype), jnp.asarray(scale),
        jnp.asarray(bias), eps=1e-6, interpret=True)
    got = _kernel_order_layernorm(xt, torch.from_numpy(scale),
                                  torch.from_numpy(bias), 1e-6)
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == "float32"
           else dict(atol=1e-2, rtol=2 ** -7))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


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
