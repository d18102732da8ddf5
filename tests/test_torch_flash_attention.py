"""Parity of the port's flash attention with the JAX package's.

The same numpy inputs go through the JAX ``flash_attention`` (its Pallas
kernels in interpret mode, 16 x 16 blocks, tiny shapes) and the port's
``flash_attention`` on CPU tensors (the plain versions of kernels 4-6
behind the autograd function): the output, and the q/k/v gradients for
one cotangent.  Causal and not, a ragged S = 40 (not a multiple of the
blocks), GQA groups of 1, 2 and 4.

Tolerances: f32 1e-5 (f32 math on both sides; summation order differs);
bf16 2e-2 (f32 math on both sides, then outputs and gradients rounded
to bf16, where one ulp is 2^-8 relative).
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu_torch.ops import flash_attention as port_fa

# the JAX package's ops/__init__ re-exports the function under the
# module's name
jax_fa = importlib.import_module("tensorflowonspark_tpu.ops.flash_attention")

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
H, D, B = 4, 16, 2


def _inputs(seed, S, group):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, H // group, D).astype(np.float32)
    v = rng.randn(B, S, H // group, D).astype(np.float32)
    g = rng.randn(B, S, H, D).astype(np.float32)
    return q, k, v, g


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("causal,S,group,dtype", [
    (True, 40, 1, "float32"), (True, 40, 2, "float32"),
    (True, 40, 4, "float32"), (False, 40, 2, "float32"),
    (True, 32, 4, "float32"), (False, 32, 1, "float32"),
    (True, 40, 2, "bfloat16"), (False, 40, 4, "bfloat16")])
def test_forward_and_grads_match_jax_interpret(causal, S, group, dtype):
    q, k, v, g = _inputs(S + group, S, group)
    jdt = jnp.dtype(dtype)

    def jax_flash(q_, k_, v_):
        return jax_fa.flash_attention(q_, k_, v_, causal=causal, block_q=16,
                                      block_k=16, interpret=True)

    out, vjp = jax.vjp(jax_flash, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = [out] + list(vjp(jnp.asarray(g, jdt)))
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(True)
              for x in (q, k, v)]
    pout = port_fa.flash_attention(*leaves, causal=causal)
    got = [pout] + list(torch.autograd.grad(
        pout, leaves, torch.from_numpy(g).to(tdt)))
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == tdt and tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.detach().float().numpy(), _np(b),
                                   atol=TOL[dtype], rtol=TOL[dtype],
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_jax_interpret(causal):
    q, k, v, _ = _inputs(3, 40, 2)
    _, want = jax_fa.flash_attention_with_lse(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, block_q=16,
        block_k=16, interpret=True)
    _, got = port_fa.flash_fwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_reference_matches_jax(causal):
    q, k, v, _ = _inputs(4, 24, 4)
    want = jax_fa.attention_reference(*(jnp.asarray(x) for x in (q, k, v)),
                                      causal=causal)
    got = port_fa.attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_no_grad_forward_skips_the_lse_and_heads_must_divide():
    q, k, v, _ = _inputs(5, 8, 2)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = port_fa.flash_fwd(tq, tk, tv, need_lse=False)
    assert lse is None
    assert torch.equal(port_fa.flash_attention(tq, tk, tv), out)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        port_fa.flash_attention(tq, tk[:, :, :1].expand(-1, -1, 3, -1),
                                tv[:, :, :1].expand(-1, -1, 3, -1))
