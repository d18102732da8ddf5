"""Parity of the port's flash attention with the JAX package's.

The same numpy inputs go through the JAX ``flash_attention`` (its Pallas
kernels in interpret mode, 16 x 16 blocks, tiny shapes) and the port's
``flash_attention`` on CPU tensors (the plain versions of kernels 4-6
behind the autograd function): the output, and the q/k/v gradients for
one cotangent.  Causal and not, a ragged S = 40 (not a multiple of the
blocks), GQA groups of 1, 2 and 4.  ``flash_attention_with_lse``: its
``(out, lse)`` and the q/k/v gradients of ``sum(out * w) + sum(lse *
u)`` (the lse cotangent folded into delta) against the JAX function, at
head dims 64 and 128; and a two-block merge (each query block's
attention over the key blocks it sees, merged by their lse weights, as
ring attention merges its steps) against ``flash_attention`` over all
keys, forward and gradients.  The bf16 tensor-core forward's rounding
point (p rounded to bf16 before the value product; an emulation of its
arithmetic in torch at D 128, S 200, GQA group 2) against the JAX
function in interpret mode, at the card tests' bf16 tolerances (1e-2
out, 1e-4 lse).  The bf16 tensor-core backward's rounding points (p and
ds rounded to bf16 before their products; an emulation in torch at D
128, S 200, GQA group 2) against the JAX gradients in interpret mode,
at the card's backward tolerance (atol 4e-2, rtol 1e-2).

Tolerances: f32 1e-5 (f32 math on both sides; summation order differs);
bf16 2e-2 (f32 math on both sides, then outputs and gradients rounded
to bf16, where one ulp is 2^-8 relative).

On a mismatch the forward-and-gradients test and the two-block merge
save their evidence under ``build/flake_evidence/`` of the checkout
(inputs and both sides' outputs, ``.npz``; the xdist worker, the
process's torch settings and the names of the tests that process ran
before it, ``.json``) and name the files in the failure.
"""
import importlib
import json
import os
import re

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


EVIDENCE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "flake_evidence")


@pytest.fixture
def evidence(request):
    """``save(**arrays) -> path``: writes the arrays and this process's
    test history: ``PYTEST_XDIST_WORKER`` and the node ids of the tests
    it ran before this one (the collected items pytest has run and torn
    down, in collection order), for a mismatch seen once in many full
    runs."""
    ran = [item.nodeid for item in request.session.items
           if getattr(item, "_request", None) is False]

    def save(**arrays):
        os.makedirs(EVIDENCE_DIR, exist_ok=True)
        stem = os.path.join(EVIDENCE_DIR, "{}-{}-{}".format(
            re.sub(r"[^\w.-]+", "_", request.node.name),
            os.environ.get("PYTEST_XDIST_WORKER", "main"), os.getpid()))
        np.savez(stem + ".npz", **arrays)
        with open(stem + ".json", "w") as f:
            json.dump({"test": request.node.nodeid,
                       "worker": os.environ.get("PYTEST_XDIST_WORKER"),
                       "pid": os.getpid(), "torch_state": _torch_state(),
                       "tests_before": ran}, f, indent=1)
        return stem
    return save


def _torch_state():
    """The process-wide torch settings that can move f32 CPU results."""
    return {"num_threads": torch.get_num_threads(),
            "num_interop_threads": torch.get_num_interop_threads(),
            "default_dtype": str(torch.get_default_dtype()),
            "float32_matmul_precision":
                torch.get_float32_matmul_precision(),
            "grad_enabled": torch.is_grad_enabled(),
            "deterministic": torch.are_deterministic_algorithms_enabled(),
            "mkldnn_enabled": torch.backends.mkldnn.enabled,
            "config": torch.__config__.parallel_info()}


@pytest.mark.parametrize("causal,S,group,dtype", [
    (True, 40, 1, "float32"), (True, 40, 2, "float32"),
    (True, 40, 4, "float32"), (False, 40, 2, "float32"),
    (True, 32, 4, "float32"), (False, 32, 1, "float32"),
    (True, 40, 2, "bfloat16"), (False, 40, 4, "bfloat16")])
def test_forward_and_grads_match_jax_interpret(causal, S, group, dtype,
                                              evidence):
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
    names = ("out", "dq", "dk", "dv")
    try:
        for name, a, b in zip(names, got, want):
            assert a.dtype == tdt and tuple(a.shape) == b.shape, name
            np.testing.assert_allclose(a.detach().float().numpy(), _np(b),
                                       atol=TOL[dtype], rtol=TOL[dtype],
                                       err_msg=name)
    except AssertionError as e:
        arrays = dict(q=q, k=k, v=v, g=g)
        for name, a, b in zip(names, got, want):
            arrays["port_" + name] = a.detach().float().numpy()
            arrays["jax_" + name] = _np(b)
        raise AssertionError(f"{e}\nevidence: {evidence(**arrays)}."
                             "{npz,json}") from e


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
    assert lse.dtype == torch.float32 and lse.numel() == 0
    assert torch.equal(port_fa.flash_attention(tq, tk, tv), out)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        port_fa.flash_attention(tq, tk[:, :, :1].expand(-1, -1, 3, -1),
                                tv[:, :, :1].expand(-1, -1, 3, -1))


@pytest.mark.parametrize("causal,S,group,D", [
    (True, 24, 2, 64), (False, 24, 1, 64), (True, 20, 4, 128),
    (False, 16, 2, 128)])
def test_with_lse_forward_and_grads_match_jax_interpret(causal, S, group,
                                                        D):
    rng = np.random.RandomState(S + D + group)
    Hq = 4
    q = rng.randn(1, S, Hq, D).astype(np.float32)
    k = rng.randn(1, S, Hq // group, D).astype(np.float32)
    v = rng.randn(1, S, Hq // group, D).astype(np.float32)
    w = rng.randn(1, S, Hq, D).astype(np.float32)
    u = rng.randn(1, Hq, S).astype(np.float32)

    def jax_flash(q_, k_, v_):
        return jax_fa.flash_attention_with_lse(
            q_, k_, v_, causal=causal, block_q=16, block_k=16,
            interpret=True)

    (out, lse), vjp = jax.vjp(jax_flash, *(jnp.asarray(x)
                                            for x in (q, k, v)))
    want = [out, lse] + list(vjp((jnp.asarray(w), jnp.asarray(u))))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    pout, plse = port_fa.flash_attention_with_lse(*leaves, causal=causal)
    loss = (pout * torch.from_numpy(w)).sum() + (
        plse * torch.from_numpy(u)).sum()
    got = [pout, plse] + list(torch.autograd.grad(loss, leaves))
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.detach().numpy(), _np(b), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_with_lse_without_grad_and_unused_lse():
    q, k, v, g = _inputs(6, 24, 2)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = port_fa.flash_attention_with_lse(tq, tk, tv)
    want, want_lse = port_fa.flash_fwd_plain(tq, tk, tv)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    # only out reaches the loss: the gradients are flash_attention's
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out, _ = port_fa.flash_attention_with_lse(*leaves)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    ref = port_fa.flash_attention(*leaves)
    want = torch.autograd.grad(ref, leaves, torch.from_numpy(g))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _merge(parts):
    """Attention over the union of key blocks from each block's ``(out,
    lse)``: weights ``exp(lse_i - logsumexp(lse))``."""
    lses = torch.stack([lse for _, lse in parts])          # [n, B, H, S]
    total = torch.logsumexp(lses, dim=0)
    return sum(out * torch.exp(lse - total).permute(0, 2, 1)[..., None]
               for out, lse in parts)


@pytest.mark.parametrize("causal", [True, False])
def test_two_block_merge_equals_full_attention(causal, evidence):
    q, k, v, g = _inputs(8, 32, 2)
    half = 16
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    full = port_fa.flash_attention(*leaves, causal=causal)
    want = [full] + list(torch.autograd.grad(full, leaves,
                                             torch.from_numpy(g)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    tq, tk, tv = leaves
    blocks = [slice(0, half), slice(half, None)]
    outs = []
    for qi, qs in enumerate(blocks):
        parts = []
        for ki, ks in enumerate(blocks):
            if causal and ki > qi:
                continue          # keys after every query of the block
            parts.append(port_fa.flash_attention_with_lse(
                tq[:, qs], tk[:, ks], tv[:, ks],
                causal=causal and ki == qi))
        outs.append(_merge(parts))
    merged = torch.cat(outs, dim=1)
    got = [merged] + list(torch.autograd.grad(merged, leaves,
                                              torch.from_numpy(g)))
    names = ("out", "dq", "dk", "dv")
    try:
        for name, a, b in zip(names, got, want):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=name)
    except AssertionError as e:
        arrays = dict(q=q, k=k, v=v, g=g)
        for name, a, b in zip(names, got, want):
            arrays["merged_" + name] = a.detach().numpy()
            arrays["full_" + name] = b.detach().numpy()
        raise AssertionError(f"{e}\nevidence: {evidence(**arrays)}."
                             "{npz,json}") from e


def _tensor_core_forward(q, k, v, causal, tile=64):
    """The arithmetic of the bf16 tensor-core forward (csrc/mma.cuh
    ``AttnWarp``), emulated in torch: 64-key tiles, f32 scores in log2
    units, f32 running max and sum, p rounded to bf16 before the value
    product (f32 sums), l summed from the f32 p, out rounded to bf16.
    Returns ``(out [B, S, H, D] bf16, lse [B, H, S] f32)``."""
    B, S, H, D = q.shape
    group = H // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().repeat_interleave(group, 2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(group, 2).permute(0, 2, 1, 3)
    scale2 = D ** -0.5 * np.log2(np.e)
    m = torch.full((B, H, S), port_fa.NEG_INF)
    l = torch.zeros((B, H, S))
    o = torch.zeros((B, H, S, D))
    rows = torch.arange(S)
    for k0 in range(0, S, tile):
        keys = torch.arange(k0, min(S, k0 + tile))
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2) * scale2
        if causal:
            s = torch.where(keys[None, :] <= rows[:, None], s,
                            torch.tensor(port_fa.NEG_INF))
        mn = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - mn)
        p = torch.exp2(s - mn[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + (p.bfloat16().float()
                                    @ vf[:, :, k0:k0 + tile])
        m = mn
    l = l.clamp_min(1e-30)
    out = (o / l[..., None]).bfloat16().permute(0, 2, 1, 3)
    lse = torch.where(m <= port_fa.NEG_INF / 2, torch.zeros_like(m),
                      m * np.log(2.0) + torch.log(l))
    return out, lse


@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_rounding_point_fits_the_tolerance(causal):
    """The bf16 tensor-core forward rounds p to bf16 before the value
    product (the JAX ``attention_reference`` rounds there too); its
    emulation stays within the card tests' bf16 tolerances of the JAX
    kernel in interpret mode: 1e-2 for out, 1e-4 for lse."""
    rng = np.random.RandomState(200 + causal)
    S, Hq, group, Dh = 200, 4, 2, 128
    q = rng.randn(1, S, Hq, Dh).astype(np.float32)
    k = rng.randn(1, S, Hq // group, Dh).astype(np.float32)
    v = rng.randn(1, S, Hq // group, Dh).astype(np.float32)
    want, want_lse = jax_fa.flash_attention_with_lse(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=causal,
        block_q=64, block_k=64, interpret=True)
    got, lse = _tensor_core_forward(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=1e-2,
                               rtol=1e-2)
    np.testing.assert_allclose(lse.numpy(), _np(want_lse), atol=1e-4,
                               rtol=1e-4)


def _tensor_core_backward(q, k, v, do, lse, delta, causal, tile=64):
    """The arithmetic of the bf16 tensor-core backward
    (csrc/flash_attention.cu ``flash_bwd_dq_mma_kernel`` and
    ``flash_bwd_dkv_mma_kernel``), emulated in torch: 64 x 64 tiles
    (causal tiles above the diagonal skipped), f32 scores in log2 units,
    ``p = exp2(s * scale * log2 e - lse * log2 e)`` (0 where masked),
    ``ds = p (dp - delta)``, p and ds rounded to bf16 before their
    products (f32 sums), dk and dv summed over each kv head's group, and
    ``dq = scale ds k``, ``dk = scale ds^T q``, ``dv = p^T dO`` rounded
    to bf16.  Returns ``(dq, dk, dv)`` in the layouts of q and k."""
    B, S, H, D = q.shape
    n_kv = k.shape[2]
    group = H // n_kv

    def heads(x):
        return x.float().repeat_interleave(H // x.shape[2], 2).permute(
            0, 2, 1, 3)

    qf, kf, vf, of = (heads(x) for x in (q, k, v, do))
    scale = D ** -0.5
    log2e = np.float32(np.log2(np.e))
    scale2 = np.float32(scale) * log2e
    lse2 = lse.float() * log2e
    pos = torch.arange(S)
    dq = torch.zeros((B, H, S, D))
    dk = torch.zeros((B, H, S, D))
    dv = torch.zeros((B, H, S, D))
    for q0 in range(0, S, tile):
        qs = slice(q0, q0 + tile)
        for k0 in range(0, S, tile):
            if causal and k0 > q0 + tile - 1:
                continue
            ks = slice(k0, k0 + tile)
            s = qf[:, :, qs] @ kf[:, :, ks].transpose(-1, -2)
            dp = of[:, :, qs] @ vf[:, :, ks].transpose(-1, -2)
            seen = torch.ones((len(pos[qs]), len(pos[ks])), dtype=torch.bool)
            if causal:
                seen = pos[ks][None, :] <= pos[qs][:, None]
            p = torch.where(seen, torch.exp2(s * scale2
                                             - lse2[:, :, qs, None]),
                            torch.zeros(()))
            ds = p * (dp - delta[:, :, qs, None])
            pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
            dq[:, :, qs] += dsb @ kf[:, :, ks]
            dv[:, :, ks] += pb.transpose(-1, -2) @ of[:, :, qs]
            dk[:, :, ks] += dsb.transpose(-1, -2) @ qf[:, :, qs]

    def narrow(x):
        return x.reshape(B, n_kv, group, S, D).sum(2).permute(0, 2, 1, 3)

    return ((scale * dq).permute(0, 2, 1, 3).bfloat16(),
            narrow(scale * dk).bfloat16(), narrow(dv).bfloat16())


@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_backward_rounding_points_fit_the_tolerance(causal):
    """The bf16 tensor-core backward rounds p and ds to bf16 before
    their products (the JAX kernels keep them in f32); its emulation
    stays within the card tests' backward tolerance (atol 4e-2, rtol
    1e-2) of the JAX gradients with the Pallas kernels in interpret mode
    at D 128, S 200 (ragged, four 64-row tiles), 4 q / 2 kv heads.  The
    share of the tolerance used is in the failure message."""
    rng = np.random.RandomState(300 + causal)
    S, Hq, group, Dh = 200, 4, 2, 128
    q = rng.randn(1, S, Hq, Dh).astype(np.float32)
    k = rng.randn(1, S, Hq // group, Dh).astype(np.float32)
    v = rng.randn(1, S, Hq // group, Dh).astype(np.float32)
    g = rng.randn(1, S, Hq, Dh).astype(np.float32)
    jq, jk, jv, jg = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g))

    def jax_flash(*args):
        return jax_fa.flash_attention(*args, causal=causal, block_q=64,
                                      block_k=64, interpret=True)

    out, vjp = jax.vjp(jax_flash, jq, jk, jv)
    want = vjp(jg)
    _, lse = jax_fa.flash_attention_with_lse(
        jq, jk, jv, causal=causal, block_q=64, block_k=64, interpret=True)
    delta = torch.einsum("bshd,bshd->bhs", torch.tensor(_np(jg)),
                         torch.tensor(_np(out)))
    got = _tensor_core_backward(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v, g)),
        torch.tensor(_np(lse)), delta, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape
        err = np.abs(a.float().numpy() - _np(b))
        used = (err / (4e-2 + 1e-2 * np.abs(_np(b)))).max()
        assert used <= 1.0, f"{name}: {used:.3f} of the tolerance"
