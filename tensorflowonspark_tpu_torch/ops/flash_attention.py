"""Flash attention, forward and blocked backward (kernels 4-6).

Counterpart of ``tensorflowonspark_tpu/ops/flash_attention.py``:
attention over ``[B, S, H, D]`` queries and narrow GQA ``[B, S, H_kv,
D]`` keys/values (``H_kv`` any divisor of ``H``), with an online softmax
in the forward and a recompute-P backward, so the ``[S, S]`` score matrix
never lands in device memory on the card.

:func:`flash_attention` is a ``torch.autograd.Function``, as the JAX
function is a ``custom_vjp``: the forward without grad writes no LSE; the
forward with grad saves ``(q, k, v, out, lse)``; the backward computes
``delta = rowsum(dO * O)`` in f32 as plain torch (the JAX package does it
outside its kernels too), then runs the dq kernel and the narrow dk/dv
kernel.  :func:`flash_attention_with_lse` also returns the per-row
logsumexp, differentiably: its cotangent folds into ``delta``
(``delta -= g_lse``) before the same two kernels.

Three kernels, one wrapper each (:func:`flash_fwd`, :func:`flash_bwd_dq`,
:func:`flash_bwd_dkv`), with the port's one rule: a CPU tensor takes the
plain PyTorch version (:func:`flash_fwd_plain`, :func:`flash_bwd_dq_plain`,
:func:`flash_bwd_dkv_plain`); a CUDA tensor launches the hand-written
kernel in ``csrc/flash_attention.cu`` (design and bound in its header) or
raises.  The kernels take head_dim 64 or 128, in f32 or bf16; in bf16 all
three run on the tensor cores, in f32 on the CUDA cores.  The C entries
refuse rows that are not 16-byte aligned; the wrappers hand them an
aligned copy of a misaligned view.  Their card tests alone, with the
prefill read's: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py -k "flash or prefill"``.

The JAX function's ``block_q`` / ``block_k`` are not in the signature:
they size the TPU grid and its VMEM tiles (``_pick_block``), while the
CUDA kernels use fixed tiles sized for shared memory (64 x 64 in bf16,
64 x 32 in f32), and the plain versions have no tiles
at all.  Queries and keys share one sequence length, as the JAX
kernels' masks assume.
"""
import torch

from . import _build

NEG_INF = -1e30  # large-finite: exp(NEG_INF - m) == 0 without inf-inf NaNs


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} must be [B, S, H, D] and k/v "
                         f"{tuple(k.shape)} / {tuple(v.shape)} [B, S, H_kv, D]")
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"q heads {q.shape[2]} must be a multiple of kv heads "
            f"{k.shape[2]} (GQA: narrow k/v feed the kernel directly; "
            "no repeat needed)")
    if (k.shape[0], k.shape[1], k.shape[3]) != (q.shape[0], q.shape[1],
                                                q.shape[3]):
        raise ValueError(f"k/v {tuple(k.shape)} must share batch, sequence "
                         f"and head_dim with q {tuple(q.shape)}")


def _scale(q, sm_scale):
    return 1.0 / (q.shape[-1] ** 0.5) if sm_scale is None else float(sm_scale)


def _wide(x, H):
    """Narrow kv heads repeated to H heads, in f32."""
    x = x.float()
    return x if x.shape[2] == H else x.repeat_interleave(H // x.shape[2], 2)


def _narrow(x, H_kv):
    """Per-q-head cotangents summed over each kv head's group."""
    B, S, H, D = x.shape
    return x if H == H_kv else x.reshape(B, S, H_kv, H // H_kv, D).sum(3)


def _probs_inputs(q, k, causal, sm_scale):
    """Masked f32 scores ``[B, H, S, S]`` and the full-head f32 keys."""
    kf = _wide(k, q.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * sm_scale
    if causal:
        S = q.shape[1]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s, kf


def flash_fwd_plain(q, k, v, causal=True, sm_scale=None):
    """Plain version of kernel 4: ``(out, lse)`` with the kernel's
    semantics (f32 softmax, large-finite mask, ``l`` clamped at 1e-30,
    lse 0 for a row that sees no key); out in q's dtype, lse f32
    ``[B, H, S]``."""
    sm_scale = _scale(q, sm_scale)
    s, _ = _probs_inputs(q, k, causal, sm_scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, _wide(v, q.shape[2]))
    out = (out / l.permute(0, 2, 1, 3)).to(q.dtype)
    lse = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m + torch.log(l))
    return out, lse[..., 0]


def _dscores(q, k, v, do, lse, delta, causal, sm_scale):
    s, kf = _probs_inputs(q, k, causal, sm_scale)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), _wide(v, q.shape[2]))
    return p, p * (dp - delta[..., None]), kf


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=True, sm_scale=None):
    """Plain version of kernel 5: ``dq = scale * sum_k p (dp - delta) k``
    with ``p = exp(s * scale - lse)`` and ``dp = dO . v``; dq in q's
    dtype."""
    sm_scale = _scale(q, sm_scale)
    _, ds, kf = _dscores(q, k, v, do, lse, delta, causal, sm_scale)
    return (sm_scale * torch.einsum("bhqk,bkhd->bqhd", ds, kf)).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=True, sm_scale=None):
    """Plain version of kernel 6: ``dv = sum_q p^T dO`` and ``dk = scale
    * sum_q ds^T q``, summed over each kv head's group of q heads
    (narrow); dk/dv in k's dtype."""
    sm_scale = _scale(q, sm_scale)
    p, ds, _ = _dscores(q, k, v, do, lse, delta, causal, sm_scale)
    H_kv = k.shape[2]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = sm_scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return _narrow(dk, H_kv).to(k.dtype), _narrow(dv, H_kv).to(v.dtype)


def attention_reference(q, k, v, causal=True, sm_scale=None):
    """Dense reference with the kernel's semantics (f32 softmax,
    large-finite mask; probabilities cast to q's dtype before the value
    product, as the JAX reference does).  Narrow k/v are repeated."""
    sm_scale = _scale(q, sm_scale)
    H = q.shape[2]
    if k.shape[2] != H:
        k = k.repeat_interleave(H // k.shape[2], 2)
        v = v.repeat_interleave(H // v.shape[2], 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * sm_scale
    if causal:
        S = q.shape[1]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)


def _card_args(*tensors):
    """Check the tensors for the kernels and return them contiguous and
    16-byte aligned (a misaligned view runs on an aligned copy)."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for {q.device}")
    D = q.shape[-1]
    if D not in (64, 128):
        raise NotImplementedError(
            f"the flash-attention kernels take head_dim 64 or 128, got {D}")
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"a tensor is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError("q, k, v and dO must share one dtype on the card")
    _build.dtype_code(q)
    return [_build.aligned(t) for t in tensors]


def _rows(t, name, shape):
    if tuple(t.shape) != shape or t.dtype != torch.float32:
        raise ValueError(f"{name} must be f32 {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def flash_fwd(q, k, v, causal=True, sm_scale=None, need_lse=True):
    """Forward of kernel 4: ``(out, lse)``, lse f32 ``[B, H, S]`` or None
    when ``need_lse`` is False (the kernel then writes none).  CPU tensors
    take :func:`flash_fwd_plain`."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        out, lse = flash_fwd_plain(q, k, v, causal, sm_scale)
        return out, (lse if need_lse else None)
    q, k, v = _card_args(q, k, v)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if need_lse else None)
    P = _build.ptr
    code = _build.lib().tos_flash_fwd(
        P(q), P(k), P(v), P(out), P(lse) if need_lse else None, B, S, H,
        k.shape[2], D, _scale(q, sm_scale), int(causal), _build.dtype_code(q),
        _build.stream_ptr(q.device))
    _build.check(code, "tos_flash_fwd")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_bwd_dq(q, k, v, do, lse, delta, causal=True, sm_scale=None):
    """dq of kernel 5.  CPU tensors take :func:`flash_bwd_dq_plain`."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, sm_scale)
    q, k, v, do = _card_args(q, k, v, do)
    B, S, H, D = q.shape
    lse = _rows(lse, "lse", (B, H, S))
    delta = _rows(delta, "delta", (B, H, S))
    dq = torch.empty_like(q)
    P = _build.ptr
    code = _build.lib().tos_flash_bwd_dq(
        P(q), P(k), P(v), P(do), P(lse), P(delta), P(dq), B, S, H,
        k.shape[2], D, _scale(q, sm_scale), int(causal), _build.dtype_code(q),
        _build.stream_ptr(q.device))
    _build.check(code, "tos_flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, sm_scale=None):
    """Narrow ``(dk, dv)`` of kernel 6.  CPU tensors take
    :func:`flash_bwd_dkv_plain`."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, sm_scale)
    q, k, v, do = _card_args(q, k, v, do)
    B, S, H, D = q.shape
    lse = _rows(lse, "lse", (B, H, S))
    delta = _rows(delta, "delta", (B, H, S))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    P = _build.ptr
    code = _build.lib().tos_flash_bwd_dkv(
        P(q), P(k), P(v), P(do), P(lse), P(delta), P(dk), P(dv), B, S, H,
        k.shape[2], D, _scale(q, sm_scale), int(causal), _build.dtype_code(q),
        _build.stream_ptr(q.device))
    _build.check(code, "tos_flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def _flash_backward(ctx, g, g_lse):
    """dq, dk, dv of the saved forward for the cotangents of out (``g``)
    and of lse (``g_lse``); either may be None (zero)."""
    q, k, v, out, lse = ctx.saved_tensors
    # autograd may hand over a strided cotangent
    g = torch.zeros_like(out) if g is None else g.contiguous()
    # delta = rowsum(dO * O): [B, H, S], f32, outside the kernels
    delta = torch.einsum("bshd,bshd->bhs", g.float(), out.float())
    if g_lse is not None:
        # ds_ij = p_ij (dp_ij - delta_i + g_lse_i), since dlse_i/ds_ij =
        # p_ij: an lse cotangent folds exactly into delta
        delta = delta - g_lse.float()
    dq = flash_bwd_dq(q, k, v, g, lse, delta, ctx.causal, ctx.sm_scale)
    dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, ctx.causal, ctx.sm_scale)
    return dq, dk, dv, None, None


class _Flash(torch.autograd.Function):
    """The JAX ``custom_vjp``: forward with LSE saved, backward through
    the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_fwd(q, k, v, causal, sm_scale, need_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        return _flash_backward(ctx, g, None)


class _FlashLSE(torch.autograd.Function):
    """The JAX ``_flash_lse`` custom_vjp: ``(out, lse)`` out, the lse
    cotangent folded into delta in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_fwd(q, k, v, causal, sm_scale, need_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        # an unused output's cotangent arrives as None, not as zeros
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        return _flash_backward(ctx, g, g_lse)


def flash_attention_with_lse(q, k, v, causal=True, sm_scale=None):
    """:func:`flash_attention` that also returns the per-row logsumexp,
    f32 ``[B, H, S]`` (0 for a row that sees no key): the merge key for
    attention computed over key/value blocks (ring attention's per-step
    compute).  Differentiable in q, k and v through both outputs."""
    _check_shapes(q, k, v)
    sm_scale = _scale(q, sm_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashLSE.apply(q, k, v, causal, sm_scale)
    return flash_fwd(q, k, v, causal, sm_scale, need_lse=True)


def flash_attention(q, k, v, causal=True, sm_scale=None):
    """Flash attention over ``[B, S, H, D]`` q and ``[B, S, H_kv, D]`` k/v.

    GQA-native: ``H_kv`` may be any divisor of ``H``; the kernels index
    narrow k/v per q-head group, so repeated k/v (and the repeat's summed
    cotangent) never materialise on the card.  Sequence lengths need not
    be multiples of the kernels' tiles.  Differentiable in q, k and v;
    without grad the forward writes no LSE."""
    _check_shapes(q, k, v)
    sm_scale = _scale(q, sm_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, causal, sm_scale)
    out, _ = flash_fwd(q, k, v, causal, sm_scale, need_lse=False)
    return out
