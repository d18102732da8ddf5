"""Paged prefill: in-place page writes, then flash attention over
[context pages || chunk].

Counterpart of ``tensorflowonspark_tpu/ops/paged_prefill.py``.  A
prefill chunk (S > 1) of B rows stores its k/v into the shared pool
``[kv_pages, page, n_kv, Dh]`` through each row's page table, then
attends its queries over the row's context pages (positions < start)
and its own k/v under the causal triangle.

Two kernels, one wrapper each, with the port's one rule: a CPU tensor
takes the plain PyTorch version (:func:`write_pages_plain`,
:func:`read_attention_plain`); a CUDA tensor launches the hand-written
kernel in ``csrc/paged_prefill.cu`` (design and bounds in its header) or
raises.  With bf16 activations the read runs on the tensor cores, over
a bf16 pool or an int8 one (whose scales fold into the products); with
f32 activations on the CUDA cores.

int8 pools (``--generate_kv_dtype int8``) keep f32 per-(token, head)
scales ``[kv_pages, page, n_kv]`` beside the payload.  The page write
quantises the chunk (:func:`kv_quantize`, bit-identical to the JAX
package's ``_kv_quantize``) and returns it dequantised to the activation
dtype; the read attends to that chunk and to the context pages, each
value payload x scale in f32 (on the tensor cores the scales multiply
the f32 products instead, and only p x v_scale rounds to bf16).  On the
card the quantisation is fused into the write kernel
(:func:`_write_pages_int8`), and the int8 launches count apart from the
float ones.

Sink-page contract (serve.ContinuousBatcher): table entries past a row's
allocation and the whole table of a pad row name a reserved garbage sink
page.  Pad rows and bucket-pad overshoot therefore write into the sink;
two rows writing it race on the card (the JAX blend sums them), and sink
bytes are garbage by contract, masked on every read.
"""
import torch

from . import _build
from .paged_attention import (NEG_INF, check_card_scales, check_scales,
                              dequantize_pages)


def kv_quantize(x):
    """``[..., Dh]`` -> (int8 payload, f32 scale ``[...]``): symmetric
    per-vector quantisation over head_dim, the int8 kv pool's storage
    form.  Bit-identical to the JAX package's ``_kv_quantize``: IEEE
    division by 127 (a tensor divisor: on the card a Python-scalar
    divisor becomes a reciprocal multiply), round half to even, clip to
    +-127, a 1e-12 floor on the scale."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-12) / torch.full_like(amax, 127.0)
    q8 = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q8.to(torch.int8), scale


def kv_dequantize(q8, scale, dtype):
    """The compute-dtype kv an int8 store stands for: payload x scale in
    f32, rounded once to ``dtype``."""
    return dequantize_pages(q8, scale).to(dtype)


def _positions(starts, S, page, max_pages):
    """(logical block, offset) of every chunk position, with the TPU
    kernel's clip: overshoot past the table parks in its last block."""
    pos = starts.long()[:, None] + torch.arange(S, device=starts.device)
    return (pos // page).clamp(0, max_pages - 1), pos % page


def write_pages_plain(k, v, pages_key, pages_value, page_table, starts,
                      key_scales=None, value_scales=None):
    """Store chunk position s of row b at ``pool[table[b, clip((start +
    s) // page)], (start + s) % page]``, in place.  Out-of-range page ids
    drop the store (a JAX scatter drops them).  With scale pools (an int8
    pool) the chunk is quantised first and its scales stored at the same
    positions.  Returns the chunk k/v as the read attends to them: the
    input, or its int8 round trip in the input's dtype."""
    B, S = k.shape[:2]
    NP, page = pages_key.shape[:2]
    blk, off = _positions(starts, S, page, page_table.shape[1])
    phys = torch.gather(page_table.long(), 1, blk)
    keep = (phys >= 0) & (phys < NP)
    rows = (phys[keep], off[keep])
    ck, cv = k, v
    if key_scales is not None:
        k, k_sc = kv_quantize(k)
        v, v_sc = kv_quantize(v)
        key_scales[rows] = k_sc[keep]
        value_scales[rows] = v_sc[keep]
        ck, cv = kv_dequantize(k, k_sc, ck.dtype), kv_dequantize(v, v_sc,
                                                                 cv.dtype)
    # in place: the JAX version donates/aliases the pool instead
    pages_key[rows] = k[keep].to(pages_key.dtype)
    pages_value[rows] = v[keep].to(pages_value.dtype)
    return ck, cv


def read_attention_plain(q, ck, cv, pages_key, pages_value, page_table,
                         starts, *, key_scales=None, value_scales=None,
                         sm_scale=None):
    """Dense version of the chunked read: one softmax over the row's
    gathered context (keys ``j < start``; an int8 pool dequantised in
    f32) and the chunk's own k/v (chunk key ``jc`` visible to query ``s``
    iff ``jc <= s``), f32 math, output in q's dtype."""
    B, S, H, Dh = q.shape
    NP, page, n_kv, _ = pages_key.shape
    max_pages = page_table.shape[1]
    L = max_pages * page
    if sm_scale is None:
        sm_scale = 1.0 / (Dh ** 0.5)
    table = page_table.long().clamp(0, NP - 1)     # gathers clip, as in JAX
    ctx_k, ctx_v = pages_key[table], pages_value[table]
    if key_scales is not None:
        ctx_k = dequantize_pages(ctx_k, key_scales[table])
        ctx_v = dequantize_pages(ctx_v, value_scales[table])
    ctx_k = ctx_k.reshape(B, L, n_kv, Dh)
    ctx_v = ctx_v.reshape(B, L, n_kv, Dh)
    kf = torch.cat([ctx_k.float(), ck.float()], dim=1)   # [B, L + S, ...]
    vf = torch.cat([ctx_v.float(), cv.float()], dim=1)
    if n_kv != H:
        kf = kf.repeat_interleave(H // n_kv, dim=2)
        vf = vf.repeat_interleave(H // n_kv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * sm_scale
    dev = q.device
    ctx_vis = (torch.arange(L, device=dev)[None, :]
               < starts.long()[:, None])                     # [B, L]
    s_idx = torch.arange(S, device=dev)
    chunk_vis = s_idx[None, :] <= s_idx[:, None]             # [S, S]
    visible = torch.cat([ctx_vis[:, None, :].expand(B, S, L),
                         chunk_vis[None].expand(B, S, S)], dim=2)
    logits = torch.where(visible[:, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(q.dtype)


def _check_card_args(q, k, pages_key, pages_value, page_table, starts,
                     key_scales, value_scales):
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_prefill: no kernel for {q.device}")
    Dh = q.shape[-1]
    if Dh not in (64, 128):
        raise NotImplementedError(
            f"paged_prefill kernels take head_dim 64 or 128, got {Dh}")
    if key_scales is not None:
        if q.dtype != k.dtype:
            raise TypeError("q and the chunk k/v must share one dtype on "
                            "the card")
        check_card_scales(key_scales, value_scales, q.device)
    elif not (pages_key.dtype == pages_value.dtype == q.dtype == k.dtype):
        raise TypeError("q, k, v and float pools must share one dtype on "
                        "the card")
    for name, t in (("pages_key", pages_key), ("pages_value", pages_value),
                    ("page_table", page_table), ("starts", starts)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _check_in_place(**pools):
    for name, pool in pools.items():
        # the store is in place: a copy of the pool would lose it
        if not pool.is_contiguous() or pool.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned for the in-place page store")


def _write_pages(k, v, pages_key, pages_value, page_table, starts):
    """In-place page store of a chunk's k/v into a float pool (kernel 2).
    CPU tensors take :func:`write_pages_plain`.  Returns ``(k, v)``."""
    if k.device.type == "cpu":
        return write_pages_plain(k, v, pages_key, pages_value, page_table,
                                 starts)
    _check_card_args(k, k, pages_key, pages_value, page_table, starts,
                     None, None)
    _check_in_place(pages_key=pages_key, pages_value=pages_value)
    B, S, n_kv, Dh = k.shape
    NP, page = pages_key.shape[:2]
    lib = _build.lib()
    k, v = _build.aligned(k), _build.aligned(v)
    table = page_table.to(torch.int32).contiguous()
    st = starts.to(torch.int32).contiguous()
    P = _build.ptr
    code = lib.tos_page_write(
        P(k), P(v), P(pages_key), P(pages_value), P(table), P(st), B, S,
        n_kv * Dh * k.element_size(), page, table.shape[1], NP,
        _build.stream_ptr(k.device))
    _build.check(code, "tos_page_write")
    _write_pages.launches += 1
    return k, v


_write_pages.launches = 0


def _write_pages_int8(k, v, pages_key, pages_value, key_scales,
                      value_scales, page_table, starts):
    """In-place quantising page store into an int8 pool and its scale
    pools (kernel 2's int8 branch).  CPU tensors take
    :func:`write_pages_plain`.  Returns the chunk's int8 round trip
    ``(ck, cv)`` in k's dtype."""
    if not check_scales(pages_key, pages_value, key_scales, value_scales):
        raise ValueError("_write_pages_int8 stores into int8 pools only")
    if k.device.type == "cpu":
        return write_pages_plain(k, v, pages_key, pages_value, page_table,
                                 starts, key_scales, value_scales)
    _check_card_args(k, k, pages_key, pages_value, page_table, starts,
                     key_scales, value_scales)
    _check_in_place(pages_key=pages_key, pages_value=pages_value)
    B, S, n_kv, Dh = k.shape
    NP, page = pages_key.shape[:2]
    lib = _build.lib()
    k, v = _build.aligned(k), _build.aligned(v)
    ck, cv = torch.empty_like(k), torch.empty_like(v)
    table = page_table.to(torch.int32).contiguous()
    st = starts.to(torch.int32).contiguous()
    P = _build.ptr
    code = lib.tos_page_write_int8(
        P(k), P(v), P(pages_key), P(pages_value), P(key_scales),
        P(value_scales), P(ck), P(cv), P(table), P(st), B, S, n_kv, Dh, page,
        table.shape[1], NP, _build.dtype_code(k), _build.stream_ptr(k.device))
    _build.check(code, "tos_page_write_int8")
    _write_pages_int8.launches += 1
    return ck, cv


_write_pages_int8.launches = 0


def _read_attention(q, ck, cv, pages_key, pages_value, page_table, starts,
                    *, key_scales=None, value_scales=None, sm_scale=None):
    """Flash attention of the chunk against [context pages || chunk]
    (kernel 3; int8 pools with their scale pools).  CPU tensors take
    :func:`read_attention_plain`."""
    quant = check_scales(pages_key, pages_value, key_scales, value_scales)
    if q.device.type == "cpu":
        return read_attention_plain(
            q, ck, cv, pages_key, pages_value, page_table, starts,
            key_scales=key_scales, value_scales=value_scales,
            sm_scale=sm_scale)
    _check_card_args(q, ck, pages_key, pages_value, page_table, starts,
                     key_scales, value_scales)
    B, S, H, Dh = q.shape
    NP, page, n_kv = pages_key.shape[:3]
    if sm_scale is None:
        sm_scale = 1.0 / (Dh ** 0.5)
    lib = _build.lib()
    q, ck, cv, pages_key, pages_value = (
        _build.aligned(t) for t in (q, ck, cv, pages_key, pages_value))
    table = page_table.to(torch.int32).contiguous()
    st = starts.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    P = _build.ptr
    scales = ((P(key_scales), P(value_scales)) if quant else (None, None))
    code = lib.tos_prefill_read(
        P(q), P(ck), P(cv), P(pages_key), P(pages_value), *scales, P(table),
        P(st), P(out), B, S, H, n_kv, Dh, page, table.shape[1], NP,
        float(sm_scale), _build.dtype_code(q), _build.dtype_code(pages_key),
        _build.stream_ptr(q.device))
    _build.check(code, "tos_prefill_read")
    (READ_INT8_LAUNCHES if quant else _read_attention).launches += 1
    return out


_read_attention.launches = 0
# launches of kernel 3's int8-pool instantiation, made by _read_attention
READ_INT8_LAUNCHES = _build.Launches()


def paged_prefill(q, k, v, pages_key, pages_value, page_table, starts, *,
                  key_scales=None, value_scales=None, sm_scale=None):
    """Chunked prefill over an in-place paged kv pool: page writes, then
    flash attention over [context pages || chunk].

    Args:
      q, k, v: ``[B, S, *, Dh]`` chunk activations (q has H heads, k/v
        the narrow n_kv); one row per admitted request, pad rows carry a
        sink page table.
      pages_key / pages_value: the pool ``[kv_pages, page, n_kv, Dh]``,
        updated IN PLACE (the JAX version aliases it through the call):
        the activation dtype, or int8 with ``key_scales``/
        ``value_scales`` ``[kv_pages, page, n_kv]`` f32, also updated in
        place (the chunk is quantised here, bit-identical to the JAX
        package's storage).
      page_table: ``[B, max_pages]`` int32; entries past a row's
        allocation MUST name the caller's sink page.
      starts: ``[B]`` int32 pre-write positions: chunk position s lands
        at ``starts + s`` and sees keys ``j <= starts + s``.

    Returns ``(out, pools)``: ``out [B, S, H, Dh]`` in q's dtype and
    ``pools = (pages_key, pages_value, key_scales, value_scales)``, the
    same (updated) tensors, in the JAX function's return layout.
    """
    B, S, H, Dh = q.shape
    NP, page, n_kv, Dh_kv = pages_key.shape
    if pages_value.shape != pages_key.shape or Dh_kv != Dh:
        raise ValueError(
            f"pool shapes {tuple(pages_key.shape)} / "
            f"{tuple(pages_value.shape)} must match and end in head_dim {Dh}")
    if k.shape != (B, S, n_kv, Dh) or v.shape != k.shape:
        raise ValueError(f"chunk k/v {tuple(k.shape)} / {tuple(v.shape)} "
                         f"must be {(B, S, n_kv, Dh)}")
    if H % n_kv:
        raise ValueError(
            f"q heads {H} must be a multiple of kv heads {n_kv} (GQA "
            "groups map onto their kv head inside the kernel)")
    if check_scales(pages_key, pages_value, key_scales, value_scales):
        ck, cv = _write_pages_int8(k, v, pages_key, pages_value, key_scales,
                                   value_scales, page_table, starts)
    else:
        ck, cv = _write_pages(k, v, pages_key, pages_value, page_table,
                              starts)
    # the read walks the post-write pool: context pages are byte-equal
    # either way, and the chunk's own keys come from the activations (an
    # int8 pool's: their round trip, as a pool read would give them)
    out = _read_attention(q, ck, cv, pages_key, pages_value, page_table,
                          starts, key_scales=key_scales,
                          value_scales=value_scales, sm_scale=sm_scale)
    return out, (pages_key, pages_value, key_scales, value_scales)
