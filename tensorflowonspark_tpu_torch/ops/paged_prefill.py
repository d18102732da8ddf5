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
raises.

Sink-page contract (serve.ContinuousBatcher): table entries past a row's
allocation and the whole table of a pad row name a reserved garbage sink
page.  Pad rows and bucket-pad overshoot therefore write into the sink;
two rows writing it race on the card (the JAX blend sums them), and sink
bytes are garbage by contract, masked on every read.
"""
import torch

from . import _build
from .paged_attention import NEG_INF, _aligned


def _positions(starts, S, page, max_pages):
    """(logical block, offset) of every chunk position, with the TPU
    kernel's clip: overshoot past the table parks in its last block."""
    pos = starts.long()[:, None] + torch.arange(S, device=starts.device)
    return (pos // page).clamp(0, max_pages - 1), pos % page


def write_pages_plain(k, v, pages_key, pages_value, page_table, starts):
    """Store chunk position s of row b at ``pool[table[b, clip((start +
    s) // page)], (start + s) % page]``, in place.  Out-of-range page ids
    drop the store (a JAX scatter drops them)."""
    B, S = k.shape[:2]
    NP, page = pages_key.shape[:2]
    blk, off = _positions(starts, S, page, page_table.shape[1])
    phys = torch.gather(page_table.long(), 1, blk)
    keep = (phys >= 0) & (phys < NP)
    # in place: the JAX version donates/aliases the pool instead
    pages_key[phys[keep], off[keep]] = k[keep].to(pages_key.dtype)
    pages_value[phys[keep], off[keep]] = v[keep].to(pages_value.dtype)


def read_attention_plain(q, ck, cv, pages_key, pages_value, page_table,
                         starts, *, sm_scale=None):
    """Dense version of the chunked read: one softmax over the row's
    gathered context (keys ``j < start``) and the chunk's own k/v (chunk
    key ``jc`` visible to query ``s`` iff ``jc <= s``), f32 math, output
    in q's dtype."""
    B, S, H, Dh = q.shape
    NP, page, n_kv, _ = pages_key.shape
    max_pages = page_table.shape[1]
    L = max_pages * page
    if sm_scale is None:
        sm_scale = 1.0 / (Dh ** 0.5)
    table = page_table.long().clamp(0, NP - 1)     # gathers clip, as in JAX
    ctx_k = pages_key[table].reshape(B, L, n_kv, Dh)
    ctx_v = pages_value[table].reshape(B, L, n_kv, Dh)
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


def _check_card_args(q, k, pages_key, pages_value, page_table, starts):
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_prefill: no kernel for {q.device}")
    Dh = q.shape[-1]
    if Dh not in (64, 128):
        raise NotImplementedError(
            f"paged_prefill kernels take head_dim 64 or 128, got {Dh}")
    if not (pages_key.dtype == pages_value.dtype == q.dtype == k.dtype):
        raise TypeError("q, k, v and the pools must share one dtype on the "
                        "card")
    for name, t in (("pages_key", pages_key), ("pages_value", pages_value),
                    ("page_table", page_table), ("starts", starts)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _write_pages(k, v, pages_key, pages_value, page_table, starts):
    """In-place page store of a chunk's k/v (kernel 2).  CPU tensors take
    :func:`write_pages_plain`."""
    if k.device.type == "cpu":
        write_pages_plain(k, v, pages_key, pages_value, page_table, starts)
        return
    _check_card_args(k, k, pages_key, pages_value, page_table, starts)
    for name, pool in (("pages_key", pages_key), ("pages_value", pages_value)):
        # the store is in place: a copy of the pool would lose it
        if not pool.is_contiguous() or pool.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned for the in-place page store")
    B, S, n_kv, Dh = k.shape
    NP, page = pages_key.shape[:2]
    lib = _build.lib()
    k, v = _aligned(k), _aligned(v)
    table = page_table.to(torch.int32).contiguous()
    st = starts.to(torch.int32).contiguous()
    P = _build.ptr
    code = lib.tos_page_write(
        P(k), P(v), P(pages_key), P(pages_value), P(table), P(st), B, S,
        n_kv * Dh * k.element_size(), page, table.shape[1], NP,
        _build.stream_ptr(k.device))
    _build.check(code, "tos_page_write")
    _write_pages.launches += 1


_write_pages.launches = 0


def _read_attention(q, ck, cv, pages_key, pages_value, page_table, starts,
                    *, sm_scale=None):
    """Flash attention of the chunk against [context pages || chunk]
    (kernel 3).  CPU tensors take :func:`read_attention_plain`."""
    if q.device.type == "cpu":
        return read_attention_plain(q, ck, cv, pages_key, pages_value,
                                    page_table, starts, sm_scale=sm_scale)
    _check_card_args(q, ck, pages_key, pages_value, page_table, starts)
    B, S, H, Dh = q.shape
    NP, page, n_kv = pages_key.shape[:3]
    if sm_scale is None:
        sm_scale = 1.0 / (Dh ** 0.5)
    lib = _build.lib()
    q, ck, cv = _aligned(q), _aligned(ck), _aligned(cv)
    pages_key, pages_value = _aligned(pages_key), _aligned(pages_value)
    table = page_table.to(torch.int32).contiguous()
    st = starts.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    P = _build.ptr
    code = lib.tos_prefill_read(
        P(q), P(ck), P(cv), P(pages_key), P(pages_value), P(table), P(st),
        P(out), B, S, H, n_kv, Dh, page, table.shape[1], NP, float(sm_scale),
        _build.dtype_code(q), _build.stream_ptr(q.device))
    _build.check(code, "tos_prefill_read")
    _read_attention.launches += 1
    return out


_read_attention.launches = 0


def paged_prefill(q, k, v, pages_key, pages_value, page_table, starts, *,
                  key_scales=None, value_scales=None, sm_scale=None):
    """Chunked prefill over an in-place paged kv pool: page writes, then
    flash attention over [context pages || chunk].

    Args:
      q, k, v: ``[B, S, *, Dh]`` chunk activations (q has H heads, k/v
        the narrow n_kv); one row per admitted request, pad rows carry a
        sink page table.
      pages_key / pages_value: the pool ``[kv_pages, page, n_kv, Dh]``,
        updated IN PLACE (the JAX version aliases it through the call).
      page_table: ``[B, max_pages]`` int32; entries past a row's
        allocation MUST name the caller's sink page.
      starts: ``[B]`` int32 pre-write positions: chunk position s lands
        at ``starts + s`` and sees keys ``j <= starts + s``.

    Returns ``(out, pools)``: ``out [B, S, H, Dh]`` in q's dtype and
    ``pools = (pages_key, pages_value, None, None)``, the same (updated)
    tensors, in the JAX function's return layout.
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
    if (pages_key.dtype == torch.int8 or key_scales is not None
            or value_scales is not None):
        raise NotImplementedError(
            "int8 kv pools are not ported yet (ROADMAP: int8 kv branch of "
            "kernels 1-3)")
    _write_pages(k, v, pages_key, pages_value, page_table, starts)
    # the read walks the post-write pool: context pages are byte-equal
    # either way, and the chunk's own keys come from the activations
    out = _read_attention(q, k, v, pages_key, pages_value, page_table,
                          starts, sm_scale=sm_scale)
    return out, (pages_key, pages_value, None, None)
