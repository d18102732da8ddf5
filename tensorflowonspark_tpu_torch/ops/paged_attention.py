"""Paged flash-decode attention: read kv pages in place.

Counterpart of ``tensorflowonspark_tpu/ops/paged_attention.py``.  The
paged slot cache keeps kv in a shared pool ``pages_key/pages_value
[kv_pages, page, n_kv, Dh]`` with a per-row ``page_table [B,
max_pages]``; a decode step attends each row's query over the row's
occupied pages only.

Which implementation runs follows one rule: a CPU tensor takes the plain
PyTorch version (:func:`paged_attention_plain`, the port of
``paged_attention_reference``); a CUDA tensor launches the hand-written
kernel ``csrc/paged_attention.cu`` (design and bound in its header) or
raises.  The kernel writes split-K partials ``(acc, m, l)``, each split
over its share of the row's occupied pages; a second small kernel merges
them by their log-sum-exp weights (the JAX wrapper's combine) in one
launch.

int8 pools (``--generate_kv_dtype int8``) carry f32 per-(token, head)
scales ``key_scales/value_scales [kv_pages, page, n_kv]``; both versions
dequantise every value in f32 (payload x scale) before it meets q, as
the JAX kernel does.  The int8 launches count apart from the float ones
(``ops.launch_counts()["paged_attention_int8"]``).
"""
import torch

from . import _build

NEG_INF = -1e30  # large-finite: exp(NEG_INF - m) == 0 without inf-inf NaNs


def _pick_splits(requested, max_pages):
    """Largest split count <= requested that DIVIDES the page axis, as
    the TPU wrapper picks it (every split then walks the same number of
    pages)."""
    for cand in range(min(int(requested), max_pages), 1, -1):
        if max_pages % cand == 0:
            return cand
    return 1


def _check_args(q, pages_key, pages_value, page_table, lengths, key_scales,
                value_scales):
    """Validate shapes; returns whether the pool is int8."""
    B, S, H, Dh = q.shape
    NP, page, n_kv, Dh_kv = pages_key.shape
    if pages_value.shape != pages_key.shape or Dh_kv != Dh:
        raise ValueError(
            f"pool shapes {tuple(pages_key.shape)} / "
            f"{tuple(pages_value.shape)} must match and end in head_dim {Dh}")
    if H % n_kv:
        raise ValueError(
            f"q heads {H} must be a multiple of kv heads {n_kv} (GQA "
            "groups map onto their kv head inside the kernel)")
    if page_table.shape[0] != B or lengths.shape != (B,):
        raise ValueError(
            f"page_table {tuple(page_table.shape)} / lengths "
            f"{tuple(lengths.shape)} must have {B} rows")
    return check_scales(pages_key, pages_value, key_scales, value_scales)


def check_scales(pages_key, pages_value, key_scales, value_scales):
    """The JAX wrappers' int8 rules: an int8 pool needs both scale pools
    ``[kv_pages, page, n_kv]``, a float pool takes none.  Returns whether
    the pool is int8."""
    quant = pages_key.dtype == torch.int8
    if quant and (key_scales is None or value_scales is None):
        raise ValueError("int8 pools need key_scales and value_scales "
                         "[kv_pages, page, n_kv]")
    if not quant and (key_scales is not None or value_scales is not None):
        raise ValueError("scales are only meaningful for int8 pools")
    if quant:
        if pages_value.dtype != torch.int8:
            raise ValueError("pages_key is int8 but pages_value is "
                             f"{pages_value.dtype}")
        for name, sc in (("key_scales", key_scales),
                         ("value_scales", value_scales)):
            if tuple(sc.shape) != tuple(pages_key.shape[:3]):
                raise ValueError(f"{name} {tuple(sc.shape)} must be "
                                 f"{tuple(pages_key.shape[:3])}")
    return quant


def check_card_scales(key_scales, value_scales, device):
    """The kernels read the scale pools in place: f32, contiguous, on the
    pool's card."""
    for name, sc in (("key_scales", key_scales),
                     ("value_scales", value_scales)):
        if sc.dtype != torch.float32 or not sc.is_contiguous():
            raise TypeError(f"{name} must be a contiguous float32 tensor on "
                            f"the card, got {sc.dtype}")
        if sc.device != device:
            raise ValueError(f"{name} is on {sc.device}, q on {device}")


def dequantize_pages(pages, scales):
    """An int8 pool (or a gather of it) in f32: payload x its scale."""
    return pages.float() * scales[..., None]


def paged_attention_plain(q, pages_key, pages_value, page_table, lengths, *,
                          key_scales=None, value_scales=None, sm_scale=None):
    """Dense gather version with the kernel's exact semantics (f32
    softmax, large-finite mask, lengths-relative visibility, int8 pools
    dequantised in f32): query s of row b sees key j iff ``j <=
    lengths[b] - S + s``; rows with ``lengths == 0`` return zeros.
    Returns ``[B, S, H, Dh]`` in q's dtype."""
    B, S, H, Dh = q.shape
    NP, page, n_kv, _ = pages_key.shape
    max_pages = page_table.shape[1]
    L = max_pages * page
    if sm_scale is None:
        sm_scale = 1.0 / (Dh ** 0.5)
    table = page_table.long().clamp(0, NP - 1)     # gathers clip, as in JAX
    kf, vf = pages_key[table], pages_value[table]
    if key_scales is not None:
        kf = dequantize_pages(kf, key_scales[table])
        vf = dequantize_pages(vf, value_scales[table])
    kf = kf.reshape(B, L, n_kv, Dh).float()
    vf = vf.reshape(B, L, n_kv, Dh).float()
    if n_kv != H:
        kf = kf.repeat_interleave(H // n_kv, dim=2)
        vf = vf.repeat_interleave(H // n_kv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * sm_scale
    idx = lengths.long() - S
    keys = torch.arange(L, device=q.device)
    visible = keys[None, None, :] <= (
        idx[:, None, None] + torch.arange(S, device=q.device)[None, :, None])
    logits = torch.where(visible[:, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    out = torch.where((lengths > 0)[:, None, None, None], out,
                      torch.zeros_like(out))
    return out.to(q.dtype)


def paged_attention(q, pages_key, pages_value, page_table, lengths, *,
                    key_scales=None, value_scales=None, sm_scale=None,
                    k_splits=8):
    """Flash-decode attention over an in-place paged kv pool.

    Args:
      q: ``[B, S, H, Dh]`` query chunk (S=1 decode steps; any S >= 1).
      pages_key / pages_value: the pool, ``[kv_pages, page, n_kv, Dh]``
        in q's dtype (float32 or bfloat16 on the card), or int8 with
        ``key_scales``/``value_scales`` ``[kv_pages, page, n_kv]`` f32.
      page_table: ``[B, max_pages]`` int32 physical page per logical
        block; entries past a row's length are never read.
      lengths: ``[B]`` int32 tokens WRITTEN per row, including the current
        chunk; query s sees key j iff ``j <= lengths - S + s``.
      k_splits: target split-K parallelism over the page axis (clamped to
        a divisor of max_pages).

    Returns ``[B, S, H, Dh]`` in q's dtype.  CPU tensors take
    :func:`paged_attention_plain`; CUDA tensors launch the kernel.
    """
    quant = _check_args(q, pages_key, pages_value, page_table, lengths,
                        key_scales, value_scales)
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, pages_key, pages_value, page_table, lengths,
            key_scales=key_scales, value_scales=value_scales,
            sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_attention: no kernel for {q.device}")
    Dh = q.shape[-1]
    if Dh not in (64, 128):
        raise NotImplementedError(
            f"paged_attention kernel takes head_dim 64 or 128, got {Dh}")
    if quant:
        check_card_scales(key_scales, value_scales, q.device)
    elif not (pages_key.dtype == pages_value.dtype == q.dtype):
        raise TypeError("q and float pools must share one dtype on the card")
    for name, t in (("pages_key", pages_key), ("pages_value", pages_value),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    parts = _split_partials(q, pages_key, pages_value, page_table, lengths,
                            key_scales=key_scales, value_scales=value_scales,
                            sm_scale=sm_scale, k_splits=k_splits)
    out = _combine_splits(q, *parts)
    (INT8_LAUNCHES if quant else paged_attention).launches += 1
    return out


paged_attention.launches = 0
# launches of the int8-pool instantiation, made by paged_attention
INT8_LAUNCHES = _build.Launches()


def _split_partials(q, pages_key, pages_value, page_table, lengths, *,
                    key_scales=None, value_scales=None, sm_scale=None,
                    k_splits=8):
    """The decode kernel's launch (card tensors, checked by
    :func:`paged_attention`): each split's unnormalised ``(acc, m, l)``
    over its span of the row's occupied pages, f32 ``[B, n_kv, n_splits,
    S * group(, Dh)]``."""
    B, S, H, Dh = q.shape
    NP, page, n_kv, _ = pages_key.shape
    max_pages = page_table.shape[1]
    quant = key_scales is not None
    if sm_scale is None:
        sm_scale = 1.0 / (Dh ** 0.5)
    lib = _build.lib()
    q, pages_key, pages_value = (_build.aligned(t)
                                 for t in (q, pages_key, pages_value))
    table = page_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    rows = S * (H // n_kv)
    n_splits = _pick_splits(k_splits, max_pages)
    acc = torch.empty((B, n_kv, n_splits, rows, Dh), dtype=torch.float32,
                      device=q.device)
    m = torch.empty((B, n_kv, n_splits, rows), dtype=torch.float32,
                    device=q.device)
    l = torch.empty_like(m)
    P = _build.ptr
    scales = ((P(key_scales), P(value_scales)) if quant else (None, None))
    code = lib.tos_paged_decode(
        P(q), P(pages_key), P(pages_value), *scales, P(table), P(lens),
        P(acc), P(m), P(l), B, S, H, n_kv, Dh, page, max_pages, NP, n_splits,
        float(sm_scale), _build.dtype_code(q), _build.dtype_code(pages_key),
        _build.stream_ptr(q.device))
    _build.check(code, "tos_paged_decode")
    return acc, m, l


def _combine_splits(q, acc, m, l):
    """The combine kernel's launch: the splits' partials merged by their
    log-sum-exp weights in split order, ``[B, S, H, Dh]`` in q's dtype;
    rows with no visible key (lengths == 0) come out as exact zeros."""
    B, S, H, Dh = q.shape
    n_kv, n_splits = acc.shape[1], acc.shape[2]
    out = torch.empty((B, S, H, Dh), dtype=q.dtype, device=q.device)
    P = _build.ptr
    code = _build.lib().tos_paged_decode_combine(
        P(acc), P(m), P(l), P(out), B, S, H, n_kv, Dh, n_splits,
        _build.dtype_code(q), _build.stream_ptr(q.device))
    _build.check(code, "tos_paged_decode_combine")
    return out
