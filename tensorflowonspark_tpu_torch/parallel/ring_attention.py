"""Ring attention — counterpart of ``tensorflowonspark_tpu/parallel/
ring_attention.py``: exact attention over sequence blocks, one a rank
along a mesh axis, with the k/v blocks passed around the ring
(:func:`~.collectives.ring_shift`, the ``lax.ppermute`` by +1; its
backward sends the gradients the reverse way).

At step ``s`` a rank holds the k/v block of axis index ``(i - s) mod N``
and merges its queries' attention over it into a running result.  Two
local paths, as in the JAX module:

- ``use_flash=True``: each step runs kernel 4 through
  ``ops.flash_attention_with_lse`` (kernels 5 and 6 in the backward, the
  lse cotangent included) and the blocks merge by their logsumexp
  (:func:`merge_block`, JAX's ``m_safe`` / ``alpha`` / ``w`` code).
  Under causal masking a past block runs non-causal, the diagonal block
  causal, and a future block is skipped: weight 0 and lse -inf, never
  through the kernel (whose lse is 0 for a row that sees no key);
- ``use_flash=False``: the plain online-softmax update
  (:func:`_online_update`), the reference semantics.

GQA k/v travel the ring narrow.  Causal work is uneven, as in JAX: the
rank at axis index ``i`` computes ``i + 1`` blocks.  :func:`ring_merge`
is the merge over any sequence of blocks, so one process can drive it
over a whole sequence's blocks (chip_smoke phase 14).
"""
import math

import torch

from tensorflowonspark_tpu_torch.ops.flash_attention import (
    flash_attention_with_lse)
from tensorflowonspark_tpu_torch.parallel import collectives as coll
from tensorflowonspark_tpu_torch.parallel.mesh import active_mesh


def _online_update(o, m, l, logits, v_blk):
    """One block's contribution via streaming softmax.

    o: [B, Sq, H, D] accumulated (unnormalized) output, f32
    m: [B, H, Sq]    running max
    l: [B, H, Sq]    running denominator
    logits: [B, H, Sq, Sk] this block's scores (f32, already masked)
    """
    m_blk = logits.amax(-1)
    m_new = torch.maximum(m, m_blk)
    alpha = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l_new = l * alpha + p.sum(-1)
    o_new = o * alpha.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p.to(v_blk.dtype), v_blk).float()
    return o_new, m_new, l_new


def _kv_repeat(q, k_blk, v_blk):
    """Broadcast narrow (GQA) k/v heads to the query head count, after
    the exchange moved only the narrow tensors."""
    H, H_kv = q.shape[2], k_blk.shape[2]
    if H == H_kv:
        return k_blk, v_blk
    if H % H_kv:
        raise ValueError(f"q heads {H} must be divisible by kv heads {H_kv}")
    rep = H // H_kv
    return (k_blk.repeat_interleave(rep, dim=2),
            v_blk.repeat_interleave(rep, dim=2))


def merge_block(o, m, l, out_blk, lse_blk):
    """Merge one block's ``(out_blk, lse_blk)`` (``out_blk`` normalised
    within the block, carrying weight ``exp(lse_blk)``) into the running
    ``(o, m, l)``: f32 ``o [B, Sq, H, D]``, ``m`` / ``l [B, H, Sq]``."""
    m_new = torch.maximum(m, lse_blk)
    m_safe = torch.where(torch.isfinite(m_new), m_new,
                         torch.zeros_like(m_new))
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                        torch.zeros_like(m))
    w = torch.where(torch.isfinite(lse_blk), torch.exp(lse_blk - m_safe),
                    torch.zeros_like(lse_blk))
    o = (o * alpha.transpose(1, 2)[..., None]
         + out_blk.float() * w.transpose(1, 2)[..., None])
    return o, m_new, l * alpha + w


def block_attention(q, k_blk, v_blk, blk_idx, my_idx, causal):
    """One step's ``(out_blk, lse_blk)`` through kernel 4: a past block
    non-causal, the diagonal block causal, a future block skipped
    (zeros, lse -inf) without a launch."""
    if causal and blk_idx > my_idx:
        B, Sq, H, _ = q.shape
        return (torch.zeros_like(q),
                torch.full((B, H, Sq), -math.inf, dtype=torch.float32,
                           device=q.device))
    return flash_attention_with_lse(q, k_blk, v_blk,
                                    causal=causal and blk_idx == my_idx)


def ring_merge(q, blocks, my_idx, causal, use_flash=True):
    """Exact attention of the query block ``q`` (axis index ``my_idx``)
    over ``blocks``, an iterable of ``(blk_idx, k_blk, v_blk)`` that
    covers every k/v block once: the kernel path merges by lse
    (:func:`merge_block`), the plain path by the online update."""
    B, Sq, H, D = q.shape
    o = torch.zeros((B, Sq, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(D)
    for blk_idx, k_blk, v_blk in blocks:
        if use_flash:
            out_blk, lse_blk = block_attention(q, k_blk, v_blk, blk_idx,
                                               my_idx, causal)
            o, m, l = merge_block(o, m, l, out_blk, lse_blk)
            continue
        k_use, v_use = _kv_repeat(q, k_blk, v_blk)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k_use).float() * scale
        if causal:
            Sk = k_blk.shape[1]
            q_pos = my_idx * Sq + torch.arange(Sq, device=q.device)
            k_pos = blk_idx * Sk + torch.arange(Sk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(mask[None, None], logits,
                                 torch.full_like(logits, -1e30))
        o, m, l = _online_update(o, m, l, logits, v_use)
    out = o / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ring_local(q, k, v, group, causal=True, use_flash=True):
    """The ring over ``group`` (a :class:`~.collectives.AxisGroup`):
    ``q`` / ``k`` / ``v`` are this rank's sequence blocks; the k/v blocks
    move one rank forward a step."""
    last = [k, v]

    def blocks():
        k_blk, v_blk = k, v
        for step in range(group.size):
            yield (group.index - step) % group.size, k_blk, v_blk
            if step + 1 < group.size:
                k_blk, v_blk = coll.ring_shift((k_blk, v_blk), group)
                last[:] = k_blk, v_blk

    out = ring_merge(q, blocks(), group.index, causal, use_flash)
    # a causal rank skips the blocks after its own, but every exchange's
    # backward must run on every rank: the last block (downstream of all
    # of them) is tied to the output
    return coll.anchor(out, *last) if group.size > 1 else out


def ring_attention(q, k, v, axis_name="tp", causal=True, mesh=None,
                   use_flash=True):
    """Exact attention with q/k/v ``[B, S_local, H, D]`` this rank's
    sequence blocks along ``axis_name`` of ``mesh`` (default: the active
    mesh, ``parallel.mesh.use_mesh``; none: the whole sequence here)."""
    mesh = mesh if mesh is not None else active_mesh()
    return ring_local(q, k, v, coll.axis_group(mesh, axis_name), causal,
                      use_flash)
