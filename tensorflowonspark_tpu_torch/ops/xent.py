"""Fused unembedding + softmax cross entropy for LM training —
counterpart of ``tensorflowonspark_tpu/ops/xent.py``.

:func:`fused_unembed_xent` takes the hidden states BEFORE the
unembedding and the ``lm_head`` weight and computes the mean loss over
token chunks: each chunk's ``[chunk, V]`` logits live only while that
chunk is reduced (f32 logsumexp minus the gold logit), and the backward
recomputes them chunk by chunk as ``softmax - onehot`` instead of
saving them.  The ``[B, S, V]`` f32 logits of :func:`models.transformer.
lm_loss` never exist, in either pass: this is a memory feature (the JAX
package measured step time at parity).  Peak extra memory is one
``[chunk, V]`` f32 tile and the f32 weight-gradient accumulator.

The JAX op is a ``lax.scan`` of plain dots with a ``custom_vjp``, not a
Pallas kernel, so this is plain PyTorch: a ``torch.autograd.Function``
over a Python loop.  The weight is the port's ``lm_head.weight``
``[V, D]`` (flax's kernel ``[D, V]`` transposed, as ``convert`` stores
every Dense).  A chunk's logits come from a product in the hidden
states' dtype, taken to f32; the weight gradient accumulates in f32,
from the f32 hidden states, as JAX's does.

Vocabulary-split (tp) heads keep ``lm_loss``: this op gathers gold
logits by target id over a whole vocabulary.
"""
import torch


def _chunks(hidden, targets, chunk_size, ignore_id):
    """Flat ``[T, D]`` hidden and ``[T]`` targets, padded with
    ``ignore_id`` rows to whole chunks: ``(h, t, n_chunks)``."""
    D = hidden.shape[-1]
    h = hidden.reshape(-1, D)
    t = targets.reshape(-1)
    T = h.shape[0]
    n = -(-T // chunk_size)
    pad = n * chunk_size - T
    if pad:
        h = torch.cat([h, h.new_zeros(pad, D)])
        t = torch.cat([t, t.new_full((pad,), ignore_id)])
    return h, t, n


def _chunk_logits(h, weight):
    return torch.matmul(h, weight.to(h.dtype).t()).float()


class _FusedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight, targets, chunk_size, ignore_id):
        h, t, n = _chunks(hidden, targets, chunk_size, ignore_id)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        count = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(n):
            rows = slice(i * chunk_size, (i + 1) * chunk_size)
            tc = t[rows]
            mask = (tc != ignore_id).float()
            logits = _chunk_logits(h[rows], weight)
            gold = logits.gather(1, tc.clamp_min(0).long()[:, None])[:, 0]
            total = total + torch.sum(
                (torch.logsumexp(logits, dim=-1) - gold) * mask)
            count = count + mask.sum()
        count = torch.clamp_min(count, 1.0)
        ctx.save_for_backward(hidden, weight, targets, count)
        ctx.chunk_size, ctx.ignore_id = chunk_size, ignore_id
        return total / count

    @staticmethod
    def backward(ctx, g):
        hidden, weight, targets, count = ctx.saved_tensors
        cs, ignore_id = ctx.chunk_size, ctx.ignore_id
        h, t, n = _chunks(hidden, targets, cs, ignore_id)
        scale = g / count
        dh = torch.empty_like(h)
        dw = torch.zeros(weight.shape, dtype=torch.float32,
                         device=weight.device)
        for i in range(n):
            rows = slice(i * cs, (i + 1) * cs)
            tc = t[rows]
            mask = (tc != ignore_id).float()
            # d/dlogits of (logz - gold) = softmax - onehot
            d = torch.softmax(_chunk_logits(h[rows], weight), dim=-1)
            d.scatter_add_(1, tc.clamp_min(0).long()[:, None],
                           -torch.ones_like(d[:, :1]))
            d = d * (mask * scale)[:, None]
            dh[rows] = torch.matmul(d.to(weight.dtype), weight).to(dh.dtype)
            dw += torch.matmul(d.t(), h[rows].float())
        T = hidden.numel() // hidden.shape[-1]
        return (dh[:T].reshape(hidden.shape), dw.to(weight.dtype), None,
                None, None)


def fused_unembed_xent(hidden, weight, targets, chunk_size=512,
                       ignore_id=-1):
    """Mean softmax cross entropy of ``hidden @ weight.T`` against
    ``targets`` without forming the logits.

    hidden:  ``[B, S, D]`` (``Transformer(..., return_hidden=True)``)
    weight:  ``[V, D]``, the ``lm_head.weight``
    targets: ``[B, S]`` int ids; positions equal to ``ignore_id`` are
             masked out of the mean
    chunk_size: tokens a chunk (the last one padded with ignored rows)

    Matches ``lm_loss(model(tokens), targets)`` to f32 tolerance."""
    return _FusedXent.apply(hidden, weight, targets, int(chunk_size),
                            ignore_id)
