"""Ulysses sequence parallelism — counterpart of
``tensorflowonspark_tpu/parallel/ulysses.py``: around the attention core
two all-to-alls (:func:`~.collectives.all_to_all`) swap the split axis,
so attention sees the whole sequence at ``H / N`` local heads:

    [B, S/N, H, D] --all2all--> [B, S, H/N, D] --attn--> --all2all--> back

The default core is ``ops.flash_attention`` (kernels 4-6), which takes
GQA-narrow k/v; k/v are repeated before the exchange only until the
axis divides their head count (JAX's ``pre`` rule).
"""
from tensorflowonspark_tpu_torch.parallel import collectives as coll
from tensorflowonspark_tpu_torch.parallel.mesh import active_mesh


def dense_core(q, k, v, causal):
    """The plain attention core (``attention_impl="dense"``): k/v
    repeated to the query heads, dense softmax."""
    from tensorflowonspark_tpu_torch.models.transformer import (
        _kv_repeat, dot_product_attention)

    k, v = _kv_repeat(q, k, v)
    return dot_product_attention(q, k, v, causal=causal)


def _flash_core(q, k, v, causal):
    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        flash_attention)

    return flash_attention(q, k, v, causal=causal)


def ulysses_local(q, k, v, group, causal=True, attn_fn=None):
    """Ulysses over ``group`` (a :class:`~.collectives.AxisGroup`): q/k/v
    are this rank's ``[B, S/N, H, D]`` sequence blocks.  ``attn_fn(q, k,
    v, causal)`` is the core (default: the flash kernels)."""
    n = group.size
    H_q, H_kv = q.shape[2], k.shape[2]
    if H_q % n:
        raise ValueError(f"n_heads={H_q} must be divisible by the ulysses "
                         f"axis size {n}")
    if H_q != H_kv:
        # GQA: exchange kv as narrow as the axis allows (the repeat keeps
        # kv group g beside the q heads that land on the same rank)
        if H_q % H_kv:
            raise ValueError(
                f"n_heads={H_q} must be divisible by n_kv_heads={H_kv}")
        rep = H_q // H_kv
        pre = next(p for p in range(1, rep + 1)
                   if rep % p == 0 and (H_kv * p) % n == 0)
        if pre > 1:
            k = k.repeat_interleave(pre, dim=2)
            v = v.repeat_interleave(pre, dim=2)
    qg, kg, vg = (coll.all_to_all(x, group, split_dim=2, concat_dim=1)
                  for x in (q, k, v))
    out = (attn_fn or _flash_core)(qg, kg, vg, causal)
    return coll.all_to_all(out, group, split_dim=1, concat_dim=2)


def ulysses_attention(q, k, v, axis_name="tp", causal=True, mesh=None,
                      attn_fn=None):
    """Exact attention with q/k/v ``[B, S_local, H, D]`` this rank's
    sequence blocks along ``axis_name`` of ``mesh`` (default: the active
    mesh; none: the whole sequence here)."""
    mesh = mesh if mesh is not None else active_mesh()
    return ulysses_local(q, k, v, coll.axis_group(mesh, axis_name), causal,
                         attn_fn)
