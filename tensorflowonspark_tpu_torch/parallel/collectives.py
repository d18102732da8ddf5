"""The sharded train step's collectives, coalesced into one flat buffer
per dtype: the fsdp all-gather of the parameters, the gradient mean over
the batch axes (an all-reduce for replicated parameters, a
reduce-scatter over fsdp then an all-reduce over dp for sharded ones)
and the norm of the whole gradient.  Every function short-circuits where
its group holds one rank, so the same code runs on a mesh of 1.
"""
import math

import torch
import torch.distributed as dist

from tensorflowonspark_tpu_torch.ops.fused_optim import global_norm
from tensorflowonspark_tpu_torch.parallel.mesh import (AXIS_DP, AXIS_FSDP,
                                                       BATCH_AXES)


def sharded_dims(tensors, shardings):
    """``{name: dim}`` of the tensors split over fsdp (by the dim of the
    tensor as the port stores it)."""
    out = {}
    for name, t in tensors.items():
        sh = shardings.get(name) if shardings else None
        split = sh.shard_dim(t.ndim) if sh is not None else None
        if split is not None:
            out[name] = split[0]
    return out


def _by_dtype(names, tensors):
    groups = {}
    for n in names:
        groups.setdefault(tensors[n].dtype, []).append(n)
    return groups.items()


def _axis_order(rows, order):
    """Rows in group-rank order -> rows in axis-index order."""
    if list(order) == sorted(order):
        return rows
    inv = sorted(range(len(order)), key=lambda g: order[g])
    return rows[torch.tensor(inv, device=rows.device)]


def _group_order(rows, order):
    """Rows in axis-index order -> rows in group-rank order."""
    if list(order) == sorted(order):
        return rows
    return rows[torch.tensor(list(order), device=rows.device)]


def gather_full(tensors, shardings):
    """``{name: full tensor}``: the fsdp-sharded local tensors
    all-gathered (one collective per dtype), the rest as they are."""
    dims = sharded_dims(tensors, shardings)
    full = dict(tensors)
    if not dims:
        return full
    group = shardings[next(iter(dims))].mesh.group(AXIS_FSDP)
    n = group.size
    for _, names in _by_dtype(dims, tensors):
        flat = torch.cat([tensors[k].reshape(-1) for k in names])
        out = flat.new_empty(n * flat.numel())
        dist.all_gather_into_tensor(out, flat, group=group.pg)
        rows = _axis_order(out.view(n, -1), group.order)
        off = 0
        for k in names:
            t, d = tensors[k], dims[k]
            piece = rows[:, off:off + t.numel()].reshape((n,) + t.shape)
            shape = list(t.shape)
            shape[d] *= n
            full[k] = piece.movedim(0, d).reshape(shape)
            off += t.numel()
    return full


def reduce_gradients(grads, dims, mesh, loss):
    """This rank's gradients (of its local mean loss, at the full shapes)
    -> ``({name: gradient of the global mean}, global mean loss)``:
    sharded leaves come back as this rank's shard along the same dim.

    Replicated leaves (and the loss, appended to the f32 buffer) are
    summed over the batch axes by one all-reduce per dtype; sharded
    leaves by one reduce-scatter per dtype over fsdp, then an all-reduce
    over dp.  Both are then divided by the batch group's size.

    Consumes ``grads``: each gradient leaves the dict once its flat
    buffer holds it, so that the full-shape gradients and the buffers
    are not resident together."""
    n_batch = mesh.extent(BATCH_AXES)
    if n_batch == 1:
        return grads, loss
    batch = mesh.group(BATCH_AXES)
    order = list(grads)
    shapes = {k: g.shape for k, g in grads.items()}
    out = {}
    repl = [n for n in grads if n not in dims]
    groups = dict(_by_dtype(repl, grads))
    groups.setdefault(torch.float32, [])
    for dtype, names in groups.items():
        parts = [grads.pop(k).reshape(-1) for k in names]
        if dtype == torch.float32:
            parts.append(loss.reshape(1).float())
        flat = torch.cat(parts)
        del parts
        dist.all_reduce(flat, group=batch.pg)
        flat.div_(n_batch)
        off = 0
        for k in names:
            size = math.prod(shapes[k])
            out[k] = flat[off:off + size].view(shapes[k])
            off += size
        if dtype == torch.float32:
            # a copy: a view would keep the whole buffer alive as long
            # as the caller keeps the loss
            loss = flat[-1].clone()
    if dims:
        fsdp, dp = mesh.group(AXIS_FSDP), mesh.group(AXIS_DP)
        n = fsdp.size
        for _, names in _by_dtype(dims, grads):
            blocks = []
            for k in names:
                g, d = grads.pop(k), dims[k]
                split = g.shape[:d] + (n, g.shape[d] // n) + g.shape[d + 1:]
                blocks.append(g.reshape(split).movedim(d, 0).reshape(n, -1))
            rows = _group_order(torch.cat(blocks, dim=1), fsdp.order)
            del blocks, g
            local = rows.new_empty(rows.shape[1])
            dist.reduce_scatter_tensor(local, rows.reshape(-1), group=fsdp.pg)
            del rows
            if dp.pg is not None:
                dist.all_reduce(local, group=dp.pg)
            local.div_(n_batch)
            off = 0
            for k in names:
                shape = list(shapes[k])
                shape[dims[k]] //= n
                size = math.prod(shape)
                out[k] = local[off:off + size].view(shape)
                off += size
    return {k: out[k] for k in order}, loss


def global_grad_norm(grads, dims, mesh):
    """The norm of the WHOLE gradient from this rank's local gradients:
    the squares of the sharded leaves' shards summed over fsdp, plus the
    replicated leaves counted once.  Without sharded leaves it is
    ``global_norm`` of the gradients, as on one card."""
    if not dims:
        return global_norm(list(grads.values()))
    sharded = [grads[k].float() for k in grads if k in dims]
    repl = [grads[k].float() for k in grads if k not in dims]
    sq = torch.stack(torch._foreach_norm(sharded)).square().sum()
    dist.all_reduce(sq, group=mesh.group(AXIS_FSDP).pg)
    if repl:
        sq = sq + torch.stack(torch._foreach_norm(repl)).square().sum()
    return sq.sqrt()
