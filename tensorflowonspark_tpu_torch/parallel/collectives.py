"""Collectives of the sharded step and of the split forward.

The step's collectives are coalesced into one flat buffer per dtype: the
fsdp (and tp) all-gather of the parameters, the gradient mean over the
batch axes (an all-reduce for replicated parameters, a reduce-scatter
over fsdp then an all-reduce over dp for fsdp-sharded ones), the sum
over tp / cp / pp of the gradients that a rank holds only part of, and
the norm of the whole gradient.

The forward's collectives are ``torch.autograd.Function`` s over one
mesh axis (an :class:`AxisGroup`), each with its conjugate in the
backward: Megatron's :func:`copy_to_tp` / :func:`reduce_from_tp`, the
sequence-parallel :func:`gather_seq` / :func:`scatter_seq` /
:func:`split_seq`, Ulysses' :func:`all_to_all` and the ring's and the
pipeline's neighbour exchange :func:`ring_shift`.

Every function short-circuits where its group holds one rank, so the
same code runs on a mesh of 1 and with no process group at all.

A tp serving engine's leader drives its followers through a
:class:`HeaderChannel`: one broadcast of a host header a device
operation, over a gloo group of the tp ranks, so the header never
waits for the card.
"""
import datetime
import time
import math
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from tensorflowonspark_tpu_torch.ops.fused_optim import global_norm
from tensorflowonspark_tpu_torch.parallel.mesh import (AXIS_DP, AXIS_FSDP,
                                                       AXIS_PP, AXIS_TP,
                                                       BATCH_AXES, tp_leader)


class AxisGroup(NamedTuple):
    """One mesh axis as seen from this rank: its process group (None: a
    group of one), size, ``order[g]`` (the axis index of the group's rank
    ``g``), this rank's axis index, and the global ranks one step
    forward and back along the axis."""
    pg: Any
    size: int
    order: tuple
    index: int
    next: int
    prev: int


SOLO = AxisGroup(None, 1, (0,), 0, 0, 0)


def axis_group(mesh, axis):
    """The :class:`AxisGroup` of ``axis`` on ``mesh`` (None: a group of
    one)."""
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return SOLO
    g = mesh.group(axis)
    return AxisGroup(g.pg, g.size, g.order, mesh.coords[axis],
                     mesh.neighbor(axis, 1), mesh.neighbor(axis, -1))


def sharded_dims(tensors, shardings):
    """``{name: dim}`` of the tensors split over fsdp (by the dim of the
    tensor as the port stores it)."""
    return split_dims(tensors, shardings, AXIS_FSDP)


def split_dims(tensors, shardings, axis):
    """``{name: dim}`` of the tensors that ``axis`` splits."""
    out = {}
    for name, t in tensors.items():
        sh = shardings.get(name) if shardings else None
        for dim, axes in (sh.shard_dim(t.ndim) if sh is not None else ()):
            if axis in axes:
                if axes != (axis,):
                    raise NotImplementedError(
                        f"{name}: dim {dim} split over {axes} together "
                        "(ROADMAP A3c)")
                out[name] = dim
    return out


def split_axes(tensors, shardings):
    """``{name: axes}`` of the mesh axes that split each tensor (empty
    for a replicated one)."""
    return {n: (shardings[n].split_axes(t.ndim)
                if shardings and n in shardings else ())
            for n, t in tensors.items()}


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


def gather_full(tensors, shardings, axes=(AXIS_FSDP,)):
    """``{name: tensor}`` with the slices along ``axes`` all-gathered
    (one collective per axis and dtype), the rest as they are: by
    default the fsdp slices (the forward's parameters: tp slices stay
    local), with ``axes=("fsdp", "tp")`` the full tensors."""
    full = dict(tensors)
    for axis in axes:
        dims = split_dims(full, shardings, axis)
        if not dims:
            continue
        mesh = shardings[next(iter(dims))].mesh
        group = mesh.group(axis)
        n = group.size
        for _, names in _by_dtype(dims, full):
            flat = torch.cat([full[k].reshape(-1) for k in names])
            out = flat.new_empty(n * flat.numel())
            dist.all_gather_into_tensor(out, flat, group=group.pg)
            rows = _axis_order(out.view(n, -1), group.order)
            off = 0
            for k in names:
                t, d = full[k], dims[k]
                piece = rows[:, off:off + t.numel()].reshape((n,) + t.shape)
                shape = list(t.shape)
                shape[d] *= n
                full[k] = piece.movedim(0, d).reshape(shape)
                off += t.numel()
    return full


def sum_partial(grads, partial, mesh):
    """Sum, in place of each gradient of ``partial`` (``{name: axes}``),
    its value over the ranks along those axes: the leaves a rank holds
    whole but computes only part of the gradient of (norm scales under
    sequence parallelism, every leaf under context parallelism, the
    embedding under a pipeline).  One all-reduce per axis and dtype."""
    for axis in (AXIS_FSDP, AXIS_PP, AXIS_TP):
        names = [n for n in grads if axis in partial.get(n, ())]
        group = mesh.group(axis)
        if not names or group.pg is None:
            continue
        for _, group_names in _by_dtype(names, grads):
            flat = torch.cat([grads[k].reshape(-1) for k in group_names])
            dist.all_reduce(flat, group=group.pg)
            off = 0
            for k in group_names:
                size = grads[k].numel()
                grads[k] = flat[off:off + size].view(grads[k].shape)
                off += size
    return grads


def reduce_gradients(grads, dims, mesh, loss, partial=None):
    """This rank's gradients (of its local mean loss, at the fsdp-full
    shapes) -> ``({name: gradient of the global mean}, global mean
    loss)``: fsdp-sharded leaves (``dims``) come back as this rank's
    shard along the same dim.  The gradients of ``partial`` (``{name:
    axes}``) are first summed over those axes (:func:`sum_partial`).

    Replicated leaves (and the loss, appended to the f32 buffer) are
    summed over the batch axes by one all-reduce per dtype; sharded
    leaves by one reduce-scatter per dtype over fsdp, then an all-reduce
    over dp.  Both are then divided by the batch group's size.

    Consumes ``grads``: each gradient leaves the dict once its flat
    buffer holds it, so that the full-shape gradients and the buffers
    are not resident together."""
    if partial:
        grads = sum_partial(grads, partial, mesh)
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


def global_grad_norm(grads, axes, mesh):
    """The norm of the WHOLE gradient from this rank's local gradients.
    ``axes`` (``{name: axes}``) names the mesh axes along which each
    leaf's piece differs between ranks (its fsdp / tp split; pp for a
    pipeline stage's layers): the squares are summed over those axes, so
    each piece counts once and each replicated leaf once.  Without such
    leaves it is ``global_norm`` of the gradients, as on one card."""
    if mesh is None or not any(axes.get(k) for k in grads):
        return global_norm(list(grads.values()))
    order = (AXIS_FSDP, AXIS_TP, AXIS_PP)
    keys = {}
    for k, g in grads.items():
        key = frozenset(a for a in axes.get(k, ()) if a in order)
        keys.setdefault(key, []).append(g.float())
    sums = {key: torch.stack(torch._foreach_norm(gs)).square().sum()
            for key, gs in keys.items()}
    # every rank walks the same key set, whatever leaves it holds
    zero = next(iter(sums.values())) * 0
    sums = {frozenset(c): sums.get(frozenset(c), zero)
            for c in _subsets(order)}
    for axis in order:
        group = mesh.group(axis)
        with_axis = [key for key in sums if axis in key]
        vec = torch.stack([sums[key] for key in with_axis])
        if group.pg is not None:
            dist.all_reduce(vec, group=group.pg)
        for key, v in zip(with_axis, vec):
            rest = key - {axis}
            sums[rest] = sums[rest] + v
            del sums[key]
    return sums[frozenset()].sqrt()


def _subsets(axes):
    out = [()]
    for a in axes:
        out += [c + (a,) for c in out]
    return out


# --- the forward's collectives (autograd) ----------------------------


def _all_reduce(x, group):
    x = x.clone()
    dist.all_reduce(x, group=group.pg)
    return x


def _gather(x, group, dim):
    """All-gather along ``dim``, blocks in axis order."""
    n = group.size
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty(n * xm.numel())
    dist.all_gather_into_tensor(out, xm.view(-1), group=group.pg)
    rows = _axis_order(out.view((n,) + tuple(xm.shape)), group.order)
    return rows.reshape((n * xm.shape[0],) + tuple(xm.shape[1:])).movedim(
        0, dim).contiguous()


def _reduce_scatter(x, group, dim):
    """Sum over the group, then this rank's block along ``dim``."""
    n = group.size
    xm = x.movedim(dim, 0)
    if xm.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    rows = xm.reshape((n, xm.shape[0] // n) + tuple(xm.shape[1:]))
    rows = _group_order(rows, group.order).contiguous()
    out = rows.new_empty(rows[0].numel())
    dist.reduce_scatter_tensor(out, rows.view(-1), group=group.pg)
    return out.view(rows.shape[1:]).movedim(0, dim).contiguous()


def _block(x, group, dim):
    """This rank's block along ``dim``."""
    size = x.shape[dim] // group.size
    return x.narrow(dim, group.index * size, size).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, reduce_grad):
        ctx.group, ctx.dim, ctx.reduce_grad = group, dim, reduce_grad
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = (_reduce_scatter(g, ctx.group, ctx.dim) if ctx.reduce_grad
             else _block(g, ctx.group, ctx.dim))
        return g, None, None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.group, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.group, ctx.dim), None, None


def copy_to_tp(x, group):
    """Megatron's ``f``: identity forward, all-reduce of the gradient
    backward.  Enters a column-parallel layer from a replicated
    activation."""
    return x if group.size == 1 else _CopyTo.apply(x, group)


def reduce_from_tp(x, group):
    """Megatron's ``g``: all-reduce (sum) forward, identity backward.
    Leaves a row-parallel layer (its partial sums) for a replicated
    activation; also sums pieces of a value every rank then uses
    alike (the vocab-parallel loss's)."""
    return x if group.size == 1 else _ReduceFrom.apply(x, group)


def gather_seq(x, group, dim=1, reduce_grad=True):
    """All-gather along ``dim`` (the sequence, by default).  The
    backward reduce-scatters (``reduce_grad``: each rank's gradient of
    the whole is a partial sum, as where column-parallel layers consume
    it) or keeps this rank's block of it (every rank holds the whole
    gradient alike)."""
    if group.size == 1:
        return x
    return _Gather.apply(x, group, dim, reduce_grad)


def scatter_seq(x, group, dim=1):
    """Reduce-scatter along ``dim``: the sum of the ranks' partial
    values, this rank's block of it (a row-parallel layer's output under
    sequence parallelism); the backward all-gathers."""
    return x if group.size == 1 else _ScatterSum.apply(x, group, dim)


def split_seq(x, group, dim=1):
    """This rank's block along ``dim`` of a value every rank holds alike;
    the backward all-gathers the blocks' gradients."""
    return x if group.size == 1 else _Split.apply(x, group, dim)


def _all_to_all(x, group, split_dim, concat_dim):
    n = group.size
    chunks = x.chunk(n, split_dim)
    ins = [chunks[group.order[g]].contiguous() for g in range(n)]
    outs = [torch.empty_like(ins[0]) for _ in range(n)]
    dist.all_to_all(outs, ins, group=group.pg)
    got = [None] * n
    for g in range(n):
        got[group.order[g]] = outs[g]
    return torch.cat(got, dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, concat_dim, split_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


def all_to_all(x, group, split_dim, concat_dim):
    """``lax.all_to_all(tiled=True)``: ``x`` split into ``size`` blocks
    along ``split_dim``, block ``j`` to axis index ``j``, the received
    blocks concatenated along ``concat_dim`` in axis order; the backward
    is the inverse exchange."""
    if group.size == 1:
        return x
    if x.shape[split_dim] % group.size:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {group.size} ranks")
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def exchange(send, send_to, recv_like, recv_from, group):
    """One neighbour exchange, posted as one ``batch_isend_irecv`` in the
    same order on every rank (the send, then the receive): ``send`` (a
    list of tensors, or None) to global rank ``send_to``, and tensors
    shaped like ``recv_like`` (or None) from ``recv_from``.  Returns the
    received tensors (None when nothing is received)."""
    ops, got = [], None
    if send is not None:
        ops += [dist.P2POp(dist.isend, t.contiguous(), send_to, group.pg)
                for t in send]
    if recv_like is not None:
        got = [torch.empty_like(t) for t in recv_like]
        ops += [dist.P2POp(dist.irecv, t, recv_from, group.pg) for t in got]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return got


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(exchange(xs, group.next, xs, group.prev, group))

    @staticmethod
    def backward(ctx, *gs):
        group = ctx.group
        gs = [torch.zeros_like(g) if g is None else g for g in gs]
        return (None,) + tuple(exchange(gs, group.prev, gs, group.next,
                                        group))


def ring_shift(xs, group):
    """Each tensor of ``xs`` to the next rank along the axis, the previous
    rank's in return (``lax.ppermute`` by ``+1``); the backward sends the
    gradients the reverse way."""
    if group.size == 1:
        return tuple(xs)
    return _Shift.apply(group, *xs)


class _Anchor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *tied):
        ctx.tied = [(t.shape, t.dtype, t.device) for t in tied]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=d, device=v)
                            for s, d, v in ctx.tied)


def anchor(x, *tied):
    """``x`` unchanged, with ``tied`` on its backward path (their
    gradient through it zero): a collective whose output this rank does
    not use still runs its backward, so its peers' backward exchanges
    find it."""
    return _Anchor.apply(x, *tied)


# --- the tp serving engine's host headers ----------------------------

# the timeout of a gloo header group made beside an nccl tp group: an idle
# leader sends a noop every few seconds, so only a dead rank trips it
HEADER_TIMEOUT_S = 1800.0


class HeaderChannel:
    """Host headers from a tp group's leader (tp index 0) to its other
    ranks, in order: the leader :meth:`send` s one per device operation
    and each follower :meth:`recv` s it and replays the operation, so
    every rank issues the forward's collectives in the same order.

    A header is a fixed ``int64`` tensor (``HEADER`` entries: the
    operation's code, the payload flag and up to ``HEADER - 2`` small
    ints) broadcast over a gloo group of the tp ranks (the tp group
    itself where it is gloo; a new one beside an nccl group), so that
    neither side waits for the card; a variable payload (a prefill's
    chunks, an adapter's arrays) follows as one
    ``broadcast_object_list``.  ``seconds`` / ``count`` add up the host
    time in :meth:`send` (the leader; it holds the wait for followers
    still replaying the previous operation) or in :meth:`recv` (a
    follower: its wait for the leader).  Every rank of the world
    constructs the first channel of a mesh together (``new_group`` is
    collective)."""

    HEADER = 8

    def __init__(self, mesh):
        g = mesh.group(AXIS_TP)
        self.size = g.size
        self.leader = tp_leader(mesh)
        self.is_leader = mesh.rank == self.leader
        if dist.get_backend(g.pg) == "gloo":
            self.pg = g.pg
        else:
            # one gloo group a mesh, made by the first channel on it
            if getattr(mesh, "_header_pg", None) is None:
                mesh._header_pg = dist.new_group(
                    dist.get_process_group_ranks(g.pg), backend="gloo",
                    timeout=datetime.timedelta(seconds=HEADER_TIMEOUT_S))
            self.pg = mesh._header_pg
        self.seconds = 0.0
        self.count = 0

    def send(self, code, ints=(), payload=None):
        """Leader: broadcast operation ``code`` with ``ints`` (at most
        ``HEADER - 2`` ints) and an optional picklable ``payload``."""
        t0 = time.perf_counter()
        if len(ints) > self.HEADER - 2:
            raise ValueError(f"{len(ints)} ints exceed a header")
        hdr = torch.zeros(self.HEADER, dtype=torch.int64)
        hdr[0], hdr[1] = int(code), int(payload is not None)
        if ints:
            hdr[2:2 + len(ints)] = torch.tensor([int(i) for i in ints])
        dist.broadcast(hdr, src=self.leader, group=self.pg)
        if payload is not None:
            dist.broadcast_object_list([payload], src=self.leader,
                                       group=self.pg)
        self.seconds += time.perf_counter() - t0
        self.count += 1

    def recv(self):
        """Follower: the next ``(code, ints, payload)`` the leader sent
        (``ints``: the header's ``HEADER - 2`` int slots)."""
        t0 = time.perf_counter()
        hdr = torch.empty(self.HEADER, dtype=torch.int64)
        dist.broadcast(hdr, src=self.leader, group=self.pg)
        payload = None
        if hdr[1]:
            box = [None]
            dist.broadcast_object_list(box, src=self.leader, group=self.pg)
            payload = box[0]
        values = hdr.tolist()
        self.seconds += time.perf_counter() - t0
        self.count += 1
        return values[0], values[2:], payload

    def gather(self, obj):
        """Every tp rank's ``obj``, in the group's rank order (a
        collective: the construction's agreement check)."""
        got = [None] * self.size
        dist.all_gather_object(got, obj, group=self.pg)
        return got
