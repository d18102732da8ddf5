"""Pipeline parallelism — counterpart of ``tensorflowonspark_tpu/
parallel/pipeline.py``: the GPipe schedule over the ``pp`` mesh axis.

Each rank holds ONE stage's parameters.  Micro-batches flow through the
stages: at tick ``t`` stage ``s`` runs micro-batch ``t - s`` and sends its
activation to stage ``s + 1`` (a neighbour exchange, one
``batch_isend_irecv`` a tick posted in the same order on every rank);
the schedule runs ``T = n_micro + n_stages - 1`` ticks (bubble ticks
compute nothing).  The last stage's outputs reach every pp rank, as the
JAX ``psum`` makes them.

The backward is the schedule reversed, with the reverse exchange: the
last stage takes the outputs' gradient (every rank computes the same
downstream, so once, not summed over the pp ranks), each stage runs its
micro-batches' saved graphs backward and sends the input gradients to
the stage before it.  The stacked input's gradient is stage 0's (zero on
the others): a replicated producer of it (the embedding) gets its
gradient summed over pp by the train step.
"""
import torch
import torch.distributed as dist

from tensorflowonspark_tpu_torch.parallel import collectives as coll
from tensorflowonspark_tpu_torch.parallel.mesh import AXIS_PP, active_mesh


def stack_stage_params(per_stage_params):
    """Stack a list of per-stage ``{name: tensor}`` dicts into leaves with
    a leading ``[n_stages]`` dim (a rank takes its stage's slice)."""
    return {k: torch.stack([p[k] for p in per_stage_params])
            for k in per_stage_params[0]}


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, names, group, n_micro, x_micro, *params):
        n, s = group.size, group.index
        stage_params = dict(zip(names, params))
        if n > 1:
            # the group's first collective has every rank in it (nccl's
            # rule for batched p2p that later involves only some)
            dist.all_reduce(torch.zeros(1, device=x_micro.device),
                            group=group.pg)
        outputs = torch.zeros_like(x_micro)
        saved, recv = {}, None
        for t in range(n_micro + n - 1):
            m, y = t - s, None
            if 0 <= m < n_micro:
                inp = (x_micro[m] if s == 0 else recv).detach()
                inp.requires_grad_(True)
                with torch.enable_grad():
                    y = stage_fn(stage_params, inp)
                saved[m] = (inp, y)
                if s == n - 1:
                    outputs[m] = y.detach()
            prev_valid = s > 0 and 0 <= t - (s - 1) < n_micro
            got = coll.exchange(
                [y.detach()] if y is not None and s < n - 1 else None,
                group.next, [x_micro[0]] if prev_valid else None,
                group.prev, group)
            recv = got[0] if got else None
        if n > 1:
            dist.all_reduce(outputs, group=group.pg)
        ctx.group, ctx.n_micro, ctx.saved = group, n_micro, saved
        ctx.params = params
        ctx.x_shape = x_micro.shape
        return outputs

    @staticmethod
    def backward(ctx, grad_out):
        group, n_micro, saved = ctx.group, ctx.n_micro, ctx.saved
        n, s = group.size, group.index
        params = ctx.params
        want = [i for i, p in enumerate(params) if p.requires_grad]
        grads = [None] * len(params)
        # stage 0's input gradient; zeros elsewhere (so that the
        # replicated producer gets a gradient, summed over pp, on every rank)
        grad_x = grad_out.new_zeros(ctx.x_shape)
        recv = None
        for t in reversed(range(n_micro + n - 1)):
            m, g_inp = t - s, None
            if 0 <= m < n_micro:
                inp, y = saved.pop(m)
                gy = grad_out[m] if s == n - 1 else recv
                res = torch.autograd.grad(
                    y, [inp] + [params[i] for i in want], gy,
                    allow_unused=True)
                g_inp = res[0]
                for i, g in zip(want, res[1:]):
                    if g is not None:
                        grads[i] = g if grads[i] is None else grads[i] + g
                if s == 0:
                    grad_x[m] = g_inp
            next_valid = s < n - 1 and 0 <= t - (s + 1) < n_micro
            got = coll.exchange(
                [g_inp] if g_inp is not None and s > 0 else None,
                group.prev, [grad_out[0]] if next_valid else None,
                group.next, group)
            recv = got[0] if got else None
        ctx.saved = ctx.params = None
        return (None, None, None, None, grad_x) + tuple(grads)


def pipeline_apply(stage_fn, stage_params, x_micro, mesh=None, axis=AXIS_PP):
    """Apply an N-stage pipeline, one stage a rank along ``axis`` of
    ``mesh`` (default: the active mesh; none: one stage).

    ``stage_fn(stage_params, x) -> y`` with ``y.shape == x.shape``;
    ``stage_params``: this rank's stage's ``{name: tensor}`` (gradients
    flow to those that require them); ``x_micro``: ``[n_micro,
    micro_batch, ...]``, the same on every pp rank (each dp rank its own
    rows).  Returns the last stage's ``[n_micro, micro_batch, ...]`` on
    every pp rank."""
    mesh = mesh if mesh is not None else active_mesh()
    group = coll.axis_group(mesh, axis)
    names = list(stage_params)
    return _Pipeline.apply(stage_fn, names, group, x_micro.shape[0],
                           x_micro, *(stage_params[k] for k in names))
