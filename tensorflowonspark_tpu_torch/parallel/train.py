"""Train-step harness — counterpart of ``tensorflowonspark_tpu/parallel/
train.py`` on one card.

    state = create_train_state(model, optimizer)
    step = make_train_step(loss_fn, optimizer, grad_accum=2)
    state, metrics = step(state, batch, rng)

Where the JAX harness passes a params pytree, here ``loss_fn(params,
batch, rng)`` receives the ``nn.Module`` itself (``TrainState.params``)
and runs it as PyTorch code does, or, when the state was made from a
dict of tensors, that dict.  Gradients come from ``torch.autograd.grad``
of the float parameters, so nothing accumulates in ``.grad``.

JAX's step is a pure function whose state buffers jit donates; the port
updates the parameters and the optimizer state IN PLACE (the fused
AdamW kernel writes them in its one pass) and returns a new
``TrainState`` that holds the same tensors.  Meshes and explicit
shardings wait for multi-GPU sharding; :func:`feed_consensus` votes over
the ``torch.distributed`` group the cluster runtime's
``NodeContext.init_distributed`` makes.
"""
from typing import Any, NamedTuple

import torch
from torch import nn

from tensorflowonspark_tpu_torch.ops.fused_optim import global_norm
from tensorflowonspark_tpu_torch.optim import apply_updates

_MESH = ("a mesh and explicit shardings are not ported yet (ROADMAP: "
         "multi-GPU sharding)")


class TrainState(NamedTuple):
    step: Any
    params: Any
    opt_state: Any


def _tensors(params):
    """The float tensors the optimizer walks, by name."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return {n: t for n, t in params.items() if t.is_floating_point()}


def create_train_state(params, optimizer, mesh=None, param_shardings=None):
    """TrainState of an ``nn.Module`` (or a dict of tensors, whose float
    leaves are marked ``requires_grad``), its optimizer state, and the
    step count 0 on the parameters' device."""
    if mesh is not None or param_shardings is not None:
        raise NotImplementedError(_MESH)
    tensors = _tensors(params)
    if not isinstance(params, nn.Module):
        for t in tensors.values():
            t.requires_grad_(True)
    dev = next(iter(tensors.values())).device
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      params=params, opt_state=optimizer.init(tensors))


class _BoundLoss(nn.Module):
    """``loss_fn`` over a module, as a module, so that
    ``torch.func.functional_call`` can hand it cast parameters."""

    def __init__(self, module, loss_fn):
        super().__init__()
        self.module = module
        self.loss_fn = loss_fn

    def forward(self, batch, rng):
        return self.loss_fn(self.module, batch, rng)


def _split(batch, n):
    """``[B, ...]`` leaves (tensors, possibly in a dict/tuple/list) ->
    ``n`` micro-batches of ``B // n`` rows."""
    if isinstance(batch, torch.Tensor):
        return list(batch.reshape((n, batch.shape[0] // n)
                                  + tuple(batch.shape[1:])))
    if isinstance(batch, dict):
        parts = {k: _split(v, n) for k, v in batch.items()}
        return [{k: parts[k][i] for k in batch} for i in range(n)]
    if isinstance(batch, (tuple, list)):
        parts = [_split(v, n) for v in batch]
        return [type(batch)(p[i] for p in parts) for i in range(n)]
    raise TypeError(f"cannot split a batch of type {type(batch).__name__}")


def make_train_step(loss_fn, optimizer, mesh=None, param_shardings=None,
                    grad_accum=1, compute_dtype=None, donate=True):
    """Build ``train_step(state, batch, rng) -> (state, metrics)``.

    ``loss_fn(params, batch, rng) -> scalar loss`` (the mean over the
    batch).  ``grad_accum > 1`` splits the batch's leading axis into that
    many micro-batches, sums their losses and gradients, then divides, as
    the JAX step's scan does.  ``compute_dtype`` casts the float
    parameters for the loss (gradients flow back to the masters).  An
    optimizer with a single-pass ``apply`` (``adamw_fused``) takes that
    path; others run ``update`` then :func:`optim.apply_updates`.
    ``metrics = {"loss", "grad_norm"}``, device tensors.

    ``donate=True`` is the only mode: the step updates the state in
    place, as the JAX step donates it."""
    if mesh is not None or param_shardings is not None:
        raise NotImplementedError(_MESH)
    if not donate:
        raise NotImplementedError(
            "a train step that keeps its input state is not ported (ROADMAP: "
            "training compute); the port updates the state in place")
    if isinstance(compute_dtype, str):
        compute_dtype = getattr(torch, compute_dtype)

    def _loss(params, batch, rng):
        if compute_dtype is None:
            return loss_fn(params, batch, rng)
        cast = {n: t.to(compute_dtype) for n, t in _tensors(params).items()}
        if isinstance(params, nn.Module):
            return torch.func.functional_call(
                _BoundLoss(params, loss_fn),
                {"module." + n: t for n, t in cast.items()}, (batch, rng))
        return loss_fn(dict(params, **cast), batch, rng)

    def _value_and_grad(params, tensors, batch, rng):
        loss = _loss(params, batch, rng)
        grads = torch.autograd.grad(loss, list(tensors.values()))
        return loss.detach(), dict(zip(tensors, grads))

    def train_step(state, batch, rng=None):
        params = state.params
        tensors = _tensors(params)
        if grad_accum > 1:
            loss, grads = 0.0, None
            for mb in _split(batch, grad_accum):
                mb_loss, mb_grads = _value_and_grad(params, tensors, mb, rng)
                loss = loss + mb_loss
                grads = mb_grads if grads is None else {
                    n: grads[n] + g for n, g in mb_grads.items()}
            loss = loss / grad_accum
            grads = {n: g / grad_accum for n, g in grads.items()}
        else:
            loss, grads = _value_and_grad(params, tensors, batch, rng)
        grad_norm = global_norm(list(grads.values()))
        fused_apply = getattr(optimizer, "apply", None)
        with torch.no_grad():
            if callable(fused_apply):
                # single pass: the parameter write is fused into the
                # kernel's pass over grad and moments
                _, opt_state = fused_apply(grads, state.opt_state, tensors,
                                           grad_norm=grad_norm)
            else:
                updates, opt_state = optimizer.update(grads, state.opt_state,
                                                      tensors)
                apply_updates(tensors, updates)
        new_state = TrainState(step=state.step + 1, params=params,
                               opt_state=opt_state)
        return new_state, {"loss": loss, "grad_norm": grad_norm}

    return train_step


def make_eval_step(forward_fn, mesh=None):
    """``eval_step(params, batch) -> forward_fn(params, batch)`` without
    autograd."""
    if mesh is not None:
        raise NotImplementedError(_MESH)

    def eval_step(params, batch):
        with torch.no_grad():
            return forward_fn(params, batch)
    return eval_step


def feed_consensus(has_data):
    """Global stop-consensus over an uneven feed: True while EVERY
    process has data, so every rank leaves the loop on the same step
    (a rank that stopped alone would leave its peers blocked in the
    step's collective).  An ``all_reduce(MIN)`` of a one-element int
    tensor over the default process group — a CPU tensor under gloo, a
    CUDA tensor under nccl; with one process, or no process group, the
    answer is ``has_data`` itself.

        while True:
            batch = feed.next_numpy_batch(B, timeout=probe_s)
            if not feed_consensus(batch is not None and len(batch[0])):
                break
            state, m = step(state, batch, rng)
    """
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return bool(has_data)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    vote = torch.tensor([1 if has_data else 0], dtype=torch.int32, device=dev)
    dist.all_reduce(vote, op=dist.ReduceOp.MIN)
    return bool(vote.item())
