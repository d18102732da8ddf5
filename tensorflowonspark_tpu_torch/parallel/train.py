"""Train-step harness — counterpart of ``tensorflowonspark_tpu/parallel/
train.py``, on one card or over a mesh of ranks (one GPU each).

    state = create_train_state(model, optimizer, mesh)
    step = make_train_step(loss_fn, optimizer, mesh, grad_accum=2)
    state, metrics = step(state, batch, rng)

Where the JAX harness passes a params pytree, here ``loss_fn(params,
batch, rng)`` receives the ``nn.Module`` itself (``TrainState.params``)
and runs it as PyTorch code does, or, when the state was made from a
dict of tensors, that dict.  Gradients come from ``torch.autograd.grad``
of the float parameters, so nothing accumulates in ``.grad``.

JAX's step is a pure function whose state buffers jit donates; the port
updates the parameters and the optimizer state IN PLACE (the fused
AdamW kernel writes them in its one pass) and returns a new
``TrainState`` that holds the same tensors (``donate=False`` copies the
state first).

On a mesh (``parallel.mesh``) the sharding lives in the step, with
explicit collectives that run alike under gloo and nccl: parameters and
optimizer state are sharded at rest by the JAX rules
(``TrainState.shardings``), each rank's ``loss_fn`` sees its own rows
(and, under context parallelism, its sequence block of them), the
fsdp-sharded parameters are all-gathered for the forward, and the
forward runs inside ``parallel.mesh.use_mesh`` so that a model split
over tp, sp, cp or pp runs its own collectives.  The gradients that a
rank holds only part of (the model's ``grad_axes``) are summed over
their axes, then all gradients are averaged over the batch axes
(all-reduced, or reduce-scattered back to their fsdp shard).  The
optimizer then runs on the local shards, clipped by the norm of the
whole gradient.  :func:`feed_consensus` votes over the default process
group.
"""
import contextlib
import copy
import math
from typing import Any, NamedTuple

import torch
from torch import nn

from tensorflowonspark_tpu_torch.optim import (apply_updates,
                                               whole_gradient_norm)
from tensorflowonspark_tpu_torch.parallel import collectives
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_mod
from tensorflowonspark_tpu_torch.parallel import sharding as sharding_mod


class TrainState(NamedTuple):
    step: Any
    params: Any
    opt_state: Any
    # {name: parallel.mesh.NamedSharding} of a state on a mesh (a JAX
    # array carries its placement; a local shard here does not)
    shardings: Any = None


def _tensors(params):
    """The float tensors the optimizer walks, by name."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return {n: t for n, t in params.items() if t.is_floating_point()}


def _mesh_of(shardings):
    return next(iter(shardings.values())).mesh if shardings else None


def _grad_axes(params, mesh):
    """The model's ``(partial, distinct)`` gradient axes on ``mesh``
    (``Transformer.grad_axes``); none for a dict of tensors."""
    fn = getattr(params, "grad_axes", None)
    return fn(mesh) if fn is not None and mesh is not None else ({}, {})


def create_train_state(params, optimizer, mesh=None, param_shardings=None):
    """TrainState of an ``nn.Module`` (or a dict of tensors, whose float
    leaves are marked ``requires_grad``), its optimizer state, and the
    step count 0 on the parameters' device.

    On a mesh the parameters are sharded first (``param_shardings``,
    default ``infer_param_shardings(params, mesh)``; a module in place)
    and the optimizer state is built over the local shards, so every
    moment shards exactly like its parameter."""
    if mesh is None and param_shardings:
        mesh = _mesh_of(param_shardings)
    if mesh is not None:
        if param_shardings is None:
            param_shardings = sharding_mod.infer_param_shardings(params, mesh)
        params = sharding_mod.shard_params(params, param_shardings)
    tensors = _tensors(params)
    if not isinstance(params, nn.Module):
        for t in tensors.values():
            t.requires_grad_(True)
    dev = next(iter(tensors.values())).device
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      params=params, opt_state=optimizer.init(tensors),
                      shardings=param_shardings)


class _Bound(nn.Module):
    """``fn(module, *args)`` as a module, so that
    ``torch.func.functional_call`` can hand it other tensors."""

    def __init__(self, module, fn):
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.module, *args)


def _call_with(fn, params, tensors, *args):
    """``fn(params, *args)`` with ``tensors`` in place of the parameters
    of the same names (gathered, cast)."""
    if isinstance(params, nn.Module):
        return torch.func.functional_call(
            _Bound(params, fn), {"module." + n: t for n, t in tensors.items()},
            args)
    return fn(dict(params, **tensors), *args)


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


def _clone(tree):
    """A copy of an optimizer state: its tensors cloned, its containers
    rebuilt."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _copy_state(state):
    """A state that shares no tensor with ``state`` (for donate=False)."""
    params = state.params
    if isinstance(params, nn.Module):
        params = copy.deepcopy(params)
    else:
        params = {n: t.detach().clone().requires_grad_(t.requires_grad)
                  for n, t in params.items()}
    return state._replace(step=state.step.clone(), params=params,
                          opt_state=_clone(state.opt_state))


def _states_8bit(tree):
    """The ``Adam8bitState`` s inside an optimizer state."""
    from tensorflowonspark_tpu_torch.optim8bit import Adam8bitState

    if isinstance(tree, Adam8bitState):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [s for t in tree for s in _states_8bit(t)]
    return []


def _check_layouts(layouts, state, tensors, example_params):
    """JAX's checks of a declared 8-bit layout (``_quantized_shardings``):
    it must be the layout of the parameter's sharding, and the payload
    must have been built with it (this rank's shard of it)."""
    from tensorflowonspark_tpu_torch.optim8bit import (expected_blocks,
                                                       shard_layout)

    full, split = {}, set()
    for n, t in tensors.items():
        shape = list(t.shape)
        sh = (state.shardings or {}).get(n)
        for d, axes in (sh.shard_dim(t.ndim) if sh is not None else ()):
            shape[d] *= sh.mesh.extent(axes)
            split.add(n)
        full[n] = tuple(shape)
    if example_params is not None:
        for n, t in sharding_mod.named_tensors(example_params).items():
            if n in full and tuple(t.shape) != full[n]:
                raise ValueError(f"example_params[{n!r}] has shape "
                                 f"{tuple(t.shape)}, the state {full[n]}")
    q_states = _states_8bit(state.opt_state)
    for n, layout in layouts.items():
        if layout is None or all(c == 1 for c in layout.counts):
            continue
        shape = full[n]
        sharding = (state.shardings or {}).get(n)
        if layout != shard_layout(shape, sharding):
            raise ValueError(
                f"declared quantized-state layout {tuple(layout.counts)} "
                f"does not match sharding {getattr(sharding, 'spec', None)} "
                f"for param shape {shape} (build both from "
                "optim8bit.layouts_for_shardings with the same shardings)")
        for qs in q_states:
            q = qs.mu[n].q
            want = expected_blocks(layout.shape, layout.counts, q.shape[1])
            if n in split:     # this rank holds one shard's blocks
                want //= math.prod(layout.counts)
            if q.shape[0] != want:
                raise ValueError(
                    f"quantized payload {tuple(q.shape)} for param shape "
                    f"{shape} was not built with layout "
                    f"{tuple(layout.counts)} (pass the same layouts= to the "
                    "optimizer and make_train_step)")


def make_train_step(loss_fn, optimizer, mesh=None, param_shardings=None,
                    grad_accum=1, compute_dtype=None, donate=True,
                    example_params=None, layouts=None):
    """Build ``train_step(state, batch, rng) -> (state, metrics)``.

    ``loss_fn(params, batch, rng) -> scalar loss``, the mean over the
    batch it is given: on a mesh, this rank's rows.  ``grad_accum > 1``
    splits the batch's leading axis into that many micro-batches, sums
    their losses and gradients, then divides, as the JAX step's scan
    does.  ``compute_dtype`` casts the float parameters for the loss
    (gradients flow back to the masters).  An optimizer with a
    single-pass ``apply`` (``adamw_fused``) takes that path; others run
    ``update`` then :func:`optim.apply_updates`.  ``metrics = {"loss",
    "grad_norm"}``, device tensors: on a mesh the global-batch mean loss
    and the norm of the whole gradient, the same on every rank.

    ``mesh`` / ``param_shardings`` (default: the state's shardings): the
    sharded step of the module doc; the mesh is taken from the shardings
    when not given (at each call, from the state's, when neither is).
    ``layouts`` — the SAME tree ``adamw8bit`` was built
    with (``optim8bit.layouts_for_shardings``) — is checked against the
    shardings and the state's payloads at the first step, as are the
    shapes of ``example_params`` (full-shape parameters) when given.

    ``donate=True`` updates the state in place, as the JAX step donates
    it; ``donate=False`` copies the state first and leaves it as it
    was."""
    if isinstance(compute_dtype, str):
        compute_dtype = getattr(torch, compute_dtype)
    if mesh is None and param_shardings:
        mesh = _mesh_of(param_shardings)
    if mesh is not None:
        mesh.check_placeable()
    checked = []

    def _loss(params, full, swap, batch, rng):
        if compute_dtype is not None:
            full = {n: t.to(compute_dtype) for n, t in full.items()}
        elif not swap:
            return loss_fn(params, batch, rng)
        return _call_with(loss_fn, params, full, batch, rng)

    def _value_and_grad(params, full, swap, batch, rng):
        loss = _loss(params, full, swap, batch, rng)
        grads = torch.autograd.grad(loss, list(full.values()))
        return loss.detach(), dict(zip(full, grads))

    def train_step(state, batch, rng=None):
        if not donate:
            state = _copy_state(state)
        params = state.params
        tensors = _tensors(params)
        shardings = param_shardings or state.shardings
        # a step built without a mesh, given a sharded state, takes the
        # state's mesh: it is still the global step
        step_mesh = mesh if mesh is not None else _mesh_of(shardings)
        if step_mesh is not None and mesh is None:
            step_mesh.check_placeable()
        dims = collectives.sharded_dims(tensors, shardings)
        axes = collectives.split_axes(tensors, shardings)
        if any(axes.values()) and getattr(optimizer, "whole_leaf", False):
            raise NotImplementedError(
                "an optimizer that reads whole leaves (adafactor) over "
                "fsdp- or tp-sharded parameters is not ported yet (ROADMAP: "
                "multi-GPU sharding, A3a's open items)")
        partial, distinct = _grad_axes(params, step_mesh)
        for n, extra in distinct.items():
            axes[n] = tuple(axes.get(n, ())) + tuple(extra)
        if layouts is not None and shardings and not checked:
            _check_layouts(layouts, state._replace(shardings=shardings),
                           tensors, example_params)
            checked.append(True)
        full, gathered = tensors, None
        if dims:     # the fsdp-sharded parameters, whole, for the forward
            gathered = collectives.gather_full(
                {n: tensors[n].detach() for n in dims}, shardings)
            full = {n: (gathered[n].requires_grad_(True) if n in dims
                        else t) for n, t in tensors.items()}
        swap = bool(dims)
        ctx = (mesh_mod.use_mesh(step_mesh) if step_mesh is not None
               else contextlib.nullcontext())
        with ctx:
            loss, grads = _accumulate(params, full, swap, batch, rng)
        del full, gathered
        if step_mesh is not None:
            grads, loss = collectives.reduce_gradients(grads, dims,
                                                       step_mesh, loss,
                                                       partial)
        grad_norm = collectives.global_grad_norm(grads, axes, step_mesh)
        fused_apply = getattr(optimizer, "apply", None)
        with torch.no_grad():
            if callable(fused_apply):
                # single pass: the parameter write is fused into the
                # kernel's pass over grad and moments
                _, opt_state = fused_apply(grads, state.opt_state, tensors,
                                           grad_norm=grad_norm)
            else:
                with whole_gradient_norm(
                        grad_norm if any(axes.values()) else None):
                    updates, opt_state = optimizer.update(
                        grads, state.opt_state, tensors)
                apply_updates(tensors, updates)
        new_state = state._replace(step=state.step + 1, opt_state=opt_state,
                                   shardings=shardings)
        return new_state, {"loss": loss, "grad_norm": grad_norm}

    def _accumulate(params, full, swap, batch, rng):
        if grad_accum > 1:
            loss, grads = 0.0, None
            for mb in _split(batch, grad_accum):
                mb_loss, mb_grads = _value_and_grad(params, full, swap, mb,
                                                    rng)
                loss = loss + mb_loss
                grads = mb_grads if grads is None else {
                    n: grads[n] + g for n, g in mb_grads.items()}
            loss = loss / grad_accum
            grads = {n: g / grad_accum for n, g in grads.items()}
        else:
            loss, grads = _value_and_grad(params, full, swap, batch, rng)
        return loss, grads

    return train_step


def make_eval_step(forward_fn, mesh=None, param_shardings=None):
    """``eval_step(params, batch) -> forward_fn(params, batch)`` without
    autograd.  On a mesh each rank runs the forward on its own rows (its
    sequence block under cp) inside ``parallel.mesh.use_mesh`` and gets
    its own output (a tp-split model's logits: its vocabulary slice,
    ``models.transformer.gather_vocab`` joins them);
    ``param_shardings`` (a sharded state's ``shardings``) gathers the
    fsdp-sharded parameters for it."""
    if mesh is None and param_shardings:
        mesh = _mesh_of(param_shardings)
    if mesh is not None:
        mesh.check_placeable()

    def eval_step(params, batch):
        ctx = (mesh_mod.use_mesh(mesh) if mesh is not None
               else contextlib.nullcontext())
        with torch.no_grad(), ctx:
            if not collectives.sharded_dims(_tensors(params),
                                            param_shardings or {}):
                return forward_fn(params, batch)
            tensors = _tensors(params)
            full = collectives.gather_full(tensors, param_shardings)
            return _call_with(forward_fn, params, full, batch)
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
