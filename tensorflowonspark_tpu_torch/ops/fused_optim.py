"""Single-pass fused AdamW (kernel 7).

Counterpart of ``tensorflowonspark_tpu/ops/fused_optim.py``.  The whole
AdamW update of a parameter (clip scale, moments, bias corrections,
decoupled weight decay, learning rate, the parameter write) runs as one
pass over it: g, p, mu and nu are read once and p, mu and nu written
once.

Trees are dicts ``{name: tensor}`` (``dict(model.named_parameters())``);
``FusedAdamWState.mu/nu`` mirror them name for name.  The object that
:func:`adamw_fused` returns has the JAX package's three methods:

    ``init(params)`` -> state
    ``update(grads, state, params=None)`` -> (updates, state)
    ``apply(grads, state, params)`` -> (params, state)

``apply`` writes the parameters, ``mu`` and ``nu`` IN PLACE, where the
JAX train step donates their buffers; ``update`` writes ``-lr * upd``
into new tensors and updates ``mu`` and ``nu`` in place too.  Both take
an optional ``grad_norm``: the train step passes the global norm it
computes for its metrics, so the reduction runs once (in the JAX package
XLA merges the two).

The four step scalars ``[lr, clip, 1 - b1^t, 1 - b2^t]`` are computed on
the device (the schedule of the count, the clip scale from the global
gradient norm, the bias corrections in f32) and the kernel reads them
from a device pointer, so no step waits on the host.

One rule per leaf: a CPU tensor takes :func:`adamw_plain`; a CUDA tensor
launches ``csrc/fused_optim.cu`` or raises.  The JAX function's
``block_rows`` and ``interpret`` are TPU grid and interpreter knobs and
are not in the signature.
"""
from typing import Any, Callable, NamedTuple

import torch

from . import _build

_INT32_MAX = 2**31 - 1


class FusedAdamWState(NamedTuple):
    """Fused-AdamW state; mu/nu mirror the param dict name for name."""
    count: Any
    mu: Any
    nu: Any


class FusedOptimizer(NamedTuple):
    """``init`` / ``update`` as an optax-style transformation, plus the
    single-pass ``apply(grads, state, params) -> (params, state)``."""
    init: Callable
    update: Callable
    apply: Callable


def safe_increment(count):
    """``count + 1``, saturating at the int32 maximum
    (``optax.safe_int32_increment``)."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def global_norm(tensors):
    """``sqrt(sum of squares)`` over every tensor, in f32 on the tensors'
    device (``optax.global_norm``); per-tensor norms in one multi-tensor
    reduction, then their norm."""
    tensors = [t if t.dtype == torch.float32 else t.float() for t in tensors]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def adamw_plain(g, p, mu, nu, scalars, *, b1, b2, eps, wd, write_param):
    """Plain version of kernel 7 for one leaf: ``(out, mu, nu)`` in the
    TPU kernel's expression order (f32 math; out in p's dtype, or g's for
    ``update``; mu and nu in their own dtypes)."""
    lr, clip, c1, c2 = scalars[0], scalars[1], scalars[2], scalars[3]
    gf = g.float() * clip
    new_mu = (1.0 - b1) * gf + b1 * mu.float()
    new_nu = (1.0 - b2) * (gf * gf) + b2 * nu.float()
    upd = (new_mu / c1) / (torch.sqrt(new_nu / c2) + eps)
    pf = p.float()
    if wd:
        upd = upd + wd * pf
    if write_param:
        out = (pf - lr * upd).to(p.dtype)
    else:
        out = (-lr * upd).to(g.dtype)
    return out, new_mu.to(mu.dtype), new_nu.to(nu.dtype)


def _adamw(g, p, mu, nu, scalars, out, *, b1, b2, eps, wd, write_param):
    """Kernel 7 on one leaf: writes ``out`` (p itself for ``apply``), mu
    and nu in place.  CPU tensors take :func:`adamw_plain`."""
    if g.device.type == "cpu":
        o, m, n = adamw_plain(g, p, mu, nu, scalars, b1=b1, b2=b2, eps=eps,
                              wd=wd, write_param=write_param)
        out.copy_(o)
        mu.copy_(m)
        nu.copy_(n)
        return
    if g.device.type != "cuda":
        raise RuntimeError(f"adamw: no kernel for {g.device}")
    for name, t in (("param", p), ("mu", mu), ("nu", nu), ("out", out),
                    ("scalars", scalars)):
        if t.device != g.device:
            raise ValueError(f"{name} is on {t.device}, the grad on "
                             f"{g.device}")
        # the update is in place: a copy would lose it
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the in-place "
                             "AdamW kernel")
    if not (g.dtype == p.dtype == nu.dtype == out.dtype):
        raise TypeError("grad, param, nu and the output must share one dtype "
                        "on the card")
    if not (g.numel() == p.numel() == mu.numel() == nu.numel()
            == out.numel()):
        raise ValueError("grad, param and moments must have one size")
    if scalars.dtype != torch.float32 or scalars.numel() != 4:
        raise ValueError("scalars must be f32 [lr, clip, 1-b1^t, 1-b2^t]")
    g = g.contiguous()
    P = _build.ptr
    code = _build.lib().tos_adamw(
        P(g), P(p), P(mu), P(nu), P(out), P(scalars), g.numel(), float(b1),
        1.0 - b1, float(b2), 1.0 - b2, float(eps), float(wd),
        int(write_param), _build.dtype_code(g), _build.dtype_code(mu),
        _build.stream_ptr(g.device))
    _build.check(code, "tos_adamw")
    _adamw.launches += 1


_adamw.launches = 0


def _scalars(learning_rate, count, clip_norm, b1, b2, updates,
             grad_norm=None):
    """``[lr, clip_scale, 1 - b1^t, 1 - b2^t]`` as an f32 device tensor,
    ``t = count + 1``; the global-norm reduction is the only pass besides
    the kernels (skipped when the caller hands ``grad_norm`` over)."""
    lr = learning_rate(count) if callable(learning_rate) else learning_rate
    lr = torch.as_tensor(lr, dtype=torch.float32, device=count.device)
    t = safe_increment(count).float()
    if clip_norm:
        if grad_norm is None:
            grad_norm = global_norm(list(updates.values()))
        # optax.clip_by_global_norm: identity below the threshold, exact
        # max_norm/g_norm scale above it
        clip = torch.where(grad_norm < clip_norm, torch.ones_like(grad_norm),
                           clip_norm / grad_norm)
    else:
        clip = torch.ones((), dtype=torch.float32, device=count.device)
    return torch.stack([lr.reshape(()), clip.float(),
                        1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)])


def _decay_tree(params, weight_decay, mask):
    """Per-leaf weight decay (the mask, a dict of bools or a callable
    returning one, routes decay away from biases and norms)."""
    if not weight_decay:
        return {name: 0.0 for name in params}
    if mask is None:
        return {name: float(weight_decay) for name in params}
    flags = mask(params) if callable(mask) else mask
    return {name: float(weight_decay) if flags[name] else 0.0
            for name in params}


def adamw_fused(learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                weight_decay=0.0, mask=None, clip_norm=None, mu_dtype=None):
    """Fused AdamW: the math of ``optax.chain(clip_by_global_norm(
    clip_norm), adamw(...))`` in one pass per leaf.  ``learning_rate`` may
    be a schedule (called with the update count, optax convention).
    ``mu_dtype`` stores the first moment narrower (bf16, rounded to
    nearest even); nu keeps the parameter's dtype."""
    if isinstance(mu_dtype, str):
        mu_dtype = getattr(torch, mu_dtype)

    def init_fn(params):
        first = next(iter(params.values()))
        return FusedAdamWState(
            count=torch.zeros((), dtype=torch.int32, device=first.device),
            mu={n: torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()})

    @torch.no_grad()
    def _run(updates, state, params, write_param, grad_norm):
        if params is None:
            if weight_decay:
                raise ValueError(
                    "adamw_fused with weight_decay requires params "
                    "(optax convention: update(grads, state, params))")
            if write_param:
                raise ValueError("apply() requires params")
            params = updates   # placeholder operand; the kernel skips it
        scal = _scalars(learning_rate, state.count, clip_norm, b1, b2,
                        updates, grad_norm)
        wds = _decay_tree(updates, weight_decay, mask)
        out = {}
        for name, g in updates.items():
            p = params[name]
            # apply: in place into the parameter, where JAX donates it
            dst = p if write_param else torch.empty_like(g)
            # mu and nu in place, where the JAX train step donates them
            _adamw(g, p, state.mu[name], state.nu[name], scal, dst, b1=b1,
                   b2=b2, eps=eps, wd=wds[name], write_param=write_param)
            out[name] = dst
        return out, FusedAdamWState(safe_increment(state.count), state.mu,
                                    state.nu)

    def update_fn(updates, state, params=None, *, grad_norm=None):
        return _run(updates, state, params, False, grad_norm)

    def apply_fn(updates, state, params, *, grad_norm=None):
        return _run(updates, state, params, True, grad_norm)

    return FusedOptimizer(init_fn, update_fn, apply_fn)


def lion_fused(*args, **kwargs):
    """Not ported: the fused Lion kernel."""
    raise NotImplementedError(
        "lion_fused is not ported yet (ROADMAP: kernel 8, the fused Lion "
        "kernel)")
