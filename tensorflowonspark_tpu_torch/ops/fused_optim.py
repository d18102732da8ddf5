"""Single-pass fused AdamW (kernel 7) and Lion (kernel 8).

Counterpart of ``tensorflowonspark_tpu/ops/fused_optim.py``.  The whole
update of a parameter (clip scale, moments, bias corrections, decoupled
weight decay, learning rate, the parameter write) runs as one pass over
it: g, p and the moments are read once and p and the moments written
once.  Lion keeps one moment (``mu``) where AdamW keeps two.

Trees are dicts ``{name: tensor}`` (``dict(model.named_parameters())``);
``FusedAdamWState.mu/nu`` and ``FusedLionState.mu`` mirror them name
for name.  The objects that :func:`adamw_fused` and :func:`lion_fused`
return have the JAX package's three methods:

    ``init(params)`` -> state
    ``update(grads, state, params=None)`` -> (updates, state)
    ``apply(grads, state, params)`` -> (params, state)

``apply`` writes the parameters and the moments IN PLACE, where the JAX
train step donates their buffers; ``update`` writes ``-lr * upd`` into
new tensors and updates the moments in place too.  Both take an
optional ``grad_norm``: the train step passes the global norm it
computes for its metrics, so the reduction runs once (in the JAX package
XLA merges the two).

The four step scalars ``[lr, clip, 1 - b1^t, 1 - b2^t]`` are computed on
the device (the schedule of the count, the clip scale from the global
gradient norm, the bias corrections in f32; Lion reads the first two)
and the kernels read them from a device pointer, so no step waits on the
host.

One rule per leaf: a CPU tensor takes :func:`adamw_plain` /
:func:`lion_plain`; a CUDA tensor launches ``csrc/fused_optim.cu`` or
raises.  The JAX functions' ``block_rows`` and ``interpret`` are TPU grid
and interpreter knobs and are not in the signatures.
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


class FusedLionState(NamedTuple):
    """Fused-Lion state; mu mirrors the param dict name for name."""
    count: Any
    mu: Any


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


def _check_card(g, same_dtype, **tensors):
    """The in-place kernels' preconditions on the card: every tensor on
    the grad's device and contiguous, ``same_dtype`` sharing the grad's
    dtype, one size, f32 step scalars."""
    if g.device.type != "cuda":
        raise RuntimeError(f"fused optimizer: no kernel for {g.device}")
    for name, t in tensors.items():
        if t.device != g.device:
            raise ValueError(f"{name} is on {t.device}, the grad on "
                             f"{g.device}")
        # the update is in place: a copy would lose it
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the in-place "
                             "optimizer kernel")
    if any(tensors[n].dtype != g.dtype for n in same_dtype):
        raise TypeError(f"grad, {', '.join(same_dtype)} must share one "
                        "dtype on the card")
    if any(t.numel() != g.numel() for n, t in tensors.items()
           if n != "scalars"):
        raise ValueError("grad, param and moments must have one size")
    scalars = tensors["scalars"]
    if scalars.dtype != torch.float32 or scalars.numel() != 4:
        raise ValueError("scalars must be f32 [lr, clip, 1-b1^t, 1-b2^t]")


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
    _check_card(g, ("param", "nu", "out"), param=p, mu=mu, nu=nu, out=out,
                scalars=scalars)
    g = g.contiguous()
    P = _build.ptr
    _build.launch("tos_adamw", g.device,
        P(g), P(p), P(mu), P(nu), P(out), P(scalars), g.numel(), float(b1),
        1.0 - b1, float(b2), 1.0 - b2, float(eps), float(wd),
        int(write_param), _build.dtype_code(g), _build.dtype_code(mu))
    _adamw.launches += 1


_adamw.launches = 0


def sign(x):
    """``jnp.sign``: +-1 for a nonzero value, the value itself for +-0
    and NaN (``torch.sign`` maps NaN to 0 and -0 to +0)."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


def lion_plain(g, p, mu, scalars, *, b1, b2, wd, write_param):
    """Plain version of kernel 8 for one leaf: ``(out, mu)`` in the TPU
    kernel's expression order (f32 math; out in p's dtype, or g's for
    ``update``; mu in its own dtype).  ``scalars[0:2]`` are lr and the
    clip scale."""
    lr, clip = scalars[0], scalars[1]
    gf = g.float() * clip
    mf = mu.float()
    upd = sign((1.0 - b1) * gf + b1 * mf)
    new_mu = (1.0 - b2) * gf + b2 * mf
    pf = p.float()
    if wd:
        upd = upd + wd * pf
    if write_param:
        out = (pf - lr * upd).to(p.dtype)
    else:
        out = (-lr * upd).to(g.dtype)
    return out, new_mu.to(mu.dtype)


def _lion(g, p, mu, scalars, out, *, b1, b2, wd, write_param):
    """Kernel 8 on one leaf: writes ``out`` (p itself for ``apply``) and
    mu in place.  CPU tensors take :func:`lion_plain`."""
    if g.device.type == "cpu":
        o, m = lion_plain(g, p, mu, scalars, b1=b1, b2=b2, wd=wd,
                          write_param=write_param)
        out.copy_(o)
        mu.copy_(m)
        return
    _check_card(g, ("param", "out"), param=p, mu=mu, out=out,
                scalars=scalars)
    g = g.contiguous()
    P = _build.ptr
    _build.launch("tos_lion", g.device,
        P(g), P(p), P(mu), P(out), P(scalars), g.numel(), float(b1),
        1.0 - b1, float(b2), 1.0 - b2, float(wd), int(write_param),
        _build.dtype_code(g), _build.dtype_code(mu))
    _lion.launches += 1


_lion.launches = 0


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


def _fused(name, init_fn, leaf, learning_rate, b1, b2, weight_decay, mask,
           clip_norm):
    """The :class:`FusedOptimizer` of a single-pass kernel: ``leaf(g, p,
    moments, scalars, out, wd, write_param)`` runs it on one leaf; the
    state is ``(count, *moment dicts)``."""

    @torch.no_grad()
    def _run(updates, state, params, write_param, grad_norm):
        if params is None:
            if weight_decay:
                raise ValueError(
                    f"{name} with weight_decay requires params "
                    "(optax convention: update(grads, state, params))")
            if write_param:
                raise ValueError("apply() requires params")
            params = updates   # placeholder operand; the kernel skips it
        scal = _scalars(learning_rate, state.count, clip_norm, b1, b2,
                        updates, grad_norm)
        wds = _decay_tree(updates, weight_decay, mask)
        out = {}
        for n, g in updates.items():
            p = params[n]
            # apply: in place into the parameter, where JAX donates it
            dst = p if write_param else torch.empty_like(g)
            # the moments in place, where the JAX train step donates them
            leaf(g, p, [m[n] for m in state[1:]], scal, dst, wds[n],
                 write_param)
            out[n] = dst
        return out, type(state)(safe_increment(state.count), *state[1:])

    def update_fn(updates, state, params=None, *, grad_norm=None):
        return _run(updates, state, params, False, grad_norm)

    def apply_fn(updates, state, params, *, grad_norm=None):
        return _run(updates, state, params, True, grad_norm)

    return FusedOptimizer(init_fn, update_fn, apply_fn)


def _zero_state(cls, params, mu_dtype, n_full):
    """``cls(count 0, mu in mu_dtype, then n_full moments in each
    parameter's dtype)``, on the parameters' device."""
    first = next(iter(params.values()))
    return cls(torch.zeros((), dtype=torch.int32, device=first.device),
               {n: torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                for n, p in params.items()},
               *({n: torch.zeros_like(p) for n, p in params.items()}
                 for _ in range(n_full)))


def adamw_fused(learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                weight_decay=0.0, mask=None, clip_norm=None, mu_dtype=None):
    """Fused AdamW: the math of ``optax.chain(clip_by_global_norm(
    clip_norm), adamw(...))`` in one pass per leaf.  ``learning_rate`` may
    be a schedule (called with the update count, optax convention).
    ``mu_dtype`` stores the first moment narrower (bf16, rounded to
    nearest even); nu keeps the parameter's dtype."""
    if isinstance(mu_dtype, str):
        mu_dtype = getattr(torch, mu_dtype)

    def leaf(g, p, moments, scal, out, wd, write_param):
        _adamw(g, p, *moments, scal, out, b1=b1, b2=b2, eps=eps, wd=wd,
               write_param=write_param)

    return _fused("adamw_fused",
                  lambda params: _zero_state(FusedAdamWState, params,
                                             mu_dtype, 1),
                  leaf, learning_rate, b1, b2, weight_decay, mask, clip_norm)


def lion_fused(learning_rate, b1=0.9, b2=0.99, weight_decay=0.0, mask=None,
               clip_norm=None, mu_dtype=None):
    """Fused Lion (sign momentum): the math of ``optax.chain(
    clip_by_global_norm(clip_norm), lion(...))`` in one pass per leaf,
    with half of AdamW's moment state.  The kernel upcasts a bf16 mu to
    f32 before ``b1 * mu``, as the TPU kernel does (optax's plain
    ``lion`` multiplies in bf16 first)."""
    if isinstance(mu_dtype, str):
        mu_dtype = getattr(torch, mu_dtype)

    def leaf(g, p, moments, scal, out, wd, write_param):
        _lion(g, p, *moments, scal, out, b1=b1, b2=b2, wd=wd,
              write_param=write_param)

    return _fused("lion_fused",
                  lambda params: _zero_state(FusedLionState, params,
                                             mu_dtype, 0),
                  leaf, learning_rate, b1, b2, weight_decay, mask, clip_norm)
