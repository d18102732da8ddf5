"""Optimizer and learning-rate schedule factory — counterpart of
``tensorflowonspark_tpu/optim.py``.

    opt, schedule = optim.make_optimizer(
        "adamw_fused", learning_rate=3e-4, warmup_steps=1000,
        total_steps=100_000, schedule="cosine", weight_decay=0.1,
        clip_norm=1.0, decay_mask=optim.default_decay_mask)

Trees are dicts ``{name: tensor}`` (``dict(model.named_parameters())``).
An optimizer is an optax-style pair ``init(params) -> state`` /
``update(grads, state, params=None) -> (updates, state)``; apply the
updates with :func:`apply_updates`.  ``adamw_fused`` (kernel 7,
``ops.fused_optim``) adds the single-pass ``apply(grads, state, params)``
that the train step takes, with clipping and decay folded in.  The plain
optimizers (``adam``, ``adamw``, ``sgd``) are PyTorch tensor code with
optax's semantics and expression order.

Schedules take the update count (an int or an integer tensor, optax's
convention: ``lr = schedule(count)`` before the count's increment) and
return an f32 tensor on the count's device, so a step on the card reads
its learning rate without a host sync.
"""
import logging
import math
from typing import Any, Callable, NamedTuple

import torch

from tensorflowonspark_tpu_torch.ops import fused_optim
from tensorflowonspark_tpu_torch.ops.fused_optim import (
    global_norm, safe_increment)

logger = logging.getLogger(__name__)

SCHEDULES = ("constant", "cosine", "linear", "rsqrt")
OPTIMIZERS = ("adam", "adamw", "adamw_fused", "adamw8bit", "sgd", "lion",
              "lion_fused", "adafactor")
_FUSED = ("adamw_fused", "lion_fused")
_UNPORTED = {
    "lion": "ROADMAP: the zoo and the rest (optax.lion)",
    "lion_fused": "ROADMAP: kernel 8, the fused Lion kernel",
    "adamw8bit": "ROADMAP: the zoo and the rest (optim8bit)",
    "adafactor": "ROADMAP: the zoo and the rest (optax.adafactor)",
}


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def _count(step):
    return torch.as_tensor(step)


def _constant(value):
    def schedule(step):
        return torch.full_like(_count(step), value, dtype=torch.float32)
    return schedule


def _linear(init_value, end_value, transition_steps):
    """``optax.linear_schedule`` (polynomial of power 1, no offset)."""
    if transition_steps <= 0:
        return _constant(init_value)

    def schedule(step):
        count = _count(step).clamp(0, transition_steps).float()
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def _cosine(init_value, decay_steps, alpha):
    """``optax.cosine_decay_schedule`` (exponent 1)."""
    def schedule(step):
        count = torch.clamp(_count(step).float(), max=float(decay_steps))
        cosine_decay = 0.5 * (1 + torch.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine_decay + alpha)
    return schedule


def _join(schedules, boundaries):
    """``optax.join_schedules``: each schedule sees the steps since its
    boundary."""
    def schedule(step):
        step = _count(step)
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            out = torch.where(step < boundary, out, sched(step - boundary))
        return out
    return schedule


def make_schedule(learning_rate, schedule="constant", warmup_steps=0,
                  total_steps=None, end_value=0.0):
    """Linear warmup into constant / cosine / linear / rsqrt decay.
    ``total_steps`` is required for cosine and linear."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule={schedule!r} not in {SCHEDULES}")
    if schedule in ("cosine", "linear") and not total_steps:
        raise ValueError(f"schedule={schedule!r} requires total_steps")
    decay_steps = max((total_steps or 0) - warmup_steps, 1)
    if schedule == "constant":
        main = _constant(learning_rate)
    elif schedule == "cosine":
        main = _cosine(learning_rate, decay_steps,
                       end_value / learning_rate if learning_rate else 0.0)
    elif schedule == "linear":
        main = _linear(learning_rate, end_value, decay_steps)
    else:  # rsqrt (the classic transformer schedule tail)
        shift = max(warmup_steps, 1)

        def main(step):
            return (learning_rate * (shift ** 0.5)
                    / ((_count(step) + shift).float() ** 0.5))
    if warmup_steps:
        warm = _linear(0.0, learning_rate, warmup_steps)
        return _join([warm, main], [warmup_steps])
    return main


# ---------------------------------------------------------------------------
# plain transforms (optax semantics over dicts of tensors)
# ---------------------------------------------------------------------------

class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class ScaleByAdamState(NamedTuple):
    count: Any
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: Any


class TraceState(NamedTuple):
    trace: Any


def _device_of(params):
    return next(iter(params.values())).device


def _weak(x, t):
    """A Python scalar as JAX combines it with ``t``: in ``t``'s dtype."""
    return torch.tensor(x, dtype=t.dtype, device=t.device)


def _zero_count(params):
    return torch.zeros((), dtype=torch.int32, device=_device_of(params))


def _identity():
    return GradientTransformation(lambda params: (),
                                  lambda u, s, params=None: (u, s))


def chain(*transforms):
    """``optax.chain``: the updates pass through each transform in turn."""
    def init_fn(params):
        return tuple(t.init(params) for t in transforms)

    def update_fn(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)
    return GradientTransformation(init_fn, update_fn)


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8, mu_dtype=None):
    """``optax.scale_by_adam`` (eps_root 0, no nesterov)."""
    def init_fn(params):
        return ScaleByAdamState(
            _zero_count(params),
            {n: torch.zeros_like(p, dtype=mu_dtype or p.dtype)
             for n, p in params.items()},
            {n: torch.zeros_like(p) for n, p in params.items()})

    def update_fn(updates, state, params=None):
        # JAX's weak typing: a Python scalar takes the array's dtype, so
        # b1 * mu of a bf16 mu is bf16(b1) * mu rounded to bf16
        mu = {n: (1 - b1) * g + _weak(b1, state.mu[n]) * state.mu[n]
              for n, g in updates.items()}
        nu = {n: (1 - b2) * (g * g) + b2 * state.nu[n]
              for n, g in updates.items()}
        count = safe_increment(state.count)
        c1 = 1 - torch.pow(b1, count.float())
        c2 = 1 - torch.pow(b2, count.float())
        out = {n: (mu[n] / c1.to(mu[n].dtype))
               / (torch.sqrt(nu[n] / c2.to(nu[n].dtype)) + eps)
               for n in updates}
        if mu_dtype is not None:
            mu = {n: m.to(mu_dtype) for n, m in mu.items()}
        return out, ScaleByAdamState(count, mu, nu)
    return GradientTransformation(init_fn, update_fn)


def add_decayed_weights(weight_decay, mask=None):
    """``optax.add_decayed_weights``: ``u + wd * p`` where the mask is
    True (a dict of bools, or a callable returning one)."""
    def update_fn(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights requires params")
        flags = (mask(params) if callable(mask) else mask) if mask is not None \
            else None
        return {n: u + weight_decay * params[n]
                if flags is None or flags[n] else u
                for n, u in updates.items()}, state
    return GradientTransformation(lambda params: (), update_fn)


def scale_by_learning_rate(schedule):
    """``optax.scale_by_learning_rate`` of a schedule:
    ``-schedule(count) * u``."""
    def init_fn(params):
        return ScaleByScheduleState(_zero_count(params))

    def update_fn(updates, state, params=None):
        step = -schedule(state.count)
        return ({n: step.to(u.dtype) * u for n, u in updates.items()},
                ScaleByScheduleState(safe_increment(state.count)))
    return GradientTransformation(init_fn, update_fn)


def trace(decay):
    """``optax.trace`` (no nesterov): ``t = g + decay * t``."""
    def init_fn(params):
        return TraceState({n: torch.zeros_like(p) for n, p in params.items()})

    def update_fn(updates, state, params=None):
        new = {n: g + decay * state.trace[n] for n, g in updates.items()}
        return new, TraceState(new)
    return GradientTransformation(init_fn, update_fn)


def clip_by_global_norm(max_norm):
    """``optax.clip_by_global_norm``."""
    def update_fn(updates, state, params=None):
        g_norm = global_norm(list(updates.values()))
        trigger = g_norm < max_norm
        return {n: torch.where(trigger, t, (t / g_norm.to(t.dtype)) * max_norm)
                for n, t in updates.items()}, state
    return GradientTransformation(lambda params: (), update_fn)


@torch.no_grad()
def apply_updates(params, updates):
    """``p += u`` for every leaf, in place (``optax.apply_updates``
    returns new arrays; the JAX train step donates the old ones)."""
    for n, p in params.items():
        p.add_(updates[n].to(p.dtype))
    return params


# ---------------------------------------------------------------------------
# the factory
# ---------------------------------------------------------------------------

def make_optimizer(name="adamw", learning_rate=1e-3, schedule="constant",
                   warmup_steps=0, total_steps=None, end_value=0.0,
                   weight_decay=0.0, clip_norm=None, b1=None, b2=None,
                   momentum=0.9, decay_mask=None, mu_dtype=None,
                   layouts=None):
    """``(optimizer, schedule_fn)`` from plain config values, with the
    JAX package's validation.

    ``decay_mask`` (a dict of bools or a callable of the params, e.g.
    :func:`default_decay_mask`) routes weight decay away from biases and
    norms.  ``clip_norm`` prepends global-norm clipping (folded into the
    kernel for ``adamw_fused``).  ``b1``/``b2`` default to each
    optimizer's published defaults.  ``mu_dtype`` (``"bfloat16"``)
    stores the first moment narrower.  ``lion``, ``lion_fused``,
    ``adamw8bit`` and ``adafactor`` raise NotImplementedError."""
    if isinstance(mu_dtype, str):
        mu_dtype = getattr(torch, mu_dtype)
    if mu_dtype is not None and name not in ("adam", "adamw", "lion") + _FUSED:
        raise ValueError(f"optimizer={name!r} has no mu_dtype knob")
    if layouts is not None and name != "adamw8bit":
        raise ValueError(
            f"optimizer={name!r} has no quantized-state layouts knob "
            "(layouts= is adamw8bit-only)")
    if name not in OPTIMIZERS:
        raise ValueError(f"optimizer={name!r} not in {OPTIMIZERS}")
    if (weight_decay or decay_mask is not None) and name not in (
            "adamw", "adamw8bit", "lion") + _FUSED:
        raise ValueError(
            f"optimizer={name!r} has no decoupled weight decay; use adamw, "
            "adamw_fused, adamw8bit, or lion (or drop "
            "weight_decay/decay_mask)")
    if name in _UNPORTED:
        raise NotImplementedError(
            f"optimizer={name!r} is not ported yet ({_UNPORTED[name]})")
    sched = make_schedule(learning_rate, schedule, warmup_steps,
                          total_steps, end_value)
    if name == "adam":
        core = chain(scale_by_adam(b1 or 0.9, b2 or 0.999, mu_dtype=mu_dtype),
                     scale_by_learning_rate(sched))
    elif name == "adamw":
        core = chain(scale_by_adam(b1 or 0.9, b2 or 0.999, mu_dtype=mu_dtype),
                     add_decayed_weights(weight_decay, decay_mask),
                     scale_by_learning_rate(sched))
    elif name == "adamw_fused":
        # single-pass kernel: clip_norm and decay fold INTO the update
        # (chaining a clip around it would waste a pass and lose .apply)
        core = fused_optim.adamw_fused(
            sched, b1=b1 or 0.9, b2=b2 or 0.999, weight_decay=weight_decay,
            mask=decay_mask, clip_norm=clip_norm, mu_dtype=mu_dtype)
    else:  # sgd; momentum=None keeps no trace state
        core = chain(_identity() if momentum is None else trace(momentum),
                     scale_by_learning_rate(sched))
    if clip_norm and name not in _FUSED:
        core = chain(clip_by_global_norm(clip_norm), core)
    logger.info("optimizer %s lr=%s schedule=%s warmup=%d wd=%s clip=%s",
                name, learning_rate, schedule, warmup_steps, weight_decay,
                clip_norm)
    return core, sched


def default_decay_mask(params):
    """True (decay) for >= 2-D kernels, False for biases and norm
    scales."""
    return {n: getattr(p, "ndim", 0) >= 2 for n, p in params.items()}
