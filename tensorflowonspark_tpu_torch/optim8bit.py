"""8-bit blockwise-quantised Adam state — counterpart of
``tensorflowonspark_tpu/optim8bit.py``.

Both moments are stored as int8 with one f32 scale per block of
``block_size`` values, about a quarter of f32 AdamW's moment bytes:

- **mu** (first moment): symmetric linear int8, ``q = round(m / s *
  127)`` with ``s`` the block's absmax;
- **nu** stored as ``sqrt(v)`` with the UNSIGNED map (``signed=False``):
  ``q = round(x / s * 254) - 127``, so the whole int8 range covers
  ``[0, s]``.

The transform is optax-style (``init`` / ``update``), so weight decay
and the learning rate chain around it as around ``scale_by_adam``:

    opt = optim8bit.adamw8bit(3e-4, weight_decay=0.1)
    # or optim.make_optimizer("adamw8bit", ...)

Trees are dicts ``{name: tensor}``; the state's ``mu`` / ``nu_sqrt`` map
each name to a :class:`Quantized`, blocked over the row-major flatten of
the tensor as it is stored.  The arithmetic follows the JAX module's
expression order (``b1 * mu + (1 - b1) * g``, bias corrections ``b **
count`` in f32, a count that increments without saturation); every
division is by a tensor, so the card divides exactly as the CPU does,
and square roots go through :func:`sqrt`, which rounds as the CPU does.
Shard-aligned block layouts (the JAX ``layouts=``) wait for multi-GPU
sharding and raise NotImplementedError.
"""
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

DEFAULT_BLOCK = 256
_LAYOUTS = ("shard-aligned quantisation layouts are not ported yet "
            "(ROADMAP: multi-GPU sharding)")


class Quantized(NamedTuple):
    """Blockwise-quantised tensor: int8 payload ``[n_blocks, block]`` and
    f32 scales ``[n_blocks, 1]``.  The shape is not stored:
    :func:`dequantize` takes it from the tensor it is paired with."""
    q: Any
    scale: Any


def _const(value, like):
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def quantize(x, block=DEFAULT_BLOCK, signed=True, layout=None):
    """A float tensor -> :class:`Quantized`, linear absmax per block of
    its row-major flatten (zero-padded to whole blocks).  ``signed``:
    symmetric int8 in [-127, 127]; unsigned (for nonnegative tensors):
    ``round(x / s * 254) - 127``."""
    if layout is not None:
        raise NotImplementedError(_LAYOUTS)
    flat = x.reshape(1, -1).float()
    pad = (-flat.shape[1]) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    if signed:
        q = torch.clamp(torch.round(blocks / safe * 127.0), -127, 127)
    else:
        q = torch.clamp(torch.round(blocks / safe * 254.0) - 127.0, -127,
                        127)
    return Quantized(q.to(torch.int8), scale)


def dequantize(qt, shape, dtype=torch.float32, signed=True, layout=None):
    """:class:`Quantized` -> a tensor of ``shape`` in ``dtype``."""
    if layout is not None:
        raise NotImplementedError(_LAYOUTS)
    if signed:
        flat = qt.q.float() * (qt.scale / _const(127.0, qt.scale))
    else:
        flat = (qt.q.float() + 127.0) * (qt.scale / _const(254.0, qt.scale))
    return flat.reshape(-1)[:math.prod(shape)].reshape(shape).to(dtype)


def sqrt(x):
    """Correctly rounded f32 square root on any device.  The f32
    ``torch.sqrt`` is not correctly rounded in every build (on an H100
    the card's and the host's differ in the last bit on some inputs);
    the f64 root rounded to f32 is the correctly rounded f32
    root (53 >= 2 x 24 + 2 bits, so the double rounding is harmless)."""
    return torch.sqrt(x.double()).float()


def shard_layout(shape, sharding):
    """Not ported: per-dim shard counts of a sharded parameter."""
    raise NotImplementedError(_LAYOUTS)


def layouts_for_shardings(params, shardings):
    """Not ported: the ``layouts=`` tree of a sharded parameter tree."""
    raise NotImplementedError(_LAYOUTS)


class Adam8bitState(NamedTuple):
    count: Any
    mu: Any        # {name: Quantized}
    nu_sqrt: Any   # {name: Quantized} of sqrt(v)


def scale_by_adam_8bit(b1=0.9, b2=0.999, eps=1e-8, block_size=DEFAULT_BLOCK,
                       layouts=None):
    """``optax.scale_by_adam`` with int8 blockwise moments (see the
    module doc)."""
    from tensorflowonspark_tpu_torch.optim import GradientTransformation

    if layouts is not None:
        raise NotImplementedError(_LAYOUTS)

    def init_fn(params):
        def zeros(p, signed):
            return quantize(torch.zeros(p.shape, device=p.device),
                            block_size, signed=signed)
        first = next(iter(params.values()))
        return Adam8bitState(
            torch.zeros((), dtype=torch.int32, device=first.device),
            {n: zeros(p, True) for n, p in params.items()},
            {n: zeros(p, False) for n, p in params.items()})

    def update_fn(updates, state, params=None):
        count = state.count + 1
        t = count.float()
        c1 = 1 - torch.pow(b1, t)
        c2 = 1 - torch.pow(b2, t)
        out, mu_q, nu_q = {}, {}, {}
        for n, g in updates.items():
            g = g.float()
            mu = dequantize(state.mu[n], g.shape)
            v = dequantize(state.nu_sqrt[n], g.shape, signed=False)
            v = v * v
            mu = b1 * mu + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            out[n] = (mu / c1) / (sqrt(v / c2) + eps)
            mu_q[n] = quantize(mu, block_size)
            nu_q[n] = quantize(sqrt(v), block_size, signed=False)
        return out, Adam8bitState(count, mu_q, nu_q)

    return GradientTransformation(init_fn, update_fn)


def adamw8bit(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
              mask=None, block_size=DEFAULT_BLOCK, layouts=None):
    """AdamW with 8-bit state: ``scale_by_adam_8bit`` -> weight decay
    (when nonzero) -> the learning rate."""
    from tensorflowonspark_tpu_torch import optim

    parts = [scale_by_adam_8bit(b1, b2, eps, block_size, layouts=layouts)]
    if weight_decay:
        parts.append(optim.add_decayed_weights(weight_decay, mask))
    parts.append(optim.scale_by_learning_rate(learning_rate))
    return optim.chain(*parts)
