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
Shard-aligned block layouts (the JAX ``layouts=``): with a
:class:`Layout` from :func:`layouts_for_shardings`, blocks are computed
over each logical shard's own elements (shard-major flatten, per-shard
padding), in the JAX package's dim order (a ``Dense`` weight is
quantised through its flax ``[in, out]`` transpose), so the payload
bytes are JAX's.  A layout serves a full tensor (the shard-major payload
of every shard) and a rank's local shard alike (that shard's rows): under
fsdp each rank quantises its own shard, and the shards' payloads,
concatenated in rank order, are JAX's aligned payload.
"""
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

DEFAULT_BLOCK = 256


class Layout(NamedTuple):
    """A shard-aligned block layout.  ``counts`` is the JAX package's
    layout (per-dim shard counts) and ``shape`` the parameter's full
    shape, both in the JAX package's dim order; ``transposed``: the port
    stores the parameter transposed (a ``Dense`` weight)."""
    counts: tuple
    shape: tuple
    transposed: bool = False


class Quantized(NamedTuple):
    """Blockwise-quantised tensor: int8 payload ``[n_blocks, block]`` and
    f32 scales ``[n_blocks, 1]``.  The shape is not stored:
    :func:`dequantize` takes it from the tensor it is paired with."""
    q: Any
    scale: Any


def _const(value, like):
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _shard_major(x, layout):
    """Reshape ``x`` to ``[n_shards, elems_per_shard]``, shard-major: row k
    holds the elements of shard k (dim-major shard order, as GSPMD
    numbers them)."""
    r = x.dim()
    split = []
    for d, n in zip(x.shape, layout):
        split.extend((n, d // n))
    perm = [2 * i for i in range(r)] + [2 * i + 1 for i in range(r)]
    return x.reshape(split).permute(perm).reshape(math.prod(layout), -1)


def _shard_major_inverse(flat, shape, layout):
    """Invert :func:`_shard_major`: ``[n_shards, elems_per_shard]`` ->
    ``shape``."""
    r = len(shape)
    sub = tuple(d // n for d, n in zip(shape, layout))
    perm = []
    for i in range(r):
        perm.extend((i, r + i))
    return flat.reshape(tuple(layout) + sub).permute(perm).reshape(shape)


def _check_layout(layout, shape):
    """Validate ``layout`` against ``shape``; normalise all-ones to None."""
    if layout is None:
        return None
    if len(layout) != len(shape) or any(
            d % n for d, n in zip(shape, layout)):
        raise ValueError(f"layout {tuple(layout)} does not tile shape "
                         f"{tuple(shape)}")
    return None if all(n == 1 for n in layout) else tuple(layout)


def _resolve(layout, shape):
    """``(transposed, counts)`` of a tensor of the port's ``shape`` under
    ``layout``: a plain tuple is a JAX layout over ``shape`` itself; a
    :class:`Layout` serves the full tensor (its counts) or one shard of
    it (None: the shard is one block run)."""
    if not isinstance(layout, Layout):
        return False, _check_layout(layout, shape)
    shape = tuple(shape)
    if layout.transposed:
        shape = shape[::-1]
    if shape == tuple(layout.shape):
        return layout.transposed, _check_layout(layout.counts, shape)
    local = tuple(d // n for d, n in zip(layout.shape, layout.counts))
    if shape == local:
        return layout.transposed, None
    raise ValueError(f"layout {tuple(layout.counts)} of shape "
                     f"{tuple(layout.shape)} fits neither that shape nor its "
                     f"shard {local}: got {shape}")


def expected_blocks(shape, layout, block):
    """Block-row count of a payload quantised with ``layout`` (per-shard
    padding: each shard's elements round up to whole blocks)."""
    n_shards = math.prod(layout)
    per_shard = math.prod(shape) // n_shards
    return n_shards * (-(-per_shard // block))


def quantize(x, block=DEFAULT_BLOCK, signed=True, layout=None):
    """A float tensor -> :class:`Quantized`, linear absmax per block of
    its row-major flatten (zero-padded to whole blocks).  ``signed``:
    symmetric int8 in [-127, 127]; unsigned (for nonnegative tensors):
    ``round(x / s * 254) - 127``.  ``layout`` (a :class:`Layout`, or a
    JAX layout tuple over ``x``'s own dims): blocks over each shard's
    own elements, in the JAX dim order (see the module doc); pass the
    same ``layout`` to :func:`dequantize`."""
    transposed, counts = _resolve(layout, x.shape)
    if transposed:
        x = x.t()
    if counts is None:
        flat = x.reshape(1, -1).float()
    else:
        flat = _shard_major(x.float(), counts)
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
    """:class:`Quantized` -> a tensor of ``shape`` in ``dtype`` (the
    port's shape; ``layout`` as given to :func:`quantize`)."""
    if signed:
        flat = qt.q.float() * (qt.scale / _const(127.0, qt.scale))
    else:
        flat = (qt.q.float() + 127.0) * (qt.scale / _const(254.0, qt.scale))
    transposed, counts = _resolve(layout, shape)
    shape = tuple(shape)[::-1] if transposed else tuple(shape)
    if counts is None:
        out = flat.reshape(-1)[:math.prod(shape)].reshape(shape)
    else:
        n_shards, block = math.prod(counts), qt.q.shape[-1]
        if qt.q.shape[0] != expected_blocks(shape, counts, block):
            raise ValueError(
                f"payload {tuple(qt.q.shape)} was not quantized with layout "
                f"{counts} for shape {shape} (expected "
                f"{expected_blocks(shape, counts, block)} blocks)")
        flat = flat.reshape(n_shards, -1)[:, :math.prod(shape) // n_shards]
        out = _shard_major_inverse(flat, shape, counts)
    return (out.t() if transposed else out).to(dtype)


def sqrt(x):
    """Correctly rounded f32 square root on any device.  The f32
    ``torch.sqrt`` is not correctly rounded in every build (on an H100
    the card's and the host's differ in the last bit on some inputs);
    the f64 root rounded to f32 is the correctly rounded f32
    root (53 >= 2 x 24 + 2 bits, so the double rounding is harmless)."""
    return torch.sqrt(x.double()).float()


def shard_layout(shape, sharding):
    """The :class:`Layout` of a parameter of the port's ``shape`` (its
    full shape) under ``sharding`` (a ``parallel.mesh.NamedSharding``),
    or None: unsharded, scalar, indivisible, or no mesh."""
    mesh = getattr(sharding, "mesh", None)
    if mesh is None or not shape:
        return None
    transposed = bool(getattr(sharding, "transposed", False))
    shape = tuple(shape)[::-1] if transposed else tuple(shape)
    spec = tuple(getattr(sharding, "spec", ()) or ())
    counts = []
    for i, d in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        names = (() if entry is None
                 else entry if isinstance(entry, tuple) else (entry,))
        n = math.prod(mesh.shape.get(a, 1) for a in names)
        if n > 1 and d % n:
            return None
        counts.append(n)
    if all(n == 1 for n in counts):
        return None
    return Layout(tuple(counts), shape, transposed)


def layouts_for_shardings(params, shardings):
    """``{name: shard_layout}`` of a parameter tree (an ``nn.Module`` or a
    dict of tensors, at their FULL shapes: build the optimizer before
    ``create_train_state`` shards them) under ``shardings``, for the
    ``layouts=`` of :func:`adamw8bit` and of ``make_train_step``."""
    tensors = (dict(params.named_parameters())
               if hasattr(params, "named_parameters") else params)
    return {n: shard_layout(tuple(t.shape), shardings[n])
            for n, t in tensors.items()}


class Adam8bitState(NamedTuple):
    count: Any
    mu: Any        # {name: Quantized}
    nu_sqrt: Any   # {name: Quantized} of sqrt(v)


def scale_by_adam_8bit(b1=0.9, b2=0.999, eps=1e-8, block_size=DEFAULT_BLOCK,
                       layouts=None):
    """``optax.scale_by_adam`` with int8 blockwise moments (see the
    module doc).  ``layouts`` (``{name: Layout or None}``, from
    :func:`layouts_for_shardings`) aligns each parameter's blocks to its
    shards; the update math is the same."""
    from tensorflowonspark_tpu_torch.optim import GradientTransformation

    lay = (lambda n: None) if layouts is None else (  # noqa: E731
        lambda n: layouts.get(n))

    def init_fn(params):
        def zeros(n, p, signed):
            return quantize(torch.zeros(p.shape, device=p.device),
                            block_size, signed=signed, layout=lay(n))
        first = next(iter(params.values()))
        return Adam8bitState(
            torch.zeros((), dtype=torch.int32, device=first.device),
            {n: zeros(n, p, True) for n, p in params.items()},
            {n: zeros(n, p, False) for n, p in params.items()})

    def update_fn(updates, state, params=None):
        count = state.count + 1
        t = count.float()
        c1 = 1 - torch.pow(b1, t)
        c2 = 1 - torch.pow(b2, t)
        out, mu_q, nu_q = {}, {}, {}
        for n, g in updates.items():
            g, lo = g.float(), lay(n)
            mu = dequantize(state.mu[n], g.shape, layout=lo)
            v = dequantize(state.nu_sqrt[n], g.shape, signed=False,
                           layout=lo)
            v = v * v
            mu = b1 * mu + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            out[n] = (mu / c1) / (sqrt(v / c2) + eps)
            mu_q[n] = quantize(mu, block_size, layout=lo)
            nu_q[n] = quantize(sqrt(v), block_size, signed=False, layout=lo)
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
