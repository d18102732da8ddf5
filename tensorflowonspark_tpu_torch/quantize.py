"""Weight-only int8 / int4 post-training quantisation for serving —
counterpart of ``tensorflowonspark_tpu/quantize.py`` on tensors.

Storage keeps the JAX package's layout and bytes:

- int8 (W8A16): ``{"q": [K, N] int8, "scale": [1, N] f32}``, one scale
  per output channel, ``scale = max(amax, 1e-12) / 127``;
- int4 (W4A16): :class:`Int4Weight`, two signed 4-bit values per int8
  byte along the input dim (row ``2i`` in the low nibble, ``2i + 1`` in
  the high one) and one f32 scale per (``group_size`` input rows, output
  channel), ``scale = max(amax, 1e-12) / 7``; K is zero-padded to whole
  groups and ``in_dim`` records the unpadded K.

Values divide by the scale (no reciprocal, on the card too), round half
to even and clip to +-127 / +-7, so the bytes equal
``quantize.quantize_tree``'s on the CPU and on the card.

On a model, :func:`quantize_module` turns every ``Dense`` weight of at
least ``min_elements`` elements (the JAX ``DEFAULT_TARGETS = "kernel$"``
selection: attention and MLP projections and ``lm_head``; never
embeddings, norm scales or biases) into ``q`` / ``scale`` buffers, which
``Dense`` then consumes through ``ops.quant_matmul`` (kernels 9 and 10).
Quantise from the f32 masters, then :func:`cast_float_leaves` to the
compute width: it skips the scales, which must stay f32.
"""
import logging

import torch

logger = logging.getLogger(__name__)

DEFAULT_GROUP_SIZE = 128
MODES = ("int8", "int4")


class Int4Weight:
    """A nibble-packed int4 kernel: ``q [ceil(K/G) * G/2, N]`` int8,
    ``scale [ceil(K/G), N]`` f32, ``in_dim`` K (unpadded), ``group_size``
    G.  The same fields as the JAX package's ``Int4Weight``."""

    __slots__ = ("q", "scale", "in_dim", "group_size")

    def __init__(self, q, scale, in_dim, group_size):
        self.q = q
        self.scale = scale
        self.in_dim = int(in_dim)
        self.group_size = int(group_size)

    @property
    def out_dim(self):
        return self.q.shape[-1]

    def __repr__(self):
        return (f"Int4Weight(in_dim={self.in_dim}, out_dim={self.out_dim}, "
                f"group_size={self.group_size})")


def is_int8_leaf(node):
    """An int8 ``{"q", "scale"}`` dict (the int8 dtype tells it from a
    float dict that happens to use those keys)."""
    return (isinstance(node, dict) and set(node) == {"q", "scale"}
            and getattr(node["q"], "dtype", None) == torch.int8)


def _true_div(t, divisor):
    """``t / divisor`` correctly rounded on every device: on the card a
    Python-scalar divisor becomes a multiply by its reciprocal, which can
    differ from JAX's division in the last bit."""
    return t / torch.full_like(t, divisor)


def quantize_int8(w):
    """A float ``[K, N]`` kernel -> ``{"q": int8 [K, N], "scale": f32
    [1, N]}`` with per-output-channel symmetric scales."""
    w = torch.as_tensor(w).float().contiguous()   # q comes out [K, N]
    if w.ndim != 2:
        raise ValueError(f"quantize_int8 needs a 2-D [in, out] kernel, got "
                         f"shape {tuple(w.shape)}")
    amax = w.abs().amax(dim=0, keepdim=True)
    scale = _true_div(amax.clamp_min(1e-12), 127.0)
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def int4_pack(w, group_size=DEFAULT_GROUP_SIZE):
    """A float ``[K, N]`` kernel -> :class:`Int4Weight` with
    per-(group, output-channel) symmetric scales, values in [-7, 7]."""
    if group_size < 2 or group_size % 2:
        raise ValueError(f"group_size must be even and >= 2, got "
                         f"{group_size}")
    w = torch.as_tensor(w).float().contiguous()
    if w.ndim != 2:
        raise ValueError(f"int4_pack needs a 2-D [in, out] kernel, got "
                         f"shape {tuple(w.shape)}")
    in_dim, out_dim = w.shape
    n_groups = -(-in_dim // group_size)
    padded = n_groups * group_size
    if padded != in_dim:
        w = torch.cat([w, w.new_zeros(padded - in_dim, out_dim)])
    grouped = w.reshape(n_groups, group_size, out_dim)
    scale = _true_div(grouped.abs().amax(dim=1).clamp_min(1e-12), 7.0)
    q = torch.round(grouped / scale[:, None, :]).clamp(-7, 7)
    q = q.reshape(padded, out_dim).to(torch.int32)
    packed = (q[0::2] & 0x0F) | ((q[1::2] & 0x0F) << 4)   # 0..255
    packed = packed.to(torch.uint8).view(torch.int8).contiguous()
    return Int4Weight(packed, scale, in_dim, group_size)


def int4_unpack(w):
    """The f32 ``[in_dim, N]`` kernel of an :class:`Int4Weight` (the
    padding rows sliced off): the dequantisation kernel 10 computes."""
    p = w.q.to(torch.int32)
    lo = ((p << 28) >> 28).float()          # arithmetic shifts sign-extend
    hi = ((p << 24) >> 28).float()
    rows = torch.stack([lo, hi], dim=1).reshape(2 * p.shape[0], p.shape[1])
    scales = torch.repeat_interleave(w.scale.float(), w.group_size, dim=0)
    return (rows * scales)[:w.in_dim]


def dequantize_leaf(node, dtype=None):
    """A quantised leaf -> its float ``[K, N]`` kernel (f32 unless
    ``dtype``)."""
    target = torch.float32 if dtype is None else dtype
    if is_int8_leaf(node):
        return (node["q"].float() * node["scale"].float()).to(target)
    if isinstance(node, Int4Weight):
        return int4_unpack(node).to(target)
    raise TypeError(f"not a quantized leaf: {type(node)!r}")


def _dense_modules(model):
    from tensorflowonspark_tpu_torch.models.transformer import Dense

    return [(name, mod) for name, mod in model.named_modules()
            if isinstance(mod, Dense)]


def quantize_module(model, mode="int8", group_size=DEFAULT_GROUP_SIZE,
                    min_elements=4096):
    """Quantise every ``Dense`` weight of ``model`` with at least
    ``min_elements`` elements in place (``Dense.set_quantized``); returns
    the names of the quantised modules.  Raises when nothing matched, as
    ``quantize_tree`` does."""
    if mode not in MODES:
        raise ValueError(f"mode must be 'int8' or 'int4', got {mode!r}")
    done = []
    with torch.no_grad():
        for name, mod in _dense_modules(model):
            if mod.quant is not None or mod.weight.numel() < min_elements:
                continue
            kernel = mod.weight.float().t()          # [in, out], f32
            if mode == "int8":
                mod.set_quantized(quantize_int8(kernel))
            else:
                mod.set_quantized(int4_pack(kernel, group_size))
            done.append(name)
    if not done:
        raise ValueError(f"no Dense weight has >= {min_elements} elements")
    qb, fb = quantized_bytes(model)
    logger.info("quantized %d kernels to %s (weight bytes %.2fx smaller)",
                len(done), mode, fb / max(qb, 1))
    return done


def quantized_modes(model):
    """The quantisation modes present in ``model`` (a sorted tuple)."""
    return tuple(sorted({mod.quant for _, mod in _dense_modules(model)
                         if mod.quant is not None}))


def cast_float_leaves(model, dtype):
    """Cast the floating parameters and buffers of ``model`` to ``dtype``
    in place, SKIPPING the scales of quantised weights: they stay f32 (a
    blanket ``model.to(dtype)`` would round them to the compute width).
    Returns ``model``."""
    keep = {id(mod.scale) for _, mod in _dense_modules(model)
            if mod.quant is not None}
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            if t.is_floating_point() and id(t) not in keep:
                t.data = t.data.to(dtype)
    return model


def quantized_bytes(model):
    """``(quantized_bytes, float_equivalent_bytes)`` over the quantised
    weights of ``model``; the float equivalent counts f32, as the JAX
    package does."""
    qb = fb = 0
    for _, mod in _dense_modules(model):
        if mod.quant is None:
            continue
        qb += mod.q.numel() + mod.scale.numel() * 4
        fb += mod.in_features * mod.out_features * 4
    return qb, fb


def max_abs_error(model, qmodel):
    """Worst |W - dequant(Q)| over the weights ``qmodel`` quantised,
    against the float ``model`` of the same structure (the quantisation
    noise bound: half a scale step per channel or group)."""
    floats = dict(_dense_modules(model))
    worst = 0.0
    for name, mod in _dense_modules(qmodel):
        if mod.quant is None:
            continue
        w = floats[name].weight.detach().float().t()
        deq = dequantize_leaf(mod.quantized_leaf()).to(w.device)
        worst = max(worst, (w - deq).abs().max().item())
    return worst
