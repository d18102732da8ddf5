"""Shared building blocks of the model zoo — counterpart of
``tensorflowonspark_tpu/models/common.py`` (``ChannelGroupNorm``,
``WSConv``, ``IdentityNorm``), and the flax layers the zoo builds on,
with flax's semantics: ``Conv`` (``nn.Conv``, SAME padding as XLA pads
it), ``ConvTranspose`` (``nn.ConvTranspose`` with
``transpose_kernel=False``), ``max_pool``, ``BatchNorm`` (``nn.BatchNorm``)
and ``GroupNorm`` (``nn.GroupNorm``).

Layout: every zoo module takes and returns NHWC ``[B, H, W, C]``
tensors, as the JAX modules do.  A conv reads the NCHW view of that
memory (``permute``), which is PyTorch's channels_last layout, so cuDNN
takes its NHWC kernels without a copy.  Conv kernels are stored OIHW,
as ``F.conv2d`` takes them (``convert`` permutes flax's HWIO).

Dtypes follow flax: a layer built with ``dtype`` casts its input and
kernel to it and computes in it; ``dtype=None`` is f32 (flax promotes
the input with the f32 parameters).  Norm statistics are f32 and the
norms' outputs f32 (``dtype=jnp.float32`` in the JAX modules), with
flax's fast variance ``E[x^2] - E[x]^2`` clipped at 0.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size, k, stride, dilation=1):
    """XLA's SAME padding of one dim: ``(before, after)``, the odd pixel
    after.  PyTorch's ``padding="same"`` refuses strides above 1."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(x, weight, strides=(1, 1), padding="SAME", dilation=(1, 1),
              bias=None):
    """``lax.conv_general_dilated`` over NHWC ``x`` with an OIHW kernel;
    ``padding`` "SAME" or "VALID".  Symmetric SAME padding goes to the
    conv itself; an uneven one (strided convs over even sizes) pads
    explicitly first."""
    xc = x.permute(0, 3, 1, 2)
    pad = 0
    if padding == "SAME":
        kh, kw = weight.shape[2], weight.shape[3]
        ph = same_pads(x.shape[1], kh, strides[0], dilation[0])
        pw = same_pads(x.shape[2], kw, strides[1], dilation[1])
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"padding={padding!r} not in ('SAME', 'VALID')")
    y = F.conv2d(xc, weight, bias, tuple(strides), pad, tuple(dilation))
    return y.permute(0, 2, 3, 1)


def max_pool(x, window, strides, padding="VALID"):
    """``nn.max_pool`` over NHWC ``x`` (SAME pads with -inf)."""
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        ph = same_pads(x.shape[1], window[0], strides[0])
        pw = same_pads(x.shape[2], window[1], strides[1])
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]), value=-math.inf)
    elif padding != "VALID":
        raise ValueError(f"padding={padding!r} not in ('SAME', 'VALID')")
    return F.max_pool2d(xc, tuple(window), tuple(strides)).permute(0, 2, 3, 1)


def _dtype(dtype):
    if dtype is None:
        return torch.float32
    dt = getattr(torch, dtype, None) if isinstance(dtype, str) else dtype
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"dtype={dtype!r} is not a float dtype")
    return dt


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class Conv(nn.Module):
    """``nn.Conv`` over NHWC: kernel ``weight`` OIHW, optional ``bias``,
    input and kernel cast to ``dtype``, the bias added in it."""

    def __init__(self, in_features, features, kernel_size=(3, 3),
                 strides=(1, 1), padding="SAME", use_bias=True, dtype=None,
                 kernel_dilation=(1, 1)):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.weight = nn.Parameter(torch.empty(features, in_features, kh, kw))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)
        self.strides = _pair(strides)
        self.padding = padding
        self.dilation = _pair(kernel_dilation)
        self.dtype = _dtype(dtype)

    def forward(self, x):
        dt = self.dtype
        return conv_nhwc(x.to(dt), self.weight.to(dt), self.strides,
                         self.padding, self.dilation,
                         None if self.bias is None else self.bias.to(dt))


def transpose_pads(k, stride):
    """``lax.conv_transpose``'s SAME padding of the stride-dilated input
    (``_conv_transpose_padding``)."""
    pad_len = k + stride - 2
    before = k - 1 if stride > k - 1 else -(-pad_len // 2)
    return before, pad_len - before


class ConvTranspose(nn.Module):
    """``nn.ConvTranspose`` (``transpose_kernel=False``, SAME): the input
    dilated by the stride, padded by :func:`transpose_pads`, correlated
    with the kernel as stored (not flipped).  ``F.conv_transpose2d`` is
    the gradient of a conv, which flips the kernel and swaps its in / out
    dims, so the kernel goes in flipped and swapped, with the padding and
    ``output_padding`` that give flax's pads."""

    def __init__(self, in_features, features, kernel_size=(4, 4),
                 strides=(2, 2), use_bias=True, dtype=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.weight = nn.Parameter(torch.empty(features, in_features, kh, kw))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)
        self.strides = _pair(strides)
        self.dtype = _dtype(dtype)

    def forward(self, x):
        dt = self.dtype
        w = self.weight.to(dt).transpose(0, 1).flip(2, 3)  # [in, out, h, w]
        pads, extra = [], []
        for k, s in zip(w.shape[2:], self.strides):
            before, after = transpose_pads(k, s)
            pads.append(k - 1 - before)
            extra.append(after - before)
        y = F.conv_transpose2d(
            x.to(dt).permute(0, 3, 1, 2), w,
            None if self.bias is None else self.bias.to(dt), self.strides,
            tuple(pads), tuple(max(e, 0) for e in extra))
        # an after-pad one short of before (k 3 / s 2, say) drops the last
        # row or column
        y = y[:, :, :y.shape[2] + min(extra[0], 0) or None,
              :y.shape[3] + min(extra[1], 0) or None]
        return y.permute(0, 2, 3, 1)


def _normalize(xf, mean, var, eps, scale, bias):
    """flax ``_normalize``: ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias`` in f32."""
    return (xf - mean) * (torch.rsqrt(var + eps) * scale) + bias


def _fast_stats(xf, dims):
    mean = xf.mean(dims, keepdim=True)
    var = ((xf * xf).mean(dims, keepdim=True) - mean * mean).clamp_min(0.0)
    return mean, var


class GroupNorm(nn.Module):
    """``nn.GroupNorm(dtype=float32)`` over NHWC: statistics over (H, W,
    the group's channels) in f32, f32 output."""

    def __init__(self, channels, num_groups, eps=1e-5, zero_scale=False):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{channels} channels do not split into "
                             f"{num_groups} groups")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(channels) if zero_scale
                                   else torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        G, C = self.num_groups, x.shape[-1]
        xf = x.float().reshape(*x.shape[:-1], G, C // G)
        dims = tuple(range(1, xf.dim() - 2)) + (xf.dim() - 1,)
        mean, var = _fast_stats(xf, dims)
        y = _normalize(xf, mean, var, self.eps,
                       self.weight.float().reshape(G, C // G),
                       self.bias.float().reshape(G, C // G))
        return y.reshape(x.shape)


class ChannelGroupNorm(nn.Module):
    """GroupNorm that adapts its grouping to the channel count: groups of
    ``preferred_group_size`` channels, or gcd(channels, preferred) groups
    when the count does not divide (the JAX module's submodule ``gn``)."""

    def __init__(self, channels, preferred_group_size=16, eps=1e-5,
                 zero_scale=False):
        super().__init__()
        groups = (channels // preferred_group_size
                  if channels % preferred_group_size == 0
                  else math.gcd(channels, preferred_group_size))
        self.gn = GroupNorm(channels, groups, eps, zero_scale)

    def forward(self, x):
        return self.gn(x)


class BatchNorm(nn.Module):
    """``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)`` over
    NHWC.  ``train=True`` normalises with the batch's f32 mean and BIASED
    variance (flax's fast form) and updates the running buffers as flax
    updates ``batch_stats``: ``ra = momentum * ra + (1 - momentum) *
    batch``; ``train=False`` reads the buffers.  The buffers are named
    ``mean`` and ``var``, as in flax's ``batch_stats``."""

    def __init__(self, channels, momentum=0.9, eps=1e-5, zero_scale=False):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(channels) if zero_scale
                                   else torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x, train=False):
        xf = x.float()
        dims = tuple(range(xf.dim() - 1))
        if train:
            mean, var = _fast_stats(xf, dims)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean.reshape(-1))
                self.var.copy_(m * self.var + (1 - m) * var.reshape(-1))
        else:
            mean, var = self.mean, self.var
        return _normalize(xf, mean, var, self.eps, self.weight.float(),
                          self.bias.float())


class WSConv(nn.Module):
    """Weight-standardised conv (the NF-ResNet conv): the kernel
    standardised over its (h, w, in) fan-in, times ``rsqrt(var * fan_in
    + 1e-4) * gain`` (per output channel), in f32; the conv in ``dtype``.
    Supports dilation; no bias unless ``use_bias``."""

    def __init__(self, in_features, features, kernel_size=(3, 3),
                 strides=(1, 1), padding="SAME", dtype="bfloat16",
                 use_bias=False, kernel_dilation=(1, 1)):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.weight = nn.Parameter(torch.empty(features, in_features, kh, kw))
        self.gain = nn.Parameter(torch.ones(features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)
        self.strides = _pair(strides)
        self.padding = padding
        self.dilation = _pair(kernel_dilation)
        self.dtype = _dtype(dtype)

    def standardized(self):
        """The standardised f32 kernel, OIHW."""
        w = self.weight.float()
        fan_in = w[0].numel()
        mean = w.mean((1, 2, 3), keepdim=True)
        var = w.var((1, 2, 3), unbiased=False, keepdim=True)
        return ((w - mean) * torch.rsqrt(var * fan_in + 1e-4)
                * self.gain.float()[:, None, None, None])

    def forward(self, x):
        dt = self.dtype
        y = conv_nhwc(x.to(dt), self.standardized().to(dt), self.strides,
                      self.padding, self.dilation)
        return y if self.bias is None else y + self.bias.to(dt)


class IdentityNorm(nn.Module):
    """The norm slot of a normaliser-free network: the identity, or, in
    the zero-init slot, a learnable scalar ``alpha`` (SkipInit) that
    starts at 0 and scales the branch in f32."""

    def __init__(self, channels=None, zero_scale=False):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(1)) if zero_scale else None

    def forward(self, x):
        if self.alpha is None:
            return x
        return (x.float() * self.alpha).to(x.dtype)


def init_zoo_(module):
    """The JAX zoo's initialisers in distribution, from torch's global
    generator (seed it with ``torch.manual_seed``): conv kernels and
    Dense weights lecun-normal (std 1/sqrt(fan_in); WSConv he-normal, std
    sqrt(2/fan_in)), embeddings std 1/sqrt(rows), biases zero; norm
    scales keep what their constructor set (one, or zero in a zero-init
    slot)."""
    from tensorflowonspark_tpu_torch.models.transformer import Dense

    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (Conv, ConvTranspose, WSConv, Dense)):
                w = mod.weight
                fan_in = w[0].numel()
                std = ((2.0 / fan_in) ** 0.5 if isinstance(mod, WSConv)
                       else fan_in ** -0.5)
                w.normal_(0.0, std)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, mod.weight.shape[0] ** -0.5)
    return module
