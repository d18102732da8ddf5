"""Fused LayerNorm with f32 statistics.

Counterpart of ``tensorflowonspark_tpu/ops/layernorm.py``: a row
LayerNorm over the last dim whose mean and CENTRED variance are computed
in f32 whatever the input type, with scale and bias applied in f32 and
the output in x's dtype.  It is not flax's ``nn.LayerNorm`` (the port's
``models.transformer.LayerNorm``), which takes the fast variance and
returns f32.

The one rule of the port's kernels: a CPU tensor takes the plain PyTorch
version (:func:`layernorm_plain`, the port of ``layernorm_reference``); a
CUDA tensor launches the hand-written kernel ``csrc/layernorm.cu``
(design and bound in its header) or raises.  The kernel needs no row
padding (the TPU version pads N to its row block); how it splits a row
over threads is :func:`kernel_layout`, a function of D and the dtype
alone.  The gradient, as in the JAX custom VJP, recomputes through the
plain version under autograd.
"""
import torch

from . import _build

# csrc/layernorm.cu: the most f32 values of x a thread keeps, and the
# most threads a block (so the most threads a row)
KERNEL_VALUES = 32
KERNEL_BLOCK = 256


def kernel_layout(D, dtype):
    """``(vec, lanes)`` of kernel 11 for rows of ``D`` elements of
    ``dtype``: a row is cut into chunks of ``vec`` values (16 bytes of x
    where the row's byte width is a multiple of 16, else single values)
    and ``lanes`` threads share it, thread l taking chunks l, l + lanes,
    ...  (at most ``KERNEL_VALUES`` values each).  It depends on D and
    the dtype alone, never on the number of rows, so a row's sums run in
    one order whatever shares the call."""
    size = torch.empty((), dtype=dtype).element_size()
    vec = 16 // size if D * size % 16 == 0 else 1
    per = KERNEL_VALUES // vec
    lanes = 8 if vec > 1 else 32
    while lanes * per < D // vec:
        lanes *= 2
    if lanes > KERNEL_BLOCK:
        raise NotImplementedError(
            f"the LayerNorm kernel takes rows of up to 8192, got {D}")
    return vec, lanes


def layernorm_plain(x, scale, bias, eps=1e-6):
    """``layernorm_reference``: f32 mean, centred f32 variance, f32
    scale and bias, the result in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _layernorm(x, scale, bias, eps):
    """Forward of one LayerNorm over ``x [..., D]`` (kernel 11).  CPU
    tensors take :func:`layernorm_plain`."""
    if x.device.type == "cpu":
        return layernorm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_layernorm: no kernel for {x.device}")
    D = x.shape[-1]
    vec, lanes = kernel_layout(D, x.dtype)      # raises above D 8192
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (D,) or t.device != x.device:
            raise ValueError(f"{name} must be [{D}] on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if scale.dtype != bias.dtype:
        raise TypeError(f"scale {scale.dtype} and bias {bias.dtype} differ")
    lib = _build.lib()
    # the 16-byte loads need 16-byte aligned bases: a misaligned view
    # runs on an aligned copy
    x2, scale, bias = (_build.aligned(t) for t in (x.reshape(-1, D), scale,
                                                   bias))
    y = torch.empty_like(x2)
    P = _build.ptr
    code = lib.tos_layernorm(
        P(x2), P(scale), P(bias), P(y), x2.shape[0], D, vec, lanes,
        float(eps), _build.dtype_code(x2), _build.dtype_code(scale),
        _build.stream_ptr(x.device))
    _build.check(code, "tos_layernorm")
    _layernorm.launches += 1
    return y.reshape(x.shape)


_layernorm.launches = 0


class _FusedLayerNorm(torch.autograd.Function):
    """The JAX ``_ln`` custom VJP: the forward is the kernel, the
    backward differentiates :func:`layernorm_plain` from the saved
    (x, scale, bias)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return _layernorm(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(True) for t in (x, scale, bias)]
        with torch.enable_grad():
            y = layernorm_plain(*leaves, ctx.eps)
        grads = torch.autograd.grad(y, leaves, g)
        return (*grads, None)


def fused_layernorm(x, scale, bias, eps=1e-6):
    """LayerNorm over the last dim of ``x`` with f32 statistics;
    differentiable in x, scale and bias."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias)):
        return _FusedLayerNorm.apply(x, scale, bias, float(eps))
    return _layernorm(x, scale, bias, float(eps))
