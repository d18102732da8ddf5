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
padding (the TPU version pads N to its row block).  The gradient, as in
the JAX custom VJP, recomputes through the plain version under autograd.
"""
import torch

from . import _build


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
    if D > 8192:
        raise NotImplementedError(
            f"the LayerNorm kernel takes rows of up to 8192, got {D}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (D,) or t.device != x.device:
            raise ValueError(f"{name} must be [{D}] on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if scale.dtype != bias.dtype:
        raise TypeError(f"scale {scale.dtype} and bias {bias.dtype} differ")
    lib = _build.lib()
    x2 = x.reshape(-1, D).contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    y = torch.empty_like(x2)
    P = _build.ptr
    code = lib.tos_layernorm(
        P(x2), P(scale), P(bias), P(y), x2.shape[0], D, float(eps),
        _build.dtype_code(x2), _build.dtype_code(scale),
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
