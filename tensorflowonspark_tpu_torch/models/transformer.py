"""Transformer LM — counterpart of ``tensorflowonspark_tpu/models/
transformer.py`` for the serving and training slices.

The same ``TransformerConfig`` (field names and defaults), the same
parameter tree under PyTorch names (``convert.params_from_jax`` maps
one onto the other), and the same math: RoPE with split-half pairing,
GQA attention with f32 softmax, plain or gated MLPs or MoE layers
(:class:`MoEMLP`: the dense and the top-k capacity router), RMSNorm or
LayerNorm (statistics in f32; ``fused_ln`` runs kernel 11), pre- or
post-LN blocks.

Attention paths, as in the JAX package: the cache-free forward runs the
flash kernels (``ops.flash_attention``, differentiable) for
``attention_impl="flash"``, or ``"auto"`` on a CUDA tensor, and dense
attention otherwise; the paged slot cache (``_paged_attention_body``)
runs the paged kernels, over float or int8 pools (the cache decides:
``models.decode.init_paged_slot_cache(kv_dtype=)``), and the dense slot
cache (``_slot_attention_body``) plain products over each row's window,
as the JAX package computes it in XLA.  ``remat``
recomputes each block in the backward
(``torch.utils.checkpoint``).  :func:`lm_loss` is the causal-LM loss the
train step uses; ``return_hidden=True`` gives the hidden states for
``ops.xent.fused_unembed_xent`` instead.  Fields of the config whose
feature is not ported raise ``NotImplementedError`` naming the ROADMAP
item when they are set.

Split over GPUs (the forward reads its mesh from
``parallel.mesh.use_mesh``, which the train and eval steps enter; the
collectives are ``parallel.collectives``):

- **tp** (parameters sharded by the JAX rules, ``parallel.sharding``;
  training, and decoding with a slot cache that holds this rank's kv
  heads, :meth:`Attention.cache_heads`, LoRA banks split with the
  layers they adapt):
  ``query`` / ``key`` / ``value`` / ``wi`` are column-parallel at local
  head counts, entered through ``copy_to_tp``; ``out`` / ``wo`` are
  row-parallel, left through ``reduce_from_tp`` (the bias added after
  it); ``token_embed`` / ``pos_embed`` are split over d_model (the local
  columns looked up, then gathered); ``lm_head`` is split over the
  vocabulary and returns this rank's vocabulary slice of the logits,
  which :func:`lm_loss` reduces without forming the whole.  A kv
  projection that tp splits mid-head (``n_kv_heads % tp``) is gathered
  and the kv heads this rank's q heads read are taken from it.
- **sp** (``sp_axis="tp"``, Megatron-SP where JAX puts ``_sp_constrain``):
  the residual stream between blocks is split over the sequence; each
  norm runs on its block, ``gather_seq`` precedes the column-parallel
  projections and ``scatter_seq`` replaces ``reduce_from_tp``.
- **cp** (``ring_attention_axis`` / ``ulysses_axis``, on the tp axis,
  parameters replicated over it): every rank's tokens are its sequence
  block (``parallel.mesh.batch_sharding(mesh, seq_axis)``), positions are
  global, and attention runs ``parallel.ring_attention`` or
  ``parallel.ulysses``.

:meth:`Transformer.grad_axes` names the leaves whose gradient a rank
holds only part of, which the train step sums.
"""
import dataclasses
import logging
import math
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tensorflowonspark_tpu_torch import quantize
from tensorflowonspark_tpu_torch.ops.flash_attention import flash_attention
from tensorflowonspark_tpu_torch.ops.layernorm import fused_layernorm
from tensorflowonspark_tpu_torch.ops.paged_attention import paged_attention
from tensorflowonspark_tpu_torch.ops.paged_prefill import (
    _write_pages_int8, kv_dequantize, kv_quantize, paged_prefill)
from tensorflowonspark_tpu_torch.ops.quant_matmul import quant_matmul
from tensorflowonspark_tpu_torch.parallel import collectives as coll
from tensorflowonspark_tpu_torch.parallel.mesh import (AXIS_TP,
                                                       active_mesh)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: Optional[int] = None  # GQA: kv heads < query heads (1 = MQA)
    n_layers: int = 6
    d_ff: int = 2048
    max_seq_len: int = 2048
    causal: bool = True
    dtype: str = "bfloat16"
    rope: bool = False            # rotary embeddings instead of a learned
    # absolute pos_embed table
    rope_theta: float = 10000.0
    num_experts: int = 0          # >0 = MoE on every moe_every-th layer
    moe_every: int = 2
    moe_router: str = "dense"     # dense | topk (capacity dispatch)
    moe_top_k: int = 1            # experts per token under topk
    moe_capacity_factor: float = 1.25  # slots an expert = factor*k*T/E
    remat: bool = False           # recompute each block in the backward
    ring_attention_axis: Optional[str] = None   # context parallelism
    ulysses_axis: Optional[str] = None          # (the tp axis)
    sp_axis: Optional[str] = None               # Megatron-SP (the tp axis)
    attention_impl: str = "auto"  # auto | flash (CUDA kernels) | dense
    use_bias: bool = False
    ln_eps: float = 1e-6
    norm_type: str = "layernorm"  # layernorm | rmsnorm
    fused_ln: bool = False        # LayerNorm through kernel 11
    norm_style: str = "pre"       # pre | post
    activation: str = "gelu_tanh"  # gelu_tanh | gelu_exact | relu | silu
    mlp_style: str = "plain"      # plain | gated
    decode: bool = False          # the JAX package's decode-mode flags;
    decode_slots: bool = False    # here the cache object passed to the
    kv_page_size: int = 0         # forward decides the decode mode
    kv_pages: int = 0
    kv_table_pages: int = 0
    kv_dtype: str = "auto"        # auto | int8: the paged pools' storage
    paged_attn_impl: str = "kernel"    # the kernels are the only paged
    quant_matmul_impl: str = "kernel"  # and quantised-weight paths on
    paged_prefill_impl: str = "kernel"  # the card


_UNPORTED = (
    ("ring_attention_axis", lambda v: v not in (None, AXIS_TP),
     "context parallelism on another axis than tp (ROADMAP A3c)"),
    ("ulysses_axis", lambda v: v not in (None, AXIS_TP),
     "context parallelism on another axis than tp (ROADMAP A3c)"),
    ("sp_axis", lambda v: v not in (None, AXIS_TP),
     "sequence parallelism on another axis than tp (ROADMAP A3c)"),
    ("paged_attn_impl", lambda v: v != "kernel",
     "a selectable reference read path (the kernel is the only card path)"),
    ("paged_prefill_impl", lambda v: v != "kernel",
     "a selectable reference prefill path (the kernels are the only card "
     "path)"),
    ("quant_matmul_impl", lambda v: v != "kernel",
     "a selectable inline-dequant matmul path (the kernels are the only "
     "card path)"),
)


def check_ported(cfg):
    """Validate a config and raise NotImplementedError for any field
    whose feature this slice does not port."""
    for field, is_set, what in _UNPORTED:
        if is_set(getattr(cfg, field)):
            raise NotImplementedError(
                f"TransformerConfig.{field}={getattr(cfg, field)!r}: {what} "
                "is not ported yet")
    if cfg.attention_impl not in ("auto", "flash", "dense"):
        raise ValueError(f"attention_impl={cfg.attention_impl!r} not in "
                         "('auto', 'flash', 'dense')")
    if cfg.ring_attention_axis and cfg.ulysses_axis:
        raise ValueError(
            "ring_attention_axis and ulysses_axis are mutually exclusive "
            "context-parallel strategies")
    if cfg.sp_axis and (cfg.ring_attention_axis or cfg.ulysses_axis):
        raise NotImplementedError(
            "sequence parallelism together with context parallelism on "
            "one axis is not ported yet (ROADMAP A3c)")
    if cfg.norm_type not in ("layernorm", "rmsnorm"):
        raise ValueError(
            f"norm_type={cfg.norm_type!r} not in ('layernorm', 'rmsnorm')")
    if cfg.fused_ln and cfg.norm_type == "rmsnorm":
        raise ValueError("fused_ln applies to norm_type='layernorm' (the "
                         "fused kernel computes mean and variance)")
    if cfg.kv_dtype not in ("auto", "int8"):
        raise ValueError(f"kv_dtype={cfg.kv_dtype!r} not in ('auto', "
                         "'int8')")
    if cfg.norm_style not in ("pre", "post"):
        raise ValueError(
            f"norm_style={cfg.norm_style!r} not in ('pre', 'post')")
    if cfg.mlp_style not in ("plain", "gated"):
        raise ValueError(
            f"mlp_style={cfg.mlp_style!r} not in ('plain', 'gated')")
    n_kv = cfg.n_heads if cfg.n_kv_heads is None else cfg.n_kv_heads
    if n_kv < 1 or cfg.n_heads % n_kv:
        raise ValueError(f"n_heads={cfg.n_heads} must be divisible by "
                         f"n_kv_heads={n_kv} >= 1")
    torch_dtype(cfg)


def torch_dtype(cfg):
    """The activation dtype named by ``cfg.dtype``."""
    dt = getattr(torch, cfg.dtype, None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"dtype={cfg.dtype!r} is not a float dtype")
    return dt


def apply_rope(x, positions, theta=10000.0):
    """Rotary position embedding over [..., S, H, D] (split-half pairing).

    ``positions``: [S] (or [B, S]) absolute token positions."""
    D = x.shape[-1]
    if D % 2:
        raise ValueError(f"head_dim={D} must be even for RoPE")
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs           # [..., S, half]
    cos = torch.cos(angles)[..., None, :]                   # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


class _Par(NamedTuple):
    """Where a forward runs: the tp group, whether the residual stream is
    split over the sequence on it (sp), and the context-parallel group
    (cp) with its kind."""
    tp: Any
    sp: bool
    cp: Any
    cp_kind: Optional[str]


def _par(cfg):
    mesh = active_mesh()
    tp = coll.axis_group(mesh, AXIS_TP)
    cp_axis = cfg.ring_attention_axis or cfg.ulysses_axis
    return _Par(tp, bool(cfg.sp_axis) and tp.size > 1,
                coll.axis_group(mesh, cp_axis) if cp_axis else coll.SOLO,
                "ring" if cfg.ring_attention_axis
                else "ulysses" if cfg.ulysses_axis else None)


def _a3c(what):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP A3c)")


class Dense(nn.Module):
    """The JAX package's ``QuantDense``.  A float weight (``[out, in]``;
    flax keeps ``[in, out]``) has ``nn.Dense`` semantics: input, weight
    and bias promoted to ``dtype``, then one matmul.  After
    :meth:`set_quantized` the weight is a quantised leaf held as buffers
    ``q`` / ``scale`` in the JAX ``[in, out]`` storage layout (``quant``
    names the mode); the input is cast to ``dtype``, goes through
    ``ops.quant_matmul`` (kernels 9 and 10), and the bias is added in
    ``dtype`` after it."""

    def __init__(self, in_features, features, use_bias, dtype):
        super().__init__()
        self.in_features = in_features
        self.out_features = features
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)
        self.dtype = dtype
        self.quant = None          # None | "int8" | "int4"
        self.group_size = 0

    def set_quantized(self, leaf):
        """Replace the float weight with a quantised leaf (an int8
        ``{"q", "scale"}`` dict or an ``Int4Weight`` of this layer's
        ``[in, out]`` shape)."""
        if quantize.is_int8_leaf(leaf):
            q, scale, mode, group = leaf["q"], leaf["scale"], "int8", 0
            if tuple(q.shape) != (self.in_features, self.out_features):
                raise ValueError(f"int8 kernel {tuple(q.shape)} does not fit "
                                 f"a {self.in_features}->{self.out_features}"
                                 " Dense")
        elif isinstance(leaf, quantize.Int4Weight):
            q, scale, mode, group = leaf.q, leaf.scale, "int4", leaf.group_size
            if (leaf.in_dim, leaf.out_dim) != (self.in_features,
                                               self.out_features):
                raise ValueError(f"{leaf!r} does not fit a "
                                 f"{self.in_features}->{self.out_features} "
                                 "Dense")
        else:
            raise TypeError(f"not a quantized leaf: {type(leaf)!r}")
        if self.quant is None:
            del self.weight
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.quant, self.group_size = mode, group

    def local_shape(self):
        """``(out, in)`` of the weight this rank holds: tp splits one of
        them, a quantised weight's ``q`` / ``scale`` with it
        (``parallel.sharding``: the int8 ``q`` over either dim, the
        packed int4 ``q`` and its group scales over whole groups)."""
        if self.quant is None:
            return tuple(self.weight.shape)
        if self.quant == "int8":
            return self.q.shape[1], self.q.shape[0]
        # int4: K pads to whole groups; a row split holds whole groups
        whole = -(-self.in_features // self.group_size)
        return self.q.shape[1], (self.in_features
                                 if self.scale.shape[0] == whole
                                 else self.scale.shape[0] * self.group_size)

    def quantized_leaf(self):
        """The quantised weight this rank holds, as ``ops.quant_matmul``
        takes it."""
        if self.quant == "int8":
            return {"q": self.q, "scale": self.scale}
        return quantize.Int4Weight(self.q, self.scale, self.local_shape()[1],
                                   self.group_size)

    def matmul(self, x):
        """``x`` times the weight this rank holds, in ``dtype``, without
        the bias: one ``F.linear``, or kernel 9 / 10 for a quantised
        weight."""
        if self.quant is None:
            return F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return quant_matmul(x.to(self.dtype), self.quantized_leaf())

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        out = self.local_shape()[0]
        if bias is not None and bias.shape[0] != out:
            # column-parallel: this rank's slice of the replicated bias
            # (its gradient all-reduced, so whole on every rank)
            tp = coll.axis_group(active_mesh(), AXIS_TP)
            bias = coll.copy_to_tp(bias, tp).narrow(0, tp.index * out, out)
        if self.quant is None:
            return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                            bias)
        y = self.matmul(x)
        return y if bias is None else y + bias

    def take_columns(self, cols):
        """Keep columns ``cols`` (a slice) of a whole quantised weight,
        contiguous (``Attention.take_kv_heads``)."""
        if self.quant is None or self.local_shape()[0] != self.out_features:
            raise ValueError("take_columns keeps columns of a whole "
                             "quantised weight")
        self.q.data = self.q[:, cols].contiguous()
        self.scale.data = self.scale[:, cols].contiguous()


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm(dtype=float32)``: statistics and output in f32."""

    def __init__(self, d, eps):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        x = x.float()
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * (torch.rsqrt(var + self.eps) * self.weight.float())


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: fast variance
    ``E[x^2] - E[x]^2`` clipped at 0, f32 output."""

    def __init__(self, d, eps):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps = eps

    def forward(self, x):
        x = x.float()
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = (torch.mean(x * x, dim=-1, keepdim=True)
               - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return (x - mean) * mul + self.bias.float()


class FusedLayerNorm(LayerNorm):
    """The JAX package's ``FusedLayerNorm``: LayerNorm through
    ``ops.layernorm`` (kernel 11 on the card), centred f32 variance, the
    output in x's dtype.  Same parameters as :class:`LayerNorm`, so
    ``convert`` maps the JAX ``scale`` / ``bias`` unchanged."""

    def forward(self, x):
        return fused_layernorm(x, self.weight, self.bias, self.eps)


def _make_ln(cfg):
    if cfg.norm_type == "rmsnorm":
        return RMSNorm(cfg.d_model, cfg.ln_eps)
    if cfg.fused_ln:
        return FusedLayerNorm(cfg.d_model, cfg.ln_eps)
    return LayerNorm(cfg.d_model, cfg.ln_eps)


def dot_product_attention(q, k, v, causal=True, mask=None):
    """Standard attention with f32 softmax accumulation over [B, S, H, D]
    inputs (k/v at full head count).  ``mask`` is an optional [B, S_k]
    key-validity mask (True = attend)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        S_q, S_k = q.shape[1], k.shape[1]
        cmask = torch.ones((S_q, S_k), dtype=torch.bool,
                           device=q.device).tril()
        logits = torch.where(cmask[None, None], logits,
                             torch.full_like(logits, -1e30))
    if mask is not None:
        logits = torch.where(mask[:, None, None, :], logits,
                             torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _kv_repeat(q, k, v):
    """Broadcast narrow (GQA) k/v heads to the query head count."""
    H, H_kv = q.shape[2], k.shape[2]
    if H == H_kv:
        return k, v
    rep = H // H_kv
    return k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)


class Attention(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.head_dim = cfg.d_model // cfg.n_heads
        self.n_kv = cfg.n_heads if cfg.n_kv_heads is None else cfg.n_kv_heads
        dt = torch_dtype(cfg)
        kv = self.n_kv * self.head_dim
        self.query = Dense(cfg.d_model, cfg.d_model, cfg.use_bias, dt)
        self.key = Dense(cfg.d_model, kv, cfg.use_bias, dt)
        self.value = Dense(cfg.d_model, kv, cfg.use_bias, dt)
        self.out = Dense(cfg.d_model, cfg.d_model, cfg.use_bias, dt)
        # this rank's tp coordinate, set by parallel.sharding.shard_params:
        # a cache built outside use_mesh reads its heads from it
        self.tp_index = 0
        # quantised k / v projections that hold only this rank's kv heads'
        # columns (take_kv_heads)
        self.kv_selected = False

    def split(self):
        """True when tp splits this layer's heads (the query projection is
        column-parallel)."""
        return self.query.local_shape()[0] < self.cfg.d_model

    def kv_column_parallel(self):
        """True when tp splits the k / v projections at whole heads (a
        rank's columns are its kv heads); otherwise, split mid-head or
        whole, the forward reads its heads from the gathered weight
        (``_kv``)."""
        if self.kv_selected:
            return False
        kv = self.n_kv * self.head_dim
        local = self.key.local_shape()[0]
        return local < kv and self.n_kv % (kv // local) == 0

    def take_kv_heads(self):
        """Where tp splits this layer's heads but cannot split quantised k
        / v projections at whole heads (``parallel.sharding`` leaves their
        ``q`` / ``scale`` whole), keep the columns of the kv heads this
        rank's q heads read, once, so that kernels 9 and 10 run on them
        (a float weight is gathered a call instead, ``_kv``)."""
        if (not self.split() or self.key.quant is None
                or self.kv_column_parallel()):
            return
        n_q = self.query.local_shape()[0] // self.head_dim
        first, n_sel, _ = _kv_heads(self.cfg.n_heads, self.n_kv, n_q,
                                    self.tp_index)
        cols = slice(first * self.head_dim, (first + n_sel) * self.head_dim)
        for dense in (self.key, self.value):
            dense.take_columns(cols)
        self.kv_selected = True

    def cache_heads(self):
        """The kv heads a slot cache holds for this layer on this rank:
        every one unsplit; under tp the heads this rank's q heads read
        (its share of an even split, or those selected from the gathered
        weight, never repeated).  Read from the layer's own split and
        ``tp_index``, so a cache built outside ``use_mesh`` holds the
        right count; ranks whose q heads straddle the kv heads
        differently hold different counts."""
        if not self.split():
            return self.n_kv
        if self.kv_column_parallel():
            return self.key.local_shape()[0] // self.head_dim
        n_q = self.query.local_shape()[0] // self.head_dim
        return _kv_heads(self.cfg.n_heads, self.n_kv, n_q, self.tp_index)[1]

    def _kv(self, dense, h, par, n_local_q, lora, name):
        """k or v for this rank's q heads: ``(heads [B, S, n, Dh],
        index)``.  The local heads of a column-parallel projection; or,
        where tp splits the projection mid-head (or leaves it whole), the
        heads this rank's q heads read, from the gathered weight (with
        the LoRA delta of the same rows of a whole ``B``); a quantised
        weight already holds only those heads (``take_kv_heads``).
        ``index`` is None where the q heads group evenly over the returned
        heads, else the head each q head reads."""
        B, S = h.shape[0], h.shape[1]
        hd, n_kv, tp = self.head_dim, self.n_kv, par.tp
        if self.kv_column_parallel():
            return (self._proj(dense, h, lora, name).reshape(
                B, S, n_kv // tp.size, hd), None)
        w = None
        if not self.kv_selected:
            # every rank reads its own rows of the whole weight: the
            # gather's backward reduce-scatters, a replicated weight's
            # all-reduces
            w = dense.weight
            w = (coll.gather_seq(w, tp, dim=0) if w.shape[0] < n_kv * hd
                 else coll.copy_to_tp(w, tp))
        first, n_sel, index = _kv_heads(self.cfg.n_heads, n_kv, n_local_q,
                                        tp.index)
        rows = slice(first * hd, (first + n_sel) * hd)
        bias = (None if dense.bias is None else
                coll.copy_to_tp(dense.bias, tp)[rows].to(dense.dtype))
        if w is None:
            out = dense.matmul(h)
            out = out if bias is None else out + bias
        else:
            out = F.linear(h.to(dense.dtype), w[rows].to(dense.dtype), bias)
        if lora is not None:
            out = out + _lora_delta(h, lora, name, rows).to(out.dtype)
        return out.reshape(B, S, n_sel, hd), index

    def _proj(self, dense, x, lora, name):
        """One projection, with the optional PER-ROW LoRA delta (the
        JAX ``Attention._proj``): ``lora = (banks, ids)`` holds this
        layer's ``{name}_a [L, d_in, r]`` / ``{name}_b [L, r, d_out]``
        banks (the scale folded into b; index 0 the all-zero null
        adapter; under tp this rank's columns of a column-parallel
        projection's ``b``) and ``ids [B]``, each row's bank index.  Row
        n computes ``x_n @ W + (x_n @ A[ids_n]) @ B[ids_n]`` in f32, cast
        to y's dtype, for any S (a decode step, a prefill chunk, a verify
        block)."""
        y = dense(x)
        if lora is None:
            return y
        return y + _lora_delta(x, lora, name).to(y.dtype)

    def forward(self, x, cache=None, layer=0, mask=None, lora=None):
        cfg = self.cfg
        par = _par(cfg)
        split = self.split()
        if lora is not None and par.cp_kind:
            raise _a3c("LoRA adapters under context parallelism")
        if split and par.cp.size > 1:
            raise _a3c("context parallelism over an axis that also splits "
                       "the parameters (tp-sharded attention)")
        if cache is not None and par.cp_kind:
            raise NotImplementedError(
                "decode mode with sequence-parallel attention is not "
                "supported; decode on a tp/dp mesh instead")
        if cache is not None and par.sp:
            raise _a3c("decoding under sequence parallelism")
        if par.sp and not split:
            raise _a3c("sequence parallelism over attention that tp does "
                       "not split")
        if split:
            # column-parallel in-projections from the replicated (or, under
            # sp, the gathered) stream
            x = (coll.gather_seq(x, par.tp) if par.sp
                 else coll.copy_to_tp(x, par.tp))
        B, S = x.shape[0], x.shape[1]
        q = self._proj(self.query, x, lora, "query")
        if q.shape[-1] % self.head_dim:
            raise _a3c(f"a tp split of {cfg.n_heads} query heads over "
                       f"{par.tp.size} ranks")
        H = q.shape[-1] // self.head_dim
        q = q.reshape(B, S, H, self.head_dim)
        index = None
        if split:
            # a cache holds what _kv returns (Attention.cache_heads); where
            # the q heads do not group evenly over it, a cacheless forward
            # repeats it to one a q head, a cached one regroups the queries
            k, index = self._kv(self.key, x, par, H, lora, "key")
            v, _ = self._kv(self.value, x, par, H, lora, "value")
            if index is not None and cache is None:
                k, v = k[:, :, index], v[:, :, index]
        else:
            k = self._proj(self.key, x, lora, "key").reshape(
                B, S, self.n_kv, self.head_dim)
            v = self._proj(self.value, x, lora, "value").reshape(
                B, S, self.n_kv, self.head_dim)
        if cfg.rope:
            pos = torch.arange(S, device=x.device)
            if cache is not None:           # per-row positions: [B, S]
                pos = cache.cache_index.long()[:, None] + pos[None, :]
            elif par.cp.size > 1:
                # this rank's sequence block: rotate with global positions
                pos = pos + par.cp.index * S
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        flash = cfg.attention_impl == "flash" or (
            cfg.attention_impl == "auto" and q.is_cuda)
        if cache is not None:
            if not cfg.causal:
                raise NotImplementedError(
                    "decode mode is autoregressive (causal) generation; "
                    "causal=False has no incremental form")
            if mask is not None:
                raise NotImplementedError(
                    "key-padding masks are not supported in decode mode")
            body = (_paged_attention_body if hasattr(cache, "page_table")
                    else _slot_attention_body)
            if index is None:
                out = body(q, k, v, cache, layer)
            else:
                qg, pos = _group_queries(q, index)
                out = body(qg, k, v, cache, layer)[:, :, pos]
        elif par.cp_kind:
            if mask is not None:
                raise NotImplementedError(
                    "key-padding masks are not supported with "
                    "sequence-parallel attention; pad/pack sequences to "
                    "full length, or unset ring_attention_axis/"
                    "ulysses_axis to use non-sequence-parallel attention")
            out = _seqpar_dispatch(q, k, v, cfg, par.cp, flash)
        elif mask is None and flash:
            # GQA-native kernels: narrow k/v go straight in (no repeated
            # kv on the card, dk/dv come back narrow)
            out = flash_attention(q, k, v, causal=cfg.causal)
        else:
            # dense path: broadcast back to full heads
            kf, vf = _kv_repeat(q, k, v)
            if mask is not None and cfg.attention_impl == "flash":
                # key-padding masks are not in the flash kernels; an
                # explicit 'flash' request must not silently lose its
                # O(S) memory promise
                logging.getLogger(__name__).warning(
                    "attention_impl='flash' with a key-padding mask falls "
                    "back to dense O(S^2) attention")
            out = dot_product_attention(q, kf, vf, causal=cfg.causal,
                                        mask=mask)
        out = out.reshape(B, S, H * self.head_dim)
        if split:
            return _row_parallel(self.out, out, par, None if lora is None
                                 else _lora_delta(out, lora, "out"))
        return self._proj(self.out, out, lora, "out")


def _kv_heads(n_heads, n_kv, n_q, index):
    """``(first, n_sel, index)`` of the kv heads that q heads ``index *
    n_q ..`` (``n_q`` of them, as tp rank ``index`` holds) read under
    GQA: the run ``first .. first + n_sel - 1``, and None where the q
    heads group evenly over it (``n_q / n_sel`` each, in order), else
    the run position each q head reads."""
    group = n_heads // n_kv
    heads = [(index * n_q + i) // group for i in range(n_q)]
    first, n_sel = heads[0], heads[-1] - heads[0] + 1
    per = n_q // n_sel
    if n_q % n_sel or any(heads[i] - first != i // per for i in range(n_q)):
        return first, n_sel, [h - first for h in heads]
    return first, n_sel, None


def _group_queries(q, index):
    """``(q', pos)``: the q heads laid out for k / v heads they do not
    group evenly over (``_kv_heads``'s ``index``, the k / v head each q
    head reads, in order): each k / v head's q heads, padded with zero
    heads to the largest group, so that head ``h`` of ``q'`` reads k / v
    head ``h // group`` as the attention bodies and kernels group them;
    q head ``i`` is head ``pos[i]`` of ``q'``."""
    n_sel = index[-1] + 1
    width = max(index.count(j) for j in range(n_sel))
    pos = [j * width + index[:i].count(j) for i, j in enumerate(index)]
    qg = q.new_zeros(q.shape[0], q.shape[1], n_sel * width, q.shape[3])
    qg[:, :, pos] = q
    return qg, pos


def _lora_delta(x, lora, name, cols=None):
    """The per-row LoRA delta ``(x_n @ A[ids_n]) @ B[ids_n]`` in f32 of
    projection ``name`` (``lora = (banks, ids)``; ``cols``: those columns
    of a whole ``B`` only)."""
    banks, ids = lora
    a = banks[f"{name}_a"][ids]                 # [B, d_in, r]
    b = banks[f"{name}_b"][ids]                 # [B, r, d_out]
    if cols is not None:
        b = b[..., cols]
    return torch.bmm(torch.bmm(x.float(), a.float()), b.float())


def _row_parallel(dense, x, par, delta=None):
    """A row-parallel projection: this rank's partial sums, with its
    partial LoRA ``delta`` (``x_local @ A[local rows] @ B``: the ranks'
    partials sum to the whole delta), summed over tp
    (``reduce_from_tp``; under sp ``scatter_seq``, which also leaves this
    rank's sequence block), then the replicated bias, added once."""
    y = dense.matmul(x)
    if delta is not None:
        y = y + delta.to(y.dtype)
    y = (coll.scatter_seq(y, par.tp) if par.sp
         else coll.reduce_from_tp(y, par.tp))
    return y if dense.bias is None else y + dense.bias.to(dense.dtype)


def _seqpar_dispatch(q, k, v, cfg, group, flash):
    """Ring or Ulysses context-parallel attention over this rank's
    sequence block (JAX ``_seqpar_dispatch``, under an enclosing
    ``shard_map``): GQA kv travel narrow; ``attention_impl="dense"`` (or
    "auto" off the card) takes the plain cores."""
    if cfg.ring_attention_axis:
        from tensorflowonspark_tpu_torch.parallel.ring_attention import (
            ring_local)
        return ring_local(q, k, v, group, cfg.causal, use_flash=flash)
    from tensorflowonspark_tpu_torch.parallel.ulysses import (
        dense_core, ulysses_local)
    return ulysses_local(q, k, v, group, cfg.causal,
                         None if flash else dense_core)


def _paged_attention_body(q, k, v, cache, layer):
    """Paged continuous-batching attention for one layer.

    ``cache`` holds this layer's pool ``pages_key[layer] /
    pages_value[layer] [kv_pages, page, n_kv, Dh]`` (an int8 pool also
    ``key_scales[layer] / value_scales[layer] [kv_pages, page, n_kv]``
    f32), the per-row ``page_table [B, max_pages]`` and ``cache_index
    [B]`` (tokens already written).  Prefill chunks (S > 1) run
    ``paged_prefill`` (page write + chunked flash read).  Decode steps
    (S == 1) write the token's k/v (a float pool by plain tensor
    indexing, an int8 pool through the quantising page write) and read
    through ``paged_attention`` with ``lengths = cache_index + S``.

    CONTRACT (as in the JAX package): a row's table names valid pool
    pages for every position it will touch, and every other entry names
    the caller's garbage SINK page, because tail blocks do receive writes
    (bucket-pad overshoot, the garbage steps of free rows).
    """
    pk, pv = cache.pages_key[layer], cache.pages_value[layer]
    ks = vs = None
    if cache.key_scales is not None:
        ks, vs = cache.key_scales[layer], cache.value_scales[layer]
    table, idx = cache.page_table, cache.cache_index
    S = k.shape[1]
    if S > 1:
        out, _ = paged_prefill(q, k, v, pk, pv, table, idx, key_scales=ks,
                               value_scales=vs)
        return out
    if ks is not None:
        # the one-token quantising store: the JAX blend writes the same
        # bytes (a valid table never names a page outside the pool)
        _write_pages_int8(k, v, pk, pv, ks, vs, table, idx)
    else:
        NP, P = pk.shape[:2]
        pos = idx.long()
        block = (pos // P).clamp(0, table.shape[1] - 1)
        # an out-of-range page id clamps to the pool's last page (the sink
        # in the serving layout) instead of raising; masking it out would
        # cost a host sync per layer
        phys = torch.gather(table.long(), 1,
                            block[:, None])[:, 0].clamp(0, NP - 1)
        # in place: the JAX step donates the pool instead
        pk[phys, pos % P] = k[:, 0].to(pk.dtype)
        pv[phys, pos % P] = v[:, 0].to(pv.dtype)
    return paged_attention(q, pk, pv, table, idx + S, key_scales=ks,
                           value_scales=vs)


def _slot_attention_body(q, k, v, cache, layer):
    """Dense slot-cache attention for one layer (the ``decode_slots``
    branch of the JAX ``_decode_attention``, computed there in XLA, so
    plain products here too).

    ``cache`` holds this layer's store ``keys[layer] / values[layer]
    [n_slots + 1, L, n_kv, Dh]`` (an int8 store also ``key_scales[layer]
    / value_scales[layer] [n_slots + 1, L, n_kv]`` f32), ``cache_index
    [B]`` and ``rows`` (the view's store rows; None: ``0..B-1``).  The
    chunk's k/v are written at each row's ``cache_index`` (int8: through
    ``kv_quantize``, bit-identical to ``_kv_quantize``); positions past L
    go to the garbage row (the JAX one-hot write drops them).  Query s
    of row b then sees key j iff ``j <= cache_index[b] + s``, f32
    softmax, probabilities rounded to the activation dtype."""
    ck, cv = cache.keys[layer], cache.values[layer]
    quant = cache.key_scales is not None
    B, S, n_kv, Dh = k.shape
    L, garbage = ck.shape[1], ck.shape[0] - 1
    dev = k.device
    pos = cache.cache_index.long()[:, None] + torch.arange(S, device=dev)
    rows = (torch.arange(B, device=dev) if cache.rows is None
            else cache.rows.long())
    inside = pos < L
    wrow = torch.where(inside, rows[:, None], garbage)
    wpos = torch.where(inside, pos, L - 1)
    if quant:
        k_st, k_sc = kv_quantize(k)
        v_st, v_sc = kv_quantize(v)
        cache.key_scales[layer][wrow, wpos] = k_sc
        cache.value_scales[layer][wrow, wpos] = v_sc
    else:
        k_st, v_st = k, v
    ck[wrow, wpos] = k_st.to(ck.dtype)
    cv[wrow, wpos] = v_st.to(cv.dtype)
    pick = slice(0, B) if cache.rows is None else rows
    kf, vf = ck[pick], cv[pick]
    if quant:
        kf = kv_dequantize(kf, cache.key_scales[layer][pick], q.dtype)
        vf = kv_dequantize(vf, cache.value_scales[layer][pick], q.dtype)
    H = q.shape[2]
    # query head h reads kv head h // (H // n_kv), as _kv_repeat does
    qg = q.reshape(B, S, n_kv, H // n_kv, Dh)
    logits = (torch.einsum("bsngd,blnd->bngsl", qg, kf).float()
              * (1.0 / math.sqrt(Dh)))
    visible = torch.arange(L, device=dev)[None, None, :] <= pos[:, :, None]
    logits = torch.where(visible[:, None, None], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bngsl,blnd->bsngd", probs, vf).reshape(B, S, H, Dh)


def _activation(x, name):
    if name == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if name == "gelu_exact":
        return F.gelu(x)
    if name == "relu":
        return F.relu(x)
    if name == "silu":
        return F.silu(x)
    raise ValueError(f"activation={name!r} not in "
                     "('gelu_tanh', 'gelu_exact', 'relu', 'silu')")


class DenseMLP(nn.Module):
    """``plain``: wo(act(wi x)); ``gated``: wo(act(wi_gate x) * wi_up x)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        dt = torch_dtype(cfg)
        if cfg.mlp_style == "gated":
            self.wi_gate = Dense(cfg.d_model, cfg.d_ff, cfg.use_bias, dt)
            self.wi_up = Dense(cfg.d_model, cfg.d_ff, cfg.use_bias, dt)
        else:
            self.wi = Dense(cfg.d_model, cfg.d_ff, cfg.use_bias, dt)
        self.wo = Dense(cfg.d_ff, cfg.d_model, cfg.use_bias, dt)

    def forward(self, x):
        par = _par(self.cfg)
        split = self.wo.local_shape()[1] < self.cfg.d_ff
        if par.sp and not split:
            raise _a3c("sequence parallelism over an MLP that tp does not "
                       "split")
        if split:
            x = (coll.gather_seq(x, par.tp) if par.sp
                 else coll.copy_to_tp(x, par.tp))
        if self.cfg.mlp_style == "gated":
            h = (_activation(self.wi_gate(x), self.cfg.activation)
                 * self.wi_up(x))
        else:
            h = _activation(self.wi(x), self.cfg.activation)
        return _row_parallel(self.wo, h, par) if split else self.wo(h)


def _stable_topk(p, k):
    """``jax.lax.top_k`` over the last dim: the k largest, ties broken
    toward the lower index (a stable descending sort; ``torch.topk``
    promises no order among equal values)."""
    vals, idx = torch.sort(p, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoEMLP(nn.Module):
    """Mixture-of-experts MLP — the JAX ``MoEMLP`` (Switch / GShard).

    The router (``router``, an f32 Dense over the f32 stream) gives each
    token a softmax over ``num_experts`` experts; the experts are
    ``experts_wi`` ``[E, D, F]`` / ``experts_wo`` ``[E, F, D]`` (and, for
    ``mlp_style="gated"``, ``experts_up``, the linear branch), run as
    batched products in the activation dtype.

    - ``dense``: each token through its argmax expert, the output times
      that expert's probability (in the activation dtype, as JAX scales
      it);
    - ``topk``: each token picks its top ``moe_top_k`` experts (ties to
      the lower index, as ``lax.top_k``); each expert has ``C = min(T,
      ceil(capacity_factor * k * T / E))`` slots over the call's ``T =
      B * S`` tokens, claimed in token order, all first choices before
      second ones; a token past its expert's capacity contributes zero
      (the residual carries it); for ``k > 1`` the combine weights are
      renormalised over the chosen experts.

    JAX computes the dispatch and combine as one-hot ``[T, E, C]``
    einsums; here the same slots are index copies into an ``[E, C, D]``
    buffer and gathers out of it (both exact).  After each forward,
    ``aux_loss`` holds the Switch load-balancing loss ``E * sum(
    frac_tokens * frac_probs)`` (``frac_tokens`` from the pre-drop first
    choices), the value JAX ``sow``s and no step adds to a loss;
    ``dropped`` the share of the ``k * T`` token-expert assignments that
    overflowed; ``expert_index`` the chosen experts ``[B, S, k]``.  All
    three are detached."""

    def __init__(self, cfg):
        super().__init__()
        if cfg.moe_router not in ("dense", "topk"):
            raise ValueError(
                f"moe_router={cfg.moe_router!r} not in ('dense', 'topk')")
        E = cfg.num_experts
        if cfg.moe_router == "topk" and not 1 <= cfg.moe_top_k <= E:
            raise ValueError(f"moe_top_k={cfg.moe_top_k} must be in "
                             f"[1, {E}]")
        self.cfg = cfg
        D, Fd = cfg.d_model, cfg.d_ff
        self.router = Dense(D, E, False, torch.float32)
        self.experts_wi = nn.Parameter(torch.empty(E, D, Fd))
        self.experts_wo = nn.Parameter(torch.empty(E, Fd, D))
        self.experts_up = (nn.Parameter(torch.empty(E, D, Fd))
                           if cfg.mlp_style == "gated" else None)
        self.aux_loss = self.dropped = self.expert_index = None

    def forward(self, x):
        cfg = self.cfg
        par = _par(cfg)
        if (par.tp.size > 1 or par.cp.size > 1
                or self.experts_wi.shape[0] < cfg.num_experts
                or self.experts_wi.shape[2] < cfg.d_ff):
            raise _a3c("MoE layers split over a mesh (experts over ep, "
                       "d_ff over tp, tokens over sp / cp)")
        dt = torch_dtype(cfg)
        B, S, D = x.shape
        E = cfg.num_experts
        dense = cfg.moe_router == "dense"
        k = 1 if dense else cfg.moe_top_k
        T = B * S
        probs = torch.softmax(self.router(x.float()), dim=-1)   # f32
        pt = probs.reshape(T, E)
        top_p, idx = _stable_topk(pt, k)                        # [T, k]
        if dense:
            C = T
        else:
            C = min(int(max(1, -(-cfg.moe_capacity_factor * k * T // E))),
                    T)
            if k > 1:
                top_p = top_p / torch.clamp_min(
                    top_p.sum(-1, keepdim=True), 1e-9)
        # slot c of each token: its place in its expert's queue (all
        # first choices before second ones); row E*C is where overflow
        # goes (sliced off, so its output reads as zero)
        counts = torch.zeros(E, dtype=torch.long, device=x.device)
        flat, keep = [], []
        for c in range(k):
            onehot = F.one_hot(idx[:, c], E)
            pos = torch.cumsum(onehot, 0) - 1 + counts
            counts = counts + onehot.sum(0)
            p = pos.gather(1, idx[:, c:c + 1])[:, 0]
            kept = p < C
            flat.append(torch.where(kept, idx[:, c] * C + p, E * C))
            keep.append(kept)
        xt = x.reshape(T, D).to(dt)
        expert_in = xt.new_zeros(E * C + 1, D).index_add(
            0, torch.cat(flat), xt.repeat(k, 1))
        out = self._experts(expert_in[:E * C].reshape(E, C, D), dt)
        out = torch.cat([out.reshape(E * C, D), out.new_zeros(1, D)])
        if dense:
            y = out[flat[0]] * top_p.to(dt)
        else:
            y = sum(out[flat[c]].float()
                    * (top_p[:, c] * keep[c])[:, None]
                    for c in range(k)).to(dt)
        with torch.no_grad():
            frac_tokens = F.one_hot(idx[:, 0], E).float().mean(0)
            frac_probs = probs.reshape(T, E).mean(0)
            self.aux_loss = E * torch.sum(frac_tokens * frac_probs)
            self.dropped = 1.0 - torch.stack(keep).float().mean()
            self.expert_index = idx.reshape(B, S, k)
        return y.reshape(B, S, D)

    def _experts(self, xe, dt):
        """[E, C, D] -> [E, C, D]: each expert's MLP over its slots."""
        h = _activation(torch.bmm(xe, self.experts_wi.to(dt)),
                        self.cfg.activation)
        if self.experts_up is not None:
            h = h * torch.bmm(xe, self.experts_up.to(dt))
        return torch.bmm(h, self.experts_wo.to(dt))


class Block(nn.Module):
    """One block: pre-LN ``x + f(ln(x))`` or post-LN ``ln(x + f(x))``;
    its MLP is ``mlp`` (:class:`DenseMLP`) or, with ``use_moe``, ``moe``
    (:class:`MoEMLP`)."""

    def __init__(self, cfg, use_moe=False):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _make_ln(cfg)
        self.ln2 = _make_ln(cfg)
        self.attn = Attention(cfg)
        if use_moe:
            self.moe = MoEMLP(cfg)
        else:
            self.mlp = DenseMLP(cfg)

    def forward(self, x, cache=None, layer=0, mask=None, lora=None):
        mlp = self.moe if hasattr(self, "moe") else self.mlp
        if self.cfg.norm_style == "pre":
            x = x + self.attn(self.ln1(x), cache, layer, mask, lora)
            return x + mlp(self.ln2(x))
        dt = torch_dtype(self.cfg)
        x = self.ln1(x + self.attn(x, cache, layer, mask, lora)).to(dt)
        return self.ln2(x + mlp(x)).to(dt)


class Transformer(nn.Module):
    """Token ids -> logits (``return_hidden=True``: the post-``ln_f``
    hidden states in the activation dtype instead).  With ``cache`` (a
    dense or a paged slot cache from ``models.decode``) the forward is
    one prefill chunk or decode step at each row's ``cache_index``, and
    advances the index by S.  ``lora = (banks, ids)`` adds per-row
    adapters to the attention projections (``Attention._proj``):
    ``banks`` maps each layer name to its ``{proj}_a`` / ``{proj}_b``
    banks, ``ids [B]`` each row's bank index."""

    def __init__(self, cfg):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        if not cfg.rope:
            self.pos_embed = nn.Embedding(cfg.max_seq_len, cfg.d_model)
        self.layer_names = [f"layer_{i}" for i in range(cfg.n_layers)]
        for i, name in enumerate(self.layer_names):
            # every moe_every-th layer is MoE (moe_every=1: every layer)
            use_moe = cfg.num_experts > 0 and (
                i % cfg.moe_every == cfg.moe_every - 1)
            self.add_module(name, Block(cfg, use_moe=use_moe))
        self.ln_f = _make_ln(cfg)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, False,
                             torch_dtype(cfg))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """The JAX package's initialisers in distribution: lecun-normal
        kernels (std 1/sqrt(fan_in)), embeddings std 1/sqrt(rows), norm
        scales one, biases zero.  ``generator`` seeds the draw."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, Dense):
                    mod.weight.normal_(0.0, mod.weight.shape[1] ** -0.5,
                                       generator=generator)
                    if mod.bias is not None:
                        mod.bias.zero_()
                elif isinstance(mod, nn.Embedding):
                    mod.weight.normal_(0.0, mod.weight.shape[0] ** -0.5,
                                       generator=generator)
                elif isinstance(mod, (RMSNorm, LayerNorm)):
                    mod.weight.fill_(1.0)
                    if isinstance(mod, LayerNorm):
                        mod.bias.zero_()
                elif isinstance(mod, MoEMLP):
                    # flax lecun_normal over [E, in, out]: fan_in E * in
                    for w in (mod.experts_wi, mod.experts_wo,
                              mod.experts_up):
                        if w is not None:
                            w.normal_(0.0, (w.shape[0] * w.shape[1]) ** -0.5,
                                      generator=generator)

    def split(self):
        """True when tp splits this model's parameters (``shard_params``
        on a tp mesh: the first layer's attention, the tables or the
        head), so that its forwards run on that mesh only."""
        return (getattr(self, self.layer_names[0]).attn.split()
                if self.layer_names else False) or (
            self.token_embed.weight.shape[1] < self.cfg.d_model
            or self.lm_head.local_shape()[0] < self.cfg.vocab_size)

    def moe_layers(self):
        """``{layer name: MoEMLP}`` of the MoE layers, in order (each
        holds its last forward's ``aux_loss``, ``dropped`` and
        ``expert_index``)."""
        return {name: getattr(self, name).moe for name in self.layer_names
                if hasattr(getattr(self, name), "moe")}

    def forward(self, tokens, cache=None, lora=None, return_hidden=False):
        cfg = self.cfg
        dt = torch_dtype(cfg)
        par = _par(cfg)
        x = F.embedding(tokens, self.token_embed.weight).to(dt)
        S = tokens.shape[1]
        if not cfg.rope:
            pos = torch.arange(S, device=tokens.device)
            if cache is not None:          # per-row positions: [B, S]
                pos = cache.cache_index.long()[:, None] + pos[None, :]
            elif S * par.cp.size > cfg.max_seq_len:
                # the JAX gather fills NaN past the table: a too-long
                # batch must not train on clamped positions
                raise ValueError(f"sequence length {S * par.cp.size} "
                                 f"exceeds max_seq_len {cfg.max_seq_len} "
                                 "(learned positions)")
            else:
                # under cp, this rank's block of the global positions
                pos = (pos + par.cp.index * S)[None]
            # free rows keep stepping past max_seq_len; the lookup clips
            # (their tokens are discarded)
            pos = pos.clamp(0, cfg.max_seq_len - 1)
            x = x + F.embedding(pos, self.pos_embed.weight).to(dt)
        if x.shape[-1] < cfg.d_model:
            # tp splits the tables over d_model: this rank's columns,
            # gathered (under sp: exchanged for this rank's sequence block)
            x = (coll.all_to_all(x, par.tp, split_dim=1, concat_dim=2)
                 if par.sp else
                 coll.gather_seq(x, par.tp, dim=2, reduce_grad=False))
        elif par.sp:
            x = coll.split_seq(x, par.tp)
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, name in enumerate(self.layer_names):
            block = getattr(self, name)
            if remat:
                # nn.remat(Block): keep only the block's input, recompute
                # its activations in the backward
                x = checkpoint(block, x, None, i, use_reentrant=False)
            else:
                x = block(x, cache, i, None, None if lora is None
                          else (lora[0][name], lora[1]))
        if cache is not None:
            cache.cache_index = cache.cache_index + S
        if return_hidden:
            # the post-ln_f stream for a loss that fuses the unembedding
            # (ops.xent.fused_unembed_xent): lm_head.weight gets its
            # gradient through that op
            if par.tp.size > 1 or par.cp.size > 1:
                raise _a3c("return_hidden on a tp / sp / cp mesh")
            return self.ln_f(x).to(dt)
        return _head(self.ln_f, self.lm_head, x, par, cfg.vocab_size)

    def grad_axes(self, mesh):
        """``(partial, distinct)``, each ``{name: axes}``: ``partial``
        names the leaves whose gradient a rank holds only part of on
        ``mesh``, summed over those axes by the train step: every leaf
        under context parallelism (a rank sees its sequence block), and
        under sp the leaves replicated over tp that act on a sequence
        block (the norms, the row-parallel biases).  ``distinct`` is
        empty: the split leaves are told by their shardings."""
        cfg = self.cfg
        cp_axis = cfg.ring_attention_axis or cfg.ulysses_axis
        shape = mesh.shape if mesh is not None else {}
        partial = {}
        for name, _ in self.named_parameters():
            parts = name.split(".")
            if cp_axis and shape.get(cp_axis, 1) > 1:
                partial[name] = (cp_axis,)
            elif cfg.sp_axis and shape.get(AXIS_TP, 1) > 1 and (
                    parts[-2] in ("ln1", "ln2", "ln_f")
                    or parts[-2] in ("out", "wo") and parts[-1] == "bias"):
                partial[name] = (AXIS_TP,)
        return partial, {}


def _head(ln_f, lm_head, x, par, vocab):
    """``lm_head(ln_f(x))``; a vocab-split ``lm_head`` (tp) gives this
    rank's slice of the vocabulary, and the logits carry the split
    (:class:`LogitsSplit`) for :func:`lm_loss`."""
    h = ln_f(x)
    vsplit = lm_head.local_shape()[0] < vocab
    if par.sp:
        h = coll.gather_seq(h, par.tp, reduce_grad=vsplit)
    elif vsplit:
        h = coll.copy_to_tp(h, par.tp)
    logits = lm_head(h)
    if par.tp.size > 1 or par.cp.size > 1:
        logits.logits_split = LogitsSplit(
            par.tp if vsplit else coll.SOLO,
            par.tp.index * logits.shape[-1] if vsplit else 0, vocab,
            par.cp)
    return logits


class LogitsSplit(NamedTuple):
    """How a forward's logits lie over the ranks: ``vocab`` (the group
    over whose ranks the vocabulary is split, this rank's slice starting
    at ``start`` of ``size``) and ``seq`` (the group over which the
    sequence is split)."""
    vocab: Any
    start: int
    size: int
    seq: Any


def lm_loss(logits, targets, ignore_id=-1):
    """Causal-LM cross entropy: f32 logsumexp minus the gold logit, the
    mean over targets that are not ``ignore_id``.  Logits that a split
    forward made (:class:`LogitsSplit`) take :func:`vocab_parallel_lm_loss`:
    the mean over the whole sequence and vocabulary, the same on every
    rank of the split."""
    split = getattr(logits, "logits_split", None)
    if split is not None:
        return vocab_parallel_lm_loss(logits, targets, split, ignore_id)
    mesh = active_mesh()
    if mesh is not None and mesh.shape.get(AXIS_TP, 1) > 1:
        raise ValueError(
            "logits on a tp mesh must come straight from the model's "
            "forward (they carry its vocabulary and sequence split)")
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.clamp_min(0).long()[..., None])
    mask = (targets != ignore_id).float()
    return (torch.sum((logz - gold[..., 0]) * mask)
            / torch.clamp_min(torch.sum(mask), 1.0))


def vocab_parallel_lm_loss(logits, targets, split, ignore_id=-1):
    """:func:`lm_loss` of logits split over ranks (the JAX one-hot form
    for a vocab-sharded ``lm_head``, written out): each rank's max, its
    sum of exponentials and the gold logit where the target lies in its
    vocabulary slice, combined by all-reduce over the vocab group; under
    context parallelism the token sum and count all-reduced over the
    sequence group.  The whole ``[B, S, vocab]`` logits never form."""
    import torch.distributed as dist

    lg = logits.float()
    vg = split.vocab
    m = lg.detach().amax(-1)
    if vg.size > 1:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=vg.pg)
    sumexp = coll.reduce_from_tp(torch.exp(lg - m[..., None]).sum(-1), vg)
    logz = torch.log(sumexp) + m
    local = targets.clamp_min(0).long() - split.start
    inside = (local >= 0) & (local < lg.shape[-1])
    gold = torch.gather(lg, -1, local.clamp(0, lg.shape[-1] - 1)[..., None])
    gold = coll.reduce_from_tp(gold[..., 0] * inside, vg)
    mask = (targets != ignore_id).float()
    total = coll.reduce_from_tp(torch.sum((logz - gold) * mask), split.seq)
    count = torch.sum(mask)
    if split.seq.size > 1:
        count = count.clone()
        dist.all_reduce(count, group=split.seq.pg)
    return total / torch.clamp_min(count, 1.0)


def gather_vocab(logits, select=None):
    """The whole-vocabulary logits of a split forward's (this rank's
    sequence block of them), all-gathered over the vocab group.
    ``select`` (a function of the logits) picks the rows to gather
    first, so a decode step or a prefill chunk gathers only the
    positions it picks from: every rank then picks from the same
    whole-vocabulary logits."""
    split = getattr(logits, "logits_split", None)
    if select is not None:
        logits = select(logits)
    if split is None or split.vocab.size == 1:
        return logits
    return coll.gather_seq(logits, split.vocab, dim=logits.dim() - 1,
                           reduce_grad=False)


def build_transformer(**kwargs):
    """Export-spec builder (``"module:callable"``): rebuilds
    ``Transformer`` from JSON-able TransformerConfig fields."""
    return Transformer(TransformerConfig(**kwargs))
