"""Transformer LM — counterpart of ``tensorflowonspark_tpu/models/
transformer.py`` for the serving and training slices.

The same ``TransformerConfig`` (field names and defaults), the same
parameter tree under PyTorch names (``convert.params_from_jax`` maps
one onto the other), and the same math: RoPE with split-half pairing,
GQA attention with f32 softmax, plain or gated MLPs, RMSNorm or
LayerNorm (statistics in f32), pre- or post-LN blocks.

Attention paths, as in the JAX package: the cache-free forward runs the
flash kernels (``ops.flash_attention``, differentiable) for
``attention_impl="flash"``, or ``"auto"`` on a CUDA tensor, and dense
attention otherwise; the paged slot cache (``_paged_attention_body``)
runs the paged kernels.  ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``).  :func:`lm_loss` is the causal-LM loss the
train step uses.  Fields of the config whose feature is not ported raise
``NotImplementedError`` naming the ROADMAP item when they are set.
"""
import dataclasses
import logging
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tensorflowonspark_tpu_torch.ops.flash_attention import flash_attention
from tensorflowonspark_tpu_torch.ops.paged_attention import paged_attention
from tensorflowonspark_tpu_torch.ops.paged_prefill import paged_prefill


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
    num_experts: int = 0          # >0 = MoE (not ported)
    moe_every: int = 2
    moe_router: str = "dense"
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    remat: bool = False           # recompute each block in the backward
    ring_attention_axis: Optional[str] = None   # context parallelism
    ulysses_axis: Optional[str] = None          # (not ported)
    sp_axis: Optional[str] = None
    attention_impl: str = "auto"  # auto | flash (CUDA kernels) | dense
    use_bias: bool = False
    ln_eps: float = 1e-6
    norm_type: str = "layernorm"  # layernorm | rmsnorm
    fused_ln: bool = False        # kernel 11 (not ported)
    norm_style: str = "pre"       # pre | post
    activation: str = "gelu_tanh"  # gelu_tanh | gelu_exact | relu | silu
    mlp_style: str = "plain"      # plain | gated
    decode: bool = False          # the JAX package's decode-mode flags;
    decode_slots: bool = False    # here the cache object passed to the
    kv_page_size: int = 0         # forward decides the decode mode
    kv_pages: int = 0
    kv_table_pages: int = 0
    kv_dtype: str = "auto"        # auto only; int8 kv is not ported
    paged_attn_impl: str = "kernel"    # the kernels are the only paged
    quant_matmul_impl: str = "kernel"  # path on the card; float weights
    paged_prefill_impl: str = "kernel"  # only (no quantized leaves)


_UNPORTED = (
    ("num_experts", lambda v: v > 0,
     "MoE layers (ROADMAP: the zoo and the rest)"),
    ("ring_attention_axis", bool,
     "context-parallel attention (ROADMAP: the zoo and the rest)"),
    ("ulysses_axis", bool,
     "context-parallel attention (ROADMAP: the zoo and the rest)"),
    ("sp_axis", bool, "sequence parallelism (ROADMAP: the zoo and the rest)"),
    ("fused_ln", bool, "the fused LayerNorm kernel (ROADMAP: kernel 11)"),
    ("kv_dtype", lambda v: v != "auto",
     "int8 kv pools (ROADMAP: int8 kv branch of kernels 1-3)"),
    ("kv_table_pages", lambda v: v > 0,
     "growable page tables (ROADMAP: async engine, prefix cache, growable "
     "tables and streaming)"),
    ("paged_attn_impl", lambda v: v != "kernel",
     "a selectable reference read path (the kernel is the only card path)"),
    ("paged_prefill_impl", lambda v: v != "kernel",
     "a selectable reference prefill path (the kernels are the only card "
     "path)"),
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
    if cfg.norm_type not in ("layernorm", "rmsnorm"):
        raise ValueError(
            f"norm_type={cfg.norm_type!r} not in ('layernorm', 'rmsnorm')")
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


class Dense(nn.Module):
    """The float path of the JAX package's ``QuantDense`` (``nn.Dense``
    semantics): input, weight and bias promoted to ``dtype``, then one
    matmul.  The weight is ``[out, in]`` (flax keeps ``[in, out]``)."""

    def __init__(self, in_features, features, use_bias, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)
        self.dtype = dtype

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


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


def _make_ln(cfg):
    if cfg.norm_type == "rmsnorm":
        return RMSNorm(cfg.d_model, cfg.ln_eps)
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

    def forward(self, x, cache=None, layer=0, mask=None):
        cfg = self.cfg
        B, S = x.shape[0], x.shape[1]
        q = self.query(x).reshape(B, S, cfg.n_heads, self.head_dim)
        k = self.key(x).reshape(B, S, self.n_kv, self.head_dim)
        v = self.value(x).reshape(B, S, self.n_kv, self.head_dim)
        if cfg.rope:
            pos = torch.arange(S, device=x.device)
            if cache is not None:           # per-row positions: [B, S]
                pos = cache.cache_index.long()[:, None] + pos[None, :]
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        if cache is not None:
            if not cfg.causal:
                raise NotImplementedError(
                    "decode mode is autoregressive (causal) generation; "
                    "causal=False has no incremental form")
            if mask is not None:
                raise NotImplementedError(
                    "key-padding masks are not supported in decode mode")
            out = _paged_attention_body(q, k, v, cache, layer)
        elif mask is None and (cfg.attention_impl == "flash" or (
                cfg.attention_impl == "auto" and q.is_cuda)):
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
        return self.out(out.reshape(B, S, cfg.d_model))


def _paged_attention_body(q, k, v, cache, layer):
    """Paged continuous-batching attention for one layer.

    ``cache`` holds this layer's pool ``pages_key[layer] /
    pages_value[layer] [kv_pages, page, n_kv, Dh]``, the per-row
    ``page_table [B, max_pages]`` and ``cache_index [B]`` (tokens already
    written).  Prefill chunks (S > 1) run ``paged_prefill`` (page write +
    chunked flash read).  Decode steps (S == 1) write the token's k/v by
    plain tensor indexing and read through ``paged_attention`` with
    ``lengths = cache_index + S``.

    CONTRACT (as in the JAX package): a row's table names valid pool
    pages for every position it will touch, and every other entry names
    the caller's garbage SINK page, because tail blocks do receive writes
    (bucket-pad overshoot, the garbage steps of free rows).
    """
    pk, pv = cache.pages_key[layer], cache.pages_value[layer]
    table, idx = cache.page_table, cache.cache_index
    S = k.shape[1]
    if S > 1:
        out, _ = paged_prefill(q, k, v, pk, pv, table, idx)
        return out
    NP, P = pk.shape[:2]
    pos = idx.long()
    block = (pos // P).clamp(0, table.shape[1] - 1)
    # an out-of-range page id clamps to the pool's last page (the sink in
    # the serving layout) instead of raising; masking it out would cost
    # a host sync per layer
    phys = torch.gather(table.long(), 1, block[:, None])[:, 0].clamp(0, NP - 1)
    # in place: the JAX step donates the pool instead
    pk[phys, pos % P] = k[:, 0].to(pk.dtype)
    pv[phys, pos % P] = v[:, 0].to(pv.dtype)
    return paged_attention(q, pk, pv, table, idx + S)


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
        if self.cfg.mlp_style == "gated":
            h = (_activation(self.wi_gate(x), self.cfg.activation)
                 * self.wi_up(x))
        else:
            h = _activation(self.wi(x), self.cfg.activation)
        return self.wo(h)


class Block(nn.Module):
    """One block: pre-LN ``x + f(ln(x))`` or post-LN ``ln(x + f(x))``."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _make_ln(cfg)
        self.ln2 = _make_ln(cfg)
        self.attn = Attention(cfg)
        self.mlp = DenseMLP(cfg)

    def forward(self, x, cache=None, layer=0, mask=None):
        if self.cfg.norm_style == "pre":
            x = x + self.attn(self.ln1(x), cache, layer, mask)
            return x + self.mlp(self.ln2(x))
        dt = torch_dtype(self.cfg)
        x = self.ln1(x + self.attn(x, cache, layer, mask)).to(dt)
        return self.ln2(x + self.mlp(x)).to(dt)


class Transformer(nn.Module):
    """Token ids -> logits.  With ``cache`` (a paged slot cache from
    ``models.decode``) the forward is one prefill chunk or decode step
    at each row's ``cache_index``, and advances the index by S."""

    def __init__(self, cfg):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        if not cfg.rope:
            self.pos_embed = nn.Embedding(cfg.max_seq_len, cfg.d_model)
        self.layer_names = [f"layer_{i}" for i in range(cfg.n_layers)]
        for name in self.layer_names:
            self.add_module(name, Block(cfg))
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

    def forward(self, tokens, cache=None):
        cfg = self.cfg
        dt = torch_dtype(cfg)
        x = F.embedding(tokens, self.token_embed.weight).to(dt)
        S = tokens.shape[1]
        if not cfg.rope:
            pos = torch.arange(S, device=tokens.device)
            if cache is not None:          # per-row positions: [B, S]
                pos = cache.cache_index.long()[:, None] + pos[None, :]
            else:
                pos = pos[None]
            # free rows keep stepping past max_seq_len; the lookup clips
            # like the JAX gather (their tokens are discarded)
            pos = pos.clamp(0, cfg.max_seq_len - 1)
            x = x + F.embedding(pos, self.pos_embed.weight).to(dt)
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, name in enumerate(self.layer_names):
            block = getattr(self, name)
            if remat:
                # nn.remat(Block): keep only the block's input, recompute
                # its activations in the backward
                x = checkpoint(block, x, None, i, use_reentrant=False)
            else:
                x = block(x, cache, i)
        logits = self.lm_head(self.ln_f(x))
        if cache is not None:
            cache.cache_index = cache.cache_index + S
        return logits


def lm_loss(logits, targets, ignore_id=-1):
    """Causal-LM cross entropy: f32 logsumexp minus the gold logit, the
    mean over targets that are not ``ignore_id``."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.clamp_min(0).long()[..., None])
    mask = (targets != ignore_id).float()
    return (torch.sum((logz - gold[..., 0]) * mask)
            / torch.clamp_min(torch.sum(mask), 1.0))


def build_transformer(**kwargs):
    """Export-spec builder (``"module:callable"``): rebuilds
    ``Transformer`` from JSON-able TransformerConfig fields."""
    return Transformer(TransformerConfig(**kwargs))
