"""BERT encoder family — counterpart of ``tensorflowonspark_tpu/models/
bert.py``: ``BertConfig`` with the HF-faithful defaults (post-LN blocks,
biased denses, erf GELU, ``ln_eps`` 1e-12), ``BertEncoder`` (token +
position + segment embeddings, ``ln_embed``, the port's transformer
``Block`` s bidirectional) and ``BertForPreTraining`` (the MLM head
decoding against the tied ``token_embed`` with a free ``mlm_bias``, and
the NSP head over a tanh pooler of position 0), with the losses,
``apply_mlm_masking`` and ``check_checkpoint_layout``.

A key-padding ``attention_mask`` ``[B, S]`` (True / nonzero = attend)
takes dense attention, as in the JAX package; without one, on a CUDA
tensor, attention runs the flash kernels (head_dim 64 in BERT-base)."""
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tensorflowonspark_tpu_torch.models.common import init_zoo_
from tensorflowonspark_tpu_torch.models.transformer import (
    Block, Dense, LayerNorm, TransformerConfig, _activation, check_ported,
    lm_loss, torch_dtype)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    dtype: str = "bfloat16"
    remat: bool = False
    attention_impl: str = "auto"
    mask_token_id: int = 103  # [MASK] in the canonical BERT vocab
    # original-BERT numerics: post-LN blocks, biased denses, erf GELU
    norm_style: str = "post"
    use_bias: bool = True
    activation: str = "gelu_exact"
    ln_eps: float = 1e-12

    def block_config(self):
        """The shared transformer-block config, bidirectional."""
        return TransformerConfig(
            vocab_size=self.vocab_size, d_model=self.d_model,
            n_heads=self.n_heads, n_layers=self.n_layers, d_ff=self.d_ff,
            max_seq_len=self.max_seq_len, causal=False, dtype=self.dtype,
            remat=self.remat, attention_impl=self.attention_impl,
            norm_style=self.norm_style, use_bias=self.use_bias,
            activation=self.activation, ln_eps=self.ln_eps)


class BertEncoder(nn.Module):
    """Embeddings -> ``ln_embed`` -> the bidirectional stack (-> ``ln_f``
    for pre-LN blocks: post-LN blocks end normalised)."""

    def __init__(self, cfg):
        super().__init__()
        bcfg = cfg.block_config()
        check_ported(bcfg)
        self.cfg, self.bcfg = cfg, bcfg
        d = cfg.d_model
        self.token_embed = nn.Embedding(cfg.vocab_size, d)
        self.pos_embed = nn.Embedding(cfg.max_seq_len, d)
        if cfg.type_vocab_size:
            self.type_embed = nn.Embedding(cfg.type_vocab_size, d)
        self.ln_embed = LayerNorm(d, cfg.ln_eps)
        self.layer_names = [f"layer_{i}" for i in range(cfg.n_layers)]
        for name in self.layer_names:
            self.add_module(name, Block(bcfg))
        if cfg.norm_style != "post":
            self.ln_f = LayerNorm(d, cfg.ln_eps)

    def forward(self, tokens, type_ids=None, attention_mask=None):
        cfg = self.cfg
        dt = torch_dtype(self.bcfg)
        S = tokens.shape[1]
        if S > cfg.max_seq_len:
            raise ValueError(f"sequence length {S} exceeds max_seq_len "
                             f"{cfg.max_seq_len}")
        x = F.embedding(tokens, self.token_embed.weight).to(dt)
        pos = torch.arange(S, device=tokens.device)[None]
        x = x + F.embedding(pos, self.pos_embed.weight).to(dt)
        if cfg.type_vocab_size:
            if type_ids is None:
                type_ids = torch.zeros_like(tokens)
            x = x + F.embedding(type_ids, self.type_embed.weight).to(dt)
        x = self.ln_embed(x).to(dt)
        mask = None if attention_mask is None else attention_mask.bool()
        remat = cfg.remat and torch.is_grad_enabled()
        for name in self.layer_names:
            block = getattr(self, name)
            x = (checkpoint(block, x, None, 0, mask, use_reentrant=False)
                 if remat else block(x, mask=mask))
        if cfg.norm_style == "post":
            return x
        return self.ln_f(x)


class BertForPreTraining(nn.Module):
    """MLM head (embedding-tied decoder) + NSP head over the [CLS]
    pooler: ``(mlm_logits [B, S, V], nsp_logits [B, 2])``, f32."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        dt = torch_dtype(cfg.block_config())
        d = cfg.d_model
        self.encoder = BertEncoder(cfg)
        self.mlm_dense = Dense(d, d, True, dt)
        self.mlm_ln = LayerNorm(d, cfg.ln_eps)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        self.pooler = Dense(d, d, True, dt)
        self.nsp_head = Dense(d, 2, True, torch.float32)
        init_zoo_(self)

    def forward(self, tokens, type_ids=None, attention_mask=None):
        cfg = self.cfg
        dt = self.mlm_dense.dtype
        h = self.encoder(tokens, type_ids, attention_mask)
        t = self.mlm_ln(_activation(self.mlm_dense(h), cfg.activation))
        # embed.attend: the tied table in the activation dtype, then the
        # f32 bias (the sum promotes to f32)
        mlm_logits = (F.linear(t.to(dt), self.encoder.token_embed.weight
                               .to(dt)) + self.mlm_bias)
        pooled = torch.tanh(self.pooler(h[:, 0]))
        return mlm_logits, self.nsp_head(pooled.float())


def check_checkpoint_layout(cfg, params):
    """Raise when a parameter tree's norm layout disagrees with
    ``cfg.norm_style``: the pre-LN layout carries ``encoder/ln_f``, the
    (default, HF-faithful) post-LN layout does not (MIGRATION.md "BERT
    checkpoint layout").  ``params``: a flax tree (nested dicts,
    optionally under ``"params"``) or the port's ``state_dict``."""
    if isinstance(params, dict) and "params" in params:
        params = params["params"]
    if isinstance(params, dict) and any("." in k for k in params):
        enc = {k.split(".")[1]: v for k, v in params.items()
               if k.startswith("encoder.")}
    else:
        enc = params.get("encoder", params) if isinstance(params, dict) \
            else {}
    has_ln_f = isinstance(enc, dict) and "ln_f" in enc
    if cfg.norm_style == "post" and has_ln_f:
        raise ValueError(
            "checkpoint contains encoder/ln_f (pre-LN layout) but the "
            "config is norm_style='post' (the default since the HF-faithful "
            "change); load with BertConfig(norm_style='pre', use_bias=False, "
            "activation='gelu', ln_eps=1e-6) or re-save the checkpoint")
    if cfg.norm_style != "post" and isinstance(enc, dict) and enc \
            and not has_ln_f:
        raise ValueError(
            "checkpoint lacks encoder/ln_f but the config is pre-LN; this "
            "looks like a post-LN checkpoint — use the default BertConfig")


def build_bert(**kwargs):
    """Builder-spec target for exports (``'module:callable'`` with JSON
    kwargs, BertConfig fields)."""
    return BertForPreTraining(BertConfig(**kwargs))


def mlm_loss(logits, targets):
    """Masked-LM cross entropy; ``targets`` are the original ids at the
    masked positions and -1 elsewhere (ignored)."""
    return lm_loss(logits, targets, ignore_id=-1)


def nsp_loss(logits, labels):
    """Next-sentence-prediction cross entropy over ``[B, 2]`` logits."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None])[:, 0].mean()


def apply_mlm_masking(rng, tokens, mask_token_id, vocab_size,
                      mask_prob=0.15):
    """The BERT 80/10/10 corruption, in numpy: of the ``mask_prob``
    selected positions, 80% become ``mask_token_id``, 10% a random token,
    10% stay.  Returns ``(corrupted_tokens, targets)``, targets -1 where
    nothing was selected.  The same numpy draws in the same order as the
    JAX function, so one seed gives its masks."""
    rng = np.random.default_rng(rng)
    tokens = np.asarray(tokens)
    select = rng.random(tokens.shape) < mask_prob
    targets = np.where(select, tokens, -1)
    action = rng.random(tokens.shape)
    corrupted = tokens.copy()
    corrupted[select & (action < 0.8)] = mask_token_id
    rand_tok = rng.integers(0, vocab_size, tokens.shape)
    corrupted[select & (action >= 0.8) & (action < 0.9)] = \
        rand_tok[select & (action >= 0.8) & (action < 0.9)]
    return corrupted, targets
