"""Vision Transformer — counterpart of ``tensorflowonspark_tpu/models/
vit.py``: a ``patch_embed`` conv (patch x patch, stride patch, VALID,
biased), an optional ``cls_token``, the raw ``pos_embed`` parameter
``[1, tokens, d_model]`` (not an embedding table), the port's
transformer ``Block`` s bidirectional (``causal=False``), ``ln_f`` and
a ``head`` over the cls token or the mean of the patch tokens.

On a CUDA tensor attention runs the flash kernels (``attention_impl=
"auto"``) at head_dim ``d_model / n_heads`` (ViT-B/16: 64, over 197
tokens, which the kernels' tail tiles cover)."""
import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tensorflowonspark_tpu_torch.models.common import Conv, init_zoo_
from tensorflowonspark_tpu_torch.models.transformer import (
    Block, Dense, LayerNorm, TransformerConfig, check_ported, torch_dtype)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    num_classes: int = 1000
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    dtype: str = "bfloat16"
    pool: str = "cls"             # cls token | mean over patch tokens
    remat: bool = False
    attention_impl: str = "auto"

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError(
                f"image_size {self.image_size} not divisible by "
                f"patch_size {self.patch_size}")
        if self.pool not in ("cls", "mean"):
            raise ValueError(f"pool={self.pool!r} not in ('cls', 'mean')")

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2

    def block_config(self):
        """The shared transformer-block config: bidirectional attention
        over the patch tokens (+1 cls token when pool='cls')."""
        return TransformerConfig(
            vocab_size=1, d_model=self.d_model, n_heads=self.n_heads,
            n_layers=self.n_layers, d_ff=self.d_ff,
            max_seq_len=self.num_patches + 1, causal=False,
            dtype=self.dtype, remat=self.remat,
            attention_impl=self.attention_impl)


class ViT(nn.Module):
    """images ``[B, H, W, C]`` (float, any scale) -> logits ``[B,
    num_classes]`` (f32)."""

    def __init__(self, cfg):
        super().__init__()
        bcfg = cfg.block_config()
        check_ported(bcfg)
        self.cfg, self.bcfg = cfg, bcfg
        d, p = cfg.d_model, cfg.patch_size
        self.patch_embed = Conv(cfg.channels, d, (p, p), (p, p),
                                padding="VALID", dtype=cfg.dtype)
        n_tokens = cfg.num_patches
        if cfg.pool == "cls":
            self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
            n_tokens += 1
        self.pos_embed = nn.Parameter(torch.empty(1, n_tokens, d))
        self.layer_names = [f"layer_{i}" for i in range(cfg.n_layers)]
        for name in self.layer_names:
            self.add_module(name, Block(bcfg))
        self.ln_f = LayerNorm(d, 1e-6)
        self.head = Dense(d, cfg.num_classes, True, torch.float32)
        self.reset_parameters()

    def reset_parameters(self):
        """Kernels lecun-normal, ``pos_embed`` std 0.02, ``cls_token``
        zeros (torch's global generator)."""
        init_zoo_(self)
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02)
            if self.cfg.pool == "cls":
                self.cls_token.zero_()

    def forward(self, images):
        cfg = self.cfg
        dt = torch_dtype(self.bcfg)
        B = images.shape[0]
        x = self.patch_embed(images.to(dt)).reshape(B, -1, cfg.d_model)
        if cfg.pool == "cls":
            x = torch.cat([self.cls_token.expand(B, 1, cfg.d_model).to(dt),
                           x], dim=1)
        x = x + self.pos_embed.to(dt)
        remat = cfg.remat and torch.is_grad_enabled()
        for name in self.layer_names:
            block = getattr(self, name)
            x = (checkpoint(block, x, use_reentrant=False) if remat
                 else block(x))
        x = self.ln_f(x)
        pooled = x[:, 0] if cfg.pool == "cls" else x.mean(1)
        return self.head(pooled.float())


def ViTTiny(num_classes=10, image_size=32, patch_size=4, **kw):
    """CIFAR-scale ViT for tests and examples."""
    return ViT(ViTConfig(image_size=image_size, patch_size=patch_size,
                         num_classes=num_classes, d_model=192, n_heads=3,
                         n_layers=4, d_ff=768, **kw))


def ViTBase(num_classes=1000, **kw):
    """ViT-B/16 (86M parameters)."""
    return ViT(ViTConfig(num_classes=num_classes, **kw))
