"""ResNet family — counterpart of ``tensorflowonspark_tpu/models/
resnet.py``: ``ResNetBlock`` (3x3 + 3x3), ``BottleneckBlock`` (1x1 -
3x3 - 1x1), ``ResNet`` with every option of the JAX module, and the
``ResNet50`` / ``ResNet56Cifar`` builders.

- ``norm``: "group" (``ChannelGroupNorm``, the default), "batch"
  (``BatchNorm``, running statistics in the ``mean`` / ``var`` buffers,
  updated by a ``train=True`` forward) or "none" (``WSConv`` kernels and
  ``IdentityNorm``: SkipInit on the last norm of each block);
- ``stem``: "conv" (7x7 / s2, then a 3x3 / s2 SAME max-pool) or "s2d"
  (2x2 space-to-depth, then a 4x4 / s1 conv); ``small_inputs`` keeps
  the CIFAR 3x3 stem without the pool;
- ``output_stride`` 16 or 8 trades the last one or two stage strides
  for dilation 2; ``features_only`` returns the last feature map.

The last norm of every block starts with a zero scale.  Submodules
carry flax's names (``Conv_0``, ``BatchNorm_1``, ``conv_proj``, ...),
so ``convert`` maps a JAX tree by name.  A block projects its residual
where its stride or width changes (flax projects where the shapes
differ, which is the same for any feature map wider than one pixel).
NHWC in and out; the convs run in ``dtype``, the norms in f32.
"""
import torch
from torch import nn

from tensorflowonspark_tpu_torch.models.common import (
    BatchNorm, ChannelGroupNorm, Conv, IdentityNorm, WSConv, _dtype,
    init_zoo_, max_pool)
from tensorflowonspark_tpu_torch.models.transformer import Dense

_NORMS = {"batch": BatchNorm, "group": ChannelGroupNorm,
          "none": IdentityNorm}


class _Layers:
    """The conv and norm a ResNet's ``norm`` option picks, with their
    flax class names (the prefix of flax's automatic submodule names)."""

    def __init__(self, norm, dtype):
        if norm not in _NORMS:
            raise ValueError(f"norm={norm!r} not in ('group', 'batch', "
                             "'none')")
        self.norm_cls = _NORMS[norm]
        self.conv_cls = WSConv if norm == "none" else Conv
        self.norm_name = self.norm_cls.__name__
        self.conv_name = self.conv_cls.__name__
        self.dtype = dtype

    def conv(self, cin, cout, k, strides=1, dilation=1):
        kw = dict(strides=(strides, strides), padding="SAME",
                  dtype=self.dtype, kernel_dilation=(dilation, dilation))
        if self.conv_cls is Conv:
            kw["use_bias"] = False
        return self.conv_cls(cin, cout, (k, k), **kw)

    def norm(self, channels, zero_scale=False):
        return self.norm_cls(channels, zero_scale=zero_scale)


def _norm_call(norm, x, train):
    return norm(x, train) if isinstance(norm, BatchNorm) else norm(x)


class _Block(nn.Module):
    """A residual block: ``convs`` (kernel size, width multiplier,
    strided?) in order, a norm after each (the last zero-init), relu
    between, the residual projected where the stride or width changes."""

    def __init__(self, layers, cin, filters, convs, strides, dilation):
        super().__init__()
        self.n = len(convs)
        c = cin
        for i, (k, mult, strided) in enumerate(convs):
            cout = filters * mult
            self.add_module(f"{layers.conv_name}_{i}", layers.conv(
                c, cout, k, strides if strided else 1, dilation))
            self.add_module(f"{layers.norm_name}_{i}", layers.norm(
                cout, zero_scale=i == self.n - 1))
            c = cout
        self.conv_names = [f"{layers.conv_name}_{i}" for i in range(self.n)]
        self.norm_names = [f"{layers.norm_name}_{i}" for i in range(self.n)]
        self.project = strides != 1 or cin != c
        if self.project:
            self.conv_proj = layers.conv(cin, c, 1, strides, dilation)
            self.norm_proj = layers.norm(c)

    def forward(self, x, train=False):
        residual = x
        y = x
        for i, (cn, nn_) in enumerate(zip(self.conv_names, self.norm_names)):
            y = _norm_call(getattr(self, nn_), getattr(self, cn)(y), train)
            if i < self.n - 1:
                y = torch.relu(y)
        if self.project:
            residual = _norm_call(self.norm_proj, self.conv_proj(residual),
                                  train)
        return torch.relu(residual + y)


class ResNetBlock(_Block):
    """Basic 3x3 + 3x3 block (CIFAR / ResNet-18/34)."""

    def __init__(self, layers, cin, filters, strides=1, dilation=1):
        super().__init__(layers, cin, filters,
                         ((3, 1, True), (3, 1, False)), strides, dilation)
        self.out_channels = filters


class BottleneckBlock(_Block):
    """1x1 - 3x3 - 1x1 bottleneck block (ResNet-50/101/152)."""

    def __init__(self, layers, cin, filters, strides=1, dilation=1):
        super().__init__(layers, cin, filters,
                         ((1, 1, False), (3, 1, True), (1, 4, False)),
                         strides, dilation)
        self.out_channels = filters * 4


class ResNet(nn.Module):
    """ResNet over NHWC images ``[B, H, W, in_channels]``: class logits
    ``[B, num_classes]`` (f32), or with ``features_only`` the last
    feature map."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), num_classes=1000,
                 num_filters=64, bottleneck=True, small_inputs=False,
                 norm="group", dtype="bfloat16", stem="conv",
                 output_stride=None, features_only=False, in_channels=3):
        super().__init__()
        if stem not in ("conv", "s2d"):
            raise ValueError(f"stem={stem!r} not in ('conv', 's2d')")
        n_dilated = 0
        if output_stride is not None:
            if output_stride not in (8, 16):
                raise ValueError("output_stride must be 8, 16, or None")
            n_dilated = {16: 1, 8: 2}[output_stride]
        layers = _Layers(norm, dtype)
        self.dtype = _dtype(dtype)
        self.small_inputs = small_inputs
        self.stem = stem
        self.features_only = features_only
        if small_inputs:
            self.conv_init = layers.conv(in_channels, num_filters, 3)
        elif stem == "s2d":
            self.conv_init = layers.conv(4 * in_channels, num_filters, 4)
        else:
            self.conv_init = layers.conv(in_channels, num_filters, 7, 2)
        self.norm_init = layers.norm(num_filters)
        block_cls = BottleneckBlock if bottleneck else ResNetBlock
        self.block_names = []
        c = num_filters
        for i, block_count in enumerate(stage_sizes):
            dilated = i >= len(stage_sizes) - n_dilated
            for j in range(block_count):
                strides = 2 if (i > 0 and j == 0 and not dilated) else 1
                block = block_cls(layers, c, num_filters * 2 ** i, strides,
                                  2 if dilated else 1)
                name = f"stage{i}_block{j}"
                self.add_module(name, block)
                self.block_names.append(name)
                c = block.out_channels
        self.out_channels = c
        if not features_only:
            self.head = Dense(c, num_classes, True, torch.float32)
        init_zoo_(self)

    def forward(self, x, train=False):
        x = x.to(self.dtype)
        if self.stem == "s2d" and not self.small_inputs:
            n, h, w, c = x.shape
            x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)
        x = torch.relu(_norm_call(self.norm_init, self.conv_init(x), train))
        if not self.small_inputs:
            x = max_pool(x, (3, 3), (2, 2), padding="SAME")
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        if self.features_only:
            return x
        return self.head(x.mean((1, 2)).float())


def ResNet50(num_classes=1000, **kwargs):
    """ImageNet ResNet-50."""
    return ResNet(stage_sizes=(3, 4, 6, 3), num_classes=num_classes,
                  bottleneck=True, **kwargs)


def ResNet56Cifar(num_classes=10, **kwargs):
    """CIFAR ResNet-56: 3 stages x 9 basic blocks, 16 base filters, 3x3
    stem."""
    return ResNet(stage_sizes=(9, 9, 9), num_classes=num_classes,
                  num_filters=16, bottleneck=False, small_inputs=True,
                  **kwargs)
