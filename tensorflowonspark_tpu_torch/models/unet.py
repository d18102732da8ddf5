"""UNet segmentation model — counterpart of ``tensorflowonspark_tpu/
models/unet.py``: 4x4 / s2 SAME convs down (``down<i>``: conv, group
norm, leaky relu 0.2), 4x4 / s2 transposed convs up (``up<i>``: conv,
group norm, relu) with the encoder's maps concatenated, a last
transposed conv (``up_final``, biased, relu) back to the input size and
a 1x1 ``head``.  NHWC in, per-pixel f32 logits ``[B, H, W,
num_classes]`` out."""
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_tpu_torch.models.common import (ChannelGroupNorm,
                                                       Conv, ConvTranspose,
                                                       _dtype, init_zoo_)
from tensorflowonspark_tpu_torch.models.mlp import cross_entropy_loss


class DownBlock(nn.Module):
    def __init__(self, cin, filters, dtype="bfloat16"):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, (4, 4), (2, 2), use_bias=False,
                           dtype=dtype)
        self.ChannelGroupNorm_0 = ChannelGroupNorm(filters)

    def forward(self, x):
        return F.leaky_relu(self.ChannelGroupNorm_0(self.Conv_0(x)), 0.2)


class UpBlock(nn.Module):
    def __init__(self, cin, filters, dtype="bfloat16"):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(cin, filters, (4, 4), (2, 2),
                                             use_bias=False, dtype=dtype)
        self.ChannelGroupNorm_0 = ChannelGroupNorm(filters)

    def forward(self, x):
        return torch.relu(self.ChannelGroupNorm_0(self.ConvTranspose_0(x)))


class UNet(nn.Module):
    """Encoder-decoder with skip connections over ``[B, H, W,
    in_channels]``."""

    def __init__(self, num_classes=3, features=(64, 128, 256, 512),
                 dtype="bfloat16", in_channels=3):
        super().__init__()
        self.dtype = _dtype(dtype)
        self.n = len(features)
        c = in_channels
        for i, f in enumerate(features):
            self.add_module(f"down{i}", DownBlock(c, f, dtype))
            c = f
        for i, f in enumerate(reversed(features[:-1])):
            self.add_module(f"up{i}", UpBlock(c, f, dtype))
            c = 2 * f             # the skip's channels join
        self.up_final = ConvTranspose(c, features[0] // 2, (4, 4), (2, 2),
                                      dtype=dtype)
        self.head = Conv(features[0] // 2, num_classes, (1, 1),
                         dtype=torch.float32)
        init_zoo_(self)

    def forward(self, x):
        x = x.to(self.dtype)
        skips = []
        for i in range(self.n):
            x = getattr(self, f"down{i}")(x)
            skips.append(x)
        for i in range(self.n - 1):
            x = getattr(self, f"up{i}")(x)
            x = torch.cat([x, skips[self.n - 2 - i].to(x.dtype)], dim=-1)
        x = torch.relu(self.up_final(x))
        return self.head(x).float()


def pixel_cross_entropy(logits, labels):
    """Mean per-pixel softmax cross entropy; ``labels`` are int class
    maps ``[B, H, W]``."""
    return cross_entropy_loss(logits, labels)
