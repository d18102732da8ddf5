"""DeepLabV3 semantic segmentation — counterpart of
``tensorflowonspark_tpu/models/deeplab.py``: the ResNet backbone at
``output_stride=16`` with ``features_only`` (every ResNet ``norm`` /
``stem`` option reaches it), ``ASPP``, a 1x1 f32 ``classifier``, then a
bilinear resize back to the input size (``jax.image.resize(...,
"bilinear")``: half-pixel centres, edges clamped, which is
``F.interpolate(mode="bilinear", align_corners=False)`` when it
upsamples).  NHWC in, f32 logits ``[B, H, W, num_classes]`` out."""
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_tpu_torch.models.common import (ChannelGroupNorm,
                                                       Conv, _dtype,
                                                       init_zoo_)
from tensorflowonspark_tpu_torch.models.resnet import ResNet


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling over ``[B, H, W, C]``: a 1x1 branch,
    a dilated 3x3 branch per rate, each group-normed and relu'd, and the
    image-level pooled branch (a biased 1x1 conv and relu, no norm: over
    a 1x1 map group norm would zero it), concatenated and projected."""

    def __init__(self, in_features, features=256, rates=(6, 12, 18),
                 dtype="bfloat16"):
        super().__init__()
        self.dtype = _dtype(dtype)
        self.rates = tuple(rates)
        self.features = features
        self.branch_1x1 = Conv(in_features, features, (1, 1),
                               use_bias=False, dtype=dtype)
        self.norm_1x1 = ChannelGroupNorm(features)
        for r in self.rates:
            self.add_module(f"branch_rate{r}", Conv(
                in_features, features, (3, 3), use_bias=False, dtype=dtype,
                kernel_dilation=(r, r)))
            self.add_module(f"norm_rate{r}", ChannelGroupNorm(features))
        self.branch_pool = Conv(in_features, features, (1, 1),
                                use_bias=True, dtype=dtype)
        self.project = Conv(features * (len(self.rates) + 2), features,
                            (1, 1), use_bias=False, dtype=dtype)
        self.norm_project = ChannelGroupNorm(features)

    def forward(self, x):
        branches = [torch.relu(self.norm_1x1(self.branch_1x1(x)))]
        for r in self.rates:
            conv = getattr(self, f"branch_rate{r}")
            branches.append(torch.relu(getattr(self, f"norm_rate{r}")(
                conv(x))))
        pooled = torch.relu(self.branch_pool(x.mean((1, 2), keepdim=True)))
        pooled = pooled.to(self.dtype).expand(
            *x.shape[:3], self.features)
        # jnp.concatenate promotes the pooled branch to the others' f32
        branches.append(pooled.to(branches[0].dtype))
        y = self.project(torch.cat(branches, dim=-1))
        return torch.relu(self.norm_project(y))


class DeepLabV3(nn.Module):
    """Dilated-ResNet backbone -> ASPP -> classifier -> bilinear upsample
    to the input resolution."""

    def __init__(self, num_classes=21, stage_sizes=(3, 4, 6, 3),
                 num_filters=64, aspp_features=256, norm="group",
                 stem="conv", dtype="bfloat16", in_channels=3):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = ResNet(
            stage_sizes=tuple(stage_sizes), num_filters=num_filters,
            bottleneck=True, norm=norm, stem=stem, dtype=dtype,
            output_stride=16, features_only=True, in_channels=in_channels)
        self.aspp = ASPP(self.backbone.out_channels, aspp_features,
                         dtype=dtype)
        self.classifier = Conv(aspp_features, num_classes, (1, 1),
                               dtype=torch.float32)
        init_zoo_(self.aspp)
        init_zoo_(self.classifier)

    def forward(self, x, train=False):
        H, W = x.shape[1], x.shape[2]
        x = self.aspp(self.backbone(x, train))
        logits = self.classifier(x).float()
        up = F.interpolate(logits.permute(0, 3, 1, 2), size=(H, W),
                           mode="bilinear", align_corners=False)
        return up.permute(0, 2, 3, 1)
