"""MNIST CNN — counterpart of ``tensorflowonspark_tpu/models/cnn.py``:
two 3 x 3 SAME conv blocks (``conv1`` 32, ``conv2`` 64, each relu and a
2 x 2 VALID max-pool), dropout 0.5, then ``logits``; f32, NHWC input
(a flat 784 row is read as one 28 x 28 x 1 image)."""
import torch
from torch import nn

from tensorflowonspark_tpu_torch.models.common import (Conv, init_zoo_,
                                                       max_pool)
from tensorflowonspark_tpu_torch.models.transformer import Dense


def dropout(x, rate, generator=None):
    """flax ``nn.Dropout``: keep each element with probability ``1 -
    rate`` and scale it by ``1 / (1 - rate)``; the mask drawn from
    ``generator`` (torch's bits, not JAX's)."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class MnistCNN(nn.Module):
    def __init__(self, num_classes=10, image_size=28, in_channels=1):
        super().__init__()
        self.conv1 = Conv(in_channels, 32, (3, 3))
        self.conv2 = Conv(32, 64, (3, 3))
        flat = 64 * (image_size // 4) ** 2
        self.logits = Dense(flat, num_classes, True, torch.float32)
        init_zoo_(self)

    def forward(self, x, train=False, generator=None):
        """``train=True`` applies the dropout, its mask drawn from
        ``generator``."""
        if x.dim() == 2:        # flat 784 rows from an RDD feed
            x = x.reshape(-1, 28, 28, 1)
        x = x.float()
        x = max_pool(torch.relu(self.conv1(x)), (2, 2), (2, 2))
        x = max_pool(torch.relu(self.conv2(x)), (2, 2), (2, 2))
        x = x.reshape(x.shape[0], -1)
        if train:
            x = dropout(x, 0.5, generator)
        return self.logits(x)
