"""Linear regression and a relu MLP — counterpart of
``tensorflowonspark_tpu/models/linear.py``.  flax infers the input
width; a PyTorch layer is built with it (``in_features``)."""
import torch
from torch import nn

from tensorflowonspark_tpu_torch.models.common import init_zoo_
from tensorflowonspark_tpu_torch.models.transformer import Dense


class Linear(nn.Module):
    """One f32 Dense ``dense``; ``features == 1`` drops the last dim."""

    def __init__(self, features=1, in_features=1):
        super().__init__()
        self.features = features
        self.dense = Dense(in_features, features, True, torch.float32)
        init_zoo_(self)

    def forward(self, x):
        y = self.dense(x.float())
        return y[..., 0] if self.features == 1 else y


class MLP(nn.Module):
    """Relu MLP; ``features`` are the per-layer widths (``dense_<i>``),
    no relu after the last."""

    def __init__(self, features=(128, 128), in_features=128):
        super().__init__()
        self.n = len(features)
        widths = (in_features,) + tuple(features)
        for i in range(self.n):
            self.add_module(f"dense_{i}", Dense(widths[i], widths[i + 1],
                                                True, torch.float32))
        init_zoo_(self)

    def forward(self, x):
        x = x.float()
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n - 1:
                x = torch.relu(x)
        return x
