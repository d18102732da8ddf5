"""MNIST MLP — counterpart of ``tensorflowonspark_tpu/models/mlp.py``:
``fc1`` (``hidden``) -> relu -> ``logits``, in f32, over the flattened
input (``in_features`` = 784 for 28 x 28 images; flax infers it, a
PyTorch layer is built with it)."""
import torch
from torch import nn

from tensorflowonspark_tpu_torch.models.common import init_zoo_
from tensorflowonspark_tpu_torch.models.transformer import Dense


class MnistMLP(nn.Module):
    def __init__(self, hidden=512, num_classes=10, in_features=784):
        super().__init__()
        self.fc1 = Dense(in_features, hidden, True, torch.float32)
        self.logits = Dense(hidden, num_classes, True, torch.float32)
        init_zoo_(self)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).float()
        return self.logits(torch.relu(self.fc1(x)))


def cross_entropy_loss(logits, labels):
    """Mean softmax cross entropy; ``labels`` are int class ids over the
    leading dims of ``logits`` (optax's
    ``softmax_cross_entropy_with_integer_labels``, then the mean)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0].mean()
