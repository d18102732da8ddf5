"""Models of the port: the decoder LM (``transformer``, with MoE
layers), its paged slot decoding (``decode``) and pipeline stages
(``pipelined``), and the zoo (``mlp``, ``linear``, ``cnn``, ``resnet``,
``unet``, ``deeplab``, ``vit``, ``bert``, on ``common``).
:func:`get_model` builds a registry name, as the JAX package's does."""

_REGISTRY = {
    "mnist_mlp": ("tensorflowonspark_tpu_torch.models.mlp", "MnistMLP"),
    "mnist_cnn": ("tensorflowonspark_tpu_torch.models.cnn", "MnistCNN"),
    "resnet": ("tensorflowonspark_tpu_torch.models.resnet", "ResNet"),
    "unet": ("tensorflowonspark_tpu_torch.models.unet", "UNet"),
    "deeplabv3": ("tensorflowonspark_tpu_torch.models.deeplab",
                  "DeepLabV3"),
    "transformer": ("tensorflowonspark_tpu_torch.models.transformer",
                    "Transformer"),
    "bert": ("tensorflowonspark_tpu_torch.models.bert",
             "BertForPreTraining"),
}


def get_model(name, device=None, **kwargs):
    """The registry's module ``name`` built with ``kwargs`` on
    ``device`` (``cuda`` unless the caller asks for the CPU;
    ``device.resolve`` raises without CUDA)."""
    import importlib

    import torch

    from tensorflowonspark_tpu_torch.device import resolve

    mod_name, cls_name = _REGISTRY[name]
    cls = getattr(importlib.import_module(mod_name), cls_name)
    with torch.device(resolve(device)):
        return cls(**kwargs)
