"""The port's device rule (counterpart of the JAX package's
``ops.default_interpret``).

Entry points run on the card unless the caller asks for the CPU: with no
``device`` they take ``cuda``, and without a CUDA device they raise
instead of carrying on somewhere slower.  ``device="cpu"`` (``--device
cpu`` on the CLI) is the explicit request the tests make.
"""
import torch


def resolve(device=None):
    """The ``torch.device`` an entry point runs on: ``device`` when
    given, else ``cuda``; raises when CUDA is asked for (explicitly or
    by default) and no CUDA device exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (--device cpu) to "
            "run on the CPU explicitly")
    return dev
