"""tensorflowonspark_tpu_torch — the PyTorch / CUDA port of
tensorflowonspark_tpu, slice by slice.

This slice serves a decoder LM through paged continuous batching on an
NVIDIA H100: ``serve`` (HTTP :generate over ``ContinuousBatcher``),
``models.decode`` (paged slot cache, prefill and decode steps),
``models.transformer`` and the hand-written CUDA kernels in ``ops`` /
``csrc``.  Module names follow the JAX package, so each module's
counterpart is easy to find.  The port imports ``torch``, numpy and the
standard library only — never ``jax`` and nothing of the JAX package.

Submodules import lazily, keeping ``import tensorflowonspark_tpu_torch``
cheap.
"""
__version__ = "0.1.0"

_LAZY_SUBMODULES = {
    "benchmarks", "convert", "device", "export", "metrics", "models", "ops",
    "serve",
}


def __getattr__(name):
    import importlib
    try:
        if name in _LAZY_SUBMODULES:
            return importlib.import_module(f"tensorflowonspark_tpu_torch.{name}")
    except ModuleNotFoundError as e:
        # hasattr()/feature detection must see AttributeError, not an
        # import error escaping through the lazy loader
        raise AttributeError(f"lazy import of {name!r} failed: {e}") from e
    raise AttributeError(
        f"module 'tensorflowonspark_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | _LAZY_SUBMODULES)
