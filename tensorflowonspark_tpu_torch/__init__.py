"""tensorflowonspark_tpu_torch — the PyTorch / CUDA port of
tensorflowonspark_tpu, slice by slice.

Slice 1 serves a decoder LM through paged continuous batching on an
NVIDIA H100: ``serve`` (HTTP :generate over ``ContinuousBatcher``),
``models.decode`` (paged slot cache, prefill and decode steps),
``models.transformer`` and the hand-written CUDA kernels in ``ops`` /
``csrc``.  Slice 2 trains it on one card: ``benchmarks.
make_flagship_step`` over ``parallel.train`` (the train step),
``optim`` (schedules, optimizers) and the flash-attention and fused
AdamW kernels.  Slice 6 ports the cluster runtime: ``cluster.run`` over
a ``backend`` (``LocalBackend``) turns executors into trainers, each a
``node`` process fed partitions through ``reservation``, ``manager``,
the ``shm`` ring and ``feed.DataFeed``, with ``gpu_info`` giving each
executor its GPUs and ``parallel.train.feed_consensus`` voting across
processes.  Slice 7 ports the data layer and the pipeline API:
``tfrecord`` (framing, CRC32C, the ``tf.train.Example`` codec), ``data``
(``Dataset``, the NATIVE feed), ``dfutil`` (DataFrame <-> TFRecords),
``fsio``, ``schema``, ``minispark`` (a local stand-in for pyspark),
``pipeline`` / ``pipeline_ml`` (``TFEstimator.fit``, ``TFModel.
transform``) and ``inference`` (the batch CLI).  Module names follow
the JAX package, so each module's counterpart is easy to find
(``gpu_info`` takes the place of ``tpu_info``).  The port imports
``torch``, numpy and the standard library only — never ``jax`` and
nothing of the JAX package.

Submodules import lazily, keeping ``import tensorflowonspark_tpu_torch``
cheap.
"""
__version__ = "0.1.0"

_LAZY_SUBMODULES = {
    "backend", "benchmarks", "cluster", "compat", "convert", "data",
    "device", "dfutil", "export", "faults", "feed", "fsio", "gpu_info",
    "inference", "manager", "marker", "metrics", "minispark", "models",
    "node", "ops", "optim", "parallel", "parallel_runner", "pipeline",
    "pipeline_ml", "quantize", "reservation", "schema", "serve", "shm",
    "tfrecord", "util",
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
