"""Parallelism and the train-step harness — counterpart of
``tensorflowonspark_tpu/parallel``.

- ``parallel.mesh``: ``MeshSpec``, meshes of ranks (one GPU each) with a
  process group per axis, batch placement (``put_batch``);
- ``parallel.sharding``: the JAX package's rules, over flax paths, and
  ``shard_params`` / ``gather_params``;
- ``parallel.collectives``: the sharded step's coalesced collectives;
- ``parallel.train``: the train step on one card or over a dp / fsdp
  mesh, and ``feed_consensus``, the stop vote across the ranks.

Meshes with tp or pp above 1, context parallelism and pipelines wait for
multi-GPU sharding A3b (ROADMAP).
"""
from tensorflowonspark_tpu_torch.parallel import (collectives, mesh,  # noqa: F401
                                                  sharding, train)
