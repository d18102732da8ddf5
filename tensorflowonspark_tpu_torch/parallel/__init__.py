"""Parallelism and the train-step harness — counterpart of
``tensorflowonspark_tpu/parallel``.

- ``parallel.mesh``: ``MeshSpec``, meshes of ranks (one GPU each) with a
  process group per axis, batch placement (``put_batch``);
- ``parallel.sharding``: the JAX package's rules, over flax paths, and
  ``shard_params`` / ``gather_params``;
- ``parallel.collectives``: the sharded step's coalesced collectives and
  the split forward's autograd-aware ones (Megatron's conjugate pair,
  the sequence gathers and scatters, all-to-all, the neighbour
  exchange);
- ``parallel.ring_attention`` / ``parallel.ulysses``: context-parallel
  attention over a sequence split;
- ``parallel.pipeline``: the GPipe schedule over the pp axis;
- ``parallel.train``: the train step on one card or over a mesh (dp,
  fsdp, tp, sp, cp, pp), and ``feed_consensus``, the stop vote across
  the ranks.
"""
from tensorflowonspark_tpu_torch.parallel import (collectives, mesh,  # noqa: F401
                                                  pipeline, ring_attention,
                                                  sharding, train, ulysses)
