"""Parallelism and the train-step harness — counterpart of
``tensorflowonspark_tpu/parallel``.

This slice ports the single-card train step (``parallel.train``).
Meshes, sharding rules and the multi-process collectives wait for the
cluster runtime (ROADMAP: cluster runtime) and multi-GPU sharding.
"""
