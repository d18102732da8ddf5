"""Parallelism and the train-step harness — counterpart of
``tensorflowonspark_tpu/parallel``.

``parallel.train`` holds the train step of one card and
``feed_consensus``, the stop vote across the processes of a cluster
(``torch.distributed``).  Meshes and sharding rules wait for multi-GPU
sharding (ROADMAP).
"""
