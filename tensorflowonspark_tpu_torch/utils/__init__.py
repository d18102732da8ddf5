"""Auxiliary subsystems of the port: checkpointing (``checkpoint``) and
TensorBoard scalar summaries (``summary``)."""
