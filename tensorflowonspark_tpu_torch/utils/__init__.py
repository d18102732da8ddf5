"""Auxiliary subsystems of the port: checkpointing (``checkpoint``),
TensorBoard scalar summaries (``summary``) and profiling
(``profiling``: ``torch.profiler`` captures and their Chrome traces)."""
