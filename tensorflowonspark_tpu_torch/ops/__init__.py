"""Hand-written CUDA kernels of the port, one module per TPU kernel
family, each with its plain PyTorch version beside it.

- paged_attention : flash-decode over the paged serving kv pool
  (csrc/paged_attention.cu; replaces ops/paged_attention.py
  ``_decode_kernel`` of the JAX package)
- paged_prefill : in-place page write + chunked flash read of a prefill
  chunk (csrc/paged_prefill.cu; replaces ops/paged_prefill.py
  ``_page_write_kernel`` and ``_prefill_read_kernel``)
- flash_attention : the training attention, forward with LSE and the
  dq / narrow dk-dv backward (csrc/flash_attention.cu; replaces
  ops/flash_attention.py ``_fwd_kernel``, ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``)
- fused_optim : single-pass AdamW (csrc/fused_optim.cu; replaces
  ops/fused_optim.py ``_adamw_kernel``)

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  Kernels build at first use (ops/_build.py), never at import.
The package binds its submodules only (no function re-exports under the
same names), so ``ops.paged_attention`` is always the module.
"""

# the kernels each main path runs: serving (serve -> models.decode) and
# training (parallel.train -> models.transformer backward + optimizer)
SERVING_KERNELS = ("paged_attention", "page_write", "prefill_read")
TRAINING_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "adamw")


def _wrappers():
    """{kernel name: its launching wrapper} of every ported kernel."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.ops import fused_optim as fo
    from tensorflowonspark_tpu_torch.ops import paged_attention as pa
    from tensorflowonspark_tpu_torch.ops import paged_prefill as pp

    return {"paged_attention": pa.paged_attention,
            "page_write": pp._write_pages,
            "prefill_read": pp._read_attention,
            "flash_fwd": fa.flash_fwd,
            "flash_bwd_dq": fa.flash_bwd_dq,
            "flash_bwd_dkv": fa.flash_bwd_dkv,
            "adamw": fo._adamw}


def launch_counts(names=None):
    """{kernel: launches} of every ported kernel's wrapper, or of the
    kernels in ``names``."""
    return {name: fn.launches for name, fn in _wrappers().items()
            if names is None or name in names}


def reset_launch_counts():
    """Set every wrapper's launch count to 0."""
    for fn in _wrappers().values():
        fn.launches = 0
