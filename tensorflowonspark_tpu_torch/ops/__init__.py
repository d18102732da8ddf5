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
- fused_optim : single-pass AdamW and Lion (csrc/fused_optim.cu;
  replaces ops/fused_optim.py ``_adamw_kernel`` and ``_lion_kernel``)
- quant_matmul : fused-dequant W8A16 / W4A16 matmuls
  (csrc/quant_matmul.cu; replaces ops/quant_matmul.py ``_int8_kernel``
  and ``_int4_kernel``)
- layernorm : row LayerNorm with f32 statistics (csrc/layernorm.cu;
  replaces ops/layernorm.py ``_ln_kernel``)

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  Kernels build at first use (ops/_build.py), never at import.
The flash forward and the LayerNorm are also dispatcher ops
(``tos::flash_fwd``, ``tos::layernorm``), so ``torch.export`` programs
and AOTInductor packages (``aot``) run them; tracing any other launch
raises.
The package binds its submodules (no function re-exports under the
same names), so ``ops.paged_attention`` is always the module; it
re-exports ``flash_attention_with_lse``, whose name no module takes.
"""
from tensorflowonspark_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention_with_lse)

# the kernels each main path runs: serving (serve -> models.decode) over
# a float or an int8 kv pool, quantised-weight serving adds
# "<mode>_matmul" per mode and fused_ln models "layernorm", and training
# (parallel.train -> models.transformer backward + the fused optimizer:
# "adamw" for adamw_fused, "lion" for lion_fused)
SERVING_KERNELS = ("paged_attention", "page_write", "prefill_read")
SERVING_KERNELS_INT8_KV = ("paged_attention_int8", "page_write_int8",
                           "prefill_read_int8")
TRAINING_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "adamw",
                    "lion")


def _wrappers():
    """{kernel name: its launching wrapper} of every ported kernel (or,
    where one wrapper launches two instantiations, the second one's
    ``_build.Launches``)."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.ops import fused_optim as fo
    from tensorflowonspark_tpu_torch.ops import layernorm as ln
    from tensorflowonspark_tpu_torch.ops import paged_attention as pa
    from tensorflowonspark_tpu_torch.ops import paged_prefill as pp
    from tensorflowonspark_tpu_torch.ops import quant_matmul as qm

    return {"paged_attention": pa.paged_attention,
            "page_write": pp._write_pages,
            "prefill_read": pp._read_attention,
            "paged_attention_int8": pa.INT8_LAUNCHES,
            "page_write_int8": pp._write_pages_int8,
            "prefill_read_int8": pp.READ_INT8_LAUNCHES,
            "flash_fwd": fa.flash_fwd,
            "flash_bwd_dq": fa.flash_bwd_dq,
            "flash_bwd_dkv": fa.flash_bwd_dkv,
            "adamw": fo._adamw,
            "lion": fo._lion,
            "int8_matmul": qm._int8_matmul,
            "int4_matmul": qm._int4_matmul,
            "layernorm": ln._layernorm}


def launch_counts(names=None):
    """{kernel: launches} of every ported kernel's wrapper, or of the
    kernels in ``names``."""
    return {name: fn.launches for name, fn in _wrappers().items()
            if names is None or name in names}


def reset_launch_counts():
    """Set every wrapper's launch count to 0."""
    for fn in _wrappers().values():
        fn.launches = 0
