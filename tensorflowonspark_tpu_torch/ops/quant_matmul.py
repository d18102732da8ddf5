"""Fused-dequant weight matmuls, W8A16 and W4A16 (kernels 9 and 10).

Counterpart of ``tensorflowonspark_tpu/ops/quant_matmul.py``.  The
weight arrives in its quantised storage form (``quantize.py``): an int8
``{"q": [K, N], "scale": [1, N]}`` dict, or a nibble-packed
:class:`~tensorflowonspark_tpu_torch.quantize.Int4Weight` with
per-group scales.  ``csrc/quant_matmul.cu`` dequantises weight tiles in
shared memory, so the dense weight never exists in device memory; it
accumulates in f32 and writes x's dtype.  bf16 activations run on the
tensor cores (``mma.sync``, the weight tile dequantised to bf16), f32
activations on the CUDA cores (the weight tile dequantised to f32).

One rule per call: a CPU tensor takes the plain version
(:func:`int8_matmul_plain` / :func:`int4_matmul_plain`, exactly the JAX
package's ``quant_matmul_reference``); a CUDA tensor launches the kernel
or raises.  The JAX function's ``block_m`` / ``block_n`` / ``block_k``
and ``interpret`` are TPU grid and interpreter knobs and are not in the
signature; the launch shape follows from M, K, N and the card
(:func:`launch_plan`).
"""
import functools

import torch

from tensorflowonspark_tpu_torch import quantize

from . import _build

_LANE = 128          # the TPU lane width the JAX int4 k-tile is cut to
_BK = 32             # K rows per step of the CUDA kernel
_BN = 128            # output columns per block
_MAX_GRID_Y = 65535


def _check_group(group_size):
    """The JAX package's rule for an int4 group it can tile: half a group
    divides the 128-wide lane tile or is a multiple of it."""
    gh = group_size // 2
    if not (_LANE % gh == 0 or gh % _LANE == 0):
        raise ValueError(
            f"group_size {group_size} does not tile the {_LANE}-wide lane "
            f"grid: half-group {gh} must divide {_LANE} or be a multiple of "
            "it")


def quant_matmul_plain(x, w):
    """Plain version of kernels 9 and 10: dequantise in f32, cast to x's
    dtype, matmul with f32 accumulation, cast back
    (``quant_matmul_reference``)."""
    wf = quantize.dequantize_leaf(w).to(x.dtype)
    return torch.matmul(x.float(), wf.float()).to(x.dtype)


# one body serves both: dequantize_leaf tells int8 from int4
int8_matmul_plain = int4_matmul_plain = quant_matmul_plain


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_plan(M, K, N, n_sm):
    """``(block_m, tiles_per_chunk, splits)`` of one launch.

    K sums in fixed chunks of ``tiles_per_chunk`` 32-row steps, chosen
    from K, N and the card alone (enough chunks that one block per chunk
    and 128-column tile puts about four blocks on each SM, at least four
    steps per chunk), so a row's sum does not depend on M.  16-row tiles
    serve decode-sized M (up to 16 rows), 64-row tiles above.  When the
    output tiles number fewer than two per SM, each chunk runs in its own
    block (``splits`` = the chunk count, partials summed in a second
    pass); otherwise one block walks every chunk (``splits`` 1)."""
    block_m = 16 if M <= 16 else 64
    tiles_n = -(-N // _BN)
    k_steps = max(1, -(-K // _BK))
    chunks = max(1, min(-(-4 * n_sm // tiles_n), k_steps // 4))
    per = -(-k_steps // chunks)
    chunks = -(-k_steps // per)
    tiles = tiles_n * -(-M // block_m)
    return block_m, per, chunks if tiles < 2 * n_sm else 1


def _launch(x2, q, scale, K, N, group, int4, name):
    """Run ``csrc/quant_matmul.cu`` on the card: ``x2 [M, K]`` in f32 or
    bf16 -> ``[M, N]`` in x's dtype.  ``vec`` tells the kernel which rows
    take 16-byte copies: bit 0 the weight's and scales' (N % 4 == 0,
    16-byte aligned bases), bit 1 x's (K % 8 == 0, a 16-byte aligned
    base); the others take predicated loads in the same kernel."""
    if x2.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {x2.device}")
    for label, t in (("q", q), ("scale", scale)):
        if t.device != x2.device:
            raise ValueError(f"{label} is on {t.device}, the activations on "
                             f"{x2.device}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{name}: q must be int8 and scale f32, got "
                        f"{q.dtype} / {scale.dtype}")
    # a copy of the weight per call would cost more than the matmul
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name}: q and scale must be contiguous")
    M = x2.shape[0]
    x2 = x2.contiguous()
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    if M == 0:
        return out
    block_m, per, splits = launch_plan(M, K, N,
                                       _sm_count(x2.device.index or 0))
    if -(-M // block_m) > _MAX_GRID_Y:
        raise ValueError(f"{name}: {M} rows exceed one launch's grid")
    partial = (torch.empty((splits, M, N), dtype=torch.float32,
                           device=x2.device) if splits > 1 else None)
    vec = (int(N % 4 == 0 and q.data_ptr() % 16 == 0
               and scale.data_ptr() % 16 == 0)
           | int(K % 8 == 0 and x2.data_ptr() % 16 == 0) << 1)
    _build.launch("tos_quant_matmul", x2.device,
        _build.ptr(x2), _build.ptr(q), _build.ptr(scale), _build.ptr(out),
        None if partial is None else _build.ptr(partial), M, K, N,
        q.shape[0], group, int(int4), block_m, per, splits, vec,
        _build.dtype_code(x2))
    return out


def _int8_matmul(x2, w):
    """Kernel 9 on ``x2 [M, K]`` and an int8 leaf.  CPU tensors take
    :func:`int8_matmul_plain`."""
    if x2.device.type == "cpu":
        return int8_matmul_plain(x2, w)
    K, N = w["q"].shape
    out = _launch(x2, w["q"], w["scale"], K, N, 1, False, "int8_matmul")
    _int8_matmul.launches += 1
    return out


def _int4_matmul(x2, w):
    """Kernel 10 on ``x2 [M, K]`` and an ``Int4Weight``.  CPU tensors take
    :func:`int4_matmul_plain`."""
    if x2.device.type == "cpu":
        return int4_matmul_plain(x2, w)
    n_groups = -(-w.in_dim // w.group_size)
    if (w.q.shape[0] != n_groups * w.group_size // 2
            or w.scale.shape[0] != n_groups):
        raise ValueError(f"{w!r}: q {tuple(w.q.shape)} / scale "
                         f"{tuple(w.scale.shape)} do not match its groups")
    out = _launch(x2, w.q, w.scale, w.in_dim, w.out_dim, w.group_size, True,
                  "int4_matmul")
    _int4_matmul.launches += 1
    return out


_int8_matmul.launches = 0
_int4_matmul.launches = 0


def quant_matmul(x, w):
    """``x @ dequant(w)`` with the dequantisation fused into the weight
    read.

    Args:
      x: ``[..., K]`` floating activations (any leading batch shape).
      w: an int8 ``{"q": [K, N] int8, "scale": [1, N] f32}`` dict or an
        ``Int4Weight``.

    Returns ``[..., N]`` in x's dtype (f32-accumulated).
    """
    if not x.is_floating_point():
        raise ValueError(f"activations must be floating, got {x.dtype}")
    if isinstance(w, quantize.Int4Weight):
        _check_group(w.group_size)
        K, N = w.in_dim, w.out_dim
    elif quantize.is_int8_leaf(w):
        if w["q"].ndim != 2:
            raise ValueError(f"quant_matmul needs a 2-D [in, out] kernel, "
                             f"got {tuple(w['q'].shape)}")
        K, N = w["q"].shape
    else:
        raise TypeError(f"w must be an int8 quantized-leaf dict or "
                        f"Int4Weight, got {type(w)!r}")
    *batch, Kx = x.shape
    if Kx != K:
        raise ValueError(f"activation K {Kx} != weight in_dim {K}")
    x2 = x.reshape(-1, K)
    if isinstance(w, quantize.Int4Weight):
        out = _int4_matmul(x2, w)
    else:
        out = _int8_matmul(x2, w)
    return out.reshape(*batch, N)
