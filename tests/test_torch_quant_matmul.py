"""Kernels 9 and 10's plain versions against the JAX package's
``quant_matmul`` (the Pallas kernels in interpret mode) and its
``quant_matmul_reference``, on the CPU.

The same numpy activations and f32 kernels go to both packages, each
quantises them (the bytes are identical, test_torch_quantize.py), and the
products must agree.  Tolerances, relative to the largest |output|: f32
1e-5 (f32 accumulation on both sides, in another order); bf16 1e-2 (the
same bf16 operands and f32 sums, each side rounds its output to bf16
once: at most one bf16 step apart).  Against ``quant_matmul_reference``
in f32 the plain versions agree to 1e-6.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorflowonspark_tpu import quantize as jq
from tensorflowonspark_tpu_torch import ops, quantize
from tensorflowonspark_tpu_torch.ops import quant_matmul as port_qm

jax_qm = importlib.import_module("tensorflowonspark_tpu.ops.quant_matmul")

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(M, K, N, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(M, K).astype(np.float32),
            (rs.randn(K, N) * 0.3).astype(np.float32))


def _leaves(w, mode, G):
    if mode == "int8":
        return (jq.quantize_tree({"kernel": w}, min_elements=0)["kernel"],
                quantize.quantize_int8(torch.from_numpy(w)))
    return jq.int4_pack(w, G), quantize.int4_pack(torch.from_numpy(w), G)


def _close(got, want, dtype, tol=None):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    denom = float(np.max(np.abs(w))) + 1e-6
    assert float(np.max(np.abs(g - w))) / denom <= (tol or TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,M,K,N,G", [
    ("int8", 5, 200, 130, 0), ("int8", 1, 64, 256, 0),
    ("int4", 7, 200, 130, 128), ("int4", 3, 256, 96, 64),
    ("int4", 9, 64, 192, 8)])
def test_plain_matches_jax_kernel(mode, M, K, N, G, dtype):
    x, w = _inputs(M, K, N, seed=M * 31 + K + N)
    jleaf, pleaf = _leaves(w, mode, G)
    jx = jnp.asarray(x, dtype)
    px = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jax_qm.quant_matmul(jx, jleaf, interpret=True)
    got = port_qm.quant_matmul(px, pleaf)
    assert got.dtype == px.dtype
    _close(got, want, dtype)
    # the named plain version is what the CPU tensor took
    plain = (port_qm.int8_matmul_plain if mode == "int8"
             else port_qm.int4_matmul_plain)
    assert torch.equal(plain(px, pleaf), got)
    _close(got, jax_qm.quant_matmul_reference(jx, jleaf), dtype,
           tol=1e-6 if dtype == "float32" else None)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_batched_leading_dims(mode):
    x, w = _inputs(6, 128, 64, seed=4)
    jleaf, pleaf = _leaves(w, mode, 128)
    x3 = torch.from_numpy(x).reshape(2, 3, 128)
    got = port_qm.quant_matmul(x3, pleaf)
    assert got.shape == (2, 3, 64)
    flat = port_qm.quant_matmul(torch.from_numpy(x), pleaf)
    assert torch.equal(got.reshape(6, 64), flat)
    want = jax_qm.quant_matmul(jnp.asarray(x).reshape(2, 3, 128), jleaf,
                               interpret=True)
    _close(got.reshape(6, 64), np.asarray(want).reshape(6, 64), "float32")


def test_cpu_tensors_count_no_launch():
    x, w = _inputs(2, 64, 32, seed=9)
    before = ops.launch_counts(("int8_matmul", "int4_matmul"))
    for mode in ("int8", "int4"):
        port_qm.quant_matmul(torch.from_numpy(x), _leaves(w, mode, 64)[1])
    assert ops.launch_counts(("int8_matmul", "int4_matmul")) == before


def test_integer_activation_raises():
    leaf = quantize.quantize_int8(torch.ones(128, 128))
    with pytest.raises(ValueError, match="floating"):
        port_qm.quant_matmul(torch.ones(4, 128, dtype=torch.int32), leaf)


def test_k_mismatch_raises():
    leaf = quantize.quantize_int8(torch.ones(128, 128))
    with pytest.raises(ValueError, match="in_dim"):
        port_qm.quant_matmul(torch.ones(4, 64), leaf)
    leaf4 = quantize.int4_pack(torch.ones(100, 16), 64)
    with pytest.raises(ValueError, match="in_dim"):
        port_qm.quant_matmul(torch.ones(4, 128), leaf4)


def test_non_quantized_weight_raises():
    with pytest.raises(TypeError, match="Int4Weight"):
        port_qm.quant_matmul(torch.ones(4, 128), torch.ones(128, 128))
    with pytest.raises(TypeError, match="Int4Weight"):
        port_qm.quant_matmul(torch.ones(4, 128),
                             {"q": torch.ones(128, 128),
                              "scale": torch.ones(1, 128)})


def test_untileable_int4_group_raises():
    # half-group 48 neither divides the 128-lane tile nor is a multiple
    # of it: the JAX package refuses it, and so does the port
    leaf = quantize.int4_pack(torch.ones(192, 128), 96)
    with pytest.raises(ValueError, match="does not tile"):
        port_qm.quant_matmul(torch.ones(4, 192), leaf)


def test_launch_plan_fills_the_card():
    # the flagship wi shape on a 132-SM H100: decode runs 8 chunks of 8
    # steps in their own blocks (64 output tiles); prefill walks the same
    # chunks in one block (1024 tiles)
    assert port_qm.launch_plan(16, 2048, 8192, 132) == (16, 8, 8)
    assert port_qm.launch_plan(1024, 2048, 8192, 132) == (64, 8, 1)
    assert port_qm.launch_plan(8, 2048, 32000, 132) == (16, 22, 3)
    # tiny K: one chunk below four 32-row steps
    assert port_qm.launch_plan(1, 100, 64, 132) == (16, 4, 1)
    for K, N in ((200, 1000), (2048, 2048), (8192, 2048), (2048, 32000)):
        plans = [port_qm.launch_plan(M, K, N, 132) for M in (1, 7, 17, 1024)]
        # the chunking (hence every row's sum order) does not depend on M
        assert len({per for _, per, _ in plans}) == 1
        steps = -(-K // 32)
        for _, per, splits in plans:
            assert splits in (1, -(-steps // per))
            assert (-(-steps // per) - 1) * per < steps    # no empty chunk
