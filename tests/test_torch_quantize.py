"""The port's weight quantisation against the JAX package's, on the CPU.

Bytes must be identical: int8 ``q`` / ``scale`` from ``quantize_tree``
and int4 packed bytes / group scales from ``int4_pack`` (including K that
is not a multiple of the group), the same leaves selected from a tiny
LM, and ``qparams_from_jax`` / ``qparams_to_jax`` carrying a quantised
tree across unchanged.  The quantised forward of the tiny LM matches the
JAX package's to 1e-5 (f32 on both sides; the matmuls sum in another
order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import quantize as jq
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import convert, quantize
from tensorflowonspark_tpu_torch.models import transformer as port_tf

CFG = dict(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=128, max_seq_len=32, dtype="float32", rope=True,
           norm_type="rmsnorm", use_bias=True)


def _bits(a):
    """Float arrays as their raw 32-bit patterns, so equality is bytes."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same_bytes(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("K,N", [(64, 64), (200, 130), (1, 7)])
def test_int8_bytes_match_jax(K, N):
    rs = np.random.RandomState(K + N)
    w = (rs.randn(K, N) * rs.rand(1, N) * 3).astype(np.float32)
    w[:, 0] = 0.0                          # an all-zero channel: 1e-12 floor
    want = jq.quantize_tree({"kernel": w}, min_elements=0)["kernel"]
    got = quantize.quantize_int8(torch.from_numpy(w))
    _assert_same_bytes(got["q"].numpy(), want["q"])
    _assert_same_bytes(got["scale"].numpy(), want["scale"])
    _assert_same_bytes(quantize.dequantize_leaf(got).numpy(),
                       jq.dequantize_leaf(want))


@pytest.mark.parametrize("K,N,G", [(256, 64, 128), (200, 130, 128),
                                   (200, 33, 64), (64, 16, 8), (7, 5, 4)])
def test_int4_bytes_match_jax(K, N, G):
    rs = np.random.RandomState(K * 7 + N + G)
    w = (rs.randn(K, N) * 0.5).astype(np.float32)
    w[3 % K] *= 40.0                       # one outlier row per group set
    want = jq.int4_pack(w, G)
    got = quantize.int4_pack(torch.from_numpy(w), G)
    assert (got.in_dim, got.group_size, got.out_dim) == (
        want.in_dim, want.group_size, want.out_dim)
    _assert_same_bytes(got.q.numpy(), want.q)
    _assert_same_bytes(got.scale.numpy(), want.scale)
    _assert_same_bytes(quantize.int4_unpack(got).numpy(),
                       jq.int4_unpack(want))


def test_int4_pack_rejects_odd_groups_and_non_2d():
    with pytest.raises(ValueError, match="even"):
        quantize.int4_pack(torch.ones(8, 8), 3)
    with pytest.raises(ValueError, match="2-D"):
        quantize.int4_pack(torch.ones(2, 8, 8), 8)
    with pytest.raises(ValueError, match="2-D"):
        quantize.quantize_int8(torch.ones(8))


@pytest.fixture(scope="module")
def tiny():
    """(JAX module, JAX f32 params as numpy, port model with the same
    weights)."""
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**CFG))
    params = jm.init(jax.random.key(3), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    pm = port_tf.build_transformer(**CFG)
    pm.load_state_dict(convert.params_from_jax(params), strict=True)
    return jm, params, pm.eval()


def _quantized_port(tiny, mode):
    jm, params, pm = tiny
    qm = port_tf.build_transformer(**CFG).eval()
    qm.load_state_dict(pm.state_dict())
    quantize.quantize_module(qm, mode)
    return qm


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_module_matches_quantize_tree(tiny, mode):
    jm, params, pm = tiny
    qtree = jq.quantize_tree(params, mode=mode)
    qm = _quantized_port(tiny, mode)
    # the same leaves selected: kernels >= 4096 elements, lm_head too;
    # key/value (64 x 32), embeddings, norms and biases stay float
    got = qm.state_dict()
    want = convert.qparams_from_jax(qtree)
    assert set(got) == set(want)
    assert "lm_head.q" in got and "layer_0.attn.key.weight" in got
    assert "token_embed.weight" in got and "layer_0.mlp.wi.bias" in got
    for name, t in got.items():
        _assert_same_bytes(t.numpy(), want[name].numpy())
    assert quantize.quantized_bytes(qm) == jq.quantized_bytes(qtree)
    assert quantize.quantized_modes(qm) == (mode,)
    assert quantize.max_abs_error(pm, qm) == pytest.approx(
        jq.max_abs_error(params, qtree), rel=0, abs=1e-7)


def _jax_int4(tree):
    """The port's tree with its Int4Weight leaves rebuilt as the JAX
    package's Int4Weight (the same four fields)."""
    if isinstance(tree, quantize.Int4Weight):
        return jq.Int4Weight(tree.q, tree.scale, tree.in_dim,
                             tree.group_size)
    if isinstance(tree, dict):
        return {k: _jax_int4(v) for k, v in tree.items()}
    return tree


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_qparams_roundtrip(tiny, mode):
    jm, params, pm = tiny
    qtree = jq.quantize_tree(params, mode=mode)
    qm = _quantized_port(tiny, mode)
    back = _jax_int4(convert.qparams_to_jax(qm))
    got = jax.tree_util.tree_leaves_with_path(back)
    want = jax.tree_util.tree_leaves_with_path(qtree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        _assert_same_bytes(g, w)
    # and back into the port: the same state, byte for byte
    state = convert.qparams_from_jax(back)
    assert set(state) == set(qm.state_dict())
    for name, t in qm.state_dict().items():
        _assert_same_bytes(state[name].numpy(), t.numpy())


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_forward_matches_jax(tiny, mode):
    """The port's quantised Dense path (loaded through qparams_from_jax)
    against the JAX QuantDense path on the same quantised tree."""
    jm, params, pm = tiny
    qtree = jq.quantize_tree(params, mode=mode)
    tokens = np.random.RandomState(5).randint(0, CFG["vocab_size"], (2, 11))
    want = np.asarray(jm.apply({"params": qtree}, jnp.asarray(tokens)))
    qm = _quantized_port(tiny, mode)
    qm.load_state_dict(convert.qparams_from_jax(qtree), strict=True)
    with torch.no_grad():
        got = qm(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_cast_float_leaves_keeps_scales_f32(tiny):
    qm = _quantized_port(tiny, "int4")
    quantize.cast_float_leaves(qm, torch.bfloat16)
    for name, t in qm.state_dict().items():
        if name.endswith(".q"):
            assert t.dtype == torch.int8, name
        elif name.endswith(".scale"):
            assert t.dtype == torch.float32, name
        else:
            assert t.dtype == torch.bfloat16, name


def test_quantize_module_rejects_bad_input(tiny):
    with pytest.raises(ValueError, match="mode"):
        quantize.quantize_module(port_tf.build_transformer(**CFG), "int2")
    with pytest.raises(ValueError, match="no Dense"):
        quantize.quantize_module(port_tf.build_transformer(**CFG), "int8",
                                 min_elements=1 << 30)
    with pytest.raises(TypeError, match="not a quantized leaf"):
        quantize.dequantize_leaf(torch.ones(2, 2))
    # a weight tp split (here by hand: the columns of rank 0 of 2) is not
    # quantised alone: its scales would not be the whole weight's
    split = port_tf.build_transformer(**CFG)
    wi = split.layer_0.mlp.wi
    wi.weight.data = wi.weight.data[:wi.out_features // 2].contiguous()
    with pytest.raises(ValueError, match="quantise the whole model"):
        quantize.quantize_module(split, "int8", min_elements=1)
