"""Parity of the port's paged flash-decode attention with the JAX package.

The port's wrapper on CPU tensors runs its plain PyTorch version
(tensorflowonspark_tpu_torch/ops/paged_attention.py); it must match the
JAX Pallas kernel run in interpret mode (the real kernel body) and the
JAX gather reference on the same numpy inputs: a shuffled page table,
ragged lengths (an empty row, a row ending mid-page, a page-boundary row,
a full row), GQA and MHA, S=1 decode and S=3 chunks, f32.

Tolerance 1e-5: both sides compute in f32 and differ only in summation
order (online softmax over pages vs one dense softmax) over <= 32 keys.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorflowonspark_tpu_torch.ops import paged_attention as port_pa

# the JAX ops package binds its kernel functions under the submodules'
# names, so the submodule is fetched by its full name
jax_pa = importlib.import_module("tensorflowonspark_tpu.ops.paged_attention")

ATOL = RTOL = 1e-5


def _case(seed, B, S, H, n_kv, Dh, page, max_pages, lengths, extra=3):
    """Random q / pool / shuffled table; unoccupied entries name the
    last pool page (the sink stand-in)."""
    rng = np.random.RandomState(seed)
    NP = B * max_pages + extra
    q = rng.randn(B, S, H, Dh).astype(np.float32)
    pk = rng.randn(NP, page, n_kv, Dh).astype(np.float32)
    pv = rng.randn(NP, page, n_kv, Dh).astype(np.float32)
    perm = rng.permutation(NP - 1)
    table = np.full((B, max_pages), NP - 1, np.int32)
    off = 0
    for b, n in enumerate(lengths):
        used = -(-int(n) // page)
        table[b, :used] = perm[off:off + used]
        off += used
    return q, pk, pv, table, np.asarray(lengths, np.int32)


CASES = {
    "gqa-s1": dict(B=4, S=1, H=4, n_kv=2, lengths=[0, 9, 16, 32]),
    "mha-s1": dict(B=4, S=1, H=4, n_kv=4, lengths=[0, 9, 16, 32]),
    "gqa-s3": dict(B=4, S=3, H=4, n_kv=2, lengths=[0, 11, 20, 32]),
    "mha-s3": dict(B=3, S=3, H=2, n_kv=2, lengths=[3, 13, 24]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_kernel_and_reference(name):
    kw = CASES[name]
    q, pk, pv, table, lengths = _case(
        len(name), Dh=16, page=8, max_pages=4, **kw)
    out = port_pa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(table), torch.from_numpy(lengths)).numpy()
    args = [jnp.asarray(a) for a in (q, pk, pv, table, lengths)]
    kernel = np.asarray(jax_pa.paged_attention(*args, interpret=True))
    ref = np.asarray(jax_pa.paged_attention_reference(*args))
    assert out.shape == q.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, kernel, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    for b, n in enumerate(lengths):
        if n == 0:    # empty rows are defined to be exact zeros
            assert not out[b].any()


def test_split_choice_matches_jax():
    for req in (1, 4, 8, 16):
        for max_pages in (1, 3, 4, 6, 64, 100):
            assert (port_pa._pick_splits(req, max_pages)
                    == jax_pa._pick_splits(req, max_pages))


def test_rejects_bad_shapes_and_int8_pools():
    q, pk, pv, table, lengths = _case(5, B=1, S=1, H=4, n_kv=2, Dh=16,
                                      page=8, max_pages=2, lengths=[8])
    t = [torch.from_numpy(a) for a in (q, pk, pv, table, lengths)]
    with pytest.raises(ValueError, match="multiple of kv heads"):
        port_pa.paged_attention(t[0][:, :, :3], *t[1:])
    # the JAX wrapper's int8 rules: scales with int8 pools, and only then
    k8, v8 = t[1].to(torch.int8), t[2].to(torch.int8)
    sc = torch.ones(t[1].shape[:3])
    with pytest.raises(ValueError, match="int8 pools need"):
        port_pa.paged_attention(t[0], k8, v8, *t[3:])
    with pytest.raises(ValueError, match="only meaningful for int8"):
        port_pa.paged_attention(*t, key_scales=sc, value_scales=sc)
    with pytest.raises(ValueError, match="key_scales"):
        port_pa.paged_attention(t[0], k8, v8, *t[3:], key_scales=sc[:1],
                                value_scales=sc)
