"""Parity of the port's paged prefill with the JAX package.

The port's ``paged_prefill`` on CPU tensors runs its plain PyTorch
versions of the page write and the chunked read
(tensorflowonspark_tpu_torch/ops/paged_prefill.py); it must match the
JAX Pallas kernels run in interpret mode on the same numpy inputs.
Covered: ragged multi-row bursts with fresh (0), page-aligned and
unaligned starts, a chunk straddling pages, a chunk wider than two
pages, bucket-pad overshoot past a row's allocation, and a pad row with
an all-sink table.

Outputs: 1e-5 (f32 on both sides, summation order differs).  Pools:
byte-for-byte on every page but the sink, whose bytes are garbage by
contract (concurrent sink stores race on the card and sum in the JAX
kernel).  Pad-row outputs are excluded: the model drops them.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorflowonspark_tpu_torch.ops import paged_prefill as port_pp

# the JAX ops package binds its kernel functions under the submodules'
# names, so the submodule is fetched by its full name
jax_pp = importlib.import_module("tensorflowonspark_tpu.ops.paged_prefill")

ATOL = RTOL = 1e-5


def _case(seed, H, n_kv, S=12, P=8, max_pages=4, Dh=16,
          starts=(0, 8, 12, 0), pad_rows=(3,), valid=None, extra=3):
    """Ragged burst; each live row maps ceil((start + valid) / P) pages
    of a shuffled pool, the rest of its table (and a pad row's whole
    table) names the sink."""
    rng = np.random.RandomState(seed)
    B = len(starts)
    valid = valid or [S] * B
    NP = B * max_pages + extra
    q = rng.randn(B, S, H, Dh).astype(np.float32)
    k = rng.randn(B, S, n_kv, Dh).astype(np.float32)
    v = rng.randn(B, S, n_kv, Dh).astype(np.float32)
    pk = rng.randn(NP, P, n_kv, Dh).astype(np.float32)
    pv = rng.randn(NP, P, n_kv, Dh).astype(np.float32)
    sink = NP - 1
    perm = rng.permutation(NP - 1)
    table = np.full((B, max_pages), sink, np.int32)
    off = 0
    for b, st in enumerate(starts):
        if b in pad_rows:
            continue
        used = min(max_pages, -(-(int(st) + valid[b]) // P))
        table[b, :used] = perm[off:off + used]
        off += used
    return (q, k, v, pk, pv, table, np.asarray(starts, np.int32), sink,
            pad_rows)


def _check(case):
    q, k, v, pk, pv, table, starts, sink, pad_rows = case
    jout, jpools = jax_pp.paged_prefill(
        *[jnp.asarray(a) for a in (q, k, v, pk, pv, table, starts)],
        interpret=True)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    out, pools = port_pp.paged_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tk, tv, torch.from_numpy(table), torch.from_numpy(starts))
    assert pools[0] is tk and pools[1] is tv      # updated in place
    nonsink = np.arange(pk.shape[0]) != sink
    np.testing.assert_array_equal(tk.numpy()[nonsink],
                                  np.asarray(jpools[0])[nonsink])
    np.testing.assert_array_equal(tv.numpy()[nonsink],
                                  np.asarray(jpools[1])[nonsink])
    live = [b for b in range(q.shape[0]) if b not in pad_rows]
    np.testing.assert_allclose(out.numpy()[live], np.asarray(jout)[live],
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("H,n_kv", [(4, 2), (4, 4)], ids=["gqa", "mha"])
def test_ragged_burst_with_pad_row(H, n_kv):
    # starts: fresh (0), page-aligned (8), straddling (12); row 3 is pad
    _check(_case(0, H, n_kv))


def test_unaligned_start_chunk_wider_than_two_pages():
    # S=20 > 2 pages: a chunk touching ceil(S/P)+1 logical blocks, one
    # row starting mid-page
    _check(_case(1, 4, 2, S=20, starts=(0, 7), pad_rows=()))


def test_bucket_pad_overshoot_lands_in_sink():
    # row 0 holds 3 real tokens at start 12 but its bucket is 12 wide:
    # positions 16..23 run past its 2 mapped pages into the sink
    _check(_case(2, 4, 2, S=12, starts=(12, 0), pad_rows=(),
                 valid=[3, 12]))


def test_rejects_bad_shapes_and_int8_pools():
    q, k, v, pk, pv, table, starts, _, _ = _case(3, 4, 2, starts=(0,),
                                                 pad_rows=())
    t = [torch.from_numpy(a) for a in (q, k, v, pk, pv, table, starts)]
    with pytest.raises(ValueError, match="multiple of kv heads"):
        port_pp.paged_prefill(t[0][:, :, :3], *t[1:])
    with pytest.raises(ValueError, match="must be"):
        port_pp.paged_prefill(t[0], t[1][:, :4], t[2][:, :4], *t[3:])
    # the JAX wrapper's int8 rules: scales with int8 pools, and only then
    k8, v8 = t[3].to(torch.int8), t[4].to(torch.int8)
    sc = torch.ones(t[3].shape[:3])
    with pytest.raises(ValueError, match="int8 pools need"):
        port_pp.paged_prefill(t[0], t[1], t[2], k8, v8, *t[5:])
    with pytest.raises(ValueError, match="only meaningful for int8"):
        port_pp.paged_prefill(*t, key_scales=sc, value_scales=sc)
