"""Parity of the port's paged flash-decode attention with the JAX package.

The port's wrapper on CPU tensors runs its plain PyTorch version
(tensorflowonspark_tpu_torch/ops/paged_attention.py); it must match the
JAX Pallas kernel run in interpret mode (the real kernel body) and the
JAX gather reference on the same numpy inputs: a shuffled page table,
ragged lengths (an empty row, a row ending mid-page, a page-boundary row,
a full row), GQA and MHA, S=1 decode and S=3 chunks, f32.

Kernel 1's order of work on the card (csrc/paged_attention.cu: splits
over the row's occupied pages, one online-softmax update per token tile
of each of 4 warps, the warps and then the splits merged in order),
emulated in torch f32, against the JAX kernel in interpret mode on the
same cases and on rows shorter than the number of splits.

Tolerance 1e-5: both sides compute in f32 and differ only in summation
order (online softmax over pages vs one dense softmax) over <= 64 keys.
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


def decode_split_order(q, pk, pv, table, lengths, key_scales=None,
                       value_scales=None, k_splits=8, tile=8, warps=4):
    """Kernel 1's order of work (csrc/paged_attention.cu), in torch f32.

    Split sp of n_splits (``_pick_splits``) walks pages [sp * n_per, (sp
    + 1) * n_per) of the row's ceil(n_vis / page) occupied pages, n_per =
    ceil(that / n_splits); warp w of 4 takes every 4th ``tile`` of the
    split's tokens (the kernel's tile: 8 tokens in f32 at Dh 64, 16 over
    bf16 or int8 pools at Dh 128) and updates its softmax once a tile
    (masked keys p = 0); the warps merge by exp(m_w - M), then the splits in split order
    with the denominator clamped at 1e-30.  int8 pools fold the scales
    into the products: s = (q . k_int) k_scale sm_scale, P V sums (p
    v_scale) v_int.  Returns ``[B, S, H, Dh]`` f32."""
    q, pk, pv = q.float(), pk.float(), pv.float()
    B, S, H, Dh = q.shape
    NP, page, n_kv, _ = pk.shape
    max_pages = table.shape[1]
    group = H // n_kv
    sm_scale = Dh ** -0.5
    n_splits = port_pa._pick_splits(k_splits, max_pages)
    neg = port_pa.NEG_INF
    out = torch.zeros(B, S, H, Dh)
    for b in range(B):
        n_tok = int(lengths[b])
        n_vis = min(n_tok, max_pages * page)
        n_per = -(-(-(-n_vis // page)) // n_splits)
        # grouped rows: row r is query r // group of q head h * group + r
        # % group, for each kv head h
        qg = q[b].reshape(S, n_kv, group, Dh).permute(1, 0, 2, 3).reshape(
            n_kv, S * group, Dh)
        lim = n_tok - S + torch.arange(S).repeat_interleave(group)
        parts = []
        for sp in range(n_splits):
            t_begin = sp * n_per * page
            t_end = min(t_begin + n_per * page, n_vis)
            states = []
            for w in range(warps):
                m = torch.full((n_kv, S * group), neg)
                l = torch.zeros(n_kv, S * group)
                acc = torch.zeros(n_kv, S * group, Dh)
                for t0 in range(t_begin + w * tile, t_end, warps * tile):
                    t = torch.arange(t0, min(t0 + tile, t_end))
                    phys = table[b, t // page].long().clamp(0, NP - 1)
                    k, v = pk[phys, t % page], pv[phys, t % page]
                    sc = (torch.einsum("hrd,thd->hrt", qg, k)
                          if key_scales is None else
                          torch.einsum("hrd,thd->hrt", qg, k)
                          * key_scales[phys, t % page].T[:, None])
                    sc = sc * sm_scale
                    vis = (t[None, :] <= lim[:, None])[None]
                    mn = torch.maximum(m, torch.where(
                        vis, sc, torch.tensor(neg)).amax(-1))
                    alpha = torch.exp(m - mn)
                    p = torch.where(vis, torch.exp(sc - mn[..., None]),
                                    torch.zeros(()))
                    l = l * alpha + p.sum(-1)
                    if value_scales is not None:
                        p = p * value_scales[phys, t % page].T[:, None]
                    acc = (acc * alpha[..., None]
                           + torch.einsum("hrt,thd->hrd", p, v))
                    m = mn
                states.append((m, l, acc))
            mw = torch.stack([st[0] for st in states])
            mx = mw.amax(0)
            wt = torch.exp(mw - mx)
            parts.append((mx, (wt * torch.stack([st[1] for st in states])
                               ).sum(0),
                          (wt[..., None] * torch.stack(
                              [st[2] for st in states])).sum(0)))
        mx = torch.stack([pt[0] for pt in parts]).amax(0)
        denom = torch.zeros(n_kv, S * group)
        o = torch.zeros(n_kv, S * group, Dh)
        for m, l, acc in parts:
            wt = torch.exp(m - mx)
            denom = denom + wt * l
            o = o + wt[..., None] * acc
        o = o / denom.clamp_min(1e-30)[..., None]
        out[b] = o.reshape(n_kv, S, group, Dh).permute(1, 0, 2, 3).reshape(
            S, H, Dh)
    return out


ORDER_CASES = dict(CASES, **{
    # 8 splits over 8 table pages: rows of 1, 2 and 8 pages
    "short-rows": dict(B=3, S=1, H=4, n_kv=2, lengths=[5, 12, 64],
                       max_pages=8)})


@pytest.mark.parametrize("name", list(ORDER_CASES))
def test_kernel_order_of_work_matches_jax_kernel(name):
    kw = dict(ORDER_CASES[name])
    max_pages = kw.pop("max_pages", 4)
    q, pk, pv, table, lengths = _case(
        len(name) + 7, Dh=16, page=8, max_pages=max_pages, **kw)
    got = decode_split_order(*(torch.from_numpy(a)
                               for a in (q, pk, pv, table, lengths)))
    want = np.asarray(jax_pa.paged_attention(
        *(jnp.asarray(a) for a in (q, pk, pv, table, lengths)),
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    for b, n in enumerate(lengths):
        if n == 0:
            assert not got[b].any()


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
