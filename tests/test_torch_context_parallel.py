"""Parity of the port's context parallelism (ring attention and Ulysses)
with the JAX package, over four gloo ranks
(``tests/torch_model_parallel_world.py``).

- ``ring_attention`` (kernel path: kernels 4-6's plain versions with the
  lse merge; plain path: the online softmax) and ``ulysses_attention``
  (flash core and dense core), causal and not, with GQA-narrow k/v (4
  query heads, 2 kv heads), each rank its sequence block of ``[2, 32,
  ., 16]``: outputs within 2e-5 and q/k/v gradients within 2e-4 (ring)
  or 2e-5 (Ulysses) of the JAX functions on a JAX ``{tp: 4}`` mesh (the
  kernel path against JAX's Pallas kernels in interpret mode), the JAX
  tests' own tolerances;
- the Transformer with ``ring_attention_axis`` / ``ulysses_axis`` on the
  tp axis (parameters replicated, every rank its sequence block, global
  positions for RoPE and for learned positions) on ``{tp: 4}`` and
  ``{dp: 2, tp: 2}``: logits, loss, grad_norm and one step's whole
  gradient against the JAX sequential model within 3e-5;
- the ring's merge over a whole sequence's blocks in one process (the
  check chip_smoke phase 14 runs on one card) against flash attention;
- the sequence-split batch placement and feed, and what raises.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_model_parallel_world as tpw
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu.parallel import mesh as jax_mesh
from tensorflowonspark_tpu.parallel.ring_attention import (
    ring_attention as jax_ring)
from tensorflowonspark_tpu.parallel.ulysses import (
    ulysses_attention as jax_ulysses)
from tensorflowonspark_tpu_torch.ops import flash_attention as port_fa
from tensorflowonspark_tpu_torch.parallel import ring_attention as port_ring


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tpw.world(tmp_path_factory)


@pytest.mark.parametrize("label", ["ring4", "ring4_plain", "dp2ulysses2",
                                   "ulysses4"])
def test_cp_model_matches_jax(world, label):
    tpw.check_model_case(world, label)


_JAX_FNS = {
    "ring_flash": functools.partial(jax_ring, use_flash=True, interpret=True),
    "ring_plain": functools.partial(jax_ring, use_flash=False),
    "ulysses_flash": jax_ulysses,
    "ulysses_dense": functools.partial(
        jax_ulysses, attn_fn=lambda q, k, v, causal:
        jax_tf.dot_product_attention(*_repeat(q, k, v), causal=causal)),
}


def _repeat(q, k, v):
    rep = q.shape[2] // k.shape[2]
    return q, jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("label", list(_JAX_FNS))
def test_attention_function_matches_jax(world, label, causal):
    a = tpw.inputs()["attn"]
    mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(dp=1, tp=4),
                               devices=jax.devices()[:tpw.WORLD])
    fn = functools.partial(_JAX_FNS[label], axis_name="tp", causal=causal,
                           mesh=mesh)

    @jax.jit
    def fwd_bwd(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(do)

    out, grads = fwd_bwd(*(jnp.asarray(a[x]) for x in ("q", "k", "v", "do")))
    by_tp = sorted(world, key=lambda o: o["attention"]["coords"]["tp"])
    got = {key: np.concatenate([o["attention"][label, causal][key]
                                for o in by_tp], axis=1)
           for key in ("out", "dq", "dk", "dv")}
    gtol = tpw.RING_GRAD_TOL if label.startswith("ring") else tpw.ATTN_TOL
    np.testing.assert_allclose(got["out"], np.asarray(out),
                               rtol=tpw.ATTN_TOL, atol=tpw.ATTN_TOL)
    for key, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(got[key], np.asarray(g), rtol=gtol,
                                   atol=gtol, err_msg=key)


def test_ulysses_rejects_indivisible_heads(world):
    for o in world:
        assert "must be divisible by the ulysses axis size 4" in o[
            "attention"]["indivisible"]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_merge_over_blocks_in_one_process(causal):
    """The ring's per-step merge driven over a whole sequence's 4 blocks
    in one process (as chip_smoke phase 14 drives it on one card, through
    kernels 4-6): out and q/k/v gradients against flash attention over the
    whole sequence."""
    a = tpw.inputs()["attn"]
    q, k, v = (torch.from_numpy(a[x]).requires_grad_(True)
               for x in ("q", "k", "v"))
    do = torch.from_numpy(a["do"])
    n, s = 4, q.shape[1] // 4
    blk = [(k[:, i * s:(i + 1) * s], v[:, i * s:(i + 1) * s])
           for i in range(n)]
    out = torch.cat([port_ring.ring_merge(
        q[:, r * s:(r + 1) * s],
        [((r - j) % n,) + blk[(r - j) % n] for j in range(n)], r, causal)
        for r in range(n)], dim=1)
    got = torch.autograd.grad((out * do).sum(), (q, k, v))
    ref = port_fa.flash_attention(q, k, v, causal=causal)
    want = torch.autograd.grad((ref * do).sum(), (q, k, v))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=tpw.ATTN_TOL, atol=tpw.ATTN_TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=tpw.ATTN_TOL,
                                   atol=tpw.ATTN_TOL)


def test_merge_block_skips_a_future_block_exactly():
    """A skipped block (weight 0, lse -inf) leaves the running result as
    it was, and a first block's merge is that block: JAX's m_safe /
    alpha / w arithmetic."""
    rng = np.random.RandomState(0)
    out_blk = torch.from_numpy(rng.randn(1, 3, 2, 4).astype(np.float32))
    lse = torch.from_numpy(rng.randn(1, 2, 3).astype(np.float32))
    o = torch.zeros(1, 3, 2, 4)
    m = torch.full((1, 2, 3), -float("inf"))
    l = torch.zeros(1, 2, 3)
    o, m, l = port_ring.merge_block(o, m, l, out_blk, lse)
    np.testing.assert_allclose((o / l.transpose(1, 2)[..., None]).numpy(),
                               out_blk.numpy(), rtol=1e-6)
    skip = port_ring.block_attention(
        torch.zeros(1, 3, 2, 4), torch.zeros(1, 3, 2, 4),
        torch.zeros(1, 3, 2, 4), blk_idx=2, my_idx=1, causal=True)
    assert torch.isinf(skip[1]).all() and not skip[0].any()
    o2, m2, l2 = port_ring.merge_block(o, m, l, *skip)
    for x, y in ((o2, o), (m2, m), (l2, l)):
        assert torch.equal(x, y)


def test_seq_sharded_batches_give_each_rank_its_block(world):
    """put_batch, device_prefetch(sharding=), DataFeed.
    iter_device_batches(sharding=) and Dataset.prefetch_to_device(
    sharding=) under batch_sharding(mesh, "tp"): each rank its [b, S / 4]
    block (the feed pads its tail to 4 rows)."""
    tokens = tpw.inputs()["tokens"][:, :16]
    for o in world:
        m = o["misc"]
        j = o["attention"]["coords"]["tp"]
        blocks = {i: tokens[:, 4 * i:4 * i + 4] for i in range(4)}
        np.testing.assert_array_equal(m["put"], blocks[j])
        np.testing.assert_array_equal(m["prefetched"][0], blocks[j])
        np.testing.assert_array_equal(m["prefetched"][1], blocks[j] + 1)
        fed = np.concatenate(m["fed"])
        rows = np.concatenate([tokens[:6], tokens[5:6].repeat(2, 0)])
        np.testing.assert_array_equal(fed, rows[:, 4 * j:4 * j + 4])
        np.testing.assert_array_equal(np.concatenate(m["dataset"]),
                                      tokens[:8, 4 * j:4 * j + 4])
        assert "divisible by the 'tp' axis size 4" in m["seq_indivisible"]


def test_cp_errors_match_jax(world):
    """What the JAX dispatch refuses, the port refuses with the same
    message fragments; cp over parameters split on the same axis raises
    naming its ROADMAP item."""
    for o in world:
        e = o["misc"]["errors"]
        assert e["cp_mask"].startswith("NotImplementedError")
        assert "key-padding masks are not supported with sequence-" \
            "parallel attention" in e["cp_mask"]
        assert "decode mode with sequence-parallel attention is not " \
            "supported" in e["cp_decode"]
        assert e["cp_split"].startswith("NotImplementedError") and \
            "ROADMAP A3c" in e["cp_split"]
