"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips (with a reason) where no CUDA device
exists, so on the CPU tier they count as skips.  On a machine with the
card and the CUDA toolkit (no JAX needed; the repo's conftest imports
JAX, so skip it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes are small and deliberately awkward (head_dim 64 and 128, GQA
groups of 1 to 4, S=1 and S=3 decode, chunks that straddle pages and
tiles, empty rows, rows past the table, pad rows; flash sequences that
are not a multiple of the 64 x 32 tiles, causal and not; AdamW leaves of
odd sizes), in f32 and bf16.  Tolerances: f32 1e-4 (f32 math on both
sides, summation order differs over <= 300 keys); bf16 1e-2 (f32 math,
bf16 output rounding).  AdamW: the kernel's separately rounded f32 ops
match the plain version's to 1e-6 (p, nu) and one bf16 step (mu).
"""
import pytest
import torch

from tensorflowonspark_tpu_torch import benchmarks, ops
from tensorflowonspark_tpu_torch.models import decode as port_decode
from tensorflowonspark_tpu_torch.models import transformer as port_tf
from tensorflowonspark_tpu_torch.ops import flash_attention as fa
from tensorflowonspark_tpu_torch.ops import fused_optim as fo
from tensorflowonspark_tpu_torch.ops import paged_attention as pa
from tensorflowonspark_tpu_torch.ops import paged_prefill as pp

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card)")
    return torch.device("cuda")


def _pool(gen, B, max_pages, page, n_kv, Dh, dtype, dev, extra=2):
    NP = B * max_pages + extra
    pk = torch.randn((NP, page, n_kv, Dh), generator=gen).to(dev, dtype)
    pv = torch.randn((NP, page, n_kv, Dh), generator=gen).to(dev, dtype)
    perm = torch.randperm(NP - 1, generator=gen)[:B * max_pages]
    table = perm.reshape(B, max_pages).to(dev, torch.int32)
    return pk, pv, table, NP


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S,H,n_kv,Dh", [(1, 8, 2, 64), (1, 4, 4, 128),
                                         (3, 8, 2, 64), (3, 16, 8, 128)])
def test_decode_kernel_matches_plain(dev, dtype, S, H, n_kv, Dh):
    gen = torch.Generator().manual_seed(S * 100 + H + Dh)
    B, page, max_pages = 5, 16, 6
    pk, pv, table, _ = _pool(gen, B, max_pages, page, n_kv, Dh, dtype, dev)
    q = torch.randn((B, S, H, Dh), generator=gen).to(dev, dtype)
    # empty, mid-page, page boundary, full table, past the table (a free
    # row's garbage steps keep counting)
    lengths = torch.tensor([0, 21, 32, 96, 130], dtype=torch.int32,
                           device=dev).clamp_min(0)
    lengths[1:] = lengths[1:].clamp_min(S)
    for k_splits in (1, 3, 8):
        before = pa.paged_attention.launches
        out = pa.paged_attention(q, pk, pv, table, lengths,
                                 k_splits=k_splits)
        assert pa.paged_attention.launches == before + 1
        ref = pa.paged_attention_plain(q, pk, pv, table, lengths)
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        assert not out[0].any()          # empty row: exact zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S,H,n_kv,Dh,starts", [
    (12, 8, 2, 64, (0, 8, 21, 0)),
    (70, 4, 4, 128, (0, 33, 5, 0)),
    (33, 16, 4, 128, (64, 0, 100, 0)),
])
def test_prefill_kernels_match_plain(dev, dtype, S, H, n_kv, Dh, starts):
    gen = torch.Generator().manual_seed(S + H + Dh)
    B, page, max_pages = len(starts), 16, 12
    pk, pv, table, NP = _pool(gen, B, max_pages, page, n_kv, Dh, dtype, dev)
    sink = NP - 1
    table[3] = sink                      # the last row is a pad row
    q = torch.randn((B, S, H, Dh), generator=gen).to(dev, dtype)
    k = torch.randn((B, S, n_kv, Dh), generator=gen).to(dev, dtype)
    v = torch.randn((B, S, n_kv, Dh), generator=gen).to(dev, dtype)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    pk2, pv2 = pk.clone(), pv.clone()
    counts = ops.launch_counts()
    pp._write_pages(k, v, pk, pv, table, st)
    pp.write_pages_plain(k, v, pk2, pv2, table, st)
    nonsink = torch.arange(NP, device=dev) != sink
    assert torch.equal(pk[nonsink], pk2[nonsink])
    assert torch.equal(pv[nonsink], pv2[nonsink])
    out = pp._read_attention(q, k, v, pk, pv, table, st)
    ref = pp.read_attention_plain(q, k, v, pk, pv, table, st)
    after = ops.launch_counts()
    assert after["page_write"] == counts["page_write"] + 1
    assert after["prefill_read"] == counts["prefill_read"] + 1
    torch.testing.assert_close(out[:3].float(), ref[:3].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_greedy_generate_on_card_matches_cpu(dev):
    cfg = dict(vocab_size=128, d_model=256, n_heads=4, n_kv_heads=2,
               n_layers=2, d_ff=512, max_seq_len=128, dtype="float32",
               rope=True, norm_type="rmsnorm")
    cpu = port_tf.build_transformer(**cfg).eval()
    cpu.reset_parameters(torch.Generator().manual_seed(3))
    card = port_tf.build_transformer(**cfg).eval()
    card.load_state_dict(cpu.state_dict())
    card.to(dev)
    prompt = [[5, 17, 99, 3, 42, 8, 1, 77, 64, 12, 9, 30, 2, 2, 101]]
    ops.reset_launch_counts()
    with torch.no_grad():
        want = port_decode.generate(cpu, prompt, 12, device="cpu")
        got = port_decode.generate(card, prompt, 12, device=dev)
    assert got.cpu().tolist() == want.tolist()
    assert min(ops.launch_counts(ops.SERVING_KERNELS).values()) >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,n_kv,D,causal", [
    (2, 40, 4, 4, 64, True), (1, 100, 8, 4, 128, True),
    (2, 67, 8, 2, 64, False), (1, 130, 4, 1, 128, False),
    (1, 1, 2, 1, 64, True)])
def test_flash_kernels_match_plain(dev, dtype, B, S, H, n_kv, D, causal):
    gen = torch.Generator().manual_seed(B * 1000 + S + H + D)
    q = torch.randn((B, S, H, D), generator=gen).to(dev, dtype)
    k = torch.randn((B, S, n_kv, D), generator=gen).to(dev, dtype)
    v = torch.randn((B, S, n_kv, D), generator=gen).to(dev, dtype)
    do = torch.randn((B, S, H, D), generator=gen).to(dev, dtype)
    tol = TOL[dtype]
    counts = ops.launch_counts()
    out, lse = fa.flash_fwd(q, k, v, causal)
    ref, ref_lse = fa.flash_fwd_plain(q, k, v, causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    no_lse, none = fa.flash_fwd(q, k, v, causal, need_lse=False)
    assert none is None and torch.equal(no_lse, out)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), ref.float())
    dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal)
    want_dq = fa.flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, causal)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta,
                                              causal)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.shape == want.shape and got.dtype == want.dtype
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=tol * 4, rtol=tol)
    after = ops.launch_counts()
    assert after["flash_fwd"] == counts["flash_fwd"] + 2
    assert after["flash_bwd_dq"] == counts["flash_bwd_dq"] + 1
    assert after["flash_bwd_dkv"] == counts["flash_bwd_dkv"] + 1


def test_flash_attention_autograd_on_card(dev):
    gen = torch.Generator().manual_seed(7)
    leaves = [torch.randn(s, generator=gen).to(dev).requires_grad_(True)
              for s in ((2, 77, 8, 64), (2, 77, 2, 64), (2, 77, 2, 64))]
    out = fa.flash_attention(*leaves)
    want = fa.attention_reference(*leaves)
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)
    g = torch.randn(out.shape, generator=gen).to(dev)
    got = torch.autograd.grad(out, leaves, g)
    ref = torch.autograd.grad(want, leaves, g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    with pytest.raises(NotImplementedError, match="head_dim"):
        fa.flash_fwd(*[t.detach()[..., :32] for t in leaves])


@pytest.mark.parametrize("dtype,mu_dtype", [
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16)], ids=["f32-mubf16", "f32", "bf16"])
@pytest.mark.parametrize("write_param", [True, False],
                         ids=["apply", "update"])
def test_adamw_kernel_matches_plain(dev, dtype, mu_dtype, write_param):
    gen = torch.Generator().manual_seed(11)
    n = 300_001                       # odd: not a multiple of any vector
    g = torch.randn(n, generator=gen).to(dev, dtype)
    p = torch.randn(n, generator=gen).to(dev, dtype)
    mu = (0.1 * torch.randn(n, generator=gen)).to(dev, mu_dtype)
    nu = torch.rand(n, generator=gen).to(dev, dtype)
    scal = torch.tensor([3e-4, 0.5, 0.19, 0.002], device=dev)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.1, write_param=write_param)
    want_out, want_mu, want_nu = fo.adamw_plain(g, p, mu, nu, scal, **kw)
    out = p if write_param else torch.empty_like(g)
    before = fo._adamw.launches
    fo._adamw(g, p, mu, nu, scal, out, **kw)
    assert fo._adamw.launches == before + 1
    ulp = {torch.float32: 1e-6, torch.bfloat16: 8e-3}
    torch.testing.assert_close(out.float(), want_out.float(),
                               atol=ulp[dtype], rtol=ulp[dtype])
    torch.testing.assert_close(nu.float(), want_nu.float(), atol=1e-6,
                               rtol=ulp[dtype])
    torch.testing.assert_close(mu.float(), want_mu.float(), atol=1e-6,
                               rtol=ulp[mu_dtype])


def test_flagship_step_on_card_matches_cpu(dev):
    # f32 on both sides: the card runs kernels 4-7, the CPU their plain
    # versions; loss to 1e-4.  Parameters after 3 AdamW steps (lr 3e-4,
    # so each element moves at most ~9e-4): within 1e-4 each (an element
    # whose gradient is near 0 can turn its update, summation order
    # differs) and 1e-6 on average
    cfg = dict(benchmarks.FLAGSHIP_LM_V2, vocab_size=256, d_model=256,
               n_heads=4, n_kv_heads=2, n_layers=2, d_ff=512, max_seq_len=96,
               dtype="float32")
    cpu_step, cpu_state, tokens, _ = benchmarks.make_flagship_step(
        4, None, dict(cfg, attention_impl="flash"), device="cpu")
    step, state, card_tokens, _ = benchmarks.make_flagship_step(
        4, None, cfg, device=dev)
    state.params.load_state_dict(cpu_state.params.state_dict())
    assert torch.equal(card_tokens.cpu(), tokens)
    ops.reset_launch_counts()
    losses = []
    for _ in range(3):
        cpu_state, want = cpu_step(cpu_state, tokens, None)
        state, got = step(state, card_tokens, None)
        losses.append(want["loss"].item())
        for key in ("loss", "grad_norm"):
            torch.testing.assert_close(got[key].cpu(), want[key], atol=1e-4,
                                       rtol=1e-4)
    assert losses[-1] < losses[0]
    n_leaves = len(list(state.params.parameters()))
    assert ops.launch_counts(ops.TRAINING_KERNELS) == {
        "flash_fwd": 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6,
        "adamw": 3 * n_leaves}
    want = cpu_state.params.state_dict()
    for name, t in state.params.state_dict().items():
        diff = (t.cpu() - want[name]).abs()
        assert diff.max().item() <= 1e-4 and diff.mean().item() <= 1e-6, name
