"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips (with a reason) where no CUDA device
exists, so on the CPU tier they count as skips.  On a machine with the
card and the CUDA toolkit (no JAX needed; the repo's conftest imports
JAX, so skip it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes are small and deliberately awkward (head_dim 64 and 128, GQA
groups of 1 to 4, S=1 and S=3 decode, chunks that straddle pages and
tiles, empty rows, rows past the table, pad rows, page 64 with starts
and contexts off the page and the 64-key tile; flash sequences that are
not a multiple of the 64 x 32 tiles, causal and not, and in bf16 on the
tensor-core kernels' 64-row / 64-key tile edges (S 63, 64, 65, 129,
1024) at GQA groups 1 to 8 (the backward also repeated bitwise; the C
entries refuse rows that are not 16-byte aligned, the wrappers run an
aligned copy of them and give its bits); paged decode rows shorter than
their splits, repeated bitwise and alone as in a batch; the int8-pool
prefill read on the tensor cores over several 64-key tiles; AdamW leaves of
odd sizes; quantised matmuls at 1 to 2048 rows (16, 17 and 65 on the
tensor-core tile edges), K 1 to 8192 (130: x rows not 16-byte aligned),
int4 groups of 16, 32, 128 and 256, N 5 to 32000, 3-D activations; int8 kv
pools at odd S
and starts straddling pages; the int8 page write at 16-row decode
steps (positions at offset 0 and page - 1 of a page) and at prefill
chunks of four kv rows a warp, with a ragged last warp, and the float
page write at S 1, 7 and 256 over rows of 128 to 4096 bytes, each with
an out-of-range page id; LayerNorm rows of 64 to 8192, D not a
multiple of 256, both of the kernel's layouts (16-byte chunks, single
values) at N 1, 8 and 1024 with every (x, parameter) dtype pair, and
misaligned views), in f32 and bf16.
Tolerances: f32 1e-4 (f32 math on both sides, summation order differs
over <= 300 keys); bf16 1e-2 (f32 math, bf16 output rounding).  Lion
(kernel 8): bitwise equal to ``lion_plain`` (bit patterns, so the sign
of a zero counts; a NaN as a NaN, whose payload the bf16 conversions
spell differently), at sizes 1, 255, 257 and 2^20 + 3 with zeros, -0
and a NaN among the inputs.  ``flash_attention_with_lse``: the
gradients under a random lse cotangent as the flash kernels' (f32, and
bf16 at the flash backward's bf16 tolerance, atol 4e-2).  AdamW:
the kernel's separately rounded f32 ops match the plain version's to
1e-6 (p, nu) and one bf16 step (mu).  Quantised matmuls: the largest
error within 1e-5 (f32) or 2e-2 (bf16) of the largest |output|, as the
JAX package's own kernel tests hold them, and each row's bits the same
whatever the number of rows in the call.  int8 kv: the quantising page
write gives the plain version's and the CPU's bytes exactly (payload,
scales and the dequantised chunk); the reads as above.  LayerNorm: f32
1e-5, bf16 one bf16 step (rtol 2^-7); each row's bits the same at every
N, and a misaligned view's the same as its aligned copy's.  The page
write: bitwise (pools, scales, dequantised chunk; off the sink where a
pad row writes it).  8-bit AdamW state (``optim8bit``,
plain PyTorch on both sides): its square root, quantise / dequantise
and three updates give the CPU's bits (the int8 payloads and f32
scales); the updates within rtol 1e-6 (the bias corrections'
``torch.pow`` may round an ulp apart) and atol 1e-8 (an ulp of a term
where weight decay cancels).
"""
import pytest
import torch

from tensorflowonspark_tpu_torch import (benchmarks, export, ops, optim,
                                         optim8bit, quantize, serve)
from tensorflowonspark_tpu_torch.models import decode as port_decode
from tensorflowonspark_tpu_torch.models import transformer as port_tf
from tensorflowonspark_tpu_torch.ops import _build
from tensorflowonspark_tpu_torch.ops import flash_attention as fa
from tensorflowonspark_tpu_torch.ops import fused_optim as fo
from tensorflowonspark_tpu_torch.ops import layernorm as ln
from tensorflowonspark_tpu_torch.ops import paged_attention as pa
from tensorflowonspark_tpu_torch.ops import paged_prefill as pp
from tensorflowonspark_tpu_torch.ops import quant_matmul as qm

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


def _cases(f32_and_bf16, bf16_only):
    """Parametrize cases: each shape in f32 and bf16, then bf16-only
    shapes (the tensor-core kernels' tile edges; f32 runs the CUDA-core
    kernels, which the first list covers)."""
    def case(dtype, name, shape):
        parts = ["_".join(map(str, x)) if isinstance(x, tuple) else str(x)
                 for x in shape]
        return pytest.param(dtype, *shape, id="-".join([*parts, name]))

    return ([case(dt, name, shape) for shape in f32_and_bf16
             for dt, name in ((torch.float32, "f32"),
                              (torch.bfloat16, "bf16"))]
            + [case(torch.bfloat16, "bf16", shape) for shape in bf16_only])


# page 64 with starts that are not page multiples and contexts that are
# not multiples of the 64-key tile; GQA group 4 (bf16 runs the
# tensor-core read)
@pytest.mark.parametrize("dtype,S,H,n_kv,Dh,starts,page", _cases(
    [(12, 8, 2, 64, (0, 8, 21, 0), 16),
     (70, 4, 4, 128, (0, 33, 5, 0), 16),
     (33, 16, 4, 128, (64, 0, 100, 0), 16)],
    [(100, 16, 4, 128, (130, 64, 0, 0), 64),
     (37, 8, 2, 64, (200, 5, 64, 0), 64),
     (65, 8, 2, 128, (63, 127, 1, 0), 16)]))
def test_prefill_kernels_match_plain(dev, dtype, S, H, n_kv, Dh, starts,
                                     page):
    gen = torch.Generator().manual_seed(S + H + Dh)
    B, max_pages = len(starts), 12
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


# bf16-only: the tensor-core kernels' tile edges (S 63, 64, 65, 129 and
# 1024), GQA groups 1 to 8, D 64 and 128, causal and not; group 8 at S 65
# and 129 walks the dk/dv kernel over 8 q heads into a ragged last tile
@pytest.mark.parametrize("dtype,B,S,H,n_kv,D,causal", _cases(
    [(2, 40, 4, 4, 64, True), (1, 100, 8, 4, 128, True),
     (2, 67, 8, 2, 64, False), (1, 130, 4, 1, 128, False),
     (1, 1, 2, 1, 64, True)],
    [(1, 63, 4, 4, 64, True), (2, 64, 8, 4, 128, False),
     (1, 65, 8, 2, 128, True), (2, 65, 4, 1, 64, False),
     (1, 129, 8, 1, 64, False), (1, 129, 16, 2, 128, True),
     (1, 1024, 8, 4, 128, True), (1, 1024, 8, 1, 64, False),
     (1, 65, 8, 1, 64, True), (1, 65, 8, 1, 64, False),
     (1, 65, 8, 1, 128, True), (1, 65, 8, 1, 128, False),
     (1, 129, 8, 1, 64, True), (1, 129, 8, 1, 128, True),
     (1, 129, 8, 1, 128, False)]))
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


@pytest.mark.parametrize("S,H,n_kv,D,causal", [
    (200, 8, 2, 128, True), (129, 8, 1, 64, False)])
def test_flash_backward_kernels_repeat_bitwise(dev, S, H, n_kv, D, causal):
    # bf16 (the tensor-core kernels): each output element is written
    # once by one block, summed in a fixed order
    gen = torch.Generator().manual_seed(S + D)
    q, do = (torch.randn((2, S, H, D), generator=gen).to(dev, torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((2, S, n_kv, D), generator=gen).to(
        dev, torch.bfloat16) for _ in range(2))
    out, lse = fa.flash_fwd(q, k, v, causal)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), out.float())
    first = [fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)]
    again = [fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)]
    for a, b in zip(first, again):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_flash_kernels_refuse_what_they_do_not_take(dev):
    # the bf16 C entries refuse rows that are not 16-byte aligned (the
    # wrappers hand them an aligned copy instead), and head_dim 32 raises
    # rather than take another path
    gen = torch.Generator().manual_seed(11)
    B, S, H, D = 1, 70, 4, 64
    n = B * S * H * D
    buf = torch.randn(n + 1, generator=gen).to(dev, torch.bfloat16)
    q = buf[1:].view(B, S, H, D)                 # 2 bytes off
    k = torch.randn((B, S, H, D), generator=gen).to(dev, torch.bfloat16)
    lse = torch.zeros((B, H, S), device=dev)
    out, dk, dv = (torch.empty_like(k) for _ in range(3))
    lib, P = _build.lib(), _build.ptr
    tail = (B, S, H, H, D, D ** -0.5, 1, _build.dtype_code(q),
            _build.stream_ptr(dev))
    for name, args in (
            ("tos_flash_fwd", (q, k, k, out, lse)),
            ("tos_flash_bwd_dq", (q, k, k, k, lse, lse, out)),
            ("tos_flash_bwd_dkv", (k, k, k, q, lse, lse, dk, dv))):
        code = getattr(lib, name)(*map(P, args), *tail)
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.check(code, name)
    small = k[..., :32].contiguous()
    with pytest.raises(NotImplementedError, match="head_dim"):
        fa.flash_bwd_dq(small, small, small, small, lse, lse)
    with pytest.raises(NotImplementedError, match="head_dim"):
        fa.flash_bwd_dkv(small, small, small, small, lse, lse)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_wrappers_realign_misaligned_views(dev, D):
    # a bf16 view 2 bytes off a 16-byte boundary runs the same kernel on
    # an aligned copy: the bits of the aligned input's result
    gen = torch.Generator().manual_seed(D + 3)
    B, S, H, n_kv = 1, 70, 4, 2
    tensors = {}
    for name, h in (("q", H), ("k", n_kv), ("v", n_kv), ("do", H)):
        n = B * S * h * D
        buf = torch.randn(n + 1, generator=gen).to(dev, torch.bfloat16)
        tensors[name] = buf[1:].view(B, S, h, D)
    assert all(t.data_ptr() % 16 for t in tensors.values())
    copies = {name: t.clone() for name, t in tensors.items()}
    assert not any(t.data_ptr() % 16 for t in copies.values())
    lse = torch.randn((B, H, S), generator=gen).to(dev)
    delta = torch.randn((B, H, S), generator=gen).to(dev)

    def run(t):
        out, out_lse = fa.flash_fwd(t["q"], t["k"], t["v"])
        return [out, out_lse,
                fa.flash_bwd_dq(t["q"], t["k"], t["v"], t["do"], lse, delta),
                *fa.flash_bwd_dkv(t["q"], t["k"], t["v"], t["do"], lse,
                                  delta)]

    for got, want in zip(run(tensors), run(copies)):
        assert torch.equal(got, want)


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


def _same_bits(a, b):
    """Equal bit patterns, NaN for NaN."""
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return torch.equal(a.view(view)[~nan], b.view(view)[~nan])


@pytest.mark.parametrize("n", [1, 255, 257, 2**20 + 3])
@pytest.mark.parametrize("dtype,mu_dtype", [
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)],
    ids=["f32-mubf16", "f32", "bf16", "bf16-muf32"])
@pytest.mark.parametrize("write_param", [True, False],
                         ids=["apply", "update"])
@pytest.mark.parametrize("wd", [0.0, 0.1], ids=["nowd", "wd"])
def test_lion_kernel_matches_plain_bitwise(dev, n, dtype, mu_dtype,
                                           write_param, wd):
    gen = torch.Generator().manual_seed(n + 13)
    g = torch.randn(n, generator=gen)
    mu = 0.1 * torch.randn(n, generator=gen)
    if n > 8:
        g[:4] = torch.tensor([0.0, -0.0, 0.0, float("nan")])
        mu[:4] = torch.tensor([0.0, -0.0, -0.0, 0.5])
    g, mu = g.to(dev, dtype), mu.to(dev, mu_dtype)
    p = torch.randn(n, generator=gen).to(dev, dtype)
    scal = torch.tensor([3e-4, 0.5, 0.19, 0.002], device=dev)
    kw = dict(b1=0.9, b2=0.99, wd=wd, write_param=write_param)
    want_out, want_mu = fo.lion_plain(g, p, mu, scal, **kw)
    out = p if write_param else torch.empty_like(g)
    before = fo._lion.launches
    fo._lion(g, p, mu, scal, out, **kw)
    torch.cuda.synchronize()
    assert fo._lion.launches == before + 1
    assert out.dtype == dtype and mu.dtype == mu_dtype
    assert _same_bits(out, want_out)
    assert _same_bits(mu, want_mu)


def _8bit_inputs(gen, signed):
    zeros_first = torch.randn(700, generator=gen)
    zeros_first[:256] = 0.0                   # one block of zeros
    ties = torch.zeros(300)
    ties[:4] = torch.tensor([254.0, 1.0, -127.0, 0.5])  # .5 steps at 254
    xs = [torch.randn(1, generator=gen), torch.randn(255, generator=gen),
          torch.randn(3, 301, generator=gen) * 5.0, zeros_first, ties]
    return xs if signed else [x.abs() for x in xs]


@pytest.mark.parametrize("block", [256, 64])
@pytest.mark.parametrize("signed", [True, False],
                         ids=["signed", "unsigned"])
def test_optim8bit_quantize_on_card_gives_the_cpu_bytes(dev, signed, block):
    gen = torch.Generator().manual_seed(block + signed)
    for x in _8bit_inputs(gen, signed):
        want = optim8bit.quantize(x, block, signed=signed)
        got = optim8bit.quantize(x.to(dev), block, signed=signed)
        assert torch.equal(got.q.cpu(), want.q)
        assert torch.equal(got.scale.cpu(), want.scale)
        back = optim8bit.dequantize(got, x.shape, signed=signed)
        assert _same_bits(back.cpu(), optim8bit.dequantize(
            want, x.shape, signed=signed))


def test_optim8bit_sqrt_on_card_is_the_cpu_sqrt(dev):
    x = torch.rand(1 << 20, generator=torch.Generator().manual_seed(5))
    x[:3] = torch.tensor([0.0, 1.0, 4.0])
    got = optim8bit.sqrt(x.to(dev))
    assert got.dtype == torch.float32
    assert _same_bits(got.cpu(), optim8bit.sqrt(x))
    assert got[:3].tolist() == [0.0, 1.0, 2.0]


def test_adamw8bit_steps_on_card_match_cpu(dev):
    gen = torch.Generator().manual_seed(31)
    params = {"w": torch.randn(40, 70, generator=gen),
              "b": torch.randn(300, generator=gen),
              "z": torch.zeros(600), "s": torch.randn(5, generator=gen)}
    opt, _ = optim.make_optimizer("adamw8bit", learning_rate=0.05,
                                  weight_decay=0.1)
    card = {n: p.to(dev) for n, p in params.items()}
    cpu_state, card_state = opt.init(params), opt.init(card)
    for _ in range(3):
        grads = {n: torch.randn(p.shape, generator=gen)
                 for n, p in params.items()}
        grads["z"][:256] = 0.0                # one block of zeros
        want, cpu_state = opt.update(grads, cpu_state, params)
        got, card_state = opt.update({n: g.to(dev) for n, g in
                                      grads.items()}, card_state, card)
        for n in params:
            for part in ("mu", "nu_sqrt"):
                a = getattr(card_state[0], part)[n]
                b = getattr(cpu_state[0], part)[n]
                assert torch.equal(a.q.cpu(), b.q), (n, part)
                assert torch.equal(a.scale.cpu(), b.scale), (n, part)
            # atol: where u + wd p cancels, an ulp of a term (~4e-9)
            torch.testing.assert_close(got[n].cpu(), want[n], atol=1e-8,
                                       rtol=1e-6)
            params[n] = params[n] + want[n]
            card[n] = params[n].to(dev)      # both follow the CPU's path
        assert int(card_state[0].count) == int(cpu_state[0].count)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_with_lse_backward_matches_plain(dev, D, causal):
    gen = torch.Generator().manual_seed(D + causal)
    shapes = ((2, 70, 8, D), (2, 70, 2, D), (2, 70, 2, D))
    leaves = [torch.randn(s, generator=gen).to(dev).requires_grad_(True)
              for s in shapes]
    g = torch.randn(shapes[0], generator=gen).to(dev)
    g_lse = torch.randn((2, 8, 70), generator=gen).to(dev)
    before = ops.launch_counts()
    out, lse = fa.flash_attention_with_lse(*leaves, causal=causal)
    got = torch.autograd.grad((out, lse), leaves, (g, g_lse))
    after = ops.launch_counts()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert after[name] == before[name] + 1, name
    q, k, v = (t.detach() for t in leaves)
    ref, ref_lse = fa.flash_fwd_plain(q, k, v, causal)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    delta = (torch.einsum("bshd,bshd->bhs", g, ref) - g_lse)
    want = [fa.flash_bwd_dq_plain(q, k, v, g, ref_lse, delta, causal),
            *fa.flash_bwd_dkv_plain(q, k, v, g, ref_lse, delta, causal)]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=4e-4, rtol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_with_lse_bf16_backward_matches_plain(dev, causal):
    # the tensor-core backward under an lse cotangent (folded into
    # delta), at the bf16 gradient tolerance of test_flash_kernels_match_plain
    gen = torch.Generator().manual_seed(128 + causal)
    shapes = ((2, 150, 8, 128), (2, 150, 2, 128), (2, 150, 2, 128))
    leaves = [torch.randn(s, generator=gen).to(dev, torch.bfloat16)
              .requires_grad_(True) for s in shapes]
    g = torch.randn(shapes[0], generator=gen).to(dev, torch.bfloat16)
    g_lse = torch.randn((2, 8, 150), generator=gen).to(dev)
    out, lse = fa.flash_attention_with_lse(*leaves, causal=causal)
    got = torch.autograd.grad((out, lse), leaves, (g, g_lse))
    q, k, v = (t.detach() for t in leaves)
    ref, ref_lse = fa.flash_fwd_plain(q, k, v, causal)
    delta = (torch.einsum("bshd,bshd->bhs", g.float(), out.float())
             - g_lse)
    want = [fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, causal),
            *fa.flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal)]
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), atol=tol * 4,
                                   rtol=tol)


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
        "adamw": 3 * n_leaves, "lion": 0}
    want = cpu_state.params.state_dict()
    for name, t in state.params.state_dict().items():
        diff = (t.cpu() - want[name]).abs()
        assert diff.max().item() <= 1e-4 and diff.mean().item() <= 1e-6, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
# int4 groups: 32 to 256 stage one scale row with each 32-row K step, 16
# reads each row's scales (a step spans two groups)
@pytest.mark.parametrize("mode,group", [("int8", None), ("int4", 128),
                                        ("int4", 32), ("int4", 256),
                                        ("int4", 16)],
                         ids=["int8", "int4", "int4-g32", "int4-g256",
                              "int4-g16"])
@pytest.mark.parametrize("shape", [
    (1, 200, 1000), (7, 200, 1003), (1024, 200, 1000), (7, 2048, 32000),
    (1, 1, 5), (3, 4, 7),
    # [B, M, K, N]: B * M rows on the 16- and 64-row tile edges at the
    # flagship's `wi`; K 130 (x rows not 16-byte aligned, a ragged last
    # step); `wo` at decode (K 8192, N 2048); `lm_head` at a decode step
    (1, 16, 2048, 8192), (1, 17, 2048, 8192), (1, 65, 2048, 8192),
    (2, 7, 130, 1000), (1, 16, 8192, 2048), (1, 8, 2048, 32000)])
def test_quant_matmul_kernels_match_plain(dev, dtype, mode, group, shape):
    # a 3-D activation [B, M, K] reshapes to B * M rows (B 2 unless given)
    B, M, K, N = shape if len(shape) == 4 else (2, *shape)
    gen = torch.Generator().manual_seed(M + K + N)
    w = torch.randn((K, N), generator=gen) * 0.3
    leaf = (quantize.quantize_int8(w) if mode == "int8"
            else quantize.int4_pack(w, group))
    on_card = ({"q": leaf["q"].to(dev), "scale": leaf["scale"].to(dev)}
               if mode == "int8" else quantize.Int4Weight(
                   leaf.q.to(dev), leaf.scale.to(dev), leaf.in_dim,
                   leaf.group_size))
    x = torch.randn((B, M, K), generator=gen).to(dev, dtype)
    name = f"{mode}_matmul"
    before = ops.launch_counts()[name]
    got = qm.quant_matmul(x, on_card)
    assert ops.launch_counts()[name] == before + 1
    plain = qm.int8_matmul_plain if mode == "int8" else qm.int4_matmul_plain
    want = plain(x, on_card)
    torch.cuda.synchronize()
    assert got.shape == (B, M, N) and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert err <= tol * want.float().abs().max().item() + 1e-6, err
    # the CPU plain version of the same leaf agrees too
    cpu = plain(x.cpu(), leaf)
    torch.testing.assert_close(got.cpu().float(), cpu.float(),
                               atol=tol * cpu.float().abs().max().item()
                               + 1e-6, rtol=0)


def test_quantize_on_card_gives_the_cpu_bytes(dev):
    gen = torch.Generator().manual_seed(5)
    w = torch.randn((2048, 1024), generator=gen) * 0.02
    a, b = quantize.quantize_int8(w), quantize.quantize_int8(w.to(dev))
    assert torch.equal(a["q"], b["q"].cpu())
    assert torch.equal(a["scale"], b["scale"].cpu())
    a, b = quantize.int4_pack(w, 128), quantize.int4_pack(w.to(dev), 128)
    assert torch.equal(a.q, b.q.cpu()) and torch.equal(a.scale,
                                                       b.scale.cpu())


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_generate_on_card_matches_cpu(dev, mode, tmp_path):
    # f32 on both sides; the card runs kernels 1-3 and the quantised
    # matmul, the CPU their plain versions on the same quantised bytes
    cfg = dict(vocab_size=128, d_model=256, n_heads=4, n_kv_heads=2,
               n_layers=2, d_ff=512, max_seq_len=128, dtype="float32",
               rope=True, norm_type="rmsnorm")
    model = port_tf.build_transformer(**cfg)
    model.reset_parameters(torch.Generator().manual_seed(3))
    export.export_saved_model(str(tmp_path), model.state_dict(),
                              builder_kwargs=cfg)
    prompt = [5, 17, 99, 3, 42, 8, 1, 77, 64, 12, 9, 30, 2, 2, 101]
    outs = {}
    ops.reset_launch_counts()
    for device in ("cpu", dev):
        svc = serve.GenerateService(str(tmp_path), kv_page_size=16,
                                    kv_pages=16, quantize_mode=mode,
                                    device=device)
        try:
            outs[str(device)] = svc.generate({"inputs": [prompt],
                                              "max_new_tokens": 12})
        finally:
            svc.close()
    assert outs["cpu"] == outs[str(dev)]
    counts = ops.launch_counts(ops.SERVING_KERNELS + (f"{mode}_matmul",))
    assert min(counts.values()) >= 1, counts


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quant_matmul_rows_do_not_depend_on_the_batch(dev, mode):
    # a request decodes the same tokens alone or in a batch: each row's
    # bits are the same at M 1 ... 64 (16-row tiles or 64, K chunks in
    # their own blocks) as at M 300 (one block walks every chunk)
    gen = torch.Generator().manual_seed(17)
    K, N = 2048, 8192
    w = torch.randn((K, N), generator=gen) * K ** -0.5
    leaf = quantize.quantize_int8(w) if mode == "int8" else \
        quantize.int4_pack(w, 128)
    leaf = ({"q": leaf["q"].to(dev), "scale": leaf["scale"].to(dev)}
            if mode == "int8" else quantize.Int4Weight(
                leaf.q.to(dev), leaf.scale.to(dev), K, 128))
    x = torch.randn((300, K), generator=gen).to(dev, torch.bfloat16)
    full = qm.quant_matmul(x, leaf)
    for M in (1, 7, 16, 17, 64):
        assert torch.equal(qm.quant_matmul(x[:M].contiguous(), leaf),
                           full[:M]), M


def _int8_pool(gen, B, max_pages, page, n_kv, Dh, dev, extra=2):
    NP = B * max_pages + extra
    pools = [torch.randint(-127, 128, (NP, page, n_kv, Dh), generator=gen,
                           dtype=torch.int8).to(dev) for _ in range(2)]
    scales = [(torch.rand((NP, page, n_kv), generator=gen) * 0.05
               + 1e-3).to(dev) for _ in range(2)]
    perm = torch.randperm(NP - 1, generator=gen)[:B * max_pages]
    table = perm.reshape(B, max_pages).to(dev, torch.int32)
    return pools, scales, table, NP


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S,H,n_kv,Dh", [(1, 8, 2, 64), (1, 16, 8, 128),
                                         (3, 8, 2, 64), (3, 4, 4, 128)])
def test_int8_decode_kernel_matches_plain(dev, dtype, S, H, n_kv, Dh):
    gen = torch.Generator().manual_seed(S * 100 + H + Dh + 1)
    B, page, max_pages = 5, 16, 6
    pools, scales, table, _ = _int8_pool(gen, B, max_pages, page, n_kv, Dh,
                                         dev)
    q = torch.randn((B, S, H, Dh), generator=gen).to(dev, dtype)
    lengths = torch.tensor([0, 21, 32, 96, 130], dtype=torch.int32,
                           device=dev)
    lengths[1:] = lengths[1:].clamp_min(S)
    sc = dict(key_scales=scales[0], value_scales=scales[1])
    counts = ops.launch_counts()
    out = pa.paged_attention(q, *pools, table, lengths, **sc)
    ref = pa.paged_attention_plain(q, *pools, table, lengths, **sc)
    after = ops.launch_counts()
    assert after["paged_attention_int8"] == counts["paged_attention_int8"] + 1
    assert after["paged_attention"] == counts["paged_attention"]
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert not out[0].any()
    # rows do not depend on the batch: row 3 alone gives the same bits
    alone = pa.paged_attention(q[3:4], *pools, table[3:4], lengths[3:4],
                               **sc)
    assert torch.equal(alone, out[3:4])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S,H,n_kv,Dh,starts", [
    (1, 8, 2, 64, (5, 16, 31, 0)),
    (33, 16, 8, 128, (64, 0, 100, 0)),
    (70, 4, 4, 128, (0, 33, 5, 0)),
    (13, 8, 2, 64, (7, 15, 0, 0)),
])
def test_int8_prefill_kernels_match_plain(dev, dtype, S, H, n_kv, Dh,
                                          starts):
    gen = torch.Generator().manual_seed(S + H + Dh + 2)
    B, page, max_pages = len(starts), 16, 12
    pools, scales, table, NP = _int8_pool(gen, B, max_pages, page, n_kv, Dh,
                                          dev)
    sink = NP - 1
    table[3] = sink                      # the last row is a pad row
    q = torch.randn((B, S, H, Dh), generator=gen).to(dev, dtype)
    k = torch.randn((B, S, n_kv, Dh), generator=gen).to(dev, dtype)
    v = torch.randn((B, S, n_kv, Dh), generator=gen).to(dev, dtype)
    k[0, 0] = 0.0                        # an all-zero row
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    plain = [t.clone() for t in pools + scales]
    cpu = [t.cpu() for t in pools + scales]
    counts = ops.launch_counts()
    ck, cv = pp._write_pages_int8(k, v, *pools, *scales, table, st)
    pck, pcv = pp.write_pages_plain(k, v, plain[0], plain[1], table, st,
                                    plain[2], plain[3])
    cck, ccv = pp.write_pages_plain(k.cpu(), v.cpu(), cpu[0], cpu[1],
                                    table.cpu(), st.cpu(), cpu[2], cpu[3])
    nonsink = torch.arange(NP, device=dev) != sink
    for got, want, host in zip(pools + scales, plain, cpu):
        assert torch.equal(got[nonsink], want[nonsink])
        assert torch.equal(got[nonsink].cpu(), host[nonsink.cpu()])
    for got, want, host in ((ck, pck, cck), (cv, pcv, ccv)):
        assert torch.equal(got, want) and torch.equal(got.cpu(), host)
    sc = dict(key_scales=scales[0], value_scales=scales[1])
    out = pp._read_attention(q, ck, cv, *pools, table, st, **sc)
    ref = pp.read_attention_plain(q, ck, cv, *pools, table, st, **sc)
    after = ops.launch_counts()
    assert after["page_write_int8"] == counts["page_write_int8"] + 1
    assert after["prefill_read_int8"] == counts["prefill_read_int8"] + 1
    assert after["page_write"] == counts["page_write"]
    torch.testing.assert_close(out[:3].float(), ref[:3].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _kernels_launched(fn):
    """``{kernel name: launches}`` of the CUDA kernels that ``fn()`` runs,
    from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    # the first CUDA profile of a process can drop the records of its
    # first kernels while CUPTI starts up: count from a second profile
    with profile(activities=[ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key: ev.count for ev in prof.key_averages()
            if getattr(ev, "device_type", None)
            == torch.autograd.DeviceType.CUDA}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("S,H,n_kv,Dh", [(1, 16, 8, 128), (3, 8, 2, 64)])
def test_decode_spans_follow_the_occupied_pages(dev, kv, S, H, n_kv, Dh):
    # 8 splits over 16 table pages: rows of 3 pages (fewer than the
    # splits), one token past a page, 13 pages and the full table; the
    # split partials merge in one more launch, repeated launches give the
    # same bits, and each row alone gives its bits in the batch
    gen = torch.Generator().manual_seed(S * 10 + Dh + (kv == "int8"))
    B, page, max_pages = 4, 16, 16
    if kv == "int8":
        pools, scales, table, _ = _int8_pool(gen, B, max_pages, page, n_kv,
                                             Dh, dev)
        sc = dict(key_scales=scales[0], value_scales=scales[1])
    else:
        pk, pv, table, _ = _pool(gen, B, max_pages, page, n_kv, Dh,
                                 torch.bfloat16, dev)
        pools, sc = [pk, pv], {}
    q = torch.randn((B, S, H, Dh), generator=gen).to(dev, torch.bfloat16)
    lengths = torch.tensor([40, 17, 200, 256], dtype=torch.int32,
                           device=dev)
    counts = ops.launch_counts()
    out = pa.paged_attention(q, *pools, table, lengths, **sc)
    key = "paged_attention_int8" if kv == "int8" else "paged_attention"
    assert ops.launch_counts()[key] == counts[key] + 1
    ref = pa.paged_attention_plain(q, *pools, table, lengths, **sc)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[
        torch.bfloat16], rtol=TOL[torch.bfloat16])
    launched = _kernels_launched(
        lambda: pa.paged_attention(q, *pools, table, lengths, **sc))
    decode = {k: n for k, n in launched.items() if "paged_decode" in k}
    assert sorted(decode.values()) == [1, 1], launched
    assert any("combine" in k for k in decode), launched
    again = pa.paged_attention(q, *pools, table, lengths, **sc)
    assert torch.equal(again.view(torch.int16), out.view(torch.int16))
    for b in range(B):
        alone = pa.paged_attention(q[b:b + 1], *pools, table[b:b + 1],
                                   lengths[b:b + 1], **sc)
        assert torch.equal(alone.view(torch.int16),
                           out[b:b + 1].view(torch.int16)), b


@pytest.mark.parametrize("S,H,n_kv,Dh,starts", [
    (100, 8, 2, 128, (130, 200, 77, 0)),
    (70, 16, 4, 64, (193, 131, 64, 0)),
])
def test_int8_prefill_read_runs_on_the_tensor_cores(dev, S, H, n_kv, Dh,
                                                    starts):
    # bf16 activations over an int8 pool: contexts of several 64-key
    # tiles at page 16, starts off the tile, a pad row (row 3, its table
    # all sink), chunks longer than one tile; the new kernel runs once a
    # call, within TOL of the plain version, and repeats its bits
    gen = torch.Generator().manual_seed(S + Dh + 5)
    B, page, max_pages = len(starts), 16, 24
    pools, scales, table, NP = _int8_pool(gen, B, max_pages, page, n_kv, Dh,
                                          dev)
    table[3] = NP - 1
    q = torch.randn((B, S, H, Dh), generator=gen).to(dev, torch.bfloat16)
    ck, cv = (torch.randn((B, S, n_kv, Dh), generator=gen).to(
        dev, torch.bfloat16) for _ in range(2))
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    sc = dict(key_scales=scales[0], value_scales=scales[1])
    counts = ops.launch_counts()
    out = pp._read_attention(q, ck, cv, *pools, table, st, **sc)
    after = ops.launch_counts()
    assert after["prefill_read_int8"] == counts["prefill_read_int8"] + 1
    assert after["prefill_read"] == counts["prefill_read"]
    ref = pp.read_attention_plain(q, ck, cv, *pools, table, st, **sc)
    torch.testing.assert_close(out[:3].float(), ref[:3].float(),
                               atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])
    launched = _kernels_launched(
        lambda: pp._read_attention(q, ck, cv, *pools, table, st, **sc))
    assert [n for k, n in launched.items()
            if "prefill_read_i8_mma_kernel" in k] == [1], launched
    again = pp._read_attention(q, ck, cv, *pools, table, st, **sc)
    assert torch.equal(again.view(torch.int16), out.view(torch.int16))


def test_kv_quantize_on_card_gives_the_cpu_bytes(dev):
    gen = torch.Generator().manual_seed(23)
    x = torch.randn((64, 8, 128), generator=gen) * 3.0
    x[0] = 0.0
    x[1, 0, :4] = torch.tensor([127.0, 2.5, -3.5, 0.5])   # exact ties
    x[1, 0, 4:] = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        t = x.to(dtype)
        a = pp.kv_quantize(t)
        b = pp.kv_quantize(t.to(dev))
        assert torch.equal(a[0], b[0].cpu()) and torch.equal(a[1],
                                                             b[1].cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16],
                         ids=["p32", "p16"])
@pytest.mark.parametrize("N,D", [(1, 64), (300, 1000), (37, 2048),
                                 (5, 8192), (1024, 2048)])
def test_layernorm_kernel_matches_plain(dev, dtype, param_dtype, N, D):
    gen = torch.Generator().manual_seed(N + D)
    x = (torch.randn((N, D), generator=gen) * 2 + 0.5).to(dev, dtype)
    w = (1 + 0.1 * torch.randn(D, generator=gen)).to(dev, param_dtype)
    b = (0.1 * torch.randn(D, generator=gen)).to(dev, param_dtype)
    before = ln._layernorm.launches
    out = ln.fused_layernorm(x, w, b)
    assert ln._layernorm.launches == before + 1
    ref = ln.layernorm_plain(x, w, b)
    assert out.dtype == dtype
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32
           else dict(atol=1e-2, rtol=2 ** -7))
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    # rows do not depend on how many share the call
    for M in (1, min(N, 7)):
        assert torch.equal(ln.fused_layernorm(x[:M].contiguous(), w, b),
                           out[:M])


def test_layernorm_autograd_on_card(dev):
    gen = torch.Generator().manual_seed(29)
    leaves = [t.to(dev).requires_grad_(True) for t in (
        torch.randn((3, 50, 320), generator=gen),
        1 + 0.1 * torch.randn(320, generator=gen),
        0.1 * torch.randn(320, generator=gen))]
    out = ln.fused_layernorm(*leaves)
    want = ln.layernorm_plain(*leaves)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    g = torch.randn(out.shape, generator=gen).to(dev)
    for a, b in zip(torch.autograd.grad(out, leaves, g),
                    torch.autograd.grad(want, leaves, g)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


_LN_DTYPES = [pytest.param(x, p, id=f"{xn}-{pn}")
              for x, xn in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
              for p, pn in ((torch.float32, "p32"), (torch.bfloat16, "p16"))]


@pytest.mark.parametrize("dtype,param_dtype", _LN_DTYPES)
@pytest.mark.parametrize("D", [64, 100, 1000, 2048, 8192])
def test_layernorm_rows_keep_their_bits_at_every_n(dev, dtype, param_dtype,
                                                   D):
    # every layout branch (16-byte chunks and single values; rows of 8 to
    # 256 threads): within the tolerance of the plain version at N 1024,
    # and each row's bits the same at N 1, 8 and 1024
    gen = torch.Generator().manual_seed(D + 7)
    x = (torch.randn((1024, D), generator=gen) * 2 + 0.5).to(dev, dtype)
    w = (1 + 0.1 * torch.randn(D, generator=gen)).to(dev, param_dtype)
    b = (0.1 * torch.randn(D, generator=gen)).to(dev, param_dtype)
    before = ln._layernorm.launches
    full = ln.fused_layernorm(x, w, b)
    ref = ln.layernorm_plain(x, w, b)
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32
           else dict(atol=1e-2, rtol=2 ** -7))
    torch.testing.assert_close(full.float(), ref.float(), **tol)
    for N in (1, 8):
        part = ln.fused_layernorm(x[:N].contiguous(), w, b)
        torch.testing.assert_close(part.float(), ref[:N].float(), **tol)
        assert torch.equal(part.view(-1).view(torch.uint8),
                           full[:N].reshape(-1).view(torch.uint8)), N
    assert ln._layernorm.launches == before + 3


@pytest.mark.parametrize("D", [100, 2048])
def test_layernorm_realigns_misaligned_views(dev, D):
    # buf[1:] of a bf16 buffer starts 2 bytes off 16: the wrapper runs the
    # kernel on an aligned copy and gives that copy's bits
    gen = torch.Generator().manual_seed(D)
    buf = torch.randn(37 * D + 1, generator=gen).to(dev, torch.bfloat16)
    x = buf[1:].view(37, D)
    assert x.data_ptr() % 16
    w = (1 + 0.1 * torch.randn(D, generator=gen)).to(dev, torch.bfloat16)
    b = (0.1 * torch.randn(D, generator=gen)).to(dev, torch.bfloat16)
    got = ln.fused_layernorm(x, w, b)
    want = ln.fused_layernorm(x.clone(), w, b)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    launched = _kernels_launched(lambda: ln.fused_layernorm(x, w, b))
    assert [n for k, n in launched.items() if "layernorm_kernel" in k] == [1]


def _write_case(gen, dtype, B, S, n_kv, Dh, page, starts, dev, int8):
    """A chunk, a pool (int8 with scales, or float) whose table is a
    permutation of its pages but the sink (the last page), and one table
    entry of row 1 out of the pool's range (its stores drop)."""
    max_pages = max(starts) // page + (S - 1) // page + 2
    NP = B * max_pages + 2
    k, v = (torch.randn((B, S, n_kv, Dh), generator=gen).to(dev, dtype)
            for _ in range(2))
    if int8:
        pools = [torch.randint(-127, 128, (NP, page, n_kv, Dh),
                               generator=gen, dtype=torch.int8).to(dev)
                 for _ in range(2)]
        pools += [(torch.rand((NP, page, n_kv), generator=gen) * 0.05
                   + 1e-3).to(dev) for _ in range(2)]
    else:
        pools = [torch.randn((NP, page, n_kv, Dh), generator=gen).to(
            dev, dtype) for _ in range(2)]
    perm = torch.randperm(NP - 1, generator=gen)[:B * max_pages]
    table = perm.reshape(B, max_pages).to(dev, torch.int32)
    table[1, starts[1] // page] = NP + 3
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    return k, v, pools, table, st


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,n_kv,Dh,page,starts", [
    # decode steps of 16 rows: positions at offset 0 and page - 1
    # (logical pages up to 36: table entries past the first 32 lanes)
    pytest.param(16, 1, 8, 128, 64, tuple(576 * (i % 5) + 63 * (i % 2)
                                          for i in range(16)), id="decode"),
    pytest.param(16, 1, 2, 64, 16, tuple(96 * (i % 7) + 15 * (i % 2)
                                         for i in range(16)),
                 id="decode-d64"),
    # prefill chunks of 4 rows a warp (8192 and 4227 kv rows, the second
    # with a ragged last warp), starts straddling pages
    pytest.param(4, 256, 8, 128, 64, (2000, 63, 0, 5), id="prefill"),
    pytest.param(3, 1409, 1, 64, 16, (15, 0, 33), id="prefill-ragged"),
])
def test_int8_page_write_matches_plain_bitwise(dev, dtype, B, S, n_kv, Dh,
                                               page, starts):
    gen = torch.Generator().manual_seed(B * S + Dh)
    k, v, pools, table, st = _write_case(gen, dtype, B, S, n_kv, Dh, page,
                                         starts, dev, int8=True)
    plain = [t.clone() for t in pools]
    cpu = [t.cpu() for t in pools]
    counts = ops.launch_counts()
    ck, cv = pp._write_pages_int8(k, v, *pools, table, st)
    assert ops.launch_counts()["page_write_int8"] == (
        counts["page_write_int8"] + 1)
    pck, pcv = pp.write_pages_plain(k, v, plain[0], plain[1], table, st,
                                    plain[2], plain[3])
    cck, ccv = pp.write_pages_plain(k.cpu(), v.cpu(), cpu[0], cpu[1],
                                    table.cpu(), st.cpu(), cpu[2], cpu[3])
    # the whole pools: no row writes the sink, and the out-of-range page's
    # stores drop on every side
    for got, want, host in zip(pools, plain, cpu):
        assert torch.equal(got, want) and torch.equal(got.cpu(), host)
    # the dequantised chunk is written for every row, dropped page or not
    for got, want, host in ((ck, pck, cck), (cv, pcv, ccv)):
        assert torch.equal(got, want) and torch.equal(got.cpu(), host)


@pytest.mark.parametrize("S", [1, 7, 256])
@pytest.mark.parametrize("dtype,n_kv,Dh", [
    (torch.bfloat16, 8, 128), (torch.float32, 8, 128),
    (torch.bfloat16, 1, 64), (torch.float32, 3, 64)],
    ids=["bf16-8x128", "f32-8x128", "bf16-1x64", "f32-3x64"])
def test_page_write_kernel_matches_plain_off_the_sink(dev, S, dtype, n_kv,
                                                      Dh):
    # row bytes of 128 to 4096 (one or two passes of a warp's 16-byte
    # chunks), starts straddling a page, logical pages past 32, a pad row
    # whose table is all sink (row 3) and an out-of-range page id (row 1)
    gen = torch.Generator().manual_seed(S * 10 + Dh + n_kv)
    page = 64
    k, v, (pk, pv), table, st = _write_case(
        gen, dtype, 4, S, n_kv, Dh, page, (60, 2040, 127, 5), dev,
        int8=False)
    NP = pk.shape[0]
    table[3] = NP - 1
    pk2, pv2 = pk.clone(), pv.clone()
    counts = ops.launch_counts()
    pp._write_pages(k, v, pk, pv, table, st)
    assert ops.launch_counts()["page_write"] == counts["page_write"] + 1
    pp.write_pages_plain(k, v, pk2, pv2, table, st)
    nonsink = torch.arange(NP, device=dev) != NP - 1
    assert torch.equal(pk[nonsink], pk2[nonsink])
    assert torch.equal(pv[nonsink], pv2[nonsink])


@pytest.mark.parametrize("variant", ["int8_kv", "fused_ln"])
def test_slice4_generate_on_card_matches_cpu(dev, variant):
    # f32 on both sides: the card runs the int8 kv branch of kernels 1-3
    # (or kernel 11 and kernels 1-3), the CPU their plain versions
    cfg = dict(vocab_size=128, d_model=256, n_heads=4, n_kv_heads=2,
               n_layers=2, d_ff=512, max_seq_len=128, dtype="float32",
               rope=True, norm_type="layernorm",
               fused_ln=variant == "fused_ln")
    kv = "int8" if variant == "int8_kv" else None
    cpu = port_tf.build_transformer(**cfg).eval()
    cpu.reset_parameters(torch.Generator().manual_seed(3))
    card = port_tf.build_transformer(**cfg).eval()
    card.load_state_dict(cpu.state_dict())
    card.to(dev)
    prompt = [[5, 17, 99, 3, 42, 8, 1, 77, 64, 12, 9, 30, 2, 2, 101]]
    ops.reset_launch_counts()
    with torch.no_grad():
        want = port_decode.generate(cpu, prompt, 12, device="cpu",
                                    kv_dtype=kv)
        got = port_decode.generate(card, prompt, 12, device=dev, kv_dtype=kv)
    assert got.cpu().tolist() == want.tolist()
    names = (ops.SERVING_KERNELS_INT8_KV if kv
             else ops.SERVING_KERNELS + ("layernorm",))
    assert min(ops.launch_counts(names).values()) >= 1
