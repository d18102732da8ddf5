"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips (with a reason) where no CUDA device
exists, so on the CPU tier they count as skips.  On a machine with the
card and the CUDA toolkit (no JAX needed; the repo's conftest imports
JAX, so skip it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes are small and deliberately awkward (head_dim 64 and 128, GQA
groups of 1 to 4, S=1 and S=3 decode, chunks that straddle pages and
tiles, empty rows, rows past the table, pad rows), in f32 and bf16.
Tolerances: f32 1e-4 (f32 math on both sides, summation order differs
over <= 300 keys); bf16 1e-2 (f32 math, bf16 output rounding).
"""
import pytest
import torch

from tensorflowonspark_tpu_torch import ops
from tensorflowonspark_tpu_torch.models import decode as port_decode
from tensorflowonspark_tpu_torch.models import transformer as port_tf
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
    assert min(ops.launch_counts().values()) >= 1
