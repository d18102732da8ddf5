"""The port's int8 kv pools against the JAX package, on the CPU.

- :func:`kv_quantize` / :func:`kv_dequantize` (the port's single copy of
  ``models/transformer._kv_quantize`` and ``ops/paged_prefill._quantize``)
  give the JAX functions' bytes bit for bit, exact .5 ties (round half to
  even) and all-zero rows (the 1e-12 floor) included, in f32 and bf16.
- The int8 branch of ``paged_attention`` and of ``paged_prefill`` on CPU
  tensors (the plain versions) against the JAX Pallas kernels in
  interpret mode: ragged lengths with an empty row; fresh, aligned and
  unaligned starts, a chunk wider than two pages, bucket-pad overshoot
  and a pad row.  Pool payload and scales must be bit-equal off the sink
  page (whose bytes are garbage by contract); outputs within 1e-5 (f32
  on both sides, summation order differs).
- The paged slot path over an int8 pool against the JAX package's
  (``init_paged_slot_cache(kv_dtype="int8")`` with its reference bodies):
  greedy tokens equal, logits within 1e-4 (f32, two layers of width 64).
- ``--generate_kv_dtype int8`` over HTTP (alone and with
  ``--generate_quantize int8``): a concurrent burst decodes the port's
  solo ``generate(kv_dtype="int8")`` tokens, the generate stats report
  the kv dtype and the pool's bytes, and the quiesced pool conserves its
  pages.
"""
import importlib
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu.models import decode as jax_decode
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import convert, export, quantize, serve
from tensorflowonspark_tpu_torch.models import decode as port_decode
from tensorflowonspark_tpu_torch.models import transformer as port_tf
from tensorflowonspark_tpu_torch.ops import paged_attention as port_pa
from tensorflowonspark_tpu_torch.ops import paged_prefill as port_pp
from test_torch_paged_attention import decode_split_order

# the JAX ops package binds its kernel functions under the submodules'
# names, so the submodules are fetched by their full names
jax_pa = importlib.import_module("tensorflowonspark_tpu.ops.paged_attention")
jax_pp = importlib.import_module("tensorflowonspark_tpu.ops.paged_prefill")

ATOL = RTOL = 1e-5
LOGIT_TOL = 1e-4


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _tricky_rows(rng, dtype):
    """[3, 2, 16] kv rows: random, all zero, and one whose amax is 127
    (scale exactly 1) holding exact .5 ties of both signs."""
    x = rng.randn(3, 2, 16).astype(np.float32) * 3.0
    x[1] = 0.0
    x[2, 0] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5, 4.5,
               0.0, 6.5, -7.5, 8.25, 9.5, -10.5, 11.5, -12.5]
    x[2, 1] = x[2, 0][::-1]
    t = torch.from_numpy(x).to(dtype)
    return t, jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kv_quantize_is_bit_identical_to_jax(dtype):
    t, j = _tricky_rows(np.random.RandomState(0), dtype)
    q8, sc = port_pp.kv_quantize(t)
    for jax_fn in (jax_tf._kv_quantize, jax_pp._quantize):
        jq, jsc = jax_fn(j)
        np.testing.assert_array_equal(q8.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_bits(sc.numpy()), _bits(jsc))
    # round half to even on the exact ties
    assert q8[2, 0, 1:8].tolist() == [2, -4, 0, 0, 2, -126, 4]
    assert not q8[1].any()
    jdeq = jax_tf._kv_dequantize(jnp.asarray(q8.numpy()),
                                 jnp.asarray(sc.numpy()), j.dtype)
    deq = port_pp.kv_dequantize(q8, sc, dtype)
    np.testing.assert_array_equal(_bits(deq.float().numpy()),
                                  _bits(np.asarray(jdeq, np.float32)))


def _int8_pool(rng, NP, page, n_kv, Dh):
    payload = [rng.randint(-127, 128, (NP, page, n_kv, Dh)).astype(np.int8)
               for _ in range(2)]
    scales = [(rng.rand(NP, page, n_kv) * 0.05 + 1e-3).astype(np.float32)
              for _ in range(2)]
    return payload, scales


DECODE_CASES = {
    "gqa-s1": dict(B=4, S=1, H=4, n_kv=2, lengths=[0, 9, 16, 32]),
    "mha-s1": dict(B=4, S=1, H=4, n_kv=4, lengths=[0, 9, 16, 32]),
    "gqa-s3": dict(B=4, S=3, H=4, n_kv=2, lengths=[0, 11, 20, 32]),
}


def _int8_decode_case(seed, B, S, H, n_kv, lengths, max_pages=4, page=8,
                      Dh=16):
    """q, an int8 pool and its scales, a shuffled table whose unoccupied
    entries name the last pool page, and the lengths."""
    rng = np.random.RandomState(seed)
    NP = B * max_pages + 3
    q = rng.randn(B, S, H, Dh).astype(np.float32)
    (pk, pv), (ks, vs) = _int8_pool(rng, NP, page, n_kv, Dh)
    perm = rng.permutation(NP - 1)
    table = np.full((B, max_pages), NP - 1, np.int32)
    off = 0
    for b, n in enumerate(lengths):
        used = -(-n // page)
        table[b, :used] = perm[off:off + used]
        off += used
    return (q, pk, pv, table, np.asarray(lengths, np.int32)), (ks, vs)


def _jax_decode(args, ks, vs):
    return np.asarray(jax_pa.paged_attention(
        *[jnp.asarray(a) for a in args], interpret=True,
        key_scales=jnp.asarray(ks), value_scales=jnp.asarray(vs)))


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_int8_paged_attention_matches_jax_kernel(name):
    args, (ks, vs) = _int8_decode_case(len(name), **DECODE_CASES[name])
    out = port_pa.paged_attention(
        *[torch.from_numpy(a) for a in args],
        key_scales=torch.from_numpy(ks), value_scales=torch.from_numpy(vs))
    kernel = _jax_decode(args, ks, vs)
    ref = np.asarray(jax_pa.paged_attention_reference(
        *[jnp.asarray(a) for a in args], key_scales=jnp.asarray(ks),
        value_scales=jnp.asarray(vs)))
    np.testing.assert_allclose(out.numpy(), kernel, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    assert not out[0].any()          # the empty row is exact zeros


DECODE_ORDER_CASES = dict(DECODE_CASES, **{
    # 8 splits over 8 table pages: rows of 1, 2 and 8 pages
    "short-rows": dict(B=3, S=1, H=4, n_kv=2, lengths=[5, 12, 64],
                       max_pages=8)})


@pytest.mark.parametrize("name", list(DECODE_ORDER_CASES))
def test_int8_decode_order_of_work_matches_jax_kernel(name):
    """Kernel 1's order of work over an int8 pool (occupied-page splits,
    one softmax update per token tile, scales folded into the f32
    products; ``decode_split_order``) against the JAX kernel in interpret
    mode: it differs only in the order and rounding of f32 sums."""
    args, (ks, vs) = _int8_decode_case(len(name) + 7,
                                       **DECODE_ORDER_CASES[name])
    got = decode_split_order(*[torch.from_numpy(a) for a in args],
                             key_scales=torch.from_numpy(ks),
                             value_scales=torch.from_numpy(vs), tile=16)
    np.testing.assert_allclose(got.numpy(), _jax_decode(args, ks, vs),
                               atol=ATOL, rtol=RTOL)
    assert not got[args[4] == 0].any()


def _prefill_case(seed, H, n_kv, S=12, page=8, max_pages=4, Dh=16,
                  starts=(0, 8, 12, 0), pad_rows=(3,), valid=None):
    """A ragged burst over an int8 pool; live rows map ceil((start +
    valid) / page) shuffled pages, the rest of their table (and a pad
    row's whole table) names the sink, the last pool page."""
    rng = np.random.RandomState(seed)
    B = len(starts)
    valid = valid or [S] * B
    NP = B * max_pages + 3
    q = rng.randn(B, S, H, Dh).astype(np.float32)
    k = rng.randn(B, S, n_kv, Dh).astype(np.float32)
    v = rng.randn(B, S, n_kv, Dh).astype(np.float32)
    k[0, 1] = 0.0                     # an all-zero row: the 1e-12 floor
    (pk, pv), (ks, vs) = _int8_pool(rng, NP, page, n_kv, Dh)
    sink = NP - 1
    perm = rng.permutation(NP - 1)
    table = np.full((B, max_pages), sink, np.int32)
    off = 0
    for b, st in enumerate(starts):
        if b in pad_rows:
            continue
        used = min(max_pages, -(-(st + valid[b]) // page))
        table[b, :used] = perm[off:off + used]
        off += used
    return ((q, k, v, pk, pv, table, np.asarray(starts, np.int32)),
            (ks, vs), sink, [b for b in range(B) if b not in pad_rows])


PREFILL_CASES = {
    # fresh (0), page-aligned (8) and straddling (12) starts; a pad row
    "burst-gqa": dict(seed=0, H=4, n_kv=2),
    "burst-mha": dict(seed=1, H=4, n_kv=4),
    # S=20 > 2 pages, one row starting mid-page
    "wide-unaligned": dict(seed=2, H=4, n_kv=2, S=20, starts=(0, 7),
                           pad_rows=()),
    # row 0 holds 3 real tokens at start 12 in a 12-wide bucket:
    # positions 16..23 run past its 2 mapped pages into the sink
    "overshoot": dict(seed=3, H=4, n_kv=2, starts=(12, 0), pad_rows=(),
                      valid=[3, 12]),
}


@pytest.mark.parametrize("name", list(PREFILL_CASES))
def test_int8_paged_prefill_matches_jax_kernel(name):
    args, (ks, vs), sink, live = _prefill_case(**PREFILL_CASES[name])
    jout, jpools = jax_pp.paged_prefill(
        *[jnp.asarray(a) for a in args], key_scales=jnp.asarray(ks),
        value_scales=jnp.asarray(vs), interpret=True)
    t = [torch.from_numpy(a.copy()) for a in args]
    tks, tvs = torch.from_numpy(ks.copy()), torch.from_numpy(vs.copy())
    out, pools = port_pp.paged_prefill(*t, key_scales=tks, value_scales=tvs)
    assert pools[0] is t[3] and pools[2] is tks     # updated in place
    nonsink = np.arange(ks.shape[0]) != sink
    for got, want in zip(pools, jpools):
        np.testing.assert_array_equal(_bits(got.numpy()[nonsink]),
                                      _bits(np.asarray(want)[nonsink]))
    np.testing.assert_allclose(out.numpy()[live], np.asarray(jout)[live],
                               atol=ATOL, rtol=RTOL)


def _i8_tensor_core_read(q, ck, cv, pk, pv, ks, vs, table, starts,
                         tile=64):
    """The arithmetic of kernel 3's int8-pool read on the tensor cores
    (csrc/paged_prefill.cu ``prefill_read_i8_mma_kernel``), emulated in
    torch: 64-key tiles, first the row's context (keys j < start, read
    through the table and clipped into the pool), then the chunk's own;
    scores = (bf16 q . exact-bf16 int8 payload, f32 sums) x (k_scale x
    sm_scale x log2 e), in log2 units; f32 running max and sum; l from
    the f32 p; p x v_scale rounded to f16 before the product with the
    payload (f32 sums); the chunk tiles with scale 1 and p rounded to
    bf16 (the bf16-pool kernel's rounding); out rounded to bf16.
    Returns ``[B, S, H, Dh]`` bf16."""
    B, S, H, Dh = q.shape
    NP, page, n_kv, _ = pk.shape
    max_pages = table.shape[1]
    group = H // n_kv
    rows = S * group
    scale2 = Dh ** -0.5 * np.log2(np.e)
    neg = port_pa.NEG_INF
    out = torch.empty(B, S, H, Dh, dtype=torch.bfloat16)
    for b in range(B):
        n_ctx = min(int(starts[b]), max_pages * page)
        j = torch.arange(n_ctx)
        phys = table[b, j // page].long().clamp(0, NP - 1)
        ctx = [(pk[phys, j % page].float(), ks[phys, j % page],
                pv[phys, j % page].float(), vs[phys, j % page], None,
                torch.float16)]
        r = torch.arange(rows)
        jc = torch.arange(S)
        ones = torch.ones(S, n_kv)
        chunk = [(ck[b].float(), ones, cv[b].float(), ones,
                  jc[None, :] <= (r // group)[:, None], torch.bfloat16)]
        for h in range(n_kv):
            qh = q[b, :, h * group:(h + 1) * group].reshape(rows, Dh).float()
            m = torch.full((rows,), neg)
            l = torch.zeros(rows)
            o = torch.zeros(rows, Dh)
            for k, ksc, v, vsc, mask, p_dtype in ctx + chunk:
                for k0 in range(0, k.shape[0], tile):
                    sl = slice(k0, k0 + tile)
                    s = (qh @ k[sl, h].T) * (ksc[sl, h] * scale2)[None]
                    if mask is not None:
                        s = torch.where(mask[:, sl], s, torch.tensor(neg))
                    mn = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp2(m - mn)
                    p = torch.exp2(s - mn[:, None])
                    l = l * alpha + p.sum(-1)
                    p = (p * vsc[sl, h][None]).to(p_dtype).float()
                    o = o * alpha[:, None] + p @ v[sl, h]
                    m = mn
            o = (o / l.clamp_min(1e-30)[:, None]).bfloat16()
            out[b, :, h * group:(h + 1) * group] = o.reshape(S, group, Dh)
    return out


@pytest.mark.parametrize("Dh", [64, 128])
def test_int8_tensor_core_read_fits_the_tolerance(Dh):
    """Kernel 3's int8-pool read on the tensor cores rounds one thing the
    JAX kernel keeps in f32: p x v_scale, to f16 before the product with
    the payload (and, over the chunk, p to bf16, as the bf16-pool kernel
    does).  Its emulation
    (``_i8_tensor_core_read``) stays within the card tests' bf16 TOL
    (atol = rtol = 1e-2) of JAX ``_read_attention`` in interpret mode, on
    bf16 activations over an int8 pool: a shuffled table, page 16, starts
    130 and 77 (not multiples of the 64-key tile; contexts of 3 and 2
    tiles), a fresh row, a chunk of 80 (two tiles), GQA group 2.  The
    largest |error| / (atol + rtol |ref|) is 0.62 at Dh 128 and 0.63 at
    Dh 64: one bf16 step of an output just above 4 (the plain version
    itself is one step off at 0.44 / 0.46).  Rounding p x v_scale to
    bf16 instead gave 1.01 at Dh 64: an error of |v| x 2^-9 on an output
    near 0, where the int8 pool's values reach +-6."""
    rng = np.random.RandomState(300 + Dh)
    B, S, H, n_kv, page = 3, 80, 4, 2, 16
    starts = np.asarray([130, 77, 0], np.int32)
    max_pages = -(-(int(starts.max()) + S) // page)
    NP = B * max_pages + 2
    (pk, pv), (ks, vs) = _int8_pool(rng, NP, page, n_kv, Dh)
    table = rng.permutation(NP - 1)[:B * max_pages].reshape(
        B, max_pages).astype(np.int32)
    q, ck, cv = (torch.from_numpy(rng.randn(B, S, h, Dh).astype(
        np.float32)).bfloat16() for h in (H, n_kv, n_kv))
    want = np.asarray(jax_pp._read_attention(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, ck, cv)),
        jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(table), jnp.asarray(starts), sm_scale=Dh ** -0.5,
        interpret=True), np.float32)
    got = _i8_tensor_core_read(
        q, ck, cv, *(torch.from_numpy(a) for a in (pk, pv, ks, vs, table)),
        starts)
    assert got.dtype == torch.bfloat16
    share = (np.abs(got.float().numpy() - want)
             / (1e-2 + 1e-2 * np.abs(want))).max()
    assert share < 1.0, share
    # the same inputs through the port's plain version
    plain = port_pp.read_attention_plain(
        q, ck, cv, *(torch.from_numpy(a) for a in (pk, pv, table, starts)),
        key_scales=torch.from_numpy(ks), value_scales=torch.from_numpy(vs))
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               atol=1e-2, rtol=1e-2)


def _pair(seed, **kw):
    cfg = dict(vocab_size=96, d_model=64, n_heads=4, n_kv_heads=2,
               n_layers=2, d_ff=128, max_seq_len=64, dtype="float32",
               rope=True, norm_type="rmsnorm", **kw)
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**cfg))
    params = jm.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    pm = port_tf.build_transformer(**cfg)
    pm.load_state_dict(convert.params_from_jax(params), strict=True)
    return cfg, jm, params, pm.eval()


def test_int8_paged_slot_path_matches_jax_slot_path():
    _, jm, params, pm = _pair(4)
    n_slots, page, per_row = 3, 8, 4
    n_pages = n_slots * per_row + 1
    sink = n_pages - 1
    slot_model, jcache = jax_decode.init_paged_slot_cache(
        jm, n_slots, page, n_pages, kv_dtype="int8",
        paged_attn_impl="einsum", paged_prefill_impl="blend")
    _, pcache = port_decode.init_paged_slot_cache(pm, n_slots, page, n_pages,
                                                  kv_dtype="int8")
    assert pcache.pages_key[0].dtype == torch.int8
    assert pcache.key_scales[0].shape == (n_pages, page, 2)
    set_table = jax_decode._jitted_set_row_page_table(slot_model)
    width = 64 // page
    for row in range(n_slots):
        pages = list(range(row * per_row, (row + 1) * per_row))
        entries = pages + [sink] * (width - per_row)
        jcache = set_table(jcache, jnp.asarray(row, jnp.int32),
                           jnp.asarray(entries, jnp.int32))
        port_decode.set_row_page_table(pcache, row, entries)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 96, n).tolist() for n in (12, 15, 12)]
    prefill = jax_decode._jitted_slot_prefill_many(slot_model)
    # fresh rows at start 0, then the rows continue from starts 5, 8, 3
    cuts = (5, 8, 3)
    rounds = [[(r, prompts[r][:cuts[r]], 0) for r in range(n_slots)],
              [(r, prompts[r][cuts[r]:], cuts[r]) for r in range(n_slots)]]
    for entries in rounds:
        bucket = max(8, 1 << (max(len(c) for _, c, _ in entries)
                              - 1).bit_length())
        jargs = jax_decode.build_prefill_batch(entries, 4, bucket, n_slots)
        jlast, jcache = prefill(params, jcache, *jargs,
                                jnp.asarray(sink, jnp.int32))
        pargs = port_decode.build_prefill_batch(entries, 4, bucket, n_slots,
                                                "cpu")
        with torch.no_grad():
            plast = port_decode.slot_prefill_many(pm, pcache, *pargs, sink)
        np.testing.assert_allclose(plast.numpy()[:n_slots],
                                   np.asarray(jlast)[:n_slots],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)

    @jax.jit
    def jstep(cache, toks):
        logits, mut = slot_model.apply({"params": params, "cache": cache},
                                       toks[:, None], mutable=["cache"])
        return logits[:, -1], mut["cache"]

    jtok = jnp.argmax(jlast[:n_slots], axis=-1)
    ptok = torch.argmax(plast[:n_slots], dim=-1)
    for _ in range(8):
        assert ptok.tolist() == np.asarray(jtok).tolist()
        jl, jcache = jstep(jcache, jtok)
        with torch.no_grad():
            pl = pm(ptok[:, None], pcache)[:, -1]
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        jtok = jnp.argmax(jl, axis=-1)
        ptok = torch.argmax(pl, dim=-1)
    assert ptok.tolist() == np.asarray(jtok).tolist()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("weights", ["none", "int8"])
def test_http_int8_kv_matches_solo_generate(weights, tmp_path):
    cfg, _, _, pm = _pair(7)
    export.export_saved_model(str(tmp_path), pm.state_dict(),
                              builder_kwargs=cfg)
    ref = pm
    if weights != "none":
        quantize.quantize_module(ref, weights)
    prompts = [[5, 9, 2, 40, 7], list(range(3, 22)), [11, 3, 60, 8, 1, 2]]
    with torch.no_grad():
        want = [port_decode.generate(ref, [p], 6, device="cpu",
                                     kv_dtype="int8")[0].tolist()
                for p in prompts]
    args = serve.build_argparser().parse_args([
        "--export_dir", str(tmp_path), "--port", "0", "--device", "cpu",
        "--generate_kv_page_size", "8", "--generate_kv_pages", "24",
        "--generate_prefill_chunk", "8", "--generate_slots", "4",
        "--generate_kv_dtype", "int8", "--generate_quantize", weights])
    server, service = serve.make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}/v1/models/default"
    try:
        outs = [None] * len(prompts)

        def client(i):
            outs[i] = _post(base + ":generate", {
                "inputs": [prompts[i]], "max_new_tokens": 6})["outputs"][0]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert outs == want
        with urllib.request.urlopen(base, timeout=60) as resp:
            meta = json.loads(resp.read())["model"]
        stats = meta["generate_stats"]
        assert stats["kv_dtype"] == "int8"
        # 2 layers x (k, v) x 25 pages x 8 x 2 kv heads x (16 B + 4 B)
        assert stats["kv_pool_bytes"] == 2 * 2 * 25 * 8 * 2 * (16 + 4)
        assert set(stats["kernel_launches"]) >= {
            "paged_attention_int8", "page_write_int8", "prefill_read_int8"}
        batcher = service.generate_service().batcher
        free = list(batcher._free_pages)
        # the prefix cache keeps full prompt pages at refcount 0
        cached = list(batcher._prefix.values())
        owned = [p for pages in batcher._row_pages if pages for p in pages
                 if p not in batcher._page_rc]
        assert len(set(free)) == len(free) and batcher._sink not in free
        assert sorted(free + owned + cached) == list(
            range(batcher._total_pages))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
