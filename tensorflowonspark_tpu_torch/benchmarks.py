"""Shared benchmark definitions of the port: the card's bf16 peak, the
flagship configurations the port is sized against (copies of the JAX
package's ``benchmarks`` dicts, key for key; the port imports nothing
from that package), and the workload builders a harness times.

Every builder keeps the JAX function's name, defaults and return tuple
and adds two keywords: ``device`` (``cuda`` unless the caller asks for
the CPU, ``device.resolve``: it raises without CUDA) and ``config``, a
dict of ``TransformerConfig`` fields that replaces ``FLAGSHIP_LM_V2``
(small models for the CPU tests; the default is the full 0.87B
flagship).  Parameters are f32 masters with bf16 compute (``Dense``
casts), random from ``torch.Generator(device).manual_seed(0)`` (the
speculation draft: seed 1); prompts come from ``np.random.RandomState(0)``
in the JAX builders' order, so both packages build the same prompt
lists.  The JAX builders' ``impl`` switches to a plain read path
("einsum", "blend") raise ``ValueError``: the port's kernel wrappers take
no switch, as its server's flags do not.

The builders, by the harness segment they serve:

- :func:`make_flagship_step` — training step ms and MFU;
- :func:`make_decode_step` — one paged decode step of 16 slots
  (kernel 1; kernels 9 / 10 with ``quantize``);
- :func:`make_qmm_op` — one quantised projection matmul (kernels 9, 10);
- :func:`make_prefill_chunk_step` — one batched paged prefill chunk
  (kernels 2, 3);
- the batcher bursts, each a ``serve.ContinuousBatcher`` with the JAX
  builder's arguments and its prompts: :func:`make_prefill_burst`
  (TTFT), :func:`make_engine_burst` (engine tokens/s),
  :func:`make_spec_burst` (speculation), :func:`make_migrate_pair`
  (kv migration), :func:`make_sched_burst` (preemption),
  :func:`make_warm_burst` (the host page tier), :func:`make_job_burst`
  (bulk jobs) and :func:`make_long_burst` (a 32,768-token prompt
  through the mega-prompt lane).  The caller stops every batcher.

The JAX package's ``ROUND1_LM_MFU`` (47.0) is a TPU v5e figure and is
not carried: the port states no TPU number.
"""

# dense bf16 tensor-core peaks by substring of the CUDA device name
# (``torch.cuda.get_device_name``): NVIDIA's public H100 sheet, half its
# with-sparsity figures, rounded down to whole TFLOP/s
PEAK_BF16 = {
    "H100 80GB HBM3": 989e12,      # H100 SXM5
    "H100 SXM": 989e12,
    "H100 NVL": 835e12,
    "H100 PCIe": 756e12,
}


def bf16_peak(device_name):
    """Peak dense bf16 FLOP/s for a CUDA device name, or None if unknown
    — callers must NOT substitute a default: an MFU or a bound against
    the wrong peak is a made-up number."""
    return next((v for k, v in PEAK_BF16.items() if k in device_name), None)


# 0.87B decoder LM: RoPE, GQA 16 q / 8 kv heads (head_dim 128), bf16
FLAGSHIP_LM = dict(
    vocab_size=32000, d_model=2048, n_heads=16, n_kv_heads=8,
    n_layers=16, d_ff=8192, max_seq_len=1024, dtype="bfloat16",
    rope=True, attention_impl="auto")
# the same dims with RMSNorm: the configuration the port serves
FLAGSHIP_LM_V2 = dict(FLAGSHIP_LM, norm_type="rmsnorm")
# its MoE variant: every 2nd layer (8 of 16) 8 experts, top-2 routing at
# capacity 1.25 (about 2.75 B parameters)
FLAGSHIP_MOE = dict(FLAGSHIP_LM_V2, num_experts=8, moe_every=2,
                    moe_router="topk", moe_top_k=2,
                    moe_capacity_factor=1.25)
# the flagship training step: batch 8 x max_seq_len tokens, the
# single-pass fused AdamW with a bf16 first moment
FLAGSHIP_BATCH = 8
FLAGSHIP_MU_DTYPE = "bfloat16"
FLAGSHIP_OPTIMIZER = "adamw_fused"
_CONFIGS = {"v2": FLAGSHIP_LM_V2, "v1": FLAGSHIP_LM, "moe": FLAGSHIP_MOE}

# steady-state paged decode: 16 slots, page 64, rows filled to 2000 of
# 4096 (long max_seq, rows partly filled: kernel 1's per-row length
# bound is what the step prices)
FLAGSHIP_DECODE = dict(n_slots=16, page_size=64, max_seq=4096, fill=2000)
# one decode-shaped projection matmul on the flagship's widest kernel,
# wi (d_model 2048 -> d_ff 8192), a decode batch of 16 rows; int4 groups
# of 128.  Decode matmuls are weight-read-bound, so the stores' bytes
# (qmm_weight_bytes) price the step
FLAGSHIP_QMM = dict(rows=16, in_dim=2048, out_dim=8192, group_size=128)
# steady-state batched paged prefill: 4 rows, chunk 256 at offset 2000
# (not page-aligned: the chunk straddles pages)
FLAGSHIP_PREFILL_KERNEL = dict(n_slots=4, page_size=64, max_seq=4096,
                               fill=2000, chunk=256)
# kernels 9 and 10 at FLAGSHIP_QMM's projection, at its decode rows and
# at a FLAGSHIP_PREFILL_KERNEL dispatch (4 rows x 256 tokens): the same
# shape under chip_smoke's keys
FLAGSHIP_QUANT_MATMUL = dict(
    K=FLAGSHIP_QMM["in_dim"], N=FLAGSHIP_QMM["out_dim"],
    decode_m=FLAGSHIP_QMM["rows"],
    prefill_m=FLAGSHIP_PREFILL_KERNEL["n_slots"]
    * FLAGSHIP_PREFILL_KERNEL["chunk"],
    group_size=FLAGSHIP_QMM["group_size"])
# a burst of 8 distinct 768-token prompts admitted through batched
# prefill (prefill_rows 4) on the dense slot cache: TTFT
FLAGSHIP_PREFILL = dict(n_slots=8, prompts=8, prompt_len=768, max_new=2,
                        prefill_chunk=256, prefill_rows=4, max_seq=1024)
# sustained decode through the whole batcher: short prompts, long
# generations (the engine's host / device overlap)
FLAGSHIP_ENGINE = dict(n_slots=8, prompts=16, prompt_len=64, max_new=96,
                       prefill_chunk=256, prefill_rows=4, max_seq=256)
# the engine burst with speculation ("ngram", "model": a 4-layer draft,
# "off"): repetitive prompts (an 8-token motif tiled), greedy
FLAGSHIP_SPEC = dict(n_slots=8, prompts=16, prompt_len=64, max_new=96,
                     prefill_chunk=256, prefill_rows=4, max_seq=256,
                     draft_k=4, motif_len=8, draft_layers=4)
# one live paged session moved between two batchers mid-decode
FLAGSHIP_MIGRATE = dict(n_slots=4, prompt_len=192, max_new=48,
                        prefill_chunk=256, kv_page_size=32, kv_pages=64,
                        max_seq=256)
# long batch-class sessions on every slot, short interactive requests on
# top, with the preemption controller armed or not
FLAGSHIP_SCHED = dict(n_slots=4, batch_sessions=4, batch_prompt_len=64,
                      batch_max_new=96, inter_sessions=8,
                      inter_prompt_len=32, inter_max_new=4,
                      prefill_chunk=256, kv_page_size=32, kv_pages=64,
                      max_seq=256, preempt_ms=5.0)
# 8 returning conversations (6 full 32-token pages each) over the host
# page tier: cold pass, then warm from host pages
FLAGSHIP_WARM = dict(n_slots=4, conversations=8, prompt_len=192,
                     max_new=8, prefill_chunk=256, kv_page_size=32,
                     kv_pages=96, host_cache_mb=256, max_seq=256)
# a bulk job's records as batch-class work, interactive probes on top,
# preemption armed
FLAGSHIP_JOB = dict(n_slots=4, records=64, record_prompt_len=32,
                    record_max_new=4, partitions=4, workers=3,
                    checkpoint_every=16, inter_probes=8,
                    inter_prompt_len=32, inter_max_new=4,
                    prefill_chunk=256, kv_page_size=32, kv_pages=64,
                    max_seq=256, preempt_ms=5.0)
# one 32,768-token prompt through the mega-prompt lane (armed) or as an
# ordinary admission (disarmed), an interactive burst on top; the pool a
# hair over the prompt's own run (1,040 pages of 32), so the interactive
# burst's cold prefix pages are evicted into the 64 MB host tier
FLAGSHIP_LONG = dict(n_slots=4, long_prompt_len=32768, long_max_new=8,
                     long_prompt_threshold=4096, inter_sessions=8,
                     inter_prompt_len=32, inter_max_new=4,
                     prefill_chunk=256, kv_page_size=32, kv_pages=1040,
                     host_cache_mb=64, max_seq=32800)


def _check_impl(impl, switch):
    """The JAX builders' read-path switch: "kernel" runs; ``switch`` (the
    plain XLA path) raises, as the port's server flags do."""
    from tensorflowonspark_tpu_torch.serve import _NO_SWITCH

    if impl != "kernel":
        raise ValueError(f"impl={impl!r}: {_NO_SWITCH}" if impl == switch
                         else f"impl={impl!r} not in ('kernel', {switch!r})")


def _seeded_lm(config, max_seq, dev, seed=0, **over):
    """``config`` (None: FLAGSHIP_LM_V2) at ``max_seq``: a Transformer of
    f32 master parameters on ``dev`` (bf16 compute through ``Dense``),
    random from ``seed``, for inference."""
    import torch

    from tensorflowonspark_tpu_torch.models.transformer import (
        Transformer, TransformerConfig)

    cfg = TransformerConfig(**dict(
        FLAGSHIP_LM_V2 if config is None else config, max_seq_len=max_seq,
        **over))
    with torch.device(dev):
        model = Transformer(cfg)
    model.reset_parameters(torch.Generator(dev).manual_seed(seed))
    return model.eval().requires_grad_(False)


def _quantized(model, quantize):
    """``model`` stored as serving stores it (``serve._load_lm``'s
    order): quantised from the f32 masters, then the other float leaves
    cast to the compute width; the scales stay f32."""
    from tensorflowonspark_tpu_torch import quantize as quantize_mod
    from tensorflowonspark_tpu_torch.models.transformer import torch_dtype

    if quantize:
        quantize_mod.quantize_module(model, quantize)
        quantize_mod.cast_float_leaves(model, torch_dtype(model.cfg))
    return model


def _prompts(rs, n, length, vocab):
    """``n`` distinct random prompts of ``length`` ids in [1, vocab)."""
    return [rs.randint(1, vocab, length).astype("int32").tolist()
            for _ in range(n)]


def _row_contiguous_cache(model, n_slots, page, max_seq, dev):
    """A paged cache whose row r maps pages ``[r * P, (r + 1) * P)`` (P
    = the full table width), plus one sink page: every row fully
    mapped, so a step never writes past an allocated page.  Returns
    ``(cache, n_pages)``."""
    import torch

    from tensorflowonspark_tpu_torch.models import decode as decode_mod
    from tensorflowonspark_tpu_torch.serve import max_table_pages

    max_pages = max_table_pages(max_seq, page)
    n_pages = n_slots * max_pages + 1        # +1 = the sink page
    _, cache = decode_mod.init_paged_slot_cache(model, n_slots, page,
                                                n_pages)
    for row in range(n_slots):
        decode_mod.set_row_page_table(cache, row, torch.arange(
            row * max_pages, (row + 1) * max_pages, dtype=torch.int32,
            device=dev))
    return cache, n_pages


def make_decode_step(impl="kernel", n_slots=None, page_size=None,
                     max_seq=None, fill=None, quantize=None, device=None,
                     config=None):
    """The steady-state paged slot-decode step: flagship dims at
    ``max_seq``, every row page-mapped (row-contiguous tables) and its
    index set to ``fill``, so each step is one mid-stream token for all
    ``n_slots`` rows through kernel 1 (its work bounded by ``fill``, the
    per-row length).  ``quantize`` ("int8" / "int4") stores the weights
    as serving does, so the step's projections run kernels 9 / 10.
    Returns ``(step, model, cache, (toks, temps, seeds, ords))``;
    advance with ``toks, cache, ords = step(model, cache, toks, temps,
    seeds, ords)`` (the cache advances in place; greedy rows).  The kv
    content is zeros: decode cost is shape-bound, not value-bound."""
    import torch

    from tensorflowonspark_tpu_torch.device import resolve
    from tensorflowonspark_tpu_torch.models import decode as decode_mod

    _check_impl(impl, "einsum")
    d = FLAGSHIP_DECODE
    n_slots = n_slots or d["n_slots"]
    page = page_size or d["page_size"]
    max_seq = max_seq or d["max_seq"]
    fill = d["fill"] if fill is None else fill
    dev = resolve(device)
    model = _quantized(_seeded_lm(config, max_seq, dev), quantize)
    cache, _ = _row_contiguous_cache(model, n_slots, page, max_seq, dev)
    decode_mod.set_row_indices(
        cache, torch.arange(n_slots, device=dev),
        torch.full((n_slots,), fill, dtype=torch.int32, device=dev))

    def step(model, cache, toks, temps, seeds, ords):
        with torch.no_grad():
            picks = decode_mod.slot_step(model, cache, toks, temps, seeds,
                                         ords)
        return picks.to(toks.dtype), cache, ords + 1

    def zeros(dtype):
        return torch.zeros((n_slots,), dtype=dtype, device=dev)

    return step, model, cache, (zeros(torch.int32), zeros(torch.float32),
                                zeros(torch.int32), zeros(torch.int32))


def make_qmm_op(mode="bf16", rows=None, in_dim=None, out_dim=None,
                group_size=None, device=None):
    """One flagship projection matmul: ``(fn, x, w)`` with ``fn(x, w) ->
    y``.  ``mode`` picks the weight store: "bf16" the dense compute-width
    matmul (``torch.matmul``: the JAX op is ``jnp.dot``, no Pallas
    kernel), "int8" / "int4" the fused-dequant kernels 9 / 10
    (``ops.quant_matmul``) over the port's quantised leaf (int8:
    ``quantize_tree(min_elements=0)``; int4: ``int4_pack`` in groups of
    ``group_size``).  The activation is bf16 in every mode (W8A16 /
    W4A16); x and the f32 weight are random from seed 0."""
    import torch

    from tensorflowonspark_tpu_torch import quantize as quantize_mod
    from tensorflowonspark_tpu_torch.device import resolve
    from tensorflowonspark_tpu_torch.ops.quant_matmul import quant_matmul

    d = FLAGSHIP_QMM
    rows = rows or d["rows"]
    K = in_dim or d["in_dim"]
    N = out_dim or d["out_dim"]
    G = group_size or d["group_size"]
    dev = resolve(device)
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randn((rows, K), generator=gen, device=dev).bfloat16()
    w = torch.randn((K, N), generator=gen, device=dev)
    if mode == "bf16":
        return torch.matmul, x, w.bfloat16()
    if mode == "int8":
        qleaf = quantize_mod.quantize_tree({"proj": {"kernel": w}},
                                           min_elements=0)["proj"]["kernel"]
    elif mode == "int4":
        qleaf = quantize_mod.int4_pack(w, group_size=G)
    else:
        raise ValueError(f"unknown qmm mode {mode!r}")
    return quant_matmul, x, qleaf


def qmm_weight_bytes(mode, in_dim=None, out_dim=None, group_size=None):
    """Analytic resident weight bytes of one :func:`make_qmm_op` matmul,
    the weight read a decode step streams once.  bf16: K·N·2.  int8: K·N
    payload + N per-channel f32 scales.  int4: the nibble-packed payload
    (two input rows a byte, K padded to whole groups) + one f32 scale per
    (group, output channel)."""
    d = FLAGSHIP_QMM
    K = in_dim or d["in_dim"]
    N = out_dim or d["out_dim"]
    G = group_size or d["group_size"]
    if mode == "bf16":
        return K * N * 2
    if mode == "int8":
        return K * N + N * 4
    if mode == "int4":
        n_groups = -(-K // G)
        return n_groups * (G // 2) * N + n_groups * N * 4
    raise ValueError(f"unknown qmm mode {mode!r}")


def make_prefill_chunk_step(impl="kernel", n_slots=None, page_size=None,
                            max_seq=None, fill=None, chunk=None,
                            device=None, config=None):
    """The steady-state batched paged prefill chunk: flagship dims at
    ``max_seq``, every row page-mapped, each dispatch prefilling the
    same ``chunk``-wide slab at offset ``fill`` for all ``n_slots`` rows
    through ``decode.slot_prefill_many`` (kernels 2 and 3).
    Re-dispatch is idempotent: the row indices are SET to ``fill +
    chunk`` and the same pages are rewritten.  Returns ``(prefill,
    model, cache, (chunks, rows, starts, n_valids, sink))``; advance
    with ``logits, cache = prefill(model, cache, *args)`` (logits
    ``[n_slots, V]`` at each row's last position).  The kv content is
    zeros: prefill cost is shape-bound."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.device import resolve
    from tensorflowonspark_tpu_torch.models import decode as decode_mod

    _check_impl(impl, "blend")
    d = FLAGSHIP_PREFILL_KERNEL
    n_slots = n_slots or d["n_slots"]
    page = page_size or d["page_size"]
    max_seq = max_seq or d["max_seq"]
    fill = d["fill"] if fill is None else fill
    chunk = chunk or d["chunk"]
    dev = resolve(device)
    model = _seeded_lm(config, max_seq, dev)
    cache, n_pages = _row_contiguous_cache(model, n_slots, page, max_seq,
                                           dev)

    def prefill(model, cache, chunks, rows, starts, n_valids, sink):
        with torch.no_grad():
            logits = decode_mod.slot_prefill_many(model, cache, chunks, rows,
                                                  starts, n_valids, sink)
        return logits, cache

    rs = np.random.RandomState(0)
    chunks = torch.from_numpy(rs.randint(
        1, model.cfg.vocab_size, (n_slots, chunk)).astype(np.int32)).to(dev)

    def full(value):
        return torch.full((n_slots,), value, dtype=torch.int32, device=dev)

    rows = torch.arange(n_slots, dtype=torch.int32, device=dev)
    return prefill, model, cache, (chunks, rows, full(fill), full(chunk),
                                   n_pages - 1)


def prefill_chunk_write_bytes(impl, n_slots=None, page_size=None,
                              max_seq=None, chunk=None, config=None):
    """Analytic kv-pool WRITE bytes of one prefill chunk dispatch (all
    layers, k + v, bf16 pool): the JAX package's "blend" path
    materialises a whole new pool every chunk, every page whether
    occupied or not; the kernel writes only the ``chunk // page + 1``
    pages each row's chunk can touch, in place.  Both branches are kept
    so the two figures can stand side by side (the port runs the
    kernel only)."""
    from tensorflowonspark_tpu_torch.serve import max_table_pages

    d = FLAGSHIP_PREFILL_KERNEL
    n_slots = n_slots or d["n_slots"]
    page = page_size or d["page_size"]
    max_seq = max_seq or d["max_seq"]
    chunk = chunk or d["chunk"]
    lm = FLAGSHIP_LM_V2 if config is None else config
    dh = lm["d_model"] // lm["n_heads"]
    page_bytes = page * lm["n_kv_heads"] * dh * 2       # bf16 kv pool
    if impl == "blend":
        pages = n_slots * max_table_pages(max_seq, page) + 1   # WHOLE pool
    else:
        pages = n_slots * (chunk // page + 1)     # W pages a row, in place
    return lm["n_layers"] * 2 * pages * page_bytes


def _batcher(model, dev, **kw):
    from tensorflowonspark_tpu_torch import serve as serve_mod

    return serve_mod.ContinuousBatcher(model, device=dev, **kw)


def make_prefill_burst(prefill_rows=None, n_slots=None, prompts=None,
                       prompt_len=None, max_new=None, prefill_chunk=None,
                       max_seq=None, device=None, config=None):
    """TTFT: a ContinuousBatcher on the flagship dims (dense slot cache,
    ``prefill_rows`` admissions a prefill dispatch; 1 = sequential
    admission) plus a burst of distinct random prompts.  Returns
    ``(batcher, prompts_list, max_new)``; the caller submits the burst,
    drains every handle and reads TTFT from ``batcher.stats()``
    (``ttft_ms_sum`` / ``ttft_count``).  Distinct prompts: the prefix
    cache cannot short-circuit the work."""
    import numpy as np

    from tensorflowonspark_tpu_torch.device import resolve

    d = FLAGSHIP_PREFILL
    rows = d["prefill_rows"] if prefill_rows is None else prefill_rows
    n_slots = n_slots or d["n_slots"]
    n_prompts = prompts or d["prompts"]
    prompt_len = prompt_len or d["prompt_len"]
    max_new = max_new or d["max_new"]
    chunk = prefill_chunk or d["prefill_chunk"]
    max_seq = max_seq or d["max_seq"]
    dev = resolve(device)
    model = _seeded_lm(config, max_seq, dev)
    batcher = _batcher(model, dev, n_slots=n_slots, read_chunk=4,
                       prefill_chunk=chunk, prefill_rows=rows)
    rs = np.random.RandomState(0)
    return (batcher, _prompts(rs, n_prompts, prompt_len,
                              model.cfg.vocab_size), max_new)


def make_engine_burst(engine="async", n_slots=None, prompts=None,
                      prompt_len=None, max_new=None, prefill_chunk=None,
                      prefill_rows=None, max_seq=None, pipeline_depth=2,
                      quantize=None, device=None, config=None):
    """Engine tokens/s: a ContinuousBatcher on the flagship dims running
    ``engine`` ("async": the device / host thread pipeline, "serial":
    the one-thread baseline) plus a burst of short distinct prompts with
    long generations.  ``quantize`` ("int8" / "int4") stores the weights
    as serving does, so the burst decodes through kernels 9 / 10.
    Returns ``(batcher, prompts_list, max_new)``; the caller submits the
    burst, drains every handle and computes tokens/s from the wall
    clock (the device-idle share from ``batcher.stats()``)."""
    import numpy as np

    from tensorflowonspark_tpu_torch.device import resolve

    d = FLAGSHIP_ENGINE
    n_slots = n_slots or d["n_slots"]
    n_prompts = prompts or d["prompts"]
    prompt_len = prompt_len or d["prompt_len"]
    max_new = max_new or d["max_new"]
    chunk = prefill_chunk or d["prefill_chunk"]
    rows = d["prefill_rows"] if prefill_rows is None else prefill_rows
    max_seq = max_seq or d["max_seq"]
    dev = resolve(device)
    model = _quantized(_seeded_lm(config, max_seq, dev), quantize)
    batcher = _batcher(model, dev, n_slots=n_slots, read_chunk=4,
                       prefill_chunk=chunk, prefill_rows=rows, engine=engine,
                       pipeline_depth=pipeline_depth)
    rs = np.random.RandomState(0)
    return (batcher, _prompts(rs, n_prompts, prompt_len,
                              model.cfg.vocab_size), max_new)


def make_spec_burst(mode="ngram", n_slots=None, prompts=None,
                    prompt_len=None, max_new=None, prefill_chunk=None,
                    prefill_rows=None, max_seq=None, draft_k=None,
                    device=None, config=None):
    """Speculation tokens/s: a ContinuousBatcher on the flagship dims
    with ``mode`` speculation ("ngram": prompt lookup, "model": a
    ``draft_layers``-deep draft of the same widths from seed 1, "off")
    plus repetitive prompts (a random motif tiled to ``prompt_len``),
    where prompt lookup pays.  Returns ``(batcher, prompts_list,
    max_new)``; the caller submits the burst greedily, drains it and
    reads the acceptance from ``batcher.stats()`` (``spec_rounds``,
    ``spec_accept_rate``)."""
    import numpy as np

    from tensorflowonspark_tpu_torch.device import resolve

    d = FLAGSHIP_SPEC
    n_slots = n_slots or d["n_slots"]
    n_prompts = prompts or d["prompts"]
    prompt_len = prompt_len or d["prompt_len"]
    max_new = max_new or d["max_new"]
    chunk = prefill_chunk or d["prefill_chunk"]
    rows = d["prefill_rows"] if prefill_rows is None else prefill_rows
    max_seq = max_seq or d["max_seq"]
    draft_k = draft_k or d["draft_k"]
    dev = resolve(device)
    model = _seeded_lm(config, max_seq, dev)
    draft = None
    if mode == "model":
        draft = _seeded_lm(config, max_seq, dev, seed=1,
                           n_layers=d["draft_layers"])
    batcher = _batcher(model, dev, n_slots=n_slots, read_chunk=4,
                       prefill_chunk=chunk, prefill_rows=rows,
                       spec_draft=mode, draft_model=draft, draft_k=draft_k)
    rs = np.random.RandomState(0)
    motif_len = d["motif_len"]
    prompts_list = []
    for _ in range(n_prompts):
        motif = rs.randint(1, model.cfg.vocab_size, motif_len)
        reps = prompt_len // motif_len + 1
        prompts_list.append(
            np.tile(motif, reps)[:prompt_len].astype("int32").tolist())
    return batcher, prompts_list, max_new


def make_migrate_pair(n_slots=None, prompt_len=None, max_new=None,
                      prefill_chunk=None, kv_page_size=None,
                      kv_pages=None, max_seq=None, device=None,
                      config=None):
    """kv migration: source and destination ContinuousBatchers on the
    flagship dims (both paged; they share one model) plus the prompt to
    move.  Returns ``(src, dst, prompt, max_new)``; the caller submits
    to ``src``, freezes the session mid-decode, resumes the snapshot on
    ``dst`` and times the handoff.  Stop BOTH batchers."""
    import numpy as np

    from tensorflowonspark_tpu_torch.device import resolve

    d = FLAGSHIP_MIGRATE
    n_slots = n_slots or d["n_slots"]
    prompt_len = prompt_len or d["prompt_len"]
    max_new = max_new or d["max_new"]
    chunk = prefill_chunk or d["prefill_chunk"]
    page = kv_page_size or d["kv_page_size"]
    pages = kv_pages or d["kv_pages"]
    max_seq = max_seq or d["max_seq"]
    dev = resolve(device)
    model = _seeded_lm(config, max_seq, dev)

    def mk():
        return _batcher(model, dev, n_slots=n_slots, read_chunk=1,
                        prefill_chunk=chunk, kv_page_size=page,
                        kv_pages=pages)

    src = mk()
    try:
        dst = mk()
    except BaseException:
        src.stop()
        raise
    rs = np.random.RandomState(0)
    prompt = _prompts(rs, 1, prompt_len, model.cfg.vocab_size)[0]
    return src, dst, prompt, max_new


def make_sched_burst(preempt=True, n_slots=None, prefill_chunk=None,
                     kv_page_size=None, kv_pages=None, max_seq=None,
                     preempt_ms=None, device=None, config=None):
    """Preemption: one paged ContinuousBatcher (the controller armed when
    ``preempt``, parking at most ``batch_sessions``) plus the batch-class
    and interactive prompts.  Returns ``(batcher, batch_prompts,
    batch_max_new, inter_prompts, inter_max_new)``; the caller fills the
    slots with the batch population, sends the interactive one on top,
    drains everything and reads per-class queueing delay and
    ``sessions_parked`` from ``batcher.stats()``."""
    import numpy as np

    from tensorflowonspark_tpu_torch.device import resolve

    d = FLAGSHIP_SCHED
    n_slots = n_slots or d["n_slots"]
    chunk = prefill_chunk or d["prefill_chunk"]
    page = kv_page_size or d["kv_page_size"]
    pages = kv_pages or d["kv_pages"]
    max_seq = max_seq or d["max_seq"]
    preempt_ms = d["preempt_ms"] if preempt_ms is None else preempt_ms
    dev = resolve(device)
    model = _seeded_lm(config, max_seq, dev)
    batcher = _batcher(model, dev, n_slots=n_slots, read_chunk=1,
                       prefill_chunk=chunk, kv_page_size=page,
                       kv_pages=pages,
                       preempt_ms=preempt_ms if preempt else 0.0,
                       park_capacity=d["batch_sessions"])
    rs = np.random.RandomState(0)
    vocab = model.cfg.vocab_size
    batch_prompts = _prompts(rs, d["batch_sessions"], d["batch_prompt_len"],
                             vocab)
    inter_prompts = _prompts(rs, d["inter_sessions"], d["inter_prompt_len"],
                             vocab)
    return (batcher, batch_prompts, d["batch_max_new"], inter_prompts,
            d["inter_max_new"])


def make_warm_burst(n_slots=None, conversations=None, prompt_len=None,
                    max_new=None, prefill_chunk=None, kv_page_size=None,
                    kv_pages=None, host_cache_mb=None, max_seq=None,
                    device=None, config=None):
    """The host page tier: one paged ContinuousBatcher with the tier
    armed plus the conversations' prompts.  Returns ``(batcher,
    prompts_list, max_new)``; the caller runs the burst cold, flushes the
    tier, drops the device prefix cache, runs the same burst warm (its
    prefixes promoted from host pages: ``host_hits``) and compares
    TTFT."""
    import numpy as np

    from tensorflowonspark_tpu_torch.device import resolve

    d = FLAGSHIP_WARM
    n_slots = n_slots or d["n_slots"]
    n_conv = conversations or d["conversations"]
    prompt_len = prompt_len or d["prompt_len"]
    max_new = max_new or d["max_new"]
    chunk = prefill_chunk or d["prefill_chunk"]
    page = kv_page_size or d["kv_page_size"]
    pages = kv_pages or d["kv_pages"]
    cache_mb = host_cache_mb or d["host_cache_mb"]
    max_seq = max_seq or d["max_seq"]
    dev = resolve(device)
    model = _seeded_lm(config, max_seq, dev)
    batcher = _batcher(model, dev, n_slots=n_slots, read_chunk=1,
                       prefill_chunk=chunk, kv_page_size=page,
                       kv_pages=pages, host_cache_mb=cache_mb)
    rs = np.random.RandomState(0)
    return (batcher, _prompts(rs, n_conv, prompt_len, model.cfg.vocab_size),
            max_new)


def make_job_burst(n_slots=None, records=None, record_prompt_len=None,
                   prefill_chunk=None, kv_page_size=None, kv_pages=None,
                   max_seq=None, preempt_ms=None, device=None, config=None):
    """A bulk job: one paged ContinuousBatcher (preemption armed) plus
    the job's record prompts and the interactive probes.  Returns
    ``(batcher, record_prompts, record_max_new, inter_prompts,
    inter_max_new)``; the caller spools the records into a jsonl file,
    runs a ``jobs.JobManager`` over it with a dispatch callable driving
    this batcher, and probes interactive latency while the job
    drains."""
    import numpy as np

    from tensorflowonspark_tpu_torch.device import resolve

    d = FLAGSHIP_JOB
    n_slots = n_slots or d["n_slots"]
    records = records or d["records"]
    rec_len = record_prompt_len or d["record_prompt_len"]
    chunk = prefill_chunk or d["prefill_chunk"]
    page = kv_page_size or d["kv_page_size"]
    pages = kv_pages or d["kv_pages"]
    max_seq = max_seq or d["max_seq"]
    preempt_ms = d["preempt_ms"] if preempt_ms is None else preempt_ms
    dev = resolve(device)
    model = _seeded_lm(config, max_seq, dev)
    batcher = _batcher(model, dev, n_slots=n_slots, read_chunk=1,
                       prefill_chunk=chunk, kv_page_size=page,
                       kv_pages=pages, preempt_ms=preempt_ms)
    rs = np.random.RandomState(0)
    vocab = model.cfg.vocab_size
    record_prompts = _prompts(rs, records, rec_len, vocab)
    inter_prompts = _prompts(rs, d["inter_probes"], d["inter_prompt_len"],
                             vocab)
    return (batcher, record_prompts, d["record_max_new"], inter_prompts,
            d["inter_max_new"])


def make_long_burst(armed=True, n_slots=None, long_prompt_len=None,
                    prefill_chunk=None, kv_page_size=None, kv_pages=None,
                    host_cache_mb=None, max_seq=None,
                    long_prompt_threshold=None, device=None, config=None):
    """A 32,768-token prompt: one paged ContinuousBatcher (the
    mega-prompt lane armed when ``armed``; disarmed = threshold 0, the
    prompt admits as ordinary work and reserves its whole page run) plus
    the long prompt and an interactive burst.  Armed, the prompt
    prefills chunk by chunk under the lane's quota, the page table grows
    from its 8-entry seed, and the overflow valve demotes cold prefix
    pages to the host tier when the pool runs dry.  Returns ``(batcher,
    long_prompt, long_max_new, inter_prompts, inter_max_new)``; the
    caller submits the long prompt, sends the interactive burst on top,
    drains everything and reads TTFT, queueing delay and the growth and
    demotion counters from ``batcher.stats()``."""
    import numpy as np

    from tensorflowonspark_tpu_torch.device import resolve

    d = FLAGSHIP_LONG
    n_slots = n_slots or d["n_slots"]
    long_len = long_prompt_len or d["long_prompt_len"]
    chunk = prefill_chunk or d["prefill_chunk"]
    page = kv_page_size or d["kv_page_size"]
    pages = kv_pages or d["kv_pages"]
    cache_mb = host_cache_mb or d["host_cache_mb"]
    max_seq = max_seq or d["max_seq"]
    threshold = (long_prompt_threshold or d["long_prompt_threshold"]
                 if armed else 0)
    dev = resolve(device)
    model = _seeded_lm(config, max_seq, dev)
    batcher = _batcher(model, dev, n_slots=n_slots, read_chunk=1,
                       prefill_chunk=chunk, kv_page_size=page,
                       kv_pages=pages, host_cache_mb=cache_mb,
                       long_prompt_threshold=threshold)
    rs = np.random.RandomState(0)
    vocab = model.cfg.vocab_size
    long_prompt = _prompts(rs, 1, long_len, vocab)[0]
    inter_prompts = _prompts(rs, d["inter_sessions"], d["inter_prompt_len"],
                             vocab)
    return (batcher, long_prompt, d["long_max_new"], inter_prompts,
            d["inter_max_new"])


def make_flagship_step(batch_size=None, seq_len=None, config="v2",
                       optimizer=None, device=None):
    """Build the flagship-LM training step as the JAX package's
    ``make_flagship_step`` builds it: returns ``(step, state, tokens,
    n_params)``; call as ``state, m = step(state, tokens, rng)``.

    ``config``: "v2" (rmsnorm), "v1" (layernorm), "moe"
    (:data:`FLAGSHIP_MOE`), or a dict of TransformerConfig fields (a
    small model for the CPU).  ``optimizer``: None
    -> FLAGSHIP_OPTIMIZER (adamw_fused, kernel 7); "lion_fused" -> the
    fused Lion (kernel 8); "adam", "adamw", "lion" -> their plain
    optax-semantics versions; "sgd0" -> zero-lr momentum-less SGD.  Every
    optimizer gets lr 3e-4 and the bf16 first moment, so "sgd",
    "adamw8bit" and "adafactor", which have no mu_dtype knob, raise
    ValueError here as in the JAX package: build those with
    ``optim.make_optimizer(name, learning_rate=3e-4)`` and
    ``parallel.train.make_train_step`` on the same model.  The
    parameters are f32 masters with bf16 compute through ``Dense``'s
    cast, random from a seed (0); tokens ``[B, S + 1]`` come from
    ``np.random.RandomState(0)``.  ``device`` defaults to ``cuda``
    (``device.resolve``)."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.device import resolve
    from tensorflowonspark_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, lm_loss)
    from tensorflowonspark_tpu_torch.optim import make_optimizer
    from tensorflowonspark_tpu_torch.parallel import train as train_mod

    dev = resolve(device)
    if isinstance(config, dict):
        cfg_kw = dict(config)
    elif config in _CONFIGS:
        cfg_kw = dict(_CONFIGS[config])
    else:
        raise ValueError(f"config={config!r} not in {tuple(_CONFIGS)} or "
                         "a dict")
    if seq_len:
        cfg_kw["max_seq_len"] = seq_len
    B = batch_size or FLAGSHIP_BATCH
    S = cfg_kw["max_seq_len"]
    cfg = TransformerConfig(**cfg_kw)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S + 1))).to(dev)
    with torch.device(dev):
        model = Transformer(cfg)      # f32 master params
    model.reset_parameters(torch.Generator(dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())

    def loss_fn(m, batch, rng):
        return lm_loss(m(batch[:, :-1]), batch[:, 1:])

    name = optimizer or FLAGSHIP_OPTIMIZER
    if name == "sgd0":
        # momentum=None (not 0.0): a trace state would put optimizer
        # bandwidth back into the "no optimizer" baseline
        opt, _ = make_optimizer("sgd", learning_rate=0.0, momentum=None)
    else:
        opt, _ = make_optimizer(name, learning_rate=3e-4,
                                mu_dtype=FLAGSHIP_MU_DTYPE)
    state = train_mod.create_train_state(model, opt)
    step = train_mod.make_train_step(loss_fn, opt, donate=True)
    return step, state, tokens, n_params
