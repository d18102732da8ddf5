"""Slot decoding — counterpart of ``tensorflowonspark_tpu/models/
decode.py`` for the serving slices.

Every row of a slot cache is an independent serving slot that requests
join and leave at token boundaries (serve.ContinuousBatcher), with a
per-row ``cache_index [n_slots]``.  Two layouts, as in the JAX package:

- the dense slot cache (:func:`init_slot_cache`, ``kv_page_size 0``):
  every row owns a full ``[max_seq_len, n_kv, Dh]`` window per layer;
- the paged slot cache (:func:`init_paged_slot_cache`): every layer's kv
  lives in a shared pool of pages (``pages_key/pages_value [kv_pages,
  page, n_kv, Dh]``) mapped per row through one ``page_table [n_slots,
  width]``.  The table may start narrow and grow (:func:`grow_page_table`).

With ``kv_dtype="int8"`` either layout holds int8 payloads beside f32
per-(token, head) scales.  The jitted JAX bodies become plain functions
that update the cache in place; the JAX package donated the cache to
the same end.  Host values reach the card through pinned buffers with
non-blocking copies (:func:`to_device`), so a dispatch never waits for
the card.

Sampling is counter-based: the noise of row b for new-token ordinal t
is a pure function of ``(seed_b, t)``, drawn from an explicit
``torch.Generator`` seeded with both (:func:`sample_noise`), so a
request reproduces its tokens whatever batch it rides in and on any
device.  It does not reproduce JAX's threefry bits.
"""
import dataclasses
import math

import numpy as np
import torch

from tensorflowonspark_tpu_torch import device as device_mod
from tensorflowonspark_tpu_torch.models.transformer import (
    Transformer, TransformerConfig, torch_dtype)


def to_device(array, device):
    """A host array or tensor on ``device``.  On the card the copy runs
    from a pinned buffer without blocking the host (a pageable copy
    would wait for the stream to drain); on the CPU it is the tensor
    itself."""
    t = torch.as_tensor(array)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclasses.dataclass
class SlotCache:
    """The dense slot cache: per layer a ``[n_slots + 1, max_seq_len,
    n_kv, Dh]`` kv store (``key_scales`` / ``value_scales`` ``[n_slots +
    1, max_seq_len, n_kv]`` f32 beside an int8 store) and the per-row
    ``cache_index``.  The extra last row is the garbage row: a prefill's
    pad rows and writes past ``max_seq_len`` (the JAX one-hot write
    drops those) land there.  ``rows`` maps the rows of a view onto the
    store (a prefill batch); None means rows ``0..B-1``."""
    keys: list                 # per layer: [n_slots + 1, L, n_kv, Dh]
    values: list
    cache_index: torch.Tensor  # [rows] int32: tokens written per row
    key_scales: list = None    # per layer: [n_slots + 1, L, n_kv] f32
    value_scales: list = None
    rows: torch.Tensor = None  # [rows] int64 store row of each view row

    def rows_view(self, rows, cache_index):
        """A view over store rows ``rows`` (pad rows name the garbage
        row, ``n_slots``) at write offsets ``cache_index``."""
        return dataclasses.replace(self, rows=rows, cache_index=cache_index)

    def pool_bytes(self):
        """Resident bytes of the stores, scales included."""
        return sum(t.numel() * t.element_size() for t in (
            self.keys + self.values + (self.key_scales or [])
            + (self.value_scales or [])))


@dataclasses.dataclass
class PagedCache:
    """The paged slot cache: per-layer pools (shared by every row) plus
    the per-row page table and write index, shared by every layer (the
    JAX tree repeats them per layer; every copy holds the same values).
    ``key_scales`` / ``value_scales`` are the int8 pools' per-layer f32
    scale pools, None for float pools."""
    pages_key: list        # per layer: [kv_pages, page, n_kv, Dh]
    pages_value: list
    page_table: torch.Tensor   # [rows, max_pages] int32
    cache_index: torch.Tensor  # [rows] int32: tokens written per row
    page_size: int
    key_scales: list = None    # per layer: [kv_pages, page, n_kv] f32
    value_scales: list = None

    def rows_view(self, page_table, cache_index):
        """A cache over other rows (a prefill batch) sharing these pools:
        writes through it land in the same pages."""
        return dataclasses.replace(self, page_table=page_table,
                                   cache_index=cache_index)

    def pool_bytes(self):
        """Resident bytes of the pools, scales included."""
        return sum(t.numel() * t.element_size() for t in (
            self.pages_key + self.pages_value + (self.key_scales or [])
            + (self.value_scales or [])))


def _cache_layout(model_or_cfg, device, kv_dtype):
    """(cfg, device, head_dim, n_kv, int8?, store dtype) of a slot cache
    for a Transformer (its parameters' device) or a config (``device``,
    resolved by the port's device rule)."""
    if isinstance(model_or_cfg, Transformer):
        cfg = model_or_cfg.cfg
        dev = next(model_or_cfg.parameters()).device
    elif isinstance(model_or_cfg, TransformerConfig):
        cfg = model_or_cfg
        dev = device_mod.resolve(device)
    else:
        raise TypeError(f"expected Transformer or TransformerConfig, got "
                        f"{type(model_or_cfg)}")
    kv_dtype = cfg.kv_dtype if kv_dtype is None else kv_dtype
    if kv_dtype not in ("auto", "int8"):
        raise ValueError(f"kv_dtype={kv_dtype!r} not in ('auto', 'int8')")
    head_dim = cfg.d_model // cfg.n_heads
    n_kv = cfg.n_heads if cfg.n_kv_heads is None else cfg.n_kv_heads
    quant = kv_dtype == "int8"
    return (cfg, dev, head_dim, n_kv, quant,
            torch.int8 if quant else torch_dtype(cfg))


def _per_layer(cfg, shape, dtype, dev):
    """One zero tensor of ``shape`` per layer."""
    return [torch.zeros(shape, dtype=dtype, device=dev)
            for _ in range(cfg.n_layers)]


def init_slot_cache(model_or_cfg, n_slots, kv_dtype=None, device=None):
    """Build the dense slot cache for ``n_slots`` rows (the JAX
    ``init_slot_cache`` at ``page_size 0``): per layer a zero
    ``[n_slots + 1, max_seq_len, n_kv, Dh]`` store (the last row is the
    garbage row) in the compute dtype, or int8 with f32 scales
    (``kv_dtype="int8"``; None takes the config's), and zero indices.
    Returns ``(model_or_cfg, cache)``."""
    cfg, dev, head_dim, n_kv, quant, dt = _cache_layout(
        model_or_cfg, device, kv_dtype)
    if n_slots < 1:
        raise ValueError("a slot cache needs n_slots >= 1")
    shape = (n_slots + 1, cfg.max_seq_len, n_kv, head_dim)

    def stores(shape, dtype):
        return _per_layer(cfg, shape, dtype, dev)

    cache = SlotCache(
        keys=stores(shape, dt), values=stores(shape, dt),
        cache_index=torch.zeros((n_slots,), dtype=torch.int32, device=dev),
        key_scales=stores(shape[:3], torch.float32) if quant else None,
        value_scales=stores(shape[:3], torch.float32) if quant else None)
    return model_or_cfg, cache


def init_paged_slot_cache(model_or_cfg, n_slots, page_size, n_pages,
                          kv_dtype=None, table_pages=0, device=None):
    """Build the paged slot cache for ``n_slots`` rows: per-layer pools
    of ``n_pages`` pages of ``page_size`` tokens, page tables (all 0)
    and zero indices.  ``kv_dtype`` ("auto" or "int8"; None takes the
    config's) picks the pools' storage: the compute dtype, or int8
    payloads with f32 scale pools.

    The tables are ``table_pages`` entries wide (else the config's
    ``kv_table_pages``; 0 means the full ``max_seq_len // page_size``),
    capped at the full width: the growable layout, which
    :func:`grow_page_table` widens as rows outgrow it.

    Accepts a Transformer (its parameters' device is used) or a config
    (then ``device``, resolved by the port's device rule).  Returns
    ``(model_or_cfg, cache)``.  CALLER CONTRACT, as in the JAX package:
    reserve one pool page as a garbage SINK and point every unallocated
    or retired table entry at it (serve.ContinuousBatcher allocates
    ``kv_pages + 1`` pages and uses the last as the sink)."""
    cfg, dev, head_dim, n_kv, quant, dt = _cache_layout(
        model_or_cfg, device, kv_dtype)
    if page_size < 1 or cfg.max_seq_len % page_size:
        raise ValueError(f"max_seq_len={cfg.max_seq_len} must be a multiple "
                         f"of page_size={page_size} >= 1")
    if n_pages < 1:
        raise ValueError("a paged cache needs n_pages >= 1")
    cap = cfg.max_seq_len // page_size
    width = int(table_pages or cfg.kv_table_pages or cap)
    if width < 1:
        raise ValueError(f"table_pages={width} must be >= 1")
    shape = (n_pages, page_size, n_kv, head_dim)

    def pools(shape, dtype):
        return _per_layer(cfg, shape, dtype, dev)

    cache = PagedCache(
        pages_key=pools(shape, dt), pages_value=pools(shape, dt),
        page_table=torch.zeros((n_slots, min(width, cap)),
                               dtype=torch.int32, device=dev),
        cache_index=torch.zeros((n_slots,), dtype=torch.int32, device=dev),
        page_size=page_size,
        key_scales=pools(shape[:3], torch.float32) if quant else None,
        value_scales=pools(shape[:3], torch.float32) if quant else None)
    return model_or_cfg, cache


def set_row_page_table(cache, row, entries):
    """Install row ``row``'s page mapping (serving-side allocation), in
    place: the port of ``_jitted_set_row_page_table``.  ``entries`` is a
    host sequence or a tensor on the table's device, as wide as the
    table."""
    if not isinstance(entries, torch.Tensor):
        entries = to_device(np.asarray(entries, np.int32),
                            cache.page_table.device)
    cache.page_table[row] = entries


def grow_page_table(cache, new_width, sink):
    """Widen every row's page table to ``new_width`` entries (the port of
    ``_jitted_grow_page_table``): existing mappings keep their columns
    and the new tail names the ``sink`` page, so a row mid-decode keeps
    its pages and the widened table is safe to step at once."""
    rows, width = cache.page_table.shape
    if new_width < width:
        raise ValueError(f"a page table grows: {new_width} < {width}")
    pad = torch.full((rows, new_width - width), int(sink), dtype=torch.int32,
                     device=cache.page_table.device)
    cache.page_table = torch.cat([cache.page_table, pad], dim=1)


def set_row_indices(cache, rows, values):
    """Write ``values`` into ``cache.cache_index`` at ``rows`` (device
    tensors): the port of ``_jitted_set_row_index`` /
    ``_reset_row_indices`` over a batch.  Rows ``>= n_slots`` (a
    prefill's pad rows) are dropped, as the JAX scatter drops them,
    through one spare slot and without reading the rows back to the
    host."""
    n_slots = cache.cache_index.shape[0]
    index = torch.cat([cache.cache_index, cache.cache_index.new_zeros(1)])
    index[rows.long().clamp(max=n_slots)] = values.to(torch.int32)
    cache.cache_index = index[:n_slots]


def build_prefill_batch(entries, width, bucket, n_slots, device):
    """Host-side slot builder for one batched prefill dispatch.

    ``entries`` is [(row, chunk_tokens, start)] for up to ``width``
    admitting rows; the result pads to the (width, bucket) dispatch
    shape.  Pad rows take row index ``n_slots`` (one past the last slot),
    which :func:`slot_prefill_many` clips on gather, drops on writeback
    and points at the sink page.  Returns (chunks, rows, starts,
    n_valids) on ``device``."""
    if len(entries) > width:
        raise ValueError(f"{len(entries)} entries exceed width {width}")
    if len({row for row, _, _ in entries}) != len(entries):
        raise ValueError("duplicate rows in one prefill dispatch would "
                         "double-write their pool pages")
    chunks = np.zeros((width, bucket), np.int64)
    rows = np.full((width,), n_slots, np.int64)
    starts = np.zeros((width,), np.int32)
    n_valids = np.ones((width,), np.int32)
    for i, (row, toks, start) in enumerate(entries):
        if not 0 < len(toks) <= bucket:
            raise ValueError(f"chunk of {len(toks)} tokens does not fit "
                             f"bucket {bucket}")
        chunks[i, :len(toks)] = toks
        rows[i] = row
        starts[i] = start
        n_valids[i] = len(toks)
    return tuple(to_device(a, device) for a in (chunks, rows, starts,
                                                n_valids))


def slot_prefill_many(model, cache, chunks, rows, starts, n_valids, sink):
    """Batched multi-row prefill (``_slot_prefill_many_body``): one
    forward writes one bucket-padded chunk for each of P rows, over a
    dense or a paged slot cache.

    ``chunks`` [P, bucket]; ``rows`` / ``starts`` / ``n_valids`` [P] give
    each row's slot, write offset and true token count.  JAX's
    out-of-bounds rules do not hold in torch, so they are reproduced
    here: pad rows (``rows == n_slots``) write into the dense cache's
    garbage row, or (paged) take a table of ``sink`` pages; their index
    writeback is DROPPED.  A paged chunk's table is widened by sink
    entries for the bucket, so bucket-pad overshoot past a row's table
    lands in the sink (the JAX kernel's clip would park it in the row's
    last page).  Rows must be distinct.  Returns the last-valid-position
    logits [P, V]; stores, pools and ``cache_index`` update in place."""
    n_slots = cache.cache_index.shape[0]
    rows = rows.long()
    if isinstance(cache, SlotCache):
        sub = cache.rows_view(rows.clamp(max=n_slots), starts.to(torch.int32))
    else:
        valid = rows < n_slots
        table = cache.page_table[rows.clamp(max=n_slots - 1)]
        table = torch.where(valid[:, None], table,
                            torch.full_like(table, int(sink)))
        tail = -(-chunks.shape[1] // cache.page_size)
        table = torch.cat([table, torch.full(
            (table.shape[0], tail), int(sink), dtype=table.dtype,
            device=table.device)], dim=1)
        sub = cache.rows_view(table, starts.to(torch.int32))
    logits = model(chunks.long(), sub)
    set_row_indices(cache, rows, starts + n_valids)
    pick = (n_valids.long() - 1).clamp(0, chunks.shape[1] - 1)
    return logits[torch.arange(logits.shape[0], device=logits.device), pick]


def filter_top_k_p(logits, top_k, top_p, min_p=None):
    """Per-row top-k / nucleus (top-p) / min-p logit filtering, the JAX
    package's shared filter: HF-warper order temperature -> top_k ->
    top_p -> min_p, each on the renormalised survivors of the previous.
    Ties at the threshold value survive together (so top-k can keep more
    than k).  Filtered entries become -inf.

    ``logits`` [n, V] (already temperature-scaled); ``top_k`` [n] int
    (0 disables); ``top_p`` [n] float (1.0 disables); ``min_p`` [n] float
    (0.0 disables) or None."""
    V = logits.shape[-1]
    sorted_l = torch.sort(logits, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k.clamp(1, V), torch.full_like(top_k, V))
    pos = torch.arange(V, device=logits.device)[None, :]
    in_k = pos < k[:, None]
    neg = torch.full_like(sorted_l, -math.inf)
    probs = torch.softmax(torch.where(in_k, sorted_l, neg), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = in_k & ((cum - probs) < top_p[:, None])
    if min_p is not None:
        probs2 = torch.softmax(torch.where(keep_sorted, sorted_l, neg),
                               dim=-1)
        keep_sorted = keep_sorted & (probs2 >= min_p[:, None] * probs2[:, :1])
    thr = torch.where(keep_sorted, sorted_l,
                      torch.full_like(sorted_l, math.inf)).amin(dim=-1)
    return torch.where(logits >= thr[:, None], logits,
                       torch.full_like(logits, -math.inf))


def sample_noise(seed, ordinal, vocab):
    """Gumbel noise ``[vocab]`` for new-token ``ordinal`` of a request
    seeded ``seed``: a pure function of the pair, drawn on the CPU from a
    ``torch.Generator`` seeded with both (so it is the same on every
    device and in every batch)."""
    g = torch.Generator()
    g.manual_seed(((int(seed) & 0xFFFFFFFF) << 32)
                  | (int(ordinal) & 0xFFFFFFFF))
    u = torch.rand(vocab, generator=g)
    return -torch.log(-torch.log(u))


def pick_tokens(logits, temps, seeds, ords, topks=None, topps=None,
                minps=None):
    """Per-row token pick, shared by every decode path: greedy argmax
    where ``temps[b] == 0``, else a categorical draw from the
    temperature-scaled (and, with ``topks``, filtered) logits by the
    Gumbel-max rule with :func:`sample_noise` of ``(seeds[b], ords[b])``.
    ``temps``/``seeds``/``ords``/filters are per-row host sequences.
    Returns [n] int64 on the logits' device."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    sampled = [i for i, t in enumerate(temps) if t > 0]
    if not sampled:
        return greedy
    dev = logits.device
    t = to_device(torch.tensor([max(float(x), 1e-6) for x in temps]), dev)
    scaled = logits / t[:, None]
    if topks is not None:
        scaled = filter_top_k_p(
            scaled, to_device(torch.tensor(list(topks)), dev),
            to_device(torch.tensor(list(topps), dtype=torch.float32), dev),
            None if minps is None else to_device(torch.tensor(
                list(minps), dtype=torch.float32), dev))
    noise = torch.zeros(logits.shape)
    for i in sampled:
        noise[i] = sample_noise(seeds[i], ords[i], logits.shape[-1])
    pick = torch.argmax(scaled + to_device(noise, dev), dim=-1)
    use = to_device(torch.tensor([x > 0 for x in temps]), dev)
    return torch.where(use, pick, greedy)


def slot_step(model, cache, toks, temps, seeds, ords, topks=None,
              topps=None, minps=None, rems=None, eoss=None, eos_on=None):
    """One decode step over ALL slots (``_slot_step_body``): feed each
    row its current token ``toks [n]`` (a device tensor, the previous
    step's pick), then pick per row (:func:`pick_tokens`).  Free rows
    step too; their writes land in the sink page (paged) or past their
    window.  Returns the picks [n]; the cache advances in place.

    With ``rems`` / ``eoss`` / ``eos_on`` ([n] device tensors: remaining
    budget, eos id, whether an eos is set) the stop decision runs on the
    device too: returns ``(picks, rems - 1, done)`` with ``done[b]``
    raised when row b's budget hits zero or it picked its eos, so the
    serving engine reads the verdict back with the tokens and never
    inspects token values to decide whether to keep dispatching."""
    logits = model(toks.long()[:, None], cache)[:, -1]
    pick = pick_tokens(logits, temps, seeds, ords, topks, topps, minps)
    if rems is None:
        return pick
    rems = rems - 1
    return pick, rems, (rems <= 0) | (eos_on & (pick == eoss))


def check_pick_args(temperature, top_k, top_p, min_p):
    """Validate one request's sampling controls (``_solo_pick_fn``)."""
    if temperature < 0:
        raise ValueError(f"temperature={temperature!r} must be >= 0")
    if not (isinstance(top_k, int) and not isinstance(top_k, bool)
            and 0 <= top_k < (1 << 31)):
        raise ValueError(f"top_k={top_k!r} must be an int32 >= 0")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p={top_p!r} must be in (0, 1]")
    if not 0.0 <= min_p < 1.0:
        raise ValueError(f"min_p={min_p!r} must be in [0, 1)")
    if (top_k or top_p < 1.0 or min_p > 0.0) and temperature <= 0:
        raise ValueError("top_k/top_p/min_p filter the SAMPLED distribution "
                         "— they require temperature > 0")


def _solo_page_size(max_seq_len):
    return next(p for p in (16, 8, 4, 2, 1) if max_seq_len % p == 0)


def generate(model, prompt, max_new_tokens, temperature=0.0, seed=None,
             eos_id=None, top_k=0, top_p=1.0, min_p=0.0, device=None,
             kv_dtype=None):
    """Generate continuations of ``prompt`` [B, T0] -> [B, T0 +
    max_new_tokens] through the paged slot path (one slot per row).

    ``temperature == 0`` is greedy argmax; > 0 samples, optionally top-k
    / top-p / min-p filtered, with row b drawing from seed ``seed + b``
    (required when sampling).  With ``eos_id``, rows that emit it keep
    emitting it.  ``device`` follows the port's device rule (default
    ``cuda``; raises without one unless ``device="cpu"``); the model's
    parameters must live there.  ``kv_dtype="int8"`` decodes on an int8
    paged pool, as the batcher serves it (None: the config's).  Returns
    an int64 tensor on that device.
    """
    dev = device_mod.resolve(device)
    param_dev = next(model.parameters()).device
    if param_dev.type != dev.type or (
            dev.index is not None and param_dev.index != dev.index):
        raise ValueError(f"model parameters are on {param_dev}, not {dev}")
    check_pick_args(temperature, top_k, top_p, min_p)
    if temperature > 0 and seed is None:
        raise ValueError("sampling (temperature > 0) requires `seed`")
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64)
    if prompt.ndim != 2 or prompt.shape[1] < 1:
        raise ValueError(f"prompt must be [B, T0>=1], got {tuple(prompt.shape)}")
    if max_new_tokens <= 0:
        return prompt.to(dev)
    cfg = model.cfg
    B, T0 = prompt.shape
    if T0 + max_new_tokens > cfg.max_seq_len:
        raise ValueError(f"prompt {T0} + max_new_tokens {max_new_tokens} "
                         f"exceeds max_seq_len {cfg.max_seq_len}")
    page = _solo_page_size(cfg.max_seq_len)
    per_row = -(-(T0 + max_new_tokens) // page)
    sink = B * per_row
    _, cache = init_paged_slot_cache(model, B, page, sink + 1,
                                     kv_dtype=kv_dtype,
                                     table_pages=cfg.max_seq_len // page)
    width = cache.page_table.shape[1]
    for b in range(B):
        pages = list(range(b * per_row, (b + 1) * per_row))
        set_row_page_table(cache, b, pages + [sink] * (width - per_row))
    temps = [float(temperature)] * B
    seeds = [(seed or 0) + b for b in range(B)]
    filt = bool(temperature > 0 and (top_k or top_p < 1.0 or min_p > 0.0))
    fkw = ({"topks": [top_k] * B, "topps": [top_p] * B,
            "minps": [min_p] * B} if filt else {})
    with torch.no_grad():
        last = slot_prefill_many(
            model, cache, prompt.to(dev), torch.arange(B, device=dev),
            torch.zeros(B, dtype=torch.int32, device=dev),
            torch.full((B,), T0, dtype=torch.int32, device=dev), sink)
        tok = pick_tokens(last, temps, seeds, [0] * B, **fkw)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        if eos_id is not None:
            done = tok == eos_id
        out = [tok]
        for t in range(1, max_new_tokens):
            nxt = slot_step(model, cache, tok, temps, seeds, [t] * B, **fkw)
            if eos_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
                done = done | (nxt == eos_id)
            out.append(nxt)
            tok = nxt
    return torch.cat([prompt.to(dev), torch.stack(out, dim=1)], dim=1)
