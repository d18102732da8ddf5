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
is a pure function of ``(seed_b, t)`` (:func:`counter_uniform`, an
integer hash computed where the logits are, so the seeds and ordinals
stay on the device), so a request reproduces its tokens whatever batch
it rides in and on any device.  It does not reproduce JAX's threefry
bits.  Speculative rounds (:func:`spec_round`) draw their draft,
acceptance and resample noise from streams of their own, tagged, per
position ordinal, as the JAX package's spec v2 schedule does.

Also here, as in the JAX package: the repetition penalty
(:func:`apply_repetition_penalty` over a device ``seen`` table), per-row
LoRA banks (``lora=(banks, ids)``, passed to the model's forward), the
n-gram proposer (:func:`ngram_propose`), the rejection walk of sampled
verification (:func:`spec_accept_sampled`) and
:func:`speculative_generate`.

On a tp mesh (a model that ``parallel.sharding.shard_params`` split, run
inside ``parallel.mesh.use_mesh``, every rank calling alike): a slot
cache holds this rank's kv heads (``Attention.cache_heads``), the
paged kernels run on them, and every pick reads the whole-vocabulary
logits (``gather_vocab``), so every rank picks the same token, sampled
ones too; so does every step of speculation (a draft split over the
same mesh, the verify block, the acceptance walk).  The kv migration
helpers raise there, naming ROADMAP A3c.
"""
import dataclasses
import math

import numpy as np
import torch

from tensorflowonspark_tpu_torch import device as device_mod
from tensorflowonspark_tpu_torch.models.transformer import (
    Transformer, TransformerConfig, gather_vocab, torch_dtype)
from tensorflowonspark_tpu_torch.parallel.mesh import (
    A3C, active_mesh, check_serving_mesh)


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
    split: bool = False        # holds one tp rank's kv heads

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
    split: bool = False        # holds one tp rank's kv heads

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
    """(cfg, device, head_dim, n_kv, int8?, store dtype, split?) of a slot
    cache for a Transformer (its parameters' device; a tp-split one's kv
    heads on this rank, read from its own split) or a config
    (``device``, resolved by the port's device rule)."""
    split = False
    if isinstance(model_or_cfg, Transformer):
        cfg = model_or_cfg.cfg
        dev = next(model_or_cfg.parameters()).device
        split = model_or_cfg.split()
        n_kv = _first_attention(model_or_cfg).cache_heads()
    elif isinstance(model_or_cfg, TransformerConfig):
        cfg = model_or_cfg
        dev = device_mod.resolve(device)
        n_kv = cfg.n_heads if cfg.n_kv_heads is None else cfg.n_kv_heads
    else:
        raise TypeError(f"expected Transformer or TransformerConfig, got "
                        f"{type(model_or_cfg)}")
    kv_dtype = cfg.kv_dtype if kv_dtype is None else kv_dtype
    if kv_dtype not in ("auto", "int8"):
        raise ValueError(f"kv_dtype={kv_dtype!r} not in ('auto', 'int8')")
    head_dim = cfg.d_model // cfg.n_heads
    quant = kv_dtype == "int8"
    return (cfg, dev, head_dim, n_kv, quant,
            torch.int8 if quant else torch_dtype(cfg), split)


def _first_attention(model):
    return getattr(model, model.layer_names[0]).attn


def check_tp_decode(model):
    """Raise unless a tp-split ``model`` decodes inside ``use_mesh`` of a
    serving mesh that splits it (``parallel.mesh.check_serving_mesh``);
    a whole model decodes anywhere."""
    if model.split() and check_serving_mesh(active_mesh()) == 1:
        raise ValueError("a tp-split model decodes inside parallel.mesh."
                         "use_mesh(mesh), on the tp mesh it was split over")


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
    cfg, dev, head_dim, n_kv, quant, dt, split = _cache_layout(
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
        value_scales=stores(shape[:3], torch.float32) if quant else None,
        split=split)
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
    cfg, dev, head_dim, n_kv, quant, dt, split = _cache_layout(
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
        value_scales=pools(shape[:3], torch.float32) if quant else None,
        split=split)
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


# ---- kv migration and the host page tier --------------------------------
# A migrating row's committed kv leaves the card once (a gather into
# fresh tensors on the source) and re-enters once (a scatter into freshly
# allocated pages or the destination row).  These are the JAX package's
# ``jnp.take`` / ``.at[].set`` helpers, not kernels: ``index_select`` and
# ``index_copy_``.  Blocks are keyed by the JAX cache tree's path strings,
# so both packages build and read the same ``(meta, blocks)``.


def kv_leaves(cache):
    """``{block name: store}`` of every kv leaf of ``cache``: the pools
    (``layer_<i>/attn/pages_key``, ``pages_value`` and, for an int8
    pool, ``pages_key_scale`` / ``pages_value_scale``, dim 0 = pool
    pages) or the dense stores (``cached_key`` ... , dim 0 = rows).  A
    cache of one tp rank's kv heads raises: the migration and host-tier
    blocks are whole-head (ROADMAP A3c)."""
    if cache.split:
        raise NotImplementedError(
            "kv migration / host tier / parking on a tp mesh is not ported "
            f"yet ({A3C})")
    if isinstance(cache, PagedCache):
        names, stores = ("pages_key", "pages_value"), (cache.pages_key,
                                                       cache.pages_value)
    else:
        names, stores = ("cached_key", "cached_value"), (cache.keys,
                                                         cache.values)
    out = {}
    for i in range(len(stores[0])):
        for name, store in zip(names, stores):
            out[f"layer_{i}/attn/{name}"] = store[i]
        if cache.key_scales is not None:
            out[f"layer_{i}/attn/{names[0]}_scale"] = cache.key_scales[i]
            out[f"layer_{i}/attn/{names[1]}_scale"] = cache.value_scales[i]
    return out


def _index(ids, device):
    if isinstance(ids, torch.Tensor):
        return ids.to(device=device, dtype=torch.int64)
    return to_device(np.asarray(ids, np.int64), device)


def _block_on(block, leaf):
    """A host or device block (tensor or array) on ``leaf``'s device in
    its dtype (host blocks ride a pinned, non-blocking copy)."""
    if not (isinstance(block, torch.Tensor) and block.device == leaf.device):
        block = to_device(block, leaf.device)
    return block.to(leaf.dtype)


def gather_pages(cache, ids):
    """Pool pages ``ids`` of every pool leaf, ``{name: [n, page, ...]}``
    in fresh tensors (the port of ``_jitted_gather_pages``): the pool
    pages may be reused as soon as this returns."""
    leaves = kv_leaves(cache)
    idx = _index(ids, next(iter(leaves.values())).device)
    return {name: leaf.index_select(0, idx) for name, leaf in leaves.items()}


def scatter_pages(cache, ids, blocks):
    """Write ``blocks`` (``{name: [n, page, ...]}``, one per pool leaf,
    on any device) into pool pages ``ids``, in place (the port of
    ``_jitted_scatter_pages``)."""
    leaves = kv_leaves(cache)
    idx = _index(ids, next(iter(leaves.values())).device)
    for name, leaf in leaves.items():
        leaf.index_copy_(0, idx, _block_on(blocks[name], leaf))


def gather_row_kv(cache, row):
    """Row ``row``'s whole window of every dense kv leaf, ``{name:
    [max_seq_len, ...]}`` in fresh tensors (the port of
    ``_jitted_gather_row_kv``: positions past the row's index hold
    garbage the causal mask never shows)."""
    return {name: leaf[int(row)].clone()
            for name, leaf in kv_leaves(cache).items()}


def scatter_row_kv(cache, row, blocks):
    """Install ``blocks`` (from :func:`gather_row_kv`) at dense row
    ``row``, in place (the port of ``_jitted_scatter_row_kv``)."""
    for name, leaf in kv_leaves(cache).items():
        leaf[int(row)].copy_(_block_on(blocks[name], leaf))


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


def slot_prefill_many(model, cache, chunks, rows, starts, n_valids, sink,
                      lora=None):
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
    last page).  Rows must be distinct.  ``lora = (banks, adapter_ids
    [P])`` prefills each row under its adapter (pad rows: 0, the null
    adapter).  Returns the last-valid-position logits [P, V]; stores,
    pools and ``cache_index`` update in place."""
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
    logits = model(chunks.long(), sub, lora=lora)
    set_row_indices(cache, rows, starts + n_valids)
    pick = (n_valids.long() - 1).clamp(0, chunks.shape[1] - 1)
    return gather_vocab(logits, lambda lg: lg[
        torch.arange(lg.shape[0], device=lg.device), pick])


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


_M32 = 0xFFFFFFFF
# the tags of the noise streams: plain picks, and a speculative round's
# draft proposals, acceptance tests and residual resamples
TAG_PICK, TAG_DRAFT, TAG_ACCEPT, TAG_RESAMPLE = 0, 1, 2, 3


def _mul32(a, c):
    """``a * c mod 2**32`` for int64 tensors ``a`` in [0, 2**32) and a
    constant ``c`` (split in halves so no product leaves int64)."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x):
    """A 32-bit avalanche hash (lowbias32) of int64 tensors in [0,
    2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_uniform(seeds, ords, tag, n):
    """``[rows, n]`` f32 uniforms in (0, 1): element j of row b is a
    pure function of ``(seeds[b], ords[b], tag, j)`` (an integer hash, on
    the tensors' device).  ``seeds`` / ``ords`` are ``[rows]`` integer
    tensors."""
    seeds = seeds.long() & _M32
    ords = ords.long()
    k = _mix32(seeds ^ _mul32(torch.full_like(seeds, tag + 1), 0x9E3779B9))
    k = _mix32(k ^ (ords & _M32))
    k = _mix32(k ^ ((ords >> 32) & _M32))
    j = _mul32(torch.arange(n, device=seeds.device), 0x85EBCA6B)
    h = _mix32(k[:, None] ^ j[None, :])
    h = _mix32((h + k[:, None]) & _M32)
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def sample_noise(seeds, ords, vocab, tag=TAG_PICK):
    """Gumbel noise ``[rows, vocab]`` of :func:`counter_uniform`: the
    categorical draw of row b at ordinal ``ords[b]`` is
    ``argmax(logits + noise)``."""
    return -torch.log(-torch.log(counter_uniform(seeds, ords, tag, vocab)))


def _on(x, dev, dtype):
    """A per-row control (a host sequence or a tensor) as a tensor of
    ``dtype`` on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, dtype)
    return to_device(torch.tensor(list(x), dtype=dtype), dev)


def _filter_args(topks, topps, minps, dev):
    return (_on(topks, dev, torch.int64), _on(topps, dev, torch.float32),
            None if minps is None else _on(minps, dev, torch.float32))


def pick_tokens(logits, temps, seeds, ords, topks=None, topps=None,
                minps=None, sampled=None):
    """Per-row token pick, shared by every decode path: greedy argmax
    where ``temps[b] == 0``, else a categorical draw from the
    temperature-scaled (and, with ``topks``, filtered) logits by the
    Gumbel-max rule with :func:`sample_noise` of ``(seeds[b], ords[b])``.
    The controls are per-row host sequences or device tensors;
    ``sampled=False`` promises no row samples (the noise is skipped; by
    default host sequences are looked at, tensors are not).  Returns
    [n] int64 on the logits' device."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    if sampled is None:
        sampled = (isinstance(temps, torch.Tensor)
                   or any(t > 0 for t in temps))
    if not sampled:
        return greedy
    dev = logits.device
    t = _on(temps, dev, torch.float32)
    scaled = logits / t.clamp_min(1e-6)[:, None]
    if topks is not None:
        scaled = filter_top_k_p(scaled,
                                *_filter_args(topks, topps, minps, dev))
    noise = sample_noise(_on(seeds, dev, torch.int64),
                         _on(ords, dev, torch.int64), logits.shape[-1])
    pick = torch.argmax(scaled + noise, dim=-1)
    return torch.where(t > 0, pick, greedy)


def apply_repetition_penalty(logits, seen, rep):
    """HF-style repetition penalty, shared by every decode path: logits
    of tokens already seen (``seen [n, V]`` nonzero) divide by ``rep``
    where positive and multiply where negative (``rep [n]`` f32; 1.0
    disables).  Applied to the RAW logits, before temperature and the
    filters, so it moves greedy picks too."""
    pen = torch.where(logits > 0, logits / rep[:, None],
                      logits * rep[:, None])
    return torch.where(seen > 0, pen, logits)


def seen_from_prompt(prompt, vocab_size):
    """``[B, V]`` int8 presence table of the prompt tokens ``[B, T]`` (a
    tensor; the table lands on its device): the initial ``seen`` of
    :func:`apply_repetition_penalty`."""
    B = prompt.shape[0]
    seen = torch.zeros((B, vocab_size), dtype=torch.int8,
                       device=prompt.device)
    seen.scatter_(1, prompt.long(), 1)
    return seen


def check_penalty(repetition_penalty):
    """Validate a repetition penalty; True when active.  The finite cap
    matters: rep = inf times a zero-valued seen logit is NaN."""
    if not 0 < repetition_penalty <= 1e6:
        raise ValueError(
            f"repetition_penalty={repetition_penalty!r} must be in "
            "(0, 1e6] (1.0 disables; >1 discourages repeats)")
    return repetition_penalty != 1.0


def slot_step(model, cache, toks, temps, seeds, ords, topks=None,
              topps=None, minps=None, rems=None, eoss=None, eos_on=None,
              seen=None, reps=None, lora=None, sampled=None):
    """One decode step over ALL slots (``_slot_step_body``): feed each
    row its current token ``toks [n]`` (a device tensor, the previous
    step's pick), then pick per row (:func:`pick_tokens`).  Free rows
    step too; their writes land in the sink page (paged) or past their
    window.  Returns the picks [n]; the cache advances in place.

    ``seen`` / ``reps`` ([n, V] int8, [n] f32): the repetition penalty;
    the fed token joins ``seen`` (in place) before the penalty applies.
    ``lora = (banks, ids)``: per-row adapters (``Transformer.forward``).

    With ``rems`` / ``eoss`` / ``eos_on`` ([n] device tensors: remaining
    budget, eos id, whether an eos is set) the stop decision runs on the
    device too: returns ``(picks, rems - 1, done)`` with ``done[b]``
    raised when row b's budget hits zero or it picked its eos, so the
    serving engine reads the verdict back with the tokens and never
    inspects token values to decide whether to keep dispatching."""
    logits = gather_vocab(model(toks.long()[:, None], cache, lora=lora),
                          lambda lg: lg[:, -1])
    if seen is not None:
        seen[torch.arange(toks.shape[0], device=toks.device),
             toks.long()] = 1
        logits = apply_repetition_penalty(logits, seen, reps)
    pick = pick_tokens(logits, temps, seeds, ords, topks, topps, minps,
                       sampled)
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
             kv_dtype=None, repetition_penalty=1.0):
    """Generate continuations of ``prompt`` [B, T0] -> [B, T0 +
    max_new_tokens] through the paged slot path (one slot per row).

    ``temperature == 0`` is greedy argmax; > 0 samples, optionally top-k
    / top-p / min-p filtered, with row b drawing from seed ``seed + b``
    (required when sampling).  With ``eos_id``, rows that emit it keep
    emitting it.  ``repetition_penalty`` > 1 discourages tokens of the
    prompt and of the output so far (:func:`apply_repetition_penalty`,
    on the raw logits).  ``device`` follows the port's device rule (default
    ``cuda``; raises without one unless ``device="cpu"``); the model's
    parameters must live there.  ``kv_dtype="int8"`` decodes on an int8
    paged pool, as the batcher serves it (None: the config's).  Returns
    an int64 tensor on that device.  A tp-split model generates on its
    mesh: every rank calls this alike inside ``use_mesh(mesh)`` and gets
    the same tokens.
    """
    dev = device_mod.resolve(device)
    param_dev = next(model.parameters()).device
    if param_dev.type != dev.type or (
            dev.index is not None and param_dev.index != dev.index):
        raise ValueError(f"model parameters are on {param_dev}, not {dev}")
    check_tp_decode(model)
    check_pick_args(temperature, top_k, top_p, min_p)
    penalized = check_penalty(repetition_penalty)
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
        pkw = {}
        if penalized:
            pkw = {"seen": seen_from_prompt(prompt.to(dev), cfg.vocab_size),
                   "reps": torch.full((B,), float(repetition_penalty),
                                      device=dev)}
            last = apply_repetition_penalty(last, pkw["seen"], pkw["reps"])
        tok = pick_tokens(last, temps, seeds, [0] * B, **fkw)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        if eos_id is not None:
            done = tok == eos_id
        out = [tok]
        for t in range(1, max_new_tokens):
            nxt = slot_step(model, cache, tok, temps, seeds, [t] * B, **fkw,
                            **pkw)
            if eos_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
                done = done | (nxt == eos_id)
            out.append(nxt)
            tok = nxt
    return torch.cat([prompt.to(dev), torch.stack(out, dim=1)], dim=1)


# ---- speculative decoding ---------------------------------------------------

def _last_logits(model, toks, cache):
    """One cached step of ``toks [n]``: the whole-vocabulary logits
    ``[n, V]`` (a draft's step)."""
    return gather_vocab(model(toks[:, None], cache), lambda lg: lg[:, -1])


def _first_false(mask):
    """Index of the first False of each row of ``mask [n, k]`` (k where
    every entry is True)."""
    k = mask.shape[1]
    miss = ~mask
    return torch.where(miss.any(dim=1), miss.int().argmax(dim=1),
                       torch.full_like(mask[:, 0], k, dtype=torch.int64))


def ngram_propose(ctx, ctx_len, k, max_match=3):
    """Model-free draft (prompt-lookup decoding): ``k`` continuation
    tokens per row by suffix-matching the row's own context.

    ``ctx [n, C]`` holds each row's committed tokens (prompt + delivered
    output), ``ctx_len [n]`` the valid length; ``ctx[r, ctx_len[r] - 1]``
    is the token fed this round.  Each position re-matches the
    block-so-far suffix (up to ``max_match`` tokens, longest match wins,
    the most recent site breaks ties) against the context with the
    earlier proposals virtually appended, so proposal i is a pure
    function of the committed prefix at that ordinal.  A row with no
    match repeats its last token."""
    n, C = ctx.shape
    ctx_len = ctx_len.long()
    pos = torch.arange(C, device=ctx.device)[None, :]
    ctx_v = ctx.long().clone()
    props = []
    for i in range(k):
        len_v = ctx_len + i
        tail = [ctx_v.gather(1, (len_v - 1 - g).clamp(0, C - 1)[:, None])[:, 0]
                for g in range(max_match)]
        score = torch.zeros((n, C), dtype=torch.int64, device=ctx.device)
        chain = torch.ones((n, C), dtype=torch.bool, device=ctx.device)
        shifted = ctx_v
        for g in range(max_match):
            chain = (chain & (shifted == tail[g][:, None])
                     & (len_v >= g + 1)[:, None])
            score = score + chain.long()
            # compare position j-(g+1) next: shift right, j=0 invalid
            shifted = torch.cat([torch.full_like(shifted[:, :1], -1),
                                 shifted[:, :-1]], dim=1)
        # a candidate j needs its continuation inside the valid region
        # (j <= len - 2, which also rules out the trivial self-match)
        valid = pos <= (len_v - 2)[:, None]
        rank = torch.where(valid & (score >= 1), score * (C + 1) + pos,
                           torch.full_like(score, -1))
        j_star = rank.argmax(dim=1)
        found = rank.gather(1, j_star[:, None])[:, 0] >= 0
        cont = ctx_v.gather(1, (j_star + 1).clamp(0, C - 1)[:, None])[:, 0]
        prop = torch.where(found, cont, tail[0])
        props.append(prop)
        # virtual append; a full row keeps its last column
        at = len_v.clamp(max=C - 1)[:, None]
        ctx_v.scatter_(1, at, torch.where(
            (len_v < C)[:, None], prop[:, None], ctx_v.gather(1, at)))
    return torch.stack(props, dim=1)


def ngram_append(ctx, ctx_len, c_tok, n_del):
    """Commit a round's deliverable tokens into the n-gram table, in
    place: ``c_tok[r, :n_del[r]]`` lands at ``ctx_len[r]``.  ``ctx`` is
    ``[n, C + 1]``: masked and overflowing writes go to the spare last
    column.  Returns the new ``ctx_len``."""
    n, k = c_tok.shape
    C = ctx.shape[1] - 1
    j = torch.arange(k, device=ctx.device)[None, :]
    pos = ctx_len.long()[:, None] + j
    pos = torch.where(j < n_del.long()[:, None], pos.clamp(max=C),
                      torch.full_like(pos, C))
    ctx.scatter_(1, pos, c_tok.to(ctx.dtype))
    return ctx_len + n_del.to(ctx_len.dtype)


def set_row_ctx(ctx, ctx_len, row, toks):
    """Install one row's committed tokens into the n-gram table (at
    admission), in place."""
    t = torch.as_tensor(toks, dtype=ctx.dtype)
    ctx[row, :t.shape[0]] = to_device(t, ctx.device)
    ctx_len[row] = t.shape[0]


def spec_accept_sampled(t_logits, props, temps, seeds, ords, topks=None,
                        topps=None, minps=None, q_logits=None):
    """The speculative-sampling acceptance walk (Leviathan et al.; Chen
    et al.) over one verify block, as the JAX package's
    ``spec_accept_sampled``.

    ``t_logits [n, k, V]`` are the target's raw logits at the k block
    positions, ``props [n, k]`` the proposals, ``q_logits`` the
    proposer's scaled (and filtered) logits or None for point-mass
    proposals (n-gram, greedy drafts).  Position i accepts with
    probability min(1, p_i(x_i) / q_i(x_i)), computed as ``u * q < p``;
    the first rejection resamples from the residual max(p - q, 0) (for a
    point mass: p with the proposal zeroed), renormalised.  Chained over
    positions this reproduces the target's sampling distribution.  The
    uniforms and the resample noise come from the ``TAG_ACCEPT`` /
    ``TAG_RESAMPLE`` streams at each position's ordinal ``ords + i``.

    Returns ``(c_tok [n, k], commit [n])``: row r commits
    ``c_tok[r, :commit[r]]``."""
    n, k, V = t_logits.shape
    dev = t_logits.device
    temps = _on(temps, dev, torch.float32)
    seeds = _on(seeds, dev, torch.int64)
    ords = _on(ords, dev, torch.int64)
    scaled = t_logits.float() / temps.clamp_min(1e-6)[:, None, None]
    if topks is not None:
        fargs = _filter_args(topks, topps, minps, dev)
        p_sl = torch.stack([filter_top_k_p(scaled[:, i], *fargs)
                            for i in range(k)], dim=1)
    else:
        p_sl = scaled
    p_probs = torch.softmax(p_sl, dim=-1)
    props = props.long()
    p_prop = p_probs.gather(-1, props[..., None])[..., 0]
    if q_logits is None:
        q_probs = None
        q_prop = torch.ones_like(p_prop)
    else:
        q_probs = torch.softmax(q_logits.float(), dim=-1)
        q_prop = q_probs.gather(-1, props[..., None])[..., 0]
    u = torch.stack([counter_uniform(seeds, ords + i, TAG_ACCEPT, 1)[:, 0]
                     for i in range(k)], dim=1)
    accept = u * q_prop < p_prop
    j = _first_false(accept)
    if q_probs is None:
        res = p_probs.scatter(-1, props[..., None], 0.0)
    else:
        res = (p_probs - q_probs).clamp_min(0.0)
    # a degenerate residual (p == q to float precision) falls back to p
    res_ok = res.sum(dim=-1, keepdim=True) > 1e-9
    res_l = torch.where(res_ok, torch.where(
        res > 0, torch.log(res), torch.full_like(res, -math.inf)), p_sl)
    y = torch.stack([torch.argmax(res_l[:, i] + sample_noise(
        seeds, ords + i, V, TAG_RESAMPLE), dim=-1) for i in range(k)], dim=1)
    commit = j.clamp(max=k - 1) + 1
    ii = torch.arange(k, device=dev)[None, :]
    c_tok = torch.where(ii == j[:, None], y, props)
    return c_tok, commit


def _stop_walk(c_tok, commit, rems, eoss, eos_on):
    """The per-row stop decision over a round's committed tokens
    ``c_tok [n, k]``: ``(n_del, done, rems_new)``.  ``n_del[r]`` counts
    the deliverable tokens (committed, within the remaining budget, not
    past the first eos), ``done[r]`` is raised when the budget is spent
    or an eos was delivered — the host loop's per-token walk, batched."""
    ii = torch.arange(c_tok.shape[1], device=c_tok.device)[None, :]
    is_eos = eos_on[:, None] & (c_tok == eoss[:, None]) & (
        ii < commit[:, None])
    j_eos = _first_false(~is_eos)
    n_del = torch.minimum(commit, torch.minimum(rems.clamp_min(0).long(),
                                                j_eos + 1))
    rems_new = rems - n_del.to(rems.dtype)
    return n_del, (rems_new <= 0) | (j_eos < n_del), rems_new


def slot_spec_round_greedy(model, draft, t_cache, d_cache, toks, rems=None,
                           eoss=None, eos_on=None, k=4):
    """Speculation v1, the JAX package's ``_jitted_slot_spec_round``:
    one greedy round over ALL rows of dense slot caches.  ``k`` draft
    slot steps propose, ONE target pass verifies the ``[n, k]`` block,
    each row commits the longest prefix of proposals equal to the
    target's argmax plus the target's next argmax (1..k tokens, every
    one the target's own greedy choice), and both caches rewind per row
    to the committed length.  Unlike the grouped `speculative_generate`
    (batch-min acceptance), each row advances at its own agreement.

    Returns ``(new_toks, t_next [n, k], commit, t_cache, d_cache)``: row
    r committed ``t_next[r, :commit[r]]``.  With ``rems`` / ``eoss`` /
    ``eos_on`` the stop walk joins the round on the device and it
    returns ``(new_toks, t_next, commit, n_del, done, rems_new, t_cache,
    d_cache)`` (`_stop_walk`).  The caches update in place.  No server
    flag reaches it: the JAX server, as the port's, serves v2
    (`spec_round`)."""
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    idx = t_cache.cache_index
    toks = toks.long()
    d_tok, props = toks, []
    for _ in range(k):
        d_tok = torch.argmax(_last_logits(draft, d_tok, d_cache), dim=-1)
        props.append(d_tok)
    props = torch.stack(props, dim=1)                        # [n, k]
    block = torch.cat([toks[:, None], props[:, :-1]], dim=1)
    t_next = torch.argmax(gather_vocab(model(block, t_cache)), dim=-1)
    commit = _first_false(props == t_next).clamp(max=k - 1) + 1
    new_toks = t_next.gather(1, (commit - 1)[:, None])[:, 0]
    t_cache.cache_index = (idx + commit).to(torch.int32)
    d_cache.cache_index = (idx + commit).to(torch.int32)
    if rems is None:
        return new_toks, t_next, commit, t_cache, d_cache
    n_del, done, rems_new = _stop_walk(t_next, commit, rems, eoss, eos_on)
    return (new_toks, t_next, commit, n_del, done, rems_new, t_cache,
            d_cache)


def spec_round(model, cache, toks, temps, seeds, ords, rems, eoss, eos_on,
               k, draft=None, d_cache=None, ctx=None, ctx_len=None,
               lora=None, topks=None, topps=None, minps=None, sampled=True):
    """One speculative round over ALL slots, the JAX package's fused
    round v2, with no host sync: k proposals per row (``draft`` slot
    steps on ``d_cache``, or, without a draft, :func:`ngram_propose`
    over ``ctx [n, C + 1]`` / ``ctx_len``), ONE target pass over the
    ``[n, k]`` block, and each row commits 1..k tokens:

    - greedy rows (``temps <= 0``) take the longest prefix of proposals
      equal to the target's argmax plus the target's next argmax: every
      committed token is the target's own greedy choice;
    - sampled rows run :func:`spec_accept_sampled` on the same scaled
      and filtered logits the plain step samples from (``sampled=False``
      promises there are none).

    ``lora`` applies the per-row adapters to the verify pass only (the
    draft runs on base weights).  Both caches, and the n-gram table,
    advance per row by the commit; the budget / eos walk runs over the
    committed tokens.  Returns ``(new_toks, c_tok [n, k], commit, n_del,
    done, rems_new, ords_new, ctx_len_new)`` (``ctx_len_new`` None in
    model mode); caches and ``ctx`` update in place.  On a tp mesh every
    logit read is the whole vocabulary's (``gather_vocab``), so each
    rank proposes, accepts and commits alike."""
    idx = cache.cache_index
    is_g = temps <= 0
    toks = toks.long()

    def scaled(logits):
        s = logits.float() / temps.clamp_min(1e-6)[:, None]
        if topks is not None:
            s = filter_top_k_p(s, topks, topps, minps)
        return s

    q_sl = None
    if draft is None:
        props = ngram_propose(ctx[:, :-1], ctx_len, k)
    else:
        d_tok, plist, qlist = toks, [], []
        for i in range(k):
            dl = _last_logits(draft, d_tok, d_cache).float()
            greedy = torch.argmax(dl, dim=-1)
            if sampled:
                d_sc = scaled(dl)
                drawn = torch.argmax(d_sc + sample_noise(
                    seeds, ords + i, dl.shape[-1], TAG_DRAFT), dim=-1)
                d_tok = torch.where(is_g, greedy, drawn)
                qlist.append(d_sc)
            else:
                d_tok = greedy
            plist.append(d_tok)
        props = torch.stack(plist, dim=1)
        if sampled:
            q_sl = torch.stack(qlist, dim=1)
    block = torch.cat([toks[:, None], props[:, :-1]], dim=1)
    t_logits = gather_vocab(model(block, cache, lora=lora))
    t_pick = torch.argmax(t_logits, dim=-1)
    commit = _first_false(props == t_pick).clamp(max=k - 1) + 1
    c_tok = t_pick
    if sampled:
        c_s, commit_s = spec_accept_sampled(
            t_logits, props, temps, seeds, ords, topks, topps, minps,
            q_logits=q_sl)
        commit = torch.where(is_g, commit, commit_s)
        c_tok = torch.where(is_g[:, None], t_pick, c_s)
    new_toks = c_tok.gather(1, (commit - 1)[:, None])[:, 0]
    cache.cache_index = (idx + commit).to(torch.int32)
    if d_cache is not None:
        d_cache.cache_index = (idx + commit).to(torch.int32)
    n_del, done, rems_new = _stop_walk(c_tok, commit, rems, eoss, eos_on)
    ctx_len_new = None
    if draft is None:
        ctx_len_new = ngram_append(ctx, ctx_len, c_tok, n_del)
    return (new_toks, c_tok, commit, n_del, done, rems_new,
            ords + commit, ctx_len_new)


def speculative_generate(model, draft_model, prompt, max_new_tokens, k=4,
                         device=None):
    """Greedy generation with draft-model speculation: exactly the tokens
    of ``generate(model, prompt, max_new_tokens)``, from fewer target
    passes when the draft agrees.  Each round the draft proposes ``m <=
    k`` tokens, one target pass verifies them, and every row advances by
    the batch's shortest accepted prefix plus the target's own next
    token (the JAX package's grouped ``speculative_generate``); rejected
    kv is discarded by rewinding ``cache_index``.  Both models run on
    dense slot caches with ``k`` positions of headroom."""
    dev = device_mod.resolve(device)
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    for m in (model, draft_model):
        check_tp_decode(m)
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64)
    if max_new_tokens <= 0:
        return prompt.to(dev)
    B, T0 = prompt.shape
    if model.cfg.vocab_size != draft_model.cfg.vocab_size:
        raise ValueError(f"target vocab {model.cfg.vocab_size} != draft "
                         f"vocab {draft_model.cfg.vocab_size}")
    for cfg in (model.cfg, draft_model.cfg):
        if T0 + max_new_tokens + k > cfg.max_seq_len:
            raise ValueError(
                f"prompt {T0} + max_new_tokens {max_new_tokens} + k {k} "
                f"exceeds max_seq_len {cfg.max_seq_len}")
    _, t_cache = init_slot_cache(model, B)
    _, d_cache = init_slot_cache(draft_model, B)
    rows = torch.arange(B, device=dev)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    full = torch.full((B,), T0, dtype=torch.int32, device=dev)
    with torch.no_grad():
        last = torch.argmax(slot_prefill_many(
            model, t_cache, prompt.to(dev), rows, zero, full, 0), dim=-1)
        slot_prefill_many(draft_model, d_cache, prompt.to(dev), rows, zero,
                          full, 0)
        committed = [last]
        base = T0
        while len(committed) < max_new_tokens:
            m = min(k, max_new_tokens - len(committed))
            d_tok, props = last, []
            for _ in range(m):
                d_tok = torch.argmax(
                    _last_logits(draft_model, d_tok, d_cache), dim=-1)
                props.append(d_tok)
            props = torch.stack(props, dim=1)
            block = torch.cat([last[:, None], props[:, :-1]], dim=1)
            t_next = torch.argmax(gather_vocab(model(block, t_cache)),
                                  dim=-1)
            # the batch's shortest agreement (a deliberate host read:
            # every row advances by it)
            a = min(int(_first_false(props == t_next).min()), m - 1)
            committed.extend(props[:, j] for j in range(a))
            last = t_next[:, a]
            committed.append(last)
            base += 1 + a
            for c in (t_cache, d_cache):
                c.cache_index = torch.full_like(c.cache_index, base)
    new = torch.stack(committed[:max_new_tokens], dim=1)
    return torch.cat([prompt.to(dev), new], dim=1)
