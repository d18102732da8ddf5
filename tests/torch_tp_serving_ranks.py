"""One rank of the port's tp serving checks (``tests/test_torch_tp_serving.py``),
run as its own interpreter so that it imports torch and the port only,
never JAX:

    python tests/torch_tp_serving_ranks.py RANK WORLD DIR

``DIR/inputs.pkl`` holds the configs, their flax parameter trees (numpy,
seeded), the draft's, the prompts and the adapters.  The rank joins a
gloo world of ``WORLD`` ranks through a FileStore in ``DIR`` (its
collectives time out after ``TIMEOUT_S``, so a hung one fails instead of
waiting), splits each model over ``MeshSpec(tp=WORLD)`` and runs every
case of ``run_config`` (the quantised ones of ``run_quant`` on
QUANT_GROUPS' configs), then the refusals; rank 0 also runs the same
cases on the whole model with no mesh (the port at tp 1): in the world of ``tp1_world`` ranks
only, each rank a share of the configs (``tp1_configs``).  Writes
``DIR/rank<RANK>.pkl``.
"""
import contextlib
import datetime
import os
import pickle
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tensorflowonspark_tpu_torch import (  # noqa: E402
    convert, export, lora, quantize, serve)
from tensorflowonspark_tpu_torch.models import decode  # noqa: E402
from tensorflowonspark_tpu_torch.models import transformer as port_tf  # noqa: E402
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from tensorflowonspark_tpu_torch.parallel import sharding  # noqa: E402

TIMEOUT_S = 120
NEW = 6
SAMPLED = dict(temperature=0.8, seed=7, top_k=20)
# 4 slots, readbacks of 2 steps, chunks of 16 tokens over 2 rows
ENGINE = dict(n_slots=4, read_chunk=2, prefill_chunk=16, prefill_rows=2)
PAGED = dict(kv_page_size=8, kv_pages=48)
# (d): an int8 pool, a shared prefix, a table grow and the lane; the
# dense cache in int8 on the serial engine; both with a greedy, a
# sampled (filtered) and a penalised row
EXTRAS = dict(PAGED, kv_dtype="int8", long_prompt_threshold=40)
DENSE_INT8 = dict(kv_dtype="int8", engine="serial")
MIXED = [{}, dict(temperature=0.8, seed=5, top_k=20, top_p=0.9),
         dict(repetition_penalty=1.3)]
VARIANTS = {"dense_async": dict(engine="async"),
            "dense_serial": dict(engine="serial"),
            "paged_async": dict(PAGED, engine="async"),
            "paged_serial": dict(PAGED, engine="serial")}
# (e): a base row and rows of two adapters, one adapter on two rows
LORA_ROWS = [{}, {"adapter": "a"}, {"adapter": "b"}, {"adapter": "a"}]
# (g)-(i): quantised weights on these configs, each at an int4 group that
# divides its every row-parallel K / tp (d_model 32: out 16 / 8 and wo 32
# / 16 rows a rank; d_model 48: out 24 / 12), every projection quantised
QUANT_GROUPS = {"gqa8": 8, "uneven": 4}
QUANT_MIN = 256
QUANT_VARIANTS = ("dense_serial", "paged_async")
# (j): an int4 group of 32 straddles gqa4's row-parallel out split (K 32
# over 2 or 4 ranks)
STRADDLE_GROUP = 32
# (k): speculation on the extras config, a greedy and a sampled row and
# a greedy row that shares the first one's prefix; the serial engines
# take one request at a time (their round counts and adaptive k are then
# a function of the requests alone), the async one a burst (a draft
# step costs a forward's collectives: over gloo here 2.5 ms each at tp
# 2, 13 ms at tp 4)
SPEC_ROWS = [{}, dict(temperature=0.8, seed=5, top_k=20), {}]
SPEC_ENGINES = {
    "spec_ngram": dict(PAGED, engine="serial", spec_draft="ngram"),
    "spec_draft": dict(PAGED, engine="serial", draft=True),
    "spec_ngram_dense": dict(engine="async", spec_draft="ngram")}
SPEC_ONE_AT_A_TIME = ("spec_ngram", "spec_draft")
SPEC_STATS = ("spec_rounds", "spec_tokens_accepted", "spec_k_mean")


def whole_model(inp, name, params=None):
    cfg = inp["cfgs"][name]
    if params is not None:       # the draft: the config's widths, 1 layer
        cfg = dict(cfg, n_layers=1)
    model = port_tf.build_transformer(**cfg)
    model.load_state_dict(convert.params_from_jax(
        inp["params"][name] if params is None else params), strict=True)
    return model.eval().requires_grad_(False)


def split(model, mesh):
    """``model`` split over ``mesh`` (None: whole)."""
    if mesh is None:
        return model
    return sharding.shard_params(
        model, sharding.infer_param_shardings(model, mesh))


def split_model(inp, name, mesh):
    return split(whole_model(inp, name), mesh)


def quantised_model(inp, name, mode, mesh):
    """Config ``name`` quantised whole (every rank the same masters),
    then split."""
    model = whole_model(inp, name)
    quantize.quantize_module(model, mode, group_size=QUANT_GROUPS[name],
                             min_elements=QUANT_MIN)
    return split(model, mesh)


def on(mesh):
    return (mesh_mod.use_mesh(mesh) if mesh is not None
            else contextlib.nullcontext())


def first_logits(model, mesh, prompts):
    """Whole-vocabulary logits of each prompt's last position from a
    paged slot-cache prefill (the cache holds this rank's kv heads)."""
    B, T = len(prompts), len(prompts[0])
    with torch.no_grad(), on(mesh):
        _, cache = decode.init_paged_slot_cache(model, B, 8, 4 * B + 1,
                                                device="cpu")
        for b in range(B):
            decode.set_row_page_table(cache, b, list(range(4 * b, 4 * b + 4))
                                      + [4 * B] * (cache.page_table.shape[1]
                                                   - 4))
        logits = decode.slot_prefill_many(
            model, cache, torch.tensor(prompts), torch.arange(B),
            torch.zeros(B, dtype=torch.int32),
            torch.full((B,), T, dtype=torch.int32), 4 * B)
    return cache.pages_key[0].shape[2], logits.numpy()


def generated(model, mesh, prompts, **kw):
    with on(mesh):
        return decode.generate(model, prompts, NEW, device="cpu",
                               **kw).tolist()


def drive(b, prompts, kws=None, new=NEW, one_at_a_time=False):
    """Requests admitted at different times: each after the previous
    one's first token (``one_at_a_time``: after its result)."""
    kws = kws or [{}] * len(prompts)
    handles = []
    for p, kw in zip(prompts, kws):
        handles.append(b.submit(p, new, **kw))
        if one_at_a_time:
            handles[-1].result(timeout=TIMEOUT_S)
        else:
            handles[-1].tokens.get(timeout=TIMEOUT_S)
    return [h.result(timeout=TIMEOUT_S) for h in handles]


def engine(model, mesh, leader, prompts, kws=None, adapters=None, new=NEW,
           one_at_a_time=False, **kw):
    """Every rank builds the engine inside use_mesh; the leader drives the
    requests and stops it, a follower replays until that stop.  Returns
    ``(outputs, stats)``: a follower's outputs None, its stats the pool's
    bytes and the speculation counters."""
    with on(mesh):
        b = serve.ContinuousBatcher(model, device="cpu", **dict(ENGINE, **kw))
    if not leader:
        b.follow(timeout=TIMEOUT_S)
        st = b.stats()
        return None, {k: st[k] for k in ("kv_pool_bytes",) + SPEC_STATS}
    try:
        for name, tree in (adapters or {}).items():
            b.register_adapter(name, tree)
        outs = drive(b, prompts, kws, new, one_at_a_time)
        return outs, b.stats()
    finally:
        b.stop()


def out_only_logits(model, mesh, index, inp, name):
    """Last-position logits of the prompts with no adapter and with the
    out-only adapter (its query / key / value banks zero), this rank's
    parts of its banks from ``lora.bank_slices``."""
    tree = inp["out_only"][name]
    attn = getattr(model, model.layer_names[0]).attn
    slices = lora.bank_slices(attn, index)
    banks = {}
    for layer in model.layer_names:
        bank = {}
        la = getattr(model, layer).attn
        for proj, (rows, cols) in slices.items():
            dense = getattr(la, proj)
            d_out, d_in = (dense.out_features, dense.in_features)
            a = np.zeros((d_in, inp["rank"]), np.float32)
            b = np.zeros((inp["rank"], d_out), np.float32)
            key = f"{layer}/attn/{proj}/kernel"
            if key in tree:
                a, b = tree[key]["a"], tree[key]["b"]
            a, b = torch.from_numpy(a)[rows], torch.from_numpy(b)[:, cols]
            bank[f"{proj}_a"] = torch.stack([torch.zeros_like(a), a])
            bank[f"{proj}_b"] = torch.stack([torch.zeros_like(b), b])
        banks[layer] = bank
    toks = torch.tensor(inp["gen_prompts"])
    out = {}
    with torch.no_grad(), on(mesh):
        for label, ids in (("base", [0, 0]), ("out_only", [1, 1])):
            logits = model(toks, lora=(banks, torch.tensor(ids)))
            out[label] = port_tf.gather_vocab(
                logits, lambda lg: lg[:, -1]).numpy()
    return out


def extra_cases(inp):
    """The extras config's engines, ``{label: (prompts, each row's
    options, adapters, engine arguments)}`` (the test runs the JAX
    batcher on the same; ``draft=True``: the config's 1-layer draft)."""
    prompts, extra = inp["prompts"], inp["extra_prompts"]
    spec_prompts = [extra[0], extra[2], extra[1]]
    return {
        "extras": (extra, MIXED, {}, EXTRAS),
        "dense_int8": (prompts, MIXED, {}, DENSE_INT8),
        "lora": (prompts + prompts[:1], LORA_ROWS,
                 {n: inp["adapters"][n] for n in ("a", "b")},
                 dict(VARIANTS["paged_async"], lora_rank=inp["rank"],
                      lora_capacity=3)),
        **{label: (spec_prompts, SPEC_ROWS, {}, kw)
           for label, kw in SPEC_ENGINES.items()}}


def run_quant(inp, name, mesh, leader):
    """(g)-(i) on config ``name``: each mode's quantised leaves on this
    rank, ``generate`` of the first prompt and the batchers' outputs; on
    gqa8 also a stored int8 export loaded as the server loads it."""
    out = {}
    for mode in quantize.MODES:
        model = quantised_model(inp, name, mode, mesh)
        out[mode] = dict(
            leaves={n: t.numpy().copy() for n, t in
                    sharding.quantized_tensors(model).items()},
            generate=generated(model, mesh, inp["prompts"][:1])[0],
            engines={v: engine(model, mesh, leader, inp["prompts"],
                               **VARIANTS[v]) for v in QUANT_VARIANTS})
    if name == "gqa8":
        path = os.path.join(inp["dir"], f"export_int8_rank{mesh.rank}")
        export.export_saved_model(
            path, whole_model(inp, name).state_dict(),
            builder_kwargs=inp["cfgs"][name], quantize_int8=True,
            quantize_kwargs={"min_elements": QUANT_MIN})
        model = split(serve._load_lm(path, "int8", "cpu"), mesh)
        out["stored_int8"] = engine(model, mesh, leader, inp["prompts"],
                                    **VARIANTS["paged_async"])
    return out


def run_config(inp, name, mesh, leader, index):
    """Every case of one config on ``mesh`` (None: the whole model, the
    quantised cases left out)."""
    model = (split_model(inp, name, mesh) if mesh is not None
             else whole_model(inp, name))
    prompts = inp["prompts"]
    res = {}
    res["cache_heads"], res["first_logits"] = first_logits(
        model, mesh, inp["gen_prompts"])
    res["greedy"] = generated(model, mesh, inp["gen_prompts"])
    res["sampled"] = generated(model, mesh, inp["gen_prompts"], **SAMPLED)
    res["engines"] = {}
    for label, kw in VARIANTS.items():
        res["engines"][label] = engine(model, mesh, leader, prompts, **kw)
    if name == inp["extras_config"]:
        draft = split(whole_model(inp, name, inp["draft_params"]), mesh)
        for label, (ps, kws, ads, kw) in extra_cases(inp).items():
            kw = dict(kw)
            if kw.pop("draft", False):
                kw["draft_model"] = draft
            res[label] = engine(model, mesh, leader, ps, kws=kws,
                                adapters=ads,
                                one_at_a_time=label in SPEC_ONE_AT_A_TIME,
                                **kw)
        res["out_only"] = out_only_logits(model, mesh, index, inp, name)
    if name in QUANT_GROUPS and mesh is not None:
        res["quant"] = run_quant(inp, name, mesh, leader)
    return res


def refusals(inp, mesh, rank):
    """Each queued feature on a tp mesh: the error's type and text."""
    name = inp["extras_config"]
    model = split_model(inp, name, mesh)
    out = {}

    def attempt(label, fn):
        try:
            fn()
            out[label] = None
        except Exception as e:   # recorded: the test reads type and text
            out[label] = (type(e).__name__, str(e))

    def build(**kw):
        with mesh_mod.use_mesh(mesh):
            b = serve.ContinuousBatcher(model, device="cpu",
                                        **dict(ENGINE, **kw))
        b.stop() if rank == 0 else b.follow(timeout=TIMEOUT_S)

    attempt("host_tier", lambda: build(host_cache_mb=1, **PAGED))
    attempt("preempt", lambda: build(preempt_ms=50.0))
    attempt("mismatch", lambda: build(n_slots=4 + rank))

    def straddle():
        whole = whole_model(inp, name)
        quantize.quantize_module(whole, "int4", group_size=STRADDLE_GROUP,
                                 min_elements=QUANT_MIN)
        sharding.infer_param_shardings(whole, mesh)

    attempt("int4_straddle", straddle)

    def kv_leaves():
        _, cache = decode.init_paged_slot_cache(model, 2, 8, 9, device="cpu")
        decode.gather_pages(cache, [0])

    attempt("migration", kv_leaves)
    attempt("dp_axis", lambda: mesh_mod.check_serving_mesh(mesh_mod.Mesh(
        mesh_mod.MeshSpec(dp=2, tp=2))))
    attempt("no_mesh", lambda: decode.generate(model, [[1, 2]], 2,
                                               device="cpu"))
    return out


def tp1_configs(inp, rank, world):
    """The configs whose whole-model cases this rank of the tp1_world
    runs: the extras config on rank 0, the others shared by the rest."""
    extras = inp["extras_config"]
    others = [n for n in inp["cfgs"] if n != extras]
    return [extras] if rank == 0 else others[rank - 1::world - 1]


def main(rank, world, d):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(d, 'store')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    inp["dir"] = d
    mesh = mesh_mod.build_mesh(mesh_mod.MeshSpec(dp=1, tp=world),
                               device="cpu")
    leader = mesh_mod.tp_leader(mesh) == rank
    t0 = time.monotonic()
    out = {"rank": rank, "leader": leader, "tp_index": mesh.coords["tp"],
           "configs": {}}
    for name in inp["cfgs"]:
        out["configs"][name] = run_config(inp, name, mesh, leader,
                                          mesh.coords["tp"])
    out["refusals"] = refusals(inp, mesh, rank)
    out["tp_s"] = time.monotonic() - t0
    dist.barrier()
    dist.destroy_process_group()
    if world == inp["tp1_world"]:
        out["tp1"] = {name: run_config(inp, name, None, True, 0)
                      for name in tp1_configs(inp, rank, world)}
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
