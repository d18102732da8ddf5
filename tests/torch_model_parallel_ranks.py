"""One rank of the multi-rank CPU checks of the port's split forward
(``tests/test_torch_tensor_parallel.py``, ``test_torch_context_parallel.py``
and ``test_torch_pipeline_parallel.py``), run as its own interpreter so
that it imports torch and the port only, never JAX:

    python tests/torch_model_parallel_ranks.py RANK WORLD DIR

``DIR/inputs.pkl`` holds the models' flax parameter trees (numpy), the
global token batch, the configs, the attention and pipeline inputs.  The
rank joins a gloo world through a FileStore in ``DIR``, runs every case,
and writes what it saw to ``DIR/rank<RANK>.pkl``.
"""
import datetime
import functools
import os
import pickle
import sys
import uuid

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tensorflowonspark_tpu_torch import (convert, data, feed, manager,  # noqa: E402
                                         optim, optim8bit)
from tensorflowonspark_tpu_torch.models import pipelined  # noqa: E402
from tensorflowonspark_tpu_torch.models import transformer as port_tf  # noqa: E402
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from tensorflowonspark_tpu_torch.parallel import pipeline  # noqa: E402
from tensorflowonspark_tpu_torch.parallel import sharding as sharding_mod  # noqa: E402
from tensorflowonspark_tpu_torch.parallel import train as port_train  # noqa: E402
from tensorflowonspark_tpu_torch.parallel import ulysses  # noqa: E402
from tensorflowonspark_tpu_torch.parallel.ring_attention import ring_attention  # noqa: E402

# label -> (mesh spec, config name, config overrides, kind, optimizer):
# kind "tp" shards by the JAX rules (fsdp too where the mesh has it),
# "cp" replicates the parameters and splits the sequence, "pp" builds a
# PipelinedLM with one stage a pp rank.  "sgd" (lr 1) steps reveal the
# step's whole gradient as the parameters' change.
CASES = {
    "tp4": (dict(dp=1, tp=4), "abs", {}, "tp", "sgd"),
    "dp2tp2_sp": (dict(dp=2, tp=2), "rope", {"sp_axis": "tp"}, "tp", "sgd"),
    "ring4": (dict(dp=1, tp=4), "rope", {"ring_attention_axis": "tp"},
              "cp", "sgd"),
    "ring4_plain": (dict(dp=1, tp=4), "abs",
                    {"ring_attention_axis": "tp", "attention_impl": "dense"},
                    "cp", "sgd"),
    "dp2ulysses2": (dict(dp=2, tp=2), "abs", {"ulysses_axis": "tp"}, "cp",
                    "sgd"),
    "ulysses4": (dict(dp=1, tp=4), "rope", {"ulysses_axis": "tp"}, "cp",
                 "sgd"),
    "pp4": (dict(dp=1, pp=4), "abs", {}, "pp", "sgd"),
    "dp2pp2": (dict(dp=2, pp=2), "rope", {}, "pp", "sgd"),
    "fsdp2tp2_adamw": (dict(dp=1, fsdp=2, tp=2), "short", {}, "tp",
                       "adamw_fused"),
    "fsdp2tp2_8bit": (dict(dp=1, fsdp=2, tp=2), "short", {}, "tp",
                      "adamw8bit"),
}


def _np(t):
    return t.detach().to(torch.float32).numpy().copy()


def _cfg(inp, name, over):
    return dict(inp["cfgs"][name], **over)


def _loss(model, batch, rng):
    return port_tf.lm_loss(model(batch[0]), batch[1])


def _build(inp, mesh, name, over, kind):
    """The case's model (full parameters) and its shardings."""
    cfg = _cfg(inp, name, over)
    sd = convert.params_from_jax(inp["params"][name])
    if kind == "pp":
        model = pipelined.PipelinedLM(port_tf.TransformerConfig(**cfg),
                                      n_stages=mesh.shape["pp"])
    else:
        model = port_tf.build_transformer(**cfg)
    model.load_state_dict(sd, strict=True)
    rules = () if kind == "cp" else sharding_mod.DEFAULT_RULES
    shardings = sharding_mod.infer_param_shardings(
        model, mesh, rules=rules, fsdp=mesh.shape["fsdp"] > 1)
    return model, shardings


def _batch(inp, mesh, kind):
    tokens = inp["tokens"]
    xy = (tokens[:, :-1], tokens[:, 1:])
    seq = "tp" if kind == "cp" else None
    local = mesh_mod.local_rows(xy, mesh, seq_axis=seq)
    return mesh_mod.put_batch(local, mesh_mod.batch_sharding(mesh, seq))


def _moments(state):
    q8 = port_train._states_8bit(state.opt_state)
    if q8:
        return {"q8": {k: {n: (qt.q.numpy().copy(), qt.scale.numpy().copy())
                           for n, qt in getattr(q8[0], k).items()}
                       for k in ("mu", "nu_sqrt")}}
    return {"mu": {n: _np(t) for n, t in state.opt_state.mu.items()},
            "nu": {n: _np(t) for n, t in state.opt_state.nu.items()}}


def run_case(inp, spec, name, over, kind, opt_name):
    mesh = mesh_mod.build_mesh(mesh_mod.MeshSpec(**spec), device="cpu")
    model, shardings = _build(inp, mesh, name, over, kind)
    layouts = None
    kw = dict(inp["opt"].get(opt_name, {}))
    if opt_name == "adamw8bit":
        layouts = optim8bit.layouts_for_shardings(model, shardings)
    opt, _ = optim.make_optimizer(
        opt_name, layouts=layouts,
        decay_mask=None if opt_name == "sgd" else optim.default_decay_mask,
        **kw)
    state = port_train.create_train_state(model, opt, mesh, shardings)
    step = port_train.make_train_step(_loss, opt, mesh, layouts=layouts)
    batch = _batch(inp, mesh, kind)
    logits = port_train.make_eval_step(
        lambda m, b: port_tf.gather_vocab(m(b)), mesh,
        param_shardings=shardings)(model, batch[0])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, m = step(state, batch, None)
    out = dict(coords=mesh.coords, logits=_np(logits), loss=m["loss"].item(),
               grad_norm=m["grad_norm"].item(), stage=getattr(
                   model, "stage", None),
               specs={n: (s.spec, s.transposed)
                      for n, s in shardings.items()})
    after = {n: p.detach() for n, p in model.named_parameters()}
    out["params"] = {n: _np(p) for n, p in after.items()}
    if opt_name == "sgd":
        out["grads"] = {n: _np(before[n] - after[n]) for n in after}
    else:
        out["before"] = {n: _np(t) for n, t in before.items()}
        out.update(_moments(state))
    if layouts is not None:
        out["layouts"] = {n: (None if lo is None else tuple(lo.counts))
                          for n, lo in layouts.items()}
    return out


def run_attention(inp):
    """ring_attention (kernel path and plain path) and ulysses_attention
    (flash core and dense core) on a tp=4 mesh, each rank its sequence
    block: outputs and q/k/v gradients of ``sum(out * dout)``."""
    mesh = mesh_mod.build_mesh(mesh_mod.MeshSpec(dp=1, tp=4), device="cpu")
    a = inp["attn"]
    i, n = mesh.coords["tp"], mesh.shape["tp"]

    def block(x):
        s = x.shape[1] // n
        return torch.from_numpy(x[:, i * s:(i + 1) * s].copy())

    fns = {"ring_flash": functools.partial(ring_attention, use_flash=True),
           "ring_plain": functools.partial(ring_attention, use_flash=False),
           "ulysses_flash": ulysses.ulysses_attention,
           "ulysses_dense": functools.partial(ulysses.ulysses_attention,
                                              attn_fn=ulysses.dense_core)}
    out = {"coords": mesh.coords}
    for label, fn in fns.items():
        for causal in (False, True):
            q, k, v = (block(a[x]).requires_grad_(True)
                       for x in ("q", "k", "v"))
            o = fn(q, k, v, "tp", causal, mesh)
            (o * block(a["do"])).sum().backward()
            out[label, causal] = dict(out=_np(o), dq=_np(q.grad),
                                      dk=_np(k.grad), dv=_np(v.grad))
    q6 = block(a["q"])[:, :, :3]
    try:
        ulysses.ulysses_attention(q6, q6, q6, "tp", True, mesh)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def _stage_fn(params, x):
    return x + torch.tanh(x @ params["w1"]) @ params["w2"]


def run_pipeline(inp):
    """pipeline_apply on a pp=4 mesh: the outputs and the gradients of
    ``sum(out ** 2)`` in x and in this rank's stage parameters."""
    mesh = mesh_mod.build_mesh(mesh_mod.MeshSpec(dp=1, pp=4), device="cpu")
    s = mesh.coords["pp"]
    params = {k: torch.from_numpy(v[s].copy()).requires_grad_(True)
              for k, v in inp["pipe"]["stacked"].items()}
    x = torch.from_numpy(inp["pipe"]["x"].copy()).requires_grad_(True)
    y = pipeline.pipeline_apply(_stage_fn, params, x, mesh)
    (y ** 2).sum().backward()
    return dict(stage=s, out=_np(y), dx=_np(x.grad),
                grads={k: _np(p.grad) for k, p in params.items()})


def _error(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def run_misc(inp):
    """The eval step on tp=4, the sequence-split batch placement and
    feed, and what raises."""
    mesh = mesh_mod.build_mesh(mesh_mod.MeshSpec(dp=1, tp=4), device="cpu")
    out = {}
    model, shardings = _build(inp, mesh, "abs", {}, "tp")
    sharding_mod.shard_params(model, shardings)
    batch = _batch(inp, mesh, "tp")
    ev = port_train.make_eval_step(
        lambda m, b: port_tf.gather_vocab(m(b)), mesh,
        param_shardings=shardings)
    out["eval_logits"] = _np(ev(model, batch[0]))
    full = sharding_mod.gather_params(model, shardings)
    out["gathered"] = {n: _np(t) for n, t in full.items()}
    # the sequence-split sharding: put_batch, device_prefetch, the feed
    sh = mesh_mod.batch_sharding(mesh, "tp")
    tokens = inp["tokens"][:, :16]
    local = mesh_mod.local_rows(tokens, mesh, seq_axis="tp")
    out["put"] = mesh_mod.put_batch(local, sh).numpy()
    out["prefetched"] = [b.numpy() for b in feed.device_prefetch(
        iter([local, local + 1]), sharding=sh)]
    mgr = manager.start(uuid.uuid4().bytes, ["input", "output", "error"])
    try:
        q = mgr.get_queue("input")
        for row in tokens[:6]:
            q.put(row)
        q.put(None)
        out["fed"] = [b.numpy() for b in feed.DataFeed(
            mgr).iter_device_batches(4, sharding=sh)]
    finally:
        mgr.shutdown()
    out["dataset"] = [b.numpy() for b in data.Dataset.from_records(
        list(tokens[:8])).batch(4).prefetch_to_device(sharding=sh)]
    out["seq_indivisible"] = _error(lambda: mesh_mod.local_rows(
        tokens[:, :15], mesh, seq_axis="tp"))

    def adafactor_on_tp():
        m, shs = _build(inp, mesh, "abs", {}, "tp")
        opt, _ = optim.make_optimizer("adafactor", learning_rate=1e-2)
        st = port_train.create_train_state(m, opt, mesh, shs)
        port_train.make_train_step(_loss, opt, mesh)(st, batch, None)

    def cp_on_split_params():
        m, shs = _build(inp, mesh, "abs", {"ring_attention_axis": "tp"},
                        "tp")
        opt, _ = optim.make_optimizer("sgd", learning_rate=1.0)
        st = port_train.create_train_state(m, opt, mesh, shs)
        port_train.make_train_step(_loss, opt, mesh)(
            st, _batch(inp, mesh, "cp"), None)

    cp_model, _ = _build(inp, mesh, "abs", {"ulysses_axis": "tp"}, "cp")
    x = torch.zeros(2, 4, inp["cfgs"]["abs"]["d_model"])

    def cp_attn(**kw):
        with mesh_mod.use_mesh(mesh):
            cp_model.layer_0.attn(x, **kw)

    out["errors"] = dict(
        adafactor=_error(adafactor_on_tp),
        cp_split=_error(cp_on_split_params),
        cp_mask=_error(lambda: cp_attn(mask=torch.ones(2, 4, dtype=bool))),
        cp_decode=_error(lambda: cp_attn(cache=object())))
    return out


def main(rank, world, d):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(d, 'store')}",
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=300))
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {label: run_case(inp, *case) for label, case in CASES.items()}
    out["attention"] = run_attention(inp)
    out["pipeline"] = run_pipeline(inp)
    out["misc"] = run_misc(inp)
    dist.destroy_process_group()
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
