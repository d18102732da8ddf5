"""One rank of the multi-rank CPU checks of the port's sharded training
(``tests/test_torch_sharded_train.py``), run as its own interpreter so
that it imports torch and the port only, never JAX:

    python tests/torch_mesh_ranks.py RANK WORLD DIR

``DIR/inputs.pkl`` holds the flax parameter tree (numpy), the global
token batch, the model config and the optimizer settings.  The rank
joins a gloo world through a FileStore in ``DIR``, runs every case on
its own rows, and writes what it saw to ``DIR/rank<RANK>.pkl``.
"""
import datetime
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tensorflowonspark_tpu_torch import convert, feed, optim, optim8bit  # noqa: E402
from tensorflowonspark_tpu_torch.models import transformer as port_tf  # noqa: E402
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from tensorflowonspark_tpu_torch.parallel import sharding as sharding_mod  # noqa: E402
from tensorflowonspark_tpu_torch.parallel import train as port_train  # noqa: E402

# (label, mesh spec, grad_accum, optimizer, donate, the step built with
# the mesh (else it takes the state's))
CASES = (("dp4", dict(dp=4), 1, "adamw_fused", True, False),
         ("fsdp4", dict(dp=1, fsdp=4), 2, "adamw_fused", True, True),
         ("dp2fsdp2", dict(dp=2, fsdp=2), 1, "adamw_fused", False, False),
         ("fsdp4_8bit", dict(dp=1, fsdp=4), 1, "adamw8bit", True, True))
STEPS = 3


def _np(t):
    return t.detach().to(torch.float32).numpy().copy()


def _model(inp):
    model = port_tf.build_transformer(**inp["cfg"])
    model.load_state_dict(convert.params_from_jax(inp["params"]),
                          strict=True)
    return model


def _loss(model, batch, rng):
    return port_tf.lm_loss(model(batch[:, :-1]), batch[:, 1:])


def _local_state(state):
    """This rank's shards of a state: params, and the moments (``mu`` /
    ``nu`` of the fused AdamW, or ``q8``: each 8-bit moment's payload and
    scales)."""
    out = {"count": int(state.step),
           "params": {n: _np(p) for n, p in state.params.named_parameters()}}
    q8 = port_train._states_8bit(state.opt_state)
    if q8:
        out["q8"] = {k: {n: (qt.q.numpy().copy(), qt.scale.numpy().copy())
                         for n, qt in getattr(q8[0], k).items()}
                     for k in ("mu", "nu_sqrt")}
    else:
        out["mu"] = {n: _np(t) for n, t in state.opt_state.mu.items()}
        out["nu"] = {n: _np(t) for n, t in state.opt_state.nu.items()}
    return out


def run_case(inp, spec, grad_accum, opt_name, donate, step_mesh):
    mesh = mesh_mod.build_mesh(mesh_mod.MeshSpec(**spec), device="cpu")
    model = _model(inp)
    shardings = sharding_mod.infer_param_shardings(model, mesh, fsdp=True)
    layouts = None
    if opt_name == "adamw8bit":
        layouts = optim8bit.layouts_for_shardings(model, shardings)
    opt, _ = optim.make_optimizer(opt_name,
                                  decay_mask=optim.default_decay_mask,
                                  layouts=layouts, **inp["opt"][opt_name])
    state = port_train.create_train_state(model, opt, mesh, shardings)
    step = port_train.make_train_step(_loss, opt,
                                      mesh if step_mesh else None,
                                      grad_accum=grad_accum, donate=donate,
                                      layouts=layouts)
    tokens = torch.from_numpy(mesh_mod.local_rows(inp["tokens"], mesh))
    states = [_local_state(state)]
    losses, norms, kept = [], [], True
    for _ in range(STEPS):
        new, m = step(state, tokens, None)
        kept = kept and all(np.array_equal(states[-1]["params"][n], _np(p))
                            for n, p in state.params.named_parameters())
        state = new
        states.append(_local_state(state))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    out = dict(losses=losses, grad_norms=norms, coords=mesh.coords,
               metric_bytes={k: v.untyped_storage().nbytes()
                             for k, v in m.items()},
               states=states, step=int(state.step),
               specs={n: (s.spec, s.transposed) for n, s in shardings.items()})
    if not donate:
        out["input_state_kept"] = kept
    if opt_name == "adamw8bit":
        out["layouts"] = {n: (None if lo is None else tuple(lo.counts))
                          for n, lo in layouts.items()}
        try:      # a declared layout that does not match the sharding
            wrong = {n: (None if lo is None else lo._replace(
                counts=lo.counts[::-1])) for n, lo in layouts.items()}
            port_train.make_train_step(_loss, opt, mesh, layouts=wrong)(
                state, tokens, None)
            out["wrong_layout"] = None
        except ValueError as e:
            out["wrong_layout"] = str(e)
    return out


def run_eval(inp):
    """The eval step of a freshly sharded fsdp=4 state on this rank's
    rows."""
    mesh = mesh_mod.build_mesh(mesh_mod.MeshSpec(dp=1, fsdp=4), device="cpu")
    model = _model(inp)
    shardings = sharding_mod.infer_param_shardings(model, mesh, fsdp=True)
    sharding_mod.shard_params(model, shardings)
    tokens = torch.from_numpy(mesh_mod.local_rows(inp["tokens"], mesh))
    ev = port_train.make_eval_step(lambda m, b: m(b), mesh,
                                   param_shardings=shardings)
    full = sharding_mod.gather_params(model, shardings)
    return dict(logits=_np(ev(model, tokens[:, :-1])),
                gathered={n: _np(t) for n, t in full.items()})


def run_batches(inp):
    """put_batch and device_prefetch(sharding=) on a dp=2 x fsdp=2 mesh,
    then a rank that passes a different local shape, and a prefetch
    whose later batch has other shapes than its first."""
    mesh = mesh_mod.build_mesh(mesh_mod.MeshSpec(dp=2, fsdp=2), device="cpu")
    sh = mesh_mod.batch_sharding(mesh)
    local = mesh_mod.local_rows(inp["tokens"], mesh)
    put = mesh_mod.put_batch({"x": local, "y": local[:, 0]}, sh)
    pre = list(feed.device_prefetch(iter([local, local + 1]), sharding=sh))
    ragged = local if mesh.rank else local[:1]
    try:
        mesh_mod.put_batch(ragged, sh)
        err = None
    except ValueError as e:
        err = str(e)
    try:
        list(feed.device_prefetch(iter([local, local[:1]]), sharding=sh))
        tail_err = None
    except ValueError as e:
        tail_err = str(e)
    return dict(index=mesh.index(mesh_mod.BATCH_AXES),
                put={k: v.numpy() for k, v in put.items()},
                prefetched=[b.numpy() for b in pre], ragged_error=err,
                ragged_tail_error=tail_err)


def main(rank, world, d):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(d, 'store')}",
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=300))
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {label: run_case(inp, *case) for label, *case in CASES}
    out["eval"] = run_eval(inp)
    out["batches"] = run_batches(inp)
    dist.destroy_process_group()
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
