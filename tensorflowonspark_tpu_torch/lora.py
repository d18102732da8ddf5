"""LoRA — low-rank adaptation, the counterpart of
``tensorflowonspark_tpu/lora.py`` on the port's models.

The adapter tree keeps the JAX package's form and names: ``{flax path:
{"a": [in, r], "b": [r, out]}}`` of f32 tensors, one entry per adapted
Dense kernel (``"layer_0/attn/query/kernel"``; ``convert.flax_path``
names the port's parameters so).  Adapters apply to a ``state_dict`` of
the port's model as a functional transform:

    adapters = lora.init(torch.Generator().manual_seed(0), model, rank=8)
    tuned = lora.merge(model.state_dict(), adapters, scale=1.0)

``make_lora_loss`` wraps a loss of the model into a loss of the adapters
alone (the base parameters stay constants), so
``parallel.train.make_train_step`` trains the adapters with optimizer
state sized to them: train the flat view ``lora.flatten(adapters)``,
whose keys are ``"<path>/a"`` and ``"<path>/b"``.  ``save_adapters`` /
``load_adapters`` write and read the JAX package's adapter file (flax's
msgpack, byte for byte: ``serialization``), the one ``serve``'s adapter
bank loads (``--generate_lora NAME=PATH``).
"""
import logging
import re

import torch
from torch import nn

from tensorflowonspark_tpu_torch import convert, serialization

logger = logging.getLogger(__name__)

# kernels adapted by default: the attention projections
DEFAULT_TARGETS = r"(query|key|value|out)/kernel$"


def _state(params):
    """A module's ``state_dict`` or the dict itself."""
    return params.state_dict() if isinstance(params, nn.Module) else params


def _kernels(params):
    """``{flax path: (port name, [in, out] shape)}`` of the 2-D Dense
    kernels of ``params`` (a module or its ``state_dict``), sorted by
    path as the JAX package flattens a tree."""
    out = {}
    for name, t in _state(params).items():
        path, transposed = convert.flax_path(name, t.dim())
        if transposed:
            out[path] = (name, (t.shape[1], t.shape[0]))
    return dict(sorted(out.items()))


BANK_PROJECTIONS = ("query", "key", "value", "out")


def bank_slices(attn, index):
    """``{projection: (rows of A, columns of B)}``: the part of each
    attention projection's adapter (``A [in, r]``, ``B [r, out]``) that
    tp rank ``index`` holds in a serving engine's bank, by the layer's
    own split (``models.transformer.Attention``).  A column-parallel
    projection keeps A whole and its columns of B; a k / v projection
    whose heads the forward reads from the gathered weight keeps B
    whole (the forward takes the same rows of it); the row-parallel
    ``out`` keeps its rows of A and B whole, so each rank adds its
    partial delta before the all-reduce.  Unsplit: everything whole."""
    whole = slice(None)
    out = {p: (whole, whole) for p in BANK_PROJECTIONS}
    if not attn.split():
        return out

    def block(n):
        return slice(index * n, (index + 1) * n)

    out["query"] = (whole, block(attn.query.local_shape()[0]))
    if attn.kv_column_parallel():
        for p in ("key", "value"):
            out[p] = (whole, block(getattr(attn, p).local_shape()[0]))
    out["out"] = (block(attn.out.local_shape()[1]), whole)
    return out


def target_paths(params, targets=DEFAULT_TARGETS):
    """Paths (slash-joined) of the kernels a pattern selects."""
    pat = re.compile(targets)
    return [p for p in _kernels(params) if pat.search(p)]


def init(generator, params, rank=8, targets=DEFAULT_TARGETS):
    """Build the adapter tree ``{path: {"a": [in, r], "b": [r, out]}}``:
    ``a`` gaussian / rank (drawn from ``generator``, on its device),
    ``b`` zeros, so the merged model starts exactly at the base model.
    Raises when no kernel matches."""
    kernels = _kernels(params)
    pat = re.compile(targets)
    paths = [p for p in kernels if pat.search(p)]
    if not paths:
        raise ValueError(f"no 2-D kernels match targets={targets!r}")
    dev = generator.device
    adapters = {}
    for path in paths:
        d_in, d_out = kernels[path][1]
        a = torch.randn((d_in, rank), generator=generator, device=dev,
                        dtype=torch.float32) * (1.0 / rank)
        adapters[path] = {"a": a, "b": torch.zeros((rank, d_out),
                                                   device=dev)}
    logger.info("LoRA: rank=%d adapters on %d kernels (%.2fM trainable)",
                rank, len(paths), num_trainable(adapters) / 1e6)
    return adapters


def flatten(adapters):
    """The flat view ``{"<path>/a": a, "<path>/b": b}`` (the same
    tensors) that a train state holds."""
    return {f"{p}/{k}": t for p, ab in adapters.items() for k, t in ab.items()}


def _nested(adapters):
    if all(isinstance(v, dict) for v in adapters.values()):
        return adapters
    out = {}
    for key, t in adapters.items():
        path, _, leaf = key.rpartition("/")
        out.setdefault(path, {})[leaf] = t
    return out


def merge(params, adapters, scale=1.0):
    """``params`` (a ``state_dict`` or module) with ``W + scale * A @ B``
    on every adapted kernel: the port's ``[out, in]`` weight gains the
    transposed delta, computed in f32 and cast back to the weight's
    dtype.  Differentiable in the adapters.  ``adapters`` may be the
    tree or its :func:`flatten` view."""
    state = _state(params)
    adapters = _nested(adapters)
    kernels = _kernels(state)
    unused = set(adapters) - set(kernels)
    if unused:
        raise ValueError(
            "adapter paths not found in params (trained on a different "
            f"tree/scope?): {sorted(unused)[:4]}...")
    out = dict(state)
    for path, ab in adapters.items():
        name = kernels[path][0]
        w = state[name]
        a, b = (ab[k].to(w.device, torch.float32) for k in ("a", "b"))
        out[name] = (w.float() + ((a @ b) * scale).t()).to(w.dtype)
    return out


def make_lora_loss(loss_fn, model, scale=1.0):
    """Wrap ``loss_fn(model, batch, rng)`` into ``lora_loss(adapters,
    batch, rng)``, a function of the adapters only: the model runs with
    its adapted weights merged in (``torch.func.functional_call``), its
    own parameters are constants (``requires_grad_(False)`` on
    ``model``).  ``make_train_step(lora_loss, opt)`` over
    ``create_train_state(flatten(adapters), opt)`` then trains the
    adapters only."""
    from tensorflowonspark_tpu_torch.parallel.train import _call_with

    model.requires_grad_(False)
    kernels = _kernels(model)

    def lora_loss(adapters, batch, rng):
        nested = _nested(adapters)
        merged = merge({kernels[p][0]: model.get_parameter(kernels[p][0])
                        for p in nested}, nested, scale)
        return _call_with(loss_fn, model, merged, batch, rng)

    return lora_loss


def num_trainable(adapters):
    adapters = _nested(adapters)
    return sum(ab["a"].numel() + ab["b"].numel() for ab in adapters.values())


def save_adapters(path, adapters, scale=1.0):
    """Write an adapter tree and its merge scale as the JAX package's
    adapter file (``{"adapters": {path: {"a", "b"}}, "meta": {"rank",
    "scale"}}``, keys sorted as its ``msgpack_serialize`` sorts them),
    to any path ``fsio`` opens."""
    adapters = _nested(adapters)
    if not adapters:
        raise ValueError("adapters tree is empty — nothing to save")
    rank = next(iter(adapters.values()))["a"].shape[-1]
    tree = {"adapters": {k: {"a": adapters[k]["a"], "b": adapters[k]["b"]}
                         for k in sorted(adapters)},
            "meta": {"rank": int(rank), "scale": float(scale)}}
    serialization.save(path, tree)


def load_adapters(path):
    """Restore ``(adapters, scale)`` written by `save_adapters` (either
    package's)."""
    obj = serialization.load(path)
    if not isinstance(obj, dict) or "adapters" not in obj:
        raise ValueError(f"{path!r} is not a saved LoRA adapter file")
    return obj["adapters"], float(obj.get("meta", {}).get("scale", 1.0))
