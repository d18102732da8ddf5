"""Parameter-sharding rules — counterpart of
``tensorflowonspark_tpu/parallel/sharding.py``.

A small rule engine gives every parameter a PartitionSpec by regex over
its tree path, with Megatron-style defaults for transformer blocks
(column-parallel in-projections, row-parallel out-projections) and
optional fsdp sharding of whatever is left.

The rules match FLAX paths (``layer_0/attn/query/kernel``): each port
name maps to its flax path (the inverse of ``convert.params_from_jax``'s
naming), and every spec, the fsdp dim included, is computed on the flax
shape.  A ``Dense`` weight is ``[out, in]`` in the port and ``[in, out]``
in flax, so its :class:`~.mesh.NamedSharding` is marked ``transposed``:
on a square weight the fsdp dim is the one JAX picks, and the 8-bit
blocks of a shard are JAX's.

:func:`shard_params` gives each rank its slice of every sharded
parameter as a plain local tensor; :func:`gather_params` puts the full
tensors back together.  A serving tree (a float ``Transformer``) splits
by the same rules, its quantised weights' ``q`` / ``scale`` by their
float weight's rule (every rank quantises the whole masters first, then
takes its slice: a slice quantised alone would get other scales); the
LoRA banks of a serving engine split with the layers they adapt
(``lora.bank_slices``).
"""
import logging
import re

import torch

from tensorflowonspark_tpu_torch.convert import flax_path, shard_of
from tensorflowonspark_tpu_torch.parallel.mesh import (A3C, AXIS_PP, AXIS_TP,
                                                       NamedSharding)

logger = logging.getLogger(__name__)


def P(*axes):
    """A PartitionSpec, as a tuple."""
    return tuple(axes)


# Megatron-style defaults for transformer parameters.  Paths are
# '/'-joined flax param paths, matched with re.search.
# `(^|/)` anchors each pattern at a path-segment start so e.g. "router"
# cannot match an "out*" rule by substring.
DEFAULT_RULES = (
    # MoE expert weights first (most specific): leading expert dim over ep
    ((r"(^|/)experts_(wi|up)[^/]*/kernel"), ("ep", "embed", "tp")),
    ((r"(^|/)experts_(wo|down)[^/]*/kernel"), ("ep", "tp", "embed")),
    ((r"(^|/)router[^/]*/kernel"), ()),
    # attention in-projections: split heads over tp (column parallel)
    (r"(^|/)(query|key|value|qkv)[^/]*/kernel", ("embed", "tp")),
    # attention out-projection: row parallel (tp partial-sums -> psum)
    (r"(^|/)(out|o_proj|attn_out)[^/]*/kernel", ("tp", "embed")),
    # MLP up/gate: column parallel
    (r"(^|/)(mlp|ffn)[^/]*/(up|gate|wi|fc1|in_proj)[^/]*/kernel", ("embed", "tp")),
    # MLP down: row parallel
    (r"(^|/)(mlp|ffn)[^/]*/(down|wo|fc2|out_proj)[^/]*/kernel", ("tp", "embed")),
    # embedding tables: split the model dim over tp (vocab-dim sharding
    # would make the row gather a cross-shard collective)
    (r"(^|/)(embed|embedding|token_embed|pos_embed)[^/]*/(embedding|kernel)",
     ("embed", "tp")),
    # lm head: split vocab over tp; the loss reduces over vocab with a psum
    (r"(^|/)(lm_head|logits)[^/]*/kernel", ("embed", "tp")),
    # norms / biases / scales: replicated
    (r"(scale|bias|norm)", ()),
)

# Logical-axis name -> mesh axis (or None = replicate).  'ep' rides the dp
# axis: experts are distributed across data-parallel shards.
DEFAULT_AXIS_MAP = {
    "tp": "tp",
    "embed": None,
    "ep": "dp",
}


def spec_for_path(path, rules=DEFAULT_RULES, axis_map=None):
    """Return the PartitionSpec for one parameter path."""
    axis_map = axis_map or DEFAULT_AXIS_MAP
    for pattern, logical in rules:
        if re.search(pattern, path):
            return P(*(axis_map.get(ax) for ax in logical))
    return P()


def named_tensors(params):
    """``{name: tensor}`` of an ``nn.Module``'s parameters or of a dict of
    tensors."""
    if hasattr(params, "named_parameters"):
        return dict(params.named_parameters())
    return dict(params)


def infer_param_shardings(params, mesh, rules=DEFAULT_RULES, axis_map=None,
                          fsdp=False):
    """``{name: NamedSharding}`` for every parameter of ``params`` (an
    ``nn.Module`` or a dict of tensors, at their full shapes).

    With fsdp=True, parameters that ended up replicated get their largest
    divisible dimension sharded over the fsdp axis (ZeRO-3 flavor)."""
    fsdp_size = mesh.shape.get("fsdp", 1)
    out = {}
    for name, leaf in named_tensors(params).items():
        path, transposed = flax_path(name, leaf.ndim)
        shape = tuple(leaf.shape)[::-1] if transposed else tuple(leaf.shape)
        spec = _fit(spec_for_path(path, rules, axis_map), shape, mesh)
        if fsdp and fsdp_size > 1:
            spec = _add_fsdp(spec, shape, fsdp_size)
        out[name] = NamedSharding(mesh, _trim(spec, shape), transposed)
    if isinstance(params, torch.nn.Module):
        out.update(_quantized_shardings(params, mesh, rules, axis_map))
    return out


def _fit(spec, shape, mesh):
    """``spec`` on a leaf of ``shape``: axes of extent 1 carry no
    sharding, and an axis whose size does not divide the dim (a GQA
    kv-projection narrower than tp) replicates."""
    return P(*(
        ax if (ax is not None and mesh.shape.get(ax, 1) > 1
               and i < len(shape) and shape[i] % mesh.shape[ax] == 0)
        else None
        for i, ax in enumerate(spec)))


def _trim(spec, shape):
    """Drop specs that exceed the leaf's rank (scalar params etc.) and
    trailing Nones."""
    if len(spec) > len(shape):
        spec = P()
    while len(spec) and spec[-1] is None:
        spec = P(*spec[:-1])
    return spec


def quantized_tensors(model):
    """``{name: buffer}`` of the quantised weights' ``q`` / ``scale``
    buffers of ``model`` (``Dense.set_quantized``)."""
    from tensorflowonspark_tpu_torch.quantize import quantized_denses

    return {f"{name}.{leaf}": getattr(mod, leaf)
            for name, mod in quantized_denses(model)
            for leaf in ("q", "scale")}


def _quantized_shardings(model, mesh, rules, axis_map):
    """The ``q`` / ``scale`` buffers' shardings of every quantised
    ``Dense``, by its float weight's rule at the whole ``[K, N]``
    (``.../kernel``): column-parallel splits both over N; row-parallel
    splits ``q`` over K (int4: its packed rows) and the int4 group scales
    over their group rows, and leaves the int8 ``[1, N]`` scale whole
    (each rank's partial sums share each column's scale).  k / v
    projections that tp would split mid-head stay whole here
    (``Attention.take_kv_heads`` keeps a rank's heads)."""
    from tensorflowonspark_tpu_torch.quantize import quantized_denses

    tp = mesh.shape.get(AXIS_TP, 1)
    out = {}
    for name, mod in quantized_denses(model):
        path, _ = flax_path(name + ".weight", 2)
        K, N = mod.in_features, mod.out_features
        spec = _fit(spec_for_path(path, rules, axis_map), (K, N), mesh)
        split = [i for i, ax in enumerate(spec) if ax is not None]
        if any(ax != AXIS_TP for ax in spec if ax is not None):
            raise NotImplementedError(
                f"{name}: a quantised weight split over {spec} is not "
                f"ported yet ({A3C}: quantised weights split over tp only)")
        parent = model.get_submodule(name.rsplit(".", 1)[0]) if (
            "." in name) else None
        if (split == [1] and name.rsplit(".", 1)[-1] in ("key", "value")
                and hasattr(parent, "take_kv_heads")
                and parent.n_kv % tp):
            split = []
        if split == [0] and mod.quant == "int4" and (
                K % tp or (K // tp) % mod.group_size):
            raise NotImplementedError(
                f"{name}: an int4 group of {mod.group_size} rows straddles "
                f"the row-parallel split of K={K} over tp={tp}; not ported "
                f"yet ({A3C}): pick a group size that divides K / tp")
        q_spec = {(): P(), (1,): P(None, AXIS_TP), (0,): P(AXIS_TP)}[
            tuple(split)]
        scale_spec = (P() if split == [0] and mod.quant == "int8"
                      else q_spec)
        out[f"{name}.q"] = NamedSharding(mesh, q_spec)
        out[f"{name}.scale"] = NamedSharding(mesh, scale_spec)
    return out


def _add_fsdp(spec, shape, fsdp_size):
    """Shard the largest still-unsharded, divisible dim over fsdp (of the
    FLAX shape: on a square weight the later flax dim wins the tie)."""
    ndim = len(shape)
    axes = list(spec) + [None] * (ndim - len(spec))
    candidates = [(shape[i], i) for i in range(ndim)
                  if axes[i] is None and shape[i] % fsdp_size == 0]
    if not candidates:
        return spec
    _, dim = max(candidates)
    axes[dim] = "fsdp"
    while axes and axes[-1] is None:
        axes.pop()
    return P(*axes)


def shard_params(params, shardings):
    """Give this rank its slice of every sharded parameter.  An
    ``nn.Module`` is sharded in place (each parameter's ``data`` becomes
    the local slice; its forward then runs only through the train and
    eval steps, which gather the fsdp slices and enter the mesh for the
    tp ones) and returned; a dict comes back as a new dict.  A module
    with ``keep_stage`` (``models.pipelined.PipelinedLM``) on a mesh
    with a pp axis first drops every other stage's layers.  Every rank
    must pass the same full parameters."""
    mesh = next(iter(shardings.values())).mesh if shardings else None
    tensors = _shardable(params)
    for name, t in tensors.items():
        if ".experts_" in "." + name and shardings[name].split_axes(t.ndim):
            raise NotImplementedError(
                f"{name}: MoE experts split over "
                f"{shardings[name].split_axes(t.ndim)} are not ported yet "
                "(ROADMAP A3c: experts over ep, MoE under tp / fsdp / dp "
                "splits); one card runs a MoE model whole")
    if mesh is not None:
        mesh.check_placeable()
        if hasattr(params, "keep_stage") and mesh.shape[AXIS_PP] > 1:
            params.keep_stage(mesh.coords[AXIS_PP])
            tensors = _shardable(params)
    dev = mesh.device if mesh is not None else None
    out = {}
    for name, t in tensors.items():
        local = shard_of(t.detach(), shardings[name],
                         shardings[name].mesh.coords)
        if dev is not None:
            local = local.to(dev)
        if hasattr(params, "named_parameters"):
            t.data = local
        else:
            out[name] = local.requires_grad_(t.requires_grad)
    if mesh is not None and hasattr(params, "named_parameters"):
        for m in params.modules():
            if hasattr(m, "tp_index"):   # models.transformer.Attention
                m.tp_index = mesh.coords[AXIS_TP]
                m.take_kv_heads()
    return params if hasattr(params, "named_parameters") else out


def _shardable(params):
    """:func:`named_tensors`, and a module's quantised buffers."""
    tensors = named_tensors(params)
    if isinstance(params, torch.nn.Module):
        tensors.update(quantized_tensors(params))
    return tensors


def gather_params(params, shardings):
    """The full tensors of sharded ``params`` (an ``nn.Module`` or a
    dict, as :func:`shard_params` left them): ``{name: tensor}``, the
    sharded ones all-gathered over fsdp and tp (a collective: every rank
    calls it), the replicated ones as they are."""
    from tensorflowonspark_tpu_torch.parallel.collectives import gather_full

    tensors = {n: t.detach() for n, t in named_tensors(params).items()}
    return gather_full(tensors, shardings, axes=("fsdp", "tp"))
