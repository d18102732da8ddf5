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
by the same rules; the LoRA banks of a serving engine split with the
layers they adapt (``lora.bank_slices``).
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
        spec = spec_for_path(path, rules, axis_map)
        # Axes of extent 1 carry no sharding; an axis whose size does not
        # divide the dim (a GQA kv-projection narrower than tp) replicates.
        spec = P(*(
            ax if (ax is not None and mesh.shape.get(ax, 1) > 1
                   and i < len(shape) and shape[i] % mesh.shape[ax] == 0)
            else None
            for i, ax in enumerate(spec)))
        if fsdp and fsdp_size > 1:
            spec = _add_fsdp(spec, shape, fsdp_size)
        # Drop specs that exceed the leaf's rank (scalar params etc.)
        if len(spec) > len(shape):
            spec = P()
        while len(spec) and spec[-1] is None:
            spec = P(*spec[:-1])
        out[name] = NamedSharding(mesh, spec, transposed)
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
    tensors = named_tensors(params)
    for name, t in tensors.items():
        if ".experts_" in "." + name and shardings[name].split_axes(t.ndim):
            raise NotImplementedError(
                f"{name}: MoE experts split over "
                f"{shardings[name].split_axes(t.ndim)} are not ported yet "
                "(ROADMAP A3c: experts over ep, MoE under tp / fsdp / dp "
                "splits); one card runs a MoE model whole")
    if mesh is not None:
        mesh.check_placeable()
        if mesh.shape[AXIS_TP] > 1 and isinstance(params, torch.nn.Module):
            from tensorflowonspark_tpu_torch.quantize import quantized_modes

            if quantized_modes(params):
                # a quantised weight is a buffer (q, scale), never split
                raise NotImplementedError(
                    "quantised weights on a tp mesh are not ported yet "
                    f"({A3C}): shard the float model")
        if hasattr(params, "keep_stage") and mesh.shape[AXIS_PP] > 1:
            params.keep_stage(mesh.coords[AXIS_PP])
            tensors = named_tensors(params)
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
    return params if hasattr(params, "named_parameters") else out


def gather_params(params, shardings):
    """The full tensors of sharded ``params`` (an ``nn.Module`` or a
    dict, as :func:`shard_params` left them): ``{name: tensor}``, the
    sharded ones all-gathered over fsdp and tp (a collective: every rank
    calls it), the replicated ones as they are."""
    from tensorflowonspark_tpu_torch.parallel.collectives import gather_full

    tensors = {n: t.detach() for n, t in named_tensors(params).items()}
    return gather_full(tensors, shardings, axes=("fsdp", "tp"))
