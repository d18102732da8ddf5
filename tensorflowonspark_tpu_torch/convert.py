"""Parameter-tree conversion between the JAX package and the port.

``params_from_jax`` turns a JAX package parameter tree (the
Transformer's, with its MoE layers, and every zoo model's), as nested
dicts of numpy arrays (``{"layer_0": {"attn": {"query": {"kernel":
...}}}}``), into the port's ``state_dict``; ``params_to_jax`` goes
back, and ``variables_to_jax`` also gives a BatchNorm model's
``batch_stats`` (the port's ``mean`` / ``var`` buffers).  Flax ``Dense``
kernels are ``[in, out]`` and the port's ``Dense`` weights ``[out,
in]``, so they transpose; conv kernels are HWIO in flax and OIHW in the
port, so they permute; ``embedding`` (Embed) and ``scale`` (norms)
become ``weight`` unchanged; raw leaves (``gain``, ``alpha``,
``cls_token``, ViT's ``pos_embed``, ``mlm_bias``) keep their names, and
an expert weight ``experts_wi/kernel`` (one flax name with a "/") is
the port's ``experts_wi``.

``adamw_state_from_jax`` / ``adamw_state_to_jax`` carry a fused-AdamW
state (``count`` and the ``mu`` / ``nu`` trees, which mirror the params)
across with the same names and transposes, so both packages can step
from one state; ``lion_state_from_jax`` / ``lion_state_to_jax`` do the
same for a fused-Lion state (``count``, ``mu``).
``adam8bit_state_from_jax`` carries an 8-bit Adam state: payloads and
scales unchanged where the port stores the leaf as JAX does, and a Dense
kernel's moments dequantised, transposed and quantised again in the
port's layout (its blocks run along the other axis).

``flax_path`` maps a port name to its flax path (what the sharding rules
match); ``shard_of`` / ``join_shards`` cut a full tensor into its fsdp
and tp slices (one dim or two) and join them again, so that a JAX state
on a mesh and the port's per-rank states can be held leaf by leaf.
``pipelined_from_jax`` / ``pipelined_to_jax`` map the JAX
``PipelinedLM`` layout (stacked ``[n_stages, layers/stage, ...]``
blocks) to the port's ``PipelinedLM`` and back.

``port_builder`` maps a JAX export's builder spec to the port's (a
fixed table, :data:`JAX_BUILDERS`); ``params_to_flax`` gives the flax
tree of a ``state_dict`` as CPU tensors in their own dtype (what the
port writes into a JAX-format ``params.msgpack``).  The ``*_from_jax``
readers take numpy arrays or torch tensors (a ``params.msgpack`` read by
``serialization`` holds tensors, bf16 ones included).

``qparams_from_jax`` / ``qparams_to_jax`` do the same for a quantised
tree (``quantize.quantize_tree``): a quantised kernel keeps the JAX
``[in, out]`` storage layout and bytes on both sides, as the ``q`` /
``scale`` buffers of the port's quantised ``Dense``.
"""
import numpy as np
import torch

from tensorflowonspark_tpu_torch import optim8bit, quantize
from tensorflowonspark_tpu_torch.ops.fused_optim import (FusedAdamWState,
                                                         FusedLionState)

_EMBEDS = ("token_embed", "pos_embed", "type_embed")
# modules whose ``weight`` is a norm's flax ``scale``: the transformer's
# and BERT's LayerNorms, ChannelGroupNorm's ``gn``, the ResNet stem's and
# projection's norms (BatchNorm; the group and identity norms keep theirs
# under ``gn`` or have none) and flax's automatic ``BatchNorm_<i>``
_NORMS = ("ln1", "ln2", "ln_f", "ln_embed", "mlm_ln", "gn", "norm_init",
          "norm_proj")
# leaves that keep their flax name: WSConv's gain, IdentityNorm's alpha,
# ViT's raw cls_token / pos_embed, BERT's mlm_bias, biases
_RAW = ("bias", "gain", "alpha", "cls_token", "pos_embed", "mlm_bias")
# BatchNorm's running statistics (flax's ``batch_stats`` collection,
# the port's buffers of the same names)
_STATS = ("mean", "var")
# MoE expert weights: one flax param whose NAME holds a "/"
# (``experts_wi/kernel``), the port's parameter ``experts_wi``
_EXPERTS = "/kernel"
_JAX_PREFIX = "tensorflowonspark_tpu."
_ZOO = (("mlp", "MnistMLP"), ("cnn", "MnistCNN"), ("linear", "Linear"),
        ("linear", "MLP"), ("resnet", "ResNet"), ("resnet", "ResNet50"),
        ("resnet", "ResNet56Cifar"), ("unet", "UNet"),
        ("deeplab", "DeepLabV3"), ("vit", "ViTTiny"), ("vit", "ViTBase"),
        ("bert", "build_bert"), ("transformer", "build_transformer"))
# the JAX package's model builders (its builder functions and the zoo
# classes an export names, as examples/mnist does with
# ``tensorflowonspark_tpu.models.cnn:MnistCNN``), and the port's
# counterpart of each
JAX_BUILDERS = {
    f"tensorflowonspark_tpu.models.{mod}:{fn}":
        f"tensorflowonspark_tpu_torch.models.{mod}:{fn}"
    for mod, fn in _ZOO}


def port_builder(spec):
    """The port's builder spec for ``spec``: a JAX builder through
    :data:`JAX_BUILDERS`, the port's own unchanged.  A spec of the JAX
    package that names no model builder raises NotImplementedError."""
    if spec in JAX_BUILDERS:
        return JAX_BUILDERS[spec]
    if spec.startswith(_JAX_PREFIX):
        raise NotImplementedError(
            f"builder {spec!r} of the JAX package has no counterpart in the "
            "port: JAX_BUILDERS maps every model builder of its models/")
    return spec


def _kernel_to_port(t, path):
    """A flax kernel in the port's layout: a Dense ``[in, out]``
    transposed, a conv HWIO permuted to OIHW."""
    if t.dim() == 2:
        return t.t().contiguous()
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1).contiguous()
    raise ValueError(f"{'/'.join(path)}: expected a 2-D Dense or 4-D conv "
                     f"kernel, got shape {tuple(t.shape)}")


def _kernel_to_flax(t):
    """The inverse of :func:`_kernel_to_port`."""
    if t.dim() == 2:
        return t.t()
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0)
    return t


def params_from_jax(tree):
    """Nested dicts of arrays (a flax ``params`` tree, optionally under a
    sole ``"params"`` key, or flax variables ``{"params", "batch_stats"}``)
    -> ``{dotted name: torch.Tensor}``, batch statistics as the
    BatchNorm buffers ``mean`` / ``var``."""
    if isinstance(tree, dict) and "params" in tree and set(tree) <= {
            "params", "batch_stats"}:
        out = params_from_jax(tree["params"])
        out.update(params_from_jax(tree.get("batch_stats", {})))
        return out
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(child, path + (key,))
            return
        t = _tensor(node)
        name, kernel = _port_name(path)
        out[name] = _kernel_to_port(t, path) if kernel else t

    walk(tree, ())
    return out


def _port_name(path):
    """A JAX parameter path -> ``(the port's dotted name, True for a
    Dense or conv kernel, which the port stores in its own layout)``."""
    leaf = path[-1]
    if leaf in ("kernel", "embedding", "scale"):
        return ".".join(path[:-1] + ("weight",)), leaf == "kernel"
    if leaf.startswith("experts_") and leaf.endswith(_EXPERTS):
        return ".".join(path[:-1] + (leaf[:-len(_EXPERTS)],)), False
    if leaf not in _RAW + _STATS:
        raise ValueError(f"{'/'.join(path)}: unknown parameter {leaf!r}")
    return ".".join(path), False


def _flax_keys(name, ndim):
    """The port's dotted name -> ``(its flax keys, "dense" for a 2-D
    Dense kernel, "conv" for a 4-D conv kernel, else None)``: the inverse
    of :func:`_port_name`."""
    parts = name.split(".")
    module, leaf = parts[:-1], parts[-1]
    if leaf.startswith("experts_"):
        return tuple(module) + (leaf + _EXPERTS,), None
    if leaf == "weight" and module:
        if module[-1] in _EMBEDS:
            leaf = "embedding"
        elif module[-1] in _NORMS or module[-1].startswith("BatchNorm_"):
            leaf = "scale"
        else:
            return (tuple(module) + ("kernel",),
                    {2: "dense", 4: "conv"}.get(ndim))
    return tuple(module) + (leaf,), None


def flax_path(name, ndim):
    """The port's dotted parameter name -> ``(its '/'-joined flax path,
    True for a 2-D Dense kernel, which the port stores transposed)``:
    the inverse of :func:`_port_name` (an expert weight's flax name holds
    the "/" of ``experts_wi/kernel``, which the sharding rules match)."""
    keys, layout = _flax_keys(name, ndim)
    return "/".join(keys), layout == "dense"


def _is_stat(name):
    return name.rsplit(".", 1)[-1] in _STATS


def _shard_grid(sharding, ndim):
    """``[(dim, axes, extent)]`` of the dims ``sharding`` splits."""
    return [(d, axes, sharding.mesh.extent(axes))
            for d, axes in sharding.shard_dim(ndim)]


def _dim_index(axes, coords, mesh):
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + coords[a]
    return i


def shard_of(t, sharding, coords):
    """This rank's slice of the full port tensor ``t`` under ``sharding``
    (a ``parallel.mesh.NamedSharding``), contiguous; ``t`` itself when
    the sharding replicates it.  ``coords``: the rank's ``{axis:
    index}`` (``Mesh.coords``), or, for a tensor split over one axis, its
    index along it."""
    grid = _shard_grid(sharding, t.ndim)
    if not grid:
        return t
    if not isinstance(coords, dict):
        if len(grid) != 1 or len(grid[0][1]) != 1:
            raise ValueError(f"spec {sharding.spec} splits over "
                             f"{[g[1] for g in grid]}: pass coords")
        coords = {grid[0][1][0]: int(coords)}
    for dim, axes, n in grid:
        size = t.shape[dim] // n
        t = t.narrow(dim, _dim_index(axes, coords, sharding.mesh) * size,
                     size)
    return t.contiguous()


def join_shards(shards, sharding):
    """The full tensor from its slices (the inverse of :func:`shard_of`):
    one slice per combination of the split axes' indices, in row-major
    order over those axes in ``parallel.mesh.ALL_AXES`` order (for one
    split axis: its index order)."""
    import itertools

    from tensorflowonspark_tpu_torch.parallel.mesh import ALL_AXES

    grid = _shard_grid(sharding, shards[0].ndim)
    if not grid:
        return shards[0]
    mesh = sharding.mesh
    axes = [a for a in ALL_AXES if any(a in g[1] for g in grid)]
    shape = list(shards[0].shape)
    for dim, _, n in grid:
        shape[dim] *= n
    full = shards[0].new_empty(shape)
    combos = list(itertools.product(*(range(mesh.shape[a]) for a in axes)))
    if len(combos) != len(shards):
        raise ValueError(f"{len(shards)} shards for a split over {axes} "
                         f"of {len(combos)}")
    for shard, idx in zip(shards, combos):
        coords = dict(zip(axes, idx))
        view = full
        for dim, split_axes, _ in grid:
            size = shard.shape[dim]
            view = view.narrow(
                dim, _dim_index(split_axes, coords, mesh) * size, size)
        view.copy_(shard)
    return full


def pipelined_from_jax(tree, n_stages):
    """A JAX ``PipelinedLM`` parameter tree (``{"embed": {token_embed,
    pos_embed}, "blocks": leaves [n_stages, layers/stage, ...], "head":
    {ln_f, lm_head}}``, numpy) -> the port's ``state_dict`` of a
    ``models.pipelined.PipelinedLM``, which names its parameters as the
    sequential ``Transformer`` does (``layer_<i>`` for layer ``i =
    stage * layers_per_stage + j``)."""
    if isinstance(tree, dict) and set(tree) == {"params"}:
        tree = tree["params"]
    flat = dict(tree["embed"])
    flat.update(tree["head"])

    def unstack(node, s, j):
        if isinstance(node, dict):
            return {k: unstack(v, s, j) for k, v in node.items()}
        arr = np.asarray(node)
        if arr.shape[0] != n_stages:
            raise ValueError(f"a blocks leaf of shape {arr.shape} does not "
                             f"lead with n_stages={n_stages}")
        return arr[s, j]

    leaf = tree["blocks"]
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    per_stage = np.asarray(leaf).shape[1]
    for s in range(n_stages):
        for j in range(per_stage):
            flat[f"layer_{s * per_stage + j}"] = unstack(tree["blocks"], s, j)
    return params_from_jax(flat)


def pipelined_to_jax(state_dict, n_stages):
    """The inverse of :func:`pipelined_from_jax`: a ``PipelinedLM`` (or
    ``Transformer``) ``state_dict`` -> the JAX ``PipelinedLM`` tree."""
    tree = params_to_jax(state_dict)
    layers = sorted((k for k in tree if k.startswith("layer_")),
                    key=lambda k: int(k.split("_")[1]))
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers do not split into "
                         f"{n_stages} stages")
    per_stage = len(layers) // n_stages

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack(nodes)

    stages = [stack([tree[layers[s * per_stage + j]]
                     for j in range(per_stage)]) for s in range(n_stages)]
    embed = {k: tree[k] for k in _EMBEDS if k in tree}
    return {"embed": embed, "blocks": stack(stages),
            "head": {"ln_f": tree["ln_f"], "lm_head": tree["lm_head"]}}


def _tensor(node):
    """A leaf as a CPU tensor: a tensor as it is (a read export's leaf
    stays over its buffer), a numpy array copied."""
    if isinstance(node, torch.Tensor):
        return node
    arr = np.asarray(node)
    # numpy has no bf16 of its own (JAX arrays come back as ml_dtypes'
    # bfloat16); f32 holds every bf16 value exactly
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def _tree(state_dict, leaf_fn):
    """Nested dicts (flax keys) of ``leaf_fn(tensor in flax layout)``."""
    tree = {}
    for name, t in state_dict.items():
        keys, layout = _flax_keys(name, t.dim())
        t = t.detach().to("cpu")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf_fn(_kernel_to_flax(t) if layout else t)
    return tree


def params_to_flax(state_dict):
    """The port's ``state_dict`` -> the JAX package's parameter tree
    (nested dicts, flax paths) of contiguous CPU tensors in their own
    dtype; kernels in flax's layout (Dense ``[in, out]``, conv HWIO).
    BatchNorm statistics are not parameters (:func:`variables_to_jax`)."""
    return _tree({n: t for n, t in state_dict.items() if not _is_stat(n)},
                 lambda t: t.contiguous())


def params_to_jax(state_dict):
    """The port's ``state_dict`` -> nested dicts of numpy arrays in the
    JAX package's layout (float32); BatchNorm statistics are left out
    (:func:`variables_to_jax` carries them)."""
    return _tree({n: t for n, t in state_dict.items() if not _is_stat(n)},
                 lambda t: np.ascontiguousarray(t.to(torch.float32).numpy()))


def variables_to_jax(state_dict):
    """The port's ``state_dict`` -> flax variables ``{"params": ...}``
    and, for a model with BatchNorm, ``"batch_stats"`` (numpy, f32)."""
    out = {"params": params_to_jax(state_dict)}
    stats = {n: t for n, t in state_dict.items() if _is_stat(n)}
    if stats:
        out["batch_stats"] = _tree(
            stats, lambda t: np.ascontiguousarray(t.float().numpy()))
    return out


def _is_jax_qleaf(node):
    """An int8 ``{"q", "scale"}`` dict or an ``Int4Weight``-shaped object
    (``q``, ``scale``, ``in_dim``, ``group_size``) of either package."""
    if isinstance(node, dict):
        return (set(node) == {"q", "scale"}
                and str(node["q"].dtype).rsplit(".", 1)[-1] == "int8")
    return all(hasattr(node, a) for a in ("q", "scale", "in_dim",
                                          "group_size"))


def qparams_from_jax(qtree):
    """A JAX quantised tree (numpy leaves; int8 dicts and
    ``Int4Weight``-shaped leaves at ``kernel``) -> the ``state_dict`` of
    the port's model after ``quantize.quantize_module``: each quantised
    kernel becomes ``<module>.q`` / ``<module>.scale`` unchanged, every
    other leaf converts as in :func:`params_from_jax`."""
    if isinstance(qtree, dict) and set(qtree) == {"params"}:
        qtree = qtree["params"]
    quantised = {}

    def split(node, path):
        if isinstance(node, dict) and not _is_jax_qleaf(node):
            return {k: v for k, v in (
                (key, split(child, path + (key,)))
                for key, child in node.items()) if v is not None}
        if _is_jax_qleaf(node):
            if path[-1] != "kernel":
                raise ValueError(f"{'/'.join(path)}: a quantized leaf that "
                                 "is not a Dense kernel")
            q, scale = ((node["q"], node["scale"]) if isinstance(node, dict)
                        else (node.q, node.scale))
            prefix = ".".join(path[:-1])
            quantised[prefix + ".q"] = _tensor(q)
            quantised[prefix + ".scale"] = _tensor(scale).float()
            return None
        return node

    out = params_from_jax(split(qtree, ()))
    out.update(quantised)
    return out


def qparams_to_jax(model):
    """The port's model (after ``quantize.quantize_module``) -> nested
    dicts of numpy arrays in the JAX package's layout: a quantised kernel
    is an int8 ``{"q", "scale"}`` dict or a ``quantize.Int4Weight`` of
    numpy arrays (build the JAX package's ``Int4Weight`` from its four
    fields); float leaves as in :func:`params_to_jax`."""
    from tensorflowonspark_tpu_torch.models.transformer import Dense

    tree = params_to_jax({n: t for n, t in model.state_dict().items()
                          if not n.endswith((".q", ".scale"))})
    for name, mod in model.named_modules():
        if not isinstance(mod, Dense) or mod.quant is None:
            continue
        node = tree
        for part in name.split("."):
            node = node.setdefault(part, {})
        leaf = mod.quantized_leaf()
        if mod.quant == "int8":
            node["kernel"] = {"q": leaf["q"].cpu().numpy(),
                              "scale": leaf["scale"].cpu().numpy()}
        else:
            node["kernel"] = quantize.Int4Weight(
                leaf.q.cpu().numpy(), leaf.scale.cpu().numpy(), leaf.in_dim,
                leaf.group_size)
    return tree


def adamw_state_from_jax(state, device="cpu"):
    """A JAX ``FusedAdamWState(count, mu, nu)`` (arrays or numpy) -> the
    port's ``FusedAdamWState`` with ``{dotted name: tensor}`` moments on
    ``device``; a bf16 ``mu`` stays bf16."""
    count, mu, nu = state
    move = lambda tree: {n: t.to(device)  # noqa: E731
                         for n, t in params_from_jax(tree).items()}
    return FusedAdamWState(
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                           device=device),
        mu=move(mu), nu=move(nu))


def adamw_state_to_jax(state):
    """The port's ``FusedAdamWState`` -> ``FusedAdamWState(count, mu,
    nu)`` of numpy in the JAX package's layout: count int32, moments
    float32 (a bf16 mu converts exactly; cast it back with
    ``.astype(jnp.bfloat16)``)."""
    return FusedAdamWState(
        count=np.asarray(int(state.count), np.int32),
        mu=params_to_jax(state.mu), nu=params_to_jax(state.nu))


def lion_state_from_jax(state, device="cpu"):
    """A JAX ``FusedLionState(count, mu)`` (arrays or numpy) -> the port's
    ``FusedLionState`` on ``device``; a bf16 ``mu`` stays bf16."""
    count, mu = state
    return FusedLionState(
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                           device=device),
        mu={n: t.to(device) for n, t in params_from_jax(mu).items()})


def lion_state_to_jax(state):
    """The port's ``FusedLionState`` -> ``FusedLionState(count, mu)`` of
    numpy in the JAX package's layout (mu float32)."""
    return FusedLionState(count=np.asarray(int(state.count), np.int32),
                          mu=params_to_jax(state.mu))


def adam8bit_state_from_jax(state, params, device="cpu"):
    """A JAX ``Adam8bitState(count, mu, nu_sqrt)`` of ``Quantized`` leaves
    (arrays or numpy, no layouts) -> the port's ``Adam8bitState`` on
    ``device``.  ``params`` (the port's ``{name: tensor}``) gives each
    Dense kernel's shape: its moments are dequantised in the JAX layout,
    transposed and quantised again (one more rounding, at most half a
    quantisation step); every other leaf's payload and scales carry over
    unchanged."""
    count, mu, nu_sqrt = state

    def carry(tree, signed):
        out = {}

        def walk(node, path):
            if isinstance(node, dict):
                for key, child in node.items():
                    walk(child, path + (key,))
                return
            name, kernel = _port_name(path)
            qt = optim8bit.Quantized(
                torch.from_numpy(np.array(node[0], np.int8)),
                torch.from_numpy(np.array(node[1], np.float32)))
            if kernel:
                out_dim, in_dim = params[name].shape
                x = optim8bit.dequantize(qt, (in_dim, out_dim),
                                         signed=signed)
                qt = optim8bit.quantize(x.T, qt.q.shape[1], signed=signed)
            out[name] = optim8bit.Quantized(qt.q.to(device),
                                            qt.scale.to(device))

        walk(tree, ())
        return out

    return optim8bit.Adam8bitState(
        torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                     device=device),
        carry(mu, True), carry(nu_sqrt, False))


# --- HuggingFace checkpoints ------------------------------------------------
#
# ``from_hf_gpt2`` / ``from_hf_bert`` / ``from_hf_llama`` /
# ``from_hf_mixtral`` map a HuggingFace model onto the port's models and
# return ``(config, state_dict)``: the port's ``TransformerConfig`` or
# ``BertConfig`` and f32 master copies under the port's names, exactly
# the tensors ``params_from_jax`` gives for the JAX package's converted
# tree.  Each takes a model (any object with ``.config`` and
# ``.state_dict()``, as a ``transformers`` model has), a ``(config,
# state_dict)`` pair (``config`` any object or dict with HF's field
# names: no ``transformers`` needed), or a local directory, which imports
# ``transformers`` and ``from_pretrained``s it.  Nothing is fetched.


def _hf_source(model_or_path, loader):
    """``(hf config, state dict, class name or None)`` of a converter's
    input; ``loader(transformers, path)`` loads a directory."""
    import os

    if isinstance(model_or_path, (str, os.PathLike)):
        try:
            import transformers
        except ImportError as e:
            raise ImportError(
                "loading a checkpoint directory needs the 'transformers' "
                "package; pass a (config, state_dict) pair instead") from e
        model = loader(transformers, os.fspath(model_or_path))
        return model.config, model.state_dict(), type(model).__name__
    if isinstance(model_or_path, (tuple, list)):
        hf_cfg, sd = model_or_path
        return _hf_fields(hf_cfg), sd, None
    return (model_or_path.config, model_or_path.state_dict(),
            type(model_or_path).__name__)


def _hf_fields(hf_cfg):
    """An HF config as an object with its fields as attributes (a dict's
    keys become them)."""
    if isinstance(hf_cfg, dict):
        import types
        return types.SimpleNamespace(**hf_cfg)
    return hf_cfg


def _f32(t):
    """A float32 master copy of an HF tensor, on its device, contiguous
    and sharing no storage with it."""
    return t.detach().to(torch.float32, copy=True).contiguous()


def _finalize(sd, label, n_layers):
    import logging

    n = sum(t.numel() for t in sd.values())
    logging.getLogger(__name__).info(
        "converted %s (%d layers, %.1fM params)", label, n_layers, n / 1e6)
    return sd


def gpt2_config(hf_cfg, **overrides):
    """TransformerConfig matching a ``transformers.GPT2Config``."""
    from tensorflowonspark_tpu_torch.models.transformer import (
        TransformerConfig)

    hf_cfg = _hf_fields(hf_cfg)
    # refuse configs whose attention numerics would silently diverge;
    # activations map onto the configurable MLP activation
    act = getattr(hf_cfg, "activation_function", "gelu_new")
    act_map = {"gelu_new": "gelu_tanh", "gelu_pytorch_tanh": "gelu_tanh",
               "gelu": "gelu_exact", "relu": "relu", "silu": "silu"}
    if act not in act_map:
        raise ValueError(f"unsupported activation_function={act!r}")
    for flag, bad in (("scale_attn_weights", False),
                      ("scale_attn_by_inverse_layer_idx", True),
                      ("reorder_and_upcast_attn", True)):
        if getattr(hf_cfg, flag, not bad) == bad:
            raise ValueError(f"unsupported GPT2Config {flag}={bad} "
                             "(attention numerics would diverge)")
    n_inner = getattr(hf_cfg, "n_inner", None)
    kw = dict(
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.n_embd,
        n_heads=hf_cfg.n_head,
        n_kv_heads=None,                     # GPT-2 is MHA
        n_layers=hf_cfg.n_layer,
        d_ff=n_inner if n_inner is not None else 4 * hf_cfg.n_embd,
        max_seq_len=hf_cfg.n_positions,
        causal=True,
        rope=False,                          # learned absolute positions
        use_bias=True,
        ln_eps=hf_cfg.layer_norm_epsilon,
        activation=act_map[act],
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def from_hf_gpt2(model_or_path, dtype="float32", **config_overrides):
    """A GPT-2 LM (``GPT2LMHeadModel``, a ``(config, state_dict)`` pair
    or a local directory) -> ``(TransformerConfig, state_dict)``.  HF's
    ``Conv1D`` weights are ``[in, out]``: the port's ``Dense`` takes
    ``[out, in]``, so they transpose (``c_attn`` split into q / k / v
    first); ``lm_head.weight`` is used whether tied or not."""
    hf_cfg, sd, _ = _hf_source(
        model_or_path, lambda tf, p: tf.GPT2LMHeadModel.from_pretrained(p))
    cfg = gpt2_config(hf_cfg, dtype=dtype, **config_overrides)
    out = {"token_embed.weight": _f32(sd["transformer.wte.weight"]),
           "pos_embed.weight": _f32(sd["transformer.wpe.weight"])}
    for i in range(cfg.n_layers):
        pre, dst = f"transformer.h.{i}.", f"layer_{i}."
        wq, wk, wv = torch.chunk(sd[pre + "attn.c_attn.weight"], 3, dim=1)
        bq, bk, bv = torch.chunk(sd[pre + "attn.c_attn.bias"], 3)
        for ln in ("ln1", "ln2"):
            src = pre + ("ln_1." if ln == "ln1" else "ln_2.")
            out[dst + ln + ".weight"] = _f32(sd[src + "weight"])
            out[dst + ln + ".bias"] = _f32(sd[src + "bias"])
        for name, w, b in (("attn.query", wq, bq), ("attn.key", wk, bk),
                           ("attn.value", wv, bv),
                           ("attn.out", sd[pre + "attn.c_proj.weight"],
                            sd[pre + "attn.c_proj.bias"]),
                           ("mlp.wi", sd[pre + "mlp.c_fc.weight"],
                            sd[pre + "mlp.c_fc.bias"]),
                           ("mlp.wo", sd[pre + "mlp.c_proj.weight"],
                            sd[pre + "mlp.c_proj.bias"])):
            out[dst + name + ".weight"] = _f32(w.t())
            out[dst + name + ".bias"] = _f32(b)
    out["ln_f.weight"] = _f32(sd["transformer.ln_f.weight"])
    out["ln_f.bias"] = _f32(sd["transformer.ln_f.bias"])
    # lm_head.weight aliases wte when tied (the GPT-2 default) and is the
    # real output projection when untied: use it either way
    out["lm_head.weight"] = _f32(sd.get("lm_head.weight",
                                        sd["transformer.wte.weight"]))
    return cfg, _finalize(out, "GPT-2", cfg.n_layers)


def bert_config(hf_cfg, **overrides):
    """models.bert.BertConfig matching a ``transformers.BertConfig``."""
    from tensorflowonspark_tpu_torch.models.bert import BertConfig

    hf_cfg = _hf_fields(hf_cfg)
    act = getattr(hf_cfg, "hidden_act", "gelu")
    act_map = {"gelu": "gelu_exact", "gelu_new": "gelu_tanh",
               "gelu_pytorch_tanh": "gelu_tanh", "relu": "relu"}
    if act not in act_map:
        raise ValueError(f"unsupported hidden_act={act!r}")
    if getattr(hf_cfg, "position_embedding_type", "absolute") != "absolute":
        raise ValueError("only absolute position embeddings are supported")
    if getattr(hf_cfg, "is_decoder", False) or getattr(
            hf_cfg, "add_cross_attention", False):
        raise ValueError("decoder-style BERT (is_decoder/add_cross_attention)"
                         " is not supported: models.bert is a bidirectional"
                         " encoder with no cross-attention")
    kw = dict(
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.hidden_size,
        n_heads=hf_cfg.num_attention_heads,
        n_layers=hf_cfg.num_hidden_layers,
        d_ff=hf_cfg.intermediate_size,
        max_seq_len=hf_cfg.max_position_embeddings,
        type_vocab_size=hf_cfg.type_vocab_size,
        ln_eps=hf_cfg.layer_norm_eps,
        activation=act_map[act],
    )
    kw.update(overrides)
    return BertConfig(**kw)


def _bert_loader(tf, path):
    archs = getattr(tf.AutoConfig.from_pretrained(path), "architectures",
                    None) or []
    loader = (tf.AutoModelForPreTraining if "BertForPreTraining" in archs
              else tf.AutoModel)
    return loader.from_pretrained(path)


def from_hf_bert(model_or_path, dtype="float32", **config_overrides):
    """An HF BERT -> ``(BertConfig, state_dict)``.

    ``BertModel`` keys (no prefix) give the ``BertEncoder``'s state dict;
    ``BertForPreTraining`` keys (``bert.`` and its ``cls.`` heads) give
    ``BertForPreTraining``'s: the encoder under ``encoder.`` with the MLM
    and NSP heads and the pooler beside it.  An untied MLM decoder is
    refused (the port's MLM logits are tied to the embedding)."""
    hf_cfg, sd, kind = _hf_source(model_or_path, _bert_loader)
    cfg = bert_config(hf_cfg, dtype=dtype, **config_overrides)
    kind = kind or "state dict"
    if "embeddings.word_embeddings.weight" in sd:
        pre = ""
    elif ("bert.embeddings.word_embeddings.weight" in sd
          and "cls.seq_relationship.weight" in sd
          and "cls.predictions.transform.dense.weight" in sd):
        pre = "bert."
    else:
        raise ValueError(
            f"unsupported model class {kind}: pass a BertModel (encoder) "
            "or BertForPreTraining (encoder + MLM/NSP heads)")
    dec = sd.get(pre and "cls.predictions.decoder.weight")
    if dec is not None and not torch.equal(
            dec, sd[pre + "embeddings.word_embeddings.weight"]):
        raise ValueError(
            "untied MLM decoder (tie_word_embeddings=False) is not "
            "supported: models.bert ties MLM logits to the embedding")
    enc = "encoder." if pre else ""
    out = {}
    for dst, src in (("token_embed.weight", "word_embeddings.weight"),
                     ("pos_embed.weight", "position_embeddings.weight"),
                     ("type_embed.weight", "token_type_embeddings.weight"),
                     ("ln_embed.weight", "LayerNorm.weight"),
                     ("ln_embed.bias", "LayerNorm.bias")):
        out[enc + dst] = _f32(sd[pre + "embeddings." + src])
    for i in range(cfg.n_layers):
        lp, dst = f"{pre}encoder.layer.{i}.", f"{enc}layer_{i}."
        # post-LN: ln1 follows attention, ln2 follows the MLP
        for name, src in (("ln1", "attention.output.LayerNorm"),
                          ("ln2", "output.LayerNorm"),
                          ("attn.query", "attention.self.query"),
                          ("attn.key", "attention.self.key"),
                          ("attn.value", "attention.self.value"),
                          ("attn.out", "attention.output.dense"),
                          ("mlp.wi", "intermediate.dense"),
                          ("mlp.wo", "output.dense")):
            out[dst + name + ".weight"] = _f32(sd[lp + src + ".weight"])
            out[dst + name + ".bias"] = _f32(sd[lp + src + ".bias"])
    if pre:     # BertForPreTraining: heads + pooler around the encoder
        for name, src in (("mlm_dense", "cls.predictions.transform.dense"),
                          ("mlm_ln", "cls.predictions.transform.LayerNorm"),
                          ("pooler", "bert.pooler.dense"),
                          ("nsp_head", "cls.seq_relationship")):
            out[name + ".weight"] = _f32(sd[src + ".weight"])
            out[name + ".bias"] = _f32(sd[src + ".bias"])
        out["mlm_bias"] = _f32(sd["cls.predictions.bias"])
    return cfg, _finalize(out, f"BERT[{kind}]", cfg.n_layers)


def llama_config(hf_cfg, **overrides):
    """TransformerConfig matching a ``transformers.LlamaConfig`` (the
    LLaMA / Mistral-style decoder family: RMSNorm, RoPE, GQA, SwiGLU)."""
    from tensorflowonspark_tpu_torch.models.transformer import (
        TransformerConfig)

    hf_cfg = _hf_fields(hf_cfg)
    act = getattr(hf_cfg, "hidden_act", "silu")
    act_map = {"silu": "silu", "gelu": "gelu_exact",
               "gelu_pytorch_tanh": "gelu_tanh"}
    if act not in act_map:
        raise ValueError(f"unsupported hidden_act={act!r}")
    if getattr(hf_cfg, "rope_scaling", None):
        raise ValueError("rope_scaling is not supported (plain RoPE only)")
    if getattr(hf_cfg, "attention_dropout", 0.0):
        raise ValueError("attention_dropout != 0 is not supported")
    head_dim = getattr(hf_cfg, "head_dim", None)
    if head_dim and head_dim * hf_cfg.num_attention_heads != \
            hf_cfg.hidden_size:
        raise ValueError(f"head_dim={head_dim} * num_attention_heads != "
                         "hidden_size (non-standard head widths would "
                         "change the q/k/v projection shapes)")
    if getattr(hf_cfg, "attention_bias", False):
        # TransformerConfig.use_bias covers attention AND MLP denses;
        # attention-only bias (Qwen-style) is not expressible
        raise ValueError("attention_bias=True is not supported")
    if getattr(hf_cfg, "mlp_bias", False):
        # silently dropping the bias tensors would convert to wrong logits
        raise ValueError("mlp_bias=True is not supported")
    kw = dict(
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.hidden_size,
        n_heads=hf_cfg.num_attention_heads,
        n_kv_heads=getattr(hf_cfg, "num_key_value_heads",
                           hf_cfg.num_attention_heads),
        n_layers=hf_cfg.num_hidden_layers,
        d_ff=hf_cfg.intermediate_size,
        max_seq_len=hf_cfg.max_position_embeddings,
        causal=True,
        rope=True,
        rope_theta=float(getattr(hf_cfg, "rope_theta", 10000.0)),
        use_bias=False,
        ln_eps=hf_cfg.rms_norm_eps,
        norm_type="rmsnorm",
        mlp_style="gated",
        activation=act_map[act],
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def _llama_common(sd, n_layers):
    """The LLaMA-layout tensors every decoder of the family shares:
    embeddings, the final norm, the unembedding (the token table when
    tied: HF then omits ``lm_head.weight``), each layer's norms and
    attention projections (HF's ``[out, in]`` is the port's layout)."""
    out = {"token_embed.weight": _f32(sd["model.embed_tokens.weight"])}
    for i in range(n_layers):
        pre, dst = f"model.layers.{i}.", f"layer_{i}."
        out[dst + "ln1.weight"] = _f32(sd[pre + "input_layernorm.weight"])
        out[dst + "ln2.weight"] = _f32(
            sd[pre + "post_attention_layernorm.weight"])
        for name, proj in (("query", "q_proj"), ("key", "k_proj"),
                           ("value", "v_proj"), ("out", "o_proj")):
            out[f"{dst}attn.{name}.weight"] = _f32(
                sd[f"{pre}self_attn.{proj}.weight"])
    out["ln_f.weight"] = _f32(sd["model.norm.weight"])
    out["lm_head.weight"] = _f32(sd.get("lm_head.weight",
                                        sd["model.embed_tokens.weight"]))
    return out


def from_hf_llama(model_or_path, dtype="float32", **config_overrides):
    """A LLaMA-family causal LM (``LlamaForCausalLM``, a ``(config,
    state_dict)`` pair or a local directory) -> ``(TransformerConfig,
    state_dict)``.  RMSNorm -> ``norm_type='rmsnorm'``, SwiGLU ->
    ``mlp_style='gated'`` (``gate_proj`` -> ``wi_gate``, ``up_proj`` ->
    ``wi_up``, ``down_proj`` -> ``wo``), GQA -> ``n_kv_heads``, HF's
    rotate-half RoPE is the port's."""
    hf_cfg, sd, _ = _hf_source(
        model_or_path, lambda tf, p: tf.LlamaForCausalLM.from_pretrained(p))
    cfg = llama_config(hf_cfg, dtype=dtype, **config_overrides)
    out = _llama_common(sd, cfg.n_layers)
    for i in range(cfg.n_layers):
        pre, dst = f"model.layers.{i}.mlp.", f"layer_{i}.mlp."
        for name, proj in (("wi_gate", "gate_proj"), ("wi_up", "up_proj"),
                           ("wo", "down_proj")):
            out[f"{dst}{name}.weight"] = _f32(sd[f"{pre}{proj}.weight"])
    return cfg, _finalize(out, "LLaMA", cfg.n_layers)


def mixtral_config(hf_cfg, **overrides):
    """TransformerConfig matching a ``transformers.MixtralConfig``
    (LLaMA-style attention + a gated-expert MoE MLP in EVERY layer).

    Router parity: Mixtral softmaxes the router logits, picks top-k, and
    renormalizes over the chosen experts — exactly the port's
    ``moe_router='topk'`` convention (softmax is monotonic, so top-k over
    probabilities equals top-k over logits).  Mixtral drops no tokens, so
    the default capacity factor here is E/k (capacity == every token);
    lower it explicitly to fine-tune with GShard capacity bounds.
    """
    import dataclasses

    from tensorflowonspark_tpu_torch.models.transformer import (
        TransformerConfig)

    hf_cfg = _hf_fields(hf_cfg)
    E = hf_cfg.num_local_experts
    k = hf_cfg.num_experts_per_tok
    base = llama_config(hf_cfg)
    # sliding-window attention is not implemented; HF only applies the
    # window beyond `sliding_window` tokens, so sequences at or under it
    # are numerics-identical — clamp max_seq_len to stay in that regime
    window = getattr(hf_cfg, "sliding_window", None)
    max_seq = base.max_seq_len if window is None \
        else min(base.max_seq_len, int(window))
    kw = dict(
        dataclasses.asdict(base),
        max_seq_len=max_seq,
        num_experts=E,
        moe_every=1,
        moe_router="topk",
        moe_top_k=k,
        moe_capacity_factor=float(E) / float(k),
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def from_hf_mixtral(model_or_path, dtype="float32", **config_overrides):
    """A Mixtral MoE causal LM (``MixtralForCausalLM``, a ``(config,
    state_dict)`` pair or a local directory) -> ``(TransformerConfig,
    state_dict)``.  Attention and norms map as LLaMA's; each layer's
    experts stack into the port's ``[E, in, out]`` expert weights (``w1``
    -> ``experts_wi``, ``w3`` -> ``experts_up``, ``w2`` ->
    ``experts_wo``), the router gate -> ``router``."""
    hf_cfg, sd, _ = _hf_source(
        model_or_path,
        lambda tf, p: tf.MixtralForCausalLM.from_pretrained(p))
    cfg = mixtral_config(hf_cfg, dtype=dtype, **config_overrides)
    out = _llama_common(sd, cfg.n_layers)
    for i in range(cfg.n_layers):
        moe, dst = f"model.layers.{i}.block_sparse_moe.", f"layer_{i}.moe."
        out[dst + "router.weight"] = _f32(sd[moe + "gate.weight"])
        for name, w in (("experts_wi", "w1"), ("experts_up", "w3"),
                        ("experts_wo", "w2")):
            # HF Linear [out, in] -> stacked [E, in, out]
            out[dst + name] = torch.stack([
                _f32(sd[f"{moe}experts.{e}.{w}.weight"]).t()
                for e in range(cfg.num_experts)]).contiguous()
    return cfg, _finalize(out, "Mixtral", cfg.n_layers)
