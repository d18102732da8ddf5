"""Parameter-tree conversion between the JAX package and the port.

``params_from_jax`` turns the JAX package's Transformer param tree, as
nested dicts of numpy arrays (``{"layer_0": {"attn": {"query":
{"kernel": ...}}}}``), into the port's ``state_dict``; ``params_to_jax``
goes back.  Flax ``Dense`` kernels are ``[in, out]`` and the port's
``Dense`` weights ``[out, in]``, so kernels transpose; ``embedding``
(Embed) and ``scale`` (norms) become ``weight`` unchanged.

``adamw_state_from_jax`` / ``adamw_state_to_jax`` carry a fused-AdamW
state (``count`` and the ``mu`` / ``nu`` trees, which mirror the params)
across with the same names and transposes, so both packages can step
from one state; ``lion_state_from_jax`` / ``lion_state_to_jax`` do the
same for a fused-Lion state (``count``, ``mu``).
``adam8bit_state_from_jax`` carries an 8-bit Adam state: payloads and
scales unchanged where the port stores the leaf as JAX does, and a Dense
kernel's moments dequantised, transposed and quantised again in the
port's layout (its blocks run along the other axis).

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

_EMBEDS = ("token_embed", "pos_embed")
_NORMS = ("ln1", "ln2", "ln_f")


def params_from_jax(tree):
    """Nested dicts of arrays (a flax ``params`` tree, optionally under a
    sole ``"params"`` key) -> ``{dotted name: torch.Tensor}``."""
    if isinstance(tree, dict) and set(tree) == {"params"}:
        tree = tree["params"]
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(child, path + (key,))
            return
        arr = np.asarray(node)
        name, kernel = _port_name(path)
        if kernel:
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: expected a 2-D Dense "
                                 f"kernel, got shape {arr.shape}")
            arr = arr.T
        out[name] = _tensor(arr)

    walk(tree, ())
    return out


def _port_name(path):
    """A JAX parameter path -> ``(the port's dotted name, True for a
    Dense kernel, which the port stores transposed)``."""
    leaf = path[-1]
    if leaf in ("kernel", "embedding", "scale"):
        return ".".join(path[:-1] + ("weight",)), leaf == "kernel"
    if leaf != "bias":
        raise ValueError(f"{'/'.join(path)}: unknown parameter {leaf!r}")
    return ".".join(path), False


def _tensor(arr):
    # numpy has no bf16 of its own (JAX arrays come back as ml_dtypes'
    # bfloat16); f32 holds every bf16 value exactly
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def params_to_jax(state_dict):
    """The port's ``state_dict`` -> nested dicts of numpy arrays in the
    JAX package's layout (float32)."""
    tree = {}
    for name, t in state_dict.items():
        parts = name.split(".")
        arr = t.detach().to("cpu", torch.float32).numpy()
        module, leaf = parts[-2], parts[-1]
        if leaf == "weight":
            if module in _EMBEDS:
                leaf = "embedding"
            elif module in _NORMS:
                leaf = "scale"
            else:
                arr, leaf = arr.T, "kernel"
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def _is_jax_qleaf(node):
    """An int8 ``{"q", "scale"}`` dict or an ``Int4Weight``-shaped object
    (``q``, ``scale``, ``in_dim``, ``group_size``) of either package."""
    if isinstance(node, dict):
        return (set(node) == {"q", "scale"}
                and np.asarray(node["q"]).dtype == np.int8)
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
            quantised[prefix + ".q"] = _tensor(np.asarray(q))
            quantised[prefix + ".scale"] = _tensor(
                np.asarray(scale, np.float32))
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
