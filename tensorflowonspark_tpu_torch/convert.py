"""Parameter-tree conversion between the JAX package and the port.

``params_from_jax`` turns the JAX package's Transformer param tree, as
nested dicts of numpy arrays (``{"layer_0": {"attn": {"query":
{"kernel": ...}}}}``), into the port's ``state_dict``; ``params_to_jax``
goes back.  Flax ``Dense`` kernels are ``[in, out]`` and the port's
``Dense`` weights ``[out, in]``, so kernels transpose; ``embedding``
(Embed) and ``scale`` (norms) become ``weight`` unchanged.
"""
import numpy as np
import torch

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
        leaf = path[-1]
        if leaf == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: expected a 2-D Dense "
                                 f"kernel, got shape {arr.shape}")
            arr, leaf = arr.T, "weight"
        elif leaf in ("embedding", "scale"):
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"{'/'.join(path)}: unknown parameter {leaf!r}")
        name = ".".join(path[:-1] + (leaf,))
        out[name] = torch.from_numpy(np.ascontiguousarray(arr).copy())

    walk(tree, ())
    return out


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
