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
from one state.
"""
import numpy as np
import torch

from tensorflowonspark_tpu_torch.ops.fused_optim import FusedAdamWState

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
        out[name] = _tensor(arr)

    walk(tree, ())
    return out


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
