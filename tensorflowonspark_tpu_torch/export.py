"""Saved-model export/load for the port's own artifact.

The artifact keeps the JAX package's layout: ``tfos_model.json`` holds
the builder spec (``"module:callable"`` + JSON kwargs) and named
signatures, so the same tooling reads both.  Parameters are stored with
``torch.save`` in ``params.pt`` (the JAX package writes
``params.msgpack``; reading those needs msgpack and waits for a later
slice — ROADMAP: reading JAX params.msgpack exports).
"""
import importlib
import json
import logging
import os

import torch

logger = logging.getLogger(__name__)

MODEL_SPEC = "tfos_model.json"
PARAMS_FILE = "params.pt"
JAX_PARAMS_FILE = "params.msgpack"
DEFAULT_SIGNATURE = "serving_default"
DEFAULT_BUILDER = ("tensorflowonspark_tpu_torch.models.transformer:"
                   "build_transformer")
_PORT_PREFIX = "tensorflowonspark_tpu_torch."


def _resolve_builder(spec):
    """Import ``"module:callable"`` -> the callable.  Only the port's own
    builders resolve: an export naming another package's module is not
    loadable here."""
    mod_name, _, attr = spec.partition(":")
    if not attr:
        raise ValueError(f"builder spec {spec!r} must look like "
                         "'module:callable'")
    if not mod_name.startswith(_PORT_PREFIX):
        raise NotImplementedError(
            f"builder {spec!r} is not a module of the port; loading JAX "
            "exports is not ported yet (ROADMAP: reading JAX "
            "params.msgpack exports)")
    obj = importlib.import_module(mod_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def export_saved_model(export_dir, state_dict, builder=DEFAULT_BUILDER,
                       builder_kwargs=None, signatures=None):
    """Write the serving artifact: ``tfos_model.json`` and ``params.pt``
    (``state_dict`` saved as given, on the CPU)."""
    _resolve_builder(builder)  # fail fast on a bad spec
    os.makedirs(export_dir, exist_ok=True)
    spec = {
        "format": "tfos-tpu-saved-model",
        "version": 1,
        "builder": builder,
        "builder_kwargs": builder_kwargs or {},
        "signatures": signatures or {
            DEFAULT_SIGNATURE: {"inputs": {"input": {}},
                                "outputs": ["output"]}},
    }
    with open(os.path.join(export_dir, MODEL_SPEC), "w") as f:
        json.dump(spec, f, indent=2)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(export_dir, PARAMS_FILE))
    logger.info("exported saved model to %s", export_dir)
    return export_dir


def _read_spec(export_dir):
    with open(os.path.join(export_dir, MODEL_SPEC)) as f:
        spec = json.load(f)
    if spec.get("format") != "tfos-tpu-saved-model":
        raise ValueError(f"{export_dir} is not a tfos-tpu saved model")
    return spec


def load_model(export_dir, device="cpu"):
    """Rebuild ``(model, spec)`` from an export dir: the builder's module
    with the stored parameters loaded onto ``device`` (in their stored
    dtype).  The module is built on the meta device first, so no
    throwaway initialisation runs."""
    spec = _read_spec(export_dir)
    path = os.path.join(export_dir, PARAMS_FILE)
    if not os.path.exists(path):
        if os.path.exists(os.path.join(export_dir, JAX_PARAMS_FILE)):
            raise NotImplementedError(
                f"{export_dir} holds a JAX params.msgpack; reading it is not "
                "ported yet (ROADMAP: reading JAX params.msgpack exports)")
        raise FileNotFoundError(path)
    builder = _resolve_builder(spec["builder"])
    with torch.device("meta"):
        model = builder(**spec["builder_kwargs"])
    state = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(state, strict=True, assign=True)
    return model, spec
