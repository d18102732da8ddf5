"""Saved-model export/load for the port's own artifact — counterpart of
``tensorflowonspark_tpu/export.py``.

The artifact keeps the JAX package's layout: ``tfos_model.json`` holds
the builder spec (``"module:callable"`` + JSON kwargs) and named
signatures, so the same tooling reads both.  Parameters are stored with
``torch.save`` in ``params.pt`` (the JAX package writes
``params.msgpack``; reading those needs msgpack and waits for a later
slice — ROADMAP: reading JAX params.msgpack exports).  Files go through
`fsio`, so an export dir may be any path `fsio` opens.

- `export_saved_model` writes the artifact (chief only);
- `load_model` rebuilds the module itself (serving's decode re-enters it
  per token);
- `load_saved_model` gives the signature's forward as a callable on
  numpy inputs (the pipeline's `TFModel` and the batch CLI use it);
- `read_signature` and `coerce_inputs` are the metadata half.

Loaders follow the port's device rule (`device.resolve`): the card
unless the caller asks for the CPU, and without CUDA they raise.
"""
import importlib
import json
import logging

from . import fsio

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
            "exports is not ported yet (ROADMAP: reading JAX params.msgpack "
            "exports)")
    obj = importlib.import_module(mod_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def export_saved_model(export_dir, state_dict, builder=DEFAULT_BUILDER,
                       builder_kwargs=None, signatures=None, is_chief=True,
                       aot_batch_sizes=None, aot_platforms=None,
                       quantize_int8=False, quantize_kwargs=None):
    """Write the serving artifact: ``tfos_model.json`` and ``params.pt``
    (``state_dict`` saved as given, on the CPU).

    Non-chief processes write nothing and return None, like the
    reference's chief-only export.  ``quantize_int8`` (a stored int8
    export) and ``aot_batch_sizes`` / ``aot_platforms`` (compiled
    artifacts for the native runner) raise NotImplementedError."""
    if quantize_int8 or quantize_kwargs:
        raise NotImplementedError(
            "export_saved_model(quantize_int8=) is not ported yet (ROADMAP "
            "A5: the stored int8 export)")
    if aot_batch_sizes or aot_platforms:
        raise NotImplementedError(
            "export_saved_model(aot_batch_sizes=) is not ported yet (ROADMAP "
            "A8: aot and the native runner)")
    if not is_chief:
        logger.info("non-chief process skipping export to %s", export_dir)
        return None
    import torch

    _resolve_builder(builder)  # fail fast on a bad spec
    fsio.makedirs(export_dir)
    spec = {
        "format": "tfos-tpu-saved-model",
        "version": 1,
        "builder": builder,
        "builder_kwargs": builder_kwargs or {},
        "signatures": signatures or {
            DEFAULT_SIGNATURE: {"inputs": {"input": {}},
                                "outputs": ["output"]}},
    }
    with fsio.fopen(fsio.join(export_dir, MODEL_SPEC), "w") as f:
        json.dump(spec, f, indent=2)
    with fsio.fopen(fsio.join(export_dir, PARAMS_FILE), "wb") as f:
        torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, f)
    logger.info("exported saved model to %s", export_dir)
    return export_dir


def _read_spec(export_dir):
    with fsio.fopen(fsio.join(export_dir, MODEL_SPEC), "r") as f:
        spec = json.load(f)
    if spec.get("format") != "tfos-tpu-saved-model":
        raise ValueError(f"{export_dir} is not a tfos-tpu saved model")
    return spec


def read_signature(export_dir, signature_def_key=None):
    """Read ``(spec, signature)`` from an export dir without loading
    params — the cheap metadata half of `load_saved_model` (format check
    and signature lookup included)."""
    spec = _read_spec(export_dir)
    sig_key = signature_def_key or DEFAULT_SIGNATURE
    try:
        return spec, spec["signatures"][sig_key]
    except KeyError:
        raise ValueError(
            f"signature {sig_key!r} not found; available: "
            f"{sorted(spec['signatures'])}") from None


def _load(export_dir, spec, dev):
    import torch

    path = fsio.join(export_dir, PARAMS_FILE)
    if not fsio.exists(path):
        if fsio.exists(fsio.join(export_dir, JAX_PARAMS_FILE)):
            raise NotImplementedError(
                f"{export_dir} holds a JAX params.msgpack; reading it is not "
                "ported yet (ROADMAP: reading JAX params.msgpack exports)")
        raise FileNotFoundError(path)
    builder = _resolve_builder(spec["builder"])
    with torch.device("meta"):
        model = builder(**spec["builder_kwargs"])
    with fsio.fopen(path, "rb") as f:
        state = torch.load(f, map_location=dev, weights_only=True)
    model.load_state_dict(state, strict=True, assign=True)
    return model


def load_model(export_dir, device=None):
    """Rebuild ``(model, spec)`` from an export dir: the builder's module
    with the stored parameters loaded onto ``device`` (``cuda`` unless
    the caller asks for the CPU; `device.resolve`), in their stored
    dtype.  The module is built on the meta device first, so no
    throwaway initialisation runs."""
    from .device import resolve

    dev = resolve(device)
    spec = _read_spec(export_dir)
    return _load(export_dir, spec, dev), spec


class SavedModel:
    """The forward of one signature of an export, on numpy: called with
    the signature's inputs (numpy arrays, in the signature's order) it
    runs the module under ``torch.inference_mode()`` on `device` and
    returns its output as a numpy array (a tuple of them for a module
    with several outputs).  numpy has no bfloat16, so a bf16 output
    reaches numpy as float32 (exactly: every bf16 value is an f32 value).
    ``model`` is the loaded module, ``device`` its ``torch.device``."""

    def __init__(self, model, device, signature):
        self.model = model.eval()
        self.device = device
        self.signature = signature

    def __call__(self, *inputs):
        import numpy as np
        import torch

        with torch.inference_mode():
            args = [torch.tensor(np.asarray(a)).to(self.device)
                    for a in inputs]
            out = self.model(*args)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            outs = [o.float() if o.dtype == torch.bfloat16 else o
                    for o in outs]
            arrays = tuple(o.cpu().numpy() for o in outs)
        return arrays if isinstance(out, (tuple, list)) else arrays[0]


def load_saved_model(export_dir, signature_def_key=None, device=None):
    """Load ``(predict, signature)`` from an export dir: ``predict`` is a
    `SavedModel` over the rebuilt module on ``device`` (``cuda`` unless
    the caller asks for the CPU; without CUDA it raises).  Maps the
    reference's ``tf.saved_model.load`` + signature lookup
    (pipeline.py:596-613)."""
    from .device import resolve

    dev = resolve(device)
    spec, signature = read_signature(export_dir, signature_def_key)
    return SavedModel(_load(export_dir, spec, dev), dev, signature), signature


def coerce_inputs(signature, columns):
    """Reshape flat tabular columns into the signature's tensor shapes.

    ``columns`` is {input_name: list_of_row_values}; each row value may be a
    flat list that the recorded shape (leading batch dim excluded, -1 ok)
    restores to its tensor form — the reference's shape-coercion for Spark's
    flat arrays (pipeline.py:615-630).
    """
    import numpy as np

    arrays = []
    for name, meta in signature["inputs"].items():
        if name not in columns:
            raise KeyError(f"input column {name!r} missing; have {sorted(columns)}")
        arr = np.asarray(columns[name], dtype=meta.get("dtype") or None)
        shape = meta.get("shape")
        if shape:
            arr = arr.reshape((arr.shape[0],) + tuple(int(d) for d in shape))
        arrays.append(arr)
    return arrays
