"""Saved-model export/load for the port's own artifact — counterpart of
``tensorflowonspark_tpu/export.py``.

The artifact keeps the JAX package's layout: ``tfos_model.json`` holds
the builder spec (``"module:callable"`` + JSON kwargs) and named
signatures, so the same tooling reads both.  The port stores its
parameters with ``torch.save`` in ``params.pt``; an export of the JAX
package (``params.msgpack``, a flax tree) loads too: its builder maps
to the port's through ``convert.port_builder`` (a JAX builder without
a counterpart raises NotImplementedError), and ``serialization`` reads
the tree, ``convert`` names it the port's way.  A stored int8 export
(``quantize_int8=True``; ``"quantized": "int8"`` and ``dequant_dtype``
in the spec, as the JAX package records them) keeps each quantised
kernel as the int8 ``q`` / f32 ``scale`` of the quantised ``Dense``.
Files go through `fsio`, so an export dir may be any path `fsio` opens.

- `export_saved_model` writes the port's artifact (chief only),
  `export_jax_saved_model` the JAX package's (``params.msgpack``);
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

from . import convert, fsio, serialization

logger = logging.getLogger(__name__)

MODEL_SPEC = "tfos_model.json"
PARAMS_FILE = "params.pt"
JAX_PARAMS_FILE = "params.msgpack"
DEFAULT_SIGNATURE = "serving_default"
DEFAULT_BUILDER = ("tensorflowonspark_tpu_torch.models.transformer:"
                   "build_transformer")
_PORT_PREFIX = "tensorflowonspark_tpu_torch."
JAX_TRANSFORMER_BUILDER = ("tensorflowonspark_tpu.models.transformer:"
                           "build_transformer")


def _resolve_builder(spec):
    """Import ``"module:callable"`` -> the callable.  The port's builders
    resolve, and the JAX package's through ``convert.port_builder``; any
    other package's module is not loadable here."""
    if ":" not in spec or not spec.partition(":")[2]:
        raise ValueError(f"builder spec {spec!r} must look like "
                         "'module:callable'")
    mod_name, _, attr = convert.port_builder(spec).partition(":")
    if not mod_name.startswith(_PORT_PREFIX):
        raise NotImplementedError(
            f"builder {spec!r} is a module of neither the port nor the JAX "
            "package")
    obj = importlib.import_module(mod_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def export_saved_model(export_dir, state_dict, builder=DEFAULT_BUILDER,
                       builder_kwargs=None, signatures=None, is_chief=True,
                       aot_batch_sizes=None, aot_platforms=None,
                       quantize_int8=False, quantize_kwargs=None,
                       device=None):
    """Write the serving artifact: ``tfos_model.json`` and ``params.pt``
    (``state_dict`` saved as given, on the CPU).

    Non-chief processes write nothing and return None, like the
    reference's chief-only export.  ``quantize_int8`` stores the Dense
    kernels that ``quantize.quantize_tree`` selects (``quantize_kwargs``
    forwards ``targets`` / ``min_elements`` / ``axis``) as int8 ``q``
    ``[in, out]`` / f32 ``scale`` entries, and records ``"quantized":
    "int8"`` and the narrowest float dtype of ``state_dict`` as
    ``dequant_dtype``, as the JAX export does.

    ``aot_batch_sizes`` also writes ahead-of-time artifacts of the
    default signature (else the first declared one) at those batch sizes
    (`aot.export_aot`): the module is rebuilt from what was just written
    (``load_model``, on ``device``: ``cuda`` unless the CPU is asked
    for) and exported for each of ``aot_platforms`` (default: that
    device) in both forms: the ``torch.export`` program (engine ``jax``)
    and the AOTInductor package (engine ``native``).  Artifacts are local files: a remote ``export_dir`` raises before
    anything is written."""
    if quantize_kwargs and not quantize_int8:
        raise ValueError("quantize_kwargs needs quantize_int8=True")
    if aot_platforms and not aot_batch_sizes:
        raise ValueError("aot_platforms needs aot_batch_sizes")
    if aot_batch_sizes:
        # checked before any write, so a large params upload is not
        # wasted on an export that cannot finish
        if fsio.is_remote(export_dir):
            raise ValueError(
                "aot_batch_sizes requires a local export_dir: AOT artifacts "
                "must be local files — export locally, then copy the "
                "directory")
        from .device import resolve

        device = resolve(device)
    if not is_chief:
        logger.info("non-chief process skipping export to %s", export_dir)
        return None
    import torch

    _resolve_builder(builder)  # fail fast on a bad spec
    state, quant = {k: v.detach() for k, v in state_dict.items()}, None
    if quantize_int8:    # on the tensors' device, then to the CPU
        state, quant = _quantize_state(state, quantize_kwargs or {})
    state = {k: v.cpu() for k, v in state.items()}
    _write_spec(export_dir, builder, builder_kwargs, signatures, quant)
    with fsio.fopen(fsio.join(export_dir, PARAMS_FILE), "wb") as f:
        torch.save(state, f)
    logger.info("exported saved model to %s", export_dir)
    if aot_batch_sizes:
        from . import aot

        spec = _read_spec(export_dir)
        names = list(spec["signatures"])
        _, signature = read_signature(
            export_dir, DEFAULT_SIGNATURE if DEFAULT_SIGNATURE in names
            else names[0])
        model, _ = load_model(export_dir, device=device)
        aot.export_aot(export_dir, model, signature,
                       batch_sizes=aot_batch_sizes, platforms=aot_platforms)
    return export_dir


def export_jax_saved_model(export_dir, state_dict, builder_kwargs=None,
                           signatures=None, is_chief=True):
    """Write the JAX package's artifact from the port's ``state_dict``:
    the JAX builder spec of ``build_transformer`` and ``params.msgpack``
    (``convert.params_to_flax``, each leaf in its own dtype, written by
    ``serialization``).  Both packages load it."""
    if not is_chief:
        return None
    builder = JAX_TRANSFORMER_BUILDER
    _write_spec(export_dir, builder, builder_kwargs, signatures, None)
    serialization.save(fsio.join(export_dir, JAX_PARAMS_FILE),
                       convert.params_to_flax(state_dict))
    logger.info("exported JAX-format saved model to %s", export_dir)
    return export_dir


def _write_spec(export_dir, builder, builder_kwargs, signatures, quant):
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
    if quant is not None:
        spec["quantized"] = "int8"
        spec["dequant_dtype"] = quant
    with fsio.fopen(fsio.join(export_dir, MODEL_SPEC), "w") as f:
        json.dump(spec, f, indent=2)


def _quantize_state(state, quantize_kwargs):
    """``(state with the selected kernels as <module>.q / .scale,
    dequant dtype name)``: ``quantize.quantize_tree`` over the state's
    flax paths (kernels as ``[in, out]`` views, on the state's device),
    so the selection (regex over flax paths, element floor, axis) and the
    bytes are the JAX export's."""
    from . import quantize

    floats = {str(t.dtype).rsplit(".", 1)[-1] for t in state.values()
              if t.is_floating_point()}
    dequant = next((d for d in ("bfloat16", "float16") if d in floats),
                   "float32")
    tree, names = {}, {}
    for name, t in state.items():
        path, transposed = convert.flax_path(name, t.dim())
        parts = path.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t.t() if transposed else t
        names[path] = name
    qtree = quantize.quantize_tree(tree, **quantize_kwargs)
    out = dict(state)

    def walk(node, path):
        for key, child in node.items():
            sub = f"{path}/{key}" if path else key
            if quantize.is_int8_leaf(child):
                prefix = names[sub].rsplit(".", 1)[0]
                del out[names[sub]]
                out[prefix + ".q"] = child["q"]
                out[prefix + ".scale"] = child["scale"]
            elif isinstance(child, dict):
                walk(child, sub)

    walk(qtree, "")
    return out, dequant


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


def _read_state(export_dir, dev):
    """The stored parameters under the port's names, on ``dev``:
    ``params.pt``, else the JAX package's ``params.msgpack`` (a sole
    ``{"params": ...}`` envelope unwrapped, as the JAX loader does; the
    tree moved to ``dev`` before its kernels are transposed)."""
    import torch

    path = fsio.join(export_dir, PARAMS_FILE)
    if fsio.exists(path):
        with fsio.fopen(path, "rb") as f:
            return torch.load(f, map_location=dev, weights_only=True)
    jax_path = fsio.join(export_dir, JAX_PARAMS_FILE)
    if not fsio.exists(jax_path):
        raise FileNotFoundError(path)
    tree = serialization.load(jax_path)
    if isinstance(tree, dict) and set(tree) == {"params"}:
        tree = tree["params"]

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if not isinstance(node, torch.Tensor):
            raise ValueError(f"{jax_path}: a parameter leaf of type "
                             f"{type(node).__name__}")
        return node.to(dev)

    return convert.qparams_from_jax(move(tree))


def _builder_kwargs(builder, spec, state):
    """The spec's builder kwargs, with ``in_features`` of a ``Linear`` /
    ``MLP`` read from its first stored kernel when the spec leaves it
    out: flax infers a Dense's input width, so a JAX export never
    records it, and a PyTorch layer is built with it."""
    from .models import linear

    kwargs = dict(spec["builder_kwargs"])
    if builder in (linear.Linear, linear.MLP) and "in_features" not in kwargs:
        first = "dense" if builder is linear.Linear else "dense_0"
        if first + ".weight" in state:
            kwargs["in_features"] = int(state[first + ".weight"].shape[1])
        else:                   # a stored int8 kernel, [in, out]
            kwargs["in_features"] = int(state[first + ".q"].shape[0])
    return kwargs


def _load(export_dir, spec, dev, dequantize=True):
    import torch

    from . import quantize

    builder = _resolve_builder(spec["builder"])
    state = _read_state(export_dir, dev)
    with torch.device("meta"):
        model = builder(**_builder_kwargs(builder, spec, state))
    stored = sorted(k[:-len(".q")] for k in state if k.endswith(".q"))
    deq = getattr(torch, spec.get("dequant_dtype") or "float32")
    for prefix in stored:
        leaf = {"q": state[prefix + ".q"].contiguous(),
                "scale": state[prefix + ".scale"].contiguous()}
        # a per-output-channel int8 kernel serves as it is stored; any
        # other (dequantize=True, or a scale along another axis) is
        # rebuilt in the recorded dtype
        if dequantize or tuple(leaf["scale"].shape) != (
                1, leaf["q"].shape[1]):
            del state[prefix + ".q"], state[prefix + ".scale"]
            state[prefix + ".weight"] = quantize.dequantize_leaf(
                leaf, deq).t().contiguous()
        else:
            model.get_submodule(prefix).set_quantized(leaf)
    model.load_state_dict(state, strict=True, assign=True)
    return model


def load_model(export_dir, device=None, dequantize=True):
    """Rebuild ``(model, spec)`` from an export dir (the port's or the
    JAX package's): the builder's module with the stored parameters
    loaded onto ``device`` (``cuda`` unless the caller asks for the CPU;
    `device.resolve`), in their stored dtype.  The module is built on
    the meta device first, so no throwaway initialisation runs.

    A stored int8 export dequantises into ``dequant_dtype`` by default;
    ``dequantize=False`` keeps its quantised kernels as the quantised
    ``Dense`` (``q`` / ``scale`` buffers, served through kernel 9)."""
    from .device import resolve

    dev = resolve(device)
    spec = _read_spec(export_dir)
    return _load(export_dir, spec, dev, dequantize), spec


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
    """Load ``(predict, signature)`` from an export dir (the port's or
    the JAX package's; a stored int8 export dequantised into its
    ``dequant_dtype``, as the JAX loader does): ``predict`` is a
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
