"""Ahead-of-time inference artifacts — counterpart of
``tensorflowonspark_tpu/aot.py``.

The JAX package serialises its jitted forward to StableHLO at fixed
serving batch sizes and runs it in-process (engine ``jax``) or through
a C++ PJRT runner that needs no model Python code (engine ``native``).
The port keeps the two engines and the layout, with PyTorch's two
artifact forms:

- ``jax``: the forward traced by ``torch.export`` at batch N, saved with
  ``torch.export.save`` and run in-process with ``torch.export.load(...)
  .module()`` — no builder needed;
- ``native``: the same program compiled by AOTInductor
  (``torch._inductor.aoti_compile_and_package``) and run with
  ``aoti_load_package`` — compiled code, no model Python code.

Shapes are static at each batch size, as JAX's are, and the weights are
inside each artifact.  The port's hand-written kernels 4 (flash
forward) and 11 (LayerNorm) are dispatcher ops (``tos::flash_fwd``,
``tos::layernorm``), so both artifact forms keep them as graph nodes and
run the CUDA kernels on the card; exporting a forward that reaches any
other kernel raises (``ops/_build.ptr``).

Artifact layout under ``<export_dir>/aot/``:
  model_b{N}.{device}.pt2        torch.export program (engine "jax")
  model_b{N}.{device}.aoti.pt2   AOTInductor package (engine "native")
  aot_spec.json                  {"format": "torch", batch_sizes, inputs,
                                  outputs, devices, seconds}

``devices`` are torch device types (``cpu``, ``cuda``): an artifact
holds code and weights for one, so each is written per device, as JAX
writes one lowering per platform.  The JAX runner's PJRT-plugin surface
(``NativeRunner``, ``default_plugin_path``, ``PLUGIN_ENV``) has no
counterpart: AOTInductor runs in the process, on the card PyTorch
drives.  A JAX-package export's ``aot/`` (StableHLO) is not read here.
"""
import json
import logging
import os
import time

logger = logging.getLogger(__name__)

AOT_DIR = "aot"
SPEC_FILE = "aot_spec.json"
FORMAT = "torch"
ENGINES = ("jax", "native")
DEVICES = ("cpu", "cuda")
# files of the JAX package's artifact (jax.export / StableHLO)
JAX_ARTIFACTS = (".jexport", ".stablehlo.mlir")


def _artifact(aot_dir, bs, device, engine):
    ext = "aoti.pt2" if engine == "native" else "pt2"
    return os.path.join(aot_dir, f"model_b{bs}.{device}.{ext}")


_OPENMP_PROBE = ("#include <omp.h>\n"
                 "int tos_probe(void) { return omp_get_max_threads(); }\n")


def aoti_cxx():
    """The C++ compiler AOTInductor builds its package with.  The
    package's wrapper always compiles with ``-fopenmp``, so the compiler
    must build and link an OpenMP shared object: inductor's own choice
    (``$CXX``, else ``g++``) when it can, else the first ``g++`` or
    ``c++`` on PATH that can (a toolchain whose compiler lacks OpenMP
    may set ``$CXX``).  Raises when none can."""
    import shutil
    import subprocess
    import tempfile

    from torch._inductor import cpp_builder, exc

    tried = []
    try:
        tried.append(cpp_builder.get_cpp_compiler())
    except exc.InvalidCxxCompiler:
        pass
    tried += [shutil.which(c) for c in ("g++", "c++")]
    errors = []
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cc")
        with open(src, "w") as f:
            f.write(_OPENMP_PROBE)
        for cxx in dict.fromkeys(c for c in tried if c):
            res = subprocess.run(
                [cxx, "-fopenmp", "-shared", "-fPIC", src, "-o",
                 os.path.join(tmp, "probe.so"), "-lgomp"],
                capture_output=True, text=True)
            if res.returncode == 0:
                return cxx
            errors.append(f"{cxx}: {res.stderr.strip()[-300:]}")
    raise RuntimeError("no C++ compiler here builds OpenMP code, which "
                       "AOTInductor's package needs: " + "; ".join(errors))


def _check_devices(platforms):
    devices = []
    for p in platforms:
        if p not in DEVICES:
            raise ValueError(
                f"aot platform {p!r} is not a torch device type of the port "
                f"({', '.join(DEVICES)}); the port writes no TPU artifact")
        if p not in devices:
            devices.append(p)
    return devices


def export_aot(export_dir, model, signature, batch_sizes=(1, 64),
               platforms=None):
    """Write ``model``'s forward at fixed batch sizes under
    ``<export_dir>/aot``.

    ``model`` is the loaded module (``export.load_model``); its
    parameters are baked into every artifact, so serving needs neither
    the builder nor ``params.pt``.  ``signature`` is the export's
    (``{"inputs": {name: {"shape", "dtype"}}, "outputs": [...]}``,
    shapes without the batch dim), and every input needs its shape.
    ``platforms`` are the devices to write for (default: the module's
    own); a module moves to each (compiling for ``cuda`` without a card
    raises before anything is written).  Each batch size and device gets
    both artifact forms: the exported program (engine ``jax``) and the
    AOTInductor package (engine ``native``, whose compile takes tens of
    seconds).
    """
    import copy

    import torch

    from .device import resolve

    home = next(model.parameters()).device
    devices = _check_devices(list(platforms) if platforms else [home.type])
    targets = [resolve(d) for d in devices]
    in_meta = list(signature["inputs"].items())
    for name, meta in in_meta:
        if meta.get("shape") is None:
            raise ValueError(
                f"aot needs each input's shape: signature input {name!r} "
                "has none")
    sizes = sorted({int(b) for b in batch_sizes})
    if not sizes or sizes[0] < 1:
        raise ValueError(f"aot batch sizes {batch_sizes!r} must be >= 1")
    aot_dir = os.path.join(export_dir, AOT_DIR)
    os.makedirs(aot_dir, exist_ok=True)
    seconds = {"export": 0.0, "compile": 0.0}
    inductor = {"cpp.cxx": (aoti_cxx(),)}
    for device, dev in zip(devices, targets):
        m = model if dev.type == home.type else copy.deepcopy(model).to(dev)
        m = m.eval().requires_grad_(False)
        for bs in sizes:
            args = tuple(
                torch.zeros((bs,) + tuple(int(d) for d in meta["shape"]),
                            dtype=getattr(torch, meta.get("dtype")
                                          or "float32"), device=dev)
                for _, meta in in_meta)
            t = time.monotonic()
            with torch.no_grad():
                program = torch.export.export(m, args)
            torch.export.save(program, _artifact(aot_dir, bs, device, "jax"))
            seconds["export"] += time.monotonic() - t
            t = time.monotonic()
            with torch.no_grad():
                torch._inductor.aoti_compile_and_package(
                    program,
                    package_path=_artifact(aot_dir, bs, device, "native"),
                    inductor_configs=inductor)
            seconds["compile"] += time.monotonic() - t
    spec = {
        "format": FORMAT,
        "batch_sizes": sizes,
        "inputs": [{"name": name, "shape": list(meta["shape"]),
                    "dtype": meta.get("dtype") or "float32"}
                   for name, meta in in_meta],
        "outputs": signature.get("outputs", ["output"]),
        "devices": devices,
        # host seconds: torch.export (+ save), the AOTInductor compile
        "seconds": seconds,
    }
    with open(os.path.join(aot_dir, SPEC_FILE), "w") as f:
        json.dump(spec, f, indent=2)
    logger.info("AOT-exported batch sizes %s for %s to %s", sizes, devices,
                aot_dir)
    return aot_dir


def has_aot(export_dir):
    """True when the export carries an ``aot/`` spec (the port's or the
    JAX package's)."""
    return os.path.exists(os.path.join(export_dir, AOT_DIR, SPEC_FILE))


def read_spec(export_dir):
    with open(os.path.join(export_dir, AOT_DIR, SPEC_FILE)) as f:
        return json.load(f)


def is_torch_artifact(export_dir):
    """True when the export's ``aot/`` holds the port's artifact; False
    for the JAX package's StableHLO one (or none)."""
    if not has_aot(export_dir):
        return False
    return read_spec(export_dir).get("format") == FORMAT


def jax_artifact_files(export_dir):
    """The JAX package's artifact files (``*.jexport``,
    ``*.stablehlo.mlir``) under the export's ``aot/``."""
    aot_dir = os.path.join(export_dir, AOT_DIR)
    if not os.path.isdir(aot_dir):
        return []
    return sorted(f for f in os.listdir(aot_dir)
                  if f.endswith(JAX_ARTIFACTS))


def _pick_batch_size(spec, requested=None):
    sizes = sorted(spec["batch_sizes"])
    if requested is None:
        return sizes[-1]
    for b in sizes:
        if b >= requested:
            return b
    return sizes[-1]


def find_artifact(export_dir, batch_size=None, engine="auto",
                  plugin_path=None, device=None):
    """Check the artifact `load_aot` would run, without loading it, and
    return ``(spec, bs, engine, path)``: the artifact spec, the batch
    size picked for ``batch_size`` (callers pad and split with
    `predict_batched`), the engine (``auto`` is ``native``: every export
    of the port writes both forms) and the file for ``device`` (``cuda``
    unless the caller asks for the CPU).

    ``engine``: ``jax`` (the ``torch.export`` program) or ``native`` (the
    AOTInductor package).  An export without the port's artifact, or
    with the JAX package's StableHLO one, raises ValueError; an artifact
    missing for the asked device raises FileNotFoundError.  Nothing falls
    back to the builder.  ``plugin_path`` (the JAX runner's PJRT plugin)
    raises NotImplementedError."""
    import torch

    if plugin_path is not None:
        raise NotImplementedError(
            "plugin_path names a PJRT plugin of the JAX runner; the port's "
            "native engine is an AOTInductor package run in this process "
            "(no plugin)")
    if engine not in ("auto",) + ENGINES:
        raise ValueError(f"engine {engine!r} not in auto, jax, native")
    if not has_aot(export_dir):
        raise ValueError(
            f"engine {engine} requires an AOT artifact ({export_dir}/"
            f"{AOT_DIR}); re-export with aot_batch_sizes")
    spec = read_spec(export_dir)
    if spec.get("format") != FORMAT:
        raise ValueError(
            f"{export_dir}/{AOT_DIR} holds the JAX package's StableHLO "
            f"(jax.export) artifact {jax_artifact_files(export_dir)}, which "
            "the port cannot run; re-export with the port's "
            "export_saved_model(aot_batch_sizes=)")
    want = torch.device("cuda" if device is None else device).type
    bs = _pick_batch_size(spec, batch_size)
    engine = "native" if engine == "auto" else engine
    path = _artifact(os.path.join(export_dir, AOT_DIR), bs, want, engine)
    if want not in spec["devices"] or not os.path.exists(path):
        raise FileNotFoundError(
            f"{export_dir}/{AOT_DIR} has no artifact for {want} at batch "
            f"{bs} ({os.path.basename(path)}; it has {spec['devices']}); "
            f"re-export with aot_platforms=[{want!r}]")
    return spec, bs, engine, path


def load_aot(export_dir, batch_size=None, engine="auto", plugin_path=None,
             device=None):
    """Return ``(predict, spec, bs)``: a fixed-batch ``predict(arrays) ->
    arrays`` over the artifact `find_artifact` checks, the artifact
    spec, and the batch size it was compiled for.  An artifact that
    fails to load raises; nothing falls back to the builder."""
    import numpy as np
    import torch

    from .device import resolve

    spec, bs, engine, path = find_artifact(export_dir, batch_size, engine,
                                           plugin_path, device)
    dev = resolve(device)
    # the kernels' dispatcher ops must exist before a graph naming them
    # loads
    from .ops import flash_attention, layernorm  # noqa: F401

    if engine == "native":
        runner = torch._inductor.aoti_load_package(path)
    else:
        runner = torch.export.load(path).module()
    logger.info("aot engine %s on %s (batch=%d): %s", engine, dev, bs, path)

    def predict(arrays):
        with torch.no_grad():
            args = [torch.as_tensor(np.ascontiguousarray(a)).to(dev)
                    for a in arrays]
            out = runner(*args)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            return [(o.float() if o.dtype == torch.bfloat16 else o)
                    .cpu().numpy() for o in outs]

    predict.engine = engine
    predict.runner = runner     # the program / package on device tensors
    return predict, spec, bs


def predict_batched(predict, arrays, compiled_bs):
    """Run a variable-size batch through a fixed-batch predict by splitting
    into compiled_bs chunks and repeat-padding the tail (trimmed after)."""
    import numpy as np

    n = int(arrays[0].shape[0])
    outs_accum = None
    for start in range(0, n, compiled_bs):
        chunk = [a[start:start + compiled_bs] for a in arrays]
        got = chunk[0].shape[0]
        if got < compiled_bs:
            pad = compiled_bs - got
            chunk = [np.concatenate([c] + [c[-1:]] * pad, axis=0)
                     for c in chunk]
        outs = predict(chunk)
        outs = [np.asarray(o)[:got] for o in outs]
        if outs_accum is None:
            outs_accum = [[o] for o in outs]
        else:
            for acc, o in zip(outs_accum, outs):
                acc.append(o)
    if outs_accum is None:
        return []
    return [np.concatenate(acc, axis=0) for acc in outs_accum]
