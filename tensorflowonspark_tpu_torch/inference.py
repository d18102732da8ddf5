"""Batch-inference CLI over TFRecord shards and an exported model —
counterpart of ``tensorflowonspark_tpu/inference.py``.

Maps the reference's JVM inference driver
(reference: src/main/scala/com/yahoo/tensorflowonspark/Inference.scala:30-43
args, :52-79 load TFRecords -> TFModel.transform -> write JSON): reads
TFRecord files, runs the exported model — preferring the port's
ahead-of-time artifact when the export carries one (`aot`) — and
writes JSON-lines output, one file per input shard.

    python -m tensorflowonspark_tpu_torch.inference \\
        --export_dir /models/lm --input data/tfrecords \\
        --schema_hint 'struct<tokens:array<int>>' \\
        --input_mapping '{"tokens": "input"}' \\
        --output /tmp/predictions [--device cuda] \\
        [--engine auto|native|jax|builder]

The model runs on ``--device``: ``cuda`` unless ``--device cpu`` is
given, and without CUDA it raises.  ``--engine``: ``auto`` takes the
port's artifact when the export has one (its AOTInductor package:
every export of the port writes both forms), else rebuilds the model
from its builder spec; ``native`` (the AOTInductor package) and ``jax``
(the ``torch.export`` program) require the port's artifact and raise
ValueError without one; ``builder`` always rebuilds.  A JAX-package
export's StableHLO artifact is not the port's: ``auto`` serves such an
export through the builder (and says so in its description), ``native``
and ``jax`` raise.
"""
import argparse
import json
import logging
import threading

# `predict_batched` moved to `aot` (where the JAX package keeps it); the
# name stays importable from here
from .aot import predict_batched  # noqa: F401

logger = logging.getLogger(__name__)


def build_argparser():
    p = argparse.ArgumentParser(
        prog="tensorflowonspark_tpu_torch.inference",
        description="batch inference over TFRecords (Inference.scala analog)")
    p.add_argument("--export_dir", required=True,
                   help="saved-model dir (export.export_saved_model)")
    p.add_argument("--input", required=True,
                   help="TFRecord file, dir, or glob")
    p.add_argument("--output", required=True, help="output dir (JSON lines)")
    p.add_argument("--schema_hint", default=None,
                   help="struct<name:type,...> to type the decoded features")
    p.add_argument("--input_mapping", default=None,
                   help='JSON {feature_name: model_input_name}')
    p.add_argument("--output_mapping", default=None,
                   help='JSON {model_output_name: result_column}')
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--signature_def_key", default=None)
    p.add_argument("--engine", choices=["auto", "native", "jax", "builder"],
                   default="auto",
                   help="auto: the port's AOT artifact if present (its "
                        "AOTInductor package), else rebuild "
                        "from the model spec; native / jax: the "
                        "AOTInductor package / torch.export program "
                        "(required); builder: rebuild")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default cuda; cpu must be "
                        "asked for)")
    p.add_argument("--verbose", action="store_true")
    return p


def _input_files(pattern):
    from . import fsio, tfrecord
    if fsio.isdir(pattern):
        files = fsio.glob(fsio.join(pattern, "*.tfrecord")) or \
            fsio.glob(fsio.join(pattern, "part-*"))
    else:
        files = fsio.glob(pattern)
    # random-access sidecars (saveAsTFRecords(index=True)) are not shards
    files = [f for f in files if not f.endswith(tfrecord.INDEX_SUFFIX)]
    if not files:
        raise FileNotFoundError(f"no input files match {pattern!r}")
    return files


def _decode_shard(path, fields):
    """TFRecord shard -> {feature: list_of_values} honoring the schema hint
    (reference DFUtil.loadTFRecords + schemaHint, DFUtil.scala:35-110)."""
    import numpy as np

    from . import tfrecord

    columns = {}
    count = 0
    for ex in tfrecord.read_examples(path):
        missing = [n for n in columns if n not in ex]
        if missing:
            # tf.train.Example allows sparse features, but a tabular batch
            # cannot: silently skipping would misalign rows across columns
            raise ValueError(
                f"{path}: example {count} is missing feature(s) {missing}; "
                "all examples in a shard must carry the same features")
        for name, (kind, values) in ex.items():
            if count and name not in columns:
                raise ValueError(
                    f"{path}: example {count} introduces new feature "
                    f"{name!r} absent from earlier examples")
            f = fields.get(name) if fields else None
            if f is None:
                value = values if kind != "bytes" or len(values) != 1 else values[0]
            elif f.dtype == "string":
                value = (values[0].decode("utf-8", "replace")
                         if values and isinstance(values[0], bytes) else values)
            elif f.dtype == "binary":
                value = values[0] if len(values) == 1 else values
            elif f.is_array:
                value = np.asarray(values, f.dtype)
            else:
                value = np.asarray(values, f.dtype).reshape(-1)[0] if values else None
            columns.setdefault(name, []).append(value)
        count += 1
    return columns, count


class _Predictor:
    """``predict_rows(columns, n) -> {out_col: array}`` over one engine,
    the weights loaded at the first call (``lazy``) or at once.  Bare
    rows key their column by ``input_names``: the feature names as fed,
    after the ``input_mapping`` inversion."""

    def __init__(self, load, run, input_names, lazy):
        self._load, self._run = load, run
        self.input_names = input_names
        self._lock = threading.Lock()
        self._predict = None if lazy else load()

    def __call__(self, columns, n):
        if self._predict is None:
            with self._lock:
                if self._predict is None:
                    self._predict = self._load()
        return self._run(self._predict, columns, n)


def _load_predictor(args, lazy=False):
    """Return ``(predict_rows(columns, n) -> {out_col: array},
    description)`` for ``args.engine`` (the JAX CLI's choice, over the
    port's artifacts).  With ``lazy`` the signature (or the artifact's
    spec) is read and checked now and the weights load at the first
    call, as the server wants."""
    from . import aot, export
    from .device import resolve

    engine = getattr(args, "engine", None) or "auto"
    if engine not in ("auto", "native", "jax", "builder"):
        raise ValueError(f"--engine {engine!r} not in auto, native, jax, "
                         "builder")
    in_map = json.loads(args.input_mapping) if args.input_mapping else None
    out_map = json.loads(args.output_mapping) if args.output_mapping else None
    inv = {v: k for k, v in (in_map or {}).items()}
    export_dir = args.export_dir
    dev = resolve(getattr(args, "device", None))
    if engine == "builder" or (engine == "auto"
                               and not aot.is_torch_artifact(export_dir)):
        _, signature = export.read_signature(export_dir,
                                             args.signature_def_key)
        bs = max(1, int(args.batch_size or 64))
        desc = f"builder(batch={bs}, device={dev})"
        if aot.has_aot(export_dir) and engine == "auto":
            desc += (", the export's aot/ is the JAX package's StableHLO "
                     "artifact, which the port does not run")

        def load():
            predict, _ = export.load_saved_model(
                export_dir, args.signature_def_key, device=dev)

            def apply_chunk(chunk):
                outs = predict(*chunk)
                return outs if isinstance(outs, (tuple, list)) else (outs,)
            apply_chunk.runner = predict.model   # on device tensors
            return apply_chunk
    else:
        spec, bs, chosen, _ = aot.find_artifact(
            export_dir, args.batch_size, engine, device=dev)
        signature = {"inputs": {i["name"]: i for i in spec["inputs"]},
                     "outputs": spec["outputs"]}
        desc = f"aot(engine={chosen}, batch={bs}, device={dev})"

        def load():
            return aot.load_aot(export_dir, batch_size=bs, engine=chosen,
                                device=dev)[0]

    out_names = signature.get("outputs", ["output"])

    def run(predict, columns, n):
        cols = {}
        for name in signature["inputs"]:
            feat = inv.get(name, name)
            if feat not in columns:
                raise KeyError(
                    f"model input {name!r} not fed: no feature {feat!r} "
                    f"(have {sorted(columns)})")
            cols[name] = columns[feat]
        outs = aot.predict_batched(
            predict, export.coerce_inputs(signature, cols), bs)
        return _name_outputs(outs, out_names, out_map)

    names = [inv.get(n, n) for n in signature["inputs"]]
    return _Predictor(load, run, names, lazy), desc


def _name_outputs(outs, out_names, out_map):
    import numpy as np

    named = {}
    for name, arr in zip(out_names, outs):
        if out_map and name not in out_map:
            continue
        named[(out_map or {}).get(name, name)] = np.asarray(arr)
    return named


def main(argv=None):
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)

    from . import schema as schema_mod

    fields = None
    if args.schema_hint:
        fields = {f.name: f for f in schema_mod.parse_struct(args.schema_hint)}

    files = _input_files(args.input)
    predict_rows, desc = _load_predictor(args)
    logger.info("inference over %d shards with engine %s", len(files), desc)

    from . import fsio

    fsio.makedirs(args.output)
    total = 0
    for i, path in enumerate(files):
        columns, n = _decode_shard(path, fields)
        out_path = fsio.join(args.output, f"part-{i:05d}.json")
        if n == 0:
            fsio.fopen(out_path, "w").close()
            continue
        named = predict_rows(columns, n)
        with fsio.fopen(out_path, "w") as out:
            for r in range(n):
                row = {k: v[r].tolist() for k, v in named.items()}
                out.write(json.dumps(row) + "\n")
        total += n
    print(f"wrote {total} predictions to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
