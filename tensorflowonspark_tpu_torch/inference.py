"""Batch-inference CLI over TFRecord shards and an exported model —
counterpart of ``tensorflowonspark_tpu/inference.py``.

Maps the reference's JVM inference driver
(reference: src/main/scala/com/yahoo/tensorflowonspark/Inference.scala:30-43
args, :52-79 load TFRecords -> TFModel.transform -> write JSON): reads
TFRecord files, runs the exported model rebuilt from its builder spec
(`export.load_saved_model`) and writes JSON-lines output, one file per
input shard.

    python -m tensorflowonspark_tpu_torch.inference \\
        --export_dir /models/lm --input data/tfrecords \\
        --schema_hint 'struct<tokens:array<int>>' \\
        --input_mapping '{"tokens": "input"}' \\
        --output /tmp/predictions [--device cuda] [--engine auto|builder]

The model runs on ``--device``: ``cuda`` unless ``--device cpu`` is
given, and without CUDA it raises.  ``--engine native`` and ``jax`` (the
JAX package's AOT artifact and native runner) raise NotImplementedError;
``auto`` and ``builder`` both rebuild the model from its spec.
"""
import argparse
import json
import logging

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
                   help="auto / builder: rebuild the model from its spec; "
                        "native and jax are not ported")
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


def predict_batched(predict, arrays, batch_size):
    """Run a variable-size batch through `predict` in chunks of
    `batch_size` rows, repeat-padding the tail chunk (trimmed after), so
    the model sees one batch shape throughout."""
    import numpy as np

    n = int(arrays[0].shape[0])
    outs_accum = None
    for start in range(0, n, batch_size):
        chunk = [a[start:start + batch_size] for a in arrays]
        got = chunk[0].shape[0]
        if got < batch_size:
            pad = batch_size - got
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


def _load_predictor(args):
    """Return (predict_rows(columns) -> {out_col: array}, description)."""
    from . import export

    if args.engine in ("native", "jax"):
        raise NotImplementedError(
            f"--engine {args.engine} is not ported yet (ROADMAP A8: aot and "
            "the native runner); use --engine auto or builder")
    in_map = json.loads(args.input_mapping) if args.input_mapping else None
    out_map = json.loads(args.output_mapping) if args.output_mapping else None

    predict, signature = export.load_saved_model(
        args.export_dir, args.signature_def_key, device=args.device)
    out_names = signature.get("outputs", ["output"])
    bs = max(1, int(args.batch_size or 64))
    desc = f"builder(batch={bs}, device={predict.device})"

    def _apply_chunk(chunk):
        outs = predict(*chunk)
        return outs if isinstance(outs, (tuple, list)) else (outs,)

    inv = {v: k for k, v in (in_map or {}).items()}

    def predict_rows(columns):
        cols = {}
        for name in signature["inputs"]:
            feat = inv.get(name, name)
            if feat not in columns:
                raise KeyError(
                    f"model input {name!r} not fed: no feature {feat!r} "
                    f"(have {sorted(columns)})")
            cols[name] = columns[feat]
        arrays = export.coerce_inputs(signature, cols)
        outs = predict_batched(_apply_chunk, arrays, bs)
        return _name_outputs(outs, out_names, out_map)

    return predict_rows, desc


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
        named = predict_rows(columns)
        with fsio.fopen(out_path, "w") as out:
            for r in range(n):
                row = {k: v[r].tolist() for k, v in named.items()}
                out.write(json.dumps(row) + "\n")
        total += n
    print(f"wrote {total} predictions to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
