"""ML-pipeline Estimator/Model API — counterpart of
``tensorflowonspark_tpu/pipeline.py`` (maps reference pipeline.py:39-710).

The reference exposes Spark ML `Estimator`/`Model` wrappers so a TFoS
cluster slots into `Pipeline.fit()/transform()` chains.  This is the same
API shape — `TFEstimator.fit(dataset) -> TFModel`,
`TFModel.transform(dataset) -> predictions` — without a hard pyspark
dependency: datasets may be Spark DataFrames (real pyspark or the port's
`minispark`), (RDD-like) partitioned data, or plain lists of partitions,
routed through the `backend` substrate.

Parity inventory (reference pipeline.py):
- the `Has*` param mixins (`:49-293`) — all 19 below, same names/defaults;
- `Namespace` argv/dict adapter (`:296-336`);
- `TFParams.merge_args_params` (`:339-348`);
- `TFEstimator._fit` → cluster run/train/shutdown (`:392-432`);
- `TFModel._transform` → per-worker cached single-node inference
  (`:460-644`), here `export.load_saved_model`'s forward over the
  exported artifact with the module-global model cache (`:492-496`).

The executor tasks (`_RunSavedModel`, `_Boxed`) are module-level classes,
so they ship through the standard pickler to spawn-started executors.
This module imports no ``torch``: `export` (which does) is imported in the
transform task only, so an executor that has run no transform can still
fork a node process.  A transform loads the model where it runs — on the
card unless ``device`` (a `transform` argument or a ``device`` key of the
model's args) asks for the CPU; without CUDA it raises.  An executor
that has initialised CUDA (a transform, or a NATIVE-mode fit, which runs
its train_fn in the executor) cannot fork a SPARK-mode node process
afterwards (`backend.refuse_fork_after_cuda`): fit before transform, or
fit on a fresh context.
"""
import logging
from typing import Any

from . import backend as backend_mod
from . import cluster as cluster_mod
from . import marker as marker_mod

logger = logging.getLogger(__name__)


class Param:
    """A named, documented, type-converted parameter (the Spark ML
    `Param` shape, reference pipeline.py:49-293 uses pyspark's)."""

    def __init__(self, name, doc, converter=None, default=None):
        self.name = name
        self.doc = doc
        self.converter = converter
        self.default = default

    def convert(self, value):
        return self.converter(value) if (self.converter and value is not None) else value


def _mixin(param):
    """Build a Has<Name> mixin class exposing set<Name>/get<Name> (the
    reference generates one class per param, pipeline.py:49-293)."""
    camel = "".join(p.capitalize() for p in param.name.split("_"))

    def setter(self, value):
        self._paramMap[param.name] = param.convert(value)
        return self

    def getter(self):
        return self._paramMap.get(param.name, param.default)

    cls = type(f"Has{camel}", (), {
        f"set{camel}": setter, f"get{camel}": getter, "PARAM": param})
    return cls


_PARAMS = [
    Param("batch_size", "number of records per batch", int, 100),
    Param("cluster_size", "number of nodes in the cluster", int, 1),
    Param("epochs", "number of epochs of training data", int, 1),
    Param("grace_secs", "seconds to wait after feeding for exports", int, 30),
    Param("input_mapping", "mapping of input column to model input tensor", dict, None),
    Param("input_mode", "input data feeding mode (InputMode.SPARK|NATIVE)", int,
          cluster_mod.InputMode.SPARK),
    Param("master_node", "job name of the master/chief node", str, "chief"),
    Param("model_dir", "path to save/load model checkpoints", str, None),
    Param("num_ps", "number of parameter-server nodes (divergence: scheduled "
          "as synchronous workers)", int, 0),
    Param("driver_ps_nodes", "run parameter servers on the driver (accepted "
          "for API parity; no-op)", bool, False),
    Param("output_mapping", "mapping of model output tensor to output column", dict, None),
    Param("protocol", "network protocol: grpc|rdma in the reference; "
          "torch.distributed picks its own (accepted, ignored)", str, "grpc"),
    Param("readers", "number of reader/enqueue threads", int, 1),
    Param("steps", "maximum number of steps to train", int, 1000),
    Param("tensorboard", "launch the profiler/TensorBoard endpoint", bool, False),
    Param("tfrecord_dir", "path to export a DataFrame as TFRecords", str, None),
    Param("export_dir", "path to export the saved model", str, None),
    Param("signature_def_key", "signature to use at inference time", str, None),
    Param("tag_set", "saved-model tag set (API parity; single-tag format "
          "here)", str, "serve"),
]
_MIXINS = {cls.PARAM.name: cls for cls in (_mixin(p) for p in _PARAMS)}
globals().update({cls.__name__: cls for cls in _MIXINS.values()})


class Namespace(object):
    """Dict/argv adapter (maps reference pipeline.py:296-336): wraps a dict,
    an argparse.Namespace, another Namespace, or a raw argv list (kept in
    `.argv` for sys.argv-style user fns)."""

    argv = None

    def __init__(self, d=None):
        if d is None:
            return
        if isinstance(d, list):
            self.argv = list(d)
        elif isinstance(d, dict):
            self.__dict__.update(d)
        elif isinstance(d, Namespace):
            self.__dict__.update(vars(d))
            self.argv = list(d.argv) if d.argv else None
        elif hasattr(d, "__dict__"):  # argparse.Namespace and friends
            self.__dict__.update(vars(d))
        else:
            raise TypeError(f"unsupported Namespace source: {type(d)!r}")

    def __contains__(self, key):
        return key in self.__dict__

    def __repr__(self):
        return f"Namespace({self.__dict__!r})"


class TFParams(*(cls for cls in _MIXINS.values())):
    """Base class carrying the param map + merge logic (maps reference
    pipeline.py:339-348)."""

    def __init__(self):
        self._paramMap = {}
        self.args = None

    def merge_args_params(self):
        """Overlay explicitly-set params onto a copy of the user args; params
        win (reference pipeline.py:343-348)."""
        args = Namespace(self.args)
        for name, value in self._paramMap.items():
            setattr(args, name, value)
        for param in _PARAMS:  # defaults for params never set anywhere
            if not hasattr(args, param.name):
                setattr(args, param.name, param.default)
        return args

    def _copy_params(self, other):
        other._paramMap = dict(self._paramMap)
        return other


class TFEstimator(TFParams):
    """Trains a model on a dataset via a cluster run; `fit` returns a
    `TFModel` (maps reference TFEstimator, pipeline.py:351-432)."""

    def __init__(self, train_fn, tf_args=None, export_fn=None):
        super().__init__()
        self.train_fn = train_fn
        self.export_fn = export_fn
        self.args = Namespace(tf_args if tf_args is not None else {})

    def fit(self, dataset: Any, backend: Any = None) -> "TFModel":
        return self._fit(dataset, backend)

    def _fit(self, dataset, backend=None):
        args = self.merge_args_params()
        logger.info("fit with args: %r", args)

        local_args = self.args.argv if self.args.argv else args
        partitions, bk = _as_partitions(dataset, args, backend)
        if (args.input_mode == cluster_mod.InputMode.NATIVE
                and args.tfrecord_dir and _is_dataframe(dataset)):
            # NATIVE mode with a DataFrame source: land it as TFRecords the
            # train_fn reads directly (reference pipeline.py's tfrecord_dir
            # flow for InputMode.TENSORFLOW).  Plain partitions carry no
            # column names: the train_fn then reads what tfrecord_dir holds.
            from . import dfutil
            dfutil.saveAsTFRecords(dataset, args.tfrecord_dir)
        cluster = cluster_mod.run(
            bk, self.train_fn, tf_args=local_args,
            num_executors=args.cluster_size, num_ps=args.num_ps,
            tensorboard=args.tensorboard,
            input_mode=args.input_mode,
            master_node=args.master_node, log_dir=args.model_dir)
        try:
            if args.input_mode == cluster_mod.InputMode.SPARK:
                cluster.train(partitions, num_epochs=args.epochs)
            cluster.shutdown(grace_secs=args.grace_secs)
        except BaseException:
            cluster.abort()      # no node, manager or server left behind
            raise

        if self.export_fn:
            # Chief already exported inside the cluster in the reference
            # flow; export_fn is the TF1-style out-of-band alternative
            # (reference pipeline.py:416-429).
            assert args.export_dir, "export_fn requires export_dir"
            self.export_fn(args)
        return self._copy_params(TFModel(args))


class TFModel(TFParams):
    """Applies an exported model to a dataset, partition-parallel, with a
    per-process model cache (maps reference TFModel, pipeline.py:435-644)."""

    def __init__(self, tf_args=None):
        super().__init__()
        self.args = Namespace(tf_args if tf_args is not None else {})

    def transform(self, dataset: Any, backend: Any = None,
                  box: Any = None) -> Any:
        """Run batch inference over ``dataset``; returns rows in input order.

        ``box`` controls the row value types:

        - ``None`` (default) — auto: rows from a Spark DataFrame/RDD input
          are boxed to Python-native floats/lists ON THE EXECUTORS (real
          Spark sinks — ``createDataFrame``, JSON — choke on numpy types,
          and those rows pay Spark serialization anyway); plain local
          partitions keep numpy row views.
        - ``True`` / ``False`` — force either behavior.

        The args' ``device`` key is where each executor loads the model
        (``cuda`` when it is not set, raising without CUDA).
        """
        return self._transform(dataset, backend, box=box)

    def _transform(self, dataset, backend=None, box=None):
        from . import export as export_mod
        from . import fsio

        args = self.merge_args_params()
        serving_dir = args.export_dir or args.model_dir
        if not serving_dir:
            raise ValueError(
                "TFModel requires export_dir (or model_dir holding an export)")
        if not fsio.exists(fsio.join(serving_dir, export_mod.MODEL_SPEC)):
            raise ValueError(
                f"{serving_dir} has no {export_mod.MODEL_SPEC}; inference "
                "needs an export_saved_model artifact — a raw checkpoint dir "
                "must be exported first (the reference had the same split: "
                "checkpoint restore vs saved-model serving, "
                "pipeline.py:541-556)")
        logger.info("transform with args: %r", args)
        run_fn = _RunSavedModel(
            export_dir=serving_dir,
            signature_def_key=args.signature_def_key,
            batch_size=args.batch_size,
            input_mapping=args.input_mapping,
            output_mapping=args.output_mapping,
            device=getattr(args, "device", None))
        is_spark = hasattr(dataset, "rdd") or hasattr(dataset, "mapPartitions")
        if box is None:
            box = is_spark
        if box:
            run_fn = _Boxed(run_fn)
        partitions, bk = _as_partitions(dataset, args, backend)
        if bk is None:  # plain local data, no executor pool: run inline
            return [row for part in partitions for row in run_fn(iter(part))]
        return bk.map_partitions(partitions, run_fn)


def _box_value(v):
    if hasattr(v, "tolist"):        # ndarray or numpy scalar
        return v.tolist()
    return v


class _Boxed:
    """A partition task whose rows come back as Python-native values
    (floats/ints/lists), boxed on the executor."""

    def __init__(self, run_fn):
        self.run_fn = run_fn

    def __call__(self, it):
        for row in self.run_fn(it):
            if isinstance(row, tuple):
                yield tuple(_box_value(v) for v in row)
            else:
                yield _box_value(row)


def _is_dataframe(dataset):
    return hasattr(dataset, "select") and hasattr(dataset, "rdd")


def _as_partitions(dataset, args, backend):
    """Normalize a dataset to (partitions, backend).

    - Spark DataFrame: select sorted input columns (the reference's
      column-order convention, pipeline.py:411,:484) → its RDD + a
      SparkBackend over its context.
    - RDD: passed through with a SparkBackend.
    - list of partitions: used as-is with the given (or no) backend.
    """
    if _is_dataframe(dataset):
        if args.input_mapping:
            dataset = dataset.select(*sorted(args.input_mapping))
        rdd = dataset.rdd.map(tuple)
        sc = rdd.context
        return rdd, backend or backend_mod.SparkBackend(sc)
    if hasattr(dataset, "mapPartitions"):  # RDD
        return dataset, backend or backend_mod.SparkBackend(dataset.context)
    return dataset, backend


# Per-python-worker model cache (maps reference globals pred_fn/global_sess/
# global_args/global_model, pipeline.py:492-496): one load per process and
# device, reused across partitions.
_MODEL_CACHE = {}


def _load_cached(export_dir, signature_def_key, device):
    key = (export_dir, signature_def_key, str(device))
    if key not in _MODEL_CACHE:
        from . import export as export_mod

        _MODEL_CACHE[key] = export_mod.load_saved_model(
            export_dir, signature_def_key, device=device)
    return _MODEL_CACHE[key]


class _RunSavedModel:
    """The per-partition inference task (maps _run_model_tf2, reference
    pipeline.py:585-644): batches of `batch_size` records through the
    cached model; yields one output row per record, in order."""

    def __init__(self, export_dir, signature_def_key, batch_size,
                 input_mapping, output_mapping, device=None):
        self.export_dir = export_dir
        self.signature_def_key = signature_def_key
        self.batch_size = batch_size
        self.input_mapping = input_mapping
        self.output_mapping = output_mapping
        self.device = device

    def __call__(self, iterator):
        predict, signature = _load_cached(
            self.export_dir, self.signature_def_key, self.device)
        sig_inputs = list(signature["inputs"])
        out_names = signature.get("outputs", ["output"])
        if self.output_mapping:
            unknown = set(self.output_mapping) - set(out_names)
            if unknown:
                raise ValueError(
                    f"output_mapping keys {sorted(unknown)} not among model "
                    f"outputs {out_names}")
            out_names = [n for n in out_names if n in self.output_mapping]

        # Column routing: records are tuples in sorted(input_mapping) column
        # order; input_mapping maps column name -> tensor input name.
        if self.input_mapping:
            tensor_names = [self.input_mapping[c]
                            for c in sorted(self.input_mapping)]
        else:
            tensor_names = sig_inputs

        batch = []
        for rec in iterator:
            batch.append(rec)
            if len(batch) >= self.batch_size:
                yield from _predict(predict, signature, tensor_names,
                                    out_names, batch)
                batch = []
        if batch:
            yield from _predict(predict, signature, tensor_names, out_names,
                                batch)


def _columnarize(batch, tensor_names):
    """Rows -> {tensor_name: column}, one pass when the records pack
    (the feed plane's columnar packer instead of per-record python list
    building — the reference's JVM path was columnar end-to-end too,
    TFModel.scala:121-239)."""
    packed = marker_mod.pack_records(batch)
    if isinstance(packed, marker_mod.PackedChunk):
        if packed.matrix:           # [N, F] flat rows
            mat = packed.columns[0]
            return {name: mat[:, i] for i, name in enumerate(tensor_names)}
        if packed.row_type in (tuple, list):
            return dict(zip(tensor_names, packed.columns))
        # single-value records: every declared input sees the one column
        # (matches the row path's `rec` fallback)
        return {name: packed.columns[0] for name in tensor_names}
    # non-uniform records: the per-column comprehension
    return {name: [rec[i] if isinstance(rec, (tuple, list)) else rec
                   for rec in batch]
            for i, name in enumerate(tensor_names)}


def _predict(predict, signature, tensor_names, out_names, batch):
    from . import export as export_mod

    arrays = export_mod.coerce_inputs(signature,
                                      _columnarize(batch, tensor_names))
    outputs = predict(*arrays)
    if not isinstance(outputs, (tuple, list)):
        outputs = (outputs,)
    named = dict(zip(signature.get("outputs", ["output"]), outputs))
    picked = [named[n] for n in out_names]
    # rows come out as numpy views/scalars — no per-element python boxing
    if len(picked) == 1:
        yield from picked[0]
    else:
        yield from zip(*picked)
