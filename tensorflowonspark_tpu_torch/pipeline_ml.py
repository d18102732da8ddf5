"""Spark ML pipeline integration: true Spark ML Estimator/Model —
counterpart of ``tensorflowonspark_tpu/pipeline_ml.py``.

The reference's headline pipeline capability is that `TFEstimator` /
`TFModel` ARE Spark ML stages (`class TFEstimator(Estimator, TFParams...)`,
reference: pipeline.py:351,435) and therefore compose in
`Pipeline([...]).fit()` chains with param propagation.  The base
`pipeline` module keeps its no-pyspark-required API; this module is the
Spark ML face over the same logic.

Its `Estimator` / `Model` bases come from real ``pyspark.ml`` when real
pyspark is importable (`minispark.has_real_pyspark`), else from the
port's own `minispark.ml` — never from whatever sits in
``sys.modules["pyspark"]``.  `Pipeline` and `PipelineModel` are
re-exported from the same place.

    from tensorflowonspark_tpu_torch.pipeline_ml import (
        Pipeline, TFEstimator, TFModel)
    model = Pipeline(stages=[est]).fit(df).stages[0]
    preds = model.transform(df)          # DataFrame of output columns
"""
import logging

from . import minispark
from . import pipeline as base

if minispark.has_real_pyspark():
    from pyspark.ml import Estimator, Model, Pipeline, PipelineModel
else:
    from .minispark.ml import Estimator, Model, Pipeline, PipelineModel

logger = logging.getLogger(__name__)

__all__ = ["Pipeline", "PipelineModel", "TFEstimator", "TFModel"]


class TFEstimator(Estimator, base.TFParams):
    """Spark ML estimator: `fit(df)` runs a cluster over the DataFrame and
    returns a `TFModel` stage (maps reference TFEstimator,
    pipeline.py:351-432)."""

    def __init__(self, train_fn, tf_args=None, export_fn=None):
        Estimator.__init__(self)
        base.TFParams.__init__(self)
        self.train_fn = train_fn
        self.export_fn = export_fn
        self.args = base.Namespace(tf_args if tf_args is not None else {})

    def _fit(self, dataset):
        inner = base.TFEstimator(self.train_fn, self.args,
                                 export_fn=self.export_fn)
        inner._paramMap = dict(self._paramMap)
        fitted = inner._fit(dataset)
        model = TFModel(fitted.args)
        model._paramMap = dict(self._paramMap)
        return model


class _AsRow:
    """One prediction row as a tuple of Python values, one per output
    column (a module-level class, so the task ships to spawn-started
    executors)."""

    def __init__(self, columns):
        self.columns = list(columns)

    def __call__(self, r):
        import numpy as np

        # a tuple = multi-output row; anything else (scalar OR per-row
        # vector, ndarray or list) is one column's value
        row = tuple(r) if isinstance(r, tuple) else (r,)
        if len(row) != len(self.columns):
            raise ValueError(
                f"model emitted {len(row)} outputs but the schema has "
                f"{len(self.columns)} columns {self.columns}")
        # the forward emits numpy scalars/row views; real pyspark's type
        # inference needs python values — box here, at the DataFrame
        # boundary, per column
        return tuple(v.item() if isinstance(v, np.generic)
                     else v.tolist() if isinstance(v, np.ndarray)
                     else v for v in row)


class TFModel(Model, base.TFParams):
    """Spark ML model: `transform(df)` -> DataFrame of model outputs
    (maps reference TFModel, pipeline.py:435-644; the reference likewise
    returns a DataFrame of the OUTPUT columns)."""

    def __init__(self, tf_args=None):
        Model.__init__(self)
        base.TFParams.__init__(self)
        self.args = base.Namespace(tf_args if tf_args is not None else {})

    def _output_columns(self, args):
        """Output column names, in model-output order, honoring
        output_mapping (tensor name -> column name)."""
        from . import export as export_mod

        serving_dir = args.export_dir or args.model_dir
        _, signature = export_mod.read_signature(serving_dir,
                                                 args.signature_def_key)
        outs = signature.get("outputs", ["output"])
        mapping = args.output_mapping or {}
        if mapping:
            outs = [o for o in outs if o in mapping]
        return [mapping.get(o, o) for o in outs]

    def _transform(self, dataset):
        args = self.merge_args_params()
        inner = base.TFModel(self.args)
        inner._paramMap = dict(self._paramMap)
        # box=False: boxing happens below in _AsRow, AFTER the column
        # split — a single vector-valued output must stay ONE ArrayType
        # column, which a pre-boxed list row would splat into columns
        preds = inner._transform(dataset, box=False)
        columns = self._output_columns(args)
        if hasattr(preds, "mapPartitions"):     # RDD of prediction rows
            sql = minispark.sql_module(preds.context)
            spark = sql.SparkSession.builder.getOrCreate()
            return spark.createDataFrame(preds.map(_AsRow(columns)),
                                         list(columns))
        # plain-list path (no Spark context): keep rows, as base does
        return preds
