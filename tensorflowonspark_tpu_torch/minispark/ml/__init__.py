"""minispark.ml — the pyspark.ml Estimator/Model/Pipeline contract
(reference: pipeline.py:351,435 subclass Spark ML's versions; tests
compose them in Pipeline([...]) chains, reference: tests/test_pipeline.py).

The param system here is deliberately thin: the port's
`pipeline.TFParams` brings its own typed Param machinery (the reference
did too); these base classes provide the fit/transform/Pipeline protocol
and param-map plumbing that makes stages composable and copyable.

Counterpart of the JAX package's ``minispark/ml``."""
import copy as _copy


class Params:
    """Holds a `_paramMap`; stages copy() cleanly (pyspark's contract)."""

    def __init__(self):
        self._paramMap = {}

    def copy(self, extra=None):
        dup = _copy.copy(self)
        dup._paramMap = dict(self._paramMap)
        if extra:
            dup._paramMap.update(extra)
        return dup


class Estimator(Params):
    def fit(self, dataset, params=None):
        """fit(dataset) -> Model, via the subclass's _fit (pyspark's
        protocol; param-map overlays apply to a copy, like pyspark)."""
        if params:
            return self.copy(params)._fit(dataset)
        return self._fit(dataset)

    def _fit(self, dataset):
        raise NotImplementedError


class Transformer(Params):
    def transform(self, dataset, params=None):
        if params:
            return self.copy(params)._transform(dataset)
        return self._transform(dataset)

    def _transform(self, dataset):
        raise NotImplementedError


class Model(Transformer):
    pass


class Pipeline(Estimator):
    """Chains estimators/transformers; fit() fits each estimator stage on
    the running dataset and returns a PipelineModel of the fitted stages."""

    def __init__(self, stages=None):
        super().__init__()
        self._stages = list(stages or [])

    def getStages(self):
        return list(self._stages)

    def setStages(self, stages):
        self._stages = list(stages)
        return self

    def _fit(self, dataset):
        fitted = []
        current = dataset
        for i, stage in enumerate(self._stages):
            if isinstance(stage, Estimator):
                model = stage.fit(current)
                fitted.append(model)
                if i < len(self._stages) - 1:
                    current = model.transform(current)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                if i < len(self._stages) - 1:
                    current = stage.transform(current)
            else:
                raise TypeError(f"stage {i} is neither Estimator nor "
                                f"Transformer: {stage!r}")
        return PipelineModel(fitted)


class PipelineModel(Model):
    def __init__(self, stages):
        super().__init__()
        self._stages = list(stages)

    @property
    def stages(self):
        return list(self._stages)

    def _transform(self, dataset):
        current = dataset
        for stage in self._stages:
            current = stage.transform(current)
        return current
