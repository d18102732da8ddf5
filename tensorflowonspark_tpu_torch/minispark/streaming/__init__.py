"""minispark.streaming — queue-backed DStreams, the shape the reference's
streaming tests and examples use (queueStream + foreachRDD; reference:
examples/mnist/estimator/mnist_spark_streaming.py, TFCluster.py:83-85).
Counterpart of the JAX package's ``minispark/streaming``."""
import logging
import threading
import time

logger = logging.getLogger(__name__)


class DStream:
    def __init__(self, ssc):
        self._ssc = ssc
        self._callbacks = []

    def foreachRDD(self, func):
        """`func(time, rdd)` or `func(rdd)` per micro-batch, like pyspark
        (arity decided by signature, not by trial call — a TypeError from
        inside the callback must not trigger a second delivery)."""
        import inspect

        try:
            nargs = len(inspect.signature(func).parameters)
        except (TypeError, ValueError):
            nargs = 2
        self._callbacks.append((func, nargs))

    def _deliver(self, batch_time, rdd):
        for func, nargs in self._callbacks:
            func(batch_time, rdd) if nargs >= 2 else func(rdd)


class StreamingContext:
    def __init__(self, sparkContext, batchDuration=1.0):
        self.sparkContext = sparkContext
        self._interval = float(batchDuration)
        self._sources = []   # (dstream, queue_of_rdds, oneAtATime, default)
        self._thread = None
        self._stop_event = threading.Event()
        self._graceful_drain = threading.Event()
        self._error = None   # first callback failure; re-raised at stop()

    def queueStream(self, rdds, oneAtATime=True, default=None):
        stream = DStream(self)
        self._sources.append((stream, list(rdds), oneAtATime, default))
        return stream

    def start(self):
        assert self._thread is None, "StreamingContext already started"

        def _loop():
            try:
                while not self._stop_event.is_set():
                    t = time.time()
                    idle = True
                    for stream, pending, one_at_a_time, default in \
                            self._sources:
                        if pending:
                            idle = False
                            if one_at_a_time:
                                stream._deliver(t, pending.pop(0))
                            else:
                                for rdd in pending:
                                    stream._deliver(t, rdd)
                                pending.clear()
                        elif default is not None:
                            stream._deliver(t, default)
                    if idle and self._graceful_drain.is_set():
                        return   # graceful stop: everything delivered
                    self._stop_event.wait(self._interval)
            except BaseException as e:
                # a dead delivery thread must not look like a clean drain:
                # remember the failure so stop()/awaitTermination re-raise
                # (real pyspark fails the streaming job too)
                self._error = e
                logger.error("streaming delivery failed", exc_info=True)

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="minispark-streaming")
        self._thread.start()

    def stop(self, stopSparkContext=True, stopGraceFully=False):
        if self._thread is not None:
            if stopGraceFully:
                self._graceful_drain.set()
                self._thread.join(timeout=60)
            self._stop_event.set()
            self._thread.join(timeout=10)
            self._thread = None
        if stopSparkContext:
            self.sparkContext.stop()
        if self._error is not None:
            raise RuntimeError("streaming delivery failed") from self._error

    def awaitTermination(self, timeout=None):
        if self._thread is not None:
            self._thread.join(timeout)
        if self._error is not None:
            raise RuntimeError("streaming delivery failed") from self._error
