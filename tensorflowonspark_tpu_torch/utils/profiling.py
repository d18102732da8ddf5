"""Profiling and observability — counterpart of
``tensorflowonspark_tpu/utils/profiling.py`` (the reference's
TensorBoard subprocess, TFSparkNode.py:282-319, plus on-device
profiling).

The JAX package captures with ``jax.profiler`` and reads its perfetto
trace; the port captures with ``torch.profiler`` (CPU activities, plus
CUDA where a card is present) and reads its Chrome trace, whose device
events are the ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` categories.
``jax.profiler.start_server`` has no torch counterpart (torch runs no
profiler gRPC server): on-demand captures of a serving replica go
through ``POST /v1/debug:profile``.  torch is imported inside the
functions, so the module imports without it.
"""
import contextlib
import logging
import os
import shutil
import subprocess

logger = logging.getLogger(__name__)

TRACE_FILE = "trace.json"
# Chrome-trace categories of work that ran on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def start_profiler_server(port=9012):
    """``jax.profiler.start_server``'s counterpart does not exist: torch
    runs no profiler server to connect to.  Raises."""
    raise NotImplementedError(
        "torch has no profiler gRPC server to start (port %d): capture on "
        "demand with POST /v1/debug:profile on a serving replica, or wrap "
        "the work in utils.profiling.trace(log_dir)" % port)


@contextlib.contextmanager
def trace(log_dir):
    """Capture a ``torch.profiler`` trace of the block (CPU activities,
    plus CUDA where a card is present) and write it as a Chrome trace to
    ``<log_dir>/trace.json`` (Perfetto and chrome://tracing read it;
    `parse_trace` sums it).  Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


def _group(name):
    """A kernel's or op's name without its signature: ``void
    tos::flash_fwd_kernel<float, 64>(Args)`` -> ``tos::flash_fwd_kernel``
    (the JAX reader's ``fusion.123`` -> ``fusion``)."""
    if name.startswith("void "):
        name = name[len("void "):]
    for stop in "<(":
        name = name.split(stop, 1)[0]
    return name.strip() or "?"


def parse_trace(path_or_events, device_only=True, group=True):
    """Sum a torch Chrome trace (`trace`, ``export_chrome_trace``) into
    time by op: ``[(name, total_dur_us, count)]``, longest first.

    ``device_only`` keeps the events that ran on the card (categories
    ``kernel``, ``gpu_memcpy``, ``gpu_memset``); False takes every
    complete event, host ops too.  ``group`` strips the signature of a
    name (template arguments, parameter list) so that instantiations of
    one kernel add up; False keeps each.  Accepts a path to a ``.json``
    or ``.json.gz`` trace, a trace dict, or a list of events."""
    import collections
    import gzip
    import json

    if isinstance(path_or_events, (str, os.PathLike)):
        path = os.fspath(path_or_events)
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            events = json.load(f).get("traceEvents", [])
    elif isinstance(path_or_events, dict):
        events = path_or_events.get("traceEvents", [])
    else:
        events = path_or_events
    dur = collections.Counter()
    cnt = collections.Counter()
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        if device_only and ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        name = ev.get("name", "?")
        if group:
            name = _group(name)
        dur[name] += ev["dur"]
        cnt[name] += 1
    return [(name, d, cnt[name]) for name, d in dur.most_common()]


def _sync(out):
    """A host readback of every tensor the call returned: a capture
    that ends before the card finishes misses its last kernels."""
    import torch
    from torch.utils._pytree import tree_leaves

    for leaf in tree_leaves(out):
        if isinstance(leaf, torch.Tensor):
            leaf.cpu()


def op_breakdown(fn, *args, steps=3, log_dir=None, top=20):
    """Run ``fn(*args)`` once to warm up, then ``steps`` times under
    `trace`, and return `parse_trace`'s rows (the scale is ``steps``
    calls; each capture ends with a host readback of the result): the
    device's time by kernel, or, when nothing ran on a device (a CPU
    function), the host ops'.  Logs the top entries."""
    import tempfile

    _sync(fn(*args))
    log_dir = log_dir or tempfile.mkdtemp(prefix="tfos_profile_")
    with trace(log_dir):
        out = None
        for _ in range(steps):
            out = fn(*args)
        _sync(out)
    path = os.path.join(log_dir, TRACE_FILE)
    rows = parse_trace(path) or parse_trace(path, device_only=False)
    for name, us, n in rows[:top]:
        logger.info("%10.3f ms/step x%-5d %s", us / 1e3 / steps, n // steps,
                    name)
    return rows


def start_tensorboard(log_dir, port=None):
    """Launch a TensorBoard subprocess if the binary is available.

    Returns (pid, port, url) or None.  Mirrors the reference's PATH search +
    TENSORBOARD_PORT/ephemeral port behavior (TFSparkNode.py:288-311).
    """
    binary = shutil.which("tensorboard")
    if binary is None:
        logger.warning("tensorboard not found on PATH; skipping")
        return None
    from .. import util
    port = port or int(os.environ.get("TENSORBOARD_PORT", 0)) or \
        util.get_free_port()
    proc = subprocess.Popen(
        [binary, "--logdir", log_dir, "--port", str(port), "--bind_all"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    url = f"http://{util.get_ip_address()}:{port}"
    logger.info("tensorboard pid=%d at %s", proc.pid, url)
    return proc.pid, port, url


def stop_tensorboard(pid):
    """Kill the TensorBoard subprocess (reference: TFSparkNode.py:599-605)."""
    import signal
    try:
        os.kill(pid, signal.SIGTERM)
    except ProcessLookupError:
        pass
