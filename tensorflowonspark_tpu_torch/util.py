"""Host/environment utilities — counterpart of
``tensorflowonspark_tpu/util.py`` (maps reference util.py:1-94).

Pure-Python helpers that import no ``torch``, so the coordination layer
(and every executor bootstrap) imports and runs without paying, or
initialising, the CUDA runtime.
"""
import errno
import logging
import os
import random
import socket
import sys
import time

logger = logging.getLogger(__name__)

EXECUTOR_ID_FILE = "executor_id"


class RetryPolicy:
    """ONE retry/backoff discipline for every network loop in the package.

    Three loops grew three divergent retry shapes (reservation.Client's
    capped-exponential connect retries, the fleet gateway's hedged
    predict retry, kvtransfer.MigrationEngine's deadline-bounded attempt
    loop); this class is the shared schedule they all thread their
    existing knobs through.  ``attempts`` is the TOTAL number of tries
    (not extra retries), ``delay(i)`` the capped exponential backoff
    before try ``i+1`` — base, 2*base, 4*base, ... never exceeding
    ``cap_delay`` — plus up to ``jitter``-fraction uniform noise so a
    fleet of clients retrying the same dead endpoint doesn't
    synchronize.  ``deadline_s`` bounds the loop's total wall time
    (sleeps are clipped to it, and no try starts past it).

    ``sleeps()`` is the iteration helper::

        for attempt in policy.sleeps():
            try:
                return dial()
            except OSError as e:
                last = e
        raise ConnectionError(last)

    It yields attempt indices and sleeps the backoff BETWEEN tries
    (never after the last — the no-pointless-post-final-sleep rule every
    hand-rolled loop had to re-derive).
    """

    def __init__(self, attempts=3, base_delay=2.0, cap_delay=15.0,
                 jitter=0.0, deadline_s=None):
        if attempts < 1:
            raise ValueError(f"attempts={attempts} must be >= 1")
        if base_delay < 0 or cap_delay < 0:
            raise ValueError("delays must be >= 0")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter={jitter} must be in [0, 1]")
        self.attempts = int(attempts)
        self.base_delay = float(base_delay)
        self.cap_delay = float(cap_delay)
        self.jitter = float(jitter)
        self.deadline_s = None if deadline_s is None else float(deadline_s)

    def delay(self, attempt):
        """Backoff before retry `attempt` (0-based: the sleep after the
        first failed try is ``delay(0)``)."""
        d = min(self.cap_delay, self.base_delay * (2.0 ** attempt))
        if self.jitter:
            d += random.uniform(0.0, self.jitter * d)
        return d

    def sleeps(self, stop=None):
        """Yield attempt indices ``0..attempts-1``, sleeping the backoff
        between them and ending early at the deadline.  ``stop`` is an
        optional ``threading.Event``-like object: the inter-try sleep
        waits on it instead of ``time.sleep`` so a shutdown can end the
        loop mid-backoff."""
        start = time.monotonic()
        for attempt in range(self.attempts):
            if (attempt and self.deadline_s is not None
                    and time.monotonic() - start >= self.deadline_s):
                return
            yield attempt
            if attempt < self.attempts - 1:
                d = self.delay(attempt)
                if self.deadline_s is not None:
                    d = min(d, max(0.0, self.deadline_s
                                   - (time.monotonic() - start)))
                if stop is not None:
                    if stop.wait(d):
                        return
                elif d > 0:
                    time.sleep(d)


def get_ip_address():
    """Best-effort routable IP of this host.

    Uses the UDP-connect trick (reference: util.py:52-65): no packets are
    sent; the kernel just picks the interface that would route to the target.
    Falls back to loopback when the host is offline.
    """
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("8.8.8.8", 80))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


# ports handed out for a later bind (get_free_port): below the ephemeral
# ranges of Linux (32768-60999) and IANA (49152-65535), from which every
# outgoing connection on the host takes its local port
FREE_PORTS = (20000, 32767)


def get_free_port(host=""):
    """A TCP port free now, for a server that another process binds later
    (the ``torch.distributed`` rendezvous, a profiler): drawn at random
    from FREE_PORTS and probed with a bind.  A port of the ephemeral
    range (``bind(0)``) can be taken by any outgoing connection on the
    host between the probe and the bind (the rendezvous then fails with
    EADDRINUSE and the other ranks wait for it); one outside it only by
    another explicit bind.  Falls back to an ephemeral port when the
    draws find none free."""
    for _ in range(64):
        port = random.randint(*FREE_PORTS)
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.bind((host, port))
            return port
        except OSError:
            continue
        finally:
            s.close()
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.bind((host, 0))
        return s.getsockname()[1]
    finally:
        s.close()


def parse_port_spec(spec):
    """Parse a port env var: '8080' -> [8080]; '8000-8010' -> [8000..8010].

    Mirrors the reference's TFOS_SERVER_PORT range support
    (reference: reservation.py:190-206).
    """
    spec = str(spec).strip()
    if "-" in spec:
        lo, hi = spec.split("-", 1)
        lo, hi = int(lo), int(hi)
        if hi < lo:
            raise ValueError(f"invalid port range: {spec}")
        return list(range(lo, hi + 1))
    return [int(spec)]


def bind_socket(host, ports=None):
    """Bind a listening TCP socket on `host`.

    `ports` is None (ephemeral) or a list of candidate ports tried in order
    (reference: reservation.py:190-206).  Returns the bound, listening socket.
    """
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if not ports:
            sock.bind((host, 0))
        else:
            last_err = None
            for port in ports:
                try:
                    sock.bind((host, port))
                    last_err = None
                    break
                except OSError as e:
                    if e.errno != errno.EADDRINUSE:
                        raise
                    last_err = e
            if last_err is not None:
                raise last_err
        sock.listen(64)
    except BaseException:
        sock.close()
        raise
    return sock


def find_in_path(path, file_name):
    """Find `file_name` in a ':'-separated search path (reference: util.py:68-76)."""
    for p in path.split(os.pathsep):
        candidate = os.path.join(p, file_name)
        if os.path.exists(candidate) and os.path.isfile(candidate):
            return candidate
    return False


def write_executor_id(num, cwd=None):
    """Persist this executor's id in a CWD file.

    Later feeder tasks scheduled on the same executor read it to locate the
    node's queue manager (reference: util.py:77-82).
    """
    path = os.path.join(cwd or os.getcwd(), EXECUTOR_ID_FILE)
    with open(path, "w") as f:
        f.write(str(num))


def read_executor_id(cwd=None):
    """Read the executor id written by `write_executor_id` (reference: util.py:85-94)."""
    path = os.path.join(cwd or os.getcwd(), EXECUTOR_ID_FILE)
    with open(path) as f:
        return int(f.read())


def single_node_env():
    """Configure the environment for a single-node run (maps reference
    util.py:21-49, which expanded the Hadoop CLASSPATH and set
    CUDA_VISIBLE_DEVICES; the GPU slice is :func:`gpu_info.assign_chips`'s
    job here)."""
    # Keep TF (used only for TFRecord interop) quiet.
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")


def cuda_initialized():
    """True when this process has initialised CUDA (never imports
    ``torch`` to find out: a process that has not loaded it has not)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def pin_platform(platform):
    """Pin THIS process (and every process it starts) to a platform.

    ``"cpu"`` hides every GPU (``CUDA_VISIBLE_DEVICES=""``); ``"cuda"``
    or ``"gpu"`` leaves the visible set as it is.  The CUDA runtime reads
    ``CUDA_VISIBLE_DEVICES`` once, when it initialises, so pinning after
    this process initialised CUDA would do nothing: that raises.
    """
    if platform not in ("cpu", "cuda", "gpu"):
        raise ValueError(f"platform={platform!r} not in ('cpu', 'cuda', "
                         "'gpu')")
    if platform != "cpu":
        return
    if cuda_initialized():
        raise RuntimeError(
            "pin_platform('cpu') after this process initialised CUDA: the "
            "runtime has already read CUDA_VISIBLE_DEVICES; pin before the "
            "first CUDA call")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def absolutize_args(args, keys=("data_dir", "model_dir", "export_dir",
                                "output", "tfrecord_dir", "log_dir")):
    """Resolve path-valued args on the DRIVER: executor processes run in
    their own per-executor workdirs, so relative paths would land there
    (the reference routes paths through ctx.absolute_path/hdfs_path for the
    same reason, TFNode.py:29-64)."""
    for k in keys:
        v = getattr(args, k, None)
        if v and "://" not in v:
            setattr(args, k, os.path.abspath(v))
    return args
