"""Accelerator discovery & per-worker GPU assignment — counterpart of
``tensorflowonspark_tpu/tpu_info.py``, under the reference's own module
name (maps reference gpu_info.py:1-98).

The reference shells out to ``nvidia-smi`` and sets
``CUDA_VISIBLE_DEVICES`` with retry/backoff; so does this module:

- counting GPUs WITHOUT initialising CUDA (an env override, the driver's
  ``/proc/driver/nvidia/gpus`` entries, then ``nvidia-smi -L``), with the
  retry × backoff discipline of the reference,
- deterministic per-worker slicing through ``CUDA_VISIBLE_DEVICES`` when
  several executor processes share one host (the reference's
  worker-index placement, gpu_info.py:60-87), where oversubscription is
  an error,
- the card's name, count and power limit for reports.

All probing goes through `_probe_devices` so tests can mock the seam
(the reference tests patch ``gpu_info.get_gpus``; SURVEY.md §4).
"""
import glob
import logging
import os
import subprocess
import time

from . import util

logger = logging.getLogger(__name__)

MAX_RETRIES = 3
RETRY_DELAY_SECS = 10

AS_LIST = "list"
AS_STRING = "string"

# overrides the probe's count (a host whose driver files are hidden)
LOCAL_GPUS_ENV = "TFOS_LOCAL_GPUS"


def _nvidia_smi(*query):
    """``nvidia-smi`` output lines; raises RuntimeError when the tool is
    missing or fails (the driver is not up, or no GPU)."""
    try:
        out = subprocess.run(["nvidia-smi", *query], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"nvidia-smi unavailable: {e}") from e
    if out.returncode:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return [line for line in out.stdout.splitlines() if line.strip()]


def _probe_devices():
    """Count the host's GPUs WITHOUT initialising CUDA — isolated seam
    for mocking.

    Order matters: a process that initialised CUDA reads
    ``CUDA_VISIBLE_DEVICES`` once, at that moment, and ignores later
    changes, so counting through ``torch.cuda`` here would make the
    assignment below a no-op for this process (and fork-started children
    could no longer use CUDA at all).  The driver's files and
    ``nvidia-smi`` run in other processes' address spaces.
    """
    env = os.environ.get(LOCAL_GPUS_ENV)
    if env:
        return int(env)
    gpus = glob.glob("/proc/driver/nvidia/gpus/*")
    if gpus:
        return len(gpus)
    return sum(1 for line in _nvidia_smi("-L") if line.startswith("GPU "))


def _visible_ids():
    """The device ids this process may hand out: the current
    ``CUDA_VISIBLE_DEVICES`` list when it is set (ids or UUIDs, kept as
    given), else ``0..n-1`` over the probed count."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [d.strip() for d in env.split(",") if d.strip()]
    return [str(i) for i in range(_probe_devices())]


def _count_local_chips():
    """Local GPUs this process can see (the name follows ``tpu_info``,
    whose callers — ``parallel_runner`` — slice by it)."""
    return len(_visible_ids())


def is_gpu_available():
    """True if any GPU is visible (reference: gpu_info.py:22-28)."""
    try:
        return _count_local_chips() > 0
    except RuntimeError:
        return False


def get_accelerator_info():
    """Summarise the visible GPUs without initialising CUDA.

    Returns dict(platform, device_kind, num_devices, power_limit), the
    kind and power limit as ``nvidia-smi --query-gpu=name,power.limit``
    gives them for the first visible GPU (``"none"`` / None when it
    cannot say).
    """
    ids = _visible_ids()
    kind, power = "none", None
    if ids:
        try:
            rows = _nvidia_smi("--query-gpu=index,uuid,name,power.limit",
                               "--format=csv,noheader")
            for row in rows:
                index, uuid, name, limit = [c.strip()
                                            for c in row.split(",", 3)]
                if ids[0] in (index, uuid):
                    kind, power = name, limit
                    break
        except RuntimeError:
            pass
    return {"platform": "gpu" if ids else "none", "device_kind": kind,
            "num_devices": len(ids), "power_limit": power}


def assign_chips(num_chips, worker_index=-1, fmt=AS_STRING):
    """Deterministically assign `num_chips` local GPUs to this worker.

    Maps reference gpu_info.get_gpus (gpu_info.py:31-98) as
    ``tpu_info.assign_chips`` does: when several worker processes land on
    one host, worker i takes GPUs [i*num_chips, (i+1)*num_chips) of the
    visible list; with worker_index < 0 assignment starts at 0.
    Oversubscription raises — silently sharing a GPU (the reference
    wrapped indices modulo the pool) puts two trainers' memory on one
    card, and NCCL refuses two ranks on one GPU.  Retries the count with
    linear backoff to ride out a driver that is still coming up.

    Sets ``CUDA_VISIBLE_DEVICES`` so a CUDA runtime started AFTER this
    call (in this process or a child) sees only the assigned GPUs, and
    returns their ids as a comma string (AS_STRING) or list (AS_LIST).
    Raises when this process already initialised CUDA: the assignment
    would not apply to it.
    """
    if util.cuda_initialized():
        raise RuntimeError(
            "assign_chips after this process initialised CUDA: the runtime "
            "has already read CUDA_VISIBLE_DEVICES")
    ids = None
    last_err = None
    for retry in range(MAX_RETRIES + 1):
        try:
            ids = _visible_ids()
            break
        except RuntimeError as e:
            last_err = e
            if retry < MAX_RETRIES:
                delay = RETRY_DELAY_SECS * (retry + 1)
                logger.warning("GPU probe failed (%s); retrying in %ds", e,
                               delay)
                time.sleep(delay)
    if ids is None:
        raise RuntimeError(f"no GPU devices available: {last_err}")

    num_local = len(ids)
    if num_chips > num_local:
        raise RuntimeError(
            f"requested {num_chips} GPUs but only {num_local} visible")

    start = 0 if worker_index < 0 else worker_index * num_chips
    if start + num_chips > num_local:
        raise RuntimeError(
            f"worker {worker_index} needs GPUs [{start}, {start + num_chips})"
            f" but only {num_local} exist on this host — oversubscription "
            f"is an error (two trainers on one GPU)")
    chip_ids = ids[start:start + num_chips]
    visible = ",".join(chip_ids)
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
    logger.info("worker %d assigned GPUs [%s] of %d local", worker_index,
                visible, num_local)
    if fmt == AS_LIST:
        return [int(c) if c.isdigit() else c for c in chip_ids]
    return visible
