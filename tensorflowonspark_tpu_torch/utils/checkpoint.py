"""Checkpoint / resume for the port — counterpart of the JAX package's
``utils/checkpoint.py``, with its API: :func:`save_checkpoint`,
:func:`wait_for_saves`, :func:`restore_checkpoint`, :func:`latest_step`
and the pruning of ``keep``, :func:`install_preemption_handler`.

A ``state`` is a nested dict / list / tuple / NamedTuple of tensors, an
``nn.Module`` (its ``state_dict``) or the port's
``parallel.train.TrainState`` (the step, the parameters and the state of
any optimizer of ``optim.make_optimizer``).  Its tensors are stored with
``torch.save`` (one ``state.pt``, names are the tensors' paths in the
state) under ``ckpt_dir/step_N/``; what is not a tensor (a NamedTuple's
type, a sharding) is structure, taken from the restore target.

Writes are atomic: a step is written under a temporary name that
``step_N`` does not match, then renamed, so :func:`latest_step` never
sees a half-written step (orbax keeps the same property).  A save that
fails leaves no ``step_N`` behind.  ``asynchronous=True`` copies the
tensors to host memory before it returns and writes them on a thread.

This module does not read orbax checkpoints of the JAX package.
"""
import logging
import os
import re
import threading
import uuid

logger = logging.getLogger(__name__)

_STEP_DIR = re.compile(r"^step_(\d+)$")
STATE_FILE = "state.pt"

_pending = []               # [(thread, [exception or None])]
_pending_lock = threading.Lock()


def _items(state, path=()):
    """``(path, tensor)`` of every tensor leaf of ``state`` in a fixed
    order; a module contributes its ``state_dict`` (its parameters and
    buffers themselves).  Other leaves are structure: not stored."""
    import torch
    from torch import nn

    if isinstance(state, nn.Module):
        state = state.state_dict(keep_vars=True)
    if isinstance(state, dict):
        for key, child in state.items():
            if not isinstance(key, (str, int)) or "/" in str(key):
                raise ValueError(f"checkpoint keys must be str or int "
                                 f"without '/', got {key!r}")
            yield from _items(child, path + (str(key),))
    elif isinstance(state, tuple) and hasattr(state, "_fields"):
        for key, child in zip(state._fields, state):
            yield from _items(child, path + (key,))
    elif isinstance(state, (tuple, list)):
        for i, child in enumerate(state):
            yield from _items(child, path + (str(i),))
    elif isinstance(state, torch.Tensor):
        yield "/".join(path), state


def state_tensors(state):
    """``{path: tensor}`` of every tensor of ``state``: what a checkpoint
    of it holds, under the names it holds them by."""
    return dict(_items(state))


def _step_path(ckpt_dir, step):
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{int(step)}")


def _host_copy(tensors):
    """Detached CPU copies of ``tensors`` (a card tensor is read back
    here, before the save returns)."""
    return {name: t.detach().to("cpu", copy=True)
            for name, t in tensors.items()}


def _write(path, host, step):
    """Write ``host`` as ``path`` atomically: under a temporary name,
    then renamed (an existing ``path`` is replaced)."""
    import shutil

    import torch

    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    try:
        os.makedirs(tmp)
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save({"step": int(step), "tensors": host}, f)
            f.flush()
            os.fsync(f.fileno())
        old = None
        if os.path.exists(path):
            old = f"{tmp}.old"
            os.replace(path, old)
        os.replace(tmp, path)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save_checkpoint(ckpt_dir, state, step, is_chief=True, keep=None,
                    asynchronous=False):
    """Save ``state`` under ``ckpt_dir/step_N``; returns the path.

    Non-chief processes do nothing and return None.  ``keep`` prunes to
    the newest ``keep`` completed steps once this one commits.
    ``asynchronous=True`` returns once the tensors are copied to host
    memory; the write continues on a thread (after any earlier
    asynchronous save has committed).  Call :func:`wait_for_saves`
    before reading the checkpoint back or exiting."""
    if not is_chief:
        return None
    path = _step_path(ckpt_dir, step)
    if asynchronous:
        wait_for_saves()
        if keep:
            # prune to keep-1 BEFORE starting: once this save commits,
            # exactly `keep` checkpoints remain, as after a sync save
            _prune(ckpt_dir, keep - 1)
        host = _host_copy(state_tensors(state))
        error = [None]

        def run():
            try:
                _write(path, host, step)
                logger.info("saved checkpoint %s", path)
            except BaseException as e:  # re-raised by wait_for_saves
                error[0] = e

        thread = threading.Thread(target=run, name="checkpoint-save",
                                  daemon=True)
        with _pending_lock:
            _pending.append((thread, error))
        thread.start()
        logger.info("async checkpoint save started: %s", path)
        return path
    _write(path, _host_copy(state_tensors(state)), step)
    logger.info("saved checkpoint %s", path)
    if keep:
        _prune(ckpt_dir, keep)
    return path


def wait_for_saves():
    """Block until every asynchronous save has committed; re-raise the
    first one's error, if a save failed."""
    with _pending_lock:
        pending = list(_pending)
        _pending.clear()
    first = None
    for thread, error in pending:
        thread.join()
        if error[0] is not None and first is None:
            first = error[0]
    if first is not None:
        raise first


class PreemptionHandler:
    """Handle of an installed preemption hook: ``uninstall()`` restores
    the previous signal handlers; ``guard()`` is a context manager that
    BLOCKS the signals for its body — wrap any region where the state
    the save_fn reads is transiently invalid (a train step that updates
    the state in place).  A signal received while blocked is delivered on
    unblock."""

    def __init__(self, previous):
        self._previous = previous

    def uninstall(self):
        import signal as signal_mod
        for sig, prev in self._previous.items():
            try:
                signal_mod.signal(sig, prev)
            except (ValueError, OSError):
                pass

    # kept callable for the uninstall-style usage
    __call__ = uninstall

    def guard(self):
        import contextlib
        import signal as signal_mod

        sigs = set(self._previous)

        @contextlib.contextmanager
        def _guard():
            # restore the PREVIOUS mask, not a blanket unblock: nested
            # guards (or a caller that blocked these signals itself) stay
            # protected when an inner guard exits
            old = signal_mod.pthread_sigmask(signal_mod.SIG_BLOCK, sigs)
            try:
                yield
            finally:
                signal_mod.pthread_sigmask(signal_mod.SIG_SETMASK, old)
        return _guard()


def install_preemption_handler(save_fn, signals=None):
    """Save a final checkpoint when the process is told to die.

    Preemptions and Spark executor decommissions deliver SIGTERM with a
    grace window before the hard kill.  ``save_fn()`` runs at most once,
    from the signal handler in the main thread — keep it to a
    synchronous ``save_checkpoint`` + ``wait_for_saves``.  After it
    returns, the process exits 128+signum (the conventional
    killed-by-signal code) so the scheduler still sees a signal death.

    Returns a :class:`PreemptionHandler`; call its ``uninstall()`` after
    a clean shutdown, and wrap train steps in ``handler.guard()``.  Must
    be called from the main thread."""
    import signal as signal_mod
    import sys

    signals = signals or (signal_mod.SIGTERM,)
    fired = []
    previous = {}

    def handler(signum, frame):
        if fired:
            # a re-delivered signal while the first one is still saving:
            # returning lets the save in progress finish and exit
            return
        fired.append(signum)
        try:
            logger.warning("signal %d: saving preemption checkpoint",
                           signum)
            save_fn()
            wait_for_saves()
            logger.warning("preemption checkpoint committed")
        except Exception:
            logger.exception("preemption save failed")
        sys.exit(128 + signum)

    for sig in signals:
        previous[sig] = signal_mod.signal(sig, handler)
    return PreemptionHandler(previous)


def restore_checkpoint(ckpt_dir, target, step=None):
    """Restore the state saved at ``step`` (default: the latest) into
    ``target``, a state of the same structure and shapes; returns
    ``(restored, step)``, or ``(None, None)`` when there is no
    checkpoint.

    Each saved tensor is copied into the target's tensor of the same
    path, on that tensor's device and in its dtype, so ``restored`` is
    ``target`` holding the checkpoint's values.  A missing or an extra
    tensor, or a different shape, raises ValueError before anything is
    copied."""
    import torch

    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None, None
    path = _step_path(ckpt_dir, step)
    with open(os.path.join(path, STATE_FILE), "rb") as f:
        saved = torch.load(f, map_location="cpu", weights_only=True)
    saved = saved["tensors"]
    want = state_tensors(target)
    missing = sorted(set(want) - set(saved))
    extra = sorted(set(saved) - set(want))
    if missing or extra:
        raise ValueError(f"checkpoint {path} does not match the target: "
                         f"missing {missing[:8]}, extra {extra[:8]}")
    for name, t in want.items():
        if tuple(saved[name].shape) != tuple(t.shape):
            raise ValueError(f"checkpoint {path}: {name} has shape "
                             f"{tuple(saved[name].shape)}, the target "
                             f"{tuple(t.shape)}")
    with torch.no_grad():
        for name, t in want.items():
            t.copy_(saved[name])
    logger.info("restored checkpoint %s", path)
    return target, int(step)


def latest_step(ckpt_dir):
    """Largest step number with a checkpoint under ckpt_dir, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := _STEP_DIR.match(d))]
    return max(steps) if steps else None


def _prune(ckpt_dir, keep):
    """Remove all but the newest `keep` completed checkpoints (0 = all)."""
    import shutil

    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                   if (m := _STEP_DIR.match(d)))
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
        logger.info("pruned checkpoint step_%d", s)
