"""Filesystem seam — counterpart of ``tensorflowonspark_tpu/fsio.py``:
one open/stat/glob surface for local AND remote paths.

Local paths (no scheme, or ``file://``) use the builtins directly.  A
scheme-qualified path (``gs://``, ``s3://``, ``hdfs://``, ``memory://``,
...) goes through fsspec, imported when such a path is first used; where
fsspec is not installed that use raises (it never falls back to a local
write).  TFRecord shards, saved-model exports and dfutil save/load all
open their files here.
"""
import builtins
import glob as glob_mod
import os

_SCHEME_SEP = "://"


def is_remote(path):
    """True for scheme-qualified non-local paths (``gs://...``); false for
    plain paths and ``file://`` URLs."""
    s = str(path)
    return _SCHEME_SEP in s and not s.startswith("file://")


def local_path(path):
    """Strip a ``file://`` prefix; other paths pass through unchanged."""
    s = str(path)
    return s[len("file://"):] if s.startswith("file://") else s


def _fsspec(path):
    try:
        import fsspec
    except ImportError as e:
        raise ModuleNotFoundError(
            f"{path}: a remote path needs the fsspec package, which is not "
            "installed") from e
    return fsspec


def _fs(path):
    return _fsspec(path).core.url_to_fs(str(path))


def fopen(path, mode="rb"):
    """Open a local or remote path; returns a file object."""
    if is_remote(path):
        return _fsspec(path).open(str(path), mode).open()
    return builtins.open(local_path(path), mode)


def exists(path):
    if is_remote(path):
        fs, p = _fs(path)
        return fs.exists(p)
    return os.path.exists(local_path(path))


def isdir(path):
    if is_remote(path):
        fs, p = _fs(path)
        return fs.isdir(p)
    return os.path.isdir(local_path(path))


def getsize(path):
    if is_remote(path):
        fs, p = _fs(path)
        return fs.size(p)
    return os.path.getsize(local_path(path))


def makedirs(path):
    if is_remote(path):
        fs, p = _fs(path)
        fs.makedirs(p, exist_ok=True)
        return
    os.makedirs(local_path(path), exist_ok=True)


def join(path, *parts):
    """Path join that preserves the scheme (os.path.join would mangle
    ``gs://bucket`` + ``part`` on some inputs)."""
    s = str(path)
    if is_remote(s):
        return "/".join([s.rstrip("/")] + [p.strip("/") for p in parts])
    return os.path.join(local_path(s), *parts)


def glob(pattern):
    """Sorted glob across local and remote filesystems.

    Remote results come back scheme-qualified so they stay openable by
    `fopen` (fsspec's fs.glob strips the scheme).
    """
    if is_remote(pattern):
        fs, p = _fs(pattern)
        # unstrip_protocol restores scheme AND authority (hdfs://nn:8020/...)
        # — fs.glob strips both, and the netloc lives in the fs object
        return sorted(fs.unstrip_protocol(m) for m in fs.glob(p))
    return sorted(glob_mod.glob(local_path(pattern)))


def isfile(path):
    if is_remote(path):
        fs, p = _fs(path)
        return fs.isfile(p)
    return os.path.isfile(local_path(path))
