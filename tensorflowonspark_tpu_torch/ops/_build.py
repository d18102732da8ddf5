"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, ``build/torch_kernels/
libtos_kernels.so`` under the repository root, loaded with ``ctypes``.
Tensors cross the boundary as raw device pointers and the stream as an
opaque pointer; each C entry returns ``cudaGetLastError()`` and
:func:`check` raises when it is not 0, so a refused launch never passes
silently.  Every wrapper launches through :func:`launch`, which makes the
tensors' device the current one for the call.

The build happens at first use (or explicitly through :func:`build`),
from the sources in the checkout alone: one ``nvcc -c`` per source, all
started together, then one link.  Nothing is compiled at import time,
so the CPU test tier imports these modules without a toolkit.  Several
processes may reach the first use at once (the executors of one cluster
on a fresh checkout): :func:`lib` builds under an ``flock`` on
``BUILD_DIR/lock``, so one compiles and the others then find the library
fresh.
"""
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
SOURCES = ("paged_attention.cu", "paged_prefill.cu", "flash_attention.cu",
           "fused_optim.cu", "quant_matmul.cu", "layernorm.cu")
HEADERS = ("common.cuh", "mma.cuh")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                         "torch_kernels")
LIBRARY = os.path.join(BUILD_DIR, "libtos_kernels.so")
LOCK = os.path.join(BUILD_DIR, "lock")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

# dtype codes of the C entries (csrc/common.cuh DType); int8 is a kv
# pool storage type only
DTYPES = {"float32": 0, "bfloat16": 1, "int8": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argtypes of every C entry: pointers and the stream as c_void_p (a bare
# Python int would be passed as a 32-bit int and cut the pointer)
SIGNATURES = {
    "tos_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "tos_paged_decode_combine": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _P],
    "tos_page_write": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "tos_page_write_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _I, _I, _I, _I, _P],
    "tos_prefill_read": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "tos_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "tos_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                         _I, _I, _P],
    "tos_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _F, _I, _I, _P],
    "tos_adamw": [_P, _P, _P, _P, _P, _P, _L, _F, _F, _F, _F, _F, _F, _I, _I,
                  _I, _P],
    "tos_lion": [_P, _P, _P, _P, _P, _L, _F, _F, _F, _F, _F, _I, _I, _I, _P],
    "tos_quant_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _P],
    "tos_layernorm": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


class Launches:
    """The launch count of a kernel instantiation whose wrapper launches
    more than one (a wrapper's own count is its ``.launches``): the
    wrapper adds one right after each launch, and nowhere else."""

    __slots__ = ("launches",)

    def __init__(self):
        self.launches = 0


def nvcc_path():
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    location; raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit required)")


def _stale():
    if not os.path.exists(LIBRARY):
        return True
    built = os.path.getmtime(LIBRARY)
    return any(os.path.getmtime(os.path.join(CSRC, f)) > built
               for f in SOURCES + HEADERS)


def build(force=False):
    """Compile every source into :data:`LIBRARY`; returns a dict with
    the build seconds and each source's ``-Xptxas -v`` report (registers,
    shared memory, spills).  Skips the work when the library is newer
    than its sources, unless ``force``."""
    if not force and not _stale():
        return {"seconds": 0.0, "built": False, "ptxas": {}}
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.monotonic()
    procs = {}
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR, src.replace(".cu", ".o"))
        cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, src), "-o", obj]
        procs[src] = (obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    reports, failed = {}, []
    for src, (_, proc) in procs.items():
        out, _ = proc.communicate()
        reports[src] = out
        if proc.returncode:
            failed.append(f"{src}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = LIBRARY + ".tmp"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
         *[obj for obj, _ in procs.values()]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, LIBRARY)
    return {"seconds": time.monotonic() - t0, "built": True,
            "ptxas": reports}


def locked_build():
    """:func:`build` under an exclusive ``flock`` on :data:`LOCK`, so
    processes that build at once compile one after another (the later
    ones find the library fresh and skip the work) instead of writing the
    same objects together.  The lock is released when the holder exits,
    however it exits."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(LOCK, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            return build()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def lib():
    """The loaded kernel library, built first when missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            locked_build()
            handle = ctypes.CDLL(LIBRARY)
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(code, name):
    """Raise when a C entry reported a CUDA error."""
    if code:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_ptr(device):
    """PyTorch's current stream on `device`, as the opaque pointer the C
    entries take."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch(name, device, *args):
    """Call C entry `name` with `args` and PyTorch's current stream on
    `device`, with `device` the calling thread's current device for the
    call, and raise when the entry reports a CUDA error.  The entries'
    ``cudaFuncSetAttribute`` and the launch itself act on the current
    device, and CUDA refuses a launch into another device's stream: a
    tensor on ``cuda:1`` from a thread whose current device is 0 (a new
    thread starts on device 0) launches on its own device here.  Every
    wrapper launches through this function; where ``device`` is already
    current (an engine thread makes its model's device current) it
    switches nothing."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        code = getattr(lib(), name)(*args, stream_ptr(device))
    else:
        with torch.cuda.device(device):
            code = getattr(lib(), name)(*args, stream_ptr(device))
    check(code, name)


# the kernels a traced program (``torch.export``, AOTInductor) may hold:
# the dispatcher ops of ops/flash_attention.py and ops/layernorm.py
TRACEABLE = ("tos::flash_fwd", "tos::layernorm")


def eager(t):
    """True when a wrapper may launch on ``t`` directly, outside the
    dispatcher: a plain tensor, no ``torch.compile`` / ``torch.export``
    trace running and no dispatch mode (fake, functional or proxy
    tensors) active.  Otherwise the dispatcher op runs, so that the
    trace records it."""
    import torch

    # is_compiling first: torch.compile folds it to True and never
    # traces the rest
    return (not torch.compiler.is_compiling()
            and type(t) is torch.Tensor
            and not torch._C._len_torch_dispatch_stack())


def ptr(t):
    """A tensor's device pointer for a C entry.  A tensor under tracing
    (``torch.export``, AOTInductor) has none: the launch raises, naming
    the kernels that are dispatcher ops, instead of tracing into a
    ctypes call.  Only a tensor subclass can be one, so a plain tensor
    skips the check (a launch reads several pointers)."""
    import torch
    from torch._subclasses.fake_tensor import is_fake

    if type(t) is not torch.Tensor and is_fake(t):
        raise RuntimeError(
            "a ctypes kernel launch cannot be traced by torch.export / "
            f"AOTInductor; only {', '.join(TRACEABLE)} are dispatcher ops "
            "(the paged decode, the flash backward, the optimizers and the "
            "quantised matmuls run eagerly only)")
    return ctypes.c_void_p(t.data_ptr())


def aligned(t):
    """``t`` contiguous, with a 16-byte aligned base (the kernels' vector
    loads and ``cp.async`` copies need it): a misaligned tensor is cloned,
    so the same kernel runs on an aligned copy."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def dtype_code(t):
    """The C dtype code of a tensor; raises for a type the kernels do
    not take."""
    name = str(t.dtype).replace("torch.", "")
    if name not in DTYPES:
        raise TypeError(f"CUDA kernels take {sorted(DTYPES)}, got {name}")
    return DTYPES[name]
