"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, ``build/torch_kernels/
libtos_kernels.so`` under the repository root, loaded with ``ctypes``.
Tensors cross the boundary as raw device pointers and the stream as an
opaque pointer; each C entry returns ``cudaGetLastError()`` and
:func:`check` raises when it is not 0, so a refused launch never passes
silently.

The build happens at first use (or explicitly through :func:`build`),
from the sources in the checkout alone: one ``nvcc -c`` per source, all
started together, then one link.  Nothing is compiled at import time,
so the CPU test tier imports these modules without a toolkit.
"""
import ctypes
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


def lib():
    """The loaded kernel library, built first when missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            build()
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


def ptr(t):
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
