"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source into ONE shared library with a plain C
interface -- no PyTorch headers, so the build takes seconds -- and ``ctypes``
loads it. The library lands in ``build/torch_kernels/<hash of the sources>/``
at the repository root: a changed source builds anew, an unchanged one loads
the library already built. Nothing is built at import time; the first kernel
launch (or an explicit :func:`load`) builds.

Every wrapper passes raw pointers (``tensor.data_ptr()``) and PyTorch's current
stream; each C entry point returns ``cudaGetLastError()`` after its launches,
and :func:`check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every C entry point (pointers and the stream as void*, or ctypes
# would pass them as 32-bit ints and cut them)
_SIGNATURES = {
    "rtca_nearest_code": (_P, _P, _P, _I, _I, _P, _P, _P),
    "rtca_int8_matmul": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "rtca_decode_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # time the last load() spent in nvcc (0.0 = cached)


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built where the CUDA toolkit is installed")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; idempotent."""
    global _lib, build_seconds
    if _lib is not None:  # the per-launch fast path
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = BUILD_ROOT / _source_hash()
        lib_path = out_dir / "librtca_kernels.so"
        t0 = time.perf_counter()
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
        build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
