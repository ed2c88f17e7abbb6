"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source at once (one process per ``.cu``; the
``.cuh`` headers they include count in the hash) and links
them into ONE shared library with a plain C interface -- no PyTorch headers,
so the build takes seconds -- and ``ctypes`` loads it. The library lands in ``build/torch_kernels/<hash of the sources>/``
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
import re
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers and spills of every kernel, kept beside the library (ptxas_report)
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# argtypes of every C entry point (pointers and the stream as void*, or ctypes
# would pass them as 32-bit ints and cut them)
_SIGNATURES = {
    "rtca_nearest_code": (_P, _P, _P, _I, _I, _P, _P, _P, _P),
    "rtca_nearest_code_plan": (_I, _I, ctypes.POINTER(_L)),
    "rtca_int8_matmul": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "rtca_int4_matmul": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "rtca_int4_dequant": (_P, _P, _P, _P, _I, _I, _I, _P),
    "rtca_int4_dequant_rows": (_I, _I),
    "rtca_hbm_stream_grid": (_P, _L, _I, _I, _I, _P, _P),
    "rtca_hbm_stream_manual": (_P, _L, _I, _I, _I, _I, _P, _P),
    "rtca_decode_attention": (ctypes.POINTER(_P), ctypes.POINTER(_L), ctypes.c_float, _P),
    "rtca_decode_attention_plan": (_I, _I, _I, _I, _I, ctypes.POINTER(_L)),
    "rtca_sample_token": (ctypes.POINTER(_P), ctypes.POINTER(_L), _P),
    "rtca_sample_token_rows": (ctypes.POINTER(_P), ctypes.POINTER(_L), _P),
    "rtca_threefry_gumbel": (ctypes.c_uint32, ctypes.c_uint32, _P, _I, ctypes.c_uint32, _I, _P, _P, _P),
    "rtca_flash_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P),
    "rtca_flash_attention_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P),
    "rtca_flash_attention_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P),
    "rtca_flash_attention_bwd_dkv_splits": (_I, _I, _I, _I),
    "rtca_flash_attention_bwd_dq_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P),
    "rtca_flash_attention_bwd_dkv_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I,
                                         _P),
    "rtca_flash_attention_bwd_dkv_f32_splits": (_I, _I, _I, _I),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # time the last load() spent in nvcc (0.0 = cached)


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _source_hash(flags) -> str:
    h = hashlib.sha256()
    h.update(" ".join(flags).encode())
    for path in sorted(CSRC.glob("*.cu*")):  # sources and the headers they include
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


def _finish(cmd, proc: subprocess.Popen) -> str:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")
    return err


def _build(flags) -> Path:
    """The library built from the sources with ``flags`` (built if missing):
    one nvcc per source, all at once, then one link."""
    global build_seconds
    out_dir = BUILD_ROOT / _source_hash(flags)
    lib_path = out_dir / "librtca_kernels.so"
    t0 = time.perf_counter()
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp_dir = Path(tempfile.mkdtemp(dir=out_dir))
        try:
            nvcc = _nvcc()
            objs, procs = [], []
            for src in _sources():
                obj = tmp_dir / (src.stem + ".o")
                cmd = [nvcc, *flags, "-c", "-o", str(obj), str(src)]
                objs.append(str(obj))
                procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            for src, (cmd, proc) in zip(_sources(), procs):
                (out_dir / f"{src.stem}.ptxas.txt").write_text(_finish(cmd, proc))
            tmp = tmp_dir / "librtca_kernels.so"
            cmd = [nvcc, "-shared", "-o", str(tmp), *objs]
            _finish(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
        finally:
            shutil.rmtree(tmp_dir, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return lib_path


def _open(lib_path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; idempotent."""
    global _lib
    if _lib is not None:  # the per-launch fast path
        return _lib
    with _lock:
        if _lib is None:
            _lib = _open(_build(NVCC_FLAGS))
        return _lib


def ptxas_report(source: str) -> list:
    """[(kernel, registers, spill store bytes, spill load bytes)] of every
    kernel in ``csrc/<source>.cu`` as ptxas reported them when the library
    that :func:`load` opens was built."""
    text = (BUILD_ROOT / _source_hash(NVCC_FLAGS) / f"{source}.ptxas.txt").read_text()
    rows = []
    for block in text.split("Compiling entry function '")[1:]:
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        regs = re.search(r"Used (\d+) registers", block)
        rows.append((block.split("'", 1)[0], int(regs.group(1)), int(spill.group(1)), int(spill.group(2))))
    return rows


def load_variant(defines) -> ctypes.CDLL:
    """The library built with extra ``-D`` ``defines`` (``"NAME=VALUE"``), in
    a directory of its own: a tool's variant of a kernel's compile-time
    constants. The port's wrappers always call :func:`load`."""
    with _lock:
        return _open(_build((*NVCC_FLAGS, *(f"-D{d}" for d in defines))))


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
