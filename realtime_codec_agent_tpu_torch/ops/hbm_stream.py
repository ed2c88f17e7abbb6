"""Device-memory streaming reductions (kernel B6) and their plain versions.

Port of the two Pallas kernels of scripts/hbm_stream_probe.py (a tool, on no
serving path): each streams the first ``n_chunks * chunk_bytes`` bytes of a
1-D int8 buffer ``passes`` times in one launch and returns an int64 sum of
what it read, so no load can be dropped.

- ``stream_sum`` (the "grid" kernel): every byte of every chunk, every pass.
- ``stream_rows_sum`` (the "manual" kernel: a ring of ``depth`` shared-memory
  stages filled by whole-chunk bulk copies): every chunk is copied, and the
  first ``REDUCE_ROWS`` rows of ``ROW_BYTES`` bytes of each are summed.

For a CUDA tensor the wrappers launch csrc/hbm_stream.cu; for a CPU tensor
they run the plain versions. tools/hbm_stream_probe.py drives them.
"""
from __future__ import annotations

import torch

from . import _cuda

ROW_BYTES = 256
REDUCE_ROWS = 32
GRID_STEP_BYTES = 16 * 1024   # the grid kernel's chunks are whole multiples of this
MAX_DEPTH = 8
MAX_RING_BYTES = 192 * 1024   # depth * chunk_bytes, inside the 227 KB a block may use


def _body(w: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    n_chunks = w.numel() // chunk_bytes
    if w.dim() != 1 or w.dtype != torch.int8 or n_chunks < 1:
        raise ValueError(f"need a 1-D int8 buffer of at least one {chunk_bytes}-byte chunk, got {w.dtype} {tuple(w.shape)}")
    return w[: n_chunks * chunk_bytes].view(n_chunks, chunk_bytes)


def stream_sum_plain(w: torch.Tensor, chunk_bytes: int, passes: int) -> torch.Tensor:
    """Plain version of ``stream_sum``: int64 sum of every byte, per pass."""
    stream_sum_plain.calls += 1
    body = _body(w, chunk_bytes)
    total = torch.zeros((), dtype=torch.int64, device=w.device)
    for _ in range(passes):
        total += body.sum(dtype=torch.int64)
    return total


stream_sum_plain.calls = 0


def stream_rows_sum_plain(w: torch.Tensor, chunk_bytes: int, passes: int) -> torch.Tensor:
    """Plain version of ``stream_rows_sum``: int64 sum of the first
    REDUCE_ROWS rows of every chunk, per pass."""
    stream_rows_sum_plain.calls += 1
    rows = _body(w, chunk_bytes)[:, : min(REDUCE_ROWS * ROW_BYTES, chunk_bytes)]
    total = torch.zeros((), dtype=torch.int64, device=w.device)
    for _ in range(passes):
        total += rows.sum(dtype=torch.int64)
    return total


stream_rows_sum_plain.calls = 0


def _check_cuda(w: torch.Tensor, what: str) -> None:
    if w.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {w.device}")
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError(f"{what}: the buffer must be contiguous and 16-byte aligned")


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_sum(w: torch.Tensor, chunk_bytes: int, passes: int) -> torch.Tensor:
    """Kernel B6, grid: 4 blocks per SM over the (pass, chunk) steps."""
    if w.device.type == "cpu":
        return stream_sum_plain(w, chunk_bytes, passes)
    _check_cuda(w, "stream_sum")
    n_chunks = _body(w, chunk_bytes).shape[0]
    if chunk_bytes % GRID_STEP_BYTES or passes < 1:
        raise ValueError(f"stream_sum: chunk_bytes must be a multiple of {GRID_STEP_BYTES}, passes >= 1")
    blocks = 4 * _sm_count(w.device)
    partial = torch.empty((blocks,), dtype=torch.int64, device=w.device)
    err = _cuda.load().rtca_hbm_stream_grid(
        w.data_ptr(), n_chunks, chunk_bytes, passes, blocks, partial.data_ptr(), _cuda.stream_handle(w.device)
    )
    _cuda.check(err, "stream_sum")
    stream_sum.launches += 1
    return partial.sum()


stream_sum.launches = 0


def stream_rows_sum(w: torch.Tensor, chunk_bytes: int, depth: int, passes: int) -> torch.Tensor:
    """Kernel B6, manual: one block per SM, a ring of ``depth`` stages."""
    if w.device.type == "cpu":
        return stream_rows_sum_plain(w, chunk_bytes, passes)
    _check_cuda(w, "stream_rows_sum")
    n_chunks = _body(w, chunk_bytes).shape[0]
    if chunk_bytes % 16 or not 1 <= depth <= MAX_DEPTH or depth * chunk_bytes > MAX_RING_BYTES or passes < 1:
        raise ValueError(f"stream_rows_sum: need chunk_bytes % 16 == 0, 1 <= depth <= {MAX_DEPTH}, "
                         f"depth * chunk_bytes <= {MAX_RING_BYTES}, passes >= 1")
    blocks = _sm_count(w.device)
    partial = torch.empty((blocks,), dtype=torch.int64, device=w.device)
    err = _cuda.load().rtca_hbm_stream_manual(
        w.data_ptr(), n_chunks, chunk_bytes, passes, depth, blocks, partial.data_ptr(),
        _cuda.stream_handle(w.device),
    )
    _cuda.check(err, "stream_rows_sum")
    stream_rows_sum.launches += 1
    return partial.sum()


stream_rows_sum.launches = 0
