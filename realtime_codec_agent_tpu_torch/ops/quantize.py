"""Nearest-codebook-entry quantization (kernel B1) and its plain version.

Port of realtime_codec_agent_tpu/ops/quantize.py. For each encoder frame the
codec quantizer picks ``argmax_j (x . c_j - |c_j|^2 / 2)`` (== the nearest
codebook entry) over 131,072 projected codes, ties going to the lowest index.

- :func:`prepare_codebook` builds what the kernel reads -- the row-major
  codebook and its half-norms -- ONCE per model (models/codec.quantizer_tables).
- :func:`nearest_code_prepared` launches the CUDA kernel (csrc/nearest_code.cu,
  one launch a call) for a CUDA tensor and runs :func:`nearest_code_plain` for
  a CPU tensor.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _cuda


def prepare_codebook(codebook: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V, D) codebook -> (contiguous f32 codebook (V, D), half-norms (V,) f32)."""
    cbf = codebook.to(torch.float32).contiguous()
    halfnorm = 0.5 * torch.sum(cbf * cbf, dim=-1)
    return cbf, halfnorm


def nearest_code_plain(x: torch.Tensor, cb: torch.Tensor, halfnorm: torch.Tensor) -> torch.Tensor:
    """Plain version: argmax of the f32 score matrix. x (N, D) -> (N,) int32."""
    nearest_code_plain.calls += 1
    scores = torch.matmul(x.to(torch.float32), cb.T) - halfnorm
    return torch.argmax(scores, dim=-1).to(torch.int32)  # first max = lowest index


nearest_code_plain.calls = 0


@functools.lru_cache(maxsize=None)
def kernel_plan(n: int, v: int) -> Tuple[int, ...]:
    """The launch csrc/nearest_code.cu picks for (N, V), as the built
    library reports it: (row tiles, rows per tile, codebook chunks per tile,
    first-level reductions per tile, threads a block, dynamic shared memory
    bytes, 64-bit keys of the workspace, ticket counters)."""
    out = (ctypes.c_longlong * 8)()
    _cuda.check(_cuda.load().rtca_nearest_code_plan(n, v, out), "nearest_code plan")
    return tuple(int(x) for x in out)


_tickets = {}  # device -> the kernel's zeroed ticket counters, the largest last


def _ticket_counters(device: torch.device, count: int) -> torch.Tensor:
    """At least ``count`` zeroed uint32 counters (stored as int32). The
    kernel leaves them zero after every call, so one array serves every call
    on the device; a larger need allocates a larger array and keeps the old
    one alive (a captured CUDA graph may still point at it)."""
    have = _tickets.setdefault(device, [])
    if not have or have[-1].numel() < count:
        have.append(torch.zeros((max(count, 64),), dtype=torch.int32, device=device))
    return have[-1]


def nearest_code_prepared(x: torch.Tensor, cb: torch.Tensor, halfnorm: torch.Tensor) -> torch.Tensor:
    """x (N, 16) -> (N,) int32 codes against a prepared codebook: the CUDA
    kernel for CUDA tensors (one launch), the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return nearest_code_plain(x, cb, halfnorm)
    if x.device.type != "cuda":
        raise ValueError(f"nearest_code: unsupported device {x.device}")
    n, d = x.shape
    v = cb.shape[0]
    if d != 16 or cb.shape != (v, 16) or halfnorm.shape != (v,):
        raise ValueError(f"nearest_code: need x (N, 16), cb (V, 16), halfnorm (V,); got {tuple(x.shape)}, {tuple(cb.shape)}, {tuple(halfnorm.shape)}")
    if cb.dtype != torch.float32 or halfnorm.dtype != torch.float32:
        raise ValueError("nearest_code: the prepared codebook must be float32")
    if cb.device != x.device or halfnorm.device != x.device:
        raise ValueError("nearest_code: x and the codebook must be on the same device")
    if not (cb.is_contiguous() and halfnorm.is_contiguous()) or cb.data_ptr() % 16 or halfnorm.data_ptr() % 16:
        raise ValueError("nearest_code: the prepared codebook and half-norms must be contiguous and 16-byte aligned")
    x = x.to(torch.float32).contiguous()
    if x.data_ptr() % 16:  # the kernel reads rows as float4
        x = x.clone()
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    keys, tickets = kernel_plan(n, v)[6:]
    part = torch.empty((keys,), dtype=torch.int64, device=x.device)
    err = _cuda.load().rtca_nearest_code(
        x.data_ptr(), cb.data_ptr(), halfnorm.data_ptr(), n, v, part.data_ptr(),
        _ticket_counters(x.device, tickets).data_ptr(), out.data_ptr(), _cuda.stream_handle(x.device),
    )
    _cuda.check(err, "nearest_code")
    nearest_code_prepared.launches += 1
    return out


nearest_code_prepared.launches = 0
