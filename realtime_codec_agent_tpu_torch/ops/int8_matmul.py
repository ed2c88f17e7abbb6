"""Weight-only int8 matmul for decode-shaped rows (kernel B2) and its plain version.

Port of realtime_codec_agent_tpu/ops/int8_matmul.py: ``x (..., K) @ wq (K, N)
int8 * scale (N,)`` -> f32, with the activations rounded to bf16 and f32
accumulation -- the TPU kernel's numerics (its ``x2.astype(bfloat16)``).
ops/nn.qdot routes calls of at most 8 rows here (the frame scan, the
lm_head, small prefill buckets); wider calls dequantize and use torch.matmul.

For a CUDA tensor :func:`int8_matmul` launches csrc/int8_matmul.cu; for a
CPU tensor it runs :func:`int8_matmul_plain`.
"""
from __future__ import annotations

import torch

from . import _cuda

MAX_ROWS = 8
_TILE_N = 512          # columns per block in csrc/int8_matmul.cu
_TARGET_BLOCKS = 264   # 2 blocks per SM on a 132-SM H100
_MIN_ROWS_PER_WARP = 8


def int8_matmul_plain(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: bf16-rounded activations, f32 matmul against the
    widened int8 weights (exact products), times the column scales."""
    int8_matmul_plain.calls += 1
    xb = x.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(xb, wq.to(torch.float32)) * scale.to(torch.float32)


int8_matmul_plain.calls = 0


def k_splits(t: int, k: int, n: int) -> int:
    """Number of K splits: enough blocks to fill the card when the column
    tiles alone cannot, at least 8 K rows per warp, and a split-sum
    workspace (2 * splits * t * n * 4 bytes of traffic) below a quarter of
    the weight bytes."""
    col_tiles = -(-n // _TILE_N)
    want = -(-_TARGET_BLOCKS // col_tiles)
    cap_rows = max(1, k // (8 * _MIN_ROWS_PER_WARP))
    cap_ws = max(1, k // (32 * t))
    return max(1, min(want, cap_rows, cap_ws))


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ wq (K, N) int8 * scale (N,) f32 -> (..., N) f32, for at
    most 8 rows: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, wq, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    k, n = wq.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    t = x2.shape[0]
    if x.shape[-1] != k or not 1 <= t <= MAX_ROWS:
        raise ValueError(f"int8_matmul: need 1..{MAX_ROWS} rows of width {k}, got {tuple(x.shape)}")
    if wq.dtype != torch.int8 or scale.shape != (n,) or scale.dtype != torch.float32:
        raise ValueError("int8_matmul: need int8 weights (K, N) and float32 scales (N,)")
    if n % 16 or not wq.is_contiguous() or wq.data_ptr() % 16 or not scale.is_contiguous():
        raise ValueError("int8_matmul: weights must be contiguous, 16-byte aligned, with N % 16 == 0")
    if wq.device != x.device or scale.device != x.device:
        raise ValueError("int8_matmul: x, weights and scales must be on the same device")
    xb = x2.to(torch.bfloat16).contiguous()
    out = torch.empty((t, n), dtype=torch.float32, device=x.device)
    splits = k_splits(t, k, n)
    partial = (
        torch.empty((splits, t, n), dtype=torch.float32, device=x.device) if splits > 1 else None
    )
    lib = _cuda.load()
    err = lib.rtca_int8_matmul(
        xb.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        t, k, n, splits, _cuda.stream_handle(x.device),
    )
    _cuda.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return out.reshape(*lead, n)


int8_matmul.launches = 0
