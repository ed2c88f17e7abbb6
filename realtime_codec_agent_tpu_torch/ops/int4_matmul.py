"""Affine int4 weight matmul for decode-shaped rows (kernel B5) and its plain version.

Port of realtime_codec_agent_tpu/ops/int4_matmul.py. A leaf holds

  {"q4": uint8 (K // 2, N), "d": f32 (K // G, N), "m": f32 (K // G, N)}

with ``w[k, n] = q[k, n] * d[k // G, n] - m[k // G, n]``, q in [0, 15], and
group-contiguous halves packing: byte row ``g * G/2 + j`` holds
``w[g * G + j]`` in its low nibble and ``w[g * G + G/2 + j]`` in its high
nibble (models/llama.quantize_params_int4 and the GGUF Q4_K import write it).

``x (..., K) @ dequant(q4, d, m) -> (..., N)`` f32: the activations rounded to
bf16 (the TPU kernel's ``x.astype(bfloat16)``), each weight rounded once to
bf16 after an f32 fused multiply-add ``fma(q, d, -m)`` (what ``jax.jit`` of
``dequant_int4`` computes on the CPU), f32 products and sums. ops/nn.qdot
routes calls of at most 8 rows here; wider calls take
:func:`dequant_int4_bf16` (the same bf16 weights as a (K, N) tensor) and
torch.matmul.

For CUDA tensors :func:`int4_matmul` and :func:`dequant_int4_bf16` launch
csrc/int4_matmul.cu (any N: 16-byte vectors when N % 16 == 0, single bytes
otherwise); for CPU tensors they run their plain versions.
"""
from __future__ import annotations

import torch

from . import _cuda

MAX_ROWS = 8
GROUP = 32             # the kernel's group size (Q4_K's sub-block)
_TILE_N = 512          # columns per block in csrc/int4_matmul.cu
_WARPS = 8
_TARGET_BLOCKS = 264   # 2 blocks per SM on a 132-SM H100


def unpack_int4(q4: torch.Tensor, groups: int) -> torch.Tensor:
    """Packed nibbles (K/2, N) uint8 -> q (groups, G, N) int32 in [0, 15]:
    each group's low nibbles, then its high nibbles."""
    kh, n = q4.shape
    gh = kh // groups
    qi = q4.to(torch.int32)
    return torch.cat([(qi & 15).reshape(groups, gh, n), (qi >> 4).reshape(groups, gh, n)], dim=1)


def dequant_int4(q4: torch.Tensor, d: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """An int4 leaf -> f32 (K, N). ``q * d - m`` is computed in float64 and
    rounded once to f32: exactly a fused multiply-add (q has 4 bits, d and
    m 24), the form ``jax.jit(dequant_int4)`` compiles to on the CPU and
    the kernels' ``fmaf``."""
    q = unpack_int4(q4, d.shape[0])
    w = q.to(torch.float64) * d.to(torch.float64)[:, None, :] - m.to(torch.float64)[:, None, :]
    return w.to(torch.float32).reshape(2 * q4.shape[0], q4.shape[1])


def dequant_int4_bf16_plain(q4: torch.Tensor, d: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Plain version of the dequant kernel: :func:`dequant_int4` rounded to
    bf16, the weights kernel B5 multiplies by."""
    dequant_int4_bf16_plain.calls += 1
    return dequant_int4(q4, d, m).to(torch.bfloat16)


dequant_int4_bf16_plain.calls = 0


def int4_matmul_plain(x: torch.Tensor, q4: torch.Tensor, d: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Plain version: bf16(x) @ bf16(dequant) as an f32 matmul (the products
    are exact in f32)."""
    int4_matmul_plain.calls += 1
    xb = x.to(torch.bfloat16).to(torch.float32)
    w = dequant_int4(q4, d, m).to(torch.bfloat16).to(torch.float32)
    return torch.matmul(xb, w)


int4_matmul_plain.calls = 0


def _check_leaf(what: str, q4: torch.Tensor, d: torch.Tensor, m: torch.Tensor) -> int:
    """The leaf shapes and layout the kernels take; returns K."""
    kh, n = q4.shape
    k = 2 * kh
    if q4.dtype != torch.uint8 or k % GROUP or d.shape != (k // GROUP, n) or m.shape != d.shape:
        raise ValueError(f"{what}: need uint8 q4 (K/2, N) and d, m (K/{GROUP}, N) with K % {GROUP} == 0, "
                         f"got {tuple(q4.shape)}, {tuple(d.shape)}, {tuple(m.shape)}")
    if d.dtype != torch.float32 or m.dtype != torch.float32:
        raise ValueError(f"{what}: d and m must be float32")
    if any(not a.is_contiguous() or a.data_ptr() % 16 for a in (q4, d, m)):
        raise ValueError(f"{what}: q4, d and m must be contiguous and 16-byte aligned")
    if d.device != q4.device or m.device != q4.device:
        raise ValueError(f"{what}: q4, d and m must be on the same device")
    return k


def dequant_int4_bf16(q4: torch.Tensor, d: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """An int4 leaf -> bf16 (K, N), each weight ``bf16(fma(q, d, -m))``: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if q4.device.type == "cpu":
        return dequant_int4_bf16_plain(q4, d, m)
    if q4.device.type != "cuda":
        raise ValueError(f"dequant_int4_bf16: unsupported device {q4.device}")
    k = _check_leaf("dequant_int4_bf16", q4, d, m)
    n = q4.shape[1]
    out = torch.empty((k, n), dtype=torch.bfloat16, device=q4.device)
    err = _cuda.load().rtca_int4_dequant(q4.data_ptr(), d.data_ptr(), m.data_ptr(), out.data_ptr(), k, n,
                                         _cuda.stream_handle(q4.device))
    _cuda.check(err, "dequant_int4_bf16")
    dequant_int4_bf16.launches += 1
    return out


dequant_int4_bf16.launches = 0


def k_splits(t: int, k: int, n: int) -> int:
    """Number of K splits, each a whole number of groups: enough blocks to
    fill the card when the column tiles alone cannot, at least one group per
    warp, and a split-sum workspace (2 * splits * t * n * 4 bytes of
    traffic) below a quarter of the leaf's bytes (0.75 * k * n). Every split
    is non-empty."""
    groups = k // GROUP
    col_tiles = -(-n // _TILE_N)
    want = -(-_TARGET_BLOCKS // col_tiles)
    cap_warps = max(1, groups // _WARPS)
    cap_ws = max(1, (3 * k) // (128 * t))
    splits = max(1, min(want, cap_warps, cap_ws))
    per_split = -(-groups // splits)
    return -(-groups // per_split)


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, d: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ dequant(q4, d, m) (K, N) -> (..., N) f32, for at most 8
    rows: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q4, d, m)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    k = _check_leaf("int4_matmul", q4, d, m)
    n = q4.shape[1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    t = x2.shape[0]
    if x.shape[-1] != k or not 1 <= t <= MAX_ROWS:
        raise ValueError(f"int4_matmul: need 1..{MAX_ROWS} rows of width {k}, got {tuple(x.shape)}")
    if q4.device != x.device:
        raise ValueError("int4_matmul: x, q4, d and m must be on the same device")
    xb = x2.to(torch.bfloat16).contiguous()
    out = torch.empty((t, n), dtype=torch.float32, device=x.device)
    splits = k_splits(t, k, n)
    partial = torch.empty((splits, t, n), dtype=torch.float32, device=x.device) if splits > 1 else None
    lib = _cuda.load()
    err = lib.rtca_int4_matmul(
        xb.data_ptr(), q4.data_ptr(), d.data_ptr(), m.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        t, k, n, splits, _cuda.stream_handle(x.device),
    )
    _cuda.check(err, "int4_matmul")
    int4_matmul.launches += 1
    return out.reshape(*lead, n)


int4_matmul.launches = 0
