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
csrc/int4_matmul.cu (any N: word and vector loads when N % 16 == 0,
single bytes otherwise; the dequant kernel's threads each own 1-16 byte
rows of a group's 8-column strip, :func:`dequant_rows`, on its vector path
at N % 8 == 0); for CPU tensors they run their plain versions.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _cuda

MAX_ROWS = 8
GROUP = 32             # the kernel's group size (Q4_K's sub-block)
MAX_CLUSTER = 8        # the portable thread-block cluster size: K splits per column tile
_TILES = (32, 64, 128)  # columns per block in csrc/int4_matmul.cu: 1, 2 or 4 warps across
_MAX_TILES = 256
_MIN_BLOCKS = 96       # ~3/4 of an H100's 132 SMs
_WAVE_WARPS = 2048     # ~16 warps an SM at the kernel's ~100 registers a thread


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


def dequant_int4_bf16(q4: torch.Tensor, d: torch.Tensor, m: torch.Tensor, rows: int = 0) -> torch.Tensor:
    """An int4 leaf -> bf16 (K, N), each weight ``bf16(fma(q, d, -m))``: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    ``rows`` (1, 2, 4, 8 or 16): the byte rows of a group strip a thread of
    the kernel takes; 0 leaves it to the kernel's plan (:func:`dequant_rows`)."""
    if q4.device.type == "cpu":
        return dequant_int4_bf16_plain(q4, d, m)
    if q4.device.type != "cuda":
        raise ValueError(f"dequant_int4_bf16: unsupported device {q4.device}")
    k = _check_leaf("dequant_int4_bf16", q4, d, m)
    n = q4.shape[1]
    out = torch.empty((k, n), dtype=torch.bfloat16, device=q4.device)
    err = _cuda.load().rtca_int4_dequant(q4.data_ptr(), d.data_ptr(), m.data_ptr(), out.data_ptr(), k, n, int(rows),
                                         _cuda.stream_handle(q4.device))
    _cuda.check(err, "dequant_int4_bf16")
    dequant_int4_bf16.launches += 1
    return out


dequant_int4_bf16.launches = 0


def dequant_rows(k: int, n: int) -> int:
    """The byte rows of a group strip (16 byte rows x 8 columns) one thread
    of the dequant kernel takes at (K, N), as the built library's plan picks
    them (csrc/int4_matmul.cu dequant_rows): 16, 8, 4, 2 or 1, or 0 where
    N % 8 sends the leaf to the scalar kernel."""
    return int(_cuda.load().rtca_int4_dequant_rows(k, n))


class Plan(NamedTuple):
    """B5's launch: ``tile`` columns per block, ``splits`` K splits of
    ``groups_per_split`` whole groups each (the last may hold fewer, none is
    empty), one cluster of ``splits`` blocks per column tile, ``kwarps``
    warps per 32 columns sharing a block's groups."""

    tile: int
    splits: int
    groups_per_split: int
    kwarps: int
    blocks: int


@functools.lru_cache(maxsize=None)
def plan(t: int, k: int, n: int) -> Plan:
    """B5's grid for x (t, k) @ (k, n), the rule the sweep of every plan at
    the layer shapes found fastest (tools/int4_plan_sweep.py, PERF.md): the
    narrowest column tile that needs at most 256 tiles; K splits (one
    cluster, at most :data:`MAX_CLUSTER`) only until :data:`_MIN_BLOCKS`
    blocks run, since the cluster's reduction costs more than idle SMs;
    then as many k-warps as give each at least 4 groups, within 16 warps a
    block and one wave of :data:`_WAVE_WARPS` warps. The splits' partials
    are summed inside the cluster, so no shape needs a workspace. ``t``
    does not change the plan: every T <= 8 fills the same mma fragment."""
    groups = k // GROUP
    tile = next((c for c in _TILES if -(-n // c) <= _MAX_TILES), _TILES[-1])
    tiles = -(-n // tile)
    splits = max(1, min(MAX_CLUSTER, groups, -(-_MIN_BLOCKS // tiles)))
    per = -(-groups // splits)
    splits = -(-groups // per)  # every split non-empty
    cwarps = tile // 32
    kwarps = max(1, min(16 // cwarps, per // 4, _WAVE_WARPS // (tiles * splits * cwarps)))
    return Plan(tile, splits, per, kwarps, tiles * splits)


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, d: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ dequant(q4, d, m) (K, N) -> (..., N) f32, for at most 8
    rows: the CUDA kernel for CUDA tensors (one launch, :func:`plan`'s
    grid), the plain version for CPU tensors."""
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
    if xb.data_ptr() % 16:  # the kernel reads x in 8-byte pieces from a 16-byte aligned base
        xb = xb.clone()
    out = torch.empty((t, n), dtype=torch.float32, device=x.device)
    p = plan(t, k, n)
    err = _cuda.load().rtca_int4_matmul(
        xb.data_ptr(), q4.data_ptr(), d.data_ptr(), m.data_ptr(), out.data_ptr(),
        t, k, n, p.tile, p.splits, p.kwarps, _cuda.stream_handle(x.device),
    )
    _cuda.check(err, "int4_matmul")
    int4_matmul.launches += 1
    return out.reshape(*lead, n)


int4_matmul.launches = 0
