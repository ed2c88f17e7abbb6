"""Weight-only int8 matmul for decode-shaped rows (kernel B2) and its plain version.

Port of realtime_codec_agent_tpu/ops/int8_matmul.py: ``x (..., K) @ wq (K, N)
int8 * scale (N,)`` -> f32, with the activations rounded to bf16 and f32
accumulation -- the TPU kernel's numerics (its ``x2.astype(bfloat16)``).
ops/nn.qdot routes calls of at most 8 rows here (the frame scan, the
lm_head, small prefill buckets); wider calls dequantize and use torch.matmul.

For a CUDA tensor :func:`int8_matmul` launches csrc/int8_matmul.cu once
(tensor-core products from weights converted in registers, K splits summed
in a thread-block cluster; :func:`plan` picks the grid; any N: word and
vector loads when N % 16 == 0, single bytes otherwise; any K); for a CPU
tensor it runs :func:`int8_matmul_plain`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _cuda

MAX_ROWS = 8
STEP = 16              # K rows per tensor-core step of the kernel
MAX_CLUSTER = 8        # the portable thread-block cluster size: K splits per column tile
MAX_KWARPS = 8         # warps per block, sharing its steps
MAX_RUN = 128          # steps (2,048 K rows) a warp sums in its one tensor-core accumulator
_WAVE_WARPS = 2048     # one wave: 16 warps an SM at the kernel's <= 128 registers a thread
_TAIL_KWARPS = 4       # k-warps a tile where the tiles alone are more than a wave


def int8_matmul_plain(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: bf16-rounded activations, f32 matmul against the
    widened int8 weights (exact products), times the column scales."""
    int8_matmul_plain.calls += 1
    xb = x.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(xb, wq.to(torch.float32)) * scale.to(torch.float32)


int8_matmul_plain.calls = 0


class Plan(NamedTuple):
    """B2's launch: ``tile`` columns per block, ``splits`` K splits of
    ``steps_per_split`` whole 16-row steps each (the last may hold fewer,
    none is empty), one cluster of ``splits`` blocks per column tile,
    ``kwarps`` warps sharing a block's steps. :func:`make_plan` is the one
    place that splits K; the kernel takes ``steps_per_split`` as given and
    refuses a plan whose ``splits`` is not ceil(steps / steps_per_split)."""

    tile: int
    splits: int
    steps_per_split: int
    kwarps: int
    blocks: int


def make_plan(k: int, n: int, tile: int, splits: int, kwarps: int) -> Plan:
    """The Plan of (tile, splits, kwarps) at (k, n), splits cut to the
    number that leaves none empty."""
    steps = -(-k // STEP)
    per = -(-steps // splits)
    splits = -(-steps // per)
    return Plan(tile, splits, per, kwarps, -(-n // tile) * splits)


@functools.lru_cache(maxsize=None)
def plan(t: int, k: int, n: int) -> Plan:
    """B2's grid for x (t, k) @ (k, n), the rule the sweep of every plan at
    the decode shapes of Llama-3.2-1B and Qwen2.5-1.5B found fastest
    (tools/int8_plan_sweep.py, PERF.md): about one wave of
    :data:`_WAVE_WARPS` warps. 128-column tiles (16-byte loads) where their
    tiles can give every warp of the wave a share (8 k-warps x 8 splits
    each), else 64 (8-byte loads); 32 where N % 16 != 0 (the byte path: 4
    bytes a lane keep its registers low). Then k-warps, then K splits (one
    cluster, at most :data:`MAX_CLUSTER`), each doubled while the grid stays
    within the wave; where the tiles alone are more than a wave (a large
    vocab's lm_head), :data:`_TAIL_KWARPS` k-warps a tile, so the warps past
    the first wave are short. Then more, if a warp would sum more than
    :data:`MAX_RUN` steps in one accumulator. The splits' partials are
    summed inside the cluster, so no shape needs a workspace. ``t`` does not
    change the plan (every T <= 8 fills the same mma fragment); it is taken
    so that both decode matmuls' plans are called alike (int4_matmul.plan)."""
    steps = -(-k // STEP)
    full_tile = MAX_CLUSTER * MAX_KWARPS  # the warps one column tile can take
    tile = 32 if n % 16 else 128 if -(-n // 128) * full_tile >= _WAVE_WARPS else 64
    tiles = -(-n // tile)
    kwarps = splits = 1
    while kwarps < MAX_KWARPS and 2 * tiles * kwarps <= _WAVE_WARPS:
        kwarps *= 2
    while splits < MAX_CLUSTER and 2 * tiles * kwarps * splits <= _WAVE_WARPS:
        splits *= 2
    if tiles > _WAVE_WARPS:
        kwarps = _TAIL_KWARPS
    while -(-steps // (splits * kwarps)) > MAX_RUN and splits * kwarps < full_tile:
        if kwarps < MAX_KWARPS:
            kwarps *= 2
        else:
            splits *= 2
    p = make_plan(k, n, tile, min(splits, steps), 1)
    return p._replace(kwarps=min(kwarps, p.steps_per_split))


def _launch(xb: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, out: torch.Tensor, p: Plan) -> None:
    """One launch of the kernel under plan ``p``: xb (t, ldx) bf16, ldx a
    multiple of 16 with zeros past K, 16-byte aligned."""
    t, ldx = xb.shape
    k, n = wq.shape
    err = _cuda.load().rtca_int8_matmul(
        xb.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
        t, k, n, ldx, p.tile, p.splits, p.steps_per_split, p.kwarps, _cuda.stream_handle(xb.device),
    )
    _cuda.check(err, "int8_matmul")


def padded_rows(x2: torch.Tensor) -> torch.Tensor:
    """x2 (t, K) as the kernel reads it: bf16, rows padded with zeros to a
    multiple of 16, 16-byte aligned."""
    t, k = x2.shape
    ldx = -(-k // STEP) * STEP
    xb = x2.to(torch.bfloat16)
    if ldx != k:
        xb = torch.nn.functional.pad(xb, (0, ldx - k))
    xb = xb.contiguous()
    if xb.data_ptr() % 16:  # the kernel reads x in 8-byte pieces from a 16-byte aligned base
        xb = xb.clone()
    return xb


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ wq (K, N) int8 * scale (N,) f32 -> (..., N) f32, for at
    most 8 rows: the CUDA kernel for CUDA tensors (one launch, :func:`plan`'s
    grid), the plain version for CPU tensors."""
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
    if not wq.is_contiguous() or wq.data_ptr() % 16 or not scale.is_contiguous():
        raise ValueError("int8_matmul: weights must be contiguous and 16-byte aligned")
    if wq.device != x.device or scale.device != x.device:
        raise ValueError("int8_matmul: x, weights and scales must be on the same device")
    out = torch.empty((t, n), dtype=torch.float32, device=x.device)
    _launch(padded_rows(x2), wq, scale, out, plan(t, k, n))
    int8_matmul.launches += 1
    return out.reshape(*lead, n)


int8_matmul.launches = 0
