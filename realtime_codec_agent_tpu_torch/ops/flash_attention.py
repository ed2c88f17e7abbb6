"""Causal flash attention (kernel B4), forward and backward, and its plain
versions.

Port of realtime_codec_agent_tpu/ops/nn.py's long-block attention: the
Pallas TPU kernel ``flash_attention_pallas`` (JAX's stock TPU flash kernel,
forward and dq/dkv backward) and, as the plain versions,
``flash_causal_attention`` with its forward ``_flash_fwd_impl`` (online
softmax over 1024-key blocks, f32 statistics, probabilities rounded to the
value dtype before P.V) and its backward ``_flash_bwd`` (a key-block scan,
f32 throughout). All functions take the JAX layout ``q (B, T, H, Dh)`` and
``k, v (B, T, KH, Dh)`` with ``H % KH == 0`` -- the JAX callers'
``repeat_kv`` happens inside: the plain versions repeat the heads (and sum
the repeated heads' dK/dV back), the kernels read KV head ``h // (H // KH)``
-- and an optional key validity ``valid (B, T)``: key j counts for query i
iff ``j <= i`` and ``valid[b, j] > 0``, multiplicatively, so a row with no
live key gives out = 0 and lse = 0.

:func:`flash_attention` is differentiable (:class:`FlashAttentionFn`): for
CUDA tensors its forward launches csrc/flash_attention.cu (head_dim 64 or
128: wgmma and TMA for bf16; for f32 csrc/flash_attention_f32.cu, a
register-tiled SIMT kernel on the f32 units) and its backward the dq and
dk/dv kernels of csrc/flash_attention_bwd.cu for bf16 (wgmma and TMA) or
of csrc/flash_attention_bwd_f32.cu for f32 (register-tiled SIMT, dk/dv
split over a cluster where the grid is small), head_dim 64 or 128; for CPU
tensors both run the plain versions. Counters:
``flash_attention.launches``, ``flash_attention_bwd_dq.launches``,
``flash_attention_bwd_dkv.launches``, ``flash_attention_bwd_dq_f32.launches``,
``flash_attention_bwd_dkv_f32.launches`` (kernels),
``flash_causal_attention.calls``, ``flash_causal_attention_bwd.calls``
(plain versions).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda

HEAD_DIMS = (64, 128)  # head dims of the kernels, forward and backward
NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KH, Dh) -> (B, S, KH*n_rep, Dh) for grouped-query attention:
    head h reads KV head h // n_rep."""
    if n_rep == 1:
        return x
    b, s, kh, dh = x.shape
    return x[:, :, :, None, :].expand(b, s, kh, n_rep, dh).reshape(b, s, kh * n_rep, dh)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 statistics and sums, f64 for f64 inputs (gradcheck)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _live(t: int, k0: int, width: int, valid: Optional[torch.Tensor], dev) -> torch.Tensor:
    """(1 or B, 1, T, width) mask of the keys k0 .. k0 + width - 1."""
    q_pos = torch.arange(t, device=dev)
    key_pos = k0 + torch.arange(width, device=dev)
    live = (key_pos[None, :] <= q_pos[:, None])[None, None]
    if valid is not None:
        live = live & (valid[:, k0 : k0 + width] > 0)[:, None, None, :]
    return live


def flash_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,  # (B, T) key validity (padding mask)
    block: int = 1024,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: the JAX package's key-block online softmax. Keys
    outside the causal window or marked invalid enter the sums with
    probability exactly 0 (multiplicative mask, as the JAX code)."""
    flash_causal_attention.calls += 1
    b, t, h, dh = q.shape
    n_rep = h // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    if scale is None:
        scale = float(dh ** -0.5)
    dev = q.device
    ct = _acc_dtype(q)
    qf = q.to(ct)
    m = torch.full((b, h, t, 1), NEG_INF, dtype=ct, device=dev)
    l = torch.zeros((b, h, t, 1), dtype=ct, device=dev)
    acc = torch.zeros((b, h, t, dh), dtype=ct, device=dev)
    for k0 in range(0, t, block):
        k_blk = k[:, k0 : k0 + block]
        v_blk = v[:, k0 : k0 + block]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.to(ct)) * scale
        live = _live(t, k0, k_blk.shape[1], valid, dev)
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(live, torch.exp(s - m_new), torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).to(ct), v_blk.to(ct))
        acc = acc * corr + pv
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe).permute(0, 2, 1, 3).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(l_safe), torch.zeros_like(l))
    return out, lse


flash_causal_attention.calls = 0


def flash_causal_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,  # (B, H, T, 1)
    dout: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    block: int = 1024,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward, a port of the JAX package's ``_flash_bwd``: per key
    block, recompute the normalized probabilities from (q, k, lse) under the
    forward's multiplicative mask (P exactly 0 where a key is dead, also on
    rows with lse = 0), then dV = P^T.dO, dS = P * (dO.V^T - delta) * scale
    with delta = rowsum(dO * O), dQ += dS.K, dK = dS^T.Q, f32 throughout.
    dK/dV of the H // KH heads that share a KV head are summed back to it."""
    flash_causal_attention_bwd.calls += 1
    b, t, h, dh = q.shape
    kh = k.shape[2]
    n_rep = h // kh
    if scale is None:
        scale = float(dh ** -0.5)
    dev = q.device
    ct = _acc_dtype(q)
    qf = q.to(ct)
    kf = repeat_kv(k, n_rep).to(ct)
    vf = repeat_kv(v, n_rep).to(ct)
    do = dout.to(ct)
    lse = lse.to(ct)
    delta = (do * out.to(ct)).sum(dim=-1).permute(0, 2, 1)[..., None]  # (B, H, T, 1)
    dq = torch.zeros((b, t, h, dh), dtype=ct, device=dev)
    dk = torch.empty((b, t, h, dh), dtype=ct, device=dev)
    dv = torch.empty((b, t, h, dh), dtype=ct, device=dev)
    for k0 in range(0, t, block):
        k_blk = kf[:, k0 : k0 + block]
        v_blk = vf[:, k0 : k0 + block]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk) * scale
        live = _live(t, k0, k_blk.shape[1], valid, dev)
        p = torch.where(live, torch.exp(s - lse), torch.zeros_like(s))
        dv[:, k0 : k0 + block] = torch.einsum("bhqk,bqhd->bkhd", p, do)
        dp = torch.einsum("bqhd,bkhd->bhqk", do, v_blk)
        ds = p * (dp - delta) * scale
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k_blk)
        dk[:, k0 : k0 + block] = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dk = dk.reshape(b, t, kh, n_rep, dh).sum(dim=3)
    dv = dv.reshape(b, t, kh, n_rep, dh).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_causal_attention_bwd.calls = 0


def _check_inputs(what: str, q, k, v, valid, dtypes=(torch.bfloat16, torch.float32)):
    if q.ndim != 4:
        raise ValueError(f"{what}: q must be (B, T, H, Dh), got {tuple(q.shape)}")
    b, t, h, dh = q.shape
    kh = k.shape[2] if k.ndim == 4 else 0
    if dh not in HEAD_DIMS or k.shape != (b, t, kh, dh) or v.shape != k.shape or kh < 1 or h % kh:
        raise ValueError(
            f"{what}: need q (B, T, H, Dh) and k, v (B, T, KH, Dh) with Dh in {HEAD_DIMS} and H % KH == 0, "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: q, k and v must all be one of {dtypes}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: q, k and v must be on the same device")
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0 for x in (q, k, v)):
        raise ValueError(f"{what}: q, k and v must be contiguous and 16-byte aligned")
    if valid is not None and (tuple(valid.shape) != (b, t) or valid.device != q.device):
        raise ValueError(f"{what}: valid must be (B, T) = {(b, t)} on {q.device}, got {tuple(valid.shape)}")


def _valid_u8(valid: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if valid is None else (valid > 0).to(torch.uint8).contiguous()


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous and 16-byte aligned (the TMA's tensor maps need both)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def _flash_fwd_kernel(q, k, v, valid, scale: float):
    """Launch the forward kernel: (out, lse (B, H, T, 1) f32)."""
    _check_inputs("flash_attention", q, k, v, valid)
    b, t, h, dh = q.shape
    vu8 = _valid_u8(valid)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t, 1), dtype=torch.float32, device=q.device)
    err = _cuda.load().rtca_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(vu8), out.data_ptr(), lse.data_ptr(),
        b, t, h, k.shape[2], dh, float(scale), int(q.dtype == torch.float32), _cuda.stream_handle(q.device),
    )
    _cuda.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, out, lse, dout, valid=None, scale: Optional[float] = None):
    """Launch the dq kernel (bf16 CUDA tensors): (dq, delta (B, H, T) f32).
    delta = rowsum(dO * O) is its first pass; the dk/dv kernel reads it."""
    _check_inputs("flash_attention_bwd_dq", q, k, v, valid, dtypes=(torch.bfloat16,))
    b, t, h, dh = q.shape
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError("flash_attention_bwd_dq: out and dout must be bf16 like q")
    if lse.shape != (b, h, t, 1) or lse.dtype != torch.float32:
        raise ValueError("flash_attention_bwd_dq: lse must be (B, H, T, 1) float32")
    out, dout, lse = _aligned(out), _aligned(dout), lse.contiguous()
    vu8 = _valid_u8(valid)
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    err = _cuda.load().rtca_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        _ptr(vu8), dq.data_ptr(), delta.data_ptr(), b, t, h, k.shape[2], dh, float(scale or dh ** -0.5),
        _cuda.stream_handle(q.device),
    )
    _cuda.check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq, delta


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, valid=None, scale: Optional[float] = None, splits: int = 0):
    """Launch the dk/dv kernel (bf16 CUDA tensors): (dk, dv) with KH heads.
    ``splits`` (1..8): the blocks, one thread-block cluster, that share each
    key tile's query tiles and sum their partial dK/dV in a fixed order; 0
    leaves it to the kernel (:func:`dkv_splits`)."""
    _check_inputs("flash_attention_bwd_dkv", q, k, v, valid, dtypes=(torch.bfloat16,))
    b, t, h, dh = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("flash_attention_bwd_dkv: dout must be bf16 like q")
    if lse.shape != (b, h, t, 1) or delta.shape != (b, h, t) or delta.dtype != torch.float32:
        raise ValueError("flash_attention_bwd_dkv: lse must be (B, H, T, 1), delta (B, H, T), both float32")
    dout, lse, delta = _aligned(dout), lse.contiguous(), delta.contiguous()
    vu8 = _valid_u8(valid)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _cuda.load().rtca_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        _ptr(vu8), dk.data_ptr(), dv.data_ptr(), b, t, h, k.shape[2], dh, float(scale or dh ** -0.5), int(splits),
        _cuda.stream_handle(q.device),
    )
    _cuda.check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def dkv_splits(b: int, t: int, kh: int, dh: int) -> int:
    """The splits the dk/dv kernel picks on this card for (B, T, KH, Dh): the
    fewest, a power of two up to 8, whose blocks fill every SM at the
    kernel's occupancy."""
    return int(_cuda.load().rtca_flash_attention_bwd_dkv_splits(b, t, kh, dh))


def _check_f32_bwd(what: str, q, k, v, valid, dout, lse, out=None, delta=None):
    _check_inputs(what, q, k, v, valid, dtypes=(torch.float32,))
    b, t, h, _ = q.shape
    if any(x is not None and (x.shape, x.dtype) != (q.shape, q.dtype) for x in (dout, out)):
        raise ValueError(f"{what}: out and dout must be float32 like q")
    if lse.shape != (b, h, t, 1) or lse.dtype != torch.float32:
        raise ValueError(f"{what}: lse must be (B, H, T, 1) float32")
    if delta is not None and (delta.shape != (b, h, t) or delta.dtype != torch.float32):
        raise ValueError(f"{what}: delta must be (B, H, T) float32")


def flash_attention_bwd_dq_f32(q, k, v, out, lse, dout, valid=None, scale: Optional[float] = None):
    """Launch the f32 dq kernel (f32 CUDA tensors): (dq, delta (B, H, T)),
    delta = rowsum(dO * O) for the f32 dk/dv kernel."""
    _check_f32_bwd("flash_attention_bwd_dq_f32", q, k, v, valid, dout, lse, out=out)
    b, t, h, dh = q.shape
    out, dout, lse = _aligned(out), _aligned(dout), lse.contiguous()
    vu8 = _valid_u8(valid)
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    err = _cuda.load().rtca_flash_attention_bwd_dq_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        _ptr(vu8), dq.data_ptr(), delta.data_ptr(), b, t, h, k.shape[2], dh, float(scale or dh ** -0.5),
        _cuda.stream_handle(q.device),
    )
    _cuda.check(err, "flash_attention_bwd_dq_f32")
    flash_attention_bwd_dq_f32.launches += 1
    return dq, delta


flash_attention_bwd_dq_f32.launches = 0


def flash_attention_bwd_dkv_f32(q, k, v, dout, lse, delta, valid=None, scale: Optional[float] = None,
                                splits: int = 0):
    """Launch the f32 dk/dv kernel (f32 CUDA tensors): (dk, dv) with KH
    heads, each summed over its H // KH query heads in order. ``splits``
    (1..8): the blocks, one thread-block cluster, that share each key tile's
    (head, query tile) list and sum their partial dK/dV in rank order; 0
    leaves it to the kernel (:func:`dkv_f32_splits`)."""
    _check_f32_bwd("flash_attention_bwd_dkv_f32", q, k, v, valid, dout, lse, delta=delta)
    b, t, h, dh = q.shape
    dout, lse, delta = _aligned(dout), lse.contiguous(), delta.contiguous()
    vu8 = _valid_u8(valid)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _cuda.load().rtca_flash_attention_bwd_dkv_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        _ptr(vu8), dk.data_ptr(), dv.data_ptr(), b, t, h, k.shape[2], dh, float(scale or dh ** -0.5), int(splits),
        _cuda.stream_handle(q.device),
    )
    _cuda.check(err, "flash_attention_bwd_dkv_f32")
    flash_attention_bwd_dkv_f32.launches += 1
    return dk, dv


flash_attention_bwd_dkv_f32.launches = 0


def dkv_f32_splits(b: int, t: int, kh: int, dh: int) -> int:
    """The splits the f32 dk/dv kernel picks on this card for (B, T, KH,
    Dh): the fewest, a power of two up to 8, whose longest block (key tile
    0's query tiles over the splits) is no longer than the card's average
    work a block slot."""
    return int(_cuda.load().rtca_flash_attention_bwd_dkv_f32_splits(b, t, kh, dh))


def flash_attention_bwd(q, k, v, out, lse, dout, valid=None, scale: Optional[float] = None):
    """(dq, dk, dv): the dq then the dk/dv kernel for CUDA tensors (bf16:
    csrc/flash_attention_bwd.cu; f32: csrc/flash_attention_bwd_f32.cu; any
    other dtype raises), the plain backward for CPU tensors."""
    if q.device.type == "cpu":
        return flash_causal_attention_bwd(q, k, v, out, lse, dout, valid=valid, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    if q.dtype == torch.float32:
        dq, delta = flash_attention_bwd_dq_f32(q, k, v, out, lse, dout, valid=valid, scale=scale)
        dk, dv = flash_attention_bwd_dkv_f32(q, k, v, dout, lse, delta, valid=valid, scale=scale)
        return dq, dk, dv
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, dout, valid=valid, scale=scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, valid=valid, scale=scale)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """B4 as an autograd Function: saves (q, k, v, out, lse, valid); the
    backward never re-runs the forward. lse is an output without gradient."""

    @staticmethod
    def forward(ctx, q, k, v, valid, scale):
        if q.device.type == "cpu":
            out, lse = flash_causal_attention(q, k, v, valid=valid, scale=scale)
        elif q.device.type == "cuda":
            out, lse = _flash_fwd_kernel(q, k, v, valid, scale)
        else:
            raise ValueError(f"flash_attention: unsupported device {q.device}")
        ctx.save_for_backward(q, k, v, out, lse, valid)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, valid = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, valid=valid, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,  # (B, T, H, Dh)
    k: torch.Tensor,  # (B, T, KH, Dh)
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention (out, lse), differentiable in q, k and v: the CUDA
    kernels for CUDA tensors, the plain versions for CPU tensors."""
    if scale is None:
        scale = float(q.shape[-1] ** -0.5)
    return FlashAttentionFn.apply(q, k, v, valid, scale)


flash_attention.launches = 0
