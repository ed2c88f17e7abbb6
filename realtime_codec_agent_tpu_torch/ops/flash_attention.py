"""Causal flash attention forward (kernel B4) and its plain version.

Port of the forward of realtime_codec_agent_tpu/ops/nn.py's long-block
attention: the Pallas TPU kernel ``flash_attention_pallas`` (JAX's stock TPU
flash kernel) and, as the plain version, ``flash_causal_attention`` with its
forward ``_flash_fwd_impl`` (online softmax over 1024-key blocks, f32
statistics, probabilities rounded to the value dtype before P.V). Both
functions take the JAX layout ``q (B, T, H, Dh)`` and ``k, v (B, T, KH, Dh)``
with ``H % KH == 0`` -- the JAX callers' ``repeat_kv`` happens inside: the plain
version repeats the heads, the kernel reads KV head ``h // (H // KH)`` -- and
return ``(out (B, T, H, Dh) in q's dtype, lse (B, H, T, 1) f32)``, where a row
whose every key is masked gives out = 0 and lse = 0.

For a CUDA tensor :func:`flash_attention` launches csrc/flash_attention.cu;
for a CPU tensor it runs :func:`flash_causal_attention`. The backward and the
validity (segment-id) mask on the card are training's (ROADMAP queue 11).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda

HEAD_DIM = 64  # head dim the CUDA kernel is written for
NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KH, Dh) -> (B, S, KH*n_rep, Dh) for grouped-query attention:
    head h reads KV head h // n_rep."""
    if n_rep == 1:
        return x
    b, s, kh, dh = x.shape
    return x[:, :, :, None, :].expand(b, s, kh, n_rep, dh).reshape(b, s, kh * n_rep, dh)


def flash_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,  # (B, T) key validity (padding mask)
    block: int = 1024,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the JAX package's key-block online softmax. Keys
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
    qf = q.to(torch.float32)
    q_pos = torch.arange(t, device=dev)
    m = torch.full((b, h, t, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, t, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, t, dh), dtype=torch.float32, device=dev)
    for k0 in range(0, t, block):
        k_blk = k[:, k0 : k0 + block]
        v_blk = v[:, k0 : k0 + block]
        key_pos = k0 + torch.arange(k_blk.shape[1], device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.to(torch.float32)) * scale
        live = (key_pos[None, :] <= q_pos[:, None])[None, None]
        if valid is not None:
            live = live & (valid[:, k0 : k0 + block] > 0)[:, None, None, :]
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(live, torch.exp(s - m_new), torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v.dtype).to(torch.float32), v_blk.to(torch.float32)
        )
        acc = acc * corr + pv
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe).permute(0, 2, 1, 3).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(l_safe), torch.zeros_like(l))
    return out, lse


flash_causal_attention.calls = 0


def flash_attention(
    q: torch.Tensor,  # (B, T, H, Dh)
    k: torch.Tensor,  # (B, T, KH, Dh)
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention (out, lse): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_causal_attention(q, k, v, valid=valid, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if valid is not None or (torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))):
        raise NotImplementedError(
            "flash_attention: the validity (segment-id) mask and the backward on the card are not "
            "ported yet (ROADMAP.md, port queue: 'training with B4's backward')"
        )
    if q.ndim != 4:
        raise ValueError(f"flash_attention: q must be (B, T, H, Dh), got {tuple(q.shape)}")
    b, t, h, dh = q.shape
    kh = k.shape[2] if k.ndim == 4 else 0
    if dh != HEAD_DIM or k.shape != (b, t, kh, dh) or v.shape != k.shape or kh < 1 or h % kh:
        raise ValueError(
            f"flash_attention: need q (B, T, H, {HEAD_DIM}) and k, v (B, T, KH, {HEAD_DIM}) with H % KH == 0, "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v must all be bfloat16 or all float32")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must be on the same device")
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0 for x in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be contiguous and 16-byte aligned")
    if scale is None:
        scale = float(dh ** -0.5)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t, 1), dtype=torch.float32, device=q.device)
    lib = _cuda.load()
    err = lib.rtca_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, t, h, kh, float(scale), int(q.dtype == torch.float32), _cuda.stream_handle(q.device),
    )
    _cuda.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
