"""Core NN ops shared by the codec and the duplex LM, on torch tensors.

Port of realtime_codec_agent_tpu/ops/nn.py. Matmuls return f32 (JAX's
``preferred_element_type=float32``): inputs are widened to f32 before
``torch.matmul``, which is exact for bf16 operands, so a bf16 model computes
the same products as the JAX package. Normalization and softmax statistics
are f32. Long-block causal attention (cacheless scoring and training) goes
through ``train_attention`` to kernel B4 (ops/flash_attention.py), forward
and backward, with the key-validity mask.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .flash_attention import flash_attention, flash_causal_attention, repeat_kv  # noqa: F401 (the JAX module's names)
from .int4_matmul import dequant_int4_bf16, int4_matmul
from .int8_matmul import MAX_ROWS as INT8_KERNEL_MAX_ROWS
from .int8_matmul import int8_matmul

NEG_INF = -1e30


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 products and sums, returned in f32."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def _use_int8_kernel(x: torch.Tensor) -> bool:
    """The routing rule of the JAX package's ``_use_pallas_int8``: calls of
    at most 8 rows (frame scan, lm_head, small prefill buckets) take kernel
    B2 (int8) or B5 (int4); wider calls dequantize and use torch.matmul."""
    rows = 1
    for d in x.shape[:-1]:
        rows *= d
    return rows <= INT8_KERNEL_MAX_ROWS


def qdot(x: torch.Tensor, w, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Matmul over a dense (in, out) weight, an int8 ``{"q", "s"}`` leaf
    (per-output-channel scales, models/llama.quantize_params_int8) or an
    affine int4 ``{"q4", "d", "m"}`` leaf (models/llama.quantize_params_int4,
    the GGUF Q4_K import). f32 result. Kernels B2 and B5 round the
    activations to bf16 (the TPU kernels' numerics); the wide routes keep
    them in their dtype (the XLA routes')."""
    if isinstance(w, dict) and "q" in w:
        if _use_int8_kernel(x):
            y = int8_matmul(x, w["q"], w["s"])
        else:
            y = dot_f32(x, w["q"]) * w["s"]
    elif isinstance(w, dict):
        if _use_int8_kernel(x):
            y = int4_matmul(x, w["q4"], w["d"], w["m"])
        else:
            y = dot_f32(x, dequant_int4_bf16(w["q4"], w["d"], w["m"]))
    else:
        y = dot_f32(x, w)
    return y if out_dtype is None else y.to(out_dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm (Llama-style: normalize in f32, scale, cast back)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight).to(x.dtype)  # f32 * weight promotes to f32 exactly


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm in f32 (torch.nn.LayerNorm semantics)."""
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    out = xf * weight.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def llama3_scaled_inv_freq(
    inv_freq: torch.Tensor,
    factor: float,
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
    original_max_position: int = 8192,
) -> torch.Tensor:
    """Llama-3.x rope scaling (HF ``rope_type="llama3"``): long-wavelength
    frequencies divided by ``factor``, short ones untouched, smooth ramp
    between."""
    low_freq_wavelen = original_max_position / low_freq_factor
    high_freq_wavelen = original_max_position / high_freq_factor
    wavelen = 2.0 * math.pi / inv_freq
    smooth = (original_max_position / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor
    )
    interp = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    out = torch.where(wavelen > low_freq_wavelen, inv_freq / factor, interp)
    return torch.where(wavelen < high_freq_wavelen, inv_freq, out)


def rope_cos_sin(
    positions: torch.Tensor,
    head_dim: int,
    theta: float = 10000.0,
    rope_scaling: Optional[Tuple[float, float, float, int]] = None,
    interleaved: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary tables for integer positions ``(...,)`` -> cos/sin ``(..., head_dim)``.
    ``interleaved=False`` duplicates each frequency across the two halves (HF
    Llama layout); ``interleaved=True`` duplicates adjacently (GPT-J layout)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    # the base as a device fill, not an upload: no host synchronization
    base = torch.full((), theta, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / torch.pow(base, exponent)
    if rope_scaling is not None and rope_scaling[0] > 0:
        inv_freq = llama3_scaled_inv_freq(inv_freq, *rope_scaling)
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    if interleaved:
        emb = torch.repeat_interleave(freqs, 2, dim=-1)
    else:
        emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _rotate_interleaved(x: torch.Tensor) -> torch.Tensor:
    """(x0,x1,x2,x3,...) -> (-x1,x0,-x3,x2,...)."""
    return torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)


def apply_rope(
    q: torch.Tensor,
    k: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    interleaved: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary embedding. q/k: (..., T, H, Dh); cos/sin: (..., T, Dh). q and k
    go through one elementwise pass together (fewer launches; same values)."""
    rot = _rotate_interleaved if interleaved else _rotate_half
    cos = cos[..., :, None, :].to(torch.float32)
    sin = sin[..., :, None, :].to(torch.float32)
    hq = q.shape[-2]
    qk = torch.cat([q, k], dim=-2).to(torch.float32)
    out = qk * cos + rot(qk) * sin
    return out[..., :hq, :].to(q.dtype), out[..., hq:, :].to(k.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Scaled dot-product attention, plain torch. q: (B, Tq, H, Dh); k/v:
    (B, Tk, H, Dh); mask broadcastable to (B, H, Tq, Tk), True = attend.
    Softmax in f32; probabilities rounded to v's dtype before P.V (as JAX)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) * scale
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhqk,bkhd->bqhd", probs.to(v.dtype).to(torch.float32), v.to(torch.float32)
    )
    return out.to(q.dtype)


def causal_mask(tq: int, tk: int, q_offset: int, device=None) -> torch.Tensor:
    """(1, 1, tq, tk) boolean mask: query at absolute pos q_offset+i attends keys <= that pos."""
    q_pos = q_offset + torch.arange(tq, device=device)[:, None]
    k_pos = torch.arange(tk, device=device)[None, :]
    return (k_pos <= q_pos)[None, None]


def train_attention(
    q: torch.Tensor,  # (B, T, H, Dh)
    k: torch.Tensor,  # (B, T, KH, Dh): NOT head-repeated
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Long-block causal attention (models/llama.transformer_layer routes
    T > 512 here), differentiable, with an optional key validity ``valid
    (B, T)``: kernel B4 for CUDA tensors, its plain versions (the JAX
    package's key-block scans) for CPU tensors. The JAX package's TPU rule
    (Pallas at T % 512 == 0) does not apply: the kernels take any T."""
    out, _ = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), valid=valid, scale=scale)
    return out


def swiglu_mlp(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """Llama SwiGLU MLP: down(silu(x@gate) * (x@up)); dense, int8 or int4 weights."""
    g = qdot(x, w_gate)
    u = qdot(x, w_up)
    h = (F.silu(g) * u).to(x.dtype)
    return qdot(h, w_down, out_dtype=x.dtype)


def gelu_mlp(x: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """Plain 2-layer GELU MLP (codec transformer blocks, codec projector)."""
    h = dot_f32(x, w1) + b1.to(torch.float32)
    h = F.gelu(h, approximate="none").to(x.dtype)
    return (dot_f32(h, w2) + b2.to(torch.float32)).to(x.dtype)
