"""Qwen2 (Qwen2.5) forward pass, plain PyTorch in f32.

    x = embed[ids]
    per layer:  y = rms(x) * g1;  q, k, v = y Wq + bq, y Wk + bk, y Wv + bv
                q, k = rope(q), rope(k)  (theta from the config, halves rotated)
                a = softmax(q k^T / sqrt(Dh) + causal) v   (each KV head shared by H / KH query heads)
                x = x + a Wo
                y = rms(x) * g2;  x = x + (silu(y Wg) * (y Wu)) Wd
    h = rms(x) * g;  logits = h E^T  (tied head)

``mm`` is the matmul: the training reference passes one that rounds its
inputs (``fp8_round`` for the control).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.utils.checkpoint

def plain_matmuls() -> None:
    """f32 products stay f32 on the card: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude at the format's 448), back in f32."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(), min=1e-30) / 448.0
    return (xf / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, Dh), rotated by the HF layout (first half against second)."""
    dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, device=x.device, dtype=torch.float64) / dh)
    ang = positions.to(torch.float64)[:, None] * inv[None, :]
    cos = torch.cat([ang.cos(), ang.cos()], -1).to(torch.float32)[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1).to(torch.float32)[:, None, :]
    half = dh // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


class Qwen2:
    """The forward pass over f32 weights ``w`` of configuration ``cfg`` (a
    ``configs/*.json`` dict), with ``mm`` as its matmul."""

    def __init__(self, w: Dict, cfg: dict, mm: Callable = torch.matmul):
        self.w, self.mm = w, mm
        self.heads, self.kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        self.dh = cfg["hidden_size"] // self.heads
        self.eps, self.theta = cfg["rms_norm_eps"], cfg["rope_theta"]

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.w["embed_tokens"][ids]

    def layer(self, x: torch.Tensor, blk: Dict, positions: torch.Tensor, valid: Optional[torch.Tensor] = None):
        """x (T, H) at ``positions``; ``valid`` (T,) masks keys."""
        t = x.shape[0]
        mm = self.mm
        y = rms(x, blk["attn_norm"], self.eps)
        q = (mm(y, blk["wq"]) + blk["bq"]).reshape(t, self.heads, self.dh)
        k = (mm(y, blk["wk"]) + blk["bk"]).reshape(t, self.kv, self.dh)
        v = (mm(y, blk["wv"]) + blk["bv"]).reshape(t, self.kv, self.dh)
        q, k = rope(q, positions, self.theta), rope(k, positions, self.theta)
        rep = self.heads // self.kv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        scores = mm(q.transpose(0, 1), k.permute(1, 2, 0)) / self.dh ** 0.5  # (heads, T, T)
        keep = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        if valid is not None:
            keep = keep & valid[None, :]
        scores = scores.masked_fill(~keep, float("-inf"))
        attn = mm(torch.softmax(scores, dim=-1), v.transpose(0, 1))  # (heads, T, Dh)
        x = x + mm(attn.transpose(0, 1).reshape(t, self.heads * self.dh), blk["wo"])
        y = rms(x, blk["mlp_norm"], self.eps)
        g, u = mm(y, blk["w_gate"]), mm(y, blk["w_up"])
        return x + mm(torch.nn.functional.silu(g) * u, blk["w_down"])

    def hidden(self, ids: torch.Tensor, valid: Optional[torch.Tensor] = None, x: Optional[torch.Tensor] = None,
               recompute: bool = False):
        """Final-norm hidden states (T, H) of ``ids`` (T,) at positions 0..T-1;
        ``recompute``: each layer's activations recomputed in the backward
        (memory, not values)."""
        positions = torch.arange(ids.shape[0], device=ids.device)
        x = self.embed(ids) if x is None else x
        for blk in self.w["layers"]:
            if recompute:
                x = torch.utils.checkpoint.checkpoint(self.layer, x, blk, positions, valid, use_reentrant=False)
            else:
                x = self.layer(x, blk, positions, valid)
        return rms(x, self.w["final_norm"], self.eps)
