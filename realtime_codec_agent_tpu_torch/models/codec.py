"""MagiCodec-style neural audio codec in PyTorch.

Port of realtime_codec_agent_tpu/models/codec.py, same param pytree (nested
dicts and lists of tensors, weights in ``(in, out)`` layout), same math:

- patchify front end: audio right-padded to a multiple of ``hop_length`` (320
  samples -> 50 Hz frames) and embedded by one (hop, H) matmul;
- transformer body: pre-RMSNorm blocks, rotary bidirectional attention, GELU
  MLPs (plain torch -- the JAX package leaves these to XLA);
- single-codebook quantizer: a raw codebook projected to ``codebook_dim``;
  the nearest-code search is kernel B1 (ops/quantize.py).

Only the default flavour is ported: ``frontend="conv"`` and
``norm_type="layer"`` raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import nn
from ..ops.quantize import nearest_code_prepared, prepare_codebook


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    sample_rate: int = 16000
    hop_length: int = 320  # -> 50 Hz frame rate
    codebook_size: int = 131072
    codebook_dim: int = 16
    codebook_raw_dim: int = 16
    hidden_size: int = 768
    num_layers: int = 8
    num_heads: int = 12
    mlp_ratio: float = 4.0
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    frontend: str = "patchify"
    conv_ratios: Tuple[int, ...] = (8, 5, 4, 2)
    conv_base_channels: int = 48
    norm_type: str = "rms"  # "rms" | "layer"
    rope_interleaved: bool = False
    compute_dtype: str = "bfloat16"

    @property
    def framerate(self) -> float:
        return self.sample_rate / self.hop_length

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def tiny_codec_config(**overrides) -> CodecConfig:
    """Small config for tests: same 16 kHz / 50 Hz geometry, tiny body+codebook."""
    defaults = dict(
        codebook_size=1024, hidden_size=64, num_layers=2, num_heads=4,
        codebook_dim=16, codebook_raw_dim=16,
    )
    defaults.update(overrides)
    return CodecConfig(**defaults)


def _check_supported(cfg: CodecConfig) -> None:
    if cfg.frontend != "patchify":
        raise NotImplementedError(f"codec frontend={cfg.frontend!r} is not ported yet (patchify only; ROADMAP.md, port queue: 'conv/LayerNorm codec flavours')")
    if cfg.norm_type != "rms":
        raise NotImplementedError(f"codec norm_type={cfg.norm_type!r} is not ported yet (rms only; ROADMAP.md, port queue: 'conv/LayerNorm codec flavours')")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * scale).to(dtype)


def _init_block(gen, h: int, mlp: int, dtype, device) -> Dict:
    s = 1.0 / math.sqrt(h)
    sm = 1.0 / math.sqrt(mlp)
    return {
        "attn_norm": torch.ones((h,), dtype=dtype, device=device),
        "wq": _normal(gen, (h, h), s, dtype, device),
        "wk": _normal(gen, (h, h), s, dtype, device),
        "wv": _normal(gen, (h, h), s, dtype, device),
        "wo": _normal(gen, (h, h), s, dtype, device),
        "mlp_norm": torch.ones((h,), dtype=dtype, device=device),
        "w1": _normal(gen, (h, mlp), s, dtype, device),
        "b1": torch.zeros((mlp,), dtype=dtype, device=device),
        "w2": _normal(gen, (mlp, h), sm, dtype, device),
        "b2": torch.zeros((h,), dtype=dtype, device=device),
    }


def init_codec_params(gen: torch.Generator, cfg: CodecConfig, device="cpu") -> Dict:
    """Random init with the JAX package's distributions (not its numbers:
    the stream is ``gen``'s). ``gen`` must live on ``device``."""
    _check_supported(cfg)
    dtype = cfg.dtype
    h, hop, d = cfg.hidden_size, cfg.hop_length, cfg.codebook_dim
    f32 = torch.float32
    return {
        "encoder": {
            "patch_embed": _normal(gen, (hop, h), 1.0 / math.sqrt(hop), dtype, device),
            "patch_bias": torch.zeros((h,), dtype=dtype, device=device),
            "blocks": [_init_block(gen, h, cfg.mlp_dim, dtype, device) for _ in range(cfg.num_layers)],
            "out_norm": torch.ones((h,), dtype=dtype, device=device),
            "out_proj": _normal(gen, (h, d), 1.0 / math.sqrt(h), dtype, device),
        },
        "quantizer": {
            "codebook": _normal(gen, (cfg.codebook_size, cfg.codebook_raw_dim), 1.0, f32, device),
            "proj_w": _normal(gen, (cfg.codebook_raw_dim, d), 1.0 / math.sqrt(cfg.codebook_raw_dim), f32, device),
            "proj_b": torch.zeros((d,), dtype=f32, device=device),
        },
        "decoder": {
            "in_proj": _normal(gen, (d, h), 1.0 / math.sqrt(d), dtype, device),
            "in_bias": torch.zeros((h,), dtype=dtype, device=device),
            "blocks": [_init_block(gen, h, cfg.mlp_dim, dtype, device) for _ in range(cfg.num_layers)],
            "out_norm": torch.ones((h,), dtype=dtype, device=device),
            "patch_unembed": _normal(gen, (h, hop), 1.0 / math.sqrt(h), dtype, device),
        },
    }


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def pad_audio(audio: np.ndarray, hop_length: int) -> np.ndarray:
    """Right-pad the last axis to a multiple of hop_length (codec_model.pad_audio)."""
    t = audio.shape[-1]
    target = ((t + hop_length - 1) // hop_length) * hop_length
    if target == t:
        return audio
    pad = [(0, 0)] * (audio.ndim - 1) + [(0, target - t)]
    return np.pad(audio, pad, mode="constant")


def _proj(y: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
    out = nn.dot_f32(y, w)
    if b is not None:
        out = out + b.to(torch.float32)
    return out.to(y.dtype)


def _transformer(x: torch.Tensor, blocks, cfg: CodecConfig) -> torch.Tensor:
    b, t, h = x.shape
    nh, dh = cfg.num_heads, cfg.head_dim
    positions = torch.arange(t, device=x.device)
    cos, sin = nn.rope_cos_sin(positions, dh, cfg.rope_theta, interleaved=cfg.rope_interleaved)
    for blk in blocks:
        res = x
        y = nn.rms_norm(x, blk["attn_norm"], cfg.rms_eps)
        q = _proj(y, blk["wq"], blk.get("bq")).reshape(b, t, nh, dh)
        k = _proj(y, blk["wk"], blk.get("bk")).reshape(b, t, nh, dh)
        v = _proj(y, blk["wv"], blk.get("bv")).reshape(b, t, nh, dh)
        q, k = nn.apply_rope(q, k, cos, sin, interleaved=cfg.rope_interleaved)
        attn = nn.attention(q, k, v)  # bidirectional
        attn = _proj(attn.reshape(b, t, h), blk["wo"], blk.get("bo"))
        x = res + attn
        res = x
        y = nn.rms_norm(x, blk["mlp_norm"], cfg.rms_eps)
        y = nn.gelu_mlp(y, blk["w1"], blk["b1"], blk["w2"], blk["b2"])
        x = res + y
    return x


def projected_codebook(params: Dict) -> torch.Tensor:
    """quantizer.codebook_proj(quantizer.codebook.weight) -> (V, codebook_dim) f32."""
    q = params["quantizer"]
    return nn.dot_f32(q["codebook"], q["proj_w"]) + q["proj_b"].to(torch.float32)


def quantizer_tables(params: Dict, cfg: CodecConfig) -> Dict:
    """The quantizer lookup tables, built ONCE per model: the projected
    codebook (decode embedding and the B1 kernel's codes) and its
    half-norms (the B1 kernel's bias)."""
    cb, halfnorm = prepare_codebook(projected_codebook(params))
    return {"cb_proj": cb, "halfnorm": halfnorm}


def encode_frames(
    params: Dict, audio: torch.Tensor, cfg: CodecConfig, tables: Optional[Dict] = None
) -> torch.Tensor:
    """audio (B, T) with T % hop == 0 -> codes (B, T/hop) int32."""
    _check_supported(cfg)
    dtype = cfg.dtype
    b, t = audio.shape
    enc = params["encoder"]
    frames = audio.reshape(b, t // cfg.hop_length, cfg.hop_length).to(dtype)
    x = nn.dot_f32(frames, enc["patch_embed"]).to(dtype) + enc["patch_bias"]
    x = _transformer(x, enc["blocks"], cfg)
    x = nn.rms_norm(x, enc["out_norm"], cfg.rms_eps)
    z_e = nn.dot_f32(x, enc["out_proj"])  # (B, F, d) f32
    if enc.get("out_proj_b") is not None:
        z_e = z_e + enc["out_proj_b"].to(torch.float32)
    if tables is None:
        tables = quantizer_tables(params, cfg)
    codes = nearest_code_prepared(z_e.reshape(-1, z_e.shape[-1]), tables["cb_proj"], tables["halfnorm"])
    return codes.reshape(b, -1)


def decode_frames(
    params: Dict, codes: torch.Tensor, cfg: CodecConfig, tables: Optional[Dict] = None
) -> torch.Tensor:
    """codes (B, F) int -> audio (B, F*hop) float32."""
    _check_supported(cfg)
    dtype = cfg.dtype
    cb = tables["cb_proj"] if tables is not None else projected_codebook(params)
    z_q = cb[codes.long()]  # (B, F, d) f32
    dec = params["decoder"]
    x = nn.dot_f32(z_q.to(dtype), dec["in_proj"]).to(dtype) + dec["in_bias"]
    x = _transformer(x, dec["blocks"], cfg)
    x = nn.rms_norm(x, dec["out_norm"], cfg.rms_eps)
    audio = nn.dot_f32(x, dec["patch_unembed"])  # (B, F, hop) f32
    if dec.get("patch_unembed_b") is not None:
        audio = audio + dec["patch_unembed_b"].to(torch.float32)
    b, f, hop = audio.shape
    return audio.reshape(b, f * hop)


class TorchCodecModel:
    """Params + config + prepared quantizer tables on one device, with the
    interface the streaming AudioTokenizer needs (pad_audio / encode /
    decode / projected codebook / sample_rate / codebook_size)."""

    def __init__(self, params: Dict, config: CodecConfig, device=None):
        _check_supported(config)
        self.params = params
        self.config = config
        self.device = torch.device(device) if device is not None else params["quantizer"]["codebook"].device
        self.sample_rate = config.sample_rate
        self.codebook_size = config.codebook_size
        with torch.no_grad():
            self.tables = quantizer_tables(params, config)

    @classmethod
    def random_init(cls, config: CodecConfig = None, seed: int = 0, device="cpu") -> "TorchCodecModel":
        config = config or CodecConfig()
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return cls(init_codec_params(gen, config, device), config, device)

    def pad_audio(self, audio: np.ndarray) -> np.ndarray:
        return pad_audio(audio, self.config.hop_length)

    @torch.no_grad()
    def encode(self, audio: np.ndarray) -> np.ndarray:
        """(B, T) float32 -> (B, F) int32 codes; pads to a hop multiple."""
        audio = self.pad_audio(np.asarray(audio, dtype=np.float32))
        x = torch.from_numpy(np.ascontiguousarray(audio)).to(self.device)
        return encode_frames(self.params, x, self.config, tables=self.tables).cpu().numpy()

    @torch.no_grad()
    def decode(self, codes: np.ndarray) -> np.ndarray:
        """(B, F) int codes -> (B, F*hop) float32 audio."""
        c = torch.from_numpy(np.asarray(codes, dtype=np.int64)).to(self.device)
        return decode_frames(self.params, c, self.config, tables=self.tables).cpu().numpy()

    @torch.no_grad()
    def get_projected_codebook(self) -> np.ndarray:
        return projected_codebook(self.params).cpu().numpy()
