"""MagiCodec-style neural audio codec in PyTorch.

Port of realtime_codec_agent_tpu/models/codec.py, same param pytree (nested
dicts and lists of tensors, weights in ``(in, out)`` layout, conv kernels in
``(k, in, out)``), same math:

- front end, either
  - ``frontend="patchify"``: audio right-padded to a multiple of
    ``hop_length`` (320 samples -> 50 Hz frames) and embedded by one (hop, H)
    matmul, or
  - ``frontend="conv"``: a strided convolution stack down to the frame rate
    and its transposed mirror back up (MagiCodec/Encodec-style; XLA's SAME
    padding, tanh GELU between stages), written as im2col and overlap-add
    products so the sums stay f32 on the card (cuDNN would round to TF32
    under PyTorch's default flags);
- transformer body: pre-norm blocks (``norm_type`` "rms", or "layer" with
  biases: the flash-attn blocks MagiCodec builds on), optional projection
  biases, rotary bidirectional attention in either rotary layout, GELU MLPs
  (plain torch -- the JAX package leaves all of these to XLA);
- single-codebook quantizer: a raw codebook projected to ``codebook_dim``;
  the nearest-code search is kernel B1 (ops/quantize.py).

``TorchCodecModel.load`` reads the port's and the JAX package's ``.npz``
checkpoints and MagiCodec-layout torch state dicts (models/convert.py).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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
    def conv_channels(self) -> Tuple[int, ...]:
        """Channel schedule for the conv front end: doubles per stage, capped
        at hidden_size, ending exactly at hidden_size."""
        chans = []
        c = self.conv_base_channels
        for _ in self.conv_ratios:
            chans.append(min(c, self.hidden_size))
            c *= 2
        chans[-1] = self.hidden_size
        return tuple(chans)

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


def _init_conv_frontend(gen, cfg: CodecConfig, dtype, device) -> Tuple[Dict, Dict]:
    """Strided conv downsample stack + its mirrored transposed-conv
    upsampler. Kernels are ``(k, in, out)`` with k = 2 x the stage's ratio;
    the decoder's stage list runs in reverse (highest width first)."""
    if math.prod(cfg.conv_ratios) != cfg.hop_length:
        raise ValueError(f"conv_ratios {cfg.conv_ratios} must multiply to hop_length {cfg.hop_length}")
    chans = cfg.conv_channels
    in_chans = (1,) + chans[:-1]
    enc_stages, dec_stages = [], []
    for r, cin, cout in zip(cfg.conv_ratios, in_chans, chans):
        enc_stages.append({"w": _normal(gen, (2 * r, cin, cout), 1.0 / math.sqrt(2 * r * cin), dtype, device),
                           "b": torch.zeros((cout,), dtype=dtype, device=device)})
        dec_stages.append({"w": _normal(gen, (2 * r, cout, cin), 1.0 / math.sqrt(2 * r * cout), dtype, device),
                           "b": torch.zeros((cin,), dtype=dtype, device=device)})
    return {"stages": enc_stages}, {"stages": list(reversed(dec_stages))}


def init_codec_params(gen: torch.Generator, cfg: CodecConfig, device="cpu") -> Dict:
    """Random init with the JAX package's distributions (not its numbers:
    the stream is ``gen``'s). ``gen`` must live on ``device``."""
    dtype = cfg.dtype
    h, hop, d = cfg.hidden_size, cfg.hop_length, cfg.codebook_dim
    f32 = torch.float32
    if cfg.frontend == "conv":
        enc_front, dec_front = _init_conv_frontend(gen, cfg, dtype, device)
        enc_front, dec_front = {"conv": enc_front}, {"conv": dec_front}
    else:
        enc_front = {
            "patch_embed": _normal(gen, (hop, h), 1.0 / math.sqrt(hop), dtype, device),
            "patch_bias": torch.zeros((h,), dtype=dtype, device=device),
        }
        dec_front = {"patch_unembed": _normal(gen, (h, hop), 1.0 / math.sqrt(h), dtype, device)}
    return {
        "encoder": {
            **enc_front,
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
            **dec_front,
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


def _norm(x: torch.Tensor, w: torch.Tensor, b, cfg: CodecConfig) -> torch.Tensor:
    if cfg.norm_type == "layer":
        return nn.layer_norm(x, w, b, cfg.rms_eps)
    return nn.rms_norm(x, w, cfg.rms_eps)


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
        y = _norm(x, blk["attn_norm"], blk.get("attn_norm_b"), cfg)
        q = _proj(y, blk["wq"], blk.get("bq")).reshape(b, t, nh, dh)
        k = _proj(y, blk["wk"], blk.get("bk")).reshape(b, t, nh, dh)
        v = _proj(y, blk["wv"], blk.get("bv")).reshape(b, t, nh, dh)
        q, k = nn.apply_rope(q, k, cos, sin, interleaved=cfg.rope_interleaved)
        attn = nn.attention(q, k, v)  # bidirectional
        attn = _proj(attn.reshape(b, t, h), blk["wo"], blk.get("bo"))
        x = res + attn
        res = x
        y = _norm(x, blk["mlp_norm"], blk.get("mlp_norm_b"), cfg)
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


def _same_pads(length: int, k: int, r: int) -> Tuple[int, int]:
    """XLA's SAME padding of a stride-r, width-k window over ``length``
    samples: (total // 2) before, the rest after."""
    total = max((-(-length // r) - 1) * r + k - length, 0)
    return total // 2, total - total // 2


def _conv_downsample(stages, x: torch.Tensor, ratios) -> torch.Tensor:
    """(B, T, 1) -> (B, T/hop, C): each stage a stride-r correlation with
    SAME padding as one im2col product (f32 sums, rounded to x's dtype), plus
    the bias, and tanh GELU (jax.nn.gelu's default) between stages."""
    for i, (stage, r) in enumerate(zip(stages, ratios)):
        w = stage["w"]  # (k, in, out)
        k, cin, cout = w.shape
        lo, hi = _same_pads(x.shape[1], k, r)
        cols = F.pad(x, (0, 0, lo, hi)).unfold(1, k, r)  # (B, n, in, k)
        cols = cols.transpose(2, 3).reshape(x.shape[0], cols.shape[1], k * cin)
        x = nn.dot_f32(cols, w.reshape(k * cin, cout)).to(x.dtype) + stage["b"]
        if i < len(stages) - 1:
            x = F.gelu(x, approximate="tanh")
    return x


def _conv_upsample(stages, x: torch.Tensor, ratios_rev) -> torch.Tensor:
    """(B, F, C) -> (B, F*hop, 1): each stage ``lax.conv_transpose(...,
    padding="SAME")`` without a kernel flip, i.e. a correlation of the input
    dilated by r. Computed without the inserted zeros: one product spreads
    every input frame over k outputs, which overlap-add at hop r; the SAME
    padding (ceil((k + r - 2) / 2) before) picks the window that is kept."""
    for i, (stage, r) in enumerate(zip(stages, ratios_rev)):
        w = stage["w"]  # (k, in, out)
        k, cin, cout = w.shape
        b, n, _ = x.shape
        pad_len = k + r - 2
        pad_a = k - 1 if r > k - 1 else -(-pad_len // 2)
        # input frame m, tap j lands on output m*r + pad_a - j: flip the taps
        z = nn.dot_f32(x, w.permute(1, 0, 2).reshape(cin, k * cout)).reshape(b, n, k, cout).flip(2)
        c = -(-k // r)
        z = F.pad(z, (0, 0, 0, c * r - k)).reshape(b, n, c, r, cout)
        full = z.new_zeros((b, n + c - 1, r, cout))
        for j in range(c):
            full[:, j : j + n] += z[:, :, j]
        start = k - 1 - pad_a
        y = full.reshape(b, (n + c - 1) * r, cout)[:, start : start + n * r]
        x = y.to(x.dtype) + stage["b"]
        if i < len(stages) - 1:
            x = F.gelu(x, approximate="tanh")
    return x


def encode_latents(params: Dict, audio: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """audio (B, T) with T % hop == 0 -> the encoder's output z_e (B, T/hop,
    codebook_dim) f32, before the nearest-code search."""
    dtype = cfg.dtype
    b, t = audio.shape
    enc = params["encoder"]
    if cfg.frontend == "conv":
        x = _conv_downsample(enc["conv"]["stages"], audio[..., None].to(dtype), cfg.conv_ratios)
    else:
        frames = audio.reshape(b, t // cfg.hop_length, cfg.hop_length).to(dtype)
        x = nn.dot_f32(frames, enc["patch_embed"]).to(dtype) + enc["patch_bias"]
    x = _transformer(x, enc["blocks"], cfg)
    x = _norm(x, enc["out_norm"], enc.get("out_norm_b"), cfg)
    z_e = nn.dot_f32(x, enc["out_proj"])  # (B, F, d) f32
    if enc.get("out_proj_b") is not None:
        z_e = z_e + enc["out_proj_b"].to(torch.float32)
    return z_e


def encode_frames(
    params: Dict, audio: torch.Tensor, cfg: CodecConfig, tables: Optional[Dict] = None
) -> torch.Tensor:
    """audio (B, T) with T % hop == 0 -> codes (B, T/hop) int32."""
    b = audio.shape[0]
    z_e = encode_latents(params, audio, cfg)
    if tables is None:
        tables = quantizer_tables(params, cfg)
    codes = nearest_code_prepared(z_e.reshape(-1, z_e.shape[-1]), tables["cb_proj"], tables["halfnorm"])
    return codes.reshape(b, -1)


def decode_frames(
    params: Dict, codes: torch.Tensor, cfg: CodecConfig, tables: Optional[Dict] = None
) -> torch.Tensor:
    """codes (B, F) int -> audio (B, F*hop) float32."""
    dtype = cfg.dtype
    cb = tables["cb_proj"] if tables is not None else projected_codebook(params)
    z_q = cb[codes.long()]  # (B, F, d) f32
    dec = params["decoder"]
    x = nn.dot_f32(z_q.to(dtype), dec["in_proj"]).to(dtype) + dec["in_bias"]
    x = _transformer(x, dec["blocks"], cfg)
    x = _norm(x, dec["out_norm"], dec.get("out_norm_b"), cfg)
    if cfg.frontend == "conv":
        audio = _conv_upsample(dec["conv"]["stages"], x, tuple(reversed(cfg.conv_ratios)))
        return audio.to(torch.float32)[..., 0]
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

    @classmethod
    def load(cls, path: str, config: Optional[CodecConfig] = None, device="cuda") -> "TorchCodecModel":
        """A codec checkpoint on ``device``: a ``.npz`` (either package's
        models/convert.save_codec_checkpoint; its config wins), a directory
        holding ``codec.npz``, or a torch ``.pt`` / ``.bin`` / ``.pth``
        MagiCodec-layout state dict (a ``"state_dict"`` entry is unwrapped;
        converted under ``config``, default ``CodecConfig()``). A missing
        file raises FileNotFoundError, an unknown suffix ValueError: never
        random weights."""
        from . import convert

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchCodecModel.load(device='cuda'): no CUDA device is available")
        if os.path.isdir(path):
            npz = os.path.join(path, "codec.npz")
            if not os.path.exists(npz):
                raise FileNotFoundError(f"no codec.npz in checkpoint dir {path}")
            path = npz
        if not os.path.exists(path):
            raise FileNotFoundError(f"codec checkpoint not found: {path}")
        if path.endswith(".npz"):
            params, cfg = convert.load_codec_checkpoint(path, device=device)
            return cls(params, cfg, device)
        if path.endswith((".pt", ".bin", ".pth")):
            state_dict = torch.load(path, map_location="cpu", weights_only=True)
            if isinstance(state_dict, dict) and "state_dict" in state_dict:
                state_dict = state_dict["state_dict"]
            cfg = config or CodecConfig()
            return cls(convert.codec_params_from_torch(state_dict, cfg, device=device), cfg, device)
        raise ValueError(f"unrecognized codec checkpoint format: {path}")

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
