"""Whisper ASR (encoder-decoder) in PyTorch.

Port of realtime_codec_agent_tpu/models/whisper.py, with its names and its
parameter layout (the JAX pytree: (in, out) matrices, (k, in, out) conv
kernels), so ``models/from_jax.whisper_params_from_jax`` is a leaf map:

- **log-mel front end** -- a reflect-padded periodic-Hann STFT
  (``torch.fft.rfft`` over unfolded frames), |.|^2 without the last frame,
  the slaney mel filterbank, log10 with the floor at this window's max - 8,
  then (x + 4) / 4: HF ``WhisperFeatureExtractor`` semantics.
- **encoder** -- the two GELU convolutions (k 3, stride 1 then 2, pad 1) as
  im2col products, so they follow ``torch.backends.cuda.matmul.allow_tf32``
  (False by default: f32 stays f32 on the card) and not cuDNN's TF32 flag;
  sinusoidal positions sliced to the window; the pre-LN transformer.
- **decoder** -- greedy decode with a preallocated self-attention cache of
  ``n_start + max_new_tokens`` and cross K/V computed once per utterance.
  The loop runs all ``max_new_tokens`` steps with a device-side ``done``
  flag (the JAX package runs one device ``while_loop``): no host read per
  token, one read of the ids at the end.

The JAX package computes Whisper's attention and GEMMs with einsums and
``jnp.dot`` outside any Pallas kernel, so here they are plain matmuls and
softmax. Numerics follow the JAX graph: exact GELU, LayerNorm in f32 with
eps 1e-5, the mask value -1e30, q scaled by head_dim**-0.5 after its bias, no
k bias, logits ``x @ embed_tokens.T`` in f32. ``TorchWhisperModel`` runs on
the card unless the caller asks for the CPU, and raises where no CUDA device
is present. This module sets no global flag.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.staging import to_device
from ..utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51864          # *.en models
    d_model: int = 768               # small
    encoder_layers: int = 12
    decoder_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    num_mel_bins: int = 80
    max_source_positions: int = 1500  # 3000 mel frames / conv stride 2
    max_target_positions: int = 448
    sample_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    # greedy-decode control tokens (HF generation_config for *.en models)
    decoder_start_token_id: int = 50257  # <|startoftranscript|>
    eos_token_id: int = 50256            # <|endoftext|>
    no_timestamps_token_id: int = 50362  # <|notimestamps|>
    compute_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def n_audio_samples(self) -> int:
        return self.max_source_positions * 2 * self.hop_length  # 30 s at defaults

    @property
    def n_mel_frames(self) -> int:
        return self.max_source_positions * 2

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def whisper_small_en_config(**overrides) -> WhisperConfig:
    return WhisperConfig(**overrides)


def tiny_whisper_config(**overrides) -> WhisperConfig:
    defaults = dict(
        vocab_size=256, d_model=64, encoder_layers=2, decoder_layers=2,
        num_heads=2, ffn_dim=128, num_mel_bins=8, max_source_positions=32,
        max_target_positions=24, decoder_start_token_id=250, eos_token_id=251,
        no_timestamps_token_id=252,
    )
    defaults.update(overrides)
    return WhisperConfig(**defaults)


def whisper_config_from_hf(hf_config, **overrides) -> WhisperConfig:
    """Map a transformers.WhisperConfig to this geometry."""
    gen = dict(
        decoder_start_token_id=hf_config.decoder_start_token_id,
        eos_token_id=hf_config.eos_token_id,
    )
    gen.update(overrides)
    return WhisperConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.d_model,
        encoder_layers=hf_config.encoder_layers,
        decoder_layers=hf_config.decoder_layers,
        num_heads=hf_config.encoder_attention_heads,
        ffn_dim=hf_config.encoder_ffn_dim,
        num_mel_bins=hf_config.num_mel_bins,
        max_source_positions=hf_config.max_source_positions,
        max_target_positions=hf_config.max_target_positions,
        **gen,
    )


def _require_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"Whisper on {device}: no CUDA device is available")
    return device


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal positions (openai/whisper audio.py)."""
    log_timescale_increment = math.log(10000) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1)


def init_whisper_params(generator: torch.Generator, cfg: WhisperConfig, device="cuda") -> Dict:
    """Random init of the whole param tree on ``device`` from one seeded
    generator (which must live on ``device``), with the JAX package's
    distributions; the draws are not JAX's."""
    device = _require_device(device)
    dtype = cfg.dtype
    d, f = cfg.d_model, cfg.ffn_dim

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=device, dtype=torch.float32) * scale).to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    def ln():
        return {"w": torch.ones((d,), dtype=dtype, device=device), "b": zeros(d)}

    def attn():
        s = 1.0 / math.sqrt(d)
        # (in, out) layout; k_proj has no bias in Whisper
        return {"wq": normal((d, d), s), "bq": zeros(d), "wk": normal((d, d), s),
                "wv": normal((d, d), s), "bv": zeros(d), "wo": normal((d, d), s), "bo": zeros(d)}

    def mlp():
        return {"w1": normal((d, f), 1.0 / math.sqrt(d)), "b1": zeros(f),
                "w2": normal((f, d), 1.0 / math.sqrt(f)), "b2": zeros(d)}

    enc_layers = [{"attn_ln": ln(), "attn": attn(), "mlp_ln": ln(), "mlp": mlp()}
                  for _ in range(cfg.encoder_layers)]
    dec_layers = [{"attn_ln": ln(), "attn": attn(), "cross_ln": ln(), "cross": attn(), "mlp_ln": ln(), "mlp": mlp()}
                  for _ in range(cfg.decoder_layers)]
    return {
        "encoder": {
            "conv1_w": normal((3, cfg.num_mel_bins, d), 1.0 / math.sqrt(3 * cfg.num_mel_bins)),
            "conv1_b": zeros(d),
            "conv2_w": normal((3, d, d), 1.0 / math.sqrt(3 * d)),
            "conv2_b": zeros(d),
            "pos": torch.as_tensor(_sinusoids(cfg.max_source_positions, d), dtype=dtype).to(device),
            "layers": enc_layers,
            "final_ln": ln(),
        },
        "decoder": {
            "embed_tokens": normal((cfg.vocab_size, d), 0.02),
            "pos": normal((cfg.max_target_positions, d), 0.02),
            "layers": dec_layers,
            "final_ln": ln(),
        },
    }


def whisper_params_from_torch(state_dict, cfg: WhisperConfig) -> Dict:
    """HF WhisperForConditionalGeneration state_dict -> param tree (f32, on
    the state dict's device). torch Linear stores (out, in); this graph uses
    (in, out), so every weight transposes. Conv1d stores (out, in, k) ->
    (k, in, out)."""

    def t(name):
        return state_dict[name].detach().float()

    def w(prefix):
        return t(f"{prefix}.weight").T.contiguous()

    def attn(prefix):
        return {
            "wq": w(f"{prefix}.q_proj"), "bq": t(f"{prefix}.q_proj.bias"),
            "wk": w(f"{prefix}.k_proj"),
            "wv": w(f"{prefix}.v_proj"), "bv": t(f"{prefix}.v_proj.bias"),
            "wo": w(f"{prefix}.out_proj"), "bo": t(f"{prefix}.out_proj.bias"),
        }

    def ln(prefix):
        return {"w": t(f"{prefix}.weight"), "b": t(f"{prefix}.bias")}

    def mlp(prefix):
        return {"w1": w(f"{prefix}.fc1"), "b1": t(f"{prefix}.fc1.bias"),
                "w2": w(f"{prefix}.fc2"), "b2": t(f"{prefix}.fc2.bias")}

    enc_layers = []
    for i in range(cfg.encoder_layers):
        p = f"model.encoder.layers.{i}"
        enc_layers.append({"attn_ln": ln(f"{p}.self_attn_layer_norm"), "attn": attn(f"{p}.self_attn"),
                           "mlp_ln": ln(f"{p}.final_layer_norm"), "mlp": mlp(p)})
    dec_layers = []
    for i in range(cfg.decoder_layers):
        p = f"model.decoder.layers.{i}"
        dec_layers.append({"attn_ln": ln(f"{p}.self_attn_layer_norm"), "attn": attn(f"{p}.self_attn"),
                           "cross_ln": ln(f"{p}.encoder_attn_layer_norm"), "cross": attn(f"{p}.encoder_attn"),
                           "mlp_ln": ln(f"{p}.final_layer_norm"), "mlp": mlp(p)})
    return {
        "encoder": {
            "conv1_w": t("model.encoder.conv1.weight").permute(2, 1, 0).contiguous(),
            "conv1_b": t("model.encoder.conv1.bias"),
            "conv2_w": t("model.encoder.conv2.weight").permute(2, 1, 0).contiguous(),
            "conv2_b": t("model.encoder.conv2.bias"),
            "pos": t("model.encoder.embed_positions.weight"),
            "layers": enc_layers,
            "final_ln": ln("model.encoder.layer_norm"),
        },
        "decoder": {
            "embed_tokens": t("model.decoder.embed_tokens.weight"),
            "pos": t("model.decoder.embed_positions.weight"),
            "layers": dec_layers,
            "final_ln": ln("model.decoder.layer_norm"),
        },
    }


# ---------------------------------------------------------------------------
# Log-mel frontend (WhisperFeatureExtractor semantics)
# ---------------------------------------------------------------------------

def slaney_mel_filters(
    sample_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: Optional[float] = None
) -> np.ndarray:
    """Slaney-style mel filterbank, (1 + n_fft//2, n_mels), slaney-normalized —
    identical to transformers.audio_utils.mel_filter_bank(norm="slaney",
    mel_scale="slaney") used by WhisperFeatureExtractor."""
    if fmax is None:
        fmax = sample_rate / 2.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        mels = 3.0 * f / 200.0
        log_region = f >= 1000.0
        mels = np.where(
            log_region, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) * (27.0 / np.log(6.4)), mels
        )
        return mels

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f = 200.0 * m / 3.0
        log_region = m >= 15.0
        f = np.where(log_region, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), f)
        return f

    n_freqs = 1 + n_fft // 2
    fft_freqs = np.linspace(0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[None, :] - fft_freqs[:, None]  # (n_freqs, n_mels+2)
    lower = -ramps[:, :-2] / fdiff[None, :-1]
    upper = ramps[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    # slaney normalization: scale each filter to unit area
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    fb = fb * enorm[None, :]
    return fb.astype(np.float32)


def log_mel_spectrogram(audio: torch.Tensor, mel_filters: torch.Tensor, cfg: WhisperConfig) -> torch.Tensor:
    """audio (n_samples,) f32 (already padded/trimmed to the window) ->
    (n_mels, n_frames) log-mel: centered periodic-Hann STFT, |.|^2 without
    the last frame, mel, log10 clamp, this window's max - 8 floor, (x+4)/4."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    window = torch.from_numpy(np.hanning(n_fft + 1)[:-1].astype(np.float32)).to(audio.device)
    padded = F.pad(audio.float().view(1, 1, -1), (n_fft // 2, n_fft // 2), mode="reflect").view(-1)
    frames = padded.unfold(0, n_fft, hop) * window  # (n_frames, n_fft)
    mag = torch.fft.rfft(frames, dim=-1).abs() ** 2  # (n_frames, n_freqs)
    mag = mag[:-1]  # HF drops the final frame
    mel = mag @ mel_filters  # (n_frames-1, n_mels)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.T  # (n_mels, n_frames)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _layer_norm(x: torch.Tensor, ln: Dict, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32, one fused launch (the decoder's steps are bound by
    the host's launches)."""
    return F.layer_norm(x.float(), (x.shape[-1],), ln["w"].float(), ln["b"].float(), eps).to(x.dtype)


def _mha(q, k, v, nh: int, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,Tq,D), k/v (B,Tk,D) already projected; returns (B,Tq,D). The
    1/sqrt(head_dim) scale is applied by the caller on q (HF semantics)."""
    b, tq, d = q.shape
    tk = k.shape[1]
    dh = d // nh
    qh = q.reshape(b, tq, nh, dh).transpose(1, 2).float()
    kh = k.reshape(b, tk, nh, dh).transpose(1, 2).float()
    vh = v.reshape(b, tk, nh, dh).transpose(1, 2)
    scores = qh @ kh.transpose(-1, -2)  # (B, H, Tq, Tk) f32
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = (probs.to(vh.dtype).float() @ vh.float()).to(q.dtype)
    return out.transpose(1, 2).reshape(b, tq, d)


def _self_attn(x, p, nh: int, scale: float, mask=None):
    q = (x @ p["wq"] + p["bq"]) * scale
    k = x @ p["wk"]
    v = x @ p["wv"] + p["bv"]
    return _mha(q, k, v, nh, mask=mask) @ p["wo"] + p["bo"]


def _mlp(x, p):
    h = F.gelu(x @ p["w1"] + p["b1"], approximate="none")
    return h @ p["w2"] + p["b2"]


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """k=3, pad 1 convolution of x (B, T, C_in) with w (3, C_in, C_out) as one
    im2col product: the columns (B, T_out, 3 * C_in), k-major, times
    w.reshape(3 * C_in, C_out)."""
    k, c_in, c_out = w.shape
    xp = F.pad(x, (0, 0, 1, 1))  # pad time by 1 on both sides
    cols = xp.unfold(1, k, stride)  # (B, T_out, C_in, k)
    cols = cols.permute(0, 1, 3, 2).reshape(x.shape[0], cols.shape[1], k * c_in)
    return cols @ w.reshape(k * c_in, c_out) + b


def encode(params: Dict, mel: torch.Tensor, cfg: WhisperConfig) -> torch.Tensor:
    """mel (B, n_mels, n_frames) -> encoder states (B, n_frames // 2, D)."""
    enc = params["encoder"]
    scale = cfg.head_dim ** -0.5
    x = mel.transpose(1, 2).to(cfg.dtype)  # (B, frames, n_mels)
    x = F.gelu(_conv1d(x, enc["conv1_w"], enc["conv1_b"], 1), approximate="none")
    x = F.gelu(_conv1d(x, enc["conv2_w"], enc["conv2_b"], 2), approximate="none")
    x = x + enc["pos"][None, : x.shape[1]]
    for blk in enc["layers"]:
        x = x + _self_attn(_layer_norm(x, blk["attn_ln"]), blk["attn"], cfg.num_heads, scale)
        x = x + _mlp(_layer_norm(x, blk["mlp_ln"]), blk["mlp"])
    return _layer_norm(x, enc["final_ln"])


def cross_kv(params: Dict, enc_states: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer cross-attention K/V, once per utterance: (L, B, T_src, D) x2."""
    ks, vs = [], []
    for blk in params["decoder"]["layers"]:
        p = blk["cross"]
        ks.append(enc_states @ p["wk"])
        vs.append(enc_states @ p["wv"] + p["bv"])
    return torch.stack(ks), torch.stack(vs)


def decode_step(
    params: Dict,
    ids: torch.Tensor,           # (B, T) new tokens
    positions: torch.Tensor,     # (T,) absolute target positions
    self_k: torch.Tensor,        # (L, B, S, D) self-attn cache, written in place
    self_v: torch.Tensor,
    cache_len: int,              # valid cache entries (a host int)
    ck: torch.Tensor,            # (L, B, T_src, D) cross K
    cv: torch.Tensor,
    cfg: WhisperConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Teacher-forced step over T new tokens against the cached prefix; their
    K/V land at cache positions [cache_len, cache_len + T). Returns (logits
    (B, T, V) f32, self_k, self_v)."""
    dec = params["decoder"]
    scale = cfg.head_dim ** -0.5
    t = ids.shape[1]
    s = self_k.shape[2]
    x = dec["embed_tokens"][ids] + dec["pos"][positions][None]
    key_pos = torch.arange(s, device=ids.device)[None, :]
    # causal over (cache ++ self): cache index i holds position i
    mask = ((key_pos <= positions[:, None]) & (key_pos < cache_len + t))[None, None]
    for li, blk in enumerate(dec["layers"]):
        p = blk["attn"]
        y = _layer_norm(x, blk["attn_ln"])
        q = (y @ p["wq"] + p["bq"]) * scale
        self_k[li, :, cache_len : cache_len + t] = y @ p["wk"]
        self_v[li, :, cache_len : cache_len + t] = y @ p["wv"] + p["bv"]
        x = x + (_mha(q, self_k[li], self_v[li], cfg.num_heads, mask=mask) @ p["wo"] + p["bo"])
        cp = blk["cross"]
        y = _layer_norm(x, blk["cross_ln"])
        cq = (y @ cp["wq"] + cp["bq"]) * scale
        x = x + (_mha(cq, ck[li], cv[li], cfg.num_heads) @ cp["wo"] + cp["bo"])
        x = x + _mlp(_layer_norm(x, blk["mlp_ln"]), blk["mlp"])
    x = _layer_norm(x, dec["final_ln"])
    logits = x.float() @ dec["embed_tokens"].float().T
    return logits, self_k, self_v


def greedy_decode(
    params: Dict,
    enc_states: torch.Tensor,    # (B=1, T_src, D)
    start_ids: torch.Tensor,     # (n_start,) forced prompt (sot, [notimestamps], ...)
    cfg: WhisperConfig,
    max_new_tokens: int,
    suppress_ids: Optional[torch.Tensor] = None,  # (n_sup,) never picked
    begin_suppress_ids: Optional[torch.Tensor] = None,  # masked at the first pick only
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode on the device. Returns (tokens (max_new_tokens,) padded
    with eos, n_generated as a 0-dim tensor), JAX's result: the loop always
    runs ``max_new_tokens - 1`` steps, and once eos is picked a device flag
    pins every later id to eos (no host read per token)."""
    n_start = int(start_ids.shape[0])
    dec_cap = n_start + max_new_tokens
    if dec_cap > cfg.max_target_positions:
        raise ValueError(
            f"start+max_new={dec_cap} exceeds max_target_positions={cfg.max_target_positions}"
        )
    dev = enc_states.device
    eos = cfg.eos_token_id
    ck, cv = cross_kv(params, enc_states)
    cache_shape = (cfg.decoder_layers, enc_states.shape[0], dec_cap, cfg.d_model)
    self_k = torch.zeros(cache_shape, dtype=cfg.dtype, device=dev)
    self_v = torch.zeros(cache_shape, dtype=cfg.dtype, device=dev)
    all_pos = torch.arange(dec_cap, device=dev)

    def pick(row, first=False):
        row = row.clone()
        if suppress_ids is not None and suppress_ids.numel() > 0:
            row[suppress_ids] = -torch.inf
        if first and begin_suppress_ids is not None and begin_suppress_ids.numel() > 0:
            row[begin_suppress_ids] = -torch.inf
        return torch.argmax(row)

    logits, _, _ = decode_step(params, start_ids[None], all_pos[:n_start], self_k, self_v, 0, ck, cv, cfg)
    tok = pick(logits[0, -1], first=True)
    out = torch.full((max_new_tokens,), eos, dtype=torch.int64, device=dev)
    out[0] = tok
    done = tok == eos
    for i in range(1, max_new_tokens):
        p = n_start + i - 1
        logits, _, _ = decode_step(params, tok.view(1, 1), all_pos[p : p + 1], self_k, self_v, p, ck, cv, cfg)
        tok = torch.where(done, eos, pick(logits[0, -1]))
        out[i] = tok
        done = done | (tok == eos)
    # every id before the first eos is not eos, every id after it is
    return out, (out != eos).sum()


class TorchWhisperModel:
    """Params + config with the mel / encode / greedy pipeline on one device.

    ``transcribe_ids(audio)`` pads or trims to a window bucket, computes the
    log-mel, encodes and decodes greedily, and returns raw token ids; text
    needs a tokenizer (agent/asr.TorchWhisperASR). ``device`` defaults to the
    card; the params are moved there."""

    def __init__(
        self,
        params: Dict,
        config: WhisperConfig,
        max_new_tokens: int = 128,
        suppress_ids: Optional[List[int]] = None,
        begin_suppress_ids: Optional[List[int]] = None,
        window_secs: Optional[List[float]] = None,
        device="cuda",
    ):
        self.device = _require_device(device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.config = config
        self.max_new_tokens = max_new_tokens
        # the checkpoint generation_config's lists (HF applies them in
        # generate; without them transcripts can contain non-speech artifacts)
        self.default_suppress_ids = list(suppress_ids or [])
        self.default_begin_suppress_ids = list(begin_suppress_ids or [])
        # Bucketed encoder windows: audio pads to the smallest bucket that
        # holds it, and the encoder's positions slice to that length; above
        # the largest bucket, the canonical full window. None = always the
        # full window (the reference's whisper.cpp behavior).
        if window_secs is not None:
            self.window_samples = [
                min(int(w * config.sample_rate), config.n_audio_samples) for w in sorted(window_secs)
            ]
            if self.window_samples[-1] < config.n_audio_samples:
                self.window_samples.append(config.n_audio_samples)
        else:
            self.window_samples = [config.n_audio_samples]
        self.mel_filters = torch.from_numpy(
            slaney_mel_filters(
                config.sample_rate, config.n_fft, config.num_mel_bins,
                fmax=min(8000.0, config.sample_rate / 2.0),
            )
        ).to(self.device)
        self._begin_suppress = to_device(np.asarray(self.default_begin_suppress_ids, np.int64), self.device)

    @classmethod
    def from_hf(
        cls, hf_model, max_new_tokens: int = 128, window_secs: Optional[List[float]] = None,
        device="cuda", **config_overrides,
    ) -> "TorchWhisperModel":
        """Convert a transformers WhisperForConditionalGeneration instance,
        carrying over its generation_config's suppress / begin_suppress
        token lists."""
        cfg = whisper_config_from_hf(hf_model.config, **config_overrides)
        params = whisper_params_from_torch(hf_model.state_dict(), cfg)
        gen_cfg = getattr(hf_model, "generation_config", None)
        sup = list(getattr(gen_cfg, "suppress_tokens", None) or [])
        bsup = list(getattr(gen_cfg, "begin_suppress_tokens", None) or [])
        return cls(
            params, cfg, max_new_tokens=max_new_tokens, suppress_ids=sup,
            begin_suppress_ids=bsup, window_secs=window_secs, device=device,
        )

    def window_for(self, n_samples: int) -> int:
        """The bucket (in samples) that audio of ``n_samples`` pads to."""
        return next((w for w in self.window_samples if n_samples <= w), self.window_samples[-1])

    def features(self, audio: np.ndarray) -> torch.Tensor:
        """Pad/trim to the smallest window bucket and compute (1, n_mels,
        frames) on the device. With the default single full-size bucket this
        is the canonical 30 s pad."""
        audio = np.asarray(audio, dtype=np.float32).reshape(-1)
        n = self.window_for(audio.shape[0])
        if audio.shape[0] < n:
            audio = np.pad(audio, (0, n - audio.shape[0]))
        else:
            audio = audio[:n]
        return log_mel_spectrogram(to_device(audio, self.device), self.mel_filters, self.config)[None]

    @torch.no_grad()
    def transcribe_ids(
        self,
        audio: np.ndarray,
        start_ids: Optional[List[int]] = None,
        suppress_ids: Optional[List[int]] = None,
    ) -> List[int]:
        cfg = self.config
        if start_ids is None:
            start_ids = [cfg.decoder_start_token_id, cfg.no_timestamps_token_id]
        if suppress_ids is None:
            suppress_ids = self.default_suppress_ids
        enc_states = encode(self.params, self.features(audio), cfg)
        out, n_gen = greedy_decode(
            self.params, enc_states, to_device(np.asarray(start_ids, np.int64), self.device), cfg,
            self.max_new_tokens, suppress_ids=to_device(np.asarray(suppress_ids, np.int64), self.device),
            begin_suppress_ids=self._begin_suppress,
        )
        host = torch.cat([out, n_gen[None]]).cpu()  # the one read of the call
        return [int(t) for t in host[: int(host[-1])]]
