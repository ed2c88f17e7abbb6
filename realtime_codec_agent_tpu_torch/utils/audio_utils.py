"""Host-side audio utilities (crossfade, pad/trim, RMS normalization, resample).

Behavioral rebuild of reference realtime_codec_agent/utils/audio_utils.py:4-46
plus the resample/mono/int16 prep from audio_tokenizer.py:203-215 without the
librosa dependency (scipy.signal.resample_poly on host).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def create_crossfade_ramps(sr: int, fade_secs: float) -> Tuple[int, np.ndarray, np.ndarray]:
    """Equal-power sine crossfade ramps (reference audio_utils.py:19-23)."""
    L = int(sr * fade_secs)
    fade_in = np.sin(0.5 * np.pi * np.linspace(0, 1, L, endpoint=False, dtype=np.float32))
    fade_out = fade_in[::-1]
    return L, fade_in, fade_out


def smooth_join(
    chunk1: np.ndarray, chunk2: np.ndarray, L: int, fade_in: np.ndarray, fade_out: np.ndarray
) -> np.ndarray:
    """Crossfade-join two chunks over the L-sample boundary (reference audio_utils.py:4-17)."""
    if chunk1.shape[-1] == 0:
        return chunk2
    if L == 0:
        return np.concatenate((chunk1, chunk2), axis=-1)
    head1, tail1 = chunk1[..., :-L], chunk1[..., -L:]
    head2, tail2 = chunk2[..., :L], chunk2[..., L:]
    cross = tail1 * fade_out + head2 * fade_in
    return np.concatenate((head1, cross, tail2), axis=-1)


def pad_or_trim(chunk: np.ndarray, target_length: int, pad_side: str = "right") -> np.ndarray:
    """Zero-pad or trim a 1-D chunk to target_length (reference audio_utils.py:25-37)."""
    if chunk.ndim > 1:
        raise ValueError("Input chunk must be a 1D array.")
    if chunk.shape[-1] < target_length:
        pad_width = target_length - chunk.shape[-1]
        pad_width = (0, pad_width) if pad_side == "right" else (pad_width, 0)
        return np.pad(chunk, pad_width, mode="constant")
    elif chunk.shape[-1] > target_length:
        return chunk[..., :target_length]
    return chunk


def normalize_audio_rms(
    audio: np.ndarray, target_rms: float = 0.05, silence_rms_threshold: float = 0.003
) -> np.ndarray:
    """Scale audio to a target RMS unless it is near-silent (reference audio_utils.py:39-46)."""
    rms = np.sqrt(np.mean(audio**2))
    if rms < silence_rms_threshold:
        return audio
    return audio * (target_rms / rms)


def to_mono(audio: np.ndarray) -> np.ndarray:
    """Mix a (C, T) or (T, C) array down to mono (librosa.to_mono equivalent)."""
    if audio.ndim == 1:
        return audio
    if audio.ndim != 2:
        raise ValueError(f"audio must be 1-D or 2-D, got shape {audio.shape}")
    # librosa convention is (C, T); accept (T, C) heuristically when T >> C
    if audio.shape[0] > audio.shape[1]:
        audio = audio.T
    return np.mean(audio, axis=0)


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample along the last axis (librosa.resample equivalent).

    Uses the native C++ core (utils/native_audio.py) when built; falls back
    to scipy's resample_poly otherwise."""
    if orig_sr == target_sr:
        return audio
    from . import native_audio

    if native_audio.native_available():
        one = native_audio.resample_streaming_oneshot
        if audio.ndim == 1:
            return one(audio, int(orig_sr), int(target_sr))
        return np.stack([one(ch, int(orig_sr), int(target_sr)) for ch in audio])
    from scipy.signal import resample_poly

    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    return resample_poly(audio.astype(np.float32), up, down, axis=-1).astype(np.float32)


def prep_audio(
    audio,
    target_sr: int,
    num_channels: int = 1,
) -> np.ndarray:
    """Normalize input audio for tokenization (reference audio_tokenizer.py:203-215):
    int16 -> float32 / 32768, optional mono downmix, resample to codec rate.

    ``audio`` is either an ndarray at ``target_sr`` or a ``(sr, ndarray)`` tuple.
    """
    if isinstance(audio, np.ndarray):
        orig_sr = target_sr
    else:
        orig_sr, audio = audio
    if audio.dtype == np.int16:
        audio = audio.astype("float32") / 32768.0
    if num_channels == 1 and audio.ndim > 1:
        audio = to_mono(audio)
    if orig_sr != target_sr:
        audio = resample(audio, orig_sr=orig_sr, target_sr=target_sr)
    return audio
