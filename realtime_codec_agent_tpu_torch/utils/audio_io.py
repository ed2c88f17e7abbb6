"""Minimal audio file IO without hard librosa/soundfile dependencies.

stdlib ``wave`` handles 16-bit PCM WAV natively; other formats use soundfile
or librosa when installed (gated). Write support targets the artifacts the
clients dump (stereo session WAVs, reference inference_client_fastrtc_v2.py:60-87).
"""
from __future__ import annotations

import os
import wave
from typing import Optional, Tuple

import numpy as np


def read_audio(path: str, mono: bool = False) -> Tuple[int, np.ndarray]:
    """Returns (sample_rate, float32 audio in [-1, 1]); (C, T) for multichannel."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        try:
            with wave.open(path, "rb") as w:
                sr = w.getframerate()
                ch = w.getnchannels()
                width = w.getsampwidth()
                frames = w.readframes(w.getnframes())
            if width == 2:
                data = np.frombuffer(frames, dtype=np.int16).astype(np.float32) / 32768.0
            elif width == 4:
                data = np.frombuffer(frames, dtype=np.int32).astype(np.float32) / 2147483648.0
            elif width == 1:
                data = (np.frombuffer(frames, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
            else:
                raise ValueError(f"unsupported WAV sample width {width}")
            if ch > 1:
                data = data.reshape(-1, ch).T
            if mono and data.ndim > 1:
                data = data.mean(axis=0)
            return sr, data
        except wave.Error:
            pass  # e.g. float WAV: fall through to soundfile/librosa
    # non-PCM-wav formats: gated backends
    try:
        import soundfile as sf

        data, sr = sf.read(path, dtype="float32", always_2d=False)
        if data.ndim > 1:
            data = data.T
        if mono and data.ndim > 1:
            data = data.mean(axis=0)
        return sr, data
    except ImportError:
        pass
    try:
        import librosa

        data, sr = librosa.load(path, sr=None, mono=mono)
        return sr, data
    except ImportError:
        raise RuntimeError(
            f"Cannot read {path}: stdlib wave failed and neither soundfile nor "
            "librosa is installed."
        )


def write_wav(path: str, sample_rate: int, audio: np.ndarray) -> None:
    """Write float32/-int16 audio ((T,) or (C, T)) as 16-bit PCM WAV."""
    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        # NaN survives np.clip and casts to garbage int16 (random-weight codec
        # output can be non-finite); zero it before quantizing
        audio = np.nan_to_num(audio, nan=0.0, posinf=1.0, neginf=-1.0)
        audio = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(1 if audio.ndim == 1 else audio.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(audio.T.tobytes() if audio.ndim > 1 else audio.tobytes())


def audio_duration_secs(path: str) -> Optional[float]:
    """Cheap duration probe (WAV header only; None if unknown format)."""
    if path.lower().endswith(".wav"):
        try:
            with wave.open(path, "rb") as w:
                return w.getnframes() / w.getframerate()
        except wave.Error:
            return None
    return None
