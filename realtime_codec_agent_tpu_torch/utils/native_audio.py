"""Streaming sample-rate conversion with a native C++ core.

The live input path receives 48 kHz WebRTC frames while the codec consumes
16 kHz. Resampling each 100 ms chunk independently (stateless
scipy.signal.resample_poly per chunk) re-runs the filter over zero-padded
chunk edges — an audible seam at every chunk boundary. ``StreamingResampler``
carries the polyphase filter history across chunks, so concatenated chunked
output equals one-shot output sample-exactly (interior region).

The compute core is the C++ extension ``rtca_native`` (native/rtca_audio.cpp,
built with ``cd native && python setup.py build_ext --inplace``); when it is
not built, an algorithm-identical numpy implementation runs instead — same
Kaiser-windowed-sinc polyphase design (scipy resample_poly's default filter),
same streaming semantics.
"""
from __future__ import annotations

import math
import os
import sys
from typing import Optional

import numpy as np


def _load_native():
    try:
        import rtca_native  # built in-place at repo root or installed

        return rtca_native
    except ImportError:
        pass
    native_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
    )
    if os.path.isdir(native_dir) and native_dir not in sys.path:
        sys.path.append(native_dir)
        try:
            import rtca_native

            return rtca_native
        except ImportError:
            pass
    return None


_NATIVE = _load_native()


def native_available() -> bool:
    return _NATIVE is not None


def _design_polyphase(up: int, down: int):
    """scipy resample_poly's default filter: 2*10*max(up,down) upsampled-domain
    taps per side, Kaiser beta 5, cutoff at the narrower Nyquist, gain up —
    decomposed phase-major (must mirror native/rtca_audio.cpp exactly)."""
    max_rate = max(up, down)
    half_len = 10 * max_rate
    n_taps = 2 * half_len + 1
    fc = 1.0 / max_rate
    beta = 5.0
    m = np.arange(n_taps) - half_len
    sinc = np.where(m == 0, fc, np.sin(np.pi * fc * m) / (np.pi * np.where(m == 0, 1, m)))
    r = m / half_len
    win = np.i0(beta * np.sqrt(np.clip(1.0 - r * r, 0.0, None))) / np.i0(beta)
    h = sinc * win * up
    taps_per_phase = (n_taps + up - 1) // up + 1
    filt = np.zeros((up, taps_per_phase), np.float64)
    for p in range(up):
        j = p + np.arange(taps_per_phase) * up
        valid = j < n_taps
        filt[p, valid] = h[j[valid]]
    return filt.astype(np.float32), half_len, taps_per_phase


class StreamingResampler:
    """Stateful chunked resampler: feed arbitrary-length float32 chunks with
    ``process``; ``flush`` drains the filter tail at end of stream."""

    def __init__(self, sr_in: int, sr_out: int):
        if sr_in <= 0 or sr_out <= 0:
            raise ValueError("sample rates must be positive")
        self.sr_in, self.sr_out = int(sr_in), int(sr_out)
        g = math.gcd(self.sr_in, self.sr_out)
        self.up, self.down = self.sr_out // g, self.sr_in // g
        if _NATIVE is not None:
            self._r = _NATIVE.resampler_new(self.sr_in, self.sr_out)
        else:
            self._r = None
            self._filt, self._half_len, self._tpp = _design_polyphase(self.up, self.down)
            self._hist = np.zeros(self._tpp - 1, np.float32)
            self._in_count = 0
            self._out_count = 0

    def process(self, chunk: np.ndarray) -> np.ndarray:
        chunk = np.ascontiguousarray(chunk, dtype=np.float32)
        if self._r is not None:
            out = _NATIVE.resampler_process(self._r, chunk.tobytes())
            return np.frombuffer(out, np.float32).copy()
        return self._process_py(chunk)

    def flush(self) -> np.ndarray:
        if self._r is not None:
            out = _NATIVE.resampler_flush(self._r)
            return np.frombuffer(out, np.float32).copy()
        return self._process_py(np.zeros(self._tpp, np.float32))

    # -- numpy fallback (same math as the C++ core) --------------------------
    def _process_py(self, chunk: np.ndarray) -> np.ndarray:
        up, down, half = self.up, self.down, self._half_len
        n = len(chunk)
        limit = ((self._in_count + n) * up - half + down - 1) // down
        n_out = max(0, limit - self._out_count)
        buf = np.concatenate([self._hist, chunk])
        base = self._in_count - len(self._hist)
        out = np.zeros(n_out, np.float32)
        if n_out:
            m = self._out_count + np.arange(n_out)
            u = m * down
            n0 = (u + half) // up
            phase = (u + half) % up
            # gather input windows (n_out, taps); clip pre-history to zeros
            idx = n0[:, None] - np.arange(self._tpp)[None, :] - base
            valid = idx >= 0
            idx = np.clip(idx, 0, len(buf) - 1)
            windows = np.where(valid, buf[idx], 0.0)
            out = np.einsum("ot,ot->o", windows, self._filt[phase]).astype(np.float32)
        self._out_count += n_out
        self._in_count += n
        keep = min(self._tpp - 1, len(buf))
        hist = buf[len(buf) - keep:]
        if keep < self._tpp - 1:
            hist = np.concatenate([np.zeros(self._tpp - 1 - keep, np.float32), hist])
        self._hist = hist.astype(np.float32)
        return out


def resample_streaming_oneshot(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """One-shot convenience over the streaming core, trimmed to the standard
    ceil(n*up/down) output length (resample_poly semantics)."""
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    r = StreamingResampler(sr_in, sr_out)
    out = np.concatenate([r.process(audio), r.flush()])
    n_expect = -(-audio.shape[-1] * r.up // r.down)
    return out[:n_expect]
