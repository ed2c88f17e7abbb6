"""Codec codes <-> unicode characters, channel interleaving, framing vocabulary.

TPU-native rebuild of the reference's ``codec_bpe`` conversion layer
(reference: realtime_codec_agent/audio_tokenizer.py:7, 89-96, 116-127;
codec_bpe.core.converter semantics). A codec code ``c`` emitted by codebook
``b`` maps to the single unicode character ``chr(unicode_offset + b * codebook_size + c)``
so that discrete audio can live inside an ordinary LM tokenizer vocabulary.

All functions here are pure host-side code (numpy / str); the hot corpus-scale
paths are vectorized with numpy instead of Python loops.
"""
from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np

# Default offsets (mirrors codec_bpe UNICODE_OFFSET / UNICODE_OFFSET_LARGE;
# the reference passes UNICODE_OFFSET_LARGE = 0xE000, the private use area,
# in audio_tokenizer.py:16 and prep_lm_dataset_magicodec.sh:4).
UNICODE_OFFSET = 0x4E00
UNICODE_OFFSET_LARGE = 0xE000


def codes_to_chars(
    codes: Union[np.ndarray, List[int]],
    codebook_size: int,
    unicode_offset: int = UNICODE_OFFSET_LARGE,
) -> str:
    """Convert codec codes to a unicode string.

    ``codes`` may be 1-D ``(T,)`` (single codebook) or 2-D ``(num_codebooks, T)``;
    for 2-D input frames are flattened frame-major (codebook-interleaved within a
    frame), with each codebook ``b`` offset by ``b * codebook_size``.
    """
    codes = np.asarray(codes)
    if codes.ndim == 1:
        codes = codes[None, :]
    if codes.ndim != 2:
        raise ValueError(f"codes must be 1-D or 2-D, got shape {codes.shape}")
    num_codebooks = codes.shape[0]
    offsets = (np.arange(num_codebooks, dtype=np.int64) * codebook_size)[:, None]
    flat = (codes.astype(np.int64) + offsets + unicode_offset).T.reshape(-1)
    # np.int32 view trick: build the string via ucs4 buffer for speed
    return flat.astype(np.uint32).tobytes().decode("utf-32-le")


def chars_to_codes(
    chars: str,
    num_codebooks: int,
    codebook_size: int,
    unicode_offset: int = UNICODE_OFFSET_LARGE,
    return_numpy: bool = True,
) -> Union[np.ndarray, List[int]]:
    """Convert a unicode code string back to codec codes ``(num_codebooks, T)``."""
    ords = np.frombuffer(chars.encode("utf-32-le"), dtype=np.uint32).astype(np.int64)
    ords = ords - unicode_offset
    if ords.size % num_codebooks != 0:
        ords = ords[: ords.size - ords.size % num_codebooks]
    codes = ords.reshape(-1, num_codebooks).T
    codes = codes - (np.arange(num_codebooks, dtype=np.int64) * codebook_size)[:, None]
    if return_numpy:
        return codes
    return codes.tolist()


def interleave_channels(channel_strs: List[str]) -> str:
    """Round-robin interleave per-frame code characters from each channel.

    Mirrors ``"".join(itertools.chain.from_iterable(zip(*channels_chars)))``
    (reference audio_tokenizer.py:96): truncates to the shortest channel.
    """
    if len(channel_strs) == 1:
        return channel_strs[0]
    n = min(len(s) for s in channel_strs)
    arrs = [np.frombuffer(s[:n].encode("utf-32-le"), dtype=np.uint32) for s in channel_strs]
    stacked = np.stack(arrs, axis=1).reshape(-1)
    return stacked.tobytes().decode("utf-32-le")


def deinterleave_channels(codes_str: str, num_channels: int) -> List[str]:
    """Split a frame-interleaved code string into per-channel strings
    (reference audio_tokenizer.py:116: ``detokenize_context[i::num_channels]``)."""
    return [codes_str[i::num_channels] for i in range(num_channels)]


def drop_hanging_channel_codes(audio_str: str, num_channels: int) -> Tuple[str, str]:
    """Trim the string so its length is divisible by num_channels.

    Returns ``(trimmed, end_hanging)``. NOTE: the reference implementation
    (audio_tokenizer.py:161-168) assigns ``end_hanging`` *after* trimming, so
    ``end_hanging`` holds the tail of the *trimmed* string; we reproduce the
    reference behavior bit-for-bit since downstream code was built around it.
    """
    div_rem = len(audio_str) % num_channels
    if div_rem != 0:
        audio_str = audio_str[:-div_rem]
        end_hanging = audio_str[-div_rem:]
    else:
        end_hanging = ""
    return audio_str, end_hanging


def is_audio_code(char: str, unicode_offset: int = UNICODE_OFFSET_LARGE) -> bool:
    """True if the character encodes a codec code (reference lm_dataset_builder.py:287-288)."""
    return ord(char) >= unicode_offset


def audio_code_positions(codes_str: str, unicode_offset: int = UNICODE_OFFSET_LARGE) -> Tuple[np.ndarray, str]:
    """Positions and concatenation of all audio-code chars in a mixed string
    (reference lm_dataset_builder.py:281-285)."""
    ords = np.frombuffer(codes_str.encode("utf-32-le"), dtype=np.uint32)
    audio_idx = np.where(ords >= unicode_offset)[0]
    audio_str = ords[audio_idx].tobytes().decode("utf-32-le")
    return audio_idx, audio_str
