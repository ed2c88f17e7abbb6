"""Streaming audio <-> unicode-codes bridge on the PyTorch codec.

Port of realtime_codec_agent_tpu/audio_tokenizer.py. With
``fixed_context=True`` (the default) the 2 s rolling encode context starts
as silence and the decode context as encoded-silence codes;
``fixed_context=False`` is the reference's legacy context, which grows from
empty (both give the same codes once the context is full). Also:
hanging-code handling, preroll, and the framerate probe (encode
``framerate_probe_secs`` of silence, default the context's length, and
count frames). The agent's reset, and its chunk path when it runs without
a fused session, go through it.

``codec_model`` is a ``TorchCodecModel``, a checkpoint path (loaded with
``codec_config`` through ``TorchCodecModel.load`` on ``device``), or None
(random weights from ``seed`` on ``device``).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .units.codes import (
    UNICODE_OFFSET_LARGE,
    chars_to_codes,
    codes_to_chars,
    deinterleave_channels,
    drop_hanging_channel_codes,
    interleave_channels,
)
from .utils.audio_utils import prep_audio

from .models.codec import CodecConfig, TorchCodecModel


class AudioTokenizer:
    def __init__(
        self,
        codec_model: Union[str, TorchCodecModel, None] = None,
        num_channels: int = 1,
        context_secs: float = 2.0,
        unicode_offset: int = UNICODE_OFFSET_LARGE,
        codec_config: Optional[CodecConfig] = None,
        fixed_context: bool = True,
        framerate_probe_secs: Optional[float] = None,
        seed: int = 0,
        device="cuda",
    ):
        if isinstance(codec_model, TorchCodecModel):
            self.codec_model = codec_model
        elif isinstance(codec_model, str):
            # a checkpoint path; a missing or malformed checkpoint raises
            self.codec_model = TorchCodecModel.load(codec_model, config=codec_config, device=device)
        elif codec_model is None:
            if torch.device(device).type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("AudioTokenizer(device='cuda'): no CUDA device is available")
            self.codec_model = TorchCodecModel.random_init(codec_config, seed=seed, device=device)
        else:
            raise TypeError(f"Unsupported codec_model: {type(codec_model)}")
        self.num_channels = num_channels
        self.num_codebooks = 1
        self.codebook_size = self.codec_model.codebook_size
        self.context_secs = context_secs
        self.unicode_offset = unicode_offset
        self.fixed_context = fixed_context

        self.sampling_rate = self.codec_model.sample_rate
        self.framerate_probe_secs = framerate_probe_secs if framerate_probe_secs is not None else context_secs
        self.framerate = self._compute_framerate()

        self.context_samples = int(self.context_secs * self.sampling_rate)
        self.context_frames = int(self.context_secs * self.framerate * self.num_channels)

        if fixed_context:
            # silence fill for the decode context: codes of encoded silence
            silence_codes = self._encode_silence(self.context_secs)[0, 0]
            ch_chars = codes_to_chars(
                silence_codes[None, :], self.codebook_size, unicode_offset=self.unicode_offset
            )
            self._silence_context_str = interleave_channels([ch_chars] * self.num_channels)

        self.reset_context()

    # -- context management -------------------------------------------------
    def reset_context(self):
        if self.fixed_context:
            self.tokenize_context = np.zeros((self.num_channels, self.context_samples), dtype=np.float32)
            self.detokenize_context = self._silence_context_str
        else:
            self.tokenize_context = np.zeros((self.num_channels, 0), dtype=np.float32)
            self.detokenize_context = ""

    def get_audio_codes_str_secs(self, audio_codes_str: str) -> float:
        return len(audio_codes_str) / (self.framerate * self.num_channels)

    # -- encode -------------------------------------------------------------
    def chunked_tokenize_audio(
        self, audio: Union[Tuple[int, np.ndarray], np.ndarray], chunk_size_secs: float
    ) -> str:
        if isinstance(audio, np.ndarray):
            sr = self.sampling_rate
        else:
            sr, audio = audio
        chunk_size_samples = int(chunk_size_secs * sr)
        parts: List[str] = []
        for start in range(0, audio.shape[-1], chunk_size_samples):
            chunk = audio[..., start : start + chunk_size_samples]
            parts.append(self.tokenize_audio((sr, chunk)))
        return "".join(parts)

    def tokenize_audio(self, audio: Union[Tuple[int, np.ndarray], np.ndarray]) -> str:
        audio = prep_audio(audio, self.sampling_rate, self.num_channels)
        audio = audio.reshape(self.num_channels, -1)

        # roll the context: keep the last max(len(chunk), context) samples
        self.tokenize_context = np.concatenate((self.tokenize_context, audio), axis=-1)
        self.tokenize_context = self.tokenize_context[
            ..., -max(audio.shape[-1], self.context_samples) :
        ]

        codes = self.codec_model.encode(self.tokenize_context)  # (C, F)

        if self.fixed_context and self.tokenize_context.shape[-1] > self.context_samples:
            # an oversize chunk blew past the window; restore the fixed shape
            self.tokenize_context = self.tokenize_context[..., -self.context_samples :]

        channels_chars = [
            codes_to_chars(ch[None, :], self.codebook_size, unicode_offset=self.unicode_offset)
            for ch in codes
        ]
        audio_codes_str = interleave_channels(channels_chars)

        # keep only the frames belonging to the new audio
        audio_secs = audio.shape[-1] / self.sampling_rate
        audio_frames = int(audio_secs * self.framerate * self.num_channels)
        return audio_codes_str[-audio_frames:]

    # -- decode -------------------------------------------------------------
    def detokenize_audio(
        self, audio_codes_str: str, preroll_samples: int = 0
    ) -> Tuple[Tuple[int, np.ndarray], str, int]:
        audio_codes_str, end_hanging = drop_hanging_channel_codes(
            audio_codes_str, self.num_channels
        )

        self.detokenize_context += audio_codes_str
        self.detokenize_context = self.detokenize_context[
            -max(len(audio_codes_str), self.context_frames) :
        ]

        channel_strs = deinterleave_channels(self.detokenize_context, self.num_channels)
        codes = np.stack(
            [
                chars_to_codes(
                    s, self.num_codebooks, self.codebook_size, unicode_offset=self.unicode_offset
                )[0]
                for s in channel_strs
            ]
        )  # (C, F)
        output_audio = self.codec_model.decode(codes)  # (C, F*hop)

        if self.fixed_context and len(self.detokenize_context) > self.context_frames:
            self.detokenize_context = self.detokenize_context[-self.context_frames :]

        # keep only the samples for the new codes (+preroll); 0 samples -- not
        # the whole context -- when there are no new codes
        audio_secs = self.get_audio_codes_str_secs(audio_codes_str)
        audio_samples = int(audio_secs * self.sampling_rate) + preroll_samples
        output_audio = output_audio[..., output_audio.shape[-1] - audio_samples :]
        preroll_samples = max(0, preroll_samples - audio_samples + output_audio.shape[-1])

        output_audio = output_audio[0] if self.num_channels == 1 else output_audio
        return (self.sampling_rate, output_audio), end_hanging, preroll_samples

    def get_codec_embeddings(self) -> np.ndarray:
        """Projected codebook (V, codebook_dim) f32: the LM embedding bridge
        table."""
        return self.codec_model.get_projected_codebook()

    # legacy-name passthrough used by clients/tests of the reference (and by
    # the agent's Whisper window)
    def _prep_audio_for_tokenization(self, audio) -> np.ndarray:
        return prep_audio(audio, self.sampling_rate, self.num_channels)

    # -- probes -------------------------------------------------------------
    def _encode_silence(self, secs: float) -> np.ndarray:
        audio = np.zeros((1, int(secs * self.sampling_rate)), dtype=np.float32)
        codes = self.codec_model.encode(audio)  # (1, F)
        return codes[:, None, :]  # (1, num_codebooks=1, F)

    def _compute_framerate(self) -> float:
        audio_codes = self._encode_silence(self.framerate_probe_secs)
        samples = int(self.framerate_probe_secs * self.sampling_rate)
        samples_per_frame = math.ceil(samples / audio_codes.shape[-1])
        return self.sampling_rate / samples_per_frame
