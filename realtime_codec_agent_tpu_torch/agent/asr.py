"""Pluggable ASR for the user channel's external transcription.

Port of realtime_codec_agent_tpu/agent/asr.py: anything with
``transcribe(audio_f32_16k) -> str`` works. ``TorchWhisperASR`` runs the
port's Whisper (models/whisper.py) on the card beside the duplex LM;
``WhisperCppASR`` and ``TransformersWhisperASR`` are host backends a caller
builds and passes in as objects (their imports are lazy).

``load_asr`` differs from the JAX package's on purpose: a model name builds
``TorchWhisperASR`` on the requested device or raises with the reason. The
JAX package falls back quietly to whisper.cpp, then to HF on the CPU, then
to no ASR at all; here that would hide a missing card or checkpoint behind a
slower host backend.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


class ASRModel:
    """Interface: transcribe 16 kHz float32 mono audio to text."""

    def transcribe(self, audio: np.ndarray, temperature: float = 0.0) -> str:
        raise NotImplementedError


class WhisperCppASR(ASRModel):
    """whisper.cpp backend (greedy, single segment, no context — matching the
    reference's call, realtime_agent_v2.py:421-428)."""

    def __init__(self, model_name: str = "small.en"):
        from pywhispercpp.model import Model

        self._model = Model(model_name)

    def transcribe(self, audio: np.ndarray, temperature: float = 0.0) -> str:
        segments = self._model.transcribe(
            audio,
            temperature=temperature,
            language="en",
            no_context=True,
            single_segment=True,
            print_progress=False,
        )
        return " ".join(segment.text for segment in segments)


class TorchWhisperASR(ASRModel):
    """The port's Whisper: log-mel, encoder and greedy decode on the model's
    device (the card by default). Greedy, single segment, no context -- the
    reference's whisper.cpp call surface (realtime_agent_v2.py:421-428)."""

    def __init__(self, model, tokenizer):
        """model: models.whisper.TorchWhisperModel; tokenizer: anything with
        decode(ids, skip_special_tokens=True) over Whisper's vocab."""
        self._model = model
        self._tokenizer = tokenizer

    @property
    def model(self):
        return self._model

    @classmethod
    def from_hf_checkpoint(
        cls,
        model_name_or_path: str,
        local_files_only: bool = True,
        max_new_tokens: int = 128,
        window_secs=None,
        device="cuda",
    ) -> "TorchWhisperASR":
        """Build from a local HF Whisper checkpoint (a directory, or a hub id
        already in the local cache), converted once at load. ``window_secs``
        (e.g. [5, 10, 30]) pads short audio to the smallest bucket instead of
        the canonical 30 s. Needs ``transformers``, imported here only."""
        from transformers import WhisperForConditionalGeneration, WhisperTokenizer

        from ..models.whisper import TorchWhisperModel, _require_device

        _require_device(device)  # before the weights are read
        if local_files_only and not os.path.isdir(model_name_or_path):
            from huggingface_hub import try_to_load_from_cache

            if not isinstance(try_to_load_from_cache(model_name_or_path, "config.json"), str):
                raise FileNotFoundError(f"{model_name_or_path}: no local checkpoint (local_files_only)")
        hf_model = WhisperForConditionalGeneration.from_pretrained(
            model_name_or_path, local_files_only=local_files_only
        )
        tokenizer = WhisperTokenizer.from_pretrained(model_name_or_path, local_files_only=local_files_only)
        return cls(
            TorchWhisperModel.from_hf(hf_model, max_new_tokens=max_new_tokens, window_secs=window_secs,
                                      device=device),
            tokenizer,
        )

    def transcribe(self, audio: np.ndarray, temperature: float = 0.0) -> str:
        # greedy regardless of temperature (the reference calls whisper.cpp
        # with temperature=0.0)
        ids = self._model.transcribe_ids(np.asarray(audio, dtype=np.float32))
        return self._tokenizer.decode(ids, skip_special_tokens=True).strip()


class TransformersWhisperASR(ASRModel):
    """HF Whisper backend on the host CPU: loads a local checkpoint directory
    or hub id via WhisperForConditionalGeneration. Greedy single-segment
    decoding matches the reference whisper.cpp call surface
    (realtime_agent_v2.py:421-428)."""

    def __init__(
        self,
        model_name_or_path: str = None,
        model=None,
        processor=None,
        local_files_only: bool = True,
    ):
        import torch

        if model is None or processor is None:
            from transformers import WhisperForConditionalGeneration, WhisperProcessor

            # local_files_only by default: a hub fetch with network timeouts
            # inside realtime-agent startup would stall the session; pass
            # False explicitly to allow downloading
            model = WhisperForConditionalGeneration.from_pretrained(
                model_name_or_path, local_files_only=local_files_only
            )
            processor = WhisperProcessor.from_pretrained(
                model_name_or_path, local_files_only=local_files_only
            )
        self._torch = torch
        self._model = model.eval()
        self._processor = processor

    def transcribe(self, audio: np.ndarray, temperature: float = 0.0) -> str:
        inputs = self._processor(
            np.asarray(audio, dtype=np.float32), sampling_rate=16000, return_tensors="pt"
        )
        with self._torch.no_grad():
            ids = self._model.generate(
                inputs.input_features,
                do_sample=temperature > 0,
                temperature=temperature if temperature > 0 else None,
                max_new_tokens=128,
            )
        return self._processor.batch_decode(ids, skip_special_tokens=True)[0].strip()


def load_asr(model: Optional[object], device="cuda") -> Optional[ASRModel]:
    """None stays None; an ASRModel passes through; a name ("small.en", a hub
    id or a checkpoint directory) builds ``TorchWhisperASR`` on ``device``
    from a local checkpoint, or raises with the reason. No fallback."""
    if model is None or isinstance(model, ASRModel):
        return model
    if isinstance(model, str):
        name = model if "/" in model or os.path.isdir(model) else f"openai/whisper-{model}"
        try:
            return TorchWhisperASR.from_hf_checkpoint(name, device=device)
        except Exception as ex:
            raise RuntimeError(
                f"cannot load Whisper {model!r} ({name}) on {device}: {type(ex).__name__}: {ex}"
            ) from ex
    raise TypeError(f"Unsupported ASR model: {type(model)}")
