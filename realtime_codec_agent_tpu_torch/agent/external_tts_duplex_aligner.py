"""Silence-distance interrupt scoring between TTS and duplex-LM predictions.

Port of realtime_codec_agent_tpu/agent/external_tts_duplex_aligner.py on
the port's ``AudioTokenizer``. Rebuild of the reference aligner (external_tts_duplex_aligner.py:6-26) in
numpy over the codec embedding table: the interrupt score is the ratio of mean
codec-embedding distances from the silence centroid — TTS prediction vs duplex
prediction. A high z-score pauses TTS substitution (reference
realtime_agent_v2.py:382-393).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..audio_tokenizer import AudioTokenizer


class ExternalTTSDuplexAligner:
    def __init__(self, audio_tokenizer: AudioTokenizer, codec_vocab_start: int):
        self.codec_embeddings = np.asarray(audio_tokenizer.get_codec_embeddings())
        self.codec_vocab_start = codec_vocab_start
        silence_codes = audio_tokenizer._encode_silence(10.0)[0, 0]
        self.silence_embedding = self.codec_embeddings[silence_codes].mean(axis=0)

    def interrupt_score(
        self, tts_token_ids: Sequence[int], duplex_token_ids: Sequence[int]
    ) -> float:
        codes = np.array([list(tts_token_ids), list(duplex_token_ids)]) - self.codec_vocab_start
        embs = self.codec_embeddings[codes]  # (2, T, D)
        dist = np.linalg.norm(embs - self.silence_embedding, axis=-1).mean(axis=-1)
        tts_dist, duplex_dist = float(dist[0]), float(dist[1])
        # "the TTS prediction is {score}x further from silence than the duplex prediction"
        return tts_dist / (duplex_dist + 1e-5)
