"""Model/tokenizer resource bundle for the realtime agent, in PyTorch.

Port of realtime_codec_agent_tpu/agent/resources.py: the streaming codec
tokenizer, the text+codec tokenizer (the port's copy, ``tokenization/``),
and the duplex LM engine over int8-quantized (optional) and QKV /
gate|up-fused weights, all on one explicit ``device``. ``aux_llm`` is the
same engine.

Weights are random (seeded) unless given: ``_lm_params`` / ``_codec_params``
take trees in the port's layout (models/from_jax.py converts JAX trees).
Checkpoint loading, Whisper and int4 are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..tokenization import CodecTextTokenizer

from ..audio_tokenizer import AudioTokenizer
from ..lm.engine import DuplexLMEngine
from ..models.codec import CodecConfig, TorchCodecModel, init_codec_params, tiny_codec_config
from ..models.llama import (
    DuplexLMConfig,
    fuse_lm_params_for_decode,
    init_lm_params,
    llama32_1b_config,
    quantize_params_int8,
    tiny_lm_config,
)


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


class RealtimeAgentResources:
    def __init__(
        self,
        llm_n_ctx: int = 12288,
        codec_config: Optional[CodecConfig] = None,
        lm_config: Optional[DuplexLMConfig] = None,
        whisper_model: Optional[object] = None,
        tiny: bool = False,
        seed: int = 0,
        quantize_int8: bool = False,
        quantize_int4: bool = False,
        device="cuda",
        _lm_params: Optional[Dict] = None,
        _codec_params: Optional[Dict] = None,
    ):
        if whisper_model is not None:
            raise NotImplementedError("Whisper ASR is not ported to PyTorch yet (ROADMAP.md, port queue: 'Whisper'); pass whisper_model=None")
        if quantize_int4:
            raise NotImplementedError("int4 decode weights are not ported to PyTorch yet (ROADMAP.md, port queue: 'int4 with B5')")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RealtimeAgentResources(device='cuda'): no CUDA device is available")
        self.quantize_int8 = quantize_int8
        self.llm_n_ctx = llm_n_ctx
        self.tiny = tiny
        self.seed = seed

        # codec + streaming tokenizer
        codec_config = codec_config or (tiny_codec_config() if tiny else CodecConfig())
        codec_params = _codec_params
        if codec_params is None:
            codec_params = init_codec_params(_generator(seed, self.device), codec_config, self.device)
        codec_model = TorchCodecModel(codec_params, codec_config, self.device)
        self.audio_tokenizer = AudioTokenizer(codec_model=codec_model)

        # text+codec tokenizer
        self.tokenizer = CodecTextTokenizer(codebook_size=self.audio_tokenizer.codebook_size)

        # duplex LM engine
        self.lm_config = lm_config or self._default_lm_config()
        lm_params = _lm_params
        if lm_params is None:
            lm_params = init_lm_params(_generator(seed, self.device), self.lm_config, self.device)
        if quantize_int8:
            # int8 decode weights, then the QKV and gate|up fusion (the JAX
            # resources' order); both pass already-processed leaves through
            lm_params = quantize_params_int8(lm_params)
        lm_params = fuse_lm_params_for_decode(lm_params)
        self.lm_params = lm_params
        self.llm = DuplexLMEngine(lm_params, self.lm_config, device=self.device)
        self.aux_llm = self.llm
        self.whisper_model = None

    def _default_lm_config(self) -> DuplexLMConfig:
        vocab = self.tokenizer.vocab_size
        vocab = ((vocab + 7) // 8) * 8  # resize_token_embeddings pad_to_multiple_of=8
        if self.tiny:
            return tiny_lm_config(
                vocab_size=vocab,
                codebook_size=self.audio_tokenizer.codebook_size,
                max_context=self.llm_n_ctx,
            )
        # deployment scale: at least the Llama-3.2 text vocab (128256) +
        # specials + codec region
        deployed_vocab = ((128256 + 10 + self.audio_tokenizer.codebook_size + 7) // 8) * 8
        return llama32_1b_config(vocab_size=max(vocab, deployed_vocab), max_context=self.llm_n_ctx)
