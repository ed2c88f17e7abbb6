"""Model/tokenizer resource bundle for the realtime agent, in PyTorch.

Port of realtime_codec_agent_tpu/agent/resources.py: the streaming codec
tokenizer, the text+codec tokenizer (the port's copy, ``tokenization/``),
and the duplex LM engine over int8- or int4-quantized (optional) and QKV /
gate|up-fused weights, all on one explicit ``device``. ``aux_llm`` is the
same engine.

LM weights come from ``llm_model_path`` (a ``.gguf`` file -- the
reference's deployment artifact, Q4_K leaves kept native with
``quantize_int4`` --, a Hugging Face Llama / Qwen2 directory, or a port
checkpoint / params dir; a GGUF file's or HF directory's config replaces
``lm_config``), from ``_lm_params`` (a tree in the port's layout;
models/from_jax.py converts JAX trees), or random from ``seed``. The codec
is ``codec_model`` (a ``TorchCodecModel``, or a checkpoint path loaded with
``codec_config`` through ``TorchCodecModel.load``), else ``_codec_params``
under ``codec_config``, else random from ``seed``. The text+codec
tokenizer is ``tokenizer``, else the ``codec_tokenizer.json`` beside
``llm_model_path``, else the byte-fallback one over the codec's codebook.
``whisper_model`` goes through ``agent/asr.load_asr`` on the same device:
None (the default; the JAX package's "small.en" needs weights the
repository does not hold), an ``ASRModel``, or a local Whisper checkpoint's
name, which loads or raises. ``clone_for_self_play`` gives a second agent
its own engine over the same weights; ``clone_to_device`` a full replica on
another device.
"""
from __future__ import annotations

import os
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
    quantize_params_int4,
    quantize_params_int8,
    tiny_lm_config,
)
from ..utils.tree import tree_map
from .asr import load_asr


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


class RealtimeAgentResources:
    def __init__(
        self,
        llm_model_path: Optional[str] = None,
        llm_n_ctx: int = 12288,
        codec_model=None,
        codec_config: Optional[CodecConfig] = None,
        lm_config: Optional[DuplexLMConfig] = None,
        whisper_model: Optional[object] = None,
        tokenizer: Optional[CodecTextTokenizer] = None,
        tiny: bool = False,
        seed: int = 0,
        quantize_int8: bool = False,
        quantize_int4: bool = False,
        device="cuda",
        duplex_engine: bool = True,
        _lm_params: Optional[Dict] = None,
        _codec_params: Optional[Dict] = None,
    ):
        """``duplex_engine=False`` builds no DuplexLMEngine (``llm`` and
        ``aux_llm`` are None), for a caller that serves ``lm_params``
        through an engine of its own (serving/server.py --mesh)."""
        if quantize_int8 and quantize_int4:
            raise ValueError("quantize_int8 and quantize_int4 are exclusive")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RealtimeAgentResources(device='cuda'): no CUDA device is available")
        self.quantize_int8 = quantize_int8
        self.quantize_int4 = quantize_int4
        self.llm_n_ctx = llm_n_ctx
        self.tiny = tiny
        self.seed = seed

        # codec + streaming tokenizer
        if isinstance(codec_model, str):
            codec_model = TorchCodecModel.load(codec_model, config=codec_config, device=self.device)
        elif codec_model is None:
            codec_config = codec_config or (tiny_codec_config() if tiny else CodecConfig())
            codec_params = _codec_params
            if codec_params is None:
                codec_params = init_codec_params(_generator(seed, self.device), codec_config, self.device)
            codec_model = TorchCodecModel(codec_params, codec_config, self.device)
        elif not isinstance(codec_model, TorchCodecModel):
            raise TypeError(f"Unsupported codec_model: {type(codec_model)}")
        self.audio_tokenizer = AudioTokenizer(codec_model=codec_model)

        # text+codec tokenizer: the caller's, else the one saved beside the model, if any
        model_dir = os.path.dirname(llm_model_path) if llm_model_path else None
        if tokenizer is not None:
            self.tokenizer = tokenizer
        elif model_dir and os.path.exists(os.path.join(model_dir, "codec_tokenizer.json")):
            self.tokenizer = CodecTextTokenizer.load(model_dir)
        else:
            self.tokenizer = CodecTextTokenizer(codebook_size=self.audio_tokenizer.codebook_size)

        # duplex LM engine
        self.lm_config = lm_config or self._default_lm_config()
        lm_params = _lm_params
        if lm_params is None and llm_model_path:
            if not os.path.exists(llm_model_path):
                raise FileNotFoundError(f"LM checkpoint not found: {llm_model_path}")
            lm_params = self._load_checkpoint(llm_model_path)
        elif lm_params is None:
            lm_params = init_lm_params(_generator(seed, self.device), self.lm_config, self.device)
        # int8 or int4 decode weights, then the QKV and gate|up fusion (the
        # JAX resources' order); all pass already-processed leaves through
        if quantize_int8:
            lm_params = quantize_params_int8(lm_params)
        elif quantize_int4:
            lm_params = quantize_params_int4(lm_params)
        lm_params = fuse_lm_params_for_decode(lm_params)
        self.lm_params = lm_params
        self.llm = DuplexLMEngine(lm_params, self.lm_config, device=self.device) if duplex_engine else None
        self.aux_llm = self.llm
        self.whisper_model = load_asr(whisper_model, device=self.device)

    def clone_for_self_play(self) -> "RealtimeAgentResources":
        """A second agent's resources over the SAME weights: a new engine
        (KV cache, sampler state) and streaming tokenizer, the codec model,
        tokenizer, params and ASR shared (reference
        realtime_agent_resources.py:41-49). Agents built on clones can be
        grouped (lm/pair_session.py)."""
        clone = object.__new__(RealtimeAgentResources)
        clone.device = self.device
        clone.quantize_int8 = self.quantize_int8
        clone.quantize_int4 = self.quantize_int4
        clone.llm_n_ctx = self.llm_n_ctx
        clone.tiny = self.tiny
        clone.seed = self.seed
        clone.audio_tokenizer = AudioTokenizer(codec_model=self.audio_tokenizer.codec_model)
        clone.tokenizer = self.tokenizer
        clone.lm_config = self.lm_config
        clone.lm_params = self.lm_params
        clone.llm = DuplexLMEngine(self.lm_params, self.lm_config, device=self.device)
        clone.aux_llm = clone.llm
        clone.whisper_model = self.whisper_model
        return clone

    def clone_to_device(self, device) -> "RealtimeAgentResources":
        """A full replica on another ``torch.device``: the LM and codec
        weights copied there, with a new engine and tokenizer over them, so
        every chunk program built on the clone runs on that device (duplex
        serving's pool on another card: calls are independent, so more cards
        are replicas and nothing communicates). The ASR model stays shared."""
        device = torch.device(device)
        clone = object.__new__(RealtimeAgentResources)
        clone.device = device
        clone.quantize_int8 = self.quantize_int8
        clone.quantize_int4 = self.quantize_int4
        clone.llm_n_ctx = self.llm_n_ctx
        clone.tiny = self.tiny
        clone.seed = self.seed
        codec_src = self.audio_tokenizer.codec_model
        codec_copy = TorchCodecModel(tree_map(lambda t: t.to(device, copy=True), codec_src.params), codec_src.config, device)
        clone.audio_tokenizer = AudioTokenizer(codec_model=codec_copy)
        clone.tokenizer = self.tokenizer
        clone.lm_config = self.lm_config
        clone.lm_params = tree_map(lambda t: t.to(device, copy=True), self.lm_params)
        clone.llm = DuplexLMEngine(clone.lm_params, clone.lm_config, device=device)
        clone.aux_llm = clone.llm
        clone.whisper_model = self.whisper_model
        return clone

    def _load_checkpoint(self, path: str) -> Dict:
        """LM weights from the reference's GGUF artifact (with
        ``quantize_int4`` its Q4_K layer matmuls stay native int4 leaves), a
        Hugging Face checkpoint directory (models/convert.load_hf_llama; both
        replace ``lm_config`` with their own config) or a port checkpoint /
        params dir, placed on ``self.device``."""
        if path.endswith(".gguf"):
            from ..models.gguf import load_gguf_llama

            with torch.device(self.device):
                params, cfg = load_gguf_llama(
                    path, max_context=self.llm_n_ctx, int4=self.quantize_int4,
                    codec_vocab_start=self.lm_config.codec_vocab_start,
                )
            self.lm_config = cfg
            return params
        if os.path.isdir(path) and os.path.exists(os.path.join(path, "config.json")):
            from ..models.convert import load_hf_llama

            with torch.device(self.device):
                params, cfg = load_hf_llama(
                    path, max_context=self.llm_n_ctx, codec_vocab_start=self.lm_config.codec_vocab_start,
                )
            self.lm_config = cfg
            return params
        from ..train.checkpoint import load_params

        return load_params(path, self.device)

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
