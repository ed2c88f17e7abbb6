"""Codec-embedding bridge: codec codebook -> LM embedding space, in PyTorch.

Port of realtime_codec_agent_tpu/train/embedding_bridge.py:
``extract_codec_embeddings`` dumps the codec's projected codebook
(``(num_codebooks, V, dim)`` f32 .npy), ``load_codec_embeddings`` reads it
(.npy, or a .pt tensor), ``persist_and_verify`` bakes the trained
projections into the embedding matrix and checks that the vanilla model's
embeddings reproduce the dual-route model's.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..models.llama import DuplexLMConfig, embed_ids, persist_codec_embeddings


def extract_codec_embeddings(audio_tokenizer, save_path: str) -> np.ndarray:
    """Dump the codec's projected codebook as float32 (num_codebooks, V, dim)."""
    emb = np.asarray(audio_tokenizer.get_codec_embeddings(), dtype=np.float32)
    emb = emb[None, ...]  # single codebook
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    np.save(save_path if save_path.endswith(".npy") else save_path + ".npy", emb)
    return emb


def load_codec_embeddings(path: str) -> np.ndarray:
    """Load a codec embedding table from .npy or .pt."""
    if path.endswith(".pt"):
        emb = torch.load(path, map_location="cpu", weights_only=True).float().numpy()
    else:
        emb = np.load(path)
    if emb.ndim != 3:
        raise ValueError(
            "codec embedding file must contain (num_codebooks, codebook_size, codebook_dim)"
        )
    return emb.astype(np.float32)


@torch.no_grad()
def persist_and_verify(
    params: Dict,
    cfg: DuplexLMConfig,
    batch_size: int = 8192,
) -> Tuple[Dict, float]:
    """Persist codec projections into embed_tokens and verify the vanilla
    model's embeddings match the dual-route model's. Returns
    (vanilla_params, max_abs_err); raises past 1e-2."""
    vanilla = persist_codec_embeddings(params, cfg, batch_size=batch_size)
    n = cfg.num_codebooks * cfg.codebook_size
    device = params["embed_tokens"].device
    max_err = 0.0
    for start in range(0, n, batch_size):
        ids = torch.arange(start, min(start + batch_size, n), device=device) + cfg.codec_vocab_start
        want = embed_ids(params, ids, cfg).to(torch.float32)
        got = embed_ids(vanilla, ids, cfg).to(torch.float32)
        max_err = max(max_err, float((want - got).abs().max()))
    if max_err > 1e-2:
        raise AssertionError(f"persisted embeddings diverge: max_abs_err={max_err}")
    return vanilla, max_err
