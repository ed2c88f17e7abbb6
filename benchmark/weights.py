"""Weights made from the run's seed, on the device, in the type they are
served or trained in: one ``torch.Generator`` on the device and one large
draw per kind of weight (all layers at once), never leaf by leaf or on the
host. The same seed gives the same weights, so the plain reference makes
them again after the window instead of keeping a copy.

The tree follows the port's training layout (``models/llama.py``): weights
``(in, out)``, the layers as ``(L, ...)`` stacked leaves.
Unlike the port's own initialisers, biases and norm scales are random too,
so that every term of the layer equations carries weight.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

MATRIX_STD = 0.02
BIAS_STD = 0.1
NORM_STD = 0.1


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed for one stream of the run (``name``)."""
    words = [seed % 2**63] + [ord(c) for c in name]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint32).astype(np.uint64).view(np.uint64)[0]
               >> np.uint64(1))


def generator(seed: int, name: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, name))
    return gen


def _normal(gen, shape, std, dtype, device, mean=0.0) -> torch.Tensor:
    out = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    out.mul_(std)
    if mean:
        out.add_(mean)
    return out.to(dtype)


def lm_shapes(cfg: dict) -> Dict[str, tuple]:
    """The per-layer weight kinds of a Qwen2 layer and their shapes."""
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = h // heads
    return {
        "attn_norm": (h,), "wq": (h, heads * dh), "wk": (h, kv * dh), "wv": (h, kv * dh),
        "bq": (heads * dh,), "bk": (kv * dh,), "bv": (kv * dh,), "wo": (heads * dh, h),
        "mlp_norm": (h,), "w_gate": (h, inter), "w_up": (h, inter), "w_down": (inter, h),
    }


def make_lm(cfg: dict, seed: int, device, dtype=torch.bfloat16, codec_embed: bool = False) -> Dict:
    """The LM's weights for configuration ``cfg`` (a ``configs/*.json``
    dict): tied embedding, random biases and norm scales; with
    ``codec_embed`` the duplex LM's codec branch (a frozen f32 table and one
    GELU projector)."""
    gen = generator(seed, "lm", device)
    n_layers, h = cfg["num_hidden_layers"], cfg["hidden_size"]
    layers = {}
    for name, shape in lm_shapes(cfg).items():
        full = (n_layers, *shape)
        if name.endswith("norm"):
            layers[name] = _normal(gen, full, NORM_STD, dtype, device, mean=1.0)
        elif name.startswith("b"):
            layers[name] = _normal(gen, full, BIAS_STD, dtype, device)
        else:
            layers[name] = _normal(gen, full, MATRIX_STD, dtype, device)
    params = {
        "embed_tokens": _normal(gen, (cfg["vocab_size"], h), MATRIX_STD, dtype, device),
        "final_norm": _normal(gen, (h,), NORM_STD, dtype, device, mean=1.0),
        "layers": layers,
    }
    if codec_embed:
        d, n_codes = 16, cfg["port"]["codebook_size"]
        params["codec_embed"] = {
            "table": _normal(gen, (n_codes, d), 1.0, torch.float32, device),
            "projectors": [{
                "w1": _normal(gen, (d, h), 1.0 / math.sqrt(d), dtype, device),
                "b1": _normal(gen, (h,), BIAS_STD, dtype, device),
                "w2": _normal(gen, (h, h), 1.0 / math.sqrt(h), dtype, device),
                "b2": _normal(gen, (h,), BIAS_STD, dtype, device),
            }],
        }
    return params
