"""HF Llama state dicts -> the port's LM param tree (the LM half of
realtime_codec_agent_tpu/models/convert.py).

``lm_params_from_hf`` maps an HF ``LlamaForCausalLM`` / ``Qwen2ForCausalLM``
state dict (torch tensors or numpy arrays) onto models/llama.py's layout:
Linear weights are stored (out, in) by torch and transposed to (in, out).
Tensors go to the target device in their checkpoint dtype and are transposed
and cast there. Pre-quantized int4 leaves (the GGUF Q4_K import,
models/gguf.py) are already (in, out) and go up as they are. The GGUF loader
calls it. Not ported here: ``hf_config_to_lm_config`` and ``load_hf_llama``
(HF directories), embedding resizing and the codec converters (ROADMAP.md,
port queue 7).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .llama import DuplexLMConfig


def _to_device(a, device) -> torch.Tensor:
    """numpy array or torch tensor -> a tensor on ``device`` in its own dtype
    (numpy arrays from a memory-mapped or read-only buffer are copied)."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.array(a))
    return a.detach().to(device)


def lm_params_from_hf(state_dict: Dict, cfg: DuplexLMConfig, dtype=None) -> Dict:
    """HF LlamaForCausalLM / Qwen2ForCausalLM state dict -> param tree on
    torch's default device (a caller places the load with ``with
    torch.device(...)``).

    Keys may carry the ``model.`` prefix or not. ``dtype`` (a torch dtype or
    its name) defaults to ``cfg.compute_dtype``."""
    if not isinstance(dtype, torch.dtype):
        dtype = getattr(torch, dtype or cfg.compute_dtype)
    device = torch.get_default_device()

    def get(key: str):
        for k in (key, f"model.{key}"):
            if k in state_dict:
                return state_dict[k]
        raise KeyError(f"missing checkpoint tensor: {key}")

    def dev(key: str) -> torch.Tensor:
        return _to_device(get(key), device).to(dtype)

    def lin(key: str):
        w = get(key)
        if isinstance(w, dict):
            # pre-quantized leaf (native GGUF Q4_K int4 import), already (in, out)
            return {k: _to_device(v, device).contiguous() for k, v in w.items()}
        return _to_device(w, device).T.to(dtype).contiguous()

    layers = []
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        blk = {
            "attn_norm": dev(p + "input_layernorm.weight"),
            "wq": lin(p + "self_attn.q_proj.weight"),
            "wk": lin(p + "self_attn.k_proj.weight"),
            "wv": lin(p + "self_attn.v_proj.weight"),
            "wo": lin(p + "self_attn.o_proj.weight"),
            "mlp_norm": dev(p + "post_attention_layernorm.weight"),
            "w_gate": lin(p + "mlp.gate_proj.weight"),
            "w_up": lin(p + "mlp.up_proj.weight"),
            "w_down": lin(p + "mlp.down_proj.weight"),
        }
        if cfg.attn_bias:
            blk["bq"] = dev(p + "self_attn.q_proj.bias")
            blk["bk"] = dev(p + "self_attn.k_proj.bias")
            blk["bv"] = dev(p + "self_attn.v_proj.bias")
        layers.append(blk)
    params = {"embed_tokens": dev("embed_tokens.weight"), "layers": layers, "final_norm": dev("norm.weight")}
    if "lm_head.weight" in state_dict and not cfg.tie_embeddings:
        params["lm_head"] = lin("lm_head.weight")
    elif not cfg.tie_embeddings:
        # tied checkpoint loaded into an untied config: materialize the head
        params["lm_head"] = params["embed_tokens"].T.contiguous()
    return params
