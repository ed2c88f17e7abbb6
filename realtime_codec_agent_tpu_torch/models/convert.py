"""Real-weight interop: Hugging Face Llama directories and MagiCodec torch
checkpoints -> the port's param trees (port of
realtime_codec_agent_tpu/models/convert.py).

- ``hf_config_to_lm_config`` / ``load_hf_llama``: an HF ``config.json`` plus
  ``*.safetensors`` shards (read by this module's own reader: an 8-byte
  little-endian header length, a JSON header, raw little-endian tensors,
  viewed with ``torch.frombuffer`` over a memory map) or a
  ``pytorch_model.bin``. ``lm_params_from_hf`` maps an ``LlamaForCausalLM``
  / ``Qwen2ForCausalLM`` state dict onto models/llama.py's layout: Linear
  weights are stored (out, in) by torch and transposed to (in, out), on the
  target device, in the checkpoint dtype until the cast there.
  Pre-quantized int4 leaves (the GGUF Q4_K import, models/gguf.py) are
  already (in, out) and go up as they are.
- ``resize_embeddings``: grow the vocab by mean-initialized rows.
- ``codec_params_from_torch``: a MagiCodec-layout state dict (flash-attn
  block names, fused ``mixer.Wqkv``, conv stages) -> models/codec.py's tree.
- ``save_codec_checkpoint`` / ``load_codec_checkpoint``: the JAX package's
  ``.npz`` format, so a file written by either package loads in the other.

Numbers come from the checkpoint; the only random numbers (new embedding
rows) come from the caller's seed through a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import json
import mmap
import os
import struct
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


# ---------------------------------------------------------------------------
# HF Llama -> models/llama.py param tree
# ---------------------------------------------------------------------------

def hf_config_to_lm_config(hf_cfg: Dict, **overrides) -> DuplexLMConfig:
    """HF LlamaConfig / Qwen2Config dict (config.json) -> DuplexLMConfig.
    Qwen2-family checkpoints (model_type "qwen2" / Qwen2ForCausalLM) differ
    from Llama only by q/k/v projection biases."""
    rope_scaling = hf_cfg.get("rope_scaling") or {}
    rope_type = rope_scaling.get("rope_type", rope_scaling.get("type"))
    archs = " ".join(hf_cfg.get("architectures") or [])
    is_qwen2 = hf_cfg.get("model_type") == "qwen2" or "Qwen2" in archs
    fields = dict(
        attn_bias=bool(hf_cfg.get("attention_bias", is_qwen2)),
        vocab_size=hf_cfg["vocab_size"],
        hidden_size=hf_cfg["hidden_size"],
        intermediate_size=hf_cfg["intermediate_size"],
        num_layers=hf_cfg["num_hidden_layers"],
        num_heads=hf_cfg["num_attention_heads"],
        num_kv_heads=hf_cfg.get("num_key_value_heads", hf_cfg["num_attention_heads"]),
        head_dim=hf_cfg.get("head_dim", hf_cfg["hidden_size"] // hf_cfg["num_attention_heads"]),
        rope_theta=hf_cfg.get("rope_theta", 10000.0),
        rms_eps=hf_cfg.get("rms_norm_eps", 1e-5),
        tie_embeddings=hf_cfg.get("tie_word_embeddings", False),
    )
    if rope_type == "llama3":
        fields.update(
            rope_scaling_factor=rope_scaling.get("factor", 32.0),
            rope_scaling_low_freq=rope_scaling.get("low_freq_factor", 1.0),
            rope_scaling_high_freq=rope_scaling.get("high_freq_factor", 4.0),
            rope_scaling_original_max_position=rope_scaling.get("original_max_position_embeddings", 8192),
        )
    fields.update(overrides)
    return DuplexLMConfig(**fields)


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


_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file as a CPU tensor in its stored
    dtype, viewed over a private (copy-on-write) memory map of the file: no
    copy until a tensor is moved, cast or written. A dtype outside F64, F32,
    F16, BF16, I64, I32, I16, I8, U8 and BOOL raises, naming the tensor."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n else b""
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which this reader does not take")
        start, end = info["data_offsets"]
        shape = info["shape"]
        count = end - start
        itemsize = torch.empty((), dtype=dtype).element_size()
        if count != itemsize * int(np.prod(shape)):
            raise ValueError(f"{path}: tensor {name!r} spans {count} bytes, not {shape} x {itemsize}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        if (base + start) % itemsize:
            # a misaligned tensor gets its own aligned copy
            t = torch.frombuffer(bytearray(buf[base + start : base + end]), dtype=dtype)
        else:
            t = torch.frombuffer(buf, dtype=dtype, count=count // itemsize, offset=base + start)
        out[name] = t.reshape(shape)
    return out


def load_hf_llama(model_dir: str, dtype=None, max_context: int = 16384, **config_overrides):
    """An HF Llama / Qwen2 checkpoint directory (config.json + *.safetensors
    shards, read in sorted order, or pytorch_model.bin) -> (params,
    DuplexLMConfig), on torch's default device (``with torch.device(...)``
    places the load). Tensors reach ``lm_params_from_hf`` in their checkpoint
    dtype, so bf16 weights cross to the card as bf16."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = hf_config_to_lm_config(hf_cfg, max_context=max_context, **config_overrides)
    st_files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if st_files:
        state_dict: Dict[str, torch.Tensor] = {}
        for fname in st_files:
            state_dict.update(read_safetensors(os.path.join(model_dir, fname)))
    else:
        state_dict = torch.load(os.path.join(model_dir, "pytorch_model.bin"), map_location="cpu", weights_only=True)
    return lm_params_from_hf(state_dict, cfg, dtype=dtype), cfg


def resize_embeddings(params: Dict, cfg: DuplexLMConfig, new_vocab: int, seed: int = 0):
    """Grow ``embed_tokens`` (and an untied ``lm_head``) to ``new_vocab``
    rows, mean-initialized as HF ``resize_token_embeddings``: the existing
    rows stay bit for bit, a new row is the old rows' mean plus 0.02 N(0, 1)
    noise (along axis 0 of ``embed_tokens``, axis 1 of ``lm_head``). The
    noise is the port's own stream: a ``torch.Generator`` seeded with
    ``seed`` on the tensors' device (the head's with ``seed + 1``). Returns
    (params, cfg) with ``vocab_size`` updated; shrinking raises ValueError."""
    old = params["embed_tokens"]
    if new_vocab < old.shape[0]:
        raise ValueError(f"cannot shrink vocab {old.shape[0]} -> {new_vocab}")
    out = dict(params)
    extra = new_vocab - old.shape[0]
    if extra:
        def noise(shape, device, s):
            gen = torch.Generator(device=device)
            gen.manual_seed(s)
            return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * 0.02

        mean = old.to(torch.float32).mean(dim=0)
        new_rows = (mean + noise((extra, old.shape[1]), old.device, seed)).to(old.dtype)
        out["embed_tokens"] = torch.cat([old, new_rows], dim=0)
        if "lm_head" in params:
            head = params["lm_head"]
            hmean = head.to(torch.float32).mean(dim=1, keepdim=True)
            new_cols = (hmean + noise((head.shape[0], extra), head.device, seed + 1)).to(head.dtype)
            out["lm_head"] = torch.cat([head, new_cols], dim=1).contiguous()
    return out, dataclasses.replace(cfg, vocab_size=new_vocab)


# ---------------------------------------------------------------------------
# MagiCodec torch checkpoint -> models/codec.py param tree
# ---------------------------------------------------------------------------

# canonical leaf -> the torch names it accepts (first match wins)
_CODEC_KEY_ALIASES = {
    "encoder.patch_embed": ("encoder.patch_embed.weight", "encoder.in_proj.weight"),
    "encoder.patch_bias": ("encoder.patch_embed.bias", "encoder.in_proj.bias"),
    "quantizer.codebook": ("quantizer.codebook.weight",),
    "quantizer.proj_w": ("quantizer.codebook_proj.weight",),
    "quantizer.proj_b": ("quantizer.codebook_proj.bias",),
    "decoder.in_proj": ("decoder.in_proj.weight", "decoder.patch_embed.weight"),
    "decoder.in_bias": ("decoder.in_proj.bias", "decoder.patch_embed.bias"),
    "encoder.out_proj": ("encoder.out_proj.weight",),
    "encoder.out_proj_b": ("encoder.out_proj.bias",),
    "decoder.patch_unembed": ("decoder.out_proj.weight", "decoder.patch_unembed.weight"),
    "decoder.patch_unembed_b": ("decoder.out_proj.bias", "decoder.patch_unembed.bias"),
}


def codec_params_from_torch(state_dict: Dict, cfg, return_unused: bool = False, device="cpu"):
    """MagiCodec-layout torch state dict (tensors or numpy arrays) ->
    models/codec.py's param tree on ``device``.

    Transformer bodies are read in the flash-attn block convention
    (``blocks.{i}.norm1/norm2`` with biases when present, the fused
    ``mixer.Wqkv`` split three ways with its bias, ``mixer.out_proj``,
    ``mlp.fc1/fc2``, ``norm_f``) or the unfused ``wq/wk/wv/wo`` and
    ``attn.{q,k,v,o}_proj`` names. Linear (out, in) weights transpose to
    (in, out); Conv1d (out, in, k) to (k, in, out); ConvTranspose1d (in,
    out, k) to (k, in, out) with the taps reversed (torch's transposed conv
    is the gradient form, ``lax.conv_transpose`` without ``transpose_kernel``
    a plain correlation). Quantizer leaves and ``patch_unembed_b`` are f32,
    every other leaf ``cfg.compute_dtype``: the JAX converter's tree leaf for
    leaf. A missing tensor raises KeyError naming it; ``return_unused=True``
    also returns the checkpoint keys the map did not consume."""
    dtype = cfg.dtype
    f32 = torch.float32
    sd = dict(state_dict)
    consumed = set()

    def pick(*names, required=True):
        for n in names:
            if n in sd:
                consumed.add(n)
                return torch.as_tensor(sd[n]).detach().to("cpu", f32)
        if required:
            raise KeyError(f"missing codec checkpoint tensor: one of {names}")
        return None

    def alias(canon, required=True):
        return pick(*_CODEC_KEY_ALIASES[canon], required=required)

    def leaf(t, dt=None):
        return None if t is None else t.to(dt or dtype).contiguous().to(device)

    def blocks(prefix: str):
        out = []
        i = 0
        while f"{prefix}.blocks.{i}.attn_norm.weight" in sd or f"{prefix}.blocks.{i}.norm1.weight" in sd:
            b = f"{prefix}.blocks.{i}"
            qkv = pick(f"{b}.mixer.Wqkv.weight", required=False)
            qkv_b = pick(f"{b}.mixer.Wqkv.bias", required=False)
            if qkv is not None:
                h = qkv.shape[1]
                wq, wk, wv = qkv[:h], qkv[h : 2 * h], qkv[2 * h :]
                bq, bk, bv = (qkv_b[:h], qkv_b[h : 2 * h], qkv_b[2 * h :]) if qkv_b is not None else (None,) * 3
            else:
                wq = pick(f"{b}.wq.weight", f"{b}.attn.q_proj.weight")
                wk = pick(f"{b}.wk.weight", f"{b}.attn.k_proj.weight")
                wv = pick(f"{b}.wv.weight", f"{b}.attn.v_proj.weight")
                bq = pick(f"{b}.wq.bias", f"{b}.attn.q_proj.bias", required=False)
                bk = pick(f"{b}.wk.bias", f"{b}.attn.k_proj.bias", required=False)
                bv = pick(f"{b}.wv.bias", f"{b}.attn.v_proj.bias", required=False)
            blk = {
                "attn_norm": leaf(pick(f"{b}.attn_norm.weight", f"{b}.norm1.weight")),
                "attn_norm_b": leaf(pick(f"{b}.attn_norm.bias", f"{b}.norm1.bias", required=False)),
                "wq": leaf(wq.T), "wk": leaf(wk.T), "wv": leaf(wv.T),
                "bq": leaf(bq), "bk": leaf(bk), "bv": leaf(bv),
                "wo": leaf(pick(f"{b}.wo.weight", f"{b}.attn.o_proj.weight", f"{b}.mixer.out_proj.weight").T),
                "bo": leaf(pick(f"{b}.wo.bias", f"{b}.attn.o_proj.bias", f"{b}.mixer.out_proj.bias",
                                required=False)),
                "mlp_norm": leaf(pick(f"{b}.mlp_norm.weight", f"{b}.norm2.weight")),
                "mlp_norm_b": leaf(pick(f"{b}.mlp_norm.bias", f"{b}.norm2.bias", required=False)),
                "w1": leaf(pick(f"{b}.w1.weight", f"{b}.mlp.fc1.weight").T),
                "b1": leaf(pick(f"{b}.b1", f"{b}.mlp.fc1.bias")),
                "w2": leaf(pick(f"{b}.w2.weight", f"{b}.mlp.fc2.weight").T),
                "b2": leaf(pick(f"{b}.b2", f"{b}.mlp.fc2.bias")),
            }
            out.append({k: v for k, v in blk.items() if v is not None})
            i += 1
        if not out:
            raise KeyError(f"no transformer blocks found under {prefix}.blocks")
        return out

    def conv_stages(prefix: str, transpose_conv: bool):
        out = []
        i = 0
        while any(f"{prefix}.{s}.{i}.weight" in sd for s in ("conv.stages", "down", "up")):
            names = (f"{prefix}.conv.stages.{i}", f"{prefix}.down.{i}", f"{prefix}.up.{i}")
            w = pick(*(n + ".weight" for n in names))
            b = pick(*(n + ".bias" for n in names))
            w = w.permute(2, 0, 1).flip(0) if transpose_conv else w.permute(2, 1, 0)
            out.append({"w": leaf(w), "b": leaf(b)})
            i += 1
        if not out:
            raise KeyError(f"no conv stages found under {prefix}")
        return out

    encoder = {
        "blocks": blocks("encoder"),
        "out_norm": leaf(pick("encoder.out_norm.weight", "encoder.norm_f.weight")),
        "out_norm_b": leaf(pick("encoder.out_norm.bias", "encoder.norm_f.bias", required=False)),
        "out_proj": leaf(alias("encoder.out_proj").T),
        "out_proj_b": leaf(alias("encoder.out_proj_b", required=False)),
    }
    in_proj = alias("decoder.in_proj")
    in_bias = alias("decoder.in_bias", required=False)
    decoder = {
        "in_proj": leaf(in_proj.T),
        "in_bias": leaf(in_bias if in_bias is not None else torch.zeros(in_proj.shape[0])),
        "blocks": blocks("decoder"),
        "out_norm": leaf(pick("decoder.out_norm.weight", "decoder.norm_f.weight")),
        "out_norm_b": leaf(pick("decoder.out_norm.bias", "decoder.norm_f.bias", required=False)),
    }
    if cfg.frontend == "conv":
        encoder["conv"] = {"stages": conv_stages("encoder", transpose_conv=False)}
        decoder["conv"] = {"stages": conv_stages("decoder", transpose_conv=True)}
    else:
        pe = alias("encoder.patch_embed")
        pb = alias("encoder.patch_bias", required=False)
        encoder["patch_embed"] = leaf(pe.T)
        encoder["patch_bias"] = leaf(pb if pb is not None else torch.zeros(pe.shape[0]))
        decoder["patch_unembed"] = leaf(alias("decoder.patch_unembed").T)
        decoder["patch_unembed_b"] = leaf(alias("decoder.patch_unembed_b", required=False), f32)
    params = {
        "encoder": {k: v for k, v in encoder.items() if v is not None},
        "quantizer": {
            "codebook": leaf(alias("quantizer.codebook"), f32),
            "proj_w": leaf(alias("quantizer.proj_w").T, f32),
            "proj_b": leaf(alias("quantizer.proj_b"), f32),
        },
        "decoder": {k: v for k, v in decoder.items() if v is not None},
    }
    if return_unused:
        return params, sorted(k for k in sd if k not in consumed)
    return params


# ---------------------------------------------------------------------------
# Codec checkpoint save/load (the JAX package's .npz format)
# ---------------------------------------------------------------------------

def save_codec_checkpoint(path: str, params: Dict, cfg) -> None:
    """Codec params + config as one ``.npz``: leaves flattened to dotted
    keys, bf16 stored as f32 (npz holds no bf16), the config as JSON under
    ``__config__``."""
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}{i}.")
        else:
            t = tree.detach().cpu()
            if t.dtype not in (torch.float32, torch.int32, torch.int64):
                t = t.to(torch.float32)
            flat[prefix[:-1]] = t.numpy()

    walk(params, "")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, __config__=json.dumps(dataclasses.asdict(cfg)), **flat)


def load_codec_checkpoint(path: str, device="cpu"):
    """A codec ``.npz`` -> (params on ``device``, CodecConfig). Quantizer
    leaves load as f32, integer leaves as int32, the rest in the config's
    compute dtype."""
    from .codec import CodecConfig

    data = np.load(path, allow_pickle=False)
    cfg_kwargs = json.loads(str(data["__config__"]))
    if "conv_ratios" in cfg_kwargs:
        cfg_kwargs["conv_ratios"] = tuple(cfg_kwargs["conv_ratios"])
    cfg = CodecConfig(**cfg_kwargs)

    params: Dict = {}
    for key in data.files:
        if key == "__config__":
            continue
        parts = key.split(".")
        node = params
        for i, p in enumerate(parts[:-1]):
            nxt = parts[i + 1]
            if isinstance(node, list):
                p = int(p)
                while len(node) <= p:
                    node.append([] if nxt.isdigit() else {})
                node = node[p]
            else:
                node = node.setdefault(p, [] if nxt.isdigit() else {})
        arr = data[key]
        if arr.dtype in (np.int32, np.int64):
            want = torch.int32
        else:
            want = torch.float32 if key.startswith("quantizer") else cfg.dtype
        val = torch.from_numpy(np.array(arr)).to(want).to(device)
        if isinstance(node, list):
            idx = int(parts[-1])
            while len(node) <= idx:
                node.append(None)
            node[idx] = val
        else:
            node[parts[-1]] = val
    return params, cfg
