"""Read-only GGUF loader: the reference's shipped deployment artifact.

The reference's published model is a GGUF conversion of the trained HF
checkpoint (reference prep_test_model.sh:27-34: convert_hf_to_gguf.py F16 /
q8_0 / F32, then llama-quantize). This module lets that exact artifact load
directly into the TPU engine: the GGUF container is parsed with numpy (no
llama.cpp dependency), llama-arch tensors map onto the models/llama.py
pytree, and q8_0 blocks dequantize to float (optionally re-quantized to the
engine's per-channel int8 layout afterwards — models/llama.quantize_params_int8).

Format reference: the GGUF v2/v3 container spec (ggml project). Supported
tensor encodings: F32, F16, Q8_0 (32-element blocks of fp16 scale + int8),
and the K-quants Q4_K / Q6_K (256-element super-blocks) that make up the
reference's final `llama-quantize ... Q4_K_M` artifact
(reference prep_test_model.sh:34). Everything else raises with the tensor
name so unsupported quantizations fail loudly.
"""
from __future__ import annotations

import struct
from typing import Any, BinaryIO, Dict, Tuple

import numpy as np

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian

# ggml tensor encodings
GGML_F32 = 0
GGML_F16 = 1
GGML_Q8_0 = 8
GGML_Q4_K = 12
GGML_Q6_K = 14

QK_K = 256  # K-quant super-block size
Q4_K_BLOCK_BYTES = 2 + 2 + 12 + QK_K // 2  # d, dmin, 6-bit scales/mins, nibbles
Q6_K_BLOCK_BYTES = QK_K // 2 + QK_K // 4 + QK_K // 16 + 2  # ql, qh, scales, d

_VALUE_READERS = {}


def _read_exact(f: BinaryIO, n: int) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise EOFError(f"truncated GGUF file (wanted {n} bytes, got {len(data)})")
    return data


def _scalar(fmt: str):
    size = struct.calcsize(fmt)

    def read(f):
        return struct.unpack(fmt, _read_exact(f, size))[0]

    return read


_VALUE_READERS = {
    0: _scalar("<B"),   # uint8
    1: _scalar("<b"),   # int8
    2: _scalar("<H"),   # uint16
    3: _scalar("<h"),   # int16
    4: _scalar("<I"),   # uint32
    5: _scalar("<i"),   # int32
    6: _scalar("<f"),   # float32
    7: lambda f: bool(_read_exact(f, 1)[0]),  # bool
    10: _scalar("<Q"),  # uint64
    11: _scalar("<q"),  # int64
    12: _scalar("<d"),  # float64
}


def _read_string(f: BinaryIO) -> str:
    n = struct.unpack("<Q", _read_exact(f, 8))[0]
    return _read_exact(f, n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype == 8:
        return _read_string(f)
    if vtype == 9:  # array: elem type + count + elems
        elem_type = struct.unpack("<I", _read_exact(f, 4))[0]
        count = struct.unpack("<Q", _read_exact(f, 8))[0]
        return [_read_value(f, elem_type) for _ in range(count)]
    reader = _VALUE_READERS.get(vtype)
    if reader is None:
        raise ValueError(f"unsupported GGUF metadata value type {vtype}")
    return reader(f)


def _dequant_q8_0(raw: np.ndarray, n_elems: int) -> np.ndarray:
    """Q8_0: blocks of [fp16 scale][32 x int8] -> float32 (n_elems,)."""
    block_bytes = 2 + 32
    n_blocks = raw.size // block_bytes
    blocks = raw.reshape(n_blocks, block_bytes)
    scales = blocks[:, :2].copy().view(np.float16).astype(np.float32)  # (n_blocks, 1)
    qs = blocks[:, 2:].view(np.int8).astype(np.float32)  # (n_blocks, 32)
    out = (qs * scales).reshape(-1)
    return out[:n_elems]


def _q4_k_components(raw: np.ndarray, n_elems: int):
    """Decompose Q4_K super-blocks into ``(q, scale, minv)`` with
    ``w[i] = q[i] * scale[i // 32] - minv[i // 32]`` — ggml's
    dequantize_row_q4_K decomposition with the per-32-element affine group
    kept EXPLICIT so it can map losslessly onto the engine's int4 leaf
    layout (ops/int4_matmul.py). q is uint8 in [0, 15]."""
    blocks = raw.reshape(-1, Q4_K_BLOCK_BYTES)
    nb = blocks.shape[0]
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)      # (nb, 1)
    dmin = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)   # (nb, 1)
    sb = blocks[:, 4:16]
    # ggml get_scale_min_k4: sub-blocks 0-3 are the low 6 bits of bytes 0-3
    # (scales) and 4-7 (mins); sub-blocks 4-7 pack low nibbles into bytes 8-11
    # and the top 2 bits into bytes 0-3 / 4-7
    sc = np.empty((nb, 8), np.float32)
    mn = np.empty((nb, 8), np.float32)
    sc[:, :4] = sb[:, 0:4] & 63
    mn[:, :4] = sb[:, 4:8] & 63
    sc[:, 4:] = (sb[:, 8:12] & 0x0F) | ((sb[:, 0:4] >> 6) << 4)
    mn[:, 4:] = (sb[:, 8:12] >> 4) | ((sb[:, 4:8] >> 6) << 4)
    scale = d * sc    # (nb, 8)
    minv = dmin * mn  # (nb, 8)
    # nibble layout: 32 bytes per 64 elements — low nibbles are sub-block 2c,
    # high nibbles sub-block 2c+1
    qn = blocks[:, 16:].reshape(nb, 4, 32)
    q = np.empty((nb, 4, 2, 32), np.uint8)
    q[:, :, 0, :] = qn & 0x0F
    q[:, :, 1, :] = qn >> 4
    assert n_elems % 32 == 0
    return (
        q.reshape(-1)[:n_elems],
        scale.reshape(-1)[: n_elems // 32],
        minv.reshape(-1)[: n_elems // 32],
    )


def _dequant_q4_k(raw: np.ndarray, n_elems: int) -> np.ndarray:
    """Q4_K: 256-element super-blocks of [fp16 d][fp16 dmin][12B 6-bit
    scales/mins][128B nibbles]; w = d*sc*q - dmin*m per 32-element sub-block
    (ggml dequantize_row_q4_K semantics)."""
    q, scale, minv = _q4_k_components(raw, n_elems)
    out = q.astype(np.float32).reshape(-1, 32) * scale[:, None] - minv[:, None]
    return out.reshape(-1)


def _int4_leaf_from_q4k(q: np.ndarray, scale: np.ndarray, minv: np.ndarray,
                        out_dim: int, in_dim: int) -> Dict[str, np.ndarray]:
    """Q4_K components of a torch-orientation (out, in) Linear weight ->
    the engine's (K, N) = (in, out) int4 leaf ``{"q4", "d", "m"}``
    (ops/int4_matmul.py layout), BIT-EXACTLY: same q values, same per-group
    f32 scale/min, just repacked. ggml quantizes along ne0 = the input dim,
    so Q4_K's 32-element groups run along K — precisely the per-group-of-K
    affine structure the kernel dequantizes in VMEM."""
    assert in_dim % 32 == 0, (out_dim, in_dim)
    qt = q.reshape(out_dim, in_dim).T                    # (K, N)
    q3 = qt.reshape(in_dim // 32, 32, out_dim)
    packed = q3[:, :16, :] | (q3[:, 16:, :] << 4)        # group-contiguous halves
    return {
        "q4": np.ascontiguousarray(packed.reshape(in_dim // 2, out_dim)),
        "d": np.ascontiguousarray(scale.reshape(out_dim, in_dim // 32).T),
        "m": np.ascontiguousarray(minv.reshape(out_dim, in_dim // 32).T),
    }


def _dequant_q6_k(raw: np.ndarray, n_elems: int) -> np.ndarray:
    """Q6_K: 256-element super-blocks of [128B low nibbles][64B high 2-bit
    pairs][16 int8 per-16 scales][fp16 d]; w = d*sc*(q-32)
    (ggml dequantize_row_q6_K semantics)."""
    blocks = raw.reshape(-1, Q6_K_BLOCK_BYTES)
    nb = blocks.shape[0]
    ql = blocks[:, 0:128].reshape(nb, 2, 64)
    qh = blocks[:, 128:192].reshape(nb, 2, 32)
    sc = blocks[:, 192:208].copy().view(np.int8).astype(np.float32).reshape(nb, 2, 8)
    d = blocks[:, 208:210].copy().view(np.float16).astype(np.float32)  # (nb, 1)
    # per 128-element half: elements 0-31 / 32-63 / 64-95 / 96-127 combine
    # (low nibble of ql[0:32] | qh bits 0-1), (ql[32:64] | bits 2-3),
    # (high nibble of ql[0:32] | bits 4-5), (ql[32:64] | bits 6-7)
    v = np.concatenate(
        [
            (ql[:, :, 0:32] & 0x0F) | (((qh >> 0) & 3) << 4),
            (ql[:, :, 32:64] & 0x0F) | (((qh >> 2) & 3) << 4),
            (ql[:, :, 0:32] >> 4) | (((qh >> 4) & 3) << 4),
            (ql[:, :, 32:64] >> 4) | (((qh >> 6) & 3) << 4),
        ],
        axis=2,
    ).astype(np.int32) - 32  # (nb, 2, 128) in natural element order
    out = d[:, :, None] * np.repeat(sc, 16, axis=2) * v  # scale index = l // 16
    return out.reshape(-1)[:n_elems]


def read_gguf(
    path: str, keep_q4k=None
) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Parse a GGUF file -> (metadata dict, {tensor name: numpy array}).

    Tensors come back in ggml's row-major orientation: a 2D tensor with
    ggml dims [ne0, ne1] is returned with numpy shape (ne1, ne0) — for
    llama-arch Linear weights that is torch's (out, in).

    ``keep_q4k(name) -> bool`` opts 2D Q4_K tensors out of dequantization:
    they come back as the engine's native ``{"q4", "d", "m"}`` int4 leaf in
    (in, out) orientation (already transposed — no further ``.T``), a
    bit-exact repack of the Q4_K groups (_int4_leaf_from_q4k)."""
    metadata: Dict[str, Any] = {}
    infos = []
    with open(path, "rb") as f:
        magic, version = struct.unpack("<II", _read_exact(f, 8))
        if magic != GGUF_MAGIC:
            raise ValueError(f"not a GGUF file: {path}")
        if version < 2:
            raise ValueError(f"GGUF version {version} unsupported (need >= 2)")
        n_tensors, n_kv = struct.unpack("<QQ", _read_exact(f, 16))
        for _ in range(n_kv):
            key = _read_string(f)
            vtype = struct.unpack("<I", _read_exact(f, 4))[0]
            metadata[key] = _read_value(f, vtype)
        for _ in range(n_tensors):
            name = _read_string(f)
            n_dims = struct.unpack("<I", _read_exact(f, 4))[0]
            dims = struct.unpack(f"<{n_dims}Q", _read_exact(f, 8 * n_dims))
            ggml_type = struct.unpack("<I", _read_exact(f, 4))[0]
            offset = struct.unpack("<Q", _read_exact(f, 8))[0]
            infos.append((name, dims, ggml_type, offset))
        alignment = int(metadata.get("general.alignment", 32))
        data_start = f.tell()
        data_start += (-data_start) % alignment

        tensors: Dict[str, np.ndarray] = {}
        for name, dims, ggml_type, offset in infos:
            n_elems = int(np.prod(dims))
            np_shape = tuple(reversed(dims))  # ggml ne[0] is fastest
            f.seek(data_start + offset)
            if ggml_type == GGML_F32:
                arr = np.frombuffer(_read_exact(f, 4 * n_elems), np.float32)
            elif ggml_type == GGML_F16:
                # keep f16: the converter uploads checkpoint-native dtypes and
                # casts on device, halving full-scale load transfer bytes
                arr = np.frombuffer(_read_exact(f, 2 * n_elems), np.float16)
            elif ggml_type == GGML_Q8_0:
                n_blocks = -(-n_elems // 32)
                raw = np.frombuffer(_read_exact(f, n_blocks * 34), np.uint8)
                arr = _dequant_q8_0(raw, n_elems)
            elif ggml_type == GGML_Q4_K:
                n_blocks = -(-n_elems // QK_K)
                raw = np.frombuffer(_read_exact(f, n_blocks * Q4_K_BLOCK_BYTES), np.uint8)
                if keep_q4k is not None and keep_q4k(name) and len(dims) == 2:
                    q, scale, minv = _q4_k_components(raw, n_elems)
                    tensors[name] = _int4_leaf_from_q4k(
                        q, scale, minv, out_dim=np_shape[0], in_dim=np_shape[1]
                    )
                    continue
                arr = _dequant_q4_k(raw, n_elems)
            elif ggml_type == GGML_Q6_K:
                n_blocks = -(-n_elems // QK_K)
                raw = np.frombuffer(_read_exact(f, n_blocks * Q6_K_BLOCK_BYTES), np.uint8)
                arr = _dequant_q6_k(raw, n_elems)
            else:
                raise ValueError(
                    f"tensor {name}: unsupported ggml type {ggml_type} "
                    "(supported: F32, F16, Q8_0, Q4_K, Q6_K)"
                )
            tensors[name] = arr.reshape(np_shape)
    return metadata, tensors


def gguf_to_lm_config(metadata: Dict[str, Any], **overrides):
    """GGUF llama/qwen2-arch metadata -> DuplexLMConfig."""
    from .llama import DuplexLMConfig

    arch = metadata.get("general.architecture", "llama")

    def m(key, default=None):
        return metadata.get(f"{arch}.{key}", default)

    n_heads = int(m("attention.head_count"))
    hidden = int(m("embedding_length"))
    fields = dict(
        attn_bias=arch == "qwen2",
        vocab_size=int(m("vocab_size", 0)),
        hidden_size=hidden,
        intermediate_size=int(m("feed_forward_length")),
        num_layers=int(m("block_count")),
        num_heads=n_heads,
        num_kv_heads=int(m("attention.head_count_kv", n_heads)),
        head_dim=int(m("rope.dimension_count", hidden // n_heads)),
        rope_theta=float(m("rope.freq_base", 10000.0)),
        rms_eps=float(m("attention.layer_norm_rms_epsilon", 1e-5)),
    )
    # llama.cpp encodes llama3 rope scaling as scaling.type == "yarn"/"linear"
    # or via the original metadata; convert_hf_to_gguf writes the llama3
    # parameters through rope.scaling.* when present
    if m("rope.scaling.type") == "llama3" or m("rope.scaling.factor") is not None:
        fields.update(
            rope_scaling_factor=float(m("rope.scaling.factor", 32.0)),
            rope_scaling_low_freq=float(m("rope.scaling.low_freq_factor", 1.0)),
            rope_scaling_high_freq=float(m("rope.scaling.high_freq_factor", 4.0)),
            rope_scaling_original_max_position=int(
                m("rope.scaling.original_context_length", 8192)
            ),
        )
    fields.update(overrides)
    return DuplexLMConfig(**fields)


_LAYER_MATMULS = (
    "attn_q.weight", "attn_k.weight", "attn_v.weight", "attn_output.weight",
    "ffn_gate.weight", "ffn_up.weight", "ffn_down.weight",
)


def load_gguf_llama(
    path: str, dtype=None, max_context: int = 16384, int4: bool = False,
    **config_overrides,
):
    """Load a llama-arch GGUF file -> (params pytree, DuplexLMConfig).

    The GGUF tensor names (token_embd / blk.N.attn_q / ffn_gate / output ...)
    rename onto the HF layout and flow through the verified HF converter
    (models/convert.lm_params_from_hf), so GGUF and safetensors checkpoints
    share one numeric path.

    ``int4=True`` imports Q4_K layer matmuls as NATIVE int4 decode leaves
    (bit-exact repack, no dequantize/requantize round-trip) — the reference's
    Q4_K_M deployment artifact (prep_test_model.sh:33-34) then runs its
    4-bit weights directly on the TPU fused-dequant kernel. Non-Q4_K layer
    tensors (Q4_K_M keeps some attn_v/ffn_down at Q6_K) still dequantize
    dense; pair with models/llama.quantize_params_int4 to quantize those
    (already-native leaves pass through untouched)."""
    from .convert import lm_params_from_hf

    keep = None
    if int4:
        keep = lambda name: name.startswith("blk.") and name.split(".", 2)[2] in _LAYER_MATMULS
    metadata, tensors = read_gguf(path, keep_q4k=keep)
    arch = metadata.get("general.architecture")
    if arch not in (None, "llama", "qwen2"):
        raise ValueError(f"unsupported GGUF architecture: {arch}")

    rename = {
        "token_embd.weight": "embed_tokens.weight",
        "output_norm.weight": "norm.weight",
        "output.weight": "lm_head.weight",
    }
    per_layer = {
        "attn_norm.weight": "input_layernorm.weight",
        "attn_q.weight": "self_attn.q_proj.weight",
        "attn_k.weight": "self_attn.k_proj.weight",
        "attn_v.weight": "self_attn.v_proj.weight",
        # qwen2 arch carries q/k/v projection biases
        "attn_q.bias": "self_attn.q_proj.bias",
        "attn_k.bias": "self_attn.k_proj.bias",
        "attn_v.bias": "self_attn.v_proj.bias",
        "attn_output.weight": "self_attn.o_proj.weight",
        "ffn_norm.weight": "post_attention_layernorm.weight",
        "ffn_gate.weight": "mlp.gate_proj.weight",
        "ffn_up.weight": "mlp.up_proj.weight",
        "ffn_down.weight": "mlp.down_proj.weight",
    }
    state_dict: Dict[str, np.ndarray] = {}
    for name, arr in tensors.items():
        if name in rename:
            state_dict[rename[name]] = arr
        elif name.startswith("blk."):
            _, idx, rest = name.split(".", 2)
            hf_rest = per_layer.get(rest)
            if hf_rest is None:
                raise ValueError(f"unrecognized GGUF tensor: {name}")
            state_dict[f"layers.{idx}.{hf_rest}"] = arr
        else:
            raise ValueError(f"unrecognized GGUF tensor: {name}")

    vocab = state_dict["embed_tokens.weight"].shape[0]
    cfg = gguf_to_lm_config(
        metadata,
        vocab_size=vocab,
        max_context=max_context,
        tie_embeddings="lm_head.weight" not in state_dict,
        **config_overrides,
    )
    return lm_params_from_hf(state_dict, cfg, dtype=dtype), cfg
