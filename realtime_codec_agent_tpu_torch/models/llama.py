"""Codec-Llama duplex LM in PyTorch: the decode side and training mode.

Port of realtime_codec_agent_tpu/models/llama.py. Params are the same pytree
(dicts and a per-layer list, or the stacked ``(L, ...)`` training layout;
weights ``(in, out)``, int8 leaves ``{"q": int8 (in, out), "s": f32 (out,)}``,
affine int4 leaves ``{"q4": uint8 (in / 2, out), "d", "m": f32 (in / 32, out)}``;
an optional ``codec_embed`` branch with the frozen codec table and its
projectors); the KV cache keeps the ``(L, B, S, KH, Dh)`` layout. ``forward_decode`` attends a READ-ONLY cache
plus a small window of new keys and returns the new K/V; the caller commits
them with ``commit_kv`` or ``commit_kv_scatter`` (in place).

Attention for T < 9 query tokens (every decode step) is one call of kernel
B3 (ops/decode_attention.py): the cache prefix and the window of new keys in
one softmax; T >= 9 (prefill buckets) stays plain torch, block by
block, as the JAX package leaves it to XLA. The cacheless ``forward``
(finalize scoring and training) runs ``transformer_layer`` per layer: masked
plain attention up to T = 512, kernel B4 (ops/flash_attention.py, forward and
backward) above, under the remat policy of ``cfg.remat`` /
``cfg.remat_policy``. ``forward_decode_pair`` runs R sessions' steps with
their own caches in one pass over the weights (lm/pair_session.py).
``commit_kv_rows`` is the batched engine's per-row commit
(lm/batched_engine.py).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..ops import nn
from ..ops.decode_attention import decode_attention

# queries shorter than this take kernel B3 (the whole two-piece attention);
# longer ones the block-by-block online softmax
FLASH_DECODE_MIN_T = 9
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class DuplexLMConfig:
    vocab_size: int = 259584
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_layers: int = 16
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 64
    rope_theta: float = 500000.0
    rope_scaling_factor: float = 0.0
    rope_scaling_low_freq: float = 1.0
    rope_scaling_high_freq: float = 4.0
    rope_scaling_original_max_position: int = 8192
    rms_eps: float = 1e-5
    max_context: int = 16384
    tie_embeddings: bool = False
    attn_bias: bool = False
    codec_vocab_start: int = 0  # 0 => vanilla model, no codec routing
    num_codebooks: int = 1
    codebook_size: int = 131072
    codebook_dim: int = 16
    compute_dtype: str = "bfloat16"
    # rematerialize each layer's activations in the backward (training);
    # remat_policy in REMAT_POLICIES, see forward()
    remat: bool = False
    remat_policy: str = "full"

    @property
    def rope_scaling(self):
        if self.rope_scaling_factor <= 0:
            return None
        return (
            self.rope_scaling_factor,
            self.rope_scaling_low_freq,
            self.rope_scaling_high_freq,
            self.rope_scaling_original_max_position,
        )

    @property
    def n_rep(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def llama32_1b_config(vocab_size: int, codec_vocab_start: int = 0, **overrides) -> DuplexLMConfig:
    """Llama-3.2-1B geometry (the reference's duplex LM)."""
    return DuplexLMConfig(
        vocab_size=vocab_size,
        hidden_size=2048,
        intermediate_size=8192,
        num_layers=16,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        rope_theta=500000.0,
        rope_scaling_factor=32.0,
        codec_vocab_start=codec_vocab_start,
        **overrides,
    )


_QWEN25_GEOMETRIES = {
    # hidden, intermediate, layers, heads, kv_heads, tied
    "0.5b": (896, 4864, 24, 14, 2, True),
    "1.5b": (1536, 8960, 28, 12, 2, True),
    "3b": (2048, 11008, 36, 16, 2, True),
    "7b": (3584, 18944, 28, 28, 4, False),
}


def qwen25_config(variant: str, vocab_size: int, codec_vocab_start: int = 0, **overrides) -> DuplexLMConfig:
    """Qwen2.5 geometry (alternative duplex-LM base family). Same graph as
    Llama except q/k/v biases (``attn_bias``), rope theta 1e6, no llama3
    rope scaling; this helper pins the published geometries (head_dim 128
    at 1.5B, 3B and 7B; 64 at 0.5B). ``overrides`` may also replace a
    geometry field (``num_layers=2`` cuts the depth), which the JAX helper
    refuses as a duplicate keyword."""
    h, inter, layers, heads, kv, tied = _QWEN25_GEOMETRIES[variant.lower()]
    fields = dict(
        vocab_size=vocab_size,
        hidden_size=h,
        intermediate_size=inter,
        num_layers=layers,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=h // heads,
        rope_theta=1000000.0,
        rms_eps=1e-6,
        tie_embeddings=tied,
        attn_bias=True,
        codec_vocab_start=codec_vocab_start,
    )
    fields.update(overrides)
    return DuplexLMConfig(**fields)


def tiny_lm_config(vocab_size: int, codec_vocab_start: int = 0, **overrides) -> DuplexLMConfig:
    defaults = dict(
        vocab_size=vocab_size,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        max_context=512,
        codec_vocab_start=codec_vocab_start,
        codebook_size=1024,
    )
    defaults.update(overrides)
    return DuplexLMConfig(**defaults)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_lm_params(gen: torch.Generator, cfg: DuplexLMConfig, device="cpu", with_codec_embed: bool = False) -> Dict:
    """Random init with the JAX package's distributions (normal * 0.02 for
    matrices, ones for norms); ``gen`` must live on ``device``. With
    ``with_codec_embed``, also the codec branch (``init_codec_embed_params``;
    the training model's, the agent's deployed model has none)."""
    dtype = cfg.dtype
    h = cfg.hidden_size

    def rnd(shape):
        return (torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * 0.02).to(dtype)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        blk = {
            "attn_norm": ones(h),
            "wq": rnd((h, cfg.q_dim)),
            "wk": rnd((h, cfg.kv_dim)),
            "wv": rnd((h, cfg.kv_dim)),
            "wo": rnd((cfg.q_dim, h)),
            "mlp_norm": ones(h),
            "w_gate": rnd((h, cfg.intermediate_size)),
            "w_up": rnd((h, cfg.intermediate_size)),
            "w_down": rnd((cfg.intermediate_size, h)),
        }
        if cfg.attn_bias:
            blk["bq"] = torch.zeros((cfg.q_dim,), dtype=dtype, device=device)
            blk["bk"] = torch.zeros((cfg.kv_dim,), dtype=dtype, device=device)
            blk["bv"] = torch.zeros((cfg.kv_dim,), dtype=dtype, device=device)
        layers.append(blk)
    params = {"embed_tokens": rnd((cfg.vocab_size, h)), "layers": layers, "final_norm": ones(h)}
    if not cfg.tie_embeddings:
        params["lm_head"] = rnd((h, cfg.vocab_size))
    if with_codec_embed:
        params["codec_embed"] = init_codec_embed_params(gen, cfg, device)
    return params


def init_codec_embed_params(gen: torch.Generator, cfg: DuplexLMConfig, device="cpu") -> Dict:
    """Frozen f32 codec table ``(num_codebooks * codebook_size, codebook_dim)``
    (standard normal) + per-codebook 2-layer GELU projector (``w1`` normal /
    sqrt(d), ``w2`` normal / sqrt(h), zero biases)."""
    dtype = cfg.dtype
    h, d = cfg.hidden_size, cfg.codebook_dim

    def randn(shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

    table = randn((cfg.num_codebooks * cfg.codebook_size, d))
    projectors = [
        {
            "w1": (randn((d, h)) / math.sqrt(d)).to(dtype),
            "b1": torch.zeros((h,), dtype=dtype, device=device),
            "w2": (randn((h, h)) / math.sqrt(h)).to(dtype),
            "b2": torch.zeros((h,), dtype=dtype, device=device),
        }
        for _ in range(cfg.num_codebooks)
    ]
    return {"table": table, "projectors": projectors}


def stack_layer_params(params: Dict) -> Dict:
    """Per-layer list of dicts -> one dict of ``(L, ...)`` stacked tensors:
    the training layout (one leaf per weight kind: fewer optimizer leaves
    and launches). Already-stacked params pass through."""
    layers = params["layers"]
    if isinstance(layers, dict):
        return params
    out = dict(params)
    out["layers"] = {k: torch.stack([blk[k] for blk in layers]) for k in layers[0]}
    return out


def unstack_layer_params(params: Dict) -> Dict:
    """Inverse of stack_layer_params (training -> inference layout)."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        return params
    n = next(iter(layers.values())).shape[0]
    out = dict(params)
    out["layers"] = [{k: v[i] for k, v in layers.items()} for i in range(n)]
    return out


def _layer_blocks(layers):
    """The per-layer dicts of either layout. The stacked layout is split
    with one ``unbind`` per weight kind, whose backward stacks the layers'
    gradients in one pass."""
    if isinstance(layers, (list, tuple)):
        return list(layers)
    cols = {k: v.unbind(0) for k, v in layers.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def fuse_lm_params_for_decode(params: Dict) -> Dict:
    """Concat per-layer Q/K/V and gate/up weights along the output axis, so a
    decode layer runs 4 matmuls (qkv, wo, gate|up, down) instead of 7.
    Column-identical to the unfused layout; accepts dense, int8 or int4
    leaves (int4: q4, d and m all concatenate on the output axis, equal to
    fusing then quantizing); already-fused layers pass through."""

    def cat(ws):
        if isinstance(ws[0], dict) and "q" in ws[0]:
            return {
                "q": torch.cat([w["q"] for w in ws], dim=1).contiguous(),
                "s": torch.cat([w["s"] for w in ws], dim=0).contiguous(),
            }
        if isinstance(ws[0], dict):
            return {k: torch.cat([w[k] for w in ws], dim=1).contiguous() for k in ("q4", "d", "m")}
        return torch.cat(list(ws), dim=1).contiguous()

    out = dict(params)
    layers = []
    for blk in params["layers"]:
        if "wqkv" in blk:
            layers.append(blk)
            continue
        nblk = {
            k: v for k, v in blk.items()
            if k not in ("wq", "wk", "wv", "w_gate", "w_up", "bq", "bk", "bv")
        }
        nblk["wqkv"] = cat([blk["wq"], blk["wk"], blk["wv"]])
        nblk["w_gu"] = cat([blk["w_gate"], blk["w_up"]])
        if "bq" in blk:
            nblk["bqkv"] = torch.cat([blk["bq"], blk["bk"], blk["bv"]])
        layers.append(nblk)
    out["layers"] = layers
    return out


# decode-path layer matmul leaves eligible for weight quantization
_DECODE_QUANT_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "wqkv", "w_gu")


def _quant8_leaf(w):
    """Per-output-channel symmetric int8: ``s = max(max|w| / 127, 1e-12)``
    per column, ``q = clip(round(w / s), -127, 127)`` (round half to even, as
    ``jnp.round``). Already-quantized dict leaves pass through. The division
    by 127 is a multiplication by the f32 reciprocal, which is what XLA
    compiles ``x / 127.0`` to under ``jax.jit`` (the form the JAX resources
    run), so q and s match bit for bit."""
    if isinstance(w, dict):
        return w
    wf = w.to(torch.float32)
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=wf.device)
    scale = torch.clamp(torch.amax(torch.abs(wf), dim=0) * inv127, min=1e-12)
    q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127).to(torch.int8)
    return {"q": q.contiguous(), "s": scale.contiguous()}


def quantize_params_int8(params: Dict) -> Dict:
    """int8 decode weights (attention projections, MLP, lm_head); embeddings
    and norms stay in their dtype."""
    out = dict(params)
    out["layers"] = [
        {**blk, **{n: _quant8_leaf(blk[n]) for n in _DECODE_QUANT_NAMES if n in blk}}
        for blk in params["layers"]
    ]
    if "lm_head" in params:
        out["lm_head"] = _quant8_leaf(params["lm_head"])
    return out


def _quant4_leaf(w, group: int):
    """Affine int4 per group of ``group`` K rows: ``d = max((max - min) /
    15, 1e-12)``, ``m = -min``, ``q = clip(round((w + m) / d), 0, 15)``
    packed in group-contiguous halves (ops/int4_matmul.py). The division by
    15 is a multiplication by the f32 reciprocal, which is what XLA compiles
    it to under ``jax.jit`` (the form the JAX resources run), so q4, d and m
    match bit for bit. Already-quantized dict leaves pass through."""
    if isinstance(w, dict):
        return w
    wf = w.to(torch.float32)
    k, n = wf.shape
    if k % group or group % 2:
        raise ValueError(f"int4 group {group} must divide K={k}")
    g3 = wf.reshape(k // group, group, n)
    wmin = torch.amin(g3, dim=1)
    inv15 = torch.tensor(1.0 / 15.0, dtype=torch.float32, device=wf.device)
    d = torch.clamp((torch.amax(g3, dim=1) - wmin) * inv15, min=1e-12)
    m = -wmin
    q = torch.clamp(torch.round((g3 + m[:, None, :]) / d[:, None, :]), 0, 15).to(torch.uint8)
    gh = group // 2
    packed = (q[:, :gh, :] | (q[:, gh:, :] << 4)).reshape(k // 2, n)
    return {"q4": packed.contiguous(), "d": d.contiguous(), "m": m.contiguous()}


def quantize_params_int4(params: Dict, group: int = 32) -> Dict:
    """Affine int4 decode weights (the Q4_K_M deployment artifact's
    counterpart): the layer matmuls in groups of ``group`` K rows; the
    lm_head stays int8 (``_quant8_leaf``), embeddings and norms dense."""
    out = dict(params)
    out["layers"] = [
        {**blk, **{n: _quant4_leaf(blk[n], group) for n in _DECODE_QUANT_NAMES if n in blk}}
        for blk in params["layers"]
    ]
    if "lm_head" in params:
        out["lm_head"] = _quant8_leaf(params["lm_head"])
    return out


def _attn_qkv(y, blk, cfg: DuplexLMConfig, dtype):
    """Project y to (q, k, v), fused or not, with optional q/k/v biases."""
    if "wqkv" in blk:
        qkv = nn.qdot(y, blk["wqkv"], out_dtype=dtype)
        if "bqkv" in blk:
            qkv = qkv + blk["bqkv"].to(dtype)
        q = qkv[..., : cfg.q_dim]
        k = qkv[..., cfg.q_dim : cfg.q_dim + cfg.kv_dim]
        v = qkv[..., cfg.q_dim + cfg.kv_dim :]
        return q, k, v
    q = nn.qdot(y, blk["wq"], out_dtype=dtype)
    k = nn.qdot(y, blk["wk"], out_dtype=dtype)
    v = nn.qdot(y, blk["wv"], out_dtype=dtype)
    if "bq" in blk:
        q = q + blk["bq"].to(dtype)
        k = k + blk["bk"].to(dtype)
        v = v + blk["bv"].to(dtype)
    return q, k, v


def _mlp(y, blk, dtype):
    """SwiGLU MLP, fused gate|up or not."""
    if "w_gu" in blk:
        gu = nn.qdot(y, blk["w_gu"])
        g, u = torch.chunk(gu, 2, dim=-1)
        h = (F.silu(g) * u).to(dtype)
        return nn.qdot(h, blk["w_down"], out_dtype=dtype)
    return nn.swiglu_mlp(y, blk["w_gate"], blk["w_up"], blk["w_down"])


def embed_ids(params: Dict, ids: torch.Tensor, cfg: DuplexLMConfig) -> torch.Tensor:
    """Token ids -> hidden states. With a ``codec_embed`` branch, ids >=
    codec_vocab_start take the frozen codec table -> projector route."""
    dtype = cfg.dtype
    codec = params.get("codec_embed")
    ids = ids.long()
    text_ids = ids if codec is None else torch.clamp(ids, max=cfg.codec_vocab_start - 1)
    text_emb = params["embed_tokens"][torch.clamp(text_ids, min=0)]
    if codec is None:
        return text_emb.to(dtype)
    codec_ids = torch.clamp(ids - cfg.codec_vocab_start, 0, codec["table"].shape[0] - 1)
    z = codec["table"][codec_ids].to(dtype)
    proj_outs = [nn.gelu_mlp(z, p["w1"], p["b1"], p["w2"], p["b2"]) for p in codec["projectors"]]
    if cfg.num_codebooks == 1:
        codec_emb = proj_outs[0]
    else:
        cb_idx = codec_ids // cfg.codebook_size
        stacked = torch.stack(proj_outs, dim=0)
        codec_emb = torch.gather(
            stacked, 0, cb_idx[None, ..., None].expand(1, *cb_idx.shape, stacked.shape[-1])
        )[0]
    is_codec = (ids >= cfg.codec_vocab_start)[..., None]
    return torch.where(is_codec, codec_emb, text_emb).to(dtype)


def logits_from_hidden(params: Dict, hidden: torch.Tensor, cfg: DuplexLMConfig) -> torch.Tensor:
    head = params["embed_tokens"].T if cfg.tie_embeddings else params["lm_head"]
    return nn.qdot(hidden, head)


# ---------------------------------------------------------------------------
# Cacheless forward (scoring): full causal self-attention within the ids
# ---------------------------------------------------------------------------

def _layer_qkv(x, blk, cfg: DuplexLMConfig, cos, sin):
    """Pre-norm and the rotated q (B, T, H, Dh), k, v (B, T, KH, Dh)."""
    b, t = x.shape[0], x.shape[1]
    y = nn.rms_norm(x, blk["attn_norm"], cfg.rms_eps)
    q, k, v = _attn_qkv(y, blk, cfg, x.dtype)
    q = q.reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    q, k = nn.apply_rope(q, k, cos, sin)
    return q, k, v


def _layer_attention(q, k, v, cfg: DuplexLMConfig, mask, attn_valid):
    """Long blocks (T > 512) take ``train_attention`` (kernel B4 on the
    card, the KV heads read unrepeated, ``attn_valid`` the key validity);
    shorter ones the masked plain attention."""
    if q.shape[1] > 512:
        return nn.train_attention(q, k, v, valid=attn_valid)
    return nn.attention(q, nn.repeat_kv(k, cfg.n_rep), nn.repeat_kv(v, cfg.n_rep), mask=mask)


def _layer_out(x, attn, blk, cfg: DuplexLMConfig):
    """Output projection, residual, post-norm SwiGLU MLP, residual."""
    b, t = x.shape[0], x.shape[1]
    x = x + nn.qdot(attn.reshape(b, t, cfg.q_dim), blk["wo"], out_dtype=x.dtype)
    y = nn.rms_norm(x, blk["mlp_norm"], cfg.rms_eps)
    return x + _mlp(y, blk, x.dtype)


def transformer_layer(
    x: torch.Tensor,  # (B, T, H)
    blk: Dict,
    cfg: DuplexLMConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: Optional[torch.Tensor] = None,  # (.., T, T) bool, used at T <= 512
    attn_valid: Optional[torch.Tensor] = None,  # (B, T) key validity, used at T > 512
) -> torch.Tensor:
    """One pre-norm decoder layer without a KV cache."""
    q, k, v = _layer_qkv(x, blk, cfg, cos, sin)
    return _layer_out(x, _layer_attention(q, k, v, cfg, mask, attn_valid), blk, cfg)


REMAT_POLICIES = ("full", "dots", "flash", "none")
# the JAX package's "attn" saves the attention context and "flash" the Pallas
# kernel's out and l/m: here both are B4's Function keeping its own residuals
_REMAT_ALIASES = {"attn": "flash"}


def _save_dots(ctx, op, *args, **kwargs):
    """The JAX package's "dots" policy (dots_with_no_batch_dims_saveable):
    the weight matmuls (aten.mm after torch.matmul folds the batch) are
    saved, the batched attention products and all elementwise work are
    recomputed."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _layer_body(cfg: DuplexLMConfig, cos, sin, mask, attn_valid):
    """The layer function under ``cfg.remat`` / ``cfg.remat_policy``. Remat
    changes memory and launches, never values:

    - "none" (or remat off): autograd keeps every activation;
    - "full": the whole layer is recomputed in the backward (B4's forward
      runs twice per layer and step);
    - "dots": the weight matmul outputs are saved, the rest recomputed
      (selective checkpointing);
    - "flash" (and its alias "attn"): the layer is checkpointed in two halves
      around the attention, which is not checkpointed: B4's autograd Function
      keeps its own residuals (q, k, v, out, lse), so the backward recomputes
      the norms, projections, rope and MLP but never B4's forward.
    """
    policy = cfg.remat_policy if cfg.remat else "none"
    policy = _REMAT_ALIASES.get(policy, policy)
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; one of {REMAT_POLICIES} or {sorted(_REMAT_ALIASES)}")

    def plain(x, blk):
        return transformer_layer(x, blk, cfg, cos, sin, mask=mask, attn_valid=attn_valid)

    if policy == "none":
        return plain
    if policy == "full":
        return lambda x, blk: checkpoint(plain, x, blk, use_reentrant=False)
    if policy == "dots":
        ctx_fn = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return lambda x, blk: checkpoint(plain, x, blk, use_reentrant=False, context_fn=ctx_fn)

    def halves(x, blk):
        q, k, v = checkpoint(_layer_qkv, x, blk, cfg, cos, sin, use_reentrant=False)
        attn = _layer_attention(q, k, v, cfg, mask, attn_valid)
        return checkpoint(_layer_out, x, attn, blk, cfg, use_reentrant=False)

    return halves


def forward(
    params: Dict,
    ids: torch.Tensor,  # (B, T)
    cfg: DuplexLMConfig,
    attn_mask: Optional[torch.Tensor] = None,  # (B, T) validity of training batches
) -> torch.Tensor:
    """Cacheless causal forward of ``ids`` at positions 0..T-1; returns the
    final-norm hidden states (B, T, H). Takes the per-layer list or the
    stacked layout, dense, int8 or int4, fused (``wqkv``, ``w_gu``) or not.
    ``attn_mask`` marks the valid tokens: keys outside it are never
    attended (the masked attention up to T = 512, B4's validity mask above)."""
    b, t = ids.shape
    positions = torch.arange(t, device=ids.device)[None, :].expand(b, t)
    x = embed_ids(params, ids, cfg)
    cos, sin = nn.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, rope_scaling=cfg.rope_scaling)
    mask = None
    if t <= 512:
        mask = nn.causal_mask(t, t, 0, device=ids.device)
        if attn_mask is not None:
            mask = mask & attn_mask[:, None, None, :].bool()
    body = _layer_body(cfg, cos, sin, mask, attn_mask)
    for blk in _layer_blocks(params["layers"]):
        x = body(x, blk)
    return nn.rms_norm(x, params["final_norm"], cfg.rms_eps)


# ---------------------------------------------------------------------------
# Decode-path forward: read-only cache + small new-KV, in-place commit
# ---------------------------------------------------------------------------

def _gqa_two_piece_attention(
    q: torch.Tensor,        # (B, T, H, Dh) rotated queries
    k_big: torch.Tensor,    # (B, S, KH, Dh) read-only cache keys
    v_big: torch.Tensor,    # (B, S, KH, Dh)
    k_new: torch.Tensor,    # (B, W, KH, Dh) rotated new keys (extra + self)
    v_new: torch.Tensor,    # (B, W, KH, Dh)
    q_pos: torch.Tensor,    # (Bq, T) absolute query positions, Bq in {1, B}
    new_pos: torch.Tensor,  # (Bn, W) absolute positions of the new keys
    cache_valid: torch.Tensor,  # (Bc,) cache indices >= this are stale, per row
    max_key: Optional[int] = None,  # host bound on the key positions a query may see
) -> torch.Tensor:
    """Joint softmax over cache + new keys without a concatenated key
    tensor or head-repeated cache copies. ``max_key`` (prefill only): the
    largest key position any query can see, ``min(max(q_pos),
    max(cache_valid) + T)``; a caller that knows it from host ints passes it
    so the prefill issues no host read."""
    b, t, h, dh = q.shape
    if t < FLASH_DECODE_MIN_T:
        # kernel B3: the cache prefix and the window in one launch
        return decode_attention(q, k_big, v_big, k_new, v_new, q_pos, new_pos, cache_valid)

    kh = k_big.shape[2]
    g = h // kh
    scale = dh ** -0.5
    qg = q.reshape(b, t, kh, g, dh).to(torch.float32)
    s_new = torch.einsum("btkgd,bwkd->bkgtw", qg, k_new.to(torch.float32)) * scale
    m_new = new_pos[:, None, :] <= q_pos[:, :, None]  # (B?, T, W)
    s_new = torch.where(m_new[:, None, None], s_new, torch.full_like(s_new, NEG_INF))

    # ---- prefill: online softmax over key blocks ----
    s = k_big.shape[1]
    block = 1024
    n_blocks = -(-s // block)
    cv = cache_valid[:, None, None]
    m = torch.full((b, kh, g, t, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kh, g, t, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kh, g, t, dh), dtype=torch.float32, device=q.device)
    # only key blocks a query can see (the valid cache never extends past
    # max(q_pos)); without the caller's bound, a host read
    if max_key is None:
        max_key = int(torch.minimum(q_pos.max(), cache_valid.max() + t))
    n_needed = min(n_blocks, max_key // block + 1)
    for i in range(n_needed):
        k_blk = k_big[:, i * block : (i + 1) * block].to(torch.float32)
        v_blk = v_big[:, i * block : (i + 1) * block]
        width = k_blk.shape[1]
        pos = (i * block + torch.arange(width, device=q.device))[None, None, :]
        sb = torch.einsum("btkgd,bskd->bkgts", qg, k_blk) * scale
        mask = (pos <= q_pos[:, :, None]) & (pos < cv)
        sb = torch.where(mask[:, None, None], sb, torch.full_like(sb, NEG_INF))
        m_blk = torch.maximum(m, sb.amax(dim=-1, keepdim=True))
        p = torch.exp(sb - m_blk)
        corr = torch.exp(m - m_blk)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bkgts,bskd->bkgtd", p.to(v_blk.dtype).to(torch.float32), v_blk.to(torch.float32))
        acc = acc * corr + pv
        m = m_blk
    m_fin = torch.maximum(m, s_new.amax(dim=-1, keepdim=True))
    p_new = torch.exp(s_new - m_fin)
    corr = torch.exp(m - m_fin)
    l = l * corr + p_new.sum(dim=-1, keepdim=True)
    acc = acc * corr + torch.einsum(
        "bkgtw,bwkd->bkgtd", p_new.to(v_new.dtype).to(torch.float32), v_new.to(torch.float32)
    )
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, dh).to(q.dtype)


def forward_decode(
    params: Dict,
    ids: torch.Tensor,        # (B, T)
    cfg: DuplexLMConfig,
    k_cache: torch.Tensor,    # (L, B, S, KH, Dh) read-only
    v_cache: torch.Tensor,
    positions: torch.Tensor,  # (T,) or per-row (B, T) absolute positions
    cache_valid: Optional[torch.Tensor] = None,  # scalar or (B,): valid cache length
    extra_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (L, B, We, KH, Dh) x2
    extra_pos: Optional[torch.Tensor] = None,  # (We,) or (B, We)
    max_key: Optional[int] = None,  # prefill: host bound on the visible key positions
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Incremental forward over a READ-ONLY cache. Attention per layer =
    cache keys at indices < ``cache_valid`` (default: the first new
    position) + ``extra_kv`` (uncommitted keys of earlier steps, masked by
    ``extra_pos``) + the T new tokens (causal among ``positions``). Returns
    (hidden (B, T, H), new_k (L, B, T, KH, Dh), new_v); nothing is written
    into the cache."""
    b, t = ids.shape
    dtype = cfg.dtype
    positions = torch.as_tensor(positions, device=ids.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    if cache_valid is None:
        cache_valid = positions[:, 0]
    cache_valid = torch.as_tensor(cache_valid, device=ids.device).reshape(-1).to(torch.int32)
    if extra_pos is not None:
        extra_pos = torch.as_tensor(extra_pos, device=ids.device)
        if extra_pos.ndim == 1:
            extra_pos = extra_pos[None, :]
    x = embed_ids(params, ids, cfg)
    cos, sin = nn.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, rope_scaling=cfg.rope_scaling)
    if extra_kv is not None:
        rows = max(extra_pos.shape[0], positions.shape[0])
        small_pos = torch.cat(
            [extra_pos.expand(rows, extra_pos.shape[1]), positions.expand(rows, positions.shape[1])],
            dim=1,
        )
    else:
        small_pos = positions

    new_ks, new_vs = [], []
    for li, blk in enumerate(params["layers"]):
        res = x
        y = nn.rms_norm(x, blk["attn_norm"], cfg.rms_eps)
        q, k, v = _attn_qkv(y, blk, cfg, dtype)
        q = q.reshape(b, t, cfg.num_heads, cfg.head_dim)
        k = k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        v = v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        q, k = nn.apply_rope(q, k, cos, sin)
        new_ks.append(k)
        new_vs.append(v)
        if extra_kv is not None:
            k_small = torch.cat([extra_kv[0][li], k], dim=1)
            v_small = torch.cat([extra_kv[1][li], v], dim=1)
        else:
            k_small, v_small = k, v
        attn = _gqa_two_piece_attention(
            q, k_cache[li], v_cache[li], k_small, v_small, positions, small_pos, cache_valid, max_key=max_key,
        )
        attn = nn.qdot(attn.reshape(b, t, cfg.q_dim), blk["wo"], out_dtype=dtype)
        x = res + attn
        res = x
        y = nn.rms_norm(x, blk["mlp_norm"], cfg.rms_eps)
        x = res + _mlp(y, blk, dtype)

    x = nn.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x, torch.stack(new_ks), torch.stack(new_vs)


def forward_decode_pair(
    params: Dict,
    ids: torch.Tensor,        # (R, T) one row per independent session
    cfg: DuplexLMConfig,
    k_caches,                 # sequence of R read-only caches, each (L, 1, S, KH, Dh)
    v_caches,
    positions: torch.Tensor,  # (R, T) per-row absolute positions
    cache_valid: torch.Tensor,  # (R,) per-row valid cache length
    extra_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (L, R, We, KH, Dh) x2
    extra_pos: Optional[torch.Tensor] = None,  # (R, We)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Incremental forward for R sessions with SEPARATE caches: the layer
    matmuls (qkv, wo, gate|up, down; the lm_head is the caller's) run once
    over all R * T rows, one read of the weights, while attention runs per
    row against that row's own cache (kernel B3 for T < 9), so each engine
    keeps its cache to itself. Returns (hidden (R, T, H), new_k (L, R, T,
    KH, Dh), new_v); nothing is written into the caches. Each row computes
    what ``forward_decode`` of that row alone computes (the same
    contractions a row)."""
    r, t = ids.shape
    dtype = cfg.dtype
    positions = torch.as_tensor(positions, device=ids.device)
    cache_valid = torch.as_tensor(cache_valid, device=ids.device).reshape(-1).to(torch.int32)
    x = embed_ids(params, ids, cfg)
    cos, sin = nn.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, rope_scaling=cfg.rope_scaling)

    new_ks, new_vs = [], []
    for li, blk in enumerate(params["layers"]):
        res = x
        y = nn.rms_norm(x, blk["attn_norm"], cfg.rms_eps)
        q, k, v = _attn_qkv(y, blk, cfg, dtype)  # over all rows: one weight read
        q = q.reshape(r, t, cfg.num_heads, cfg.head_dim)
        k = k.reshape(r, t, cfg.num_kv_heads, cfg.head_dim)
        v = v.reshape(r, t, cfg.num_kv_heads, cfg.head_dim)
        q, k = nn.apply_rope(q, k, cos, sin)
        new_ks.append(k)
        new_vs.append(v)

        attn_rows = []
        for ri in range(r):
            kr, vr = k[ri : ri + 1], v[ri : ri + 1]
            pos_r = positions[ri : ri + 1]
            if extra_kv is not None:
                k_small = torch.cat([extra_kv[0][li, ri : ri + 1], kr], dim=1)
                v_small = torch.cat([extra_kv[1][li, ri : ri + 1], vr], dim=1)
                small_pos = torch.cat([extra_pos[ri : ri + 1], pos_r], dim=1)
            else:
                k_small, v_small, small_pos = kr, vr, pos_r
            attn_rows.append(_gqa_two_piece_attention(
                q[ri : ri + 1], k_caches[ri][li], v_caches[ri][li], k_small, v_small, pos_r, small_pos,
                cache_valid[ri : ri + 1],
            ))
        attn = torch.cat(attn_rows, dim=0)
        attn = nn.qdot(attn.reshape(r, t, cfg.q_dim), blk["wo"], out_dtype=dtype)
        x = res + attn
        res = x
        y = nn.rms_norm(x, blk["mlp_norm"], cfg.rms_eps)
        x = res + _mlp(y, blk, dtype)

    x = nn.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x, torch.stack(new_ks), torch.stack(new_vs)


def commit_kv(k_cache, v_cache, new_k, new_v, offset: int):
    """Write (L, B, T, KH, Dh) new K/V at cache positions [offset, offset+T).
    In place (JAX aliases the donated buffers); returns the caches."""
    t = new_k.shape[2]
    k_cache[:, :, offset : offset + t] = new_k
    v_cache[:, :, offset : offset + t] = new_v
    return k_cache, v_cache


def commit_kv_scatter(k_cache, v_cache, new_k, new_v, target_idx: torch.Tensor):
    """Scatter (L, B, W, KH, Dh) new K/V to per-entry cache indices
    ``target_idx`` (W,), in place; returns the caches. Rejected entries
    point at a trash index that is never attended."""
    idx = target_idx.long()
    k_cache[:, :, idx] = new_k
    v_cache[:, :, idx] = new_v
    return k_cache, v_cache


def commit_kv_rows(k_cache, v_cache, new_k, new_v, offsets: torch.Tensor, active: Optional[torch.Tensor] = None):
    """Per-row contiguous commit for batched serving: row b's T new entries
    (L, B, T, KH, Dh) land at [offsets[b], offsets[b] + T), in place; returns
    the caches. With ``active`` (B,) bool, an inactive row's entries all land
    on the trash index S - 1 (never attended; which of them stays there is
    unspecified). One scatter for every row, read from device tensors: no
    host synchronization."""
    b, t = new_k.shape[1], new_k.shape[2]
    rows = torch.arange(b, device=k_cache.device)[:, None]
    idx = offsets.reshape(b, 1).long() + torch.arange(t, device=k_cache.device)[None, :]  # (B, T)
    if active is not None:
        idx = torch.where(active[:, None], idx, torch.full_like(idx, k_cache.shape[2] - 1))
    k_cache[:, rows, idx] = new_k
    v_cache[:, rows, idx] = new_v
    return k_cache, v_cache


# ---------------------------------------------------------------------------
# Embedding bridge (persist path)
# ---------------------------------------------------------------------------

def set_codec_embeddings(params: Dict, codec_table, cfg: DuplexLMConfig) -> Dict:
    """Install the frozen codec table (f32, ``(num_codebooks *
    codebook_size, codebook_dim)``) on the codec branch's device."""
    codec = dict(params["codec_embed"])
    device = codec["table"].device
    table = torch.as_tensor(codec_table, dtype=torch.float32).to(device)
    expected = (cfg.num_codebooks * cfg.codebook_size, cfg.codebook_dim)
    if tuple(table.shape) != expected:
        raise ValueError(f"codec table must have shape {expected}, got {tuple(table.shape)}")
    codec["table"] = table.contiguous()
    out = dict(params)
    out["codec_embed"] = codec
    return out


@torch.no_grad()
def persist_codec_embeddings(params: Dict, cfg: DuplexLMConfig, batch_size: int = 8192) -> Dict:
    """Bake the projected codec vectors into ``embed_tokens`` and drop the
    codec branch: a vanilla Llama param tree. Unties ``lm_head`` first if
    tied, so the codec rows of the output head keep their values."""
    out = dict(params)
    if cfg.tie_embeddings and "lm_head" not in out:
        out["lm_head"] = out["embed_tokens"].T.clone()
        cfg = dataclasses.replace(cfg, tie_embeddings=False)
    codec = out["codec_embed"]
    n = cfg.num_codebooks * cfg.codebook_size
    embed = out["embed_tokens"].detach().clone()
    for start in range(0, n, batch_size):
        ids = torch.arange(start, min(start + batch_size, n), device=embed.device) + cfg.codec_vocab_start
        proj = embed_ids({**out, "codec_embed": codec}, ids, cfg)
        embed[ids] = proj.to(embed.dtype)
    out["embed_tokens"] = embed
    del out["codec_embed"]
    return out
