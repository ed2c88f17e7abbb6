"""Codec-Llama duplex LM, decode side, in PyTorch.

Port of the decode half of realtime_codec_agent_tpu/models/llama.py. Params
are the same pytree (dicts and a per-layer list, weights ``(in, out)``,
int8 leaves ``{"q": int8 (in, out), "s": f32 (out,)}``); the KV cache keeps the
``(L, B, S, KH, Dh)`` layout. ``forward_decode`` attends a READ-ONLY cache
plus a small window of new keys and returns the new K/V; the caller commits
them with ``commit_kv`` or ``commit_kv_scatter`` (in place).

Attention for T < 9 query tokens (every decode step) sends the cache piece
through kernel B3 (ops/decode_attention.py) and folds the window in with the
online-softmax merge; T >= 9 (prefill buckets) stays plain torch, block by
block, as the JAX package leaves it to XLA. Not ported here: the cacheless
``forward`` (scoring, training) and the pair/batched variants.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import nn
from ..ops.decode_attention import decode_attention_partials, merge_window

# queries shorter than this take the cache-partials kernel + merge; longer
# ones the block-by-block online softmax
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
    # training-only knobs of the JAX config, kept so configs convert 1:1
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

def init_lm_params(gen: torch.Generator, cfg: DuplexLMConfig, device="cpu") -> Dict:
    """Random init with the JAX package's distributions (normal * 0.02 for
    matrices, ones for norms); ``gen`` must live on ``device``. No codec
    embedding branch (the agent's deployed model has none)."""
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
    return params


def fuse_lm_params_for_decode(params: Dict) -> Dict:
    """Concat per-layer Q/K/V and gate/up weights along the output axis, so a
    decode layer runs 4 matmuls (qkv, wo, gate|up, down) instead of 7.
    Column-identical to the unfused layout; accepts dense or int8 leaves;
    already-fused layers pass through."""

    def cat(ws):
        if isinstance(ws[0], dict) and "q" in ws[0]:
            return {
                "q": torch.cat([w["q"] for w in ws], dim=1).contiguous(),
                "s": torch.cat([w["s"] for w in ws], dim=0).contiguous(),
            }
        if isinstance(ws[0], dict):
            raise NotImplementedError(f"fuse: weight leaf with keys {sorted(ws[0])} is not ported yet")
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
) -> torch.Tensor:
    """Joint softmax over cache + new keys without a concatenated key
    tensor or head-repeated cache copies."""
    b, t, h, dh = q.shape
    kh = k_big.shape[2]
    g = h // kh
    scale = dh ** -0.5
    qg = q.reshape(b, t, kh, g, dh).to(torch.float32)

    s_new = torch.einsum("btkgd,bwkd->bkgtw", qg, k_new.to(torch.float32)) * scale
    m_new = new_pos[:, None, :] <= q_pos[:, :, None]  # (B?, T, W)
    s_new = torch.where(m_new[:, None, None], s_new, torch.full_like(s_new, NEG_INF))

    if t < FLASH_DECODE_MIN_T:
        # cache piece: kernel B3 partials per row, then the window merge
        outs = []
        for bi in range(b):
            rows = qg[bi].permute(1, 2, 0, 3).reshape(kh, g * t, dh)  # row = g_idx * T + t
            cv = cache_valid[min(bi, cache_valid.shape[0] - 1)]
            m, l, acc = decode_attention_partials(rows, k_big[bi], v_big[bi], cv, scale)
            out = merge_window(
                m.reshape(kh, g, t, 1), l.reshape(kh, g, t, 1), acc.reshape(kh, g, t, dh),
                s_new[bi], v_new[bi].permute(1, 0, 2)[:, None],  # (KH, 1, W, Dh)
            )  # (KH, G, T, Dh)
            outs.append(out.permute(2, 0, 1, 3).reshape(t, h, dh))
        return torch.stack(outs).to(q.dtype)

    # ---- prefill: online softmax over key blocks ----
    s = k_big.shape[1]
    block = 1024
    n_blocks = -(-s // block)
    cv = cache_valid[:, None, None]
    m = torch.full((b, kh, g, t, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kh, g, t, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kh, g, t, dh), dtype=torch.float32, device=q.device)
    # only key blocks a query can see (the valid cache never extends past
    # max(q_pos)); a host read, fine for the once-per-prefill path
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
            q, k_cache[li], v_cache[li], k_small, v_small, positions, small_pos, cache_valid
        )
        attn = nn.qdot(attn.reshape(b, t, cfg.q_dim), blk["wo"], out_dtype=dtype)
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
