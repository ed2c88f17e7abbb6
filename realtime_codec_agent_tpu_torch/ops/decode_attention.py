"""GQA decode attention over the KV cache prefix (kernel B3), its plain
version, and the online-softmax merge with the small window of new keys.

Port of realtime_codec_agent_tpu/ops/decode_attention.py. The contract is the
Pallas kernel's: queries ``qg (KH, G*T, Dh)`` (rotated, not pre-scaled) attend
the cache keys at index < ``cache_valid`` and come back as flash partials
``m, l (KH, G*T, 1)`` and ``acc (KH, G*T, Dh)``, all f32. Caller invariant
(every decode path keeps it): each query position is >= cache_valid, so the
causal mask over cache keys reduces to ``index < cache_valid``.

In the JAX package this kernel stayed off the main path (XLA's one-shot einsum
won on the TPU); in the port models/llama._gqa_two_piece_attention routes the
cache piece of every small-T attention through it and folds the new keys in
with :func:`merge_window`.

``cache_valid`` is a device int32 tensor: the CUDA kernel reads it on the
device (no host sync), and blocks past the valid prefix return at once.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from . import _cuda

MAX_ROWS = 32   # G*T query rows per KV head the CUDA kernel takes
HEAD_DIM = 64   # head dim the CUDA kernel is written for
_CHUNK = 64     # keys per block in csrc/decode_attention.cu
NEG_INF = -1e30


def decode_attention_partials_plain(
    qg: torch.Tensor,
    k_big: torch.Tensor,
    v_big: torch.Tensor,
    cache_valid: Union[int, torch.Tensor],
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version, in f32: masked scores over the whole cache. With no
    valid key it returns m = -1e30, l = 0, acc = 0, like the kernel."""
    decode_attention_partials_plain.calls += 1
    s = k_big.shape[0]
    qf = qg.to(torch.float32) * scale
    scores = torch.einsum("hgd,shd->hgs", qf, k_big.to(torch.float32))
    cv = torch.as_tensor(cache_valid, device=qg.device).reshape(())
    live = torch.arange(s, device=qg.device) < cv
    scores = torch.where(live, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("hgs,shd->hgd", p, v_big.to(torch.float32))
    return m, l, acc


decode_attention_partials_plain.calls = 0


def decode_attention_partials(
    qg: torch.Tensor,          # (KH, G*T, Dh) rotated queries (NOT pre-scaled)
    k_big: torch.Tensor,       # (S, KH, Dh) cache keys
    v_big: torch.Tensor,       # (S, KH, Dh)
    cache_valid: Union[int, torch.Tensor],  # keys at index < this are attended
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash partials of the queries against the valid cache prefix: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if qg.device.type == "cpu":
        return decode_attention_partials_plain(qg, k_big, v_big, cache_valid, scale)
    if qg.device.type != "cuda":
        raise ValueError(f"decode_attention_partials: unsupported device {qg.device}")
    kh, gt, dh = qg.shape
    s = k_big.shape[0]
    if dh != HEAD_DIM or not 1 <= gt <= MAX_ROWS:
        raise ValueError(f"decode_attention_partials: need Dh == {HEAD_DIM} and 1..{MAX_ROWS} rows per head, got {tuple(qg.shape)}")
    if k_big.shape != (s, kh, dh) or v_big.shape != (s, kh, dh):
        raise ValueError(f"decode_attention_partials: cache must be (S, {kh}, {dh}), got {tuple(k_big.shape)}, {tuple(v_big.shape)}")
    if k_big.dtype not in (torch.bfloat16, torch.float32) or v_big.dtype != k_big.dtype:
        raise ValueError("decode_attention_partials: cache must be bfloat16 or float32")
    if not (k_big.is_contiguous() and v_big.is_contiguous()) or k_big.data_ptr() % 16 or v_big.data_ptr() % 16:
        raise ValueError("decode_attention_partials: cache must be contiguous and 16-byte aligned")
    if k_big.device != qg.device or v_big.device != qg.device:
        raise ValueError("decode_attention_partials: queries and cache must be on the same device")
    if isinstance(cache_valid, torch.Tensor):
        if cache_valid.device != qg.device or cache_valid.numel() != 1:
            raise ValueError("decode_attention_partials: cache_valid must be one value on the queries' device")
        cv = cache_valid.to(torch.int32).reshape(1)
    else:
        cv = torch.tensor([int(cache_valid)], dtype=torch.int32, device=qg.device)
    dev = qg.device
    q = (qg.to(torch.float32) * scale).contiguous()
    n_chunks = -(-s // _CHUNK)
    part_ml = torch.empty((2, kh, n_chunks, gt), dtype=torch.float32, device=dev)
    part_acc = torch.empty((kh, n_chunks, gt, dh), dtype=torch.float32, device=dev)
    m = torch.empty((kh, gt, 1), dtype=torch.float32, device=dev)
    l = torch.empty((kh, gt, 1), dtype=torch.float32, device=dev)
    acc = torch.empty((kh, gt, dh), dtype=torch.float32, device=dev)
    lib = _cuda.load()
    err = lib.rtca_decode_attention(
        q.data_ptr(), k_big.data_ptr(), v_big.data_ptr(), cv.data_ptr(),
        s, kh, gt, int(k_big.dtype == torch.float32),
        part_ml[0].data_ptr(), part_ml[1].data_ptr(), part_acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), _cuda.stream_handle(dev),
    )
    _cuda.check(err, "decode_attention_partials")
    decode_attention_partials.launches += 1
    return m, l, acc


decode_attention_partials.launches = 0


def merge_window(
    m: torch.Tensor,      # (..., 1) f32 cache-piece running max
    l: torch.Tensor,      # (..., 1) f32 denominator
    acc: torch.Tensor,    # (..., Dh) f32 unnormalized P.V
    s_new: torch.Tensor,  # (..., W) f32 masked, scaled scores against the new keys
    v_new: torch.Tensor,  # (..., W, Dh) new values, broadcastable against s_new's rows
) -> torch.Tensor:
    """Online-softmax combine of the cache partials with the small window of
    new keys (the last block of the JAX flash path,
    models/llama._gqa_two_piece_attention); returns the normalized output
    (..., Dh) in f32. A cache piece with l = 0 (cache_valid == 0) drops out
    through corr = exp(-1e30 - m_fin) = 0."""
    m_fin = torch.maximum(m, s_new.amax(dim=-1, keepdim=True))
    p_new = torch.exp(s_new - m_fin)
    corr = torch.exp(m - m_fin)
    l = l * corr + p_new.sum(dim=-1, keepdim=True)
    # the JAX path rounds the window probabilities to the value dtype
    pv = torch.matmul(p_new.to(v_new.dtype).to(torch.float32), v_new.to(torch.float32))
    acc = acc * corr + pv
    return acc / torch.clamp(l, min=1e-30)
