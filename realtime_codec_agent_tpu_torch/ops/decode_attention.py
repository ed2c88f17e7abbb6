"""GQA decode attention for T < 9 query tokens (kernel B3): the whole
two-piece attention -- the valid cache prefix plus the small window of new
keys, in one softmax -- and its plain version.

Port of realtime_codec_agent_tpu/ops/decode_attention.py and of the small-T
branch of realtime_codec_agent_tpu/models/llama._gqa_two_piece_attention. In
the JAX package the Pallas partials kernel stayed off the main path and XLA
computed the small-T attention in one shot; here :func:`decode_attention`
computes that same function:

- q ``(B, T, H, Dh)`` rotated, not scaled; ``k_big``/``v_big`` ``(B, S, KH,
  Dh)``; the window ``k_new``/``v_new`` ``(B, W, KH, Dh)``; ``q_pos`` ``(Bq,
  T)``, ``new_pos`` ``(Bn, W)``, ``cache_valid`` ``(Bc,)``, each leading dim
  1 or B;
- cache keys at index < ``cache_valid[b]`` are attended (caller invariant,
  kept by every decode path: each query position is >= cache_valid, so the
  causal mask over the cache reduces to that); window keys where ``new_pos
  <= q_pos`` (``REJECTED_POS`` slots drop out);
- returns ``(B, T, H, Dh)`` in q's dtype.

For CUDA tensors it is one launch of csrc/decode_attention.cu (``cache_valid``
is read on the device: no host sync, and the call can be captured in a CUDA
graph); for CPU tensors :func:`decode_attention_plain`, which runs the Pallas
contract's plain version (:func:`decode_attention_partials_plain`: flash
partials ``m, l, acc`` of ``qg (KH, G*T, Dh)`` over the cache prefix) per
batch row and folds the window in with :func:`merge_window`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch

from . import _cuda

HEAD_DIMS = (64, 128)  # head dims the CUDA kernel is instantiated for
MAX_ROWS = 64          # G*T query rows per KV head: 4 m-tiles of 16
NEG_INF = -1e30


def decode_attention_partials_plain(
    qg: torch.Tensor,
    k_big: torch.Tensor,
    v_big: torch.Tensor,
    cache_valid: Union[int, torch.Tensor],
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Pallas kernel's contract, in f32: queries ``qg (KH, G*T, Dh)``
    against the cache keys ``(S, KH, Dh)`` at index < ``cache_valid`` as
    flash partials ``m, l (KH, G*T, 1)``, ``acc (KH, G*T, Dh)``. With no
    valid key it returns m = -1e30, l = 0, acc = 0."""
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


def decode_attention_plain(
    q: torch.Tensor,            # (B, T, H, Dh) rotated queries
    k_big: torch.Tensor,        # (B, S, KH, Dh) read-only cache keys
    v_big: torch.Tensor,        # (B, S, KH, Dh)
    k_new: torch.Tensor,        # (B, W, KH, Dh) rotated new keys (extra + self)
    v_new: torch.Tensor,        # (B, W, KH, Dh)
    q_pos: torch.Tensor,        # (Bq, T) absolute query positions
    new_pos: torch.Tensor,      # (Bn, W) absolute positions of the new keys
    cache_valid: torch.Tensor,  # (Bc,) cache indices >= this are stale, per row
) -> torch.Tensor:
    """Plain version: the Pallas contract's partials per batch row, then the
    window merge; (B, T, H, Dh) in q's dtype."""
    decode_attention_plain.calls += 1
    b, t, h, dh = q.shape
    kh = k_big.shape[2]
    g = h // kh
    scale = dh ** -0.5
    qg = q.reshape(b, t, kh, g, dh).to(torch.float32)
    s_new = torch.einsum("btkgd,bwkd->bkgtw", qg, k_new.to(torch.float32)) * scale
    m_new = new_pos[:, None, :] <= q_pos[:, :, None]  # (B?, T, W)
    s_new = torch.where(m_new[:, None, None], s_new, torch.full_like(s_new, NEG_INF))
    outs = []
    for bi in range(b):
        rows = qg[bi].permute(1, 2, 0, 3).reshape(kh, g * t, dh)  # row = g_idx * T + t
        cv = cache_valid[min(bi, cache_valid.shape[0] - 1)]
        m, l, acc = decode_attention_partials_plain(rows, k_big[bi], v_big[bi], cv, scale)
        out = merge_window(
            m.reshape(kh, g, t, 1), l.reshape(kh, g, t, 1), acc.reshape(kh, g, t, dh),
            s_new[bi], v_new[bi].permute(1, 0, 2)[:, None],  # (KH, 1, W, Dh)
        )  # (KH, G, T, Dh)
        outs.append(out.permute(2, 0, 1, 3).reshape(t, h, dh))
    return torch.stack(outs).to(q.dtype)


decode_attention_plain.calls = 0


class Plan(NamedTuple):
    """B3's launch: ``splits`` blocks (one cluster) per (batch row, KV
    head), each with ``kwarps`` key warps per 16-row m-tile."""

    splits: int
    kwarps: int


PLANS = tuple(Plan(s, k) for s in (16, 8, 4, 2, 1) for k in (8, 4, 2, 1))


def plan_fit(rows: int, dh: int, f32: bool, p: Plan) -> Optional[int]:
    """How many clusters of the kernel's launch under ``p`` (``rows`` query
    rows per KV head) the card holds at once, from the built kernel itself
    (csrc/decode_attention.cu ``rtca_decode_attention_plan``: its shared
    memory and the CUDA runtime's occupancy, registers and GPC layout included);
    None when the kernel does not take the plan."""
    out = (ctypes.c_longlong * 2)()
    _cuda.check(_cuda.load().rtca_decode_attention_plan(rows, dh, int(f32), p.splits, p.kwarps, out),
                "decode_attention plan")
    return None if out[0] < 0 else int(out[1])


@functools.lru_cache(maxsize=None)
def plan(bkh: int, rows: int, dh: int, f32: bool = False) -> Plan:
    """B3's grid for ``bkh`` (batch row, KV head) pairs of ``rows`` query
    rows at head dim ``dh``, the rule the sweep of every plan found fastest
    (tools/decode_attention_plan_sweep.py, PERF.md): the most tiles in
    flight per pair (splits x key warps) whose ``bkh`` clusters all fit on
    the card at once (:func:`plan_fit`), since clusters that wait for a
    second wave double the time; on a tie, fewer splits (the cluster's merge
    costs more than the SMs it adds). Past one wave, the most tiles in
    flight of a plan the card can place."""
    best, fallback = None, None
    for p in PLANS:
        fit = plan_fit(rows, dh, f32, p)
        if not fit:  # not taken, or not placeable
            continue
        key = (p.splits * p.kwarps, -p.splits)
        if fallback is None or key > fallback[0]:
            fallback = (key, p)
        if bkh <= fit and (best is None or key > best[0]):
            best = (key, p)
    if fallback is None:
        raise ValueError(f"decode_attention: no launch plan fits {rows} rows at head_dim {dh}")
    return (best or fallback)[1]


_VEC_BYTES = 16


def _rows_aligned(x: torch.Tensor) -> torch.Tensor:
    """The 4-D ``x`` with its last dim contiguous and every row 16-byte
    aligned (the kernel's 16-byte loads), copied only when it is not."""
    if x.data_ptr() % _VEC_BYTES == 0:
        if x.is_contiguous():  # rows of 64 or 128 elements: aligned
            return x
        per = _VEC_BYTES // x.element_size()
        st = x.stride()
        if st[3] == 1 and st[0] % per == 0 and st[1] % per == 0 and st[2] % per == 0:
            return x
    return x.contiguous()


def _lead_stride(x: torch.Tensor) -> int:
    return 0 if x.shape[0] == 1 else x.stride(0)


def decode_attention(
    q: torch.Tensor,
    k_big: torch.Tensor,
    v_big: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    q_pos: torch.Tensor,
    new_pos: torch.Tensor,
    cache_valid: torch.Tensor,
) -> torch.Tensor:
    """The small-T two-piece attention (see the module docstring): one launch
    of the CUDA kernel under :func:`plan` for CUDA tensors, the plain version
    for CPU tensors."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_big, v_big, k_new, v_new, q_pos, new_pos, cache_valid)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    b, t, h, dh = q.shape
    _, s, kh, _ = k_big.shape
    w = k_new.shape[1]
    dt = q.dtype
    if dh not in HEAD_DIMS or h % kh or (h // kh) * t > MAX_ROWS or w < 1:
        raise ValueError(
            f"decode_attention: the kernel takes head_dim {' or '.join(map(str, HEAD_DIMS))}, at most {MAX_ROWS} "
            f"query rows per KV head and at least one new key, got q {tuple(q.shape)}, k_big {tuple(k_big.shape)}, "
            f"k_new {tuple(k_new.shape)}"
        )
    if (v_big.shape != k_big.shape or k_big.shape[0] != b or k_new.shape != (b, w, kh, dh)
            or v_new.shape != k_new.shape):
        raise ValueError(f"decode_attention: need caches (B, S, {kh}, {dh}) and a window (B, W, {kh}, {dh}), got "
                         f"{tuple(k_big.shape)}, {tuple(v_big.shape)}, {tuple(k_new.shape)}, {tuple(v_new.shape)}")
    if (dt is not torch.bfloat16 and dt is not torch.float32) or not (
            k_big.dtype is dt and v_big.dtype is dt and k_new.dtype is dt and v_new.dtype is dt):
        raise ValueError("decode_attention: q, caches and window must all be bfloat16 or all float32")
    if (q_pos.ndim != 2 or q_pos.shape[0] not in (1, b) or q_pos.shape[1] != t or new_pos.ndim != 2
            or new_pos.shape[0] not in (1, b) or new_pos.shape[1] != w or cache_valid.ndim != 1
            or cache_valid.shape[0] not in (1, b)):
        raise ValueError(f"decode_attention: need q_pos (1|B, T), new_pos (1|B, W), cache_valid (1|B,), got "
                         f"{tuple(q_pos.shape)}, {tuple(new_pos.shape)}, {tuple(cache_valid.shape)}")
    if q_pos.dtype not in (torch.int32, torch.int64) or new_pos.dtype not in (torch.int32, torch.int64):
        raise ValueError("decode_attention: positions must be int32 or int64")
    dev = q.device
    if not (k_big.device == dev and v_big.device == dev and k_new.device == dev and v_new.device == dev
            and q_pos.device == dev and new_pos.device == dev and cache_valid.device == dev):
        raise ValueError("decode_attention: every input must be on the queries' device")
    if cache_valid.dtype != torch.int32:
        cache_valid = cache_valid.to(torch.int32)
    q, k_big, v_big = _rows_aligned(q), _rows_aligned(k_big), _rows_aligned(v_big)
    k_new, v_new = _rows_aligned(k_new), _rows_aligned(v_new)
    p = plan(b * kh, (h // kh) * t, dh, dt is torch.float32)
    return _launch(q, k_big, v_big, k_new, v_new, q_pos, new_pos, cache_valid, p)


def _launch(q, k_big, v_big, k_new, v_new, q_pos, new_pos, cache_valid, p: Plan) -> torch.Tensor:
    """One launch of the kernel under ``p`` on inputs :func:`decode_attention`
    has checked (rows 16-byte aligned, ``cache_valid`` int32)."""
    b, t, h, dh = q.shape
    _, s, kh, _ = k_big.shape
    w = k_new.shape[1]
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device)
    ptrs = (ctypes.c_void_p * 9)(
        q.data_ptr(), k_big.data_ptr(), v_big.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        q_pos.data_ptr(), new_pos.data_ptr(), cache_valid.data_ptr(), out.data_ptr(),
    )
    dims = (ctypes.c_longlong * 32)(
        b, t, h, kh, s, w, dh, int(q.dtype is torch.float32), int(q_pos.dtype is torch.int64),
        int(new_pos.dtype is torch.int64), p.splits, p.kwarps,
        *q.stride()[:3], *k_big.stride()[:3], *v_big.stride()[:3], *k_new.stride()[:3], *v_new.stride()[:3],
        _lead_stride(q_pos), q_pos.stride(1), _lead_stride(new_pos), new_pos.stride(1), _lead_stride(cache_valid),
    )
    err = _cuda.load().rtca_decode_attention(ptrs, dims, dh ** -0.5, _cuda.stream_handle(q.device))
    _cuda.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
