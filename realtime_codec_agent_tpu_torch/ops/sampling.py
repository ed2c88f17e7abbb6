"""Token sampler with llama.cpp sampler-chain semantics, on device tensors.

Port of realtime_codec_agent_tpu/ops/sampling.py, same chain in the same
order: additive logit bias -> repeat/frequency/presence penalties over a
trailing window -> ``min_token_id`` floor -> two-stage exact top-k -> the
dynamic top-k cutoff ``scalars[7]`` -> (greedy) or top-p -> min-p ->
temperature -> categorical draw. Only the sampled id is a result; nothing
syncs with the host.

The categorical draw is ``argmax(scaled + gumbel)``, which is how
``jax.random.categorical`` draws too, with JAX's own noise for the step:
``jax.random.gumbel(jax.random.fold_in(jax.random.PRNGKey(seed), step),
(k,))``, bit for bit in the uniform draws (threefry2x32 on the key and
counter layout JAX uses), so a seeded run samples the JAX engine's tokens,
and fused and stepwise execution of one step draw the same numbers.

Kernel S1 on the card: :func:`sample_token` is the whole draw in one launch
(csrc/sampler.cu), keyed by (seed, step), greedy or sampled decided on the
device; its plain version is :func:`sample_token_plain` (eager ops, the
noise an argument). :func:`gumbel_noise` is S1's noise-only entry
(csrc/threefry.cu, one launch; the step may be a device tensor), with its
plain version :func:`gumbel_noise_plain`: no draw of the port calls it; it
holds csrc/threefry.cuh to the plain noise and is the route S1 replaced in
the timing tool. :func:`sample_plan` is the route and widths both versions
use. :func:`sample_token_rows` draws R rows, each with its own key and
settings, in one launch of S1 (a cluster a row); its plain version is
:func:`sample_token_rows_plain`. A row's key is (seed, step), the key
``PRNGKey(seed)``, or (k1, k2, step), any threefry key data (k1, k2), as
the JAX batched engine draws with ``vmap(fold_in)(row_keys, step)``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.staging import to_device
from . import _cuda

NEG_INF = -1e30

# max simultaneous logit-bias entries (the agent uses one: end_audio suppression)
MAX_BIAS = 4
# llama.cpp penalty_last_n default
PENALTY_WINDOW = 64


@dataclasses.dataclass
class SamplerSettings:
    """Host-side sampler configuration (mirrors init_sampler_for_generate args)."""

    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    temp: float = 0.80
    repeat_penalty: float = 1.0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    logit_bias: Tuple[Tuple[int, float], ...] = ()
    seed: Optional[int] = None
    # restrict sampling to ids >= this value (0 = no restriction); used to pin
    # generation to the codec region (benchmarks, serving guardrails)
    min_token_id: int = 0

    def scalars(self, device="cpu") -> torch.Tensor:
        """Pack the dynamic knobs as one f32 vector (uploaded without a host
        synchronization)."""
        return to_device(
            [
                self.top_p,
                self.min_p,
                self.temp,
                self.repeat_penalty,
                self.frequency_penalty,
                self.presence_penalty,
                float(self.min_token_id),
            ],
            device,
            np.float32,
        )

    def bias_arrays(self, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
        ids = [0] * MAX_BIAS
        vals = [0.0] * MAX_BIAS
        for i, (tid, b) in enumerate(self.logit_bias[:MAX_BIAS]):
            ids[i] = int(tid)
            vals[i] = float(b)
        return to_device(ids, device, np.int64), to_device(vals, device, np.float32)


def apply_penalties(
    logits: torch.Tensor,       # (V,) f32
    window_ids: torch.Tensor,   # (PENALTY_WINDOW,) int
    window_mask: torch.Tensor,  # (PENALTY_WINDOW,) f32 (1 = valid)
    repeat_penalty: torch.Tensor,
    frequency_penalty: torch.Tensor,
    presence_penalty: torch.Tensor,
) -> torch.Tensor:
    """llama.cpp-style penalties over a trailing token window."""
    counts = torch.zeros_like(logits).index_add_(0, window_ids.long(), window_mask)
    present = counts > 0
    repeated = torch.where(logits > 0, logits / repeat_penalty, logits * repeat_penalty)
    out = torch.where(present, repeated, logits)
    return out - counts * frequency_penalty - torch.where(
        present, presence_penalty, torch.zeros_like(presence_penalty)
    )


_TOPK_BLOCK = 256
# kernel S1's launch: a cluster of up to 16 blocks, each staging a slice of
# about this many logits (a multiple of _TOPK_BLOCK) in shared memory
_MAX_BLOCKS = 16
_BLOCK_LOGITS = 16 * 1024
_MAX_K = 1024  # the kernel ranks the top-k with one thread of a block each


@dataclasses.dataclass(frozen=True)
class SamplePlan:
    """The route and widths of one draw, shared by the plain version and the
    kernel's wrapper: ``route`` is top_k_exact's ("direct": ``lax.top_k``
    over the vocab; "two_stage": the k 256-blocks with the largest maxima,
    then the top k of their concatenation), ``k`` the top-k width; the rest
    is the kernel's launch: ``blocks`` blocks of one cluster each owning
    ``slice`` logits, and the ``group``-wide groups whose maxima pick the
    two-stage route's blocks or, on the direct route, bound which logits can
    be in the top-k (0: none)."""

    route: str
    k: int
    group: int
    blocks: int
    slice: int


def sample_plan(vocab: int, k: int) -> SamplePlan:
    """The plan of a draw over ``vocab`` logits at top-k width ``k``
    (:func:`k_for`)."""
    if not 1 <= k <= vocab:
        raise ValueError(f"sample_plan: need 1 <= k <= vocab, got k={k}, vocab={vocab}")
    g = vocab // _TOPK_BLOCK
    two_stage = not (vocab % _TOPK_BLOCK or k > g or vocab < 16 * 1024)
    if two_stage:
        group = _TOPK_BLOCK
    else:  # the widest group that still leaves >= k group maxima
        group = next((w for w in (256, 128, 64, 32) if -(-vocab // w) >= k), 0)
    blocks = min(_MAX_BLOCKS, max(1, -(-vocab // _BLOCK_LOGITS)))
    slice_ = -(-vocab // (blocks * _TOPK_BLOCK)) * _TOPK_BLOCK
    blocks = -(-vocab // slice_)
    return SamplePlan("two_stage" if two_stage else "direct", k, group, blocks, slice_)


def _top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` semantics: descending, equal values in index order."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def top_k_exact(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage exact top-k over a large vocab, with the reference's tie
    rule: pick the k blocks of 256 with the largest maxima (ties: lowest
    block), then the top k of their concatenation in that block order (ties:
    earliest position there). Exact: an element of the true top-k in an
    unselected block would be beaten by the k selected blocks' maxima. The
    route is :func:`sample_plan`'s."""
    if sample_plan(x.shape[0], k).route == "direct":
        return _top_k_stable(x, k)
    xb = x.reshape(-1, _TOPK_BLOCK)
    bmax = torch.amax(xb, dim=1)
    _, bidx = _top_k_stable(bmax, k)
    cand = xb[bidx].reshape(-1)
    vals, ci = _top_k_stable(cand, k)
    idx = bidx[ci // _TOPK_BLOCK] * _TOPK_BLOCK + (ci % _TOPK_BLOCK)
    return vals, idx


def sample_token_plain(
    logits: torch.Tensor,            # (V,) f32
    noise: Optional[torch.Tensor],   # (k,) Gumbel noise; None = greedy
    scalars: torch.Tensor,           # packed SamplerSettings.scalars(), 7 or 8 entries
    bias_ids: torch.Tensor,
    bias_vals: torch.Tensor,
    window_ids: torch.Tensor,
    window_mask: torch.Tensor,
    top_k: int = 100,
    debug: Optional[dict] = None,
) -> torch.Tensor:
    """Plain version of kernel S1: one sampled token id (a 0-dim int64
    tensor on ``logits``' device), the full llama.cpp chain in eager ops;
    ``top_k`` is the width of the top-k stage and ``scalars[7]`` (when
    present) a dynamic top-k cutoff (0 = the full width), as in the JAX
    sampler. With noise, greedy or sampled is picked on the device from
    ``temp <= 0``, as the JAX sampler's ``lax.cond`` does; ``noise=None``
    is greedy. ``debug`` (a dict) receives the top-k values after the cutoff
    ("vals"), their ids ("ids"), the probabilities ("probs") and their
    cumulative sums ("cum")."""
    sample_token_plain.calls += 1
    top_p, min_p, temp, rep, freq, pres, min_id = (scalars[i] for i in range(7))
    logits = logits.to(torch.float32).index_add(0, bias_ids.long(), bias_vals)
    logits = apply_penalties(logits, window_ids, window_mask, rep, freq, pres)
    token_pos = torch.arange(logits.shape[0], device=logits.device, dtype=torch.float32)
    logits = torch.where(token_pos >= min_id, logits, torch.full_like(logits, NEG_INF))

    k = k_for(top_k, logits.shape[0])
    top_vals, top_idx = top_k_exact(logits, k)
    if scalars.shape[0] > 7:
        dyn_k = scalars[7]
        rank = torch.arange(k, device=logits.device, dtype=torch.float32)
        top_vals = torch.where((dyn_k <= 0) | (rank < dyn_k), top_vals, torch.full_like(top_vals, NEG_INF))
    if noise is None and debug is None:
        return top_idx[0]
    probs = torch.softmax(top_vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    if debug is not None:
        debug.update(vals=top_vals, ids=top_idx, probs=probs, cum=cum)
    if noise is None:
        return top_idx[0]
    # top-p: keep the smallest prefix with cumulative mass >= top_p
    keep = (cum - probs) < top_p
    # min-p: drop tokens below min_p * max_prob
    keep &= probs >= min_p * probs[0]
    keep[:1].fill_(True)  # a device fill: assigning a Python scalar would upload it
    scaled = torch.where(keep, top_vals / torch.clamp(temp, min=1e-6), torch.full_like(top_vals, NEG_INF))
    choice = torch.argmax(scaled + noise)
    choice = torch.where(temp <= 0, torch.zeros_like(choice), choice)
    return top_idx[choice.reshape(1)][0]  # a 0-dim index would be read on the host


sample_token_plain.calls = 0


def sample_token(
    logits: torch.Tensor,            # (V,) f32
    noise,                           # (seed, step); on the CPU also a (k,) noise tensor or None (greedy)
    scalars: torch.Tensor,           # packed SamplerSettings.scalars(), 7 or 8 entries
    bias_ids: torch.Tensor,
    bias_vals: torch.Tensor,
    window_ids: torch.Tensor,
    window_mask: torch.Tensor,
    top_k: int = 100,
    debug: Optional[dict] = None,
) -> torch.Tensor:
    """One sampled token id (a 0-dim int64 tensor on ``logits``' device):
    the JAX sampler's draw for the key ``noise = (seed, step)``, i.e. with
    the Gumbel noise of ``fold_in(PRNGKey(seed), step)`` (``step`` a host
    int or one int32/int64 on the device); greedy when ``temp <= 0``, decided
    on the device. On the card kernel S1 (csrc/sampler.cu): the whole draw
    in one launch, nothing read on the host; it takes int64 ids, f32 logits,
    values and masks, and raises on anything else. On the CPU the plain
    version, with the noise of :func:`gumbel_noise_plain`; there ``noise``
    may also be the noise tensor itself or None (greedy). ``debug`` (a dict)
    receives the top-k values after the cutoff ("vals"), their ids ("ids")
    and probabilities ("probs"); the plain version also "cum"."""
    if logits.device.type == "cpu":
        if isinstance(noise, tuple):
            seed, step = noise
            noise = gumbel_noise_plain(seed, step, k_for(top_k, logits.shape[0]), logits.device)
        return sample_token_plain(logits, noise, scalars, bias_ids, bias_vals, window_ids, window_mask, top_k,
                                  debug)
    if logits.device.type != "cuda":
        raise ValueError(f"sample_token: unsupported device {logits.device}")
    out = _launch(logits, noise, scalars, bias_ids, bias_vals, window_ids, window_mask, top_k, debug)
    sample_token.launches += 1
    return out


sample_token.launches = 0


def _launch(logits, noise, scalars, bias_ids, bias_vals, window_ids, window_mask, top_k, debug):
    """Checks the arguments and launches the draw; returns the id tensor."""
    if not (isinstance(noise, tuple) and len(noise) == 2):
        raise ValueError("sample_token: on the card the kernel draws its own noise: pass (seed, step)")
    seed, step = noise
    tensors = (logits, scalars, bias_ids, bias_vals, window_ids, window_mask)
    if any(t.device != logits.device for t in tensors):
        raise ValueError("sample_token: every tensor must be on the logits' device")
    for t, dtype, what in zip(tensors, (torch.float32, torch.float32, torch.int64, torch.float32, torch.int64,
                                        torch.float32), ("logits", "scalars", "bias_ids", "bias_vals",
                                                         "window_ids", "window_mask")):
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"sample_token: {what} must be a contiguous 1-D {dtype} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if not 7 <= scalars.shape[0] <= 8 or bias_ids.shape != bias_vals.shape or window_ids.shape != window_mask.shape:
        raise ValueError("sample_token: scalars take 7 or 8 entries; ids and values / masks must match")
    v = logits.shape[0]
    plan = sample_plan(v, k_for(top_k, v))
    if plan.k > _MAX_K:
        raise ValueError(f"sample_token: the kernel takes a top-k width of at most {_MAX_K}, got {plan.k}")
    step_ptr, step_kind, step_host = None, 0, 0
    if isinstance(step, torch.Tensor):
        _step_value(step, logits.device)  # validates
        step_ptr, step_kind = step.data_ptr(), 1 if step.dtype == torch.int32 else 2
    else:
        step_host = int(step) & _M32
    out = torch.empty((), dtype=torch.int64, device=logits.device)
    dbg = (None, None, None)
    if debug is not None:
        dbg = (torch.empty((plan.k,), dtype=torch.float32, device=logits.device),
               torch.empty((plan.k,), dtype=torch.int64, device=logits.device),
               torch.empty((plan.k,), dtype=torch.float32, device=logits.device))
        debug.update(vals=dbg[0], ids=dbg[1], probs=dbg[2])
    key = prng_key(seed)
    ptrs = (ctypes.c_void_p * 11)(
        logits.data_ptr(), scalars.data_ptr(), bias_ids.data_ptr(), bias_vals.data_ptr(), window_ids.data_ptr(),
        window_mask.data_ptr(), step_ptr, out.data_ptr(), *(None if t is None else t.data_ptr() for t in dbg),
    )
    ints = (ctypes.c_longlong * 13)(
        v, plan.k, scalars.shape[0], bias_ids.shape[0], window_ids.shape[0], int(plan.route == "two_stage"),
        plan.group, plan.blocks, plan.slice, key[0], key[1], step_kind, step_host,
    )
    _cuda.check(_cuda.load().rtca_sample_token(ptrs, ints, _cuda.stream_handle(logits.device)), "sample_token")
    return out


def row_key(row) -> Tuple[Tuple[int, int], int]:
    """(key data, step) of one row of a rows draw's keys: (seed, step) is
    the key ``PRNGKey(seed)``, (k1, k2, step) the key (k1, k2)."""
    if len(row) == 2:
        return prng_key(row[0]), int(row[1])
    return (int(row[0]) & _M32, int(row[1]) & _M32), int(row[2])


def sample_token_rows_plain(
    logits: torch.Tensor,       # (R, V) f32
    keys: torch.Tensor,         # (R, 2) int64 (seed, step) or (R, 3) (k1, k2, step), a row each
    scalars: torch.Tensor,      # (R, 7 or 8) f32
    bias_ids: torch.Tensor,     # (R, nb)
    bias_vals: torch.Tensor,
    window_ids: torch.Tensor,   # (R, W)
    window_mask: torch.Tensor,
    top_k: int = 100,
) -> torch.Tensor:
    """Plain version of kernel S1 over rows: row r is
    :func:`sample_token_plain` of its own inputs with JAX's Gumbel noise for
    ``fold_in(key_r, step_r)`` (:func:`row_key`), as ``jax.vmap`` of the
    JAX sampler over rows draws. Returns (R,) int64 on ``logits``' device."""
    sample_token_rows_plain.calls += 1
    k = k_for(top_k, logits.shape[1])
    out = []
    for r, row in enumerate(keys.tolist()):
        key, step = row_key(row)
        noise = key_gumbel_noise_plain(key, step, k, logits.device)
        out.append(sample_token_plain(logits[r], noise, scalars[r], bias_ids[r], bias_vals[r], window_ids[r],
                                      window_mask[r], top_k))
    return torch.stack(out)


sample_token_rows_plain.calls = 0


def sample_token_rows(
    logits: torch.Tensor,       # (R, V) f32, each row contiguous
    keys: torch.Tensor,         # (R, 2) (seed, step) or (R, 3) (k1, k2, step) int64 on the logits' device
    scalars: torch.Tensor,      # (R, 7 or 8) f32
    bias_ids: torch.Tensor,     # (R, nb) int64
    bias_vals: torch.Tensor,    # (R, nb) f32
    window_ids: torch.Tensor,   # (R, W) int64
    window_mask: torch.Tensor,  # (R, W) f32
    top_k: int = 100,
    debug: Optional[dict] = None,
) -> torch.Tensor:
    """R sampled ids (an (R,) int64 tensor on ``logits``' device): row r is
    :func:`sample_token` of its own logits, settings and window with the key
    of ``keys[r]``: (seed, step), or (k1, k2, step) for the threefry key data
    (k1, k2) (:func:`row_key`), the step read on the device; the counterpart
    of the JAX package's ``jax.vmap(sample_token)`` over rows
    (``lm/pair_session.py``, ``lm/batched_engine.py``). On the card
    kernel S1 in one launch, a cluster a row, the same plan for every row
    (``debug`` then receives (R, k) "vals", "ids" and "probs"); nothing is
    read on the host. On the CPU :func:`sample_token_rows_plain`."""
    if logits.device.type == "cpu":
        return sample_token_rows_plain(logits, keys, scalars, bias_ids, bias_vals, window_ids, window_mask, top_k)
    if logits.device.type != "cuda":
        raise ValueError(f"sample_token_rows: unsupported device {logits.device}")
    out = _launch_rows(logits, keys, scalars, bias_ids, bias_vals, window_ids, window_mask, top_k, debug)
    sample_token_rows.launches += 1
    return out


sample_token_rows.launches = 0


def _launch_rows(logits, keys, scalars, bias_ids, bias_vals, window_ids, window_mask, top_k, debug):
    """Checks the rows' arguments and launches their draws; returns the ids."""
    if logits.dim() != 2 or logits.dtype != torch.float32 or logits.stride(1) != 1:
        raise ValueError(f"sample_token_rows: logits must be (R, V) f32 with contiguous rows, got {logits.dtype} "
                         f"{tuple(logits.shape)} strides {logits.stride()}")
    r, v = logits.shape
    tensors = (keys, scalars, bias_ids, bias_vals, window_ids, window_mask)
    if any(t.device != logits.device for t in tensors):
        raise ValueError("sample_token_rows: every tensor must be on the logits' device")
    for t, dtype, what in zip(tensors, (torch.int64, torch.float32, torch.int64, torch.float32, torch.int64,
                                        torch.float32), ("keys", "scalars", "bias_ids", "bias_vals", "window_ids",
                                                         "window_mask")):
        if t.dtype != dtype or t.dim() != 2 or t.shape[0] != r or not t.is_contiguous():
            raise ValueError(f"sample_token_rows: {what} must be a contiguous ({r}, n) {dtype} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if keys.shape[1] not in (2, 3) or not 7 <= scalars.shape[1] <= 8 or bias_ids.shape != bias_vals.shape or (
            window_ids.shape != window_mask.shape):
        raise ValueError("sample_token_rows: keys take (seed, step) or (k1, k2, step), scalars 7 or 8 entries; ids "
                         "and values / masks must match")
    plan = sample_plan(v, k_for(top_k, v))
    if plan.k > _MAX_K:
        raise ValueError(f"sample_token_rows: the kernel takes a top-k width of at most {_MAX_K}, got {plan.k}")
    out = torch.empty((r,), dtype=torch.int64, device=logits.device)
    dbg = (None, None, None)
    if debug is not None:
        dbg = (torch.empty((r, plan.k), dtype=torch.float32, device=logits.device),
               torch.empty((r, plan.k), dtype=torch.int64, device=logits.device),
               torch.empty((r, plan.k), dtype=torch.float32, device=logits.device))
        debug.update(vals=dbg[0], ids=dbg[1], probs=dbg[2])
    ptrs = (ctypes.c_void_p * 12)(
        logits.data_ptr(), scalars.data_ptr(), bias_ids.data_ptr(), bias_vals.data_ptr(), window_ids.data_ptr(),
        window_mask.data_ptr(), None, out.data_ptr(), *(None if t is None else t.data_ptr() for t in dbg),
        keys.data_ptr(),
    )
    ints = (ctypes.c_longlong * 16)(
        v, plan.k, scalars.shape[1], bias_ids.shape[1], window_ids.shape[1], int(plan.route == "two_stage"),
        plan.group, plan.blocks, plan.slice, 0, 0, 0, 0, r, logits.stride(0), keys.shape[1],
    )
    _cuda.check(_cuda.load().rtca_sample_token_rows(ptrs, ints, _cuda.stream_handle(logits.device)),
                "sample_token_rows")
    return out


def k_for(top_k: int, vocab: int) -> int:
    """Width of the top-k stage (and of the Gumbel noise) for a setting."""
    return max(1, min(top_k if top_k > 0 else 1024, vocab))


# ---------------------------------------------------------------- JAX's noise
#
# What JAX computes for jax.random.gumbel(fold_in(PRNGKey(seed), step), (k,))
# with its default settings (32-bit mode, jax_threefry_partitionable=True,
# gumbel mode "low"), read from jax/_src (JAX 0.9.0):
#
# - PRNGKey(seed): prng.random_seed (prng.py:549) makes an int64 array of a
#   Python int, which 32-bit mode canonicalizes to int32 (the low 32 bits);
#   _threefry_seed (prng.py:817) then gives the key (seed >> 32, seed &
#   0xFFFFFFFF) of that int32: (0, seed mod 2^32).
# - fold_in(key, step): _threefry_fold_in (prng.py:1168) hashes the counter
#   pair threefry_seed(uint32(step)) = (0, step): the new key is
#   threefry2x32(key, (0, step)) (threefry_2x32, prng.py:1092).
# - random_bits(key, 32, (k,)): _threefry_random_bits_partitionable
#   (prng.py:1184) hashes the counters iota_2x32_shape (prng.py:989) = (hi 0,
#   lo i) and returns bits1 ^ bits2.
# - uniform(minval=tiny, maxval=1) (random._uniform, random.py:435): the top
#   23 bits as the mantissa of a float in [1, 2), minus 1, times
#   (1 - tiny) = 1, plus tiny, clamped below at tiny.
# - gumbel "low" (random._gumbel, random.py:1723): -log(-log(u)).
# - categorical (random.py:1739) is argmax(logits + gumbel(key, (k,))).
#
# threefry2x32 is _threefry2x32_lowering (prng.py:883): 20 rounds with the
# rotations (13, 15, 26, 6) / (17, 29, 16, 24) and a key injection every 4.

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny
_ONE_BITS = 0x3F800000  # 1.0f


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of the counter pair (x1, x2) under the key
    (k1, k2); uint32 values held in int64 tensors (or Python ints), so the
    same code runs on the CPU and the card. Returns the pair."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)``'s key data in JAX's 32-bit mode."""
    return 0, int(seed) & _M32


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: ``data`` a Python int or an
    integer tensor (its low 32 bits)."""
    return threefry2x32(key[0], key[1], 0, data & _M32)


def uniform_bits(key, k: int, device) -> torch.Tensor:
    """The 32 random bits per element of ``jax.random.uniform(key, (k,))``
    (the partitionable counter layout), as int64 (k,)."""
    i = torch.arange(k, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return b1 ^ b2


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``uniform(minval=tiny, maxval=1)``'s float from its bits, f32."""
    f = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.full((), _F32_TINY, dtype=torch.float32, device=bits.device)  # a device fill: no upload
    return torch.maximum(tiny, f * (1.0 - tiny) + tiny)


def _step_value(step, device):
    """A host int, or an int32/int64 tensor of one element on ``device``, as
    an int64 value (a Python int or a 0-dim tensor)."""
    if isinstance(step, torch.Tensor):
        if step.numel() != 1 or step.dtype not in (torch.int32, torch.int64) or step.device != torch.device(device):
            raise ValueError(f"gumbel_noise: a step tensor must be one int32/int64 value on {device}")
        return step.reshape(()).to(torch.int64)
    return int(step)


def gumbel_noise_plain(seed: int, step, k: int, device, return_uniform: bool = False):
    """Plain version of kernel S1: ``jax.random.gumbel(fold_in(PRNGKey(seed),
    step), (k,))`` in f32, with threefry on int64 tensors (see the notes
    above); ``step`` a host int or a one-element int tensor on ``device``.
    With ``return_uniform`` returns (u, noise)."""
    gumbel_noise_plain.calls += 1
    return key_gumbel_noise_plain(prng_key(seed), step, k, device, return_uniform)


gumbel_noise_plain.calls = 0


def key_gumbel_noise_plain(key, step, k: int, device, return_uniform: bool = False):
    """``jax.random.gumbel(fold_in(key, step), (k,))`` in f32 for the
    threefry key data ``key`` = (k1, k2) (uint32 values as Python ints); as
    :func:`gumbel_noise_plain`, which is this at ``prng_key(seed)``."""
    device = torch.device(device)
    folded = fold_in(key, _step_value(step, device))
    u = uniform_from_bits(uniform_bits(folded, k, device))
    g = -torch.log(-torch.log(u))
    return (u, g) if return_uniform else g


def gumbel_noise(seed: int, step: Union[int, torch.Tensor], k: int, device, return_uniform: bool = False):
    """JAX's Gumbel noise (k,) f32 of sampler step ``step`` under ``seed``: a
    pure function of (seed, step), the same numbers on every execution path.
    For the card S1's noise-only kernel (one launch; ``step`` a host int or
    a device int32/int64 tensor, read on the device), for the CPU the plain
    version. With ``return_uniform`` returns (u, noise), u the uniform
    draws. The port's draws take their noise inside :func:`sample_token`;
    this entry holds csrc/threefry.cuh to :func:`gumbel_noise_plain` and is
    the old route that tools/sampler_times.py times beside the kernel."""
    device = torch.device(device)
    if device.type == "cpu":
        return gumbel_noise_plain(seed, step, k, device, return_uniform)
    if device.type != "cuda":
        raise ValueError(f"gumbel_noise: unsupported device {device}")
    if k < 1:
        raise ValueError(f"gumbel_noise: need k >= 1, got {k}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    step_ptr, step_kind, step_host = None, 0, 0
    if isinstance(step, torch.Tensor):
        _step_value(step, device)  # validates
        step_ptr, step_kind = step.data_ptr(), 1 if step.dtype == torch.int32 else 2
    else:
        step_host = int(step) & _M32
    g = torch.empty((k,), dtype=torch.float32, device=device)
    u = torch.empty((k,), dtype=torch.float32, device=device) if return_uniform else None
    key = prng_key(seed)
    err = _cuda.load().rtca_threefry_gumbel(
        key[0], key[1], step_ptr, step_kind, step_host, k,
        None if u is None else u.data_ptr(), g.data_ptr(), _cuda.stream_handle(device),
    )
    _cuda.check(err, "gumbel_noise")
    gumbel_noise.launches += 1
    return (u, g) if return_uniform else g


gumbel_noise.launches = 0


def make_window(input_ids: Sequence[int], n: int = PENALTY_WINDOW, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build the trailing penalty window arrays from a host-side id list."""
    tail = [int(t) for t in input_ids[-n:]] if n else []
    pad = n - len(tail)
    ids = torch.tensor(tail + [0] * pad, dtype=torch.int64, device=device)
    mask = torch.tensor([1.0] * len(tail) + [0.0] * pad, dtype=torch.float32, device=device)
    return ids, mask
