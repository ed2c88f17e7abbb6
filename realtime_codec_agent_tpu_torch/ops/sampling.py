"""Token sampler with llama.cpp sampler-chain semantics, on device tensors.

Port of realtime_codec_agent_tpu/ops/sampling.py, same chain in the same
order: additive logit bias -> repeat/frequency/presence penalties over a
trailing window -> ``min_token_id`` floor -> two-stage exact top-k -> (greedy)
or top-p -> min-p -> temperature -> categorical draw. Only the sampled id is a
result; nothing syncs with the host.

The categorical draw is ``argmax(scaled + gumbel)``, which is how
``jax.random.categorical`` draws too. The Gumbel noise is an explicit argument:
the engine draws it from a ``torch.Generator`` seeded from ``(seed, step)``
(:func:`gumbel_noise`), so fused and stepwise execution of the same step draw
the same numbers. The numbers differ from JAX's threefry stream; tests feed
both sides the same noise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

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

    def scalars(self, device=None) -> torch.Tensor:
        """Pack the dynamic knobs as one f32 vector."""
        return torch.tensor(
            [
                self.top_p,
                self.min_p,
                self.temp,
                self.repeat_penalty,
                self.frequency_penalty,
                self.presence_penalty,
                float(self.min_token_id),
            ],
            dtype=torch.float32,
            device=device,
        )

    def bias_arrays(self, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        ids = [0] * MAX_BIAS
        vals = [0.0] * MAX_BIAS
        for i, (tid, b) in enumerate(self.logit_bias[:MAX_BIAS]):
            ids[i] = int(tid)
            vals[i] = float(b)
        return (
            torch.tensor(ids, dtype=torch.int64, device=device),
            torch.tensor(vals, dtype=torch.float32, device=device),
        )


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


def _top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` semantics: descending, equal values in index order."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def top_k_exact(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage exact top-k over a large vocab, with the reference's tie
    rule: pick the k blocks of 256 with the largest maxima (ties: lowest
    block), then the top k of their concatenation in that block order (ties:
    earliest position there). Exact: an element of the true top-k in an
    unselected block would be beaten by the k selected blocks' maxima."""
    v = x.shape[0]
    g = v // _TOPK_BLOCK
    if v % _TOPK_BLOCK or k > g or v < 16 * 1024:
        return _top_k_stable(x, k)
    xb = x.reshape(g, _TOPK_BLOCK)
    bmax = torch.amax(xb, dim=1)
    _, bidx = _top_k_stable(bmax, k)
    cand = xb[bidx].reshape(-1)
    vals, ci = _top_k_stable(cand, k)
    idx = bidx[ci // _TOPK_BLOCK] * _TOPK_BLOCK + (ci % _TOPK_BLOCK)
    return vals, idx


def sample_token(
    logits: torch.Tensor,            # (V,) f32
    noise: Optional[torch.Tensor],   # (k,) Gumbel noise; None = greedy (temp <= 0)
    scalars: torch.Tensor,           # packed SamplerSettings.scalars()
    bias_ids: torch.Tensor,
    bias_vals: torch.Tensor,
    window_ids: torch.Tensor,
    window_mask: torch.Tensor,
    top_k: int = 100,
) -> torch.Tensor:
    """One sampled token id (a 0-dim int64 device tensor), full llama.cpp
    chain; ``top_k`` is the width of the top-k stage. The JAX sampler picks
    greedy vs sampled on a traced ``temp <= 0``; here the caller decides on
    the host and passes ``noise=None`` for greedy."""
    top_p, min_p, temp, rep, freq, pres, min_id = (scalars[i] for i in range(7))
    logits = logits.to(torch.float32).index_add(0, bias_ids.long(), bias_vals)
    logits = apply_penalties(logits, window_ids, window_mask, rep, freq, pres)
    token_pos = torch.arange(logits.shape[0], device=logits.device, dtype=torch.float32)
    logits = torch.where(token_pos >= min_id, logits, torch.full_like(logits, NEG_INF))

    k = k_for(top_k, logits.shape[0])
    top_vals, top_idx = top_k_exact(logits, k)
    if noise is None:
        return top_idx[0]
    probs = torch.softmax(top_vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # top-p: keep the smallest prefix with cumulative mass >= top_p
    keep = (cum - probs) < top_p
    # min-p: drop tokens below min_p * max_prob
    keep &= probs >= min_p * probs[0]
    keep[0] = True
    scaled = torch.where(keep, top_vals / torch.clamp(temp, min=1e-6), torch.full_like(top_vals, NEG_INF))
    choice = torch.argmax(scaled + noise)
    return top_idx[choice]


def k_for(top_k: int, vocab: int) -> int:
    """Width of the top-k stage (and of the Gumbel noise) for a setting."""
    return max(1, min(top_k if top_k > 0 else 1024, vocab))


def gumbel_noise(seed: int, step: int, k: int, device) -> torch.Tensor:
    """Standard Gumbel noise (k,) f32 for sampler step ``step``, a pure
    function of (seed, step): every execution path of one step draws the
    same numbers."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
    u = torch.rand((k,), generator=gen, device=device, dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def make_window(input_ids: Sequence[int], n: int = PENALTY_WINDOW, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build the trailing penalty window arrays from a host-side id list."""
    tail = [int(t) for t in input_ids[-n:]] if n else []
    pad = n - len(tail)
    ids = torch.tensor(tail + [0] * pad, dtype=torch.int64, device=device)
    mask = torch.tensor([1.0] * len(tail) + [0.0] * pad, dtype=torch.float32, device=device)
    return ids, mask
