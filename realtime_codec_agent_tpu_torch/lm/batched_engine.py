"""Batched decode engine: B independent sequences, one forward a step.

Port of realtime_codec_agent_tpu/lm/batched_engine.py. Each row has its own
cache region, offset, sampler settings, threefry stream and penalty window;
one step runs ``forward_decode`` over all rows (per-row positions and
``cache_valid``), the lm_head, and kernel S1 over rows with every row's own
key (ops/sampling.sample_token_rows), so B concurrent completions cost one
pass over the weights a token.

The step's bookkeeping (pending token, offset, sampler step, penalty window)
is DEVICE-CARRIED: ``step_async`` launches ``steps`` micro-steps against the
device state and returns the token tensor without reading anything on the
host, and ``resolve`` copies it to the host (one device-to-host copy), so
the serving loop (serving/batched_backend.py) dispatches step k+1 before it
reads step k. Within a dispatch the cache is read-only: each micro-step's
K/V go to a side buffer attended as ``extra_kv`` (a slot becomes attendable
only once its true position replaces the sentinel), and the dispatch ends
with ONE scatter commit (``models/llama.commit_kv_rows``) that sends
inactive rows to the trash index.

On the card a step runs kernels B2 (the layer matmuls and the lm_head at
B <= 8 rows), B3 (decode attention over the cache rows plus the side
window) and S1 over rows; prefill buckets (T >= 9) take the plain
block-by-block attention and qdot's wide route, as in the JAX package.
The JAX engine's jit compilation has no counterpart: ``prewarm`` only runs
every cache-bucket variant once, leaving every row's state as it was.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..models.llama import DuplexLMConfig, commit_kv, commit_kv_rows, forward_decode, logits_from_hidden
from ..ops.sampling import MAX_BIAS, PENALTY_WINDOW, fold_in, prng_key, sample_token_rows
from ..utils.staging import to_device
from .engine import REJECTED_POS

PREFILL_BUCKETS = (32, 128, 512, 2048)


def _bucket(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"prompt longer than {PREFILL_BUCKETS[-1]} tokens")


class BatchedDecodeEngine:
    def __init__(
        self,
        params,
        cfg: DuplexLMConfig,
        batch_size: int = 8,
        max_context: Optional[int] = None,
        seed: int = 0,
        device=None,
    ):
        self.params = params
        self.cfg = cfg
        self.batch = batch_size
        self.max_context = max_context or min(cfg.max_context, 4096)
        self.device = torch.device(device) if device is not None else params["final_norm"].device
        dev = self.device
        kv_shape = (cfg.num_layers, batch_size, self.max_context, cfg.num_kv_heads, cfg.head_dim)
        self._k = torch.zeros(kv_shape, dtype=cfg.dtype, device=dev)
        self._v = torch.zeros(kv_shape, dtype=cfg.dtype, device=dev)
        self._base_key = prng_key(seed)
        # device-carried per-row decode state (chained across steps), in the
        # dtypes S1's rows take
        self.dstate = {
            "last": torch.zeros((batch_size,), dtype=torch.int64, device=dev),   # pending token
            "off": torch.zeros((batch_size,), dtype=torch.int64, device=dev),    # cache offset
            "step": torch.zeros((batch_size,), dtype=torch.int64, device=dev),   # sampler step
            "win": torch.zeros((batch_size, PENALTY_WINDOW), dtype=torch.int64, device=dev),
            "wcount": torch.zeros((batch_size,), dtype=torch.int64, device=dev),
        }
        # host mirrors (advanced at dispatch; used for admission/inspection)
        self.offsets = np.zeros(batch_size, dtype=np.int64)
        self._nonces = np.zeros(batch_size, dtype=np.int64)
        # per-row sampler scalars:
        # [top_p, min_p, temp, rep, freq, pres, min_id, dyn_top_k]
        self.scalars = np.tile(np.array([1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0], np.float32), (batch_size, 1))
        # per-row threefry key data: request seeds make rows reproducible;
        # unseeded rows derive a fresh stream per slot reuse
        self._row_keys = np.array([fold_in(self._base_key, r) for r in range(batch_size)], dtype=np.int64)
        self._zero_bias_ids = torch.zeros((batch_size, MAX_BIAS), dtype=torch.int64, device=dev)
        self._zero_bias_vals = torch.zeros((batch_size, MAX_BIAS), dtype=torch.float32, device=dev)
        self._win_pos = torch.arange(PENALTY_WINDOW, device=dev)[None, :]

    # ------------------------------------------------------------------ slots
    def max_prompt_len(self) -> int:
        """Longest admissible prompt: its padded prefill bucket plus at least
        one decode slot (and the trash slot) must fit the serving cache."""
        limit = 0
        for b in PREFILL_BUCKETS:
            if b + 2 <= self.max_context:
                limit = b
        return min(limit + 1, self.max_context - 2)  # +1: the unpadded last token

    def row_capacity_left(self, row: int) -> int:
        """Decode steps remaining before this row hits the cache end (the
        trash slot occupies the final index)."""
        return int(self.max_context - 2 - self.offsets[row])

    def set_row_sampler(
        self, row: int, top_p=1.0, min_p=0.0, temp=1.0, repeat_penalty=1.0,
        frequency_penalty=0.0, presence_penalty=0.0, min_token_id=0,
        top_k=0, seed=None,
    ) -> None:
        self.scalars[row] = [
            top_p, min_p, temp, repeat_penalty, frequency_penalty,
            presence_penalty, float(min_token_id), float(top_k or 0),
        ]
        if seed is not None:
            self._row_keys[row] = prng_key(int(seed))
        else:
            self._nonces[row] += 1
            self._row_keys[row] = fold_in(self._base_key, int(self._nonces[row]) * 997 + row)

    def prefill_row(self, row: int, prompt_ids: Sequence[int]) -> None:
        """Load a prompt into one slot; the final prompt token becomes the
        row's pending token (evaled by its first step). The prompt head runs
        at its padded bucket over the row's view of the cache; nothing is
        read on the host (the attention bound and the penalty window come
        from host ints)."""
        prompt_ids = [int(t) for t in prompt_ids]
        if len(prompt_ids) > self.max_prompt_len():
            raise ValueError(
                f"prompt too long for the serving cache ({len(prompt_ids)} > {self.max_prompt_len()})"
            )
        self._nonces[row] += 1
        n = len(prompt_ids)
        head, last = prompt_ids[:-1], prompt_ids[-1]
        b = _bucket(max(len(head), 1))
        padded = np.zeros((1, b), np.int64)
        padded[0, : len(head)] = head
        k_row, v_row = self._k[:, row : row + 1], self._v[:, row : row + 1]
        # no cache entry is valid at position 0: an empty view reads none
        _, nk, nv = forward_decode(
            self.params, to_device(padded, self.device), self.cfg, k_row[:, :, :0], v_row[:, :, :0],
            torch.arange(b, device=self.device), max_key=b - 1,
        )
        commit_kv(k_row, v_row, nk, nv, 0)
        # the row's chained state: pending = final prompt token, offset =
        # prompt length - 1, window = the trailing prompt tokens (the padded
        # head with the final token at its true position n - 1)
        src = np.concatenate([padded[0], [0]])
        src[n - 1] = last
        idx = np.arange(PENALTY_WINDOW) - PENALTY_WINDOW + n
        win = np.where(idx >= 0, src[np.clip(idx, 0, src.shape[0] - 1)], 0)
        vals = to_device(np.concatenate([[last, n - 1, 0, min(n, PENALTY_WINDOW)], win]), self.device, np.int64)
        for i, name in enumerate(("last", "off", "step", "wcount")):
            self.dstate[name][row : row + 1].copy_(vals[i : i + 1])
        self.dstate["win"][row].copy_(vals[4:])
        self.offsets[row] = len(head)

    # ------------------------------------------------------------------ steps
    def step_async(self, active: Sequence[bool], top_k: int = 0, steps: int = 1) -> torch.Tensor:
        """Launch one batched ``steps``-token dispatch against the
        device-carried state and return the sampled-token tensor WITHOUT
        reading it ((B,) for steps=1, (B, steps) otherwise). Consecutive
        dispatches chain on the device; ``resolve`` reads one."""
        return self._dispatch(active, int(top_k) if top_k else 1024, int(steps), self._cache_bucket())

    def _dispatch(self, active: Sequence[bool], top_k: int, steps: int, cache_bucket: int) -> torch.Tensor:
        """``steps`` micro-steps for every row, then the one commit. Each
        micro-step evals the pending tokens at per-row offsets, samples per
        row and advances the state of active rows (inactive rows freeze), so
        steps=S gives S consecutive single steps' tokens."""
        cfg, dev, bsz = self.cfg, self.device, self.batch
        active_np = np.asarray(active, dtype=bool)
        act = to_device(active_np, dev)
        keys = to_device(self._row_keys, dev, np.int64)
        scalars = to_device(self.scalars, dev, np.float32)
        d = self.dstate
        start_off = d["off"]  # the cache holds each row's content up to here
        k_big, v_big = self._k[:, :, :cache_bucket], self._v[:, :, :cache_bucket]
        side_shape = (cfg.num_layers, bsz, steps, cfg.num_kv_heads, cfg.head_dim)
        side_k = torch.zeros(side_shape, dtype=cfg.dtype, device=dev)
        side_v = torch.zeros(side_shape, dtype=cfg.dtype, device=dev)
        side_pos = torch.full((bsz, steps), REJECTED_POS, dtype=torch.int64, device=dev)
        toks = []
        for i in range(steps):
            offsets = d["off"]
            hidden, nk, nv = forward_decode(
                self.params, d["last"][:, None], cfg, k_big, v_big, offsets[:, None],
                cache_valid=start_off, extra_kv=(side_k, side_v), extra_pos=side_pos,
            )
            logits = logits_from_hidden(self.params, hidden[:, -1], cfg)  # (B, V) f32
            wmask = (self._win_pos >= PENALTY_WINDOW - d["wcount"][:, None]).to(torch.float32)
            row_keys = torch.cat([keys, d["step"][:, None]], dim=1)  # (k1, k2, step) a row
            nxt = sample_token_rows(
                logits, row_keys, scalars, self._zero_bias_ids, self._zero_bias_vals, d["win"], wmask, top_k=top_k,
            )
            # this micro-step's K/V in side slot i; inactive rows keep the
            # sentinel so their slot is never attended
            side_k[:, :, i] = nk[:, :, 0]
            side_v[:, :, i] = nv[:, :, 0]
            side_pos[:, i] = torch.where(act, offsets, side_pos[:, i])
            # chain the per-row state (frozen for inactive rows): the sampled
            # token becomes pending and joins the penalty window
            rolled = torch.cat([d["win"][:, 1:], nxt[:, None]], dim=1)
            d = {
                "last": torch.where(act, nxt, d["last"]),
                "off": torch.where(act, offsets + 1, offsets),
                "step": torch.where(act, d["step"] + 1, d["step"]),
                "win": torch.where(act[:, None], rolled, d["win"]),
                "wcount": torch.where(act, torch.clamp(d["wcount"] + 1, max=PENALTY_WINDOW), d["wcount"]),
            }
            toks.append(nxt)
        self.dstate = d
        # the dispatch's single cache write (the micro-steps only read the
        # cache); the stream orders it before the next dispatch's reads
        commit_kv_rows(self._k, self._v, side_k, side_v, start_off, act)
        self.offsets[active_np] += steps  # mirror (content arrives at resolve)
        return toks[0] if steps == 1 else torch.stack(toks, dim=1)

    def prewarm(self, steps_list: Sequence[int] = (8,), top_k: int = 1024) -> None:
        """Run every cache-bucket variant of the dispatch once with an
        all-inactive mask: every row's state stays as it was (the side
        buffer lands on the trash slot), so this is safe mid-session. On the
        card it builds the kernels (B2, B3, S1) and warms cuBLAS's and the
        caching allocator's state for each shape before the first request;
        nothing is compiled ahead of time."""
        buckets = []
        b = 256
        while b < self.max_context:
            buckets.append(b)
            b *= 2
        buckets.append(self.max_context)
        inactive = [False] * self.batch
        for steps in steps_list:
            for bucket in buckets:
                self._dispatch(inactive, top_k, int(steps), bucket)

    def _cache_bucket(self) -> int:
        """Power-of-two cache-read bound covering every row's occupancy.
        ``offsets`` is the dispatch-time mirror (advanced when a step is
        dispatched, not when it resolves), so it upper-bounds the device-side
        ``off`` of every in-flight dispatch."""
        need = int(self.offsets.max()) if self.offsets.size else 0
        b = 256
        while b < need:
            b *= 2
        return min(b, self.max_context)

    def resolve(self, handles: torch.Tensor):
        """Read dispatched tokens (one device-to-host copy): List[int] for a
        steps=1 dispatch, List[List[int]] (rows x steps) otherwise."""
        return handles.tolist()

    def step(self, active: Sequence[bool], top_k: int = 0, steps: int = 1):
        """Synchronous convenience: dispatch + immediate resolve."""
        return self.resolve(self.step_async(active, top_k=top_k, steps=steps))
