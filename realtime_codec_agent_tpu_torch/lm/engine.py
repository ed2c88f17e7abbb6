"""Autoregressive decode engine for the duplex LM, in PyTorch.

Port of realtime_codec_agent_tpu/lm/engine.py (the parts the realtime call
runs):

- a static KV cache ``(L, 1, max_context + 2048, KH, Dh)`` on the device,
  written in place;
- bucketed prefill (``eval``), so teacher forcing runs a small set of shapes;
- fused eval + sample (``eval_and_sample``) and the multi-frame audio
  continuation (``eval_and_sample_frames``) with the event probe riding
  every frame step;
- ``n_tokens`` get/set as the KV rollback primitive: later positions are
  masked by position and overwritten by the next eval.

Sampling keys: step ``i`` of a seeded run draws with JAX's Gumbel noise
for ``fold_in(PRNGKey(seed), i)`` (ops/sampling.py), so seeded sampled
tokens are the JAX engine's (in f32 configs), the same numbers on every
execution path; on the card the whole draw is one launch of kernel S1,
keyed by (seed, i), on the CPU the plain sampler. The JAX engine's
cache-view buckets are not ported: kernel B3 bounds its cache read by
``cache_valid`` on the device.

Inline text events run ``generate_until``; finalize scoring runs
``get_logprobs_batch`` through the cacheless ``forward`` (kernel B4 past 512
tokens). The incremental trim and the finalize absorb rebuild a shadow cache
one prefill slice per chunk (``rebuild_*``) while the live cache keeps
serving; a slice uploads its ids through pinned memory and passes the
attention bound down from host ints, so it issues no host synchronization.
Not ported: ``prewarm_detours`` (nothing compiles ahead of time here).
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.llama import DuplexLMConfig, commit_kv, forward, forward_decode, logits_from_hidden
from ..ops.nn import dot_f32
from ..ops.sampling import (
    PENALTY_WINDOW,
    SamplerSettings,
    make_window,
    sample_token,
)
from ..utils.staging import to_device

PREFILL_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)
# rows of the scoring head per chunk (bounds the (rows, vocab) logits)
SCORE_CHUNK = 256
# sentinel position of K/V slots that must never be attended
REJECTED_POS = 2**30


def _bucket(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return PREFILL_BUCKETS[-1]


class DuplexLMEngine:
    def __init__(
        self,
        params,
        cfg: DuplexLMConfig,
        seed: Optional[int] = 42,
        kv_slack: int = 0,
        device=None,
    ):
        self.params = params
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else params["final_norm"].device
        self.max_context = cfg.max_context
        cache_len = cfg.max_context + max(kv_slack, PREFILL_BUCKETS[-1])
        kv_shape = (cfg.num_layers, 1, cache_len, cfg.num_kv_heads, cfg.head_dim)
        self._k = torch.zeros(kv_shape, dtype=cfg.dtype, device=self.device)
        self._v = torch.zeros(kv_shape, dtype=cfg.dtype, device=self.device)

        self._input_ids: List[int] = []
        self._n_tokens = 0
        self._last_logits: Optional[torch.Tensor] = None  # (V,) f32 at the last evaled position
        self._probe_token_ids = None  # (end_audio, agent_speaker, user_speaker)
        self._frame_probs = None  # (p_end, p_agent, p_user) from the last frames call
        self._end_header_token_id: Optional[int] = None
        self._dev_settings_key = None
        self.settings = SamplerSettings(seed=seed)
        self._seed = seed if seed is not None else 0
        self._step = 0

        # incremental KV rebuild: a shadow cache filled a prefill slice at a
        # time while the live cache keeps serving
        self._rb_tokens: Optional[List[int]] = None
        self._rb_progress = 0
        self._rb_k: Optional[torch.Tensor] = None
        self._rb_v: Optional[torch.Tensor] = None
        self._rb_logits: Optional[torch.Tensor] = None

    # ----------------------------------------------------------- state mgmt
    @property
    def n_tokens(self) -> int:
        return self._n_tokens

    @n_tokens.setter
    def n_tokens(self, value: int) -> None:
        """KV rollback: later positions become unreachable (masked by position)
        and are overwritten by the next eval -- no cache mutation needed."""
        if value < 0 or value > self._n_tokens:
            raise ValueError(f"n_tokens can only be rolled back (got {value}, have {self._n_tokens})")
        self._n_tokens = value
        del self._input_ids[value:]

    def reset(self) -> None:
        self._n_tokens = 0
        self._input_ids = []
        self._last_logits = None
        self._frame_probs = None
        self.rebuild_abort()

    def commit_external_eval(self, tokens: Sequence[int]) -> None:
        """Record tokens already evaled on the device by a fused chunk
        (lm/duplex_session.py) so the host mirror and n_tokens stay in sync."""
        tokens = [int(t) for t in tokens]
        self._input_ids.extend(tokens)
        self._n_tokens += len(tokens)
        self._frame_probs = None

    # ------------------------------------------------------------- sampling
    def init_sampler_for_generate(
        self,
        top_k: int = 40,
        top_p: float = 0.95,
        min_p: float = 0.05,
        temp: float = 0.80,
        repeat_penalty: float = 1.0,
        frequency_penalty: float = 0.0,
        presence_penalty: float = 0.0,
        logit_bias: Optional[dict] = None,
        seed: Optional[int] = None,
        min_token_id: int = 0,
    ) -> None:
        self.settings = SamplerSettings(
            min_token_id=min_token_id,
            top_k=top_k,
            top_p=top_p,
            min_p=min_p,
            temp=temp,
            repeat_penalty=repeat_penalty,
            frequency_penalty=frequency_penalty,
            presence_penalty=presence_penalty,
            logit_bias=tuple((int(k), float(v)) for k, v in (logit_bias or {}).items()),
            seed=seed,
        )
        self._seed = seed if seed is not None else 0
        self._step = 0

    def device_settings(self):
        """Device copies of the sampler scalars and bias tables, rebuilt only
        when the settings change (callers may mutate ``settings`` fields)."""
        st = self.settings
        key = (
            st.top_k, st.top_p, st.min_p, st.temp, st.repeat_penalty,
            st.frequency_penalty, st.presence_penalty, st.logit_bias,
            st.min_token_id, st.seed,
        )
        if self._dev_settings_key != key:
            self._dev_scalars = st.scalars(self.device)
            self._dev_bias = st.bias_arrays(self.device)
            self._dev_settings_key = key
        return self._dev_scalars, self._dev_bias

    def _sample(self, logits: torch.Tensor, step: int, window_ids, window_mask) -> torch.Tensor:
        """The sampled id of step ``step`` (a 0-dim device tensor), drawn with
        the key (seed, step): on the card one launch of kernel S1, greedy or
        sampled decided there; on the CPU the plain version."""
        scalars, (bias_ids, bias_vals) = self.device_settings()
        return sample_token(
            logits, (self._seed, step), scalars, bias_ids, bias_vals,
            window_ids, window_mask, top_k=self.settings.top_k,
        )

    # ----------------------------------------------------------------- eval
    def _prefill(self, k: torch.Tensor, v: torch.Tensor, chunk: Sequence[int], offset: int) -> torch.Tensor:
        """Prefill ``chunk`` (at most the largest bucket) at cache positions
        [offset, offset + len) of ``k``/``v``, padded to its bucket; returns
        the logits at its last id. No host synchronization: the ids go up
        through pinned memory, and the attention bound (the last query
        position) comes from host ints."""
        b = _bucket(len(chunk))
        padded = np.zeros((1, b), dtype=np.int64)
        padded[0, : len(chunk)] = chunk
        ids = to_device(padded, self.device)
        positions = offset + torch.arange(b, device=self.device)
        hidden, nk, nv = forward_decode(
            self.params, ids, self.cfg, k, v, positions, max_key=offset + b - 1,
        )
        commit_kv(k, v, nk, nv, offset)
        last = hidden[0, len(chunk) - 1 : len(chunk)]
        return logits_from_hidden(self.params, last, self.cfg)[0]

    def eval(self, tokens: Sequence[int]) -> None:
        """Teacher-forced append of tokens at position n_tokens (bucketed prefill)."""
        tokens = [int(t) for t in tokens]
        if not tokens:
            return
        if self._n_tokens + len(tokens) > self.max_context:
            raise RuntimeError(
                f"context overflow: {self._n_tokens} + {len(tokens)} > {self.max_context}"
            )
        pos = 0
        while pos < len(tokens):
            chunk = tokens[pos : pos + PREFILL_BUCKETS[-1]]
            self._last_logits = self._prefill(self._k, self._v, chunk, self._n_tokens)
            self._input_ids.extend(chunk)
            self._n_tokens += len(chunk)
            pos += len(chunk)
        self._frame_probs = None

    # -------------------------------------------- incremental cache rebuild
    # A context trim shifts RoPE positions (the post-trim tokens re-land right
    # after the preserved header), so the trimmed KV must be re-prefilled.
    # Instead of one blocking call, the agent rebuilds into a SHADOW cache one
    # prefill slice per chunk while the live cache keeps serving, then swaps
    # (agent/agent.py, the incremental trim and the finalize absorb).

    def rebuild_begin(self, tokens: Sequence[int]) -> None:
        """Start an incremental rebuild: ``tokens`` is the full post-trim
        sequence (header + trimmed suffix) to prefill into the shadow cache
        from position 0."""
        if self._rb_k is None:
            self._rb_k = torch.zeros_like(self._k)
            self._rb_v = torch.zeros_like(self._v)
        self._rb_tokens = [int(t) for t in tokens]
        self._rb_progress = 0
        self._rb_logits = None

    def rebuild_begin_from_live(self, tokens: Sequence[int], reuse_len: int) -> None:
        """Start an incremental rebuild whose prefix [0, reuse_len) is already
        correct in the LIVE cache (an in-place suffix edit at unchanged RoPE
        positions: the finalize splice). The shadow becomes a device-to-device
        copy of the live cache and only [reuse_len, len(tokens)) is pumped."""
        tokens = [int(t) for t in tokens]
        if not (0 <= reuse_len <= min(len(tokens), self._n_tokens)):
            raise ValueError(
                f"reuse_len {reuse_len} out of range (target {len(tokens)}, live {self._n_tokens})"
            )
        if tokens[:reuse_len] != self._input_ids[:reuse_len]:
            first_bad = next(i for i in range(reuse_len) if tokens[i] != self._input_ids[i])
            raise AssertionError(
                "rebuild_begin_from_live: target prefix must match the live mirror "
                f"(first divergence at {first_bad}/{reuse_len}: target "
                f"{tokens[max(0, first_bad - 3):first_bad + 3]} vs mirror "
                f"{self._input_ids[max(0, first_bad - 3):first_bad + 3]}; live n_tokens "
                f"{self._n_tokens}, target len {len(tokens)})"
            )
        if self._rb_k is None:
            self._rb_k = torch.empty_like(self._k)
            self._rb_v = torch.empty_like(self._v)
        self._rb_k.copy_(self._k)
        self._rb_v.copy_(self._v)
        self._rb_tokens = tokens
        self._rb_progress = reuse_len
        self._rb_logits = None

    def rebuild_extend(self, tokens: Sequence[int]) -> None:
        """Append tokens to the rebuild target (the sequence grew since begin)."""
        assert self._rb_tokens is not None, "rebuild_extend without rebuild_begin"
        self._rb_tokens.extend(int(t) for t in tokens)

    def rebuild_remaining(self) -> int:
        if self._rb_tokens is None:
            return 0
        return len(self._rb_tokens) - self._rb_progress

    def rebuild_abort(self) -> None:
        self._rb_tokens = None
        self._rb_progress = 0
        self._rb_logits = None

    def rebuild_pump(self, max_tokens: int) -> int:
        """Prefill up to ``max_tokens`` of the rebuild target into the shadow
        cache (the same bucketed prefill as ``eval``; nothing is read back).
        Returns the tokens remaining."""
        assert self._rb_tokens is not None, "rebuild_pump without rebuild_begin"
        budget = min(max_tokens, self.rebuild_remaining())
        while budget > 0:
            start = self._rb_progress
            chunk = self._rb_tokens[start : start + min(budget, PREFILL_BUCKETS[-1])]
            self._rb_logits = self._prefill(self._rb_k, self._rb_v, chunk, start)
            self._rb_progress += len(chunk)
            budget -= len(chunk)
        return self.rebuild_remaining()

    def rebuild_swap(self) -> None:
        """Install the fully rebuilt shadow cache as the live cache by
        swapping references (no copy): the engine state afterwards is what a
        blocking ``eval`` of the rebuild target from scratch gives (mirror,
        n_tokens, last-position logits). The old live cache becomes the next
        shadow."""
        assert self._rb_tokens is not None and self.rebuild_remaining() == 0, (
            "rebuild_swap before the rebuild finished"
        )
        self._k, self._rb_k = self._rb_k, self._k
        self._v, self._rb_v = self._rb_v, self._v
        self._input_ids = list(self._rb_tokens)
        self._n_tokens = len(self._rb_tokens)
        self._last_logits = self._rb_logits
        self._frame_probs = None
        self._rb_tokens = None
        self._rb_progress = 0
        self._rb_logits = None

    def sample(self) -> int:
        """Sample from the logits at the last evaled position."""
        if self._last_logits is None:
            raise RuntimeError("sample() before any eval()")
        window_ids, window_mask = make_window(self._input_ids, PENALTY_WINDOW, self.device)
        token = self._sample(self._last_logits, self._step, window_ids, window_mask)
        self._step += 1
        return int(token)

    def eval_and_sample(self, tokens: Sequence[int]) -> int:
        """Eval 1-4 tokens and sample the next one in one forward."""
        tokens = [int(t) for t in tokens]
        if not (1 <= len(tokens) <= 4):
            self.eval(tokens)
            return self.sample()
        window_ids, window_mask = make_window(self._input_ids + tokens, PENALTY_WINDOW, self.device)
        offset = self._n_tokens
        ids = torch.tensor([tokens], dtype=torch.int64, device=self.device)
        positions = offset + torch.arange(len(tokens), device=self.device)
        hidden, nk, nv = forward_decode(self.params, ids, self.cfg, self._k, self._v, positions)
        logits = logits_from_hidden(self.params, hidden[:, -1], self.cfg)[0]
        token = self._sample(logits, self._step, window_ids, window_mask)
        self._step += 1
        commit_kv(self._k, self._v, nk, nv, offset)
        self._last_logits = logits
        self._input_ids.extend(tokens)
        self._n_tokens += len(tokens)
        self._frame_probs = None
        return int(token)

    def eval_and_sample_frames(
        self, pending_pair: Sequence[int], user_tokens: Sequence[int],
        max_frames: int = 8, pending_evaled: int = 0,
    ) -> Tuple[List[int], Optional[int]]:
        """Duplex audio-frame continuation, token-exact with

            toks = []
            pair = pending_pair
            for u in user_tokens:
                a = self.eval_and_sample(pair)
                if a <= end_header: return toks, a       # event
                toks.append(a); pair = [a, u]
            return toks, None

        including sampler-step, penalty-window and KV bookkeeping. The frames
        run back to back on the device with the event test as a device flag
        (frames after an event are computed but change nothing) and ONE host
        read at the end. ``pending_evaled=1``: only the pair's second id is
        unevaled; the first is the last evaled id, re-evaled in place (its
        K/V overwrite themselves bit-identically). The (end_audio, agent,
        user) probe rides each frame as a causally isolated third token."""
        assert len(pending_pair) == 2
        assert pending_evaled in (0, 1)
        assert 1 <= len(user_tokens) <= max_frames
        if pending_evaled:
            assert self._input_ids and self._input_ids[-1] == int(pending_pair[0]), (
                "pending_evaled=1 requires pending_pair[0] == the last evaled id"
            )
        end_header = self._end_header_token_id
        if end_header is None:
            raise RuntimeError("eval_and_sample_frames needs set_end_header_token_id() first")
        cfg, dev = self.cfg, self.device
        new_ids = [int(t) for t in pending_pair[pending_evaled:]]
        tail = (self._input_ids + new_ids)[-PENALTY_WINDOW:]
        window = np.zeros((PENALTY_WINDOW,), np.int64)
        if tail:
            window[-len(tail):] = tail
        n_frames = len(user_tokens)
        ut = torch.tensor([int(t) for t in user_tokens], dtype=torch.int64, device=dev)
        probe = self._probe_token_ids or (end_header, 0, 0)
        probe_t = torch.tensor(probe, dtype=torch.int64, device=dev)
        offset = self._n_tokens - pending_evaled
        step0 = self._step

        n = torch.tensor(offset, dtype=torch.int64, device=dev)
        cache_valid = torch.tensor([offset], dtype=torch.int32, device=dev)
        prev = torch.tensor([int(t) for t in pending_pair], dtype=torch.int64, device=dev)
        wids = torch.from_numpy(window).to(dev)
        wcount = torch.tensor(len(tail), dtype=torch.int64, device=dev)
        small_shape = (cfg.num_layers, 1, 2 * n_frames, cfg.num_kv_heads, cfg.head_dim)
        small_k = torch.zeros(small_shape, dtype=cfg.dtype, device=dev)
        small_v = torch.zeros(small_shape, dtype=cfg.dtype, device=dev)
        small_pos = torch.full((2 * n_frames,), REJECTED_POS, dtype=torch.int64, device=dev)
        out_tokens = torch.full((n_frames,), -2, dtype=torch.int64, device=dev)
        done = torch.tensor(False, device=dev)
        event_tok = torch.tensor(-1, dtype=torch.int64, device=dev)
        probs3 = torch.zeros((3,), dtype=torch.float32, device=dev)
        last_logits = torch.zeros((cfg.vocab_size,), dtype=torch.float32, device=dev)
        n_exec = torch.tensor(0, dtype=torch.int64, device=dev)
        arange3 = torch.arange(3, device=dev)
        for i in range(n_frames):
            active = ~done
            positions = n + arange3
            wmask = (torch.arange(PENALTY_WINDOW, device=dev) >= PENALTY_WINDOW - wcount).to(torch.float32)
            ids3 = torch.cat([prev, probe_t[:1]])
            hidden, nk, nv = forward_decode(
                self.params, ids3[None, :], cfg, self._k, self._v, positions,
                cache_valid=cache_valid, extra_kv=(small_k, small_v), extra_pos=small_pos,
            )
            logits2 = logits_from_hidden(self.params, hidden[0, 1:3], cfg)
            logits = logits2[0]
            a = self._sample(logits, step0 + i, wids, wmask)
            sample_probs = torch.softmax(logits, dim=-1)
            probe_probs = torch.softmax(logits2[1], dim=-1)
            new3 = torch.cat([sample_probs[probe_t[:1]], probe_probs[probe_t[1:]]])
            probs3 = torch.where(active, new3, probs3)
            last_logits = torch.where(active, logits, last_logits)
            # the evaled pair always commits (stepwise eval_and_sample writes
            # K/V before sampling); the probe row never does. Frames after an
            # event are masked out by position.
            small_k[:, :, 2 * i : 2 * i + 2] = nk[:, :, :2]
            small_v[:, :, 2 * i : 2 * i + 2] = nv[:, :, :2]
            small_pos[2 * i : 2 * i + 2] = torch.where(active, positions[:2], REJECTED_POS)
            u_next = ut[i]
            is_audio = a > end_header
            rolled = torch.cat([wids[2:], torch.stack([a, u_next])])
            accept = active & is_audio
            out_tokens[i] = torch.where(active, torch.where(is_audio, a, -1), out_tokens[i])
            event_tok = torch.where(active & ~is_audio, a, event_tok)
            wids = torch.where(accept, rolled, wids)
            wcount = torch.where(accept, torch.clamp(wcount + 2, max=PENALTY_WINDOW), wcount)
            prev = torch.where(accept, torch.stack([a, u_next]), prev)
            n = torch.where(active, n + 2, n)
            n_exec = n_exec + active.to(torch.int64)
            done = done | (active & ~is_audio)

        commit_kv(self._k, self._v, small_k, small_v, offset)  # slots of unexecuted frames sit past n_tokens
        host = torch.cat([out_tokens, torch.stack([n_exec, event_tok])]).cpu().numpy()
        host_probs = probs3.cpu().numpy()
        out, n_evaled, ev = host[:n_frames], int(host[n_frames]), int(host[n_frames + 1])
        hit_event = int(out[n_evaled - 1]) < 0 if n_evaled else False
        accepted = [int(t) for t in out[: n_evaled - 1 if hit_event else n_evaled]]
        evaled = list(new_ids)
        for j in range(n_evaled - 1):
            evaled += [accepted[j], int(user_tokens[j])]
        self._input_ids.extend(evaled)
        self._n_tokens += len(evaled)
        self._step += n_evaled
        self._last_logits = last_logits
        self._frame_probs = (
            tuple(float(x) for x in host_probs) if self._probe_token_ids is not None else None
        )
        return accepted, (ev if hit_event else None)

    def generate_until(
        self, first_token: int, stop_id: int, max_n: int = 64,
        n_limit: Optional[int] = None,
    ) -> Tuple[List[int], bool]:
        """Multi-token generation: eval ``first_token`` (the pending
        appended-not-evaled id), then sample until ``stop_id``, at most
        ``min(max_n, n_limit)`` tokens. Token-exact with looping
        ``eval_and_sample(ids[-1:])`` (same noise steps, same penalty window);
        the last sampled token comes back appended-not-evaled, the stepwise
        loop's state shape. The steps attend the read-only cache plus a
        ``max_n``-slot side buffer of their own K/V, which commits to the
        cache once, contiguously, at the end; the stop test is a device flag
        (steps after it change nothing), read by the host every 8 steps to
        end the loop early."""
        cfg, dev = self.cfg, self.device
        limit = max_n if n_limit is None else min(int(n_limit), max_n)
        tail = (self._input_ids + [int(first_token)])[-PENALTY_WINDOW:]
        window = np.zeros((PENALTY_WINDOW,), np.int64)
        window[-len(tail):] = tail
        wids = torch.from_numpy(window).to(dev)
        wcount = torch.tensor(len(tail), dtype=torch.int64, device=dev)
        window_pos = torch.arange(PENALTY_WINDOW, device=dev)
        offset = self._n_tokens
        cache_valid = torch.tensor([offset], dtype=torch.int32, device=dev)
        small_shape = (cfg.num_layers, 1, max_n, cfg.num_kv_heads, cfg.head_dim)
        small_k = torch.zeros(small_shape, dtype=cfg.dtype, device=dev)
        small_v = torch.zeros(small_shape, dtype=cfg.dtype, device=dev)
        small_pos = torch.full((max_n,), REJECTED_POS, dtype=torch.int64, device=dev)
        out_tokens = torch.full((max_n,), -1, dtype=torch.int64, device=dev)
        tok = torch.tensor([[int(first_token)]], dtype=torch.int64, device=dev)
        done = torch.tensor(False, device=dev)
        last_logits = torch.zeros((cfg.vocab_size,), dtype=torch.float32, device=dev)
        step0 = self._step
        for i in range(limit):
            pos = torch.tensor([offset + i], dtype=torch.int64, device=dev)
            hidden, nk, nv = forward_decode(
                self.params, tok, cfg, self._k, self._v, pos,
                cache_valid=cache_valid, extra_kv=(small_k, small_v), extra_pos=small_pos,
            )
            logits = logits_from_hidden(self.params, hidden[:, -1], cfg)[0]
            wmask = (window_pos >= PENALTY_WINDOW - wcount).to(torch.float32)
            nxt = self._sample(logits, step0 + i, wids, wmask)
            active = ~done
            small_k[:, :, i : i + 1] = nk
            small_v[:, :, i : i + 1] = nv
            small_pos[i] = offset + i
            out_tokens[i] = torch.where(active, nxt, -1)
            last_logits = torch.where(active, logits, last_logits)
            # roll the sampled token into the penalty window (the stepwise
            # make_window over the growing mirror does the same)
            wids = torch.cat([wids[1:], nxt[None]])
            wcount = torch.clamp(wcount + 1, max=PENALTY_WINDOW)
            done = done | (nxt == stop_id)
            tok = nxt.reshape(1, 1)
            if (i + 1) % 8 == 0 and i + 1 < limit and bool(done):
                break
        # executed steps fill slots [0, n) in order: one contiguous commit.
        # Slots past the new n_tokens are never attended and get overwritten.
        commit_kv(self._k, self._v, small_k, small_v, offset)
        out = out_tokens.cpu().numpy()
        toks = [int(t) for t in out[out >= 0]]
        if not toks:
            return [], False
        evaled = [int(first_token)] + toks[:-1]
        self._input_ids.extend(evaled)
        self._n_tokens += len(evaled)
        self._step += len(toks)
        self._last_logits = last_logits
        self._frame_probs = None
        return toks, toks[-1] == int(stop_id)

    def generate(self, tokens: Sequence[int], reset: bool = False) -> Iterator[int]:
        """llama.cpp-style incremental generator: eval ``tokens``, then yield
        a sampled token; each further next() evals the previously yielded
        token first."""
        if reset:
            self.reset()
        tokens = list(tokens)
        while True:
            token = self.eval_and_sample(tokens)
            yield token
            tokens = [token]

    # -------------------------------------------------------------- scoring
    def score(self, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Per-position logprob of ``targets`` under the cacheless causal
        forward of ``tokens`` (both (B, Tb)); the lm_head and log-softmax run
        in SCORE_CHUNK-row chunks to bound memory. Rows are causally
        independent, so unrelated contexts batch into one weight read. The
        head always takes the wide route (f32 matmul), as the JAX scan's
        256-row chunks do; an int8 head is widened once per call, not once
        per chunk (the same numbers)."""
        cfg = self.cfg
        hidden = forward(self.params, tokens, cfg)
        b, tb, h = hidden.shape
        flat_h = hidden.reshape(b * tb, h)
        flat_t = targets.reshape(b * tb, 1).long()
        head = self.params["embed_tokens"].T if cfg.tie_embeddings else self.params["lm_head"]
        scale = None
        if isinstance(head, dict):
            head, scale = head["q"].to(torch.float32), head["s"]
        out = torch.empty((b * tb,), dtype=torch.float32, device=hidden.device)
        for i in range(0, b * tb, SCORE_CHUNK):
            logits = dot_f32(flat_h[i : i + SCORE_CHUNK], head)
            if scale is not None:
                logits = logits * scale
            lp = torch.log_softmax(logits, dim=-1)
            out[i : i + SCORE_CHUNK] = lp.gather(1, flat_t[i : i + SCORE_CHUNK])[:, 0]
        return out.reshape(b, tb)

    def get_logprobs(self, ctx_input_ids: Sequence[int], input_ids: Sequence[int]) -> np.ndarray:
        """Teacher-forced logprobs of input_ids given ctx (cacheless)."""
        return self.get_logprobs_batch([(ctx_input_ids, input_ids)])[0]

    def get_logprobs_batch(
        self, pairs: Sequence[Tuple[Sequence[int], Sequence[int]]]
    ) -> List[np.ndarray]:
        """Score several independent (ctx, ids) sequences in ONE forward.
        Rows pad to a shared bucket (the prefill buckets, then powers of two
        past 2,048); causal attention keeps them independent. Reads and
        writes no engine state: n_tokens, the mirror and the KV cache stay."""
        for ctx, ids in pairs:
            if len(ctx) < 1:
                raise ValueError(
                    "get_logprobs_batch requires a non-empty ctx per pair "
                    "(an empty ctx would silently score the wrong slice)"
                )
        seqs = [[int(t) for t in ctx] + [int(t) for t in ids] for ctx, ids in pairs]
        longest = max(len(s) for s in seqs)
        b = _bucket(longest)
        while b < longest:
            b *= 2
        tokens = np.zeros((len(seqs), b), dtype=np.int64)
        targets = np.zeros((len(seqs), b), dtype=np.int64)
        for i, seq in enumerate(seqs):
            tokens[i, : len(seq)] = seq
            targets[i, : len(seq) - 1] = seq[1:]
        lps = self.score(
            torch.from_numpy(tokens).to(self.device), torch.from_numpy(targets).to(self.device)
        ).cpu().numpy()
        return [lps[i, len(ctx) - 1 : len(ctx) - 1 + len(ids)] for i, (ctx, ids) in enumerate(pairs)]

    def set_end_header_token_id(self, token_id: int) -> None:
        """Register the audio/event boundary id (tokens > this are codec audio)."""
        self._end_header_token_id = int(token_id)

    def set_probe_token_ids(self, end_audio_id: int, agent_id: int, user_id: int) -> None:
        """Register the ids the riding event probe reports on."""
        self._probe_token_ids = (int(end_audio_id), int(agent_id), int(user_id))

    def consume_frame_probs(self):
        """(p_end, p_agent, p_user) from the most recent frames call IF nothing
        has moved the position since; None otherwise. One-shot."""
        probs, self._frame_probs = self._frame_probs, None
        return probs

    # ------------------------------------------------------------ logit taps
    def event_probs(self, trigger_id: int, next_ids: Sequence[int]) -> Tuple[float, List[float]]:
        """P(trigger) at the last evaled position + P(each of next_ids |
        trigger appended), read-only: nothing commits."""
        if self._last_logits is None:
            raise RuntimeError("no logits available")
        p_now = torch.softmax(self._last_logits, dim=-1)[int(trigger_id)]
        ids = torch.tensor([[int(trigger_id)]], dtype=torch.int64, device=self.device)
        pos = torch.tensor([self._n_tokens], dtype=torch.int64, device=self.device)
        hidden, _, _ = forward_decode(
            self.params, ids, self.cfg, self._k, self._v, pos, cache_valid=pos,
        )
        logits2 = logits_from_hidden(self.params, hidden[:, -1], self.cfg)[0]
        pick = torch.tensor([int(t) for t in next_ids], dtype=torch.int64, device=self.device)
        out = torch.cat([p_now[None], torch.softmax(logits2, dim=-1)[pick]]).cpu().numpy()
        return float(out[0]), [float(x) for x in out[1:]]

    def last_probs(self, token_ids: Sequence[int]) -> np.ndarray:
        """Softmax probabilities of selected tokens at the last evaled position."""
        if self._last_logits is None:
            raise RuntimeError("no logits available")
        ids = torch.tensor([int(t) for t in token_ids], dtype=torch.int64, device=self.device)
        return torch.softmax(self._last_logits, dim=-1)[ids].cpu().numpy()
