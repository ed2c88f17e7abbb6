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

Sampling keys: step ``i`` of a seeded run draws its Gumbel noise from
``gumbel_noise(seed, i)`` (ops/sampling.py), the same numbers on every
execution path. The JAX engine's cache-view buckets are not ported: kernel B3
bounds its cache read by ``cache_valid`` on the device.

Not ported yet: ``generate_until`` / ``generate`` (inline text events),
incremental rebuild (trims), ``get_logprobs*`` (finalize scoring),
``prewarm_detours``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.llama import DuplexLMConfig, commit_kv, forward_decode, logits_from_hidden
from ..ops.sampling import (
    PENALTY_WINDOW,
    SamplerSettings,
    gumbel_noise,
    k_for,
    make_window,
    sample_token,
)

PREFILL_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)
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

    def step_noise(self, step: int) -> Optional[torch.Tensor]:
        """Gumbel noise of sampler step ``step`` (None when greedy)."""
        if self.settings.temp <= 0.0:
            return None
        k = k_for(self.settings.top_k, self.cfg.vocab_size)
        return gumbel_noise(self._seed, step, k, self.device)

    def _sample(self, logits: torch.Tensor, step: int, window_ids, window_mask) -> torch.Tensor:
        scalars, (bias_ids, bias_vals) = self.device_settings()
        return sample_token(
            logits, self.step_noise(step), scalars, bias_ids, bias_vals,
            window_ids, window_mask, top_k=self.settings.top_k,
        )

    # ----------------------------------------------------------------- eval
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
            b = _bucket(len(chunk))
            padded = np.zeros((1, b), dtype=np.int64)
            padded[0, : len(chunk)] = chunk
            offset = self._n_tokens
            ids = torch.from_numpy(padded).to(self.device)
            positions = offset + torch.arange(b, device=self.device)
            hidden, nk, nv = forward_decode(self.params, ids, self.cfg, self._k, self._v, positions)
            commit_kv(self._k, self._v, nk, nv, offset)
            last = hidden[0, len(chunk) - 1 : len(chunk)]
            self._last_logits = logits_from_hidden(self.params, last, self.cfg)[0]
            self._input_ids.extend(chunk)
            self._n_tokens += len(chunk)
            pos += len(chunk)
        self._frame_probs = None

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
            new3 = torch.stack([sample_probs[probe_t[0]], probe_probs[probe_t[1]], probe_probs[probe_t[2]]])
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
