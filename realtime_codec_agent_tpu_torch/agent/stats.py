"""Streaming z-score statistics driving the agent's control signals.

Copy of realtime_codec_agent_tpu/agent/stats.py (that package's
``agent/__init__`` imports JAX, so the port cannot import it from there).

Rebuild of the reference stats subsystem (realtime_agent_stats.py:7-51):
values accumulate in a rolling window (default 20 s of chunks); z-scores are
taken against a mean/std that refreshes every update interval (default 5 s).
The z-scores are *control signals*, not telemetry: amplitude VAD, forced-event
gating, and TTS interruption all key off them (reference
realtime_agent_v2.py:448-502, 385).

Implementation difference: instead of deque-of-tuples + full-window numpy
reductions per refresh, values live in a preallocated ring buffer with O(1)
append and vectorized refresh — the same numbers, less host overhead on the
100 ms hot path.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from .config import RealtimeAgentConfig


class RealtimeAgentStats:
    def __init__(
        self,
        config: RealtimeAgentConfig,
        value_size: int = 1,
        window_secs: float = 20.0,
        update_interval_secs: float = 5.0,
    ):
        self.value_size = value_size
        self.window_chunks = max(1, int(window_secs / config.chunk_size_secs))
        self.update_interval_chunks = max(1, int(update_interval_secs / config.chunk_size_secs))
        self._ring = np.zeros((self.window_chunks, value_size), dtype=np.float64)
        self.reset()

    def reset(self) -> None:
        self._count = 0  # total values ever added (ring occupancy = min(count, window))
        self._head = 0
        self._last_zscore = np.zeros(self.value_size, dtype=np.float64)
        self.mean = 0.0
        self.std = 1.0

    def __len__(self) -> int:
        return min(self._count, self.window_chunks)

    @property
    def last_zscore(self) -> Union[float, Tuple[float, ...]]:
        if self.value_size > 1:
            return tuple(self._last_zscore)
        return float(self._last_zscore[0])

    def add_value(self, value) -> None:
        arr = np.atleast_1d(np.asarray(value, dtype=np.float64))
        self._ring[self._head] = arr
        self._head = (self._head + 1) % self.window_chunks
        self._count += 1
        self._last_zscore = (arr - self.mean) / self.std
        n = len(self)
        # refresh stats during warmup and at every update interval thereafter
        # (reference realtime_agent_stats.py:37-40: the mean/std pool ALL
        # dimensions of the window values together)
        if n < self.update_interval_chunks or n % self.update_interval_chunks == 0:
            window = self._ring[:n] if self._count <= self.window_chunks else self._ring
            self.mean = float(window.mean())
            self.std = float(window.std()) if window.size > 1 else 1.0
            if self.std == 0.0:
                self.std = 1.0

    # ------------------------------------------------------ snapshot/restore
    def get_state(self) -> dict:
        """Serializable state (call snapshot: z-scores are CONTROL signals —
        VAD, forced events — so a restored call must continue the same
        window, not a cold one)."""
        return {
            "ring": self._ring.copy(),
            "count": self._count,
            "head": self._head,
            "last_zscore": self._last_zscore.copy(),
            "mean": self.mean,
            "std": self.std,
        }

    def set_state(self, state: dict) -> None:
        self._ring[:] = state["ring"]
        self._count = int(state["count"])
        self._head = int(state["head"])
        self._last_zscore = np.asarray(state["last_zscore"], dtype=np.float64)
        self.mean = float(state["mean"])
        self.std = float(state["std"])


class RealtimeAgentStatsCollection:
    """The three control-signal streams (reference realtime_agent_stats.py:42-51)."""

    def __init__(self, config: RealtimeAgentConfig):
        self.ch_abs_max = RealtimeAgentStats(config, value_size=2)
        self.event_prob = RealtimeAgentStats(config)
        self.tts_interrupt_score = RealtimeAgentStats(config)

    def reset(self) -> None:
        self.ch_abs_max.reset()
        self.event_prob.reset()
        self.tts_interrupt_score.reset()

    def get_state(self) -> dict:
        return {
            "ch_abs_max": self.ch_abs_max.get_state(),
            "event_prob": self.event_prob.get_state(),
            "tts_interrupt_score": self.tts_interrupt_score.get_state(),
        }

    def set_state(self, state: dict) -> None:
        self.ch_abs_max.set_state(state["ch_abs_max"])
        self.event_prob.set_state(state["event_prob"])
        self.tts_interrupt_score.set_state(state["tts_interrupt_score"])
