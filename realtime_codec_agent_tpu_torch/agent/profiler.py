"""Realtime-factor profilers for the duplex pipeline segments.

Port of realtime_codec_agent_tpu/agent/profiler.py: context managers around
each pipeline segment record the realtime factor (chunk_secs / elapsed, host
clock) aggregated per report interval; ``build_plot`` draws them with the
1.0x threshold line (matplotlib, imported where it draws; its time axis
spans the longest segment, where the JAX package's spans ``total`` and
fails when another segment reports more often).
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from .config import RealtimeAgentConfig


class RealtimeAgentProfiler:
    def __init__(self, config: RealtimeAgentConfig):
        self.config = config
        self.reset()

    def reset(self) -> None:
        self.report_chunk_count = 0
        self.realtime_factor_sum = 0.0
        self.realtime_factor_values: List[float] = []
        self._chunk_start: Optional[float] = None

    def log_chunk_start(self) -> None:
        if not self.config.run_profilers:
            return
        self._chunk_start = time.perf_counter()

    def log_chunk_end(self) -> None:
        if not self.config.run_profilers:
            return
        if self._chunk_start is None:
            raise ValueError("log_chunk_start() must be called before log_chunk_end().")
        elapsed = time.perf_counter() - self._chunk_start
        self.realtime_factor_sum += self.config.chunk_size_secs / (elapsed + 1e-8)
        self.report_chunk_count += 1
        self._chunk_start = None
        if self.report_chunk_count * self.config.chunk_size_secs >= self.config.profiler_report_interval_secs:
            self.realtime_factor_values.append(self.realtime_factor_sum / self.report_chunk_count)
            self.realtime_factor_sum = 0.0
            self.report_chunk_count = 0

    def __enter__(self):
        self.log_chunk_start()
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.log_chunk_end()


SEGMENTS = (
    "total",
    "tokenize",
    "detokenize",
    "audio_tokenize",
    "audio_detokenize",
    "lm",
)


class RealtimeAgentProfilerCollection:
    """One profiler per pipeline segment."""

    def __init__(self, config: RealtimeAgentConfig):
        self.config = config
        for seg in SEGMENTS:
            setattr(self, f"{seg}_profiler", RealtimeAgentProfiler(config))

    def reset(self) -> None:
        for seg in SEGMENTS:
            getattr(self, f"{seg}_profiler").reset()

    # -- plotting ------------------------------------------------------------
    def build_plot(self, ylim: Tuple[float, float] = (0.5, 3.0)):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        interval = self.config.profiler_report_interval_secs
        # the longest segment's length: a segment entered more than once a
        # chunk (the LM's on the stepwise route) reports more often than total
        n = max(len(getattr(self, f"{seg}_profiler").realtime_factor_values) for seg in SEGMENTS)
        x = np.arange(interval, interval * (n + 1), interval)
        fig, ax = plt.subplots(figsize=(14, 4))
        for i, seg in enumerate(SEGMENTS):
            vals = getattr(self, f"{seg}_profiler").realtime_factor_values
            if not vals:
                continue
            color = f"C{i}"
            ax.plot(x[: len(vals)], vals, label=seg, color=color)
            ax.axhline(
                y=float(np.median(vals)),
                xmin=0.05,
                xmax=0.95,
                color=color,
                linestyle="--",
                linewidth=1.5,
                label=f"{seg} (median)",
            )
        ax.axhline(
            y=1.0, xmin=0.05, xmax=0.95, color="orange", linestyle="--", linewidth=2.5,
            label="threshold",
        )
        ax.set_title("Realtime Factor Profile")
        ax.set_xlabel("Time (seconds)")
        ax.set_ylabel("Realtime factor")
        ax.set_ylim(*ylim)
        ax.grid(True)
        fig.legend(loc="outside center right")
        return fig
