"""Realtime-factor profilers for the duplex pipeline segments.

Port of realtime_codec_agent_tpu/agent/profiler.py: context managers around
each pipeline segment record the realtime factor (chunk_secs / elapsed, host
clock) aggregated per report interval. A device trace, where asked for with
``trace_dir``, is a ``torch.profiler`` trace (CPU + CUDA activities) written
as a Chrome trace.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

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
    """One profiler per pipeline segment, plus optional torch.profiler trace
    capture for device-level inspection."""

    def __init__(self, config: RealtimeAgentConfig, trace_dir: Optional[str] = None):
        self.config = config
        self.trace_dir = trace_dir
        self._trace = None
        for seg in SEGMENTS:
            setattr(self, f"{seg}_profiler", RealtimeAgentProfiler(config))

    def reset(self) -> None:
        for seg in SEGMENTS:
            getattr(self, f"{seg}_profiler").reset()

    # -- device-level tracing ------------------------------------------------
    def start_device_trace(self) -> None:
        if self.trace_dir and self._trace is None:
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._trace = torch.profiler.profile(activities=activities)
            self._trace.start()

    def stop_device_trace(self) -> None:
        if self._trace is not None:
            self._trace.stop()
            os.makedirs(self.trace_dir, exist_ok=True)
            self._trace.export_chrome_trace(os.path.join(self.trace_dir, "trace.json"))
            self._trace = None
