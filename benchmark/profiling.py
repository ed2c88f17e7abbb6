"""A traced sub-window: ``torch.profiler`` over whole ticks or steps, read
from its in-memory events (no trace file is written).

``Trace.start`` / ``Trace.stop`` bracket the sub-window (each after a
synchronize); ``Trace.summary`` gives what the per-layer metrics read:
the window's host seconds, the union of device intervals (``busy_s``),
kernel seconds summed over kernel rows, kernel launches on the host, and the
breakdown (the device operations that took most time, the longest idle
gaps by the host operation that was running on the launching thread).
"""
from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Optional

import torch

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel", "cudaGraphLaunch")
NAME_CHARS = 120


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trace:
    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.t0 = self.t1 = None
        self.units = 0  # ticks or steps inside the window

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        _sync(self.device)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        _sync(self.device)
        self.t1 = time.perf_counter()
        self.prof.stop()

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t1 is None

    def summary(self) -> Optional[Dict]:
        if self.prof is None or self.t1 is None:
            return None
        events = self.prof.profiler.kineto_results.events()
        dev_iv, kernels, cpu_ops = [], collections.Counter(), []
        launch_threads = collections.Counter()
        for e in events:
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if e.is_user_annotation():
                    continue
                s, d = e.start_ns(), e.duration_ns()
                dev_iv.append((s, s + d))
                kernels[name[:NAME_CHARS]] += d
            else:
                if name in LAUNCHES:
                    launch_threads[e.start_thread_id()] += 1
                cpu_ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), name, e.start_thread_id()))
        busy, gaps = _union(dev_iv)
        host = launch_threads.most_common(1)[0][0] if launch_threads else None
        idle = _attribute(gaps, [op for op in cpu_ops if op[3] == host])
        return {
            "window_s": self.t1 - self.t0,
            "busy_s": busy / 1e9,
            "kernel_s": sum(kernels.values()) / 1e9,
            "launches": sum(launch_threads.values()),
            "units": self.units,
            "device_ops": [[k, v / 1e9] for k, v in kernels.most_common(10)],
            "idle_gaps": [[k, v / 1e9] for k, v in idle.most_common(10)],
        }


def _union(iv: List[tuple]):
    """(total covered ns, the gaps between covered stretches)."""
    iv.sort()
    total, gaps = 0, []
    cur_s = cur_e = None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def _attribute(gaps: List[tuple], ops: List[tuple], scan: int = 64) -> collections.Counter:
    """Idle ns by the innermost host op running at each gap's midpoint."""
    ops.sort()
    starts = [o[0] for o in ops]
    out = collections.Counter()
    for a, b in gaps:
        mid = (a + b) // 2
        j = bisect.bisect_right(starts, mid) - 1
        name = "host: between CUDA calls, no op recorded"
        for i in range(j, max(-1, j - scan), -1):
            if ops[i][1] >= mid:
                name = ops[i][2][:NAME_CHARS]
                break
        out[name] += b - a
    return out

