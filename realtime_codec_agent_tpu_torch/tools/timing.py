"""Device timers of the port's measurement scripts (chip_smoke.py and the
sweep tools): the median CUDA-event time of one call, and the mean device
time of a call over back-to-back launches replayed from a CUDA graph."""
from __future__ import annotations

import statistics

import torch

HBM_COPY_BYTES = 160 * 2**20  # copies of a leaf for an hbm mean: > 3x the 50 MB L2


def median_ms(fn, reps: int = 20, flush=None) -> float:
    """Median CUDA-event time of ``fn`` after 3 warm-up calls. ``flush`` (a
    buffer larger than L2) is rewritten before each timed call, so weights
    are read from device memory as they are on the main path."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def loop_ms(fns, n: int = 50, reps: int = 5) -> float:
    """Mean device time per call over back-to-back launches. ``fns`` is one
    call or a list of calls taken in turn (copies of a leaf that together
    exceed L2, :data:`HBM_COPY_BYTES`, give an hbm mean: every launch reads
    its leaf from device memory). After at least 3 warm-up calls (each call
    at least once) ``max(n, len(fns))`` calls are captured once as a CUDA
    graph and replayed ``reps`` times between two CUDA events. A replay
    issues the launches with no Python in between, so the wrapper's host
    time (which a single-call event time includes, and which paces an eager
    loop of short kernels) stays out of the figure."""
    fns = [fns] if callable(fns) else list(fns)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(max(3, len(fns))):
            fns[i % len(fns)]()
    torch.cuda.current_stream().wait_stream(side)
    calls = max(n, len(fns))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * reps)
