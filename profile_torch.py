#!/usr/bin/env python3
"""Where the time of the port's realtime call goes, on one NVIDIA GPU.

Builds the chip_smoke slice (int8 Llama-3.2-1B geometry + default codec,
random seeded weights), warms up, then:

1. host timers per chunk phase (encode / frame steps / commit + decode /
   host bookkeeping), with a synchronize after each phase;
2. a torch.profiler window over N chunks: device busy share, device time per
   chunk, the kernels and host ops that take the most time.

Run from the root of a checkout:
    python3 profile_torch.py [--chunks 10] [--trace out.json]
``--trace`` also writes the profiler window as a Chrome trace (large: tens
of MiB for 5 chunks).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

import chip_smoke as cs


def phase_timers(agent, audio, n, start):
    """Per-phase host time of fused chunks, each phase ended by a sync."""
    import torch

    sess = agent._session
    acc = {"encode": 0.0, "frames": 0.0, "commit+decode": 0.0, "agent host": 0.0}
    orig_encode, orig_decode = sess._encode_codes, sess._decode_tail
    orig_scatter = None
    marks = {}

    def encode(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_encode(*a)
        torch.cuda.synchronize()
        marks["enc_end"] = time.perf_counter()
        acc["encode"] += marks["enc_end"] - t
        return out

    def decode(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_decode(*a)
        torch.cuda.synchronize()
        acc["commit+decode"] += time.perf_counter() - t
        return out

    import realtime_codec_agent_tpu_torch.lm.duplex_session as ds

    orig_scatter = ds.commit_kv_scatter

    def scatter(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        acc["frames"] += t - marks["enc_end"]
        out = orig_scatter(*a)
        torch.cuda.synchronize()
        acc["commit+decode"] += time.perf_counter() - t
        return out

    sess._encode_codes, sess._decode_tail, ds.commit_kv_scatter = encode, decode, scatter
    t_all = time.perf_counter()
    for i in range(start, start + n):
        agent.process_audio(audio[i * cs.CHUNK : (i + 1) * cs.CHUNK])
    wall = time.perf_counter() - t_all
    sess._encode_codes, sess._decode_tail, ds.commit_kv_scatter = orig_encode, orig_decode, orig_scatter
    acc["agent host"] = wall - sum(acc.values())
    return {k: v / n * 1e3 for k, v in acc.items()}, wall / n * 1e3


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--trace", default=None, help="write the profiler window as a Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    card = cs.card_line()
    from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources

    dev = torch.device("cuda", 0)
    res = RealtimeAgentResources(quantize_int8=True, device=dev, seed=cs.SEED)
    agent = cs._agent(res)
    agent.reset()
    audio = cs.bench_audio(60.0)
    for i in range(args.warmup):
        agent.process_audio(audio[i * cs.CHUNK : (i + 1) * cs.CHUNK])
    torch.cuda.synchronize()

    phases, per_chunk = phase_timers(agent, audio, args.chunks, args.warmup)
    print(f"[phases] synchronized, ms per chunk (total {per_chunk:.2f}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()) + f" | {card}")

    start = args.warmup + args.chunks
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(start, start + args.chunks):
            agent.process_audio(audio[i * cs.CHUNK : (i + 1) * cs.CHUNK])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events)
    print(f"[profile] {args.chunks} chunks: wall {wall / args.chunks * 1e3:.2f} ms/chunk, device busy "
          f"{dev_us / 1e3 / args.chunks:.2f} ms/chunk, busy share {dev_us / 1e6 / wall:.3f} | {card}")
    kernels = sorted((e for e in events if e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    print("[profile] top device time (ms per chunk, calls per chunk):")
    for e in kernels[:15]:
        print(f"  {e.self_device_time_total / 1e3 / args.chunks:8.3f}  {e.count / args.chunks:7.1f}  {e.key[:90]}")
    ops = sorted((e for e in events if e.key.startswith("aten::")), key=lambda e: -e.self_cpu_time_total)
    print("[profile] top host self time (ms per chunk, calls per chunk):")
    for e in ops[:15]:
        print(f"  {e.self_cpu_time_total / 1e3 / args.chunks:8.3f}  {e.count / args.chunks:7.1f}  {e.key}")
    n_launch = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    print(f"[profile] kernel launches per chunk: {n_launch / args.chunks:.0f}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
