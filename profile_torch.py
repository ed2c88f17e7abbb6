#!/usr/bin/env python3
"""Where the time of the port's realtime call goes, on one NVIDIA GPU.

Builds the chip_smoke slice (int8 Llama-3.2-1B geometry + default codec,
random seeded weights), warms up, then:

1. host timers per chunk phase (encode / frame steps / commit + decode /
   host bookkeeping), with a synchronize after each phase;
2. a torch.profiler window over N chunks: device busy share, device time per
   chunk, the kernels and host ops that take the most time.

``--events`` profiles the synchronous event path's heavy pieces instead, one
window each: a chunk with a forced response (30 generate_until steps of
canned text), finalize scoring at bucket 2048 (get_logprobs_batch of two
contexts, B4 in every layer), and a trim recompute's prefill (1,100 tokens
after the header).

The hot loop's window is also split by kernel: on int8 decode weights (the
default) into B2 (every layer matmul and the lm_head), the sampler (kernel
S1) and the rest; ``--int4`` profiles the same hot loop on int4 decode
weights (RealtimeAgentResources(quantize_int4=True): kernel B5 for the layer
matmuls, B2 for the int8 lm_head) and splits its device time into B5, B5's
dequant, B2, the sampler and the rest.

``--train`` profiles one training step of chip_smoke's phase 7(b) instead
(Trainer.train_batch, llama32_1b_config at vocab 259,344 with the codec
branch, B = 4, T = 2,048, remat "flash") after two warm-up steps, and splits
its device time into GEMMs, kernel B4 (forward, dq, dk/dv) and the rest
(elementwise, reductions, copies, the optimizer).

Run from the root of a checkout:
    python3 profile_torch.py [--chunks 10] [--trace out.json] [--int4] [--events | --train]
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
    ap.add_argument("--events", action="store_true", help="profile the event path's heavy pieces instead")
    ap.add_argument("--train", action="store_true", help="profile one full-width training step instead")
    ap.add_argument("--int4", action="store_true", help="int4 decode weights (B5) instead of int8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    card = cs.card_line()
    if args.train:
        profile_train(card, args.trace)
        return
    from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources

    dev = torch.device("cuda", 0)
    res = RealtimeAgentResources(quantize_int8=not args.int4, quantize_int4=args.int4, device=dev, seed=cs.SEED)
    audio = cs.bench_audio(60.0)
    if args.events:
        profile_events(res, audio, args.warmup, card)
        return
    agent = cs._agent(res)
    agent.reset()
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
    report(prof, wall, args.chunks, "chunk", card)
    matmul_shares(prof, args.chunks, card, "int4" if args.int4 else "int8")
    if args.trace:
        prof.export_chrome_trace(args.trace)


def kernel_rows(events) -> list:
    """The device kernel rows of a profile's key_averages(), longest first.
    An aten op's row carries the device time of the kernels it launched, and
    a user annotation's device row (torch.optim's "Optimizer.step#...") spans
    kernels that have rows of their own: neither counts."""
    from torch.autograd import DeviceType

    rows = [e for e in events if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    return sorted(rows, key=lambda e: -e.self_device_time_total)


def report(prof, wall: float, n: int, unit: str, card: str, top: int = 15) -> None:
    events = prof.key_averages()
    kernels = kernel_rows(events)
    dev_us = sum(e.self_device_time_total for e in kernels)
    print(f"[profile] {n} {unit}(s): wall {wall / n * 1e3:.2f} ms/{unit}, device busy "
          f"{dev_us / 1e3 / n:.2f} ms/{unit}, busy share {dev_us / 1e6 / wall:.3f} | {card}")
    print(f"[profile] top device time (ms per {unit}, calls per {unit}):")
    for e in kernels[:top]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f}  {e.count / n:7.1f}  {e.key[:90]}")
    ops = sorted((e for e in events if e.key.startswith("aten::")), key=lambda e: -e.self_cpu_time_total)
    print(f"[profile] top host self time (ms per {unit}, calls per {unit}):")
    for e in ops[:top]:
        print(f"  {e.self_cpu_time_total / 1e3 / n:8.3f}  {e.count / n:7.1f}  {e.key}")
    n_launch = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    print(f"[profile] kernel launches per {unit}: {n_launch / n:.0f}")


def matmul_shares(prof, n: int, card: str, quant: str) -> None:
    """Device time per chunk of B5 (int4 layer matmuls, one launch a
    call), B5's dequant (calls wider than 8 rows), B2 (int8: every layer
    matmul and the lm_head; int4: the lm_head), the sampler (kernel S1: the
    whole draw, or its noise-only kernel) and the rest, and their launches
    (the groups of the other quantization read 0)."""
    groups = {"B5": [0.0, 0], "B5 dequant": [0.0, 0], "B2": [0.0, 0], "sampler": [0.0, 0], "other": [0.0, 0]}
    for e in kernel_rows(prof.key_averages()):
        low = e.key.lower()
        g = ("B5" if "int4_matmul" in low else "B5 dequant" if "int4_dequant" in low
             else "B2" if "int8_matmul" in low else "sampler" if "sample_token" in low or "threefry" in low
             else "other")
        groups[g][0] += e.self_device_time_total / 1e3 / n
        groups[g][1] += e.count / n
    busy = sum(v[0] for v in groups.values())
    print(f"[{quant}] device time per chunk by group (ms, share of {busy:.2f} ms busy, kernels launched): "
          + ", ".join(f"{k} {v[0]:.2f} ({v[0] / busy:.3f}, {v[1]:.0f})" for k, v in groups.items()) + f" | {card}")


def profile_events(res, audio, warmup: int, card: str) -> None:
    """One profiler window per heavy piece of the synchronous event path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def window(label, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(f"[events] {label}")
        report(prof, wall, 1, "call", card, top=10)

    agent = cs._agent(res, events={warmup: "resp"}, max_inline_text_tokens=30)
    agent.reset()
    for i in range(warmup):
        agent.process_audio(audio[i * cs.CHUNK : (i + 1) * cs.CHUNK])
    window("forced response chunk (30 generate_until steps)",
           lambda: agent.process_audio(audio[warmup * cs.CHUNK : (warmup + 1) * cs.CHUNK]))

    rng = np.random.default_rng(cs.SEED)
    vocab = res.lm_config.vocab_size
    pairs = [(list(rng.integers(0, vocab, size=1580)), list(rng.integers(0, vocab, size=28))),
             (list(rng.integers(0, vocab, size=12)), list(rng.integers(0, vocab, size=28)))]
    res.llm.get_logprobs_batch(pairs)  # warm-up
    window("finalize scoring, bucket 2048 (2 x 2048 tokens)", lambda: res.llm.get_logprobs_batch(pairs))

    llm = res.llm
    ids = list(rng.integers(res.tokenizer.codec_vocab_start, vocab, size=1100))

    def recompute():
        llm.n_tokens = agent.context_start_pos
        llm.eval(ids)

    recompute()  # warm-up
    window("trim recompute prefill (1,100 tokens after the header)", recompute)


def kernel_group(name: str) -> str:
    """GEMM, B4 or other, by device kernel name."""
    low = name.lower()
    if "flash_fwd" in low or "flash_bwd" in low:
        return "B4"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "cublas", "sm90_", "sm80_")):
        return "GEMM"
    return "other"


def profile_train(card: str, trace=None) -> None:
    """One profiled step of phase 7(b)'s training, device time by group."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _, trainer, batch, labels = cs.full_width_trainer(torch.device("cuda", 0))
    for _ in range(2):
        trainer.train_batch(batch, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_batch(batch, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(prof, wall, 1, "step", card, top=12)
    groups = {"GEMM": 0.0, "B4": 0.0, "other": 0.0}
    for e in kernel_rows(prof.key_averages()):
        groups[kernel_group(e.key)] += e.self_device_time_total / 1e3
    busy = sum(groups.values())
    print(f"[train] device time of one step by group (ms, share of device busy {busy:.1f} ms): "
          + ", ".join(f"{k} {v:.1f} ({v / busy:.3f})" for k, v in groups.items()) + f" | {card}")
    if trace:
        prof.export_chrome_trace(trace)


if __name__ == "__main__":
    main()
