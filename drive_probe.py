#!/usr/bin/env python3
"""Compare the realtime agent's drives on one NVIDIA GPU: where a call's
time goes, and where a host synchronization hides.

Run from the root of a checkout:  python3 drive_probe.py

Builds chip_smoke.py's full-width int8 resources (Llama-3.2-1B geometry,
vocab 259,344, KV cache 14,336, the 768-wide codec, seed 0) and drives its
30 s event schedule (phases 6 and 10: forced events every 40 chunks with
canned text, a 12 s context trimmed by 4 s, incremental_trim on) through
five drives in turn: synchronous; pipeline_chunks; pipeline_chunks +
async_detours; the same with torch.cuda.set_sync_debug_mode("warn") held
around every speculative dispatch and trim pump; synchronous again (the
spread of one drive within the call). Each drive prints its RTF, the p50
and mean of its fast calls (no event, detour or rebuild before or after
the call) and the blocking sections the agent reports per call
(``last_call_acct``) averaged over those calls. The warn-mode drive then
prints each distinct Python stack at which a synchronization fired, with
its count (torch's own "prototype feature" notice is not one).
"""
from __future__ import annotations

import collections
import sys
import time
import traceback
import warnings

import numpy as np

import chip_smoke as cs


def drive(res, label: str, card: str, warn_syncs: bool = False, **config) -> collections.Counter:
    import torch

    llm = res.llm
    for name in ("generate_until", "get_logprobs_batch"):  # earlier drives' instrumentation
        llm.__dict__.pop(name, None)
    n = int(cs.EVENTS_SECS / 0.1)
    sched = cs.bench_schedule(n, cs.EVENT_EVERY, cs.EVENTS_WARMUP)
    audio = cs.bench_audio(cs.EVENTS_SECS, seed=cs.SEED + 6)
    agent = cs._agent(res, events=sched, max_inline_text_tokens=30, max_context_secs=12.0, trim_by_secs=4.0,
                      incremental_trim=True, **config)
    stacks = collections.Counter()
    if warn_syncs:
        def guarded(fn):
            def run(*args):
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return fn(*args)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            return run

        agent._dispatch_speculative = guarded(agent._dispatch_speculative)
        agent._trim_pump = guarded(agent._trim_pump)
    torch.cuda.synchronize()
    agent.reset()
    torch.cuda.synchronize()
    lat, acct = [], collections.Counter()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def record(message, category, filename, lineno, file=None, line=None):
            text = str(message)
            if "synchroniz" in text and "prototype feature" not in text:
                stacks["".join(traceback.format_stack(limit=12)[:-2])] += 1
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = record
        t0 = time.perf_counter()
        for i in range(n):
            busy_before = agent._trim_rebuild is not None or agent._detour_future is not None
            t1 = time.perf_counter()
            agent.process_audio(audio[i * cs.CHUNK : (i + 1) * cs.CHUNK])
            dt = time.perf_counter() - t1
            busy_after = agent._trim_rebuild is not None or agent._detour_future is not None
            if i >= cs.EVENTS_WARMUP and not (busy_before or busy_after or i in sched):
                lat.append(dt)
                acct.update({k: v for k, v in agent.last_call_acct.items() if k != "pumped_chunks_n"})
        agent.quiesce()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for name in ("generate_until", "get_logprobs_batch"):
        llm.__dict__.pop(name, None)
    lat_ms = np.array(lat) * 1e3
    sections = ", ".join(f"{k} {v * 1e3 / len(lat):.2f}" for k, v in sorted(acct.items())) or "none"
    print(f"[{label}] RTF {wall / cs.EVENTS_SECS:.4f}; {len(lat)} fast calls, p50 {np.percentile(lat_ms, 50):.2f} "
          f"mean {lat_ms.mean():.2f} ms; blocking sections per fast call (ms): {sections} | {card}", flush=True)
    return stacks


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this script measures the port on the card")
    card = cs.card_line()
    from realtime_codec_agent_tpu_torch.ops import _cuda

    _cuda.load()
    res = cs.full_width_resources(torch.device("cuda", 0), tag="drives")
    drive(res, "sync", card)
    drive(res, "pipelined", card, pipeline_chunks=True)
    drive(res, "pipelined + async detours", card, pipeline_chunks=True, async_detours=True)
    stacks = drive(res, "pipelined + async detours, sync-warn guard", card, warn_syncs=True,
                   pipeline_chunks=True, async_detours=True)
    drive(res, "sync again", card)
    print(f"[syncs] {sum(stacks.values())} host synchronizations inside dispatches and pumps, "
          f"{len(stacks)} distinct stacks")
    for stack, count in stacks.most_common():
        print(f"[syncs] {count} times at:\n{stack}")
    print(card)


if __name__ == "__main__":
    sys.exit(main())
