#!/usr/bin/env python3
"""Drive the PyTorch port (realtime_codec_agent_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
result line:

1. card     -- a CUDA device is required; prints its name and power limit.
2. build    -- nvcc builds the kernels (csrc/*.cu) into build/torch_kernels/.
3. kernels  -- B1, B2, B3, B4 against their plain PyTorch versions at the
               main path's shapes, with CUDA-event medians of both (one call
               with L2 flushed; for the short kernels also the mean over
               back-to-back launches replayed from a CUDA graph, which keeps
               the wrapper's host time out of the figure).
4. reference-- a small model (head_dim 64, f32) on the card against the same
               model on the CPU (plain versions): identical greedy tokens over
               3 chunks, get_logprobs_batch of a ~1,000-token pair (bucket
               1024: B4 on the card) at atol 1e-4, and a short run with one
               forced transcription and one forced response giving the same
               tokens and transcript.
5. slice    -- the realtime hot loop at full width: int8 Llama-3.2-1B geometry
               (vocab 259,344, KV cache 14,336) + the default 768-wide codec,
               random seeded weights, reset() and 20 s of bench-style audio
               through RealtimeAgent.process_audio. Checks every output chunk,
               every sampled id, the n_tokens schedule and that B1, B2 and B3
               were launched (and their plain versions were not).
6. events   -- the synchronous event path at the same width: 30 s with the
               bench's forced transcription/response every 40 chunks and canned
               event text, 12 s context trimmed by 4 s (blocking recompute),
               finalize scoring (B4 past 512 tokens), and one timed
               get_logprobs_batch of the agent's own finalize contexts at
               bucket 2048. Checks outputs, both speakers in the transcript,
               finalize, >= 2 trims, cache coordinates at every audio-mode
               boundary, fused chunks resuming after each trim and event, and
               that B1-B4 were launched (their plain versions never called).

The last lines are the kernels JSON, the card's name and power limit as
nvidia-smi reports them, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
AUDIO_SECS = 20.0
EVENTS_SECS = 30.0
CHUNK = 1600


def fail(msg: str) -> None:
    print(f"[FAIL] {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20, flush=None) -> float:
    """Median CUDA-event time of ``fn`` after 3 warm-up calls. ``flush`` (a
    buffer larger than L2) is rewritten before each timed call, so weights
    are read from device memory as they are on the main path."""
    import torch

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


def loop_ms(fn, n: int = 50, reps: int = 5) -> float:
    """Mean device time per call of ``fn`` over back-to-back launches: ``n``
    calls captured once as a CUDA graph, replayed ``reps`` times between two
    CUDA events. A replay issues the launches with no Python in between, so
    the wrapper's host time (which a single-call event time includes, and
    which paces an eager loop of short kernels) stays out of the figure; no
    L2 flush between the launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def bench_audio(secs: float, seed: int = SEED, sr: int = 16000) -> np.ndarray:
    """The bench's synthetic voice (bench.py make_audio): a gated 150 Hz tone
    plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(secs * sr)) / sr
    return (
        0.2 * np.sin(2 * np.pi * 150 * t) * np.clip(np.sin(2 * np.pi * 0.7 * t), 0, 1)
        + 0.02 * rng.normal(size=t.shape)
    ).astype(np.float32)


# --------------------------------------------------------------------- kernels

def check_b1(dev, flush):
    import torch
    from realtime_codec_agent_tpu_torch.ops import quantize as q

    gen = torch.Generator(device=dev).manual_seed(SEED)
    cb, hn = q.prepare_codebook(torch.randn((131072, 16), generator=gen, device=dev))
    x = torch.randn((100, 16), generator=gen, device=dev)
    got = q.nearest_code_prepared(x, cb, hn)
    want = q.nearest_code_plain(x, cb, hn)
    scores = x @ cb.T - hn
    top2 = torch.topk(scores, 2, dim=-1).values
    near_tie = (top2[:, 0] - top2[:, 1]) < 1e-5 * torch.clamp(top2[:, 0].abs(), min=1.0)
    diff = got != want
    if bool((diff & ~near_tie).any()):
        fail(f"B1: {int(diff.sum())} codes differ from the plain version outside near-ties")
    gap = (scores.gather(1, want[:, None].long()) - scores.gather(1, got[:, None].long())).abs()
    err = float(gap.max())
    ms = median_ms(lambda: q.nearest_code_prepared(x, cb, hn), flush=flush)
    plain_ms = median_ms(lambda: q.nearest_code_plain(x, cb, hn), flush=flush)
    loop = loop_ms(lambda: q.nearest_code_prepared(x, cb, hn))
    print(f"[kernels] B1 nearest_code N=100 V=131072 D=16: codes equal {int((~diff).sum())}/100, "
          f"near-ties {int(near_tie.sum())}, max score gap {err:.3g} | kernel {ms:.4f} ms "
          f"(loop mean {loop:.4f} ms), plain {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


B2_SHAPES = {
    "wqkv": (2048, 3072), "wo": (2048, 2048), "gate|up": (2048, 16384),
    "down": (8192, 2048), "lm_head": (2048, 259584),
}


def check_b2(dev, flush):
    import torch
    from realtime_codec_agent_tpu_torch.ops import int8_matmul as m

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst = 0.0
    ms_t3 = plain_t3 = 0.0
    for name, (k, n) in B2_SHAPES.items():
        wq = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        s = (torch.rand((n,), generator=gen, device=dev) + 0.5) / 127.0
        for t in (1, 3, 8):
            x = torch.randn((t, k), generator=gen, device=dev).to(torch.bfloat16)
            got = m.int8_matmul(x, wq, s)
            want = m.int8_matmul_plain(x, wq, s)
            abs_err = float((got - want).abs().max())
            rel = abs_err / float(want.abs().max())
            if not rel <= 1e-3:
                fail(f"B2 {name} T={t}: relative max-abs error {rel:.3g} > 1e-3")
            worst = max(worst, abs_err)
            ms = median_ms(lambda: m.int8_matmul(x, wq, s), flush=flush)
            plain_ms = median_ms(lambda: m.int8_matmul_plain(x, wq, s), flush=flush)
            loop = loop_ms(lambda: m.int8_matmul(x, wq, s))
            gbs = k * n / (ms * 1e-3) / 1e9
            print(f"[kernels] B2 int8_matmul {name} K={k} N={n} T={t}: rel err {rel:.3g} (abs {abs_err:.3g}) | "
                  f"kernel {ms:.4f} ms ({gbs:.0f} GB/s of int8 weights; loop mean {loop:.4f} ms), "
                  f"plain {plain_ms:.4f} ms")
            if t == 3:
                ms_t3 += ms
                plain_t3 += plain_ms
        del wq
    print(f"[kernels] B2 sum over the 5 matmul shapes at T=3 (one layer's 4 + lm_head): "
          f"kernel {ms_t3:.4f} ms, plain {plain_t3:.4f} ms")
    return {"max_abs_err": worst, "ms": ms_t3, "plain_ms": plain_t3}


def check_b3(dev, flush):
    import torch
    from realtime_codec_agent_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    kh, dh, s = 8, 64, 14336
    k = torch.randn((s, kh, dh), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((s, kh, dh), generator=gen, device=dev).to(torch.bfloat16)
    scale = dh ** -0.5
    worst = 0.0
    rep = None
    for gt in (4, 12):
        q = torch.randn((kh, gt, dh), generator=gen, device=dev)
        for nv in (0, 1, 2047, 2048, 5000, 14336):
            cv = torch.tensor([nv], dtype=torch.int32, device=dev)
            m, l, acc = da.decode_attention_partials(q, k, v, cv, scale)
            pm, pl, pacc = da.decode_attention_partials_plain(q, k, v, cv, scale)
            if nv == 0:
                if float(l.max()) != 0.0 or not (torch.isfinite(m).all() and torch.isfinite(acc).all()):
                    fail("B3 cache_valid=0: want l == 0 and finite partials")
                out_err = lz_err = 0.0
            else:
                out_err = float((acc / l - pacc / pl).abs().max())
                lz_err = float(((m + torch.log(l)) - (pm + torch.log(pl))).abs().max())
                if not (out_err <= 2e-3 and lz_err <= 1e-3):
                    fail(f"B3 GT={gt} cache_valid={nv}: out err {out_err:.3g} (<= 2e-3), logZ err {lz_err:.3g} (<= 1e-3)")
            worst = max(worst, out_err)
            ms = median_ms(lambda: da.decode_attention_partials(q, k, v, cv, scale), flush=flush)
            plain_ms = median_ms(lambda: da.decode_attention_partials_plain(q, k, v, cv, scale), flush=flush)
            loop = loop_ms(lambda: da.decode_attention_partials(q, k, v, cv, scale))
            print(f"[kernels] B3 decode_attention GT={gt} S={s} cache_valid={nv}: out err {out_err:.3g}, "
                  f"logZ err {lz_err:.3g} | kernel {ms:.4f} ms (loop mean {loop:.4f} ms), plain {plain_ms:.4f} ms")
            if gt == 12 and nv == 2048:
                rep = (ms, plain_ms)
    return {"max_abs_err": worst, "ms": rep[0], "plain_ms": rep[1]}


def check_b4(dev, flush):
    """Causal GQA flash forward at finalize scoring's shapes: B = 2 (the
    audio-first and text-only contexts), 32 heads over 8 KV heads, Dh 64,
    bf16. Tolerances: out 2e-2 (both versions round P and the output to
    bf16, at different running maxima), lse 1e-3 (f32 statistics)."""
    import torch
    from realtime_codec_agent_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    b, h, kh, dh = 2, 32, 8, 64
    worst = 0.0
    rep = None
    for t in (1024, 2048, 4096):
        q = torch.randn((b, t, h, dh), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((b, t, kh, dh), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((b, t, kh, dh), generator=gen, device=dev).to(torch.bfloat16)
        out, lse = fa.flash_attention(q, k, v)
        pout, plse = fa.flash_causal_attention(q, k, v)
        out_err = float((out.float() - pout.float()).abs().max())
        lse_err = float((lse - plse).abs().max())
        if not (torch.isfinite(out).all() and out_err <= 2e-2 and lse_err <= 1e-3):
            fail(f"B4 T={t}: out err {out_err:.3g} (<= 2e-2), lse err {lse_err:.3g} (<= 1e-3)")
        del pout, plse
        worst = max(worst, out_err)
        ms = median_ms(lambda: fa.flash_attention(q, k, v), reps=10, flush=flush)
        plain_ms = median_ms(lambda: fa.flash_causal_attention(q, k, v), reps=5, flush=flush)
        tflops = 4 * b * h * t * t / 2 * dh / (ms * 1e-3) / 1e12
        print(f"[kernels] B4 flash_attention B={b} H={h} KH={kh} Dh={dh} T={t} bf16: out err {out_err:.3g}, "
              f"lse err {lse_err:.3g} | kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s causal), plain {plain_ms:.4f} ms")
        if t == 2048:
            rep = (ms, plain_ms)
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, "ms": rep[0], "plain_ms": rep[1]}


# ------------------------------------------------------------------ the agent

def _agent(resources, temperature=None, events=None, **config):
    """An agent as the bench drives it: every sample restricted to codec
    ids; with ``events`` ({chunk index: "trans" | "resp"}), forced events on
    that schedule of processed chunks and each event's generated ids
    replaced by a canned parseable text (bench.py:718-788: the device does
    the real generation work, the engine mirror is rewritten to the canned
    ids, the device KV keeps the sampled ones)."""
    from realtime_codec_agent_tpu_torch.agent.agent import RealtimeAgent
    from realtime_codec_agent_tpu_torch.agent.config import RealtimeAgentConfig

    kw = dict(
        seed=SEED, use_whisper=False, agent_opening_text=None,
        force_trans_after_inactivity_secs=0.0, force_response_after_inactivity_secs=0.0,
        **config,
    )
    if temperature is not None:
        kw["temperature"] = temperature
    agent = RealtimeAgent(resources=resources, config=RealtimeAgentConfig(**kw))
    orig = agent.set_sampler

    def pinned(for_trans=False, suppress_end_audio=False):
        orig(for_trans=for_trans, suppress_end_audio=suppress_end_audio)
        resources.llm.settings.min_token_id = resources.tokenizer.codec_vocab_start

    agent.set_sampler = pinned
    agent.set_sampler()
    if events is None:
        return agent
    agent.chunk_index = 0
    agent.should_force_transcription = lambda: events.get(agent.chunk_index) == "trans"

    def force_response():
        fire = events.get(agent.chunk_index) == "resp"
        agent.chunk_index += 1  # called once per processed chunk, after the transcription test
        return fire

    agent.should_force_response = force_response
    llm = resources.llm
    canned = resources.tokenizer.encode(CANNED_TEXT, add_special_tokens=False)
    orig_gen = llm.generate_until

    def canned_generate_until(first_token, stop_id, max_n=64, n_limit=None):
        toks, hit = orig_gen(first_token, stop_id, max_n=max_n, n_limit=n_limit)
        if not toks:
            return toks, hit
        out = [canned[j % len(canned)] for j in range(len(toks))]
        if hit:
            out[-1] = toks[-1]
        if len(toks) > 1:
            llm._input_ids[len(llm._input_ids) - (len(toks) - 1):] = out[:-1]
        return out, hit

    llm.generate_until = canned_generate_until
    return agent


CANNED_TEXT = (": okay so that sounds pretty good to me and i think we should keep "
               "going with it for a while longer")


def bench_schedule(n_chunks: int, every: int, warmup: int):
    """bench.py make_sched: alternating transcription / response events."""
    sched = {}
    for k, i in enumerate(i for i in range(warmup, n_chunks) if (i - warmup) % every == every - 1):
        sched[i] = ("trans", "resp")[k % 2]
    return sched


def check_reference(dev):
    """A small model on the card (kernels) against the same weights on the
    CPU (plain versions): 3 greedy chunks, identical tokens; the logprobs of
    a pair at bucket 1024; a forced-event run, identical tokens and
    transcript."""
    import torch
    from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources
    from realtime_codec_agent_tpu_torch.models import codec as codec_lib
    from realtime_codec_agent_tpu_torch.models import llama

    ccfg = codec_lib.tiny_codec_config(compute_dtype="float32")
    lcfg = llama.DuplexLMConfig(
        vocab_size=1320, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4,
        num_kv_heads=2, head_dim=64, max_context=512, codebook_size=1024, compute_dtype="float32",
    )
    gen = torch.Generator().manual_seed(SEED)
    lm = llama.init_lm_params(gen, lcfg)
    cp = codec_lib.init_codec_params(gen, ccfg)

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, d) for v in tree]
        return tree.to(d)

    rng = np.random.default_rng(SEED + 5)
    pairs = [  # ~1,000 tokens: bucket 1024, the flash branch (B4 on the card)
        (list(rng.integers(0, 1320, size=980)), list(rng.integers(0, 1320, size=30))),
        (list(rng.integers(0, 1320, size=12)), list(rng.integers(0, 1320, size=30))),
    ]
    audio = bench_audio(0.8, seed=SEED + 3)
    runs = {}
    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        res = RealtimeAgentResources(
            device=d, lm_config=lcfg, codec_config=ccfg, _lm_params=to(lm, d), _codec_params=to(cp, d),
        )
        run = {}
        agent = _agent(res, temperature=0.0)
        agent.reset()
        run["audio"] = np.stack([agent.process_audio(audio[i * CHUNK : (i + 1) * CHUNK]) for i in range(3)])
        run["ids"] = list(agent.input_ids)
        b4 = counters()["B4"][0].launches
        run["logprobs"] = np.concatenate(res.llm.get_logprobs_batch(pairs))
        run["b4"] = counters()["B4"][0].launches - b4
        # one forced transcription and one forced response, canned text
        agent = _agent(res, temperature=0.0, events={2: "trans", 5: "resp"}, max_inline_text_tokens=8)
        agent.reset()
        for i in range(8):
            agent.process_audio(audio[i * CHUNK : (i + 1) * CHUNK])
        run["event_ids"] = list(agent.input_ids)
        run["transcript"] = [(e["speaker"], e["text"], e["start_secs"], e["end_secs"]) for e in agent.transcript]
        runs[name] = run
    cpu, card = runs["cpu"], runs["cuda"]
    if cpu["ids"] != card["ids"]:
        fail("reference: the card's greedy tokens differ from the CPU's")
    err = float(np.abs(cpu["audio"] - card["audio"]).max())
    if not err <= 1e-3:
        fail(f"reference: audio differs from the CPU run by {err:.3g} (> 1e-3)")
    print(f"[reference] small f32 model (head_dim 64), 3 greedy chunks: card == CPU tokens "
          f"({len(cpu['ids'])} ids), audio max abs diff {err:.3g}")
    lp_err = float(np.abs(cpu["logprobs"] - card["logprobs"]).max())
    if card["b4"] != 2 or cpu["b4"] != 0 or not lp_err <= 1e-4:
        fail(f"reference: logprobs differ by {lp_err:.3g} (> 1e-4) or B4 launched {card['b4']} times "
             f"on the card (want 2: one per layer) and {cpu['b4']} on the CPU")
    print(f"[reference] get_logprobs_batch, a {len(pairs[0][0]) + len(pairs[0][1])}-token pair at bucket 1024 "
          f"(B4 on the card, {card['b4']} launches): logprobs max abs diff {lp_err:.3g}")
    speakers = {e[0] for e in card["transcript"]}
    if cpu["event_ids"] != card["event_ids"] or cpu["transcript"] != card["transcript"] or speakers != {"A", "B"}:
        fail(f"reference: the forced-event run differs between card and CPU, or lacks a speaker "
             f"(card transcript {card['transcript']}, CPU {cpu['transcript']})")
    print(f"[reference] forced transcription + forced response, 8 chunks: card == CPU tokens "
          f"({len(card['event_ids'])} ids) and transcript {card['transcript']}")


def counters():
    from realtime_codec_agent_tpu_torch.ops import decode_attention as da
    from realtime_codec_agent_tpu_torch.ops import flash_attention as fa
    from realtime_codec_agent_tpu_torch.ops import int8_matmul as m
    from realtime_codec_agent_tpu_torch.ops import quantize as q

    return {
        "B1": (q.nearest_code_prepared, q.nearest_code_plain),
        "B2": (m.int8_matmul, m.int8_matmul_plain),
        "B3": (da.decode_attention_partials, da.decode_attention_partials_plain),
        "B4": (fa.flash_attention, fa.flash_causal_attention),
    }


def zero_counters():
    for wrapper, plain in counters().values():
        wrapper.launches = 0
        plain.calls = 0


def full_width_resources(dev):
    import torch
    from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources

    t0 = time.perf_counter()
    res = RealtimeAgentResources(quantize_int8=True, whisper_model=None, device=dev, seed=SEED)
    torch.cuda.synchronize()
    print(f"[slice] resources built in {time.perf_counter() - t0:.1f} s "
          f"(vocab {res.lm_config.vocab_size}, KV cache {res.llm._k.shape[2]}, "
          f"codec {res.audio_tokenizer.codec_model.config.hidden_size} wide x "
          f"{res.audio_tokenizer.codec_model.config.num_layers}+{res.audio_tokenizer.codec_model.config.num_layers} layers)")
    return res


def run_slice(res, card):
    import torch

    agent = _agent(res)
    zero_counters()
    t0 = time.perf_counter()
    agent.reset()
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    audio = bench_audio(AUDIO_SECS)
    n_chunks = len(audio) // CHUNK
    llm = res.llm
    cvs = res.tokenizer.codec_vocab_start
    lat = []
    n_prev = llm.n_tokens
    t_all = time.perf_counter()
    for i in range(n_chunks):
        t1 = time.perf_counter()
        out = agent.process_audio(audio[i * CHUNK : (i + 1) * CHUNK])
        lat.append(time.perf_counter() - t1)  # ends in the chunk's host copy
        if out.shape != (CHUNK,) or not np.isfinite(out).all():
            fail(f"slice chunk {i}: output shape {out.shape}, finite {bool(np.isfinite(out).all())}")
        grow = llm.n_tokens - n_prev
        # the first chunk evals the pending <|audio|> alone: 1 + 4 pairs
        if grow != (9 if i == 0 else 10):
            fail(f"slice chunk {i}: n_tokens grew by {grow}")
        n_prev = llm.n_tokens
    wall = time.perf_counter() - t_all
    counts = {k: (w.launches, p.calls) for k, (w, p) in counters().items() if k != "B4"}
    sampled = [agent.input_ids[j] for j in agent.audio_tokens_idx]
    if len(sampled) != 2 * 5 * n_chunks or min(sampled) < cvs:
        fail(f"slice: {len(sampled)} audio ids, smallest {min(sampled)} (codec ids start at {cvs})")
    for k, (launches, plain_calls) in counts.items():
        if launches <= 0 or plain_calls != 0:
            fail(f"slice: {k} launched {launches} times, plain version called {plain_calls} times")
    lat_ms = np.array(lat) * 1e3
    rtf = wall / (n_chunks * CHUNK / 16000)
    print(f"[slice] reset (3 s enrollment encode + header prefill) {reset_s:.3f} s")
    print(f"[slice] {n_chunks} chunks ({AUDIO_SECS:.0f} s audio): RTF {rtf:.4f} | per-chunk latency "
          f"p50 {np.percentile(lat_ms, 50):.2f} ms, p99 {np.percentile(lat_ms, 99):.2f} ms, "
          f"max {lat_ms.max():.2f} ms | {card}")
    print(f"[slice] after the first 10 chunks: RTF {sum(lat[10:]) / ((n_chunks - 10) * 0.1):.4f}, "
          f"p50 {np.percentile(lat_ms[10:], 50):.2f} ms | {card}")
    print(f"[slice] launches during reset + {n_chunks} chunks: "
          + ", ".join(f"{k} {v[0]} (plain {v[1]})" for k, v in counts.items()))
    print(f"[slice] all {len(sampled)} sampled/encoded ids are codec ids; n_tokens {llm.n_tokens}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {k: v[0] for k, v in counts.items()}


def score_bucket(n: int) -> int:
    """The length get_logprobs_batch pads n tokens to: the prefill buckets,
    then powers of two past the last."""
    from realtime_codec_agent_tpu_torch.lm.engine import PREFILL_BUCKETS

    b = next((b for b in PREFILL_BUCKETS if n <= b), PREFILL_BUCKETS[-1])
    while b < n:
        b *= 2
    return b


EVENTS_WARMUP = 10  # chunks before the first scheduled event and the latency window
EVENT_EVERY = 40


def run_events(res, card):
    """The synchronous event path at full width (bench.py's hard path, cut
    to 30 s with a 12 s context trimmed by 4 s; the bench uses 80 s and 20 s)."""
    import torch
    from realtime_codec_agent_tpu_torch.ops import flash_attention as fa

    n_chunks = int(EVENTS_SECS / 0.1)
    sched = bench_schedule(n_chunks, EVENT_EVERY, EVENTS_WARMUP)
    agent = _agent(
        res, events=sched, max_inline_text_tokens=30, max_context_secs=12.0, trim_by_secs=4.0,
    )
    llm = res.llm

    # instrumentation: each timed piece ends in a synchronize
    scores, recomputes, fused = [], [], [False]
    orig_score = llm.get_logprobs_batch
    orig_recompute = agent.recompute_kv_cache
    orig_commit = agent._commit_fused

    def timed_score(pairs):
        longest = max(len(c) + len(i) for c, i in pairs)
        b4 = fa.flash_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_score(pairs)  # ends in the host copy of the logprobs
        scores.append((time.perf_counter() - t0, longest, fa.flash_attention.launches - b4))
        return out

    def timed_recompute(edit_start_pos, edit_end_pos=None):
        n0 = llm.n_tokens
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig_recompute(edit_start_pos, edit_end_pos)
        torch.cuda.synchronize()
        kind = "trim" if edit_start_pos == 0 else "splice"
        recomputes.append((kind, time.perf_counter() - t0, n0, llm.n_tokens))

    def flag_fused(*args):
        fused[0] = True
        return orig_commit(*args)

    llm.get_logprobs_batch = timed_score
    agent.recompute_kv_cache = timed_recompute
    agent._commit_fused = flag_fused

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    agent.reset()
    audio = bench_audio(EVENTS_SECS, seed=SEED + 6)
    lat, kinds, was_fused = [], [], []
    t_all = time.perf_counter()
    for i in range(n_chunks):
        fused[0] = False
        trim_before, n_scores = agent.trim_to_secs, len(scores)
        t1 = time.perf_counter()
        out = agent.process_audio(audio[i * CHUNK : (i + 1) * CHUNK])
        lat.append(time.perf_counter() - t1)
        if out.shape != (CHUNK,) or not np.isfinite(out).all():
            fail(f"events chunk {i}: output shape {out.shape}, finite {bool(np.isfinite(out).all())}")
        if all(t > agent.end_header_token_id for t in agent.input_ids[-2:]):
            if llm.n_tokens != agent.cache_pos(len(agent.input_ids) - 2):
                fail(f"events chunk {i}: n_tokens {llm.n_tokens} != cache_pos(len - 2) "
                     f"{agent.cache_pos(len(agent.input_ids) - 2)}")
        # bench.py's split; a finalize outside an event chunk counts as an event
        if agent.trim_to_secs != trim_before:
            kinds.append("trim")
        elif i in sched or len(scores) != n_scores:
            kinds.append("event")
        else:
            kinds.append("fast")
        was_fused.append(fused[0])
    wall = time.perf_counter() - t_all
    counts = {k: (w.launches, p.calls) for k, (w, p) in counters().items()}  # the path's own run
    loop_scores = list(scores)

    # finalize's two contexts, built from the agent's own last 15 s at bucket 2048,
    # scored outside the path's run: their launches are counted on their own
    zero_counters()
    c, tok = agent.config, res.tokenizer
    end = agent.total_secs
    af_ctx = agent._mini_header_ids(c.header_audio_first_token) + agent.get_audio_tokens(end - 15.0, end)
    af_ctx += [agent.end_audio_token_id, agent.agent_speaker_token_id] + tok.encode(":", add_special_tokens=False)
    to_ctx = agent._mini_header_ids(c.header_text_only_token, suffix=f" {c.agent_identity}:")
    txt = tok.encode(" " + CANNED_TEXT[2:], add_special_tokens=False)
    if not 1024 < len(af_ctx) + len(txt) <= 2048:
        fail(f"events: the bucket-2048 finalize contexts hold {len(af_ctx) + len(txt)} tokens")
    for _ in range(2):
        lps = llm.get_logprobs_batch([(af_ctx, txt), (to_ctx, txt)])
        if not all(np.isfinite(x).all() and x.shape == (len(txt),) for x in lps):
            fail("events: non-finite logprobs at bucket 2048")
    side = {k: (w.launches, p.calls) for k, (w, p) in counters().items()}
    peak = torch.cuda.max_memory_allocated() / 2**30

    # checks
    speakers = {e["speaker"] for e in agent.transcript}
    trims = [r for r in recomputes if r[0] == "trim"]
    n_layers = res.lm_config.num_layers
    if speakers != {c.agent_identity, c.user_identity}:
        fail(f"events: transcript speakers {speakers}")
    if not loop_scores:
        fail("events: finalize scoring never ran")
    # every scoring call past 512 tokens runs the flash branch: B4 once per layer
    for dt, longest, b4 in scores:
        if longest > 512 and b4 != n_layers:
            fail(f"events: finalize scoring of {longest} tokens launched B4 {b4} times (want {n_layers})")
    flash_scores = sum(longest > 512 for _, longest, _ in loop_scores)
    if flash_scores == 0 or counts["B4"][0] != flash_scores * n_layers:
        fail(f"events: {flash_scores} finalize scores in the loop past 512 tokens, "
             f"B4 launched {counts['B4'][0]} times in the loop (want {n_layers} each)")
    if side["B4"][0] != 2 * n_layers or any(p for _, p in side.values()):
        fail(f"events: the bucket-2048 scoring launched B4 {side['B4'][0]} times (want {2 * n_layers}), "
             f"plain calls {[p for _, p in side.values()]}")
    if len(trims) < 2 or agent.trim_to_secs < 2 * c.trim_by_secs:
        fail(f"events: {len(trims)} blocking trims, trim_to_secs {agent.trim_to_secs}")
    for k, (launches, plain_calls) in counts.items():
        if launches <= 0 or plain_calls != 0:
            fail(f"events: {k} launched {launches} times, plain version called {plain_calls} times")
    for i, kind in enumerate(kinds[:-1]):
        if kind != "fast" and not was_fused[i + 1]:
            fail(f"events: chunk {i + 1}, after a {kind} chunk, did not run fused")

    lat_ms = np.array(lat) * 1e3
    rtf = wall / EVENTS_SECS
    w = EVENTS_WARMUP
    timed = lat_ms[w:]
    print(f"[events] {n_chunks} chunks ({EVENTS_SECS:.0f} s audio), forced events every {EVENT_EVERY} chunks "
          f"at {sorted(sched)}, context 12 s trimmed by 4 s: RTF {rtf:.4f} (after {w} warm-up chunks "
          f"{timed.sum() / 1e3 / ((n_chunks - w) * 0.1):.4f}) | {card}")
    for kind in ("fast", "event", "trim"):
        sel = np.array([k == kind for k in kinds[w:]])
        if sel.any():
            print(f"[events] {kind} chunks: {int(sel.sum())}, latency p50 {np.percentile(timed[sel], 50):.2f} ms, "
                  f"max {timed[sel].max():.2f} ms")
    print(f"[events] fused chunks {sum(was_fused)}, stepwise {n_chunks - sum(was_fused)}; every chunk after a "
          f"trim or event ran fused")
    print(f"[events] transcript: {len(agent.transcript)} entries, speakers {sorted(speakers)}; "
          f"finalize splices {agent.finalize_blocking}")
    for dt, longest, b4 in loop_scores:
        print(f"[events] finalize scoring in the loop: {longest} tokens (bucket {score_bucket(longest)}, "
              f"B4 launches {b4}), {dt * 1e3:.2f} ms | {card}")
    for dt, longest, b4 in scores[len(loop_scores):]:
        print(f"[events] finalize scoring of the agent's own contexts at bucket 2048 ({longest} tokens, "
              f"B4 launches {b4}): {dt * 1e3:.2f} ms | {card}")
    for kind, dt, n0, n1 in recomputes:
        print(f"[events] {kind} recompute: n_tokens {n0} -> {n1}, {dt * 1e3:.2f} ms | {card}")
    print(f"[events] launches during reset + {n_chunks} chunks: "
          + ", ".join(f"{k} {v[0]} (plain {v[1]})" for k, v in counts.items())
          + f"; peak device memory {peak:.2f} GiB")
    print(f"[events] launches of the two bucket-2048 scoring calls after the run: "
          + ", ".join(f"{k} {v[0]} (plain {v[1]})" for k, v in side.items()))
    return {k: v[0] for k, v in counts.items()}


KERNELS = {
    "B1": ("nearest_code", "realtime_codec_agent_tpu_torch/csrc/nearest_code.cu",
           "realtime_codec_agent_tpu/ops/quantize.py:83"),
    "B2": ("int8_matmul", "realtime_codec_agent_tpu_torch/csrc/int8_matmul.cu",
           "realtime_codec_agent_tpu/ops/int8_matmul.py:59"),
    "B3": ("decode_attention_partials", "realtime_codec_agent_tpu_torch/csrc/decode_attention.cu",
           "realtime_codec_agent_tpu/ops/decode_attention.py:237"),
    "B4": ("flash_attention", "realtime_codec_agent_tpu_torch/csrc/flash_attention.cu",
           "realtime_codec_agent_tpu/ops/nn.py:284"),
}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    # the plain versions' f32 matmuls stay f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from realtime_codec_agent_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.load()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_cuda.build_seconds:.1f} s; 0 = already built)", flush=True)

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    results = {
        "B1": check_b1(dev, flush), "B2": check_b2(dev, flush), "B3": check_b3(dev, flush),
        "B4": check_b4(dev, flush),
    }
    del flush
    torch.cuda.empty_cache()

    check_reference(dev)
    res = full_width_resources(dev)
    run_slice(res, card)
    # the kernels line reports the launches of phase 6's run (reset + chunks):
    # every kernel, B4 included, runs on the synchronous event path
    launches = run_events(res, card)

    kernels = []
    for key, (name, source, replaces) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], **results[key],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
