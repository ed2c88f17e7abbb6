#!/usr/bin/env python3
"""Drive the PyTorch port (realtime_codec_agent_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
result line:

1. card     -- a CUDA device is required; prints its name and power limit.
2. build    -- nvcc builds the kernels (csrc/*.cu) into build/torch_kernels/.
3. kernels  -- B1, B2, B3 against their plain PyTorch versions at the main
               path's shapes, with CUDA-event medians of both.
4. reference-- a small model (head_dim 64, f32) on the card against the same
               model on the CPU (plain versions): identical greedy tokens.
5. slice    -- the realtime call at full width: int8 Llama-3.2-1B geometry
               (vocab 259,584, KV cache 14,336) + the default 768-wide codec,
               random seeded weights, reset() and 20 s of bench-style audio
               through RealtimeAgent.process_audio. Checks every output chunk,
               every sampled id, the n_tokens schedule and that B1, B2 and B3
               were launched (and their plain versions were not).

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
    print(f"[kernels] B1 nearest_code N=100 V=131072 D=16: codes equal {int((~diff).sum())}/100, "
          f"near-ties {int(near_tie.sum())}, max score gap {err:.3g} | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
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
            gbs = k * n / (ms * 1e-3) / 1e9
            print(f"[kernels] B2 int8_matmul {name} K={k} N={n} T={t}: rel err {rel:.3g} (abs {abs_err:.3g}) | "
                  f"kernel {ms:.4f} ms ({gbs:.0f} GB/s of int8 weights), plain {plain_ms:.4f} ms")
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
            print(f"[kernels] B3 decode_attention GT={gt} S={s} cache_valid={nv}: out err {out_err:.3g}, "
                  f"logZ err {lz_err:.3g} | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if gt == 12 and nv == 2048:
                rep = (ms, plain_ms)
    return {"max_abs_err": worst, "ms": rep[0], "plain_ms": rep[1]}


# ------------------------------------------------------------------ the agent

def _agent(resources, temperature=None):
    from realtime_codec_agent_tpu_torch.agent.agent import RealtimeAgent
    from realtime_codec_agent_tpu_torch.agent.config import RealtimeAgentConfig

    kw = dict(
        seed=SEED, use_whisper=False, agent_opening_text=None,
        force_trans_after_inactivity_secs=0.0, force_response_after_inactivity_secs=0.0,
    )
    if temperature is not None:
        kw["temperature"] = temperature
    agent = RealtimeAgent(resources=resources, config=RealtimeAgentConfig(**kw))
    orig = agent.set_sampler

    def pinned(for_trans=False, suppress_end_audio=False):
        # as the bench does: every sample is restricted to codec ids
        orig(for_trans=for_trans, suppress_end_audio=suppress_end_audio)
        resources.llm.settings.min_token_id = resources.tokenizer.codec_vocab_start

    agent.set_sampler = pinned
    agent.set_sampler()
    return agent


def check_reference(dev):
    """A small model on the card (kernels) against the same weights on the
    CPU (plain versions): 3 greedy chunks, identical tokens."""
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

    runs = {}
    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        res = RealtimeAgentResources(
            device=d, lm_config=lcfg, codec_config=ccfg, _lm_params=to(lm, d), _codec_params=to(cp, d),
        )
        agent = _agent(res, temperature=0.0)
        agent.reset()
        audio = bench_audio(0.3, seed=SEED + 3)
        outs = [agent.process_audio(audio[i * CHUNK : (i + 1) * CHUNK]) for i in range(3)]
        runs[name] = (list(agent.input_ids), np.stack(outs))
    if runs["cpu"][0] != runs["cuda"][0]:
        fail("reference: the card's greedy tokens differ from the CPU's")
    err = float(np.abs(runs["cpu"][1] - runs["cuda"][1]).max())
    if not err <= 1e-3:
        fail(f"reference: audio differs from the CPU run by {err:.3g} (> 1e-3)")
    print(f"[reference] small f32 model (head_dim 64), 3 greedy chunks: card == CPU tokens "
          f"({len(runs['cpu'][0])} ids), audio max abs diff {err:.3g}")


def counters():
    from realtime_codec_agent_tpu_torch.ops import decode_attention as da
    from realtime_codec_agent_tpu_torch.ops import int8_matmul as m
    from realtime_codec_agent_tpu_torch.ops import quantize as q

    return {
        "B1": (q.nearest_code_prepared, q.nearest_code_plain),
        "B2": (m.int8_matmul, m.int8_matmul_plain),
        "B3": (da.decode_attention_partials, da.decode_attention_partials_plain),
    }


def run_slice(dev, card):
    import torch
    from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources

    t0 = time.perf_counter()
    res = RealtimeAgentResources(quantize_int8=True, whisper_model=None, device=dev, seed=SEED)
    agent = _agent(res)
    torch.cuda.synchronize()
    print(f"[slice] resources + agent built in {time.perf_counter() - t0:.1f} s "
          f"(vocab {res.lm_config.vocab_size}, KV cache {res.llm._k.shape[2]}, "
          f"codec {res.audio_tokenizer.codec_model.config.hidden_size} wide x "
          f"{res.audio_tokenizer.codec_model.config.num_layers}+{res.audio_tokenizer.codec_model.config.num_layers} layers)")

    for wrapper, plain in counters().values():
        wrapper.launches = 0
        plain.calls = 0
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
    counts = {k: (w.launches, p.calls) for k, (w, p) in counters().items()}
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


KERNELS = {
    "B1": ("nearest_code", "realtime_codec_agent_tpu_torch/csrc/nearest_code.cu",
           "realtime_codec_agent_tpu/ops/quantize.py:83"),
    "B2": ("int8_matmul", "realtime_codec_agent_tpu_torch/csrc/int8_matmul.cu",
           "realtime_codec_agent_tpu/ops/int8_matmul.py:59"),
    "B3": ("decode_attention_partials", "realtime_codec_agent_tpu_torch/csrc/decode_attention.cu",
           "realtime_codec_agent_tpu/ops/decode_attention.py:237"),
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
    results = {"B1": check_b1(dev, flush), "B2": check_b2(dev, flush), "B3": check_b3(dev, flush)}
    del flush
    torch.cuda.empty_cache()

    check_reference(dev)
    launches = run_slice(dev, card)

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
