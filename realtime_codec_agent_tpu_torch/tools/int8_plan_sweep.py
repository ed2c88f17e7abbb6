"""Sweep kernel B2's launch plan at the decode shapes of the models it serves.

The shapes (``SHAPES``): Llama-3.2-1B's fused layer matmuls (wqkv, wo,
gate|up, down) and full-width lm_head, Qwen2.5-1.5B's five, and two N that
are not multiples of 16 (the byte path: the tiny vocab and an odd N). For
each shape and T, every candidate
plan (column tile, K splits, k-warps; ops/int8_matmul.Plan) is launched
through the C entry point, checked against the plain version (relative
error <= 1e-5, two launches bitwise equal) and timed two ways, both as the
mean over launches replayed from a CUDA graph:

- ``l2``: one leaf, so after the first launch a leaf of up to ~34 MB is read
  from the 50 MB L2;
- ``hbm``: the launches cycle over copies of the leaf that together hold
  more than L2, so every launch reads its leaf from device memory, as the
  decode loop does (GB/s over the weight bytes).

``torch._weight_int8pack_mm`` on the same weights is timed the same two
ways beside them (a yardstick: the port never calls it). The plan that
``ops/int8_matmul.plan`` picks is marked. One JSON line on stdout; a plan
that disagrees with the plain version fails the run after every row is
printed.

``--wrapper`` times only the public wrapper ``int8_matmul`` (no plans, no
C entry point): one call with L2 flushed, ``l2`` and ``hbm``. Of the
package it reads only ``ops/int8_matmul.int8_matmul`` and
``int8_matmul_plain``, ``hbm_stream_probe.ctl_operands`` and
``tools/timing.py``, so this file and ``timing.py`` copied into another
checkout of the package time that checkout's kernel on the same inputs.

    python -m realtime_codec_agent_tpu_torch.tools.int8_plan_sweep [--t 3 1 8] [--shapes wo lm_head] [--reps 5]
    python -m realtime_codec_agent_tpu_torch.tools.int8_plan_sweep --wrapper [--t 3 1]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops import int8_matmul as m8
from .hbm_stream_probe import ctl_operands
from .timing import HBM_COPY_BYTES, loop_ms, median_ms

SHAPES = {"wqkv": (2048, 3072), "wo": (2048, 2048), "gate|up": (2048, 16384), "down": (8192, 2048),
          "lm_head": (2048, 259344),
          "qwen wqkv": (1536, 2048), "qwen wo": (1536, 1536), "qwen gate|up": (1536, 17920),
          "qwen down": (8960, 1536), "qwen lm_head": (1536, 283024),
          "tiny vocab": (2048, 1320), "odd N": (2048, 1321)}
TOL = 1e-5


def candidates(k: int, n: int):
    """Every plan the kernel takes at (k, n) within the accumulator bound:
    tile 32, 64 or 128, 1..8 splits (powers of 2, every split non-empty),
    1..8 k-warps (at most the split's steps), no warp summing more than
    ops/int8_matmul.MAX_RUN steps; the byte path (N % 16 != 0) at every
    tile too."""
    for tile in (32, 64, 128):
        for splits in (1, 2, 4, 8):
            p = m8.make_plan(k, n, tile, splits, 1)
            if p.splits != splits:
                continue
            for kwarps in (1, 2, 4, 8):
                if kwarps <= p.steps_per_split and -(-p.steps_per_split // kwarps) <= m8.MAX_RUN:
                    yield p._replace(kwarps=kwarps)


def raw_call(xb, leaf, out, p):
    def fn():
        m8._launch(xb, leaf["wq"], leaf["s"], out, p)
    return fn


def library_call(x, leaf):
    """torch._weight_int8pack_mm on the same weights ((N, K) int8, bf16
    scales), or None where this PyTorch refuses."""
    w_nk = leaf["wq"].t().contiguous()
    scales = leaf["s"].to(x.dtype)
    try:
        torch._weight_int8pack_mm(x, w_nk, scales)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError):
        return None
    return lambda: torch._weight_int8pack_mm(x, w_nk, scales)


def leaves_of(k: int, n: int, gen, device) -> list:
    """One int8 leaf, then copies of it until they hold > HBM_COPY_BYTES."""
    first = ctl_operands("int8", k, n, gen, device)
    leaf_bytes = sum(v.numel() * v.element_size() for v in first.values())
    return [first] + [{key: v.clone() for key, v in first.items()} for _ in range(-(-HBM_COPY_BYTES // leaf_bytes) - 1)]


def sweep(device, shapes, ts, reps: int, log) -> dict:
    gen = torch.Generator(device=device).manual_seed(7)
    rows, failures = [], []
    for name in shapes:
        k, n = SHAPES[name]
        leaves = leaves_of(k, n, gen, device)
        weight_bytes = k * n
        for t in ts:
            x = torch.randn((t, k), generator=gen, device=device).to(torch.bfloat16)
            xb = m8.padded_rows(x)
            want = m8.int8_matmul_plain(x, leaves[0]["wq"], leaves[0]["s"])
            chosen = m8.plan(t, k, n)
            lib = [library_call(x, leaf) for leaf in leaves]
            lib_l2 = loop_ms(lib[:1], reps=reps) if lib[0] is not None else None
            lib_hbm = loop_ms(lib, reps=reps) if lib[0] is not None else None
            plans = list(candidates(k, n))
            for p in plans + ([chosen] if chosen not in plans else []):
                outs = [torch.empty((t, n), dtype=torch.float32, device=device) for _ in leaves]
                fns = [raw_call(xb, leaf, out, p) for leaf, out in zip(leaves, outs)]
                fns[0]()
                first = outs[0].clone()
                fns[0]()
                torch.cuda.synchronize()
                rel = float((first - want).abs().max() / want.abs().max())
                repeat = bool(torch.equal(first, outs[0]))
                if not (rel <= TOL and repeat):
                    failures.append(f"{name} T={t} {p}: relative error {rel:.3g}, bitwise repeatable {repeat}")
                l2 = loop_ms(fns[:1], reps=reps)
                hbm = loop_ms(fns, reps=reps)
                row = {"shape": name, "k": k, "n": n, "t": t, "tile": p.tile, "splits": p.splits,
                       "kwarps": p.kwarps, "blocks": p.blocks, "chosen": p == chosen, "rel_err": rel,
                       "l2_ms": l2, "hbm_ms": hbm, "hbm_gbs": weight_bytes / (hbm * 1e-3) / 1e9,
                       "library_l2_ms": lib_l2, "library_hbm_ms": lib_hbm}
                rows.append(row)
                log(f"[sweep] {name} T={t} tile {p.tile} splits {p.splits} kwarps {p.kwarps} "
                    f"({p.blocks} blocks){' *' if row['chosen'] else ''}: rel {rel:.3g}, l2 {l2:.4f} ms, hbm "
                    f"{hbm:.4f} ms ({row['hbm_gbs']:.0f} GB/s) | library l2 {lib_l2} hbm {lib_hbm}")
        del leaves
        torch.cuda.empty_cache()
    best = {}
    for r in rows:
        key = f"{r['shape']} T={r['t']}"
        if key not in best or r["hbm_ms"] < best[key]["hbm_ms"]:
            best[key] = r
    for key, r in best.items():
        mine = next(c for c in rows if f"{c['shape']} T={c['t']}" == key and c["chosen"])
        log(f"[sweep] best by hbm {key}: tile {r['tile']} splits {r['splits']} kwarps {r['kwarps']} "
            f"hbm {r['hbm_ms']:.4f} ms, l2 {r['l2_ms']:.4f} ms; chosen tile {mine['tile']} splits "
            f"{mine['splits']} kwarps {mine['kwarps']} hbm {mine['hbm_ms']:.4f} ms "
            f"({mine['hbm_ms'] / r['hbm_ms']:.3f} of the best's time)")
    return {"device": torch.cuda.get_device_name(device), "rows": rows, "failures": failures}


def wrapper_times(device, shapes, ts, reps: int, log) -> dict:
    """The public wrapper alone: one call (L2 flushed), l2 and hbm means."""
    gen = torch.Generator(device=device).manual_seed(7)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    rows, failures = [], []
    for name in shapes:
        k, n = SHAPES[name]
        leaves = leaves_of(k, n, gen, device)
        for t in ts:
            x = torch.randn((t, k), generator=gen, device=device).to(torch.bfloat16)
            want = m8.int8_matmul_plain(x, leaves[0]["wq"], leaves[0]["s"])
            got = m8.int8_matmul(x, leaves[0]["wq"], leaves[0]["s"])
            rel = float((got - want).abs().max() / want.abs().max())
            if not rel <= TOL:
                failures.append(f"{name} T={t}: relative error {rel:.3g}")
            fns = [lambda leaf=leaf: m8.int8_matmul(x, leaf["wq"], leaf["s"]) for leaf in leaves]
            one = median_ms(fns[0], flush=flush)
            l2 = loop_ms(fns[:1], reps=reps)
            hbm = loop_ms(fns, reps=reps)
            row = {"shape": name, "k": k, "n": n, "t": t, "rel_err": rel, "one_call_ms": one, "l2_ms": l2,
                   "hbm_ms": hbm, "hbm_gbs": k * n / (hbm * 1e-3) / 1e9}
            rows.append(row)
            log(f"[wrapper] {name} K={k} N={n} T={t}: rel {rel:.3g}, one call {one:.4f} ms, l2 {l2:.4f} ms, hbm "
                f"{hbm:.4f} ms ({row['hbm_gbs']:.0f} GB/s)")
        del leaves
        torch.cuda.empty_cache()
    return {"device": torch.cuda.get_device_name(device), "rows": rows, "failures": failures}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--t", type=int, nargs="+", default=[3, 1, 8], help="rows of x")
    p.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    p.add_argument("--reps", type=int, default=5, help="graph replays per time")
    p.add_argument("--wrapper", action="store_true", help="time the public wrapper only")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_plan_sweep: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    run = wrapper_times if args.wrapper else sweep
    out = run(torch.device("cuda", 0), args.shapes, args.t, args.reps, log=lambda s: print(s, file=sys.stderr))
    print(json.dumps(out))
    if out["failures"]:
        print("int8_plan_sweep: " + "; ".join(out["failures"]), file=sys.stderr)
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
