"""Time kernel B1 and B5's dequant through their public wrappers only.

B1 (``ops/quantize.nearest_code_prepared``) at the hot loop's shape (N =
100 frames, the 131,072-entry codebook) and B5's dequant
(``ops/int4_matmul.dequant_int4_bf16``) at Llama-3.2-1B's four fused layer
leaves: the median CUDA-event time of one call with L2 flushed and the mean
over launches replayed from a CUDA graph (``tools/timing.py``). Each result
is first checked against the plain version (B1: codes equal outside
near-ties; dequant: bit for bit). One JSON line on stdout.

Of the package it reads only those two wrappers, their plain versions,
``prepare_codebook``, ``hbm_stream_probe.ctl_operands`` and
``tools/timing.py``, so this file and ``timing.py`` copied into another
checkout of the package time that checkout's kernels on the same inputs
(run two checkouts in turns in one call: parent, change, change, parent).

``--rows`` also times the dequant under every byte-row count a thread
(``dequant_int4_bf16(..., rows=)``: 1, 2, 4, 8, 16) beside the plan's
pick, the sweep behind the plan's rule (this checkout only).

    python -m realtime_codec_agent_tpu_torch.tools.wrapper_times [--reps 20] [--rows]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from realtime_codec_agent_tpu_torch.ops import int4_matmul as m4
from realtime_codec_agent_tpu_torch.ops import quantize as q
from realtime_codec_agent_tpu_torch.tools.hbm_stream_probe import ctl_operands
from realtime_codec_agent_tpu_torch.tools.timing import loop_ms, median_ms

LEAVES = {"wqkv": (2048, 3072), "wo": (2048, 2048), "gate|up": (2048, 16384), "down": (8192, 2048)}


def b1_times(dev, flush, reps: int) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    cb, hn = q.prepare_codebook(torch.randn((131072, 16), generator=gen, device=dev))
    x = torch.randn((100, 16), generator=gen, device=dev)
    got = q.nearest_code_prepared(x, cb, hn)
    scores = x @ cb.T - hn
    top2 = torch.topk(scores, 2, dim=-1).values
    near_tie = (top2[:, 0] - top2[:, 1]) < 1e-5 * torch.clamp(top2[:, 0].abs(), min=1.0)
    if bool(((got != q.nearest_code_plain(x, cb, hn)) & ~near_tie).any()):
        raise SystemExit("B1: codes differ from the plain version outside near-ties")
    return {"ms": median_ms(lambda: q.nearest_code_prepared(x, cb, hn), reps=reps, flush=flush),
            "loop_ms": loop_ms(lambda: q.nearest_code_prepared(x, cb, hn))}


def dequant_times(dev, flush, reps: int, sweep: bool) -> dict:
    gen = torch.Generator(device=dev).manual_seed(15)
    out = {}
    for name, (k, n) in LEAVES.items():
        q4, d, m = ctl_operands("int4", k, n, gen, dev).values()
        want = m4.dequant_int4_bf16_plain(q4, d, m)
        calls = {"plan": lambda: m4.dequant_int4_bf16(q4, d, m)}
        if sweep:
            calls |= {r: (lambda r=r: m4.dequant_int4_bf16(q4, d, m, rows=r)) for r in (1, 2, 4, 8, 16)}
        for key, call in calls.items():
            if not torch.equal(call(), want):
                raise SystemExit(f"B5 dequant {name} ({key}): differs from the plain version")
            times = {"ms": median_ms(call, reps=reps, flush=flush), "loop_ms": loop_ms(call)}
            if key == "plan":
                out[name] = times
            else:
                out[name][f"rows {key}"] = times
        if sweep:
            out[name]["plan rows"] = m4.dequant_rows(k, n)
    out["sum"] = {key: sum(r[key] for r in list(out.values())) for key in ("ms", "loop_ms")}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20, help="timed one-call reps (median)")
    ap.add_argument("--rows", action="store_true", help="also time the dequant under every byte-row count")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("wrapper_times: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "B1": b1_times(dev, flush, args.reps),
                      "B5 dequant": dequant_times(dev, flush, args.reps, args.rows)}))


if __name__ == "__main__":
    main()
