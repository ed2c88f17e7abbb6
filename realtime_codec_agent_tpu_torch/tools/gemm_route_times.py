"""Times ``ops/nn.dot_f32``'s two routes at the training cell's GEMM shapes
(Qwen2.5-0.5B, B 8 x T 2,048 rows; the tied head over one loss block of 8 x
512 rows and 283,024 ids) on the card: the tensor-core route (bf16 operands,
f32 sums and output) and the f32 route (both operands widened to f32 for
``torch.matmul``, as f32 operands take it).
Each shape's forward alone and its forward and backward (both gradients from
an f32 gradient), as CUDA-event medians, in TFLOP/s (2 M K N a product).
One JSON line a shape and route on standard output:

    python -m realtime_codec_agent_tpu_torch.tools.gemm_route_times [--reps 10]
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

import torch

from ..ops import nn
from .timing import median_ms

ROWS = 8 * 2048
# name: (M, K, N) of x (M, K) @ w (K, N); "head" multiplies by the tied table's transposed view
SHAPES = {
    "wqkv": (ROWS, 896, 1152),
    "wo": (ROWS, 896, 896),
    "gate_up": (ROWS, 896, 9728),
    "down": (ROWS, 4864, 896),
    "head": (8 * 512, 896, 283024),
    "projector_w1": (ROWS, 16, 896),
    "projector_w2": (ROWS, 896, 896),
}


def operands(name: str, dev, gen: torch.Generator, rows: Optional[int] = None):
    """(x, table, w, g): bf16 x (M, K) and table, leaves that need gradients,
    w (K, N) the table or, for the head, the transposed view of the (N, K)
    table; an f32 gradient g (M, N) of the output. ``rows`` replaces M."""
    m, k, n = SHAPES[name]
    m = rows or m
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16).requires_grad_(True)
    shape = (n, k) if name == "head" else (k, n)
    table = (torch.randn(*shape, generator=gen, device=dev) * k**-0.5).to(torch.bfloat16).requires_grad_(True)
    g = torch.randn(m, n, generator=gen, device=dev)
    return x, table, (table.T if name == "head" else table), g


def times(name: str, dev, reps: int):
    x, table, w, g = operands(name, dev, torch.Generator(dev).manual_seed(0))
    m, k, n = SHAPES[name]
    flop = 2 * m * k * n
    out = []
    # the f32 route applied to the same bf16 operands: both widened
    for route, fn in (("tensor_core", nn.dot_f32), ("f32", lambda a, b: torch.matmul(a.float(), b.float()))):
        fwd = median_ms(lambda: fn(x, w), reps=reps)  # with a gradient needed: the route training takes

        def step():
            x.grad = table.grad = None
            fn(x, w).backward(g)

        both = median_ms(step, reps=reps)
        out.append({"shape": name, "m": m, "k": k, "n": n, "route": route, "forward_ms": fwd,
                    "forward_tflop_s": flop / fwd / 1e9, "fwd_bwd_ms": both,
                    "fwd_bwd_tflop_s": 3 * flop / both / 1e9})
        x.grad = table.grad = None
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gemm_route_times needs a CUDA device")
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(dev)
    for name in args.shapes:
        for line in times(name, dev, args.reps):
            print(json.dumps({**line, "device": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
