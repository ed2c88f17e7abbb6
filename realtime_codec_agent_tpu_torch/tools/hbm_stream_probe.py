"""How fast one card streams device memory: kernel B6 and a control.

Port of scripts/hbm_stream_probe.py. The question is the same as on the TPU:
does a deeper copy pipeline stream a weight faster than the decode kernels
do? Here the answer is the achievable ceiling that kernels B2 (int8) and B5
(int4) are held to, beside the card's nominal 3.35 TB/s.

Variants, each one launch over a seeded int8 buffer (256 MB, several times
the 50 MB L2) read ``passes`` times, its integer sum checked against the
plain version (ops/hbm_stream.py):

- ``grid_{c}kb``: every byte summed, blocks over (pass, chunk) steps;
- ``manual{d}x{c}kb``: a ring of d shared-memory stages of c KB filled by
  bulk copies, the first 32 rows of 256 bytes of each chunk summed;
- ``matmul_ctl_int8`` / ``matmul_ctl_int4``: B2 and B5 at the w_down decode
  shape (K 8192, N 2048, T 2), launched back to back from a CUDA graph over
  8 weight copies (more bytes than L2 holds); GB/s over their weight bytes.

Times are CUDA-event minima over ``--reps`` runs; GB/s = bytes read from
device memory / time. One JSON line on stdout, as the TPU probe's.

    python -m realtime_codec_agent_tpu_torch.tools.hbm_stream_probe [--mb 256] [--passes 16] [--reps 3]
    python -m realtime_codec_agent_tpu_torch.tools.hbm_stream_probe --tiny   # CPU: plain versions, no times
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, Optional

import torch

from ..ops import hbm_stream as hs
from ..ops import int4_matmul as m4
from ..ops import int8_matmul as m8

GRID_CHUNKS_KB = (16, 64, 256)
MANUAL = ((2, 32), (4, 32), (8, 16), (3, 64), (4, 48), (2, 96))  # (depth, chunk KB), depth * chunk <= 192 KB
CTL_SHAPE = (2, 8192, 2048)   # T, K, N: the w_down decode matmul
CTL_COPIES = 8
CTL_ITERS = 64


def _event_ms(fn: Callable[[], object], reps: int) -> list:
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _graph(fn: Callable[[], object]) -> "torch.cuda.CUDAGraph":
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def ctl_operands(kind: str, k: int, n: int, gen: torch.Generator, device) -> dict:
    """Seeded weights of the control: int8 ``{"wq", "s"}`` or an int4
    ``{"q4", "d", "m"}`` leaf, both in the range of 0.02-scale weights."""
    if kind == "int8":
        return {"wq": torch.randint(-127, 128, (k, n), generator=gen, device=device, dtype=torch.int8),
                "s": (torch.rand((n,), generator=gen, device=device) + 0.5) / 127.0}
    return {"q4": torch.randint(0, 256, (k // 2, n), generator=gen, device=device, dtype=torch.uint8),
            "d": torch.rand((k // 32, n), generator=gen, device=device) * 0.01 + 0.005,
            "m": (torch.rand((k // 32, n), generator=gen, device=device) - 0.5) * 0.2}


def _ctl_call(kind: str, plain: bool = False) -> Callable:
    if kind == "int8":
        f = m8.int8_matmul_plain if plain else m8.int8_matmul
        return lambda x, w: f(x, w["wq"], w["s"])
    f = m4.int4_matmul_plain if plain else m4.int4_matmul
    return lambda x, w: f(x, w["q4"], w["d"], w["m"])


def _matmul_ctl(kind: str, device, gen: torch.Generator, reps: int, tiny: bool) -> dict:
    """B2 or B5 chained at the w_down shape over CTL_COPIES weight copies,
    checked once against its plain version (relative error <= 1e-3)."""
    t, k, n = (2, 1024, 256) if tiny else CTL_SHAPE
    copies = [ctl_operands(kind, k, n, gen, device) for _ in range(1 if tiny else CTL_COPIES)]
    x = torch.randn((t, k), generator=gen, device=device)
    call = _ctl_call(kind)
    got, want = call(x, copies[0]), _ctl_call(kind, plain=True)(x, copies[0])
    rel = float((got - want).abs().max() / want.abs().max())
    if not rel <= 1e-3:
        raise AssertionError(f"matmul_ctl_{kind}: relative error {rel:.3g} against the plain version (> 1e-3)")
    weight_bytes = sum(v.numel() * v.element_size() for v in copies[0].values())
    out = {"rel_err": rel, "weight_bytes": weight_bytes}
    if tiny:
        return {**out, "ms": None, "gbs": None, "all_ms": []}

    def chain():
        for i in range(CTL_ITERS):
            call(x, copies[i % len(copies)])

    graph = _graph(chain)
    times = _event_ms(graph.replay, reps + 1)[1:]
    dt = min(times)
    return {**out, "ms": dt, "gbs": CTL_ITERS * weight_bytes / (dt * 1e-3) / 1e9, "all_ms": times,
            "iters": CTL_ITERS}


def _stream_variant(fn, plain, w, chunk_bytes: int, passes: int, reps: int, timed: bool,
                    library: Optional[Callable] = None) -> dict:
    """One B6 variant: its sum against the plain version's, then times."""
    got, want = int(fn()), int(plain())
    if got != want:
        raise AssertionError(f"sum {got} != plain {want}")
    n_bytes = (w.numel() // chunk_bytes) * chunk_bytes * passes  # what the copies read from device memory
    out = {"sum": got, "plain_sum": want, "bytes": n_bytes}
    if not timed:
        return {**out, "ms": None, "gbs": None, "all_ms": []}
    times = _event_ms(fn, reps + 1)[1:]
    dt = min(times)
    out.update(ms=dt, gbs=n_bytes / (dt * 1e-3) / 1e9, all_ms=times, plain_ms=min(_event_ms(plain, reps)))
    if library is not None:
        library()
        out["library_ms"] = min(_event_ms(library, reps))
    return out


def run(device, total_mb: int = 256, passes: int = 16, reps: int = 3, seed: int = 0,
        tiny: bool = False, log=None) -> Dict:
    """All variants on ``device`` (a CUDA device; with ``tiny``, the CPU:
    2 MB, 2 passes, plain versions, no times). Raises if any variant's sum
    differs from its plain version's."""
    device = torch.device(device)
    timed = device.type == "cuda"
    if tiny:
        total_mb, passes = 2, 2
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randint(-128, 128, (total_mb * 2**20,), generator=gen, device=device, dtype=torch.int8)
    grid = (16,) if tiny else GRID_CHUNKS_KB
    manual = ((2, 32),) if tiny else MANUAL
    results = {}
    for ckb in grid:
        cb = ckb * 1024
        body = w[: (w.numel() // cb) * cb]
        results[f"grid_{ckb}kb"] = _stream_variant(
            lambda: hs.stream_sum(w, cb, passes), lambda: hs.stream_sum_plain(w, cb, passes),
            w, cb, passes, reps, timed,
            # one PyTorch call over the same bytes, passes times: a stride-0 view
            library=lambda: torch.sum(body.view(1, -1).expand(passes, -1), dtype=torch.int64),
        )
    for depth, ckb in manual:
        cb = ckb * 1024
        results[f"manual{depth}x{ckb}kb"] = _stream_variant(
            lambda: hs.stream_rows_sum(w, cb, depth, passes), lambda: hs.stream_rows_sum_plain(w, cb, passes),
            w, cb, passes, reps, timed,
        )
    del w
    for kind in ("int8", "int4"):
        results[f"matmul_ctl_{kind}"] = _matmul_ctl(kind, device, gen, reps, tiny)
    if log is not None:
        for name, r in results.items():
            log(f"[hbm_stream] {name}: " + (f"{r['ms']:.4f} ms, {r['gbs']:.1f} GB/s" if r["ms"] is not None
                                            else "plain version on the CPU, not timed"))
    return {"total_weight_mb": total_mb, "passes": passes, "reduce_rows": hs.REDUCE_ROWS,
            "row_bytes": hs.ROW_BYTES, "device": str(device), "results": results}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tiny", action="store_true", help="2 MB, 2 passes, plain versions on the CPU")
    p.add_argument("--mb", type=int, default=256, help="buffer size (MB)")
    p.add_argument("--passes", type=int, default=16, help="passes over the buffer in one launch")
    p.add_argument("--reps", type=int, default=3, help="timed runs per variant (the minimum is reported)")
    args = p.parse_args(argv)
    if args.tiny:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        print("hbm_stream_probe: no CUDA device (use --tiny for the CPU check)", file=sys.stderr)
        raise SystemExit(1)
    out = run(device, args.mb, args.passes, args.reps, tiny=args.tiny, log=lambda s: print(s, file=sys.stderr))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
