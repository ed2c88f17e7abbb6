"""Sweep kernel B5's launch plan at the Llama-3.2-1B layer shapes.

For each layer shape (wqkv, wo, gate|up, down) and T, every candidate plan
(column tile, K splits, k-warps; ops/int4_matmul.Plan) is launched through
the C entry point, checked against the plain version (relative error <=
1e-4: a plan with one split of 256 groups sums them all in one tensor-core
accumulator and reads ~1e-5) and timed two ways, both as the mean over launches replayed from a
CUDA graph:

- ``l2``: one leaf, so after the first launch it is read from the 50 MB L2;
- ``hbm``: the launches cycle over copies of the leaf that together hold
  more than L2, so every launch reads its leaf from device memory, as the
  decode loop does (GB/s over the leaf bytes).

``torch._weight_int4pack_mm`` on the same nibbles is timed the same two
ways beside them (a yardstick: the port never calls it). The plan that
``ops/int4_matmul.plan`` picks is marked. One JSON line on stdout.

    python -m realtime_codec_agent_tpu_torch.tools.int4_plan_sweep [--t 3 1] [--reps 5]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops import _cuda
from ..ops import int4_matmul as m4
from .hbm_stream_probe import ctl_operands
from .timing import HBM_COPY_BYTES, loop_ms

SHAPES = {"wqkv": (2048, 3072), "wo": (2048, 2048), "gate|up": (2048, 16384), "down": (8192, 2048)}


def candidates(k: int, n: int):
    """Every plan the kernel takes at (k, n): tile 32, 64 or 128, 1..8
    splits (powers of 2, every split non-empty), 1..16 k-warps (at most 16
    warps a block, at most the split's groups)."""
    groups = k // m4.GROUP
    for tile in (32, 64, 128):
        for splits in (1, 2, 4, 8):
            per = -(-groups // splits)
            if -(-groups // per) != splits:
                continue
            for kwarps in (1, 2, 4, 8, 16):
                if kwarps <= per and kwarps * tile // 32 <= 16:
                    yield m4.Plan(tile, splits, per, kwarps, -(-n // tile) * splits)


def raw_call(x, leaf, out, p: m4.Plan):
    t, k = x.shape
    n = out.shape[1]
    lib = _cuda.load()

    def fn():
        err = lib.rtca_int4_matmul(x.data_ptr(), leaf["q4"].data_ptr(), leaf["d"].data_ptr(), leaf["m"].data_ptr(),
                                   out.data_ptr(), t, k, n, p.tile, p.splits, p.kwarps,
                                   _cuda.stream_handle(x.device))
        _cuda.check(err, "int4_matmul")
    return fn


def library_call(x, leaf):
    """torch._weight_int4pack_mm on the leaf's nibbles (group 32, bf16
    scales d and zeros 8 d - m), or None where this PyTorch refuses."""
    q4, d, m = leaf["q4"], leaf["d"], leaf["m"]
    k, n = 2 * q4.shape[0], q4.shape[1]
    q_nk = m4.unpack_int4(q4, d.shape[0]).reshape(k, n).t().contiguous()
    try:
        packed = torch._convert_weight_to_int4pack((q_nk[:, ::2] << 4 | q_nk[:, 1::2]).to(torch.uint8), 8)
        sz = torch.stack([d, 8.0 * d - m], dim=-1).to(torch.bfloat16).contiguous()
        torch._weight_int4pack_mm(x, packed, 32, sz)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError):
        return None
    return lambda: torch._weight_int4pack_mm(x, packed, 32, sz)


def sweep(device, ts, reps: int, log) -> dict:
    gen = torch.Generator(device=device).manual_seed(7)
    rows = []
    for name, (k, n) in SHAPES.items():
        leaves = [ctl_operands("int4", k, n, gen, device)]
        leaf_bytes = sum(v.numel() * v.element_size() for v in leaves[0].values())
        leaves += [ctl_operands("int4", k, n, gen, device) for _ in range(-(-HBM_COPY_BYTES // leaf_bytes) - 1)]
        for t in ts:
            x = torch.randn((t, k), generator=gen, device=device).to(torch.bfloat16)
            want = m4.int4_matmul_plain(x, *leaves[0].values())
            chosen = m4.plan(t, k, n)
            lib = [library_call(x, leaf) for leaf in leaves]
            lib_l2 = loop_ms(lib[:1], reps=reps) if lib[0] is not None else None
            lib_hbm = loop_ms(lib, reps=reps) if lib[0] is not None else None
            plans = list(candidates(k, n))
            for p in plans + ([chosen] if chosen not in plans else []):
                outs = [torch.empty((t, n), dtype=torch.float32, device=device) for _ in leaves]
                fns = [raw_call(x, leaf, out, p) for leaf, out in zip(leaves, outs)]
                fns[0]()
                torch.cuda.synchronize()
                rel = float((outs[0] - want).abs().max() / want.abs().max())
                if not rel <= 1e-4:
                    raise AssertionError(f"B5 {name} T={t} {p}: relative error {rel:.3g} > 1e-4")
                l2 = loop_ms(fns[:1], reps=reps)
                hbm = loop_ms(fns, reps=reps)
                row = {"shape": name, "k": k, "n": n, "t": t, "tile": p.tile, "splits": p.splits,
                       "kwarps": p.kwarps, "blocks": p.blocks, "chosen": p == chosen, "rel_err": rel,
                       "l2_ms": l2, "hbm_ms": hbm, "hbm_gbs": leaf_bytes / (hbm * 1e-3) / 1e9,
                       "library_l2_ms": lib_l2, "library_hbm_ms": lib_hbm}
                rows.append(row)
                log(f"[sweep] {name} T={t} tile {p.tile} splits {p.splits} kwarps {p.kwarps} "
                    f"({p.blocks} blocks){' *' if row['chosen'] else ''}: l2 {l2:.4f} ms, hbm {hbm:.4f} ms "
                    f"({row['hbm_gbs']:.0f} GB/s) | library l2 {lib_l2} hbm {lib_hbm}")
        del leaves
        torch.cuda.empty_cache()
    best = {}
    for r in rows:
        key = f"{r['shape']} T={r['t']}"
        if key not in best or r["hbm_ms"] < best[key]["hbm_ms"]:
            best[key] = r
    for key, r in best.items():
        log(f"[sweep] best by hbm {key}: tile {r['tile']} splits {r['splits']} kwarps {r['kwarps']} "
            f"hbm {r['hbm_ms']:.4f} ms, l2 {r['l2_ms']:.4f} ms")
    return {"device": torch.cuda.get_device_name(device), "rows": rows}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--t", type=int, nargs="+", default=[3, 1], help="rows of x")
    p.add_argument("--reps", type=int, default=5, help="graph replays per time")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("int4_plan_sweep: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = sweep(torch.device("cuda", 0), args.t, args.reps, log=lambda s: print(s, file=sys.stderr))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
