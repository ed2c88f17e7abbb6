"""Sweep kernel B4's backward (csrc/flash_attention_bwd.cu) over its two
choices at the training shapes: the depth of the streamed tiles' ring
(``kStages``, a compile-time constant: each depth other than the shipped one
is built as a variant library, ``_cuda.load_variant``) and the dk/dv
kernel's splits (the blocks of one thread-block cluster that share a key
tile's query tiles).

Shapes: Llama-3.2-1B's training step (4, 2,048, 32 / 8 heads, head_dim 64),
Qwen2.5-1.5B's scoring shape (2, 2,048, 12 / 2, 128) and its training step
at batch 1 (1, 2,048, 12 / 2, 128). Each (depth, shape) launches dq once
and dk/dv at splits 1, 2, 4 and 8 through the C entry points, holds dq, dk
and dv to the plain backward (max |kernel - plain| / max |plain| <= 2e-2),
and times each as the mean over launches replayed from a CUDA graph. The
splits that ``ops/flash_attention.dkv_splits`` picks are marked. One JSON
line on stdout.

    python -m realtime_codec_agent_tpu_torch.tools.flash_bwd_sweep [--stages 2 3] [--reps 3]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops import _cuda
from ..ops import flash_attention as fa
from .timing import loop_ms

SHIPPED_STAGES = 2  # RTCA_FLASH_BWD_STAGES's default in the source
SPLITS = (1, 2, 4, 8)
# (name, B, T, H, KH, head dim)
SHAPES = (
    ("llama train", 4, 2048, 32, 8, 64),
    ("qwen 1.5b scoring", 2, 2048, 12, 2, 128),
    ("qwen 1.5b train", 1, 2048, 12, 2, 128),
)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-3))


def sweep(dev, stages, reps: int, log=print) -> dict:
    rows = []
    for depth in stages:
        lib = _cuda.load() if depth == SHIPPED_STAGES else _cuda.load_variant((f"RTCA_FLASH_BWD_STAGES={depth}",))
        gen = torch.Generator(device=dev).manual_seed(9)
        for name, b, t, h, kh, dh in SHAPES:
            q, k, v, do = (torch.randn((b, t, n, dh), generator=gen, device=dev).to(torch.bfloat16)
                           for n in (h, kh, kh, h))
            out, lse = fa.flash_attention(q, k, v)
            want = fa.flash_causal_attention_bwd(q, k, v, out, lse, do)
            dq = torch.empty_like(q)
            delta = torch.empty((b, h, t), dtype=torch.float32, device=dev)
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            scale = float(dh ** -0.5)

            # the current stream at each call: a graph captures on a stream of its own
            def run_dq():
                _cuda.check(lib.rtca_flash_attention_bwd_dq(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(), None,
                    dq.data_ptr(), delta.data_ptr(), b, t, h, kh, dh, scale, _cuda.stream_handle(dev)), "dq")

            def run_dkv(splits):
                _cuda.check(lib.rtca_flash_attention_bwd_dkv(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), None,
                    dk.data_ptr(), dv.data_ptr(), b, t, h, kh, dh, scale, splits, _cuda.stream_handle(dev)), "dkv")

            run_dq()
            if _rel(dq, want[0]) > 2e-2:
                raise SystemExit(f"flash_bwd_sweep: dq at {name}, stages {depth}: relative error {_rel(dq, want[0])}")
            dq_ms = loop_ms(run_dq, n=10, reps=reps)
            picked = int(lib.rtca_flash_attention_bwd_dkv_splits(b, t, kh, dh))
            for splits in SPLITS:
                run_dkv(splits)
                errs = (_rel(dk, want[1]), _rel(dv, want[2]))
                if max(errs) > 2e-2:
                    raise SystemExit(f"flash_bwd_sweep: dk/dv at {name}, stages {depth}, splits {splits}: "
                                     f"relative errors {errs}")
                row = {"stages": depth, "shape": name, "B": b, "T": t, "H": h, "KH": kh, "head_dim": dh,
                       "splits": splits, "picked": splits == picked, "dq_ms": dq_ms,
                       "dkv_ms": loop_ms(lambda: run_dkv(splits), n=10, reps=reps), "rel_err": max(errs)}
                rows.append(row)
                log(f"[flash_bwd_sweep] stages {depth} {name}: dq {dq_ms:.4f} ms, dk/dv splits {splits} "
                    f"{row['dkv_ms']:.4f} ms{' (picked)' if row['picked'] else ''}, rel err {row['rel_err']:.3g}")
            del q, k, v, do, out, lse, want, dq, delta, dk, dv
            torch.cuda.empty_cache()
    return {"device": torch.cuda.get_device_name(0), "rows": rows}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--stages", type=int, nargs="+", default=[SHIPPED_STAGES, 3], help="ring depths to build")
    p.add_argument("--reps", type=int, default=3, help="graph replays per time")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bwd_sweep: needs a CUDA device", file=sys.stderr)
        raise SystemExit(1)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain backward's f32 matmuls stay f32
    res = sweep(torch.device("cuda", 0), args.stages, args.reps, log=lambda m: print(m, file=sys.stderr))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
