"""Sweep kernel B3's launch plan (splits per cluster, key warps) at the decode
shapes of the Llama-3.2-1B and Qwen2.5-1.5B calls.

For each shape (batch rows x KV heads, G, T, head dim, window W) and valid
cache length, every plan the kernel takes and the card can place
(ops/decode_attention.PLANS and plan_fit: splits 1, 2, 4, 8, 16 -- above 8
a non-portable cluster -- and 1, 2, 4 or 8 key warps) is launched, checked against the plain version (in bf16 ulps
of each output row's largest value) and timed as the mean over launches
replayed from a CUDA graph, two ways:

- ``l2``: one cache, so after the first launch its valid prefix is read from
  the 50 MB L2;
- ``hbm``: the launches cycle over copies of the cache (valid prefix only)
  that together hold more than 3x the L2, as the 16 layers of a frame step
  read theirs.

``torch.nn.functional.scaled_dot_product_attention`` over the same rows, the
valid keys and the window is timed the same two ways beside them (a
yardstick: the port never calls it). The plan that ``ops/decode_attention.plan``
picks is marked. One JSON line on stdout.

    python -m realtime_codec_agent_tpu_torch.tools.decode_attention_plan_sweep [--reps 5]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from ..ops import decode_attention as da
from .timing import HBM_COPY_BYTES, loop_ms

# (name, batch rows, KV heads, G, T, head dim, W)
SHAPES = (
    ("llama frame step", 1, 8, 4, 3, 64, 13),
    ("llama generate_until", 1, 8, 4, 1, 64, 65),
    ("Dh128 G*T 12", 1, 8, 4, 3, 128, 13),
    ("Dh128 G*T 48", 1, 8, 6, 8, 128, 16),
    ("qwen 1.5b frame step", 1, 2, 6, 3, 128, 13),
)
CACHE_VALID = (2048, 14336)


def candidates(rows: int, dh: int):
    """Every plan the kernel takes at ``rows`` and ``dh``, with the clusters
    the card holds at once under it."""
    for p in da.PLANS:
        fit = da.plan_fit(rows, dh, False, p)
        if fit:
            yield p, fit


def _inputs(gen, dev, b, kh, g, t, dh, w, s):
    q, k_big, v_big, k_new, v_new = (
        torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        for shape in ((b, t, kh * g, dh), (b, s, kh, dh), (b, s, kh, dh), (b, w, kh, dh), (b, w, kh, dh))
    )
    q_pos = (s + w - t + torch.arange(t, device=dev))[None]
    new_pos = torch.cat([(s + torch.arange(w - t, device=dev))[None], q_pos], dim=1)
    cv = torch.full((b,), s, dtype=torch.int32, device=dev)
    return q, k_big, v_big, k_new, v_new, q_pos, new_pos, cv


def _ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of the largest |want| of each output row."""
    want = want.float()
    _, e = torch.frexp(want.abs().amax(dim=-1, keepdim=True))
    ulp = torch.ldexp(torch.ones_like(want[..., :1]), (e - 8).clamp_min(-133))
    return float(((got.float() - want).abs() / ulp).max())


def sweep(dev, reps: int, log=print) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, b, kh, g, t, dh, w in SHAPES:
        for nv in CACHE_VALID:
            cache_bytes = 2 * b * nv * kh * dh * 2
            n_copies = max(1, -(-HBM_COPY_BYTES // cache_bytes))
            copies = [_inputs(gen, dev, b, kh, g, t, dh, w, nv) for _ in range(n_copies)]
            one = copies[:1]
            want = da.decode_attention_plain(*one[0])
            picked = da.plan(b * kh, g * t, dh)

            def sdpa(args):
                q, k_big, v_big, k_new, v_new = args[:5]
                qs = q[0].reshape(t, kh, g, dh).permute(1, 2, 0, 3).reshape(1, kh, g * t, dh)
                ks = torch.cat([k_big[0], k_new[0]]).permute(1, 0, 2).contiguous()[None]
                vs = torch.cat([v_big[0], v_new[0]]).permute(1, 0, 2).contiguous()[None]
                return lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=dh ** -0.5)

            with torch.no_grad():
                lib_l2 = loop_ms([sdpa(a) for a in one], reps=reps)
                lib_hbm = loop_ms([sdpa(a) for a in copies], reps=reps)
            for p, clusters in candidates(g * t, dh):
                got = da._launch(*one[0], p)
                torch.cuda.synchronize()
                ulps = _ulps(got, want)
                l2 = loop_ms([lambda a=a: da._launch(*a, p) for a in one], reps=reps)
                hbm = loop_ms([lambda a=a: da._launch(*a, p) for a in copies], reps=reps)
                row = {"shape": name, "bkh": b * kh, "rows": g * t, "dh": dh, "w": w, "cache_valid": nv,
                       "splits": p.splits, "kwarps": p.kwarps, "clusters_at_once": clusters, "picked": p == picked,
                       "ulps": ulps, "l2_ms": l2, "hbm_ms": hbm, "sdpa_l2_ms": lib_l2, "sdpa_hbm_ms": lib_hbm}
                rows.append(row)
                log(f"[sweep] {name} cv={nv} splits {p.splits} kwarps {p.kwarps} ({clusters} clusters at once)"
                    f"{' (picked)' if row['picked'] else ''}: "
                    f"{ulps:.2f} ulps, l2 {l2:.4f} ms, hbm {hbm:.4f} ms | SDPA l2 {lib_l2:.4f}, hbm {lib_hbm:.4f}")
            del copies
            torch.cuda.empty_cache()
    best = {}
    for r in rows:
        key = f"{r['shape']} cv={r['cache_valid']}"
        if key not in best or r["hbm_ms"] < best[key]["hbm_ms"]:
            best[key] = r
    for key, r in best.items():
        log(f"[sweep] best by hbm {key}: splits {r['splits']} kwarps {r['kwarps']} hbm {r['hbm_ms']:.4f} ms, "
            f"l2 {r['l2_ms']:.4f} ms (SDPA hbm {r['sdpa_hbm_ms']:.4f}, l2 {r['sdpa_l2_ms']:.4f})")
    return {"device": torch.cuda.get_device_name(dev), "rows": rows}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=5, help="graph replays per time")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_attention_plan_sweep: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = sweep(torch.device("cuda", 0), args.reps, log=lambda s: print(s, file=sys.stderr))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
