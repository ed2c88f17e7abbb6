"""Where kernel B4's f32 time goes: cut copies of csrc/flash_attention_f32.cu
and csrc/flash_attention_bwd_f32.cu, timed.

Each variant is a kernel source with a few lines replaced, built with the
package's nvcc flags into a library of its own
(``tools/nearest_code_variants.build``), and its forward, dq and dk/dv are
launched through their C entry points at (B = 2, T = 2,048, 32 / 8 heads,
head_dim 64) and (2, 2,048, 12 / 2, 128): CUDA-event median of one call
with L2 flushed and the mean over launches replayed from a CUDA graph
(``tools/timing.py``). The variants:

- ``kernel``: the sources as they are (checked bit for bit against the
  port's wrappers, and held to the plain versions: forward max abs error of
  out and lse, backward max |diff| / max |plain| of dq, dk, dv);
- ``staging``: the cp.async staging, waits and barriers of every tile, no
  arithmetic;
- ``s_only``: staging and the first product (S, or S^T in dk/dv);
- ``no_softmax``: every product, without the mask, exp and row maxima (P =
  S; in the backward dS = S + dP);
- ``no_cluster_sum``: dk/dv without the cluster's sum of partials;
- ``no_staging``: every tile computed from the first one's stage (no copy
  after it, no wait).

A cut's outputs are wrong and are not checked. Also the dk/dv kernel under
every cluster split (1, 2, 4, 8) beside the plan's pick. One JSON line on
stdout. A change to a kernel's source that moves a replaced line makes the
tool fail at once, naming the line.

    python -m realtime_codec_agent_tpu_torch.tools.flash_f32_variants
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from realtime_codec_agent_tpu_torch.ops import _cuda
from realtime_codec_agent_tpu_torch.ops import flash_attention as fa
from realtime_codec_agent_tpu_torch.tools.nearest_code_variants import build
from realtime_codec_agent_tpu_torch.tools.timing import loop_ms, median_ms

SHAPES = ((2, 2048, 32, 8, 64), (2, 2048, 12, 2, 128))  # (B, T, H, KH, Dh)
FWD, BWD = "flash_attention_f32.cu", "flash_attention_bwd_f32.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    FWD: {"rtca_flash_attention_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P)},
    BWD: {n: _cuda._SIGNATURES[n] for n in ("rtca_flash_attention_bwd_dq_f32", "rtca_flash_attention_bwd_dkv_f32")},
}

# the kernels' loop heads, where a cut returns to the next tile (T > 0 is
# always true at run time, so the code after it stays compiled but unrun)
_FWD_S = "    float s[4][4] = {};\n    dot_tile<kD>(s, sQ, sK(st), ty, tx);\n"
_DQ_S = "    float s[4][4] = {};\n    float dp[4][4] = {};\n    dot_tile<kD>(s, sQ, sK(st), ty, tx);\n"
_DQ_DP = "    dot_tile<kD>(dp, sDO, sV(st), ty, tx);\n"
_DKV_ISSUE = "    if (n + 1 < n_hi) issue(n + 1, st ^ 1);\n"
_DKV_DP = "    dot_tile<kD, kDkvDotUnroll<kD>>(dp, sV, sDO(st), ty, tx);  // dP^T\n"
_NEXT_TILE = "    if (more) {\n      const int k1"
_SUM = """#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {acc} += s[a][c];
"""


def _sum_and_next(acc: str, store: bool) -> str:
    """The lines that fold a thread's scores into ``acc`` (so the product is
    not dead code) and go on to the next tile."""
    live = "      if (more) store_live(sLive[st ^ 1], next_live);\n" if store else ""
    return "    if (T > 0) {\n" + live + _SUM.replace("{acc}", acc) + "      continue;\n    }\n"


def variants(fwd: str, bwd: str) -> dict:
    """{name: {source: (edits, checked)}}: each variant's (old, new) text
    replacements of the files it cuts."""
    fwd_softmax = fwd[fwd.index("    uint32_t on = col_bits("):fwd.index("    __syncthreads();  // P complete\n")]
    dq_ds = ("        const float p = on_bit(on, a, c) ? prob(s[a][c], scale, lse_r[a]) : 0.0f;\n"
             "        sDS[r * kLdP + tx + 16 * c] = p * (dp[a][c] - dlt[a]) * scale;\n")
    dkv_ds = ("        const float p = on_bit(on, a, c) ? prob(s[a][c], scale, sLse(st)[ci]) : 0.0f;\n"
              "        dp[a][c] = p * (dp[a][c] - sDelta(st)[ci]) * scale;  // dS^T\n"
              "        s[a][c] = p;\n")
    staging_only = "    if (T > 0) {\n      if (more) store_live(sLive[st ^ 1], next_live);\n      continue;\n    }\n"
    return {
        "kernel": {FWD: ([], True), BWD: ([], True)},
        "staging": {
            FWD: ([(_FWD_S, staging_only + _FWD_S)], False),
            BWD: ([(_DQ_S, staging_only + _DQ_S), (_DKV_ISSUE, _DKV_ISSUE + "    if (T > 0) continue;\n")], False)},
        "s_only": {
            FWD: ([(_FWD_S, _FWD_S + _sum_and_next("l[a]", True))], False),
            BWD: ([(_DQ_DP, _sum_and_next("acc[a][0].x", True) + _DQ_DP),
                   (_DKV_DP, _sum_and_next("dk_acc[a][0].x", False) + _DKV_DP)], False)},
        "no_softmax": {
            FWD: ([(fwd_softmax, "#pragma unroll\n    for (int a = 0; a < 4; ++a)\n#pragma unroll\n"
                                 "      for (int c = 0; c < 4; ++c) sP[(ty + 16 * a) * kLdP + tx + 16 * c] = s[a][c];\n")],
                  False),
            BWD: ([(dq_ds, "        sDS[r * kLdP + tx + 16 * c] = s[a][c] + dp[a][c];\n"),
                   (dkv_ds, "        s[a][c] += dp[a][c];\n")], False)},
        "no_cluster_sum": {BWD: ([("  if (splits > 1) {\n", "  if (splits > 1 && T < 0) {\n")], False)},
        "no_staging": {
            FWD: ([(_NEXT_TILE, "    if (more && T < 0) {\n      const int k1")], False),
            BWD: ([(_NEXT_TILE, "    if (more && T < 0) {\n      const int k1"),
                   (_DKV_ISSUE, "    if (n + 1 < n_hi && T < 0) issue(n + 1, st ^ 1);\n")], False)},
    }


def _open(path, source: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def calls(fwd_lib, bwd_lib, q, k, v, do, out, lse, delta, splits=0):
    """{"fwd", "dq", "dkv"}: one launch each through the libraries' entry
    points into fresh outputs, on the stream current at the call (a graph's
    capture stream); a library that is None gives no entry."""
    b, t, h, dh = q.shape
    kh = k.shape[2]
    scale = float(dh ** -0.5)
    dev = q.device

    def fwd():
        o = torch.empty_like(q)
        ls = torch.empty((b, h, t), dtype=torch.float32, device=dev)
        _cuda.check(fwd_lib.rtca_flash_attention_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(),
                                                     ls.data_ptr(), b, t, h, kh, dh, scale,
                                                     _cuda.stream_handle(dev)), "fwd")
        return o, ls

    def dq():
        g = torch.empty_like(q)
        dl = torch.empty((b, h, t), dtype=torch.float32, device=dev)
        _cuda.check(bwd_lib.rtca_flash_attention_bwd_dq_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(), None,
            g.data_ptr(), dl.data_ptr(), b, t, h, kh, dh, scale, _cuda.stream_handle(dev)), "dq")
        return g, dl

    def dkv():
        gk, gv = torch.empty_like(k), torch.empty_like(v)
        _cuda.check(bwd_lib.rtca_flash_attention_bwd_dkv_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), None,
            gk.data_ptr(), gv.data_ptr(), b, t, h, kh, dh, scale, splits, _cuda.stream_handle(dev)), "dkv")
        return gk, gv

    fns = {}
    if fwd_lib is not None:
        fns["fwd"] = fwd
    if bwd_lib is not None:
        fns.update(dq=dq, dkv=dkv)
    return fns


def main(argv=None) -> None:
    if not torch.cuda.is_available():
        sys.exit("flash_f32_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    cut = variants((_cuda.CSRC / FWD).read_text(), (_cuda.CSRC / BWD).read_text())
    built = {src: build(src, {name: files[src] for name, files in cut.items() if src in files}) for src in (FWD, BWD)}
    libs = {name: ({src: _open(built[src][name][0], src) for src in files}, files[next(iter(files))][1])
            for name, files in cut.items()}
    res = {}
    for b, t, h, kh, dh in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(t + h + dh)
        q, k, v, do = (torch.randn((b, t, n, dh), generator=gen, device=dev) for n in (h, kh, kh, h))
        out, lse = fa.flash_attention(q, k, v)
        dq, delta = fa.flash_attention_bwd_dq_f32(q, k, v, out, lse, do)
        dk, dv = fa.flash_attention_bwd_dkv_f32(q, k, v, do, lse, delta)
        want = {"fwd": (out, lse[..., 0]), "dq": (dq, delta), "dkv": (dk, dv)}
        pout, plse = fa.flash_causal_attention(q, k, v)
        plain = fa.flash_causal_attention_bwd(q, k, v, out, lse, do)
        shape = f"B={b} T={t} H={h}/{kh} Dh={dh}"
        res[shape] = {"splits": fa.dkv_f32_splits(b, t, kh, dh)}
        for name, (lib, checked) in libs.items():
            fns = calls(lib.get(FWD), lib.get(BWD), q, k, v, do, out, lse, delta)
            row = {key: {"ms": median_ms(fn, reps=10, flush=flush), "loop_ms": loop_ms(fn, n=10, reps=3)}
                   for key, fn in fns.items()}
            if checked:
                for key, fn in fns.items():
                    if not all(torch.equal(g, w) for g, w in zip(fn(), want[key])):
                        raise SystemExit(f"flash_f32_variants: {name}'s {key} differs from the wrapper's")
                o, ls = fns["fwd"]()
                g = (fns["dq"]()[0], *fns["dkv"]())
                row["errors"] = {
                    "out_abs": float((o - pout).abs().max()), "lse_abs": float((ls - plse[..., 0]).abs().max()),
                    **{n: float((x - w).abs().max() / w.abs().max().clamp_min(1e-3))
                       for n, x, w in zip(("dq_rel", "dk_rel", "dv_rel"), g, plain)}}
            res[shape][name] = row
            print(f"{shape} {name}: {row}", file=sys.stderr, flush=True)
        kernel = libs["kernel"][0]
        res[shape]["dkv_by_splits"] = {
            s: loop_ms(calls(None, kernel[BWD], q, k, v, do, out, lse, delta, splits=s)["dkv"], n=10, reps=3)
            for s in (1, 2, 4, 8)}
        print(f"{shape} dk/dv loop mean by splits: {res[shape]['dkv_by_splits']}", file=sys.stderr, flush=True)
        del q, k, v, do, out, lse, dq, delta, dk, dv, pout, plse, plain
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "variants": res}))


if __name__ == "__main__":
    main()
