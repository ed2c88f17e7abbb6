"""Where kernel B1's time goes: variants of csrc/nearest_code.cu, timed.

Each variant is the kernel's source with a few lines replaced (a cut or a
changed constant), built with the package's nvcc flags into a library of
its own under build/torch_kernels/variants/, and launched through its C
entry point at the hot loop's shape (N = 100 frames, the 131,072-entry
codebook): CUDA-event median of one call with L2 flushed and the mean over
launches replayed from a CUDA graph (``tools/timing.py``). The variants:

- ``kernel``: the source as it is (checked against the plain version);
- ``launch``: returns at once (the launch and the blocks' start);
- ``staging``: stages the chunk and returns;
- ``no_scoring``: stages and reduces, scores nothing;
- ``no_reduction``: stages and scores, writes the block keys, stops there;
- ``rows_8``: 8 rows a thread, one block an SM;
- ``codes_8``: 8 codes a step;
- ``one_level``: one ticket, the last block loading every block's key.

A cut variant's codes are wrong and are not checked. One JSON line on
stdout. A change to the kernel's source that moves a replaced line makes
the tool fail at once, naming the line.

    python -m realtime_codec_agent_tpu_torch.tools.nearest_code_variants
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from realtime_codec_agent_tpu_torch.ops import _cuda
from realtime_codec_agent_tpu_torch.ops import quantize as q
from realtime_codec_agent_tpu_torch.tools.timing import loop_ms, median_ms

N, V = 100, 131072
_LEVEL1 = "  // level 1: the last block of each kGroupBlocks blocks reduces their keys\n"
_ONE_LEVEL = """  if (!last_arrival(tickets + blockIdx.y * (p.groups + 1), gridDim.x, &s_flag)) return;
  const int ways = blockDim.x / nrows;
  const int r = threadIdx.x % nrows, w = threadIdx.x / nrows;
  if (w < ways) {
    unsigned long long k = 0ull;
    for (int i0 = w; i0 < (int)gridDim.x; i0 += 32 * ways) {
      unsigned long long t[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int i = i0 + j * ways;
        t[j] = i < (int)gridDim.x ? __ldcg(blocks_part + (size_t)i * p.rows + r) : 0ull;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) k = key_max(k, t[j]);
    }
    s_tmp[w * nrows + r] = k;
  }
  __syncthreads();
  if (threadIdx.x < nrows) {
    unsigned long long k = s_tmp[threadIdx.x];
    for (int i = 1; i < ways; ++i) k = key_max(k, s_tmp[i * nrows + threadIdx.x]);
    out[row0 + threadIdx.x] = (int)(0xFFFFFFFFu - (unsigned int)(k & 0xFFFFFFFFull));
  }
}

"""


def variants(src: str) -> dict:
    """{name: (source, checked)}."""
    scores = src[src.index("  cp_async_wait<1>();\n"):src.index("  // the block's best per row")]
    tail = src[src.index(_LEVEL1):src.index("}  // namespace")]
    return {
        "kernel": ([], True),
        "launch": ([("  __shared__ int s_flag;\n", "  __shared__ int s_flag;\n  if (n > 0) return;\n")], False),
        "staging": ([("  const int row0 = blockIdx.y * p.rows;\n",
                      "  cp_async_wait<0>();\n  __syncthreads();\n  if (n > 0) return;\n  const int row0 = blockIdx.y * p.rows;\n")],
                    False),
        "no_scoring": ([(scores, "  cp_async_wait<0>();\n  __syncthreads();\n\n")], False),
        "no_reduction": ([(_LEVEL1, "  if (n > 0) return;\n" + _LEVEL1)], False),
        "rows_8": ([("constexpr int kR = 4;", "constexpr int kR = 8;"),
                    ("__launch_bounds__(kMaxThreads, 2)", "__launch_bounds__(kMaxThreads, 1)")], True),
        "codes_8": ([("constexpr int kC = 4;", "constexpr int kC = 8;"),
                     ("      float sc[kC] = {acc[i][0] - h.x, acc[i][1] - h.y, acc[i][2] - h.z, acc[i][3] - h.w};",
                      "      const float4 h2 = *reinterpret_cast<const float4*>(gh + s + 4);\n"
                      "      float sc[kC] = {acc[i][0] - h.x, acc[i][1] - h.y, acc[i][2] - h.z, acc[i][3] - h.w,\n"
                      "                      acc[i][4] - h2.x, acc[i][5] - h2.y, acc[i][6] - h2.z, acc[i][7] - h2.w};"),
                     ("      const float mx = fmaxf(fmaxf(sc[0], sc[1]), fmaxf(sc[2], sc[3]));",
                      "      const float mx = fmaxf(fmaxf(fmaxf(sc[0], sc[1]), fmaxf(sc[2], sc[3])),\n"
                      "                             fmaxf(fmaxf(sc[4], sc[5]), fmaxf(sc[6], sc[7])));"),
                     ("(sc[0] == mx ? 0 : sc[1] == mx ? 1 : sc[2] == mx ? 2 : 3)",
                      "(sc[0] == mx ? 0 : sc[1] == mx ? 1 : sc[2] == mx ? 2 : sc[3] == mx ? 3 : sc[4] == mx ? 4 "
                      ": sc[5] == mx ? 5 : sc[6] == mx ? 6 : 7)")], True),
        "one_level": ([(tail, _ONE_LEVEL)], True),
    }


def build(source: str, edited: dict) -> dict:
    """{name: (library, checked)}: every variant of csrc/``source`` compiled
    at once; ``edited`` is {name: (edits, checked)}, the edits (old, new)
    text replacements of the source."""
    src = (_cuda.CSRC / source).read_text()
    out_dir = _cuda.BUILD_ROOT / "variants" / _cuda._source_hash(_cuda.NVCC_FLAGS)
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _cuda.CSRC.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    procs = {}
    for name, (edits, checked) in edited.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: csrc/{source} no longer holds {old!r}")
            text = text.replace(old, new)
        stem = f"{source.split('.')[0]}_{name}"
        cu, lib = out_dir / f"{stem}.cu", out_dir / f"{stem}.so"
        cu.write_text(text)
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(lib), str(cu)]
        procs[name] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib,
                       checked)
    libs = {}
    for name, (cmd, proc, lib, checked) in procs.items():
        _cuda._finish(cmd, proc)
        libs[name] = (lib, checked)
    return libs


def main(argv=None) -> None:
    if not torch.cuda.is_available():
        sys.exit("nearest_code_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cb, hn = q.prepare_codebook(torch.randn((V, 16), generator=gen, device=dev))
    x = torch.randn((N, 16), generator=gen, device=dev)
    want = q.nearest_code_prepared(x, cb, hn)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    res = {}
    libs = build("nearest_code.cu", variants((_cuda.CSRC / "nearest_code.cu").read_text()))
    for name, (path, checked) in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.rtca_nearest_code.argtypes = (P, P, P, I, I, P, P, P, P)
        lib.rtca_nearest_code_plan.argtypes = (I, I, ctypes.POINTER(L))
        plan = (L * 8)()
        _cuda.check(lib.rtca_nearest_code_plan(N, V, plan), name)
        part = torch.empty((plan[6],), dtype=torch.int64, device=dev)
        tickets = torch.zeros((plan[7],), dtype=torch.int32, device=dev)
        out = torch.empty((N,), dtype=torch.int32, device=dev)

        def call():
            _cuda.check(lib.rtca_nearest_code(x.data_ptr(), cb.data_ptr(), hn.data_ptr(), N, V, part.data_ptr(),
                                              tickets.data_ptr(), out.data_ptr(), _cuda.stream_handle(dev)), name)

        call()
        torch.cuda.synchronize()
        if checked and not torch.equal(out, want):
            raise SystemExit(f"nearest_code_variants: {name} gives other codes than the kernel")
        res[name] = {"ms": median_ms(call, flush=flush), "loop_ms": loop_ms(call), "threads": plan[4],
                     "blocks": plan[2]}
        print(f"{name}: {res[name]}", file=sys.stderr, flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "n": N, "v": V, "variants": res}))


if __name__ == "__main__":
    main()
