"""Where kernel S1's time goes: the whole draw cut after each of its phases.

Each variant is csrc/sampler.cu with a few lines added, built into a
library of its own (``tools/nearest_code_variants.build``) and launched
through its C entry point on one draw's inputs (seeded synthetic logits,
the bench's codec-pinned settings). A cut ends every block after phase n:
0 at once (after one cluster barrier), 1 the staged slice with bias,
penalties and floor, 2 the group maxima and the direct route's prefilter,
3 the count of the elements that take part, 4 their gather into block 0
(with the radix passes first where more than 1,024 take part), 5 block
0's ranking. Each is timed as a CUDA-graph loop mean beside the whole
greedy and the whole sampled draw; a phase costs the difference of its cut
and the one before. Then the whole sampled draw in clusters of 8, 12 and
16 blocks (fewer cannot stage the vocab in shared memory; the plan's pick
is ``ops/sampling.sample_plan``), each checked against ``sample_token``'s
id. A cut's id is not checked. One JSON line on stdout.

    python -m realtime_codec_agent_tpu_torch.tools.sampler_variants [--vocab 259344] [--top-k 100]
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json

import numpy as np
import torch

from realtime_codec_agent_tpu_torch.ops import _cuda
from realtime_codec_agent_tpu_torch.ops import sampling as sm
from realtime_codec_agent_tpu_torch.tools import sampler_times as st
from realtime_codec_agent_tpu_torch.tools.nearest_code_variants import build
from realtime_codec_agent_tpu_torch.tools.timing import loop_ms

STEP = 3
_STOP = "  cluster.sync();\n  if (rank == 0 && tid == 0) *a.out = 0;\n  if (a.V > 0) return;\n"
_BARRIER4 = "  cluster.sync();  // block 0 holds every triple; no block's shared memory is read after this\n"
_TEMP = "  const float temp = a.scalars[2];\n"


def _before(anchor: str, text: str = _STOP):
    return [(anchor, text + anchor)]


CUTS = {"cut0": "launch + 1 cluster barrier", "cut1": "staged", "cut2": "group maxima, prefilter",
        "cut3": "participants counted", "cut4": "gathered in block 0", "cut5": "ranked"}
VARIANTS = {
    "kernel": ([], True),
    "cut0": (_before("  const float rep = a.scalars[3]"), False),
    "cut1": (_before("  // ---- group maxima: every block gathers"), False),
    "cut2": (_before("  // the elements that take part and their tie keys"), False),
    "cut3": (_before("  uint2* lsel = cluster.map_shared_rank("), False),
    "cut4": ([(_BARRIER4, _BARRIER4 + "  if (rank == 0 && tid == 0) *a.out = 0;\n  if (a.V > 0) return;\n")], False),
    "cut5": (_before(_TEMP, "  if (tid == 0) *a.out = ti[0];\n  if (a.V > 0) return;\n"), False),
}


def launcher(lib, inp: dict, plan: sm.SamplePlan, out: torch.Tensor):
    """One draw through ``lib``'s C entry point under ``plan``, packed as
    ``ops/sampling._launch`` packs it (host step STEP, no debug outputs)."""
    logits = inp["logits"]
    key = sm.prng_key(st.SEED)
    ptrs = (ctypes.c_void_p * 11)(
        logits.data_ptr(), inp["scalars"].data_ptr(), inp["bias_ids"].data_ptr(), inp["bias_vals"].data_ptr(),
        inp["window_ids"].data_ptr(), inp["window_mask"].data_ptr(), None, out.data_ptr(), None, None, None)
    ints = (ctypes.c_longlong * 13)(
        logits.shape[0], plan.k, inp["scalars"].shape[0], inp["bias_ids"].shape[0], inp["window_ids"].shape[0],
        int(plan.route == "two_stage"), plan.group, plan.blocks, plan.slice, key[0], key[1], 0, STEP)
    return lambda: _cuda.check(lib.rtca_sample_token(ptrs, ints, _cuda.stream_handle(logits.device)), "variant")


def with_blocks(plan: sm.SamplePlan, vocab: int, blocks: int) -> sm.SamplePlan:
    """``plan`` in a cluster of about ``blocks`` blocks (slices of whole
    256-groups)."""
    slice_ = -(-vocab // (blocks * 256)) * 256
    return dataclasses.replace(plan, blocks=-(-vocab // slice_), slice=slice_)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vocab", type=int, default=259344)
    ap.add_argument("--top-k", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sampler_variants: needs a CUDA device")
    dev = torch.device("cuda")
    logits = st.synthetic_logits(args.vocab, seed=0)
    window = st.window_on_top(logits, np.random.default_rng(0))
    cases = st.settings_cases(args.vocab)
    sampled = st.make_inputs(logits, cases["codec_pinned"], args.top_k, window, dev)
    greedy = st.make_inputs(logits, cases["greedy"], args.top_k, window, dev)
    plan = sm.sample_plan(args.vocab, sm.k_for(args.top_k, args.vocab))
    want = sm.sample_token(sampled["logits"], (st.SEED, STEP), sampled["scalars"], sampled["bias_ids"],
                           sampled["bias_vals"], sampled["window_ids"], sampled["window_mask"], args.top_k)
    out = torch.empty((), dtype=torch.int64, device=dev)
    libs = {}
    for name, (path, _) in build("sampler.cu", VARIANTS).items():
        libs[name] = ctypes.CDLL(str(path))
        libs[name].rtca_sample_token.argtypes = (ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
                                                 ctypes.c_void_p)
    times = {f"{name}: {what}": loop_ms(launcher(libs[name], sampled, plan, out)) for name, what in CUTS.items()}
    times["whole draw, greedy"] = loop_ms(launcher(libs["kernel"], greedy, plan, out))
    times["whole draw, sampled"] = loop_ms(launcher(libs["kernel"], sampled, plan, out))
    blocks = {}
    for b in (8, 12, 16):
        call = launcher(libs["kernel"], sampled, with_blocks(plan, args.vocab, b), out)
        call()
        if not torch.equal(out, want):
            raise SystemExit(f"sampler_variants: {b} blocks draw another id")
        blocks[b] = loop_ms(call)
    print(json.dumps({"card": st.card(), "vocab": args.vocab, "top_k": args.top_k, "plan": dataclasses.asdict(plan),
                      "loop_ms": times, "sampled_loop_ms_by_blocks": blocks}))


if __name__ == "__main__":
    main()
