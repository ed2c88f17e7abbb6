"""Hold kernel S1 (the whole draw in one launch, ``ops/sampling.sample_token``)
against its plain version on the card, and time it beside the route it
replaced.

Three routes draw the same token from the same inputs:

- ``kernel``: ``sample_token(logits, (seed, step), ...)``, one launch;
- ``old``: the plain draw with S1's noise kernel, what the port ran before
  (``sample_token_plain(..., gumbel_noise(seed, step, k))``: ~40 launches and
  a radix sort of the vocab);
- ``plain``: the plain draw with the plain noise (``gumbel_noise_plain``).

:func:`compare` holds the kernel to the plain route on one draw: the top-k
ids and values bit for bit, the probabilities within 2 ulp, the sampled id
equal unless the plain route's ``cum - probs`` lies within 4 ulp of top_p or
a probability within 4 ulp of ``min_p * p0`` (a boundary draw: the two sum
in other orders, so a keep decision there may flip), and the kernel bitwise
repeatable. :func:`times` gives each route's median CUDA-event
time of one call (L2 flushed) and the mean over launches replayed from a CUDA
graph, in turns (old, kernel, kernel, old), and :func:`launch_count`
counts each route's kernel launches per draw under torch.profiler.
:func:`check_rows` and :func:`rows_times` do the same for the row draw
(``sample_token_rows``: R rows in one launch) against each row's plain
draw and against R single launches; :func:`check_raw_keys` holds rows
under raw threefry keys (k1, k2, step), the batched engine's, to the plain
draw. ``chip_smoke.py`` phase 3 runs these on synthetic and on captured logits.

    python -m realtime_codec_agent_tpu_torch.tools.sampler_times [--vocab 259344] [--top-k 100] [--draws 50]

prints one JSON line: the routes' times and launches per draw at the bench's
codec-pinned settings on seeded synthetic logits, and the checks' counts.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from realtime_codec_agent_tpu_torch.ops import sampling as sm
from realtime_codec_agent_tpu_torch.tools.timing import HBM_COPY_BYTES, loop_ms, median_ms

SEED = 1234  # the sampler seed of every draw here


def settings_cases(vocab: int) -> dict:
    """The sampler settings the checks run, each a SamplerSettings keyword
    dict (plus "dyn_k", the scalars[7] cutoff): greedy; the bench's
    codec-pinned sampling (agent defaults, temperature 1.0, ids from the
    codec region: 128,266 at the deployed vocab, half the vocab elsewhere);
    the agent's text settings with the end-audio bias (agent.set_sampler);
    penalties, bias and floor on; the dynamic cutoff; and a floor that
    leaves 20 ids, so the top-k ends in ties at NEG_INF."""
    codec = 128266 if vocab > 131072 else vocab // 2
    end_audio = codec - 7
    agent = dict(top_k=100, top_p=1.0, min_p=0.0, temp=1.0)
    return {
        "greedy": dict(agent, temp=0.0),
        "codec_pinned": dict(agent, min_token_id=codec),
        "text_end_audio_bias": dict(agent, logit_bias=((end_audio, -100.0),)),
        "penalties": dict(top_p=0.9, min_p=0.05, temp=0.8, repeat_penalty=1.3, frequency_penalty=0.4,
                          presence_penalty=0.7, logit_bias=((5, 4.0), (end_audio, -100.0)), min_token_id=3),
        "dyn_k": dict(top_p=0.95, min_p=0.02, temp=0.9, dyn_k=5.0),
        "floor_ties": dict(agent, min_token_id=vocab - 20),
    }


def window_on_top(logits: torch.Tensor, rng) -> list:
    """A penalty window that hits the top logits (where the penalties move
    the top-k) and 20 random ids."""
    top = torch.argsort(logits, descending=True)[:30].tolist()
    return top[::3] + rng.integers(0, logits.shape[0], size=20).tolist() + top[:4]


def make_inputs(logits: torch.Tensor, settings: dict, top_k: int, window, device) -> dict:
    """The arguments of one draw: ``logits`` (V,) f32, the settings (a
    :func:`settings_cases` entry, whose top_k ``top_k`` replaces) and the
    penalty ``window`` (a list of ids, or the engine's (ids, mask) tensors),
    all on ``device``."""
    kw = {k: v for k, v in settings.items() if k != "dyn_k"}
    kw["top_k"] = top_k
    st = sm.SamplerSettings(**kw)
    scalars = st.scalars(device)
    if "dyn_k" in settings:
        scalars = torch.cat([scalars, torch.tensor([settings["dyn_k"]], dtype=torch.float32, device=device)])
    bias_ids, bias_vals = st.bias_arrays(device)
    if isinstance(window, tuple):
        wids, wmask = (t.to(device) for t in window)
    else:
        wids, wmask = sm.make_window(window, device=device)
    return dict(logits=logits.to(device=device, dtype=torch.float32).contiguous(), scalars=scalars,
                bias_ids=bias_ids, bias_vals=bias_vals, window_ids=wids, window_mask=wmask, top_k=top_k)


def synthetic_logits(vocab: int, seed: int, ties: bool = False) -> torch.Tensor:
    """Seeded N(0, 3^2) logits (the tests' scale); with ``ties``, values
    planted at the top-k boundary: the 30th to 60th largest and 95th to
    105th largest values repeated across several 256-blocks, some of them
    straddling the k-th value of k = 40 and 100."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(vocab,)) * 3).astype(np.float32)
    if ties:
        order = np.argsort(-x, kind="stable")
        for lo, hi in ((30, 60), (95, 105)):
            v = x[order[lo]]
            spread = rng.choice(vocab, size=hi - lo, replace=False)
            x[spread] = v
            x[order[lo:hi]] = v
    return torch.from_numpy(x)


def _routes(inp: dict, seed: int, step):
    a = (inp["scalars"], inp["bias_ids"], inp["bias_vals"], inp["window_ids"], inp["window_mask"])
    k = sm.k_for(inp["top_k"], inp["logits"].shape[0])
    dev = inp["logits"].device
    return {
        "kernel": lambda dbg=None: sm.sample_token(inp["logits"], (seed, step), *a, top_k=inp["top_k"], debug=dbg),
        "old": lambda dbg=None: sm.sample_token_plain(inp["logits"], sm.gumbel_noise(seed, step, k, dev), *a,
                                                      top_k=inp["top_k"], debug=dbg),
        "plain": lambda dbg=None: sm.sample_token_plain(inp["logits"], sm.gumbel_noise_plain(seed, step, k, dev), *a,
                                                        top_k=inp["top_k"], debug=dbg),
    }


def _spacing(x: torch.Tensor) -> torch.Tensor:
    x = x.abs()
    return torch.nextafter(x, torch.full_like(x, float("inf"))) - x


def compare(inp: dict, seed: int = SEED, step=0) -> dict:
    """One draw of the kernel against the plain route on the same inputs.
    Returns {"ids_equal", "vals_equal", "probs_ulps", "max_abs_err",
    "same_token", "boundary", "repeatable", "token"}: ``max_abs_err`` is the
    largest |kernel - plain| over the top-k values and probabilities;
    ``boundary`` is True when the plain route's ``cum - probs`` of some rank
    lies within 4 ulp of top_p, or a probability within 4 ulp of min_p * p0,
    on the sampled path."""
    routes = _routes(inp, seed, step)
    kd, pd, kd2 = {}, {}, {}
    got = routes["kernel"](kd)
    want = routes["plain"](pd)
    again = routes["kernel"](kd2)
    torch.cuda.synchronize()
    return _agreement(inp["scalars"], got, kd, want, pd, again, kd2)


def _agreement(scalars, got, kd, want, pd, again, kd2) -> dict:
    """:func:`compare`'s verdict on one draw: the kernel's id and debug
    outputs (``got``, ``kd``; a second launch ``again``, ``kd2``) against
    the plain route's (``want``, ``pd``)."""
    sampled = float(scalars[2]) > 0
    probs_ulps = 0.0
    boundary = False
    if sampled:
        probs, cum = pd["probs"], pd["cum"]
        probs_ulps = float(((kd["probs"] - probs).abs() / _spacing(probs).clamp_min(torch.finfo(torch.float32).tiny)).max())
        top_p, min_p = scalars[0], scalars[1]
        thr = min_p * probs[0]
        near_p = ((cum - probs) - top_p).abs() <= 4 * _spacing(top_p)
        near_m = (probs - thr).abs() <= 4 * _spacing(thr)
        boundary = bool((near_p | (near_m & (thr > 0))).any())
    max_abs_err = max(float((kd["vals"] - pd["vals"]).abs().max()), float((kd["probs"] - pd["probs"]).abs().max()))
    return {
        "ids_equal": bool(torch.equal(kd["ids"], pd["ids"])),
        "vals_equal": bool(torch.equal(kd["vals"].view(torch.int32), pd["vals"].view(torch.int32))),
        "probs_ulps": probs_ulps,
        "max_abs_err": max_abs_err,
        "same_token": int(got) == int(want),
        "boundary": boundary,
        "repeatable": bool(torch.equal(got, again) and torch.equal(kd["ids"], kd2["ids"])
                           and torch.equal(kd["vals"].view(torch.int32), kd2["vals"].view(torch.int32))
                           and torch.equal(kd["probs"].view(torch.int32), kd2["probs"].view(torch.int32))),
        "token": int(got),
    }


def stack_rows(rows: list) -> dict:
    """R draws' inputs (:func:`make_inputs` dicts of one vocab and top_k)
    as the row draw's (R, ...) arguments. Rows without the dynamic cutoff
    get ``scalars[7] = 0`` (the full width, the same draw) when another row
    has one."""
    width = max(r["scalars"].shape[0] for r in rows)
    scalars = [torch.cat([r["scalars"], r["scalars"].new_zeros(width - r["scalars"].shape[0])]) for r in rows]
    return {name: torch.stack([r[name] for r in rows]) for name in
            ("logits", "bias_ids", "bias_vals", "window_ids", "window_mask")} | {
        "scalars": torch.stack(scalars), "top_k": rows[0]["top_k"]}


def _row_routes(rows: list, keys: list):
    """The row draw in one launch, R single launches, and the plain draw of
    each row, over the same inputs and (seed, step) keys."""
    st = stack_rows(rows)
    dev = st["logits"].device
    keys_t = torch.tensor(keys, dtype=torch.int64, device=dev)
    a = (st["scalars"], st["bias_ids"], st["bias_vals"], st["window_ids"], st["window_mask"])
    singles = [_routes(r, seed, step)["kernel"] for r, (seed, step) in zip(rows, keys)]
    return {
        "rows": lambda dbg=None: sm.sample_token_rows(st["logits"], keys_t, *a, top_k=st["top_k"], debug=dbg),
        "singles": lambda: [f() for f in singles],
        "plain": lambda: [_routes(r, seed, step)["plain"]() for r, (seed, step) in zip(rows, keys)],
    }


def check_rows(cases, log=print) -> dict:
    """S1 over rows (``sample_token_rows``) on ``cases`` ((name, rows, keys):
    R :func:`make_inputs` dicts and their (seed, step) keys): every row held
    to the plain draw of its own inputs as :func:`check_draws` holds a
    single draw (its counts and bounds), the whole launch bitwise
    repeatable, and every row bit for bit the single kernel's draw (id,
    top-k values, ids and probabilities) under the same key. Returns
    check_draws' counts and ``launch_ids_equal_singles`` (rows checked
    against the single launches)."""
    acc = _tally()
    for name, rows, keys in cases:
        routes = _row_routes(rows, keys)
        kd, kd2 = {}, {}
        got = routes["rows"](kd)
        again = routes["rows"](kd2)
        for r, (inp, (seed, step)) in enumerate(zip(rows, keys)):
            singles = _routes(inp, seed, step)
            sd, pd = {}, {}
            one = singles["kernel"](sd)
            want = singles["plain"](pd)
            torch.cuda.synchronize()
            row = {key: kd[key][r] for key in ("vals", "ids", "probs")}
            row2 = {key: kd2[key][r] for key in ("vals", "ids", "probs")}
            tag = f"{name} row {r} (seed {seed}, step {step})"
            _tally(acc, _agreement(inp["scalars"], got[r], row, want, pd, again[r], row2), tag)
            assert int(one) == int(got[r]) and all(
                torch.equal(sd[key].view(torch.int32) if sd[key].dtype == torch.float32 else sd[key],
                            row[key].view(torch.int32) if row[key].dtype == torch.float32 else row[key])
                for key in ("vals", "ids", "probs")), f"{tag}: differs from the single launch's draw"
    out = _tally_done(acc)
    log(f"[sampler] rows: {out['draws']} row draws in {len(cases)} launches: top-k ids and values bit for bit, "
        f"probabilities within {out['worst_probs_ulps']:.2f} ulp (largest |kernel - plain| {out['max_abs_err']:.3g}), "
        f"repeatable, each row bit for bit the single launch's; {out['boundary_draws']} boundary draws, "
        f"{out['boundary_mismatches']} of them sampled another id")
    return out


def _tally(acc: dict = None, v: dict = None, tag: str = "") -> dict:
    """With no arguments a fresh tally; else adds one row draw's verdict
    (:func:`_agreement`) to ``acc``, failing (AssertionError) on top-k ids
    or values that are not bit for bit, probabilities off by more than 2
    ulp, a draw that is not repeatable or a sampled id that differs outside
    a boundary draw."""
    if acc is None:
        return {"draws": 0, "boundary_draws": 0, "boundary_mismatches": 0, "worst_probs_ulps": 0.0,
                "max_abs_err": 0.0}
    acc["draws"] += 1
    acc["boundary_draws"] += v["boundary"]
    acc["worst_probs_ulps"] = max(acc["worst_probs_ulps"], v["probs_ulps"])
    acc["max_abs_err"] = max(acc["max_abs_err"], v["max_abs_err"])
    assert v["ids_equal"] and v["vals_equal"], f"{tag}: top-k ids or values differ from the plain version"
    assert v["probs_ulps"] <= 2.0, f"{tag}: probabilities off by {v['probs_ulps']:.3g} ulp (> 2)"
    assert v["repeatable"], f"{tag}: two launches differ"
    if not v["same_token"]:
        assert v["boundary"], f"{tag}: sampled id differs from the plain version's outside a boundary draw"
        acc["boundary_mismatches"] += 1
    return acc


def _tally_done(acc: dict) -> dict:
    """``acc``, failing when more than 1 in 10,000 draws were boundary draws
    that sampled another id."""
    n, mismatched = acc["draws"], acc["boundary_mismatches"]
    assert mismatched * 10000 <= n, f"{mismatched} boundary draws of {n} sampled another id (> 1 in 10,000)"
    return acc


def raw_key_rows(vocab: int, top_k: int, rows: int, device, seed: int = 0):
    """``rows`` draws' inputs (each its own :func:`settings_cases` entry,
    seeded logits with planted ties in every other row, a window on its
    top) and random raw threefry keys (k1, k2, step), as the batched
    engine's rows carry them."""
    rng = np.random.default_rng(seed)
    settings = list(settings_cases(vocab).values())
    inputs, keys = [], []
    for r in range(rows):
        logits = synthetic_logits(vocab, seed=1000 * seed + r, ties=r % 2 == 1)
        inputs.append(make_inputs(logits, settings[r % len(settings)], top_k, window_on_top(logits, rng), device))
        keys.append((*(int(x) for x in rng.integers(0, 2**32, size=2)), int(rng.integers(0, 2**31))))
    return inputs, keys


def check_raw_keys(rows: list, keys: list, log=print) -> dict:
    """S1 over rows under raw threefry keys ``keys`` ((k1, k2, step) a row):
    each row of one launch held to the plain draw of its own inputs with the
    noise of ``fold_in((k1, k2), step)`` as :func:`check_rows` holds rows
    (top-k ids and values bit for bit, probabilities within 2 ulp, the id
    equal outside boundary draws, two launches bitwise equal), and the keys
    (0, k2, step) giving the (k2, step) launch bit for bit (a seed's key is
    (0, seed)). Returns the counts and the launch's ids."""
    st = stack_rows(rows)
    dev = st["logits"].device
    a = (st["scalars"], st["bias_ids"], st["bias_vals"], st["window_ids"], st["window_mask"])
    keys_t = torch.tensor(keys, dtype=torch.int64, device=dev)
    kd, kd2 = {}, {}
    got = sm.sample_token_rows(st["logits"], keys_t, *a, top_k=st["top_k"], debug=kd)
    again = sm.sample_token_rows(st["logits"], keys_t, *a, top_k=st["top_k"], debug=kd2)
    acc = _tally()
    for r, (inp, (k1, k2, step)) in enumerate(zip(rows, keys)):
        pd = {}
        noise = sm.key_gumbel_noise_plain((k1, k2), step, sm.k_for(inp["top_k"], inp["logits"].shape[0]), dev)
        want = sm.sample_token_plain(inp["logits"], noise, inp["scalars"], inp["bias_ids"], inp["bias_vals"],
                                     inp["window_ids"], inp["window_mask"], top_k=inp["top_k"], debug=pd)
        torch.cuda.synchronize()
        row = {key: kd[key][r] for key in ("vals", "ids", "probs")}
        row2 = {key: kd2[key][r] for key in ("vals", "ids", "probs")}
        _tally(acc, _agreement(inp["scalars"], got[r], row, want, pd, again[r], row2),
               f"row {r} (key ({k1}, {k2}), step {step})")
    out = _tally_done(acc)
    seeded = torch.tensor([(k2, step) for _, k2, step in keys], dtype=torch.int64, device=dev)
    zero_hi = torch.tensor([(0, k2, step) for _, k2, step in keys], dtype=torch.int64, device=dev)
    assert torch.equal(sm.sample_token_rows(st["logits"], seeded, *a, top_k=st["top_k"]),
                       sm.sample_token_rows(st["logits"], zero_hi, *a, top_k=st["top_k"])), (
        "keys (0, seed, step) draw other ids than (seed, step)")
    log(f"[sampler] raw keys: {out['draws']} rows under random threefry keys in one launch: top-k ids and values "
        f"bit for bit, probabilities within {out['worst_probs_ulps']:.2f} ulp (largest |kernel - plain| "
        f"{out['max_abs_err']:.3g}), repeatable, (0, seed, step) == (seed, step); {out['boundary_draws']} boundary "
        f"draws, {out['boundary_mismatches']} of them sampled another id")
    return out | {"ids": got.tolist()}


def rows_times(rows: list, keys: list, flush=None) -> dict:
    """The row draw's median one-call time (L2 flushed) and CUDA-graph loop
    mean beside R single launches' (in turns: singles, rows, rows,
    singles) and the plain per-row draw's one call; launches per call of
    each."""
    routes = _row_routes(rows, keys)
    ms = {"rows": [], "singles": []}
    loop = {"rows": [], "singles": []}
    for name in ("singles", "rows", "rows", "singles"):
        ms[name].append(median_ms(routes[name], flush=flush))
        loop[name].append(loop_ms(routes[name]))
    out = {name: {"ms": ms[name], "loop_ms": loop[name], "launches": launch_count(routes[name])[0]} for name in ms}
    out["plain"] = {"ms": [median_ms(routes["plain"], flush=flush)]}
    return out


def check_draws(cases, log=print) -> dict:
    """:func:`compare` over ``cases`` ((name, inputs, step) triples); fails
    (AssertionError) on top-k ids or values that are not bit for bit, a
    probability off by more than 2 ulp, a draw that is not repeatable, a
    sampled id that differs outside a boundary draw, or boundary draws
    with differing ids in more than 1 of 10,000 draws. Returns the counts,
    the largest probability error in ulp and the largest |kernel - plain|
    over the top-k values and probabilities."""
    n = mismatched_boundary = boundary = 0
    worst_ulps = worst_abs = 0.0
    for name, inp, step in cases:
        r = compare(inp, step=step)
        n += 1
        boundary += r["boundary"]
        worst_ulps = max(worst_ulps, r["probs_ulps"])
        worst_abs = max(worst_abs, r["max_abs_err"])
        assert r["ids_equal"] and r["vals_equal"], f"{name} step {step}: top-k ids or values differ from the plain version"
        assert r["probs_ulps"] <= 2.0, f"{name} step {step}: probabilities off by {r['probs_ulps']:.3g} ulp (> 2)"
        assert r["repeatable"], f"{name} step {step}: two launches differ"
        if not r["same_token"]:
            assert r["boundary"], f"{name} step {step}: sampled id differs from the plain version's outside a boundary draw"
            mismatched_boundary += 1
    assert mismatched_boundary * 10000 <= n, f"{mismatched_boundary} boundary draws of {n} sampled another id (> 1 in 10,000)"
    out = {"draws": n, "boundary_draws": boundary, "boundary_mismatches": mismatched_boundary,
           "worst_probs_ulps": worst_ulps, "max_abs_err": worst_abs}
    log(f"[sampler] {n} draws: top-k ids and values bit for bit, probabilities within {worst_ulps:.2f} ulp "
        f"(largest |kernel - plain| {worst_abs:.3g}), "
        f"repeatable; {boundary} boundary draws, {mismatched_boundary} of them sampled another id")
    return out


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaMemsetAsync")


def launch_count(fn, calls: int = 4):
    """(launches per call of ``fn``, the names of the device kernels seen):
    the CUDA runtime's kernel launch and memset calls under torch.profiler
    over ``calls`` calls (the runtime rows are complete; the device rows now
    and then miss a kernel, so they only name what ran)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages() if e.key in LAUNCH_CALLS)
    return n / calls, {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}


def times(inp: dict, flush=None, seed: int = SEED, step: int = 0) -> dict:
    """Each route's median time of one call (L2 flushed by ``flush``) and
    CUDA-graph loop mean, old and kernel in turns (old, kernel, kernel,
    old; the plain route last), and its device launches per draw."""
    routes = _routes(inp, seed, step)
    ms = {name: [] for name in routes}
    loop = {name: [] for name in routes}
    for name in ("old", "kernel", "kernel", "old", "plain"):
        ms[name].append(median_ms(routes[name], flush=flush))
        loop[name].append(loop_ms(routes[name]))
    return {name: {"ms": ms[name], "loop_ms": loop[name], "launches": launch_count(routes[name])[0]}
            for name in routes}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vocab", type=int, default=259344)
    ap.add_argument("--top-k", type=int, default=100)
    ap.add_argument("--draws", type=int, default=50, help="draws per settings case checked before timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sampler_times: needs a CUDA device")
    dev = torch.device("cuda")
    cases = []
    rng = np.random.default_rng(7)
    for name, st in settings_cases(args.vocab).items():
        for d in range(args.draws):
            logits = synthetic_logits(args.vocab, seed=d, ties=d % 5 == 4)
            cases.append((name, make_inputs(logits, st, args.top_k, window_on_top(logits, rng), dev), d))
    counts = check_draws(cases)
    flush = torch.empty(HBM_COPY_BYTES, dtype=torch.uint8, device=dev)
    inp = make_inputs(synthetic_logits(args.vocab, seed=0), settings_cases(args.vocab)["codec_pinned"], args.top_k,
                      rng.integers(0, args.vocab, size=40).tolist(), dev)
    print(json.dumps({"card": card(), "vocab": args.vocab, "top_k": args.top_k, "checks": counts,
                      "routes": times(inp, flush=flush)}))


if __name__ == "__main__":
    main()
