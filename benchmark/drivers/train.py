"""Training: ``train/trainer.Trainer.train_batch`` on fresh batches.

Set-up builds the weights from the seed, the Trainer (its stacked params and
AdamW state), and the batches (each row a text header, then codec ids; some
rows padded), then drives the Trainer through its first steps on the first
batches: those steps are the warm-up and what the reference judges. The same
Trainer then runs the window, a new batch a step. After the window the
Trainer is freed and the plain reference repeats the first steps in f32 from
the same seed.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import weights


def lm_config(cfg: dict):
    """The port's Qwen2.5 config at the file's numbers."""
    from realtime_codec_agent_tpu_torch.models import llama

    port = cfg["port"]
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    return llama.qwen25_config(
        port["variant"], vocab_size=cfg["vocab_size"], codec_vocab_start=0 if not port.get("codec_embed") else
        port["codec_vocab_start"], max_context=port["max_context"], hidden_size=h,
        intermediate_size=cfg["intermediate_size"], num_layers=cfg["num_hidden_layers"], num_heads=heads,
        num_kv_heads=cfg["num_key_value_heads"], head_dim=h // heads, rope_theta=cfg["rope_theta"],
        rms_eps=cfg["rms_norm_eps"], tie_embeddings=cfg["tie_word_embeddings"], attn_bias=True,
        compute_dtype=port["dtype"])


def batches(cfg: dict, tr: dict, seed: int) -> List[tuple]:
    """(ids, labels) int32 arrays of shape (B, T): per batch ``full_rows``
    full rows and the rest padded to lengths drawn from ``padded_len``;
    every row a text header of ``header`` ids, then codec ids. The sizes of
    all batches are the same for every seed (drawn once from ``tr``'s own
    seed), only the ids and their order follow the run's seed."""
    b, t = tr["batch"], tr["seq_len"]
    text_hi, lo, hi = cfg["port"]["text_vocab_size"], cfg["port"]["codec_vocab_start"], cfg["vocab_size"]
    hi = min(hi, lo + cfg["port"]["codebook_size"])
    sizes = np.random.default_rng(tr["shape_seed"])
    shapes = []
    for _ in range(tr["batches"]):
        lens = [t] * tr["full_rows"] + list(sizes.integers(tr["padded_len"][0], tr["padded_len"][1] + 1,
                                                           size=b - tr["full_rows"]))
        heads = list(sizes.integers(tr["header"][0], tr["header"][1] + 1, size=b))
        shapes.append((lens, heads))
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**63, 11]))
    out = []
    for lens, heads in shapes:
        order = rng.permutation(b)
        ids = np.zeros((b, t), np.int32)
        labels = np.full((b, t), -100, np.int32)
        for r in range(b):
            n, h = lens[order[r]], heads[order[r]]
            row = np.concatenate([rng.integers(0, text_hi, size=h), rng.integers(lo, hi, size=n - h)])
            ids[r, :n] = row
            labels[r, :n] = row
        out.append((ids, labels))
    return out


def target_tokens(labels: np.ndarray) -> int:
    return int((labels[:, 1:] != -100).sum())


def train_config(tr: dict):
    from realtime_codec_agent_tpu_torch.train.trainer import TrainConfig

    return TrainConfig(output_dir="unused", **tr["train_config"])


def run(ctx) -> Dict:
    from realtime_codec_agent_tpu_torch.train.trainer import Trainer

    from benchmark.profiling import Trace

    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    lcfg = lm_config(cfg)
    data = batches(cfg, tr, seed)
    trainer = Trainer(weights.make_lm(cfg, seed, dev, codec_embed=True), lcfg, train_config(tr),
                      device=dev)
    trainable = dict(trainer._trainable)
    p0 = {k: v.detach().clone() for k, v in trainable.items()}
    first, losses = {}, []
    b1 = tr["train_config"]["adam_b1"]
    n_judged = tr["judged_steps"]
    for i in range(n_judged):
        m = trainer.train_batch(*data[i])
        losses.append(m["loss"])
        if i == 0:
            st = trainer.optimizer.state
            first = {k: float(st[t]["mu"].float().norm()) / (1 - b1) for k, t in trainable.items()}
    change = {k: float((v.detach().float() - p0[k].float()).norm()) for k, v in trainable.items()}
    del p0
    # warm-up beyond the judged steps: every shape the window uses
    for i in range(tr.get("warm_steps", 0)):
        trainer.train_batch(*data[n_judged + i])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    tracer = Trace(dev) if ctx.trace else None
    step_at = n_judged + tr.get("warm_steps", 0)
    ctx.window_started()
    t0 = time.perf_counter()
    steps = tokens = failed = 0
    t_end = t0
    while time.perf_counter() - t0 < ctx.seconds:
        if tracer and steps == tr["trace_skip_steps"]:
            tracer.start()
        ids, labels = data[step_at % len(data)]
        step_at += 1
        m = trainer.train_batch(ids, labels)
        t_end = time.perf_counter()
        steps += 1
        tokens += target_tokens(labels)
        failed += int(not math.isfinite(m["loss"]))
        if tracer and tracer.running and steps == tr["trace_skip_steps"] + tr["trace_steps"]:
            tracer.stop()
            tracer.units = tr["trace_steps"]
    if tracer and tracer.running:
        tracer.stop()
        tracer.units = steps - tr["trace_skip_steps"]
    mem_peak = ctx.memory_peak()
    del trainer, trainable
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    trace = tracer.summary() if tracer else None
    layer = {"steps": steps, "batch": tr["batch"], "seq_len": tr["seq_len"]}
    checks = judge(ctx, data, losses, first, change)
    excluded = next(c["excluded"] for c in checks if c["name"] == "change_gap")
    return {"e2e": {"train_tokens_per_s": tokens / (t_end - t0)}, "attempted": steps, "failed": failed,
            "checks": checks, "trace": trace, "layer": layer, "memory_peak_bytes": mem_peak,
            "notes": {"steps": steps, "window_s": t_end - t0, "losses": losses,
                      "excluded_from_change": excluded}}


def judge(ctx, data, losses, first, change) -> List[Dict]:
    """The first steps against the plain reference (``reference/train.py``):
    each step's loss, the first gradient as AdamW got it (from its first
    moment after one step), and each leaf's change after the judged steps."""
    from benchmark.reference import lm as rlm
    from benchmark.reference.train import FROZEN, TrainReference, bf16_round, fp8_round, leaves, norm_gap

    rlm.plain_matmuls()
    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    tc = tr["train_config"]
    readings = {}
    runs = [("", None, 1)]
    if ctx.control:  # the control; a step in bf16; the fault "half of the batch left out, the mean over the rest"
        runs += [("control.", fp8_round, 1), ("bf16.", bf16_round, 1), ("half_batch.", None, 2)]
    for name, rnd, part in runs:
        params = weights.make_lm(cfg, seed, dev, codec_embed=True)
        ref = TrainReference(params, cfg, tc, rnd=rnd)
        p0 = {k: v for k, v in leaves(params).items()}  # the bf16 start, exact in f32
        del params
        r_losses, r_first = [], {}
        for i in range(len(losses)):
            ids, labels = data[i]
            out = ref.step(ids[: len(ids) // part], labels[: len(labels) // part])
            r_losses.append(out["loss"])
            if i == 0:
                r_first = out["grad_norms"]
        r_change = {k: float((ref.p[k].detach() - p0[k].float()).norm()) for k in r_first}
        del ref, p0
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        med = float(np.median(list(r_first.values())))
        moving = [k for k in r_first if k != FROZEN and r_first[k] >= 1e-3 * med]
        readings[name] = (r_losses, r_first, r_change, moving)
    r_losses, r_first, r_change, moving = readings[""]
    lim = ctx.limits
    out = [
        {"name": "loss_gap", "value": max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
         "limit": lim["loss_gap"]},
        {"name": "first_grad_gap", "value": norm_gap(first, r_first), "limit": lim["first_grad_gap"]},
        {"name": "change_gap", "value": norm_gap(change, r_change, moving), "limit": lim["change_gap"],
         "excluded": sorted(set(r_first) - set(moving))},
    ]
    for name in readings:
        if not name:
            continue
        c_losses, c_first, c_change, _ = readings[name]
        out += [
            {"name": name + "loss_gap", "value": max(abs(a - b) / abs(b) for a, b in zip(c_losses, r_losses)),
             "control": True},
            {"name": name + "first_grad_gap", "value": norm_gap(c_first, r_first), "control": True},
            {"name": name + "change_gap", "value": norm_gap(c_change, r_change, moving), "control": True},
        ]
    return out
