"""The duplex LM's training step, plain PyTorch in f32: the loss of a
batch, its gradients by autograd through ``lm.Qwen2``, and AdamW after a
global-norm clip.

    loss = mean over valid targets of -log softmax(logits[t])[ids[t + 1]]
    codec ids (>= codec_vocab_start) embed through the frozen table and a
    GELU projector: e = gelu(table[id - start] W1 + b1) W2 + b2
    g <- g * c / |g| where |g| >= c (the frozen table left out of |g|)
    m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2
    p <- p - lr_k ((m / (1 - b1^k)) / (sqrt(v / (1 - b2^k)) + eps) + wd p)

with lr_k the joined linear warm-up / decay at the update count before the
step. The configuration stores parameters and moments in bf16: the
reference computes every step in f32 and keeps what the configuration
stores (each parameter and moment rounded to bf16 after the step).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from .lm import Qwen2, fp8_round, rms

FROZEN = "codec_embed.table"


def schedule(count: int, lr: float, warmup: int, max_steps: int) -> float:
    f32 = np.float32

    def linear(init, end, steps, c):
        if steps <= 0:
            return f32(init)
        return (f32(init) - f32(end)) * (f32(1) - f32(min(max(c, 0), steps)) / f32(steps)) + f32(end)

    if count < warmup:
        return float(linear(0.0, lr, warmup, count))
    return float(linear(lr, 0.0, max(1, max_steps - warmup), count - warmup))


def leaves(params: Dict) -> Dict[str, torch.Tensor]:
    """Dotted paths of a stacked training tree's tensors."""
    out = {"embed_tokens": params["embed_tokens"], "final_norm": params["final_norm"]}
    out.update({f"layers.{k}": v for k, v in params["layers"].items()})
    if "codec_embed" in params:
        ce = params["codec_embed"]
        out[FROZEN] = ce["table"]
        for i, p in enumerate(ce["projectors"]):
            out.update({f"codec_embed.projectors.{i}.{k}": v for k, v in p.items()})
    return out


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, back in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


class _RoundedMM(torch.autograd.Function):
    """a @ b from rounded inputs, and the backward's two products likewise:
    dA = r(dC) r(B)^T and dB = r(A)^T r(dC), f32 sums; the gradient passes
    straight through the rounding itself."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        ra, rb = rnd(a), rnd(b)
        ctx.save_for_backward(ra, rb)
        ctx.rnd = rnd
        return torch.matmul(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = ctx.rnd(g)
        return torch.matmul(rg, rb.transpose(-1, -2)), torch.matmul(ra.transpose(-1, -2), rg), None


def rounded_mm(rnd: Callable) -> Callable:
    """The matmul of a training step whose every product, forward and
    backward, takes inputs rounded by ``rnd``."""
    return lambda a, b: _RoundedMM.apply(a, b, rnd)


class TrainReference:
    """f32 master copies of a stacked bf16 tree (``weights.make_lm(...,
    codec_embed=True)``) and AdamW state. ``fp8``: every
    matmul input rounded to fp8 (the control). Rows go one at a time, each
    layer and each block of the head recomputed in the backward, so the
    reference fits beside its f32 state at the cell's sizes."""

    LOSS_BLOCK = 512

    def __init__(self, params: Dict, cfg: dict, tc: dict, rnd: Optional[Callable] = None, store=torch.bfloat16):
        self.cfg, self.tc, self.store = cfg, tc, store
        self.codec_start = cfg["port"]["codec_vocab_start"]
        self.p = {k: v.detach().to(torch.float32).clone().requires_grad_(k != FROZEN)
                  for k, v in leaves(params).items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items() if k != FROZEN}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items() if k != FROZEN}
        self.count = 0
        self.mm: Callable = torch.matmul if rnd is None else rounded_mm(rnd)

    def _model(self) -> Qwen2:
        n = self.cfg["num_hidden_layers"]
        layers = [{k.split(".", 1)[1]: v[i] for k, v in self.p.items() if k.startswith("layers.")} for i in range(n)]
        w = {"embed_tokens": self.p["embed_tokens"], "final_norm": self.p["final_norm"], "layers": layers}
        return Qwen2(w, self.cfg, mm=self.mm)

    def _embed(self, model: Qwen2, ids: torch.Tensor) -> torch.Tensor:
        text = model.embed(torch.clamp(ids, max=self.codec_start - 1))
        if FROZEN not in self.p:
            return text
        pr = {k.rsplit(".", 1)[1]: v for k, v in self.p.items() if k.startswith("codec_embed.projectors.0.")}
        table = self.p[FROZEN]
        z = table[torch.clamp(ids - self.codec_start, 0, table.shape[0] - 1)]
        e = self.mm(torch.nn.functional.gelu(self.mm(z, pr["w1"]) + pr["b1"]), pr["w2"]) + pr["b2"]
        return torch.where((ids >= self.codec_start)[:, None], e, text)

    def loss_and_grads(self, batch: np.ndarray, labels: np.ndarray) -> float:
        """The batch's mean loss; gradients accumulated row by row in ``.grad``."""
        dev = self.p["embed_tokens"].device
        model = self._model()
        lab = torch.as_tensor(np.asarray(labels), dtype=torch.int64, device=dev)
        n_valid = int((lab[:, 1:] != -100).sum())
        total = 0.0
        def block_nll(h, tgt):
            logits = self.mm(h, self.p["embed_tokens"].T)
            return -torch.log_softmax(logits, -1).gather(1, tgt[:, None]).sum()

        for r in range(batch.shape[0]):
            ids = torch.as_tensor(np.asarray(batch[r]), dtype=torch.int64, device=dev)
            valid = lab[r] != -100
            h = model.hidden(ids, valid=valid, x=self._embed(model, ids), recompute=True)[:-1]
            tgt = lab[r, 1:]
            keep = tgt != -100
            h, tgt = h[keep], tgt[keep]
            nll = sum(torch.utils.checkpoint.checkpoint(block_nll, h[i : i + self.LOSS_BLOCK],
                                                        tgt[i : i + self.LOSS_BLOCK], use_reentrant=False)
                      for i in range(0, len(tgt), self.LOSS_BLOCK))
            (nll / n_valid).backward()
            total += float(nll.detach())
        return total / n_valid

    @torch.no_grad()
    def step(self, batch: np.ndarray, labels: np.ndarray) -> Dict:
        """One step; returns the loss and the clipped gradient's per-leaf norms."""
        for t in self.p.values():
            t.grad = None
        with torch.enable_grad():
            loss = self.loss_and_grads(batch, labels)
        tc = self.tc
        grads = {k: (self.p[k].grad if self.p[k].grad is not None else torch.zeros_like(self.p[k]))
                 for k in self.m}
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        if float(norm) >= tc["grad_clip"]:
            grads = {k: g / norm * tc["grad_clip"] for k, g in grads.items()}
        lr = schedule(self.count, tc["learning_rate"], tc["warmup_steps"], tc["max_steps"])
        self.count += 1
        b1, b2, eps, wd = tc["adam_b1"], tc["adam_b2"], 1e-8, tc["weight_decay"]
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for k, g in grads.items():
            m = b1 * self.m[k] + (1 - b1) * g
            v = b2 * self.v[k] + (1 - b2) * g * g
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * self.p[k]
            p = self.p[k] - lr * u
            self.m[k] = m.to(self.store).to(torch.float32)
            self.v[k] = v.to(self.store).to(torch.float32)
            self.p[k].copy_(p.to(self.store).to(torch.float32))
        return {"loss": loss, "grad_norms": {k: float(g.norm()) for k, g in grads.items()}}


def norm_gap(got: Dict[str, float], want: Dict[str, float], keys: Optional[List[str]] = None) -> float:
    """The worst leaf's |got - want| / max(want, the median leaf's want)."""
    keys = list(want) if keys is None else keys
    med = float(np.median([want[k] for k in keys]))
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keys)


__all__ = ["TrainReference", "norm_gap", "schedule", "leaves", "rms", "fp8_round", "bf16_round", "FROZEN"]
