"""Trainer for the duplex codec LM, in PyTorch, on one device.

Port of realtime_codec_agent_tpu/train/trainer.py: causal LM loss with
shifted labels (-100 ignored, the labels' validity doubling as the attention
mask), the blockwise loss that never holds the (T, vocab) logits of more than
one block, AdamW with the joined linear warmup / decay schedule after a
global-norm clip, the frozen codec table, eval (loss, accuracy, perplexity),
checkpoints with auto-resume (train/checkpoint.py).

The optimizer, :class:`OptaxAdamW` (a ``torch.optim.Optimizer``),
reproduces the JAX package's optax chain ``clip_by_global_norm(grad_clip) ->
adamw(schedule)`` (under ``multi_transform`` with ``set_to_zero`` for the
frozen codec table) step by step:

- the schedule is evaluated at the update count BEFORE the step, so the
  first step's learning rate is 0 with warmup > 0;
- the clip scales by ``max_norm / norm`` only when ``norm >= max_norm``
  (optax's rule; ``torch.nn.utils.clip_grad_norm_`` divides by
  ``norm + 1e-6`` always), and its norm leaves the frozen table out;
- the frozen table gets no update, no weight decay and no moments, but keeps
  ``requires_grad``: the reported ``grad_norm`` is the global norm of all
  gradients, the table's included, as the JAX trainer reports it;
- the moments live in the param dtype (optax's default) and each update
  follows optax's order of operations (bias corrections computed in f32 and
  cast to the param dtype, the step size cast to the update dtype).

Global norms are summed in f32 (optax sums each leaf in its own dtype: the
same for f32 params, a slightly different rounding for bf16).

One device, no mesh: ``mesh`` and ``pp_microbatches`` are accepted only at
their single-device values (None). The device defaults to the card and
raises when there is none; tests pass ``device="cpu"``. The Trainer takes
the params it is given over and updates them in place (the JAX trainer
donates them): pass copies where the caller keeps using its own.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..models.llama import (
    DuplexLMConfig,
    forward,
    logits_from_hidden,
    stack_layer_params,
    unstack_layer_params,
)
from ..utils.tree import tree_leaves, tree_map

CODEC_TABLE = "codec_embed.table"  # path of the frozen codec table


@dataclasses.dataclass
class TrainConfig:
    output_dir: str = "output/run"
    learning_rate: float = 5e-5
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    warmup_steps: int = 100
    max_steps: int = 1000
    per_device_batch_size: int = 1
    max_seq_len: int = 2048
    grad_clip: float = 1.0
    eval_every: int = 500
    save_every: int = 500
    log_every: int = 10
    seed: int = 42
    freeze_codec_table: bool = True
    # rematerialize layer activations in the backward (models/llama.forward)
    remat: bool = True
    # "full", "dots", "flash" (alias "attn") or "none" (models/llama.REMAT_POLICIES)
    remat_policy: str = "full"
    # blockwise CE loss: never materialize the (T, vocab) logits of more than
    # one block; None keeps the single-shot loss
    loss_block_size: Optional[int] = 512
    # "adamw"; "adafactor" is not ported (ROADMAP queue 16)
    optimizer: str = "adamw"
    # pipeline microbatches: multi-device only (ROADMAP queue 12); None here
    pp_microbatches: Optional[int] = None


def pad_batch(
    sequences: List[List[int]], max_len: int, pad_id: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad/truncate to max_len; labels get -100 at pad positions."""
    batch = np.full((len(sequences), max_len), pad_id, dtype=np.int32)
    labels = np.full((len(sequences), max_len), -100, dtype=np.int32)
    for i, seq in enumerate(sequences):
        seq = seq[:max_len]
        batch[i, : len(seq)] = seq
        labels[i, : len(seq)] = seq
    return batch, labels


def _ce_sums(logits: torch.Tensor, labels: torch.Tensor):
    """(loss_sum, n_valid, n_correct) for one block of shifted logits/labels."""
    valid = labels != -100
    safe = torch.clamp(labels, min=0).long()
    lp = torch.log_softmax(logits, dim=-1)
    token_lp = torch.gather(lp, -1, safe[..., None])[..., 0]
    loss_sum = -(token_lp * valid).sum()
    correct = ((torch.argmax(logits, dim=-1) == labels) & valid).sum()
    return loss_sum, valid.sum(), correct


def loss_and_metrics(
    params,
    batch: torch.Tensor,
    labels: torch.Tensor,
    cfg: DuplexLMConfig,
    loss_block: Optional[int] = None,
    forward_fn=forward,
):
    """Causal LM loss with shifted labels; -100 ignored.

    With ``loss_block`` set, the head matmul + softmax run over blocks of the
    shifted T (padded with -100 labels), each under activation checkpointing:
    forward and backward hold one (B, block, vocab) f32 slab at a time.
    Identical math, only the reduction is reassociated."""
    hidden = forward_fn(params, batch, cfg, attn_mask=(labels != -100))
    shift_labels = labels[:, 1:]
    t = hidden.shape[1] - 1
    if not loss_block or t <= loss_block:
        logits = logits_from_hidden(params, hidden, cfg)  # (B, T, V) f32
        loss_sum, n_valid, correct = _ce_sums(logits[:, :-1], shift_labels)
    else:
        nb = -(-t // loss_block)
        pad = nb * loss_block - t
        sh = F.pad(hidden[:, :-1], (0, 0, 0, pad))
        sl = F.pad(shift_labels, (0, pad), value=-100)

        def block(h, lb):
            return _ce_sums(logits_from_hidden(params, h, cfg), lb)

        parts = [
            checkpoint(block, sh[:, i * loss_block : (i + 1) * loss_block],
                       sl[:, i * loss_block : (i + 1) * loss_block], use_reentrant=False)
            for i in range(nb)
        ]
        loss_sum = sum(p[0] for p in parts)
        n_valid = sum(p[1] for p in parts)
        correct = sum(p[2] for p in parts)
    n_valid = torch.clamp(n_valid, min=1)
    loss = loss_sum / n_valid
    accuracy = correct / n_valid
    return loss, {"accuracy": accuracy, "n_tokens": n_valid}


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over tensors, summed in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32))) for t in tensors))


def schedule_lr(count: int, tc: TrainConfig) -> float:
    """optax.join_schedules([linear 0 -> lr over warmup, linear lr -> 0 over
    max(1, max_steps - warmup)], [warmup]) at ``count``, in f32."""
    f32 = np.float32

    def linear(init, end, steps, c):
        if steps <= 0:
            return f32(init)
        frac = f32(1) - f32(min(max(c, 0), steps)) / f32(steps)
        return (f32(init) - f32(end)) * frac + f32(end)

    w = tc.warmup_steps
    if count < w:
        return float(linear(0.0, tc.learning_rate, w, count))
    return float(linear(tc.learning_rate, 0.0, max(1, tc.max_steps - w), count - w))


class OptaxAdamW(torch.optim.Optimizer):
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule))``, step
    for step, over the params it is given (the frozen codec table is not one
    of them). ``schedule(count)`` is the learning rate at optax's update count
    before the step. A param without a gradient updates as optax updates a
    zero gradient."""

    def __init__(self, params, schedule, b1: float, b2: float, weight_decay: float, max_norm: float,
                 eps: float = 1e-8):
        super().__init__(params, {"b1": b1, "b2": b2, "eps": eps, "weight_decay": weight_decay})
        self.schedule = schedule
        self.max_norm = max_norm
        self.count = 0  # optax's update count
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdamW.step takes no closure")
        lr = self.schedule(self.count)
        self.count += 1
        params = [p for group in self.param_groups for p in group["params"]]
        grads = {p: torch.zeros_like(p) if p.grad is None else p.grad for p in params}
        g_norm = global_norm(grads.values())
        clip = g_norm >= self.max_norm
        for group in self.param_groups:
            b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
            bc1 = np.float32(1) - np.float32(b1) ** np.float32(self.count)
            bc2 = np.float32(1) - np.float32(b2) ** np.float32(self.count)
            for p in group["params"]:
                g = grads[p]
                g = torch.where(clip, (g / g_norm.to(g.dtype)) * self.max_norm, g)
                st = self.state[p]
                st["mu"] = mu = (1 - b1) * g + b1 * st["mu"]
                st["nu"] = nu = (1 - b2) * (g * g) + b2 * st["nu"]
                # 0-d CPU tensors in the param dtype: the casts optax makes, no copy to the device
                c1, c2, neg_lr = (torch.tensor(x, dtype=p.dtype) for x in (bc1, bc2, -lr))
                u = (mu / c1) / (torch.sqrt(nu / c2) + eps)
                u = u + wd * p
                p.copy_(p + neg_lr * u)


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"Trainer(device={str(device)!r}): no CUDA device is available")
    return device


class Trainer:
    def __init__(
        self,
        params,
        lm_config: DuplexLMConfig,
        train_config: TrainConfig,
        mesh=None,
        device="cuda",
    ):
        if mesh is not None or train_config.pp_microbatches is not None:
            raise NotImplementedError(
                "Trainer: meshes and pipeline parallelism are not ported (ROADMAP.md, port queue 12: "
                "'parallel/ on torch.distributed'); pass mesh=None and pp_microbatches=None"
            )
        if train_config.optimizer == "adafactor":
            raise NotImplementedError(
                "Trainer: optimizer='adafactor' is not ported (ROADMAP.md, port queue 16: 'adafactor')"
            )
        if train_config.optimizer != "adamw":
            raise ValueError(f"unknown optimizer {train_config.optimizer!r}")
        self.cfg = dataclasses.replace(
            lm_config, remat=train_config.remat, remat_policy=train_config.remat_policy
        )
        self.tc = train_config
        self.device = _resolve_device(device)
        self.step = 0
        # the stacked layout: one leaf per weight kind (models/llama.stack_layer_params)
        self.params = tree_map(
            lambda t: t.detach().to(self.device).contiguous().requires_grad_(True), stack_layer_params(params)
        )
        self._leaves = tree_leaves(self.params)
        frozen = {CODEC_TABLE} if self.tc.freeze_codec_table and "codec_embed" in self.params else set()
        self._trainable = [(p, t) for p, t in self._leaves if p not in frozen]
        self.optimizer = OptaxAdamW(
            [t for _, t in self._trainable], functools.partial(schedule_lr, tc=self.tc),
            b1=self.tc.adam_b1, b2=self.tc.adam_b2, weight_decay=self.tc.weight_decay, max_norm=self.tc.grad_clip,
        )

    @property
    def opt_state(self) -> Dict:
        """``{"count", "mu", "nu"}`` with the moments keyed by dotted param
        path (what checkpoints store and models/from_jax converts to)."""
        state = self.optimizer.state
        return {
            "count": self.optimizer.count,
            "mu": {p: state[t]["mu"] for p, t in self._trainable},
            "nu": {p: state[t]["nu"] for p, t in self._trainable},
        }

    @opt_state.setter
    def opt_state(self, value: Dict) -> None:
        self.optimizer.count = int(value["count"])
        for p, t in self._trainable:
            self.optimizer.state[t] = {
                k: value[k][p].to(self.device).contiguous() for k in ("mu", "nu")
            }

    def export_params(self):
        """Params in the inference layout (unrolled per-layer list), detached."""
        return unstack_layer_params(tree_map(lambda t: t.detach(), self.params))

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device, non_blocking=True)

    # -- steps ----------------------------------------------------------------
    def train_batch_async(self, batch: np.ndarray, labels: np.ndarray) -> Dict:
        """One train step; returns DEVICE metric tensors without waiting."""
        batch, labels = self._to_device(batch), self._to_device(labels)
        loss, metrics = loss_and_metrics(self.params, batch, labels, self.cfg, loss_block=self.tc.loss_block_size)
        loss.backward()
        tensors = [t for _, t in self._leaves]
        grad_norm = global_norm(t.grad for t in tensors if t.grad is not None)
        self.optimizer.step()
        for t in tensors:  # the frozen table's too
            t.grad = None
        self.step += 1
        return dict(metrics, loss=loss.detach(), grad_norm=grad_norm)

    def train_batch(self, batch: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
        """Synchronous step: run + fetch the metrics."""
        return {k: float(v) for k, v in self.train_batch_async(batch, labels).items()}

    @torch.no_grad()
    def eval_batches(self, batches) -> Dict[str, float]:
        total_loss = total_acc = total_n = 0.0
        for batch, labels in batches:
            loss, metrics = loss_and_metrics(
                self.params, self._to_device(batch), self._to_device(labels), self.cfg,
                loss_block=self.tc.loss_block_size,
            )
            n = float(metrics["n_tokens"])
            total_loss += float(loss) * n
            total_acc += float(metrics["accuracy"]) * n
            total_n += n
        if total_n == 0:
            return {}
        eval_loss = total_loss / total_n
        return {
            "eval_loss": eval_loss,
            "eval_accuracy": total_acc / total_n,
            "perplexity": float(np.exp(min(eval_loss, 50.0))),
        }

    # -- training loop --------------------------------------------------------
    def train(
        self,
        train_iter: Iterator[Tuple[np.ndarray, np.ndarray]],
        eval_batches_fn=None,
        resume: bool = True,
        log_fn=print,
    ) -> Dict[str, float]:
        from . import checkpoint as ckpt

        if resume:
            restored = ckpt.restore_latest(self.tc.output_dir, self)
            if restored:
                log_fn(f"Resumed from checkpoint at step {self.step}")

        last_metrics: Dict[str, float] = {}
        metrics_dev = None
        t0 = time.time()
        while self.step < self.tc.max_steps:
            try:
                batch, labels = next(train_iter)
            except StopIteration:
                break
            metrics_dev = self.train_batch_async(batch, labels)
            if self.step % self.tc.log_every == 0:
                last_metrics = {k: float(v) for k, v in metrics_dev.items()}
                rate = self.step / max(time.time() - t0, 1e-9)
                log_fn(
                    f"step {self.step}: loss={last_metrics['loss']:.4f} "
                    f"acc={last_metrics['accuracy']:.4f} ({rate:.2f} it/s)"
                )
            if eval_batches_fn and self.step % self.tc.eval_every == 0:
                log_fn(f"eval @ {self.step}: {self.eval_batches(eval_batches_fn())}")
            if self.step % self.tc.save_every == 0:
                ckpt.save(self.tc.output_dir, self)
        if metrics_dev is not None:
            last_metrics = {k: float(v) for k, v in metrics_dev.items()}
        ckpt.save(self.tc.output_dir, self)
        if eval_batches_fn:
            last_metrics.update(self.eval_batches(eval_batches_fn()))
        return last_metrics
