"""Trainer for the duplex codec LM, in PyTorch, on one device or a mesh.

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

With ``optimizer="adafactor"`` the chain is ``clip_by_global_norm(grad_clip)
-> adafactor(schedule, weight_decay_rate=weight_decay or None)`` at optax's
defaults, :class:`OptaxAdafactor`: the factored second moment, the update
clipped to block RMS 1, the learning rate, the parameter's block RMS, then
weight decay. The decay is added after the learning rate, so it is
``weight_decay * p`` unscaled (AdamW's is scaled by the learning rate). A
block is a whole leaf: a stacked ``(L, in, out)`` leaf factors over its two
matrix axes and its block RMS spans all L layers.

Global norms are summed in f32 (optax sums each leaf in its own dtype: the
same for f32 params, a slightly different rounding for bf16).

On a mesh (``mesh=parallel.make_mesh(dp, fsdp, tp, pp)`` in every rank of
an initialized process group) each rank holds its ``lm_param_specs`` slice
of the stacked params and of the optimizer moments
(parallel/mesh.shard_params), takes its rows of the global batch each step
(``batch_spec``: every rank is handed the same global batch, as JAX's
``train_batch`` is), runs the forward and the vocab-parallel loss over its
groups (pp > 1: the GPipe forward of parallel/pipeline.py with
``pp_microbatches``, default 2 * pp), and sums its gradients over the axes
each leaf is not split over (``Shards.reduce_grads``). The clip's global
norm, the reported ``grad_norm`` and Adafactor's row and column means and
block RMS are sums over every shard of a leaf, counting a replicated leaf
once; AdamW's update is elementwise on the slices. ``opt_state``,
``global_params`` and checkpoints hold the global tensors, so a checkpoint
written on one mesh resumes on another or on one device. ``pp_microbatches``
is ignored without a pp axis, as the JAX Trainer ignores it.

The device defaults to the card and raises when there is none (on a mesh,
the rank's card: ``parallel.rank_device``); tests pass ``device="cpu"``.
The Trainer takes the params it is given over and updates them in place (the
JAX trainer donates them): pass copies where the caller keeps using its own.
"""
from __future__ import annotations

import dataclasses
import functools
import math
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
    vocab_parallel_head,
    vocab_parallel_logits,
)
from ..utils import spans
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
    # "adamw" or "adafactor" (optax's defaults, OptaxAdafactor)
    optimizer: str = "adamw"
    # GPipe microbatches on a mesh with a pp axis > 1 (the global batch must
    # divide it); None defaults to 2 * pp. Ignored on pp = 1 meshes.
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


def _ce_sums_vocab_parallel(logits: torch.Tensor, offset: int, labels: torch.Tensor, tp):
    """``_ce_sums`` over this rank's vocab columns ``logits`` (the global
    index of the first: ``offset``) of a tensor-parallel group ``tp``: the
    logsumexp from a max and a sum over the group, the target logit from the
    rank that owns it, accuracy's argmax the lowest global index among equal
    maxima (``jnp.argmax``'s). The columns are never gathered."""
    valid = labels != -100
    safe = torch.clamp(labels, min=0).long()
    n = logits.shape[-1]
    m = tp.max(logits.detach().amax(-1))
    lse = m + torch.log(tp.all_reduce(torch.exp(logits - m[..., None]).sum(-1)))
    local = safe - offset
    picked = torch.gather(logits, -1, torch.clamp(local, 0, n - 1)[..., None])[..., 0]
    target = tp.all_reduce(torch.where((local >= 0) & (local < n), picked, torch.zeros_like(picked)))
    loss_sum = -((target - lse) * valid).sum()
    pred = tp.argmax(logits.detach().amax(-1), logits.detach().argmax(-1) + offset)
    correct = ((pred == labels) & valid).sum()
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
    Identical math, only the reduction is reassociated.

    On a mesh (params from parallel/mesh.shard_params, carrying
    ``params["mesh"]``) ``batch`` and ``labels`` are the rank's rows; with
    tp > 1 the logits stay split over tp (``_ce_sums_vocab_parallel``); the
    loss is the global token mean (``Shards.token_totals``: the loss sums
    and the valid and correct counts summed over (dp, fsdp) before the
    division, so each rank's gradient is its rows' share); a pipeline stage
    before the last contributes zero, its gradients coming through the
    pipeline's own backward (parallel/pipeline.py). ``forward_fn`` takes
    the pipeline's forward there."""
    shards = params.get("mesh")
    with spans.span("train.forward"):
        hidden = forward_fn(params, batch, cfg, attn_mask=(labels != -100))
    with spans.span("train.loss"):
        return _loss_from_hidden(params, hidden, labels, cfg, loss_block, shards)


def _loss_from_hidden(params, hidden, labels, cfg: DuplexLMConfig, loss_block: Optional[int], shards):
    """``loss_and_metrics`` from the final hidden states on: the head and the loss."""
    shift_labels = labels[:, 1:]
    t = hidden.shape[1] - 1
    loss_stage = shards is None or shards.loss_stage
    head = vocab_parallel_head(params, cfg) if shards is not None and loss_stage else None

    def sums(h, lb, last: bool):
        """_ce_sums of hidden states ``h`` (the logits' last row dropped
        with ``last``) against ``lb``."""
        if shards is None:
            logits, offset = logits_from_hidden(params, h, cfg), 0
        else:
            logits, offset = vocab_parallel_logits(params, h, head)
        if last:
            logits = logits[:, :-1]
        if shards is None or shards.tp is None:
            return _ce_sums(logits, lb)
        return _ce_sums_vocab_parallel(logits, offset, lb, shards.tp)

    if not loss_stage:
        zero = torch.zeros((), dtype=torch.int64, device=hidden.device)
        loss_sum, n_valid, correct = hidden.sum().float() * 0, zero, zero
    elif not loss_block or t <= loss_block:
        # the full-T head matmul, then the last row dropped
        loss_sum, n_valid, correct = sums(hidden, shift_labels, True)
    else:
        nb = -(-t // loss_block)
        pad = nb * loss_block - t
        sh = F.pad(hidden[:, :-1], (0, 0, 0, pad))
        sl = F.pad(shift_labels, (0, pad), value=-100)

        # what each checkpoint runs again in the backward, under span "train.recompute"
        block = spans.on_backward("train.recompute", lambda h, lb: sums(h, lb, False))
        parts = [
            checkpoint(block, sh[:, i * loss_block : (i + 1) * loss_block],
                       sl[:, i * loss_block : (i + 1) * loss_block], use_reentrant=False)
            for i in range(nb)
        ]
        loss_sum = sum(p[0] for p in parts)
        n_valid = sum(p[1] for p in parts)
        correct = sum(p[2] for p in parts)
    if shards is not None:
        loss_sum, n_valid, correct = shards.token_totals(loss_sum, n_valid, correct)
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


class _Sharded:
    """Where an optimizer's params are a mesh rank's slices: ``shards``
    (parallel/mesh.Shards) and each param's dotted path. Without a mesh
    every query answers as for a whole leaf, and the optimizers run the
    single-device code."""

    def __init__(self, shards=None, paths=None):
        self.shards, self.paths = shards, paths or {}

    def spec(self, p):
        return None if self.shards is None else self.shards.specs[self.paths[p]]

    def global_shape(self, p) -> Tuple[int, ...]:
        spec = self.spec(p)
        return tuple(p.shape) if spec is None else self.shards.global_shape(spec, p.shape)

    def norm(self, grads: Dict) -> torch.Tensor:
        """The global norm of ``{param: gradient}``."""
        if self.shards is None:
            return global_norm(grads.values())
        return self.shards.norm([(self.paths[p], g) for p, g in grads.items()])

    def mean(self, x: torch.Tensor, p, dim: int, p_dim: int, keepdim: bool = False) -> torch.Tensor:
        """``x.mean(dim)`` where ``x``'s ``dim`` is ``p``'s axis ``p_dim``:
        over every shard of that axis."""
        spec = self.spec(p)
        axes = () if spec is None else tuple(a for a in spec.axes(p_dim) if a in self.shards.groups)
        if not axes:
            return x.mean(dim, keepdim=keepdim)
        return self.shards.sum(x.sum(dim, keepdim=keepdim), axes) / self.global_shape(p)[p_dim]

    def block_rms(self, t: torch.Tensor, p) -> torch.Tensor:
        """sqrt(mean(t^2)) over every shard of ``p``'s leaf (``t`` shaped as ``p``)."""
        spec = self.spec(p)
        axes = () if spec is None else self.shards.split_axes(spec)
        if not axes:
            return _block_rms(t)
        return torch.sqrt(self.shards.sum(torch.sum(torch.square(t)), axes) / math.prod(self.global_shape(p)))


class OptaxAdamW(torch.optim.Optimizer):
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule))``, step
    for step, over the params it is given (the frozen codec table is not one
    of them). ``schedule(count)`` is the learning rate at optax's update count
    before the step. A param without a gradient updates as optax updates a
    zero gradient. ``sharded``: the params are a mesh rank's slices
    (the clip's norm sums over every shard)."""

    STATE_KEYS = ("mu", "nu")

    def __init__(self, params, schedule, b1: float, b2: float, weight_decay: float, max_norm: float,
                 eps: float = 1e-8, sharded: Optional[_Sharded] = None):
        super().__init__(params, {"b1": b1, "b2": b2, "eps": eps, "weight_decay": weight_decay})
        self.schedule = schedule
        self.max_norm = max_norm
        self.sharded = sharded or _Sharded()
        self.count = 0  # optax's update count
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def state_spec(self, p, key: str):
        """The spec of ``p``'s state ``key`` on a mesh: the param's."""
        return self.sharded.spec(p)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdamW.step takes no closure")
        lr = self.schedule(self.count)
        self.count += 1
        params = [p for group in self.param_groups for p in group["params"]]
        grads = {p: torch.zeros_like(p) if p.grad is None else p.grad for p in params}
        g_norm = self.sharded.norm(grads)
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


# optax 0.2.6 adafactor's defaults (optax/_src/alias.py:226-235, the min scale
# at optax/_src/transform.py:500)
ADAFACTOR_MIN_DIM_TO_FACTOR = 128
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIP = 1.0
ADAFACTOR_MIN_SCALE = 1e-3


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's rule: (second largest axis, largest axis) of a leaf with at
    least two axes whose second largest is >= ``ADAFACTOR_MIN_DIM_TO_FACTOR``,
    else None (an unfactored second moment)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _block_rms(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(t)))


class OptaxAdafactor(torch.optim.Optimizer):
    """``optax.chain(clip_by_global_norm(max_norm), adafactor(schedule,
    weight_decay_rate=weight_decay or None))`` at optax's defaults, step for
    step: ``scale_by_factored_rms`` (decay ``1 - (count + 1)^-0.8``, grad^2 +
    1e-30, leaves factored over their two largest axes when the second is >=
    128: row factor ``(v_row / mean(v_row))^-0.5``, column factor
    ``v_col^-0.5``; else ``v^-0.5``), ``clip_by_block_rms(1.0)``, the
    learning rate, ``scale_by_param_block_rms`` (min 1e-3),
    ``add_decayed_weights``, ``scale(-1)``. Each leaf is one block. The state
    holds ``v_row`` and ``v_col`` for a factored leaf and ``v`` for the
    others, in the param dtype. ``sharded``: the params are a mesh rank's
    slices; a leaf's factoring follows its global shape, and its means and
    block RMS sum over every shard."""

    STATE_KEYS = ("v_row", "v_col", "v")

    def __init__(self, params, schedule, weight_decay: float, max_norm: float, sharded: Optional[_Sharded] = None):
        super().__init__(params, {"weight_decay": weight_decay})
        self.schedule = schedule
        self.max_norm = max_norm
        self.sharded = sharded or _Sharded()
        self.count = 0  # optax's update count
        for group in self.param_groups:
            for p in group["params"]:
                dims = _factored_dims(self.sharded.global_shape(p))
                if dims is None:
                    self.state[p] = {"v": torch.zeros_like(p)}
                else:
                    d1, d0 = dims
                    row = [s for i, s in enumerate(p.shape) if i != d0]
                    col = [s for i, s in enumerate(p.shape) if i != d1]
                    self.state[p] = {"v_row": p.new_zeros(row), "v_col": p.new_zeros(col)}

    def state_spec(self, p, key: str):
        """The spec of ``p``'s state ``key`` on a mesh: a factored moment
        drops the axis it is a mean over."""
        spec = self.sharded.spec(p)
        if spec is None or key == "v":
            return spec
        d1, d0 = _factored_dims(self.sharded.global_shape(p))
        return spec.without(d0 if key == "v_row" else d1)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdafactor.step takes no closure")
        lr = self.schedule(self.count)
        f32 = np.float32
        decay = f32(1) - f32(self.count + 1) ** f32(-ADAFACTOR_DECAY_RATE)
        keep = float(f32(1) - decay)
        decay = float(decay)
        self.count += 1
        params = [p for group in self.param_groups for p in group["params"]]
        grads = {p: torch.zeros_like(p) if p.grad is None else p.grad for p in params}
        sh = self.sharded
        g_norm = sh.norm(grads)
        clip = g_norm >= self.max_norm
        for group in self.param_groups:
            wd = group["weight_decay"]
            for p in group["params"]:
                g = grads[p]
                g = torch.where(clip, (g / g_norm.to(g.dtype)) * self.max_norm, g)
                st = self.state[p]
                g_sq = g * g + ADAFACTOR_EPS
                dims = _factored_dims(sh.global_shape(p))
                if dims is None:
                    st["v"] = v = decay * st["v"] + keep * g_sq
                    u = g * torch.rsqrt(v)
                else:
                    d1, d0 = dims
                    st["v_row"] = v_row = decay * st["v_row"] + keep * sh.mean(g_sq, p, d0, d0)
                    st["v_col"] = v_col = decay * st["v_col"] + keep * sh.mean(g_sq, p, d1, d1)
                    row_factor = torch.rsqrt(v_row / sh.mean(v_row, p, d1 - 1 if d1 > d0 else d1, d1, keepdim=True))
                    u = g * row_factor.unsqueeze(d0) * torch.rsqrt(v_col).unsqueeze(d1)
                u = u / torch.clamp(sh.block_rms(u, p) / ADAFACTOR_CLIP, min=1.0)
                u = torch.tensor(lr, dtype=p.dtype) * u
                rms = sh.block_rms(p, p)
                u = u * torch.where(rms <= ADAFACTOR_MIN_SCALE, torch.tensor(ADAFACTOR_MIN_SCALE, dtype=rms.dtype), rms)
                if wd:
                    u = u + wd * p
                p.copy_(p - u)


def _silent(*args, **kwargs) -> None:
    pass


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
        if train_config.optimizer not in ("adamw", "adafactor"):
            raise ValueError(f"unknown optimizer {train_config.optimizer!r}")
        self.cfg = dataclasses.replace(
            lm_config, remat=train_config.remat, remat_policy=train_config.remat_policy
        )
        self.tc = train_config
        self.step = 0
        self.shards = None  # a mesh's parallel/mesh.Shards
        self._forward_fn = forward
        # the stacked layout: one leaf per weight kind (models/llama.stack_layer_params)
        params = stack_layer_params(params)
        if mesh is None:
            self.device = _resolve_device(device)
        else:
            from ..parallel.mesh import Mesh, local_lm_config, rank_device, shard_params

            if not isinstance(mesh, Mesh):
                raise TypeError(f"Trainer(mesh=...): a mesh from parallel.make_mesh, not {type(mesh).__name__}")
            self.device = _resolve_device(rank_device(device))
            pp = mesh.size("pp")
            params = shard_params(params, mesh, pp=pp > 1, device=self.device)
            self.shards = params.pop("mesh")
            params.pop("tp", None)
            self.cfg = local_lm_config(self.cfg, self.shards.sizes["tp"])
            if pp > 1:
                from ..parallel.pipeline import make_pipeline_forward

                self._forward_fn = make_pipeline_forward(mesh, self.tc.pp_microbatches or 2 * pp)
        self.params = tree_map(lambda t: t.detach().to(self.device).contiguous().requires_grad_(True), params)
        self._leaves = tree_leaves(self.params)
        frozen = {CODEC_TABLE} if self.tc.freeze_codec_table and "codec_embed" in self.params else set()
        self._trainable = [(p, t) for p, t in self._leaves if p not in frozen]
        trainable = [t for _, t in self._trainable]
        sharded = _Sharded(self.shards, {t: p for p, t in self._leaves})
        schedule = functools.partial(schedule_lr, tc=self.tc)
        if self.tc.optimizer == "adafactor":
            self.optimizer = OptaxAdafactor(
                trainable, schedule, weight_decay=self.tc.weight_decay, max_norm=self.tc.grad_clip, sharded=sharded
            )
        else:
            self.optimizer = OptaxAdamW(
                trainable, schedule, b1=self.tc.adam_b1, b2=self.tc.adam_b2, weight_decay=self.tc.weight_decay,
                max_norm=self.tc.grad_clip, sharded=sharded,
            )

    @property
    def is_writer(self) -> bool:
        """Whether this rank logs and writes files (rank 0 of a mesh, or no mesh)."""
        return self.shards is None or self.shards.writer

    def _global(self, spec, t: torch.Tensor) -> Optional[torch.Tensor]:
        return t if self.shards is None else self.shards.to_host(spec, t)

    def _local(self, spec, t: torch.Tensor) -> torch.Tensor:
        return t if self.shards is None else self.shards.local(spec, t)

    @property
    def opt_state(self) -> Optional[Dict]:
        """``{"count", "mu", "nu"}`` (AdamW) or ``{"count", "v_row", "v_col",
        "v"}`` (Adafactor: only the leaves a param has) with the state keyed
        by dotted param path (what checkpoints store and models/from_jax
        converts to). On a mesh a collective: the global tensors on the host
        of the mesh's rank 0, gathered one at a time; None on the others."""
        state, opt = self.optimizer.state, self.optimizer
        out = {
            "count": opt.count,
            **{k: {p: self._global(opt.state_spec(t, k), state[t][k]) for p, t in self._trainable if k in state[t]}
               for k in opt.STATE_KEYS},
        }
        return out if self.is_writer else None

    @opt_state.setter
    def opt_state(self, value: Dict) -> None:
        state = {}
        for p, t in self._trainable:
            # the keys the optimizer built for this leaf: mu / nu, or v_row +
            # v_col (factored) or v (Adafactor)
            want = set(self.optimizer.state[t])
            have = {k for k in self.optimizer.STATE_KEYS if p in value.get(k, {})}
            if have != want:
                raise KeyError(f"opt_state: {p} needs {sorted(want)}, the state has {sorted(have)}")
            state[t] = {k: self._local(self.optimizer.state_spec(t, k), value[k][p]).to(self.device).contiguous()
                        for k in want}
        self.optimizer.count = int(value["count"])
        self.optimizer.state.update(state)

    def global_params(self):
        """The params in the stacked layout, detached; on a mesh a
        collective (every rank of the mesh calls it): the global tensors on
        the host of the mesh's rank 0, gathered one at a time; None on the
        others."""
        params = tree_map(lambda t: t.detach(), self.params)
        if self.shards is None:
            return params
        from ..parallel.mesh import gather_params

        return gather_params({**params, "mesh": self.shards})

    @torch.no_grad()
    def load_global_params(self, params) -> None:
        """Copy global stacked ``params`` (a checkpoint's) into this rank's
        leaves, each its slice."""
        saved = dict(tree_leaves(params))
        mine = dict(self._leaves)
        if saved.keys() != mine.keys():
            raise ValueError(f"params {sorted(saved)} do not match the trainer's {sorted(mine)}")
        for name, t in mine.items():
            spec = None if self.shards is None else self.shards.specs[name]
            t.copy_(self._local(spec, saved[name]))

    def export_params(self):
        """Params in the inference layout (unrolled per-layer list), detached
        (on a mesh as ``global_params``: None on all but rank 0)."""
        params = self.global_params()
        return None if params is None else unstack_layer_params(params)

    def _to_device(self, a) -> torch.Tensor:
        a = np.asarray(a)
        if self.shards is not None:  # this rank's rows of the global batch
            start, n = self.shards.rows(len(a))
            a = a[start : start + n]
        return torch.as_tensor(a).to(self.device, non_blocking=True)

    def _run_params(self):
        """The params a forward takes: on a mesh, with their groups."""
        if self.shards is None:
            return self.params
        return {**self.params, "mesh": self.shards, **({"tp": self.shards.tp} if self.shards.tp else {})}

    # -- steps ----------------------------------------------------------------
    def train_batch_async(self, batch: np.ndarray, labels: np.ndarray) -> Dict:
        """One train step on the global batch (a rank takes its rows);
        returns DEVICE metric tensors without waiting."""
        with spans.span("train.h2d"):
            batch, labels = self._to_device(batch), self._to_device(labels)
        loss, metrics = loss_and_metrics(self._run_params(), batch, labels, self.cfg,
                                         loss_block=self.tc.loss_block_size, forward_fn=self._forward_fn)
        with spans.span("train.backward"):
            loss.backward()
        with spans.span("train.optimizer"):
            if self.shards is not None:
                self.shards.reduce_grads(self._leaves)
            tensors = [t for _, t in self._leaves]
            grad_norm = self.optimizer.sharded.norm({t: t.grad for t in tensors if t.grad is not None})
            self.optimizer.step()
            for t in tensors:  # the frozen table's too
                t.grad = None
        self.step += 1
        return dict(metrics, loss=loss.detach(), grad_norm=grad_norm)

    def train_batch(self, batch: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
        """Synchronous step: run + fetch the metrics."""
        with spans.span("train.step"):
            metrics = self.train_batch_async(batch, labels)
            with spans.span("train.fetch"):
                return {k: float(v) for k, v in metrics.items()}

    @torch.no_grad()
    def eval_batches(self, batches) -> Dict[str, float]:
        total_loss = total_acc = total_n = 0.0
        for batch, labels in batches:
            loss, metrics = loss_and_metrics(
                self._run_params(), self._to_device(batch), self._to_device(labels), self.cfg,
                loss_block=self.tc.loss_block_size, forward_fn=self._forward_fn,
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

        if not self.is_writer:  # one rank of a mesh logs
            log_fn = _silent
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
