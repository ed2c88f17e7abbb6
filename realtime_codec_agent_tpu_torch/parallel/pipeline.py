"""GPipe pipeline parallelism over the ``pp`` mesh axis, on torch.distributed.

Port of realtime_codec_agent_tpu/parallel/pipeline.py: the stacked layer
axis is split over ``pp`` (parallel/mesh.shard_params(..., pp=True)), stage
s holds layers [s*L/pp, (s+1)*L/pp), and M microbatches flow through the pp
stages in M + pp - 1 ticks: at tick t stage s runs microbatch t - s, then
hands its output to stage s + 1. JAX's static schedule, and the same
errors ("divide microbatches", "pp axis", the stacked layout required).

How the two packages differ: JAX's ``shard_map`` runs every stage every
tick and ``ppermute`` rotates the activations; AD transposes the rotation
for the backward, and a ``psum`` of the last stage's masked outputs gives
every stage the hidden states, so the loss runs on each. Here each rank
runs its own stage:

- bubble ticks are skipped (their outputs never reach the loss);
- the handoff is ``parallel/collectives.rotate`` (an ``all_reduce`` of
  zero-filled slots: the one collective gloo takes on CUDA tensors besides
  ``broadcast``), every stage joining each tick's rotation;
- the backward is the pipeline's own: a ``torch.autograd.Function`` keeps
  each microbatch's graph (the stage's layers under ``cfg.remat``'s policy)
  and replays the ticks in reverse, each stage's input gradient going back
  one stage by the reverse rotation, so every stage issues the same
  collectives in the same order;
- the embedding runs on the first stage and the final norm and the loss on
  the last (``Shards.loss_stage``); the other stages' hidden states are
  zeros that carry the pipeline's backward, and their loss is zero
  (train/trainer.loss_and_metrics). The leaves every stage holds (the
  embedding, the head, the final norm, the codec branch) have their
  gradients summed over pp (``Shards.reduce_grads``), which counts each
  once, as JAX's ``psum`` of masked outputs does.

A rank's microbatches split its own rows of the batch (``Shards.rows``);
where M does not divide them, some are one row smaller, and where M exceeds
them, the empty ones are dropped (B4 takes no empty batch): the schedule
runs the rest in their number + pp - 1 ticks. Every rank holds as many
rows, so every rank drops the same ones and its peers over fsdp and tp make
the same gathers and sums.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..models import llama
from ..ops import nn
from .collectives import rotate


class _Stage:
    """One rank's share of a pipelined forward and its backward."""

    def __init__(self, params, cfg, shards, valid: torch.Tensor, microbatches: int):
        self.params, self.cfg, self.shards = params, cfg, shards
        self.keys = list(params["layers"])
        self.rows = [r for r in torch.arange(valid.shape[0]).tensor_split(microbatches) if len(r)]
        self.valid = [valid[r] for r in self.rows]
        self.slot = (len(self.rows[0]), valid.shape[1], cfg.hidden_size)
        self.device = valid.device
        self.ticks = len(self.rows) + shards.stages - 1
        self.group = shards.groups["pp"]

    def _layers(self, h: torch.Tensor, layers, i: int) -> torch.Tensor:
        return llama.run_layers(h, layers, self.cfg, self.valid[i], self.params.get("tp"), self.shards)

    def _rotate(self, x: Optional[torch.Tensor], shift: int) -> torch.Tensor:
        s = self.shards
        return rotate(x, self.slot, self.cfg.dtype, self.device, self.group, s.stages, s.stage, shift)

    def forward(self, x: Optional[torch.Tensor], leaves, keep: bool) -> torch.Tensor:
        """The stage's ticks. ``keep``: build and keep each microbatch's graph
        (``leaves`` detached copies of the stage's layer leaves) for
        ``backward``. Returns the last stage's outputs in row order, zeros
        elsewhere."""
        s, n = self.shards, len(self.rows)
        layers = dict(zip(self.keys, leaves))
        self.inputs: List[torch.Tensor] = [None] * n
        self.outputs: List[torch.Tensor] = [None] * n
        recv = None
        for tick in range(self.ticks):
            i = tick - s.stage
            send = None
            if 0 <= i < n:
                inp = x[self.rows[i]] if s.stage == 0 else recv[: len(self.rows[i])]
                if keep:
                    inp = inp.detach().requires_grad_(True)
                out = self._layers(inp, layers, i)
                self.inputs[i], self.outputs[i] = inp, out
                send = None if s.loss_stage else out.detach()
            if tick < self.ticks - 1:
                recv = self._rotate(send, 1)
        if not s.loss_stage:
            return torch.zeros((sum(len(r) for r in self.rows), *self.slot[1:]), dtype=self.cfg.dtype,
                               device=self.device)
        return torch.cat([o.detach() for o in self.outputs])

    def backward(self, grad: torch.Tensor, leaves):
        """The ticks in reverse: each microbatch's gradient through the
        stage's layers, the input's gradient rotated back one stage.
        Returns (the input's gradient on the first stage, else None; the
        leaves' gradients)."""
        s, n = self.shards, len(self.rows)
        want = [l for l in leaves if l.requires_grad]
        acc = [None] * len(want)
        dx = torch.zeros_like(grad) if s.stage == 0 else None
        recv = None
        for tick in reversed(range(self.ticks)):
            i = tick - s.stage
            send = None
            if 0 <= i < n:
                d_out = grad[self.rows[i]] if s.loss_stage else recv[: len(self.rows[i])]
                got = torch.autograd.grad(self.outputs[i], [self.inputs[i], *want], d_out, allow_unused=True)
                acc = [g if a is None else a if g is None else a + g for a, g in zip(acc, got[1:])]
                if s.stage == 0:
                    dx[self.rows[i]] = got[0]
                else:
                    send = got[0]
            if tick > 0:
                recv = self._rotate(send, -1)
        it = iter(acc)
        return dx, [next(it) if l.requires_grad else None for l in leaves]


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage: _Stage, x, *leaves):
        detached = [l.detach().requires_grad_(l.requires_grad) for l in leaves]
        with torch.enable_grad():
            out = stage.forward(x, detached, keep=True)
        ctx.stage, ctx.detached = stage, detached
        return out

    @staticmethod
    def backward(ctx, grad):
        dx, dleaves = ctx.stage.backward(grad, ctx.detached)
        return (None, dx, *dleaves)


def make_pipeline_forward(mesh, microbatches: int):
    """A drop-in replacement for models/llama.forward (training) that stages
    the layer stack over the mesh's ``pp`` axis. Params must come from
    ``parallel/mesh.shard_params(..., pp=True)`` (the stacked layout, the
    layer axis over pp); the global batch must divide ``microbatches``.

    Returns ``fwd(params, ids, cfg, attn_mask=None) -> hidden`` over the
    rank's rows: on the last stage final-normed, exactly as ``forward``; on
    the others zeros that carry the pipeline's backward."""
    if mesh.size("pp") < 2:
        raise ValueError("make_pipeline_forward needs a mesh with a pp axis >= 2")

    def fwd(params, ids, cfg, attn_mask=None):
        if not isinstance(params["layers"], dict):
            raise ValueError("pipeline forward requires the stacked scan-over-layers layout")
        shards = params.get("mesh")
        if shards is None or shards.sizes["pp"] != mesh.size("pp"):
            raise ValueError("pipeline forward needs params from parallel.shard_params(params, mesh, pp=True)")
        b, t = ids.shape
        global_b = b * shards.sizes["dp"] * shards.sizes["fsdp"]
        if global_b % microbatches:
            raise ValueError(f"batch {global_b} must divide microbatches={microbatches}")
        valid = attn_mask.bool() if attn_mask is not None else torch.ones((b, t), dtype=torch.bool, device=ids.device)
        x = llama.embed_ids(params, ids, cfg) if shards.stage == 0 else None
        stage = _Stage(params, cfg, shards, valid, microbatches)
        leaves = [params["layers"][k] for k in stage.keys]
        if torch.is_grad_enabled():
            hidden = _Pipeline.apply(stage, x, *leaves)
        else:
            hidden = stage.forward(x, leaves, keep=False)
        if shards.loss_stage:
            hidden = nn.rms_norm(hidden, params["final_norm"], cfg.rms_eps)
        return hidden

    return fwd
