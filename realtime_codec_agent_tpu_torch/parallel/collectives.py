"""The explicit collectives of multi-rank serving and training, on
torch.distributed.

Every collective here is written with ``all_reduce`` and ``broadcast`` only:
the two that gloo takes on CUDA tensors, so several ranks can share one card
over gloo as well as own one each over NCCL. A gather is a sum into a
zero-filled buffer of the full size (adding zeros is exact); a rotation over
pipeline stages is the same gather, each stage reading its neighbour's slot.

- :class:`TensorParallel`, the tensor-parallel group a rank's sharded LM
  params carry under ``params["tp"]`` (parallel/mesh.shard_lm_for_inference
  and shard_params). ``models/llama`` calls it at Megatron's two sites:
  ``enter`` (*f*: identity forward, sum over the group backward) at each
  column-parallel input, ``all_reduce`` (*g*: sum forward, identity
  backward) at the row-parallel ``wo`` and ``w_down`` outputs; and
  ``gather_last`` for the vocab shards of a column-parallel ``lm_head`` in
  decode (inference only). Where no gradient flows (inference) *g* sums in
  place and *f* is the identity, with no autograd node; where one does,
  both are the autograd Functions below, so a backward through tp params
  is right.
- :func:`gather_axis`, the fsdp gather of a sharded leaf at use (forward:
  each rank's slice in a zero-filled full buffer, summed; backward: the
  full gradient summed over the group, then this rank's slice), and its
  transpose :func:`sum_slice` (the vocab-parallel embedding's sum over
  fsdp, each rank keeping its rows).
- :func:`rotate`, the pipeline stages' handoff: stage s reads stage s - 1's
  slot (``shift=1``, the forward) or stage s + 1's (``shift=-1``, the
  backward: the reverse rotation, as JAX's ``ppermute`` transposes).
- :class:`CommandChannel`, the leader's small commands to its followers
  (pickled, a length then the bytes, broadcast from rank 0) over a gloo
  group of its own on the host.

Every rank of a group issues the same collectives in the same order, and
every wait is bounded by the group's timeout: a mismatch fails, not hangs.
"""
from __future__ import annotations

import pickle
from datetime import timedelta
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist


def _grad_flows(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _SumForward(torch.autograd.Function):
    """Megatron's *g*: the sum over the group forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumBackward(torch.autograd.Function):
    """Megatron's *f*: the identity forward, the sum over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _gather(x: torch.Tensor, axis: int, group, size: int, rank: int) -> torch.Tensor:
    n = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = n * size
    full = x.new_zeros(shape)
    full.narrow(axis, rank * n, n).copy_(x)
    dist.all_reduce(full, group=group)
    return full


class _GatherAxis(torch.autograd.Function):
    """The slices of ``axis`` side by side in rank order; backward sums the
    full gradient over the group and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, axis, group, size, rank):
        ctx.meta = (axis, x.shape[axis], group, rank)
        return _gather(x, axis, group, size, rank)

    @staticmethod
    def backward(ctx, grad):
        axis, n, group, rank = ctx.meta
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=group)
        return grad.narrow(axis, rank * n, n).contiguous(), None, None, None, None


class _SumSlice(torch.autograd.Function):
    """The sum over the group, this rank's slice of ``axis`` kept (a
    reduce-scatter); backward places the slice's gradient in a zero-filled
    full buffer and sums it over the group (a gather)."""

    @staticmethod
    def forward(ctx, x, axis, group, size, rank):
        ctx.meta = (axis, group, size, rank)
        full = x.clone()
        dist.all_reduce(full, group=group)
        n = x.shape[axis] // size
        return full.narrow(axis, rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, grad):
        axis, group, size, rank = ctx.meta
        return _gather(grad.contiguous(), axis, group, size, rank), None, None, None, None


def sum_slice(x: torch.Tensor, axis: int, group, size: int, rank: int) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's slice of ``axis``
    (``size`` equal slices, rank order); autograd-correct where a gradient
    flows."""
    if _grad_flows(x):
        return _SumSlice.apply(x, axis, group, size, rank)
    full = group_sum(x.clone(), group)
    n = x.shape[axis] // size
    return full.narrow(axis, rank * n, n).contiguous()


def gather_axis(x: torch.Tensor, axis: int, group, size: int, rank: int) -> torch.Tensor:
    """The group's slices of ``axis`` side by side, rank order (the fsdp
    gather of a leaf at use); autograd-correct where a gradient flows."""
    if _grad_flows(x):
        return _GatherAxis.apply(x, axis, group, size, rank)
    return _gather(x, axis, group, size, rank)


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, in place, no gradient; returns ``x``."""
    dist.all_reduce(x, group=group)
    return x


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """*g* over ``group``, out of place: the sum forward, the identity
    backward where a gradient flows."""
    if _grad_flows(x):
        return _SumForward.apply(x, group)
    return group_sum(x.clone(), group)


def group_stack(x: torch.Tensor, group, size: int, rank: int) -> torch.Tensor:
    """``(size, *x.shape)``: every rank's ``x`` in rank order, no gradient."""
    return _gather(x.detach().unsqueeze(0), 0, group, size, rank)


def group_max(x: torch.Tensor, group, size: int, rank: int) -> torch.Tensor:
    """The elementwise max over the group, no gradient."""
    return group_stack(x, group, size, rank).amax(0)


def group_argmax(values: torch.Tensor, index: torch.Tensor, group, size: int, rank: int) -> torch.Tensor:
    """The global index of the max over the group, given each rank's max
    ``values`` and their global ``index`` (each rank's lowest): among equal
    maxima the lowest index, as ``jnp.argmax`` picks. No gradient."""
    v = group_stack(values, group, size, rank)
    i = group_stack(index, group, size, rank)
    top = v.amax(0, keepdim=True)
    return torch.where(v == top, i, torch.iinfo(i.dtype).max).amin(0)


def rotate(x: Optional[torch.Tensor], shape, dtype, device, group, size: int, rank: int, shift: int) -> torch.Tensor:
    """Stage rank's read of stage ``rank - shift``'s ``x`` over a pipeline
    group: every stage writes its ``x`` (the first ``len(x)`` rows of its
    slot of ``shape``; None writes nothing) into a zero-filled
    ``(size, *shape)`` buffer, the buffers are summed, and each stage reads
    its neighbour's slot. No gradient: the pipeline runs its backward
    rotation itself."""
    buf = torch.zeros((size, *shape), dtype=dtype, device=device)
    if x is not None:
        buf[rank, : x.shape[0]] = x
    dist.all_reduce(buf, group=group)
    return buf[(rank - shift) % size]


class TensorParallel:
    """A rank's tensor-parallel group: ``size`` ranks, this one ``rank``."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """*g*: the sum over the group. In place (returns ``x``) where no
        gradient flows; else out of place, the identity backward."""
        if _grad_flows(x):
            return _SumForward.apply(x, self.group)
        dist.all_reduce(x, group=self.group)
        return x

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """*f*: ``x`` unchanged; where a gradient flows, its gradient is
        summed over the group (a column-parallel matmul's input)."""
        if _grad_flows(x):
            return _SumBackward.apply(x, self.group)
        return x

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """The group's shards of the last axis side by side, rank order:
        each rank writes its shard into a zero-filled buffer of the full
        width, and the buffers are summed. Inference only: training's head
        is vocab-parallel (train/trainer.py) and never gathers its columns."""
        if _grad_flows(x):
            raise RuntimeError("gather_last has no gradient (inference only; training's head is vocab-parallel)")
        return _gather(x, x.dim() - 1, self.group, self.size, self.rank)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return group_max(x, self.group, self.size, self.rank)

    def argmax(self, values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        return group_argmax(values, index, self.group, self.size, self.rank)

    def __repr__(self) -> str:
        return f"TensorParallel(size={self.size}, rank={self.rank})"


class CommandChannel:
    """Commands from rank 0 to every other rank: ``send(op, *args)`` on the
    leader, ``recv() -> (op, args)`` on a follower. The channel has its own
    gloo group (CPU tensors), so a command never waits behind the data
    collectives; ``timeout_s`` bounds every send and receive."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self.group = dist.new_group(backend="gloo", timeout=timedelta(seconds=timeout_s))

    def send(self, op: str, *args: Any) -> None:
        payload = pickle.dumps((op, args))
        dist.broadcast(torch.tensor([len(payload)], dtype=torch.int64), src=0, group=self.group)
        dist.broadcast(torch.frombuffer(bytearray(payload), dtype=torch.uint8), src=0, group=self.group)

    def recv(self) -> Tuple[str, tuple]:
        try:
            size = torch.zeros(1, dtype=torch.int64)
            dist.broadcast(size, src=0, group=self.group)
            buf = torch.empty(int(size[0]), dtype=torch.uint8)
            dist.broadcast(buf, src=0, group=self.group)
        except RuntimeError as e:
            raise RuntimeError(
                f"rank {dist.get_rank()}: no command from the leader (rank 0) within {self.timeout_s} s, "
                f"or the leader is gone: {e}"
            ) from e
        return pickle.loads(buf.numpy().tobytes())
