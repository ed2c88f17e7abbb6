"""The explicit collectives of multi-rank serving, on torch.distributed.

Two pieces, both written with ``all_reduce`` and ``broadcast`` only (the
two collectives gloo takes on CUDA tensors, so several ranks can share one
card over gloo as well as own one each over NCCL):

- :class:`TensorParallel`, the tensor-parallel group a rank's sharded LM
  params carry under ``params["tp"]`` (parallel/mesh.shard_lm_for_inference).
  ``models/llama`` calls it at three sites: the sum of the row-parallel
  ``wo`` and ``w_down`` partial products, and the gather of the vocab
  shards of a column-parallel ``lm_head``, a sum into a zero-filled
  full-width buffer (adding zeros is exact, so every rank holds the same
  full row and draws the same token).
- :class:`CommandChannel`, the leader's small commands to its followers
  (pickled, a length then the bytes, broadcast from rank 0) over a gloo
  group of its own on the host. Every wait is bounded by the group's
  timeout: a follower whose leader is gone raises instead of hanging.
"""
from __future__ import annotations

import pickle
from datetime import timedelta
from typing import Any, Tuple

import torch
import torch.distributed as dist


class TensorParallel:
    """A rank's tensor-parallel group: ``size`` ranks, this one ``rank``."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group, in place; returns ``x``."""
        dist.all_reduce(x, group=self.group)
        return x

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """The group's shards of the last axis side by side, rank order:
        each rank writes its shard into a zero-filled buffer of the full
        width, and the buffers are summed."""
        n = x.shape[-1]
        full = x.new_zeros((*x.shape[:-1], n * self.size))
        full[..., self.rank * n : (self.rank + 1) * n] = x
        return self.all_reduce(full)

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
