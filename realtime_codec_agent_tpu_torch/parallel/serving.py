"""The batched decode engine served from several ranks: a leader and its
followers.

Under one controller the JAX package drives every row from one process.
Here each rank holds ``batch / dp`` rows (and a ``1 / tp`` slice of the
weights and KV heads), so rank 0, the leader, serves: the backend
(serving/batched_backend.BatchedCompletionBackend) calls its
:class:`ShardedBatchedEngine`, which has the engine's interface over all
rows. Each call that changes device state (``set_row_sampler``,
``prefill_row``, ``step_async``, ``prewarm``) is first broadcast to the
followers as a small command (parallel/collectives.CommandChannel); then
every rank runs the engine's own method, which does the device work for the
rows it holds (the tensor-parallel ranks of a row together) and keeps the
host mirrors of every row, so every rank picks the same cache bucket. A
dispatch's tokens reach the leader as a sum over the rows axis into a
zero-filled ``(B, steps)`` buffer. The followers run
:func:`follow` until the leader's ``stop``. While the leader is idle it
sends a heartbeat, so a follower's bounded wait fails only when the leader
is gone.
"""
from __future__ import annotations

import threading
import time

import torch.distributed as dist

from .collectives import CommandChannel
from .mesh import mesh_coordinate

# the engine calls that change device state: broadcast, then run on every rank
COMMANDS = ("set_row_sampler", "prefill_row", "step_async", "prewarm")


class ShardedBatchedEngine:
    """One rank's share of a BatchedDecodeEngine sharded over a mesh
    (parallel/mesh.py builds it). ``local`` is the rank's engine: its device
    holds rows ``row0 .. row0 + local_rows - 1``, its host mirrors every row.
    On rank 0 this is the engine over all rows: each call in ``COMMANDS`` is
    broadcast, then run by the engine's own method on every rank; reads
    (``batch``, ``offsets``, ``max_prompt_len``, ``resolve``...) are the
    local engine's."""

    def __init__(self, local, mesh, rows_axis: str, timeout_s: float = 300.0):
        self.local = local
        self.is_leader = dist.get_rank() == 0
        coord = mesh_coordinate(mesh)
        # the ranks that hold the leader's KV heads and weights, one for each
        # row shard: the leader's group over the rows axis
        on_leader_line = all(c == 0 for axis, c in coord.items() if axis != rows_axis)
        parts = mesh.size(rows_axis)
        self._tokens_group = mesh.axis_groups[rows_axis] if on_leader_line and parts > 1 else None
        self._gathers = on_leader_line
        self.channel = CommandChannel(timeout_s)
        self._lock = threading.RLock()
        self._last_send = time.monotonic()
        self._stopped = threading.Event()
        self._beat = None
        if self.is_leader and dist.get_world_size() > 1:
            self._beat = threading.Thread(target=self._heartbeat, args=(timeout_s / 4,), daemon=True)
            self._beat.start()

    def __getattr__(self, name):
        if name == "local":  # not set yet
            raise AttributeError(name)
        return getattr(self.local, name)

    # ----------------------------------------------------------- the leader
    def _command(self, op: str, args: tuple, kwargs: dict):
        if not self.is_leader:
            raise RuntimeError(f"rank {dist.get_rank()} is a follower: only rank 0 drives the engine")
        with self._lock:
            if self._stopped.is_set():
                raise RuntimeError("the sharded engine was stopped")
            self.channel.send(op, args, kwargs)
            self._last_send = time.monotonic()
            return self._apply(op, args, kwargs)

    def _heartbeat(self, period: float) -> None:
        while not self._stopped.wait(period):
            with self._lock:
                if not self._stopped.is_set() and time.monotonic() - self._last_send >= period:
                    self.channel.send("ping")
                    self._last_send = time.monotonic()

    def set_row_sampler(self, *args, **kwargs) -> None:
        self._command("set_row_sampler", args, kwargs)

    def prefill_row(self, row: int, prompt_ids) -> None:
        prompt_ids = [int(t) for t in prompt_ids]
        self.local.check_prompt(prompt_ids)  # refused here, before any rank takes it
        self._command("prefill_row", (row, prompt_ids), {})

    def step_async(self, *args, **kwargs):
        """The engine's dispatch on every rank; the tokens of all rows."""
        return self._command("step_async", args, kwargs)

    def step(self, *args, **kwargs):
        return self.resolve(self.step_async(*args, **kwargs))

    def prewarm(self, *args, **kwargs) -> None:
        self._command("prewarm", args, kwargs)

    def stop(self) -> None:
        """Leader: end every follower's ``follow`` loop and the heartbeat."""
        with self._lock:
            if self.is_leader and not self._stopped.is_set():
                self.channel.send("stop")
            self._stopped.set()
        if self._beat is not None:
            self._beat.join(timeout=10)

    # ------------------------------------------------------------ every rank
    def _apply(self, op: str, args: tuple, kwargs: dict):
        if op not in COMMANDS:
            raise ValueError(f"unknown command {op!r}")
        out = getattr(self.local, op)(*args, **kwargs)
        if op != "step_async" or not self._gathers:
            return None
        # this shard's rows in place in a zero-filled buffer of every row,
        # summed over the row shards
        eng = self.local
        full = out.new_zeros((eng.batch, *out.shape[1:]))
        full[eng.row0 : eng.row0 + eng.local_rows] = out
        if self._tokens_group is not None:
            dist.all_reduce(full, group=self._tokens_group)
        return full


def follow(sharded: ShardedBatchedEngine) -> int:
    """A follower's loop: apply the leader's commands to this rank's rows
    until its ``stop``; returns the commands applied. Raises when no
    command (or heartbeat) arrives within the channel's timeout."""
    if sharded.is_leader:
        raise RuntimeError("rank 0 leads: it serves the engine instead of following")
    applied = 0
    while True:
        op, args = sharded.channel.recv()
        if op == "stop":
            sharded._stopped.set()
            return applied
        if op == "ping":
            continue
        sharded._apply(op, *args)
        applied += 1
