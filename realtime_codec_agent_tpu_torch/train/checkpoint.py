"""Checkpoints with auto-resume, in PyTorch.

Port of realtime_codec_agent_tpu/train/checkpoint.py with the same
``checkpoint-<step>/`` naming: ``save`` writes ``{params, opt_state, step}``,
``restore_latest`` finds the highest step under an output dir and loads it
into a Trainer, ``save_params`` / ``load_params`` handle bare params (the
deployment artifact), unstacked to the inference layout on load.

Storage is ``torch.save`` to ``checkpoint-<step>/state.pt`` and
``<path>/params.pt`` (written to a temporary name, then renamed), read back
with ``torch.load(weights_only=True)``: tensors, dicts, lists, ints and None
only. The port cannot read the JAX package's orbax checkpoints; carry JAX
state across with models/from_jax.py instead.

A trainer on a mesh saves the global stacked tree: every rank gathers it a
leaf at a time, each leaf moving at once to rank 0's host (no card holds
more than one gathered leaf), rank 0 writes, and every rank waits for the
write at a barrier bounded by the groups' timeout; every rank restores by
loading the file and keeping its slice. So a checkpoint resumes on any mesh
and on one device.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch

from ..models.llama import unstack_layer_params
from ..utils.tree import tree_map

CKPT_PREFIX = "checkpoint-"
STATE_FILE = "state.pt"
PARAMS_FILE = "params.pt"


def _ckpt_dir(output_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(output_dir), f"{CKPT_PREFIX}{step}")


def latest_checkpoint(output_dir: str) -> Optional[str]:
    if not os.path.isdir(output_dir):
        return None
    best = None
    best_step = -1
    for name in os.listdir(output_dir):
        m = re.fullmatch(rf"{CKPT_PREFIX}(\d+)", name)
        if m and int(m.group(1)) > best_step and os.path.exists(os.path.join(output_dir, name, STATE_FILE)):
            best_step = int(m.group(1))
            best = os.path.join(output_dir, name)
    return best


def _write(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # a reader sees the old file or the whole new one


def _detached(tree):
    return tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor) else t, tree)


def save(output_dir: str, trainer) -> str:
    """Write ``checkpoint-<step>/state.pt`` (on a mesh: a collective; rank 0
    writes, every rank returns after the write)."""
    path = _ckpt_dir(output_dir, trainer.step)
    state = {"params": trainer.global_params(), "opt_state": trainer.opt_state, "step": int(trainer.step)}
    if trainer.is_writer:
        _write(state, os.path.join(path, STATE_FILE))
    if trainer.shards is not None:
        trainer.shards.barrier()
    return path


@torch.no_grad()
def restore_latest(output_dir: str, trainer) -> bool:
    """Load the latest checkpoint into ``trainer`` (params copied in place,
    so they stay the trainer's leaves); False when there is none."""
    path = latest_checkpoint(output_dir)
    if path is None:
        return False
    # on a mesh each rank moves only its slices to its device
    where = trainer.device if trainer.shards is None else "cpu"
    state = torch.load(os.path.join(path, STATE_FILE), map_location=where, weights_only=True, mmap=True)
    try:
        trainer.load_global_params(state["params"])
    except ValueError as e:
        raise ValueError(f"checkpoint {path}: {e}") from None
    trainer.opt_state = state["opt_state"]
    trainer.step = int(state["step"])
    return True


def save_params(path: str, params) -> str:
    """Save bare params (the deployment artifact, e.g. after
    persist_codec_embeddings)."""
    path = os.path.abspath(path)
    _write(_detached(params), os.path.join(path, PARAMS_FILE))
    return path


def load_params(path: str, device="cpu"):
    """Load bare params saved by save_params, or a checkpoint dir's params,
    in the per-layer list layout (trainer checkpoints hold the stacked
    layout). The files carry their own structure, so no config is needed."""
    path = os.path.abspath(path)
    for name in (PARAMS_FILE, STATE_FILE):
        file = os.path.join(path, name)
        if os.path.exists(file):
            obj = torch.load(file, map_location=device, weights_only=True, mmap=True)
            params = obj["params"] if name == STATE_FILE else obj
            return unstack_layer_params(params)
    raise FileNotFoundError(f"No {PARAMS_FILE} or {STATE_FILE} under {path}")
