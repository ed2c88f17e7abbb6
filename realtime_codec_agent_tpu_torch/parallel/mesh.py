"""Device mesh and tensor-parallel inference sharding, on torch.distributed.

Port of the serving half of realtime_codec_agent_tpu/parallel/mesh.py:
``make_mesh``, ``default_mesh_shape``, ``shard_lm_for_inference`` and
``shard_batched_engine_for_serving``, with the same Megatron layout (the
attention and MLP input projections and the ``lm_head`` split over ``tp``
by columns, ``wo`` and ``w_down`` by rows, the KV cache over KV heads, the
batched engine's rows over ``dp``). The training half (``lm_param_specs``,
``batch_spec``, ``shard_params``, the GPipe ``pipeline.py``) is not ported
yet (ROADMAP.md, queue 12b).

How the two packages differ: JAX shards by compute-follows-data under one
controller. Its arrays are global, a ``NamedSharding`` says where their
pieces live, XLA inserts the collectives, and one process drives every
device. PyTorch runs one process per rank. Each rank holds only its local
slice (``shard_lm_for_inference`` returns it, with the local config from
``local_lm_config``), and the collectives are explicit: ``models/llama``
sums the row-parallel partial products and gathers the vocab shards over
the group its params carry (parallel/collectives.TensorParallel). Every
rank of a tensor-parallel group makes the same calls (SPMD). The batched
server has a leader: rank 0 runs the backend and broadcasts each call that
changes device state to the followers, which run ``follow``
(parallel/serving.py). ``batched_engine_for_serving`` builds a rank's
engine from params on the host: its card holds only its slice of the
weights and its rows of the cache.

The backend is explicit (``init_distributed``): ``nccl`` when each rank
owns a card, ``gloo`` on the CPU and for several ranks sharing one card.
Nothing switches backend because another one failed.
"""
from __future__ import annotations

import dataclasses
import os
import socket
from datetime import timedelta
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.tree import tree_map
from .collectives import TensorParallel

AXES = ("dp", "fsdp", "tp", "pp")
BACKENDS = ("nccl", "gloo")
LAUNCH_HINT = (
    "launch one process per rank with torchrun, e.g. torchrun --nproc_per_node=<dp*tp> -m "
    "realtime_codec_agent_tpu_torch.serving.server --mesh <dp>x<tp> --dist_backend {nccl,gloo} ..."
)
_DEVICE = {}  # the device init_distributed bound this process to


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launched_world_size() -> Optional[int]:
    """WORLD_SIZE from a launcher's environment (torchrun), else None."""
    return int(os.environ["WORLD_SIZE"]) if "WORLD_SIZE" in os.environ else None


def init_distributed(backend: str, device="cuda", timeout_s: float = 300.0) -> torch.device:
    """Join the default process group with ``backend`` and return this
    rank's device. The rank, world size and rendezvous come from a
    launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``: torchrun sets
    them); without one, a single-rank group on a free localhost port.

    ``nccl`` needs a card per rank: it raises where the ranks of a host
    outnumber its cards. ``gloo`` takes CPU tensors, and CUDA tensors
    staged through the host, so ranks may share a card (rank i takes card
    ``LOCAL_RANK mod count``). ``timeout_s`` bounds every collective."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    device = torch.device(device)
    launched = launched_world_size() is not None
    world = int(os.environ["WORLD_SIZE"]) if launched else 1
    local_rank = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0))) if launched else 0
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: device cuda but no CUDA device is available")
        cards = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if backend == "nccl" and local_world > cards:
            raise RuntimeError(
                f"init_distributed: nccl needs one card per rank, but {local_world} ranks share this host's "
                f"{cards} card(s); pass backend='gloo' to share a card"
            )
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
        torch.cuda.init()  # a DeviceMesh must not pick the card from LOCAL_RANK itself
    elif backend == "nccl":
        raise ValueError(f"init_distributed: nccl needs CUDA devices, not {device}")
    if launched:
        dist.init_process_group(backend, timeout=timedelta(seconds=timeout_s))
    else:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1,
                                timeout=timedelta(seconds=timeout_s))
    _DEVICE["device"] = device
    return device


def make_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1, pp: int = 1):
    """A ``DeviceMesh`` of shape (dp, fsdp, tp, pp) named ``AXES`` over the
    first dp * fsdp * tp * pp ranks of the initialized default group, in
    rank order (tp and pp innermost, as the JAX mesh lays out devices)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(f"make_mesh: no process group (init_distributed first); {LAUNCH_HINT}")
    n = dp * fsdp * tp * pp
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp}x{pp} needs {n} devices, have {world}")
    device = _DEVICE.get("device", torch.device("cpu"))
    ranks = torch.arange(n).reshape(dp, fsdp, tp, pp)
    return DeviceMesh(device.type, ranks, mesh_dim_names=AXES)


def default_mesh_shape(n_devices: int) -> Dict[str, int]:
    """Reasonable default factorization: prefer fsdp x tp for a single replica
    group, adding dp only beyond 8 devices."""
    if n_devices == 1:
        return dict(dp=1, fsdp=1, tp=1)
    if n_devices == 2:
        return dict(dp=1, fsdp=2, tp=1)
    if n_devices == 4:
        return dict(dp=1, fsdp=2, tp=2)
    if n_devices == 8:
        return dict(dp=2, fsdp=2, tp=2)
    # general: pick the largest tp in {4,2,1} dividing n, then the largest
    # fsdp in {4,2,1} dividing the remainder, and grow dp with what's left —
    # every factor divides evenly so dp >= 1 for any device count (incl.
    # non-powers-of-two like 6 or 12)
    tp = next(t for t in (4, 2, 1) if n_devices % t == 0)
    rem = n_devices // tp
    fsdp = next(f for f in (4, 2, 1) if rem % f == 0)
    dp = rem // fsdp
    return dict(dp=dp, fsdp=fsdp, tp=tp)


def mesh_coordinate(mesh) -> Dict[str, int]:
    """This rank's index along each named axis; raises for a rank outside
    the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {tuple(mesh.mesh.shape)}")
    return dict(zip(mesh.mesh_dim_names, coord))


def _must_divide(what: str, n: int, parts: int) -> None:
    if n % parts:
        raise ValueError(f"{parts} shards: {parts} must divide {what} ({n})")


def local_lm_config(cfg, tp: int):
    """The config a tensor-parallel rank decodes with: ``num_heads / tp``
    query and ``num_kv_heads / tp`` KV heads (the vocab stays whole: the
    logits are gathered). Raises unless tp divides both head counts, the
    intermediate size and an untied vocab."""
    _must_divide("num_heads", cfg.num_heads, tp)
    _must_divide("num_kv_heads", cfg.num_kv_heads, tp)
    _must_divide("intermediate_size", cfg.intermediate_size, tp)
    if not cfg.tie_embeddings:
        _must_divide("vocab_size", cfg.vocab_size, tp)
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads // tp)


# ---------------------------------------------------------------------------
# The Megatron split of one rank's params
# ---------------------------------------------------------------------------

def _part(t: torch.Tensor, axis: int, rank: int, parts: int, what: str) -> torch.Tensor:
    size = t.shape[axis]
    _must_divide(what, size, parts)
    return t.narrow(axis, rank * (size // parts), size // parts).contiguous()


def _columns(w, rank: int, parts: int, what: str):
    """A column-parallel (in, out) leaf's output slice: int8 ``q`` and its
    scales ``s`` together; int4 ``q4``, ``d`` and ``m`` on their output
    axis."""
    if isinstance(w, dict) and "q" in w:
        return {"q": _part(w["q"], 1, rank, parts, what), "s": _part(w["s"], 0, rank, parts, what)}
    if isinstance(w, dict):
        return {k: _part(w[k], 1, rank, parts, what) for k in ("q4", "d", "m")}
    return _part(w, 1, rank, parts, what)


def _rows(w, rank: int, parts: int, what: str):
    """A row-parallel (in, out) leaf's input slice: int8 ``s`` stays whole
    (per output column); int4's group-contiguous nibble packing keeps a K
    split on whole groups when tp divides the group count
    (ops/int4_matmul.py's layout note)."""
    if isinstance(w, dict) and "q" in w:
        return {"q": _part(w["q"], 0, rank, parts, what), "s": w["s"]}
    if isinstance(w, dict):
        return {k: _part(w[k], 0, rank, parts, f"{what} (int4 groups)") for k in ("q4", "d", "m")}
    return _part(w, 0, rank, parts, what)


def _width(w) -> int:
    return (w["q"] if isinstance(w, dict) and "q" in w else w["q4"] if isinstance(w, dict) else w).shape[1]


def _in_rows(w) -> int:
    if isinstance(w, dict) and "q" in w:
        return w["q"].shape[0]
    if isinstance(w, dict):
        return w["q4"].shape[0] * 2
    return w.shape[0]


def _split_columns(w, sizes: Sequence[int]) -> List:
    """A fused leaf's column blocks of ``sizes`` (the parts it was fused from)."""
    out, start = [], 0
    for n in sizes:
        if isinstance(w, dict) and "q" in w:
            out.append({"q": w["q"][:, start : start + n], "s": w["s"][start : start + n]})
        elif isinstance(w, dict):
            out.append({k: w[k][:, start : start + n] for k in ("q4", "d", "m")})
        else:
            out.append(w[..., start : start + n])
        start += n
    return out


def _cat_columns(ws: Sequence):
    if isinstance(ws[0], dict) and "q" in ws[0]:
        return {"q": torch.cat([w["q"] for w in ws], dim=1), "s": torch.cat([w["s"] for w in ws])}
    if isinstance(ws[0], dict):
        return {k: torch.cat([w[k] for w in ws], dim=1) for k in ("q4", "d", "m")}
    return torch.cat(list(ws), dim=-1)


def shard_lm_params(params: Dict, rank: int, parts: int, head_dim: int) -> Dict:
    """Tensor-parallel rank ``rank``'s slice (of ``parts``) of an LM param
    tree in the per-layer list layout, dense, int8 or int4, fused or not:

    - columns: ``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up``, ``lm_head`` and
      the Qwen2 biases ``bq`` / ``bk`` / ``bv`` with their columns; a fused
      ``wqkv`` (``[q | k | v]``), its ``bqkv`` and ``w_gu`` (``[gate | up]``)
      are split into their parts, each part sliced, and fused again, so the
      rank's fused leaf is ``[q_r | k_r | v_r]``;
    - rows: ``wo`` and ``w_down``;
    - whole: ``embed_tokens`` (a tied head stays whole), the norms and
      ``codec_embed``.

    The query and KV head counts (from ``wo``'s rows and the KV width over
    ``head_dim``) and the intermediate size must divide by ``parts``."""
    out = {k: v for k, v in params.items() if k not in ("layers", "lm_head")}
    layers = []
    for i, blk in enumerate(params["layers"]):
        where = f"layers.{i}"
        q_dim = _in_rows(blk["wo"])
        kv_dim = (_width(blk["wqkv"]) - q_dim) // 2 if "wqkv" in blk else _width(blk["wk"])
        _must_divide("query heads", q_dim // head_dim, parts)
        _must_divide("KV heads", kv_dim // head_dim, parts)
        nblk = {}
        for name, w in blk.items():
            if name in ("wq", "wk", "wv", "w_gate", "w_up"):
                nblk[name] = _columns(w, rank, parts, f"{where}.{name} width")
            elif name in ("bq", "bk", "bv"):
                nblk[name] = _part(w, 0, rank, parts, f"{where}.{name} width")
            elif name in ("wo", "w_down"):
                nblk[name] = _rows(w, rank, parts, f"{where}.{name} rows")
            elif name in ("wqkv", "bqkv"):
                split = _split_columns(w, (q_dim, kv_dim, kv_dim))
                pieces = [_columns(s, rank, parts, f"{where}.{name} part") if name == "wqkv"
                          else _part(s, 0, rank, parts, f"{where}.{name} part") for s in split]
                nblk[name] = _cat_columns(pieces)
            elif name == "w_gu":
                half = _width(w) // 2
                nblk[name] = _cat_columns(
                    [_columns(s, rank, parts, f"{where}.w_gu part") for s in _split_columns(w, (half, half))]
                )
            else:  # the norms
                nblk[name] = w
        layers.append(nblk)
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"] = _columns(params["lm_head"], rank, parts, "lm_head vocab")
    return out


def _local_params(params: Dict, mesh, head_dim: int, device=None) -> Dict:
    """This rank's ``shard_lm_params`` slice, moved to ``device`` when given,
    carrying its tensor-parallel group as ``params["tp"]`` when tp > 1."""
    coord = mesh_coordinate(mesh)
    tp = mesh.size(AXES.index("tp"))
    local = shard_lm_params(params, coord["tp"], tp, head_dim=head_dim)
    if device is not None:
        local = tree_map(lambda t: t.to(device), local)
    if tp > 1:
        local["tp"] = TensorParallel(mesh.get_group("tp"), tp, coord["tp"])
    return local


def shard_lm_for_inference(params: Dict, k_cache: torch.Tensor, v_cache: torch.Tensor, mesh,
                           rows_axis: Optional[str] = None):
    """Megatron-style tensor-parallel inference sharding: this rank's slice
    of ``params`` (``shard_lm_params`` at its ``tp`` index; with tp > 1 the
    slice carries its group as ``params["tp"]``, which ``models/llama``
    reads) and of the KV caches ``(L, B, S, KH, Dh)``: KH over ``tp``, and B
    over ``rows_axis`` when given (the batched engine's rows). Decode with
    ``local_lm_config(cfg, tp)``. Returns (params, k_cache, v_cache)."""
    coord = mesh_coordinate(mesh)
    tp = mesh.size(AXES.index("tp"))
    local = _local_params(params, mesh, k_cache.shape[-1])

    def kv(cache):
        cache = _part(cache, 3, coord["tp"], tp, "KV heads")
        if rows_axis is not None:
            cache = _part(cache, 1, coord[rows_axis], mesh.size(AXES.index(rows_axis)), f"batch over {rows_axis}")
        return cache

    return local, kv(k_cache), kv(v_cache)


def shard_engine_for_inference(engine, mesh):
    """Shard a ``DuplexLMEngine`` (or a ``BatchedDecodeEngine``) in place
    for tensor-parallel decode and scoring: its params and caches
    (``shard_lm_for_inference``) and its config (``local_lm_config``).
    Every rank of the group then makes the same calls (``eval``,
    ``eval_and_sample``, ``get_logprobs``...) and samples the same tokens.
    Returns the engine."""
    tp = mesh.size(AXES.index("tp"))
    cfg = local_lm_config(engine.cfg, tp)
    engine.params, engine._k, engine._v = shard_lm_for_inference(engine.params, engine._k, engine._v, mesh)
    engine.cfg = cfg
    return engine


def _row_share(batch: int, mesh, rows_axis: str):
    """(first global row, rows) of this rank's share of ``batch`` rows."""
    parts = mesh.size(AXES.index(rows_axis))
    if batch % parts != 0:
        raise ValueError(f"batch {batch} must divide over {rows_axis}={parts}")
    n = batch // parts
    return mesh_coordinate(mesh)[rows_axis] * n, n


def shard_batched_engine_for_serving(engine, mesh, rows_axis: str = "dp", timeout_s: float = 300.0):
    """Shard a ``BatchedDecodeEngine`` for multi-rank serving: its device
    rows over ``rows_axis`` (``take_rows``: cache, chained state; the host
    mirrors stay global, so each row keeps its global sampler keys and the
    tokens are the unsharded engine's), its weights Megatron-style and its
    KV heads over ``tp``. Returns the rank's
    :class:`~.serving.ShardedBatchedEngine`: rank 0 serves it (the engine's
    interface over all rows; it sends each call to the other ranks), the
    others pass it to :func:`~.serving.follow`. Call on every rank."""
    from .serving import ShardedBatchedEngine

    engine.take_rows(*_row_share(engine.batch, mesh, rows_axis))
    shard_engine_for_inference(engine, mesh)
    return ShardedBatchedEngine(engine, mesh, rows_axis, timeout_s=timeout_s)


def batched_engine_for_serving(params: Dict, cfg, mesh, batch_size: int, device, max_context: Optional[int] = None,
                               seed: int = 0, rows_axis: str = "dp", timeout_s: float = 300.0):
    """``shard_batched_engine_for_serving`` without the whole engine: from
    ``params`` on the host, only this rank's slice of the weights moves to
    ``device`` and only its rows of cache are made there: a rank's card
    holds 1 / tp of the layer weights and the head (the embeddings and
    norms whole) and 1 / (dp * tp) of the cache (the multi-rank server's
    path, serving/server.py --mesh)."""
    from ..lm.batched_engine import BatchedDecodeEngine
    from .serving import ShardedBatchedEngine

    rows = _row_share(batch_size, mesh, rows_axis)
    local_cfg = local_lm_config(cfg, mesh.size(AXES.index("tp")))
    engine = BatchedDecodeEngine(_local_params(params, mesh, cfg.head_dim, device), local_cfg, batch_size=batch_size,
                                 max_context=max_context, seed=seed, device=device, rows=rows)
    return ShardedBatchedEngine(engine, mesh, rows_axis, timeout_s=timeout_s)
