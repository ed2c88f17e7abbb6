"""Device mesh, tensor-parallel inference and sharded training, on
torch.distributed.

Port of realtime_codec_agent_tpu/parallel/mesh.py: ``make_mesh``,
``default_mesh_shape``, ``shard_lm_for_inference`` and
``shard_batched_engine_for_serving`` (serving), and ``lm_param_specs``,
``batch_spec``, ``shard_params`` and their inverse ``gather_params``
(training), with the same layouts: for serving, Megatron's (the attention
and MLP input projections and the ``lm_head`` split over ``tp`` by columns,
``wo`` and ``w_down`` by rows, the KV cache over KV heads, the batched
engine's rows over ``dp``); for training, JAX's ``lm_param_specs`` (below).

How the two packages differ: JAX shards by compute-follows-data under one
controller. Its arrays are global, a ``NamedSharding`` says where their
pieces live, XLA inserts the collectives, and one process drives every
device. PyTorch runs one process per rank. Each rank holds only its local
slice (``shard_lm_for_inference`` and ``shard_params`` return it), and the
collectives are explicit: ``models/llama`` sums the row-parallel partial
products and gathers the vocab shards over the group its params carry
(parallel/collectives.TensorParallel). Every rank of a group makes the same
calls (SPMD). The batched server has a leader: rank 0 runs the backend and
broadcasts each call that changes device state to the followers, which run
``follow`` (parallel/serving.py). ``batched_engine_for_serving`` builds a
rank's engine from params on the host: its card holds only its slice of the
weights and its rows of the cache.

Training (``shard_params``): a rank holds, at rest, the ``lm_param_specs``
slice of every leaf of the stacked layout (the layer axis over ``pp`` when
pp > 1) and of its optimizer moments; :class:`Shards` (under
``params["mesh"]``) does the rest. A leaf split over ``fsdp`` is gathered
at use (``gather``, inside the remat region, so the full weight is
transient); ``tp`` is Megatron's, with *f* and *g* (parallel/collectives);
the embedding, its vocab split over (tp, fsdp), is never gathered: every
fsdp rank's ids are looked up in the rank's shard, masked, and summed over
fsdp and tp (``embed``); the head is gathered over fsdp once a loss, and
its columns over tp never are (the loss is vocab-parallel,
train/trainer.py). The batch rows go over (dp, fsdp) (``batch_spec``).
After the backward, ``reduce_grads`` sums each gradient over the batch axes
the leaf is not split over (the backward of an fsdp-split leaf's gather, or
of the embedding's sum, already summed it over fsdp) and over ``pp`` for
the leaves every
stage holds, so each gradient counts once; norms and Adafactor's means sum
over a leaf's shards. Two leaves are held otherwise than JAX's specs, for
the same math: Qwen2's ``bq`` / ``bk`` / ``bv`` go with their columns over
``tp`` (JAX replicates them and slices at use), and the codec projectors
stay whole over ``tp`` (JAX splits ``w1`` / ``b1`` / ``b2`` and ``w2``'s
columns over ``tp``; a few million weights against Megatron sums around
their GELU); ``w2`` keeps its rows over ``fsdp``.

The backend is explicit (``init_distributed``): ``nccl`` when each rank
owns a card, ``gloo`` on the CPU and for several ranks sharing one card.
Nothing switches backend because another one failed.
"""
from __future__ import annotations

import dataclasses
import os
import socket
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.tree import tree_leaves, tree_map, tree_map_with_path
from .collectives import TensorParallel, gather_axis, group_stack, group_sum, reduce_sum, sum_slice

AXES = ("dp", "fsdp", "tp", "pp")
BACKENDS = ("nccl", "gloo")
LAUNCH_HINT = (
    "launch one process per rank with torchrun, e.g. torchrun --nproc_per_node=<dp*tp> -m "
    "realtime_codec_agent_tpu_torch.serving.server --mesh <dp>x<tp> --dist_backend {nccl,gloo} ..."
)
_DEVICE = {}  # the device init_distributed bound this process to, and its groups' timeout


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
    elif backend == "nccl":
        raise ValueError(f"init_distributed: nccl needs CUDA devices, not {device}")
    if launched:
        dist.init_process_group(backend, timeout=timedelta(seconds=timeout_s))
    else:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1,
                                timeout=timedelta(seconds=timeout_s))
    _DEVICE["device"] = device
    _DEVICE["timeout"] = timedelta(seconds=timeout_s)
    return device


def rank_device(device="cuda") -> torch.device:
    """The device a rank computes on: for a bare "cuda", the card
    ``init_distributed`` bound this process to; else ``device``."""
    device = torch.device(device)
    bound = _DEVICE.get("device")
    if device.type == "cuda" and device.index is None and bound is not None and bound.type == "cuda":
        return bound
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, fsdp, tp, pp) mesh over ranks of the default group:
    ``shape`` (ranks along each of ``AXES``), this rank's ``coordinate``
    (None for a rank outside the mesh) and ``axis_groups``, this rank's
    group along each axis of more than one rank, bounded by
    ``init_distributed``'s timeout."""

    shape: Dict[str, int]
    coordinate: Optional[Dict[str, int]]
    axis_groups: Dict[str, object]

    def size(self, axis: str) -> int:
        return self.shape[axis]


def make_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1, pp: int = 1) -> Mesh:
    """The :class:`Mesh` of shape (dp, fsdp, tp, pp) over the first
    dp * fsdp * tp * pp ranks of the initialized default group, in rank
    order (tp and pp innermost, as the JAX mesh lays out devices). Every
    rank of the group calls it."""
    if not dist.is_initialized():
        raise RuntimeError(f"make_mesh: no process group (init_distributed first); {LAUNCH_HINT}")
    n = dp * fsdp * tp * pp
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp}x{pp} needs {n} devices, have {world}")
    ranks = torch.arange(n).reshape(dp, fsdp, tp, pp)
    me = dist.get_rank()
    at = (ranks == me).nonzero()
    coordinate = dict(zip(AXES, at[0].tolist())) if len(at) else None
    return Mesh(dict(zip(AXES, ranks.shape)), coordinate, _axis_groups(ranks))


def _axis_groups(ranks: torch.Tensor) -> Dict[str, object]:
    """This rank's group along each axis of more than one rank. Every rank
    of the world makes every group, in one order (``new_group``'s rule),
    with ``init_distributed``'s timeout."""
    me = dist.get_rank()
    out = {}
    for i, a in enumerate(AXES):
        if ranks.shape[i] > 1:
            for row in ranks.movedim(i, -1).reshape(-1, ranks.shape[i]).tolist():
                group = dist.new_group(row, timeout=_DEVICE.get("timeout"))
                if me in row:
                    out[a] = group
    return out


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
    if mesh.coordinate is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {tuple(mesh.shape.values())}")
    return dict(mesh.coordinate)


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
    tp = mesh.size("tp")
    local = shard_lm_params(params, coord["tp"], tp, head_dim=head_dim)
    if device is not None:
        local = tree_map(lambda t: t.to(device), local)
    if tp > 1:
        local["tp"] = TensorParallel(mesh.axis_groups["tp"], tp, coord["tp"])
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
    tp = mesh.size("tp")
    local = _local_params(params, mesh, k_cache.shape[-1])

    def kv(cache):
        cache = _part(cache, 3, coord["tp"], tp, "KV heads")
        if rows_axis is not None:
            cache = _part(cache, 1, coord[rows_axis], mesh.size(rows_axis), f"batch over {rows_axis}")
        return cache

    return local, kv(k_cache), kv(v_cache)


def shard_engine_for_inference(engine, mesh):
    """Shard a ``DuplexLMEngine`` (or a ``BatchedDecodeEngine``) in place
    for tensor-parallel decode and scoring: its params and caches
    (``shard_lm_for_inference``) and its config (``local_lm_config``).
    Every rank of the group then makes the same calls (``eval``,
    ``eval_and_sample``, ``get_logprobs``...) and samples the same tokens.
    Returns the engine."""
    tp = mesh.size("tp")
    cfg = local_lm_config(engine.cfg, tp)
    engine.params, engine._k, engine._v = shard_lm_for_inference(engine.params, engine._k, engine._v, mesh)
    engine.cfg = cfg
    return engine


def _row_share(batch: int, mesh, rows_axis: str):
    """(first global row, rows) of this rank's share of ``batch`` rows."""
    parts = mesh.size(rows_axis)
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
    local_cfg = local_lm_config(cfg, mesh.size("tp"))
    engine = BatchedDecodeEngine(_local_params(params, mesh, cfg.head_dim, device), local_cfg, batch_size=batch_size,
                                 max_context=max_context, seed=seed, device=device, rows=rows)
    return ShardedBatchedEngine(engine, mesh, rows_axis, timeout_s=timeout_s)


# ---------------------------------------------------------------------------
# Training: the lm_param_specs layout, a rank's slice and its groups
# ---------------------------------------------------------------------------

class P:
    """A leaf's partition spec as data (JAX's ``PartitionSpec``): for each
    array axis, None (whole), a mesh axis, or a tuple of mesh axes (the
    first major); axes past the last entry are whole."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = entries

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes array axis ``dim`` is split over, major first."""
        entry = self.entries[dim] if dim < len(self.entries) else None
        if entry is None:
            return ()
        return (entry,) if isinstance(entry, str) else tuple(entry)

    def without(self, dim: int) -> "P":
        """The spec of a reduction over array axis ``dim``."""
        entries = list(self.entries) + [None] * max(0, dim + 1 - len(self.entries))
        return P(*(entries[:dim] + entries[dim + 1 :]))

    def __repr__(self) -> str:
        return f"P{self.entries}"


def _layer_specs(keys=None) -> Dict[str, P]:
    specs = {
        "attn_norm": P(),
        "wq": P("fsdp", "tp"),
        "wk": P("fsdp", "tp"),
        "wv": P("fsdp", "tp"),
        "wo": P("tp", "fsdp"),
        "mlp_norm": P(),
        "w_gate": P("fsdp", "tp"),
        "w_up": P("fsdp", "tp"),
        "w_down": P("tp", "fsdp"),
        # Qwen2-family q/k/v biases go with their columns (JAX: replicated)
        "bq": P("tp"),
        "bk": P("tp"),
        "bv": P("tp"),
    }
    if keys is None:
        return specs
    return {k: specs[k] for k in keys}


def lm_param_specs(params, pp: bool = False) -> Dict:
    """The :class:`P` tree matching models/llama.py's param layout (the
    per-layer list or the stacked layout, whose leading layer axis is whole,
    or over ``pp`` with ``pp=True``: stage s holds its L/pp contiguous
    layers). JAX's ``lm_param_specs`` but for the two leaves the module
    docstring names."""
    if isinstance(params["layers"], dict):
        layer_specs = {
            k: P("pp" if pp else None, *spec.entries) for k, spec in _layer_specs(params["layers"].keys()).items()
        }
    else:
        layer_specs = [_layer_specs(blk.keys()) for blk in params["layers"]]
    specs = {
        # vocab over (tp, fsdp), hidden whole (JAX's layout)
        "embed_tokens": P(("tp", "fsdp"), None),
        "layers": layer_specs,
        "final_norm": P(),
    }
    if "lm_head" in params:
        specs["lm_head"] = P("fsdp", "tp")
    if "codec_embed" in params:
        specs["codec_embed"] = {
            "table": P("fsdp", None),
            "projectors": [{"w1": P(), "b1": P(), "w2": P("fsdp", None), "b2": P()}
                           for _ in params["codec_embed"]["projectors"]],
        }
    return specs


def batch_spec() -> P:
    """The batch rows over (dp, fsdp), in mesh order."""
    return P(("dp", "fsdp"), None)


GROUP_KEYS = ("tp", "mesh")  # the non-tensor entries shard_params adds to a param tree


def param_leaves(params) -> Dict:
    """``params`` without the groups ``shard_params`` adds."""
    return {k: v for k, v in params.items() if k not in GROUP_KEYS}


class Shards:
    """A training rank's place in a (dp, fsdp, tp, pp) mesh: its
    coordinate, its groups, the spec of every leaf (by dotted path) and the
    collectives training issues over them. ``shard_params`` puts it under
    ``params["mesh"]``. Every rank of a group makes the same calls."""

    def __init__(self, mesh, specs):
        self.coord = mesh_coordinate(mesh)
        self.sizes = dict(mesh.shape)
        self.groups = mesh.axis_groups
        self.device = _DEVICE.get("device", torch.device("cpu"))
        self.specs = dict(tree_leaves(specs))
        layers = specs["layers"]
        # a per-layer leaf's spec: the stacked one without its layer axis
        self._layer = ({k: s.without(0) for k, s in layers.items()} if isinstance(layers, dict)
                       else dict(layers[0]) if layers else {})
        self.tp = TensorParallel(self.groups["tp"], self.sizes["tp"], self.coord["tp"]) if "tp" in self.groups else None
        self.stage, self.stages = self.coord["pp"], self.sizes["pp"]
        self.loss_stage = self.stage == self.stages - 1  # the pipeline's last stage computes the loss
        self.writer = all(c == 0 for c in self.coord.values())

    def __repr__(self) -> str:
        return f"Shards({self.sizes}, at {self.coord})"

    # -- layout ---------------------------------------------------------------
    def _index(self, axes) -> Tuple[int, int]:
        idx, parts = 0, 1
        for a in axes:
            idx, parts = idx * self.sizes[a] + self.coord[a], parts * self.sizes[a]
        return idx, parts

    def split_axes(self, spec: P) -> Tuple[str, ...]:
        """The mesh axes of more than one rank that ``spec`` splits over."""
        return tuple(a for d in range(len(spec.entries)) for a in spec.axes(d) if a in self.groups)

    def local(self, spec: P, t: torch.Tensor, what: str = "leaf") -> torch.Tensor:
        """This rank's slice of the global ``t``."""
        for dim in range(len(spec.entries)):
            idx, parts = self._index(spec.axes(dim))
            if parts > 1:
                t = _part(t, dim, idx, parts, f"{what} axis {dim}")
        return t.contiguous()

    def full(self, spec: P, t: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's ``t`` (a collective, no
        gradient): each split axis gathered, its minor mesh axis first."""
        with torch.no_grad():
            for dim in range(len(spec.entries)):
                for a in reversed(spec.axes(dim)):
                    if a in self.groups:
                        t = gather_axis(t, dim, self.groups[a], self.sizes[a], self.coord[a])
        return t

    def to_host(self, spec: P, t: torch.Tensor) -> Optional[torch.Tensor]:
        """``full`` (a collective) moved to the writer's host at once, None
        on the other ranks: a card holds one gathered leaf at a time."""
        t = self.full(spec, t)
        return t.cpu() if self.writer else None

    def global_shape(self, spec: P, shape) -> Tuple[int, ...]:
        return tuple(n * self._index(spec.axes(d))[1] for d, n in enumerate(shape))

    # -- the forward ------------------------------------------------------------
    def _gather_fsdp(self, spec: P, t: torch.Tensor) -> torch.Tensor:
        if "fsdp" not in self.groups:
            return t
        for dim in range(len(spec.entries)):
            if "fsdp" in spec.axes(dim):
                return gather_axis(t, dim, self.groups["fsdp"], self.sizes["fsdp"], self.coord["fsdp"])
        return t

    def gather(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """Leaf ``path`` for use: gathered over fsdp where it is split over
        it (its tp split stays: the compute is Megatron's)."""
        return self._gather_fsdp(self.specs[path], t)

    def layer(self, blk: Dict, keys) -> Dict:
        """The per-layer leaves ``keys`` of ``blk`` (those it holds), for use."""
        return {k: self._gather_fsdp(self._layer[k], blk[k]) for k in keys if k in blk}

    def embed(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of the embedding, whose vocab is split over (tp,
        fsdp) and of which ``table`` is this rank's shard: every fsdp rank's
        ids looked up in the shard, masked to the ids it holds, summed over
        fsdp (each rank keeping its own rows: ``sum_slice``) and over tp.
        Only (rows, T, hidden) activations cross ranks, never the table."""
        idx, parts = self._index(self.specs["embed_tokens"].axes(0))
        if parts == 1:
            return table[ids]
        fsdp = "fsdp" in self.groups
        every = group_stack(ids, self.groups["fsdp"], self.sizes["fsdp"], self.coord["fsdp"]) if fsdp else ids[None]
        n = table.shape[0]
        local = every - idx * n
        rows = table[torch.clamp(local, 0, n - 1)]
        rows = torch.where(((local >= 0) & (local < n))[..., None], rows, torch.zeros_like(rows))
        rows = sum_slice(rows, 0, self.groups["fsdp"], self.sizes["fsdp"], self.coord["fsdp"]) if fsdp else rows
        return rows[0] if self.tp is None else self.tp.all_reduce(rows[0])

    def rows(self, n: int) -> Tuple[int, int]:
        """(first row, rows) of this rank's share of a global batch of ``n``
        rows (``batch_spec``)."""
        idx, parts = self._index(batch_spec().axes(0))
        if n % parts:
            raise ValueError(f"batch {n} must divide over dp*fsdp={parts}")
        return idx * (n // parts), n // parts

    # -- reductions ---------------------------------------------------------------
    def sum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``x`` summed over the groups of ``axes``, in place, no gradient."""
        for a in axes:
            if a in self.groups:
                group_sum(x, self.groups[a])
        return x

    def token_totals(self, loss_sum, n_valid, correct):
        """The loss stage's sums over the batch axes (the loss sum through
        *g*: each rank's gradient is its own rows'), then, with pp > 1, the
        totals on every stage (values only: the gradient stays the loss
        stage's)."""
        if self.loss_stage:
            for a in ("dp", "fsdp"):
                if a in self.groups:
                    loss_sum = reduce_sum(loss_sum, self.groups[a])
                    n_valid = group_sum(n_valid.clone(), self.groups[a])
                    correct = group_sum(correct.clone(), self.groups[a])
        if "pp" in self.groups:
            g = self.groups["pp"]
            total = group_sum(loss_sum.detach().clone(), g)
            loss_sum = loss_sum + (total - loss_sum.detach())
            n_valid = group_sum(n_valid.clone(), g)
            correct = group_sum(correct.clone(), g)
        return loss_sum, n_valid, correct

    def reduce_grads(self, named) -> None:
        """Each ``(path, tensor)``'s gradient summed over the batch axes it
        is not split over (an fsdp-split leaf's was summed over fsdp by its
        gather's backward) and over ``pp`` where every stage holds it; a
        missing gradient counts as zeros."""
        for path, t in named:
            g = torch.zeros_like(t) if t.grad is None else t.grad
            split = self.specs[path]
            split = {a for d in range(len(split.entries)) for a in split.axes(d)}
            self.sum(g, [a for a in ("dp", "fsdp", "pp") if a not in split])
            t.grad = g

    def norm(self, named) -> torch.Tensor:
        """The global norm of ``(path, tensor)`` pairs, summed in f32: each
        leaf's square over its shards, the leaves in order."""
        return torch.sqrt(sum(
            self.sum(torch.sum(torch.square(t.to(torch.float32))), self.split_axes(self.specs[p])) for p, t in named
        ))

    def barrier(self) -> None:
        """Every rank of the mesh got here (a sum over each axis's group in
        turn; bounded by the groups' timeout)."""
        for a in AXES:
            if a in self.groups:
                group_sum(torch.zeros(1, device=self.device), self.groups[a])


def shard_params(params: Dict, mesh, pp: bool = False, device=None) -> Dict:
    """This rank's slice of ``params`` (``lm_param_specs(params, pp)``),
    moved to ``device`` when given, carrying its groups: ``params["mesh"]``
    (:class:`Shards`) and, with tp > 1, ``params["tp"]``. Raises where an
    axis does not divide a leaf, and for pp > 1 unless the layers are
    stacked."""
    specs = lm_param_specs(params, pp=pp)
    shards = Shards(mesh, specs)
    if "pp" in shards.groups and not (pp and isinstance(params["layers"], dict)):
        raise ValueError("a pp mesh needs the stacked layout sharded over pp (shard_params(..., pp=True))")

    def one(path, t):
        t = shards.local(shards.specs[path], t, path)
        return t if device is None else t.to(device)

    local = tree_map_with_path(one, param_leaves(params))
    local["mesh"] = shards
    if shards.tp is not None:
        local["tp"] = shards.tp
    return local


def gather_params(params: Dict) -> Optional[Dict]:
    """The global tree from every rank's ``shard_params`` slice (a
    collective: every rank of the mesh calls it), detached, on the host of
    the mesh's rank 0, None on the others. Each leaf moves to the host as
    soon as it is gathered (``Shards.to_host``)."""
    shards = params["mesh"]
    tree = tree_map_with_path(lambda path, t: shards.to_host(shards.specs[path], t.detach()), param_leaves(params))
    return tree if shards.writer else None
