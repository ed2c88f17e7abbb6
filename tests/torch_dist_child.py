"""Gloo rank pools for tests/test_torch_parallel.py and
tests/test_torch_mesh_train.py, and the tasks their ranks run.

A ``RankPool`` spawns ``world`` processes (spawn context, one torch thread
each) that join one gloo process group on a free localhost port, then run
the tasks the parent sends them, every rank the same task (SPMD). Every wait
is bounded: a task's results must arrive within its deadline, every
collective within the group's timeout, and ``close`` terminates, joins and
kills. This module imports no JAX: the spawned children import it, and the
parent hands them numpy arrays.
"""
from __future__ import annotations

import os
import queue
import signal
import socket
import threading
import time
import traceback

import numpy as np

GROUP_TIMEOUT_S = 60.0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class RankPool:
    def __init__(self, world: int, start_timeout: float = 60.0):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        port = _free_port()
        self.world = world
        self.inboxes = [ctx.Queue() for _ in range(world)]
        self.outbox = ctx.Queue()
        saved = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            self.procs = [
                ctx.Process(target=_worker, args=(r, world, port, self.inboxes[r], self.outbox), daemon=True)
                for r in range(world)
            ]
            for p in self.procs:
                p.start()
        finally:
            if saved is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = saved
        self.run("ready", timeout=start_timeout)

    def run(self, task: str, *args, timeout: float = 90.0) -> list:
        """``task(*args)`` on every rank; the results in rank order. Raises
        with the rank's traceback when one fails, and after ``timeout``."""
        for box in self.inboxes:
            box.put((task, args))
        results, errors = {}, {}
        deadline = time.time() + timeout
        while len(results) + len(errors) < self.world:
            left = deadline - time.time()
            if left <= 0:
                raise TimeoutError(f"{task}: {len(results)} of {self.world} ranks answered within {timeout} s")
            try:
                rank, ok, value = self.outbox.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs) if not p.is_alive()]
                if dead:
                    raise RuntimeError(f"{task}: rank(s) {dead} died")
                continue
            (results if ok else errors)[rank] = value
        if errors:
            raise RuntimeError(f"{task} failed on rank(s) {sorted(errors)}:\n" + "\n".join(errors.values()))
        return [results[r] for r in range(self.world)]

    def close(self) -> None:
        for box in self.inboxes:
            box.put(None)
        for p in self.procs:
            p.join(timeout=10)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)


def _worker(rank: int, world: int, port: int, inbox, outbox) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch

    torch.set_num_threads(1)
    from realtime_codec_agent_tpu_torch.parallel import init_distributed

    init_distributed("gloo", "cpu", timeout_s=GROUP_TIMEOUT_S)
    while True:
        item = inbox.get()
        if item is None:
            break
        task, args = item
        try:
            outbox.put((rank, True, TASKS[task](*args)))
        except BaseException:  # noqa: BLE001 - reported to the parent
            outbox.put((rank, False, f"rank {rank}:\n{traceback.format_exc()}"))
    import torch.distributed as dist

    dist.destroy_process_group()


# ------------------------------------------------------------------- tasks

def _port_params(params_np, quant: str, fuse: bool):
    from realtime_codec_agent_tpu_torch.models import llama as tl
    from realtime_codec_agent_tpu_torch.models.from_jax import lm_params_from_numpy

    params = lm_params_from_numpy(params_np)
    if quant == "int8":
        params = tl.quantize_params_int8(params)
    if fuse:
        params = tl.fuse_lm_params_for_decode(params)
    return params


def tp_engine(params_np, cfg_kw, quant="none", fuse=False):
    """Mirror of the JAX tests/test_train.py TP cases on a (1, 1, world)
    mesh: a DuplexLMEngine sharded for tensor-parallel decode; greedy tokens
    after a 20-token eval, and logprobs of a cacheless scoring call. Every
    rank makes the same calls; each returns what it saw."""
    from realtime_codec_agent_tpu_torch.lm.engine import DuplexLMEngine
    from realtime_codec_agent_tpu_torch.models.llama import DuplexLMConfig
    from realtime_codec_agent_tpu_torch.parallel import make_mesh, shard_engine_for_inference

    import torch.distributed as dist

    cfg = DuplexLMConfig(**cfg_kw)
    eng = DuplexLMEngine(_port_params(params_np, quant, fuse), cfg, seed=3, device="cpu")
    eng.init_sampler_for_generate(temp=0.0, seed=3)
    shard_engine_for_inference(eng, make_mesh(dp=1, fsdp=1, tp=dist.get_world_size()))
    eng.eval(list(range(2, 22)))
    toks = [eng.eval_and_sample([t]) for t in (22, 23, 24)]
    lp = eng.get_logprobs(list(range(2, 22)), [5, 6])
    return {"tokens": toks, "logprobs": np.asarray(lp), "kv_heads": int(eng._k.shape[3]),
            "heads": eng.cfg.num_heads, "tp": repr(eng.params.get("tp"))}


def batched(params_np, cfg_kw, prompts, dp, tp, batch, temps=(0.0,), steps=4, rounds=2, build="shard"):
    """The JAX test_sharded_batched_serving_token_identical drive on a
    (dp, 1, tp) mesh: rank 0 leads, the others follow. ``build``: "shard"
    slices a whole engine (shard_batched_engine_for_serving), "host" builds
    the rank's engine from the params (batched_engine_for_serving). Returns
    rank 0's tokens (rows x steps * rounds)."""
    from realtime_codec_agent_tpu_torch.lm.batched_engine import BatchedDecodeEngine
    from realtime_codec_agent_tpu_torch.models.llama import DuplexLMConfig
    from realtime_codec_agent_tpu_torch.parallel import (
        batched_engine_for_serving, follow, make_mesh, shard_batched_engine_for_serving,
    )

    cfg = DuplexLMConfig(**cfg_kw)
    mesh = make_mesh(dp=dp, fsdp=1, tp=tp)
    params = _port_params(params_np, "none", False)
    if build == "host":
        sharded = batched_engine_for_serving(params, cfg, mesh, batch, "cpu", max_context=256,
                                             timeout_s=GROUP_TIMEOUT_S)
    else:
        eng = BatchedDecodeEngine(params, cfg, batch_size=batch, max_context=256, seed=0, device="cpu")
        sharded = shard_batched_engine_for_serving(eng, mesh, timeout_s=GROUP_TIMEOUT_S)
    eng = sharded.local
    if not sharded.is_leader:
        return {"applied": follow(sharded), "rows": (eng.row0, eng.local_rows), "kv_heads": int(eng._k.shape[3])}
    try:
        for row, p in enumerate(prompts):
            sharded.set_row_sampler(row, temp=temps[row % len(temps)])  # unseeded: the global row's key
            sharded.prefill_row(row, p)
        outs = [[] for _ in prompts]
        for _ in range(rounds):
            tokens = sharded.step([True] * batch, steps=steps)
            for r in range(len(prompts)):
                outs[r].extend(tokens[r])
    finally:
        sharded.stop()
    return {"tokens": outs, "rows": (eng.row0, eng.local_rows), "kv_heads": int(eng._k.shape[3])}


def must_divide(params_np, cfg_kw, dp, tp, batch):
    """shard_batched_engine_for_serving's refusal where dp does not divide
    the batch (raised on every rank before any collective)."""
    from realtime_codec_agent_tpu_torch.lm.batched_engine import BatchedDecodeEngine
    from realtime_codec_agent_tpu_torch.models.llama import DuplexLMConfig
    from realtime_codec_agent_tpu_torch.parallel import make_mesh, shard_batched_engine_for_serving

    eng = BatchedDecodeEngine(_port_params(params_np, "none", False), DuplexLMConfig(**cfg_kw), batch_size=batch,
                              max_context=256, seed=0, device="cpu")
    mesh = make_mesh(dp=dp, fsdp=1, tp=tp)
    try:
        shard_batched_engine_for_serving(eng, mesh)
    except ValueError as e:
        return str(e)
    return None


def serve(argv, prompt, max_tokens):
    """``server.main(argv)`` on every rank (argv carries --mesh): rank 0
    takes a free port, a helper thread posts one greedy completion once the
    server answers, then SIGTERMs its own process, which stops the server
    and the followers. Rank 0 returns the text."""
    import torch.distributed as dist

    from realtime_codec_agent_tpu_torch.serving import server
    from realtime_codec_agent_tpu_torch.serving.client import CompletionsClient

    if dist.get_rank() != 0:
        server.main(argv)
        return None
    port = _free_port()
    box = {}

    def ask():
        client = CompletionsClient(base_url=f"http://127.0.0.1:{port}/v1", timeout=30.0)
        deadline = time.time() + 60.0
        while time.time() < deadline:
            try:
                box["text"] = client.complete(prompt, max_tokens=max_tokens, temperature=0.0)
                break
            except OSError:
                time.sleep(0.2)
        os.kill(os.getpid(), signal.SIGTERM)

    threading.Thread(target=ask, daemon=True).start()
    server.main(argv + ["--host", "127.0.0.1", "--port", str(port)])
    if "text" not in box:
        raise RuntimeError("the meshed server never answered")
    return box["text"]


def encode_corpus(audio_root, out_dir, batch_size):
    """The corpus encode shared over the ranks (``CorpusEncoder.my_files``)
    with the tiny codec from its seed, then a barrier; returns the files
    this rank wrote."""
    import torch.distributed as dist

    from realtime_codec_agent_tpu_torch.data.encode_corpus import CorpusEncoder, list_audio_files
    from realtime_codec_agent_tpu_torch.models.codec import TorchCodecModel, tiny_codec_config

    enc = CorpusEncoder(TorchCodecModel.random_init(tiny_codec_config(), device="cpu"), batch_size=batch_size)
    written = []
    for f in enc.my_files(list_audio_files(audio_root)):
        written += enc.encode_file(f, audio_root, out_dir, stereo=True)
    dist.barrier()
    if enc.rank == 0:
        enc.write_codec_info(out_dir)
    return {"rank": enc.rank, "world": enc.world, "written": sorted(os.path.basename(w) for w in written)}


# ------------------------------------------------------- mesh training tasks

def _mesh(shape):
    """``make_mesh(**shape)`` (every rank of the pool builds it), or None on
    a rank outside it."""
    from realtime_codec_agent_tpu_torch.parallel import make_mesh

    mesh = make_mesh(**shape)
    return mesh if mesh.coordinate is not None else None


def _grads_np(shards, named):
    """Every leaf's reduced gradient, gathered to the global tensor
    (collective), as numpy by dotted path."""
    shards.reduce_grads(named)
    return {p: shards.full(shards.specs[p], t.grad).numpy() for p, t in named}


def mesh_loss_grads(params_np, cfg_kw, batch, labels, shape, microbatches=None, remat=False):
    """JAX's test_pipeline_matches_scan_forward on a rank: the stacked params
    sharded over ``shape`` (the layer axis over pp when pp > 1), the rank's
    rows through ``loss_and_metrics`` (the GPipe forward with pp > 1), the
    backward and the gradient sums; returns the loss, the fewest rows a
    stage's layers ran on, and, on rank 0, every gathered gradient and the
    leaves' local shapes."""
    import dataclasses

    import torch
    from realtime_codec_agent_tpu_torch.models import llama as tl
    from realtime_codec_agent_tpu_torch.models.from_jax import lm_params_from_numpy
    from realtime_codec_agent_tpu_torch.parallel import local_lm_config, make_pipeline_forward, shard_params
    from realtime_codec_agent_tpu_torch.parallel.mesh import param_leaves
    from realtime_codec_agent_tpu_torch.train import loss_and_metrics
    from realtime_codec_agent_tpu_torch.utils.tree import tree_leaves

    mesh = _mesh(shape)
    if mesh is None:
        return None
    pp = shape.get("pp", 1)
    params = shard_params(tl.stack_layer_params(lm_params_from_numpy(params_np)), mesh, pp=pp > 1)
    shards = params["mesh"]
    named = [(p, t.requires_grad_(True)) for p, t in tree_leaves(param_leaves(params))]
    cfg = local_lm_config(dataclasses.replace(tl.DuplexLMConfig(**cfg_kw), remat=remat), shape.get("tp", 1))
    fwd = make_pipeline_forward(mesh, microbatches) if pp > 1 else tl.forward
    start, n = shards.rows(len(batch))
    run_layers, rows_seen = tl.run_layers, []

    def counted(x, *a, **k):
        rows_seen.append(x.shape[0])
        return run_layers(x, *a, **k)

    tl.run_layers = counted
    try:
        loss, metrics = loss_and_metrics(params, torch.from_numpy(batch[start : start + n]),
                                         torch.from_numpy(labels[start : start + n]), cfg, forward_fn=fwd)
        loss.backward()
    finally:
        tl.run_layers = run_layers
    grads = _grads_np(shards, named)
    out = {"loss": float(loss.detach()), "n_tokens": int(metrics["n_tokens"]), "min_rows": min(rows_seen)}
    if shards.writer:
        out["grads"] = grads
        out["local_shapes"] = {p: tuple(t.shape) for p, t in named}
    return out


def pipeline_errors(params_np, cfg_kw, shape, microbatches):
    """JAX's test_pipeline_forward_validations: a batch that does not divide
    the microbatches, and a mesh with no pp axis."""
    import torch
    from realtime_codec_agent_tpu_torch.models import llama as tl
    from realtime_codec_agent_tpu_torch.models.from_jax import lm_params_from_numpy
    from realtime_codec_agent_tpu_torch.parallel import local_lm_config, make_pipeline_forward, shard_params

    mesh = _mesh(shape)
    fwd = make_pipeline_forward(mesh, microbatches)
    params = shard_params(tl.stack_layer_params(lm_params_from_numpy(params_np)), mesh, pp=True)
    cfg = local_lm_config(tl.DuplexLMConfig(**cfg_kw), shape["tp"])
    errors = []
    try:
        fwd(params, torch.zeros((4 // shape["dp"], 8), dtype=torch.int64), cfg)
    except ValueError as e:
        errors.append(str(e))
    try:
        make_pipeline_forward(_mesh(dict(dp=2, fsdp=2, tp=2)), 2)
    except ValueError as e:
        errors.append(str(e))
    return errors


def _trainer(params_np, cfg_kw, tc_kw, shape):
    from realtime_codec_agent_tpu_torch.models.from_jax import lm_params_from_numpy
    from realtime_codec_agent_tpu_torch.models.llama import DuplexLMConfig
    from realtime_codec_agent_tpu_torch.train import TrainConfig, Trainer

    mesh = _mesh(shape)
    if mesh is None:
        return None
    return Trainer(lm_params_from_numpy(params_np), DuplexLMConfig(**cfg_kw), TrainConfig(**tc_kw), mesh=mesh,
                   device="cpu")


def _report(tr, metrics) -> dict:
    """A trainer's metrics, its resident bytes (params and optimizer state
    at rest) and, on rank 0, its gathered params and state as numpy (the
    gathers are collectives: every rank makes them)."""
    params = tr.global_params()
    state = tr.opt_state
    out = {
        "metrics": metrics, "step": tr.step,
        "resident": {"params": sum(t.numel() * t.element_size() for _, t in tr._leaves),
                     "state": sum(v.numel() * v.element_size() for st in tr.optimizer.state.values()
                                  for v in st.values())},
    }
    if tr.is_writer:
        out["params"] = {p: _numpy(t) for p, t in _leaves_np(params).items()}
        out["opt_state"] = {k: {p: _numpy(t) for p, t in v.items()} if isinstance(v, dict) else v
                            for k, v in state.items()}
    return out


def mesh_train(params_np, cfg_kw, tc_kw, shape, batches, ckpt_dir=None):
    """A Trainer on ``shape`` steps through the global ``batches`` (every
    rank is handed the same), then saves a checkpoint in ``ckpt_dir`` when
    given. Returns ``_report``'s."""
    from realtime_codec_agent_tpu_torch.train import checkpoint as ckpt

    tr = _trainer(params_np, cfg_kw, tc_kw, shape)
    if tr is None:
        return None
    metrics = [tr.train_batch(b, l) for b, l in batches]
    if ckpt_dir is not None:
        ckpt.save(ckpt_dir, tr)
    return _report(tr, metrics)


def mesh_resume(params_np, cfg_kw, tc_kw, shape, ckpt_dir, batches):
    """A Trainer on ``shape`` from other params (``params_np``), restored
    from ``ckpt_dir``, then steps through ``batches``; ``_report``'s with
    the restored step and the params right after the restore."""
    from realtime_codec_agent_tpu_torch.train import checkpoint as ckpt

    tr = _trainer(params_np, cfg_kw, tc_kw, shape)
    if tr is None:
        return None
    if not ckpt.restore_latest(ckpt_dir, tr):
        raise RuntimeError(f"no checkpoint under {ckpt_dir}")
    restored = tr.global_params()
    out = _report(tr, [tr.train_batch(b, l) for b, l in batches])
    out["restored_step"] = out["step"] - len(batches)
    if tr.is_writer:
        out["restored"] = {p: _numpy(t) for p, t in _leaves_np(restored).items()}
    return out


def _numpy(t):
    import torch

    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _leaves_np(tree):
    from realtime_codec_agent_tpu_torch.utils.tree import tree_leaves

    return dict(tree_leaves(tree))


def mesh_cli(argv):
    """``train_duplex_lm.main(argv)`` on every rank (argv carries --mesh)."""
    from realtime_codec_agent_tpu_torch import train_duplex_lm

    return train_duplex_lm.main(argv)


FORBIDDEN = ("all_gather", "all_gather_into_tensor", "reduce_scatter", "reduce_scatter_tensor", "send", "recv",
             "isend", "irecv", "all_to_all", "all_to_all_single", "batch_isend_irecv")


def guarded(task, *args):
    """``task(*args)`` with every collective gloo cannot take on CUDA
    tensors made to raise (in ``torch.distributed`` and in
    ``distributed_c10d``, where it is defined), so the CPU runs the route
    the card runs."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    saved = [(mod, name, getattr(mod, name)) for mod in (dist, c10d) for name in FORBIDDEN if hasattr(mod, name)]

    def refuse(name):
        def call(*a, **k):
            raise RuntimeError(f"torch.distributed.{name} was called: gloo cannot take it on CUDA tensors")
        return call

    try:
        for mod, name, _ in saved:
            setattr(mod, name, refuse(name))
        return TASKS[task](*args)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


TASKS = {
    "ready": lambda: os.getpid(),
    "mesh_loss_grads": mesh_loss_grads,
    "pipeline_errors": pipeline_errors,
    "mesh_train": mesh_train,
    "mesh_resume": mesh_resume,
    "mesh_cli": mesh_cli,
    "guarded": guarded,
    "tp_engine": tp_engine,
    "batched": batched,
    "must_divide": must_divide,
    "serve": serve,
    "encode_corpus": encode_corpus,
}
