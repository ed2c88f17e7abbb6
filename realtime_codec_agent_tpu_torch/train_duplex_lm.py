"""Runnable training entry point: dataset .txt -> tokenize -> train -> eval ->
checkpoints -> deployable params, in PyTorch on one device or a mesh.

Port of the root ``train_duplex_lm.py`` (the JAX package's training CLI) with the
same flags and flow: line-per-example causal LM training, the dual-route
CodecLlama when a codec embedding file is supplied (frozen codec table +
trainable projector), a modulo streaming eval split, token-accuracy /
perplexity eval, checkpoint auto-resume, and the params (plus, with
``--persist_embeddings``, a persisted-vanilla variant) as the deployment
artifact. ``--init_from`` takes a Hugging Face Llama directory (converted,
its embeddings resized to the tokenizer's vocab) or a port checkpoint /
params dir. ``--device`` is the port's one addition: ``cuda`` (the default;
no card is an error) or ``cpu``. ``--optimizer`` takes ``adamw`` or
``adafactor``.

Under ``torchrun`` every rank joins the process group with
``--dist_backend`` (``nccl``: a card per rank; ``gloo``: ranks sharing a
card, or the CPU) and trains on the ``--mesh dp,fsdp,tp[,pp]`` mesh
(``default_mesh_shape(WORLD_SIZE)`` without ``--mesh``; pp > 1 runs the
GPipe forward with ``--pp_microbatches``, default 2 * pp); the global batch
is rounded up to a multiple of dp * fsdp and of the microbatches, as the
JAX CLI rounds it. Every rank reads the same seeded batches and takes its
rows; only rank 0 logs and writes. Without a launcher, ``--mesh`` may only
be one device.

Usage (tiny smoke on the CPU; then two ranks sharing it, tp = 2):
    python -m realtime_codec_agent_tpu_torch.train_duplex_lm \\
        --dataset output/lm_dataset.txt --output_dir output/run1 --tiny \\
        --max_steps 20 --device cpu
    torchrun --nproc_per_node=2 -m realtime_codec_agent_tpu_torch.train_duplex_lm \\
        --mesh 1,1,2 --dist_backend gloo --dataset output/lm_dataset.txt \\
        --output_dir output/run2 --tiny --max_steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the duplex codec LM (PyTorch, one device or a mesh)")
    p.add_argument("--dataset", required=True, help="prep_lm_dataset .txt output")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--tokenizer_dir", default=None,
                   help="dir with codec_tokenizer.json (default: byte-fallback tokenizer)")
    p.add_argument("--codec_embed_file", default=None,
                   help=".npy/.pt codec embedding table -> enables the dual-route "
                        "CodecLlama with a frozen codec table + trainable projector")
    p.add_argument("--init_from", default=None,
                   help="a Hugging Face checkpoint dir (config.json + weights) or a port checkpoint / "
                        "params dir to initialize from")
    p.add_argument("--tiny", action="store_true", help="tiny model (tests/smoke)")
    p.add_argument("--max_steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8, help="global batch size")
    p.add_argument("--max_seq_len", type=int, default=2048)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--optimizer", choices=["adamw", "adafactor"], default="adamw",
                   help="adafactor: optax's defaults after the global-norm clip (factored second moment)")
    p.add_argument("--remat_policy",
                   choices=["full", "dots", "attn", "flash", "none"],
                   default="flash",
                   help="selective rematerialization: 'flash' keeps B4's own residuals "
                        "(out + lse) so the backward never re-runs B4's forward; "
                        "'none' disables remat entirely")
    p.add_argument("--eval_every", type=int, default=500)
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--eval_split_every_n", type=int, default=20,
                   help="every n-th dataset line is eval (0 = no eval split)")
    p.add_argument("--shuffle_buffer", type=int, default=1024)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--mesh", default=None,
                   help="dp,fsdp,tp[,pp] mesh shape under torchrun (default: default_mesh_shape(WORLD_SIZE))")
    p.add_argument("--pp_microbatches", type=int, default=None,
                   help="GPipe microbatches when pp > 1 (default 2*pp)")
    p.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="the mesh's collectives under torchrun: nccl (a card per rank) or gloo (ranks share a "
                        "card, or the CPU)")
    p.add_argument("--compute_dtype", choices=["bfloat16", "float32"],
                   default="bfloat16",
                   help="matmul/activation dtype (float32 for CPU debugging; "
                        "the card's path is bfloat16)")
    p.add_argument("--persist_embeddings", action="store_true",
                   help="also save a persisted-vanilla params file (codec projections "
                        "baked into embed_tokens)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from realtime_codec_agent_tpu_torch.models.llama import (
        init_codec_embed_params,
        init_lm_params,
        llama32_1b_config,
        set_codec_embeddings,
        tiny_lm_config,
    )
    from realtime_codec_agent_tpu_torch.tokenization import CodecTextTokenizer
    from realtime_codec_agent_tpu_torch.train import TrainConfig, Trainer
    from realtime_codec_agent_tpu_torch.train import checkpoint as ckpt
    from realtime_codec_agent_tpu_torch.train.dataset import (
        batches_from_lines,
        iter_lines,
        repeat_batches,
        split_streaming,
    )
    from realtime_codec_agent_tpu_torch.train.embedding_bridge import (
        load_codec_embeddings,
        persist_and_verify,
    )

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_duplex_lm: --device cuda but no CUDA device is available")
    mesh, device = _mesh(args, device)
    os.makedirs(args.output_dir, exist_ok=True)

    # ---- codec embedding table ----
    codec_embed = None
    if args.codec_embed_file:
        codec_embed = load_codec_embeddings(args.codec_embed_file)

    # ---- tokenizer ----
    if args.tokenizer_dir:
        tokenizer = CodecTextTokenizer.load(args.tokenizer_dir)
    elif codec_embed is not None:
        # codec vocab sized by the embedding table (codebooks x codebook_size)
        tokenizer = CodecTextTokenizer(
            num_codebooks=codec_embed.shape[0], codebook_size=codec_embed.shape[1]
        )
    else:
        tokenizer = CodecTextTokenizer()
    vocab = ((tokenizer.vocab_size + 7) // 8) * 8  # resize pad_to_multiple_of=8

    if codec_embed is not None and (
        codec_embed.shape[0] * codec_embed.shape[1] != tokenizer.num_codec_tokens
    ):
        raise ValueError(
            f"codec embed table covers {codec_embed.shape[0] * codec_embed.shape[1]} "
            f"codes but the tokenizer has {tokenizer.num_codec_tokens} codec tokens"
        )

    # ---- model config + init ----
    cfg_kwargs = dict(
        vocab_size=vocab,
        codec_vocab_start=tokenizer.codec_vocab_start if codec_embed is not None else 0,
    )
    if codec_embed is not None:
        cfg_kwargs.update(
            num_codebooks=codec_embed.shape[0],
            codebook_size=codec_embed.shape[1],
            codebook_dim=codec_embed.shape[2],
        )
    cfg_kwargs["compute_dtype"] = args.compute_dtype
    if args.tiny:
        cfg = tiny_lm_config(max_context=args.max_seq_len, **cfg_kwargs)
    else:
        cfg = llama32_1b_config(max_context=args.max_seq_len, **cfg_kwargs)

    if args.init_from and os.path.isdir(args.init_from) and os.path.exists(
        os.path.join(args.init_from, "config.json")
    ):
        # start from a pretrained HF Llama: convert, resize to our vocab
        import dataclasses

        from realtime_codec_agent_tpu_torch.models.convert import load_hf_llama, resize_embeddings

        with torch.device(device):
            params, hf_cfg = load_hf_llama(args.init_from, max_context=args.max_seq_len)
        params, hf_cfg = resize_embeddings(params, hf_cfg, vocab, seed=args.seed)
        cfg = dataclasses.replace(
            hf_cfg,
            compute_dtype=args.compute_dtype,
            codec_vocab_start=cfg.codec_vocab_start,
            num_codebooks=cfg.num_codebooks,
            codebook_size=cfg.codebook_size,
            codebook_dim=cfg.codebook_dim,
        )
        if codec_embed is not None:
            gen = torch.Generator(device=device).manual_seed(args.seed)
            params["codec_embed"] = init_codec_embed_params(gen, cfg, device=device)
    elif args.init_from:
        params = ckpt.load_params(args.init_from, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = init_lm_params(gen, cfg, device=device, with_codec_embed=codec_embed is not None)

    if codec_embed is not None:
        # install the frozen codec table
        params = set_codec_embeddings(
            params, codec_embed.reshape(-1, codec_embed.shape[-1]), cfg
        )

    tc = TrainConfig(
        output_dir=args.output_dir,
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps,
        max_steps=args.max_steps,
        max_seq_len=args.max_seq_len,
        grad_clip=args.grad_clip,
        optimizer=args.optimizer,
        eval_every=args.eval_every,
        save_every=args.save_every,
        log_every=args.log_every,
        seed=args.seed,
        pp_microbatches=args.pp_microbatches,
        remat=args.remat_policy != "none",
        remat_policy=args.remat_policy,
    )
    trainer = Trainer(params, cfg, tc, mesh=mesh, device=device)
    del params
    writer = trainer.is_writer  # only rank 0 of a mesh logs and writes
    if writer:
        print(f"device: {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'})"
              + ("" if mesh is None else f", mesh {dict(trainer.shards.sizes)}"), file=sys.stderr)

    eval_n = args.eval_split_every_n
    train_iter = repeat_batches(
        args.dataset, tokenizer, args.batch_size, args.max_seq_len,
        shuffle_buffer=args.shuffle_buffer, seed=args.seed,
        eval_every_n=eval_n or None, is_eval=False,
    )

    def eval_batches():
        if not eval_n:
            return iter(())
        return batches_from_lines(
            split_streaming(iter_lines(args.dataset), eval_n, True),
            tokenizer, args.batch_size, args.max_seq_len,
        )

    metrics = trainer.train(
        train_iter,
        eval_batches_fn=eval_batches if eval_n else None,
        resume=not args.no_resume,
    )
    exported = trainer.export_params()  # on a mesh a collective: every rank gathers
    if not writer:
        return metrics
    print(f"final: {metrics}")

    # ---- deployment artifacts ----
    tokenizer.save(args.output_dir)
    params_path = os.path.join(args.output_dir, "params.torch")
    ckpt.save_params(params_path, exported)
    print(f"saved params -> {params_path}")
    if args.persist_embeddings and codec_embed is not None:
        vanilla, max_err = persist_and_verify(exported, cfg)
        vanilla_path = os.path.join(args.output_dir, "params-vanilla.torch")
        ckpt.save_params(vanilla_path, vanilla)
        print(f"saved persisted-vanilla params -> {vanilla_path} (max_abs_err={max_err:.2e})")
    with open(os.path.join(args.output_dir, "train_config.json"), "w") as f:
        json.dump({"metrics": metrics, "vocab_size": cfg.vocab_size,
                   "codec_vocab_start": cfg.codec_vocab_start}, f, indent=2)
    return metrics


def _mesh(args, device):
    """(the mesh, this rank's device) under a launcher (torchrun) or an
    initialized process group; (None, ``device``) without one, where
    ``--mesh`` may only be one device. Rounds ``args.batch_size`` up to
    whole rows a rank and whole microbatches, as the JAX CLI does."""
    import math

    import torch.distributed as dist

    from realtime_codec_agent_tpu_torch.parallel import default_mesh_shape, init_distributed, make_mesh, rank_device
    from realtime_codec_agent_tpu_torch.parallel.mesh import launched_world_size

    shape = None
    if args.mesh:
        factors = [int(x) for x in args.mesh.split(",")]
        if len(factors) not in (3, 4):
            raise ValueError(f"--mesh {args.mesh!r}: want dp,fsdp,tp[,pp]")
        shape = dict(zip(("dp", "fsdp", "tp", "pp"), factors))
    if launched_world_size() is None and not dist.is_initialized():
        n = math.prod(shape.values()) if shape else 1
        if n > 1:
            raise ValueError(
                f"--mesh {args.mesh} needs {n} devices, have 1: launch one process per rank with torchrun, e.g. "
                f"torchrun --nproc_per_node={n} -m realtime_codec_agent_tpu_torch.train_duplex_lm --mesh {args.mesh} "
                "--dist_backend {nccl,gloo} ...")
        return None, device
    if dist.is_initialized():
        device = rank_device(device)
    elif args.dist_backend is None:
        raise ValueError("train_duplex_lm under torchrun needs --dist_backend nccl (a card per rank) or gloo "
                         "(ranks share a card, or the CPU)")
    else:
        device = init_distributed(args.dist_backend, device)
    shape = shape or default_mesh_shape(dist.get_world_size())
    if math.prod(shape.values()) != dist.get_world_size():
        raise ValueError(f"--mesh {args.mesh} covers {math.prod(shape.values())} ranks, the launch has "
                         f"{dist.get_world_size()}")
    mesh = make_mesh(**shape)
    sizes = mesh.shape
    data_shards = sizes["dp"] * sizes["fsdp"]
    if sizes["pp"] > 1:
        n_micro = args.pp_microbatches or 2 * sizes["pp"]
        data_shards = data_shards * n_micro // math.gcd(data_shards, n_micro)
    if args.batch_size % data_shards:
        new_bs = -(-args.batch_size // data_shards) * data_shards
        if dist.get_rank() == 0:
            print(f"batch_size {args.batch_size} -> {new_bs} "
                  f"(multiple of dp*fsdp and pp microbatches = {data_shards})", file=sys.stderr)
        args.batch_size = new_bs
    return mesh, device


if __name__ == "__main__":
    main()
