"""Batched corpus -> codec codes encode job, in PyTorch.

Port of realtime_codec_agent_tpu/data/encode_corpus.py (the reference's
``codec_bpe.audio_to_codes`` jobs: chunk 0.1 s, context 2.0 s, batch 256,
mono + stereo outputs, .npy + codec_info.json). One job batches sliding
context windows of every file onto the codec's device: each batch is one
encoder pass of ``batch_size`` windows and one launch of kernel B1 (the
nearest-code search) over all of their frames.

Window semantics are the JAX package's: each 0.1 s chunk is encoded with
the ``context_secs`` of audio before it (zero left-padding at file start),
a window of context + chunk = 2.1 s by default. The streaming
AudioTokenizer keeps the last max(chunk, context) samples, a 2.0 s window,
so the two give the same codes only with ``context_secs=1.9``: the JAX
package's offline codes and its live codes come from different windows, and
the port keeps its reference's choice. ``context_mode="full"`` instead
encodes whole files in one pass (not streaming-equivalent).

The last batch of a file is padded with zero windows to ``batch_size``, so
every batch has the same GEMM shapes, and hence the same rounding.

Data parallel: with ``use_mesh`` (the default) under an initialized
process group of several ranks, the ranks share the corpus by files
(``my_files``: rank r takes every world-th file from the r-th), each rank
encoding whole files on its own card. The JAX package splits each window
batch over its devices instead; either way a file's codes are the
single-device codes, since every batch keeps its shape. ``main`` joins a
launcher's group with ``--dist_backend`` (``torchrun --nproc_per_node=N -m
realtime_codec_agent_tpu_torch.data.encode_corpus --dist_backend nccl
...``); rank 0 writes ``codec_info.json`` once every rank is done.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np

from ..models.codec import TorchCodecModel
from ..utils.audio_io import read_audio
from ..utils.audio_utils import resample
from .prep_channel_map import SUPPORTED_EXTENSIONS


def list_audio_files(
    audio_path: str,
    audio_filter: Optional[Sequence[str]] = None,
    extensions: Sequence[str] = SUPPORTED_EXTENSIONS,
) -> List[str]:
    if isinstance(audio_filter, str):
        audio_filter = [audio_filter]
    out = []
    for root, _, files in os.walk(audio_path):
        for fname in sorted(files):
            if not fname.lower().endswith(tuple(extensions)):
                continue
            path = os.path.join(root, fname)
            if audio_filter and not any(f in path for f in audio_filter):
                continue
            out.append(path)
    return sorted(out)


def sliding_windows(audio: np.ndarray, chunk_samples: int, context_samples: int) -> np.ndarray:
    """(T,) -> (num_chunks, context+chunk) with zero left-padding at the start."""
    t = audio.shape[-1]
    num_chunks = -(-t // chunk_samples)
    padded = np.zeros(context_samples + num_chunks * chunk_samples, dtype=np.float32)
    padded[context_samples : context_samples + t] = audio
    window = context_samples + chunk_samples
    idx = np.arange(num_chunks)[:, None] * chunk_samples + np.arange(window)[None, :]
    return padded[idx]


class CorpusEncoder:
    def __init__(
        self,
        codec_model: TorchCodecModel,
        chunk_secs: float = 0.1,
        context_secs: float = 2.0,
        batch_size: int = 256,
        context_mode: str = "sliding",
        use_mesh: bool = True,
    ):
        self.codec = codec_model
        self.sr = codec_model.sample_rate
        self.hop = codec_model.config.hop_length
        self.chunk_samples = int(chunk_secs * self.sr)
        self.context_samples = int(context_secs * self.sr)
        self.chunk_frames = self.chunk_samples // self.hop
        self.batch_size = batch_size
        self.context_mode = context_mode
        self.framerate = self.sr / self.hop
        self.rank, self.world = 0, 1
        if use_mesh:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                self.rank, self.world = dist.get_rank(), dist.get_world_size()

    def my_files(self, files: Sequence[str]) -> List[str]:
        """This rank's share of ``files``: every world-th from the rank's
        index (all of them on one rank)."""
        return list(files)[self.rank :: self.world]

    def encode_channel(self, audio: np.ndarray) -> np.ndarray:
        """(T,) float32 -> (1, F) int64 codes (num_codebooks leading dim)."""
        if self.context_mode == "full":
            codes = self.codec.encode(audio[None, :])[0]
            return codes[None, :]
        windows = sliding_windows(audio, self.chunk_samples, self.context_samples)
        n = windows.shape[0]
        parts = []
        bs = self.batch_size
        for start in range(0, n, bs):
            batch = windows[start : start + bs]
            real = batch.shape[0]
            if real < bs:
                batch = np.pad(batch, ((0, bs - real), (0, 0)))
            codes = self.codec.encode(batch)  # (bs, window_frames)
            parts.append(codes[:real, -self.chunk_frames :])
        return np.concatenate(parts, axis=None)[None, :].astype(np.int64)

    def encode_file(
        self,
        audio_file: str,
        audio_root: str,
        output_path: str,
        stereo: bool = False,
        overwrite: bool = False,
    ) -> List[str]:
        """Encode one file -> ``<root>_c<ch>.npy`` per channel. Mono downmix is
        always written as channel 0; with ``stereo=True`` each source channel
        is also encoded separately (encode_audio_stereo.sh behavior), with
        ``stereo="only"`` the source channels alone."""
        rel = os.path.relpath(audio_file, audio_root)
        rel_root = os.path.splitext(rel)[0]
        out_root = os.path.join(output_path, rel_root)
        os.makedirs(os.path.dirname(out_root), exist_ok=True)

        sr, audio = read_audio(audio_file)
        if sr != self.sr:
            audio = resample(audio, sr, self.sr)
        channels: List[np.ndarray] = []
        if audio.ndim == 1:
            channels.append(audio)
        else:
            channels.append(audio.mean(axis=0))  # mono mix
            if stereo:
                channels = list(audio) if stereo == "only" else channels + list(audio)

        written = []
        for ch, ch_audio in enumerate(channels):
            out_file = f"{out_root}_c{ch}.npy"
            if os.path.exists(out_file) and not overwrite:
                continue
            np.save(out_file, self.encode_channel(ch_audio.astype(np.float32)))
            written.append(out_file)
        return written

    def write_codec_info(self, output_path: str, codec_name: str = "rtca-tpu-codec") -> str:
        info = {
            "codec_model": codec_name,
            "num_codebooks": 1,
            "codebook_size": self.codec.codebook_size,
            "codec_framerate": self.framerate,
            "sampling_rate": self.sr,
            "chunk_secs": self.chunk_samples / self.sr,
            "context_secs": self.context_samples / self.sr,
        }
        os.makedirs(output_path, exist_ok=True)
        path = os.path.join(output_path, "codec_info.json")
        with open(path, "w") as f:
            json.dump(info, f, indent=2)
        return path


def get_codec_info(codes_path: str) -> Optional[dict]:
    path = os.path.join(codes_path, "codec_info.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def main(argv=None):
    import argparse

    import torch

    from ..models.codec import CodecConfig, tiny_codec_config

    parser = argparse.ArgumentParser(description="Batched corpus encode to codec codes")
    parser.add_argument("--audio_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--codec_checkpoint", default=None)
    parser.add_argument("--chunk_secs", type=float, default=0.1)
    parser.add_argument("--context_secs", type=float, default=2.0)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--context_mode", choices=["sliding", "full"], default="sliding")
    parser.add_argument("--stereo", action="store_true")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--audio_filter", nargs="+", default=None)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default; no card is an error) or cpu")
    parser.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                        help="share the files among the ranks of a torchrun launch (nccl: a card per rank)")
    args = parser.parse_args(argv)

    import torch.distributed as dist
    from tqdm import tqdm

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("encode_corpus: --device cuda but no CUDA device is available")
    if args.dist_backend and not dist.is_initialized():
        from ..parallel import init_distributed

        args.device = str(init_distributed(args.dist_backend, args.device))
    cfg = tiny_codec_config() if args.tiny else CodecConfig()
    if args.codec_checkpoint:
        codec = TorchCodecModel.load(args.codec_checkpoint, config=cfg, device=args.device)
    else:
        codec = TorchCodecModel.random_init(cfg, device=args.device)
    encoder = CorpusEncoder(
        codec,
        chunk_secs=args.chunk_secs,
        context_secs=args.context_secs,
        batch_size=args.batch_size,
        context_mode=args.context_mode,
    )
    files = encoder.my_files(list_audio_files(args.audio_path, args.audio_filter))
    for audio_file in tqdm(files, desc="Encoding" if encoder.world == 1 else f"Encoding (rank {encoder.rank} of {encoder.world})"):
        encoder.encode_file(
            audio_file, args.audio_path, args.output_path, stereo=args.stereo,
            overwrite=args.overwrite,
        )
    if encoder.world > 1:
        dist.barrier()
    if encoder.rank == 0:
        encoder.write_codec_info(args.output_path)


if __name__ == "__main__":
    main()
