"""Codec streaming round-trip demo: encode -> decode reconstruction.

Port of the root ``run_stream_codes.py``: stream audio (or an existing
codes .npy / raw code string) through chunked encode and decode with
configurable chunk sizes and crossfade joining. Headless by default (writes a
WAV).

    python -m realtime_codec_agent_tpu_torch.run_stream_codes --secs 5
    python -m realtime_codec_agent_tpu_torch.run_stream_codes --tiny --device cpu --secs 1
"""
import argparse

import numpy as np

from .audio_tokenizer import AudioTokenizer
from .models.codec import CodecConfig, TorchCodecModel, tiny_codec_config
from .units.codes import codes_to_chars
from .utils.audio_io import read_audio, write_wav
from .utils.audio_utils import create_crossfade_ramps, smooth_join


def stream_codes(
    tokenizer: AudioTokenizer,
    audio=None,
    codes_npy: str = None,
    codes_str: str = None,
    encode_chunk_secs: float = 0.1,
    decode_chunk_secs: float = 0.1,
    crossfade_secs: float = 0.02,
):
    """Returns (sr, reconstructed_audio, codes_str)."""
    tokenizer.reset_context()
    if codes_str is None:
        if codes_npy is not None:
            codes = np.load(codes_npy)
            while codes.ndim > 2:
                codes = codes[0]
            codes_str = codes_to_chars(
                codes, tokenizer.codebook_size, unicode_offset=tokenizer.unicode_offset
            )
        else:
            codes_str = tokenizer.chunked_tokenize_audio(audio, encode_chunk_secs)

    # chunked decode with crossfade joining
    sr = tokenizer.sampling_rate
    L, fade_in, fade_out = create_crossfade_ramps(sr, crossfade_secs)
    frames_per_chunk = int(decode_chunk_secs * tokenizer.framerate * tokenizer.num_channels)
    out = np.zeros(0, dtype=np.float32)
    hanging = ""
    for start in range(0, len(codes_str), frames_per_chunk):
        chunk_str = hanging + codes_str[start : start + frames_per_chunk]
        (sr, chunk_audio), hanging, preroll = tokenizer.detokenize_audio(
            chunk_str, preroll_samples=L if len(out) else 0
        )
        out = smooth_join(out, np.asarray(chunk_audio), L if len(out) else 0, fade_in, fade_out)
    return sr, out, codes_str


def main(argv=None):
    parser = argparse.ArgumentParser(description="Codec streaming round-trip check")
    parser.add_argument("--audio_file", default=None)
    parser.add_argument("--codes_npy", default=None)
    parser.add_argument("--secs", type=float, default=5.0)
    parser.add_argument("--encode_chunk_secs", type=float, default=0.1)
    parser.add_argument("--decode_chunk_secs", type=float, default=0.1)
    parser.add_argument("--crossfade_secs", type=float, default=0.02)
    parser.add_argument("--output", default="stream_codes_out.wav")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--device", default="cuda", help="the codec's torch device (default cuda; cpu for a tiny run)")
    args = parser.parse_args(argv)

    codec = TorchCodecModel.random_init(tiny_codec_config() if args.tiny else CodecConfig(), device=args.device)
    tokenizer = AudioTokenizer(codec_model=codec)

    if args.audio_file:
        sr, audio = read_audio(args.audio_file, mono=True)
        audio = (sr, audio)
    elif args.codes_npy is None:
        t = np.arange(int(args.secs * tokenizer.sampling_rate)) / tokenizer.sampling_rate
        audio = (0.2 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    else:
        audio = None

    sr, out, codes_str = stream_codes(
        tokenizer,
        audio=audio,
        codes_npy=args.codes_npy,
        encode_chunk_secs=args.encode_chunk_secs,
        decode_chunk_secs=args.decode_chunk_secs,
        crossfade_secs=args.crossfade_secs,
    )
    write_wav(args.output, sr, out)
    print(f"{len(codes_str)} codes -> {out.shape[-1]} samples -> {args.output}")


if __name__ == "__main__":
    main()
