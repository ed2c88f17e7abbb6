"""Headless agent benchmark: run audio through the full-duplex loop, save RTF
plots + transcript + sequence + stereo WAV.

Port of the root ``cli_benchmark.py``: a given audio file (its user channel)
or synthetic speech-like audio, chunked at the configured cadence through
``RealtimeAgent.process_audio``. The RTF plots need matplotlib; without it
the run says so and writes the other artifacts.

    python -m realtime_codec_agent_tpu_torch.cli_benchmark --secs 20 --int8
    python -m realtime_codec_agent_tpu_torch.cli_benchmark --tiny --secs 2 --device cpu
"""
import argparse
import os
import time

import numpy as np

from .agent.agent import RealtimeAgent
from .agent.config import RealtimeAgentConfig
from .agent.resources import RealtimeAgentResources
from .utils.audio_io import read_audio, write_wav
from .utils.cli_utils import add_common_inference_args

RTF_YLIMS = [(0.5, 3.0), (0.5, 15.0), (8.0, 13.0), (0.0, 30.0)]  # the reference's plot scales


def synthetic_speech(secs: float, sr: int, seed: int = 0) -> np.ndarray:
    """Speech-shaped test signal: AM-modulated harmonics + noise bursts."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(secs * sr)) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.5 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 5))
    envelope = np.clip(np.sin(2 * np.pi * 0.8 * t + rng.uniform(0, np.pi)), 0, 1)
    noise = rng.normal(0, 0.05, t.shape)
    return (0.2 * sig * envelope + noise * envelope).astype(np.float32)


def main(argv=None) -> dict:
    """Runs the benchmark; returns the RTF and the paths written."""
    parser = argparse.ArgumentParser(description="Headless realtime agent benchmark")
    add_common_inference_args(parser)
    parser.add_argument("--audio_file", default=None, help="Input audio (default: synthetic)")
    parser.add_argument("--secs", type=float, default=20.0, help="Seconds to process")
    parser.add_argument("--output_dir", default="recordings")
    parser.add_argument("--audio_only", action="store_true",
                        help="Pin sampling to the codec region (pure-audio duplex path)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--int8", action="store_true", help="int8 decode weights")
    parser.add_argument("--device", default="cuda", help="the torch device (default cuda; cpu for a tiny run)")
    args = parser.parse_args(argv)

    resources = RealtimeAgentResources(
        llm_model_path=args.llm_model_path, tiny=args.tiny, whisper_model=None,
        quantize_int8=args.int8, device=args.device,
    )
    config = RealtimeAgentConfig(
        seed=args.seed,
        use_whisper=False,
        force_trans_after_inactivity_secs=0.0,
        force_response_after_inactivity_secs=0.0,
        agent_opening_text=None,
    )
    agent = RealtimeAgent(resources=resources, config=config)
    sr = resources.audio_tokenizer.sampling_rate

    if args.audio_file:
        in_sr, audio = read_audio(args.audio_file, mono=False)
        if audio.ndim > 1:
            audio = audio[1] if audio.shape[0] > 1 else audio[0]  # user channel
        from .utils.audio_utils import resample

        audio = resample(audio, in_sr, sr)
    else:
        audio = synthetic_speech(args.secs, sr, seed=args.seed)
    audio = audio[: int(args.secs * sr)]

    if args.audio_only:
        # keep generation in the codec region so untrained weights still
        # exercise the hot audio path deterministically
        agent.set_sampler = _audio_only_sampler(agent)
        agent.set_sampler()

    chunk = agent.chunk_size_samples
    n_chunks = len(audio) // chunk
    print(f"Processing {n_chunks} chunks of {chunk} samples ({args.secs}s)...")
    t0 = time.time()
    for i in range(n_chunks):
        agent.process_audio(audio[i * chunk : (i + 1) * chunk])
        if (i + 1) % 50 == 0:
            rtf = (time.time() - t0) / ((i + 1) * config.chunk_size_secs)
            print(f"  chunk {i+1}/{n_chunks}  cumulative RTF={rtf:.3f}")
    elapsed = time.time() - t0
    rtf = elapsed / (n_chunks * config.chunk_size_secs)
    print(f"Total: {elapsed:.1f}s for {n_chunks * config.chunk_size_secs:.1f}s audio -> RTF={rtf:.3f}")

    os.makedirs(args.output_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    written = {"rtf": rtf, "plots": []}
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("matplotlib is not installed: RTF plots skipped")
    else:
        import matplotlib.pyplot as plt

        for i, ylim in enumerate(RTF_YLIMS):
            fig = agent.profilers.build_plot(ylim=ylim)
            path = os.path.join(args.output_dir, f"rtf_{stamp}_{i}.png")
            fig.savefig(path)
            plt.close(fig)
            written["plots"].append(path)
        print(f"RTF plots written: {len(written['plots'])}")
    written["transcript"] = os.path.join(args.output_dir, f"transcript_{stamp}.txt")
    with open(written["transcript"], "w") as f:
        f.write(agent.format_transcript())
    written["sequence"] = os.path.join(args.output_dir, f"sequence_{stamp}.txt")
    with open(written["sequence"], "w") as f:
        f.write(agent.get_sequence_str())
    written["audio"] = os.path.join(args.output_dir, f"audio_{stamp}.wav")
    write_wav(written["audio"], sr, agent.get_audio_history())
    print(f"Artifacts saved under {args.output_dir}/*_{stamp}.*")
    return written


def _audio_only_sampler(agent):
    original = agent.set_sampler

    def patched(for_trans: bool = False, suppress_end_audio: bool = False):
        original(for_trans=for_trans, suppress_end_audio=suppress_end_audio)
        agent.resources.llm.settings.min_token_id = agent.resources.tokenizer.codec_vocab_start

    return patched


if __name__ == "__main__":
    main()
