"""Free audio continuation demo against the completions server.

Port of the root ``run_demo.py``: build a header + optional text/audio
prompt, stream a completion, and incrementally detokenize the generated codec
chars with crossfade joining every 2 s of audio. Headless by default (writes a
WAV); works against a running server (--base_url) or fully in-process
(--in_process, on ``--device``).

    python -m realtime_codec_agent_tpu_torch.run_demo --in_process
    python -m realtime_codec_agent_tpu_torch.run_demo --in_process --tiny --device cpu --seconds 0.5
"""
import argparse
import re

import numpy as np

from .audio_tokenizer import AudioTokenizer
from .serving.client import CompletionsClient
from .utils.audio_io import read_audio, write_wav
from .utils.audio_utils import create_crossfade_ramps, smooth_join

SHORTEN_CODES_REGEX = r"(?<=[^>]{4})[^<>]+(?=[^<]{4}<\|end_audio\|>)"


def codec_chars(text: str, audio_tokenizer) -> str:
    """The characters of ``text`` that name codec codes. The root demos keep
    every character from the codec offset up, so a completion that puts
    text bytes, or the U+FFFD of a broken byte run, between its codes (as
    untrained weights do) fails in the decode."""
    lo = audio_tokenizer.unicode_offset
    hi = lo + audio_tokenizer.num_codebooks * audio_tokenizer.codebook_size
    return "".join(c for c in text if lo <= ord(c) < hi)


def generate_audio(
    client: CompletionsClient,
    audio_tokenizer: AudioTokenizer,
    context_audio=None,
    text_prompt: str = "",
    num_speakers: int = 2,
    audio_prompt_only: bool = False,
    text_prompt_only: bool = False,
    text_prompt_first: bool = False,
    interleave_text_first: bool = False,
    seed: int = 42,
    seconds: float = 10.0,
    temperature: float = 1.0,
    top_p: float = 1.0,
    min_p: float = 0.0,
):
    """Yields (sr, completion_audio_so_far, completion_text)."""
    audio_tokenizer.reset_context()
    crossfade_ramps = create_crossfade_ramps(audio_tokenizer.sampling_rate, 0.02)

    input_audio_str = ""
    if not text_prompt_only and context_audio is not None:
        input_audio_str = (
            "<|audio|>" + audio_tokenizer.tokenize_audio(context_audio) + "<|end_audio|>"
        )
    if audio_prompt_only and text_prompt_only:
        raise ValueError("audio_prompt_only and text_prompt_only cannot both be True.")
    if not audio_prompt_only and not text_prompt_only:
        model_inputs = (
            f" {text_prompt}{input_audio_str}"
            if text_prompt_first
            else f"{input_audio_str} {text_prompt}<|audio|>"
        )
    elif audio_prompt_only:
        model_inputs = input_audio_str
    else:
        model_inputs = f" {text_prompt}<|audio|>"

    header = "<|text_first|>" if interleave_text_first else "<|audio_first|>"
    header += "".join(f"<|speaker|> {chr(ord('A') + i % 26)}" for i in range(num_speakers))
    header += "<|end_header|>"
    prompt = header + model_inputs

    completion_text = ""
    completion_audio = np.zeros((audio_tokenizer.num_channels, 0), dtype=np.float32)
    audio_str = ""
    max_tokens = int(seconds * audio_tokenizer.framerate * audio_tokenizer.num_channels)
    for chunk_text in client.stream_completion(
        prompt,
        max_tokens=max_tokens,
        temperature=temperature,
        top_p=top_p,
        min_p=min_p,
        seed=seed,
    ):
        completion_text += chunk_text
        audio_str += codec_chars(chunk_text, audio_tokenizer)
        if audio_tokenizer.get_audio_codes_str_secs(audio_str) >= 2.0:
            (_, out), audio_str, _ = audio_tokenizer.detokenize_audio(
                audio_str, preroll_samples=crossfade_ramps[0]
            )
            completion_audio = smooth_join(
                completion_audio,
                np.asarray(out).reshape(audio_tokenizer.num_channels, -1),
                *crossfade_ramps,
            )
            yield audio_tokenizer.sampling_rate, completion_audio, completion_text
    if audio_str:
        (_, out), _, _ = audio_tokenizer.detokenize_audio(
            audio_str, preroll_samples=crossfade_ramps[0]
        )
        completion_audio = smooth_join(
            completion_audio,
            np.asarray(out).reshape(audio_tokenizer.num_channels, -1),
            *crossfade_ramps,
        )
    yield audio_tokenizer.sampling_rate, completion_audio, completion_text


def build_client_and_tokenizer(args):
    if args.in_process:
        from .agent.resources import RealtimeAgentResources
        from .serving.backend import CompletionBackend

        resources = RealtimeAgentResources(
            llm_model_path=args.llm_model_path, tiny=args.tiny, whisper_model=None, device=args.device,
        )
        client = CompletionsClient(
            backend=CompletionBackend(resources.llm, resources.tokenizer)
        )
        tokenizer = resources.audio_tokenizer
    else:
        client = CompletionsClient(base_url=args.base_url)
        if client.get_model_name() is None:
            raise SystemExit(f"No completions server at {args.base_url}")
        from .models.codec import CodecConfig, TorchCodecModel, tiny_codec_config

        codec = TorchCodecModel.random_init(tiny_codec_config() if args.tiny else CodecConfig(), device=args.device)
        tokenizer = AudioTokenizer(codec_model=codec, num_channels=2 if args.stereo else 1)
    return client, tokenizer


def main(argv=None):

    parser = argparse.ArgumentParser("Audio generation demo")
    parser.add_argument("--base_url", default="http://localhost:8000/v1")
    parser.add_argument("--in_process", action="store_true")
    parser.add_argument("--llm_model_path", default=None)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--device", default="cuda", help="the torch device (default cuda; cpu for a tiny run)")
    parser.add_argument("--stereo", action="store_true")
    parser.add_argument("--context_audio", default=None)
    parser.add_argument("--text_prompt", default=" A: hello there!")
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--output", default="demo_out.wav")
    args = parser.parse_args(argv)

    client, tokenizer = build_client_and_tokenizer(args)
    context = read_audio(args.context_audio) if args.context_audio else None
    final = None
    for final in generate_audio(
        client,
        tokenizer,
        context_audio=context,
        text_prompt=args.text_prompt,
        seconds=args.seconds,
        seed=args.seed,
    ):
        pass
    sr, audio, text = final
    write_wav(args.output, sr, audio if audio.ndim == 1 else audio[0])
    print(re.sub(SHORTEN_CODES_REGEX, ".........", text))
    print(f"Wrote {audio.shape[-1]} samples to {args.output}")


if __name__ == "__main__":
    main()
