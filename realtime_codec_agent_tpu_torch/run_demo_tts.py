"""Line-by-line TTS demo: synthesize audio for each transcript line.

Port of the root ``run_demo_tts.py``: text-first sequence, one completion
per line with stop="<|end_audio|>", hanging channel codes carried into the
next line's prompt.

    python -m realtime_codec_agent_tpu_torch.run_demo_tts --in_process
"""
import argparse
import re

import numpy as np

from .serving.client import CompletionsClient
from .run_demo import build_client_and_tokenizer, codec_chars
from .utils.audio_io import read_audio, write_wav


def streaming_tts(
    client: CompletionsClient,
    audio_tokenizer,
    transcript: str,
    context_audio=None,
    seed: int = 42,
    temperature: float = 1.0,
    top_p: float = 1.0,
    min_p: float = 0.0,
):
    """Yields (sr, synthesized_audio_so_far, sequence) per transcript line."""
    audio_tokenizer.reset_context()
    num_speakers = len(set(re.findall("[A-Z]: ", transcript)))
    lines = [l.strip() for l in transcript.split("\n") if l.strip()]

    sequence = "<|text_first|>"
    sequence += "".join(f"<|speaker|> {chr(ord('A') + i % 26)}" for i in range(num_speakers))
    sequence += "<|end_header|>"
    if context_audio is not None:
        sequence += "<|audio|>" + audio_tokenizer.tokenize_audio(context_audio) + "<|end_audio|>"

    out_audio = np.zeros((audio_tokenizer.num_channels, 0), dtype=np.float32)
    end_hanging = ""
    for line in lines:
        sequence += f" {line}<|audio|>{end_hanging}"
        text, _ = client.complete_with_reason(
            sequence,
            max_tokens=1024 * audio_tokenizer.num_channels,
            temperature=temperature,
            top_p=top_p,
            min_p=min_p,
            seed=seed,
            presence_penalty=0.5,
            frequency_penalty=0.5,
            stop="<|end_audio|>",
        )
        (_, chunk), end_hanging, _ = audio_tokenizer.detokenize_audio(end_hanging + codec_chars(text, audio_tokenizer))
        sequence += text[: (-len(end_hanging) or None)] + "<|end_audio|>"
        out_audio = np.concatenate(
            (out_audio, np.asarray(chunk).reshape(audio_tokenizer.num_channels, -1)), axis=-1
        )
        yield audio_tokenizer.sampling_rate, out_audio, sequence


def main(argv=None):

    parser = argparse.ArgumentParser("Streaming TTS demo")
    parser.add_argument("--base_url", default="http://localhost:8000/v1")
    parser.add_argument("--in_process", action="store_true")
    parser.add_argument("--llm_model_path", default=None)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--device", default="cuda", help="the torch device (default cuda; cpu for a tiny run)")
    parser.add_argument("--stereo", action="store_true")
    parser.add_argument("--transcript", default="A: hello there!\nB: hi how are you?")
    parser.add_argument("--context_audio", default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--output", default="tts_out.wav")
    args = parser.parse_args(argv)

    client, tokenizer = build_client_and_tokenizer(args)
    context = read_audio(args.context_audio) if args.context_audio else None
    final = None
    for final in streaming_tts(client, tokenizer, args.transcript, context, seed=args.seed):
        pass
    sr, audio, sequence = final
    write_wav(args.output, sr, audio if audio.ndim > 1 else audio)
    print(f"Wrote {audio.shape[-1]} samples to {args.output}")


if __name__ == "__main__":
    main()
