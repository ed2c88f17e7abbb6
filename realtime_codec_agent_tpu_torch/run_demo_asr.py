"""Streaming ASR demo: chunkwise probing for model-initiated transcription.

Port of the root ``run_demo_asr.py``: feed 100 ms chunks; each step,
generate the next chunk of tokens with stop="<|end_audio|>" — if the model
stops, it wants to transcribe: splice <|end_audio|>, generate the
transcription with stop="<|audio|>", then resume audio.

    python -m realtime_codec_agent_tpu_torch.run_demo_asr --in_process --audio_file in.wav
"""
import argparse

import numpy as np

from .serving.client import CompletionsClient
from .run_demo import build_client_and_tokenizer
from .utils.audio_io import read_audio


def streaming_asr(
    client: CompletionsClient,
    audio_tokenizer,
    audio,
    num_speakers: int = 2,
    seed: int = 42,
    cont_temperature: float = 1.0,
    trans_temperature: float = 0.0,
    top_p: float = 1.0,
    min_p: float = 0.0,
):
    """Yields the running sequence string after each processed chunk."""
    audio_tokenizer.reset_context()
    sr = audio_tokenizer.sampling_rate
    sequence = "<|audio_first|>"
    sequence += "".join(f"<|speaker|> {chr(ord('A') + i % 26)}" for i in range(num_speakers))
    sequence += "<|end_header|><|audio|>"

    chunk_size_secs = 0.1
    chunk = int(chunk_size_secs * sr)
    frames = int(chunk_size_secs * audio_tokenizer.framerate * audio_tokenizer.num_channels)
    transcribe_after = None
    for start in range(0, audio.shape[-1], chunk):
        input_audio_str = audio_tokenizer.tokenize_audio((sr, audio[..., start : start + chunk]))
        if transcribe_after is not None:
            sequence += f"{input_audio_str[:transcribe_after]}<|end_audio|>"
            text, _ = client.complete_with_reason(
                sequence,
                max_tokens=100,
                temperature=trans_temperature,
                top_p=top_p,
                min_p=min_p,
                seed=seed,
                stop="<|audio|>",
            )
            sequence += f"{text}<|audio|>{input_audio_str[transcribe_after:]}"
            transcribe_after = None
        else:
            sequence += input_audio_str
            # probe: does the model want to end audio within the next chunk?
            text, reason = client.complete_with_reason(
                sequence,
                max_tokens=frames,
                temperature=cont_temperature,
                top_p=top_p,
                min_p=min_p,
                seed=seed,
                stop="<|end_audio|>",
            )
            if reason == "stop":
                transcribe_after = len(text) - len(text) % audio_tokenizer.num_channels
        yield sequence


def main(argv=None):

    parser = argparse.ArgumentParser("Streaming ASR demo")
    parser.add_argument("--base_url", default="http://localhost:8000/v1")
    parser.add_argument("--in_process", action="store_true")
    parser.add_argument("--llm_model_path", default=None)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--device", default="cuda", help="the torch device (default cuda; cpu for a tiny run)")
    parser.add_argument("--stereo", action="store_true")
    parser.add_argument("--audio_file", required=True)
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)

    client, tokenizer = build_client_and_tokenizer(args)
    sr, audio = read_audio(args.audio_file, mono=tokenizer.num_channels == 1)
    sequence = None
    for sequence in streaming_asr(client, tokenizer, audio, seed=args.seed):
        pass
    print(sequence)


if __name__ == "__main__":
    main()
