"""External-TTS client sanity demo (port of the root
``run_demo_external_tts.py``): enrollment audio + prompt text -> per-line
target text synthesized through the TTS server's codec-chunk stream, decoded
and crossfade-joined locally on ``--device``.

Headless mode (default without gradio): --target_text in, WAV out. With
gradio installed and --ui, the reference interface appears.

    python -m realtime_codec_agent_tpu_torch.run_demo_external_tts --server_url http://127.0.0.1:8001
"""
import argparse
from typing import Optional, Tuple

import numpy as np

from .agent.external_tts_client import ExternalTTSClient
from .audio_tokenizer import AudioTokenizer
from .models.codec import TorchCodecModel, tiny_codec_config
from .utils.audio_io import read_audio, write_wav
from .utils.audio_utils import create_crossfade_ramps, smooth_join


def tts_pipeline(
    audio_tokenizer: AudioTokenizer,
    server_url: str,
    enrollment_audio: Optional[Tuple[int, np.ndarray]],
    enrollment_prompt_text: Optional[str],
    target_text: str,
) -> Optional[Tuple[int, np.ndarray]]:
    """Stream each line of target text through the TTS server; decode chunk
    strings and crossfade-join."""
    tts_client = ExternalTTSClient(server_url=server_url)
    tts_client.set_voice_enrollment(enrollment_audio, enrollment_prompt_text)
    target_texts = [t.strip() for t in target_text.split("\n") if t.strip()]
    crossfade_ramps = create_crossfade_ramps(audio_tokenizer.sampling_rate, fade_secs=0.02)
    audio_chunks = []
    for text in target_texts:
        tts_client.prep_stream(text)
        while True:
            chunk_str = tts_client.next_chunk()
            if chunk_str is None:
                break
            (_, chunk), _, _ = audio_tokenizer.detokenize_audio(
                chunk_str, preroll_samples=crossfade_ramps[0]
            )
            if audio_chunks:
                chunk_len = audio_chunks[-1].shape[-1]
                joined = smooth_join(audio_chunks[-1], chunk, *crossfade_ramps)
                audio_chunks[-1] = joined[:chunk_len]
                chunk = joined[chunk_len:]
            audio_chunks.append(chunk)
    if not audio_chunks:
        return None
    return audio_tokenizer.sampling_rate, np.concatenate(audio_chunks, axis=-1)


def main(argv=None):
    parser = argparse.ArgumentParser(description="External TTS pipeline demo")
    parser.add_argument("--server_url", default="http://127.0.0.1:8001")
    parser.add_argument("--codec_checkpoint", default=None)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--device", default="cuda", help="the codec's torch device (default cuda; cpu for a tiny run)")
    parser.add_argument("--enrollment_audio", default=None)
    parser.add_argument("--enrollment_text", default=None)
    parser.add_argument("--target_text", default="hello there.\nhow are you today?")
    parser.add_argument("--output", default="tts_demo_out.wav")
    parser.add_argument("--ui", action="store_true")
    args = parser.parse_args(argv)

    if args.codec_checkpoint:
        codec = TorchCodecModel.load(args.codec_checkpoint, device=args.device)
    else:
        codec = TorchCodecModel.random_init(tiny_codec_config() if args.tiny else None, device=args.device)
    at = AudioTokenizer(codec_model=codec)

    if args.ui:
        try:
            import gradio as gr
        except ImportError:
            raise SystemExit("gradio is not installed; run without --ui.")

        demo = gr.Interface(
            fn=lambda audio, prompt, text: tts_pipeline(at, args.server_url, audio, prompt, text),
            inputs=[
                gr.Audio(label="Enrollment Audio"),
                gr.Textbox(label="Enrollment Prompt Text", lines=2),
                gr.Textbox(label="Target Text to Synthesize", lines=4),
            ],
            outputs=[gr.Audio(label="Generated Audio")],
            title="TTS Client",
        )
        demo.launch(server_name="0.0.0.0", server_port=7860)
        return

    enrollment = None
    if args.enrollment_audio:
        sr, data = read_audio(args.enrollment_audio, mono=True)
        enrollment = (sr, data)
    result = tts_pipeline(at, args.server_url, enrollment, args.enrollment_text, args.target_text)
    if result is None:
        print("no audio generated")
        return
    sr, audio = result
    write_wav(args.output, sr, audio)
    print(f"wrote {args.output} ({audio.shape[-1] / sr:.2f}s)")


if __name__ == "__main__":
    main()
