"""Voice-enrollment segment picker (port of the root
``run_enrollment_selector.py``): cut a [start, end] window (minutes.seconds
notation: 1.30 = 1m30s) out of a recording, previewing each stereo channel
separately. No model: host code only.

Headless mode writes the selected segment(s) to WAV; --ui opens the gradio
picker when gradio is installed.

    python -m realtime_codec_agent_tpu_torch.run_enrollment_selector --filename call.wav --start 0.05 --end 0.20
"""
import argparse
from typing import Optional, Tuple

import numpy as np

from .utils.audio_io import read_audio, write_wav


def minsec_to_secs(value: float) -> float:
    """1.30 -> 90 s (minutes.seconds; decimal part must be < 0.6)."""
    if value - int(value) >= 0.6:
        raise ValueError("decimal part must be < 0.6 to represent seconds (m.ss)")
    return 60 * int(value) + 100 * (value - int(value))


def select_audio(audio, start: float, end: float):
    """(sr, data) -> (selection, channel 1, channel 2)."""
    if audio is None:
        return None, None, None
    sr, data = audio
    if end > start:
        start_samples = int(minsec_to_secs(start) * sr)
        end_samples = int(minsec_to_secs(end) * sr)
        data = data[..., start_samples:end_samples] if data.ndim == 1 else data[start_samples:end_samples]
    if data.ndim == 1:
        return (sr, data), None, None
    return (sr, data), (sr, data[:, 0]), (sr, data[:, 1])


def main(argv=None):
    parser = argparse.ArgumentParser(description="Voice-enrollment segment selector")
    parser.add_argument("--filename", default=None)
    parser.add_argument("--start", type=float, default=0.0, help="m.ss notation")
    parser.add_argument("--end", type=float, default=0.0, help="m.ss notation")
    parser.add_argument("--output", default="enrollment.wav")
    parser.add_argument("--ui", action="store_true")
    args = parser.parse_args(argv)

    if args.ui:
        try:
            import gradio as gr
        except ImportError:
            raise SystemExit("gradio is not installed; run without --ui.")
        interface = gr.Interface(
            fn=select_audio,
            inputs=[
                gr.Audio(label="Input Audio"),
                gr.Number(0, minimum=0, label="Start"),
                gr.Number(0, minimum=0, label="End"),
            ],
            outputs=[
                gr.Audio(label="Selected Audio"),
                gr.Audio(label="Selected Audio (channel 1)"),
                gr.Audio(label="Selected Audio (channel 2)"),
            ],
            allow_flagging="never",
        )
        interface.launch()
        return

    if not args.filename:
        raise SystemExit("--filename is required in headless mode")
    sr, data = read_audio(args.filename)
    # read_audio returns (channels, samples); the selector works sample-major
    sel, ch1, ch2 = select_audio((sr, data.T if data.ndim > 1 else data), args.start, args.end)
    write_wav(args.output, sel[0], sel[1].T if sel[1].ndim > 1 else sel[1])
    print(f"wrote {args.output} ({sel[1].shape[0] / sr:.2f}s)")
    if ch1 is not None:
        for i, ch in enumerate((ch1, ch2), start=1):
            out = args.output.replace(".wav", f"_c{i}.wav")
            write_wav(out, ch[0], ch[1])
            print(f"wrote {out}")


if __name__ == "__main__":
    main()
