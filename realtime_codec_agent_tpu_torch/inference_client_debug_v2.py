"""Single-process file-driven debug client.

Port of the root ``inference_client_debug_v2.py``: loop a WAV through
``RealtimeAgent.process_audio`` chunkwise with streaming RTF plot + audio /
transcript / sequence outputs in a gradio UI. Requires gradio (imported in
``main``) and matplotlib (the plots); the headless equivalent is the
``cli_benchmark`` module.

    python -m realtime_codec_agent_tpu_torch.inference_client_debug_v2
"""
import argparse

import numpy as np

from .agent.agent import RealtimeAgent
from .agent.config import RealtimeAgentConfig
from .agent.resources import RealtimeAgentResources
from .utils.audio_io import read_audio
from .utils.audio_utils import resample
from .utils.cli_utils import add_common_inference_args


def run_agent(agent: RealtimeAgent, audio_file: str, config: RealtimeAgentConfig):
    """Generator: yields (sr, out_audio_so_far), transcript, sequence, rtf_fig
    per processed second."""
    agent.set_config(config)
    agent.reset()
    sr = agent.resources.audio_tokenizer.sampling_rate
    in_sr, audio = read_audio(audio_file, mono=True)
    audio = resample(audio, in_sr, sr)
    chunk = agent.chunk_size_samples
    out_chunks = []
    for i in range(len(audio) // chunk):
        out = agent.process_audio(audio[i * chunk : (i + 1) * chunk])
        out_chunks.append(out)
        if (i + 1) % int(1.0 / config.chunk_size_secs) == 0:
            yield (
                (sr, np.concatenate(out_chunks)),
                agent.format_transcript(),
                agent.get_sequence_str(),
                agent.profilers.build_plot(),
            )
    yield (
        (sr, np.concatenate(out_chunks)) if out_chunks else (sr, np.zeros(0, np.float32)),
        agent.format_transcript(),
        agent.get_sequence_str(),
        agent.profilers.build_plot(),
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description="File-driven debug client (gradio UI)")
    add_common_inference_args(parser)
    parser.add_argument("--device", default="cuda", help="the torch device (default cuda; cpu for a tiny run)")
    args = parser.parse_args(argv)

    try:
        import gradio as gr
    except ImportError:
        raise SystemExit(
            "gradio is not installed; use the cli_benchmark module for a headless run."
        )

    resources = RealtimeAgentResources(
        llm_model_path=args.llm_model_path, tiny=args.tiny, whisper_model=None, device=args.device,
    )
    agent = RealtimeAgent(resources=resources)

    with gr.Blocks() as demo:
        audio_in = gr.Audio(type="filepath", label="Input audio")
        temperature = gr.Slider(0.0, 2.0, value=1.0, label="temperature")
        top_k = gr.Slider(1, 500, value=100, step=1, label="top_k")
        seed = gr.Number(value=42, precision=0, label="seed")
        run_btn = gr.Button("Run")
        audio_out = gr.Audio(label="Agent output", streaming=True)
        transcript_out = gr.Textbox(label="Transcript", lines=10)
        sequence_out = gr.Textbox(label="Sequence", lines=10)
        plot_out = gr.Plot(label="Realtime factor")

        def launch(audio_file, temperature, top_k, seed):
            config = RealtimeAgentConfig(
                temperature=float(temperature), top_k=int(top_k), seed=int(seed)
            )
            yield from run_agent(agent, audio_file, config)

        run_btn.click(
            launch,
            inputs=[audio_in, temperature, top_k, seed],
            outputs=[audio_out, transcript_out, sequence_out, plot_out],
        )
    demo.launch()


if __name__ == "__main__":
    main()
