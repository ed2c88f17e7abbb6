"""Live WebRTC microphone/speaker client.

Port of the root ``inference_client_fastrtc_v2.py``: mic frames are
buffered into 100 ms chunks (with an int16 noise gate), queued into the agent
child process, and the agent's output chunks are emitted back over WebRTC with
a live RTF readout; UI sliders map 1:1 onto RealtimeAgentConfig; on shutdown
the transcript / token sequence / external-LLM messages / stereo session WAV
are dumped to recordings/. Requires fastrtc + gradio (imported in ``main``).

The handler queues each chunk as the bare float32 array, which is what the
child's ``process_audio(chunk)`` takes. (The root client queues
``(sampling_rate, chunk)``, which the JAX child unpacks into
``process_audio(16000, chunk)``: its shape check fails, and the live loop
prints the error and emits nothing.)

    python -m realtime_codec_agent_tpu_torch.inference_client_fastrtc_v2
"""
import argparse
import os
import time

import numpy as np

from .agent.agent import RealtimeAgentMultiprocessing
from .agent.config import RealtimeAgentConfig
from .utils.audio_io import write_wav
from .utils.cli_utils import add_common_inference_args

NOISE_GATE = 100  # int16 amplitude below which mic frames count as silence


class AgentHandler:
    """Stream handler bridging WebRTC frames <-> the agent process queues."""

    def __init__(self, agent: RealtimeAgentMultiprocessing):
        self.agent = agent
        info = agent.get_info()
        self.sampling_rate = info.sampling_rate
        self.chunk_size_samples = info.chunk_size_samples
        self.buffer = np.zeros(0, dtype=np.float32)  # at codec rate
        self.last_rtf = None
        self._resampler = None
        self._resampler_sr = None

    def receive(self, frame):
        sr, audio = frame
        audio = audio.reshape(-1)
        if np.abs(audio).max() < NOISE_GATE:
            audio = np.zeros_like(audio)
        audio = audio.astype(np.float32) / 32768.0
        if sr != self.sampling_rate:
            # stateful streaming resample (native C++ core when built): filter
            # history carries across mic frames, so there is no per-chunk seam
            if self._resampler is None or self._resampler_sr != sr:
                from .utils.native_audio import StreamingResampler

                self._resampler = StreamingResampler(sr, self.sampling_rate)
                self._resampler_sr = sr
            audio = self._resampler.process(audio)
        self.buffer = np.concatenate([self.buffer, audio])
        while len(self.buffer) >= self.chunk_size_samples:
            self.agent.queue_input(self.buffer[: self.chunk_size_samples].copy())
            self.buffer = self.buffer[self.chunk_size_samples :]

    def emit(self):
        out = self.agent.next_output()
        if out is None:
            return None
        audio, rtf = out
        self.last_rtf = rtf
        return (self.sampling_rate, audio.reshape(1, -1))

    def dump_artifacts(self, output_dir: str = "recordings"):
        info = self.agent.get_info()
        os.makedirs(output_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        with open(os.path.join(output_dir, f"transcript_{stamp}.txt"), "w") as f:
            f.write(info.transcript)
        with open(os.path.join(output_dir, f"sequence_{stamp}.txt"), "w") as f:
            f.write(info.sequence)
        if info.external_llm_messages:
            import json

            with open(os.path.join(output_dir, f"external_llm_{stamp}.json"), "w") as f:
                json.dump(info.external_llm_messages, f, indent=2)
        if info.audio_history.size:
            write_wav(
                os.path.join(output_dir, f"audio_{stamp}.wav"),
                info.sampling_rate,
                info.audio_history,
            )
        # live-call checkpoint: resume later with --resume_snapshot
        try:
            import pickle

            with open(os.path.join(output_dir, f"snapshot_{stamp}.pkl"), "wb") as f:
                pickle.dump(self.agent.snapshot(), f)
        except Exception as ex:  # external streams / mid-event: best-effort
            print(f"snapshot dump skipped: {ex!r}")


CONFIG_CONTROLS = [
    # (field, kind, params) -> one UI control per RealtimeAgentConfig knob
    ("agent_opening_text", "text", {}),
    ("agent_identity", "text", {}),
    ("user_identity", "text", {}),
    ("temperature", "slider", dict(minimum=0.0, maximum=2.0)),
    ("trans_temperature", "slider", dict(minimum=0.0, maximum=2.0)),
    ("top_k", "number", {}),
    ("top_p", "slider", dict(minimum=0.0, maximum=1.0)),
    ("min_p", "slider", dict(minimum=0.0, maximum=1.0)),
    ("repeat_penalty", "slider", dict(minimum=0.5, maximum=2.0)),
    ("presence_penalty", "slider", dict(minimum=-2.0, maximum=2.0)),
    ("frequency_penalty", "slider", dict(minimum=-2.0, maximum=2.0)),
    ("seed", "number", {}),
    ("max_context_secs", "number", {}),
    ("trim_by_secs", "number", {}),
    ("target_volume_rms", "slider", dict(minimum=0.0, maximum=0.2)),
    ("force_trans_after_inactivity_secs", "number", {}),
    ("force_response_after_inactivity_secs", "number", {}),
    ("finalize_response_after_inactivity_secs", "number", {}),
    ("finalize_response_improbable_token_tolerance", "number", {}),
    ("use_whisper", "checkbox", {}),
    ("pipeline_chunks", "checkbox", {}),
    ("async_detours", "checkbox", {}),
    ("incremental_trim", "checkbox", {}),
    ("use_external_llm", "checkbox", {}),
    ("external_llm_base_url", "text", {}),
    ("external_llm_model", "text", {}),
    ("external_llm_top_p", "slider", dict(minimum=0.0, maximum=1.0)),
    ("external_llm_instructions", "text", {}),
    ("use_external_tts", "checkbox", {}),
    ("external_tts_server_url", "text", {}),
    ("constrain_allow_noise", "checkbox", {}),
    ("constrain_allow_breathing", "checkbox", {}),
    ("constrain_allow_laughter", "checkbox", {}),
]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Live FastRTC duplex client")
    add_common_inference_args(parser)
    parser.add_argument("--device", default="cuda", help="the torch device of the agent's child (default cuda)")
    parser.add_argument(
        "--resume_snapshot", default=None, metavar="PKL",
        help="resume a previous call from a recordings/snapshot_*.pkl "
        "(bit-identical continuation; weights must match)",
    )
    args = parser.parse_args(argv)

    try:
        import gradio as gr
        from fastrtc import ReplyOnPause, Stream, StreamHandler  # noqa: F401
    except ImportError:
        raise SystemExit(
            "fastrtc/gradio are not installed; use the cli_benchmark module (headless) "
            "or inference_client_self_play instead."
        )

    # live deployment defaults: pipelined fused chunks (one chunk of added
    # response latency; the device work overlaps the host's), background
    # event resolution with silence filler, and incremental trim rebuilds —
    # no chunk call blocks past the budget (see RealtimeAgentConfig)
    agent = RealtimeAgentMultiprocessing(
        config=RealtimeAgentConfig(
            pipeline_chunks=True, async_detours=True, incremental_trim=True
        ),
        llm_model_path=args.llm_model_path,
        tiny=args.tiny,
        device=args.device,
    )
    if args.resume_snapshot:
        import pickle

        with open(args.resume_snapshot, "rb") as f:
            agent.restore(pickle.load(f))
        print(f"resumed call from {args.resume_snapshot}")
    handler = AgentHandler(agent)
    defaults = RealtimeAgentConfig(
        pipeline_chunks=True, async_detours=True, incremental_trim=True
    )

    with gr.Blocks() as ui:
        controls = {}
        with gr.Accordion("Agent configuration", open=False):
            for field, kind, params in CONFIG_CONTROLS:
                value = getattr(defaults, field)
                if kind == "slider":
                    controls[field] = gr.Slider(value=value or 0.0, label=field, **params)
                elif kind == "number":
                    controls[field] = gr.Number(value=value, label=field)
                elif kind == "checkbox":
                    controls[field] = gr.Checkbox(value=bool(value), label=field)
                else:
                    controls[field] = gr.Textbox(value=value or "", label=field)
        apply_btn = gr.Button("Apply + reset")
        rtf_box = gr.Textbox(label="Realtime factor")

        def apply_config(*values):
            kwargs = dict(zip([f for f, _, _ in CONFIG_CONTROLS], values))
            agent.set_config_and_reset(RealtimeAgentConfig(**kwargs))
            return "config applied"

        apply_btn.click(apply_config, inputs=list(controls.values()), outputs=[rtf_box])

    # WebRTC stream wiring is fastrtc-version-specific; see the fastrtc docs.
    print("UI ready; wire handler.receive/emit into a fastrtc Stream for live audio.")
    ui.launch()


if __name__ == "__main__":
    main()
