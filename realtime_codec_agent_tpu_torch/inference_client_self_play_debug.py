"""Deterministic single-process dual-agent self-play debug client.

Port of the root ``inference_client_self_play_debug.py``, the reference's
de-facto agent regression check: both agents live IN-PROCESS
(no multiprocessing wrapper), run with fixed seeds, and cross-feed outputs
chunk by chunk (agent 1's out chunk + token ids are agent 2's input, so
re-encoding is skipped). Output is
streamed every ~2 s of conversation: per agent the stereo audio history,
formatted transcript, raw token sequence, and external-LLM messages.

Headless mode (default when gradio is absent) runs a fixed-duration
conversation and dumps all artifacts to --output_dir; with gradio installed
and --ui, the reference's interface appears.

    python -m realtime_codec_agent_tpu_torch.inference_client_self_play_debug --secs 10
    python -m realtime_codec_agent_tpu_torch.inference_client_self_play_debug --tiny --secs 1 --device cpu
"""
import argparse
import json
import os
import time

import numpy as np

from .agent.agent import RealtimeAgent
from .agent.config import RealtimeAgentConfig
from .agent.resources import RealtimeAgentResources
from .utils.audio_io import write_wav
from .utils.cli_utils import add_common_inference_args


def build_agents(args):
    resources = RealtimeAgentResources(
        llm_model_path=args.llm_model_path, tiny=args.tiny, device=getattr(args, "device", "cuda"),
    )
    pipeline = getattr(args, "pipeline", False)
    agent_1 = RealtimeAgent(
        resources=resources,
        config=RealtimeAgentConfig(
            agent_opening_text=args.opening_text, seed=args.seed, use_whisper=False,
            pipeline_chunks=pipeline,
        ),
        self_play_mode=True,
    )
    agent_2 = RealtimeAgent(
        resources=resources.clone_for_self_play(),
        config=RealtimeAgentConfig(
            agent_opening_text=None, seed=args.seed + 1, use_whisper=False,
            pipeline_chunks=pipeline,
        ),
        self_play_mode=True,
    )
    if pipeline and getattr(args, "pair", False):
        # both agents' fused chunks ride ONE batch-2 program (shared weight
        # reads); token streams are unchanged (lm/pair_session.py)
        from .lm.pair_session import pair_self_play_agents

        pair_self_play_agents(agent_1, agent_2)
    return agent_1, agent_2


def run_conversation(agent_1, agent_2, duration_secs: float, stream_every_secs: float = 2.0):
    """Cross-feed generator (reference :82-103): yields periodic snapshots
    [(sr, audio_history), transcript, sequence, llm_messages] per agent."""
    chunk = np.zeros(agent_1.chunk_size_samples, dtype=np.float32)
    out_1, ids_1 = chunk, None
    out_2, ids_2 = chunk, None
    last_stream = 0.0
    while agent_1.total_secs < duration_secs:
        out_1_, ids_1_ = agent_1.process_audio(out_2, ids_2)
        out_2, ids_2 = agent_2.process_audio(out_1, ids_1)
        out_1, ids_1 = out_1_, ids_1_
        if agent_1.total_secs >= duration_secs or (
            agent_1.total_secs - last_stream >= stream_every_secs
        ):
            snapshot = []
            for agent in (agent_1, agent_2):
                history = agent.get_audio_history()
                snapshot.append(
                    (
                        (agent.resources.audio_tokenizer.sampling_rate, history),
                        agent.format_transcript(),
                        agent.get_sequence_str(),
                        agent.get_external_llm_messages(),
                    )
                )
            yield snapshot
            last_stream = agent_1.total_secs


def main(argv=None):
    parser = argparse.ArgumentParser("Deterministic self-play debug client")
    add_common_inference_args(parser)
    parser.add_argument("--device", default="cuda", help="the torch device (default cuda; cpu for a tiny run)")
    parser.add_argument("--secs", type=float, default=10.0)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--opening_text", default="hello?")
    parser.add_argument("--output_dir", default="recordings/self_play_debug")
    parser.add_argument("--ui", action="store_true", help="gradio interface")
    parser.add_argument(
        "--pipeline", action="store_true",
        help="depth-1 pipelined chunk dispatch for both agents",
    )
    parser.add_argument(
        "--pair", action="store_true",
        help="with --pipeline: run both agents' chunks in one batch-2 device "
             "program (shared weight reads; identical tokens)",
    )
    args = parser.parse_args(argv)

    agent_1, agent_2 = build_agents(args)

    if args.ui:
        try:
            import gradio as gr
        except ImportError:
            raise SystemExit("gradio is not installed; run without --ui.")

        def run(duration):
            for snap in run_conversation(agent_1, agent_2, float(duration)):
                (a1_audio, a1_tr, a1_seq, a1_msgs), (a2_audio, a2_tr, a2_seq, a2_msgs) = snap
                yield a1_audio, a1_tr, a1_seq, json.dumps(a1_msgs), a2_audio, a2_tr, a2_seq, json.dumps(a2_msgs)

        iface = gr.Interface(
            fn=run,
            inputs=[gr.Slider(10, 600, value=60, step=10, label="Duration (seconds)")],
            outputs=[
                gr.Audio(label="Agent 1 Audio"), gr.Textbox(label="Agent 1 Transcript"),
                gr.Textbox(label="Agent 1 Sequence"), gr.Textbox(label="Agent 1 LLM Messages"),
                gr.Audio(label="Agent 2 Audio"), gr.Textbox(label="Agent 2 Transcript"),
                gr.Textbox(label="Agent 2 Sequence"), gr.Textbox(label="Agent 2 LLM Messages"),
            ],
        )
        iface.launch()
        return

    t0 = time.time()
    final = None
    for final in run_conversation(agent_1, agent_2, args.secs):
        print(f"  {agent_1.total_secs:.1f}s / {args.secs:.0f}s", flush=True)
    elapsed = time.time() - t0
    print(f"self-play {args.secs:.0f}s in {elapsed:.1f}s (RTF {elapsed / args.secs:.2f})")

    os.makedirs(args.output_dir, exist_ok=True)
    for idx, (audio, transcript, sequence, msgs) in enumerate(final, start=1):
        sr, history = audio
        write_wav(os.path.join(args.output_dir, f"agent{idx}.wav"), sr, history)
        with open(os.path.join(args.output_dir, f"agent{idx}_transcript.txt"), "w") as f:
            f.write(transcript)
        with open(os.path.join(args.output_dir, f"agent{idx}_sequence.txt"), "w") as f:
            f.write(sequence)
        with open(os.path.join(args.output_dir, f"agent{idx}_llm_messages.json"), "w") as f:
            json.dump(msgs, f, indent=2)
        print(f"agent {idx}: {transcript[:200]!r}")
    print(f"artifacts -> {args.output_dir}")


if __name__ == "__main__":
    main()
