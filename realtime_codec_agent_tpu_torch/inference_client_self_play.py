"""Dual-agent self-play client: two agents cross-feed audio.

Port of the root ``inference_client_self_play.py``: each agent's output
chunk becomes the other's input; in self-play mode process_audio also
returns the generated token ids so the receiving agent skips re-encoding.
By default each agent lives in its own child process
(``RealtimeAgentMultiprocessing``, both on ``--device`` unless
``--device_a`` / ``--device_b`` name CUDA indices); ``--inproc`` keeps both
in this process over one set of weights, ``--pair`` / ``--coord`` grouped
into one batch-2 chunk program (lm/pair_session.py). The UI emits the mixed
mean of both channels; ``--headless --secs N`` runs without gradio and
writes each agent's transcript and stereo WAV.

    python -m realtime_codec_agent_tpu_torch.inference_client_self_play --headless --secs 6 --int8
    python -m realtime_codec_agent_tpu_torch.inference_client_self_play --headless --tiny --device cpu --inproc
"""
import argparse
import os
import time

import numpy as np

from .agent.agent import RealtimeAgentMultiprocessing, RealtimeAgentMultiprocessingInfo
from .agent.config import RealtimeAgentConfig
from .utils.audio_io import write_wav
from .utils.cli_utils import add_common_inference_args


class InprocSelfPlayAgent:
    """RealtimeAgentMultiprocessing's protocol over an in-process
    RealtimeAgent, so the self-play loop and UI run either way. Both agents
    share one set of weights (resources.clone_for_self_play), each
    pipelined on its own fused chunk program (``--pair`` / ``--coord`` ride
    one batch-2 program instead)."""

    def __init__(self, agent):
        self.agent = agent
        self._outputs = []

    def queue_input(self, item) -> None:
        audio, ids = item
        t0 = time.perf_counter()
        out = self.agent.process_audio(audio, ids)
        rtf = (time.perf_counter() - t0) / self.agent.config.chunk_size_secs
        self._outputs.append((out, rtf))

    def next_output(self, block: bool = False):
        return self._outputs.pop(0) if self._outputs else None

    def get_info(self) -> RealtimeAgentMultiprocessingInfo:
        a = self.agent
        # like the child's snapshot: settle in-flight work first so the
        # transcript and sequence include every processed chunk
        a.join_detours()
        while True:
            out = a.drain_pipeline()
            if out is None:
                break
            self._outputs.append((out, None))
        return RealtimeAgentMultiprocessingInfo(
            config=a.config,
            sampling_rate=a.resources.audio_tokenizer.sampling_rate,
            chunk_size_samples=a.chunk_size_samples,
            total_secs=a.total_secs,
            transcript=a.format_transcript(),
            sequence=a.get_sequence_str(),
            audio_history=a.get_audio_history(),
            external_llm_messages=a.get_external_llm_messages(),
        )

    def close(self) -> None:
        pass


def _child_device(args, index):
    """Resources kwargs placing one child: a CUDA index, else ``--device``."""
    return {} if index is not None else {"device": args.device}


def build_agents(args):
    config_a = RealtimeAgentConfig(
        agent_opening_text=args.opening_text, seed=args.seed,
        pipeline_chunks=args.inproc,
    )
    config_b = RealtimeAgentConfig(
        agent_opening_text=None, seed=args.seed + 1,
        pipeline_chunks=args.inproc,
    )
    if args.inproc:
        from .agent.agent import RealtimeAgent
        from .agent.resources import RealtimeAgentResources
        from .lm.pair_session import pair_self_play_agents

        resources = RealtimeAgentResources(
            llm_model_path=args.llm_model_path, tiny=args.tiny, quantize_int8=args.int8, device=args.device,
        )
        agent_a = RealtimeAgent(resources=resources, config=config_a, self_play_mode=True)
        agent_b = RealtimeAgent(resources=resources.clone_for_self_play(), config=config_b, self_play_mode=True)
        if args.pair or args.coord:
            pair_self_play_agents(agent_a, agent_b)
        return InprocSelfPlayAgent(agent_a), InprocSelfPlayAgent(agent_b)
    agents = []
    for config, index in ((config_a, args.device_a), (config_b, args.device_b)):
        t0 = time.perf_counter()
        agents.append(RealtimeAgentMultiprocessing(
            config=config,
            self_play_mode=True,
            device_id=index,
            llm_model_path=args.llm_model_path,
            tiny=args.tiny,
            quantize_int8=args.int8,
            **_child_device(args, index),
        ))
        print(f"agent child {len(agents)} running after {time.perf_counter() - t0:.1f} s")
    return tuple(agents)


def self_play_loop(agent_a, agent_b, n_chunks: int, chunk_samples: int):
    """Cross-feed loop: A's out chunk (+ids) feeds B and vice versa."""
    silence = np.zeros(chunk_samples, dtype=np.float32)
    a_out, a_ids = silence, None
    mixed = []
    for _ in range(n_chunks):
        agent_b.queue_input((a_out, a_ids))
        b_out, b_ids = _next_output(agent_b)
        agent_a.queue_input((b_out, b_ids))
        a_out, a_ids = _next_output(agent_a)
        mixed.append((a_out + b_out) / 2.0)
        yield a_out, b_out, np.concatenate(mixed)


def self_play_loop_coord(agent_a, agent_b, n_chunks: int, chunk_samples: int):
    """Group-coordinated cross-feed (``--coord``): both agents dispatch into
    the shared batch-2 program before either resolves. Both sides consume
    the partner's PREVIOUS tick output (the sequential loop feeds A the
    partner's same-tick chunk), the one-chunk-stale semantics of the
    reference's queue-based cross-feed."""
    A, B = agent_a.agent, agent_b.agent
    silence = np.zeros(chunk_samples, dtype=np.float32)
    a_out, a_ids = silence, None
    b_out, b_ids = silence, None
    mixed = []
    for _ in range(n_chunks):
        A.process_audio_dispatch(b_out, b_ids)
        B.process_audio_dispatch(a_out, a_ids)
        a_out, a_ids = A.process_audio_resolve()
        b_out, b_ids = B.process_audio_resolve()
        mixed.append((a_out + b_out) / 2.0)
        yield a_out, b_out, np.concatenate(mixed)


def _next_output(agent):
    while True:
        out = agent.next_output(block=True)
        if out is not None:
            (audio, ids), _rtf = out[0], out[1]
            return audio, ids


def main(argv=None):
    """Runs self-play; headless, returns the tick seconds and the paths
    written."""
    parser = argparse.ArgumentParser(description="Dual-agent self-play")
    add_common_inference_args(parser)
    parser.add_argument("--device", default="cuda", help="the torch device (default cuda; cpu for a tiny run)")
    parser.add_argument("--device_a", type=int, default=None, help="CUDA index of agent A's child")
    parser.add_argument("--device_b", type=int, default=None, help="CUDA index of agent B's child")
    parser.add_argument("--int8", action="store_true", help="int8 decode weights")
    parser.add_argument(
        "--inproc", action="store_true",
        help="both agents in THIS process on one device, pipelined",
    )
    parser.add_argument(
        "--pair", action="store_true",
        help="with --inproc: ride both agents' fused chunks in one batch-2 program",
    )
    parser.add_argument(
        "--coord", action="store_true",
        help="with --inproc: the batch-2 pair program driven split (both agents dispatch before either resolves)",
    )
    parser.add_argument("--opening_text", default="hello?")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--headless", action="store_true")
    parser.add_argument("--secs", type=float, default=20.0)
    parser.add_argument("--output_dir", default="recordings")
    args = parser.parse_args(argv)
    if args.coord and not args.inproc:
        raise SystemExit("--coord requires --inproc")

    agent_a, agent_b = build_agents(args)
    info = agent_a.get_info()
    chunk_samples = info.chunk_size_samples
    chunk_secs = info.config.chunk_size_secs

    loop = self_play_loop_coord if args.coord else self_play_loop
    if args.headless:
        try:
            return _run_headless(args, loop, agent_a, agent_b, chunk_samples, chunk_secs)
        finally:
            agent_a.close()
            agent_b.close()

    try:
        import gradio as gr
    except ImportError:
        raise SystemExit("gradio is not installed; run with --headless.")

    with gr.Blocks() as ui:
        n_secs = gr.Number(value=30, label="seconds")
        run_btn = gr.Button("Run self-play")
        audio_out = gr.Audio(label="Conversation (mixed)")
        trans_a = gr.Textbox(label="Agent A transcript", lines=8)
        trans_b = gr.Textbox(label="Agent B transcript", lines=8)

        def run(n_secs):
            n_chunks = int(float(n_secs) / chunk_secs)
            mixed = None
            for _, _, mixed in loop(agent_a, agent_b, n_chunks, chunk_samples):
                pass
            return (
                (info.sampling_rate, mixed),
                agent_a.get_info().transcript,
                agent_b.get_info().transcript,
            )

        run_btn.click(run, inputs=[n_secs], outputs=[audio_out, trans_a, trans_b])
    ui.launch()


def _run_headless(args, loop, agent_a, agent_b, chunk_samples: int, chunk_secs: float) -> dict:
    n_chunks = int(args.secs / chunk_secs)
    ticks = []
    t0 = t1 = time.perf_counter()
    for i, _ in enumerate(loop(agent_a, agent_b, n_chunks, chunk_samples)):
        now = time.perf_counter()
        ticks.append(now - t1)
        t1 = now
        if (i + 1) % 50 == 0:
            rtf = (now - t0) / ((i + 1) * chunk_secs)
            print(f"chunk {i+1}/{n_chunks} RTF={rtf:.3f}")
    ms = np.asarray(ticks) * 1e3
    print(f"self-play {n_chunks} ticks in {time.perf_counter() - t0:.1f} s: tick p50 {np.percentile(ms, 50):.2f} ms, "
          f"p99 {np.percentile(ms, 99):.2f} ms")
    os.makedirs(args.output_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    written = {"ticks": ticks}
    for name, agent in [("a", agent_a), ("b", agent_b)]:
        inf = agent.get_info()
        path = os.path.join(args.output_dir, f"selfplay_{name}_{stamp}.txt")
        with open(path, "w") as f:
            f.write(inf.transcript)
        written[f"transcript_{name}"] = path
        if inf.audio_history.size:
            path = os.path.join(args.output_dir, f"selfplay_{name}_{stamp}.wav")
            write_wav(path, inf.sampling_rate, inf.audio_history)
            written[f"audio_{name}"] = path
    print(f"Artifacts saved under {args.output_dir}/selfplay_*_{stamp}.*")
    return written


if __name__ == "__main__":
    main()
