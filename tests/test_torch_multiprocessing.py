"""The port's RealtimeAgentMultiprocessing: the child process that owns an
agent and its device state, on the CPU.

- Mirrors of tests/test_multiprocessing.py: the pipelined round trip (n + 1
  outputs: the priming silence and one per input, the last resolved by the
  child's idle drain), set_config_and_reset, snapshot / restore across the
  process boundary, and a dead child raising instead of hanging.
- The child against JAX: a child-hosted port agent on a JAX tiny f32
  agent's weights (converted by models/from_jax) gives the in-process JAX
  agent's sequence token for token and its audio at atol 1e-4 over 12
  seeded chunks, both pipelined and pinned to the codec region.
- The live client's protocol: 48 kHz int16 mic frames through the port's
  FastRTC handler come back from the child as audio chunks.

One module-scoped child (pinned, spawned with OMP_NUM_THREADS=1) serves
every test but the dead-child one; each test sets its own config first.
Every wait has its own deadline; teardown terminates, joins and kills."""
import contextlib
import dataclasses
import os
import threading
import time

import jax
import numpy as np
import pytest

from realtime_codec_agent_tpu.agent.agent import RealtimeAgent as JaxAgent
from realtime_codec_agent_tpu.agent.config import RealtimeAgentConfig as JaxConfig
from realtime_codec_agent_tpu.agent.resources import RealtimeAgentResources as JaxResources
from realtime_codec_agent_tpu.models import llama as jl
from realtime_codec_agent_tpu.models.codec import tiny_codec_config as jax_tiny_codec_config
from realtime_codec_agent_tpu.tokenization import CodecTextTokenizer
from realtime_codec_agent_tpu_torch import RealtimeAgentConfig, RealtimeAgentMultiprocessing
from realtime_codec_agent_tpu_torch.inference_client_fastrtc_v2 import AgentHandler
from realtime_codec_agent_tpu_torch.models import codec as tcodec
from realtime_codec_agent_tpu_torch.models import llama as tl
from realtime_codec_agent_tpu_torch.models.from_jax import codec_params_from_numpy, lm_params_from_numpy

from test_torch_pipeline import one_torch_thread  # noqa: F401  (module fixture)
from torch_mp_child import PinnedAgentProcess, pin_codec_region

CALL = dict(use_whisper=False, agent_opening_text=None, pipeline_chunks=True,
            max_inline_text_tokens=16)  # pinned sampling never samples <|audio|>: bound an event's text
JAX_CHUNKS = 12


def within(secs: float, fn, *args):
    """fn(*args) on a helper thread; fails the test after ``secs``."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(secs)
    if t.is_alive():
        pytest.fail(f"{getattr(fn, '__name__', fn)} did not return within {secs} s")
    if "err" in box:
        raise box["err"]
    return box.get("out")


def start_call(agent, config) -> None:
    """set_config_and_reset, then drop the outputs an earlier test left on
    the output queue (its feeder thread may deliver them a little late)."""
    within(30.0, agent.set_config_and_reset, config)
    for _ in range(2):
        while agent.next_output() is not None:
            pass
        time.sleep(0.2)


def collect_outputs(agent, n, timeout=60.0, real=False):
    """Up to ``n`` outputs (with ``real``, non-silent ones only) within
    ``timeout`` seconds."""
    outs, deadline = [], time.time() + timeout
    while len(outs) < n and time.time() < deadline:
        o = agent.next_output()
        if o is None:
            time.sleep(0.01)
        elif not real or np.any(o[0]):
            outs.append(o)
    return outs


@pytest.fixture(scope="module")
def jax_weights():
    """A JAX tiny f32 agent's resources and the port's kwargs over the same
    weights, converted."""
    vocab = CodecTextTokenizer(codebook_size=1024).vocab_size
    lcfg = jl.tiny_lm_config(vocab_size=vocab, codebook_size=1024, compute_dtype="float32")
    ccfg = jax_tiny_codec_config(compute_dtype="float32")
    jres = JaxResources(tiny=True, whisper_model=None, lm_config=lcfg, codec_config=ccfg, seed=0)
    kwargs = dict(
        tiny=True, device="cpu", whisper_model=None,
        _lm_params=lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jres.lm_params)),
        _codec_params=codec_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jres.audio_tokenizer.codec_model.params)),
        lm_config=tl.DuplexLMConfig(**dataclasses.asdict(lcfg)),
        codec_config=tcodec.CodecConfig(**dataclasses.asdict(ccfg)),
    )
    return jres, kwargs


@contextlib.contextmanager
def one_thread_children():
    """Children spawned inside start with OMP_NUM_THREADS=1 (torch reads it
    at start)."""
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = saved


@pytest.fixture(scope="module")
def mp_agent(jax_weights):
    with one_thread_children():
        agent = PinnedAgentProcess(wait_until_running=False, config=RealtimeAgentConfig(**CALL), **jax_weights[1])
    try:
        within(60.0, agent.wait_until_running)
        yield agent
    finally:
        agent.close(timeout=10.0)


def test_pipelined_chunks_roundtrip(mp_agent):
    start_call(mp_agent, RealtimeAgentConfig(**CALL))
    rng = np.random.default_rng(0)
    n_in = 24  # > 2.0 s of audio so the profiler emits an RTF reading
    for _ in range(n_in):
        mp_agent.queue_input((0.1 * rng.normal(size=1600)).astype(np.float32))
    # priming silence + one output per input: the final input's chunk is
    # resolved by the child's idle drain, not held until the next input
    outs = collect_outputs(mp_agent, n_in + 1)
    assert len(outs) == n_in + 1
    for audio, rtf in outs:
        assert audio.shape == (1600,)
        assert audio.dtype == np.float32
    assert any(rtf is not None for _, rtf in outs)

    info = within(30.0, mp_agent.get_info)
    assert info.total_secs == pytest.approx(n_in * 0.1, abs=1e-6)
    assert info.sampling_rate > 0 and info.chunk_size_samples == 1600
    assert info.config.pipeline_chunks


def test_set_config_and_reset(mp_agent):
    start_call(mp_agent, RealtimeAgentConfig(**CALL, seed=7))
    info = within(30.0, mp_agent.get_info)
    assert info.total_secs == 0.0
    assert info.config.seed == 7
    # the agent still serves after the reset
    mp_agent.queue_input(np.zeros(1600, dtype=np.float32))
    outs = collect_outputs(mp_agent, 1, timeout=30.0)
    assert outs and outs[0][0].shape == (1600,)


def _host_only(obj) -> bool:
    """No torch tensor anywhere in a nested container."""
    import torch

    if isinstance(obj, torch.Tensor):
        return False
    if isinstance(obj, dict):
        return all(_host_only(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(_host_only(v) for v in obj)
    return True


def test_snapshot_restore_across_process_boundary(mp_agent):
    """snapshot() quiesces the child and ships the call state (host data
    only) to the parent; restore() resumes it in the child."""
    start_call(mp_agent, RealtimeAgentConfig(**CALL))
    rng = np.random.default_rng(3)
    n_in = 6
    for _ in range(n_in):
        mp_agent.queue_input((0.1 * rng.normal(size=1600)).astype(np.float32))
    collect_outputs(mp_agent, n_in, timeout=30.0)

    snap = within(30.0, mp_agent.snapshot)
    assert snap["engine_n_tokens"] > 0
    assert _host_only(snap)
    seq_len = len(snap["input_ids"])
    assert snap["config"].pipeline_chunks

    # a reset wipes the call...
    within(30.0, mp_agent.reset)
    assert within(30.0, mp_agent.get_info).total_secs == 0.0
    # ...and restore brings it back; the call continues from the snapshot
    within(30.0, mp_agent.restore, snap)
    info = within(30.0, mp_agent.get_info)
    assert info.total_secs == pytest.approx(n_in * 0.1, abs=1e-6)
    mp_agent.queue_input(np.zeros(1600, dtype=np.float32))
    outs = collect_outputs(mp_agent, 1, timeout=30.0)
    assert outs and outs[0][0].shape == (1600,)
    # the queued chunk commits when the child's idle drain resolves it
    deadline = time.time() + 30.0
    info2 = within(30.0, mp_agent.get_info)
    while info2.total_secs <= info.total_secs and time.time() < deadline:
        time.sleep(0.05)
        info2 = within(30.0, mp_agent.get_info)
    assert len(info2.sequence) > 0
    assert info2.total_secs > info.total_secs
    # the sequence grew FROM the snapshot, not from a fresh header
    snap2 = within(30.0, mp_agent.snapshot)
    assert len(snap2["input_ids"]) > seq_len


def test_dead_child_raises_instead_of_hanging():
    """A child that crashes during startup (a nonexistent model path) must
    surface as a RuntimeError from the parent-side wait."""
    with one_thread_children():
        agent = RealtimeAgentMultiprocessing(
            wait_until_running=False, config=RealtimeAgentConfig(**CALL),
            tiny=True, whisper_model=None, device="cpu", llm_model_path="/nonexistent/model.gguf",
        )
    try:
        with pytest.raises(RuntimeError, match="child process died"):
            within(60.0, agent.wait_until_running)
    finally:
        agent.close(timeout=10.0)


def test_child_matches_jax(mp_agent, jax_weights):
    """The child-hosted port agent against the in-process JAX agent on the
    same tiny f32 weights, both pipelined and pinned, seeded at temperature
    1.0: the same sequence token for token, the same audio chunks in order
    at atol 1e-4 (f32 across frameworks)."""
    jres = jax_weights[0].clone_for_self_play()
    call = dict(CALL, temperature=1.0, seed=5)
    jagent = JaxAgent(resources=jres, config=JaxConfig(**call))
    pin_codec_region(jagent, jres)
    jagent.reset()
    rng = np.random.default_rng(11)
    audio = [(0.1 * rng.normal(size=1600)).astype(np.float32) for _ in range(JAX_CHUNKS)]
    jouts = [jagent.process_audio(c) for c in audio]
    while (tail := jagent.drain_pipeline()) is not None:
        jouts.append(tail)
    jouts = [o for o in jouts if np.any(o)]

    start_call(mp_agent, RealtimeAgentConfig(**call))
    for c in audio:
        mp_agent.queue_input(c)
    touts = [o for o, _ in collect_outputs(mp_agent, JAX_CHUNKS, timeout=60.0, real=True)]
    info = within(30.0, mp_agent.get_info)

    assert info.total_secs == pytest.approx(JAX_CHUNKS * 0.1, abs=1e-6)
    assert info.sequence == jagent.get_sequence_str()
    assert len(touts) == len(jouts) == JAX_CHUNKS
    for got, want in zip(touts, jouts):
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_fastrtc_handler_feeds_child(mp_agent):
    """The live client's path end to end: 1 s of 48 kHz int16 mic frames in
    20 ms frames through the port's AgentHandler (noise gate, streaming
    resample, 100 ms chunks) into the child, and an audio chunk back for
    every chunk the handler queued."""
    start_call(mp_agent, RealtimeAgentConfig(**CALL))
    handler = within(30.0, AgentHandler, mp_agent)
    queued = []
    real_queue_input = mp_agent.queue_input
    mp_agent.queue_input = lambda item: (queued.append(item), real_queue_input(item))
    try:
        sr = 48000
        t = np.arange(sr) / sr
        mic = (8000 * np.sin(2 * np.pi * 300 * t)).astype(np.int16)
        frame = sr // 50
        for i in range(50):
            handler.receive((sr, mic[i * frame : (i + 1) * frame]))
    finally:
        del mp_agent.queue_input
    assert len(queued) >= 9
    assert all(isinstance(c, np.ndarray) and c.shape == (1600,) for c in queued)
    got, deadline = [], time.time() + 30.0
    while len(got) < len(queued) and time.time() < deadline:
        out = handler.emit()
        if out is None:
            time.sleep(0.01)
            continue
        out_sr, audio = out
        assert out_sr == 16000 and audio.shape == (1, 1600)
        if np.any(audio):
            got.append(audio)
    assert len(got) == len(queued)
    assert np.isfinite(np.concatenate(got, axis=1)).all()
    assert within(30.0, mp_agent.get_info).total_secs == pytest.approx(len(queued) * 0.1, abs=1e-6)
