"""Live-call snapshot and restore on the port's agent
(``RealtimeAgent.snapshot`` / ``from_snapshot`` / ``restore_state``).

Mirrors tests/test_snapshot.py on the port (tiny f32 models, each agent on
its own resources over the same weights):

- a restored call's future tokens and audio are bit for bit the
  uninterrupted call's, without trims and across trims; the snapshot
  survives pickling (it is the migration wire format);
- a snapshot taken while an incremental trim rebuild is in flight restores
  (the trim completes at the restore), and two restores continue alike;
- a busy agent is refused, a quiescent one is not.

Against the JAX package: the port's call, snapshotted after 14 chunks and
restored into fresh resources, continues token for token as the JAX
agent's uninterrupted call on the same converted weights, with Whisper on
and the bench's forced events (the restored call transcribes the same
channel-2 window: the snapshot carries that history).
"""
import pickle

import jax
import numpy as np
import pytest

from realtime_codec_agent_tpu.agent.agent import RealtimeAgent as JaxAgent
from realtime_codec_agent_tpu.agent.asr import JaxWhisperASR
from realtime_codec_agent_tpu.agent.config import RealtimeAgentConfig as JaxConfig
from realtime_codec_agent_tpu.models import whisper as JW
from realtime_codec_agent_tpu_torch.agent.agent import RealtimeAgent
from realtime_codec_agent_tpu_torch.agent.asr import TorchWhisperASR
from realtime_codec_agent_tpu_torch.agent.config import RealtimeAgentConfig
from realtime_codec_agent_tpu_torch.models import whisper as TW
from realtime_codec_agent_tpu_torch.models.from_jax import whisper_params_from_jax
from tests.test_torch_asr import WordsTokenizer, colon_first
from tests.test_torch_pipeline import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    DRIVE,
    bench_events,
    clone_resources,
    jax_and_port,
    one_torch_thread,
    pin_codec_region,
    tiny_f32_resources,
)


@pytest.fixture(scope="module")
def resources():
    return tiny_f32_resources()


def make_agent(resources, trims: bool = False):
    config = RealtimeAgentConfig(
        temperature=0.7,
        use_whisper=False,
        agent_opening_text=None,
        force_trans_after_inactivity_secs=0.0,
        force_response_after_inactivity_secs=0.0,
        use_fused_step=True,
        pipeline_chunks=True,
        incremental_trim=trims,
        trim_rebuild_slice_tokens=24,
        max_context_secs=1.0 if trims else 80.0,
        trim_by_secs=0.5 if trims else 20.0,
        seed=13,
    )
    res = clone_resources(resources)
    agent = RealtimeAgent(resources=res, config=config)
    _pin(agent)
    return agent


def _pin(agent):
    """Audio-only sampling: no events, so set_sampler is never re-invoked
    mid-stream and the pin survives the restore."""
    agent.resources.llm.settings.min_token_id = agent.resources.tokenizer.codec_vocab_start


def _chunks(seed, n, samples=1600):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.normal(size=samples)).astype(np.float32) for _ in range(n)]


def _drive(agent, chunks):
    outs = []
    for c in chunks:
        out = agent.process_audio(c)
        if out is not None:
            outs.append(np.asarray(out, np.float32))
    while True:
        tail = agent.drain_pipeline()
        if tail is None:
            break
        outs.append(np.asarray(tail, np.float32))
    return outs


def _assert_streams_equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"chunk {i}")


def _restore(resources, snap):
    b = RealtimeAgent.from_snapshot(clone_resources(resources), snap)
    _pin(b)
    return b


def test_snapshot_restore_token_identity(resources):
    a = make_agent(resources)
    _drive(a, _chunks(1000, 8))
    snap = pickle.loads(pickle.dumps(a.snapshot()))  # the migration wire format
    assert isinstance(snap["enc_ctx"], np.ndarray) and isinstance(snap["dec_ctx"], np.ndarray)
    cont = _chunks(2000, 8)
    outs_a = _drive(a, cont)
    b = _restore(resources, snap)
    assert b.resources.llm.n_tokens == snap["engine_n_tokens"]
    assert b.resources.llm._step == snap["engine_step"]
    outs_b = _drive(b, cont)
    _assert_streams_equal(outs_a, outs_b)
    assert b.input_ids == a.input_ids
    assert b.context_start_pos == a.context_start_pos


def test_snapshot_restore_across_trims(resources):
    a = make_agent(resources, trims=True)
    _drive(a, _chunks(3000, 14))
    # land the snapshot between rebuilds (an in-flight one completes at the
    # restore instead, which is not the uninterrupted call's schedule)
    extra = _chunks(3100, 10)
    i = 0
    while a._trim_rebuild is not None and i < len(extra):
        a.process_audio(extra[i])
        i += 1
    while a.drain_pipeline() is not None:
        pass
    assert a._trim_rebuild is None
    assert a.trim_to_secs > 0.0  # a trim happened
    snap = a.snapshot()
    cont = _chunks(4000, 8)
    outs_a = _drive(a, cont)
    outs_b = _drive(_restore(resources, snap), cont)
    _assert_streams_equal(outs_a, outs_b)


def test_snapshot_mid_trim_rebuild_restores(resources):
    """A snapshot taken while a trim rebuild is in flight records the
    post-trim cache length the restore builds; two restores continue
    identically."""
    a = make_agent(resources, trims=True)
    snap = None
    for i, c in enumerate(_chunks(5000, 40)):
        a.process_audio(c)
        if a._trim_rebuild is not None and i > 12:
            while a.drain_pipeline() is not None:
                pass
            if a._trim_rebuild is not None:  # still mid-rebuild after the drain
                snap = a.snapshot()
                break
    assert snap is not None, "never caught a rebuild in flight"
    assert snap["trim_to_secs"] > a.trim_to_secs
    snap = pickle.loads(pickle.dumps(snap))
    cont = _chunks(6000, 6)
    outs, ids = [], []
    for _ in range(2):
        b = _restore(resources, snap)
        assert b.resources.llm.n_tokens == snap["engine_n_tokens"]
        outs.append(_drive(b, cont))
        ids.append(list(b.input_ids))
    _assert_streams_equal(outs[0], outs[1])
    assert ids[0] == ids[1]


def test_snapshot_requires_quiescence(resources):
    a = make_agent(resources)
    a.process_audio(np.zeros(a.chunk_size_samples, np.float32))
    with pytest.raises(RuntimeError, match="quiescent"):
        a.snapshot()
    while a.drain_pipeline() is not None:
        pass
    snap = a.snapshot()
    assert snap["engine_n_tokens"] > 0


def test_snapshot_refuses_external_streams_and_cache_mismatch(resources):
    a = make_agent(resources)
    _drive(a, _chunks(7000, 2))
    snap = a.snapshot()
    a.config.use_external_llm = True
    with pytest.raises(RuntimeError, match="external TTS/LLM"):
        a.snapshot()
    bad = dict(snap, engine_n_tokens=snap["engine_n_tokens"] + 1)
    with pytest.raises(RuntimeError, match="cache-length mismatch"):
        RealtimeAgent.from_snapshot(clone_resources(resources), bad)


# ------------------------------------------------------ against the JAX call

# transcriptions only before the snapshot: a canned response keeps the
# sampled ids in the live KV cache and the canned ones in the sequence (the
# bench's approximation), which a restore rebuilds from
N1, N2 = 14, 18
SCHED = {7: "trans", 11: "trans", 16: "resp", 19: "trans", 23: "resp", 27: "trans"}
WHISPER = dict(max_new_tokens=4, window_secs=[0.32])
CALL = {**DRIVE, "use_whisper": True, "temperature": 1.0, "pipeline_chunks": False,
        "async_detours": False, "incremental_trim": False}


def _audio():
    rng = np.random.default_rng(11)
    t = np.arange((N1 + N2) * 1600) / 16000
    audio = (0.2 * np.sin(2 * np.pi * 150 * t) * np.clip(np.sin(2 * np.pi * 0.7 * t), 0, 1)
             + 0.02 * rng.normal(size=t.shape)).astype(np.float32)
    return [audio[i * 1600 : (i + 1) * 1600] for i in range(N1 + N2)]


def _script(agent, resources, sched):
    """The bench's pin, forced events (on ``sched``, counted from this
    agent's first processed chunk), canned text and colon, and a
    deterministic finalize cut, keeping the engine's sampler step."""
    step = resources.llm._step
    pin_codec_region(agent, resources)
    resources.llm._step = step
    bench_events(agent, resources, sched)
    colon_first(agent, resources)
    agent._improbable_run_cut = lambda ratio, tol: 2


def test_restored_call_continues_as_uninterrupted_jax_call(jax_and_port):
    jres, port_resources = jax_and_port
    jcfg = JW.tiny_whisper_config()
    jp = JW.init_whisper_params(jax.random.PRNGKey(5), jcfg)
    tp = whisper_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    chunks = _audio()

    jres = jres.clone_for_self_play()
    jres.whisper_model = JaxWhisperASR(JW.JaxWhisperModel(jp, jcfg, **WHISPER), WordsTokenizer())
    jagent = JaxAgent(resources=jres, config=JaxConfig(**CALL))
    _script(jagent, jres, SCHED)
    jagent.reset()
    jouts = [jagent.process_audio(c) for c in chunks]

    def port_res():
        res = port_resources()
        res.whisper_model = TorchWhisperASR(
            TW.TorchWhisperModel(tp, TW.tiny_whisper_config(), device="cpu", **WHISPER), WordsTokenizer())
        return res

    res = port_res()
    first = RealtimeAgent(resources=res, config=RealtimeAgentConfig(**CALL))
    _script(first, res, SCHED)
    first.reset()
    for c in chunks[:N1]:
        first.process_audio(c)
    assert first.quiesce() == []
    snap = pickle.loads(pickle.dumps(first.snapshot()))

    res2 = port_res()
    restored = RealtimeAgent.from_snapshot(res2, snap)
    _script(restored, res2, {k - N1: v for k, v in SCHED.items() if k >= N1})
    assert restored.resources.llm._step == snap["engine_step"]
    touts = [restored.process_audio(c) for c in chunks[N1:]]

    assert restored.input_ids == jagent.input_ids
    assert restored.audio_tokens_idx == jagent.audio_tokens_idx
    assert restored.transcript == jagent.transcript
    assert restored.trim_to_secs == jagent.trim_to_secs > 0
    assert restored.resources.llm.n_tokens == jagent.resources.llm.n_tokens
    assert restored.resources.llm._step == jagent.resources.llm._step
    users = [e for e in restored.transcript if e["speaker"] == "B"]
    assert len(users) == 4 and all(e["text_with_external_markers"].count("†") == 2 for e in users)
    for got, want in zip(touts, jouts[N1:]):
        np.testing.assert_allclose(got, want, atol=1e-4)
