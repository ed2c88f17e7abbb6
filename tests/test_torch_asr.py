"""Whisper on the port's agent, against the JAX agent.

- Scripted: tests/test_asr.py's constrained merge (a scripted ASR and
  tests/fakes.py's engine) on the port's agent and the JAX agent: the same
  sequence, transcript, engine calls and ASR audio, and JAX's outcome
  (native paralinguistics kept, the ASR's words spliced in as an external
  range between markers).
- Real engines: the port agent with a tiny ``TorchWhisperASR`` against the
  JAX agent with ``JaxWhisperASR`` on the same converted tiny f32 weights
  (LM, codec and Whisper) and audio, with the bench's forced events, trims
  and a finalize; greedy and seeded: identical ``input_ids``, transcript
  and ``text_with_external_markers``, Whisper called in every transcription
  event on both.
- The bench's default flags (``pipeline_chunks`` + ``async_detours`` +
  ``incremental_trim``) against the port's synchronous agent, Whisper on:
  the same state; a transcription splices while a trim rebuild is in
  flight; no detour fails.
- ``load_asr``: None and ASR objects pass, a name it cannot load raises.

The canned colon: an agent pinned to the codec region (as the bench pins
it) never samples the ":" after the speaker token, and an event without it
leaves no transcript entry. ``colon_first`` records ":" for the first
constrained step of each transcription event while the device samples as
usual, as bench.py's canned text does for ``generate_until``.
"""
import dataclasses
import warnings

import jax
import numpy as np
import pytest

from realtime_codec_agent_tpu.agent.agent import RealtimeAgent as JaxAgent
from realtime_codec_agent_tpu.agent.asr import ASRModel as JaxASRModel
from realtime_codec_agent_tpu.agent.asr import JaxWhisperASR
from realtime_codec_agent_tpu.agent.config import RealtimeAgentConfig as JaxConfig
from realtime_codec_agent_tpu.audio_tokenizer import AudioTokenizer as JaxAudioTokenizer
from realtime_codec_agent_tpu.models import whisper as JW
from realtime_codec_agent_tpu.models.codec import JaxCodecModel, tiny_codec_config
from realtime_codec_agent_tpu.tokenization import CodecTextTokenizer
from realtime_codec_agent_tpu_torch.agent.agent import RealtimeAgent
from realtime_codec_agent_tpu_torch.agent.asr import ASRModel, TorchWhisperASR, load_asr
from realtime_codec_agent_tpu_torch.agent.config import RealtimeAgentConfig
from realtime_codec_agent_tpu_torch.audio_tokenizer import AudioTokenizer
from realtime_codec_agent_tpu_torch.models import codec as tcodec
from realtime_codec_agent_tpu_torch.models import whisper as TW
from realtime_codec_agent_tpu_torch.models.from_jax import codec_params_from_numpy, whisper_params_from_jax
from tests.test_torch_pipeline import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    DRIVE,
    bench_events,
    jax_and_port,
    one_torch_thread,
    pin_codec_region,
)

from fakes import FakeLMEngine, FakeResources


# ------------------------------------------------------------------ scripted

class ScriptedASR:
    """transcribe() returns a fixed text and records its audio."""

    def __init__(self, text):
        self.text = text
        self.calls = []

    def transcribe(self, audio, temperature=0.0):
        self.calls.append(np.asarray(audio))
        return self.text


class PortScriptedASR(ScriptedASR, ASRModel):
    pass


class JaxScriptedASR(ScriptedASR, JaxASRModel):
    pass


def _scripted_run(which):
    jcodec = JaxCodecModel.random_init(tiny_codec_config(compute_dtype="float32"), seed=0)
    tt = CodecTextTokenizer(codebook_size=jcodec.codebook_size)
    fake = FakeLMEngine(default_token=tt.codec_vocab_start + 7)
    config = dict(use_whisper=True, agent_opening_text=None, force_trans_after_inactivity_secs=0.0,
                  force_response_after_inactivity_secs=0.0)
    if which == "jax":
        res = FakeResources(JaxAudioTokenizer(codec_model=jcodec), tt, fake)
        res.whisper_model = asr = JaxScriptedASR("Hello There.")
        agent = JaxAgent(resources=res, config=JaxConfig(**config))
    else:
        tcfg = tcodec.CodecConfig(**dataclasses.asdict(jcodec.config))
        codec = tcodec.TorchCodecModel(
            codec_params_from_numpy(jax.tree_util.tree_map(np.asarray, jcodec.params)), tcfg, "cpu")
        res = FakeResources(AudioTokenizer(codec_model=codec), tt, fake)
        res.whisper_model = asr = PortScriptedASR("Hello There.")
        agent = RealtimeAgent(resources=res, config=RealtimeAgentConfig(**config))
    user_sp = tt.encode(" B", add_special_tokens=False)[0]
    end_audio = tt.convert_tokens_to_ids("<|end_audio|>")
    start_audio = tt.convert_tokens_to_ids("<|audio|>")
    audio_tok = tt.codec_vocab_start + 21
    # chunk 1: pure audio (the channel-2 history Whisper reads); chunk 2:
    # frame 0 audio, frame 1 the transcription event whose native
    # constrained generation keeps "&=laughs " and drops the content word
    agent.process_audio(np.zeros(1600, np.float32))
    fake.script = ([audio_tok, end_audio, user_sp] + tt.encode(":", add_special_tokens=False)
                   + tt.encode(" &=laughs and", add_special_tokens=False)
                   + tt.encode(" ", add_special_tokens=False) + [start_audio] + [audio_tok] * 4)
    out = agent.process_audio(np.zeros(1600, np.float32))
    return agent, fake, asr, out


def test_constrained_merge_matches_jax():
    jagent, jfake, jasr, jout = _scripted_run("jax")
    tagent, tfake, tasr, tout = _scripted_run("port")
    assert tout.shape == jout.shape == (1600,)
    assert tagent.input_ids == jagent.input_ids
    assert tagent.get_sequence_str() == jagent.get_sequence_str()
    assert tagent.transcript == jagent.transcript
    assert tfake.eval_calls == jfake.eval_calls
    assert tfake.n_tokens == jfake.n_tokens
    assert len(tasr.calls) == len(jasr.calls) == 1
    np.testing.assert_array_equal(tasr.calls[0], jasr.calls[0])
    # JAX's outcome (tests/test_asr.py): merged native paralinguistics and
    # external words, the words between the two markers
    (entry,) = tagent.transcript
    assert entry["speaker"] == "B"
    assert "hello there" in entry["text"] and "&=laughs" in entry["text"]
    assert entry["text_with_external_markers"].count(tagent.config.external_marker_token) == 2
    seq = tagent.get_sequence_str()
    assert "hello there" in seq and "<|audio|>" in seq.split("hello there")[-1]


# ------------------------------------------------------------- real engines

class WordsTokenizer:
    """Whisper ids -> words (random weights give arbitrary ids; the words
    keep them visible in the transcript)."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{t}" for t in ids)


def colon_first(agent, resources) -> None:
    """The first constrained step of a transcription event records ":"; the
    engine samples (and later evals) as usual. Works on both agents."""
    llm = resources.llm
    colon = resources.tokenizer.encode(":", add_special_tokens=False)[0]
    armed = {"on": False}
    orig_native, orig_step = agent._native_generate_text, llm.eval_and_sample

    def native(constrained=False, allowed_wordlist=None):
        armed["on"] = constrained and allowed_wordlist is None
        try:
            return orig_native(constrained=constrained, allowed_wordlist=allowed_wordlist)
        finally:
            armed["on"] = False

    def step(tokens):
        tok = orig_step(tokens)
        if armed["on"]:
            armed["on"] = False
            return colon
        return tok

    agent._native_generate_text = native
    llm.eval_and_sample = step


def count_calls(asr, agent):
    """Wrap ``asr.transcribe``: the calls, each with whether a trim rebuild
    was in flight."""
    calls = []
    orig = asr.transcribe

    def transcribe(audio, temperature=0.0):
        calls.append(agent._trim_rebuild is not None)
        return orig(audio, temperature=temperature)

    asr.transcribe = transcribe
    return calls


N_CHUNKS = 32
SCHED = {7: "trans", 11: "resp", 16: "trans", 19: "trans", 23: "resp", 27: "trans"}
WHISPER = dict(max_new_tokens=4, window_secs=[0.32])


@pytest.fixture(scope="module")
def whisper_params():
    jcfg = JW.tiny_whisper_config()
    jp = JW.init_whisper_params(jax.random.PRNGKey(3), jcfg)
    return jp, whisper_params_from_jax(jax.tree_util.tree_map(np.asarray, jp)), jcfg


def _drive(agent, resources, asr):
    pin_codec_region(agent, resources)
    bench_events(agent, resources, SCHED)
    colon_first(agent, resources)
    agent._improbable_run_cut = lambda ratio, tol: 2  # a deterministic finalize cut
    calls = count_calls(asr, agent)
    agent.reset()
    rng = np.random.default_rng(9)
    t = np.arange(N_CHUNKS * 1600) / 16000
    audio = (0.2 * np.sin(2 * np.pi * 150 * t) * np.clip(np.sin(2 * np.pi * 0.7 * t), 0, 1)
             + 0.02 * rng.normal(size=t.shape)).astype(np.float32)
    outs = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(N_CHUNKS):
            out = agent.process_audio(audio[i * 1600 : (i + 1) * 1600])
            if not getattr(agent, "last_emit_was_filler", False):
                outs.append(out)
        if hasattr(agent, "quiesce"):
            outs.extend(agent.quiesce())
    assert not [str(w.message) for w in caught if "detour failed" in str(w.message)]
    return outs, calls


def _port_agent(port_resources, whisper_params, flags, temperature):
    _, tp, _ = whisper_params
    tres = port_resources()
    tres.whisper_model = TorchWhisperASR(
        TW.TorchWhisperModel(tp, TW.tiny_whisper_config(), device="cpu", **WHISPER), WordsTokenizer())
    cfg = {**DRIVE, "use_whisper": True, "temperature": temperature, **flags}
    return RealtimeAgent(resources=tres, config=RealtimeAgentConfig(**cfg)), tres


SYNC = dict(pipeline_chunks=False, async_detours=False, incremental_trim=True)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_whisper_call_matches_jax(jax_and_port, whisper_params, temperature):
    jres, port_resources = jax_and_port
    jp, _, jcfg = whisper_params
    jres = jres.clone_for_self_play()
    jres.whisper_model = JaxWhisperASR(JW.JaxWhisperModel(jp, jcfg, **WHISPER), WordsTokenizer())
    jagent = JaxAgent(resources=jres, config=JaxConfig(**{**DRIVE, "use_whisper": True,
                                                           "temperature": temperature, **SYNC}))
    tagent, tres = _port_agent(port_resources, whisper_params, SYNC, temperature)
    jouts, jcalls = _drive(jagent, jres, jres.whisper_model)
    touts, tcalls = _drive(tagent, tres, tres.whisper_model)

    assert tagent.input_ids == jagent.input_ids
    assert tagent.audio_tokens_idx == jagent.audio_tokens_idx
    assert tagent.transcript == jagent.transcript
    assert [e["text_with_external_markers"] for e in tagent.transcript] == [
        e["text_with_external_markers"] for e in jagent.transcript]
    assert tagent.resources.llm.n_tokens == jagent.resources.llm.n_tokens
    assert tagent.resources.llm._step == jagent.resources.llm._step
    # Whisper ran in every transcription event, and its words stand between
    # the markers in the user entries
    assert len(tcalls) == len(jcalls) == sum(v == "trans" for v in SCHED.values())
    marker = tagent.config.external_marker_token
    users = [e for e in tagent.transcript if e["speaker"] == "B"]
    assert len(users) == len(tcalls)
    for e in users:
        inner = e["text_with_external_markers"].split(marker)
        assert len(inner) == 3 and inner[1].strip().startswith("w")
    assert len(touts) == len(jouts)
    for got, want in zip(touts, jouts):
        np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_bench_flags_match_sync_with_whisper(jax_and_port, whisper_params, temperature):
    _, port_resources = jax_and_port
    sync, sres = _port_agent(port_resources, whisper_params, SYNC, temperature)
    bench, bres = _port_agent(port_resources, whisper_params, {}, temperature)  # DRIVE's async flags
    assert bench.config.pipeline_chunks and bench.config.async_detours and bench.config.incremental_trim
    souts, scalls = _drive(sync, sres, sres.whisper_model)
    bouts, bcalls = _drive(bench, bres, bres.whisper_model)
    assert bench.input_ids == sync.input_ids
    assert bench.audio_tokens_idx == sync.audio_tokens_idx
    assert bench.transcript == sync.transcript
    assert bench.trim_to_secs == sync.trim_to_secs >= DRIVE["trim_by_secs"]
    assert bench.resources.llm.n_tokens == sync.resources.llm.n_tokens
    assert bench.resources.llm._step == sync.resources.llm._step
    assert bcalls == scalls and len(bcalls) == 4
    assert any(bcalls), "no transcription spliced while a trim rebuild was in flight"
    assert len(bench.detour_durations) >= 4
    assert len(bouts) == len(souts) == N_CHUNKS
    for got, want in zip(bouts, souts):
        np.testing.assert_allclose(got, want, atol=1e-5)


# ----------------------------------------------------------------- load_asr

def test_load_asr_passes_objects_and_raises_on_names():
    asr = PortScriptedASR("x")
    assert load_asr(asr) is asr
    assert load_asr(None) is None
    with pytest.raises(RuntimeError, match=r"cannot load Whisper 'no-such-whisper-model' .*on cpu"):
        load_asr("no-such-whisper-model", device="cpu")
    with pytest.raises(TypeError):
        load_asr(3)


def test_torch_whisper_asr_decodes_ids(whisper_params):
    _, tp, _ = whisper_params
    model = TW.TorchWhisperModel(tp, TW.tiny_whisper_config(), device="cpu", **WHISPER)
    asr = TorchWhisperASR(model, WordsTokenizer())
    audio = (np.random.default_rng(1).normal(size=8000) * 0.05).astype(np.float32)
    ids = model.transcribe_ids(audio)
    assert asr.transcribe(audio) == " ".join(f"w{t}" for t in ids).strip()
    assert asr.model is model
