"""The agent's synchronous event path in the port, against the JAX package.

- Generation: ``generate_until`` greedy is token-exact with the JAX engine on
  the same converted f32 weights; within the port, seeded temperature 1.0 is
  token-exact with a stepwise ``eval_and_sample`` loop, and ``n_limit`` caps it.
- Scripted agent: tests/test_agent.py's event scenarios (transcription,
  response, suppression rollback, forced response, forced transcription,
  trim) on the port's agent and the JAX agent with tests/fakes.py's engine:
  the same sequence, transcript and engine calls.
- Whole slice: the JAX agent and the port's agent on the same converted tiny
  weights, greedy f32, with the bench's scheduled forced events and canned
  event text (bench.py:732-788), trims every second of audio and a finalize
  whose scoring context passes 512 tokens (the flash branch): after every
  chunk the two agents agree exactly on the sequence, the audio-token
  indices, the transcript, the trim point and n_tokens, and on the audio at
  atol 1e-4.
- Within the port: fused chunks that stop at an event and replay on the
  stepwise path give the same sequence as the agent without a fused session,
  at seeded temperature 1.0 (this is what sees the sampler-step bookkeeping
  of the replay; greedy parity cannot).
"""
import dataclasses

import jax
import numpy as np
import pytest

from realtime_codec_agent_tpu.agent.agent import RealtimeAgent as JaxAgent
from realtime_codec_agent_tpu.agent.config import RealtimeAgentConfig as JaxConfig
from realtime_codec_agent_tpu.agent.resources import RealtimeAgentResources as JaxResources
from realtime_codec_agent_tpu.audio_tokenizer import AudioTokenizer as JaxAudioTokenizer
from realtime_codec_agent_tpu.lm.engine import DuplexLMEngine as JaxEngine
from realtime_codec_agent_tpu.models import llama as jl
from realtime_codec_agent_tpu.models.codec import JaxCodecModel, tiny_codec_config
from realtime_codec_agent_tpu.tokenization import CodecTextTokenizer
from realtime_codec_agent_tpu_torch.agent.agent import RealtimeAgent
from realtime_codec_agent_tpu_torch.agent.config import RealtimeAgentConfig
from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources
from realtime_codec_agent_tpu_torch.audio_tokenizer import AudioTokenizer
from realtime_codec_agent_tpu_torch.lm.engine import DuplexLMEngine
from realtime_codec_agent_tpu_torch.models import codec as tcodec
from realtime_codec_agent_tpu_torch.models import llama as tl
from realtime_codec_agent_tpu_torch.models.from_jax import codec_params_from_numpy, lm_params_from_numpy

from fakes import FakeLMEngine, FakeResources

VOCAB = 1320


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def bench_audio(secs, seed=0, sr=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(int(secs * sr)) / sr
    return (
        0.2 * np.sin(2 * np.pi * 150 * t) * np.clip(np.sin(2 * np.pi * 0.7 * t), 0, 1)
        + 0.02 * rng.normal(size=t.shape)
    ).astype(np.float32)


# ------------------------------------------------------------------ generation

@pytest.fixture(scope="module")
def lm():
    jcfg = jl.tiny_lm_config(vocab_size=VOCAB, compute_dtype="float32")
    jparams = jl.init_lm_params(jax.random.PRNGKey(2), jcfg)
    return jcfg, jparams, tl.DuplexLMConfig(**dataclasses.asdict(jcfg))


def _port_engine(lm, seed=5, temp=1.0):
    _, jparams, tcfg = lm
    e = DuplexLMEngine(lm_params_from_numpy(_np_tree(jparams)), tcfg, seed=seed, device="cpu")
    e.init_sampler_for_generate(temp=temp, top_k=50, repeat_penalty=1.3, seed=seed)
    e.eval(list(range(20, 30)))
    return e


@pytest.mark.parametrize("stop", ["never", "third"])
def test_generate_until_matches_jax_greedy(lm, stop):
    jcfg, jparams, _ = lm
    je = JaxEngine(jparams, jcfg, seed=5)
    je.init_sampler_for_generate(temp=0.0, top_k=50, repeat_penalty=1.3, seed=5)
    je.eval(list(range(20, 30)))
    te = _port_engine(lm, temp=0.0)
    stop_id = -1
    if stop == "third":
        probe = _port_engine(lm, temp=0.0)
        stop_id = probe.generate_until(31, stop_id=-1, max_n=8)[0][2]
    jt, jhit = je.generate_until(31, stop_id=stop_id, max_n=16)
    tt, thit = te.generate_until(31, stop_id=stop_id, max_n=16)
    assert tt == jt and thit == jhit
    assert len(tt) == (3 if stop == "third" else 16)
    assert te._input_ids == je._input_ids
    assert te.n_tokens == je.n_tokens and te._step == je._step
    np.testing.assert_allclose(te._last_logits.numpy(), np.asarray(je._last_logits), atol=1e-4)


def _stepwise(e, first, n, stop_id):
    toks, tok = [], first
    for _ in range(n):
        tok = e.eval_and_sample([tok])
        toks.append(tok)
        if tok == stop_id:
            break
    return toks


@pytest.mark.parametrize("n_limit", [None, 10])
def test_generate_until_matches_stepwise_seeded(lm, n_limit):
    """Seeded temperature 1.0 with a repeat penalty: the same noise steps
    and penalty windows as the stepwise loop, and the same state after."""
    ref = _port_engine(lm)
    ref_toks = _stepwise(ref, 31, 16 if n_limit is None else n_limit, stop_id=-1)
    if n_limit is None:  # a stop token inside the run: the 12th sampled one
        ref = _port_engine(lm)
        stop_id = ref_toks[11]
        ref_toks = _stepwise(ref, 31, 16, stop_id=stop_id)
    else:
        stop_id = -1
    scan = _port_engine(lm)
    toks, hit = scan.generate_until(31, stop_id=stop_id, max_n=16, n_limit=n_limit)
    assert toks == ref_toks
    assert hit == (ref_toks[-1] == stop_id)
    assert len(toks) == (10 if n_limit else ref_toks.index(stop_id) + 1)
    assert scan._input_ids == ref._input_ids
    assert scan.n_tokens == ref.n_tokens and scan._step == ref._step
    # the committed K/V: the next step samples the same token
    assert scan.eval_and_sample([toks[-1]]) == ref.eval_and_sample([ref_toks[-1]])


def test_generate_yields_stepwise(lm):
    a, b = _port_engine(lm), _port_engine(lm)
    gen = a.generate([31])
    got = [next(gen) for _ in range(4)]
    assert got == _stepwise(b, 31, 4, stop_id=-1)


# --------------------------------------------------------- scripted agent

@pytest.fixture(scope="module")
def codecs():
    jcodec = JaxCodecModel.random_init(tiny_codec_config(compute_dtype="float32"), seed=0)
    tcfg = tcodec.CodecConfig(**dataclasses.asdict(jcodec.config))
    tcodec_model = tcodec.TorchCodecModel(codec_params_from_numpy(_np_tree(jcodec.params)), tcfg, "cpu")
    return jcodec, tcodec_model


def _scripted(codecs, which, **config_kwargs):
    jcodec, tcodec_model = codecs
    tt = CodecTextTokenizer(codebook_size=jcodec.codebook_size)
    config_kwargs = dict(
        use_whisper=False, agent_opening_text=None,
        force_trans_after_inactivity_secs=0.0, force_response_after_inactivity_secs=0.0,
        **config_kwargs,
    )
    fake = FakeLMEngine(default_token=tt.codec_vocab_start + 7)
    if which == "jax":
        res = FakeResources(JaxAudioTokenizer(codec_model=jcodec), tt, fake)
        return JaxAgent(resources=res, config=JaxConfig(**config_kwargs)), fake, tt
    res = FakeResources(AudioTokenizer(codec_model=tcodec_model), tt, fake)
    return RealtimeAgent(resources=res, config=RealtimeAgentConfig(**config_kwargs)), fake, tt


def _ids(tt):
    return dict(
        user_sp=tt.encode(" B", add_special_tokens=False)[0],
        agent_sp=tt.encode(" A", add_special_tokens=False)[0],
        end_audio=tt.convert_tokens_to_ids("<|end_audio|>"),
        start_audio=tt.convert_tokens_to_ids("<|audio|>"),
    )


def _silence():
    return np.zeros(1600, dtype=np.float32)


def _run_transcription(agent, fake, tt):
    t = _ids(tt)
    audio = tt.codec_vocab_start + 21
    colon = tt.encode(":", add_special_tokens=False)
    hi = tt.encode(" hi", add_special_tokens=False)
    fake.script = [audio, t["end_audio"], t["user_sp"]] + colon + hi + [t["start_audio"]] + [audio] * 4
    agent.process_audio(_silence())
    assert [(e["speaker"], e["text"]) for e in agent.transcript] == [("B", "hi")]
    assert "<|end_audio|> B: hi<|audio|>" in agent.get_sequence_str()


def _run_response(agent, fake, tt):
    t = _ids(tt)
    audio = tt.codec_vocab_start + 30
    fake.script = [audio, t["end_audio"], t["agent_sp"]] + tt.encode(": yes", add_special_tokens=False) + [
        t["start_audio"]] + [audio] * 4
    agent.process_audio(_silence())
    assert [(e["speaker"], e["text"], e["end_secs"]) for e in agent.transcript] == [("A", "yes", None)]
    assert agent.ch1_inactivity_elapsed_secs == 0.0


def _run_suppression(agent, fake, tt):
    t = _ids(tt)
    before = len(agent.input_ids)
    fake.script = [t["end_audio"], t["user_sp"], t["start_audio"]] + [tt.codec_vocab_start + 40] * 5
    agent.process_audio(_silence())
    assert agent.transcript == []
    assert len(agent.input_ids) == before + 10  # the event rolled back entirely
    assert any(s.get("logit_bias") for s in fake.sampler_inits)


def _run_forced(agent, fake, tt, as_trans):
    t = _ids(tt)
    audio = tt.codec_vocab_start + 50
    user = [tt.codec_vocab_start + 60] * 5
    fake.script = [audio] * 5
    agent.process_audio_input_ids(user)
    fake.script = tt.encode(": hey" if as_trans else ": ok", add_special_tokens=False) + [
        t["start_audio"]] + [audio] * 5
    out = agent.process_audio_input_ids(user, force_trans=as_trans, force_response=not as_trans)
    assert len(out) == 5
    assert [(e["speaker"], e["text"]) for e in agent.transcript] == [("B", "hey") if as_trans else ("A", "ok")]


def _run_trim(agent, fake, tt):
    for _ in range(3):
        agent.process_audio(_silence())  # 0.3 s > 0.2 s: the trim fires
    assert agent.trim_to_secs == pytest.approx(0.1)


SCENARIOS = {
    "transcription": (_run_transcription, {}),
    "response": (_run_response, {}),
    "suppression": (_run_suppression, {}),
    "forced_response": (lambda a, f, t: _run_forced(a, f, t, as_trans=False), {}),
    "forced_transcription": (lambda a, f, t: _run_forced(a, f, t, as_trans=True), {}),
    "trim": (_run_trim, {"max_context_secs": 0.2, "trim_by_secs": 0.1}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scripted_events_match_jax_agent(codecs, name):
    run, cfg = SCENARIOS[name]
    runs = {}
    for which in ("jax", "torch"):
        agent, fake, tt = _scripted(codecs, which, **cfg)
        run(agent, fake, tt)
        runs[which] = (agent, fake)
    (ja, jf), (ta, tf) = runs["jax"], runs["torch"]
    assert ta.input_ids == ja.input_ids
    assert ta.audio_tokens_idx == ja.audio_tokens_idx
    assert ta.transcript == ja.transcript
    assert ta.trim_to_secs == ja.trim_to_secs
    assert tf.eval_calls == jf.eval_calls and tf.n_tokens == jf.n_tokens


# ------------------------------------------------------------- whole slice

SLICE_CHUNKS = 66
SLICE_EVENTS = {2: "resp", 20: "trans", 40: "trans", 64: "resp"}
SLICE_CONFIG = dict(
    temperature=0.0, seed=7, use_whisper=False, agent_opening_text=None,
    force_trans_after_inactivity_secs=0.0, force_response_after_inactivity_secs=0.0,
    finalize_response_after_inactivity_secs=1000.0,  # finalize only through the next response
    max_inline_text_tokens=8, max_context_secs=2.0, trim_by_secs=1.0,
)


def _bench_drive(agent, resources, events):
    """bench.py's harness: sampling pinned to codec ids, forced events on a
    schedule of processed chunks, and the generated ids of every event
    overridden by a canned parseable text (the engine mirror rewritten to
    match, the device KV keeping the sampled ids)."""
    tok = resources.tokenizer
    orig_sampler = agent.set_sampler

    def pinned(for_trans=False, suppress_end_audio=False):
        orig_sampler(for_trans=for_trans, suppress_end_audio=suppress_end_audio)
        resources.llm.settings.min_token_id = tok.codec_vocab_start

    agent.set_sampler = pinned
    state = {"i": 0}
    agent.should_force_transcription = lambda: events.get(state["i"]) == "trans"

    def fr():
        fire = events.get(state["i"]) == "resp"
        state["i"] += 1
        return fire

    agent.should_force_response = fr
    canned = tok.encode(": okay so that sounds good", add_special_tokens=False)
    orig_gen = resources.llm.generate_until

    def canned_generate_until(first_token, stop_id, max_n=64, n_limit=None):
        toks, hit = orig_gen(first_token, stop_id, max_n=max_n, n_limit=n_limit)
        if not toks:
            return toks, hit
        out = [canned[j % len(canned)] for j in range(len(toks))]
        if hit:
            out[-1] = toks[-1]
        if len(toks) > 1:
            llm = resources.llm
            llm._input_ids[len(llm._input_ids) - (len(toks) - 1):] = out[:-1]
        return out, hit

    resources.llm.generate_until = canned_generate_until
    agent.reset()


def test_slice_with_events_trims_and_finalize_matches_jax():
    vocab = CodecTextTokenizer(codebook_size=1024).vocab_size
    lcfg = jl.tiny_lm_config(vocab_size=vocab, codebook_size=1024, compute_dtype="float32", max_context=1024)
    ccfg = tiny_codec_config(compute_dtype="float32")
    jres = JaxResources(tiny=True, whisper_model=None, lm_config=lcfg, codec_config=ccfg)
    tres = RealtimeAgentResources(
        tiny=True, device="cpu",
        lm_config=tl.DuplexLMConfig(**dataclasses.asdict(lcfg)),
        codec_config=tcodec.CodecConfig(**dataclasses.asdict(ccfg)),
        _lm_params=lm_params_from_numpy(_np_tree(jres.lm_params)),
        _codec_params=codec_params_from_numpy(_np_tree(jres.audio_tokenizer.codec_model.params)),
    )
    jagent = JaxAgent(resources=jres, config=JaxConfig(**SLICE_CONFIG))
    tagent = RealtimeAgent(resources=tres, config=RealtimeAgentConfig(**SLICE_CONFIG))
    _bench_drive(jagent, jres, SLICE_EVENTS)
    _bench_drive(tagent, tres, SLICE_EVENTS)
    scored = []
    orig_score = tres.llm.get_logprobs_batch
    tres.llm.get_logprobs_batch = lambda pairs: scored.append(max(len(c) + len(i) for c, i in pairs)) or orig_score(pairs)
    fused = {"n": 0}
    orig_commit = tagent._commit_fused
    tagent._commit_fused = lambda *a: fused.__setitem__("n", fused["n"] + 1) or orig_commit(*a)

    assert tagent.input_ids == jagent.input_ids
    audio = bench_audio(SLICE_CHUNKS * 0.1)
    trims = []
    for c in range(SLICE_CHUNKS):
        chunk = audio[c * 1600 : (c + 1) * 1600]
        jout = jagent.process_audio(chunk)
        tout = tagent.process_audio(chunk)
        assert tagent.input_ids == jagent.input_ids, f"chunk {c}"
        assert tagent.audio_tokens_idx == jagent.audio_tokens_idx, f"chunk {c}"
        assert tagent.trim_to_secs == jagent.trim_to_secs, f"chunk {c}"
        assert tagent.resources.llm.n_tokens == jagent.resources.llm.n_tokens, f"chunk {c}"
        for te, je in zip(tagent.transcript, jagent.transcript, strict=True):
            for key in ("speaker", "text", "start_secs", "end_secs", "planned_text"):
                assert te.get(key) == je.get(key), (c, key)
        np.testing.assert_allclose(tout, jout, atol=1e-4, err_msg=f"chunk {c}")
        if all(t > tagent.end_header_token_id for t in tagent.input_ids[-2:]):
            assert tagent.resources.llm.n_tokens == tagent.cache_pos(len(tagent.input_ids) - 2)
        trims.append(tagent.trim_to_secs)
    assert len(set(trims)) >= 3  # the trim point advanced at least twice
    assert {e["speaker"] for e in tagent.transcript} == {"A", "B"}
    assert scored and max(scored) > 512, scored  # finalize scored through the flash branch
    responses = [e for e in tagent.transcript if e["speaker"] == "A"]
    assert responses[0].get("planned_text") is not None and responses[-1].get("planned_text") is None
    assert fused["n"] >= SLICE_CHUNKS - 2 * len(SLICE_EVENTS) - 4  # fused chunks resume after trims and events


# ------------------------------------------------------------- within the port

def test_fused_event_replay_matches_unfused_seeded():
    """Unpinned sampling at temperature 1.0: the LM samples non-audio tokens
    inside fused chunks, which stop at the event and replay from its frame;
    the agent without a fused session runs every chunk stepwise. Same
    sequences, same engine state."""
    base = RealtimeAgentResources(tiny=True, device="cpu", seed=1)
    cfg = dict(
        temperature=1.0, seed=11, use_whisper=False, agent_opening_text=None,
        force_trans_after_inactivity_secs=0.0, force_response_after_inactivity_secs=0.0,
        max_inline_text_tokens=6,
    )
    agents = []
    for fused in (True, False):
        res = RealtimeAgentResources(
            tiny=True, device="cpu", lm_config=base.lm_config,
            _lm_params=base.lm_params, _codec_params=base.audio_tokenizer.codec_model.params,
        )
        agents.append(RealtimeAgent(resources=res, config=RealtimeAgentConfig(**cfg, use_fused_step=fused)))
    fused_agent, step_agent = agents
    assert step_agent._session is None
    replays = {"n": 0}
    orig = fused_agent._commit_accepted_frames
    fused_agent._commit_accepted_frames = lambda res: replays.__setitem__("n", replays["n"] + 1) or orig(res)
    audio = bench_audio(0.6, seed=5)
    for c in range(6):
        chunk = audio[c * 1600 : (c + 1) * 1600]
        fused_agent.process_audio(chunk)
        step_agent.process_audio(chunk)
        assert fused_agent.input_ids == step_agent.input_ids, f"chunk {c}"
    assert replays["n"] >= 2  # events fired inside fused chunks
    assert fused_agent.audio_tokens_idx == step_agent.audio_tokens_idx
    fl, sl = fused_agent.resources.llm, step_agent.resources.llm
    assert fl.n_tokens == sl.n_tokens and fl._input_ids == sl._input_ids and fl._step == sl._step
