"""The port's pipelined drive and async detours: against the JAX agent, and
against the port's own synchronous agent.

- Against JAX: the JAX agent and the port's, both with ``pipeline_chunks``,
  ``async_detours`` and ``incremental_trim``, on the same converted tiny f32
  weights, with the bench's forced events and canned event text, trims
  about every second of audio and a finalize splice that is absorbed;
  greedy, and seeded at temperature 1.0 (S1's noise is JAX's). After
  ``quiesce()`` the two agents hold the same ids, transcript, trim point,
  n_tokens, sampler step and absorb counts; the non-filler audio agrees in
  order at atol 1e-4. Filler counts depend on wall time and are not held.
- Against the port's synchronous agent: tests/test_pipeline.py's contract
  (its self-play test aside): the same token stream, audio one chunk late.
- The step fault: two dispatches in flight before one resolve draw the
  sampler keys of two synchronous chunks.

Tiny f32 configs: f32 keeps the fused and stepwise routes' numeric
difference far below a sampled token's margin, so seeded runs are exact.
This file also holds the drive helpers the port's async-detour and
incremental-trim tests share.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.agent.agent import RealtimeAgent as JaxAgent
from realtime_codec_agent_tpu.agent.config import RealtimeAgentConfig as JaxConfig
from realtime_codec_agent_tpu.agent.resources import RealtimeAgentResources as JaxResources
from realtime_codec_agent_tpu.models import llama as jl
from realtime_codec_agent_tpu.models.codec import tiny_codec_config as jax_tiny_codec_config
from realtime_codec_agent_tpu.tokenization import CodecTextTokenizer
from realtime_codec_agent_tpu_torch.agent.agent import RealtimeAgent
from realtime_codec_agent_tpu_torch.agent.config import RealtimeAgentConfig
from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources
from realtime_codec_agent_tpu_torch.models import codec as tcodec
from realtime_codec_agent_tpu_torch.models import llama as tl
from realtime_codec_agent_tpu_torch.models.from_jax import codec_params_from_numpy, lm_params_from_numpy

CANNED_TEXT = (": okay so that sounds pretty good to me and i think we should keep "
               "going with it for a while longer")


# ------------------------------------------------------------ drive helpers

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models run on one intra-op thread: eight cost about three
    times the CPU time for less than twice the speed, and when the suite's
    workers share the cores each small op waits on descheduled pool threads
    (a drive test went from seconds to minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_f32_resources(seed: int = 0) -> RealtimeAgentResources:
    """The port's tiny resources with an f32 LM and codec."""
    vocab = CodecTextTokenizer(codebook_size=1024).vocab_size
    return RealtimeAgentResources(
        tiny=True, device="cpu", seed=seed,
        lm_config=tl.tiny_lm_config(vocab_size=vocab, max_context=12288, compute_dtype="float32"),
        codec_config=tcodec.tiny_codec_config(compute_dtype="float32"),
    )


def clone_resources(res: RealtimeAgentResources) -> RealtimeAgentResources:
    """A second resources over the same weights: its own engine (KV cache,
    sampler state) and codec streaming state."""
    return RealtimeAgentResources(
        tiny=True, device="cpu", lm_config=res.lm_config,
        codec_config=res.audio_tokenizer.codec_model.config,
        _lm_params=res.lm_params, _codec_params=res.audio_tokenizer.codec_model.params,
    )


def pin_codec_region(agent, resources) -> None:
    """As the bench does: every sample is restricted to codec ids."""
    orig = agent.set_sampler

    def pinned(for_trans=False, suppress_end_audio=False):
        orig(for_trans=for_trans, suppress_end_audio=suppress_end_audio)
        resources.llm.settings.min_token_id = resources.tokenizer.codec_vocab_start

    agent.set_sampler = pinned
    agent.set_sampler()


def make_agent(resources, mode: str, temperature: float = 0.0, pin_audio: bool = True, **cfg_overrides):
    """A port agent over a clone of ``resources``; ``mode`` "sync", "pipe"
    (pipeline_chunks) or "async" (pipeline_chunks + async_detours)."""
    config = dict(
        temperature=temperature,
        use_whisper=False,
        agent_opening_text=None,
        force_trans_after_inactivity_secs=0.0,
        force_response_after_inactivity_secs=0.0,
        use_fused_step=True,
        pipeline_chunks=mode != "sync",
        async_detours=mode == "async",
        seed=11,
        # pinned sampling never samples <|audio|>: bound an event's text
        max_inline_text_tokens=16,
    )
    config.update(cfg_overrides)
    res = clone_resources(resources)
    agent = RealtimeAgent(resources=res, config=RealtimeAgentConfig(**config))
    if pin_audio:
        pin_codec_region(agent, res)
    return agent


def chunks(n, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=1600) * 0.1).astype(np.float32) for _ in range(n)]


def force_trans_once(agent, at_secs=0.4):
    """A state-based forced transcription: fires once when the processed
    audio clock crosses ``at_secs``, on every drive alike."""
    fired = {"done": False}
    orig = agent.should_force_transcription

    def f():
        if not fired["done"] and agent.total_secs >= at_secs:
            fired["done"] = True
            return True
        return orig()

    agent.should_force_transcription = f


def run_and_collect(agent, audio):
    """[(output, was filler)] of every call and of the drain."""
    emissions = []
    for c in audio:
        out = agent.process_audio(c)
        emissions.append((out, agent.last_emit_was_filler))
    while True:
        tail = agent.drain_pipeline()
        if tail is None:
            break
        emissions.append((tail, False))
    return emissions


def bench_events(agent, resources, sched) -> None:
    """The bench's scripted events (bench.py:718-788): forced events on the
    schedule {processed chunk: "trans" | "resp"}, each event's generated ids
    replaced by the canned text (the engine mirror rewritten to match, the
    KV keeping the sampled ids). Works on the JAX agent and the port's."""
    state = {"i": 0}
    agent.should_force_transcription = lambda: sched.get(state["i"]) == "trans"

    def force_response():
        fire = sched.get(state["i"]) == "resp"
        state["i"] += 1  # called once per processed chunk, after the transcription test
        return fire

    agent.should_force_response = force_response
    llm = resources.llm
    canned = resources.tokenizer.encode(CANNED_TEXT, add_special_tokens=False)
    orig_gen = llm.generate_until

    def canned_generate_until(first_token, stop_id, max_n=64, n_limit=None):
        toks, hit = orig_gen(first_token, stop_id, max_n=max_n, n_limit=n_limit)
        if not toks:
            return toks, hit
        out = [canned[j % len(canned)] for j in range(len(toks))]
        if hit:
            out[-1] = toks[-1]
        if len(toks) > 1:
            llm._input_ids[len(llm._input_ids) - (len(toks) - 1):] = out[:-1]
        return out, hit

    llm.generate_until = canned_generate_until


# -------------------------------------------------------------- against JAX

# trims about every second: start at 1.5 s of context, evict 1 s, the
# rebuild 32-token slices over a header cut to 0.5 s of enrollment;
# alternating forced events (the bench's schedule, cut to 3.2 s); a finalize
# cut to two tokens at the second response, absorbed into the trim in flight
DRIVE = dict(
    use_whisper=False, agent_opening_text=None, agent_voice_enrollment=np.zeros(8000, np.float32),
    force_trans_after_inactivity_secs=0.0, force_response_after_inactivity_secs=0.0,
    finalize_response_after_inactivity_secs=0.0,
    pipeline_chunks=True, async_detours=True, incremental_trim=True,
    max_context_secs=1.5, trim_by_secs=1.0, trim_rebuild_slice_tokens=32,
    max_inline_text_tokens=12, seed=7,
)
N_DRIVE = 32
DRIVE_SCHED = {7: "trans", 11: "resp", 19: "resp", 23: "trans"}


@pytest.fixture(scope="module")
def jax_and_port():
    """JAX resources (tiny, f32) and a factory of port resources over the
    same weights, converted."""
    vocab = CodecTextTokenizer(codebook_size=1024).vocab_size
    lcfg = jl.tiny_lm_config(vocab_size=vocab, codebook_size=1024, compute_dtype="float32")
    ccfg = jax_tiny_codec_config(compute_dtype="float32")
    jres = JaxResources(tiny=True, whisper_model=None, lm_config=lcfg, codec_config=ccfg, seed=0)
    lm = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jres.lm_params))
    cp = codec_params_from_numpy(jax.tree_util.tree_map(np.asarray, jres.audio_tokenizer.codec_model.params))

    def port_resources():
        return RealtimeAgentResources(
            tiny=True, device="cpu", _lm_params=lm, _codec_params=cp,
            lm_config=tl.DuplexLMConfig(**dataclasses.asdict(lcfg)),
            codec_config=tcodec.CodecConfig(**dataclasses.asdict(ccfg)),
        )

    return jres, port_resources


def _bench_drive(agent, resources, temperature):
    pin_codec_region(agent, resources)
    bench_events(agent, resources, DRIVE_SCHED)
    agent._improbable_run_cut = lambda ratio, tol: 2  # a deterministic finalize cut
    agent.reset()
    rng = np.random.default_rng(4)
    t = np.arange(N_DRIVE * 1600) / 16000
    audio = (0.2 * np.sin(2 * np.pi * 150 * t) * np.clip(np.sin(2 * np.pi * 0.7 * t), 0, 1)
             + 0.02 * rng.normal(size=t.shape)).astype(np.float32)
    outs = []
    for i in range(N_DRIVE):
        out = agent.process_audio(audio[i * 1600 : (i + 1) * 1600])
        if not agent.last_emit_was_filler:
            outs.append(out)
    outs.extend(agent.quiesce())
    return outs


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_bench_drive_matches_jax(jax_and_port, temperature):
    jres, port_resources = jax_and_port
    jres = jres.clone_for_self_play()
    tres = port_resources()
    jagent = JaxAgent(resources=jres, config=JaxConfig(**DRIVE, temperature=temperature))
    tagent = RealtimeAgent(resources=tres, config=RealtimeAgentConfig(**DRIVE, temperature=temperature))
    jouts = _bench_drive(jagent, jres, temperature)
    touts = _bench_drive(tagent, tres, temperature)

    assert tagent.input_ids == jagent.input_ids
    assert tagent.audio_tokens_idx == jagent.audio_tokens_idx
    assert tagent.transcript == jagent.transcript
    assert tagent.trim_to_secs == jagent.trim_to_secs >= 2 * DRIVE["trim_by_secs"]
    assert tagent.resources.llm.n_tokens == jagent.resources.llm.n_tokens
    assert tagent.resources.llm._step == jagent.resources.llm._step
    assert (tagent.finalize_absorbs, tagent.finalize_blocking) == (jagent.finalize_absorbs, jagent.finalize_blocking)
    assert tagent.finalize_absorbs >= 1
    assert len(tagent.detour_durations) >= 1
    assert len(touts) == len(jouts) == N_DRIVE
    for got, want in zip(touts, jouts):
        np.testing.assert_allclose(got, want, atol=1e-4)


# --------------------------------------------- against the port's sync agent

@pytest.fixture(scope="module")
def resources():
    return tiny_f32_resources()


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_pipelined_tokens_match_sync_audio_lags_one(resources, temperature):
    sync = make_agent(resources, "sync", temperature=temperature)
    pipe = make_agent(resources, "pipe", temperature=temperature)
    audio = chunks(5)
    sync_out, pipe_out = [], []
    for c in audio:
        sync_out.append(sync.process_audio(c))
        pipe_out.append(pipe.process_audio(c))
    tail = pipe.drain_pipeline()
    assert tail is not None
    pipe_out.append(tail)

    assert pipe.input_ids == sync.input_ids
    assert pipe.audio_tokens_idx == sync.audio_tokens_idx
    assert pipe.resources.llm.n_tokens == sync.resources.llm.n_tokens
    assert pipe.resources.llm._step == sync.resources.llm._step
    # audio one chunk late (the first pipelined emission is silence)
    np.testing.assert_array_equal(pipe_out[0], np.zeros(1600, np.float32))
    for i in range(5):
        np.testing.assert_allclose(pipe_out[i + 1], sync_out[i], atol=1e-5)


def test_pipelined_event_replay_matches_fused_samples(resources):
    """Unpinned sampling on random weights fires natural events within a few
    frames: the pipelined agent handles each one chunk late and ends with
    the synchronous agent's sequence and transcript."""
    sync = make_agent(resources, "sync", temperature=1.0, pin_audio=False)
    pipe = make_agent(resources, "pipe", temperature=1.0, pin_audio=False)
    for c in chunks(3, seed=5):
        sync.process_audio(c)
        pipe.process_audio(c)
    pipe.drain_pipeline()
    assert pipe.input_ids == sync.input_ids
    assert pipe.get_sequence_str() == sync.get_sequence_str()
    assert [t["text"] for t in pipe.transcript] == [t["text"] for t in sync.transcript]


def test_replay_resamples_identical_tokens(resources):
    """A fused chunk's samples and a stepwise replay of the same frames from
    the same step give the same tokens."""
    agent = make_agent(resources, "sync", temperature=1.0)
    audio = chunks(4, seed=8)
    agent.process_audio(audio[0])  # enter audio mode
    eng = agent.resources.llm
    session = agent._session
    session.bind_sequence(agent.input_ids)
    step_before, n_before = eng._step, eng.n_tokens
    res, _ = session.process_chunk(audio[1])
    assert res.event_frame == agent.chunk_size_frames_per_channel
    assert eng.n_tokens == n_before  # the host mirror is the agent's to commit
    eng._step = step_before
    replayed, pending = [], agent.input_ids[-2:]
    for i in range(agent.chunk_size_frames_per_channel):
        tok = eng.eval_and_sample(pending)
        replayed.append(tok)
        pending = [tok, res.user_tokens[i]]
    assert replayed == list(res.out_tokens)


def test_fused_path_survives_context_trim(resources):
    """After a trim the cache positions differ from sequence positions; the
    fused precondition holds in cache coordinates, both drives give the same
    tokens, and the fused chunk is used after the trim."""
    def trim_agent(mode):
        a = make_agent(resources, mode)
        a.config.max_context_secs = 1.0
        a.config.trim_by_secs = 0.5
        return a

    sync, pipe = trim_agent("sync"), trim_agent("pipe")
    for c in chunks(16, seed=4):
        sync.process_audio(c)
        pipe.process_audio(c)
    pipe.drain_pipeline()
    assert sync.trim_to_secs >= 0.5
    assert pipe.trim_to_secs == sync.trim_to_secs
    assert pipe.input_ids == sync.input_ids
    assert sync.resources.llm.n_tokens < len(sync.input_ids) - 2
    assert sync._fused_ready() and pipe._fused_ready()

    calls = {"n": 0}
    orig = pipe._session.dispatch_chunk

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    pipe._session.dispatch_chunk = counting
    for c in chunks(3, seed=9):
        pipe.process_audio(c)
    assert calls["n"] == 3


# ---------------------------------------------------------------- step fault

def test_two_dispatches_in_flight_draw_sync_keys(resources):
    """Chunk t+1 dispatched before chunk t is resolved draws the sampler keys
    that follow chunk t's (the chain's step advances at dispatch): the same
    tokens as the synchronous agent's two fused chunks, at seeded
    temperature 1.0."""
    audio = chunks(3, seed=6)
    ref, fly = (make_agent(resources, "sync", temperature=1.0) for _ in range(2))
    for a in (ref, fly):
        a.process_audio(audio[0])  # enter audio mode; the sampler step is past 0
    before = len(ref.audio_tokens_idx)
    for c in audio[1:]:
        ref.process_audio(c)  # two fused chunks, each resolved before the next
    want_agent = [ref.input_ids[i] for i in ref.audio_tokens_idx[before::2]]
    want_user = [ref.input_ids[i] for i in ref.audio_tokens_idx[before + 1 :: 2]]

    session, eng = fly._session, fly.resources.llm
    session.bind_sequence(fly.input_ids)
    session.sync_chain()
    step0 = eng._step
    handles = [session.dispatch_chunk(c) for c in audio[1:]]
    assert session.chain["step"] == step0 + 2 * fly.chunk_size_frames_per_channel
    got = [session.resolve(h)[0] for h in handles]
    assert all(r.event_frame == fly.chunk_size_frames_per_channel for r in got)
    assert got[0].out_tokens + got[1].out_tokens == want_agent
    assert got[0].user_tokens + got[1].user_tokens == want_user
    assert eng._step == ref.resources.llm._step
