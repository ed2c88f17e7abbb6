"""The port's incremental context trim and finalize absorb
(tests/test_trim_incremental.py's and tests/test_finalize_incremental.py's
contracts, the snapshot test aside), and its shadow-cache rebuild against the
JAX engine's.

With ``incremental_trim`` the trim's KV rebuild goes into a shadow cache one
prefill slice per processed chunk, then swaps; a finalize splice rides the
same pump/swap schedule, the live (pre-splice) cache serving until the swap.
The schedule depends only on processed chunks, so the synchronous and
pipelined drives give the same tokens. The swapped cache equals a
from-scratch ``eval`` at the JAX tests' 1e-4 (K/V) and 1e-3 (logits).
Tiny f32 configs.
"""
import dataclasses

import jax
import numpy as np
import pytest

from realtime_codec_agent_tpu.lm.engine import DuplexLMEngine as JaxEngine
from realtime_codec_agent_tpu.models import llama as jl
from realtime_codec_agent_tpu.tokenization import CodecTextTokenizer
from realtime_codec_agent_tpu_torch.lm.engine import DuplexLMEngine
from realtime_codec_agent_tpu_torch.models import llama as tl
from realtime_codec_agent_tpu_torch.models.from_jax import lm_params_from_numpy
from realtime_codec_agent_tpu_torch.ops.sampling import PENALTY_WINDOW
from tests.test_torch_pipeline import chunks, make_agent, one_torch_thread, tiny_f32_resources  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope="module")
def resources():
    return tiny_f32_resources()


def trim_agent(resources, pipeline: bool, incremental: bool = True, slice_tokens: int = 24):
    return make_agent(
        resources, "pipe" if pipeline else "sync", incremental_trim=incremental,
        trim_rebuild_slice_tokens=slice_tokens, max_context_secs=1.0, trim_by_secs=0.5,
    )


def finalize_agent(resources, pipeline: bool, slice_tokens: int = 24, **over):
    """Trims off unless a test opts in; the timer-driven finalize off (the
    tests call finalize_last_response at chosen chunk boundaries)."""
    kwargs = dict(
        finalize_response_after_inactivity_secs=0.0, incremental_trim=True,
        trim_rebuild_slice_tokens=slice_tokens, max_context_secs=100.0, trim_by_secs=0.5,
    )
    kwargs.update(over)
    return make_agent(resources, "pipe" if pipeline else "sync", **kwargs)


def assert_cache_matches_scratch(agent):
    """The live K/V equal a from-scratch eval of the engine mirror (the live
    cache mixes rebuild slices with fused-chunk commits); returns the fresh
    engine."""
    llm = agent.resources.llm
    fresh = DuplexLMEngine(llm.params, llm.cfg, device="cpu")
    fresh.eval(list(llm._input_ids))
    assert fresh.n_tokens == llm.n_tokens
    valid = llm.n_tokens
    np.testing.assert_allclose(llm._k[:, :, :valid].numpy(), fresh._k[:, :, :valid].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(llm._v[:, :, :valid].numpy(), fresh._v[:, :, :valid].numpy(), rtol=1e-4, atol=1e-4)
    return fresh


# ---------------------------------------------------------- incremental trim

def test_incremental_trim_sync_pipe_parity(resources):
    """Synchronous and pipelined agents with incremental trims give the same
    tokens, the trim swaps in, and the fused precondition holds after it."""
    sync = trim_agent(resources, pipeline=False)
    pipe = trim_agent(resources, pipeline=True)
    for c in chunks(20, seed=4):
        sync.process_audio(c)
        pipe.process_audio(c)
    pipe.drain_pipeline()

    assert sync.trim_to_secs >= 0.5, "incremental trim never swapped in"
    assert pipe.trim_to_secs == sync.trim_to_secs
    assert pipe.input_ids == sync.input_ids
    assert pipe.resources.llm.n_tokens == sync.resources.llm.n_tokens
    assert pipe.resources.llm._step == sync.resources.llm._step
    assert sync.resources.llm.n_tokens < len(sync.input_ids) - 2
    assert sync._fused_ready() and pipe._fused_ready()


def test_rebuild_spans_multiple_chunks(resources):
    """Between trigger and swap the agent keeps processing chunks on the live
    (untrimmed) cache."""
    agent = trim_agent(resources, pipeline=False, slice_tokens=48)
    window_chunks = 0
    for c in chunks(30, seed=4):
        agent.process_audio(c)
        if agent._trim_rebuild is not None:
            window_chunks += 1
    assert agent.trim_to_secs >= 0.5
    assert window_chunks >= 2, "rebuild finished in <2 chunks; not incremental"


def test_swapped_cache_matches_scratch_prefill(resources):
    """After the swap the engine's cache and logits equal a from-scratch
    eval of the same mirror."""
    agent = trim_agent(resources, pipeline=False)
    for c in chunks(22, seed=4):
        agent.process_audio(c)
    assert agent.trim_to_secs >= 0.5
    llm = agent.resources.llm
    fresh = assert_cache_matches_scratch(agent)
    pending = agent.input_ids[-2:]
    llm.eval(pending)
    fresh.eval(pending)
    np.testing.assert_allclose(llm._last_logits.numpy(), fresh._last_logits.numpy(), rtol=1e-3, atol=1e-3)


def test_restart_on_history_edit(resources):
    """An edit below the frozen watermark restarts the rebuild against the
    edited sequence; an edit above it does not."""
    agent = trim_agent(resources, pipeline=False, slice_tokens=8)
    found = False
    for c in chunks(20, seed=4):
        agent.process_audio(c)
        if agent._trim_rebuild is not None:
            found = True
            frozen_end = agent._trim_rebuild["frozen_end"]
            agent._trim_restart_on_edit(frozen_end - 4)
            assert agent._trim_rebuild is not None
            assert agent.resources.llm._rb_progress == 0
            agent.resources.llm.rebuild_pump(8)
            agent._trim_restart_on_edit(agent._trim_rebuild["frozen_end"] + 1)
            assert agent.resources.llm._rb_progress > 0
            break
    assert found, "rebuild window never observed"


def test_incremental_vs_blocking_both_valid(resources):
    """The blocking and incremental trims land on different chunks, and both
    end with a consistent cache / sequence mapping."""
    blocking = trim_agent(resources, pipeline=False, incremental=False)
    incr = trim_agent(resources, pipeline=False, incremental=True)
    for c in chunks(20, seed=4):
        blocking.process_audio(c)
        incr.process_audio(c)
    for agent in (blocking, incr):
        assert agent.trim_to_secs >= 0.5
        assert agent._fused_ready()
        assert agent.resources.llm.n_tokens == agent.cache_pos(len(agent.input_ids) - 2)


def test_occupancy_emergency_trim(resources):
    """The cache-occupancy guard triggers a trim long before the time-based
    policy would, with the same tokens on both drives; the blocking trim
    takes it too."""
    def occ_agent(pipeline, incremental=True):
        a = trim_agent(resources, pipeline=pipeline, incremental=incremental, slice_tokens=48)
        a.config.max_context_secs = 100.0  # the time trigger never fires here
        a.config.trim_occupancy_margin = a.resources.llm._k.shape[2] - 280
        return a

    sync, pipe = occ_agent(False), occ_agent(True)
    for c in chunks(24, seed=4):
        sync.process_audio(c)
        pipe.process_audio(c)
    pipe.drain_pipeline()
    assert sync.trim_to_secs >= 0.5, "occupancy trigger never fired"
    assert pipe.trim_to_secs == sync.trim_to_secs
    assert pipe.input_ids == sync.input_ids
    assert sync.resources.llm.n_tokens == pipe.resources.llm.n_tokens

    blocking = occ_agent(False, incremental=False)
    for c in chunks(24, seed=4):
        blocking.process_audio(c)
    assert blocking.trim_to_secs >= 0.5


# ----------------------------------------------------------- finalize absorb

def splice_audio_values(agent, lo_frame: int, n: int):
    """Change the values of ``n`` audio tokens from frame ``lo_frame`` in
    place (a splice with diff 0)."""
    idx = agent.audio_tokens_idx[lo_frame : lo_frame + n]
    cvs = agent.resources.tokenizer.codec_vocab_start
    for i in idx:
        agent.input_ids[i] = cvs + ((agent.input_ids[i] - cvs + 1) % 8)
    return idx[0], idx[-1] + 1


def drive_to_swap(agent, audio, max_chunks=30):
    """Process chunks until the pending rebuild swaps in."""
    for i, c in enumerate(audio[:max_chunks]):
        agent.process_audio(c)
        if agent._trim_rebuild is None:
            return i + 1
    raise AssertionError("rebuild never swapped in")


def inject_response(agent, text: str):
    """A completed agent response at a chunk boundary, as
    generate_for_response leaves it: ...<|end_audio|> A:<text><|audio|>, all
    but the trailing <|audio|> evaled, its transcript entry appended."""
    llm = agent.resources.llm
    tok = agent.resources.tokenizer
    llm.eval(agent.input_ids[-2:])  # the pending audio pair
    colon = tok.encode(":", add_special_tokens=False)
    assert len(colon) == 1
    text_ids = tok.encode(" " + text, add_special_tokens=False)
    ids = [agent.end_audio_token_id, agent.agent_speaker_token_id] + colon + text_ids + [agent.start_audio_token_id]
    speaker_pos = len(agent.input_ids) + 1
    agent.input_ids.extend(ids)
    llm.eval(ids[:-1])  # the trailing <|audio|> stays pending (text mode)
    agent.transcript.append({
        "speaker": agent.config.agent_identity, "text": text, "start_secs": agent.total_secs,
        "end_secs": None, "text_start_pos": speaker_pos, "text_with_external_markers": text,
    })
    agent._chain_dirty = True
    return speaker_pos + 2, text_ids


def test_absorb_swapped_cache_matches_scratch(resources):
    """A value splice absorbed: the live prefix is reused, the cache
    coordinates hold during the stale window, and the swapped cache equals a
    from-scratch prefill of the spliced mirror."""
    agent = finalize_agent(resources, pipeline=False, slice_tokens=16)
    audio = chunks(40, seed=4)
    for c in audio[:16]:
        agent.process_audio(c)
    assert agent._trim_rebuild is None

    s, e = splice_audio_values(agent, lo_frame=40, n=6)
    assert e <= len(agent.input_ids) - PENALTY_WINDOW, "test setup: splice too close to tail"
    assert agent._absorb_finalize_splice(s, e, 0) is True
    assert agent._stale_splice == (s, e, 0)
    assert agent._trim_rebuild is not None
    assert agent._trim_rebuild["to_secs"] == agent.trim_to_secs
    assert agent.resources.llm._rb_progress == agent.cache_pos(s)
    assert agent._fused_ready()

    assert drive_to_swap(agent, audio[16:]) >= 2, "absorb swapped immediately; not incremental"
    assert agent._stale_splice is None
    cs = agent.cache_pos(s)
    assert agent.resources.llm._input_ids[cs : cs + (e - s)] == agent.input_ids[s:e]
    assert_cache_matches_scratch(agent)


def test_finalize_absorb_end_to_end_with_diff(resources):
    """A full finalize_last_response through the absorb: the text splice
    shrinks the sequence, the stale window's coordinates hold, and the
    swapped cache is right."""
    agent = finalize_agent(resources, pipeline=False, slice_tokens=16)
    audio = chunks(50, seed=7)
    for c in audio[:4]:
        agent.process_audio(c)
    splice_start, _ = inject_response(agent, "hello there my good friend")
    for c in audio[4:16]:
        agent.process_audio(c)
    assert agent._trim_rebuild is None

    len_before = len(agent.input_ids)
    n_before = agent.resources.llm.n_tokens
    agent.ch1_inactivity_elapsed_secs = 0.1
    agent._improbable_run_cut = lambda ratio, tol: 2  # a deterministic cut
    agent.finalize_last_response()

    diff = len(agent.input_ids) - len_before
    assert diff < 0, "finalize did not shrink the planned text"
    ss, _, sd = agent._stale_splice
    assert (ss, sd) == (splice_start, diff)
    assert agent.resources.llm.n_tokens == n_before  # no blocking recompute
    assert agent._fused_ready()
    assert agent.last_response["text"] != agent.last_response["planned_text"]
    assert (agent.finalize_absorbs, agent.finalize_blocking) == (1, 0)

    assert drive_to_swap(agent, audio[16:]) >= 2
    assert agent._stale_splice is None
    assert agent.resources.llm.n_tokens == agent.cache_pos(len(agent.input_ids) - 2)
    assert_cache_matches_scratch(agent)


def test_finalize_absorb_sync_pipe_parity(resources):
    """Synchronous and pipelined agents give the same tokens through an
    absorbed finalize splice."""
    def run(pipeline):
        agent = finalize_agent(resources, pipeline=pipeline, slice_tokens=16)
        audio = chunks(34, seed=9)
        for c in audio[:4]:
            agent.process_audio(c)
        agent.drain_pipeline()
        inject_response(agent, "hello there my good friend")
        for c in audio[4:16]:
            agent.process_audio(c)
        agent.drain_pipeline()
        agent.ch1_inactivity_elapsed_secs = 0.1
        agent._improbable_run_cut = lambda ratio, tol: 2
        agent.finalize_last_response()
        assert agent._stale_splice is not None
        for c in audio[16:]:
            agent.process_audio(c)
        agent.drain_pipeline()
        assert agent._stale_splice is None, "absorb never swapped"
        return agent

    sync, pipe = run(False), run(True)
    assert pipe.input_ids == sync.input_ids
    assert pipe.resources.llm.n_tokens == sync.resources.llm.n_tokens
    assert pipe.resources.llm._step == sync.resources.llm._step
    assert pipe.resources.llm._input_ids == sync.resources.llm._input_ids


def test_tail_adjacent_splice_falls_back_to_blocking(resources):
    """A splice inside the penalty window of the tail falls back to the
    blocking recompute (the fused chain and the stepwise sampler would see
    different penalty windows)."""
    agent = finalize_agent(resources, pipeline=False)
    audio = chunks(12, seed=5)
    for c in audio[:4]:
        agent.process_audio(c)
    inject_response(agent, "hello there my good friend")
    for c in audio[4:6]:
        agent.process_audio(c)
    agent.ch1_inactivity_elapsed_secs = 0.1
    agent._improbable_run_cut = lambda ratio, tol: 2
    agent.finalize_last_response()
    assert agent._stale_splice is None and agent._trim_rebuild is None
    assert agent._absorb_reject == "splice inside penalty window"
    assert (agent.finalize_absorbs, agent.finalize_blocking) == (0, 1)
    assert agent.resources.llm.n_tokens == agent.cache_pos(len(agent.input_ids) - 2)
    assert_cache_matches_scratch(agent)


def test_incremental_finalize_off_uses_blocking(resources):
    agent = finalize_agent(resources, pipeline=False, incremental_finalize=False)
    audio = chunks(20, seed=6)
    for c in audio[:4]:
        agent.process_audio(c)
    inject_response(agent, "hello there my good friend")
    for c in audio[4:16]:
        agent.process_audio(c)
    agent.ch1_inactivity_elapsed_secs = 0.1
    agent._improbable_run_cut = lambda ratio, tol: 2
    agent.finalize_last_response()
    assert agent._stale_splice is None
    assert agent._absorb_reject == "disabled"
    assert agent.resources.llm.n_tokens == agent.cache_pos(len(agent.input_ids) - 2)
    assert_cache_matches_scratch(agent)


def test_edit_below_splice_sync_materializes(resources):
    """An edit at or below a pending splice widens the blocking recompute
    over the splice, clears the stale window and drops the absorb."""
    agent = finalize_agent(resources, pipeline=False)
    for c in chunks(16, seed=8):
        agent.process_audio(c)
    s, e = splice_audio_values(agent, lo_frame=60, n=6)
    assert agent._absorb_finalize_splice(s, e, 0) is True
    s2, e2 = splice_audio_values(agent, lo_frame=30, n=4)
    assert s2 < s
    agent.recompute_kv_cache(s2, e2)
    assert agent._stale_splice is None
    assert agent._trim_rebuild is None  # the pure absorb dropped, not restarted
    assert agent.resources.llm.n_tokens == agent.cache_pos(len(agent.input_ids) - 2)
    assert_cache_matches_scratch(agent)


def test_edit_above_splice_keeps_absorb(resources):
    """An in-place edit ABOVE a pending splice re-evals at stale coordinates
    while the absorb keeps its live-prefix reuse and pumps on."""
    agent = finalize_agent(resources, pipeline=False, slice_tokens=8)
    audio = chunks(40, seed=8)
    for c in audio[:16]:
        agent.process_audio(c)
    s, e = splice_audio_values(agent, lo_frame=40, n=6)
    assert agent._absorb_finalize_splice(s, e, 0) is True
    s2, e2 = splice_audio_values(agent, lo_frame=120, n=4)
    assert s2 >= e
    agent.recompute_kv_cache(s2, e2)
    assert agent._stale_splice == (s, e, 0)
    assert agent._trim_rebuild is not None
    assert agent.resources.llm._rb_progress == agent.cache_pos(s)
    drive_to_swap(agent, audio[16:])
    assert agent._stale_splice is None
    assert_cache_matches_scratch(agent)


def test_absorb_during_trim_rebuild_refreezes_trim(resources):
    """A splice while a trim rebuild is in flight re-freezes the TRIM (its
    own target, a full rebuild) against the spliced sequence; its swap
    absorbs the splice."""
    agent = finalize_agent(resources, pipeline=False, slice_tokens=16, max_context_secs=1.0)
    seen = False
    for c in chunks(60, seed=4):
        agent.process_audio(c)
        if agent._trim_rebuild is not None and not seen:
            rb_to = agent._trim_rebuild["to_secs"]
            assert rb_to > agent.trim_to_secs  # a real trim, not an absorb
            lo = max(agent.frames_from_secs(agent.trim_to_secs), 60)
            s, e = splice_audio_values(agent, lo_frame=lo + 8, n=6)
            if e > len(agent.input_ids) - PENALTY_WINDOW:
                continue  # too close to the tail this chunk; try the next
            assert agent._absorb_finalize_splice(s, e, 0) is True
            assert agent._trim_rebuild["to_secs"] == rb_to
            assert agent.resources.llm._rb_progress == 0  # a full re-freeze
            assert agent._stale_splice == (s, e, 0)
            seen = True
        elif seen and agent._trim_rebuild is None:
            break
    assert seen, "trim rebuild window never observed"
    assert agent._stale_splice is None, "the trim swap did not clear the stale window"
    assert agent.trim_to_secs >= 0.5
    assert agent._fused_ready()
    assert_cache_matches_scratch(agent)


# ----------------------------------------------------- against the JAX engine

def test_rebuild_matches_jax_engine():
    """rebuild_begin + slices + swap, and rebuild_begin_from_live, on the
    port's engine against the JAX engine's on the same weights: the same
    mirror and n_tokens, K/V and last logits within 1e-4 / 1e-3."""
    vocab = CodecTextTokenizer(codebook_size=1024).vocab_size
    lcfg = jl.tiny_lm_config(vocab_size=vocab, codebook_size=1024, max_context=1024, compute_dtype="float32")
    jparams = jl.fuse_lm_params_for_decode(jl.init_lm_params(jax.random.PRNGKey(3), lcfg))
    jeng = JaxEngine(jparams, lcfg)
    teng = DuplexLMEngine(
        lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams)),
        tl.DuplexLMConfig(**dataclasses.asdict(lcfg)), device="cpu",
    )
    rng = np.random.default_rng(0)
    live = [int(t) for t in rng.integers(0, vocab, size=300)]
    target = live[:40] + [int(t) for t in rng.integers(0, vocab, size=180)]
    remaining = []
    for eng in (jeng, teng):
        eng.eval(live)
        eng.rebuild_begin(target)
        remaining.append([eng.rebuild_pump(48) for _ in range(3)])  # three slices across "chunks"
        eng.rebuild_extend(target[:5])
        eng.rebuild_pump(1000)
        eng.rebuild_swap()
    assert remaining[0] == remaining[1] == [len(target) - 48 * i for i in (1, 2, 3)]
    n = teng.n_tokens
    assert n == jeng.n_tokens == len(target) + 5 and teng._input_ids == jeng._input_ids
    np.testing.assert_allclose(teng._k[:, :, :n].numpy(), np.asarray(jeng._k[:, :, :n], np.float32), atol=1e-4)
    np.testing.assert_allclose(teng._v[:, :, :n].numpy(), np.asarray(jeng._v[:, :, :n], np.float32), atol=1e-4)
    np.testing.assert_allclose(teng._last_logits.numpy(), np.asarray(jeng._last_logits), atol=1e-3)

    # a suffix edit at unchanged positions: the shadow starts as a copy of
    # the live cache and only the suffix re-prefills
    edited = list(teng._input_ids[:150]) + [int(t) for t in rng.integers(0, vocab, size=30)]
    for eng in (jeng, teng):
        eng.rebuild_begin_from_live(edited, 150)
        eng.rebuild_pump(16)
        eng.rebuild_pump(1000)
        eng.rebuild_swap()
    n = teng.n_tokens
    assert n == jeng.n_tokens == len(edited) and teng._input_ids == jeng._input_ids
    np.testing.assert_allclose(teng._k[:, :, :n].numpy(), np.asarray(jeng._k[:, :, :n], np.float32), atol=1e-4)
    np.testing.assert_allclose(teng._last_logits.numpy(), np.asarray(jeng._last_logits), atol=1e-3)
    # the swap exchanged references: the old live cache is the next shadow
    assert teng._rb_k is not teng._k and teng._rb_k.shape == teng._k.shape
