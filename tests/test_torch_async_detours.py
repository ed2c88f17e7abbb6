"""The port's async detours (tests/test_async_detours.py's contract, its
external-LLM test aside): heavy chunks (events, trim steps, an event
chunk's replay) run on the detour thread while the agent emits silence
filler, then the backlog catches up. The token stream and transcript are the
synchronous agent's (the blocking pipelined agent's where forced-event
timers lag by the pipeline's one chunk); the emitted audio is that agent's
output stream with filler chunks interleaved. Tiny f32 configs.
"""
import time
import warnings

import numpy as np
import pytest
import torch

from tests.test_torch_pipeline import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    chunks, force_trans_once, make_agent, one_torch_thread, run_and_collect, tiny_f32_resources,
)


@pytest.fixture(scope="module")
def resources():
    return tiny_f32_resources()


def test_async_tokens_match_sync_natural_events(resources):
    """Unpinned sampling on random weights fires natural events: the async
    agent ends with the synchronous agent's sequence and transcript."""
    sync = make_agent(resources, "sync", temperature=1.0, pin_audio=False)
    asyn = make_agent(resources, "async", temperature=1.0, pin_audio=False)
    audio = chunks(4, seed=5)
    for c in audio:
        sync.process_audio(c)
    run_and_collect(asyn, audio)

    assert asyn.input_ids == sync.input_ids
    assert asyn.get_sequence_str() == sync.get_sequence_str()
    assert [t["text"] for t in asyn.transcript] == [t["text"] for t in sync.transcript]
    assert asyn.resources.llm.n_tokens == sync.resources.llm.n_tokens
    assert asyn.resources.llm._step == sync.resources.llm._step


def test_async_forced_event_tokens_and_emissions(resources):
    """A forced event detours in the background: the tokens are the blocking
    pipelined agent's, and the non-filler emissions are its outputs in order
    (fillers only interleave, and are silence)."""
    pipe = make_agent(resources, "pipe")
    asyn = make_agent(resources, "async")
    force_trans_once(pipe)
    force_trans_once(asyn)
    audio = chunks(8, seed=7)
    pipe_emissions = run_and_collect(pipe, audio)
    emissions = run_and_collect(asyn, audio)

    assert asyn.input_ids == pipe.input_ids
    assert [t["text"] for t in asyn.transcript] == [t["text"] for t in pipe.transcript]
    pipe_out = [e for e, _ in pipe_emissions[1:]]
    non_filler = [e for e, filler in emissions if not filler]
    assert len(non_filler) == len(pipe_out)
    for got, want in zip(non_filler, pipe_out):
        np.testing.assert_allclose(got, want, atol=1e-5)
    for e, filler in emissions:
        if filler:
            np.testing.assert_array_equal(e, np.zeros(1600, np.float32))


def test_async_with_incremental_trim(resources):
    """Async detours compose with incremental trims: the synchronous
    incremental-trim agent's tokens across a trim swap."""
    trim = dict(incremental_trim=True, max_context_secs=1.0, trim_by_secs=0.5, trim_rebuild_slice_tokens=24)
    sync = make_agent(resources, "sync", **trim)
    asyn = make_agent(resources, "async", **trim)
    audio = chunks(20, seed=4)
    for c in audio:
        sync.process_audio(c)
    run_and_collect(asyn, audio)

    assert sync.trim_to_secs >= 0.5
    assert asyn.trim_to_secs == sync.trim_to_secs
    assert asyn.input_ids == sync.input_ids
    assert asyn.resources.llm.n_tokens == sync.resources.llm.n_tokens


def test_async_filler_counter(resources):
    """The agent counts the filler chunks it emitted."""
    asyn = make_agent(resources, "async")
    force_trans_once(asyn)
    run_and_collect(asyn, chunks(8, seed=7))
    assert asyn.n_filler_emitted >= 1  # at least the pipeline's priming chunk


def test_detour_failure_does_not_wedge_session(resources):
    """A detour that raises must not deadlock or crash later calls: the chain
    resyncs and a silence chunk stands in for the lost output."""
    asyn = make_agent(resources, "async")
    audio = chunks(6, seed=12)
    asyn.process_audio(audio[0])
    asyn.drain_pipeline()

    orig_sync = asyn._process_chunk_sync
    blew = {"done": False}

    def exploding(*a, **kw):
        if not blew["done"]:
            blew["done"] = True
            raise RuntimeError("injected transient device failure")
        return orig_sync(*a, **kw)

    asyn._process_chunk_sync = exploding
    force_trans_once(asyn, at_secs=0.0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        outs = [asyn.process_audio(c) for c in audio[1:]]
        while asyn.drain_pipeline() is not None:
            pass
    assert any("background detour failed" in str(w.message) for w in caught)
    for o in outs:
        assert o.shape == (1600,)
    out = asyn.process_audio(chunks(1, seed=13)[0])
    assert out.shape == (1600,)
    asyn.drain_pipeline()
    assert asyn.total_secs > 0.2


def test_per_call_blocking_attribution(resources):
    """Every call exposes last_call_acct, named wall-time sections (fetch
    wait, dispatch, chain resync, detour join); detour-thread work never
    lands in a foreground call's dict."""
    asyn = make_agent(resources, "async")
    seen = set()
    for c in chunks(24, seed=21):
        asyn.process_audio(c)
        acct = asyn.last_call_acct
        assert isinstance(acct, dict)
        assert all(v >= 0.0 for v in acct.values())
        seen.update(acct)
        # pace so that detours finish and the pump reaches the fused path
        fut = asyn._detour_future
        if fut is not None:
            for _ in range(400):
                if fut.done():
                    break
                time.sleep(0.02)
    while asyn.drain_pipeline() is not None:
        pass
    assert "dispatch" in seen and "fetch" in seen, seen


def test_split_drive_async_matches_plain(resources):
    """The split dispatch/resolve drive in async mode gives the plain drive's
    tokens and transcript; only filler placement may differ."""
    plain = make_agent(resources, "async")
    split = make_agent(resources, "async")
    audio = chunks(20, seed=31)
    force_trans_once(plain, at_secs=0.5)
    force_trans_once(split, at_secs=0.5)
    for c in audio:
        plain.process_audio(c)
    while plain.drain_pipeline() is not None:
        pass
    for c in audio:
        split.process_audio_dispatch(c)
        out = split.process_audio_resolve()
        assert out is None or out.shape == (1600,)
    while split.drain_pipeline() is not None:
        pass
    assert split.input_ids == plain.input_ids
    assert split.get_sequence_str() == plain.get_sequence_str()
    assert [t["text"] for t in split.transcript] == [t["text"] for t in plain.transcript]


def test_detour_runs_in_the_callers_grad_mode(resources):
    """Grad mode is thread-local in torch: a detour runs in the calling
    thread's mode (here inference under no_grad), so it builds no graph."""
    asyn = make_agent(resources, "async")
    modes = []
    orig_sync = asyn._process_chunk_sync

    def recording(*a, **kw):
        modes.append(torch.is_grad_enabled())
        return orig_sync(*a, **kw)

    asyn._process_chunk_sync = recording
    force_trans_once(asyn, at_secs=0.2)
    with torch.no_grad():
        run_and_collect(asyn, chunks(5, seed=2))
    assert modes and not any(modes)
