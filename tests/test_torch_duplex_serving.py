"""The port's duplex serving server (serving/duplex_server.py): R concurrent
full-duplex calls over TCP, on the CPU with the tiny models. The mirror of
tests/test_duplex_serving.py:

- two concurrent calls stream chunks and get agent audio and a report;
  without events they ride the group program;
- a served call's audio is bit for bit a direct RealtimeAgent's with the
  same seed and config on the same chunks (the slot pool and the group
  coordinator only schedule; these checks serve without async detours,
  whose filler placement follows wall time);
- slots are reused across calls, and a full server refuses the next call;
- ``devices=["cpu", "cpu"]`` splits the slots into replicated pools;
- a live call migrates through a snapshot;
- a stale release leaves a re-claimed slot alone, and a corrupt snapshot
  ends its call with a wire error;
- a bad config and a bad chunk are refused;
- the interleaved drive serves what the split drive serves;
- the server runs on the card unless asked for the CPU, and does not fall
  back.

Every socket, thread join and queue wait is bounded; each server shuts
down in a ``finally``.
"""
import dataclasses
import pickle
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu_torch.agent.agent import RealtimeAgent
from realtime_codec_agent_tpu_torch.serving.duplex_client import DuplexCall
from realtime_codec_agent_tpu_torch.serving.duplex_server import DuplexServingServer, serve
from test_torch_pipeline import one_torch_thread  # noqa: F401 (a module fixture)

N_CHUNKS = 6
TIMEOUT = 60.0


@contextmanager
def running(**kw):
    """A tiny CPU server on an ephemeral port, shut down on exit."""
    duplex = DuplexServingServer(tiny=True, device="cpu", underrun_timeout_secs=30.0, **kw)
    srv = serve(duplex, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv.server_address[1], duplex
    finally:
        srv.shutdown()
        duplex.shutdown()
        t.join(TIMEOUT)


@pytest.fixture(scope="module")
def duplex_srv():
    with running(max_calls=2) as pair:
        yield pair


def _no_detours():
    """The served config without async detours: with them a call emits
    silence filler while a detour runs, so where its audio lands depends on
    wall time (the token stream does not); the bit-for-bit audio checks
    use the pipelined drive alone."""
    from realtime_codec_agent_tpu_torch.agent.config import RealtimeAgentConfig

    return RealtimeAgentConfig(use_whisper=False, pipeline_chunks=True, async_detours=False, incremental_trim=True)


def _call(port, **kw):
    return DuplexCall(port=port, timeout=TIMEOUT, **kw)


def _stream(port, seed, chunks):
    call = _call(port, config={"seed": seed})
    for c in chunks:
        call.send_chunk(c)
    return call, call.hangup(timeout=TIMEOUT)


def _user_chunks(seed, n, chunk_samples):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.normal(size=chunk_samples)).astype(np.float32) for _ in range(n)]


def _direct_wire_audio(duplex, slot, seed, chunks):
    """A direct agent over fresh caches on the slot's weights, its audio as
    the wire carries it (int16 / 32768)."""
    cfg = dataclasses.replace(duplex.base_config, seed=seed)
    agent = RealtimeAgent(resources=duplex.slots[slot].agent.resources.clone_for_self_play(), config=cfg)
    out = [np.asarray(agent.process_audio(c), np.float32) for c in chunks]
    tail = agent.drain_pipeline()
    if tail is not None:
        out.append(np.asarray(tail, np.float32))
    audio = np.concatenate(out)
    return (np.clip(np.nan_to_num(audio), -1.0, 1.0) * 32767.0).astype("<i2").astype(np.float32) / 32768.0


def test_two_concurrent_calls(duplex_srv):
    port, duplex = duplex_srv
    n = duplex.chunk_samples
    results = {}

    def run(name, seed, chunks):
        results[name] = _stream(port, seed, chunks)

    threads = [threading.Thread(target=run, args=(name, seed, _user_chunks(cs, N_CHUNKS, n)))
               for name, seed, cs in (("a", 7, 100), ("b", 8, 200))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
    assert set(results) == {"a", "b"}
    for name in ("a", "b"):
        call, report = results[name]
        audio = call.collected_audio()
        assert report["type"] == "report"
        assert report["chunks"] == N_CHUNKS and report["underruns"] == 0
        # pipelined: every processed chunk emits one output chunk (+ the drained tail)
        assert len(audio) >= N_CHUNKS * n
        assert np.isfinite(audio).all()


def _pin(agent) -> None:
    """Every sample in the codec region (the bench's serving cell does the
    same): no natural events, so the calls stay on the fused path."""
    res, orig = agent.resources, agent.set_sampler

    def pinned(for_trans=False, suppress_end_audio=False):
        orig(for_trans=for_trans, suppress_end_audio=suppress_end_audio)
        res.llm.settings.min_token_id = res.tokenizer.codec_vocab_start

    agent.set_sampler = pinned


def test_pinned_calls_ride_the_group_program():
    """Two concurrent calls without events (pinned sampling, no forced
    events): after each call's first chunks (synchronous, on the detour
    thread) the ticks launch the batch-2 program. (Timeout flushes are
    held to 0 on the card, chip_smoke phase 12: here a loaded CPU can take
    longer than the 2 s timeout for a detour.)"""
    quiet = {"force_trans_after_inactivity_secs": 0.0, "force_response_after_inactivity_secs": 0.0}
    n_chunks = 16
    with running(max_calls=2) as (port, duplex):
        for slot in duplex.slots:
            _pin(slot.agent)
        calls = [_call(port, config={"seed": seed, **quiet}) for seed in (7, 8)]
        streams = [_user_chunks(seed, n_chunks, duplex.chunk_samples) for seed in (100, 200)]
        for chunks2 in zip(*streams):
            for call, c in zip(calls, chunks2):
                call.send_chunk(c)
        reports = [call.hangup(timeout=TIMEOUT) for call in calls]
        assert [r["chunks"] for r in reports] == [n_chunks, n_chunks]
        stats = duplex.stats()["pools"][0]
        assert stats["paired_dispatches"] >= n_chunks // 4, stats


def test_served_call_matches_direct_agent():
    with running(max_calls=2, config=_no_detours()) as (port, duplex):
        chunks = _user_chunks(300, N_CHUNKS, duplex.chunk_samples)
        call, report = _stream(port, 21, chunks)
        served = call.collected_audio()
        assert report["underruns"] == 0
        direct = _direct_wire_audio(duplex, call.slot, 21, chunks)
        assert len(served) == len(direct)
        np.testing.assert_array_equal(served, direct)


def test_slot_reuse_and_server_full(duplex_srv):
    port, duplex = duplex_srv
    chunks = _user_chunks(400, 2, duplex.chunk_samples)
    c1 = _call(port, config={"seed": 1})
    c2 = _call(port, config={"seed": 2})
    with pytest.raises(RuntimeError, match="server full"):
        _call(port, config={"seed": 3})
    for c in chunks:
        c1.send_chunk(c)
        c2.send_chunk(c)
    r1, r2 = c1.hangup(timeout=TIMEOUT), c2.hangup(timeout=TIMEOUT)
    assert r1["type"] == "report" and r2["type"] == "report"
    _, r3 = _stream(port, 4, chunks)  # the slots are free again
    assert r3["type"] == "report" and r3["chunks"] == 2


def test_multi_device_pools():
    """devices=["cpu", "cpu"]: the slots split into two replicated pools,
    pool 1 on its own copy of the weights; calls spread over the pools,
    and a call served from pool 1 is bit for bit a direct agent's."""
    with running(max_calls=4, devices=["cpu", "cpu"], config=_no_detours()) as (port, duplex):
        assert len(duplex.pools) == 2
        assert [s.idx for s in duplex.pools[1].slots] == [2, 3]
        p0 = duplex.slots[0].agent.resources.lm_params["final_norm"]
        p1 = duplex.slots[2].agent.resources.lm_params["final_norm"]
        assert p1.device == torch.device("cpu") and p1.data_ptr() != p0.data_ptr()
        torch.testing.assert_close(p1, p0, rtol=0, atol=0)
        assert duplex.pools[1].coordinator is not None

        chunks = _user_chunks(500, N_CHUNKS, duplex.chunk_samples)
        # fill pool 0 so the third call lands on pool 1 (slot 2); no other
        # claim while it streams
        hold = [_call(port, config={"seed": s}) for s in (1, 2)]
        call = _call(port, config={"seed": 31})
        assert call.slot == 2
        for c in chunks:
            call.send_chunk(c)
        report = call.hangup(timeout=TIMEOUT)
        served = call.collected_audio()
        assert report["underruns"] == 0

        c4, c5 = _call(port, config={"seed": 4}), _call(port, config={"seed": 5})
        assert {c4.slot, c5.slot} == {2, 3}
        with pytest.raises(RuntimeError, match="server full"):
            _call(port, config={"seed": 6})
        for c in (c4, c5, *hold):
            c.hangup(timeout=TIMEOUT)

        direct = _direct_wire_audio(duplex, 2, 31, chunks)
        assert len(served) == len(direct)
        np.testing.assert_array_equal(served, direct)


def test_call_migration_via_snapshot(duplex_srv):
    """A mid-call snapshot over the wire, then a resume as a new call: the
    resumed call carries the sequence forward and keeps streaming."""
    port, duplex = duplex_srv
    n = duplex.chunk_samples
    chunks = _user_chunks(600, N_CHUNKS, n)
    call = _call(port, config={"seed": 41})
    for c in chunks[:3]:
        call.send_chunk(c)
    st = call.stats(timeout=TIMEOUT)
    assert st["type"] == "stats" and st["max_calls"] == 2 and st["active_calls"] >= 1
    blob = call.snapshot(timeout=TIMEOUT)
    assert isinstance(blob, bytes) and len(blob) > 0
    assert call.last_snapshot_chunks == 3  # the client's resend point
    seq_len = len(pickle.loads(blob)["input_ids"])
    assert call.hangup(timeout=TIMEOUT)["type"] == "report"

    resumed = _call(port, snapshot=blob)
    for c in chunks[3:]:
        resumed.send_chunk(c)
    report = resumed.hangup(timeout=TIMEOUT)
    audio = resumed.collected_audio()
    assert report["type"] == "report" and report["chunks"] == N_CHUNKS - 3
    assert len(audio) >= (N_CHUNKS - 3) * n and np.isfinite(audio).all()
    # the resumed slot's sequence grew from the snapshot, not from a reset
    assert len(duplex.slots[resumed.slot].agent.input_ids) > seq_len
    assert duplex.stats()["pools"][0]["ticks"] >= N_CHUNKS


def test_stale_release_and_activation_failure(duplex_srv):
    port, duplex = duplex_srv
    idx1, gen1, _, _ = duplex.claim({"seed": 51})
    duplex.release(idx1, gen1)
    idx2, gen2, _, _ = duplex.claim({"seed": 52})
    assert idx2 == idx1 and gen2 == gen1 + 1
    assert duplex.release(idx1, gen1)["chunks"] == 0  # the old call's handler retrying
    slot = duplex.slots[idx2]
    assert slot.active or slot.pending_cfg is not None
    duplex.release(idx2, gen2)

    good = _call(port, config={"seed": 53})
    good.send_chunk(np.zeros(duplex.chunk_samples, np.float32))
    blob = good.snapshot(timeout=TIMEOUT)
    good.hangup(timeout=TIMEOUT)
    snap = pickle.loads(blob)
    snap["engine_n_tokens"] += 1  # the restore's cache-length check fires
    bad = _call(port, snapshot=pickle.dumps(snap))
    deadline = time.monotonic() + TIMEOUT
    while bad.report is None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert bad.report is not None and bad.report["type"] == "error"
    assert "activation failed" in bad.report["message"]
    bad.hangup(timeout=TIMEOUT)


def test_rejects_bad_config_and_bad_chunk(duplex_srv):
    port, duplex = duplex_srv
    with pytest.raises(RuntimeError, match="not overridable"):
        _call(port, config={"chunk_size_secs": 0.2})
    call = _call(port, config={})
    call.send_chunk(np.zeros(duplex.chunk_samples + 1, np.float32))
    assert call.hangup(timeout=TIMEOUT).get("type") in ("error", "report")


def test_no_split_drive_serves_identically():
    """The interleaved drive (dispatch and resolve a slot at a time) serves
    the same audio as the split drive: the drives differ only in
    scheduling."""
    outs = {}
    for split in (True, False):
        with running(max_calls=2, split_drive=split, config=_no_detours()) as (port, duplex):
            call, report = _stream(port, 33, _user_chunks(500, N_CHUNKS, duplex.chunk_samples))
            assert report["underruns"] == 0
            outs[split] = call.collected_audio()
    np.testing.assert_array_equal(outs[True], outs[False])


def test_server_runs_on_the_card_unless_asked():
    """The default device is cuda: without a card the server refuses to
    start instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DuplexServingServer(max_calls=2, tiny=True)
