"""Grouped sessions of the port (lm/pair_session.py), on the CPU.

Against the JAX package (tiny f32 weights converted with models/from_jax):
``forward_decode_pair`` at R = 2 and 3, with and without earlier
uncommitted pairs (hidden states and new K/V within 1e-5 relative); the row
draw ``sample_token_rows`` against ``jax.vmap`` of the JAX sampler with
``fold_in`` keys (ids equal); and the slice as a whole, two self-play
agents cross-fed and paired in each package (the same ids every chunk,
audio within 1e-4).

Against the port's own ungrouped agents (the mirrors of
tests/test_pair_session.py): grouping only schedules, so every grouped run
gives the ungrouped run's tokens and audio bit for bit, across clean
chunks, events with their replays and halted successors, drains, resets,
three rows, failed flushes and launches, and the split and async drives.

Tiny f32 configs: f32 keeps the grouped and single programs' numeric
difference far below a sampled token's margin (here they agree bit for bit).
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.agent.agent import RealtimeAgent as JaxAgent
from realtime_codec_agent_tpu.agent.config import RealtimeAgentConfig as JaxConfig
from realtime_codec_agent_tpu.agent.resources import RealtimeAgentResources as JaxResources
from realtime_codec_agent_tpu.lm import pair_session as jpair
from realtime_codec_agent_tpu.models import llama as jl
from realtime_codec_agent_tpu.models.codec import tiny_codec_config as jax_tiny_codec_config
from realtime_codec_agent_tpu.ops import sampling as jsampling
from realtime_codec_agent_tpu.tokenization import CodecTextTokenizer
from realtime_codec_agent_tpu_torch.agent.agent import RealtimeAgent
from realtime_codec_agent_tpu_torch.agent.config import RealtimeAgentConfig
from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources
from realtime_codec_agent_tpu_torch.lm.pair_session import group_duplex_agents, pair_self_play_agents
from realtime_codec_agent_tpu_torch.models import codec as tcodec
from realtime_codec_agent_tpu_torch.models import llama as tl
from realtime_codec_agent_tpu_torch.models.from_jax import codec_params_from_numpy, lm_params_from_numpy
from realtime_codec_agent_tpu_torch.ops import sampling as tsampling
from test_torch_pipeline import one_torch_thread, tiny_f32_resources  # noqa: F401 (a module fixture)

CHUNK = 1600
REL = 1e-5


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------- against the JAX package

@pytest.fixture(scope="module")
def tiny_lm():
    vocab = CodecTextTokenizer(codebook_size=1024).vocab_size
    jcfg = jl.tiny_lm_config(vocab_size=vocab, compute_dtype="float32")
    jparams = jl.fuse_lm_params_for_decode(jl.init_lm_params(jax.random.PRNGKey(0), jcfg))
    tcfg = tl.DuplexLMConfig(**dataclasses.asdict(jcfg))
    tparams = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("extra", [False, True])
@pytest.mark.parametrize("rows", [2, 3])
def test_forward_decode_pair_matches_jax(tiny_lm, rows, extra):
    jcfg, jparams, tcfg, tparams = tiny_lm
    rng = np.random.default_rng(10 * rows + extra)
    s = 640
    cache_shape = (jcfg.num_layers, 1, s, jcfg.num_kv_heads, jcfg.head_dim)
    caches = [(rng.normal(size=cache_shape).astype(np.float32), rng.normal(size=cache_shape).astype(np.float32))
              for _ in range(rows)]
    valid = np.array([120 + 37 * r for r in range(rows)], np.int32)
    positions = (valid[:, None] + 4 + np.arange(3)[None, :]).astype(np.int32)
    ids = rng.integers(0, jcfg.vocab_size, size=(rows, 3)).astype(np.int32)
    jextra = textra = jepos = tepos = None
    if extra:
        shape = (jcfg.num_layers, rows, 6, jcfg.num_kv_heads, jcfg.head_dim)
        ek = rng.normal(size=shape).astype(np.float32)
        ev = rng.normal(size=shape).astype(np.float32)
        # two accepted pairs and a rejected one a row
        epos = np.stack([[v, v + 1, 2**30, 2**30, v + 2, v + 3] for v in valid]).astype(np.int32)
        jextra, textra = (jnp.asarray(ek), jnp.asarray(ev)), (torch.from_numpy(ek), torch.from_numpy(ev))
        jepos, tepos = jnp.asarray(epos), torch.from_numpy(epos.astype(np.int64))
    jh, jk, jv = jl.forward_decode_pair(
        jparams, jnp.asarray(ids), jcfg, [jnp.asarray(k) for k, _ in caches], [jnp.asarray(v) for _, v in caches],
        jnp.asarray(positions), jnp.asarray(valid), extra_kv=jextra, extra_pos=jepos,
    )
    th, tk, tv = tl.forward_decode_pair(
        tparams, torch.from_numpy(ids.astype(np.int64)), tcfg, [torch.from_numpy(k) for k, _ in caches],
        [torch.from_numpy(v) for _, v in caches], torch.from_numpy(positions.astype(np.int64)),
        torch.from_numpy(valid), extra_kv=textra, extra_pos=tepos,
    )
    assert th.shape == (rows, 3, jcfg.hidden_size) and tk.shape == jk.shape
    for got, want in ((th, jh), (tk, jk), (tv, jv)):
        assert _rel(got.numpy(), np.asarray(want)) <= REL
    # each row is what forward_decode of that row alone computes
    for r in range(rows):
        h1, k1, _ = tl.forward_decode(
            tparams, torch.from_numpy(ids[r : r + 1].astype(np.int64)), tcfg, torch.from_numpy(caches[r][0]),
            torch.from_numpy(caches[r][1]), torch.from_numpy(positions[r].astype(np.int64)),
            cache_valid=torch.tensor(valid[r : r + 1]),
            extra_kv=None if textra is None else (textra[0][:, r : r + 1], textra[1][:, r : r + 1]),
            extra_pos=None if tepos is None else tepos[r],
        )
        torch.testing.assert_close(th[r : r + 1], h1, rtol=0, atol=0)
        torch.testing.assert_close(tk[:, r : r + 1], k1, rtol=0, atol=0)


def test_row_draw_matches_jax_vmap():
    """Four rows with their own seeds, steps, settings and windows: the
    port's row draw against jax.vmap of the JAX sampler with fold_in keys."""
    rows, vocab, top_k = 4, 1320, 40
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(rows, vocab)) * 3).astype(np.float32)
    cases = [dict(top_k=top_k, top_p=1.0, min_p=0.0, temp=1.0, min_token_id=296),
             dict(top_k=top_k, top_p=0.9, min_p=0.05, temp=0.8, repeat_penalty=1.3, frequency_penalty=0.4,
                  presence_penalty=0.7, logit_bias=((5, 4.0), (300, -100.0))),
             dict(top_k=top_k, temp=0.0),
             dict(top_k=top_k, top_p=0.95, min_p=0.02, temp=0.9)]
    seeds, steps = [11, 12, 2**33 + 7, 0], [0, 5, 77, 1234]
    windows = [rng.integers(0, vocab, size=int(n)).tolist() for n in (0, 10, 64, 30)]
    js = [jsampling.SamplerSettings(**c) for c in cases]
    ts = [tsampling.SamplerSettings(**c) for c in cases]
    jw = [jsampling.make_window(w) for w in windows]
    tw = [tsampling.make_window(w) for w in windows]
    keys = jax.vmap(jax.random.fold_in)(jnp.stack([jax.random.PRNGKey(s) for s in seeds]),
                                        jnp.asarray(steps, jnp.uint32))
    want = jax.vmap(lambda lg, key, sc, bi, bv, wi, wm: jsampling.sample_token(lg, key, sc, bi, bv, wi, wm,
                                                                               top_k=top_k))(
        jnp.asarray(logits), keys, jnp.stack([s.scalars() for s in js]),
        jnp.stack([s.bias_arrays()[0] for s in js]), jnp.stack([s.bias_arrays()[1] for s in js]),
        jnp.stack([w[0] for w in jw]), jnp.stack([w[1] for w in jw]))
    calls = tsampling.sample_token_rows_plain.calls
    got = tsampling.sample_token_rows(
        torch.from_numpy(logits), torch.tensor(list(zip(seeds, steps)), dtype=torch.int64),
        torch.stack([s.scalars() for s in ts]), torch.stack([s.bias_arrays()[0] for s in ts]),
        torch.stack([s.bias_arrays()[1] for s in ts]), torch.stack([w[0] for w in tw]),
        torch.stack([w[1] for w in tw]), top_k=top_k)
    assert tsampling.sample_token_rows_plain.calls == calls + 1
    assert got.dtype == torch.int64 and got.tolist() == np.asarray(want).tolist()
    # the rows are the single draw's, key by key
    for r in range(rows):
        one = tsampling.sample_token(torch.from_numpy(logits[r]), (seeds[r], steps[r]), ts[r].scalars(),
                                     *ts[r].bias_arrays(), *tw[r], top_k=top_k)
        assert int(one) == got[r]


def _jax_self_play_agent(jres, seed):
    res = jres.clone_for_self_play()
    agent = JaxAgent(resources=res, config=JaxConfig(**SELF_PLAY, seed=seed), self_play_mode=True)
    _pin(agent, res)
    return agent


SELF_PLAY = dict(temperature=1.0, use_whisper=False, agent_opening_text=None, force_trans_after_inactivity_secs=0.0,
                 force_response_after_inactivity_secs=0.0, use_fused_step=True, pipeline_chunks=True,
                 max_inline_text_tokens=16)


def test_self_play_slice_matches_jax():
    """Two agents of each package, cross-fed and paired, seeded sampling at
    temperature 1.0 in the codec region: the same ids every chunk, audio
    within 1e-4, and both coordinators grouped."""
    vocab = CodecTextTokenizer(codebook_size=1024).vocab_size
    lcfg = jl.tiny_lm_config(vocab_size=vocab, codebook_size=1024, compute_dtype="float32")
    ccfg = jax_tiny_codec_config(compute_dtype="float32")
    jres = JaxResources(tiny=True, whisper_model=None, lm_config=lcfg, codec_config=ccfg, seed=0)
    tres = RealtimeAgentResources(
        tiny=True, device="cpu",
        _lm_params=lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jres.lm_params)),
        _codec_params=codec_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                                     jres.audio_tokenizer.codec_model.params)),
        lm_config=tl.DuplexLMConfig(**dataclasses.asdict(lcfg)),
        codec_config=tcodec.CodecConfig(**dataclasses.asdict(ccfg)),
    )
    ja, jb = (_jax_self_play_agent(jres, s) for s in (11, 12))
    ta, tb = (_make(tres, s, temperature=1.0) for s in (11, 12))
    jp = jpair.pair_self_play_agents(ja, jb)
    tp = pair_self_play_agents(ta, tb)
    jouts, touts = _cross_feed(ja, jb, 8), _cross_feed(ta, tb, 8)
    for (jo, to) in zip(jouts, touts):
        assert to[1] == jo[1] and to[3] == jo[3]  # both agents' ids, chunk by chunk
        np.testing.assert_allclose(to[0], jo[0], atol=1e-4)
        np.testing.assert_allclose(to[2], jo[2], atol=1e-4)
    assert ta.input_ids == ja.input_ids and tb.input_ids == jb.input_ids
    assert tp.paired_dispatches == jp.paired_dispatches >= 4


# ----------------------------------------- against the port's ungrouped agents

@pytest.fixture(scope="module")
def resources():
    return tiny_f32_resources()


def _pin(agent, res) -> None:
    """Every sample restricted to codec ids."""
    orig = agent.set_sampler

    def pinned(for_trans=False, suppress_end_audio=False):
        orig(for_trans=for_trans, suppress_end_audio=suppress_end_audio)
        res.llm.settings.min_token_id = res.tokenizer.codec_vocab_start

    agent.set_sampler = pinned
    agent.set_sampler()


def _make(resources, seed, temperature=0.0, pin_audio=True, pipeline=True, self_play=True, async_detours=False):
    config = RealtimeAgentConfig(
        temperature=temperature, use_whisper=False, agent_opening_text=None, async_detours=async_detours,
        force_trans_after_inactivity_secs=0.0, force_response_after_inactivity_secs=0.0, use_fused_step=True,
        pipeline_chunks=pipeline, seed=seed, max_inline_text_tokens=16,
    )
    res = resources.clone_for_self_play()
    agent = RealtimeAgent(resources=res, config=config, self_play_mode=self_play)
    if pin_audio:
        _pin(agent, res)
    return agent


def _drain(*agents) -> None:
    for a in agents:
        while a.drain_pipeline() is not None:
            pass


def _cross_feed(a, b, n_chunks, split=False):
    """The self-play loop: A's output chunk and ids feed B and the other way
    round; ``split`` dispatches both before either resolves. Returns each
    chunk's (A's audio, A's ids, B's audio, B's ids)."""
    zero = np.zeros(CHUNK, np.float32)
    out_a, ids_a, out_b, ids_b = zero, None, zero, None
    outs = []
    for _ in range(n_chunks):
        if split:
            a.process_audio_dispatch(out_b, ids_b)
            b.process_audio_dispatch(out_a, ids_a)
            (out_a, ids_a), (out_b, ids_b) = a.process_audio_resolve(), b.process_audio_resolve()
        else:
            out_a_, ids_a_ = a.process_audio(out_b, ids_b)
            out_b, ids_b = b.process_audio(out_a, ids_a)
            out_a, ids_a = out_a_, ids_a_
        outs.append((out_a.copy(), None if ids_a is None else list(ids_a), out_b.copy(),
                     None if ids_b is None else list(ids_b)))
    _drain(a, b)
    return outs


def _conversation(resources, paired, n_chunks=8, split=False, **kw):
    a, b = _make(resources, 11, **kw), _make(resources, 12, **kw)
    pair = pair_self_play_agents(a, b) if paired else None
    return a, b, pair, _cross_feed(a, b, n_chunks, split=split)


@pytest.fixture(scope="module")
def ungrouped(resources):
    """The ungrouped reference conversations: pinned greedy over 8 chunks,
    and natural events at temperature 1.0 over 6."""
    return {"pinned": _conversation(resources, False), "events": _conversation(
        resources, False, n_chunks=6, temperature=1.0, pin_audio=False)}


def _same_streams(got, want):
    for g, w in zip(got[:2], want[:2]):
        assert g.input_ids == w.input_ids
        assert g.get_sequence_str() == w.get_sequence_str()
        assert [t["text"] for t in g.transcript] == [t["text"] for t in w.transcript]
        assert g.resources.llm.n_tokens == w.resources.llm.n_tokens
        assert g.resources.llm._step == w.resources.llm._step
    for go, wo in zip(got[3], want[3]):
        np.testing.assert_array_equal(go[0], wo[0])
        np.testing.assert_array_equal(go[2], wo[2])
        assert (go[1], go[3]) == (wo[1], wo[3])


def test_paired_cross_feed_tokens_and_audio_match_unpaired(resources, ungrouped):
    got = _conversation(resources, True)
    _same_streams(got, ungrouped["pinned"])
    assert got[2].paired_dispatches >= 4


def test_paired_with_events_matches_unpaired(resources, ungrouped):
    """Unpinned sampling at temperature 1.0 on random weights fires events
    within a few frames: the replay, the halted successor's re-dispatch and
    the flush rules keep the ungrouped streams."""
    want = ungrouped["events"]
    got = _conversation(resources, True, n_chunks=6, temperature=1.0, pin_audio=False)
    _same_streams(got, want)
    a = want[0]
    assert any(t <= a.end_header_token_id for t in a.input_ids[a.context_start_pos + 1:])  # an event fired
    assert got[2].single_dispatches > 0


@pytest.mark.parametrize("paired", [False, True])
def test_split_drive_matches_interleaved(resources, ungrouped, paired):
    got = _conversation(resources, paired, split=True)
    _same_streams(got, ungrouped["pinned"])
    if paired:
        assert got[2].paired_dispatches >= 4


def test_split_drive_with_events_matches_interleaved(resources, ungrouped):
    got = _conversation(resources, True, n_chunks=6, split=True, temperature=1.0, pin_audio=False)
    _same_streams(got, ungrouped["events"])


def test_sync_paired_session_flushes_immediately(resources):
    """Synchronous agents over a pair: each read is adjacent to its dispatch,
    so every chunk flushes through the single program at once."""
    want = _conversation(resources, False, n_chunks=4, pipeline=False)
    got = _conversation(resources, True, n_chunks=4, pipeline=False)
    _same_streams(got, want)
    pair = got[2]
    assert pair.timeout_flushes == 0
    assert pair.single_dispatches >= 6 and pair.paired_dispatches == 0


def _primed_pair(resources):
    a, b = _make(resources, 11), _make(resources, 12)
    pair = pair_self_play_agents(a, b)
    zero = np.zeros(CHUNK, np.float32)
    a.process_audio(zero, None)
    b.process_audio(zero, None)
    for ag in (a, b):
        s = ag._session
        s.bind_sequence(ag.input_ids)
        s.sync_chain()
    return a, b, pair, zero


def test_reset_cancels_buffered_chunk(resources):
    a, b, pair, zero = _primed_pair(resources)
    sa = a._session
    lazy = sa.dispatch_chunk(zero)  # buffered: the other row never dispatches
    assert pair._buffered
    sa.reset()
    assert not pair._buffered
    res, _ = sa.resolve(lazy)
    assert res.halted_input and res.audio is None
    _drain(a, b)


def test_flush_failure_resolves_lazy(resources):
    a, b, pair, zero = _primed_pair(resources)
    sa = a._session
    lazy = sa.dispatch_chunk(zero)
    orig = sa._dispatch_chunk_single

    def boom(*args, **kwargs):
        raise RuntimeError("injected dispatch failure")

    sa._dispatch_chunk_single = boom
    try:
        with pytest.raises(RuntimeError, match="injected"):
            pair.flush(sa)
    finally:
        sa._dispatch_chunk_single = orig
    assert not pair._buffered
    res, _ = sa.resolve(lazy)  # resolves at once: no wait
    assert res.halted_input
    _drain(a, b)


def test_launch_failure_resolves_all_lazies(resources):
    a, b, pair, zero = _primed_pair(resources)

    def boom(*args, **kwargs):
        raise RuntimeError("injected launch failure")

    pair._fused_group = boom
    try:
        lazy_a = a._session.dispatch_chunk(zero)
        with pytest.raises(RuntimeError, match="injected"):
            b._session.dispatch_chunk(zero)  # fills the group: the launch raises
    finally:
        del pair._fused_group
    res_a, _ = a._session.resolve(lazy_a)
    assert res_a.halted_input
    _drain(a, b)


def test_pair_rejects_mismatched_sessions(resources):
    a, b = _make(resources, 11), _make(resources, 12)
    b._session.codec = tcodec.TorchCodecModel.random_init(tcodec.tiny_codec_config(compute_dtype="float32"), seed=1)
    with pytest.raises(ValueError, match="codec"):
        pair_self_play_agents(a, b)
    c = _make(tiny_f32_resources(seed=1), 13)
    with pytest.raises(ValueError, match="weight"):
        pair_self_play_agents(a, c)
    _drain(a)


def _streams(n_chunks, rows=3, seed=100):
    rngs = [np.random.default_rng(seed + i) for i in range(rows)]
    return [[(r.normal(size=CHUNK) * 0.1).astype(np.float32) for _ in range(n_chunks)] for r in rngs]


def test_grouped_three_rows_match_ungrouped(resources):
    """Duplex serving's shape: three agents on independent audio (no
    cross-feed) in one batch-3 program give the ungrouped streams."""
    runs = {}
    for grouped in (False, True):
        agents = [_make(resources, 20 + i, self_play=False) for i in range(3)]
        coord = group_duplex_agents(agents) if grouped else None
        outs = [[] for _ in agents]
        for chunks3 in zip(*_streams(6)):
            for o, a, c in zip(outs, agents, chunks3):
                o.append(a.process_audio(c))
        for o, a in zip(outs, agents):
            while (tail := a.drain_pipeline()) is not None:
                o.append(tail)
        runs[grouped] = (agents, coord, outs)
    for a_un, a_gr, o_un, o_gr in zip(runs[False][0], runs[True][0], runs[False][2], runs[True][2]):
        assert a_gr.input_ids == a_un.input_ids
        assert a_gr.resources.llm.n_tokens == a_un.resources.llm.n_tokens
        assert a_gr.resources.llm._step == a_un.resources.llm._step
        np.testing.assert_array_equal(np.concatenate(o_gr), np.concatenate(o_un))
    coord = runs[True][1]
    assert coord.n_rows == 3 and coord.paired_dispatches >= 4


def test_interleaved_async_drive_still_groups(resources):
    """Async agents driven by plain interleaved process_audio under a
    coordinator still ride the group program: a flush before the previous
    chunk's read that were not targeted would turn every buffered chunk
    into a single, which token parity alone cannot see."""
    agents = [_make(resources, 40 + i, self_play=False, async_detours=True) for i in range(3)]
    coord = group_duplex_agents(agents)
    for chunks3 in zip(*_streams(10, seed=200)):
        for a, c in zip(agents, chunks3):
            a.process_audio(c)
        # let the opening detours finish so the rows stay aligned (bounded)
        for a in agents:
            fut = a._detour_future
            deadline = time.monotonic() + 8.0
            while fut is not None and not fut.done() and time.monotonic() < deadline:
                time.sleep(0.02)
    _drain(*agents)
    assert coord.paired_dispatches >= 4, (coord.paired_dispatches, coord.single_dispatches)
