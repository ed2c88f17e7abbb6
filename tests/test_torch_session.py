"""PyTorch DuplexSession (the fused chunk) against the JAX package, and the
port's fused chunk against its own stepwise paths under seeded sampling.

Tiny f32 config. JAX vs port (greedy): out_tokens, user_tokens and n_final
identical, audio at atol 1e-4, the three probe probabilities at atol 1e-5.
Within the port (temperature 1): the fused chunk, the frames continuation and
per-frame eval_and_sample give identical tokens -- the Gumbel noise of step i
is a function of (seed, i), whichever path draws it.
"""
import dataclasses

import jax
import numpy as np
import pytest

from realtime_codec_agent_tpu.lm.duplex_session import DuplexSession as JaxSession
from realtime_codec_agent_tpu.lm.engine import DuplexLMEngine as JaxEngine
from realtime_codec_agent_tpu.models import llama as jl
from realtime_codec_agent_tpu.models.codec import JaxCodecModel, tiny_codec_config
from realtime_codec_agent_tpu.tokenization import CodecTextTokenizer
from realtime_codec_agent_tpu.units import special_tokens as st
from realtime_codec_agent_tpu_torch.lm.duplex_session import DuplexSession
from realtime_codec_agent_tpu_torch.lm.engine import DuplexLMEngine
from realtime_codec_agent_tpu_torch.models import codec as tcodec
from realtime_codec_agent_tpu_torch.models import llama as tl
from realtime_codec_agent_tpu_torch.models.from_jax import codec_params_from_numpy, lm_params_from_numpy

CHUNK = 1600
N_CHUNKS = 6


def bench_audio(secs, seed=0, sr=16000):
    """The bench's synthetic voice: a gated 150 Hz tone plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(secs * sr)) / sr
    return (
        0.2 * np.sin(2 * np.pi * 150 * t) * np.clip(np.sin(2 * np.pi * 0.7 * t), 0, 1)
        + 0.02 * rng.normal(size=t.shape)
    ).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    tok = CodecTextTokenizer(codebook_size=1024)
    ccfg = tiny_codec_config(compute_dtype="float32")
    jcodec = JaxCodecModel.random_init(ccfg, seed=0)
    lcfg = jl.tiny_lm_config(vocab_size=tok.vocab_size, codebook_size=1024, compute_dtype="float32")
    jparams = jl.fuse_lm_params_for_decode(jl.init_lm_params(jax.random.PRNGKey(0), lcfg))
    tcodec_model = tcodec.TorchCodecModel(
        codec_params_from_numpy(jax.tree_util.tree_map(np.asarray, jcodec.params)),
        tcodec.CodecConfig(**dataclasses.asdict(ccfg)),
    )
    tparams = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    return tok, jcodec, lcfg, jparams, tcodec_model, tl.DuplexLMConfig(**dataclasses.asdict(lcfg)), tparams


def _ids(tok):
    return dict(
        end_header=tok.convert_tokens_to_ids(st.END_HEADER),
        end_audio=tok.convert_tokens_to_ids(st.END_AUDIO),
        agent=tok.encode(" A", add_special_tokens=False)[0],
        user=tok.encode(" B", add_special_tokens=False)[0],
    )


def _prime(engine, tok, ids, temp, seed=7):
    """Header prefill + a pending (agent, user) codec pair: the state the
    agent's fused path starts from."""
    engine.init_sampler_for_generate(
        top_k=100, top_p=1.0, min_p=0.0, temp=temp, seed=seed,
        min_token_id=tok.codec_vocab_start,
    )
    engine.set_end_header_token_id(ids["end_header"])
    engine.set_probe_token_ids(ids["end_audio"], ids["agent"], ids["user"])
    header = tok.encode(f"{st.HEADER_AGENT}{st.HEADER_SPEAKER} A{st.HEADER_SPEAKER} B{st.END_HEADER}")
    cvs = tok.codec_vocab_start
    seq = list(header) + [cvs + 17, cvs + 900]
    engine.eval(seq[:-2])
    return seq


def _session(cls, engine, codec, tok, ids):
    return cls(
        engine=engine, codec_model=codec, codec_vocab_start=tok.codec_vocab_start,
        end_header_token_id=ids["end_header"], end_audio_token_id=ids["end_audio"],
        agent_speaker_token_id=ids["agent"], user_speaker_token_id=ids["user"],
        chunk_size_samples=CHUNK, preroll_samples=320,
    )


def _commit(engine, seq, res, frames=5):
    """The agent's _commit_fused bookkeeping on the host mirrors."""
    evaled = list(seq[-2:])
    for f in range(frames - 1):
        evaled += [res.out_tokens[f], res.user_tokens[f]]
    engine.commit_external_eval(evaled)
    for f in range(frames):
        seq += [res.out_tokens[f], res.user_tokens[f]]


def test_session_matches_jax_greedy(models):
    tok, jcodec, lcfg, jparams, tcodec_model, tcfg, tparams = models
    ids = _ids(tok)
    jeng = JaxEngine(jparams, lcfg)
    teng = DuplexLMEngine(tparams, tcfg)
    jseq = _prime(jeng, tok, ids, temp=0.0)
    tseq = _prime(teng, tok, ids, temp=0.0)
    jsess = _session(JaxSession, jeng, jcodec, tok, ids)
    tsess = _session(DuplexSession, teng, tcodec_model, tok, ids)
    audio = bench_audio(N_CHUNKS * CHUNK / 16000)
    for c in range(N_CHUNKS):
        chunk = audio[c * CHUNK : (c + 1) * CHUNK]
        jsess.bind_sequence(jseq)
        tsess.bind_sequence(tseq)
        jres, _ = jsess.process_chunk(chunk)
        tres, _ = tsess.process_chunk(chunk)
        assert tres.event_frame == jres.event_frame == 5
        assert tres.user_tokens == jres.user_tokens, c
        assert tres.out_tokens == jres.out_tokens, c
        assert tres.n_final == jres.n_final
        np.testing.assert_allclose(tres.audio, jres.audio, atol=1e-4)
        np.testing.assert_allclose(
            [tres.p_end_audio, tres.p_event_agent, tres.p_event_user],
            [jres.p_end_audio, jres.p_event_agent, jres.p_event_user], atol=1e-5,
        )
        _commit(jeng, jseq, jres)
        _commit(teng, tseq, tres)
    assert tseq == jseq
    assert teng.n_tokens == jeng.n_tokens == len(tseq) - 2
    assert teng._step == jeng._step


def test_fused_matches_stepwise_sampled(models):
    tok, _, _, _, tcodec_model, tcfg, tparams = models
    ids = _ids(tok)
    fused_eng, frames_eng, step_eng = (DuplexLMEngine(tparams, tcfg) for _ in range(3))
    fseq = _prime(fused_eng, tok, ids, temp=1.0)
    gseq = _prime(frames_eng, tok, ids, temp=1.0)
    sseq = _prime(step_eng, tok, ids, temp=1.0)
    sess = _session(DuplexSession, fused_eng, tcodec_model, tok, ids)
    audio = bench_audio(4 * CHUNK / 16000, seed=3)
    for c in range(4):
        sess.bind_sequence(fseq)
        res, _ = sess.process_chunk(audio[c * CHUNK : (c + 1) * CHUNK])
        assert res.event_frame == 5
        _commit(fused_eng, fseq, res)
        # the frames continuation over the same user tokens
        accepted, event = frames_eng.eval_and_sample_frames(gseq[-2:], res.user_tokens)
        assert event is None
        assert accepted == res.out_tokens, c
        for a, u in zip(accepted, res.user_tokens):
            gseq += [a, u]
        # one eval_and_sample per frame
        for f in range(5):
            a = step_eng.eval_and_sample(sseq[-2:])
            assert a == res.out_tokens[f], (c, f)
            sseq += [a, res.user_tokens[f]]
    assert fseq == gseq == sseq
    assert fused_eng.n_tokens == frames_eng.n_tokens == step_eng.n_tokens
    assert fused_eng._step == frames_eng._step == step_eng._step
