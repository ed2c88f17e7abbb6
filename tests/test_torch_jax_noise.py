"""The port's Gumbel noise is JAX's: ``jax.random.gumbel(fold_in(PRNGKey(seed),
step), (k,))`` computed by the port's plain threefry2x32 (ops/sampling.py,
the CPU side of kernel S1), and seeded sampled tokens equal the JAX
engine's with no noise handed in. Also the port's copy of ``qwen25_config``.

Tolerances: key data and uniform draws bit for bit. Noise within 2 ulp,
the ulp taken at max(|g|, 1): the uniform draws are identical, and each of
the two logs (XLA's and torch's) rounds to within 1 ulp; near g = 0 the
outer log amplifies the inner log's rounding of a value near 1, so the
spacing of 1.0 is the scale there. Tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.lm.duplex_session import DuplexSession as JaxSession
from realtime_codec_agent_tpu.lm.engine import DuplexLMEngine as JaxEngine
from realtime_codec_agent_tpu.models import llama as jl
from realtime_codec_agent_tpu.models.codec import JaxCodecModel, tiny_codec_config
from realtime_codec_agent_tpu.ops import sampling as jsampling
from realtime_codec_agent_tpu.tokenization import CodecTextTokenizer
from realtime_codec_agent_tpu.units import special_tokens as st
from realtime_codec_agent_tpu_torch.lm.duplex_session import DuplexSession
from realtime_codec_agent_tpu_torch.lm.engine import DuplexLMEngine
from realtime_codec_agent_tpu_torch.models import codec as tcodec
from realtime_codec_agent_tpu_torch.models import llama as tl
from realtime_codec_agent_tpu_torch.models.from_jax import codec_params_from_numpy, lm_params_from_numpy
from realtime_codec_agent_tpu_torch.ops import sampling as tsampling

TINY = float(np.finfo(np.float32).tiny)
KEY_CASES = [(0, 0), (42, 7), (2**31 + 5, 123456), (2**40 + 3, 1)]
SEED = 1234
CHUNK = 1600


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs tiny tensors: one intra-op thread is faster, and
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps_at_scale(got, want):
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want) / (np.maximum(np.abs(want), 1.0) * 2.0**-23)))


@pytest.mark.parametrize("seed,step", KEY_CASES)
def test_prng_key_and_fold_in_match_jax(seed, step):
    key = jax.random.PRNGKey(seed)
    assert tsampling.prng_key(seed) == tuple(int(x) for x in np.asarray(key))
    want = tuple(int(x) for x in np.asarray(jax.random.fold_in(key, step)))
    assert tuple(tsampling.fold_in(tsampling.prng_key(seed), step)) == want
    # a step tensor folds in the same
    got = tsampling.fold_in(tsampling.prng_key(seed), torch.tensor(step, dtype=torch.int64))
    assert tuple(int(x) for x in got) == want


@pytest.mark.parametrize("k", [1, 40, 100, 1023, 1024])
def test_uniform_bits_match_jax(k):
    for seed, step in KEY_CASES:
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        want = np.asarray(jax.random.uniform(jkey, (k,), minval=TINY))
        u, _ = tsampling.gumbel_noise(seed, step, k, "cpu", return_uniform=True)
        np.testing.assert_array_equal(u.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed,step", KEY_CASES)
def test_gumbel_noise_within_2_ulp_of_jax(seed, step):
    k = 1024
    want = np.asarray(jax.random.gumbel(jax.random.fold_in(jax.random.PRNGKey(seed), step), (k,)))
    calls = tsampling.gumbel_noise_plain.calls
    got = tsampling.gumbel_noise(seed, step, k, "cpu")
    assert tsampling.gumbel_noise_plain.calls == calls + 1  # a CPU device takes the plain version
    assert got.dtype == torch.float32 and got.shape == (k,)
    assert _ulps_at_scale(got.numpy(), want) <= 2.0
    # the step as a tensor gives the same numbers
    assert torch.equal(tsampling.gumbel_noise(seed, torch.tensor(step), k, "cpu"), got)


def test_sample_token_with_port_noise_matches_jax_categorical():
    """500 sampled steps: the port's sampler with its own noise for (seed,
    step) picks jax.random.categorical's token under fold_in(PRNGKey(seed),
    step), on fresh logits each step."""
    settings = dict(temp=0.9, top_k=100, top_p=1.0, min_p=0.0)
    jst = jsampling.SamplerSettings(**settings)
    tst = tsampling.SamplerSettings(**settings)
    jw, tw = jsampling.make_window([]), tsampling.make_window([])
    jbias, tbias = jst.bias_arrays(), tst.bias_arrays()
    jsample = jax.jit(jsampling.sample_token, static_argnames="top_k")
    base = jax.random.PRNGKey(SEED)
    rng = np.random.default_rng(0)
    k = tsampling.k_for(100, 1320)
    for step in range(500):
        logits = (rng.normal(size=(1320,)) * 2).astype(np.float32)
        want = int(jsample(jnp.asarray(logits), jax.random.fold_in(base, step), jst.scalars(), jbias[0], jbias[1],
                           jw[0], jw[1], top_k=100))
        noise = tsampling.gumbel_noise(SEED, step, k, "cpu")
        got = int(tsampling.sample_token(torch.from_numpy(logits), noise, tst.scalars(), tbias[0], tbias[1], tw[0],
                                         tw[1], top_k=100))
        assert got == want, step


# ------------------------------------------------------------------ the slice

@pytest.fixture(scope="module")
def models():
    tok = CodecTextTokenizer(codebook_size=1024)
    ccfg = tiny_codec_config(compute_dtype="float32")
    jcodec = JaxCodecModel.random_init(ccfg, seed=0)
    lcfg = jl.tiny_lm_config(vocab_size=tok.vocab_size, codebook_size=1024, compute_dtype="float32")
    jparams = jl.fuse_lm_params_for_decode(jl.init_lm_params(jax.random.PRNGKey(3), lcfg))
    tcodec_model = tcodec.TorchCodecModel(
        codec_params_from_numpy(jax.tree_util.tree_map(np.asarray, jcodec.params)),
        tcodec.CodecConfig(**dataclasses.asdict(ccfg)),
    )
    tparams = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    return tok, jcodec, lcfg, jparams, tcodec_model, tl.DuplexLMConfig(**dataclasses.asdict(lcfg)), tparams


def _sampler(engine, tok, **kw):
    engine.init_sampler_for_generate(top_k=100, top_p=1.0, min_p=0.0, temp=1.0, seed=SEED, **kw)


def test_seeded_generate_until_matches_jax(models):
    """generate_until at temperature 1.0, seed 1234, 4 x 64 sampled steps:
    the port computes its own noise and samples the JAX engine's tokens."""
    tok, _, lcfg, jparams, _, tcfg, tparams = models
    je, te = JaxEngine(jparams, lcfg, seed=SEED), DuplexLMEngine(tparams, tcfg, seed=SEED, device="cpu")
    for e in (je, te):
        _sampler(e, tok)
        e.eval(list(range(20, 30)))
    jtoks, ttoks, jfirst, tfirst = [], [], 31, 31
    for _ in range(4):
        jt, _ = je.generate_until(jfirst, stop_id=-1, max_n=64)
        tt, _ = te.generate_until(tfirst, stop_id=-1, max_n=64)
        jtoks += jt
        ttoks += tt
        jfirst, tfirst = jt[-1], tt[-1]
    assert len(ttoks) == 256 and len(set(ttoks)) > 50  # sampled, not a greedy loop
    assert ttoks == jtoks
    assert te._step == je._step and te._input_ids == je._input_ids


def bench_audio(secs, seed=0, sr=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(int(secs * sr)) / sr
    return (
        0.2 * np.sin(2 * np.pi * 150 * t) * np.clip(np.sin(2 * np.pi * 0.7 * t), 0, 1)
        + 0.02 * rng.normal(size=t.shape)
    ).astype(np.float32)


def test_seeded_fused_scan_matches_jax(models):
    """The fused frame scan at temperature 1.0, seed 1234, 40 chunks of 5
    frames (200 sampled steps, codec ids only): the port's session samples
    the JAX session's agent tokens chunk for chunk."""
    tok, jcodec, lcfg, jparams, tcodec_model, tcfg, tparams = models
    ids = dict(
        end_header=tok.convert_tokens_to_ids(st.END_HEADER), end_audio=tok.convert_tokens_to_ids(st.END_AUDIO),
        agent=tok.encode(" A", add_special_tokens=False)[0], user=tok.encode(" B", add_special_tokens=False)[0],
    )
    header = tok.encode(f"{st.HEADER_AGENT}{st.HEADER_SPEAKER} A{st.HEADER_SPEAKER} B{st.END_HEADER}")
    cvs = tok.codec_vocab_start
    runs = []
    for eng_cls, sess_cls, params, cfg, codec in (
        (JaxEngine, JaxSession, jparams, lcfg, jcodec), (DuplexLMEngine, DuplexSession, tparams, tcfg, tcodec_model)
    ):
        eng = eng_cls(params, cfg, seed=SEED)
        _sampler(eng, tok, min_token_id=cvs)
        eng.set_end_header_token_id(ids["end_header"])
        eng.set_probe_token_ids(ids["end_audio"], ids["agent"], ids["user"])
        seq = list(header) + [cvs + 17, cvs + 900]
        eng.eval(seq[:-2])
        sess = sess_cls(
            engine=eng, codec_model=codec, codec_vocab_start=cvs, end_header_token_id=ids["end_header"],
            end_audio_token_id=ids["end_audio"], agent_speaker_token_id=ids["agent"],
            user_speaker_token_id=ids["user"], chunk_size_samples=CHUNK, preroll_samples=320,
        )
        runs.append((eng, sess, seq, []))
    audio = bench_audio(40 * CHUNK / 16000, seed=5)
    for c in range(40):
        chunk = audio[c * CHUNK : (c + 1) * CHUNK]
        for eng, sess, seq, out in runs:
            sess.bind_sequence(seq)
            res, _ = sess.process_chunk(chunk)
            assert res.event_frame == 5
            out.append(list(res.out_tokens))
            evaled = list(seq[-2:])
            for f in range(4):
                evaled += [res.out_tokens[f], res.user_tokens[f]]
            eng.commit_external_eval(evaled)
            for f in range(5):
                seq += [res.out_tokens[f], res.user_tokens[f]]
        assert runs[1][3][-1] == runs[0][3][-1], c
    (jeng, _, jseq, _), (teng, _, tseq, tout) = runs
    assert sum(len(o) for o in tout) == 200
    assert tseq == jseq and teng._step == jeng._step == 200


# ------------------------------------------------------------- qwen25_config

@pytest.mark.parametrize("variant", ["0.5b", "1.5b", "3b", "7b"])
def test_qwen25_config_matches_jax(variant):
    want = jl.qwen25_config(variant, vocab_size=283024, codec_vocab_start=151946, max_context=4096)
    got = tl.qwen25_config(variant, vocab_size=283024, codec_vocab_start=151946, max_context=4096)
    fields = [f.name for f in dataclasses.fields(got)]
    assert {f: getattr(want, f) for f in fields} == dataclasses.asdict(got)
