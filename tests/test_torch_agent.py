"""The slice as a whole: the PyTorch RealtimeAgent against the JAX one.

Both agents run over the same weights (the JAX resources' params, converted),
configured as the bench's hot loop: no Whisper, no forced events, no opening
text, sampling pinned to the codec region. Tiny config.

- f32, greedy: ``input_ids`` identical after 8 chunks (reset prefill, the
  first chunk's frames continuation, 7 fused chunks), every output chunk at
  audio atol 1e-4.
- int8 and int4 decode weights: the port quantizes the same dense weights
  itself, and its quantized leaves equal the JAX resources' bit for bit; no
  token check, audio at the looser atol 1e-3, equal ``n_tokens``. On the CPU
  the JAX quantized paths take the XLA route, which keeps the f32
  activations (realtime_codec_agent_tpu/ops/nn.py:64-83), while the port's
  plain B2 and B5 round them to bf16 as the TPU kernels do, so the logits
  differ at bf16 resolution and the two runs are not held to the same tokens.
"""
import dataclasses

import jax
import numpy as np
import pytest

from realtime_codec_agent_tpu.agent.agent import RealtimeAgent as JaxAgent
from realtime_codec_agent_tpu.agent.config import RealtimeAgentConfig as JaxConfig
from realtime_codec_agent_tpu.agent.resources import RealtimeAgentResources as JaxResources
from realtime_codec_agent_tpu.models import llama as jl
from realtime_codec_agent_tpu.models.codec import tiny_codec_config
from realtime_codec_agent_tpu.tokenization import CodecTextTokenizer
from realtime_codec_agent_tpu_torch.agent.agent import RealtimeAgent
from realtime_codec_agent_tpu_torch.agent.config import RealtimeAgentConfig
from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources
from realtime_codec_agent_tpu_torch.models import codec as tcodec
from realtime_codec_agent_tpu_torch.models import llama as tl
from realtime_codec_agent_tpu_torch.models.from_jax import codec_params_from_numpy, lm_params_from_numpy

N_CHUNKS = 8
CONFIG = dict(
    temperature=0.0,
    use_whisper=False,
    agent_opening_text=None,
    force_trans_after_inactivity_secs=0.0,
    force_response_after_inactivity_secs=0.0,
    seed=7,
)


def bench_audio(secs, seed=0, sr=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(int(secs * sr)) / sr
    return (
        0.2 * np.sin(2 * np.pi * 150 * t) * np.clip(np.sin(2 * np.pi * 0.7 * t), 0, 1)
        + 0.02 * rng.normal(size=t.shape)
    ).astype(np.float32)


def _pin_codec_region(agent, resources):
    """As the bench does: every sample is restricted to codec ids."""
    orig = agent.set_sampler

    def pinned(for_trans=False, suppress_end_audio=False):
        orig(for_trans=for_trans, suppress_end_audio=suppress_end_audio)
        resources.llm.settings.min_token_id = resources.tokenizer.codec_vocab_start

    agent.set_sampler = pinned
    agent.set_sampler()


def _agents(quant=None):
    """The JAX and the port's agents over the same weights; with ``quant``
    ("int8" or "int4") each resources quantizes the same dense weights
    (JaxResources' own seed-0 init) itself. The int4 LM computes in bf16:
    at f32 the JAX route keeps f32 activations where B5 rounds them to bf16,
    and with these weights a near-tie then flips a greedy token; in bf16 both
    routes see the same activations."""
    vocab = CodecTextTokenizer(codebook_size=1024).vocab_size
    lm_dtype = "bfloat16" if quant == "int4" else "float32"
    lcfg = jl.tiny_lm_config(vocab_size=vocab, codebook_size=1024, compute_dtype=lm_dtype)
    ccfg = tiny_codec_config(compute_dtype="float32")
    flags = {"quantize_int8": quant == "int8", "quantize_int4": quant == "int4"}
    jres = JaxResources(tiny=True, whisper_model=None, lm_config=lcfg, codec_config=ccfg, **flags)
    dense = jres.lm_params if quant is None else jl.init_lm_params(jax.random.PRNGKey(0), lcfg)
    tres = RealtimeAgentResources(
        tiny=True, device="cpu", **flags,
        lm_config=tl.DuplexLMConfig(**dataclasses.asdict(lcfg)),
        codec_config=tcodec.CodecConfig(**dataclasses.asdict(ccfg)),
        _lm_params=lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, dense)),
        _codec_params=codec_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jres.audio_tokenizer.codec_model.params)
        ),
    )
    jagent = JaxAgent(resources=jres, config=JaxConfig(**CONFIG))
    tagent = RealtimeAgent(resources=tres, config=RealtimeAgentConfig(**CONFIG))
    _pin_codec_region(jagent, jres)
    _pin_codec_region(tagent, tres)
    # the pinned sampler must be in place for the header prefill's state too
    jagent.reset()
    tagent.reset()
    return jagent, tagent


def test_agent_matches_jax_f32_greedy():
    jagent, tagent = _agents()
    assert tagent.input_ids == jagent.input_ids  # same header and enrollment codes
    audio = bench_audio(N_CHUNKS * 0.1)
    for c in range(N_CHUNKS):
        chunk = audio[c * 1600 : (c + 1) * 1600]
        jout = jagent.process_audio(chunk)
        tout = tagent.process_audio(chunk)
        assert tout.shape == jout.shape == (1600,)
        np.testing.assert_allclose(tout, jout, atol=1e-4)
    assert tagent.input_ids == jagent.input_ids
    assert tagent.audio_tokens_idx == jagent.audio_tokens_idx
    assert tagent.resources.llm.n_tokens == jagent.resources.llm.n_tokens
    np.testing.assert_allclose(
        tagent.stats.event_prob._ring[:N_CHUNKS, 0], jagent.stats.event_prob._ring[:N_CHUNKS, 0],
        atol=1e-5,
    )


def _quantized_leaves(params):
    """{"layers.<i>.<name>.<key>" or "lm_head.<key>": array} of every
    quantized leaf."""
    out = {}
    for i, blk in enumerate(params["layers"]):
        for name, leaf in blk.items():
            if isinstance(leaf, dict):
                out.update({f"layers.{i}.{name}.{k}": np.asarray(v) for k, v in leaf.items()})
    out.update({f"lm_head.{k}": np.asarray(v) for k, v in params["lm_head"].items()})
    return out


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_agent_int8_close_to_jax(quant):
    """int8 or int4 decode weights (the lm_head int8 in both): the port's
    quantized and fused leaves equal the JAX resources' bit for bit, and the
    agents agree at audio atol 1e-3 with equal n_tokens."""
    jagent, tagent = _agents(quant)
    want = _quantized_leaves(jax.tree_util.tree_map(np.asarray, jagent.resources.lm_params))
    got = _quantized_leaves(tagent.resources.lm_params)
    assert sorted(got) == sorted(want) and any(k.endswith(".q4") for k in got) == (quant == "int4")
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    audio = bench_audio(N_CHUNKS * 0.1)
    for c in range(N_CHUNKS):
        chunk = audio[c * 1600 : (c + 1) * 1600]
        jout = jagent.process_audio(chunk)
        tout = tagent.process_audio(chunk)
        assert tout.shape == (1600,) and np.isfinite(tout).all()
        np.testing.assert_allclose(tout, jout, atol=1e-3)
    assert tagent.resources.llm.n_tokens == jagent.resources.llm.n_tokens


def test_fused_matches_unfused_agent_greedy():
    """Within the port: fused chunks against the agent's per-chunk path
    without a session (host AudioTokenizer encode/decode + the frames
    continuation), greedy: identical sequences, audio close."""
    tres = RealtimeAgentResources(tiny=True, device="cpu", seed=1)
    agents = []
    for fused in (True, False):
        res = RealtimeAgentResources(
            tiny=True, device="cpu", lm_config=tres.lm_config,
            _lm_params=tres.lm_params, _codec_params=tres.audio_tokenizer.codec_model.params,
        )
        agent = RealtimeAgent(resources=res, config=RealtimeAgentConfig(**CONFIG, use_fused_step=fused))
        _pin_codec_region(agent, res)
        agent.reset()
        agents.append(agent)
    fused, unfused = agents
    assert unfused._session is None
    audio = bench_audio(0.4, seed=5)
    for c in range(4):
        chunk = audio[c * 1600 : (c + 1) * 1600]
        np.testing.assert_allclose(fused.process_audio(chunk), unfused.process_audio(chunk), atol=1e-4)
    assert fused.input_ids == unfused.input_ids
    assert fused.resources.llm.n_tokens == unfused.resources.llm.n_tokens


def test_unported_paths_raise(tmp_path):
    """A Hugging Face checkpoint directory whose config.json lacks the
    geometry fails as the JAX resources do: a KeyError naming ``vocab_size``
    (loading real directories: test_torch_convert.py; the external LLM and
    TTS: test_torch_external_agent_paths.py). ``use_whisper`` with no ASR
    model loaded warns and turns itself off, as the JAX agent does (Whisper
    itself: test_torch_asr.py; pipelining, async detours and the incremental
    trim: test_torch_pipeline.py, test_torch_async_detours.py and
    test_torch_trim_incremental.py)."""
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(KeyError, match="vocab_size"):
        RealtimeAgentResources(tiny=True, device="cpu", llm_model_path=str(tmp_path))
    tres = RealtimeAgentResources(tiny=True, device="cpu")
    cfg = RealtimeAgentConfig(**{**CONFIG, "use_whisper": True})
    with pytest.warns(UserWarning, match="no ASR model is loaded; disabling"):
        agent = RealtimeAgent(resources=tres, config=cfg)
    assert agent.config.use_whisper is False
