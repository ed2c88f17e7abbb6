"""The port's GGUF import (models/gguf.py, its own copy of the JAX reader,
and models/convert.lm_params_from_hf) against the JAX package's, on
synthetic files written by the JAX tests' own writer: a Q4_K_M-style mix
(Q4_K bulk, Q6_K for attn_v / ffn_down / output, F32 norms and embedding).

- ``read_gguf``: the same metadata and tensors, native Q4_K leaves included;
- ``load_gguf_llama``, dense and ``int4=True``: every leaf bit for bit, the
  config field for field;
- ``RealtimeAgentResources(llm_model_path=<file>.gguf, quantize_int4=True)``:
  the tokenizer saved beside the file, leaves bit for bit against
  ``JaxResources`` on the same file, and three greedy chunks of the agent
  giving the same tokens (bf16 compute, the GGUF config's: both routes then
  see the same activations).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.agent.agent import RealtimeAgent as JaxAgent
from realtime_codec_agent_tpu.agent.config import RealtimeAgentConfig as JaxConfig
from realtime_codec_agent_tpu.agent.resources import RealtimeAgentResources as JaxResources
from realtime_codec_agent_tpu.models import gguf as jgguf
from realtime_codec_agent_tpu.tokenization import CodecTextTokenizer
from realtime_codec_agent_tpu_torch.agent.agent import RealtimeAgent
from realtime_codec_agent_tpu_torch.agent.config import RealtimeAgentConfig
from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources
from realtime_codec_agent_tpu_torch.models import codec as tcodec
from realtime_codec_agent_tpu_torch.models import gguf as tgguf
from realtime_codec_agent_tpu_torch.models.from_jax import codec_params_from_numpy

from test_gguf import _META, GGML_Q4_K, GGML_Q6_K, write_gguf

H, FFN, HEADS, KV, DH = 256, 512, 4, 2, 64  # k-quants need the input dim % 256 == 0


def _q4km_file(path, vocab: int, layers: int, seed: int):
    rng = np.random.default_rng(seed)

    def rnd(*shape, s=0.05):
        return rng.normal(size=shape).astype(np.float32) * s

    t = {"token_embd.weight": rnd(vocab, H), "output_norm.weight": np.ones(H, np.float32),
         "output.weight": rnd(vocab, H)}
    for i in range(layers):
        t[f"blk.{i}.attn_norm.weight"] = np.ones(H, np.float32)
        t[f"blk.{i}.attn_q.weight"] = rnd(HEADS * DH, H)
        t[f"blk.{i}.attn_k.weight"] = rnd(KV * DH, H)
        t[f"blk.{i}.attn_v.weight"] = rnd(KV * DH, H)
        t[f"blk.{i}.attn_output.weight"] = rnd(H, HEADS * DH)
        t[f"blk.{i}.ffn_norm.weight"] = np.ones(H, np.float32)
        t[f"blk.{i}.ffn_gate.weight"] = rnd(FFN, H)
        t[f"blk.{i}.ffn_up.weight"] = rnd(FFN, H)
        t[f"blk.{i}.ffn_down.weight"] = rnd(H, FFN)
    meta = dict(_META)
    meta.update({
        "llama.embedding_length": H, "llama.feed_forward_length": FFN, "llama.attention.head_count": HEADS,
        "llama.attention.head_count_kv": KV, "llama.rope.dimension_count": DH, "llama.vocab_size": vocab,
        "llama.block_count": layers,
    })
    enc = {}
    for name in t:
        if "norm" in name or name == "token_embd.weight":
            continue
        q6 = "attn_v" in name or "ffn_down" in name or name == "output.weight"
        enc[name] = GGML_Q6_K if q6 else GGML_Q4_K
    write_gguf(path, meta, t, enc)
    return path


def _keep(name):
    return name.startswith("blk.") and name.split(".", 2)[2] in jgguf._LAYER_MATMULS


def _assert_tree_equal(got, want, where=""):
    """A port param tree (torch) against a JAX one (numpy), bit for bit."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{where}.{i}")
    else:
        want = np.asarray(want)
        got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype) if want.dtype.name == "bfloat16" else want,
                                      err_msg=where)
        assert got.dtype == (np.float32 if want.dtype.name == "bfloat16" else want.dtype), where


@pytest.mark.parametrize("keep", [False, True])
def test_read_gguf_matches_jax(tmp_path, keep):
    path = str(_q4km_file(tmp_path / "q4km.gguf", vocab=96, layers=2, seed=11))
    jmeta, jt = jgguf.read_gguf(path, keep_q4k=_keep if keep else None)
    tmeta, tt = tgguf.read_gguf(path, keep_q4k=_keep if keep else None)
    assert tmeta == jmeta and set(tt) == set(jt)
    for name, want in jt.items():
        got = tt[name]
        if isinstance(want, dict):
            assert keep and set(got) == {"q4", "d", "m"}
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
            assert got.dtype == want.dtype


@pytest.mark.parametrize("int4", [False, True])
def test_load_gguf_llama_matches_jax(tmp_path, int4):
    """Every leaf bit for bit (the native int4 leaves included: uint8 q4, f32
    d and m, (in, out)), and the config field for field."""
    path = str(_q4km_file(tmp_path / "q4km.gguf", vocab=96, layers=2, seed=12))
    jparams, jcfg = jgguf.load_gguf_llama(path, dtype="float32", max_context=64, int4=int4)
    tparams, tcfg = tgguf.load_gguf_llama(path, dtype="float32", max_context=64, int4=int4)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    _assert_tree_equal(tparams, jax.tree_util.tree_map(np.asarray, jparams))
    wq = tparams["layers"][0]["wq"]
    assert isinstance(wq, dict) == int4 and isinstance(tparams["layers"][0]["wv"], torch.Tensor)
    # the default dtype is the config's compute dtype, as the JAX converter's
    bparams, _ = tgguf.load_gguf_llama(path, max_context=64, int4=int4)
    assert bparams["embed_tokens"].dtype == torch.bfloat16


CONFIG = dict(temperature=0.0, use_whisper=False, agent_opening_text=None,
              force_trans_after_inactivity_secs=0.0, force_response_after_inactivity_secs=0.0, seed=7)


def _pinned(agent, res):
    orig = agent.set_sampler

    def pinned(for_trans=False, suppress_end_audio=False):
        orig(for_trans=for_trans, suppress_end_audio=suppress_end_audio)
        res.llm.settings.min_token_id = res.tokenizer.codec_vocab_start

    agent.set_sampler = pinned
    agent.set_sampler()
    agent.reset()
    return agent


def test_resources_gguf_int4_matches_jax(tmp_path):
    CodecTextTokenizer(codebook_size=1024).save(str(tmp_path))  # codec_tokenizer.json beside the model
    vocab = CodecTextTokenizer(codebook_size=1024).vocab_size
    path = str(_q4km_file(tmp_path / "model.gguf", vocab=vocab, layers=2, seed=13))
    jres = JaxResources(llm_model_path=path, tiny=True, whisper_model=None, llm_n_ctx=1024, quantize_int4=True)
    jcodec = jres.audio_tokenizer.codec_model
    tres = RealtimeAgentResources(
        llm_model_path=path, tiny=True, device="cpu", llm_n_ctx=1024, quantize_int4=True,
        codec_config=tcodec.CodecConfig(**dataclasses.asdict(jcodec.config)),
        _codec_params=codec_params_from_numpy(jax.tree_util.tree_map(np.asarray, jcodec.params)),
    )
    assert dataclasses.asdict(tres.lm_config) == dataclasses.asdict(jres.lm_config)
    assert tres.lm_config.vocab_size == vocab and tres.tokenizer.vocab_size == vocab
    assert set(tres.lm_params["layers"][0]["wqkv"]) == {"q4", "d", "m"}  # Q4_K rows kept native
    assert set(tres.lm_params["layers"][0]["w_down"]) == {"q4", "d", "m"}  # Q6_K rows quantized here
    _assert_tree_equal(tres.lm_params, jax.tree_util.tree_map(np.asarray, jres.lm_params))

    jagent = _pinned(JaxAgent(resources=jres, config=JaxConfig(**CONFIG)), jres)
    tagent = _pinned(RealtimeAgent(resources=tres, config=RealtimeAgentConfig(**CONFIG)), tres)
    rng = np.random.default_rng(3)
    audio = (0.1 * rng.normal(size=3 * 1600)).astype(np.float32)
    for c in range(3):
        chunk = audio[c * 1600 : (c + 1) * 1600]
        jagent.process_audio(chunk)
        tagent.process_audio(chunk)
    assert tagent.input_ids == jagent.input_ids
    assert len(tagent.audio_tokens_idx) == len(jagent.audio_tokens_idx) > 0
