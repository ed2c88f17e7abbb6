"""Finalize scoring in the port against the JAX package (tiny config, f32):
the cacheless ``forward`` (masked attention at T <= 512, kernel B4's plain
version above), and the engine's ``get_logprobs`` / ``get_logprobs_batch``
on the same converted weights, including a pair past 512 tokens (bucket
1024, the flash branch).

Tolerances: hidden states and logprobs at atol 1e-4 (f32, the same math
with sums in another order). int8 weights: both sides take the wide route
(f32 matmul against the widened int8 weights, times the scales), so the
same 1e-4 holds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.lm.engine import DuplexLMEngine as JaxEngine
from realtime_codec_agent_tpu.models import llama as jl
from realtime_codec_agent_tpu_torch.lm import engine as teng
from realtime_codec_agent_tpu_torch.models import llama as tl
from realtime_codec_agent_tpu_torch.models.from_jax import lm_params_from_numpy
from realtime_codec_agent_tpu_torch.ops import flash_attention as tfa

VOCAB = 1320


@pytest.fixture(scope="module")
def models():
    jcfg = jl.tiny_lm_config(vocab_size=VOCAB, compute_dtype="float32")
    jparams = jl.init_lm_params(jax.random.PRNGKey(3), jcfg)
    tcfg = tl.DuplexLMConfig(**dataclasses.asdict(jcfg))
    return jcfg, jparams, tcfg


def _torch_params(jparams):
    return lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))


def _engines(models, transform=None):
    jcfg, jparams, tcfg = models
    if transform is not None:
        jparams = transform(jparams)
    jeng = JaxEngine(jparams, jcfg, seed=0)
    teng_ = teng.DuplexLMEngine(_torch_params(jparams), tcfg, seed=0, device="cpu")
    return jeng, teng_


def _pairs(rng):
    """A short pair (bucket 16) and one past 512 tokens (bucket 1024)."""
    return [
        (list(rng.integers(0, VOCAB, size=9)), list(rng.integers(0, VOCAB, size=4))),
        (list(rng.integers(0, VOCAB, size=560)), list(rng.integers(0, VOCAB, size=20))),
    ]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("t", [16, 600])
def test_forward_matches_jax(models, t, fused):
    jcfg, jparams, tcfg = models
    if fused:
        jparams = jl.fuse_lm_params_for_decode(jparams)
    ids = np.random.default_rng(t).integers(0, VOCAB, size=(2, t)).astype(np.int32)
    jh, _ = jl.forward(jparams, jnp.asarray(ids), jcfg)
    calls = tfa.flash_causal_attention.calls
    th = tl.forward(_torch_params(jparams), torch.from_numpy(ids).long(), tcfg)
    # the flash branch runs once per layer at T > 512, never at T <= 512
    assert tfa.flash_causal_attention.calls - calls == (tcfg.num_layers if t > 512 else 0)
    assert th.shape == (2, t, tcfg.hidden_size)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)


def test_get_logprobs_matches_jax(models):
    jeng, teng_ = _engines(models)
    for ctx, ids in _pairs(np.random.default_rng(1)):
        want = jeng.get_logprobs(ctx, ids)
        got = teng_.get_logprobs(ctx, ids)
        assert got.shape == (len(ids),)
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_get_logprobs_batch_matches_jax(models):
    """Both contexts in one forward (finalize's batch of two), rows padded to
    the longer one's bucket (1024)."""
    jeng, teng_ = _engines(models, transform=jl.fuse_lm_params_for_decode)
    pairs = _pairs(np.random.default_rng(2))
    want = jeng.get_logprobs_batch(pairs)
    got = teng_.get_logprobs_batch(pairs)
    for (_, ids), w, g in zip(pairs, want, got):
        assert g.shape == (len(ids),)
        np.testing.assert_allclose(g, w, atol=1e-4)
    # batched equals per-pair within the port
    for (ctx, ids), g in zip(pairs, got):
        np.testing.assert_allclose(teng_.get_logprobs(ctx, ids), g, atol=1e-5)


def test_get_logprobs_int8_matches_jax(models):
    def q8(p):
        return jl.quantize_params_int8(jl.fuse_lm_params_for_decode(p))

    jeng, teng_ = _engines(models, transform=q8)
    assert isinstance(teng_.params["lm_head"], dict)
    pairs = _pairs(np.random.default_rng(4))
    want = jeng.get_logprobs_batch(pairs)
    got = teng_.get_logprobs_batch(pairs)
    for w, g in zip(want, got):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_get_logprobs_empty_ctx_raises(models):
    _, teng_ = _engines(models)
    with pytest.raises(ValueError, match="non-empty ctx"):
        teng_.get_logprobs([], [1, 2, 3])
    with pytest.raises(ValueError, match="non-empty ctx"):
        teng_.get_logprobs_batch([([1, 2], [3]), ([], [4])])


def test_scoring_leaves_engine_state(models):
    """Cacheless: n_tokens, the host mirror, the last logits and the KV
    cache are what they were."""
    _, teng_ = _engines(models)
    teng_.init_sampler_for_generate(temp=0.0, seed=0)
    teng_.eval([1, 2, 3])
    before = (teng_.n_tokens, list(teng_._input_ids), teng_._last_logits.clone(),
              teng_._k.clone(), teng_._v.clone())
    teng_.get_logprobs([4, 5], [6, 7])
    teng_.get_logprobs_batch(_pairs(np.random.default_rng(5)))
    assert teng_.n_tokens == before[0] == 3
    assert teng_._input_ids == before[1]
    torch.testing.assert_close(teng_._last_logits, before[2], rtol=0, atol=0)
    torch.testing.assert_close(teng_._k, before[3], rtol=0, atol=0)
    torch.testing.assert_close(teng_._v, before[4], rtol=0, atol=0)


@pytest.mark.parametrize("longest,bucket", [(5, 8), (600, 1024), (2048, 2048), (2049, 4096), (5000, 8192)])
def test_logprobs_buckets(models, monkeypatch, longest, bucket):
    """Rows pad to the prefill buckets, then to powers of two past 2,048 --
    any length, with no block-multiple rule."""
    _, teng_ = _engines(models)
    shapes = []

    def fake_score(tokens, targets):
        shapes.append(tuple(tokens.shape))
        return torch.zeros(tokens.shape, dtype=torch.float32)

    monkeypatch.setattr(teng_, "score", fake_score)
    out = teng_.get_logprobs_batch([([1] * (longest - 2), [2, 3]), ([4], [5])])
    assert shapes == [(2, bucket)]
    assert [len(o) for o in out] == [2, 1]
