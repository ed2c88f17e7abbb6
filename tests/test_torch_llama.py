"""PyTorch duplex LM decode side against the JAX package (tiny config):
forward_decode logits at f32 atol 1e-4 (dense, fused, with extra_kv, and a
prefill-sized T) and at bf16 atol 5e-2, and the scatter commit exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.models import llama as jl
from realtime_codec_agent_tpu_torch.models import llama as tl
from realtime_codec_agent_tpu_torch.models.from_jax import lm_params_from_numpy

VOCAB = 1320
S = 2560  # tiny max_context 512 + 2048 slack, as the engine sizes it


def _setup(dtype, fused):
    jcfg = jl.tiny_lm_config(vocab_size=VOCAB, compute_dtype=dtype)
    jparams = jl.init_lm_params(jax.random.PRNGKey(0), jcfg)
    if fused:
        jparams = jl.fuse_lm_params_for_decode(jparams)
    tcfg = tl.DuplexLMConfig(**dataclasses.asdict(jcfg))
    tparams = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


def _cache(cfg, seed, dtype):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, 1, S, cfg.num_kv_heads, cfg.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    return (jnp.asarray(k, dtype), jnp.asarray(v, dtype),
            torch.from_numpy(k).to(getattr(torch, dtype)), torch.from_numpy(v).to(getattr(torch, dtype)))


def _run(jcfg, jparams, tcfg, tparams, ids, positions, cache_valid, extra=None, dtype="float32"):
    jk, jv, tk, tv = _cache(jcfg, 1, dtype)
    jextra = textra = jpos = tpos = None
    if extra is not None:
        ek, ev, epos = extra
        jextra = (jnp.asarray(ek, dtype), jnp.asarray(ev, dtype))
        textra = (torch.from_numpy(ek).to(getattr(torch, dtype)), torch.from_numpy(ev).to(getattr(torch, dtype)))
        jpos, tpos = jnp.asarray(epos), torch.from_numpy(epos)
    jh, jnk, jnv = jl.forward_decode(
        jparams, jnp.asarray(ids), jcfg, jk, jv, jnp.asarray(positions),
        cache_valid=jnp.int32(cache_valid), extra_kv=jextra, extra_pos=jpos,
    )
    th, tnk, tnv = tl.forward_decode(
        tparams, torch.from_numpy(ids), tcfg, tk, tv, torch.from_numpy(positions),
        cache_valid=torch.tensor(cache_valid, dtype=torch.int32), extra_kv=textra, extra_pos=tpos,
    )
    jlog = np.asarray(jl.logits_from_hidden(jparams, jh, jcfg), np.float32)
    tlog = tl.logits_from_hidden(tparams, th, tcfg).float().numpy()
    return (jlog, tlog), (np.asarray(jnk, np.float32), tnk.float().numpy())


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("t", [1, 3, 16])
def test_forward_decode_f32(fused, t):
    jcfg, jparams, tcfg, tparams = _setup("float32", fused)
    ids = np.random.default_rng(t).integers(0, VOCAB, size=(1, t)).astype(np.int32)
    positions = (300 + np.arange(t)).astype(np.int32)
    (jlog, tlog), (jnk, tnk) = _run(jcfg, jparams, tcfg, tparams, ids, positions, 300)
    np.testing.assert_allclose(tlog, jlog, atol=1e-4)
    np.testing.assert_allclose(tnk, jnk, atol=1e-4)


def test_forward_decode_extra_kv_f32():
    """The fused frame step's shape: a probe triple against the cache plus
    earlier uncommitted pairs, one of them rejected."""
    jcfg, jparams, tcfg, tparams = _setup("float32", True)
    rng = np.random.default_rng(9)
    shape = (jcfg.num_layers, 1, 6, jcfg.num_kv_heads, jcfg.head_dim)
    ek = rng.normal(size=shape).astype(np.float32)
    ev = rng.normal(size=shape).astype(np.float32)
    epos = np.array([200, 201, 2**30, 2**30, 202, 203], np.int32)
    ids = rng.integers(0, VOCAB, size=(1, 3)).astype(np.int32)
    positions = (204 + np.arange(3)).astype(np.int32)
    (jlog, tlog), _ = _run(jcfg, jparams, tcfg, tparams, ids, positions, 200, extra=(ek, ev, epos))
    np.testing.assert_allclose(tlog, jlog, atol=1e-4)


def test_forward_decode_bf16():
    jcfg, jparams, tcfg, tparams = _setup("bfloat16", True)
    ids = np.random.default_rng(5).integers(0, VOCAB, size=(1, 3)).astype(np.int32)
    positions = (120 + np.arange(3)).astype(np.int32)
    (jlog, tlog), _ = _run(jcfg, jparams, tcfg, tparams, ids, positions, 120, dtype="bfloat16")
    np.testing.assert_allclose(tlog, jlog, atol=5e-2)


def test_embed_ids_codec_route_matches_jax():
    """Ids at or past codec_vocab_start take the codec table + projector."""
    jcfg = jl.tiny_lm_config(vocab_size=VOCAB, codec_vocab_start=296, compute_dtype="float32")
    jparams = jl.init_lm_params(jax.random.PRNGKey(4), jcfg, with_codec_embed=True)
    tcfg = tl.DuplexLMConfig(**dataclasses.asdict(jcfg))
    tparams = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    ids = np.array([[0, 5, 295, 296, 297, 1319]], np.int32)
    want = np.asarray(jl.embed_ids(jparams, jnp.asarray(ids), jcfg))
    got = tl.embed_ids(tparams, torch.from_numpy(ids), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_commit_kv_scatter_exact():
    rng = np.random.default_rng(2)
    shape = (2, 1, S, 2, 16)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    nk = rng.normal(size=(2, 1, 10, 2, 16)).astype(np.float32)
    nv = rng.normal(size=(2, 1, 10, 2, 16)).astype(np.float32)
    trash = S - 4
    # accepted pairs at their positions, rejected ones (duplicates) at the trash slot
    target = np.array([50, 51, 52, 53, trash, trash, trash, trash, trash, trash], np.int32)
    jk, jv = jl.commit_kv_scatter(jnp.asarray(k), jnp.asarray(v), jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(target))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tl.commit_kv_scatter(tk, tv, torch.from_numpy(nk), torch.from_numpy(nv), torch.from_numpy(target))
    live = np.arange(S) != trash  # the trash slot holds whichever duplicate landed last
    np.testing.assert_array_equal(tk.numpy()[:, :, live], np.asarray(jk)[:, :, live])
    np.testing.assert_array_equal(tv.numpy()[:, :, live], np.asarray(jv)[:, :, live])
