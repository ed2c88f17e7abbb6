"""Kernel B3 (decode attention partials over the cache prefix): the port's
plain version against the JAX Pallas kernel (interpret mode), the two-piece
attention (partials + merge) against the JAX one-shot and flash paths. The
CUDA kernel's own test is in test_torch_cuda_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.models import llama as jllama
from realtime_codec_agent_tpu.ops.decode_attention import BLOCK_S, decode_attention_partials as j_partials
from realtime_codec_agent_tpu_torch.models import llama as tllama
from realtime_codec_agent_tpu_torch.ops import decode_attention as tda


def _logz(m, l):
    return np.asarray(m)[..., 0] + np.log(np.maximum(np.asarray(l)[..., 0], 1e-30))


@pytest.mark.parametrize("n_valid", [0, 1, 5, BLOCK_S, BLOCK_S + 7, 2 * BLOCK_S])
def test_plain_matches_pallas_interpret(n_valid):
    kh, gt, dh = 4, 3, 64
    s = 2 * BLOCK_S
    rng = np.random.default_rng(n_valid)
    qg = rng.normal(size=(kh, gt, dh)).astype(np.float32)
    k = rng.normal(size=(s, kh, dh)).astype(np.float32)
    v = rng.normal(size=(s, kh, dh)).astype(np.float32)
    scale = dh ** -0.5
    jm, jl, jacc = j_partials(
        jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v), jnp.int32(n_valid), scale, interpret=True
    )
    tm, tl, tacc = tda.decode_attention_partials(
        torch.from_numpy(qg), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(n_valid, dtype=torch.int32), scale,
    )
    if n_valid == 0:
        assert float(tl.max()) == 0.0 and float(np.max(np.asarray(jl))) == 0.0
        assert torch.isfinite(tm).all() and torch.isfinite(tacc).all()
        return
    out_t = tacc.numpy() / np.maximum(tl.numpy(), 1e-30)
    out_j = np.asarray(jacc) / np.maximum(np.asarray(jl), 1e-30)
    np.testing.assert_allclose(out_t, out_j, atol=2e-3)
    np.testing.assert_allclose(_logz(tm, tl), _logz(jm, jl), atol=1e-3)


def _two_piece_case(t, s=2560, kh=2, g=2, dh=16, w_extra=4, cache_valid=700, seed=0):
    rng = np.random.default_rng(seed)
    h = kh * g
    q = rng.normal(size=(1, t, h, dh)).astype(np.float32)
    k_big = rng.normal(size=(1, s, kh, dh)).astype(np.float32)
    v_big = rng.normal(size=(1, s, kh, dh)).astype(np.float32)
    w = w_extra + t
    k_new = rng.normal(size=(1, w, kh, dh)).astype(np.float32)
    v_new = rng.normal(size=(1, w, kh, dh)).astype(np.float32)
    q_pos = (cache_valid + w_extra + np.arange(t))[None].astype(np.int32)
    extra_pos = cache_valid + np.arange(w_extra)
    extra_pos[1] = 2**30  # a rejected slot
    new_pos = np.concatenate([extra_pos, q_pos[0]])[None].astype(np.int32)
    cv = np.array([cache_valid], np.int32)
    return q, k_big, v_big, k_new, v_new, q_pos, new_pos, cv


@pytest.mark.parametrize("t,cache_valid", [(1, 700), (3, 700), (3, 0), (8, 2559), (16, 700)])
def test_two_piece_attention_matches_jax(t, cache_valid):
    """T < 9: the port's partials + merge against JAX's one-shot softmax;
    T = 16: both take the block-by-block online softmax."""
    args = _two_piece_case(t, cache_valid=cache_valid, seed=t)
    want = np.asarray(jllama._gqa_two_piece_attention(*[jnp.asarray(a) for a in args]))
    got = tllama._gqa_two_piece_attention(*[torch.from_numpy(a) for a in args]).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)
