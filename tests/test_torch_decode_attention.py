"""Kernel B3 (the small-T two-piece attention): the Pallas contract's plain
partials against the JAX Pallas kernel (interpret mode); decode_attention on
CPU tensors (its plain version) and the port's two-piece attention against
the JAX one-shot and flash paths. The CUDA kernel's own test is in
test_torch_cuda_kernels.py."""
import jax
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
    tm, tl, tacc = tda.decode_attention_partials_plain(
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


@pytest.mark.parametrize("t,g,dh,cache_valid", [(8, 7, 64, 700), (8, 6, 128, 2559), (3, 6, 128, 700), (1, 8, 128, 0)])
def test_two_piece_attention_wide_groups_matches_jax(t, g, dh, cache_valid):
    """Qwen2.5's geometries: G = 7 at T = 8 (56 rows per KV head, two row
    groups of kernel B3), head dim 128 with G = 6 and 8."""
    args = _two_piece_case(t, kh=2, g=g, dh=dh, cache_valid=cache_valid, seed=t + g + dh)
    want = np.asarray(jllama._gqa_two_piece_attention(*[jnp.asarray(a) for a in args]))
    got = tllama._gqa_two_piece_attention(*[torch.from_numpy(a) for a in args]).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _decode_case(b, t, g, dh, w, cvs, per_row_pos, kh=2, s=2560, seed=0):
    """B batch rows with their own cache_valid; a window of W keys: W - T
    earlier extra keys (every 5th rejected) and the T query tokens."""
    rng = np.random.default_rng(seed)
    h = kh * g
    top = max(cvs)
    q = rng.normal(size=(b, t, h, dh)).astype(np.float32)
    k_big = rng.normal(size=(b, s, kh, dh)).astype(np.float32)
    v_big = rng.normal(size=(b, s, kh, dh)).astype(np.float32)
    k_new = rng.normal(size=(b, w, kh, dh)).astype(np.float32)
    v_new = rng.normal(size=(b, w, kh, dh)).astype(np.float32)
    rows = b if per_row_pos else 1
    base = (np.array(cvs) if per_row_pos else np.array([top]))[:, None]
    extra = base + np.arange(w - t)[None]
    extra[:, ::5] = 2**30  # REJECTED_POS slots
    q_pos = (base + (w - t) + np.arange(t)[None]).astype(np.int32)
    new_pos = np.concatenate([extra, q_pos], axis=1).astype(np.int32)
    assert q_pos.shape[0] == rows
    cv = np.array(cvs, np.int32)
    return q, k_big, v_big, k_new, v_new, q_pos, new_pos, cv


_J_TWO_PIECE = jax.jit(jllama._gqa_two_piece_attention)


@pytest.mark.parametrize(
    "b,t,g,dh,w,cvs,per_row_pos,dtype",
    [
        (2, 3, 4, 64, 65, (700, 1500), False, "float32"),   # Llama's 12 rows, Bc = 2, Bq = Bn = 1
        (2, 1, 1, 64, 65, (0, 300), True, "float32"),       # one row, per-row positions, an empty cache
        (1, 8, 8, 128, 65, (2000,), False, "float32"),      # 64 rows at head dim 128
        (2, 8, 6, 128, 20, (0, 0), True, "float32"),        # 48 rows, cache_valid 0: the window alone
        (2, 5, 7, 64, 9, (2559, 1), False, "float32"),      # 35 rows, a full and a one-key cache
        (2, 3, 4, 64, 65, (700, 1500), False, "bfloat16"),
        (1, 8, 8, 128, 65, (2000,), False, "bfloat16"),
        (2, 1, 6, 128, 65, (0, 900), True, "bfloat16"),
        (2, 3, 4, 64, 103, (700, 0), False, "float32"),     # a 1 s chunk's frame scan: W = 2 * 50 + 3
        (1, 1, 6, 128, 129, (1500,), False, "bfloat16"),    # generate_until at max_n 128
    ],
)
def test_decode_attention_matches_jax(b, t, g, dh, w, cvs, per_row_pos, dtype):
    """decode_attention on CPU tensors (the plain version) against jitted JAX
    _gqa_two_piece_attention, at the kernel's shapes. f32 at 1e-5. bf16:
    JAX rounds the cache probabilities to bf16 and the port keeps them in
    f32, and both round the output to bf16. The reading over the first three
    bf16 cases: max |diff| 9.8e-4 / 4.9e-4 / 3.9e-3 at max |out| 0.218 / 0.196 /
    0.805, i.e. 0.0025-0.0049 of max |out| (at most one bf16 ulp of the
    largest element); the W = 129 case 4.9e-4 at 0.148 (0.0033). The limit
    is 2^-7 = 0.0078 of max |out|."""
    args = _decode_case(b, t, g, dh, w, cvs, per_row_pos, seed=b * 100 + t * 10 + g + dh)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = np.asarray(_J_TWO_PIECE(*[jnp.asarray(a, jdt) for a in args[:5]], *map(jnp.asarray, args[5:])))
    calls = tda.decode_attention_plain.calls
    got = tda.decode_attention(*[torch.from_numpy(a).to(tdt) for a in args[:5]], *map(torch.from_numpy, args[5:]))
    assert tda.decode_attention_plain.calls == calls + 1
    assert got.dtype == tdt and got.shape == (b, t, g * 2, dh)
    got = got.float().numpy()
    want = want.astype(np.float32)
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        err = float(np.abs(got - want).max())
        assert err <= 2.0 ** -7 * float(np.abs(want).max()), err
