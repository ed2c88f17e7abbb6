"""Kernel B4's plain version (ops/flash_attention.flash_causal_attention)
against the JAX package's XLA flash path and its masked attention.

On the CPU the JAX package reaches B4 only through that XLA path
(``train_attention`` -> ``flash_causal_attention``, forward
``_flash_fwd_impl``), so the comparison is made there. The port takes k and v
with KH heads (the kernel reads KV head h // (H // KH)); JAX gets them
head-repeated.

Tolerances: f32, out and lse at atol 1e-5 (the same algorithm, sums in
another order). bf16 inputs, out at atol 2e-2: both sides round the
probabilities to bf16 before P.V and the output to bf16, and a one-ulp
difference in a rounded probability or output is ~4e-3 at these magnitudes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.ops import nn as jnn
from realtime_codec_agent_tpu_torch.ops import flash_attention as tfa
from realtime_codec_agent_tpu_torch.ops import nn as tnn

DH = 16


def _inputs(b, t, h, kh, seed, dh=DH):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, t, kh, dh)).astype(np.float32)
    v = rng.normal(size=(b, t, kh, dh)).astype(np.float32)
    return q, k, v


def _jax_fwd(q, k, v, n_rep, dtype=jnp.float32, block=1024, valid=None):
    """JAX's _flash_fwd_impl on head-repeated K/V, padded as
    flash_causal_attention pads them; ``valid`` (B, T) or every key live."""
    b, t, h, dh = q.shape
    jq = jnp.asarray(q, dtype)
    jk = jnn.repeat_kv(jnp.asarray(k, dtype), n_rep)
    jv = jnn.repeat_kv(jnp.asarray(v, dtype), n_rep)
    t_pad = -(-t // block) * block
    pad = [(0, 0), (0, t_pad - t), (0, 0), (0, 0)]
    jvalid = np.ones((b, t_pad), np.float32)
    if valid is not None:
        jvalid[:, :t] = valid
    out, lse = jnn._flash_fwd_impl(
        jq, jnp.pad(jk, pad), jnp.pad(jv, pad), jnp.asarray(jvalid), block, float(dh ** -0.5), t,
    )
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)


def _dead_row(b, t):
    """Key validity with every key of the last batch row dead."""
    valid = np.ones((b, t), np.float32)
    valid[-1] = 0.0
    return valid


def _fwd_id(case):
    """Cases without a dead row keep their ids of before it was a parameter."""
    *rest, dead = case
    return "-".join(map(str, rest)) + ("-dead_row" if dead else "")


F32_CASES = [  # (b, t, h, kh, a dead batch row)
    (2, 1, 4, 1, False), (1, 7, 4, 4, False), (2, 600, 4, 1, False), (1, 1024, 4, 1, False), (1, 1500, 2, 2, False),
    # the f32 kernel's tiles at 12 / 2 heads: a last tile of one row; a batch row with no live key
    (2, 129, 12, 2, False), (1, 1025, 12, 2, False), (2, 129, 12, 2, True),
]


@pytest.mark.parametrize("b,t,h,kh,dead_row", F32_CASES, ids=[_fwd_id(c) for c in F32_CASES])
def test_plain_matches_jax_flash_f32(b, t, h, kh, dead_row):
    q, k, v = _inputs(b, t, h, kh, seed=t)
    valid = _dead_row(b, t) if dead_row else None
    calls = tfa.flash_causal_attention.calls
    out, lse = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   valid=None if valid is None else torch.from_numpy(valid))
    assert tfa.flash_causal_attention.calls == calls + 1  # a CPU tensor takes the plain version
    jout, jlse = _jax_fwd(q, k, v, h // kh, valid=valid)
    assert out.shape == (b, t, h, DH) and lse.shape == (b, h, t, 1)
    np.testing.assert_allclose(out.numpy(), jout, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=1e-5)
    if dead_row:  # no live key: out = 0 and lse = 0
        assert float(out[-1].abs().max()) == 0.0 and float(lse[-1].abs().max()) == 0.0
    # the public JAX entry point (custom-VJP wrapper) gives the same output
    jflash = np.asarray(
        jnn.flash_causal_attention(
            jnp.asarray(q), jnn.repeat_kv(jnp.asarray(k), h // kh), jnn.repeat_kv(jnp.asarray(v), h // kh),
            valid=None if valid is None else jnp.asarray(valid),
        )
    )
    np.testing.assert_allclose(out.numpy(), jflash, atol=1e-5)


@pytest.mark.parametrize("t,h,kh", [(7, 4, 1), (300, 4, 2)])
def test_plain_matches_jax_masked_attention(t, h, kh):
    """The long-block path and the T <= 512 path agree: B4's plain version
    against JAX ``attention`` with ``causal_mask``, and the port's own."""
    q, k, v = _inputs(1, t, h, kh, seed=100 + t)
    out, _ = tfa.flash_causal_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    n_rep = h // kh
    want = np.asarray(
        jnn.attention(
            jnp.asarray(q), jnn.repeat_kv(jnp.asarray(k), n_rep), jnn.repeat_kv(jnp.asarray(v), n_rep),
            mask=jnn.causal_mask(t, t, 0),
        )
    )
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    mine = tnn.attention(
        torch.from_numpy(q), tnn.repeat_kv(torch.from_numpy(k), n_rep), tnn.repeat_kv(torch.from_numpy(v), n_rep),
        mask=tnn.causal_mask(t, t, 0),
    )
    np.testing.assert_allclose(mine.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("t", [600, 1500])
def test_plain_matches_jax_flash_bf16(t):
    q, k, v = _inputs(2, t, 4, 1, seed=7 + t)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out, lse = tfa.flash_causal_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    # JAX gets the same bf16-rounded inputs
    rq, rk, rv = (x.to(torch.float32).numpy() for x in (tq, tk, tv))
    jout, jlse = _jax_fwd(rq, rk, rv, 4, dtype=jnp.bfloat16)
    np.testing.assert_allclose(out.to(torch.float32).numpy(), jout, atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=1e-4)


def test_valid_mask_and_fully_masked_rows():
    """The plain version keeps the JAX contract for a key-validity mask: a
    row with no live key gives out = 0 and lse = 0."""
    q, k, v = _inputs(1, 9, 2, 2, seed=3)
    valid = np.ones((1, 9), np.float32)
    valid[0, :4] = 0.0  # rows 0..3 see no live key
    out, lse = tfa.flash_causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), valid=torch.from_numpy(valid)
    )
    jout, jlse = jnn._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid), 9, float(DH ** -0.5), 9,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5)
    assert float(out[0, :4].abs().max()) == 0.0 and float(lse[0, :, :4].abs().max()) == 0.0


def test_train_attention_routes_cpu_to_plain():
    q, k, v = _inputs(1, 520, 4, 2, seed=11)
    calls = tfa.flash_causal_attention.calls
    launches = tfa.flash_attention.launches
    out = tnn.train_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert out.shape == (1, 520, 4, DH)
    assert tfa.flash_causal_attention.calls == calls + 1
    assert tfa.flash_attention.launches == launches


HD128_CASES = [  # (b, t, h, kh, a dead batch row)
    (1, 600, 12, 2, False), (2, 70, 4, 1, False),
    (2, 129, 12, 2, False), (1, 1025, 12, 2, False), (2, 129, 12, 2, True), (2, 1025, 12, 2, True),
]


@pytest.mark.parametrize("b,t,h,kh,dead_row", HD128_CASES, ids=[_fwd_id(c) for c in HD128_CASES])
def test_plain_matches_jax_flash_head_dim_128(b, t, h, kh, dead_row):
    """Head dim 128 (Qwen2.5-1.5B's 12 / 2 heads): the plain forward against
    JAX's flash_causal_attention, f32, out and lse at atol 1e-5; T = 129
    and 1,025 end in a tile of one row, and a dead batch row gives out = 0
    and lse = 0."""
    q, k, v = _inputs(b, t, h, kh, seed=t + 128, dh=128)
    valid = _dead_row(b, t) if dead_row else None
    out, lse = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   valid=None if valid is None else torch.from_numpy(valid))
    jout, jlse = _jax_fwd(q, k, v, h // kh, valid=valid)
    assert out.shape == (b, t, h, 128)
    np.testing.assert_allclose(out.numpy(), jout, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=1e-5)
    if dead_row:
        assert float(out[-1].abs().max()) == 0.0 and float(lse[-1].abs().max()) == 0.0
    jflash = np.asarray(
        jnn.flash_causal_attention(
            jnp.asarray(q), jnn.repeat_kv(jnp.asarray(k), h // kh), jnn.repeat_kv(jnp.asarray(v), h // kh),
            valid=None if valid is None else jnp.asarray(valid),
        )
    )
    np.testing.assert_allclose(out.numpy(), jflash, atol=1e-5)
