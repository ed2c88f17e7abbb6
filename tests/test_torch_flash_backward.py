"""Kernel B4's backward and validity mask, plain versions: the port's
``flash_causal_attention_bwd`` and the differentiable ``flash_attention``
(its autograd Function) against ``jax.vjp`` of the JAX package's
``flash_causal_attention`` (its custom VJP ``_flash_bwd``, the XLA path the
JAX package takes on the CPU).

Inputs are seeded numpy; JAX gets K/V head-repeated through ``repeat_kv``
inside the differentiated function, so its dK/dV come back summed over the
repeated heads, as the port's. Tolerances, as max |port - JAX| / max |JAX|:
f32 <= 1e-5 (the same algorithm, sums in another order), at head_dim 16 and
at 128 (the kernels' head dims are 64 and 128); bf16 inputs <= 2e-2
(both sides round the forward's P and output to bf16 at the same places and
cast the f32 gradients to bf16, a one-ulp difference is 2^-8 relative); plus
an absolute 1e-6 for gradients that are 0 exactly (T = 1: dS = P (dP -
delta) with dP = delta, both sides hold ~1e-7 of f32 cancellation).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.ops import nn as jnn
from realtime_codec_agent_tpu_torch.ops import flash_attention as tfa

DH = 16


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The suite runs several workers on one machine: one torch thread each
    keeps these many small CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, t, h, kh, seed, masked, dh=DH):
    """``masked``: right padding, and row 0's first keys dead (rows with no
    live key); "dead_row" also kills every key of the last batch row."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(b, t, n, dh)).astype(np.float32) for n in (h, kh, kh, h))
    valid = None
    if masked:
        valid = np.ones((b, t), np.float32)
        valid[-1, (3 * t) // 4 :] = 0.0
        valid[0, : min(5, t)] = 0.0
        if masked == "dead_row":
            valid[-1] = 0.0
    return q, k, v, do, valid


def _jax_vjp(q, k, v, do, valid, n_rep, dtype):
    def f(q, k, v):
        return jnn.flash_causal_attention(
            q, jnn.repeat_kv(k, n_rep), jnn.repeat_kv(v, n_rep),
            valid=None if valid is None else jnp.asarray(valid),
        )

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(do, dtype))
    return np.asarray(out.astype(jnp.float32)), [np.asarray(g.astype(jnp.float32)) for g in grads]


def _err(a, b):
    """max |a - b| beyond the absolute 1e-6, relative to max |b|."""
    return float(max(np.abs(a - b).max() - 1e-6, 0.0) / max(float(np.abs(b).max()), 1e-30))


CASES = [  # (t, h, kh, masked, dtype, head_dim)
    (1, 4, 1, False, "float32", DH), (1, 4, 4, True, "float32", DH),
    (65, 4, 1, True, "float32", DH), (65, 4, 4, False, "float32", DH),
    (1000, 4, 1, False, "float32", DH), (1000, 4, 4, True, "float32", DH),
    (1100, 4, 1, True, "float32", DH), (1100, 4, 4, False, "float32", DH),
    (65, 4, 1, False, "bfloat16", DH), (1100, 4, 1, True, "bfloat16", DH), (1000, 4, 4, True, "bfloat16", DH),
    # head_dim 128, Qwen2.5-1.5B's GQA 12 / 2 among them
    (65, 12, 2, True, "float32", 128), (1100, 12, 2, True, "float32", 128), (1000, 4, 4, False, "float32", 128),
    (65, 4, 1, False, "bfloat16", 128), (1100, 12, 2, True, "bfloat16", 128),
    # the f32 kernels' tiles at Qwen2.5-1.5B's 12 / 2 heads: a last tile of one row (129, 1,025), and a
    # batch row whose keys are all dead
    (129, 12, 2, True, "float32", 128), (1025, 12, 2, False, "float32", 128),
    (129, 12, 2, "dead_row", "float32", 128), (1025, 12, 2, "dead_row", "float32", 128),
]


def _case_id(case):
    """The head_dim-16 cases keep their ids of before head_dim was a parameter."""
    *rest, dh = case
    return "-".join(map(str, rest if dh == DH else case))


@pytest.mark.parametrize("t,h,kh,masked,dtype,dh", CASES, ids=[_case_id(c) for c in CASES])
def test_plain_backward_matches_jax_vjp(t, h, kh, masked, dtype, dh):
    """1,100 keys cross the plain versions' 1,024-key block."""
    q, k, v, do, valid = _inputs(2, t, h, kh, seed=t + kh, masked=masked, dh=dh)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    tvalid = None if valid is None else torch.from_numpy(valid)
    # JAX gets the same (rounded) inputs
    rq, rk, rv, rdo = (x.to(torch.float32).numpy() for x in (tq, tk, tv, tdo))
    jout, jgrads = _jax_vjp(rq, rk, rv, rdo, valid, h // kh, getattr(jnp, dtype))

    out, lse = tfa.flash_causal_attention(tq, tk, tv, valid=tvalid)
    calls = tfa.flash_causal_attention_bwd.calls
    grads = tfa.flash_causal_attention_bwd(tq, tk, tv, out, lse, tdo, valid=tvalid)
    assert tfa.flash_causal_attention_bwd.calls == calls + 1
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert _err(out.to(torch.float32).numpy(), jout) <= tol
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        assert g.dtype == tdt and g.shape == jg.shape, name
        assert _err(g.to(torch.float32).numpy(), jg) <= tol, (name, _err(g.to(torch.float32).numpy(), jg))
    if masked:  # rows with no live key get no gradient
        assert float(grads[0][0, : min(5, t)].abs().max()) == 0.0
    if masked == "dead_row":  # nor does a batch row with no live key at all: out, dq, dk, dv all 0
        assert float(out[-1].abs().max()) == 0.0 and float(lse[-1].abs().max()) == 0.0
        assert all(float(g[-1].abs().max()) == 0.0 for g in grads)


@pytest.mark.parametrize("masked", [False, True])
def test_function_gradcheck_float64(masked):
    """torch.autograd.gradcheck of the autograd Function (plain versions on
    the CPU), float64, GQA 2:1, fully masked rows when masked."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 7, n, 4))).requires_grad_() for n in (4, 2, 2))
    valid = None
    if masked:
        valid = torch.ones((1, 7), dtype=torch.float64)
        valid[0, :2] = 0.0
        valid[0, 5] = 0.0
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.flash_attention(q, k, v, valid=valid)[0], (q, k, v), eps=1e-6, atol=1e-6
    )


@pytest.mark.parametrize("masked", [False, True])
def test_function_gradcheck_float64_head_dim_128(masked):
    """The same gradcheck at head_dim 128 (the kernels' second head dim),
    GQA 3:1, T = 6 with fully masked rows when masked."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 6, n, 128))).requires_grad_() for n in (3, 1, 1))
    valid = None
    if masked:
        valid = torch.ones((1, 6), dtype=torch.float64)
        valid[0, 0] = 0.0
        valid[0, 4] = 0.0
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.flash_attention(q, k, v, valid=valid)[0], (q, k, v), eps=1e-6, atol=1e-6
    )


def test_function_backward_is_the_plain_backward_on_cpu():
    """On CPU tensors the Function runs the plain forward once and the plain
    backward once (no kernel launch), and lse carries no gradient."""
    q, k, v, do, valid = _inputs(2, 600, 4, 2, seed=1, masked=True)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    counts = (tfa.flash_causal_attention.calls, tfa.flash_causal_attention_bwd.calls, tfa.flash_attention.launches)
    out, lse = tfa.flash_attention(tq, tk, tv, valid=torch.from_numpy(valid))
    assert not lse.requires_grad
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert (tfa.flash_causal_attention.calls, tfa.flash_causal_attention_bwd.calls, tfa.flash_attention.launches) == (
        counts[0] + 1, counts[1] + 1, counts[2]
    )
    want = tfa.flash_causal_attention_bwd(
        tq.detach(), tk.detach(), tv.detach(), out.detach(), lse, torch.from_numpy(do), valid=torch.from_numpy(valid)
    )
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
