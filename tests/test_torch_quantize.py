"""Kernel B1 (nearest codebook entry): the port's plain version against the
JAX Pallas kernel (interpret mode) and its XLA reference -- codes exact,
planted ties included. The CUDA kernel's own test is in
test_torch_cuda_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.ops import quantize as jq
from realtime_codec_agent_tpu_torch.ops import quantize as tq


def _case(seed=0, n=100, v=1024, d=16):
    rng = np.random.default_rng(seed)
    cb = rng.normal(size=(v, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    # planted exact ties: duplicated codebook rows, queried exactly
    for lo, hi in ((3, 700), (200, 201), (511, 1023)):
        cb[hi] = cb[lo]
    x[0], x[1], x[2] = cb[3], cb[200], cb[511]
    return x, cb


def test_prepare_codebook_halfnorm_matches_jax():
    _, cb = _case()
    _, jhn = jq.prepare_codebook(jnp.asarray(cb), block_v=256)
    tcb, thn = tq.prepare_codebook(torch.from_numpy(cb))
    # the 16-term sum may be ordered differently: a few ulps
    np.testing.assert_allclose(thn.numpy(), np.asarray(jhn)[0, : cb.shape[0]], rtol=1e-6)
    np.testing.assert_array_equal(tcb.numpy(), cb)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_interpret_and_xla(seed):
    x, cb = _case(seed)
    want_pallas = np.asarray(jq.nearest_code_pallas(jnp.asarray(x), jnp.asarray(cb), block_v=256, interpret=True))
    want_xla = np.asarray(jq.nearest_code_xla(jnp.asarray(x), jnp.asarray(cb)))
    tcb, thn = tq.prepare_codebook(torch.from_numpy(cb))
    calls = tq.nearest_code_plain.calls
    got = tq.nearest_code_prepared(torch.from_numpy(x), tcb, thn).numpy()
    assert tq.nearest_code_plain.calls == calls + 1  # a CPU tensor takes the plain version
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, want_xla)
    # ties resolve to the lowest index
    assert list(got[:3]) == [3, 200, 511]
