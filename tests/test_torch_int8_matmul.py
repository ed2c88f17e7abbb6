"""Kernel B2 (weight-only int8 matmul): the port's plain version against the
JAX Pallas kernel (interpret mode), int8 quantization exact against the JAX
package, and qdot's routing. The CUDA kernel's own test is in
test_torch_cuda_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.models import llama as jllama
from realtime_codec_agent_tpu.ops import nn as jnn
from realtime_codec_agent_tpu.ops.int8_matmul import int8_matmul as j_int8_matmul
from realtime_codec_agent_tpu_torch.models import llama as tllama
from realtime_codec_agent_tpu_torch.models.from_jax import lm_params_from_numpy
from realtime_codec_agent_tpu_torch.ops import int8_matmul as t8
from realtime_codec_agent_tpu_torch.ops import nn as tnn


def _case(t, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, k)).astype(np.float32)
    wq = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    s = (rng.random(n).astype(np.float32) + 0.5) / 127.0
    return x, wq, s


@pytest.mark.parametrize("t,k,n", [(1, 256, 384), (3, 512, 256), (8, 128, 640)])
def test_plain_matches_pallas_interpret(t, k, n):
    x, wq, s = _case(t, k, n)
    want = np.asarray(j_int8_matmul(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s), interpret=True))
    got = t8.int8_matmul(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_int8_exact(dtype):
    """q and s bit-exact against jax.jit(quantize_params_int8), the form the
    JAX agent resources run."""
    cfg = jllama.tiny_lm_config(vocab_size=1320, compute_dtype=dtype)
    params = jllama.init_lm_params(jax.random.PRNGKey(3), cfg)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(jllama.quantize_params_int8)(params))
    got = tllama.quantize_params_int8(lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        for li in range(cfg.num_layers):
            np.testing.assert_array_equal(got["layers"][li][name]["q"].numpy(), want["layers"][li][name]["q"])
            np.testing.assert_array_equal(got["layers"][li][name]["s"].numpy(), want["layers"][li][name]["s"])
    np.testing.assert_array_equal(got["lm_head"]["q"].numpy(), want["lm_head"]["q"])
    np.testing.assert_array_equal(got["lm_head"]["s"].numpy(), want["lm_head"]["s"])


def test_qdot_routing():
    """<= 8 rows take B2 (its plain version on the CPU); wider calls take
    the dequantize + matmul route, which equals the JAX XLA route."""
    x, wq, s = _case(12, 128, 256, seed=4)
    w = {"q": torch.from_numpy(wq), "s": torch.from_numpy(s)}
    calls = t8.int8_matmul_plain.calls
    tnn.qdot(torch.from_numpy(x[:8]), w)
    assert t8.int8_matmul_plain.calls == calls + 1
    wide = tnn.qdot(torch.from_numpy(x), w).numpy()
    assert t8.int8_matmul_plain.calls == calls + 1
    want = np.asarray(jnn.qdot(jnp.asarray(x), {"q": jnp.asarray(wq), "s": jnp.asarray(s)}))
    np.testing.assert_allclose(wide, want, rtol=1e-5, atol=1e-5)


def test_k_splits_fill_the_card():
    # the decode shapes whose column tiles alone are few get split over K
    assert t8.k_splits(3, 2048, 2048) > 1
    assert t8.k_splits(3, 8192, 2048) > 1
    assert t8.k_splits(1, 2048, 259584) == 1
