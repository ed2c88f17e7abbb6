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


LAYER_SHAPES = {"wqkv": (2048, 3072), "wo": (2048, 2048), "gate|up": (2048, 16384), "down": (8192, 2048),
                "qwen-wqkv": (1536, 2048), "qwen-wo": (1536, 1536), "qwen-gate|up": (1536, 17920),
                "qwen-down": (8960, 1536)}


@pytest.mark.parametrize(
    "t,k,n", [(3, k, n) for k, n in LAYER_SHAPES.values()] + [(1, 2048, 259344), (3, 2048, 259344),
                                                             (1, 1536, 283024)],
    ids=[*LAYER_SHAPES, "lm_head-T1", "lm_head-T3", "qwen-lm_head-T1"],
)
def test_plan_whole_steps_one_cluster(t, k, n):
    """B2's plan: every K split holds whole 16-row steps and none is empty;
    the splits of a column tile are one cluster of at most the portable
    size, so no shape needs a workspace; a block's k-warps share its steps,
    each at least one, in at most MAX_KWARPS warps of one tile; the grid is
    at most one wave of warps, no warp sums more than MAX_RUN steps in one
    accumulator; the layer shapes keep at least 96 blocks (3/4 of the SMs)
    busy; the lm_head's thousands of column tiles need no split (Qwen's
    2,212 tiles of 128 columns are more than one wave: 4 k-warps each)."""
    p = t8.plan(t, k, n)
    steps = -(-k // t8.STEP)
    assert p.tile in (32, 64, 128) and p.blocks == -(-n // p.tile) * p.splits
    assert 1 <= p.splits <= t8.MAX_CLUSTER
    assert p.steps_per_split * (p.splits - 1) < steps <= p.steps_per_split * p.splits
    assert 1 <= p.kwarps <= min(p.steps_per_split, t8.MAX_KWARPS)
    assert -(-p.steps_per_split // p.kwarps) <= t8.MAX_RUN
    if -(-n // p.tile) > t8._WAVE_WARPS:
        assert (p.splits, p.kwarps) == (1, t8._TAIL_KWARPS), p
    else:
        assert p.blocks * p.kwarps <= t8._WAVE_WARPS, p
    if (k, n) in LAYER_SHAPES.values():
        assert p.blocks >= 96, p
    else:
        assert p.splits == 1 and -(-n // p.tile) >= 2000, p


@pytest.mark.parametrize("t,k,n", [(3, 1000, 1321), (1, 40, 24), (8, 16, 2048), (2, 7, 5), (1, 8192, 259344),
                                   (3, 65536, 16)])
def test_plan_any_shape(t, k, n):
    """Any K (a partial last step) and any N: whole steps, no empty split;
    N not a multiple of 16 (the byte path) takes 32-column tiles; a long K
    is split until no warp sums more than MAX_RUN steps, or as far as 8
    k-warps x 8 splits go."""
    p = t8.plan(t, k, n)
    steps = -(-k // t8.STEP)
    assert p.steps_per_split * (p.splits - 1) < steps <= p.steps_per_split * p.splits
    assert 1 <= p.kwarps <= p.steps_per_split
    assert n % 16 == 0 or p.tile == 32
    run = -(-p.steps_per_split // p.kwarps)
    assert run <= t8.MAX_RUN or (p.splits, p.kwarps) == (t8.MAX_CLUSTER, t8.MAX_KWARPS)


def test_padded_rows():
    """The rows the kernel reads: bf16, padded with zeros to a multiple of
    16 (the kernel's step), values kept."""
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 40)).astype(np.float32))
    xb = t8.padded_rows(x)
    assert xb.dtype == torch.bfloat16 and xb.shape == (3, 48) and xb.is_contiguous()
    assert torch.equal(xb[:, :40], x.to(torch.bfloat16)) and not xb[:, 40:].any()
    assert t8.padded_rows(x[:, :32]).shape == (3, 32)
