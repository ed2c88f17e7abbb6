"""Kernel B5 (affine int4 weight matmul): the port's plain version against
the JAX Pallas kernel (interpret mode), dequantization, quantization and the
fused layout bit for bit against ``jax.jit`` of the JAX functions, and
qdot's routing. The CUDA kernel's own test is in test_torch_cuda_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.models import llama as jllama
from realtime_codec_agent_tpu.ops import nn as jnn
from realtime_codec_agent_tpu.ops.int4_matmul import dequant_int4 as j_dequant_int4
from realtime_codec_agent_tpu.ops.int4_matmul import int4_matmul as j_int4_matmul
from realtime_codec_agent_tpu_torch.models import llama as tllama
from realtime_codec_agent_tpu_torch.models.from_jax import lm_params_from_numpy
from realtime_codec_agent_tpu_torch.ops import int4_matmul as t4
from realtime_codec_agent_tpu_torch.ops import nn as tnn

_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _leaf(rng, k, n, group=32):
    """A random int4 leaf in the packed layout (the JAX test's _rand_leaf)."""
    kg, gh = k // group, group // 2
    q = rng.integers(0, 16, size=(k, n)).astype(np.uint8)
    d = rng.uniform(0.005, 0.02, size=(kg, n)).astype(np.float32)
    m = rng.uniform(-0.1, 0.1, size=(kg, n)).astype(np.float32)
    q3 = q.reshape(kg, group, n)
    return {"q4": (q3[:, :gh, :] | (q3[:, gh:, :] << 4)).reshape(k // 2, n), "d": d, "m": m}


def _torch_leaf(leaf):
    return {k: torch.from_numpy(np.array(v)) for k, v in leaf.items()}


@pytest.mark.parametrize(
    "lead,k,n",
    [((2,), 256, 384), ((3,), 128, 128), ((16,), 256, 256), ((33,), 384, 260), ((1, 3), 128, 256)],
)
def test_plain_matches_pallas_interpret(lead, k, n):
    """The JAX test's four shapes and its 3-D lead, at its limits (rtol
    1e-2, atol 5e-4)."""
    rng = np.random.default_rng(0)
    leaf = _leaf(rng, k, n)
    x = rng.normal(size=(*lead, k)).astype(np.float32)
    want = np.asarray(j_int4_matmul(jnp.asarray(x), *(jnp.asarray(leaf[key]) for key in ("q4", "d", "m")),
                                    interpret=True))
    tl = _torch_leaf(leaf)
    got = t4.int4_matmul(torch.from_numpy(x), tl["q4"], tl["d"], tl["m"]).numpy()
    assert got.shape == (*lead, n)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=5e-4)


@pytest.mark.parametrize("k,n", [(512, 384), (128, 260), (8192, 48)])
def test_dequant_int4_matches_jit(k, n):
    """Bit for bit against jax.jit(dequant_int4), which the CPU compiles to
    one fused multiply-add per weight."""
    leaf = _leaf(np.random.default_rng(k + n), k, n)
    want = np.asarray(jax.jit(j_dequant_int4)(*(jnp.asarray(leaf[key]) for key in ("q4", "d", "m"))))
    tl = _torch_leaf(leaf)
    got = t4.dequant_int4(tl["q4"], tl["d"], tl["m"]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,n", [(512, 384), (8192, 48)])
def test_dequant_int4_bf16_matches_jit(k, n):
    """The wide route's weights: on the CPU the plain version (counted),
    jax.jit(dequant_int4) rounded to bf16 bit for bit."""
    leaf = _leaf(np.random.default_rng(k * n), k, n)
    want = jax.jit(j_dequant_int4)(*(jnp.asarray(leaf[key]) for key in ("q4", "d", "m"))).astype(jnp.bfloat16)
    tl = _torch_leaf(leaf)
    calls = t4.dequant_int4_bf16_plain.calls
    got = t4.dequant_int4_bf16(tl["q4"], tl["d"], tl["m"])
    assert t4.dequant_int4_bf16_plain.calls == calls + 1
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))


def _tiny(dtype):
    cfg = jllama.tiny_lm_config(vocab_size=1320, compute_dtype=dtype)
    params = jllama.init_lm_params(jax.random.PRNGKey(5), cfg)
    return cfg, params, lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params))


def _assert_leaves_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_int4_exact(dtype):
    """q4, d, m and the int8 lm_head bit for bit against
    jax.jit(quantize_params_int4), the form the JAX resources run."""
    cfg, jparams, tparams = _tiny(dtype)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(jllama.quantize_params_int4)(jparams))
    got = tllama.quantize_params_int4(tparams)
    for li in range(cfg.num_layers):
        for name in _NAMES:
            assert got["layers"][li][name]["q4"].dtype == torch.uint8
            _assert_leaves_equal(got["layers"][li][name], want["layers"][li][name])
        np.testing.assert_array_equal(got["layers"][li]["attn_norm"].float().numpy(),
                                      np.asarray(want["layers"][li]["attn_norm"], np.float32))
    _assert_leaves_equal(got["lm_head"], want["lm_head"])
    # already-quantized leaves pass through untouched
    again = tllama.quantize_params_int4(got)
    assert again["layers"][0]["wq"] is got["layers"][0]["wq"] and again["lm_head"] is got["lm_head"]


def test_fused_int4_layout_matches_jax():
    """Quantize then fuse (the resources' order) equals jax.jit of the same,
    and equals fuse then quantize (the groups run along K, the fusion along
    N)."""
    cfg, jparams, tparams = _tiny("bfloat16")
    want = jax.tree_util.tree_map(
        np.asarray, jax.jit(jllama.fuse_lm_params_for_decode)(jax.jit(jllama.quantize_params_int4)(jparams))
    )
    got = tllama.fuse_lm_params_for_decode(tllama.quantize_params_int4(tparams))
    other = tllama.quantize_params_int4(tllama.fuse_lm_params_for_decode(tparams))
    for li in range(cfg.num_layers):
        for name in ("wqkv", "wo", "w_gu", "w_down"):
            _assert_leaves_equal(got["layers"][li][name], want["layers"][li][name])
            for key in ("q4", "d", "m"):
                assert torch.equal(got["layers"][li][name][key], other["layers"][li][name][key]), (name, key)
    assert got["layers"][0]["wqkv"]["q4"].shape == (cfg.hidden_size // 2, cfg.q_dim + 2 * cfg.kv_dim)


@pytest.mark.parametrize("rows", [3, 8, 12])
def test_qdot_int4_routing(rows):
    """<= 8 rows take B5 (its plain version on the CPU, counted); wider
    calls the dequantize + matmul route. Both against jax.jit of JAX's qdot
    (jitted, its dequantization is one fused multiply-add, as the port's) at
    bf16 compute, where the two routes see the same activations: the
    products are exact, only the f32 sums' order differs."""
    rng = np.random.default_rng(rows)
    leaf = _leaf(rng, 256, 192)
    x = rng.normal(size=(rows, 256)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    calls, wide = t4.int4_matmul_plain.calls, t4.dequant_int4_bf16_plain.calls
    got = tnn.qdot(xb, _torch_leaf(leaf)).numpy()
    assert t4.int4_matmul_plain.calls == calls + (1 if rows <= 8 else 0)
    assert t4.dequant_int4_bf16_plain.calls == wide + (0 if rows <= 8 else 1)
    want = np.asarray(jax.jit(jnn.qdot)(jnp.asarray(x, jnp.bfloat16), {k: jnp.asarray(v) for k, v in leaf.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


LAYER_SHAPES = ((2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048))  # wqkv, wo, gate|up, down


@pytest.mark.parametrize("k,n", [*LAYER_SHAPES, (256, 512), (32, 16), (8192, 1040), (2048, 1321)])
@pytest.mark.parametrize("t", [1, 3, 8])
def test_plan_whole_groups_one_cluster(t, k, n):
    """B5's plan: every K split holds whole groups and none is empty; the
    splits of a column tile are one cluster, which divides the grid's split
    dimension and is at most the portable cluster size, so no shape needs
    a workspace; a block's k-warps share its groups, each at least one, in
    at most 16 warps; all warps fit one wave; the four layer shapes keep at
    least 96 blocks (3/4 of the SMs) busy."""
    p = t4.plan(t, k, n)
    groups = k // t4.GROUP
    assert p.tile in (32, 64, 128) and p.blocks == -(-n // p.tile) * p.splits
    assert 1 <= p.splits <= t4.MAX_CLUSTER and p.splits <= groups
    assert p.groups_per_split * (p.splits - 1) < groups <= p.groups_per_split * p.splits
    assert 1 <= p.kwarps <= p.groups_per_split and p.kwarps * p.tile // 32 <= 16
    assert p.kwarps == 1 or p.blocks * p.kwarps * p.tile // 32 <= 2048
    if (k, n) in LAYER_SHAPES:
        assert p.blocks >= 96, p


def test_int4_matmul_rejects_other_devices():
    leaf = _torch_leaf(_leaf(np.random.default_rng(1), 64, 32))
    with pytest.raises(ValueError, match="unsupported device"):
        t4.int4_matmul(torch.zeros((1, 64), device="meta"), leaf["q4"], leaf["d"], leaf["m"])
    with pytest.raises(ValueError, match="unsupported device"):
        t4.dequant_int4_bf16(*(leaf[key].to("meta") for key in ("q4", "d", "m")))
