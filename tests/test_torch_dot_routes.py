"""``ops/nn.dot_f32`` and ``qdot``'s wide routes.

On the CPU (every operand pair): the f32 route, bit for bit
``torch.matmul(x.float(), w.float())``. On the card: two bf16 operands that
need a gradient take the tensor-core route, held at the training cell's
shapes to the exact product (float64) by multiples of the bf16 rounding
error; products that need no gradient, f32, mixed and quantized operands
keep the f32 route bit for bit; a checkpointed step gives the
gradients of the plain one. The card's tests skip without a CUDA device (the
skipif condition is a string, evaluated when a test runs). The file imports
neither JAX nor the JAX package, so on a machine with a card and no JAX it
runs with ``python -m pytest --noconftest tests/test_torch_dot_routes.py``.
"""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from realtime_codec_agent_tpu_torch.models import llama as tl
from realtime_codec_agent_tpu_torch.ops import int4_matmul as t4
from realtime_codec_agent_tpu_torch.ops import nn as tnn
from realtime_codec_agent_tpu_torch.tools.gemm_route_times import SHAPES, operands
from realtime_codec_agent_tpu_torch.utils import spans
from realtime_codec_agent_tpu_torch.utils.tree import tree_leaves

needs_card = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: the tensor-core route runs only on the card",
)
BF16, F32 = torch.bfloat16, torch.float32
# the tensor-core route's limits, in units of the bf16 rounding error of the exact result
# (|bf16(ref) - ref| over |ref|, Frobenius): the forward's sums and output are f32, so it reads
# a small fraction of one rounding (a bf16 output or bf16 sums read 1 or more); a gradient has
# two roundings of that size, the incoming gradient's to bf16 and its own output's, so about
# sqrt(2) (a third, or an operand below bf16, reads more)
FORWARD_ROUNDINGS = 0.05
GRAD_ROUNDINGS = 1.6


def _leaf(kind: str, w: torch.Tensor):
    if kind == "int8":
        return tl._quant8_leaf(w)
    if kind == "int4":
        return tl._quant4_leaf(w, 32)
    return w


def _dense(kind: str, leaf) -> torch.Tensor:
    """The weight the wide route multiplies by, widened to f32 ahead of the
    scales (int8: the scales after the product, as qdot applies them)."""
    if kind == "int8":
        return leaf["q"].float()
    if kind == "int4":
        return t4.dequant_int4_bf16(leaf["q4"], leaf["d"], leaf["m"]).float()
    return leaf.float()


@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
@pytest.mark.parametrize("x_dtype,w_dtype", [(BF16, BF16), (F32, F32), (BF16, F32), (F32, BF16)])
def test_cpu_routes_are_the_f32_matmul_bit_for_bit(kind, x_dtype, w_dtype):
    """On the CPU ``dot_f32`` and ``qdot``'s wide routes (12 rows, past B2 and
    B5) are ``torch.matmul`` of the operands widened to f32, bit for bit, for
    bf16, f32 and mixed operands."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(3, 4, 64, generator=gen).to(x_dtype)
    w = torch.randn(64, 48, generator=gen).to(w_dtype)
    if kind == "dense":
        assert torch.equal(tnn.dot_f32(x, w), torch.matmul(x.float(), w.float()))
    leaf = _leaf(kind, w)
    want = torch.matmul(x.float(), _dense(kind, leaf))
    if kind == "int8":
        want = want * leaf["s"]
    got = tnn.qdot(x, leaf)
    assert got.dtype == F32 and torch.equal(got, want)
    assert torch.equal(tnn.qdot(x, leaf, out_dtype=BF16), want.to(BF16))


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref).norm() / ref.norm())


def _rounding(ref: torch.Tensor) -> float:
    """The bf16 rounding error of ``ref`` (float64), relative, Frobenius."""
    return _rel(ref.to(BF16), ref)


@pytest.fixture
def cuda_device():
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 route stays f32
    spans.reset()
    yield torch.device("cuda")
    spans.reset()


@needs_card
@pytest.mark.parametrize("name", list(SHAPES))
def test_tensor_core_route_at_the_cell_shapes(cuda_device, name):
    """bf16 operands: the output and both gradients against the exact
    product, within ``FORWARD_ROUNDINGS`` and ``GRAD_ROUNDINGS`` bf16
    roundings; the f32 route's own output within the same forward limit and
    its gradients within one rounding and a little; every FLOP counted on
    the tensor cores, none on the f32 route."""
    # the head: one 512-row block of the tied table's transposed view
    x, table, w, g = operands(name, cuda_device, torch.Generator(cuda_device).manual_seed(0),
                              rows=512 if name == "head" else None)
    with profile(activities=[ProfilerActivity.CPU]):
        y = tnn.dot_f32(x, w)
        y.backward(g)
    assert y.dtype == F32 and x.grad.dtype == BF16 and table.grad.dtype == BF16
    m, k, n = x.shape[0], x.shape[1], w.shape[1]
    assert spans.counters() == {tnn.TENSOR_CORE_FLOP: 2 * m * k * n}
    xd, wd, gd = x.detach().double(), w.detach().double(), g.double()
    ref = {"y": xd @ wd, "dx": gd @ wd.T, "dw": xd.T @ gd}
    dw = table.grad.T if name == "head" else table.grad
    got = {"y": y.detach(), "dx": x.grad, "dw": dw}
    x.grad = table.grad = None
    y32 = torch.matmul(x.float(), w.float())  # the f32 route applied to the same bf16 operands
    y32.backward(g)
    old = {"y": y32.detach(), "dx": x.grad, "dw": table.grad.T if name == "head" else table.grad}
    for key in ("y", "dx", "dw"):
        r = _rounding(ref[key])
        tc, f32 = _rel(got[key], ref[key]) / r, _rel(old[key], ref[key]) / r
        limit = FORWARD_ROUNDINGS if key == "y" else GRAD_ROUNDINGS
        print(f"{name} {key}: tensor cores {tc:.4f} roundings, f32 route {f32:.4f} (limit {limit})")
        assert tc <= limit, (name, key, tc, f32)
        assert f32 <= (FORWARD_ROUNDINGS if key == "y" else 1.1), (name, key, f32)


@needs_card
@pytest.mark.parametrize("kind,x_dtype,w_dtype", [("dense", BF16, BF16), ("dense", F32, F32), ("dense", BF16, F32),
                                                  ("dense", F32, BF16), ("int8", BF16, BF16), ("int8", F32, F32),
                                                  ("int4", BF16, BF16), ("int4", F32, F32)])
def test_inference_and_f32_operands_keep_the_f32_route(cuda_device, kind, x_dtype, w_dtype):
    """On the card, a product that needs no gradient (bf16 leaves under
    ``no_grad``; bf16 activations by int8 or int4 weights, which need none)
    or has an f32 operand: the f32 route, bit for bit ``torch.matmul`` of
    the widened operands, counted as f32 FLOP."""
    gen = torch.Generator(cuda_device).manual_seed(2)
    x = torch.randn(64, 896, generator=gen, device=cuda_device).to(x_dtype)
    leaf = _leaf(kind, torch.randn(896, 1152, generator=gen, device=cuda_device).to(w_dtype))
    bf16_leaves = kind == "dense" and x_dtype == w_dtype == BF16
    if bf16_leaves:
        x.requires_grad_(True)
        leaf.requires_grad_(True)
    with profile(activities=[ProfilerActivity.CPU]), torch.set_grad_enabled(not bf16_leaves):
        got = tnn.qdot(x, leaf)
    assert spans.counters() == {tnn.F32_FLOP: 2 * 64 * 896 * 1152}
    want = torch.matmul(x.detach().float(), _dense(kind, leaf).detach())
    if kind == "int8":
        want = want * leaf["s"]
    assert torch.equal(got, want)


@needs_card
def test_remat_step_through_checkpoint(cuda_device):
    """A tiny bf16 model with the codec branch and blockwise loss: every
    remat policy (checkpointed halves and loss blocks, the whole layer,
    saved dots) gives the gradients of the step without remat bit for bit;
    every GEMM of the step takes the tensor cores, the recompute's counted
    on autograd's thread."""
    from realtime_codec_agent_tpu_torch.train.trainer import loss_and_metrics

    cfg = tl.tiny_lm_config(vocab_size=96, codec_vocab_start=60, codebook_size=36, compute_dtype="bfloat16",
                            hidden_size=128, intermediate_size=256, head_dim=32)
    gen = torch.Generator(cuda_device).manual_seed(0)
    base = tl.init_lm_params(gen, cfg, device=cuda_device, with_codec_embed=True)
    ids = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, device=cuda_device)
    labels = ids.clone()
    labels[1, 40:] = -100
    leaves = [t.requires_grad_(True) for _, t in tree_leaves(base)]
    results = {}
    for policy in ("none", "flash", "full", "dots"):
        run_cfg = dataclasses.replace(cfg, remat=policy != "none", remat_policy=policy)
        spans.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            loss, _ = loss_and_metrics(base, ids, labels, run_cfg, loss_block=16)
            grads = torch.autograd.grad(loss, leaves)
        results[policy] = (loss.detach(), grads, spans.counters())
    loss0, grads0, counts0 = results["none"]
    assert set(counts0) == {tnn.TENSOR_CORE_FLOP}
    for policy, (loss, grads, counts) in results.items():
        assert torch.equal(loss, loss0), policy
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0)), policy
        assert set(counts) == {tnn.TENSOR_CORE_FLOP}, policy
        assert counts[tnn.TENSOR_CORE_FLOP] >= counts0[tnn.TENSOR_CORE_FLOP], policy
    assert results["flash"][2][tnn.TENSOR_CORE_FLOP] > counts0[tnn.TENSOR_CORE_FLOP]
