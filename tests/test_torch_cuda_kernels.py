"""The port's CUDA kernels (B1, B2, B3) against their plain PyTorch versions.

These need the card: every test skips without a CUDA device (the skipif
condition is a string, so pytest evaluates it when a test runs, not when the
module is imported). The file imports neither JAX nor the JAX package, so on
a machine with a card and no JAX it runs with
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu_torch.ops import decode_attention as tda
from realtime_codec_agent_tpu_torch.ops import int8_matmul as t8
from realtime_codec_agent_tpu_torch.ops import quantize as tq


pytestmark = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: the kernels are compiled and run only on the card",
)


@pytest.fixture
def cuda_device():
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 matmuls stay f32
    return torch.device("cuda")


def _logz(m, l):
    return m[..., 0] + torch.log(torch.clamp(l[..., 0], min=1e-30))


@pytest.mark.parametrize("n,v", [(100, 4096), (3, 131072)])
def test_nearest_code_kernel_matches_plain(cuda_device, n, v):
    rng = np.random.default_rng(n)
    cb = rng.normal(size=(v, 16)).astype(np.float32)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    cb[v - 1] = cb[7]  # exact tie: the lower index must win
    x[0] = cb[7]
    tcb, thn = tq.prepare_codebook(torch.from_numpy(cb).to(cuda_device))
    xd = torch.from_numpy(x).to(cuda_device)
    launches = tq.nearest_code_prepared.launches
    got = tq.nearest_code_prepared(xd, tcb, thn)
    torch.cuda.synchronize()
    assert tq.nearest_code_prepared.launches == launches + 1
    want = tq.nearest_code_plain(xd, tcb, thn)
    assert int(got[0]) == 7
    # row 0's tie is exact only inside the kernel (cuBLAS may round the two
    # equal columns' scores differently); the other rows must agree
    np.testing.assert_array_equal(got[1:].cpu().numpy(), want[1:].cpu().numpy())


@pytest.mark.parametrize("t,k,n", [(1, 2048, 2048), (3, 8192, 2048), (8, 2048, 3072), (2, 2048, 16384)])
def test_int8_matmul_kernel_matches_plain(cuda_device, t, k, n):
    rng = np.random.default_rng(t * k + n)
    x = torch.from_numpy(rng.normal(size=(t, k)).astype(np.float32)).to(cuda_device)
    wq = torch.from_numpy(rng.integers(-127, 128, size=(k, n)).astype(np.int8)).to(cuda_device)
    s = torch.from_numpy(((rng.random(n) + 0.5) / 127.0).astype(np.float32)).to(cuda_device)
    launches = t8.int8_matmul.launches
    got = t8.int8_matmul(x, wq, s)
    torch.cuda.synchronize()
    assert t8.int8_matmul.launches == launches + 1
    want = t8.int8_matmul_plain(x, wq, s)
    # same exact products, f32 sums in another order
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= 1e-5, err


@pytest.mark.parametrize("gt,n_valid", [(4, 0), (12, 1), (12, 2047), (32, 2560), (4, 2500)])
def test_decode_attention_kernel_matches_plain(cuda_device, gt, n_valid):
    """Ragged cache length (2560 keys = 40 chunks of 64), bf16 cache."""
    kh, dh, s = 8, 64, 2560
    rng = np.random.default_rng(gt + n_valid)
    qg = torch.from_numpy(rng.normal(size=(kh, gt, dh)).astype(np.float32)).to(cuda_device)
    k = torch.from_numpy(rng.normal(size=(s, kh, dh)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    v = torch.from_numpy(rng.normal(size=(s, kh, dh)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    cv = torch.tensor([n_valid], dtype=torch.int32, device=cuda_device)
    launches = tda.decode_attention_partials.launches
    m, l, acc = tda.decode_attention_partials(qg, k, v, cv, dh ** -0.5)
    torch.cuda.synchronize()
    assert tda.decode_attention_partials.launches == launches + 1
    pm, pl, pacc = tda.decode_attention_partials_plain(qg, k, v, cv, dh ** -0.5)
    if n_valid == 0:
        assert float(l.max()) == 0.0 and torch.isfinite(m).all() and torch.isfinite(acc).all()
        return
    torch.testing.assert_close(acc / l.clamp_min(1e-30), pacc / pl.clamp_min(1e-30), atol=2e-3, rtol=0)
    torch.testing.assert_close(_logz(m, l), _logz(pm, pl), atol=1e-3, rtol=0)
