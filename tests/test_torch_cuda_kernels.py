"""The port's CUDA kernels (B1, B2, B3, B4 forward and backward in bf16 and
f32, B5 and its dequant, B6, S1: the whole draw, the draw over rows and its
noise-only entry) against their plain PyTorch versions.

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
from realtime_codec_agent_tpu_torch.ops import flash_attention as tfa
from realtime_codec_agent_tpu_torch.ops import hbm_stream as ths
from realtime_codec_agent_tpu_torch.ops import int4_matmul as t4
from realtime_codec_agent_tpu_torch.ops import int8_matmul as t8
from realtime_codec_agent_tpu_torch.ops import quantize as tq
from realtime_codec_agent_tpu_torch.ops import sampling as tsm
from realtime_codec_agent_tpu_torch.tools import sampler_times as st
from realtime_codec_agent_tpu_torch.tools.hbm_stream_probe import ctl_operands


pytestmark = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: the kernels are compiled and run only on the card",
)


@pytest.fixture
def cuda_device():
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 matmuls stay f32
    return torch.device("cuda")


def _device_launches(fn) -> int:
    """Device kernels and memsets one call of ``fn`` puts on the stream,
    from a torch.profiler window."""
    from torch.profiler import ProfilerActivity, profile

    count = 0
    for _ in range(5):  # a window now and then comes back with no device events at all: take the next
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        count = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        if count:
            break
    return count


@pytest.mark.parametrize("v", [1000, 131072])
@pytest.mark.parametrize("n", [1, 5, 100, 129, 4096])
def test_nearest_code_kernel_matches_plain(cuda_device, n, v):
    """B1 against the plain version: planted exact ties (duplicated codebook
    rows, queried exactly) go to the lowest index; every other code equals
    the plain version's outside near-ties (the plain matmul sums in another
    order); one launch a call, bitwise repeatable, the ticket counters left
    left at zero. N = 129 and 4,096 take 2 and 32 row tiles; V = 1,000 ends
    in a partial codebook chunk."""
    rng = np.random.default_rng(n + v)
    cb = rng.normal(size=(v, 16)).astype(np.float32)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    ties = [(7, v - 1), (300, 301), (2, 513)][: n]
    for lo, hi in ties:
        cb[hi] = cb[lo]
    for i, (lo, _) in enumerate(ties):
        x[(i * 37) % n] = cb[lo]
    tcb, thn = tq.prepare_codebook(torch.from_numpy(cb).to(cuda_device))
    xd = torch.from_numpy(x).to(cuda_device)
    launches = tq.nearest_code_prepared.launches
    got = tq.nearest_code_prepared(xd, tcb, thn)
    again = tq.nearest_code_prepared(xd, tcb, thn)
    torch.cuda.synchronize()
    assert tq.nearest_code_prepared.launches == launches + 2
    assert torch.equal(got, again)
    assert _device_launches(lambda: tq.nearest_code_prepared(xd, tcb, thn)) == 1
    assert int(tq._ticket_counters(xd.device, 1).abs().sum()) == 0  # every ticket reset for the next call
    for i, (lo, _) in enumerate(ties):
        assert int(got[(i * 37) % n]) == lo
    want = tq.nearest_code_plain(xd, tcb, thn)
    scores = xd @ tcb.T - thn
    top2 = torch.topk(scores, min(2, v), dim=-1).values
    near_tie = (top2[:, 0] - top2[:, -1]) < 1e-5 * torch.clamp(top2[:, 0].abs(), min=1.0)
    assert not bool(((got != want) & ~near_tie).any())


@pytest.mark.parametrize(
    "t,k,n",
    [(1, 2048, 2048), (3, 8192, 2048), (8, 2048, 3072), (2, 2048, 16384), (3, 2048, 1320), (1, 2048, 1321),
     (8, 2048, 16384), (1, 2048, 259344), (3, 1000, 528), (2, 40, 1321)],
)
def test_int8_matmul_kernel_matches_plain(cuda_device, t, k, n):
    """The fused layer shapes (gate|up also at T = 8), the lm_head at T = 1,
    two N that are not multiples of 16 (the tiny vocab 1,320 and an odd N:
    the byte path) and two K that are not multiples of 16 (a partial last
    step). One call is one launch (no second, split-sum kernel); two
    launches are bitwise equal."""
    rng = np.random.default_rng(t * k + n)
    x = torch.from_numpy(rng.normal(size=(t, k)).astype(np.float32)).to(cuda_device)
    wq = torch.from_numpy(rng.integers(-127, 128, size=(k, n)).astype(np.int8)).to(cuda_device)
    s = torch.from_numpy(((rng.random(n) + 0.5) / 127.0).astype(np.float32)).to(cuda_device)
    launches = t8.int8_matmul.launches
    got = t8.int8_matmul(x, wq, s)
    assert t8.int8_matmul.launches == launches + 1
    again = t8.int8_matmul(x, wq, s)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = t8.int8_matmul_plain(x, wq, s)
    # same exact products, f32 sums in another order
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= 1e-5, err


@pytest.mark.parametrize("k,n", [(2048, 2048), (8192, 2048), (1000, 1321)])
def test_int8_matmul_every_plan_matches_plain(cuda_device, k, n):
    """Every launch plan the sweep tries (tile, K splits in a cluster,
    k-warps) at T = 3 and 8: within 1e-5 relative of the plain version and
    bitwise repeatable."""
    from realtime_codec_agent_tpu_torch.tools.int8_plan_sweep import candidates

    rng = np.random.default_rng(k + n)
    wq = torch.from_numpy(rng.integers(-127, 128, size=(k, n)).astype(np.int8)).to(cuda_device)
    s = torch.from_numpy(((rng.random(n) + 0.5) / 127.0).astype(np.float32)).to(cuda_device)
    for t in (3, 8):
        x = torch.from_numpy(rng.normal(size=(t, k)).astype(np.float32)).to(cuda_device)
        xb = t8.padded_rows(x)
        want = t8.int8_matmul_plain(x, wq, s)
        for p in candidates(k, n):
            got, again = (torch.empty((t, n), device=cuda_device) for _ in range(2))
            t8._launch(xb, wq, s, got, p)
            t8._launch(xb, wq, s, again, p)
            torch.cuda.synchronize()
            err = ((got - want).abs().max() / want.abs().max()).item()
            assert err <= 1e-5 and torch.equal(got, again), (t, p, err)


def test_int8_matmul_wrapper_raises(cuda_device):
    wq = torch.zeros((64, 32), dtype=torch.int8, device=cuda_device)
    s = torch.ones(32, device=cuda_device)
    with pytest.raises(ValueError, match="rows"):
        t8.int8_matmul(torch.zeros((9, 64), device=cuda_device), wq, s)
    with pytest.raises(ValueError, match="float32"):
        t8.int8_matmul(torch.zeros((2, 64), device=cuda_device), wq, s.half())
    xb = t8.padded_rows(torch.zeros((2, 64), device=cuda_device))
    # K = 64 is 4 steps: 8 splits of 1 leave four empty, 2 splits of 1 leave
    # two steps out; the kernel takes only splits = ceil(steps / per)
    for bad in (t8.Plan(32, 8, 1, 1, 8), t8.Plan(32, 2, 1, 1, 2)):
        with pytest.raises(RuntimeError, match="cudaError_t"):
            t8._launch(xb, wq, s, torch.empty((2, 32), device=cuda_device), bad)


_B3_GT = {4: (4, 1), 12: (4, 3), 18: (6, 3), 32: (4, 8), 48: (6, 8), 56: (7, 8), 64: (8, 8)}  # G*T -> (G, T)


def _b3_inputs(dev, gt, cvs, dh, dtype, w=65, kh=8, s=2560, seed=0):
    """B = len(cvs) batch rows with their own cache_valid, a bf16 or f32
    cache of S keys, and a window of W keys: W - T extra keys (every 5th
    rejected) and the T query tokens; positions broadcast over the batch."""
    g, t = _B3_GT[gt]
    b = len(cvs)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    q, k_big, v_big, k_new, v_new = (
        torch.randn(shape, generator=gen, device=dev).to(dt)
        for shape in ((b, t, kh * g, dh), (b, s, kh, dh), (b, s, kh, dh), (b, w, kh, dh), (b, w, kh, dh))
    )
    extra = s + torch.arange(w - t, device=dev)
    extra[::5] = 2**30  # REJECTED_POS
    q_pos = (s + w - t + torch.arange(t, device=dev))[None].to(torch.int32)
    new_pos = torch.cat([extra[None].to(torch.int32), q_pos], dim=1)
    cv = torch.tensor(cvs, dtype=torch.int32, device=dev)
    return q, k_big, v_big, k_new, v_new, q_pos, new_pos, cv


def _bf16_ulps(got, want):
    """|got - want| in bf16 ulps (frexp: |x| = m 2^e, m in [0.5, 1), the
    bf16 spacing there is 2^(e - 8)), the largest over the elements: (of
    each element's own value, of the largest |want| of its output row)."""
    want = want.float()
    diff = (got.float() - want).abs()

    def ulp(x):
        _, e = torch.frexp(x)
        return torch.ldexp(torch.ones_like(x), (e - 8).clamp_min(-133))

    row = want.abs().amax(dim=-1, keepdim=True)
    return float((diff / ulp(want)).max()), float((diff / ulp(row)).max())


# B3's bf16 check: at most this share of the output elements off the plain
# version's bf16 value. Readings over chip_smoke's B3 cases on an H100
# (PERF.md): the kernel at most 0.195%; chip_smoke's b3_control, nearly
# right variants through the same check, 40-43% for the cache
# probabilities in one bf16 term (at 2,047 valid keys or more) and 2.1-39%
# for the window probabilities left unrounded. Row ulps alone read 1.00
# for both controls.
_B3_MISMATCH_LIMIT = 0.01


def _b3_agreement(got, want):
    """(bf16 ulps of each output row's largest value, share of elements off
    the plain version's bf16 value)."""
    return _bf16_ulps(got, want)[1], float((got != want).float().mean())


@pytest.mark.parametrize(
    "gt,n_valid,dh,dtype,w,kh",
    [(4, 0, 64, "bfloat16", 65, 8), (12, 1, 64, "bfloat16", 65, 8), (12, 2047, 64, "bfloat16", 65, 8),
     (32, 2560, 64, "bfloat16", 65, 8), (4, 2500, 64, "bfloat16", 65, 8), (56, 2047, 64, "bfloat16", 65, 8),
     (64, 2500, 64, "bfloat16", 65, 8), (12, 2047, 128, "bfloat16", 65, 8), (48, 2500, 128, "bfloat16", 65, 8),
     (64, 1, 128, "bfloat16", 65, 8), (64, 0, 128, "bfloat16", 65, 8),
     (12, 2047, 64, "float32", 65, 8), (4, 0, 64, "float32", 65, 8), (48, 2500, 128, "float32", 65, 8),
     (64, 1, 128, "float32", 65, 8),
     # Qwen2.5-1.5B's 2 KV heads: the frame scan (18 rows) and a bucket of 8 (48)
     (18, 2047, 128, "bfloat16", 13, 2), (48, 2500, 128, "bfloat16", 16, 2), (48, 0, 128, "float32", 16, 2),
     # windows past the 72 staged keys: a 1 s chunk's frame scan, generate_until at max_n 128
     (12, 2047, 64, "bfloat16", 103, 8), (4, 0, 64, "bfloat16", 129, 8), (18, 1000, 128, "bfloat16", 103, 2),
     (12, 2047, 64, "float32", 103, 8), (4, 700, 128, "float32", 129, 8)],
)
def test_decode_attention_kernel_matches_plain(cuda_device, gt, n_valid, dh, dtype, w, kh):
    """The small-T two-piece attention, one launch, against its plain version
    on the card: B = 2 with cache_valid (n_valid, n_valid + 513 up to S),
    a ragged cache (2560 keys), a window of W keys with rejected slots
    (13 to 129: past the 72 the kernel stages); head dims 64 and 128, 4 to
    64 rows per KV head over 8 or 2 KV heads. f32 at 2e-5. bf16: within
    one bf16 ulp of the largest |value| of each output row and at most
    _B3_MISMATCH_LIMIT of the elements off the plain version's bf16 value.
    Both versions round the window probabilities to bf16 (as the JAX path
    does), and a score that differs by 1e-7 flips one of them: near-zero
    outputs then move by up to ~130 of their own ulps on an H100, while the
    plain version itself is ~35,000 such ulps from an f32 reference there.
    Two launches are bitwise equal."""
    args = _b3_inputs(cuda_device, gt, (n_valid, min(2560, n_valid + 513)), dh, dtype, w=w, kh=kh,
                      seed=gt + n_valid + dh)
    launches = tda.decode_attention.launches
    calls = tda.decode_attention_plain.calls
    got = tda.decode_attention(*args)
    again = tda.decode_attention(*args)
    torch.cuda.synchronize()
    assert tda.decode_attention.launches == launches + 2
    assert tda.decode_attention_plain.calls == calls
    assert torch.equal(got, again)
    want = tda.decode_attention_plain(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    else:
        row, miss = _b3_agreement(got, want)
        assert row <= 1.0 and miss <= _B3_MISMATCH_LIMIT, (row, miss)


def test_decode_attention_graph_replay_reads_cache_valid(cuda_device):
    """A captured launch replayed after cache_valid is rewritten in place
    gives the plain result for the new values."""
    args = _b3_inputs(cuda_device, 12, (2047, 1000), 64, "bfloat16", seed=7)
    cv = args[-1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tda.decode_attention(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tda.decode_attention(*args)
    for new in ((500, 2560), (0, 64), (2560, 0)):
        cv.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        row, miss = _b3_agreement(out, tda.decode_attention_plain(*args))
        assert row <= 1.0 and miss <= _B3_MISMATCH_LIMIT, (new, row, miss)


def test_two_piece_attention_is_one_launch(cuda_device):
    """On CUDA tensors the small-T branch of _gqa_two_piece_attention is one
    kernel launch (torch.profiler's runtime launch rows), no plain version."""
    from torch.profiler import ProfilerActivity, profile

    from realtime_codec_agent_tpu_torch.models import llama

    args = _b3_inputs(cuda_device, 12, (2047,), 64, "bfloat16", seed=3)
    llama._gqa_two_piece_attention(*args)
    torch.cuda.synchronize()
    calls = tda.decode_attention_plain.calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        llama._gqa_two_piece_attention(*args)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages() if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    assert launches == 1, [(e.key, e.count) for e in prof.key_averages()]
    assert tda.decode_attention_plain.calls == calls


def test_decode_attention_wrapper_raises(cuda_device):
    args = list(_b3_inputs(cuda_device, 12, (100,), 64, "bfloat16"))
    bad_dtype = list(args)
    bad_dtype[1] = args[1].float()
    with pytest.raises(ValueError):
        tda.decode_attention(*bad_dtype)
    with pytest.raises(ValueError):  # 9 * 8 rows per KV head
        q = torch.zeros((1, 9, 64, 64), dtype=torch.bfloat16, device=cuda_device)
        tda.decode_attention(q, *args[1:])


@pytest.mark.parametrize(
    "b,t,h,kh,dtype,dh",
    [
        (2, 1, 32, 8, "bfloat16", 64), (1, 65, 4, 1, "bfloat16", 64), (2, 1000, 32, 8, "bfloat16", 64),
        (2, 2048, 32, 8, "bfloat16", 64), (1, 1500, 4, 4, "float32", 64), (1, 130, 8, 2, "float32", 64),
        (2, 2048, 12, 2, "bfloat16", 128), (1, 65, 4, 1, "bfloat16", 128), (1, 1000, 14, 2, "bfloat16", 128),
        (1, 130, 12, 2, "float32", 128),
        # the f32 kernel's tiles: a ragged last tile of 1 row, 60 and 63 rows, and whole tiles; batch 1
        (1, 65, 32, 8, "float32", 64), (2, 1100, 32, 8, "float32", 64), (1, 2047, 32, 8, "float32", 64),
        (2, 2048, 32, 8, "float32", 64), (1, 65, 12, 2, "float32", 128), (2, 1100, 12, 2, "float32", 128),
        (1, 2047, 12, 2, "float32", 128), (1, 2048, 12, 2, "float32", 128),
    ],
)
def test_flash_attention_kernel_matches_plain(cuda_device, b, t, h, kh, dtype, dh):
    """Causal GQA flash forward, ragged last tiles, head dims 64 and 128.
    bf16: the output at atol 2e-2 (both round P and the output to bf16, at
    different running maxima: a one-ulp difference is ~4e-3 here), lse at
    1e-4 (f32 statistics of the same exact products); two launches bitwise
    equal. f32 (the register-tiled SIMT kernel): both at 1e-5."""
    rng = np.random.default_rng(t + h + dh)
    dt = getattr(torch, dtype)
    q, k, v = (
        torch.from_numpy(rng.normal(size=(b, t, n, dh)).astype(np.float32)).to(cuda_device, dt)
        for n in (h, kh, kh)
    )
    launches = tfa.flash_attention.launches
    out, lse = tfa.flash_attention(q, k, v)
    again, again_lse = tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == launches + 2
    assert torch.equal(out, again) and torch.equal(lse, again_lse)
    assert out.dtype == dt and out.shape == q.shape and lse.shape == (b, h, t, 1)
    want, want_lse = tfa.flash_causal_attention(q, k, v)
    atol = 2e-2 if dtype == "bfloat16" else 1e-5
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4 if dtype == "bfloat16" else 1e-5, rtol=0)


def test_flash_attention_wrapper_raises(cuda_device):
    """Shapes and dtypes the kernels do not take raise; a gradient of f32
    inputs runs the f32 backward kernels."""
    q = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16, device=cuda_device)
    counts = (tfa.flash_attention_bwd_dq_f32.launches, tfa.flash_attention_bwd_dkv_f32.launches)
    qf = q.float().requires_grad_()
    out, _ = tfa.flash_attention(qf, q.float(), q.float())
    out.sum().backward()
    assert qf.grad is not None and bool(torch.isfinite(qf.grad).all())
    assert (tfa.flash_attention_bwd_dq_f32.launches, tfa.flash_attention_bwd_dkv_f32.launches) == tuple(
        c + 1 for c in counts)
    with pytest.raises(ValueError, match="float16"):
        tfa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="valid"):
        tfa.flash_attention(q, q, q, valid=torch.ones((1, 7), device=cuda_device))
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q.float(), q.float())
    with pytest.raises(ValueError):
        tfa.flash_attention(q[..., :32], q[..., :32], q[..., :32])


def _bf16_inputs(b, t, h, kh, seed, dev, masked, dh=64, prefix=5):
    rng = np.random.default_rng(seed)
    q, k, v, do = (
        torch.from_numpy(rng.normal(size=(b, t, n, dh)).astype(np.float32)).to(dev, torch.bfloat16)
        for n in (h, kh, kh, h)
    )
    valid = None
    if masked:  # right padding, and batch row 0 with its first `prefix` keys dead (rows with no live key)
        v_np = np.ones((b, t), np.float32)
        v_np[-1, (3 * t) // 4 :] = 0.0
        v_np[0, : min(prefix, t)] = 0.0
        valid = torch.from_numpy(v_np).to(dev)
    return q, k, v, do, valid


def _rel(a, b):
    """max |a - b| / max |b|, the scale floored at 1e-3: where the exact
    gradient is 0 (T = 1: dS = P (dP - delta) with dP = delta) both sides
    hold sums that cancel in another order."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-3))


@pytest.mark.parametrize("t", [1, 65, 1000, 1100, 2048])
@pytest.mark.parametrize("kh", [8, 32])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_attention_bwd_kernels_match_plain(cuda_device, t, kh, masked):
    """dq/dk/dv of the kernels against the plain backward on the same
    forward residuals, bf16, GQA 4:1 and 1:1: relative error (max abs diff /
    max abs) <= 2e-2 (the kernels round P and dS to bf16 as operands, the
    plain version keeps them f32)."""
    b, h = 2, 32
    q, k, v, do, valid = _bf16_inputs(b, t, h, kh, t + kh, cuda_device, masked)
    out, lse = tfa.flash_attention(q, k, v, valid=valid)
    n_dq, n_dkv = tfa.flash_attention_bwd_dq.launches, tfa.flash_attention_bwd_dkv.launches
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do, valid=valid)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_bwd_dq.launches, tfa.flash_attention_bwd_dkv.launches) == (n_dq + 1, n_dkv + 1)
    want = tfa.flash_causal_attention_bwd(q, k, v, out, lse, do, valid=valid)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16 and torch.isfinite(g).all(), name
        assert _rel(g, w) <= 2e-2, (name, _rel(g, w))
    if masked:  # rows with no live key: dq exactly 0
        assert float(got[0][0, :5].abs().max()) == 0.0


@pytest.mark.parametrize("t", [65, 1000, 1100, 2048])
@pytest.mark.parametrize("h,kh", [(12, 2), (32, 8), (32, 32)])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_attention_bwd_kernels_match_plain_head_dim_128(cuda_device, t, h, kh, masked):
    """The same at head_dim 128 (Qwen2.5's), GQA 6:1, 4:1 and 1:1: relative
    error <= 2e-2, rows with no live key get dq = 0, one launch each."""
    q, k, v, do, valid = _bf16_inputs(2, t, h, kh, t + kh + 128, cuda_device, masked, dh=128)
    out, lse = tfa.flash_attention(q, k, v, valid=valid)
    n_dq, n_dkv = tfa.flash_attention_bwd_dq.launches, tfa.flash_attention_bwd_dkv.launches
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do, valid=valid)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_bwd_dq.launches, tfa.flash_attention_bwd_dkv.launches) == (n_dq + 1, n_dkv + 1)
    want = tfa.flash_causal_attention_bwd(q, k, v, out, lse, do, valid=valid)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16 and torch.isfinite(g).all(), name
        assert _rel(g, w) <= 2e-2, (name, _rel(g, w))
    if masked:
        assert float(got[0][0, :5].abs().max()) == 0.0


def test_flash_attention_bwd_deterministic(cuda_device):
    q, k, v, do, valid = _bf16_inputs(4, 2048, 32, 8, 1, cuda_device, True)
    out, lse = tfa.flash_attention(q, k, v, valid=valid)
    a = tfa.flash_attention_bwd(q, k, v, out, lse, do, valid=valid)
    b = tfa.flash_attention_bwd(q, k, v, out, lse, do, valid=valid)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("b,t,h,kh,dh", [(1, 1100, 12, 2, 128), (1, 65, 12, 2, 128), (2, 1000, 32, 8, 64)])
def test_flash_attention_bwd_dkv_splits(cuda_device, b, t, h, kh, dh):
    """dk/dv with its key tiles' query tiles split over a cluster of 1, 2, 4
    or 8 blocks (partials summed by block 0 in rank order): each within the
    plain backward's 2e-2, bitwise equal over two launches; splits=0 is the
    kernel's own pick (dkv_splits), bit for bit. Batch 1 with 2 KV heads is
    the grid the splits are for (phase 9(b)); T = 65 leaves some blocks of a
    cluster without a tile."""
    q, k, v, do, valid = _bf16_inputs(b, t, h, kh, 11 + t, cuda_device, True, dh=dh)
    out, lse = tfa.flash_attention(q, k, v, valid=valid)
    _, delta = tfa.flash_attention_bwd_dq(q, k, v, out, lse, do, valid=valid)
    want = tfa.flash_causal_attention_bwd(q, k, v, out, lse, do, valid=valid)
    got = {}
    for splits in (1, 2, 4, 8):
        got[splits] = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, valid=valid, splits=splits)
        again = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, valid=valid, splits=splits)
        for name, g, a, w in zip(("dk", "dv"), got[splits], again, want[1:]):
            assert torch.equal(g, a), (splits, name)
            assert _rel(g, w) <= 2e-2, (splits, name, _rel(g, w))
    picked = tfa.dkv_splits(b, t, kh, dh)
    assert picked in got
    for g, a in zip(tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, valid=valid), got[picked]):
        assert torch.equal(g, a)
    with pytest.raises(RuntimeError):
        tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, valid=valid, splits=16)


def test_flash_attention_bwd_deterministic_head_dim_128(cuda_device):
    """Two launches bitwise equal at head_dim 128, Qwen2.5-1.5B's GQA 12 / 2,
    masked."""
    q, k, v, do, valid = _bf16_inputs(2, 2048, 12, 2, 2, cuda_device, True, dh=128)
    out, lse = tfa.flash_attention(q, k, v, valid=valid)
    a = tfa.flash_attention_bwd(q, k, v, out, lse, do, valid=valid)
    b = tfa.flash_attention_bwd(q, k, v, out, lse, do, valid=valid)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


VALID_MASK_CASES = [  # (b, t, h, kh, dtype, dh, dead prefix of batch row 0)
    (2, 1100, 32, 8, "bfloat16", 64, 5), (1, 65, 4, 4, "bfloat16", 64, 5), (2, 700, 4, 2, "float32", 64, 5),
    (2, 1100, 12, 2, "bfloat16", 128, 5), (1, 300, 4, 2, "float32", 128, 5),
    # f32: a dead prefix of two whole key tiles and part of a third (a row max that stays -inf for tiles)
    (2, 2047, 32, 8, "float32", 64, 150), (1, 1100, 12, 2, "float32", 128, 150), (1, 65, 12, 2, "float32", 128, 65),
]


@pytest.mark.parametrize(
    "b,t,h,kh,dtype,dh,prefix", VALID_MASK_CASES,
    ids=["-".join(map(str, c if c[-1] != 5 else c[:-1])) for c in VALID_MASK_CASES],
)
def test_flash_attention_valid_mask_matches_plain(cuda_device, b, t, h, kh, dtype, dh, prefix):
    """The forward with a validity mask (right padding and fully masked
    rows, a dead prefix of up to whole tiles), head dims 64 and 128: out at
    atol 2e-2 (bf16) / 1e-5 (f32), lse at 1e-4 / 1e-5; masked rows give
    out = 0 and lse = 0 exactly."""
    q, k, v, _, valid = _bf16_inputs(b, t, h, kh, 7 + t, cuda_device, True, dh=dh, prefix=prefix)
    dt = getattr(torch, dtype)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    out, lse = tfa.flash_attention(q, k, v, valid=valid)
    want, want_lse = tfa.flash_causal_attention(q, k, v, valid=valid)
    atol = 2e-2 if dtype == "bfloat16" else 1e-5
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4 if dtype == "bfloat16" else 1e-5, rtol=0)
    dead = min(prefix, t)
    assert float(out[0, :dead].float().abs().max()) == 0.0 and float(lse[0, :, :dead].abs().max()) == 0.0


def test_flash_attention_function_grads_match_autograd_of_plain(cuda_device):
    """The Function's gradients (kernels both ways) against autograd through
    the plain forward (torch ops, bf16 rounding at the same places), bf16,
    relative error <= 2e-2."""
    q, k, v, do, valid = _bf16_inputs(2, 1100, 32, 8, 3, cuda_device, True)
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    launches = tfa.flash_attention.launches
    out, _ = tfa.flash_attention(q, k, v, valid=valid)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert tfa.flash_attention.launches == launches + 1
    calls = tfa.flash_causal_attention_bwd.calls
    want_out, _ = tfa.flash_causal_attention(q, k, v, valid=valid)
    want = torch.autograd.grad(want_out, (q, k, v), do)
    assert tfa.flash_causal_attention_bwd.calls == calls  # the kernels ran, not the plain backward
    for g, w in zip(got, want):
        assert _rel(g, w) <= 2e-2, _rel(g, w)


@pytest.mark.parametrize("t,h,kh,masked", [(1100, 12, 2, True), (2048, 12, 2, False), (65, 8, 8, True)])
def test_flash_attention_function_grads_match_autograd_of_plain_head_dim_128(cuda_device, t, h, kh, masked):
    """The same at head_dim 128: the kernels both ways against autograd
    through the plain forward, relative error <= 2e-2."""
    q, k, v, do, valid = _bf16_inputs(1, t, h, kh, 5 + t, cuda_device, masked, dh=128)
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    counts = (tfa.flash_attention.launches, tfa.flash_attention_bwd_dq.launches, tfa.flash_attention_bwd_dkv.launches)
    out, _ = tfa.flash_attention(q, k, v, valid=valid)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert (tfa.flash_attention.launches, tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    calls = tfa.flash_causal_attention_bwd.calls
    want_out, _ = tfa.flash_causal_attention(q, k, v, valid=valid)
    want = torch.autograd.grad(want_out, (q, k, v), do)
    assert tfa.flash_causal_attention_bwd.calls == calls
    for g, w in zip(got, want):
        assert _rel(g, w) <= 2e-2, _rel(g, w)


def _f32_inputs(b, t, h, kh, seed, dev, masked, dh):
    """f32 inputs; ``masked`` "prefix": batch row 0's first 150 keys dead
    (two whole key tiles and part of a third), right padding on the last."""
    q, k, v, do, valid = _bf16_inputs(b, t, h, kh, seed, dev, bool(masked), dh=dh,
                                      prefix=150 if masked == "prefix" else 5)
    rng = np.random.default_rng(seed + 1)
    q, k, v, do = (torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)).to(dev) for x in (q, k, v, do))
    return q, k, v, do, valid


# f32 backward against the plain backward on the card, max |diff| / max |plain|
# per gradient: the same f32 algorithm summed in other orders. The limit
# stands between the kernels' reading and that of a nearly right control,
# the plain backward with TF32 products (chip_smoke.check_b4_f32_bwd prints
# both).
F32_BWD_REL = 1e-5


@pytest.mark.parametrize("masked", [False, True, "prefix"])
@pytest.mark.parametrize("t", [65, 1100, 2047, 2048])
@pytest.mark.parametrize("h,kh", [(32, 8), (12, 2)])
@pytest.mark.parametrize(  # batch 2 keeps the ids the cases had before batch 1 was added
    "dh,b", [pytest.param(dh, b, id=f"{dh}" if b == 2 else f"{dh}-b{b}") for b in (2, 1) for dh in (64, 128)])
def test_flash_attention_bwd_f32_kernels_match_plain(cuda_device, b, dh, h, kh, t, masked):
    """B4's f32 dq and dk/dv kernels against the plain backward on the same
    forward residuals (the f32 forward kernel's), head_dim 64 and 128, GQA
    4:1 and 6:1, T 65 (a last tile of one row), 1,100 (past the plain
    version's 1,024-key block), 2,047 and 2,048, batch 2 and 1 (where the
    dk/dv kernel splits its key tiles over a cluster), unmasked, masked and
    with a dead prefix of whole key tiles: relative error <= F32_BWD_REL,
    rows with no live key get dq = 0, one launch each, two launches bitwise
    equal."""
    q, k, v, do, valid = _f32_inputs(b, t, h, kh, t + h + dh + b, cuda_device, masked, dh)
    out, lse = tfa.flash_attention(q, k, v, valid=valid)
    counts = (tfa.flash_attention_bwd_dq_f32.launches, tfa.flash_attention_bwd_dkv_f32.launches,
              tfa.flash_attention_bwd_dq.launches, tfa.flash_attention_bwd_dkv.launches)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do, valid=valid)
    again = tfa.flash_attention_bwd(q, k, v, out, lse, do, valid=valid)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_bwd_dq_f32.launches, tfa.flash_attention_bwd_dkv_f32.launches,
            tfa.flash_attention_bwd_dq.launches, tfa.flash_attention_bwd_dkv.launches) == (
        counts[0] + 2, counts[1] + 2, counts[2], counts[3])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = tfa.flash_causal_attention_bwd(q, k, v, out, lse, do, valid=valid)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32 and torch.isfinite(g).all(), name
        assert _rel(g, w) <= F32_BWD_REL, (name, _rel(g, w))
    if masked:
        dead = min(150 if masked == "prefix" else 5, t)
        assert float(got[0][0, :dead].abs().max()) == 0.0
        assert float(got[1][0, :dead].abs().max()) == 0.0 and float(got[2][0, :dead].abs().max()) == 0.0
    _, delta = tfa.flash_attention_bwd_dq_f32(q, k, v, out, lse, do, valid=valid)
    want_delta = (do * out).sum(dim=-1).permute(0, 2, 1)
    assert float((delta - want_delta).abs().max()) <= 1e-5 * float(want_delta.abs().max())


@pytest.mark.parametrize(
    "t,h,kh,dh", [(1100, 32, 8, 64), (1100, 12, 2, 128), (65, 8, 8, 64), (2047, 32, 8, 64), (2048, 12, 2, 128)])
def test_flash_attention_function_grads_f32(cuda_device, t, h, kh, dh):
    """The Function's f32 gradients on the card (the f32 forward and
    backward kernels) against autograd through the plain forward: within
    F32_BWD_REL, the plain backward never called."""
    q, k, v, do, valid = _f32_inputs(1, t, h, kh, 9 + t, cuda_device, True, dh)
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    counts = (tfa.flash_attention.launches, tfa.flash_attention_bwd_dq_f32.launches,
              tfa.flash_attention_bwd_dkv_f32.launches)
    calls = tfa.flash_causal_attention_bwd.calls
    out, _ = tfa.flash_attention(q, k, v, valid=valid)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert (tfa.flash_attention.launches, tfa.flash_attention_bwd_dq_f32.launches,
            tfa.flash_attention_bwd_dkv_f32.launches) == tuple(c + 1 for c in counts)
    assert tfa.flash_causal_attention_bwd.calls == calls
    want_out, _ = tfa.flash_causal_attention(q, k, v, valid=valid)
    want = torch.autograd.grad(want_out, (q, k, v), do)
    for g, w in zip(got, want):
        assert _rel(g, w) <= F32_BWD_REL, _rel(g, w)


@pytest.mark.parametrize(
    "b,t,h,kh,dh",
    [(1, 1100, 12, 2, 128), (1, 65, 12, 2, 128), (2, 1000, 32, 8, 64), (1, 2048, 32, 8, 64), (2, 2047, 12, 2, 128)],
)
def test_flash_attention_bwd_dkv_f32_splits(cuda_device, b, t, h, kh, dh):
    """The f32 dk/dv with its key tiles' (head, query tile) lists split over
    a cluster of 1, 2, 4 or 8 blocks (partials summed by block 0 in rank
    order): each within F32_BWD_REL of the plain backward, bitwise equal
    over two launches; splits=0 is the kernel's own pick (dkv_f32_splits),
    bit for bit. T = 65 leaves some blocks of a cluster without a tile."""
    q, k, v, do, valid = _f32_inputs(b, t, h, kh, 13 + t, cuda_device, True, dh)
    out, lse = tfa.flash_attention(q, k, v, valid=valid)
    _, delta = tfa.flash_attention_bwd_dq_f32(q, k, v, out, lse, do, valid=valid)
    want = tfa.flash_causal_attention_bwd(q, k, v, out, lse, do, valid=valid)
    got = {}
    for splits in (1, 2, 4, 8):
        got[splits] = tfa.flash_attention_bwd_dkv_f32(q, k, v, do, lse, delta, valid=valid, splits=splits)
        again = tfa.flash_attention_bwd_dkv_f32(q, k, v, do, lse, delta, valid=valid, splits=splits)
        for name, g, a, w in zip(("dk", "dv"), got[splits], again, want[1:]):
            assert torch.equal(g, a), (splits, name)
            assert _rel(g, w) <= F32_BWD_REL, (splits, name, _rel(g, w))
    picked = tfa.dkv_f32_splits(b, t, kh, dh)
    assert picked in got
    for g, a in zip(tfa.flash_attention_bwd_dkv_f32(q, k, v, do, lse, delta, valid=valid), got[picked]):
        assert torch.equal(g, a)
    with pytest.raises(RuntimeError):
        tfa.flash_attention_bwd_dkv_f32(q, k, v, do, lse, delta, valid=valid, splits=16)


def _int4_operands(seed, t, k, n, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((t, k), generator=gen, device=dev), *ctl_operands("int4", k, n, gen, dev).values())


@pytest.mark.parametrize(
    "t,k,n",
    [(3, 2048, 3072), (3, 2048, 2048), (3, 2048, 16384), (3, 8192, 2048), (1, 2048, 3072), (1, 8192, 2048),
     (8, 2048, 2048), (2, 8192, 1040), (5, 32, 16), (3, 2048, 1320), (1, 2048, 1321), (2, 64, 7),
     (2, 2048, 2048), (4, 2048, 2048), (6, 2048, 2048), (7, 2048, 2048), (3, 32, 16), (3, 32, 512),
     (3, 32, 528)],
)
def test_int4_matmul_kernel_matches_plain(cuda_device, t, k, n):
    """The fused layer shapes at T = 3 and 1, every T at wo's shape, a
    ragged N (not a multiple of the column tile), one group (K = 32: fewer
    groups than splits) at N = 16, 512 and 528, and N not a multiple of 16
    (the byte path). The same bf16 weights and exact products on both
    sides, f32 sums in another order (the tensor cores' against the plain
    matmul's): relative error (max abs diff / max abs) <= 1e-5. One call is
    one launch; two launches are bitwise equal."""
    x, q4, d, m = _int4_operands(t * k + n, t, k, n, cuda_device)
    launches = t4.int4_matmul.launches
    got = t4.int4_matmul(x, q4, d, m)
    assert t4.int4_matmul.launches == launches + 1
    again = t4.int4_matmul(x, q4, d, m)
    torch.cuda.synchronize()
    assert t4.int4_matmul.launches == launches + 2
    assert torch.equal(got, again)
    want = t4.int4_matmul_plain(x, q4, d, m)
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= 1e-5, err


def test_int4_matmul_wrapper_raises(cuda_device):
    x, q4, d, m = _int4_operands(0, 2, 64, 32, cuda_device)
    with pytest.raises(ValueError, match="rows"):
        t4.int4_matmul(torch.zeros((9, 64), device=cuda_device), q4, d, m)
    # any N is taken (N = 24: the byte path)
    leaf = (q4[:, :24].contiguous(), d[:, :24].contiguous(), m[:, :24].contiguous())
    got = t4.int4_matmul(x, *leaf)
    want = t4.int4_matmul_plain(x, *leaf)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    with pytest.raises(ValueError, match="K % 32"):
        t4.int4_matmul(x[:, :48], q4[:24], d[:1], m[:1])
    with pytest.raises(ValueError, match="float32"):
        t4.int4_matmul(x, q4, d.half(), m)


@pytest.mark.parametrize(
    "k,n", [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048), (8192, 1040), (32, 16), (2048, 1320),
            (2048, 1321), (8192, 8192)]
)
def test_int4_dequant_kernel_matches_plain(cuda_device, k, n):
    """The dequant route's kernel at the four fused layer leaves (wo: the
    smallest grid), a ragged N, one group, a leaf wide enough for 16 byte
    rows a thread, the tiny vocab (N % 16 != 0, N % 8 == 0) and an odd N
    (the scalar kernel): the same fma and bf16 rounding as the plain
    version, so bit for bit equal, under the plan and under every other
    byte-row count a thread."""
    _, q4, d, m = _int4_operands(k + n, 1, k, n, cuda_device)
    launches = t4.dequant_int4_bf16.launches
    got = t4.dequant_int4_bf16(q4, d, m)
    torch.cuda.synchronize()
    assert t4.dequant_int4_bf16.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.shape == (k, n)
    assert torch.equal(got, t4.dequant_int4_bf16_plain(q4, d, m))
    assert t4.dequant_rows(k, n) in ((0,) if n % 8 else (1, 2, 4, 8, 16))
    for rows in (1, 2, 4, 8, 16):
        assert torch.equal(t4.dequant_int4_bf16(q4, d, m, rows=rows), got), rows
    leaf = (q4[:, :8].contiguous(), d[:, :8].contiguous(), m[:, :8].contiguous())
    assert torch.equal(t4.dequant_int4_bf16(*leaf), t4.dequant_int4_bf16_plain(*leaf))


def test_int4_dequant_wrapper_raises(cuda_device):
    _, q4, d, m = _int4_operands(0, 1, 64, 32, cuda_device)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        t4.dequant_int4_bf16(q4, d, m, rows=3)


@pytest.mark.parametrize("chunk_kb", [16, 64])
def test_hbm_stream_grid_matches_plain(cuda_device, chunk_kb):
    """Every byte of every whole chunk, every pass: the integer sum exactly
    (a buffer with a ragged tail, which neither side reads)."""
    gen = torch.Generator(device=cuda_device).manual_seed(chunk_kb)
    w = torch.randint(-128, 128, (8 * 2**20 + 4096,), generator=gen, device=cuda_device, dtype=torch.int8)
    launches = ths.stream_sum.launches
    got = ths.stream_sum(w, chunk_kb * 1024, 3)
    assert ths.stream_sum.launches == launches + 1
    assert int(got) == int(ths.stream_sum_plain(w, chunk_kb * 1024, 3))


@pytest.mark.parametrize("depth,chunk_bytes", [(2, 32 * 1024), (4, 48 * 1024), (8, 16 * 1024), (3, 4096)])
def test_hbm_stream_manual_matches_plain(cuda_device, depth, chunk_bytes):
    """The bulk-copy ring: the first 32 rows of 256 bytes of every chunk
    (all of a 4 KB chunk), every pass, the integer sum exactly."""
    gen = torch.Generator(device=cuda_device).manual_seed(depth)
    w = torch.randint(-128, 128, (8 * 2**20,), generator=gen, device=cuda_device, dtype=torch.int8)
    launches = ths.stream_rows_sum.launches
    got = ths.stream_rows_sum(w, chunk_bytes, depth, 3)
    assert ths.stream_rows_sum.launches == launches + 1
    assert int(got) == int(ths.stream_rows_sum_plain(w, chunk_bytes, 3))


def _ulps_at_scale(a, b):
    """|a - b| in units of the f32 spacing at max(|b|, 1): near g = 0 the
    outer log amplifies the inner log's rounding of a value near 1."""
    scale = torch.clamp(b.abs(), min=1.0)
    return float(((a - b).abs() / (scale * 2.0**-23)).max())


@pytest.mark.parametrize("k", [40, 100, 1024, 2000])
@pytest.mark.parametrize("step_kind", ["host", "int32", "int64"])
def test_threefry_gumbel_kernel_matches_plain(cuda_device, k, step_kind):
    """S1 against its plain version on the card: the uniform draws bit for
    bit, the noise within 2 ulp (at max(|g|, 1)); the step as a host int or
    a device tensor."""
    seed, step = 1234, 77
    step_arg = step if step_kind == "host" else torch.tensor(step, dtype=getattr(torch, step_kind), device=cuda_device)
    launches = tsm.gumbel_noise.launches
    u, g = tsm.gumbel_noise(seed, step_arg, k, cuda_device, return_uniform=True)
    torch.cuda.synchronize()
    assert tsm.gumbel_noise.launches == launches + 1
    pu, pg = tsm.gumbel_noise_plain(seed, step, k, cuda_device, return_uniform=True)
    assert torch.equal(u.view(torch.int32), pu.view(torch.int32))
    assert _ulps_at_scale(g, pg) <= 2.0
    assert torch.equal(tsm.gumbel_noise(seed, step_arg, k, cuda_device), g)


@pytest.mark.parametrize("top_k", [40, 100, 1024])
@pytest.mark.parametrize("v", [1320, 32768, 259344, 259584, 283024])
def test_sample_token_kernel_matches_plain(cuda_device, v, top_k):
    """S1's whole draw against sample_token_plain on the card with the plain
    noise: every settings case (greedy, codec-pinned, the end-audio bias,
    penalties, the dyn_k cutoff), plain and planted-tie logits, three steps
    each; top-k ids and values bit for bit, probabilities within 2 ulp, the
    sampled id equal outside boundary draws, bitwise repeatable
    (tools/sampler_times.check_draws). 259,584 takes the two-stage route,
    the others the direct one."""
    rng = np.random.default_rng(v + top_k)
    cases = []
    for name, settings in st.settings_cases(v).items():
        for step, ties in ((0, False), (1, True), (2, False)):
            logits = st.synthetic_logits(v, seed=v + step, ties=ties)
            cases.append((name, st.make_inputs(logits, settings, top_k, st.window_on_top(logits, rng), cuda_device),
                          step))
    counts = st.check_draws(cases, log=lambda *_: None)
    assert counts["draws"] == len(cases)


def test_sample_token_kernel_is_one_launch(cuda_device):
    """One launch a call, counted by the wrapper and by torch.profiler; the
    step as a host int, a device int32 or int64 gives the same id."""
    logits = st.synthetic_logits(259344, seed=3)
    inp = st.make_inputs(logits, st.settings_cases(259344)["codec_pinned"], 100, [1, 2, 3], cuda_device)
    a = (inp["scalars"], inp["bias_ids"], inp["bias_vals"], inp["window_ids"], inp["window_mask"])
    launches = tsm.sample_token.launches
    ids = [tsm.sample_token(inp["logits"], (7, step), *a, top_k=100)
           for step in (77, torch.tensor(77, dtype=torch.int32, device=cuda_device),
                        torch.tensor(77, dtype=torch.int64, device=cuda_device))]
    assert tsm.sample_token.launches == launches + 3
    assert len({int(t) for t in ids}) == 1
    per_draw, names = st.launch_count(lambda: tsm.sample_token(inp["logits"], (7, 77), *a, top_k=100))
    assert per_draw == 1 and all("sample_token_kernel" in n for n in names), (per_draw, names)


def _row_cases(v, top_k, rows, dev, n_cases=3):
    """``n_cases`` launches of ``rows`` rows, each row its own settings case,
    logits (every other one with planted ties), window and (seed, step)."""
    rng = np.random.default_rng(v + top_k + rows)
    settings = list(st.settings_cases(v).values())
    cases = []
    for c in range(n_cases):
        inputs, keys = [], []
        for r in range(rows):
            logits = st.synthetic_logits(v, seed=v + 7 * c + r, ties=(c + r) % 2 == 1)
            inputs.append(st.make_inputs(logits, settings[(c + r) % len(settings)], top_k,
                                         st.window_on_top(logits, rng), dev))
            keys.append((1000 + r, 31 * c + r))
        cases.append((f"V={v} k={top_k} launch {c}", inputs, keys))
    return cases


@pytest.mark.parametrize("rows", [1, 2, 4])
@pytest.mark.parametrize("top_k", [40, 100, 1024])
@pytest.mark.parametrize("v", [1320, 259344, 259584])
def test_sample_token_rows_kernel_matches_plain(cuda_device, v, top_k, rows):
    """S1 over rows: every row against the plain draw of its own inputs and
    key as the single draw is held (top-k ids and values bit for bit,
    probabilities within 2 ulp, the id equal outside boundary draws,
    bitwise repeatable), and bit for bit the single launch's draw under the
    same key (R = 1 is the single draw)."""
    counts = st.check_rows(_row_cases(v, top_k, rows, cuda_device), log=lambda *_: None)
    assert counts["draws"] == 3 * rows


def test_sample_token_rows_kernel_is_one_launch(cuda_device):
    cases = _row_cases(259344, 100, 4, cuda_device, n_cases=1)
    _, inputs, keys = cases[0]
    stacked = st.stack_rows(inputs)
    keys_t = torch.tensor(keys, dtype=torch.int64, device=cuda_device)
    a = (stacked["scalars"], stacked["bias_ids"], stacked["bias_vals"], stacked["window_ids"], stacked["window_mask"])
    launches = tsm.sample_token_rows.launches
    ids = tsm.sample_token_rows(stacked["logits"], keys_t, *a, top_k=100)
    assert tsm.sample_token_rows.launches == launches + 1 and ids.shape == (4,)
    per_call, names = st.launch_count(lambda: tsm.sample_token_rows(stacked["logits"], keys_t, *a, top_k=100))
    assert per_call == 1 and all("sample_token_kernel" in n for n in names), (per_call, names)
    # rows of a wider tensor (the group program's logits[:, 0] of (R, 2, V))
    wide = torch.stack([stacked["logits"], stacked["logits"] * 0.5], dim=1)
    assert torch.equal(tsm.sample_token_rows(wide[:, 0], keys_t, *a, top_k=100), ids)


@pytest.mark.parametrize("top_k", [40, 1024])
@pytest.mark.parametrize("v", [259584, 283024])
def test_sample_token_rows_raw_keys_kernel_matches_plain(cuda_device, v, top_k):
    """S1 over rows under raw threefry keys (k1, k2, step), the batched
    engine's: 16 rows in one launch against the plain draw of each row's
    inputs with the noise of fold_in((k1, k2), step)
    (tools/sampler_times.check_raw_keys), and (0, seed, step) keys drawing
    what (seed, step) keys draw."""
    rows, keys = st.raw_key_rows(v, top_k, 16, cuda_device, seed=v + top_k)
    assert st.check_raw_keys(rows, keys, log=lambda *_: None)["draws"] == 16


def test_sample_token_rows_wrapper_raises(cuda_device):
    _, inputs, keys = _row_cases(1320, 40, 2, cuda_device, n_cases=1)[0]
    stacked = st.stack_rows(inputs)
    keys_t = torch.tensor(keys, dtype=torch.int64, device=cuda_device)
    a = [stacked["scalars"], stacked["bias_ids"], stacked["bias_vals"], stacked["window_ids"], stacked["window_mask"]]
    with pytest.raises(ValueError):
        tsm.sample_token_rows(stacked["logits"].half(), keys_t, *a, top_k=40)
    with pytest.raises(ValueError):
        tsm.sample_token_rows(stacked["logits"], keys_t.int(), *a, top_k=40)
    with pytest.raises(ValueError):
        tsm.sample_token_rows(stacked["logits"], keys_t[:1], *a, top_k=40)
    with pytest.raises(ValueError):
        tsm.sample_token_rows(stacked["logits"], keys_t, *a, top_k=1100)


def test_sample_token_wrapper_raises(cuda_device):
    """The kernel takes f32 logits, int64 ids, (seed, step) or None, k <=
    1,024; anything else raises instead of falling back."""
    inp = st.make_inputs(st.synthetic_logits(1320, seed=0), st.settings_cases(1320)["greedy"], 40, [1], cuda_device)
    a = [inp["scalars"], inp["bias_ids"], inp["bias_vals"], inp["window_ids"], inp["window_mask"]]
    with pytest.raises(ValueError):
        tsm.sample_token(inp["logits"].half(), (0, 0), *a, top_k=40)
    with pytest.raises(ValueError):
        tsm.sample_token(inp["logits"], torch.zeros(40, device=cuda_device), *a, top_k=40)
    with pytest.raises(ValueError):
        tsm.sample_token(inp["logits"], (0, 0), a[0], a[1].int(), *a[2:], top_k=40)
    with pytest.raises(ValueError):
        tsm.sample_token(inp["logits"], (0, 0), *a, top_k=1100)


def test_dispatch_and_rebuild_pump_never_synchronize(cuda_device):
    """The pipelined drive's device work issues no host synchronization:
    under torch.cuda.set_sync_debug_mode("error") (which raises on any
    stream synchronize, blocking copy or host read), a chain resync, two
    fused-chunk dispatches in flight at once and shadow-cache prefill slices
    (a fresh rebuild and one from the live cache) all run. Asserts the sync
    check and the results, never wall time."""
    from realtime_codec_agent_tpu_torch.agent.agent import RealtimeAgent
    from realtime_codec_agent_tpu_torch.agent.config import RealtimeAgentConfig
    from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources
    from realtime_codec_agent_tpu_torch.models.llama import DuplexLMConfig

    lcfg = DuplexLMConfig(  # the tiny widths at head_dim 64, which B3 takes
        vocab_size=1320, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4,
        num_kv_heads=2, head_dim=64, max_context=2048, codebook_size=1024,
    )
    res = RealtimeAgentResources(tiny=True, device=cuda_device, quantize_int8=True, seed=3, lm_config=lcfg)
    agent = RealtimeAgent(resources=res, config=RealtimeAgentConfig(
        use_whisper=False, agent_opening_text=None, force_trans_after_inactivity_secs=0.0,
        force_response_after_inactivity_secs=0.0, temperature=1.0, seed=5,
    ))
    res.llm.settings.min_token_id = res.tokenizer.codec_vocab_start  # no events: every frame accepted
    rng = np.random.default_rng(0)
    chunks = [(0.1 * rng.normal(size=agent.chunk_size_samples)).astype(np.float32) for _ in range(4)]
    for c in chunks[:2]:
        agent.process_audio(c)  # the kernels built, the fused path warm
    session, llm = agent._session, res.llm
    session.bind_sequence(agent.input_ids)
    target = list(llm._input_ids)
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        session.sync_chain()
        first = session.dispatch_chunk(chunks[2])
        second = session.dispatch_chunk(chunks[3])
        llm.rebuild_begin(target)
        llm.rebuild_pump(40)  # the prefill bucket of 64: the two-piece prefill branch
        llm.rebuild_begin_from_live(target, len(target) - 20)
        llm.rebuild_pump(20)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    r1, _ = session.resolve(first)
    r2, _ = session.resolve(second)
    frames = agent.chunk_size_frames_per_channel
    assert r1.event_frame == frames and r2.event_frame == frames
    assert min(r1.out_tokens + r2.out_tokens) >= res.tokenizer.codec_vocab_start
    assert r2.n_final == r1.n_final + 2 * frames
    assert np.isfinite(r1.audio).all() and np.isfinite(r2.audio).all()
    assert llm.rebuild_remaining() == 0 and torch.isfinite(llm._rb_logits).all()
