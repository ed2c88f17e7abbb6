"""PyTorch port: basic ops and the sampler against the JAX package, plus the
port's guards (no JAX import, no silent CPU fallback)."""
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.ops import nn as jnn
from realtime_codec_agent_tpu.ops import sampling as jsampling
from realtime_codec_agent_tpu_torch.ops import nn as tnn
from realtime_codec_agent_tpu_torch.ops import sampling as tsampling

ATOL = 1e-5  # f32 elementwise ops: a few ulps of O(1) values


def _t(a):
    return torch.from_numpy(np.array(a))


def test_port_imports_no_jax():
    """Every module of the port (Whisper and the ASR among them) imports in a
    fresh interpreter without pulling in JAX, any module of the JAX package,
    or transformers."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import realtime_codec_agent_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "assert len(mods) >= 30, mods\n"
        "assert {p.__name__ + '.models.whisper', p.__name__ + '.agent.asr'} <= set(mods), mods\n"
        "assert 'transformers' not in sys.modules  # imported only inside from_hf_checkpoint\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'realtime_codec_agent_tpu' or m.startswith('realtime_codec_agent_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_imports_no_requests():
    """No module of the port needs ``requests`` (the card's machine lacks
    it): every module imports in a fresh interpreter in which importing it
    fails, and no source of the port imports it anywhere (the HTTP clients
    use the standard library)."""
    code = (
        "import sys, importlib, pkgutil\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'requests' or name.startswith('requests.'):\n"
        "            raise ImportError('requests is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import realtime_codec_agent_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "assert p.__name__ + '.agent.external_llm_client' in mods, mods\n"
        "assert 'requests' not in sys.modules\n"
        "print('ok', len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    root = pathlib.Path(__file__).resolve().parents[1] / "realtime_codec_agent_tpu_torch"
    pattern = re.compile(r"^\s*(?:import|from)\s+requests\b", re.MULTILINE)
    assert [str(f) for f in root.rglob("*.py") if pattern.search(f.read_text())] == []


_JAX_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|optax\b|realtime_codec_agent_tpu(?:\.|\s|$))", re.MULTILINE
)
_HF_IMPORT = re.compile(r"^\s*(?:import|from)\s+(?:safetensors|transformers)\b", re.MULTILINE)


@pytest.mark.parametrize(
    "script",
    ["chip_smoke.py", "profile_torch.py", "drive_probe.py", "realtime_codec_agent_tpu_torch/tools/hbm_stream_probe.py"],
)
def test_chip_scripts_import_no_jax(script):
    """The scripts that drive the port on the card import nothing of JAX or
    of the JAX package, and neither safetensors nor transformers (the card's
    machine has none of them; the port's converters:
    test_torch_convert.py::test_converters_need_no_safetensors_or_transformers)."""
    src = (pathlib.Path(__file__).resolve().parents[1] / script).read_text()
    assert _JAX_IMPORT.findall(src) == []
    assert _JAX_IMPORT.findall("import jax\nfrom realtime_codec_agent_tpu.units import x\n")  # the scan bites
    assert _HF_IMPORT.findall(src) == []
    assert len(_HF_IMPORT.findall("    from safetensors import safe_open\nimport transformers\n")) == 2


def test_ptxas_report_reads_registers_and_spills(monkeypatch, tmp_path):
    """The build keeps ptxas's -v report of each source beside the library;
    ptxas_report gives every entry function's registers and spill bytes."""
    from realtime_codec_agent_tpu_torch.ops import _cuda

    assert ("-Xptxas", "-v") == _cuda.NVCC_FLAGS[-2:]
    monkeypatch.setattr(_cuda, "BUILD_ROOT", tmp_path)
    lib_dir = tmp_path / _cuda._source_hash(_cuda.NVCC_FLAGS)
    lib_dir.mkdir()
    (lib_dir / "k.ptxas.txt").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1aPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1aPf\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 122 registers, used 1 barriers, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z1bPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1bPf\n"
        "    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 255 registers, 400 bytes cmem[0]\n"
    )
    assert _cuda.ptxas_report("k") == [("_Z1aPf", 122, 0, 0), ("_Z1bPf", 255, 12, 8)]


def test_resources_cuda_without_gpu_raises(monkeypatch):
    """Asking for the card where there is none is an error, never a CPU run."""
    from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RealtimeAgentResources(tiny=True, device="cuda")


@pytest.mark.parametrize("what", ["whisper"])
def test_resources_unported_options_raise(what):
    """A Whisper model name with no local checkpoint raises from load_asr
    with its reason: no quiet fallback to another backend or to no ASR."""
    from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources

    kwargs = {"whisper": {"whisper_model": "small.en"}}[what]
    with pytest.raises(RuntimeError, match=r"cannot load Whisper 'small.en' \(openai/whisper-small.en\) on cpu"):
        RealtimeAgentResources(tiny=True, device="cpu", **kwargs)


def test_resources_int4_layout():
    """quantize_int4 gives fused int4 layer leaves and an int8 lm_head;
    it is exclusive with quantize_int8."""
    from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources

    res = RealtimeAgentResources(tiny=True, device="cpu", quantize_int4=True)
    for blk in res.lm_params["layers"]:
        assert set(blk) >= {"wqkv", "wo", "w_gu", "w_down"}
        for name in ("wqkv", "wo", "w_gu", "w_down"):
            assert set(blk[name]) == {"q4", "d", "m"} and blk[name]["q4"].dtype == torch.uint8
    assert set(res.lm_params["lm_head"]) == {"q", "s"}
    with pytest.raises(ValueError, match="exclusive"):
        RealtimeAgentResources(tiny=True, device="cpu", quantize_int8=True, quantize_int4=True)


def test_norms_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32)
    w = rng.normal(size=(48,)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    np.testing.assert_allclose(
        tnn.rms_norm(_t(x), _t(w)).numpy(), np.asarray(jnn.rms_norm(x, w)), atol=ATOL
    )
    np.testing.assert_allclose(
        tnn.layer_norm(_t(x), _t(w), _t(b)).numpy(), np.asarray(jnn.layer_norm(x, w, b)), atol=ATOL
    )


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("scaling", [None, (32.0, 1.0, 4.0, 8192)])
def test_rope_matches_jax(interleaved, scaling):
    rng = np.random.default_rng(1)
    pos = np.array([[0, 1, 7, 130, 511]], np.int32)
    q = rng.normal(size=(1, 5, 4, 64)).astype(np.float32)
    k = rng.normal(size=(1, 5, 2, 64)).astype(np.float32)
    jc, js = jnn.rope_cos_sin(jnp.asarray(pos), 64, 500000.0, rope_scaling=scaling, interleaved=interleaved)
    tc, ts = tnn.rope_cos_sin(_t(pos), 64, 500000.0, rope_scaling=scaling, interleaved=interleaved)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)
    jq, jk = jnn.apply_rope(q, k, jc, js, interleaved=interleaved)
    tq, tk = tnn.apply_rope(_t(q), _t(k), tc, ts, interleaved=interleaved)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)


def test_mlps_and_attention_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    wg, wu = (rng.normal(size=(32, 64)).astype(np.float32) * 0.2 for _ in range(2))
    wd = rng.normal(size=(64, 32)).astype(np.float32) * 0.2
    np.testing.assert_allclose(
        tnn.swiglu_mlp(_t(x), _t(wg), _t(wu), _t(wd)).numpy(),
        np.asarray(jnn.swiglu_mlp(x, wg, wu, wd)), atol=ATOL,
    )
    b1 = rng.normal(size=(64,)).astype(np.float32)
    b2 = rng.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(
        tnn.gelu_mlp(_t(x), _t(wg), _t(b1), _t(wd), _t(b2)).numpy(),
        np.asarray(jnn.gelu_mlp(x, wg, b1, wd, b2)), atol=ATOL,
    )
    q, k, v = (rng.normal(size=(2, 6, 4, 16)).astype(np.float32) for _ in range(3))
    mask = np.tril(np.ones((6, 6), bool))[None, None]
    np.testing.assert_allclose(
        tnn.attention(_t(q), _t(k), _t(v), mask=_t(mask)).numpy(),
        np.asarray(jnn.attention(q, k, v, mask=mask)), atol=ATOL,
    )


# ----------------------------------------------------------------- sampler

def _sampler_case(seed, vocab, settings_kw, window_len=20):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(vocab,)).astype(np.float32) * 3
    ids = rng.integers(0, vocab, size=window_len).tolist()
    jst = jsampling.SamplerSettings(**settings_kw)
    tst = tsampling.SamplerSettings(**settings_kw)
    jw = jsampling.make_window(ids)
    tw = tsampling.make_window(ids)
    return logits, jst, tst, jw, tw


def _run_both(logits, jst, tst, jw, tw, step, top_k, base_seed=5):
    key = jax.random.fold_in(jax.random.PRNGKey(base_seed), step)
    jbias = jst.bias_arrays()
    j_tok = int(jsampling.sample_token(
        jnp.asarray(logits), key, jst.scalars(), jbias[0], jbias[1], jw[0], jw[1], top_k=top_k
    ))
    if tst.temp > 0:
        k = tsampling.k_for(top_k, logits.shape[0])
        noise = _t(np.asarray(jax.random.gumbel(key, (k,))))
    else:
        noise = None
    tbias = tst.bias_arrays()
    t_tok = int(tsampling.sample_token(
        _t(logits), noise, tst.scalars(), tbias[0], tbias[1], tw[0], tw[1], top_k=top_k
    ))
    return j_tok, t_tok


SAMPLER_CASES = {
    "greedy": dict(temp=0.0),
    "greedy_penalties_bias_min_id": dict(
        temp=0.0, repeat_penalty=1.3, frequency_penalty=0.4, presence_penalty=0.7,
        logit_bias=((3, 5.0), (11, -100.0)), min_token_id=300,
    ),
    "sampled": dict(temp=0.9, top_p=0.9, min_p=0.02),
    "sampled_penalties_bias_min_id": dict(
        temp=1.0, top_p=1.0, min_p=0.0, repeat_penalty=1.2, frequency_penalty=0.2,
        presence_penalty=0.3, logit_bias=((40, 2.0),), min_token_id=296,
    ),
}


@pytest.mark.parametrize("vocab", [1320, 32768])
@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_matches_jax(case, vocab):
    """Greedy picks the same token; sampled picks the same token when both
    sides use JAX's own Gumbel draw for the step. 32768 takes the two-stage
    top-k, 1320 the direct one."""
    logits, jst, tst, jw, tw = _sampler_case(7, vocab, SAMPLER_CASES[case])
    for step in range(6):
        j_tok, t_tok = _run_both(logits, jst, tst, jw, tw, step, top_k=100)
        assert j_tok == t_tok, (case, step, j_tok, t_tok)


def test_top_k_exact_tie_rule_matches_jax():
    """Planted ties at the top-k boundary resolve as lax.top_k's two-stage
    chain does (block order first, then position)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64 * 256,)).astype(np.float32)
    # equal maxima in several blocks and duplicates inside blocks
    for idx in (5, 300, 301, 4096, 9000, 16000, 257):
        x[idx] = 9.0
    x[[700, 701, 12000]] = 8.5
    for k in (1, 3, 5, 8, 10):
        jv, ji = jsampling.top_k_exact(jnp.asarray(x), k)
        tv, ti = tsampling.top_k_exact(_t(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the direct (small-vocab) route: ties keep index order
    y = np.zeros((1000,), np.float32)
    y[[10, 3, 999, 500]] = 1.0
    jv, ji = jsampling.top_k_exact(jnp.asarray(y), 6)
    tv, ti = tsampling.top_k_exact(_t(y), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_penalties_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(500,)).astype(np.float32)
    ids = rng.integers(0, 500, size=40).tolist() + [7, 7, 7]
    jw = jsampling.make_window(ids)
    tw = tsampling.make_window(ids)
    args = (1.3, 0.25, 0.5)
    j = jsampling.apply_penalties(jnp.asarray(logits), jw[0], jw[1], *[jnp.float32(a) for a in args])
    t = tsampling.apply_penalties(_t(logits), tw[0], tw[1], *[torch.tensor(a) for a in args])
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def test_gumbel_noise_is_a_function_of_seed_and_step():
    a = tsampling.gumbel_noise(42, 7, 100, "cpu")
    b = tsampling.gumbel_noise(42, 7, 100, "cpu")
    c = tsampling.gumbel_noise(42, 8, 100, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.isfinite(a).all()
