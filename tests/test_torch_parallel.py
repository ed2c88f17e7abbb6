"""The port's multi-rank serving (parallel/) on the CPU, in gloo rank pools,
against the unsharded port engines and the JAX package's sharded ones.

Two module-scoped pools (tests/torch_dist_child.RankPool: spawned, one
torch thread each, every wait bounded, killed in teardown), one of 2 ranks
and one of 4; the children import no JAX, the parent computes the JAX
references on its 8 virtual CPU devices (tests/conftest.py) and hands the
children numpy arrays. f32 tiny configs throughout. Tolerances: greedy
tokens equal; logprobs within 1e-5 (the JAX test_train.py TP cases' bound:
the row-parallel sums add two partial products in another order); the
sharded corpus encode and the sharded batched rows, which do no
cross-rank sums, exactly.
"""
import dataclasses
import filecmp
import os

import jax
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.lm.batched_engine import BatchedDecodeEngine as JBatchedEngine
from realtime_codec_agent_tpu.lm.engine import DuplexLMEngine as JEngine
from realtime_codec_agent_tpu.models import llama as jl
from realtime_codec_agent_tpu.parallel import make_mesh as jmake_mesh
from realtime_codec_agent_tpu.parallel import mesh as jmesh
from realtime_codec_agent_tpu.parallel import shard_batched_engine_for_serving as jshard_batched
from realtime_codec_agent_tpu.parallel import shard_lm_for_inference as jshard_lm
from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources
from realtime_codec_agent_tpu_torch.data.encode_corpus import CorpusEncoder, list_audio_files
from realtime_codec_agent_tpu_torch.lm.batched_engine import BatchedDecodeEngine
from realtime_codec_agent_tpu_torch.lm.engine import DuplexLMEngine
from realtime_codec_agent_tpu_torch.models import llama as tl
from realtime_codec_agent_tpu_torch.models.codec import TorchCodecModel, tiny_codec_config
from realtime_codec_agent_tpu_torch.models.from_jax import lm_params_from_numpy
from realtime_codec_agent_tpu_torch.parallel import default_mesh_shape, local_lm_config, shard_lm_params
from realtime_codec_agent_tpu_torch.serving.backend import CompletionBackend
from realtime_codec_agent_tpu_torch.tokenization import CodecTextTokenizer
from realtime_codec_agent_tpu_torch.utils.audio_io import write_wav

from test_torch_pipeline import one_torch_thread  # noqa: F401 (a module fixture)
from torch_dist_child import RankPool

TP_CFG = dict(vocab_size=128, compute_dtype="float32", max_context=128)


@pytest.fixture(scope="module")
def pool2():
    pool = RankPool(2)
    try:
        yield pool
    finally:
        pool.close()


@pytest.fixture(scope="module")
def pool4():
    pool = RankPool(4)
    try:
        yield pool
    finally:
        pool.close()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfg_kw(jcfg) -> dict:
    return dataclasses.asdict(jcfg)


# ------------------------------------------------------------ (h) the slicing

def _rand_params(cfg, seed, fuse=False, quant=None):
    params = tl.init_lm_params(torch.Generator().manual_seed(seed), cfg)
    gen = torch.Generator().manual_seed(seed + 1)
    for blk in params["layers"]:
        for b in ("bq", "bk", "bv"):
            if b in blk:  # random biases, so a misplaced slice shows
                blk[b] = torch.randn(blk[b].shape, generator=gen)
    if quant == "int8":
        params = tl.quantize_params_int8(params)
    elif quant == "int4":
        params = tl.quantize_params_int4(params)
    return tl.fuse_lm_params_for_decode(params) if fuse else params


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_and_bias_slices_match_a_plain_reference(quant, bias):
    """A rank's fused ``wqkv`` / ``w_gu`` / ``bqkv`` equal fusing its plain
    slices (``[q_r | k_r | v_r]``, ``[gate_r | up_r]``), never a plain column
    split of the fused leaf; Qwen2 biases go with their columns; ``wo`` and
    ``w_down`` split by rows with int8 scales whole and int4 groups whole;
    the embedding and norms stay whole. Rank outputs sum to the full layer's."""
    cfg = tl.tiny_lm_config(vocab_size=96, num_heads=4, num_kv_heads=2, attn_bias=bias, hidden_size=64,
                            intermediate_size=128, head_dim=16, compute_dtype="float32")
    plain = _rand_params(cfg, 11, quant=quant)
    fused = tl.fuse_lm_params_for_decode(plain)
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(5))
    full_down = tl.nn.qdot(x.repeat(1, 2), fused["layers"][0]["w_down"])  # K = 128
    parts = []
    for rank in range(2):
        a = shard_lm_params(fused, rank, 2, head_dim=16)
        b = tl.fuse_lm_params_for_decode(shard_lm_params(plain, rank, 2, head_dim=16))
        for k in ("wqkv", "w_gu", "wo", "w_down") + (("bqkv",) if bias else ()):
            la, lb = a["layers"][0][k], b["layers"][0][k]
            for x1, x2 in zip(*(list(v.values()) if isinstance(v, dict) else [v] for v in (la, lb))):
                assert torch.equal(x1, x2), (quant, bias, k)
        blk = plain["layers"][0]
        mine = shard_lm_params(plain, rank, 2, head_dim=16)["layers"][0]
        q = blk["wq"]["q"] if quant == "int8" else blk["wq"]["q4"] if quant == "int4" else blk["wq"]
        mq = mine["wq"]["q"] if quant == "int8" else mine["wq"]["q4"] if quant == "int4" else mine["wq"]
        assert torch.equal(mq, q[:, rank * (q.shape[1] // 2) : (rank + 1) * (q.shape[1] // 2)])
        if quant == "int8":
            assert torch.equal(mine["wo"]["s"], blk["wo"]["s"])  # row split: scales whole
        if quant == "int4":  # K split on whole groups: 64 K rows = 2 groups of 32, one each
            assert mine["w_down"]["d"].shape[0] == blk["w_down"]["d"].shape[0] // 2
        if bias:
            for name, width in (("bq", 64), ("bk", 32), ("bv", 32)):
                h = width // 2
                assert torch.equal(mine[name], blk[name][rank * h : (rank + 1) * h])
        assert mine["attn_norm"] is blk["attn_norm"]
        assert shard_lm_params(plain, rank, 2, head_dim=16)["embed_tokens"] is plain["embed_tokens"]
        xr = x.repeat(1, 2)[:, rank * 64 : (rank + 1) * 64]
        parts.append(tl.nn.qdot(xr, a["layers"][0]["w_down"]))
    torch.testing.assert_close(parts[0] + parts[1], full_down, rtol=1e-5, atol=1e-6)


def test_local_config_and_shape_checks():
    cfg = tl.tiny_lm_config(vocab_size=96)
    local = local_lm_config(cfg, 2)
    assert (local.num_heads, local.num_kv_heads, local.vocab_size) == (2, 1, 96)
    for bad, match in ((dict(num_kv_heads=1, num_heads=3), "num_heads"), (dict(vocab_size=97), "vocab_size"),
                       (dict(intermediate_size=129), "intermediate_size")):
        with pytest.raises(ValueError, match=f"must divide {match}"):
            local_lm_config(tl.tiny_lm_config(**{"vocab_size": 96, **bad}), 2)
    assert local_lm_config(tl.tiny_lm_config(vocab_size=97, tie_embeddings=True), 1).vocab_size == 97
    with pytest.raises(ValueError, match="must divide"):
        shard_lm_params(_rand_params(cfg, 3), 0, 4, head_dim=16)  # 2 KV heads over 4 ranks


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 24])
def test_default_mesh_shape_is_the_jax_rule(n):
    assert default_mesh_shape(n) == jmesh.default_mesh_shape(n)


# ------------------------------------------------ (d) DuplexLMEngine, tp = 2

@pytest.fixture(scope="module")
def tp_setup():
    jcfg = jl.tiny_lm_config(**TP_CFG)
    return jcfg, jl.init_lm_params(jax.random.PRNGKey(7), jcfg)


def _jax_tp_run(params, jcfg, tp):
    eng = JEngine(params, jcfg, seed=3)
    eng.init_sampler_for_generate(temp=0.0, seed=3)
    if tp > 1:
        eng.params, eng._k, eng._v = jshard_lm(params, eng._k, eng._v, jmake_mesh(dp=1, fsdp=1, tp=tp))
    eng.eval(list(range(2, 22)))
    toks = [eng.eval_and_sample([int(t)]) for t in (22, 23, 24)]
    return toks, np.asarray(eng.get_logprobs(list(range(2, 22)), [5, 6]))


def _port_run(params, cfg):
    eng = DuplexLMEngine(params, cfg, seed=3, device="cpu")
    eng.init_sampler_for_generate(temp=0.0, seed=3)
    eng.eval(list(range(2, 22)))
    toks = [eng.eval_and_sample([t]) for t in (22, 23, 24)]
    return toks, np.asarray(eng.get_logprobs(list(range(2, 22)), [5, 6]))


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_tp2_engine_matches_unsharded_and_jax(pool2, tp_setup, quant):
    jcfg, jparams = tp_setup
    if quant == "int8":
        jparams = jax.jit(jl.quantize_params_int8)(jparams)
    jax_toks, jax_lp = _jax_tp_run(jparams, jcfg, tp=2)
    params_np = _np(jparams)
    ref_toks, ref_lp = _port_run(lm_params_from_numpy(params_np), tl.DuplexLMConfig(**_cfg_kw(jcfg)))
    assert ref_toks == jax_toks
    ranks = pool2.run("tp_engine", params_np, _cfg_kw(jcfg), "none", False)
    for r in ranks:
        assert r["tokens"] == ref_toks == jax_toks
        assert (r["heads"], r["kv_heads"]) == (2, 1) and r["tp"].startswith("TensorParallel(size=2")
        np.testing.assert_allclose(r["logprobs"], ref_lp, atol=1e-5)
        np.testing.assert_allclose(r["logprobs"], jax_lp, atol=1e-5)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_tp2_fused_qwen2_engine_matches_unsharded(pool2, quant):
    """The engines' fused layout with Qwen2 biases (random, so a replicated
    bias would add a whole bias to a slice) under tp = 2."""
    cfg = tl.tiny_lm_config(**TP_CFG, attn_bias=True)
    params = _rand_params(cfg, 21, fuse=True, quant=None if quant == "none" else quant)
    ref_toks, ref_lp = _port_run(params, cfg)
    # the children rebuild the same tree from numpy (int8 leaves as dicts)
    params_np = jax.tree_util.tree_map(lambda t: t.numpy(), params)
    for r in pool2.run("tp_engine", params_np, dataclasses.asdict(cfg)):
        assert r["tokens"] == ref_toks
        np.testing.assert_allclose(r["logprobs"], ref_lp, atol=1e-5)


# ------------------------------------------------- (e) the batched engine

@pytest.fixture(scope="module")
def serving_setup():
    tok = CodecTextTokenizer(codebook_size=1024)
    jcfg = jl.tiny_lm_config(vocab_size=((tok.vocab_size + 7) // 8) * 8, compute_dtype="float32", max_context=256)
    jparams = jl.init_lm_params(jax.random.PRNGKey(0), jcfg)
    prompts = [tok.encode("hello there"), tok.encode("a completely different prompt!"), tok.encode("x"),
               tok.encode("fourth stream")]
    return tok, jcfg, jparams, prompts


def _port_batched(params_np, jcfg, prompts, temps=(0.0,)):
    eng = BatchedDecodeEngine(lm_params_from_numpy(params_np), tl.DuplexLMConfig(**_cfg_kw(jcfg)), batch_size=4,
                              max_context=256, seed=0, device="cpu")
    for row, p in enumerate(prompts):
        eng.set_row_sampler(row, temp=temps[row % len(temps)])
        eng.prefill_row(row, p)
    outs = [[] for _ in prompts]
    for _ in range(2):
        tokens = eng.step([True] * 4, steps=4)
        for r in range(len(prompts)):
            outs[r].extend(tokens[r])
    return outs


def _jax_batched_sharded(jparams, jcfg, prompts):
    """JAX's test_sharded_batched_serving_token_identical run, dp 2 x tp 2."""
    eng = JBatchedEngine(jparams, jcfg, batch_size=4, max_context=256, seed=0)
    jshard_batched(eng, jmake_mesh(dp=2, fsdp=1, tp=2))
    for row, p in enumerate(prompts):
        eng.set_row_sampler(row, temp=0.0)
        eng.prefill_row(row, p)
    outs = [[] for _ in prompts]
    for _ in range(2):
        tokens = eng.step([True] * 4, steps=4)
        for r in range(len(prompts)):
            outs[r].extend(tokens[r])
    return outs


def test_dp2_tp2_batched_serving_matches_unsharded_and_jax(pool4, serving_setup):
    _, jcfg, jparams, prompts = serving_setup
    params_np = _np(jparams)
    ref = _port_batched(params_np, jcfg, prompts)
    assert ref == _jax_batched_sharded(jparams, jcfg, prompts)
    for build in ("shard", "host"):
        ranks = pool4.run("batched", params_np, _cfg_kw(jcfg), prompts, 2, 2, 4, (0.0,), 4, 2, build)
        assert ranks[0]["tokens"] == ref, build
        # rows (0, 2) on ranks 0-1 (tp pair), (2, 2) on ranks 2-3; one KV head each
        assert [r["rows"] for r in ranks] == [(0, 2), (0, 2), (2, 2), (2, 2)]
        assert all(r["kv_heads"] == 1 for r in ranks)
        assert all(r["applied"] == 4 * 2 + 2 for r in ranks[1:])  # 4 samplers, 4 prefills, 2 dispatches
    # sampled rows keep their global row's key: temperature 1.0 unseeded
    mixed = pool4.run("batched", params_np, _cfg_kw(jcfg), prompts, 2, 2, 4, (0.0, 1.0))
    assert mixed[0]["tokens"] == _port_batched(params_np, jcfg, prompts, temps=(0.0, 1.0))
    errors = pool4.run("must_divide", params_np, _cfg_kw(jcfg), 4, 1, 6)
    assert all(e is not None and "must divide" in e for e in errors)


@pytest.mark.parametrize("build", ["shard", "host"])
def test_dp2_batched_serving_matches_unsharded(pool2, serving_setup, build):
    """dp = 2 x tp = 1: each rank decodes its own rows with the whole
    model, greedy and sampled; no cross-rank sum, so the tokens are exact.
    The rank's engine is a whole engine's share, or built for its rows."""
    _, jcfg, jparams, prompts = serving_setup
    params_np = _np(jparams)
    for temps in ((0.0,), (1.0, 0.0)):
        ranks = pool2.run("batched", params_np, _cfg_kw(jcfg), prompts, 2, 1, 4, temps, 4, 2, build)
        assert ranks[0]["tokens"] == _port_batched(params_np, jcfg, prompts, temps=temps)
        assert ranks[1]["rows"] == (2, 2) and ranks[1]["kv_heads"] == 2


# --------------------------------------------------- (f) the server's --mesh

def test_server_mesh_2x2_serves_the_sequential_text(pool4):
    """``server.main(["--mesh", "2x2", ...])`` on 4 gloo ranks answers a
    greedy HTTP completion with the sequential backend's text (JAX's
    test_sharded_backend_end_to_end); the followers stop with the server."""
    res = RealtimeAgentResources(tiny=True, whisper_model=None, llm_n_ctx=16384, device="cpu")
    ref = "".join(CompletionBackend(res.llm, res.tokenizer).generate("hello wor", max_tokens=8, temperature=0.0))
    argv = ["--mesh", "2x2", "--dist_backend", "gloo", "--batch_size", "4", "--serving_context", "256",
            "--tiny", "--device", "cpu"]
    out = pool4.run("serve", argv, "hello wor", 8, timeout=120.0)
    assert out[0] == ref and out[1:] == [None, None, None]


# ----------------------------------------------------- (g) the corpus encode

def test_two_rank_corpus_encode_writes_the_single_rank_files(pool2, tmp_path):
    root = tmp_path / "audio"
    (root / "a").mkdir(parents=True)
    rng = np.random.default_rng(8)
    for i, secs in enumerate((1.5, 1.0, 0.7)):
        write_wav(str(root / "a" / f"m{i}.wav"), 16000, (0.1 * rng.standard_normal(int(secs * 16000))).astype(np.float32))
    write_wav(str(root / "st.wav"), 16000, (0.1 * rng.standard_normal((2, 12000))).astype(np.float32))
    one = tmp_path / "one"
    enc = CorpusEncoder(TorchCodecModel.random_init(tiny_codec_config(), device="cpu"), batch_size=7)
    assert (enc.rank, enc.world) == (0, 1)
    for f in list_audio_files(str(root)):
        enc.encode_file(f, str(root), str(one), stereo=True)
    enc.write_codec_info(str(one))
    two = tmp_path / "two"
    ranks = pool2.run("encode_corpus", str(root), str(two), 7)
    assert [(r["rank"], r["world"]) for r in ranks] == [(0, 2), (1, 2)]
    assert ranks[0]["written"] and ranks[1]["written"]  # both ranks took files
    files = sorted(os.path.relpath(os.path.join(d, f), one) for d, _, fs in os.walk(one) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), two) for d, _, fs in os.walk(two) for f in fs)
    for rel in files:
        assert filecmp.cmp(one / rel, two / rel, shallow=False), rel
