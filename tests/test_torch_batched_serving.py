"""The port's batched decode engine and continuous-batching backend, on the
CPU: mirrors of tests/test_batched_serving.py, and the engine against the
JAX package's.

The contract: N concurrent requests through the batched path produce
exactly the sequences the sequential engine produces one at a time, while
sharing one batched forward a token. Against the JAX ``BatchedDecodeEngine``
on shared tiny f32 weights (converted with models/from_jax): every row's
tokens, greedy, seeded and unseeded at temperature 1.0 (the rows' raw
threefry keys: ``PRNGKey(seed)`` and ``fold_in(base_key, nonce * 997 +
row)``), at ``steps`` 1 and 4, across the 256 -> 512 cache-bucket boundary
and through a slot's re-admission. The two sharded JAX tests become one:
``--mesh`` raises naming its queue item. Every backend's worker and every
server shuts down in ``finally``; every HTTP call carries a timeout.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.lm.batched_engine import BatchedDecodeEngine as JaxBatchedEngine
from realtime_codec_agent_tpu.models import llama as jl
from realtime_codec_agent_tpu_torch.lm.batched_engine import BatchedDecodeEngine
from realtime_codec_agent_tpu_torch.lm.engine import DuplexLMEngine
from realtime_codec_agent_tpu_torch.models import llama as tl
from realtime_codec_agent_tpu_torch.models.from_jax import lm_params_from_numpy
from realtime_codec_agent_tpu_torch.serving import server as tserver
from realtime_codec_agent_tpu_torch.serving.backend import CompletionBackend
from realtime_codec_agent_tpu_torch.serving.batched_backend import BatchedCompletionBackend
from realtime_codec_agent_tpu_torch.tokenization import CodecTextTokenizer
from test_torch_pipeline import one_torch_thread  # noqa: F401 (a module fixture)


@pytest.fixture(scope="module")
def setup():
    tok = CodecTextTokenizer(codebook_size=1024)
    jcfg = jl.tiny_lm_config(vocab_size=((tok.vocab_size + 7) // 8) * 8, compute_dtype="float32", max_context=256)
    jparams = jl.init_lm_params(jax.random.PRNGKey(0), jcfg)
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    return tok, tl.DuplexLMConfig(**dataclasses.asdict(jcfg)), params, jcfg, jparams


def _sequential_greedy(params, cfg, prompt_ids, n):
    eng = DuplexLMEngine(params, cfg, seed=0, device="cpu")
    eng.init_sampler_for_generate(temp=0.0, top_k=0, seed=0)
    out = []
    eng.eval(prompt_ids[:-1])
    tok = prompt_ids[-1]
    for _ in range(n):
        tok = eng.eval_and_sample([tok])
        out.append(tok)
    return out


def test_batched_rows_match_sequential_greedy(setup):
    tok, cfg, params, _, _ = setup
    prompts = [tok.encode("hello there"), tok.encode("a completely different prompt!"), tok.encode("x")]
    n = 8
    refs = [_sequential_greedy(params, cfg, p, n) for p in prompts]

    eng = BatchedDecodeEngine(params, cfg, batch_size=4, max_context=256, seed=0)
    for row, p in enumerate(prompts):
        eng.set_row_sampler(row, temp=0.0)
        eng.prefill_row(row, p)
    active = [True, True, True, False]
    outs = [[] for _ in prompts]
    for _ in range(n):
        tokens = eng.step(active)
        for r in range(len(prompts)):
            outs[r].append(tokens[r])
    assert outs == refs

    # a freed slot can be re-used for a new prompt without disturbing others
    refs2_long = _sequential_greedy(params, cfg, prompts[2], n + 2)
    eng.prefill_row(1, prompts[2])
    eng.set_row_sampler(1, temp=0.0)
    tokens = eng.step([False, True, True, False])
    assert tokens[1] == refs2_long[0]       # fresh prompt decodes from scratch
    assert tokens[2] == refs2_long[n]       # row 2 keeps its own continuation
    more = eng.step([False, True, True, False])
    assert more[1] == refs2_long[1]
    assert more[2] == refs2_long[n + 1]
    # row 0 state untouched while inactive
    assert eng.offsets[0] == len(prompts[0]) - 1 + n


def test_multi_step_dispatch_token_identical(setup):
    """steps=S in one dispatch == S consecutive single steps (same active
    mask): the per-token key/penalty schedule is per-row device state, so
    the batched serving path must not change any sampled token."""
    tok, cfg, params, _, _ = setup
    prompts = [tok.encode("hello there"), tok.encode("zq")]

    def run(steps_list):
        eng = BatchedDecodeEngine(params, cfg, batch_size=2, max_context=256, seed=0)
        for row, p in enumerate(prompts):
            eng.set_row_sampler(row, temp=0.9, top_k=50, repeat_penalty=1.1, seed=row)
            eng.prefill_row(row, p)
        outs = [[] for _ in prompts]
        for s in steps_list:
            tokens = eng.step([True, True], steps=s)
            if s == 1:
                tokens = [[t] for t in tokens]
            for r in range(len(prompts)):
                outs[r].extend(tokens[r])
        return outs

    assert run([1] * 12) == run([4, 4, 4]) == run([8, 4]) == run([12])


def test_batched_seed_reproducible_and_guards(setup):
    tok, cfg, params, _, _ = setup
    backend = BatchedCompletionBackend(BatchedDecodeEngine(params, cfg, batch_size=2, max_context=256, seed=0), tok)
    try:
        a = "".join(backend.generate("hello", max_tokens=8, temperature=1.0, seed=7))
        b = "".join(backend.generate("hello", max_tokens=8, temperature=1.0, seed=7))
        c = "".join(backend.generate("hello", max_tokens=8, temperature=1.0, seed=8))
        assert a == b            # per-request seeds survive slot reuse
        assert a != c or len(a) == 0
        # oversized prompts are rejected on the request thread; the worker
        # (and other requests) keep running
        with pytest.raises(ValueError, match="prompt too long"):
            list(backend.generate("x" * 4000, max_tokens=4))
        assert "".join(backend.generate("hello", max_tokens=4, temperature=0.0))
        # max_tokens is capped by the serving cache: the stream ends with
        # finish_reason length instead of decoding past the cache
        "".join(backend.generate("y" * 100, max_tokens=100000, temperature=0.0))
        assert backend.last_finish_reason in ("stop", "length")
    finally:
        backend.shutdown()


def test_batched_backend_concurrent_requests(setup):
    tok, cfg, params, _, _ = setup
    seq_backend = CompletionBackend(DuplexLMEngine(params, cfg, seed=0, device="cpu"), tok)
    prompts = ["hello wor", "abcd", "zq"]
    refs = ["".join(seq_backend.generate(p, max_tokens=10, temperature=0.0)) for p in prompts]

    backend = BatchedCompletionBackend(BatchedDecodeEngine(params, cfg, batch_size=4, max_context=256, seed=0), tok)
    try:
        results = {}

        def run(p):
            results[p] = "".join(backend.generate(p, max_tokens=10, temperature=0.0))
            results[p + "/reason"] = backend.last_finish_reason

        threads = [threading.Thread(target=run, args=(p,)) for p in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert [results[p] for p in prompts] == refs
        assert all(results[p + "/reason"] in ("stop", "length") for p in prompts)
        assert backend.dispatches > 0 and backend.host_secs > 0

        # stop strings apply per request
        stop = refs[0][2:4]
        cut = "".join(backend.generate(prompts[0], max_tokens=10, temperature=0.0, stop=[stop]))
        assert cut == refs[0][: refs[0].find(stop)]
        assert backend.last_finish_reason == "stop"
    finally:
        backend.shutdown()


def test_batched_backend_behind_http_server(setup):
    """The OpenAI-compatible server runs unchanged over the batched backend."""
    from realtime_codec_agent_tpu_torch.serving.client import CompletionsClient
    from realtime_codec_agent_tpu_torch.serving.server import CompletionServer

    tok, cfg, params, _, _ = setup
    backend = BatchedCompletionBackend(BatchedDecodeEngine(params, cfg, batch_size=2, max_context=256, seed=0), tok)
    server = CompletionServer(backend, host="127.0.0.1", port=0)
    server.start_background()
    try:
        client = CompletionsClient(base_url=f"http://127.0.0.1:{server.port}/v1", timeout=60)
        ref = _sequential_greedy(params, cfg, tok.encode("xyz"), 6)
        text, reason = client.complete_with_reason("xyz", max_tokens=6, temperature=0.0)
        assert text == tok.decode(ref, skip_special_tokens=False)
        assert reason in ("stop", "length")
    finally:
        server.shutdown()
        backend.shutdown()


def test_bucket_boundary_crossing_token_identical(setup):
    """The occupancy-bucketed cache read changes at powers of two; a row
    decoding ACROSS a bucket boundary (256 -> 512 here) must produce exactly
    the sequential engine's tokens: the bucket bounds traffic, never
    attention content."""
    tok, cfg, params, _, _ = setup
    cfg_big = dataclasses.replace(cfg, max_context=1024)
    rng = np.random.default_rng(7)
    prompt = [int(t) for t in rng.integers(5, 200, size=250)]
    n = 16  # crosses offset 256 mid-decode
    ref = _sequential_greedy(params, cfg_big, prompt, n)

    eng = BatchedDecodeEngine(params, cfg_big, batch_size=2, max_context=1024, seed=0)
    eng.set_row_sampler(0, temp=0.0)
    eng.prefill_row(0, prompt)
    assert eng._cache_bucket() == 256
    out = []
    for _ in range(n // 4):
        out.extend(eng.step([True, False], steps=4)[0])
    assert eng._cache_bucket() == 512  # the boundary was crossed
    assert out == ref


def test_mesh_serving_raises():
    """Multi-device serving (the JAX server's --mesh, its two sharded tests)
    is not ported: the server's entry point raises naming the queue item
    before it builds anything."""
    with pytest.raises(NotImplementedError, match=r"\[12\] parallel"):
        tserver.main(["--mesh", "2x2", "--batch_size", "4", "--tiny", "--device", "cpu"])


def test_prewarm_leaves_state(setup):
    """``prewarm`` (every cache-bucket variant, all rows inactive) leaves
    every row's device state, the host mirrors and the attended cache as
    they were: decoding after it gives the tokens of an engine without it."""
    tok, cfg, params, _, _ = setup
    cfg_big = dataclasses.replace(cfg, max_context=1024)

    def run(prewarm):
        eng = BatchedDecodeEngine(params, cfg_big, batch_size=2, max_context=1024, seed=0)
        for row, p in enumerate((tok.encode("hello there"), tok.encode("abc"))):
            eng.set_row_sampler(row, temp=1.0, seed=3 + row)
            eng.prefill_row(row, p)
        eng.step([True, True], steps=2)
        before = {k: v.clone() for k, v in eng.dstate.items()}
        k_before = eng._k[:, :, :-1].clone()
        offsets = eng.offsets.copy()
        if prewarm:
            eng.prewarm(steps_list=(1, 4))
            for k, v in before.items():
                assert torch.equal(eng.dstate[k], v), k
            assert torch.equal(eng._k[:, :, :-1], k_before)  # only the trash slot took writes
            assert (eng.offsets == offsets).all()
        return eng.step([True, True], steps=4)

    assert run(True) == run(False)


@pytest.mark.parametrize("steps", [1, 4])
def test_rows_match_jax(setup, steps):
    """Every row equals the JAX batched engine's token for token: greedy,
    seeded and unseeded at temperature 1.0 (top-k, top-p, penalties), one
    row crossing the 256 -> 512 cache bucket, then a slot re-admitted with a
    fresh unseeded key."""
    tok, cfg, params, jcfg, jparams = setup
    cfg_big = dataclasses.replace(cfg, max_context=1024)
    jcfg_big = dataclasses.replace(jcfg, max_context=1024)
    rng = np.random.default_rng(11)
    prompts = [[int(t) for t in rng.integers(5, 200, size=250)], tok.encode("hello there"),
               tok.encode("a completely different prompt!")]
    samplers = [dict(temp=0.0), dict(temp=1.0, top_k=50, repeat_penalty=1.1, seed=5),
                dict(temp=1.0, top_p=0.9, presence_penalty=0.5)]
    active = [True, True, True, False]

    def run(engine):
        for row, (p, sampler) in enumerate(zip(prompts, samplers)):
            engine.set_row_sampler(row, **sampler)
            engine.prefill_row(row, p)
        outs = [[] for _ in prompts]

        def decode(n, mask):
            for _ in range(n // steps):
                toks = engine.step(mask, steps=steps)
                for r in range(len(prompts)):
                    if mask[r]:
                        outs[r].extend([toks[r]] if steps == 1 else toks[r])

        decode(16, active)
        engine.set_row_sampler(1, temp=1.0, top_k=20)  # unseeded: a fresh stream
        engine.prefill_row(1, prompts[2])
        decode(8, active)
        return outs

    want = run(JaxBatchedEngine(jparams, jcfg_big, batch_size=4, max_context=1024, seed=0))
    got = run(BatchedDecodeEngine(params, cfg_big, batch_size=4, max_context=1024, seed=0))
    assert got == want
