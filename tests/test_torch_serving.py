"""The port's completion and TTS serving, on the CPU: mirrors of
tests/test_serving.py, and the port against the JAX package.

The sequential completion backend (prefix reuse, stop-string holdback), the
OpenAI-compatible HTTP server with the port's stdlib client (and its chat
endpoint, which the agent's external-LLM client reads), the TTS server's
codec-chunk line stream through the port's TTS client, and the external
LLM client's SSE sentence joining. Against the JAX package on shared tiny
f32 weights (converted with models/from_jax): ``CompletionBackend``'s text
for a seeded prompt, and the TTS server's chunks for the same text. Every
server runs on 127.0.0.1 with an ephemeral port and shuts down in
``finally``; every HTTP call carries a timeout.
"""
import dataclasses
import threading
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest

from realtime_codec_agent_tpu.audio_tokenizer import AudioTokenizer as JaxAudioTokenizer
from realtime_codec_agent_tpu.lm.engine import DuplexLMEngine as JaxEngine
from realtime_codec_agent_tpu.models import llama as jl
from realtime_codec_agent_tpu.models.codec import JaxCodecModel
from realtime_codec_agent_tpu.models.codec import tiny_codec_config as jax_tiny_codec_config
from realtime_codec_agent_tpu.serving import tts_server as jtts
from realtime_codec_agent_tpu.serving.backend import CompletionBackend as JaxBackend
from realtime_codec_agent_tpu.tokenization import CodecTextTokenizer as JaxTextTokenizer
from realtime_codec_agent_tpu_torch.audio_tokenizer import AudioTokenizer
from realtime_codec_agent_tpu_torch.lm.engine import DuplexLMEngine
from realtime_codec_agent_tpu_torch.models import codec as tcodec
from realtime_codec_agent_tpu_torch.models import llama as tl
from realtime_codec_agent_tpu_torch.models.from_jax import codec_params_from_numpy, lm_params_from_numpy
from realtime_codec_agent_tpu_torch.serving.backend import CompletionBackend
from realtime_codec_agent_tpu_torch.serving.client import CompletionsClient
from realtime_codec_agent_tpu_torch.serving import tts_server as ttts
from realtime_codec_agent_tpu_torch.serving.server import CompletionServer
from realtime_codec_agent_tpu_torch.tokenization import CodecTextTokenizer
from test_torch_pipeline import one_torch_thread  # noqa: F401 (a module fixture)
from tests.test_serving import _FakeOpenAIHandler


@pytest.fixture(scope="module")
def lm():
    """Tiny f32 LM weights, in the JAX layout and converted to the port's."""
    tok = CodecTextTokenizer(codebook_size=1024)
    jcfg = jl.tiny_lm_config(vocab_size=((tok.vocab_size + 7) // 8) * 8, max_context=512, compute_dtype="float32")
    jparams = jl.init_lm_params(jax.random.PRNGKey(0), jcfg)
    tparams = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, tl.DuplexLMConfig(**dataclasses.asdict(jcfg)), tparams


@pytest.fixture(scope="module")
def backend(lm):
    _, _, tcfg, tparams = lm
    return CompletionBackend(DuplexLMEngine(tparams, tcfg, device="cpu"), CodecTextTokenizer(codebook_size=1024))


@pytest.fixture(scope="module")
def codecs():
    """The JAX tiny f32 codec and the port's over the same weights."""
    jcfg = jax_tiny_codec_config(compute_dtype="float32")
    jcodec = JaxCodecModel.random_init(jcfg, seed=0)
    params = codec_params_from_numpy(jax.tree_util.tree_map(np.asarray, jcodec.params))
    return jcodec, tcodec.TorchCodecModel(params, tcodec.CodecConfig(**dataclasses.asdict(jcfg)), "cpu")


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _close(httpd):
    httpd.shutdown()
    httpd.server_close()


def test_backend_deterministic_and_prefix_reuse(backend):
    out1 = "".join(backend.generate("hello wor", max_tokens=8, temperature=0.0))
    evals_before = backend.engine.n_tokens
    out2 = "".join(backend.generate("hello wor", max_tokens=8, temperature=0.0))
    assert out1 == out2
    assert len(out1) > 0
    # the second call reused the cached prefix: it evaled only the suffix
    assert backend.engine.n_tokens == evals_before
    # prewarm touches no engine state
    ids, n = list(backend.engine._input_ids), backend.engine.n_tokens
    backend.prewarm()
    assert (backend.engine._input_ids, backend.engine.n_tokens) == (ids, n)


def test_backend_stop_string_holdback(backend):
    # greedy continuation, then re-run with a stop string taken from the
    # middle of that continuation: output must cut exactly before it and the
    # streamed deltas must never leak any part of the stop string
    full = "".join(backend.generate("abcd", max_tokens=12, temperature=0.0))
    assert len(full) >= 4
    stop = full[2:4]
    deltas = list(backend.generate("abcd", max_tokens=12, temperature=0.0, stop=[stop]))
    joined = "".join(deltas)
    assert joined == full[: full.find(stop)]
    assert backend.last_finish_reason == "stop"
    for i in range(1, len(deltas)):
        assert stop not in "".join(deltas[:i])


def test_completion_server_round_trip(backend):
    server = CompletionServer(backend, host="127.0.0.1", port=0)
    server.start_background()
    try:
        client = CompletionsClient(base_url=f"http://127.0.0.1:{server.port}/v1", timeout=60)
        assert client.get_model_name() == backend.model_name
        ref = "".join(backend.generate("xyz", max_tokens=6, temperature=0.0))
        text, reason = client.complete_with_reason("xyz", max_tokens=6, temperature=0.0)
        assert text == ref
        assert reason in ("stop", "length")
        # streaming deltas concatenate to the same completion
        chunks = list(client.stream_completion("xyz", max_tokens=6, temperature=0.0))
        assert "".join(c for c in chunks if c) == ref
        # the chat endpoint (the agent's external-LLM client reads it): the
        # messages' prompt, streamed as deltas without special-token strings
        from realtime_codec_agent_tpu_torch.agent.external_llm_client import ExternalLLMClient
        from realtime_codec_agent_tpu_torch.serving.server import _SPECIAL_TOKEN, chat_prompt

        llm = ExternalLLMClient(api_key="k", base_url=f"http://127.0.0.1:{server.port}/v1")
        assert llm.model == backend.model_name
        transcript = [{"speaker": "B", "text": "hi", "text_with_external_markers": "hi"}]
        llm.prep_stream(transcript, additional_instructions=None, top_p=1.0, max_tokens=12)
        got = []
        while (c := llm.next_chunk()) is not None:
            got.append(c)
        llm.close_stream(blocking=True)
        prompt = chat_prompt(llm.get_messages(transcript, None))
        want = _SPECIAL_TOKEN.sub("", "".join(backend.generate(prompt, max_tokens=12, top_p=1.0)))
        assert "".join(got) == want
    finally:
        server.shutdown()


def test_tts_server_stream_round_trip():
    from realtime_codec_agent_tpu_torch.agent.external_tts_client import ExternalTTSClient
    from realtime_codec_agent_tpu_torch.serving.tts_server import (
        SyntheticTTSEngine,
        TTSServer,
        make_http_server,
        sanitize_text_for_tts,
    )

    at = AudioTokenizer(codec_model=tcodec.TorchCodecModel.random_init(tcodec.tiny_codec_config(), seed=0))
    httpd = _serve(make_http_server(TTSServer(SyntheticTTSEngine(), at), host="127.0.0.1", port=0))
    try:
        client = ExternalTTSClient(server_url=f"http://127.0.0.1:{httpd.server_address[1]}", chunk_size_secs=0.1)
        # enrollment accepted
        sr = at.sampling_rate
        enrollment = (sr, (np.sin(np.arange(sr) / 40.0) * 0.3).astype(np.float32))
        client.set_voice_enrollment(enrollment, "test voice")
        client.prep_stream("hello there (0.4) how are you")
        chunks = []
        while (c := client.next_chunk()) is not None:
            chunks.append(c)
        assert len(chunks) >= 5
        # every line is one 100 ms chunk of codec-unicode chars (5 frames)
        for c in chunks:
            assert len(c) == 5
            assert all(ord(ch) >= at.unicode_offset for ch in c)
        # the lines decode to audio of exactly chunk length
        (sr_out, audio), _, _ = at.detokenize_audio(chunks[0])
        assert sr_out == sr
    finally:
        _close(httpd)

    # sanitizer behavior (reference tts_server.py:21-30)
    assert sanitize_text_for_tts("so (0.3) yeah [laughs] &=coughs ok") == "so ... yeah ok"
    assert sanitize_text_for_tts("hhh. well xxx") == "well"


def test_external_llm_client_sse_sentences():
    from realtime_codec_agent_tpu_torch.agent.external_llm_client import ExternalLLMClient

    httpd = _serve(ThreadingHTTPServer(("127.0.0.1", 0), _FakeOpenAIHandler))
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}/v1"
        assert ExternalLLMClient.get_models("k", base) == ["fake-model"]
        client = ExternalLLMClient(api_key="k", base_url=base, model="fake-model")
        transcript = [{"speaker": "B", "text": "hi", "text_with_external_markers": "hi"}]
        client.prep_stream(transcript, additional_instructions=None)
        sents = []
        while (s := client.next_sentence()) is not None:
            sents.append(s)
        # sentence joining on punctuation (reference external_llm_client.py:142-153)
        assert " ".join(sents) == "Hello there. How are you? Good."
        assert sents[0].rstrip().endswith(".")
        client.close_stream(blocking=True)
    finally:
        _close(httpd)


def test_tts_server_flushes_utterance_tail():
    """The final partial audio chunk of an utterance is zero-padded and
    yielded rather than dropped (the reference clips it)."""
    from realtime_codec_agent_tpu_torch.serving.tts_server import SyntheticTTSEngine, TTSServer

    at = AudioTokenizer(codec_model=tcodec.TorchCodecModel.random_init(tcodec.tiny_codec_config(), seed=0))
    chunks = list(TTSServer(SyntheticTTSEngine(), at).generate_chunks("s1", "hi", 0.1))
    # total synthesized samples for "hi": 2*0.045s*16k=1440 + 480 pad = 1920
    # -> one full chunk + a flushed padded tail
    assert len(chunks) == 2
    assert all(len(c) == 5 for c in chunks)


def test_backend_matches_jax(lm):
    """The port's sequential backend gives the JAX backend's text for one
    prompt, seeded at temperature 1.0 with penalties, and greedy with a
    stop string."""
    jcfg, jparams, tcfg, tparams = lm
    jb = JaxBackend(JaxEngine(jparams, jcfg), JaxTextTokenizer(codebook_size=1024))
    tb = CompletionBackend(DuplexLMEngine(tparams, tcfg, device="cpu"), CodecTextTokenizer(codebook_size=1024))
    kwargs = dict(max_tokens=16, temperature=1.0, top_p=0.9, seed=1234, repeat_penalty=1.1, presence_penalty=0.3)
    want = "".join(jb.generate("hello there, how", **kwargs))
    assert "".join(tb.generate("hello there, how", **kwargs)) == want
    assert tb.last_finish_reason == jb.last_finish_reason
    greedy = "".join(jb.generate("abcd", max_tokens=12, temperature=0.0))
    stop = greedy[3:5]
    assert "".join(tb.generate("abcd", max_tokens=12, temperature=0.0)) == greedy
    assert "".join(tb.generate("abcd", max_tokens=12, temperature=0.0, stop=[stop])) == "".join(
        jb.generate("abcd", max_tokens=12, temperature=0.0, stop=[stop]))


def test_tts_server_chunks_match_jax(codecs):
    """The port's TTS server streams the JAX TTS server's codes for the same
    text and codec weights, chunk for chunk (the utterance tail included)."""
    jcodec, tcodec_model = codecs
    text = "well hello there (0.3) how are you doing today [laughs]"
    want = list(jtts.TTSServer(jtts.SyntheticTTSEngine(), JaxAudioTokenizer(codec_model=jcodec))
                .generate_chunks("s", text, 0.1))
    got = list(ttts.TTSServer(ttts.SyntheticTTSEngine(), AudioTokenizer(codec_model=tcodec_model))
               .generate_chunks("s", text, 0.1))
    assert len(want) >= 10
    assert got == want

