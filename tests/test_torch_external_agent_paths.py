"""The port's agent on its external-service paths, on the CPU, against the
JAX agent: mirrors of tests/test_external_agent_paths.py.

The external-LLM response (sentences from an OpenAI-compatible SSE stream
spliced as marked external ranges between constrained native tokens) and
the external-TTS substitution (codec chunks from the TTS server swapped in
for the duplex LM's agent tokens, with interrupt scoring) run on the scripted
fake LM of tests/fakes.py and a tiny f32 codec whose weights the two
packages share (converted with models/from_jax). Each package's agent talks
to its own package's TTS server; the fake OpenAI server is
tests/test_serving.py's. The port's transcript and ``input_ids`` equal the
JAX agent's. Every server runs on 127.0.0.1 with an ephemeral port and shuts
down in ``finally``; the clients' HTTP calls carry timeouts.
"""
import dataclasses
import threading
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest

from realtime_codec_agent_tpu.agent.agent import RealtimeAgent as JaxAgent
from realtime_codec_agent_tpu.agent.config import RealtimeAgentConfig as JaxConfig
from realtime_codec_agent_tpu.audio_tokenizer import AudioTokenizer as JaxAudioTokenizer
from realtime_codec_agent_tpu.models.codec import JaxCodecModel
from realtime_codec_agent_tpu.models.codec import tiny_codec_config as jax_tiny_codec_config
from realtime_codec_agent_tpu.serving import tts_server as jtts
from realtime_codec_agent_tpu.tokenization import CodecTextTokenizer as JaxTextTokenizer
from realtime_codec_agent_tpu_torch.agent.agent import RealtimeAgent
from realtime_codec_agent_tpu_torch.agent.config import RealtimeAgentConfig
from realtime_codec_agent_tpu_torch.audio_tokenizer import AudioTokenizer
from realtime_codec_agent_tpu_torch.models import codec as tcodec
from realtime_codec_agent_tpu_torch.models.from_jax import codec_params_from_numpy
from realtime_codec_agent_tpu_torch.serving import tts_server as ttts
from realtime_codec_agent_tpu_torch.tokenization import CodecTextTokenizer
from tests.fakes import FakeLMEngine, FakeResources
from tests.test_serving import _FakeOpenAIHandler


@pytest.fixture(scope="module")
def codecs():
    """The JAX tiny f32 codec and the port's over the same weights."""
    jcfg = jax_tiny_codec_config(compute_dtype="float32")
    jcodec = JaxCodecModel.random_init(jcfg, seed=0)
    params = codec_params_from_numpy(jax.tree_util.tree_map(np.asarray, jcodec.params))
    tcodec_model = tcodec.TorchCodecModel(params, tcodec.CodecConfig(**dataclasses.asdict(jcfg)), "cpu")
    return jcodec, tcodec_model


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _close(httpd):
    httpd.shutdown()
    httpd.server_close()


def _agents(codecs, fake_default, jax_config=(), **config):
    """(JAX agent, its fake LM, port agent, its fake LM, port tokenizer) on
    the same config (``jax_config`` overrides entries for the JAX agent)."""
    jcodec, tcodec_model = codecs
    jtok = JaxTextTokenizer(codebook_size=jcodec.codebook_size)
    ttok = CodecTextTokenizer(codebook_size=tcodec_model.codebook_size)
    jfake = FakeLMEngine(default_token=fake_default(ttok))
    tfake = FakeLMEngine(default_token=fake_default(ttok))
    jagent = JaxAgent(resources=FakeResources(JaxAudioTokenizer(codec_model=jcodec), jtok, jfake),
                      config=JaxConfig(**{**config, **dict(jax_config)}))
    tagent = RealtimeAgent(resources=FakeResources(AudioTokenizer(codec_model=tcodec_model), ttok, tfake),
                           config=RealtimeAgentConfig(**config))
    return jagent, jfake, tagent, tfake, ttok


def chunk_audio():
    return np.zeros(1600, dtype=np.float32)


def test_external_llm_coordinated_response(codecs):
    """Response event with use_external_llm: the native LM's content tokens
    are suppressed (constrained), the external LLM's sentences are spliced
    in as marked external ranges, and the transcript records the response;
    the port's transcript, ids and outgoing messages equal the JAX agent's."""
    httpd = _serve(ThreadingHTTPServer(("127.0.0.1", 0), _FakeOpenAIHandler))
    try:
        config = dict(
            use_whisper=False,
            agent_opening_text=None,
            force_trans_after_inactivity_secs=0.0,
            force_response_after_inactivity_secs=0.0,
            use_external_llm=True,
            external_llm_base_url=f"http://127.0.0.1:{httpd.server_address[1]}/v1",
            external_llm_model="fake-model",
            external_llm_api_key="k",
        )
        jagent, jfake, agent, fake, text_tok = _agents(codecs, lambda t: t.codec_vocab_start + 7, **config)

        agent_sp = text_tok.encode(" A", add_special_tokens=False)[0]
        end_audio = text_tok.convert_tokens_to_ids("<|end_audio|>")
        start_audio = text_tok.convert_tokens_to_ids("<|audio|>")
        audio_tok = text_tok.codec_vocab_start + 21
        colon = text_tok.encode(":", add_special_tokens=False)
        content = text_tok.encode(" x", add_special_tokens=False)
        # response event: end_audio -> agent speaker -> ":" -> native content
        # (constrained: dropped) -> coordinated external sentences -> the
        # native closes each splice; final <|audio|> returns to audio mode
        script = [audio_tok, end_audio, agent_sp] + colon + content + [start_audio] + [audio_tok] * 4
        outs = []
        for a, f in ((jagent, jfake), (agent, fake)):
            # the speculative speaker probe must point at the AGENT, else the
            # coordinated path defers to the user
            f.speaker_probs = (0.9, 0.1)
            a.process_audio(chunk_audio())  # enter audio mode
            f.script = list(script)
            outs.append(np.asarray(a.process_audio(chunk_audio())))
        assert outs[1].shape == (1600,)

        assert len(agent.transcript) == 1
        entry = agent.transcript[0]
        assert entry["speaker"] == "A"
        assert "hello there" in entry["text"]
        assert entry["text_with_external_markers"].count(agent.config.external_marker_token) >= 2
        assert "hello there" in agent.get_sequence_str()
        msgs = agent.get_external_llm_messages()
        assert msgs and msgs[0]["role"] == "system"

        assert agent.transcript == jagent.transcript
        assert agent.input_ids == jagent.input_ids
        assert fake.eval_calls == jfake.eval_calls
        assert msgs == jagent.get_external_llm_messages()
        np.testing.assert_allclose(outs[1], outs[0], atol=1e-4)
        assert agent.get_audio_history().shape == (2, 2 * 1600)
    finally:
        _close(httpd)


def test_external_tts_substitution(codecs):
    """Live TTS substitution: the agent pulls codec chunks from the TTS
    server (opening-text stream prepped at reset), swaps them in for the
    duplex LM's agent tokens via set_audio_tokens + KV recompute, and scores
    interruptions; each package's agent against its own package's TTS
    server gives the same ids and interrupt scores."""
    jcodec, tcodec_model = codecs
    jhttpd = _serve(jtts.make_http_server(
        jtts.TTSServer(jtts.SyntheticTTSEngine(), JaxAudioTokenizer(codec_model=jcodec)), "127.0.0.1", 0))
    thttpd = _serve(ttts.make_http_server(
        ttts.TTSServer(ttts.SyntheticTTSEngine(), AudioTokenizer(codec_model=tcodec_model)), "127.0.0.1", 0))
    try:
        config = dict(
            use_whisper=False,
            agent_opening_text="hello there friend",
            force_trans_after_inactivity_secs=0.0,
            force_response_after_inactivity_secs=0.0,
            use_external_tts=True,
        )
        # each agent on its own server from the start: a server's streaming
        # encode context is shared by every stream it serves
        jagent, _, agent, fake, text_tok = _agents(
            codecs, lambda t: t.codec_vocab_start + 7,
            jax_config={"external_tts_server_url": f"http://127.0.0.1:{jhttpd.server_address[1]}"},
            external_tts_server_url=f"http://127.0.0.1:{thttpd.server_address[1]}", **config)

        subbed, jsubbed = [], []
        for _ in range(6):
            for a, rows in ((jagent, jsubbed), (agent, subbed)):
                a.process_audio(chunk_audio())
                frames = a.chunk_size_frames_per_channel
                idx = a.audio_tokens_idx[-2 * frames :: 2]
                rows.append([a.input_ids[i] for i in idx])

        assert len(agent.stats.tts_interrupt_score) == 6
        default = fake.default_token
        assert any(any(t != default for t in chunk_toks) for chunk_toks in subbed)
        assert all(t >= text_tok.codec_vocab_start for chunk_toks in subbed for t in chunk_toks)

        assert subbed == jsubbed
        assert agent.input_ids == jagent.input_ids
        assert agent.transcript == jagent.transcript
        np.testing.assert_allclose(agent.stats.tts_interrupt_score._ring, jagent.stats.tts_interrupt_score._ring,
                                   rtol=1e-5)
    finally:
        _close(jhttpd)
        _close(thttpd)
