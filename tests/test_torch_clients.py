"""The port's client side on the CPU: the demos, the headless benchmark, the
self-play client, the codec streaming round trip, the enrollment selector,
the FastRTC handler, the RTF plot and the package's public surface, each
beside the root script or JAX function it ports where there is one.

- Mirrors of tests/test_demos.py (3), test_tools.py's external-TTS and
  enrollment-selector tests, and test_native_audio.py's FastRTC handler test.
- ``synthetic_speech``, ``minsec_to_secs`` and ``select_audio`` equal the
  root scripts' outputs exactly; ``stream_codes`` on a tiny f32 codec
  carried across from JAX gives JAX's code string exactly and its audio
  within 1e-5; ``build_plot`` draws JAX's lines and labels.
- Every client module parses its flags, and every port module imports in a
  fresh interpreter where gradio, fastrtc and matplotlib cannot be
  imported."""
import dataclasses
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from realtime_codec_agent_tpu_torch.utils.audio_io import read_audio, write_wav

from test_torch_pipeline import one_torch_thread  # noqa: F401  (module fixture)

CLIENTS = ["cli_benchmark", "inference_client_self_play", "inference_client_self_play_debug",
           "inference_client_fastrtc_v2", "inference_client_debug_v2", "run_demo", "run_demo_asr",
           "run_demo_tts", "run_demo_external_tts", "run_stream_codes", "run_enrollment_selector"]


# ------------------------------------------------------- tests/test_demos.py

def test_run_demo_continuation(tmp_path, monkeypatch):
    """The demo's WAV holds the audio of every codec code of the completion
    (random tiny weights put text tokens between them, so the length is
    counted from the completion rather than from --seconds)."""
    import argparse

    from realtime_codec_agent_tpu_torch import run_demo

    out = str(tmp_path / "demo.wav")
    monkeypatch.chdir(tmp_path)
    run_demo.main(["--in_process", "--tiny", "--device", "cpu", "--seconds", "0.5", "--output", out,
                   "--text_prompt", " A: hi"])
    sr, audio = read_audio(out)
    assert sr == 16000

    args = argparse.Namespace(in_process=True, llm_model_path=None, tiny=True, device="cpu")
    client, tok = run_demo.build_client_and_tokenizer(args)
    *_, (gen_sr, gen_audio, text) = run_demo.generate_audio(client, tok, text_prompt=" A: hi", seconds=0.5, seed=42)
    n_codes = len(run_demo.codec_chars(text, tok))
    assert gen_sr == sr and n_codes > 0
    assert gen_audio.shape[-1] >= n_codes * tok.codec_model.config.hop_length
    # the WAV holds int16 (written x 32767, read / 32768), clipped to [-1, 1]
    np.testing.assert_allclose(audio, np.clip(gen_audio[0], -1.0, 1.0), atol=1e-4)


def test_run_demo_asr(tmp_path, capsys):
    from realtime_codec_agent_tpu_torch import run_demo_asr

    sr = 16000
    wav = str(tmp_path / "in.wav")
    write_wav(wav, sr, (0.2 * np.sin(np.arange(sr) / 25.0)).astype(np.float32))
    run_demo_asr.main(["--in_process", "--tiny", "--device", "cpu", "--audio_file", wav])
    assert "<|audio|>" in capsys.readouterr().out


def test_run_demo_tts(tmp_path):
    from realtime_codec_agent_tpu_torch import run_demo_tts

    out = str(tmp_path / "tts.wav")
    run_demo_tts.main(["--in_process", "--tiny", "--device", "cpu", "--transcript", "A: hello\nB: hi there",
                       "--output", out])
    sr, audio = read_audio(out)
    assert sr == 16000
    assert audio.shape[-1] > 0


# --------------------------------------------------------- tests/test_tools.py

def test_run_demo_external_tts_pipeline():
    """The headless external-TTS demo against the port's in-process TTS
    server: enrollment + two lines of text -> one crossfaded waveform."""
    from realtime_codec_agent_tpu_torch.audio_tokenizer import AudioTokenizer
    from realtime_codec_agent_tpu_torch.models.codec import TorchCodecModel, tiny_codec_config
    from realtime_codec_agent_tpu_torch.run_demo_external_tts import tts_pipeline
    from realtime_codec_agent_tpu_torch.serving.tts_server import SyntheticTTSEngine, TTSServer, make_http_server

    codec = TorchCodecModel.random_init(tiny_codec_config(), seed=0, device="cpu")
    httpd = make_http_server(TTSServer(SyntheticTTSEngine(), AudioTokenizer(codec_model=codec)), "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        client_at = AudioTokenizer(codec_model=codec)
        sr = client_at.sampling_rate
        enrollment = (sr, 0.2 * np.sin(np.arange(sr) / 20.0).astype(np.float32))
        result = tts_pipeline(client_at, f"http://127.0.0.1:{httpd.server_address[1]}", enrollment, "test voice",
                              "hello there.\nhow are you?")
        assert result is not None
        out_sr, audio = result
        assert out_sr == sr
        assert audio.shape[-1] >= sr  # at least a second of audio came back
        assert np.isfinite(audio).all()
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_enrollment_selector_minsec():
    import run_enrollment_selector as jsel
    from realtime_codec_agent_tpu_torch.run_enrollment_selector import minsec_to_secs, select_audio

    assert minsec_to_secs(1.30) == pytest.approx(90.0)
    assert minsec_to_secs(0.05) == pytest.approx(5.0)
    with pytest.raises(ValueError):
        minsec_to_secs(1.75)
    for v in (0.0, 0.05, 0.3, 1.30, 2.59, 10.01):
        assert minsec_to_secs(v) == jsel.minsec_to_secs(v)

    sr = 100
    stereo = np.stack([np.arange(1000.0), -np.arange(1000.0)], axis=1)
    sel, c1, c2 = select_audio((sr, stereo), 0.01, 0.03)
    assert sel[1].shape == (200, 2)
    np.testing.assert_array_equal(c1[1], stereo[100:300, 0])
    mono = np.arange(1000.0)
    for audio, (start, end) in [((sr, stereo), (0.01, 0.03)), ((sr, stereo), (0.0, 0.0)),
                                ((sr, mono), (0.02, 0.05)), (None, (0.0, 0.01))]:
        got, want = select_audio(audio, start, end), jsel.select_audio(audio, start, end)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert g[0] == w[0]
                np.testing.assert_array_equal(g[1], w[1])


# -------------------------------------------------- tests/test_native_audio.py

def test_fastrtc_handler_streaming_resample():
    """The live client's mic path: 48 kHz frames resample statefully to the
    codec rate and chunk at exactly 1600 samples, queued as the bare arrays
    the port's child takes."""
    from realtime_codec_agent_tpu_torch.inference_client_fastrtc_v2 import AgentHandler

    class FakeAgentProc:
        def __init__(self):
            self.inputs = []

        def get_info(self):
            class I:
                sampling_rate = 16000
                chunk_size_samples = 1600
            return I()

        def queue_input(self, item):
            self.inputs.append(item)

    fake = FakeAgentProc()
    h = AgentHandler(fake)
    sr = 48000
    t = np.arange(sr) / sr  # 1 s of mic audio in 20 ms frames
    mic = (8000 * np.sin(2 * np.pi * 300 * t)).astype(np.int16)
    frame = sr // 50
    for i in range(50):
        h.receive((sr, mic[i * frame : (i + 1) * frame]))
    # 1 s at 16 kHz = 10 chunks of 1600 (minus filter delay, at least 9)
    assert len(fake.inputs) >= 9
    for chunk in fake.inputs:
        assert isinstance(chunk, np.ndarray)
        assert chunk.shape == (1600,)
        assert chunk.dtype == np.float32
    # the resampled audio still carries the 300 Hz tone (not noise/zeros)
    joined = np.concatenate(fake.inputs)
    assert np.abs(joined).max() > 0.1
    spec = np.abs(np.fft.rfft(joined))
    peak_hz = np.argmax(spec) * 16000 / len(joined)
    assert 280 < peak_hz < 320


# --------------------------------------------------------- the port's clients

def test_synthetic_speech_matches_root_script():
    import cli_benchmark as jcli
    from realtime_codec_agent_tpu_torch.cli_benchmark import synthetic_speech

    for secs, sr, seed in [(2.0, 16000, 42), (0.37, 16000, 0), (1.0, 24000, 7)]:
        got, want = synthetic_speech(secs, sr, seed=seed), jcli.synthetic_speech(secs, sr, seed=seed)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_cli_benchmark_writes_artifacts(tmp_path, capsys):
    from realtime_codec_agent_tpu_torch import cli_benchmark

    out = cli_benchmark.main(["--tiny", "--secs", "2", "--device", "cpu", "--audio_only",
                              "--output_dir", str(tmp_path)])
    printed = capsys.readouterr().out
    assert "RTF=" in printed
    for key in ("transcript", "sequence", "audio"):
        assert os.path.exists(out[key]), key
    assert "<|audio|>" in open(out["sequence"]).read()
    sr, audio = read_audio(out["audio"])
    assert sr == 16000 and audio.shape == (2, 32000)
    assert len(out["plots"]) == 4 and all(os.path.getsize(p) > 0 for p in out["plots"])


def test_self_play_inproc_headless(tmp_path):
    from realtime_codec_agent_tpu_torch import inference_client_self_play as sp

    out = sp.main(["--inproc", "--headless", "--tiny", "--device", "cpu", "--secs", "0.5",
                   "--output_dir", str(tmp_path)])
    assert len(out["ticks"]) == 5
    for name in ("a", "b"):
        assert os.path.exists(out[f"transcript_{name}"])
        sr, audio = read_audio(out[f"audio_{name}"])
        assert sr == 16000 and audio.shape == (2, 8000)
    # agent A opens the call with its opening text
    assert "hello?" in open(out["transcript_a"]).read()


def test_self_play_debug_headless(tmp_path):
    from realtime_codec_agent_tpu_torch import inference_client_self_play_debug as spd

    spd.main(["--tiny", "--device", "cpu", "--secs", "0.3", "--output_dir", str(tmp_path)])
    for i in (1, 2):
        assert os.path.exists(tmp_path / f"agent{i}_sequence.txt")
        sr, audio = read_audio(str(tmp_path / f"agent{i}.wav"))
        assert audio.shape == (2, 4800)


def test_debug_client_run_agent(tmp_path):
    """The file-driven debug client's generator (without its UI): one yield
    a second of audio and a last one, each with the RTF figure."""
    from realtime_codec_agent_tpu_torch.agent.agent import RealtimeAgent
    from realtime_codec_agent_tpu_torch.agent.config import RealtimeAgentConfig
    from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources
    from realtime_codec_agent_tpu_torch.inference_client_debug_v2 import run_agent

    wav = str(tmp_path / "in.wav")
    write_wav(wav, 16000, (0.2 * np.sin(np.arange(19200) / 25.0)).astype(np.float32))
    agent = RealtimeAgent(resources=RealtimeAgentResources(tiny=True, device="cpu"))
    config = RealtimeAgentConfig(use_whisper=False, agent_opening_text=None, max_inline_text_tokens=16)
    yields = list(run_agent(agent, wav, config))
    assert len(yields) == 2
    (sr, out), transcript, sequence, fig = yields[-1]
    assert sr == 16000 and out.shape == (19200,)
    assert sequence.startswith("<|")
    assert fig.axes[0].get_title() == "Realtime Factor Profile"


def _jax_and_port_tokenizers():
    """A tiny f32 JAX codec and the port's codec over the same params."""
    import jax
    from realtime_codec_agent_tpu.audio_tokenizer import AudioTokenizer as JaxAudioTokenizer
    from realtime_codec_agent_tpu.models.codec import JaxCodecModel, tiny_codec_config as jtiny
    from realtime_codec_agent_tpu_torch.audio_tokenizer import AudioTokenizer
    from realtime_codec_agent_tpu_torch.models.codec import CodecConfig, TorchCodecModel
    from realtime_codec_agent_tpu_torch.models.from_jax import codec_params_from_numpy

    jcodec = JaxCodecModel.random_init(jtiny(compute_dtype="float32"), seed=0)
    params = codec_params_from_numpy(jax.tree_util.tree_map(np.asarray, jcodec.params))
    tcodec = TorchCodecModel(params, CodecConfig(**dataclasses.asdict(jcodec.config)), "cpu")
    return JaxAudioTokenizer(codec_model=jcodec), AudioTokenizer(codec_model=tcodec)


def test_stream_codes_matches_jax(tmp_path):
    import run_stream_codes as jstream
    from realtime_codec_agent_tpu_torch import run_stream_codes

    jtok, ttok = _jax_and_port_tokenizers()
    sr = ttok.sampling_rate
    t = np.arange(int(0.8 * sr)) / sr
    audio = (0.2 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.sin(2 * np.pi * 1300 * t)).astype(np.float32)
    for enc, dec in [(0.1, 0.1), (0.2, 0.3)]:
        jsr, jout, jcodes = jstream.stream_codes(jtok, audio=audio, encode_chunk_secs=enc, decode_chunk_secs=dec)
        tsr, tout, tcodes = run_stream_codes.stream_codes(ttok, audio=audio, encode_chunk_secs=enc,
                                                          decode_chunk_secs=dec)
        assert tsr == jsr
        assert tcodes == jcodes
        assert tout.shape == jout.shape
        np.testing.assert_allclose(tout, np.asarray(jout), atol=1e-5)
    # the CLI writes its WAV
    out = str(tmp_path / "rt.wav")
    run_stream_codes.main(["--tiny", "--device", "cpu", "--secs", "0.5", "--output", out])
    assert read_audio(out)[1].shape[-1] > 0


def test_build_plot_matches_jax():
    from realtime_codec_agent_tpu.agent.config import RealtimeAgentConfig as JaxConfig
    from realtime_codec_agent_tpu.agent.profiler import RealtimeAgentProfilerCollection as JaxProfilers
    from realtime_codec_agent_tpu_torch.agent.config import RealtimeAgentConfig
    from realtime_codec_agent_tpu_torch.agent.profiler import SEGMENTS, RealtimeAgentProfilerCollection

    import matplotlib.pyplot as plt

    rng = np.random.default_rng(0)
    port, ref = RealtimeAgentProfilerCollection(RealtimeAgentConfig()), JaxProfilers(JaxConfig())
    for i, seg in enumerate(SEGMENTS):
        vals = [] if i == 1 else list(rng.uniform(0.2, 3.0, size=7 - i))
        getattr(port, f"{seg}_profiler").realtime_factor_values = list(vals)
        getattr(ref, f"{seg}_profiler").realtime_factor_values = list(vals)
    for ylim in [(0.5, 3.0), (0.0, 30.0)]:
        figs = [port.build_plot(ylim=ylim), ref.build_plot(ylim=ylim)]
        (got, want) = [f.axes[0] for f in figs]
        assert got.get_title() == want.get_title()
        assert (got.get_xlabel(), got.get_ylabel()) == (want.get_xlabel(), want.get_ylabel())
        assert got.get_ylim() == want.get_ylim() == ylim
        assert [ln.get_label() for ln in got.lines] == [ln.get_label() for ln in want.lines]
        assert len(got.lines) == 2 * (len(SEGMENTS) - 1) + 1
        for a, b in zip(got.lines, want.lines):
            np.testing.assert_array_equal(np.asarray(a.get_xydata()), np.asarray(b.get_xydata()))
            assert (a.get_color(), a.get_linestyle()) == (b.get_color(), b.get_linestyle())
        for f in figs:
            plt.close(f)


def test_lazy_public_names():
    import realtime_codec_agent_tpu as jpkg
    import realtime_codec_agent_tpu_torch as pkg
    from realtime_codec_agent_tpu_torch.agent import agent, config, resources
    from realtime_codec_agent_tpu_torch.utils import cli_utils

    assert pkg.__all__ == jpkg.__all__
    assert pkg.RealtimeAgent is agent.RealtimeAgent
    assert pkg.RealtimeAgentMultiprocessing is agent.RealtimeAgentMultiprocessing
    assert pkg.RealtimeAgentResources is resources.RealtimeAgentResources
    assert pkg.RealtimeAgentConfig is config.RealtimeAgentConfig
    assert pkg.add_common_inference_args is cli_utils.add_common_inference_args
    with pytest.raises(AttributeError):
        pkg.NoSuchName


@pytest.mark.parametrize("name", CLIENTS)
def test_client_parses_its_flags(name, capsys):
    import importlib

    module = importlib.import_module(f"realtime_codec_agent_tpu_torch.{name}")
    with pytest.raises(SystemExit) as exc:
        module.main(["--help"])
    assert exc.value.code == 0
    assert "usage:" in capsys.readouterr().out


def test_port_imports_without_gui_libraries():
    """Every port module imports in a fresh interpreter in which gradio,
    fastrtc and matplotlib cannot be imported, and importing the package
    alone imports no torch."""
    code = (
        "import sys, importlib, pkgutil\n"
        "BLOCKED = ('gradio', 'fastrtc', 'matplotlib')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(name + ' is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import realtime_codec_agent_tpu_torch as p\n"
        "assert 'torch' not in sys.modules\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        f"assert {{p.__name__ + '.' + n for n in {CLIENTS!r}}} <= set(mods), mods\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        "print('ok', len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
