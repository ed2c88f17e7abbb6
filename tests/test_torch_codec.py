"""PyTorch codec and streaming AudioTokenizer against the JAX package, tiny
f32 config: codes exact, audio at atol 1e-4 (f32 sums ordered differently
through 2 transformer layers), streaming code strings identical."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.audio_tokenizer import AudioTokenizer as JaxAudioTokenizer
from realtime_codec_agent_tpu.models.codec import JaxCodecModel, tiny_codec_config
from realtime_codec_agent_tpu_torch.audio_tokenizer import AudioTokenizer
from realtime_codec_agent_tpu_torch.models import codec as tcodec
from realtime_codec_agent_tpu_torch.models.from_jax import codec_params_from_numpy

AUDIO_ATOL = 1e-4


@pytest.fixture(scope="module")
def codecs():
    jcfg = tiny_codec_config(compute_dtype="float32")
    jmodel = JaxCodecModel.random_init(jcfg, seed=0)
    tcfg = tcodec.CodecConfig(**dataclasses.asdict(jcfg))
    params = codec_params_from_numpy(jax.tree_util.tree_map(np.asarray, jmodel.params))
    return jmodel, tcodec.TorchCodecModel(params, tcfg)


def _speechlike(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 180 * t) * np.clip(np.sin(2 * np.pi * 0.9 * t), 0, 1)
            + 0.05 * rng.normal(size=n)).astype(np.float32)


def test_encode_codes_exact(codecs):
    jmodel, tmodel = codecs
    audio = np.stack([_speechlike(32000, 1), _speechlike(32000, 2)])
    want = jmodel.encode(audio)
    got = tmodel.encode(audio)
    assert got.shape == want.shape == (2, 100)
    np.testing.assert_array_equal(got, want)


def test_decode_audio_matches(codecs):
    jmodel, tmodel = codecs
    codes = np.random.default_rng(3).integers(0, 1024, size=(2, 100))
    want = jmodel.decode(codes)
    got = tmodel.decode(codes)
    assert got.shape == want.shape == (2, 32000)
    np.testing.assert_allclose(got, want, atol=AUDIO_ATOL)


def test_streaming_tokenizer_matches(codecs):
    jmodel, tmodel = codecs
    jtok = JaxAudioTokenizer(codec_model=jmodel)
    ttok = AudioTokenizer(codec_model=tmodel)
    assert ttok.framerate == jtok.framerate == 50.0
    assert ttok.detokenize_context == jtok.detokenize_context
    audio = _speechlike(16000, 4)
    for i in range(10):
        chunk = audio[i * 1600 : (i + 1) * 1600]
        js = jtok.tokenize_audio(chunk)
        ts = ttok.tokenize_audio(chunk)
        assert ts == js, i
        (_, ja), jh, jp = jtok.detokenize_audio(js, preroll_samples=320)
        (_, ta), th, tp = ttok.detokenize_audio(ts, preroll_samples=320)
        assert (th, tp) == (jh, jp)
        np.testing.assert_allclose(ta, ja, atol=AUDIO_ATOL)


@pytest.mark.parametrize("override", [{"frontend": "conv"}, {"norm_type": "layer"}])
def test_unported_flavours_raise(override):
    with pytest.raises(NotImplementedError):
        tcodec.TorchCodecModel.random_init(tcodec.tiny_codec_config(**override))
