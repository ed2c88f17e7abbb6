"""The port's copies of the JAX package's host-only modules (``units``,
``tokenization``, ``utils.audio_utils`` and the ``utils.native_audio`` it
calls, ``models.gguf``, ``utils.audio_io``, ``serving.duplex_client``) and of Whisper's JAX-free pieces (``slaney_mel_filters``,
``_sinusoids``, the agent's ``_clean_whisper_text`` and ``CONSTRAINED_*``,
``WhisperCppASR``) against their originals: the sources are line for line the same, and
seeded inputs give exactly equal outputs (no tolerance: the same Python and
numpy code runs on both sides)."""
import pathlib

import numpy as np
import pytest

from realtime_codec_agent_tpu import tokenization as jtok
from realtime_codec_agent_tpu import units as junits
from realtime_codec_agent_tpu.utils import audio_utils as jaudio
from realtime_codec_agent_tpu_torch import tokenization as ttok
from realtime_codec_agent_tpu_torch import units as tunits
from realtime_codec_agent_tpu_torch.utils import audio_utils as taudio

ROOT = pathlib.Path(__file__).resolve().parents[1]
COPIES = [
    "units/__init__.py", "units/codes.py", "units/special_tokens.py",
    "tokenization/__init__.py", "tokenization/tokenizer.py",
    "utils/audio_utils.py", "utils/native_audio.py", "models/gguf.py",
    "utils/audio_io.py", "serving/duplex_client.py",
]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_line_for_line(rel):
    orig = (ROOT / "realtime_codec_agent_tpu" / rel).read_text().splitlines()
    copy = (ROOT / "realtime_codec_agent_tpu_torch" / rel).read_text().splitlines()
    assert copy == orig


def _texts(rng, tok, n=40):
    """Seeded mixes of plain text, framing specials and codec characters."""
    words = ["hello", " A", " B", ":", "okay so", "†", "naïve", "日本", " Z"]
    out = []
    for _ in range(n):
        parts = []
        for _ in range(int(rng.integers(1, 12))):
            kind = int(rng.integers(0, 3))
            if kind == 0:
                parts.append(words[int(rng.integers(0, len(words)))])
            elif kind == 1:
                parts.append(tok.special_tokens[int(rng.integers(0, len(tok.special_tokens)))])
            else:
                codes = rng.integers(0, tok.num_codec_tokens, size=int(rng.integers(1, 6)))
                parts.append("".join(chr(tok.unicode_offset + int(c)) for c in codes))
        out.append("".join(parts))
    return out


@pytest.mark.parametrize("num_codebooks,codebook_size", [(1, 131072), (2, 64)])
def test_tokenizer_round_trips_match(num_codebooks, codebook_size):
    jt = jtok.CodecTextTokenizer(num_codebooks=num_codebooks, codebook_size=codebook_size)
    tt = ttok.CodecTextTokenizer(num_codebooks=num_codebooks, codebook_size=codebook_size)
    for attr in ("vocab_size", "codec_vocab_start", "num_codec_tokens", "pad_token_id", "bos_token_id",
                 "eos_token_id", "text_vocab_size"):
        assert getattr(tt, attr) == getattr(jt, attr), attr
    rng = np.random.default_rng(num_codebooks)
    for text in _texts(rng, jt):
        for specials in (True, False):
            ids = tt.encode(text, add_special_tokens=specials)
            assert ids == jt.encode(text, add_special_tokens=specials)
        for skip in (False, True):
            assert tt.decode(ids, skip_special_tokens=skip) == jt.decode(ids, skip_special_tokens=skip)
        assert tt.decode(ids) == text
    for token in [*jt.special_tokens, " A", "x", chr(jt.unicode_offset + 5), "zz"]:
        assert tt.convert_tokens_to_ids(token) == jt.convert_tokens_to_ids(token)


def test_tokenizer_save_load_match(tmp_path):
    tt = ttok.CodecTextTokenizer(codebook_size=128)
    tt.save(str(tmp_path / "port"))
    jtok.CodecTextTokenizer(codebook_size=128).save(str(tmp_path / "jax"))
    assert (tmp_path / "port" / "codec_tokenizer.json").read_text() == (
        tmp_path / "jax" / "codec_tokenizer.json"
    ).read_text()
    tl = ttok.CodecTextTokenizer.load(str(tmp_path / "jax"))
    jl = jtok.CodecTextTokenizer.load(str(tmp_path / "port"))
    text = "<|audio|> A: hi" + "".join(chr(tl.unicode_offset + c) for c in (0, 7, 127))
    assert tl.encode(text) == jl.encode(text) == tt.encode(text)
    assert tl.vocab_size == jl.vocab_size == tt.vocab_size


def test_codes_maps_match():
    rng = np.random.default_rng(5)
    assert tunits.SPECIAL_TOKENS == junits.SPECIAL_TOKENS
    assert (tunits.UNICODE_OFFSET, tunits.UNICODE_OFFSET_LARGE) == (junits.UNICODE_OFFSET, junits.UNICODE_OFFSET_LARGE)
    for shape, cb in (((50,), 131072), ((3, 20), 1024)):
        codes = rng.integers(0, cb, size=shape)
        s = tunits.codes_to_chars(codes, cb)
        assert s == junits.codes_to_chars(codes, cb)
        nb = 1 if len(shape) == 1 else shape[0]
        np.testing.assert_array_equal(tunits.chars_to_codes(s, nb, cb), junits.chars_to_codes(s, nb, cb))
        assert tunits.chars_to_codes(s, nb, cb, return_numpy=False) == junits.chars_to_codes(
            s, nb, cb, return_numpy=False
        )
    chans = [tunits.codes_to_chars(rng.integers(0, 999, size=n), 1024) for n in (9, 7)]
    mixed = tunits.interleave_channels(chans)
    assert mixed == junits.interleave_channels(chans)
    assert tunits.deinterleave_channels(mixed, 2) == junits.deinterleave_channels(mixed, 2)
    for n in (2, 3):
        assert tunits.drop_hanging_channel_codes(mixed[:-1], n) == junits.drop_hanging_channel_codes(mixed[:-1], n)
    text = "ab" + mixed[:5] + "c" + mixed[5:9]
    t_idx, t_str = tunits.audio_code_positions(text)
    j_idx, j_str = junits.audio_code_positions(text)
    np.testing.assert_array_equal(t_idx, j_idx)
    assert t_str == j_str
    assert [tunits.is_audio_code(c) for c in text] == [junits.is_audio_code(c) for c in text]


@pytest.mark.parametrize("case", ["f32", "int16_stereo_48k", "tuple_same_rate", "f32_22k"])
def test_prep_audio_matches(case):
    rng = np.random.default_rng(len(case))
    if case == "f32":
        audio = rng.normal(size=4000).astype(np.float32) * 0.1
    elif case == "int16_stereo_48k":
        audio = (48000, (rng.normal(size=(2, 9600)) * 3000).astype(np.int16))
    elif case == "tuple_same_rate":
        audio = (16000, rng.normal(size=1600).astype(np.float32))
    else:
        audio = (22050, rng.normal(size=2205).astype(np.float32))
    got = taudio.prep_audio(audio, 16000)
    want = jaudio.prep_audio(audio, 16000)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    x = rng.normal(size=800).astype(np.float32)
    np.testing.assert_array_equal(taudio.normalize_audio_rms(x), jaudio.normalize_audio_rms(x))
    np.testing.assert_array_equal(taudio.pad_or_trim(x, 1000, "left"), jaudio.pad_or_trim(x, 1000, "left"))
    L, fi, fo = taudio.create_crossfade_ramps(16000, 0.01)
    np.testing.assert_array_equal(taudio.smooth_join(x, x[::-1], L, fi, fo),
                                  jaudio.smooth_join(x, x[::-1], *jaudio.create_crossfade_ramps(16000, 0.01)))


def _whisper_copies():
    from realtime_codec_agent_tpu.agent import agent as jagent
    from realtime_codec_agent_tpu.agent import asr as jasr
    from realtime_codec_agent_tpu.models import whisper as jw
    from realtime_codec_agent_tpu_torch.agent import agent as tagent
    from realtime_codec_agent_tpu_torch.agent import asr as tasr
    from realtime_codec_agent_tpu_torch.models import whisper as tw

    return {
        "slaney_mel_filters": (jw.slaney_mel_filters, tw.slaney_mel_filters),
        "_sinusoids": (jw._sinusoids, tw._sinusoids),
        "_clean_whisper_text": (jagent.RealtimeAgent._clean_whisper_text, tagent.RealtimeAgent._clean_whisper_text),
        "WhisperCppASR": (jasr.WhisperCppASR, tasr.WhisperCppASR),
    }


@pytest.mark.parametrize("name", ["slaney_mel_filters", "_sinusoids", "_clean_whisper_text", "WhisperCppASR"])
def test_whisper_copy_is_line_for_line(name):
    """The JAX-free pieces of Whisper and the ASR the port copies: the same
    source lines."""
    import inspect

    orig, copy = _whisper_copies()[name]
    assert inspect.getsource(copy) == inspect.getsource(orig)


def test_whisper_copies_give_the_same_outputs():
    from realtime_codec_agent_tpu.agent import agent as jagent
    from realtime_codec_agent_tpu_torch.agent import agent as tagent

    c = _whisper_copies()
    for args in ((16000, 400, 80, 0.0, 8000.0), (16000, 400, 8), (8000, 256, 40, 100.0, None)):
        np.testing.assert_array_equal(c["slaney_mel_filters"][1](*args), c["slaney_mel_filters"][0](*args))
    for shape in ((1500, 768), (32, 64)):
        np.testing.assert_array_equal(c["_sinusoids"][1](*shape), c["_sinusoids"][0](*shape))
    for text in (" Hello, there... [ BLANK_AUDIO ] mm-hmm >>", "[Inaudible] ok.", "", "  [silence] [pause]"):
        assert c["_clean_whisper_text"][1](text) == c["_clean_whisper_text"][0](text)
    assert tagent.CONSTRAINED_STOP_REGEX.pattern == jagent.CONSTRAINED_STOP_REGEX.pattern
    assert tagent.CONSTRAINED_STOP_REGEX.flags == jagent.CONSTRAINED_STOP_REGEX.flags
    assert tagent.CONSTRAINED_WORDLIST == jagent.CONSTRAINED_WORDLIST
