"""PyTorch codec and streaming AudioTokenizer against the JAX package, tiny
configs, f32: codes exact, audio at atol 1e-4 (f32 sums ordered differently
through 2 transformer layers), streaming code strings identical. Three
flavours: the default (patchify, RMSNorm), the conv front end (JAX seed ->
numpy -> ``codec_params_from_numpy``), and the LayerNorm flavour with every
bias in both rotary layouts (one flash-attn-named state dict from a numpy
seed through both packages' ``codec_params_from_torch``). In bf16 the two
packages round differently (XLA's convolutions and fusions against
torch's), so a bf16 case holds codes and audio to BF16_CODES and BF16_REL
instead. Also: the converters' trees and unused keys, malformed input,
``.npz`` files written by one package and read by the other,
``TorchCodecModel.load``, and the tokenizer's checkpoint path and legacy
(growing) context."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.audio_tokenizer import AudioTokenizer as JaxAudioTokenizer
from realtime_codec_agent_tpu.models import convert as jconvert
from realtime_codec_agent_tpu.models.codec import JaxCodecModel, tiny_codec_config
from realtime_codec_agent_tpu_torch.audio_tokenizer import AudioTokenizer
from realtime_codec_agent_tpu_torch.models import codec as tcodec
from realtime_codec_agent_tpu_torch.models import convert as tconvert
from realtime_codec_agent_tpu_torch.models.from_jax import codec_params_from_numpy

from test_torch_pipeline import one_torch_thread  # noqa: F401 (a module fixture)

AUDIO_ATOL = 1e-4
BF16_CODES = 0.95  # share of frames whose bf16 codes agree
BF16_REL = 0.02   # bf16 decode of the same codes: max |port - JAX| / max |JAX|
CONV = dict(frontend="conv", conv_ratios=(8, 5, 4, 2), conv_base_channels=8)


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


# ---------------------------------------------------------------------------
# The conv front end and the LayerNorm flavour
# ---------------------------------------------------------------------------

def _tcfg(jcfg):
    return tcodec.CodecConfig(**dataclasses.asdict(jcfg))


def flash_state_dict(cfg, seed: int = 5) -> dict:
    """A MagiCodec-layout torch state dict from a numpy seed: flash-attn
    blocks (``norm1``/``norm2`` LayerNorms with biases, fused biased
    ``mixer.Wqkv``, biased ``mixer.out_proj``, ``mlp.fc1``/``fc2``),
    ``norm_f`` with bias, biased output projections; Linear patchify or
    Conv1d / ConvTranspose1d stages (the encoder's under ``down.{i}``, the
    decoder's under ``conv.stages.{i}``, highest width first)."""
    rng = np.random.default_rng(seed)
    h, mlp = cfg.hidden_size, cfg.mlp_dim
    sd = {}

    def lin(name, o, i, bias=True):
        sd[f"{name}.weight"] = rng.normal(size=(o, i)) / np.sqrt(i)
        if bias:
            sd[f"{name}.bias"] = rng.normal(size=o) * 0.1

    def norm(name):
        sd[f"{name}.weight"] = 1.0 + rng.normal(size=h) * 0.1
        sd[f"{name}.bias"] = rng.normal(size=h) * 0.1

    def body(prefix):
        for i in range(cfg.num_layers):
            b = f"{prefix}.blocks.{i}"
            norm(f"{b}.norm1")
            lin(f"{b}.mixer.Wqkv", 3 * h, h)
            lin(f"{b}.mixer.out_proj", h, h)
            norm(f"{b}.norm2")
            lin(f"{b}.mlp.fc1", mlp, h)
            lin(f"{b}.mlp.fc2", h, mlp)
        norm(f"{prefix}.norm_f")

    if cfg.frontend == "conv":
        chans = cfg.conv_channels
        in_chans = (1,) + chans[:-1]
        stages = list(zip(cfg.conv_ratios, in_chans, chans))
        for i, (r, cin, cout) in enumerate(stages):
            sd[f"encoder.down.{i}.weight"] = rng.normal(size=(cout, cin, 2 * r)) / np.sqrt(2 * r * cin)
            sd[f"encoder.down.{i}.bias"] = rng.normal(size=cout) * 0.1
        for j, (r, cin, cout) in enumerate(reversed(stages)):
            sd[f"decoder.conv.stages.{j}.weight"] = rng.normal(size=(cout, cin, 2 * r)) / np.sqrt(2 * r * cout)
            sd[f"decoder.conv.stages.{j}.bias"] = rng.normal(size=cin) * 0.1
    else:
        lin("encoder.patch_embed", h, cfg.hop_length)
        lin("decoder.out_proj", cfg.hop_length, h)
    body("encoder")
    lin("encoder.out_proj", cfg.codebook_dim, h)
    # a spread codebook keeps the nearest code's margin above f32 noise
    sd["quantizer.codebook.weight"] = rng.normal(size=(cfg.codebook_size, cfg.codebook_raw_dim)) * 3.0
    lin("quantizer.codebook_proj", cfg.codebook_dim, cfg.codebook_raw_dim)
    lin("decoder.in_proj", h, cfg.codebook_dim)
    body("decoder")
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}


def assert_tree_equal(got, want, where=""):
    """A port tree (torch) against a JAX one (numpy), bit for bit, dtype included."""
    if isinstance(want, dict):
        assert set(got) == set(want), (where, sorted(got), sorted(want))
        for k in want:
            assert_tree_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{where}.{i}")
    else:
        want = np.asarray(want)
        assert str(got.dtype).replace("torch.", "") == want.dtype.name, where
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32), err_msg=where)


def _flavour(name: str, dtype: str = "float32"):
    """(JaxCodecModel, TorchCodecModel) of one flavour on the same weights."""
    if name == "conv":
        jcfg = tiny_codec_config(compute_dtype=dtype, **CONV)
        jmodel = JaxCodecModel.random_init(jcfg, seed=0)
        params = codec_params_from_numpy(jax.tree_util.tree_map(np.asarray, jmodel.params))
    else:
        jcfg = tiny_codec_config(compute_dtype=dtype, norm_type="layer", rope_interleaved=name == "layer-interleaved")
        sd = flash_state_dict(jcfg)
        jmodel = JaxCodecModel(jconvert.codec_params_from_torch(sd, jcfg), jcfg)
        params = tconvert.codec_params_from_torch(sd, _tcfg(jcfg))
    return jmodel, tcodec.TorchCodecModel(params, _tcfg(jcfg))


@pytest.fixture(scope="module", params=["conv", "layer", "layer-interleaved"])
def flavour(request):
    return _flavour(request.param)


def test_flavour_codes_exact(flavour):
    jmodel, tmodel = flavour
    audio = np.stack([_speechlike(32000, 1), _speechlike(32000, 2)])
    want = jmodel.encode(audio)
    got = tmodel.encode(audio)
    assert got.shape == want.shape == (2, 100)
    np.testing.assert_array_equal(got, want)


def test_flavour_decode_matches(flavour):
    jmodel, tmodel = flavour
    codes = np.random.default_rng(3).integers(0, 1024, size=(2, 100))
    want = jmodel.decode(codes)
    got = tmodel.decode(codes)
    assert got.shape == want.shape == (2, 32000) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=AUDIO_ATOL)


def test_flavour_streaming_matches(flavour):
    jmodel, tmodel = flavour
    jtok = JaxAudioTokenizer(codec_model=jmodel)
    ttok = AudioTokenizer(codec_model=tmodel)
    assert ttok.detokenize_context == jtok.detokenize_context
    audio = _speechlike(16000, 4)
    for i in range(10):
        chunk = audio[i * 1600 : (i + 1) * 1600]
        js, ts = jtok.tokenize_audio(chunk), ttok.tokenize_audio(chunk)
        assert ts == js, i
        (_, ja), jh, jp = jtok.detokenize_audio(js, preroll_samples=320)
        (_, ta), th, tp = ttok.detokenize_audio(ts, preroll_samples=320)
        assert (th, tp) == (jh, jp)
        np.testing.assert_allclose(ta, ja, atol=AUDIO_ATOL)


@pytest.mark.parametrize("name", ["conv", "layer"])
def test_flavour_bf16_within_tolerance(name):
    jmodel, tmodel = _flavour(name, "bfloat16")
    audio = np.stack([_speechlike(32000, 1), _speechlike(32000, 2)])
    agree = float((tmodel.encode(audio) == jmodel.encode(audio)).mean())
    assert agree >= BF16_CODES, agree
    codes = np.random.default_rng(3).integers(0, 1024, size=(2, 100))
    want = jmodel.decode(codes)
    rel = float(np.abs(tmodel.decode(codes) - want).max() / np.abs(want).max())
    assert rel <= BF16_REL, rel


@pytest.mark.parametrize("frontend", ["patchify", "conv"])
def test_converted_trees_match_jax(frontend):
    """Both converters give the same tree leaf for leaf (f32: bit for bit)
    and report the same unused keys."""
    jcfg = tiny_codec_config(compute_dtype="float32", norm_type="layer", **(CONV if frontend == "conv" else {}))
    sd = flash_state_dict(jcfg)
    sd["encoder.spare.weight"] = torch.zeros(3)
    jparams, junused = jconvert.codec_params_from_torch(sd, jcfg, return_unused=True)
    tparams, tunused = tconvert.codec_params_from_torch(sd, _tcfg(jcfg), return_unused=True)
    assert tunused == junused == ["encoder.spare.weight"]
    assert_tree_equal(tparams, jax.tree_util.tree_map(np.asarray, jparams))
    blk = tparams["encoder"]["blocks"][0]
    assert {"attn_norm_b", "bq", "bk", "bv", "bo", "mlp_norm_b"} <= set(blk)
    assert "out_norm_b" in tparams["decoder"] and "out_proj_b" in tparams["encoder"]


def test_malformed_codecs_raise():
    """A missing tensor raises KeyError naming it in both packages; conv
    ratios that do not multiply to hop_length raise ValueError in both; an
    unknown leaf in a JAX tree raises KeyError."""
    jcfg = tiny_codec_config(compute_dtype="float32", norm_type="layer")
    sd = flash_state_dict(jcfg)
    del sd["quantizer.codebook.weight"]
    with pytest.raises(KeyError, match="quantizer.codebook"):
        jconvert.codec_params_from_torch(sd, jcfg)
    with pytest.raises(KeyError, match="quantizer.codebook"):
        tconvert.codec_params_from_torch(sd, _tcfg(jcfg))
    bad = tiny_codec_config(frontend="conv", conv_ratios=(8, 5, 4))
    with pytest.raises(ValueError, match="hop_length"):
        JaxCodecModel.random_init(bad)
    with pytest.raises(ValueError, match="hop_length"):
        tcodec.TorchCodecModel.random_init(_tcfg(bad))
    tree = jax.tree_util.tree_map(np.asarray, JaxCodecModel.random_init(tiny_codec_config(), seed=0).params)
    tree["decoder"]["blocks"][1]["spare"] = np.zeros(2, np.float32)
    with pytest.raises(KeyError, match="spare"):
        codec_params_from_numpy(tree)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("name", ["conv", "layer"])
def test_npz_interchange(tmp_path, name, writer):
    """A ``.npz`` written by one package loads in the other: the same
    config, the leaves bit for bit, the same codes."""
    jmodel, tmodel = _flavour(name)
    path = str(tmp_path / "codec.npz")
    audio = _speechlike(16000, 6)[None]
    if writer == "jax":
        jconvert.save_codec_checkpoint(path, jmodel.params, jmodel.config)
        params, cfg = tconvert.load_codec_checkpoint(path)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jmodel.config)
        assert_tree_equal(params, jax.tree_util.tree_map(np.asarray, jmodel.params))
        np.testing.assert_array_equal(tcodec.TorchCodecModel(params, cfg).encode(audio), jmodel.encode(audio))
    else:
        tconvert.save_codec_checkpoint(path, tmodel.params, tmodel.config)
        params, cfg = jconvert.load_codec_checkpoint(path)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(tmodel.config)
        assert_tree_equal(tmodel.params, jax.tree_util.tree_map(np.asarray, params))
        np.testing.assert_array_equal(JaxCodecModel(params, cfg).encode(audio), tmodel.encode(audio))


@pytest.mark.parametrize("form", ["npz", "dir", "pt", "missing", "suffix"])
def test_codec_model_load(tmp_path, form):
    """``TorchCodecModel.load``: a ``.npz``, a directory holding
    ``codec.npz``, a ``.pt`` holding ``{"state_dict": ...}`` (converted
    under the given config); a missing file raises FileNotFoundError, an
    unknown suffix ValueError."""
    jcfg = tiny_codec_config(compute_dtype="float32", norm_type="layer")
    sd = flash_state_dict(jcfg)
    ref = tcodec.TorchCodecModel(tconvert.codec_params_from_torch(sd, _tcfg(jcfg)), _tcfg(jcfg))
    if form in ("npz", "dir"):
        tconvert.save_codec_checkpoint(str(tmp_path / "codec.npz"), ref.params, ref.config)
        path = str(tmp_path / "codec.npz") if form == "npz" else str(tmp_path)
    elif form == "pt":
        path = str(tmp_path / "magicodec.pt")
        torch.save({"state_dict": sd}, path)
    elif form == "missing":
        with pytest.raises(FileNotFoundError):
            tcodec.TorchCodecModel.load(str(tmp_path / "nope.npz"), device="cpu")
        with pytest.raises(FileNotFoundError):
            tcodec.TorchCodecModel.load(str(tmp_path), device="cpu")  # a dir without codec.npz
        return
    else:
        (tmp_path / "codec.ckpt").write_bytes(b"")
        with pytest.raises(ValueError, match="unrecognized"):
            tcodec.TorchCodecModel.load(str(tmp_path / "codec.ckpt"), device="cpu")
        return
    model = tcodec.TorchCodecModel.load(path, config=_tcfg(jcfg), device="cpu")
    assert model.config == ref.config
    assert_tree_equal(model.params, jax.tree_util.tree_map(lambda t: t.numpy(), ref.params))
    audio = _speechlike(16000, 7)[None]
    np.testing.assert_array_equal(model.encode(audio), ref.encode(audio))


def test_tokenizer_loads_checkpoint_path(tmp_path, codecs, monkeypatch):
    """``AudioTokenizer(codec_model=<path>)`` gives the strings of the same
    model passed as an object; ``None`` builds random weights from ``seed``;
    the default device is the card, which raises without one."""
    _, tmodel = codecs
    path = str(tmp_path / "codec.npz")
    tconvert.save_codec_checkpoint(path, tmodel.params, tmodel.config)
    by_path = AudioTokenizer(codec_model=path, device="cpu")
    by_model = AudioTokenizer(codec_model=tmodel)
    audio = _speechlike(8000, 8)
    for i in range(3):
        chunk = audio[i * 1600 : (i + 1) * 1600]
        assert by_path.tokenize_audio(chunk) == by_model.tokenize_audio(chunk)
    rnd = AudioTokenizer(codec_config=tcodec.tiny_codec_config(), seed=3, device="cpu")
    again = AudioTokenizer(codec_config=tcodec.tiny_codec_config(), seed=3, device="cpu")
    assert rnd.tokenize_audio(audio[:1600]) == again.tokenize_audio(audio[:1600])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AudioTokenizer(codec_model=path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AudioTokenizer(codec_config=tcodec.tiny_codec_config())


def test_legacy_context_matches_jax(codecs):
    """``fixed_context=False``: the context grows from empty, as the
    reference's does; 25 chunks of 0.2 s (saturated after 10) give the JAX
    tokenizer's strings, and audio at AUDIO_ATOL. ``framerate_probe_secs``
    probes with another length and finds the same rate."""
    jmodel, tmodel = codecs
    jtok = JaxAudioTokenizer(codec_model=jmodel, fixed_context=False, framerate_probe_secs=1.0)
    ttok = AudioTokenizer(codec_model=tmodel, fixed_context=False, framerate_probe_secs=1.0)
    assert ttok.framerate == jtok.framerate == 50.0
    assert ttok.tokenize_context.shape == (1, 0) and ttok.detokenize_context == ""
    audio = _speechlike(80000, 9)
    for i in range(25):
        chunk = audio[i * 3200 : (i + 1) * 3200]
        js, ts = jtok.tokenize_audio(chunk), ttok.tokenize_audio(chunk)
        assert ts == js, i
        (_, ja), jh, jp = jtok.detokenize_audio(js, preroll_samples=320)
        (_, ta), th, tp = ttok.detokenize_audio(ts, preroll_samples=320)
        assert (th, tp) == (jh, jp)
        np.testing.assert_allclose(ta, ja, atol=AUDIO_ATOL)
    assert ttok.tokenize_context.shape == (1, 32000) and len(ttok.detokenize_context) == 100
