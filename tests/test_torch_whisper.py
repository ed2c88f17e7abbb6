"""The port's Whisper (realtime_codec_agent_tpu_torch/models/whisper.py)
against the JAX package's on the same params.

JAX params (``init_whisper_params`` from a PRNG key) go to the port through
``whisper_params_from_jax``, at ``tiny_whisper_config()`` and at the 2-layer
geometry of tests/test_whisper.py's ``_tiny_pair`` (vocab 500, 64 wide, 2
heads, 8 mel bins, 32 source positions). Held: the log-mel within 1e-4 (also
at 80 mel bins over a 5 s and the 30 s window), encoder states and
teacher-forced decoder logits within 2e-4, the port's incremental decode
against its teacher-forced one, greedy ids with suppress and begin-suppress
lists exactly, window buckets and the full-window fall-through exactly;
``whisper_params_from_torch`` against HF's model; the card is asked for by
default and its absence raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.models import whisper as JW
from realtime_codec_agent_tpu_torch.models import whisper as TW
from realtime_codec_agent_tpu_torch.models.from_jax import whisper_params_from_jax

GEOMETRIES = {
    "tiny": {},
    "tiny_pair": dict(vocab_size=500, decoder_start_token_id=490, eos_token_id=491, no_timestamps_token_id=493),
}


def _pair(geometry, seed=0):
    """(JAX params, port params on the CPU, JAX config, port config)."""
    jcfg = JW.tiny_whisper_config(**GEOMETRIES[geometry])
    jp = JW.init_whisper_params(jax.random.PRNGKey(seed), jcfg)
    tp = whisper_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jp, tp, jcfg, TW.tiny_whisper_config(**GEOMETRIES[geometry])


def _mel(cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(1, cfg.num_mel_bins, cfg.n_mel_frames)).astype(np.float32)


@pytest.mark.parametrize("case", ["tiny", "80mel_5s", "80mel_30s"])
def test_log_mel_matches_jax(case):
    kw = {} if case == "tiny" else dict(num_mel_bins=80, max_source_positions=1500)
    jcfg, tcfg = JW.tiny_whisper_config(**kw), TW.tiny_whisper_config(**kw)
    n = {"tiny": jcfg.n_audio_samples, "80mel_5s": 80000, "80mel_30s": jcfg.n_audio_samples}[case]
    rng = np.random.default_rng(len(case))
    audio = (rng.normal(size=n) * 0.1).astype(np.float32)
    audio[: n // 4] *= 0.01  # a quiet stretch reaches the max - 8 floor
    filters = JW.slaney_mel_filters(16000, 400, jcfg.num_mel_bins, fmax=8000.0)
    want = np.asarray(JW.log_mel_spectrogram(jnp.asarray(audio), jnp.asarray(filters), jcfg))
    got = TW.log_mel_spectrogram(torch.from_numpy(audio), torch.from_numpy(filters), tcfg).numpy()
    assert got.shape == want.shape == (jcfg.num_mel_bins, n // 160)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_encoder_matches_jax(geometry):
    jp, tp, jcfg, tcfg = _pair(geometry, seed=1)
    mel = _mel(jcfg, 1)
    want = np.asarray(JW.encode(jp, jnp.asarray(mel), jcfg))
    got = TW.encode(tp, torch.from_numpy(mel), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # a bucket's shorter window: the positions slice to it
    half = mel[..., : jcfg.n_mel_frames // 2]
    np.testing.assert_allclose(TW.encode(tp, torch.from_numpy(half), tcfg).numpy(),
                               np.asarray(JW.encode(jp, jnp.asarray(half), jcfg)), rtol=2e-4, atol=2e-4)


def _teacher_forced(jp, tp, jcfg, tcfg, mel, ids):
    t = ids.shape[1]
    enc = JW.encode(jp, jnp.asarray(mel), jcfg)
    ck, cv = JW.cross_kv(jp, enc)
    sk = jnp.zeros((jcfg.decoder_layers, 1, t + 4, jcfg.d_model), jnp.float32)
    want, _, _ = JW.decode_step(jp, jnp.asarray(ids, jnp.int32), jnp.arange(t), sk, jnp.zeros_like(sk),
                                jnp.int32(0), ck, cv, jcfg)
    tenc = TW.encode(tp, torch.from_numpy(mel), tcfg)
    tck, tcv = TW.cross_kv(tp, tenc)
    tsk = torch.zeros((tcfg.decoder_layers, 1, t + 4, tcfg.d_model))
    got, _, _ = TW.decode_step(tp, torch.from_numpy(ids).long(), torch.arange(t), tsk, torch.zeros_like(tsk),
                               0, tck, tcv, tcfg)
    return np.asarray(want), got, (tck, tcv)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_decoder_teacher_forced_matches_jax(geometry):
    jp, tp, jcfg, tcfg = _pair(geometry, seed=2)
    rng = np.random.default_rng(2)
    mel = _mel(jcfg, 2)
    ids = rng.integers(0, jcfg.vocab_size, size=(1, 6)).astype(np.int64)
    want, got, _ = _teacher_forced(jp, tp, jcfg, tcfg, mel, ids)
    assert got.dtype == torch.float32 and got.shape == (1, 6, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_incremental_matches_teacher_forced():
    """One-token steps against the cached prefix give the full prefix's
    logits."""
    jp, tp, jcfg, tcfg = _pair("tiny_pair", seed=3)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, jcfg.vocab_size, size=(1, 5)).astype(np.int64)
    _, full, (ck, cv) = _teacher_forced(jp, tp, jcfg, tcfg, _mel(jcfg, 3), ids)
    sk = torch.zeros((tcfg.decoder_layers, 1, 7, tcfg.d_model))
    sv = torch.zeros_like(sk)
    steps = []
    for i in range(5):
        lg, sk, sv = TW.decode_step(tp, torch.from_numpy(ids[:, i : i + 1]), torch.tensor([i]), sk, sv, i, ck, cv, tcfg)
        steps.append(lg[0, 0])
    np.testing.assert_allclose(torch.stack(steps).numpy(), full[0].numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("lists", ["none", "suppress"])
def test_greedy_ids_match_jax(geometry, lists):
    jp, tp, jcfg, tcfg = _pair(geometry, seed=4)
    mel = _mel(jcfg, 4)
    start = [jcfg.decoder_start_token_id, jcfg.no_timestamps_token_id]
    enc = JW.encode(jp, jnp.asarray(mel), jcfg)
    tenc = TW.encode(tp, torch.from_numpy(mel), tcfg)
    jkw, tkw = {}, {}
    if lists == "suppress":
        # suppress the unconstrained run's favourites, so the lists change the ids
        free, n = JW.greedy_decode(jp, enc, jnp.asarray(start, jnp.int32), jcfg, max_new_tokens=8)
        free = [int(t) for t in np.asarray(free)[: int(n)]]
        sup, bsup = sorted(set(free[1:3])), [free[0], jcfg.eos_token_id]
        jkw = dict(suppress_ids=jnp.asarray(sup, jnp.int32), begin_suppress_ids=jnp.asarray(bsup, jnp.int32))
        tkw = dict(suppress_ids=torch.tensor(sup), begin_suppress_ids=torch.tensor(bsup))
    out, n_gen = JW.greedy_decode(jp, enc, jnp.asarray(start, jnp.int32), jcfg, max_new_tokens=8, **jkw)
    tout, tn = TW.greedy_decode(tp, tenc, torch.tensor(start), tcfg, 8, **tkw)
    assert tout.tolist() == [int(t) for t in np.asarray(out)]  # padded with eos alike
    assert int(tn) == int(n_gen)
    if lists == "suppress":
        assert tout[0] not in bsup and not set(tout[: int(tn)].tolist()) & set(sup)


def test_greedy_stops_at_eos_like_jax():
    """An eos picked mid-decode: the ids after it are eos, n_gen counts the
    ids before it, as JAX's while_loop leaves them."""
    jp, tp, jcfg, tcfg = _pair("tiny", seed=5)
    mel = _mel(jcfg, 5)
    start = [jcfg.decoder_start_token_id]
    tenc = TW.encode(tp, torch.from_numpy(mel), tcfg)
    free, _ = TW.greedy_decode(tp, tenc, torch.tensor(start), tcfg, 8)
    # make the third id eos: its embedding row as the eos row's... simplest:
    # suppress nothing, but move eos onto the third pick by swapping rows
    third = int(free[2])
    for tree in (jp, tp):
        emb = tree["decoder"]["embed_tokens"]
        if isinstance(emb, torch.Tensor):
            emb[[third, tcfg.eos_token_id]] = emb[[tcfg.eos_token_id, third]].clone()
        else:
            e = np.asarray(emb).copy()
            e[[third, jcfg.eos_token_id]] = e[[jcfg.eos_token_id, third]]
            tree["decoder"]["embed_tokens"] = jnp.asarray(e)
    enc = JW.encode(jp, jnp.asarray(mel), jcfg)
    tenc = TW.encode(tp, torch.from_numpy(mel), tcfg)
    out, n_gen = JW.greedy_decode(jp, enc, jnp.asarray(start, jnp.int32), jcfg, max_new_tokens=8)
    tout, tn = TW.greedy_decode(tp, tenc, torch.tensor(start), tcfg, 8)
    assert tout.tolist() == [int(t) for t in np.asarray(out)]
    assert int(tn) == int(n_gen) < 8
    assert tout[int(tn):].eq(tcfg.eos_token_id).all()


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_window_buckets_match_jax(geometry):
    """window_secs: short audio pads to the smallest bucket, longer audio
    takes the next one, audio past the largest falls through to the full
    window; every case gives JAX's ids."""
    jp, tp, jcfg, tcfg = _pair(geometry, seed=6)
    full_secs = jcfg.n_audio_samples / jcfg.sample_rate
    buckets = [full_secs / 4, full_secs / 2]
    jm = JW.JaxWhisperModel(jp, jcfg, max_new_tokens=6, window_secs=buckets, suppress_ids=[5, 6],
                            begin_suppress_ids=[7])
    tm = TW.TorchWhisperModel(tp, tcfg, max_new_tokens=6, window_secs=buckets, suppress_ids=[5, 6],
                              begin_suppress_ids=[7], device="cpu")
    assert tm.window_samples == jm.window_samples == [jcfg.n_audio_samples // 4, jcfg.n_audio_samples // 2,
                                                      jcfg.n_audio_samples]
    rng = np.random.default_rng(6)
    for n, frames in ((jcfg.n_audio_samples // 8, jcfg.n_mel_frames // 4),
                      (jcfg.n_audio_samples // 3, jcfg.n_mel_frames // 2),
                      (jcfg.n_audio_samples * 3 // 4, jcfg.n_mel_frames),
                      (jcfg.n_audio_samples + 500, jcfg.n_mel_frames)):
        audio = (rng.normal(size=n) * 0.1).astype(np.float32)
        mel = tm.features(audio)
        assert mel.shape == (1, tcfg.num_mel_bins, frames)
        np.testing.assert_allclose(mel.numpy(), np.asarray(jm.features(audio)), rtol=1e-4, atol=1e-4)
        assert tm.transcribe_ids(audio) == jm.transcribe_ids(audio)
    full = TW.TorchWhisperModel(tp, tcfg, max_new_tokens=6, suppress_ids=[5, 6], begin_suppress_ids=[7],
                                device="cpu")
    long = (rng.normal(size=jcfg.n_audio_samples) * 0.1).astype(np.float32)
    assert tm.transcribe_ids(long) == full.transcribe_ids(long)


def test_params_from_torch_match_hf_and_jax():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.WhisperConfig(
        vocab_size=500, d_model=64, encoder_layers=2, decoder_layers=2, encoder_attention_heads=2,
        decoder_attention_heads=2, encoder_ffn_dim=128, decoder_ffn_dim=128, num_mel_bins=8,
        max_source_positions=32, max_target_positions=24, decoder_start_token_id=490, eos_token_id=491,
        bos_token_id=491, pad_token_id=492,
    )
    torch.manual_seed(7)
    hf = transformers.WhisperForConditionalGeneration(hf_cfg).eval()
    cfg = TW.whisper_config_from_hf(hf_cfg, no_timestamps_token_id=493)
    assert cfg == TW.tiny_whisper_config(**GEOMETRIES["tiny_pair"])
    tp = TW.whisper_params_from_torch(hf.state_dict(), cfg)
    jp = JW.whisper_params_from_torch(hf.state_dict(), JW.whisper_config_from_hf(hf_cfg, no_timestamps_token_id=493))
    flat_t = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda x: x.numpy(), tp))
    flat_j = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jp))
    assert len(flat_t) == len(flat_j)
    for a, b in zip(flat_t, flat_j):
        np.testing.assert_array_equal(a, b)
    mel = _mel(cfg, 7)
    ids = np.array([[490, 3, 17, 250]])
    with torch.no_grad():
        enc_ref = hf.model.encoder(torch.from_numpy(mel)).last_hidden_state
        logits_ref = hf(input_features=torch.from_numpy(mel), decoder_input_ids=torch.from_numpy(ids)).logits
    enc = TW.encode(tp, torch.from_numpy(mel), cfg)
    np.testing.assert_allclose(enc.numpy(), enc_ref.numpy(), rtol=2e-4, atol=2e-4)
    ck, cv = TW.cross_kv(tp, enc)
    sk = torch.zeros((2, 1, 4, 64))
    logits, _, _ = TW.decode_step(tp, torch.from_numpy(ids), torch.arange(4), sk, torch.zeros_like(sk), 0, ck, cv, cfg)
    np.testing.assert_allclose(logits.numpy(), logits_ref.numpy(), rtol=2e-3, atol=2e-3)


def test_params_from_jax_rejects_other_trees():
    jp, _, _, _ = _pair("tiny")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    del tree["decoder"]["layers"][1]["cross"]["bv"]
    with pytest.raises(KeyError, match="decoder.layers.1"):
        whisper_params_from_jax(tree)
    with pytest.raises(KeyError, match="not a Whisper"):
        whisper_params_from_jax({"encoder": {}, "decoder": {}})


def test_init_is_seeded_and_shaped():
    cfg = TW.tiny_whisper_config()

    def init(seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        return TW.init_whisper_params(gen, cfg, device="cpu")

    a, b, c = init(0), init(0), init(1)
    ja = JW.init_whisper_params(jax.random.PRNGKey(0), JW.tiny_whisper_config())
    shapes = [tuple(x.shape) for x in jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t, a))]
    assert shapes == [tuple(x.shape) for x in jax.tree_util.tree_leaves(ja)]
    assert torch.equal(a["decoder"]["embed_tokens"], b["decoder"]["embed_tokens"])
    assert not torch.equal(a["decoder"]["embed_tokens"], c["decoder"]["embed_tokens"])
    np.testing.assert_allclose(a["encoder"]["pos"].numpy(), np.asarray(ja["encoder"]["pos"]), atol=1e-6)


def test_cuda_is_the_default_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tp, _, tcfg = _pair("tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.TorchWhisperModel(tp, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.init_whisper_params(torch.Generator(), tcfg)
