"""The port's training path (models/llama training mode, train/, the CLI)
against the JAX package's, on the CPU at tiny sizes.

Seeded JAX params (numpy, through models/from_jax) and seeded numpy batches
go through both sides, f32 compute. Tolerances:

- loss, accuracy, token counts and grad norms: relative 1e-4 per step (f32;
  the two frameworks sum in different orders);
- gradients and params after three optimizer steps: max |port - JAX| / max
  |JAX| per leaf <= 1e-3 (AdamW divides each gradient by the root of its
  own second moment, so entries whose gradients are tiny move by a full
  step either way and amplify the f32 rounding of the sums; the metrics
  above are the end-to-end check);
- remat policies, stacked against unrolled, resumed against uninterrupted:
  the port against itself, equal to f32 rounding (1e-6) or exactly.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.models import llama as jl
from realtime_codec_agent_tpu.parallel import make_mesh
from realtime_codec_agent_tpu.tokenization import CodecTextTokenizer as JTokenizer
from realtime_codec_agent_tpu.train import TrainConfig as JTrainConfig
from realtime_codec_agent_tpu.train import Trainer as JTrainer
from realtime_codec_agent_tpu.train import dataset as jdataset
from realtime_codec_agent_tpu.train import embedding_bridge as jbridge
from realtime_codec_agent_tpu.train import loss_and_metrics as jloss
from realtime_codec_agent_tpu_torch import train_duplex_lm as tcli
from realtime_codec_agent_tpu_torch.models import llama as tl
from realtime_codec_agent_tpu_torch.models.from_jax import adamw_state_from_numpy, lm_params_from_numpy
from realtime_codec_agent_tpu_torch.tokenization import CodecTextTokenizer
from realtime_codec_agent_tpu_torch.train import TrainConfig, Trainer, loss_and_metrics, pad_batch
from realtime_codec_agent_tpu_torch.train import checkpoint as ckpt
from realtime_codec_agent_tpu_torch.train import dataset as tdataset
from realtime_codec_agent_tpu_torch.train import embedding_bridge as tbridge
from realtime_codec_agent_tpu_torch.utils.tree import tree_leaves

VOCAB, CODEC_START, CODEBOOK = 96, 60, 36


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The suite runs several workers on one machine: one torch thread each
    keeps these many small CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
CFG = dict(vocab_size=VOCAB, codec_vocab_start=CODEC_START, codebook_size=CODEBOOK,
           compute_dtype="float32", max_context=1024)
STEP_KW = dict(max_steps=10, warmup_steps=2, learning_rate=1e-2, grad_clip=0.5, weight_decay=0.1,
               log_every=100, max_seq_len=48)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _key(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _jax_leaves(tree):
    return {_key(p): np.asarray(a) for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def _assert_metrics_close(port, ref, rtol=1e-4):
    assert set(port) == set(ref)
    for k in ref:
        assert port[k] == pytest.approx(ref[k], rel=rtol), (k, port[k], ref[k])


@pytest.fixture(scope="module")
def jparams():
    """Seeded JAX params with the codec branch (list layout), as numpy: the
    JAX Trainer donates the arrays it is given, so each use makes its own
    (``_jax``)."""
    cfg = jl.tiny_lm_config(**CFG)
    return _np(jl.init_lm_params(jax.random.PRNGKey(0), cfg, with_codec_embed=True))


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _padded_batch(t, lengths, seed):
    rng = np.random.default_rng(seed)
    seqs = [list(rng.integers(1, VOCAB, size=n)) for n in lengths]
    return pad_batch(seqs, t, pad_id=0)


@pytest.mark.parametrize("loss_block", [None, 512])
def test_loss_and_metrics_and_grads_match_jax(jparams, loss_block):
    """T = 640 (> 512: the flash path, B4's plain versions in the port), a
    padded row, the codec branch; the full route and the blockwise route
    (639 shifted tokens -> 2 blocks of 512, the tail padded with -100)."""
    batch, labels = _padded_batch(640, (640, 500), seed=1)
    cfg = jl.tiny_lm_config(**CFG)

    def f(p):
        return jloss(p, jnp.asarray(batch), jnp.asarray(labels), cfg, loss_block=loss_block)

    (jl_loss, jmet), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(_jax(jparams))

    params = lm_params_from_numpy(jparams)
    leaves = tree_leaves(params)
    for _, t in leaves:
        t.requires_grad_(True)
    loss, met = loss_and_metrics(
        params, torch.from_numpy(batch), torch.from_numpy(labels), tl.tiny_lm_config(**CFG), loss_block=loss_block
    )
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    assert float(loss.detach()) == pytest.approx(float(jl_loss), rel=1e-5)
    assert float(met["accuracy"]) == pytest.approx(float(jmet["accuracy"]), rel=1e-5)
    assert int(met["n_tokens"]) == int(jmet["n_tokens"]) == 639 + 499
    jg = _jax_leaves(jgrads)
    assert set(jg) == {p for p, _ in leaves}
    for (path, _), g in zip(leaves, grads):
        assert _rel(g.numpy(), jg[path]) <= 1e-3, (path, _rel(g.numpy(), jg[path]))


def test_remat_policies_and_stacked_layout_give_the_same_gradients(jparams):
    """Every remat policy, on the stacked and the unrolled layout, gives the
    unrolled no-remat gradients (T = 600: the flash path under remat)."""
    batch, labels = _padded_batch(600, (600, 420), seed=2)
    base_cfg = tl.tiny_lm_config(**CFG)
    results = {}
    for layout in ("list", "stacked"):
        for policy in (*tl.REMAT_POLICIES, "attn"):
            params = lm_params_from_numpy(jparams)
            if layout == "stacked":
                params = tl.stack_layer_params(params)
            leaves = tree_leaves(params)
            for _, t in leaves:
                t.requires_grad_(True)
            cfg = dataclasses.replace(base_cfg, remat=policy != "none", remat_policy=policy)
            loss, _ = loss_and_metrics(params, torch.from_numpy(batch), torch.from_numpy(labels), cfg, loss_block=256)
            grads = torch.autograd.grad(loss, [t for _, t in leaves])
            if layout == "stacked":  # compare per layer
                grads = [g for (p, _), g in zip(leaves, grads)]
                names = [p for p, _ in leaves]
                flat = {}
                for name, g in zip(names, grads):
                    if name.startswith("layers."):
                        for i in range(g.shape[0]):
                            flat[f"layers.{i}.{name[7:]}"] = g[i]
                    else:
                        flat[name] = g
            else:
                flat = {p: g for (p, _), g in zip(leaves, grads)}
            results[(layout, policy)] = (float(loss.detach()), flat)
    ref_loss, ref = results[("list", "none")]
    for key, (loss, flat) in results.items():
        assert loss == pytest.approx(ref_loss, rel=1e-6), key
        assert flat.keys() == ref.keys()
        for name in ref:
            torch.testing.assert_close(flat[name], ref[name], rtol=1e-6, atol=1e-7, msg=f"{key} {name}")


@pytest.mark.parametrize("with_codec", [True, False])
def test_trainer_three_steps_match_jax(jparams, with_codec, tmp_path):
    """Warmup 2 (the first step's learning rate is 0), clipping active
    (grad_clip 0.5 below the gradient norms), weight decay, the frozen codec
    table: metrics per step, then every param, against the JAX Trainer."""
    p = jparams if with_codec else {k: v for k, v in jparams.items() if k != "codec_embed"}
    cfg = jl.tiny_lm_config(**CFG)
    jt = JTrainer(_jax(p), cfg, JTrainConfig(output_dir=str(tmp_path / "jax"), **STEP_KW), mesh=make_mesh(1, 1, 1))
    tt = Trainer(lm_params_from_numpy(p), tl.tiny_lm_config(**CFG),
                 TrainConfig(output_dir=str(tmp_path / "port"), **STEP_KW), device="cpu")
    batch, labels = _padded_batch(48, (40, 25, 48, 10), seed=3)
    for step in range(3):
        mj, mt = jt.train_batch(batch, labels), tt.train_batch(batch, labels)
        _assert_metrics_close(mt, mj)
        assert mj["grad_norm"] > 0.5  # the clip is active
    jleaves = _jax_leaves(_np(jt.params))
    tleaves = {k: v.detach().numpy() for k, v in tree_leaves(tt.params)}
    assert jleaves.keys() == tleaves.keys()
    for k in jleaves:
        assert _rel(tleaves[k], jleaves[k]) <= 1e-3, (k, _rel(tleaves[k], jleaves[k]))
    if with_codec:  # frozen in both
        np.testing.assert_array_equal(tleaves["codec_embed.table"], p["codec_embed"]["table"])
        np.testing.assert_array_equal(jleaves["codec_embed.table"], p["codec_embed"]["table"])
    ev_j = jt.eval_batches(iter([(batch, labels)]))
    ev_t = tt.eval_batches(iter([(batch, labels)]))
    _assert_metrics_close(ev_t, ev_j)


def test_training_continues_from_jax_state(jparams, tmp_path):
    """Two JAX steps, then params (stacked layout) and the optax AdamW state
    carried across through from_jax; two more steps on each side agree."""
    cfg = jl.tiny_lm_config(**CFG)
    jt = JTrainer(_jax(jparams), cfg, JTrainConfig(output_dir=str(tmp_path / "jax"), **STEP_KW),
                  mesh=make_mesh(1, 1, 1))
    batch, labels = _padded_batch(48, (48, 30, 41, 12), seed=4)
    for _ in range(2):
        jt.train_batch(batch, labels)
    tt = Trainer(lm_params_from_numpy(_np(jt.params)), tl.tiny_lm_config(**CFG),
                 TrainConfig(output_dir=str(tmp_path / "port"), **STEP_KW), device="cpu")
    state = adamw_state_from_numpy(_np(jt.opt_state))
    assert state["count"] == 2 and "codec_embed.table" not in state["mu"]
    assert state["mu"].keys() == tt.opt_state["mu"].keys()
    tt.opt_state, tt.step = state, jt.step
    for _ in range(2):
        _assert_metrics_close(tt.train_batch(batch, labels), jt.train_batch(batch, labels))


def _port_trainer(jparams, out_dir):
    return Trainer(lm_params_from_numpy(jparams), tl.tiny_lm_config(**CFG),
                   TrainConfig(output_dir=str(out_dir), **STEP_KW), device="cpu")


def test_checkpoint_resume_continues_identically(jparams, tmp_path):
    batch, labels = _padded_batch(48, (48, 33, 20, 47), seed=5)
    a = _port_trainer(jparams, tmp_path)
    for _ in range(2):
        a.train_batch(batch, labels)
    path = ckpt.save(str(tmp_path), a)
    assert os.path.basename(path) == "checkpoint-2" and ckpt.latest_checkpoint(str(tmp_path)) == path
    b = _port_trainer(jparams, tmp_path)
    assert ckpt.restore_latest(str(tmp_path), b) and b.step == 2
    for _ in range(2):
        assert b.train_batch(batch, labels) == a.train_batch(batch, labels)
    for (name, x), (_, y) in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y), name
    # bare params: saved stacked or not, loaded in the inference layout
    loaded = ckpt.load_params(ckpt.save_params(str(tmp_path / "deploy"), a.params))
    assert isinstance(loaded["layers"], list) and len(loaded["layers"]) == 2
    assert torch.equal(loaded["layers"][1]["wq"], a.params["layers"]["wq"][1].detach())
    from_ckpt = ckpt.load_params(path)
    assert isinstance(from_ckpt["layers"], list)


def test_dataset_batches_match_jax(tmp_path):
    path = tmp_path / "data.txt"
    rng = np.random.default_rng(6)
    with open(path, "w", encoding="utf-8") as f:
        for i in range(37):
            codes = "".join(chr(0xE000 + int(c)) for c in rng.integers(0, 64, size=int(rng.integers(0, 30))))
            f.write(f"<|audio|> A: line {i}{codes}\n" if i % 5 else "\n")
    jt, tt = JTokenizer(codebook_size=64), CodecTextTokenizer(codebook_size=64)
    for kw in (dict(eval_every_n=4, is_eval=False), dict(eval_every_n=4, is_eval=True), dict()):
        jit_ = jdataset.repeat_batches(str(path), jt, 3, 40, shuffle_buffer=5, seed=9, **kw)
        tit = tdataset.repeat_batches(str(path), tt, 3, 40, shuffle_buffer=5, seed=9, **kw)
        for _ in range(25):
            jb, tb = next(jit_, None), next(tit, None)
            if jb is None:
                assert tb is None
                break
            np.testing.assert_array_equal(tb[0], jb[0])
            np.testing.assert_array_equal(tb[1], jb[1])


def test_persist_and_verify_matches_jax(jparams):
    cfg = jl.tiny_lm_config(**CFG)
    table = np.random.default_rng(7).normal(size=(CODEBOOK, cfg.codebook_dim)).astype(np.float32)
    jp = jl.set_codec_embeddings(_jax(jparams), table, cfg)
    jvanilla, jerr = jbridge.persist_and_verify(jp, cfg, batch_size=16)
    tp = tl.set_codec_embeddings(lm_params_from_numpy(jparams), table, tl.tiny_lm_config(**CFG))
    tvanilla, terr = tbridge.persist_and_verify(tp, tl.tiny_lm_config(**CFG), batch_size=16)
    assert "codec_embed" not in tvanilla and jerr < 1e-2 and terr < 1e-2
    np.testing.assert_allclose(tvanilla["embed_tokens"].numpy(), np.asarray(jvanilla["embed_tokens"]), atol=1e-5)


def _write_dataset(path, n=24, seed=8):
    rng = np.random.default_rng(seed)
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n):
            codes = "".join(chr(0xE000 + int(c)) for c in rng.integers(0, 64, size=int(rng.integers(4, 40))))
            f.write(f"<|audio|>{codes}<|end_audio|> A: turn {i}\n")


def test_cli_end_to_end_and_resume(tmp_path, capsys):
    """The port's CLI on the CPU: tiny model, a codec table file (the dual
    route and the frozen table), an eval split, persisted embeddings; then a
    second call with two more steps resumes from the first call's
    checkpoint."""
    data = tmp_path / "data.txt"
    _write_dataset(data)
    table = tmp_path / "codec.npy"
    np.save(table, np.random.default_rng(9).normal(size=(1, 64, 16)).astype(np.float32))
    out = tmp_path / "run"
    argv = ["--dataset", str(data), "--output_dir", str(out), "--codec_embed_file", str(table), "--tiny",
            "--device", "cpu", "--batch_size", "3", "--max_seq_len", "40", "--warmup_steps", "1",
            "--learning_rate", "1e-2", "--eval_split_every_n", "4", "--log_every", "1",
            "--compute_dtype", "float32", "--persist_embeddings", "--remat_policy", "flash"]
    metrics = tcli.main(argv + ["--max_steps", "3"])
    assert all(np.isfinite(v) for v in metrics.values())
    assert {"loss", "accuracy", "grad_norm", "eval_loss", "perplexity"} <= set(metrics)
    assert (out / "checkpoint-3" / ckpt.STATE_FILE).exists()
    assert (out / "params.torch" / ckpt.PARAMS_FILE).exists()
    assert (out / "params-vanilla.torch" / ckpt.PARAMS_FILE).exists()
    assert (out / "codec_tokenizer.json").exists()
    info = json.loads((out / "train_config.json").read_text())
    assert info["codec_vocab_start"] == CodecTextTokenizer(codebook_size=64).codec_vocab_start
    capsys.readouterr()
    tcli.main(argv + ["--max_steps", "5"])
    log = capsys.readouterr().out
    assert "Resumed from checkpoint at step 3" in log and "step 5:" in log and "step 3:" not in log
    assert (out / "checkpoint-5" / ckpt.STATE_FILE).exists()
    params = ckpt.load_params(str(out / "params.torch"))
    assert "codec_embed" in params and isinstance(params["layers"], list)


def test_unported_options_raise(jparams, tmp_path, monkeypatch):
    p = lm_params_from_numpy(jparams)
    cfg = tl.tiny_lm_config(**CFG)
    # Adafactor is ported (tests/test_torch_adafactor.py holds it to the JAX Trainer)
    assert set(Trainer(p, cfg, TrainConfig(optimizer="adafactor"), device="cpu").opt_state) == {
        "count", "v_row", "v_col", "v"}
    with pytest.raises(ValueError, match="unknown optimizer"):
        Trainer(p, cfg, TrainConfig(optimizer="sgd"), device="cpu")
    with pytest.raises(TypeError, match="a mesh from parallel.make_mesh"):
        Trainer(p, cfg, TrainConfig(), mesh=object(), device="cpu")
    # no pp axis: pp_microbatches is ignored, as the JAX Trainer ignores it
    # (meshes: tests/test_torch_mesh_train.py)
    assert Trainer(p, cfg, TrainConfig(pp_microbatches=4), device="cpu").shards is None
    data = tmp_path / "data.txt"
    _write_dataset(data, n=4)
    hf = tmp_path / "hf"
    hf.mkdir()
    (hf / "config.json").write_text("{}")
    base = ["--dataset", str(data), "--output_dir", str(tmp_path / "o"), "--tiny", "--device", "cpu"]
    with pytest.raises(KeyError, match="vocab_size"):  # as the JAX CLI on an empty config.json
        tcli.main(base + ["--init_from", str(hf)])
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):  # no launcher: one device
        tcli.main(base + ["--mesh", "2,1,1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(p, cfg, TrainConfig(), device="cuda")
