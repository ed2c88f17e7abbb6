"""The port's Adafactor (train/trainer.OptaxAdafactor) against the JAX
Trainer's ``optax.adafactor`` chain, on the CPU at tiny sizes.

The config is tiny_lm_config with hidden_size 128 and intermediate_size 256,
so that every kind of leaf occurs: factored (the stacked MLP weights, the
codec projector's 128 x 128 ``w2``), unfactored (the attention weights, whose
second largest axis is 64, the norms, the embeddings and the head) and
stacked ``(L, ...)`` leaves, whose factor means and block RMS span both
layers. Tolerances are the AdamW tests' (tests/test_torch_train.py): metrics
relative 1e-4 per step, params max |port - JAX| / max |JAX| <= 1e-3 per
leaf, the port against itself exactly.
"""
import json

import jax
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.models import llama as jl
from realtime_codec_agent_tpu.parallel import make_mesh
from realtime_codec_agent_tpu.train import TrainConfig as JTrainConfig
from realtime_codec_agent_tpu.train import Trainer as JTrainer
from realtime_codec_agent_tpu_torch import train_duplex_lm as tcli
from realtime_codec_agent_tpu_torch.models import llama as tl
from realtime_codec_agent_tpu_torch.models.from_jax import adafactor_state_from_numpy, lm_params_from_numpy
from realtime_codec_agent_tpu_torch.train import TrainConfig, Trainer
from realtime_codec_agent_tpu_torch.train import checkpoint as ckpt
from realtime_codec_agent_tpu_torch.train.trainer import OptaxAdafactor, _factored_dims
from realtime_codec_agent_tpu_torch.utils.tree import tree_leaves

from test_torch_train import (  # noqa: F401  (the module fixture)
    CFG,
    _assert_metrics_close,
    _jax,
    _jax_leaves,
    _np,
    _one_intra_op_thread,
    _padded_batch,
    _rel,
    _write_dataset,
)

WIDE = dict(CFG, hidden_size=128, intermediate_size=256)
STEP_KW = dict(max_steps=10, warmup_steps=2, learning_rate=1e-2, grad_clip=0.5, weight_decay=0.1,
               log_every=100, max_seq_len=48, optimizer="adafactor")


@pytest.fixture(scope="module")
def wparams():
    cfg = jl.tiny_lm_config(**WIDE)
    return _np(jl.init_lm_params(jax.random.PRNGKey(0), cfg, with_codec_embed=True))


def _port(p, out_dir, **kw):
    return Trainer(lm_params_from_numpy(p), tl.tiny_lm_config(**WIDE),
                   TrainConfig(output_dir=str(out_dir), **dict(STEP_KW, **kw)), device="cpu")


def _jax_trainer(p, out_dir, **kw):
    return JTrainer(_jax(p), jl.tiny_lm_config(**WIDE), JTrainConfig(output_dir=str(out_dir), **dict(STEP_KW, **kw)),
                    mesh=make_mesh(1, 1, 1))


def test_factored_dims_follow_optax():
    """optax's _factored_dims on the shapes of this file and the full-width
    stacked layout."""
    from optax._src.factorized import _factored_dims as optax_dims

    for shape in [(128,), (2, 128), (2, 128, 64), (2, 64, 128), (2, 128, 256), (2, 256, 128), (128, 128),
                  (96, 128), (16, 128), (16, 2048, 8192), (16, 8192, 2048), (128256, 2048)]:
        assert _factored_dims(shape) == optax_dims(shape, True, 128), shape


@pytest.mark.parametrize("with_codec", [True, False])
def test_adafactor_three_steps_match_jax(wparams, with_codec, tmp_path):
    """Warmup 2, clipping active, weight decay 0.1 (added after the learning
    rate), the frozen codec table: metrics per step, then every param and
    every second-moment leaf, against the JAX Trainer."""
    p = wparams if with_codec else {k: v for k, v in wparams.items() if k != "codec_embed"}
    jt, tt = _jax_trainer(p, tmp_path / "jax"), _port(p, tmp_path / "port")
    assert isinstance(tt.optimizer, OptaxAdafactor)
    state = tt.opt_state
    factored, unfactored = set(state["v_row"]), set(state["v"])
    assert factored == set(state["v_col"]) and not factored & unfactored
    assert {"layers.w_gate", "layers.w_up", "layers.w_down"} <= factored  # stacked and factored
    assert {"layers.wq", "layers.attn_norm", "embed_tokens", "lm_head"} <= unfactored  # stacked or not
    assert ("codec_embed.projectors.0.w2" in factored) == with_codec
    assert "codec_embed.table" not in factored | unfactored
    batch, labels = _padded_batch(48, (40, 25, 48, 10), seed=3)
    for _ in range(3):
        mj, mt = jt.train_batch(batch, labels), tt.train_batch(batch, labels)
        _assert_metrics_close(mt, mj)
        assert mj["grad_norm"] > 0.5  # the clip is active
    jleaves = _jax_leaves(_np(jt.params))
    tleaves = {k: v.detach().numpy() for k, v in tree_leaves(tt.params)}
    assert jleaves.keys() == tleaves.keys()
    for k in jleaves:
        assert _rel(tleaves[k], jleaves[k]) <= 1e-3, (k, _rel(tleaves[k], jleaves[k]))
    if with_codec:
        np.testing.assert_array_equal(tleaves["codec_embed.table"], p["codec_embed"]["table"])
    jstate = adafactor_state_from_numpy(_np(jt.opt_state))
    tstate = tt.opt_state
    assert jstate["count"] == tstate["count"] == 3
    for kind in ("v_row", "v_col", "v"):
        assert jstate[kind].keys() == tstate[kind].keys(), kind
        for k, ref in jstate[kind].items():
            assert tstate[kind][k].shape == ref.shape, (kind, k)
            assert _rel(tstate[kind][k].numpy(), ref.numpy()) <= 1e-3, (kind, k)


def test_adafactor_without_weight_decay_or_warmup_matches_jax(wparams, tmp_path):
    """weight_decay 0 (optax gets weight_decay_rate=None: no decay term) and
    no warmup: the first step already moves the params."""
    kw = dict(weight_decay=0.0, warmup_steps=0, grad_clip=1e3)
    jt, tt = _jax_trainer(wparams, tmp_path / "jax", **kw), _port(wparams, tmp_path / "port", **kw)
    batch, labels = _padded_batch(48, (48, 31, 17, 40), seed=11)
    for _ in range(2):
        _assert_metrics_close(tt.train_batch(batch, labels), jt.train_batch(batch, labels))
    jleaves = _jax_leaves(_np(jt.params))
    for k, v in tree_leaves(tt.params):
        assert _rel(v.detach().numpy(), jleaves[k]) <= 1e-3, k


def test_adafactor_continues_from_jax_state(wparams, tmp_path):
    """Two JAX steps, then params (stacked layout) and optax's FactoredState
    carried across through from_jax (its (1,) placeholders dropped); two
    more steps on each side agree."""
    jt = _jax_trainer(wparams, tmp_path / "jax")
    batch, labels = _padded_batch(48, (48, 30, 41, 12), seed=4)
    for _ in range(2):
        jt.train_batch(batch, labels)
    tt = Trainer(lm_params_from_numpy(_np(jt.params)), tl.tiny_lm_config(**WIDE),
                 TrainConfig(output_dir=str(tmp_path / "port"), **STEP_KW), device="cpu")
    state = adafactor_state_from_numpy(_np(jt.opt_state))
    assert state["count"] == 2 and "codec_embed.table" not in state["v"]
    mine = tt.opt_state
    for kind in ("v_row", "v_col", "v"):
        assert state[kind].keys() == mine[kind].keys(), kind
        assert all(state[kind][k].shape == mine[kind][k].shape for k in mine[kind]), kind
    tt.opt_state, tt.step = state, jt.step
    for _ in range(2):
        _assert_metrics_close(tt.train_batch(batch, labels), jt.train_batch(batch, labels))
    jleaves = _jax_leaves(_np(jt.params))
    for k, v in tree_leaves(tt.params):
        assert _rel(v.detach().numpy(), jleaves[k]) <= 1e-3, k


def test_adafactor_checkpoint_resume_continues_identically(wparams, tmp_path):
    batch, labels = _padded_batch(48, (48, 33, 20, 47), seed=5)
    a = _port(wparams, tmp_path)
    for _ in range(2):
        a.train_batch(batch, labels)
    path = ckpt.save(str(tmp_path), a)
    b = _port(wparams, tmp_path)
    assert ckpt.restore_latest(str(tmp_path), b) and b.step == 2
    sa, sb = a.opt_state, b.opt_state
    assert sb["count"] == 2 and set(sb) == {"count", "v_row", "v_col", "v"}
    for kind in ("v_row", "v_col", "v"):
        assert sa[kind].keys() == sb[kind].keys()
        assert all(torch.equal(sa[kind][k], sb[kind][k]) for k in sa[kind]), kind
    for _ in range(2):
        assert b.train_batch(batch, labels) == a.train_batch(batch, labels)
    for (name, x), (_, y) in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y), name
    assert ckpt.latest_checkpoint(str(tmp_path)) == path


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_opt_state_restore_names_a_leaf_without_its_state(wparams, tmp_path, optimizer):
    """Restoring a state that lacks a leaf's keys, or gives it another
    kind's (v for a factored leaf), raises and names the leaf; the
    optimizer's state is left as it was."""
    t = _port(wparams, tmp_path, optimizer=optimizer)
    state = t.opt_state
    kind = "mu" if optimizer == "adamw" else "v_row"
    leaf = sorted(state[kind])[0]
    missing = dict(state, **{kind: {k: v for k, v in state[kind].items() if k != leaf}})
    with pytest.raises(KeyError, match=leaf):
        t.opt_state = missing
    if optimizer == "adafactor":
        other = dict(state, v={**state["v"], leaf: state["v_row"][leaf]}, v_row=missing["v_row"],
                     v_col={k: v for k, v in state["v_col"].items() if k != leaf})
        with pytest.raises(KeyError, match=leaf):
            t.opt_state = other
    t.opt_state = state
    assert t.opt_state[kind].keys() == state[kind].keys()


def test_cli_trains_with_adafactor_and_resumes(tmp_path, capsys):
    """``train_duplex_lm --optimizer adafactor`` for two steps, then a
    second call resumes from its checkpoint with the Adafactor state."""
    data = tmp_path / "data.txt"
    _write_dataset(data)
    out = tmp_path / "run"
    argv = ["--dataset", str(data), "--output_dir", str(out), "--tiny", "--device", "cpu", "--batch_size", "2",
            "--max_seq_len", "40", "--warmup_steps", "1", "--learning_rate", "1e-2", "--log_every", "1",
            "--eval_split_every_n", "0", "--compute_dtype", "float32", "--optimizer", "adafactor"]
    metrics = tcli.main(argv + ["--max_steps", "2"])
    assert all(np.isfinite(v) for v in metrics.values())
    state = torch.load(out / "checkpoint-2" / ckpt.STATE_FILE, weights_only=True)
    assert set(state["opt_state"]) == {"count", "v_row", "v_col", "v"} and state["opt_state"]["count"] == 2
    assert json.loads((out / "train_config.json").read_text())
    capsys.readouterr()
    tcli.main(argv + ["--max_steps", "3"])
    log = capsys.readouterr().out
    assert "Resumed from checkpoint at step 2" in log and "step 3:" in log
