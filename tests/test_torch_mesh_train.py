"""The port's training on a mesh (parallel/mesh.shard_params,
parallel/pipeline.py, the Trainer and train_duplex_lm with a mesh) on the
CPU, in gloo rank pools, against the JAX package on its 8 virtual CPU
devices.

Mirrors tests/test_pipeline_parallel.py case by case, the dp2 x fsdp2 x tp2
step of tests/test_spmd_clean.py and the checkpoint resume of
tests/test_train.py on default_mesh_shape(8), and adds a resume onto another
mesh and onto one device, three Adafactor steps on fsdp2 x tp2, each rank's
resident bytes, and a step in which every collective the card's gloo cannot
take on CUDA tensors raises.

Two module-scoped pools (tests/torch_dist_child.RankPool: spawned, one
torch thread each, every wait bounded, killed in teardown), of 8 and 4
ranks; a mesh smaller than its pool leaves the other ranks idle. The
children import no JAX: the parent computes the JAX references and hands
the children numpy. Seeded JAX params and batches of unequal row lengths,
f32. Tolerances: the GPipe cases' loss rtol 1e-6 and gradients rtol 2e-5,
atol 1e-6 (JAX's own pipelined-against-scan bounds) against both JAX's pp
= 1 scan and JAX's pipelined run; Trainer losses rtol 1e-5 and grad norms
rtol 1e-4 (JAX's test_trainer_on_pp_mesh bounds); the mesh against the
port's own single device where no cross-framework sum is involved (remat,
resumes) at rtol 1e-6 / 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from realtime_codec_agent_tpu.models import llama as jl
from realtime_codec_agent_tpu.parallel import make_mesh as jmake_mesh
from realtime_codec_agent_tpu.parallel import make_pipeline_forward as jmake_pipeline_forward
from realtime_codec_agent_tpu.parallel import shard_params as jshard_params
from realtime_codec_agent_tpu.train import TrainConfig as JTrainConfig
from realtime_codec_agent_tpu.train import Trainer as JTrainer
from realtime_codec_agent_tpu.train import pad_batch
from realtime_codec_agent_tpu.train.trainer import loss_and_metrics as jloss
from realtime_codec_agent_tpu_torch.models import llama as tl
from realtime_codec_agent_tpu_torch.models.from_jax import lm_params_from_numpy
from realtime_codec_agent_tpu_torch.parallel import lm_param_specs
from realtime_codec_agent_tpu_torch.train import TrainConfig, Trainer
from realtime_codec_agent_tpu_torch.train import checkpoint as ckpt

from test_torch_pipeline import one_torch_thread  # noqa: F401 (a module fixture)
from torch_dist_child import RankPool

VOCAB = 304
DP2_TP2_PP2 = dict(dp=2, fsdp=1, tp=2, pp=2)
DEFAULT_8 = dict(dp=2, fsdp=2, tp=2, pp=1)  # default_mesh_shape(8)


@pytest.fixture(scope="module")
def pool8():
    pool = RankPool(8)
    try:
        yield pool
    finally:
        pool.close()


@pytest.fixture(scope="module")
def pool4():
    pool = RankPool(4)
    try:
        yield pool
    finally:
        pool.close()


def f32_cfg(**overrides):
    return jl.tiny_lm_config(vocab_size=VOCAB, codec_vocab_start=200, codebook_size=104, compute_dtype="float32",
                             **overrides)


def rand_batch(bs=8, seq=48, seed=0):
    """tests/test_pipeline_parallel.py's batch: rows of unequal length."""
    rng = np.random.default_rng(seed)
    seqs = [list(rng.integers(1, VOCAB, size=seq - i % 5)) for i in range(bs)]
    return pad_batch(seqs, seq, pad_id=0)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _leaves(tree) -> dict:
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


def _kw(cfg) -> dict:
    return dataclasses.asdict(cfg)


def _on_mesh(results):
    return [r for r in results if r is not None]


def _assert_grads(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6, err_msg=f"{what}: {k}")


# ------------------------------------------------- test_pipeline_parallel.py

@pytest.mark.parametrize(
    "mesh_shape,n_layers,n_micro",
    [
        (dict(dp=2, fsdp=1, tp=2, pp=2), 2, 4),
        (dict(dp=1, fsdp=1, tp=2, pp=4), 4, 2),
        (dict(dp=1, fsdp=2, tp=1, pp=2), 4, 8),
    ],
)
def test_pipeline_matches_scan_forward(pool8, mesh_shape, n_layers, n_micro):
    """Loss and every gathered gradient through the port's staged pipeline
    == JAX's pp = 1 scan and JAX's own pipelined run."""
    cfg = f32_cfg(num_layers=n_layers)
    params = jl.stack_layer_params(jl.init_lm_params(jax.random.PRNGKey(0), cfg, with_codec_embed=True))
    batch, labels = rand_batch()
    params_np = _np(params)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(lambda p: jloss(p, batch, labels, cfg)[0]))(params)
    jmesh = jmake_mesh(**mesh_shape)
    jfwd = jmake_pipeline_forward(jmesh, n_micro)
    pp_loss, pp_grads = jax.jit(jax.value_and_grad(lambda p: jloss(p, batch, labels, cfg, forward_fn=jfwd)[0]))(
        jshard_params(params, jmesh, pp=True))

    ranks = _on_mesh(pool8.run("mesh_loss_grads", params_np, _kw(cfg), batch, labels, mesh_shape, n_micro))
    assert len(ranks) == int(np.prod(list(mesh_shape.values())))
    for r in ranks:  # every stage reports the global loss
        np.testing.assert_allclose(r["loss"], float(ref_loss), rtol=1e-6)
        np.testing.assert_allclose(r["loss"], float(pp_loss), rtol=1e-6)
        assert r["min_rows"] >= 1  # no stage runs an empty microbatch
    got = ranks[0]["grads"]
    _assert_grads(got, _leaves(ref_grads), "against JAX's scan")
    _assert_grads(got, _leaves(pp_grads), "against JAX's pipeline")
    # the layer stack really is staged: rank 0 holds its stage's layers,
    # its fsdp rows and its tp columns of wq
    h, q = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    want = (n_layers // mesh_shape["pp"], h // mesh_shape["fsdp"], q // mesh_shape["tp"])
    assert ranks[0]["local_shapes"]["layers.wq"] == want


def test_pipeline_long_blocks_with_fewer_rows_than_microbatches(pool4):
    """T > 512 (the flash path, B4 on the card) with 4 rows a rank and 8
    microbatches: the empty microbatches are dropped, never run (B4 takes
    no empty batch), and the loss and gradients equal JAX's scan."""
    cfg = f32_cfg(num_layers=2)
    params = jl.stack_layer_params(jl.init_lm_params(jax.random.PRNGKey(2), cfg))
    batch, labels = rand_batch(bs=8, seq=520, seed=3)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(lambda p: jloss(p, batch, labels, cfg)[0]))(params)
    shape = dict(dp=1, fsdp=2, tp=1, pp=2)
    ranks = _on_mesh(pool4.run("mesh_loss_grads", _np(params), _kw(cfg), batch, labels, shape, 8))
    assert len(ranks) == 4
    for r in ranks:
        assert r["min_rows"] == 1
        np.testing.assert_allclose(r["loss"], float(ref_loss), rtol=1e-6)
    _assert_grads(ranks[0]["grads"], _leaves(ref_grads), "against JAX's scan")


def test_pipeline_remat_matches(pool8):
    """Remat inside the stage body changes nothing numerically; both equal
    JAX's scan."""
    cfg = f32_cfg(num_layers=2)
    params = jl.stack_layer_params(jl.init_lm_params(jax.random.PRNGKey(1), cfg))
    batch, labels = rand_batch(bs=4, seq=32)
    ref_loss = float(jax.jit(lambda p: jloss(p, batch, labels, cfg)[0])(params))
    runs = [_on_mesh(pool8.run("mesh_loss_grads", _np(params), _kw(cfg), batch, labels, DP2_TP2_PP2, 2, remat))[0]
            for remat in (False, True)]
    plain, remat = runs
    np.testing.assert_allclose(remat["loss"], plain["loss"], rtol=1e-6)
    np.testing.assert_allclose(plain["loss"], ref_loss, rtol=1e-6)
    for k, g in plain["grads"].items():
        np.testing.assert_allclose(remat["grads"][k], g, rtol=1e-6, atol=1e-7, err_msg=k)


def test_pipeline_forward_validations(pool8):
    cfg = f32_cfg(num_layers=2)
    params_np = _np(jl.stack_layer_params(jl.init_lm_params(jax.random.PRNGKey(0), cfg)))
    for errors in _on_mesh(pool8.run("pipeline_errors", params_np, _kw(cfg), DP2_TP2_PP2, 3)):
        assert len(errors) == 2
        assert "batch 4 must divide microbatches=3" in errors[0]
        assert "pp axis" in errors[1]


def _write_lines(path, n=8, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            f.write("".join(chr(0x3000 + c) for c in rng.integers(0, 80, size=90)) + "\n")


def test_train_cli_on_pp_mesh(pool4, tmp_path):
    """train_duplex_lm --mesh dp,fsdp,tp,pp drives the pipelined trainer
    end to end on 4 gloo ranks; rank 0 writes the artifacts."""
    dataset = tmp_path / "data.txt"
    _write_lines(dataset)
    out = tmp_path / "run"
    argv = ["--dataset", str(dataset), "--output_dir", str(out), "--tiny", "--max_steps", "2", "--batch_size", "8",
            "--max_seq_len", "64", "--mesh", "1,1,2,2", "--pp_microbatches", "4", "--compute_dtype", "float32",
            "--eval_split_every_n", "0", "--eval_every", "1000", "--save_every", "1000", "--shuffle_buffer", "0",
            "--warmup_steps", "1", "--device", "cpu"]
    metrics = pool4.run("mesh_cli", argv, timeout=120.0)
    assert all(np.isfinite(m["loss"]) for m in metrics)
    assert len({m["loss"] for m in metrics}) == 1  # every rank reports the global loss
    assert (out / "checkpoint-2" / ckpt.STATE_FILE).exists() and (out / "params.torch" / ckpt.PARAMS_FILE).exists()
    loaded = ckpt.load_params(str(out / "params.torch"))
    assert isinstance(loaded["layers"], list) and len(loaded["layers"]) == 2


def _jax_trainer(params, cfg, tmp_path, mesh, **tc_kw):
    tc_kw.pop("output_dir", None)
    return JTrainer(jax.tree.map(jnp.asarray, params), cfg, JTrainConfig(output_dir=str(tmp_path / "jax"), **tc_kw),
                    mesh=mesh)


def test_trainer_on_pp_mesh(pool8, tmp_path):
    """The Trainer on dp2 x tp2 x pp2: the first step's loss and grad_norm
    are the JAX Trainer's on its mesh; a second step moves wq (the first
    step's learning rate is 0); a checkpoint restores into a Trainer from
    other params on the same mesh, and training resumes."""
    cfg = f32_cfg(num_layers=2)
    params = _np(jl.init_lm_params(jax.random.PRNGKey(0), cfg, with_codec_embed=True))
    tc_kw = dict(max_steps=5, warmup_steps=1, max_seq_len=48, pp_microbatches=4, remat=False)
    batch, labels = rand_batch()
    m_jax = _jax_trainer(params, cfg, tmp_path, jmake_mesh(**DP2_TP2_PP2), **tc_kw).train_batch(batch, labels)
    tc_kw["output_dir"] = str(tmp_path / "pp")
    ranks = _on_mesh(pool8.run("mesh_train", params, _kw(cfg), tc_kw, DP2_TP2_PP2, [(batch, labels)] * 2,
                               str(tmp_path / "pp")))
    for r in ranks:
        m1, m2 = r["metrics"]
        np.testing.assert_allclose(m1["loss"], m_jax["loss"], rtol=1e-5)
        np.testing.assert_allclose(m1["grad_norm"], m_jax["grad_norm"], rtol=1e-4)
        assert np.isfinite(m2["loss"])
    stacked = jl.stack_layer_params(params)
    assert not np.array_equal(ranks[0]["params"]["layers.wq"], np.asarray(stacked["layers"]["wq"]))
    other = _np(jl.init_lm_params(jax.random.PRNGKey(7), cfg, with_codec_embed=True))
    resumed = _on_mesh(pool8.run("mesh_resume", other, _kw(cfg), tc_kw, DP2_TP2_PP2, str(tmp_path / "pp"),
                                 [(batch, labels)]))
    assert all(r["restored_step"] == 2 for r in resumed)
    np.testing.assert_array_equal(resumed[0]["restored"]["layers.wq"], ranks[0]["params"]["layers.wq"])
    assert np.isfinite(resumed[0]["metrics"][0]["loss"])


# ----------------------------------------------------- test_spmd_clean.py

def test_spmd_steps_on_dp2_fsdp2_tp2_and_pp(pool8, tmp_path):
    """tests/test_spmd_clean.py's two steps run on the port's mesh: dp2 x
    fsdp2 x tp2 at the config's bf16, then dp2 x tp2 x pp2 at f32, each
    against the port's single device (bf16: the sums are reordered, so
    within bf16 rounding)."""
    cfg = jl.tiny_lm_config(vocab_size=512, codec_vocab_start=300, codebook_size=212)
    rng = np.random.default_rng(0)
    batch, labels = pad_batch([list(rng.integers(1, cfg.vocab_size, size=60)) for _ in range(8)], 64, pad_id=0)
    for shape, c, rtol, extra in ((DEFAULT_8, cfg, 2e-3, {}),
                                  (DP2_TP2_PP2, dataclasses.replace(cfg, compute_dtype="float32"), 1e-5,
                                   dict(pp_microbatches=4))):
        params = _np(jl.init_lm_params(jax.random.PRNGKey(0), c, with_codec_embed=True))
        tc_kw = dict(output_dir=str(tmp_path), max_steps=1, warmup_steps=0, max_seq_len=64, **extra)
        m_one = _port_one_device(params, c, tc_kw).train_batch(batch, labels)
        for r in _on_mesh(pool8.run("mesh_train", params, _kw(c), tc_kw, shape, [(batch, labels)])):
            m = r["metrics"][0]
            assert np.isfinite(m["loss"]), shape
            np.testing.assert_allclose(m["loss"], m_one["loss"], rtol=rtol, err_msg=str(shape))
            np.testing.assert_allclose(m["grad_norm"], m_one["grad_norm"], rtol=10 * rtol, err_msg=str(shape))


# ----------------------------------------------------------- test_train.py

def _port_one_device(params, cfg, tc_kw):
    return Trainer(lm_params_from_numpy(params), tl.DuplexLMConfig(**_kw(cfg)), TrainConfig(**tc_kw), device="cpu")


def test_checkpoint_save_resume_on_mesh_another_mesh_and_one_device(pool8, pool4, tmp_path):
    """tests/test_train.py's checkpoint resume on default_mesh_shape(8)
    (dp2 x fsdp2 x tp2): two steps, a checkpoint, a Trainer from other
    params restored at step 2 with the same wq, a third step; the first two
    steps against the JAX Trainer on its mesh. The same checkpoint resumes
    on fsdp2 x pp2 and on one device, each third step equal to the mesh's."""
    cfg = jl.tiny_lm_config(vocab_size=VOCAB, codec_vocab_start=200, codebook_size=104, compute_dtype="float32")
    params = _np(jl.init_lm_params(jax.random.PRNGKey(0), cfg, with_codec_embed=True))
    tc_kw = dict(max_steps=5, warmup_steps=1, log_every=100, max_seq_len=64, pp_microbatches=2)
    rng = np.random.default_rng(0)
    batch, labels = pad_batch([list(rng.integers(1, VOCAB, size=60)) for _ in range(8)], 64, pad_id=0)
    jt = _jax_trainer(params, cfg, tmp_path, jmake_mesh(**DEFAULT_8), **tc_kw)
    m_jax = [jt.train_batch(batch, labels) for _ in range(2)]
    run = str(tmp_path / "run")
    ranks = _on_mesh(pool8.run("mesh_train", params, _kw(cfg), dict(tc_kw, output_dir=run), DEFAULT_8,
                               [(batch, labels)] * 2, run))
    for mj, mt in zip(m_jax, ranks[0]["metrics"]):
        np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=1e-5)
        np.testing.assert_allclose(mt["grad_norm"], mj["grad_norm"], rtol=1e-4)
    saved_wq = ranks[0]["params"]["layers.wq"]
    other = _np(jl.init_lm_params(jax.random.PRNGKey(7), cfg, with_codec_embed=True))
    same = _on_mesh(pool8.run("mesh_resume", other, _kw(cfg), dict(tc_kw, output_dir=run), DEFAULT_8, run,
                              [(batch, labels)]))
    assert same[0]["restored_step"] == 2
    np.testing.assert_array_equal(same[0]["restored"]["layers.wq"], saved_wq)
    third = same[0]["metrics"][0]
    assert np.isfinite(third["loss"])
    moved = _on_mesh(pool4.run("mesh_resume", other, _kw(cfg), dict(tc_kw, output_dir=run),
                               dict(dp=1, fsdp=2, tp=1, pp=2), run, [(batch, labels)]))
    np.testing.assert_array_equal(moved[0]["restored"]["layers.wq"], saved_wq)
    one = _port_one_device(other, cfg, dict(tc_kw, output_dir=run))
    assert ckpt.restore_latest(run, one) and one.step == 2
    np.testing.assert_array_equal(one.params["layers"]["wq"].detach().numpy(), saved_wq)
    m_one = one.train_batch(batch, labels)
    for m in (moved[0]["metrics"][0], m_one):
        np.testing.assert_allclose(m["loss"], third["loss"], rtol=1e-6)
        np.testing.assert_allclose(m["grad_norm"], third["grad_norm"], rtol=1e-5)


# ------------------------------------------------------------------ added

def test_adafactor_three_steps_on_fsdp2_tp2_match_jax(pool4, tmp_path):
    """Adafactor's factored means and block RMS over the shards: three
    steps on fsdp2 x tp2 (hidden 128 / intermediate 256, so factored,
    unfactored and stacked leaves all occur) against the JAX Trainer on
    the same mesh; then the gathered factored moments."""
    cfg = jl.tiny_lm_config(vocab_size=VOCAB, codec_vocab_start=200, codebook_size=104, compute_dtype="float32",
                            hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=2, head_dim=32)
    params = _np(jl.init_lm_params(jax.random.PRNGKey(3), cfg, with_codec_embed=True))
    tc_kw = dict(max_steps=10, warmup_steps=1, learning_rate=1e-2, grad_clip=0.5, weight_decay=0.1,
                 max_seq_len=48, optimizer="adafactor")
    batch, labels = rand_batch(bs=4)
    shape = dict(dp=1, fsdp=2, tp=2, pp=1)
    jt = _jax_trainer(params, cfg, tmp_path, jmake_mesh(**shape), **tc_kw)
    m_jax = [jt.train_batch(batch, labels) for _ in range(3)]
    ranks = _on_mesh(pool4.run("mesh_train", params, _kw(cfg), dict(tc_kw, output_dir=str(tmp_path / "p")), shape,
                               [(batch, labels)] * 3))
    for r in ranks:
        for mj, mt in zip(m_jax, r["metrics"]):
            np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=1e-5)
            np.testing.assert_allclose(mt["grad_norm"], mj["grad_norm"], rtol=1e-4)
    jparams = _leaves(jt.params)
    for k, v in ranks[0]["params"].items():
        assert np.abs(v - jparams[k]).max() <= 1e-4 * max(np.abs(jparams[k]).max(), 1.0), k
    one = _port_one_device(params, cfg, dict(tc_kw, output_dir=str(tmp_path / "o")))
    for _ in range(3):
        one.train_batch(batch, labels)
    for kind in ("v_row", "v_col", "v"):
        mine = one.opt_state[kind]
        assert ranks[0]["opt_state"][kind].keys() == mine.keys()
        for k, v in mine.items():
            np.testing.assert_allclose(ranks[0]["opt_state"][kind][k], v.numpy(), rtol=1e-4, atol=1e-10,
                                       err_msg=f"{kind} {k}")


def _slice(nbytes: int, spec, shape) -> int:
    return nbytes // int(np.prod([shape[a] for d in range(len(spec.entries)) for a in spec.axes(d)]))


def _resident_want(whole, shape, optimizer):
    """(param bytes, optimizer state bytes) of a rank's slices on a mesh of
    ``shape``: each leaf's (or moment's) bytes over the product of the axes
    it is split over; Adafactor's factored moments drop the axis each is a
    mean over. The frozen codec table has no state."""
    from realtime_codec_agent_tpu_torch.train.trainer import _factored_dims
    from realtime_codec_agent_tpu_torch.utils.tree import tree_leaves

    spec_of = dict(tree_leaves(lm_param_specs(whole, pp=shape["pp"] > 1)))
    params = state = 0
    for path, t in tree_leaves(whole):
        s, n = spec_of[path], t.numel() * t.element_size()
        params += _slice(n, s, shape)
        if path == "codec_embed.table":
            continue
        dims = _factored_dims(tuple(t.shape)) if optimizer == "adafactor" else None
        if optimizer == "adamw":
            state += 2 * _slice(n, s, shape)
        elif dims is None:
            state += _slice(n, s, shape)
        else:
            d1, d0 = dims
            state += _slice(n // t.shape[d0], s.without(d0), shape) + _slice(n // t.shape[d1], s.without(d1), shape)
    return params, state


@pytest.mark.parametrize("shape,optimizer", [(DP2_TP2_PP2, "adamw"), (dict(dp=1, fsdp=2, tp=2, pp=2), "adamw"),
                                             (dict(dp=1, fsdp=2, tp=2, pp=1), "adafactor")])
def test_each_rank_holds_its_slice(pool8, tmp_path, shape, optimizer):
    """At rest a rank's params and optimizer state are its slices' bytes
    (``lm_param_specs``), after a step."""
    cfg = f32_cfg(num_layers=2, hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=2, head_dim=32)
    params = _np(jl.init_lm_params(jax.random.PRNGKey(0), cfg, with_codec_embed=True))
    tc_kw = dict(output_dir=str(tmp_path), max_steps=5, warmup_steps=1, max_seq_len=32, optimizer=optimizer)
    batch, labels = rand_batch(bs=8, seq=32)
    ranks = _on_mesh(pool8.run("mesh_train", params, _kw(cfg), tc_kw, shape, [(batch, labels)]))
    want = _resident_want(tl.stack_layer_params(lm_params_from_numpy(params)), shape, optimizer)
    assert len(ranks) == int(np.prod(list(shape.values())))
    for r in ranks:
        assert (r["resident"]["params"], r["resident"]["state"]) == want


def test_card_route_uses_no_collective_gloo_refuses_on_cuda(pool8, tmp_path):
    """A dp2 x tp2 x pp2 step (and its checkpoint) with all_gather,
    reduce_scatter, send, recv and all_to_all made to raise, so the CPU
    runs the route the card's gloo runs: it completes with the unguarded
    step's metrics."""
    cfg = f32_cfg(num_layers=2)
    params = _np(jl.init_lm_params(jax.random.PRNGKey(0), cfg, with_codec_embed=True))
    batch, labels = rand_batch()
    tc_kw = dict(max_steps=5, warmup_steps=0, max_seq_len=48, pp_microbatches=4)
    plain = _on_mesh(pool8.run("mesh_train", params, _kw(cfg), dict(tc_kw, output_dir=str(tmp_path / "a")),
                               DP2_TP2_PP2, [(batch, labels)]))
    guarded = _on_mesh(pool8.run("guarded", "mesh_train", params, _kw(cfg), dict(tc_kw, output_dir=str(tmp_path / "b")),
                                 DP2_TP2_PP2, [(batch, labels)], str(tmp_path / "b")))
    assert [r["metrics"] for r in guarded] == [r["metrics"] for r in plain]
    assert (tmp_path / "b" / "checkpoint-1" / ckpt.STATE_FILE).exists()
