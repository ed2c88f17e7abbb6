"""The port's span layer (utils/spans.py) and the training step's spans, on
the CPU: nothing kept without a profiler; under ``torch.profiler`` the
spans' names, steps and parents, their place in the profiler's timeline,
windows, spans that raise, a tiny ``Trainer.train_batch`` tiled by its
phases, and the benchmark's phase readers over such a window; the window's
counters (``ops/nn.dot_f32``'s FLOP by route) and their reader."""
import collections
import gc
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import ROOT, load_module
from realtime_codec_agent_tpu_torch.models import llama as tl
from realtime_codec_agent_tpu_torch.ops import nn as tnn
from realtime_codec_agent_tpu_torch.train import TrainConfig, Trainer
from realtime_codec_agent_tpu_torch.utils import spans

PHASES = ("train.h2d", "train.forward", "train.loss", "train.backward", "train.optimizer", "train.fetch")
READERS = ("forward_ms.train", "loss_ms.train", "backward_ms.train", "recompute_ms.train", "optimizer_ms.train",
           "host_wait_ms.train")
CFG = dict(vocab_size=96, codec_vocab_start=60, codebook_size=36, compute_dtype="float32", max_context=1024)
T, LOSS_BLOCK = 48, 16
STEPS = 3


@pytest.fixture(autouse=True)
def _fresh_spans():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.reset()
    yield
    spans.reset()
    torch.set_num_threads(n)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _trainer(policy: str = "flash") -> Trainer:
    cfg = tl.tiny_lm_config(**CFG)
    params = tl.init_lm_params(torch.Generator().manual_seed(0), cfg, with_codec_embed=True)
    tc = TrainConfig(output_dir="unused", remat=True, remat_policy=policy, loss_block_size=LOSS_BLOCK,
                     max_seq_len=T, warmup_steps=1)
    return Trainer(params, cfg, tc, device="cpu")


def _batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], size=(2, T)).astype(np.int32)
    labels = ids.copy()
    labels[1, 30:] = -100
    return ids, labels


def _profiled_steps(trainer: Trainer, pause_s: float = 0.0):
    """``STEPS`` steps under the profiler after one outside it (first-call
    work), ``pause_s`` of host work between steps, the collector off (its
    pauses land between phases)."""
    trainer.train_batch(*_batch(0))
    gc.collect()
    gc.disable()
    try:
        with _cpu_profile() as prof:
            for seed in range(1, STEPS + 1):
                if seed > 1:
                    time.sleep(pause_s)
                trainer.train_batch(*_batch(seed))
    finally:
        gc.enable()
    return prof


def _encloses(outer, inner) -> bool:
    return outer.time_range.start <= inner.time_range.start and inner.time_range.end <= outer.time_range.end


def test_off_is_one_shared_noop(monkeypatch):
    """No profiler: one shared context, no record_function, no event, no
    allocation, nothing kept; the recompute wrapper is the function itself."""
    def refuse(*args, **kwargs):
        raise AssertionError("called while no profiler runs")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(spans, "_On", refuse)  # the one object the span layer makes
    assert spans.span("train.step") is spans.span("train.forward")
    with spans.span("train.step") as sp:
        assert sp is None
    fn = lambda x: x  # noqa: E731
    assert spans.on_backward("train.recompute", fn) is fn
    assert spans.window() == []


def test_spans_nest_and_sit_in_the_profiler_timeline():
    """Names, steps and parents (a span opened on another thread takes the
    step's innermost open span as its parent); each span is a profiler event
    that encloses the aten ops issued inside it."""
    seen = []

    def on_other_thread():
        with spans.span("train.recompute"):
            seen.append(threading.get_ident())

    with _cpu_profile() as prof:
        for _ in range(2):
            with spans.span("train.step"):
                with spans.span("train.forward"):
                    torch.ones(64).add_(1)
                with spans.span("train.backward"):
                    worker = threading.Thread(target=on_other_thread)
                    worker.start()
                    worker.join(timeout=30)
                    assert not worker.is_alive()
                    torch.ones(64).mul_(2)
    win = spans.window()
    assert [s.name for s in win] == ["train.step", "train.forward", "train.backward", "train.recompute"] * 2
    assert [s.step for s in win] == [1] * 4 + [2] * 4
    for i in (0, 4):
        step, fwd, bwd, rec = win[i : i + 4]
        assert step.parent is None and fwd.parent == i and bwd.parent == i and rec.parent == i + 2
        assert rec.thread == seen[i // 4] != bwd.thread == step.thread
        assert step.host_start_ns <= fwd.host_start_ns <= fwd.host_end_ns <= bwd.host_start_ns
        assert bwd.host_start_ns <= rec.host_start_ns <= rec.host_end_ns <= bwd.host_end_ns <= step.host_end_ns
        assert all(s.device_ms >= 0 for s in (step, fwd, bwd, rec))
    events = prof.events()
    for name, op in (("train.forward", "aten::add_"), ("train.backward", "aten::mul_")):
        marks = [e for e in events if e.name == name]
        ops = [e for e in events if e.name == op]
        assert len(marks) == 2 and len(ops) == 2
        assert all(any(_encloses(m, o) for m in marks) for o in ops)


def test_a_new_window_starts_after_the_profiler_was_off():
    with _cpu_profile():
        with spans.span("train.step"):
            pass
    with _cpu_profile():  # no span between the two: one window
        with spans.span("train.step"):
            pass
    assert [s.step for s in spans.window()] == [1, 2]
    with spans.span("train.step"):  # off
        pass
    assert len(spans.window()) == 2
    with _cpu_profile():
        with spans.span("train.optimizer"):
            pass
    win = spans.window()
    assert [(s.name, s.step, s.parent) for s in win] == [("train.optimizer", 1, None)]


def test_a_span_that_raises_still_records():
    with _cpu_profile() as prof:
        with pytest.raises(RuntimeError, match="early stop"):
            with spans.span("train.step"):
                with spans.span("train.recompute"):
                    raise RuntimeError("early stop")
        with spans.span("train.step"):  # the stacks were left clean
            pass
    win = spans.window()
    assert [(s.name, s.step, s.parent) for s in win] == [
        ("train.step", 1, None), ("train.recompute", 1, 0), ("train.step", 2, None)]
    assert all(s.host_end_ns is not None and s.device_ms is not None for s in win)
    assert collections.Counter(e.name for e in prof.events() if e.name.startswith("train.")) == {
        "train.step": 2, "train.recompute": 1}


@pytest.mark.parametrize("policy,per_layer", [("flash", 2), ("full", 1), ("none", 0), ("dots", 1)])
def test_train_step_phases_under_the_profiler(policy, per_layer):
    """The phases in order, each a profiler event enclosing its aten ops;
    one recompute a checkpoint (the remat policy's per layer, then every
    loss block), each inside ``train.backward``; the phases tile the step's
    host interval to within 10%."""
    trainer = _trainer(policy)
    prof = _profiled_steps(trainer)
    win = spans.window()
    n_blocks = -(-(T - 1) // LOSS_BLOCK)
    n_layers = trainer.cfg.num_layers
    ratios = []
    for step in range(1, STEPS + 1):
        mine = [s for s in win if s.step == step]
        assert mine[0].name == "train.step" and mine[0].parent is None
        root = win.index(mine[0])
        assert [s.name for s in mine if s.name != "train.recompute"][1:] == list(PHASES)
        assert all(s.parent == root for s in mine if s.name in PHASES)
        bwd = next(s for s in mine if s.name == "train.backward")
        rec = [s for s in mine if s.name == "train.recompute"]
        assert len(rec) == per_layer * n_layers + n_blocks
        assert all(win[s.parent] is bwd and bwd.host_start_ns <= s.host_start_ns <= s.host_end_ns <= bwd.host_end_ns
                   for s in rec)
        host = lambda s: s.host_end_ns - s.host_start_ns  # noqa: E731
        ratios.append(sum(host(s) for s in mine if s.name in PHASES) / host(mine[0]))
    # a step the host did not interrupt (the others may hold a preemption)
    assert max(ratios) <= 1 and max(ratios) >= 0.9
    events = prof.events()
    names = collections.Counter(e.name for e in events if e.name.startswith("train."))
    assert names == collections.Counter(s.name for s in win)
    aten = [e for e in events if e.name.startswith("aten::")]
    for name in PHASES[1:5]:
        marks = [e for e in events if e.name == name]
        inside = [o for o in aten if any(_encloses(m, o) and o.thread == m.thread for m in marks)]
        assert inside, name


def _reader(name):
    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", "test_metric_" + name.replace(".", "_"))


@pytest.mark.parametrize("name", READERS)
def test_phase_readers_read_a_cpu_window(name):
    """Each reader reads the window (None on an empty one); the five phases
    and the host's wait, the pauses between steps included, tile the
    window's steps."""
    reader = _reader(name)
    assert reader.read({}) is None  # an empty window
    pause_ms = 30
    _profiled_steps(_trainer(), pause_s=pause_ms / 1e3)
    value = reader.read({})
    assert value is not None and value >= 0
    win = spans.window()
    parts = {r: _reader(r).read({}) for r in READERS}
    assert parts["recompute_ms.train"] < parts["backward_ms.train"]
    assert parts["host_wait_ms.train"] >= pause_ms * (STEPS - 1) / STEPS
    tiled = STEPS * sum(v for r, v in parts.items() if r != "recompute_ms.train")
    window_ms = max(s.device_end_ms for s in win) - win[0].device_start_ms
    assert 0.9 * window_ms <= tiled <= window_ms
    spans.reset()
    assert reader.read({}) is None


def test_counters_keep_the_dot_flop_of_the_window():
    """Each ``dot_f32`` call on the CPU adds 2 M K N to the f32 route's
    counter while a profiler runs, from any thread, and nothing without one;
    a window after the profiler was off starts from zero."""
    x, w = torch.ones(3, 4, 8), torch.ones(8, 5, dtype=torch.bfloat16)  # 12 rows: past B2
    tnn.dot_f32(x, w)
    assert spans.counters() == {}
    with _cpu_profile():
        tnn.dot_f32(x, w)
        worker = threading.Thread(target=tnn.dot_f32, args=(x[0], w))
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        tnn.qdot(x, {"q": torch.ones(8, 5, dtype=torch.int8), "s": torch.ones(5)})
    flop = 2 * 12 * 8 * 5
    assert spans.counters() == {tnn.F32_FLOP: flop + flop // 3 + flop}
    tnn.dot_f32(x, w)  # off: kept as it was, and the next window starts afresh
    assert spans.counters() == {tnn.F32_FLOP: flop + flop // 3 + flop}
    with _cpu_profile():
        with spans.span("train.step"):
            tnn.dot_f32(x, w)
    assert spans.counters() == {tnn.F32_FLOP: flop}
    assert [s.name for s in spans.window()] == ["train.step"]


def test_tc_gemm_share_reader():
    """The tensor-core share of the window's dot FLOP; None without counters
    (a program whose span layer has none),
    and None in a window without a dot."""
    reader = _reader("tc_gemm_share.train")
    assert reader.read({}) is None
    with _cpu_profile():
        tnn.dot_f32(torch.ones(4, 8), torch.ones(8, 2))
    assert reader.read({}) == 0.0  # the CPU takes the f32 route
    spans.count(tnn.F32_FLOP, 1)  # off: the next window starts afresh
    with _cpu_profile():
        spans.count(tnn.TENSOR_CORE_FLOP, 99)
        spans.count(tnn.F32_FLOP, 1)
    assert reader.read({}) == pytest.approx(0.99)
    counters = spans.counters
    try:
        del spans.counters
        assert reader.read({}) is None
    finally:
        spans.counters = counters
