"""The training cell run whole at tiny sizes on the CPU (the harness's look
for a card skipped): the printed result line, and ``correct`` coming out
false when the timed path is broken underneath."""
from __future__ import annotations

import io
import json

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import tiny_cell

TRAIN = "qwen2.5-0.5b.train-b8"
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(workload, trace=False, seed=2147483659, seconds=1.5):
    return harness.run_cell(tiny_cell(workload), seed, seconds, trace, device="cpu")


def line_of(result):
    out, err = io.StringIO(), io.StringIO()
    harness.emit(result, out, err)
    assert err.getvalue().splitlines()[-1].startswith("check ")
    return json.loads(out.getvalue().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    line = line_of(run(TRAIN, trace))
    assert set(line) == KEYS | ({"breakdown"} if trace else set())
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    cell = tiny_cell(TRAIN)
    want = {m["name"] for m in (cell.per_layer() if trace else cell.end_to_end())}
    got = set(line["metrics"])
    if trace:  # the device readers find nothing to read on the CPU and stay silent
        assert got <= want and got
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert got == want and all(v["value"] > 0 for v in line["metrics"].values())
    assert all(c["limit"] is not None for c in line["checks"].values())


def test_same_seed_same_inputs():
    from benchmark import weights
    from benchmark.drivers.train import batches

    cell = tiny_cell(TRAIN)
    a = weights.make_lm(cell.config, 2**31 + 5, "cpu")
    b = weights.make_lm(cell.config, 2**31 + 5, "cpu")
    assert torch.equal(a["embed_tokens"], b["embed_tokens"])
    assert not torch.equal(a["embed_tokens"], weights.make_lm(cell.config, 2**31 + 6, "cpu")["embed_tokens"])
    x, y = batches(cell.config, cell.traffic, 7), batches(cell.config, cell.traffic, 7)
    assert all((p[0] == q[0]).all() for p, q in zip(x, y))
    z = batches(cell.config, cell.traffic, 8)
    assert sorted(int((l != -100).sum()) for l in (p[1] for p in x)) == sorted(
        int((l != -100).sum()) for l in (p[1] for p in z))  # the same sizes for every seed


def test_fault_state_unchanged(monkeypatch):
    from realtime_codec_agent_tpu_torch.train import trainer

    def no_step(self, closure=None):
        self.count += 1

    monkeypatch.setattr(trainer.OptaxAdamW, "step", no_step)
    r = run(TRAIN)
    assert r["correct"] is False and r["checks"]["change_gap"]["value"] > r["checks"]["change_gap"]["limit"]


def test_fault_half_batch(monkeypatch):
    from realtime_codec_agent_tpu_torch.train import trainer

    orig = trainer.loss_and_metrics

    def half(params, batch, labels, *a, **k):
        n = batch.shape[0] // 2
        return orig(params, batch[:n], labels[:n], *a, **k)

    monkeypatch.setattr(trainer, "loss_and_metrics", half)
    assert run(TRAIN)["correct"] is False


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", TRAIN, "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_control_rounds_the_backward_products():
    """The control's matmul rounds the inputs of the backward's two products
    as well as the forward's."""
    from benchmark.reference.lm import fp8_round
    from benchmark.reference.train import rounded_mm

    gen = torch.Generator().manual_seed(3)
    a = torch.randn(5, 7, generator=gen).requires_grad_()
    b = torch.randn(7, 3, generator=gen).requires_grad_()
    g = torch.randn(5, 3, generator=gen)
    out = rounded_mm(fp8_round)(a, b)
    assert torch.equal(out, torch.matmul(fp8_round(a), fp8_round(b)))
    out.backward(g)
    assert torch.equal(a.grad, torch.matmul(fp8_round(g), fp8_round(b).detach().T))
    assert torch.equal(b.grad, torch.matmul(fp8_round(a).detach().T, fp8_round(g)))
    assert not torch.equal(a.grad, torch.matmul(g, b.detach().T))
