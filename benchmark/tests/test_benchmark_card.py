"""The controls on the card, at each cell's own size and a short window:
the program's numbers within their limits, the control's (the reference in
the nearest lower precision) outside at least one. Needs a CUDA device; on
the CPU each test skips, decided inside the test:

    python3 -m pytest benchmark/tests/test_benchmark_card.py -q -s
"""
from __future__ import annotations

import pytest
import torch

from benchmark.harness import ROOT, Cell, load_json, run_cell, set_caches


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run only on the card")


@pytest.mark.parametrize("workload", [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]])
def test_control_fails_where_the_program_passes(workload):
    needs_card()
    set_caches(ROOT)
    cell = Cell.find(workload)
    r = run_cell(cell, 2**31 + 11, 8.0, False, control=True)
    checks = r["checks"]
    print(workload, {k: v["value"] for k, v in checks.items()})
    assert r["correct"], checks
    controls = {k.split(".", 1)[1]: v["value"] for k, v in checks.items() if k.startswith("control.")}
    assert controls and set(controls) <= set(cell.limits)
    assert any(v > cell.limits[k] for k, v in controls.items()), (controls, cell.limits)
