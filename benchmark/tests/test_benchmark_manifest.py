"""The manifest against the files it names, discovery by file name, the
yardstick's counts, and the no-JAX rules. CPU only, no run of a cell."""
from __future__ import annotations

import ast
import json
import re
import shutil
import sys

import pytest

from benchmark import harness, yardstick
from benchmark.harness import BARRED, ROOT, Cell, load_json

BENCH = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_manifest_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1].startswith("benchmark/")
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in BENCH["end_to_end"]} == {"setup_s", "train_tokens_per_s"}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(w):
    cell = Cell.find(w)
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = cell.per_layer()
    assert layers
    for m in layers:
        assert m["moves"] in e2e
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    assert (ROOT / "benchmark" / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    assert cell.limits and all(v >= 0 for v in cell.limits.values())


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_state_their_source(c):
    cfg = load_json(ROOT / c["file"])
    assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for key in c["reduced"]:
        assert not key.endswith(("_dim", "_rank", "_size")) or key == "vocab_size"


def test_a_cell_is_added_by_new_files_only(tmp_path):
    """A new configuration, traffic mix, limits and per-layer metric are new
    files and new manifest entries; no existing file of the benchmark
    changes, and the new cell finds them all."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    cfg = load_json(ROOT / "benchmark" / "configs" / "qwen2.5-0.5b.json")
    cfg["num_hidden_layers"] = 12
    (tmp_path / "benchmark" / "configs" / "new-model.json").write_text(json.dumps(cfg))
    traffic = load_json(ROOT / "benchmark" / "traffic" / "train-b8.json")
    traffic["batch"] = 4
    (tmp_path / "benchmark" / "traffic" / "train-b4.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark" / "limits" / "new-model.train-b4.json").write_text('{"loss_gap": 1e-4}')
    (tmp_path / "benchmark" / "metrics" / "steps.train.py").write_text(
        "def read(run):\n    return run['layer'].get('steps')\n")
    bench["configs"].append({"name": "new-model", "source": "https://example.org/new-model",
                             "file": "benchmark/configs/new-model.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "new-model.train-b4", "config": "new-model", "traffic": "train-b4",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "trainer",
                               "moves": "train_tokens_per_s", "workloads": ["new-model.train-b4"]})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("new-model.train-b4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Cell.find("new-model.train-b4", root=tmp_path)
    assert cell.config["num_hidden_layers"] == 12 and cell.traffic["batch"] == 4
    assert "steps.train" in [m["name"] for m in cell.per_layer()]
    assert "train_tokens_per_s" in [m["name"] for m in cell.end_to_end()]
    metric = harness.load_module(tmp_path / "benchmark" / "metrics" / "steps.train.py", "m_steps")
    assert metric.read({"layer": {"steps": 4}}) == 4
    after = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())


def test_train_flop_counts():
    """PERF.md's 77.4 TFLOP for phase 7(b) (Llama-3.2-1B geometry, vocab
    259,344 with the codec branch, B 4, T 2,048) and 64.5 TFLOP for the
    training cell."""
    llama = yardstick.LMShape(hidden=2048, intermediate=8192, layers=16, heads=32, kv_heads=8, head_dim=64,
                              vocab=259344, codec_branch=True)
    assert yardstick.train_flop_per_step(llama, 4, 2048) / 1e12 == pytest.approx(77.4, abs=0.05)
    cfg = load_json(ROOT / "benchmark" / "configs" / "qwen2.5-0.5b.json")
    s = yardstick.LMShape.from_config(cfg)
    assert s.layers * s.layer_params + s.head_params + 16 * 896 + 896 * 896 == pytest.approx(612.2e6, rel=1e-3)
    assert yardstick.train_flop_per_step(s, 8, 2048) / 1e12 == pytest.approx(64.5, abs=0.05)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark").rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    """Whole top-level names: the port's package name begins with the JAX
    package's, and passes."""
    tops = {m.split(".", 1)[0] for m in _imports(path)}
    assert not tops & set(BARRED)
    if "reference" in path.parts:
        assert "realtime_codec_agent_tpu_torch" not in tops


def test_barred_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "realtime_codec_agent_tpu_torch_fake", object())
    assert harness.barred_modules() == []
    monkeypatch.setitem(sys.modules, "realtime_codec_agent_tpu.ops", object())
    assert harness.barred_modules() == ["realtime_codec_agent_tpu.ops"]
