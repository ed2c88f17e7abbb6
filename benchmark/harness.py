"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name the manifest gives:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the mix's parameters; its ``driver`` names
  ``drivers/<driver>.py``, whose ``run(ctx)`` builds the system, runs the
  window and judges the outputs;
- ``limits/<workload>.json``: the limit of each number that decides
  ``correct`` in that cell;
- ``metrics/<name>.py``: a per-layer metric's reader (``read(run)`` returns
  a number or None, and None leaves the metric out of the line).
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# whole top-level module names that must not be loaded by the end of a run
BARRED = ("jax", "jaxlib", "flax", "optax", "realtime_codec_agent_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def barred_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in BARRED)


@dataclass
class Cell:
    """One cell with everything its files say; ``bench`` is the manifest."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    bench: dict
    root: Path = ROOT

    @classmethod
    def find(cls, name: str, root: Path = ROOT, bench: Optional[dict] = None) -> "Cell":
        bench = bench or load_json(root / "BENCHMARK.json")
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        base = root / "benchmark"
        config = load_json(base / "configs" / f"{entry['config']}.json")
        traffic = load_json(base / "traffic" / f"{entry['traffic']}.json")
        limits = load_json(base / "limits" / f"{name}.json")
        return cls(name, entry, config, traffic, limits, bench, root)

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


@dataclass
class Ctx:
    """What a driver gets: the cell's files, the run's arguments, the
    device, and the harness's clock."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    control: bool = False
    t_start: float = field(default_factory=time.perf_counter)
    t_window: Optional[float] = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def limits(self) -> dict:
        return self.cell.limits

    @property
    def root(self) -> Path:
        return self.cell.root

    def window_started(self) -> None:
        self.t_window = time.perf_counter()

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def set_caches(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port builds its kernels under ``build/torch_kernels/`` by itself)."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device=None, control: bool = False,
             t_start: Optional[float] = None) -> Dict:
    """Run the cell once; returns the result object (without printing)."""
    import torch

    if device is None:
        chips = cell.entry.get("chips", 1)
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"needs {chips} CUDA device(s); torch sees "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    device = torch.device(device)
    ctx = Ctx(cell, seed, seconds, trace, device, control)
    if t_start is not None:
        ctx.t_start = t_start
    driver = load_module(cell.root / "benchmark" / "drivers" / f"{cell.traffic['driver']}.py",
                         f"benchmark_driver_{cell.traffic['driver']}")
    out = driver.run(ctx)
    if ctx.t_window is None:
        raise RuntimeError("the driver never opened its window")
    barred = barred_modules()
    if barred:
        raise SystemExit(f"loaded in the measuring process: {', '.join(barred)}")
    e2e = dict(out["e2e"], setup_s=ctx.t_window - ctx.t_start)
    checks = [c for c in out["checks"] if not c.get("control")]
    correct = all(c["value"] <= c["limit"] for c in checks)
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
               "memory_peak_bytes": out["memory_peak_bytes"]}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    metrics = {}
    if not trace:
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    else:
        tr = out.get("trace") or {}
        dev["busy_s"] = tr.get("busy_s", 0.0)
        dev["window_s"] = tr.get("window_s", 0.0)
        run = {"cell": cell, "trace": out.get("trace"), "layer": out.get("layer", {}), "e2e": e2e}
        for m in cell.per_layer():
            reader = load_module(cell.root / "benchmark" / "metrics" / f"{m['name']}.py",
                                 "benchmark_metric_" + m["name"].replace(".", "_").replace("-", "_"))
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if tr:
            result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["metrics"] = metrics
    result["device"] = dev
    result["notes"] = out.get("notes", {})
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c.get("limit")} for c in out["checks"]}
    gc.collect()
    return result


def emit(result: Dict, out=None, err=None) -> None:
    """The run's notes on standard error, then each number compared beside
    its limit as the last lines there; the result as the last line of
    standard output, its ``checks`` key last."""
    out, err = out or sys.stdout, err or sys.stderr
    line = {k: v for k, v in result.items() if k not in ("notes", "checks")}
    line["checks"] = result["checks"]
    print("notes " + json.dumps(result.get("notes", {})), file=err)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=err)
    err.flush()
    print(json.dumps(line), file=out, flush=True)


def main(argv=None, t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description="run one cell of BENCHMARK.json once")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_caches(ROOT)
    cell = Cell.find(args.workload)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    except SystemExit as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 3
    emit(result)
    return 0
