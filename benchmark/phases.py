"""The trainer's phases from the program's spans
(``realtime_codec_agent_tpu_torch/utils/spans.py``) over the traced window:
device milliseconds a step, averaged over the window's ``train.step`` spans.
A program without spans, or a window without a step, gives None."""
from __future__ import annotations

import collections
import importlib
from typing import Dict, Optional

PHASES = {"forward": "train.forward", "loss": "train.loss", "backward": "train.backward",
          "recompute": "train.recompute", "optimizer": "train.optimizer"}


def per_step() -> Optional[Dict[str, float]]:
    """``PHASES``' milliseconds a step, and ``host_wait``: ``train.h2d`` and
    ``train.fetch`` and the device time between one ``train.step`` and the
    next."""
    try:
        spans = importlib.import_module("realtime_codec_agent_tpu_torch.utils.spans")
    except ModuleNotFoundError:
        return None
    window = spans.window()
    steps = sorted((s for s in window if s.name == "train.step" and s.device_ms is not None),
                   key=lambda s: s.device_start_ms)
    if not steps:
        return None
    ids = {s.step for s in steps}
    ms = collections.Counter()
    for s in window:
        if s.step in ids and s.device_ms is not None:
            ms[s.name] += s.device_ms
    between = sum(b.device_start_ms - a.device_end_ms for a, b in zip(steps, steps[1:]))
    out = {k: ms[name] / len(steps) for k, name in PHASES.items()}
    out["host_wait"] = (ms["train.h2d"] + ms["train.fetch"] + between) / len(steps)
    return out
