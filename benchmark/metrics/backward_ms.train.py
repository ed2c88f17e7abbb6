"""The trainer, ``train.backward``: every gradient, the remat policy's
recompute included: device ms a step from the program's spans
(``benchmark/phases.py``). Moves ``train_tokens_per_s``."""
from benchmark.phases import per_step


def read(run):
    ms = per_step()
    return None if ms is None else ms["backward"]
