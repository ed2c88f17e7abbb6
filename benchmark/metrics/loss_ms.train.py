"""The trainer, ``train.loss``: the tied head and the blockwise cross-entropy,
forward only: device ms a step from the program's spans
(``benchmark/phases.py``). Moves ``train_tokens_per_s``."""
from benchmark.phases import per_step


def read(run):
    ms = per_step()
    return None if ms is None else ms["loss"]
