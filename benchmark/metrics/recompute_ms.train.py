"""The trainer, the ``train.recompute`` spans: what each checkpoint runs again
in the backward (remat "flash": the two halves of every layer and every loss
block): device ms a step from the program's spans (``benchmark/phases.py``).
Moves ``train_tokens_per_s``."""
from benchmark.phases import per_step


def read(run):
    ms = per_step()
    return None if ms is None else ms["recompute"]
