"""The trainer, ``train.optimizer``: a mesh's gradient sums, the reported
global norm, the clip's norm, the update and the gradients' release: device
ms a step from the program's spans (``benchmark/phases.py``). Moves
``train_tokens_per_s``."""
from benchmark.phases import per_step


def read(run):
    ms = per_step()
    return None if ms is None else ms["optimizer"]
