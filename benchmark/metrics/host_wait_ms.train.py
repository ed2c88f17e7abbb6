"""The trainer, ``train.h2d`` (the batch's copy to the card), ``train.fetch``
(the step's closing synchronize) and the device time between one
``train.step`` and the next: device ms a step from the program's spans
(``benchmark/phases.py``). Moves ``train_tokens_per_s``."""
from benchmark.phases import per_step


def read(run):
    ms = per_step()
    return None if ms is None else ms["host_wait"]
