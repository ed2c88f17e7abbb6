"""The trainer, ``train.forward``: the embeddings, the decoder layers and the
final norm (the GPipe forward on a mesh): device ms a step from the
program's spans (``benchmark/phases.py``). Moves ``train_tokens_per_s``."""
from benchmark.phases import per_step


def read(run):
    ms = per_step()
    return None if ms is None else ms["forward"]
