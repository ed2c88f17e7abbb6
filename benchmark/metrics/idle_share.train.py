"""The device: the share of the traced sub-window in which no operation ran
on the card (1 - union of device intervals / window). Moves
``train_tokens_per_s``."""


def read(run):
    tr = run["trace"]
    return 1.0 - tr["busy_s"] / tr["window_s"] if tr and tr["window_s"] > 0 and tr["busy_s"] > 0 else None
