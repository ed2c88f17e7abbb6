"""The trainer (``train/trainer.Trainer.train_batch``): a step's model FLOPs
(``yardstick.train_flop_per_step``: 6 N_mm B T + 3 L 4 B H (T^2 / 2) Dh) over
the traced steps' host seconds (the host clock between two synchronizes
around whole steps) at 989 TFLOP/s, in %. Moves
``train_tokens_per_s``."""
from benchmark.yardstick import BF16_FLOP_PER_S, train_step_work


def read(run):
    tr, lay = run["trace"], run["layer"]
    if not tr or not tr["units"] or not tr["window_s"]:
        return None
    flop, _ = train_step_work(run["cell"].config, lay["batch"], lay["seq_len"])
    return 100.0 * tr["units"] * flop / (tr["window_s"] * BF16_FLOP_PER_S)
