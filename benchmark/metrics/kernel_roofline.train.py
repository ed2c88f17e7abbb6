"""The kernels: the least time of the traced steps' work (the step's FLOPs
at 989 TFLOP/s against its bytes, each read or written once, at 3.35 TB/s;
``yardstick.train_step_work``) over the device time summed over kernel rows,
in %. Moves ``train_tokens_per_s``."""
from benchmark.yardstick import bound_s, train_step_work


def read(run):
    tr, lay = run["trace"], run["layer"]
    if not tr or not tr["units"] or not tr["kernel_s"]:
        return None
    flop, n_bytes = train_step_work(run["cell"].config, lay["batch"], lay["seq_len"])
    return 100.0 * tr["units"] * bound_s(n_bytes, flop) / tr["kernel_s"]
