"""The kernels: the tensor-core share of the FLOP of the traced window's
``ops/nn.dot_f32`` calls, forward and recompute, from the program's counters
(``utils/spans.counters``: each call adds its own 2 M K N, not its
backward's, to ``gemm.flop.tensor_core`` or ``gemm.flop.f32`` by the route
it takes; a call's backward products take the same route). None where the
program keeps no such counters or the window ran no such call. Moves
``train_tokens_per_s``."""
import importlib


def read(run):
    try:
        spans = importlib.import_module("realtime_codec_agent_tpu_torch.utils.spans")
    except ModuleNotFoundError:
        return None
    counters = getattr(spans, "counters", None)
    if counters is None:
        return None
    c = counters()
    tc, f32 = c.get("gemm.flop.tensor_core", 0), c.get("gemm.flop.f32", 0)
    return tc / (tc + f32) if tc + f32 else None
