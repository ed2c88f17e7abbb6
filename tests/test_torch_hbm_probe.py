"""Kernel B6's plain versions and the probe's command line on the CPU.

The JAX probe's kernels live inside ``scripts/hbm_stream_probe.py:main()``
and cannot be imported, so numpy states what each variant sums: the grid
kernel every byte of every whole chunk (the TPU probe's ``--full_reduce``,
``:81-83``), the manual kernel the first REDUCE_ROWS rows of each chunk
(``:79``, ``:150``), each ``passes`` times. The kernels themselves are held
to these plain versions on the card (test_torch_cuda_kernels.py)."""
import json

import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu_torch.ops import hbm_stream as hs
from realtime_codec_agent_tpu_torch.tools import hbm_stream_probe as probe


def _buffer(n_bytes, seed):
    return np.random.default_rng(seed).integers(-128, 128, size=n_bytes, dtype=np.int8)


@pytest.mark.parametrize("chunk_kb,n_bytes,passes", [(16, 2 * 2**20, 2), (64, 2 * 2**20 + 5000, 3)])
def test_stream_sum_plain_matches_numpy(chunk_kb, n_bytes, passes):
    w = _buffer(n_bytes, chunk_kb)
    chunk = chunk_kb * 1024
    n_chunks = n_bytes // chunk
    want = passes * int(w[: n_chunks * chunk].astype(np.int64).sum())
    calls = hs.stream_sum_plain.calls
    got = hs.stream_sum(torch.from_numpy(w), chunk, passes)  # a CPU tensor takes the plain version
    assert hs.stream_sum_plain.calls == calls + 1
    assert got.dtype == torch.int64 and int(got) == want


@pytest.mark.parametrize("chunk_bytes", [32 * 1024, 4096, 96 * 1024])
def test_stream_rows_sum_plain_matches_numpy(chunk_bytes):
    """The first 32 rows of 256 bytes of every chunk (the whole chunk when
    it is shorter), every pass."""
    w = _buffer(2 * 2**20, 7)
    passes = 2
    n_chunks = w.size // chunk_bytes
    rows = w[: n_chunks * chunk_bytes].reshape(n_chunks, chunk_bytes)[:, : hs.REDUCE_ROWS * hs.ROW_BYTES]
    want = passes * int(rows.astype(np.int64).sum())
    calls = hs.stream_rows_sum_plain.calls
    got = hs.stream_rows_sum(torch.from_numpy(w), chunk_bytes, 2, passes)
    assert hs.stream_rows_sum_plain.calls == calls + 1
    assert int(got) == want


def test_plain_rejects_a_buffer_shorter_than_a_chunk():
    with pytest.raises(ValueError, match="chunk"):
        hs.stream_sum_plain(torch.zeros(100, dtype=torch.int8), 16 * 1024, 1)


def test_probe_tiny_prints_one_json_line(capsys):
    """``--tiny``: every variant's sum equals its plain version's on the CPU,
    the matmul controls agree with theirs, and no time is reported."""
    out = probe.main(["--tiny"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(out))
    assert out["total_weight_mb"] == 2 and out["passes"] == 2 and out["device"] == "cpu"
    res = out["results"]
    assert set(res) == {"grid_16kb", "manual2x32kb", "matmul_ctl_int8", "matmul_ctl_int4"}
    for name in ("grid_16kb", "manual2x32kb"):
        assert res[name]["sum"] == res[name]["plain_sum"] and res[name]["ms"] is None
    w = torch.randint(-128, 128, (2 * 2**20,), generator=torch.Generator().manual_seed(0), dtype=torch.int8)
    assert res["grid_16kb"]["sum"] == 2 * int(w.to(torch.int64).sum())
    for kind in ("int8", "int4"):
        assert res[f"matmul_ctl_{kind}"]["rel_err"] == 0.0 and res[f"matmul_ctl_{kind}"]["gbs"] is None
