"""Host-to-device uploads that never synchronize the stream.

A blocking copy from pageable host memory to the card ends in a stream
synchronize (PyTorch's ``memcpy_and_sync``), so an upload in the middle of a
chunk's dispatch would wait for every chunk still in flight. :func:`to_device`
stages the array in pinned memory (PyTorch's caching host allocator, which
keeps a block until the copy that reads it has finished) and copies it with
``non_blocking=True``. On the CPU it is a plain ``torch.from_numpy``.
"""
from __future__ import annotations

import numpy as np
import torch


def to_device(array, device, dtype=None) -> torch.Tensor:
    """``array`` (numpy, a list or a scalar) as a tensor on ``device``,
    uploaded without a host synchronization."""
    host = torch.from_numpy(np.ascontiguousarray(np.asarray(array, dtype=dtype)))
    device = torch.device(device)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)
