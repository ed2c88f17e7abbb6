"""Line-by-line text dataset loading for LM training.

Copy of realtime_codec_agent_tpu/train/dataset.py (numpy only; ``pad_batch``
from the port's trainer). The reference trains on the prep_lm_dataset .txt
output one example per line (train_vanilla_latest.py:384-476, incl. a
modulo-based streaming split :276-312). Here: a generator-based loader that tokenizes lines with the
CodecTextTokenizer, pads to max_seq_len with -100 labels, and yields numpy
batches; split_streaming mirrors the modulo eval split.
"""
from __future__ import annotations

import itertools
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .trainer import pad_batch


def iter_lines(path: str) -> Iterator[str]:
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if line:
                yield line


def split_streaming(
    lines: Iterator[str], eval_every_n: int, is_eval: bool
) -> Iterator[str]:
    """Every n-th line is eval (reference split_streaming_dataset,
    train_vanilla_latest.py:276-312)."""
    for i, line in enumerate(lines):
        if (i % eval_every_n == 0) == is_eval:
            yield line


def batches_from_lines(
    lines: Iterator[str],
    tokenizer,
    batch_size: int,
    max_seq_len: int,
    shuffle_buffer: int = 0,
    seed: int = 42,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    pad_id = tokenizer.pad_token_id

    def tokenized() -> Iterator[List[int]]:
        for line in lines:
            yield tokenizer.encode(line)

    stream = tokenized()
    if shuffle_buffer > 1:
        rng = np.random.default_rng(seed)

        def shuffled(it):
            buf = list(itertools.islice(it, shuffle_buffer))
            for item in it:
                j = rng.integers(0, len(buf))
                yield buf[j]
                buf[j] = item
            rng.shuffle(buf)
            yield from buf

        stream = shuffled(stream)

    while True:
        chunk = list(itertools.islice(stream, batch_size))
        if not chunk:
            return
        if len(chunk) < batch_size:
            chunk += [chunk[-1]] * (batch_size - len(chunk))  # pad final batch
        yield pad_batch(chunk, max_seq_len, pad_id)


def repeat_batches(
    path: str,
    tokenizer,
    batch_size: int,
    max_seq_len: int,
    shuffle_buffer: int = 1024,
    seed: int = 42,
    eval_every_n: Optional[int] = None,
    is_eval: bool = False,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless epoch-looping batch stream from a dataset txt file."""
    epoch = 0
    while True:
        lines = iter_lines(path)
        if eval_every_n:
            lines = split_streaming(lines, eval_every_n, is_eval)
        yield from batches_from_lines(
            lines, tokenizer, batch_size, max_seq_len,
            shuffle_buffer=shuffle_buffer, seed=seed + epoch,
        )
        epoch += 1
        if is_eval:
            return
