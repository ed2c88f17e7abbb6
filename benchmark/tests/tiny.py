"""Tiny cells for the CPU: a cell at ``tiny_lm_config``-sized widths, built
from the real cell's files with the sizes cut."""
from __future__ import annotations

import copy

from benchmark.harness import ROOT, Cell, load_json

TINY_LM = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
           "num_key_value_heads": 2}
CODEBOOK = 1024


def tiny_config(name: str) -> dict:
    cfg = copy.deepcopy(load_json(ROOT / "benchmark" / "configs" / f"{name}.json"))
    cfg.update(TINY_LM)
    text = 300
    cfg["port"].update({"text_vocab_size": text, "codec_vocab_start": text + 10, "codebook_size": CODEBOOK,
                        "max_context": 1024})
    cfg["vocab_size"] = ((text + 10 + CODEBOOK + 7) // 8) * 8
    return cfg


def tiny_cell(workload: str, limits: dict = None) -> Cell:
    """The cell ``workload`` at tiny sizes and a short mix."""
    cell = Cell.find(workload)
    cell.config = tiny_config(cell.entry["config"])
    tr = copy.deepcopy(cell.traffic)
    tr.update({"batch": 3, "seq_len": 96, "full_rows": 2, "padded_len": [40, 96], "header": [4, 12],
               "batches": 8, "trace_skip_steps": 0, "trace_steps": 1})
    tr["train_config"] = dict(tr["train_config"], per_device_batch_size=3, max_seq_len=96, loss_block_size=32)
    cell.traffic = tr
    if limits is not None:
        cell.limits = limits
    return cell
