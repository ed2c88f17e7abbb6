"""The benchmark's arithmetic: the card's peaks, roofline bounds and the
operations and bytes of a training step, worked out from a configuration's
shapes.

Frozen here so that a change to the program cannot move the yardstick. The
training count is the formula ``chip_smoke.train_flop_per_step`` used and
the bound ``chip_smoke.bound``'s; the byte count is new.
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM, dense, at the full 700 W (NVIDIA's data sheet). Every
# share is taken against the configuration's precision (bf16 tensor cores),
# never the unit that runs the work today, so a faster route can never read
# over 100%.
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(n_bytes: float, flop: float, flop_per_s: float = BF16_FLOP_PER_S) -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, flop / flop_per_s)


@dataclass(frozen=True)
class LMShape:
    hidden: int
    intermediate: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    codebook_dim: int = 16
    codec_branch: bool = False

    @classmethod
    def from_config(cls, cfg: dict) -> "LMShape":
        h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
        return cls(hidden=h, intermediate=cfg["intermediate_size"], layers=cfg["num_hidden_layers"],
                   heads=heads, kv_heads=cfg["num_key_value_heads"], head_dim=h // heads,
                   vocab=cfg["vocab_size"], codec_branch=bool(cfg.get("port", {}).get("codec_embed")))

    @property
    def layer_params(self) -> int:
        """The weights of one layer's matmuls (q, k, v, o, gate, up, down)."""
        h, q, kv = self.hidden, self.heads * self.head_dim, self.kv_heads * self.head_dim
        return h * q + 2 * h * kv + q * h + 3 * h * self.intermediate

    @property
    def head_params(self) -> int:
        return self.hidden * self.vocab


def train_flop_per_step(s: LMShape, b: int, t: int) -> float:
    """6 N_mm B T + 3 L 4 B H (T^2 / 2) Dh: N_mm counts the layer matmul
    weights, the head and the codec projector (not the embedding gathers);
    the attention term is the causal forward's, x3 for forward and backward;
    remat's recompute is not counted."""
    projector = (s.codebook_dim * s.hidden + s.hidden * s.hidden) if s.codec_branch else 0
    n_mm = s.layers * s.layer_params + s.head_params + projector
    attn = 3 * s.layers * 4 * b * s.heads * (t * t / 2) * s.head_dim
    return 6.0 * n_mm * b * t + attn


def train_bytes_per_step(s: LMShape, b: int, t: int, param_bytes: int = 2) -> float:
    """Each input byte of a step read once and each output written once: the
    parameters read, the gradients and updated parameters written, the two
    AdamW moments read and written (all in the parameter dtype), and the
    token ids and labels."""
    n_params = s.layers * s.layer_params + s.head_params + 2 * s.layers * s.hidden + s.hidden
    if s.heads:
        n_params += s.layers * (s.heads + 2 * s.kv_heads) * s.head_dim  # q/k/v biases
    return n_params * param_bytes * (1 + 1 + 1 + 4) + b * t * 8 * 2


def train_step_work(cfg: dict, b: int, t: int):
    """(flop, bytes) of one training step."""
    s = LMShape.from_config(cfg)
    return train_flop_per_step(s, b, t), train_bytes_per_step(s, b, t)
