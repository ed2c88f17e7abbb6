"""JAX-package param pytrees (as numpy arrays) -> the port's torch params.

The port keeps the JAX package's pytree layout, so a conversion is a leaf
map: nested dicts and lists stay, each numpy array becomes a tensor on the
target device (bfloat16 arrays included, which numpy holds as an extension
dtype). LM trees may be dense or int8 ``{"q", "s"}``, fused or not. This module
takes numpy only and imports no JAX: callers hand it
``jax.tree_util.tree_map(np.asarray, params)``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_LM_LAYER_KEYS = {
    "attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "wqkv", "w_gu", "bq", "bk", "bv", "bqkv",
}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: arrays from JAX are read-only
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device).contiguous()


def tree_to_torch(tree: Any, device="cpu") -> Any:
    """Map every numpy leaf of a dict/list pytree to a torch tensor."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_torch(v, device) for v in tree]
    return _tensor(tree, device)


def _check_leaf(name: str, leaf) -> None:
    if isinstance(leaf, dict) and set(leaf) != {"q", "s"}:
        raise NotImplementedError(f"LM leaf {name!r} with keys {sorted(leaf)} is not ported yet (dense or int8 only)")


def lm_params_from_numpy(tree: Dict, device="cpu") -> Dict:
    """An LM param pytree (``embed_tokens``, ``layers``, ``final_norm``,
    optional ``lm_head`` / ``codec_embed``) -> the port's params."""
    missing = {"embed_tokens", "layers", "final_norm"} - set(tree)
    if missing:
        raise KeyError(f"LM params lack {sorted(missing)}")
    if not isinstance(tree["layers"], (list, tuple)):
        raise ValueError("LM params must use the per-layer list layout (unstack_layer_params first)")
    for i, blk in enumerate(tree["layers"]):
        unknown = set(blk) - _LM_LAYER_KEYS
        if unknown:
            raise KeyError(f"layer {i}: unknown leaves {sorted(unknown)}")
        for name, leaf in blk.items():
            _check_leaf(f"layers.{i}.{name}", leaf)
    if "lm_head" in tree:
        _check_leaf("lm_head", tree["lm_head"])
    return tree_to_torch(tree, device)


def codec_params_from_numpy(tree: Dict, device="cpu") -> Dict:
    """A codec param pytree (``encoder``, ``quantizer``, ``decoder``) -> the
    port's params. The conv front end is not ported yet."""
    missing = {"encoder", "quantizer", "decoder"} - set(tree)
    if missing:
        raise KeyError(f"codec params lack {sorted(missing)}")
    if "conv" in tree["encoder"] or "conv" in tree["decoder"]:
        raise NotImplementedError("codec conv front end is not ported yet")
    return tree_to_torch(tree, device)
