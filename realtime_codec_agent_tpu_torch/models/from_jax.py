"""JAX-package param pytrees (as numpy arrays) -> the port's torch params.

The port keeps the JAX package's pytree layout, so a conversion is a leaf
map: nested dicts and lists stay, each numpy array becomes a tensor on the
target device (bfloat16 arrays included, which numpy holds as an extension
dtype). LM trees may be dense, int8 ``{"q", "s"}`` or int4 ``{"q4", "d",
"m"}`` (uint8 nibbles, f32 group scales and mins), fused or not, in the
per-layer list or the stacked training layout, with or without the
``codec_embed`` branch; codec trees in either front end and block
flavour. The JAX trainer's optax AdamW state converts to the
port trainer's optimizer state (``adamw_state_from_numpy``). This module takes
numpy only and imports no JAX: callers hand it
``jax.tree_util.tree_map(np.asarray, tree)``. Whisper trees convert through
``whisper_params_from_jax``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..utils.tree import tree_leaves

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
    if isinstance(leaf, dict) and set(leaf) not in ({"q", "s"}, {"q4", "d", "m"}):
        raise KeyError(f"LM leaf {name!r} with keys {sorted(leaf)}: want dense, int8 {{q, s}} or int4 {{q4, d, m}}")


def _check_layer(where: str, blk: Dict) -> None:
    unknown = set(blk) - _LM_LAYER_KEYS
    if unknown:
        raise KeyError(f"{where}: unknown leaves {sorted(unknown)}")
    for name, leaf in blk.items():
        _check_leaf(f"{where}.{name}", leaf)


def lm_params_from_numpy(tree: Dict, device="cpu") -> Dict:
    """An LM param pytree (``embed_tokens``, ``layers`` as a per-layer list
    or the stacked dict of ``(L, ...)`` arrays, ``final_norm``, optional
    ``lm_head`` / ``codec_embed``) -> the port's params, same layout."""
    missing = {"embed_tokens", "layers", "final_norm"} - set(tree)
    if missing:
        raise KeyError(f"LM params lack {sorted(missing)}")
    unknown = set(tree) - {"embed_tokens", "layers", "final_norm", "lm_head", "codec_embed"}
    if unknown:
        raise KeyError(f"LM params: unknown entries {sorted(unknown)}")
    if isinstance(tree["layers"], dict):  # the stacked training layout
        _check_layer("layers", tree["layers"])
    else:
        for i, blk in enumerate(tree["layers"]):
            _check_layer(f"layers.{i}", blk)
    if "lm_head" in tree:
        _check_leaf("lm_head", tree["lm_head"])
    if "codec_embed" in tree:
        codec = tree["codec_embed"]
        if set(codec) != {"table", "projectors"} or any(
            set(p) != {"w1", "b1", "w2", "b2"} for p in codec["projectors"]
        ):
            raise KeyError("codec_embed must hold 'table' and 'projectors' of {w1, b1, w2, b2}")
    return tree_to_torch(tree, device)


def _find_adam_state(state):
    """optax's ScaleByAdamState (a namedtuple with count, mu, nu) anywhere in
    an optimizer state: the clip_by_global_norm -> adamw chain, possibly
    inside multi_transform's per-label MaskedState."""
    if hasattr(state, "_fields") and {"count", "mu", "nu"} <= set(state._fields):
        return state
    children = state.values() if isinstance(state, dict) else state if isinstance(state, (list, tuple)) else ()
    for child in children:
        found = _find_adam_state(child)
        if found is not None:
            return found
    if hasattr(state, "__dict__"):
        for child in vars(state).values():
            found = _find_adam_state(child)
            if found is not None:
                return found
    return None


def adamw_state_from_numpy(opt_state, device="cpu") -> Dict:
    """The JAX trainer's optax AdamW state (as numpy) -> the port trainer's
    ``{"count", "mu", "nu"}``: moments keyed by dotted param path, frozen
    leaves (the codec table under multi_transform) absent: optax's
    MaskedNode there is an empty tuple, which has no leaves."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no optax ScaleByAdamState (count, mu, nu) in the optimizer state")
    return {
        "count": int(np.asarray(adam.count)),
        "mu": {k: _tensor(v, device) for k, v in tree_leaves(adam.mu)},
        "nu": {k: _tensor(v, device) for k, v in tree_leaves(adam.nu)},
    }


_CODEC_KEYS = {
    "encoder": {"blocks", "out_norm", "out_norm_b", "out_proj", "out_proj_b", "patch_embed", "patch_bias", "conv"},
    "quantizer": {"codebook", "proj_w", "proj_b"},
    "decoder": {"in_proj", "in_bias", "blocks", "out_norm", "out_norm_b", "patch_unembed", "patch_unembed_b", "conv"},
}
_CODEC_BLOCK_KEYS = {
    "attn_norm", "attn_norm_b", "wq", "wk", "wv", "bq", "bk", "bv", "wo", "bo",
    "mlp_norm", "mlp_norm_b", "w1", "b1", "w2", "b2",
}


def codec_params_from_numpy(tree: Dict, device="cpu") -> Dict:
    """A codec param pytree (``encoder``, ``quantizer``, ``decoder``; either
    front end, RMS or LayerNorm blocks with their optional biases) -> the
    port's params. Unknown entries raise KeyError."""
    if set(tree) != set(_CODEC_KEYS):
        raise KeyError(f"codec params: want {sorted(_CODEC_KEYS)}, got {sorted(tree)}")
    for side, keys in _CODEC_KEYS.items():
        unknown = set(tree[side]) - keys
        if unknown:
            raise KeyError(f"codec {side}: unknown leaves {sorted(unknown)}")
    for side in ("encoder", "decoder"):
        for i, blk in enumerate(tree[side]["blocks"]):
            unknown = set(blk) - _CODEC_BLOCK_KEYS
            if unknown:
                raise KeyError(f"codec {side}.blocks.{i}: unknown leaves {sorted(unknown)}")
        conv = tree[side].get("conv")
        if conv is not None and (set(conv) != {"stages"} or any(set(st) != {"w", "b"} for st in conv["stages"])):
            raise KeyError(f"codec {side}.conv must be {{'stages': [{{'w', 'b'}}, ...]}}")
    return tree_to_torch(tree, device)


_WHISPER_ATTN = {"wq", "bq", "wk", "wv", "bv", "wo", "bo"}
_WHISPER_LN = {"w", "b"}
_WHISPER_MLP = {"w1", "b1", "w2", "b2"}


def whisper_params_from_jax(tree: Dict, device="cpu") -> Dict:
    """A JAX Whisper param pytree (models/whisper.py's layout: ``encoder``
    with the two convolutions, sinusoidal ``pos``, ``layers`` and
    ``final_ln``; ``decoder`` with ``embed_tokens``, learned ``pos``,
    ``layers`` and ``final_ln``) -> the port's tensors on ``device``, same
    layout."""
    enc, dec = tree.get("encoder"), tree.get("decoder")
    if set(tree) != {"encoder", "decoder"} or set(enc) != {
        "conv1_w", "conv1_b", "conv2_w", "conv2_b", "pos", "layers", "final_ln"
    } or set(dec) != {"embed_tokens", "pos", "layers", "final_ln"}:
        raise KeyError("not a Whisper param pytree (encoder / decoder of models/whisper.py)")
    want = {"attn_ln": _WHISPER_LN, "attn": _WHISPER_ATTN, "mlp_ln": _WHISPER_LN, "mlp": _WHISPER_MLP}
    for side, blocks in (("encoder", enc["layers"]), ("decoder", dec["layers"])):
        keys = want if side == "encoder" else {**want, "cross_ln": _WHISPER_LN, "cross": _WHISPER_ATTN}
        for i, blk in enumerate(blocks):
            if set(blk) != set(keys) or any(set(blk[k]) != v for k, v in keys.items()):
                raise KeyError(f"Whisper {side}.layers.{i}: unexpected leaves")
    return tree_to_torch(tree, device)
