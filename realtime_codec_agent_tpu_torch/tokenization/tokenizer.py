"""Self-contained duplex tokenizer: text vocab + framing specials + codec codes.

The reference relies on a HF Llama-3.2 tokenizer directory with the framing
special tokens and 131,072 codec unicode characters appended as added tokens
(reference train_vanilla_latest.py:524-561, realtime_agent_resources.py:34).
This module rebuilds that as a first-class object with a guaranteed vocabulary
layout::

    [0, text_vocab_size)                          text tokens
    [text_vocab_size, +len(SPECIAL_TOKENS))       framing specials (<|end_header|> LAST)
    [codec_vocab_start, +num_codebooks*codebook_size)  codec code tokens

Codec token id == ``codec_vocab_start + codebook*codebook_size + code``, i.e.
encoding ``chr(unicode_offset + k)`` always yields ``codec_vocab_start + k``,
mirroring ``config.codec_vocab_start = tokenizer.convert_tokens_to_ids(chr(unicode_offset))``
(reference train_vanilla_latest.py:556-561).

Any text tokenizer with ``encode/decode/vocab_size`` can back the text region;
``ByteTextTokenizer`` is the dependency-free default (used in tests and when no
trained tokenizer directory is supplied). A HF fast tokenizer can be wrapped
with ``HFTextTokenizerAdapter`` for deployments with the real Llama vocab.
"""
from __future__ import annotations

import json
import os
import re
from typing import List, Optional, Sequence

from ..units.codes import UNICODE_OFFSET_LARGE
from ..units.special_tokens import SPECIAL_TOKENS


class ByteTextTokenizer:
    """Byte-level fallback text tokenizer.

    Layout: ids [0,256) = raw bytes; 256=BOS, 257=EOS, 258=PAD; then atomic
    word tokens (greedy longest-match). Atomic tokens default to the single
    leading-space capital letters " A".." Z" so speaker-identity tokens are a
    single id, which the duplex state machine requires (the reference Llama
    tokenizer also encodes " A" as one token; see realtime_agent_v2.py:137-138).
    """

    BOS = 256
    EOS = 257
    PAD = 258

    def __init__(self, atomic_tokens: Optional[Sequence[str]] = None):
        if atomic_tokens is None:
            # speaker-identity tokens " A".." Z" plus the external-content
            # marker '†' (one id each — the real Llama tokenizer also encodes
            # these atomically, and the agent stores single marker ids)
            atomic_tokens = [f" {chr(ord('A') + i)}" for i in range(26)] + ["†"]
        self.atomic_tokens = list(atomic_tokens)
        self._atomic_to_id = {tok: 259 + i for i, tok in enumerate(self.atomic_tokens)}
        self._id_to_atomic = {v: k for k, v in self._atomic_to_id.items()}
        self.vocab_size = 259 + len(self.atomic_tokens)
        self.bos_token_id = self.BOS
        self.eos_token_id = self.EOS
        self.pad_token_id = self.PAD
        # sort by length desc for greedy longest match
        self._atomic_sorted = sorted(self.atomic_tokens, key=len, reverse=True)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        i = 0
        n = len(text)
        while i < n:
            matched = False
            for tok in self._atomic_sorted:
                if text.startswith(tok, i):
                    ids.append(self._atomic_to_id[tok])
                    i += len(tok)
                    matched = True
                    break
            if not matched:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        parts: List[str] = []
        byte_run = bytearray()
        for tid in ids:
            if tid < 256:
                byte_run.append(tid)
                continue
            if byte_run:
                parts.append(byte_run.decode("utf-8", errors="replace"))
                byte_run = bytearray()
            if tid in self._id_to_atomic:
                parts.append(self._id_to_atomic[tid])
            # BOS/EOS/PAD decode to nothing
        if byte_run:
            parts.append(byte_run.decode("utf-8", errors="replace"))
        return "".join(parts)

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self._atomic_to_id:
            return self._atomic_to_id[token]
        b = token.encode("utf-8")
        if len(b) == 1:
            return b[0]
        return None


class HFTextTokenizerAdapter:
    """Wraps a HuggingFace tokenizer as the text region backend."""

    def __init__(self, hf_tokenizer):
        self.hf = hf_tokenizer
        self.vocab_size = len(hf_tokenizer)
        self.bos_token_id = hf_tokenizer.bos_token_id
        self.eos_token_id = hf_tokenizer.eos_token_id
        pad = hf_tokenizer.pad_token_id
        if pad is None:
            # reference train_vanilla_latest.py:545-550: prefer <|finetune_right_pad_id|>
            pad = hf_tokenizer.convert_tokens_to_ids("<|finetune_right_pad_id|>")
            if pad is None:
                pad = hf_tokenizer.eos_token_id
        self.pad_token_id = pad

    def encode(self, text: str) -> List[int]:
        return self.hf.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self.hf.decode(list(ids), skip_special_tokens=False)

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self.hf.convert_tokens_to_ids(token)
        unk = getattr(self.hf, "unk_token_id", None)
        if tid is None or (unk is not None and tid == unk):
            ids = self.hf.encode(token, add_special_tokens=False)
            return ids[0] if ids else None
        return tid


class CodecTextTokenizer:
    """Unified tokenizer over text + framing specials + codec code characters."""

    def __init__(
        self,
        text_tokenizer=None,
        num_codebooks: int = 1,
        codebook_size: int = 131072,
        unicode_offset: int = UNICODE_OFFSET_LARGE,
        special_tokens: Sequence[str] = SPECIAL_TOKENS,
    ):
        self.text = text_tokenizer if text_tokenizer is not None else ByteTextTokenizer()
        self.num_codebooks = num_codebooks
        self.codebook_size = codebook_size
        self.unicode_offset = unicode_offset
        self.special_tokens = tuple(special_tokens)

        self.text_vocab_size = self.text.vocab_size
        self._special_to_id = {
            tok: self.text_vocab_size + i for i, tok in enumerate(self.special_tokens)
        }
        self._id_to_special = {v: k for k, v in self._special_to_id.items()}
        self.codec_vocab_start = self.text_vocab_size + len(self.special_tokens)
        self.num_codec_tokens = num_codebooks * codebook_size
        self.vocab_size = self.codec_vocab_start + self.num_codec_tokens

        self.bos_token_id = self.text.bos_token_id
        self.eos_token_id = self.text.eos_token_id
        self.pad_token_id = self.text.pad_token_id

        # regex splitting on special-token strings (escaped, longest first)
        specials_alt = "|".join(
            re.escape(t) for t in sorted(self.special_tokens, key=len, reverse=True)
        )
        self._special_re = re.compile(f"({specials_alt})")

    def __len__(self) -> int:
        return self.vocab_size

    # -- encode ------------------------------------------------------------
    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        if add_special_tokens and self.bos_token_id is not None:
            ids.append(self.bos_token_id)
        for segment in self._special_re.split(text):
            if not segment:
                continue
            if segment in self._special_to_id:
                ids.append(self._special_to_id[segment])
            else:
                ids.extend(self._encode_mixed_text(segment))
        return ids

    def _encode_mixed_text(self, segment: str) -> List[int]:
        """Encode a segment that may mix plain text with codec code chars."""
        ids: List[int] = []
        run_start = 0
        off = self.unicode_offset
        hi = off + self.num_codec_tokens
        for i, ch in enumerate(segment):
            o = ord(ch)
            if off <= o < hi:
                if run_start < i:
                    ids.extend(self.text.encode(segment[run_start:i]))
                ids.append(self.codec_vocab_start + (o - off))
                run_start = i + 1
        if run_start < len(segment):
            ids.extend(self.text.encode(segment[run_start:]))
        return ids

    # -- decode ------------------------------------------------------------
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        parts: List[str] = []
        text_run: List[int] = []

        def flush():
            if text_run:
                parts.append(self.text.decode(text_run))
                text_run.clear()

        for tid in ids:
            tid = int(tid)
            if tid >= self.codec_vocab_start:
                flush()
                parts.append(chr(self.unicode_offset + tid - self.codec_vocab_start))
            elif tid in self._id_to_special:
                flush()
                if not skip_special_tokens:
                    parts.append(self._id_to_special[tid])
            elif skip_special_tokens and tid in (
                self.bos_token_id,
                self.eos_token_id,
                self.pad_token_id,
            ):
                flush()
            else:
                text_run.append(tid)
        flush()
        return "".join(parts)

    # -- lookups -----------------------------------------------------------
    def convert_tokens_to_ids(self, token: str) -> Optional[int]:
        if token in self._special_to_id:
            return self._special_to_id[token]
        if len(token) == 1:
            o = ord(token)
            if self.unicode_offset <= o < self.unicode_offset + self.num_codec_tokens:
                return self.codec_vocab_start + (o - self.unicode_offset)
        return self.text.token_to_id(token)

    def is_codec_token(self, token_id: int) -> bool:
        return token_id >= self.codec_vocab_start

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        meta = {
            "num_codebooks": self.num_codebooks,
            "codebook_size": self.codebook_size,
            "unicode_offset": self.unicode_offset,
            "special_tokens": list(self.special_tokens),
            "text_tokenizer": "byte" if isinstance(self.text, ByteTextTokenizer) else "hf",
        }
        if isinstance(self.text, ByteTextTokenizer):
            meta["atomic_tokens"] = self.text.atomic_tokens
        with open(os.path.join(path, "codec_tokenizer.json"), "w", encoding="utf-8") as f:
            json.dump(meta, f, ensure_ascii=False, indent=2)
        if not isinstance(self.text, ByteTextTokenizer):
            self.text.hf.save_pretrained(path)

    @classmethod
    def load(cls, path: str) -> "CodecTextTokenizer":
        with open(os.path.join(path, "codec_tokenizer.json"), "r", encoding="utf-8") as f:
            meta = json.load(f)
        if meta["text_tokenizer"] == "byte":
            text = ByteTextTokenizer(atomic_tokens=meta.get("atomic_tokens"))
        else:
            from transformers import AutoTokenizer

            text = HFTextTokenizerAdapter(AutoTokenizer.from_pretrained(path))
        return cls(
            text_tokenizer=text,
            num_codebooks=meta["num_codebooks"],
            codebook_size=meta["codebook_size"],
            unicode_offset=meta["unicode_offset"],
            special_tokens=meta["special_tokens"],
        )
