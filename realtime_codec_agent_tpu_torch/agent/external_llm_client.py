"""OpenAI-compatible streaming chat client for external response text.

Port of realtime_codec_agent_tpu/agent/external_llm_client.py on the
standard library (``urllib.request`` + SSE parsing; ``requests`` is not a
dependency of the port). Capability rebuild of the reference client
(external_llm_client.py:5-164) without the openai sdk (the wire protocol is
identical). Preserves:
transcript -> role-mapped messages with [silence] handling, background-thread
stream preparation with a cancelled-thread set, sentence-joining on
punctuation, and defensive close semantics.
"""
from __future__ import annotations

import json
import threading
import urllib.request
from typing import Any, Dict, List, Optional

from ..serving.client import iter_sse_data

SENTENCE_PUNCT = (".", "!", "?", ":", ";")


class ExternalLLMClient:
    @classmethod
    def get_models(cls, api_key: str, base_url: str) -> List[str]:
        try:
            headers = {"Authorization": f"Bearer {api_key}"} if api_key else {}
            req = urllib.request.Request(f"{base_url.rstrip('/')}/models", headers=headers)
            with urllib.request.urlopen(req, timeout=10) as resp:
                return [m["id"] for m in json.loads(resp.read()).get("data", [])]
        except Exception:
            return []

    def __init__(
        self,
        api_key: str,
        base_url: str,
        model: Optional[str] = None,
        agent_identity: str = "A",
        allow_laughter: bool = True,
    ):
        self.api_key = api_key
        self.base_url = base_url.rstrip("/")
        is_openai = "openai.com" in self.base_url
        self.system_role = "developer" if is_openai else "system"
        self.assistant_prefill_supported = not is_openai
        if not model:
            models = self.get_models(api_key, base_url)
            if not models:
                raise ValueError(f"No models found at {base_url}.")
            model = models[0]
        self.model = model
        self.agent_identity = agent_identity
        self.allow_laughter = allow_laughter

        self.cancelled_threads = set()
        self.prep_stream_thread: Optional[threading.Thread] = None
        self.stream = None  # iterator of text deltas
        self._stream_resp = None  # the open SSE response
        self.stream_read_count = 0

    # -- message building ----------------------------------------------------
    def get_messages(
        self, transcript: List[Dict[str, Any]], additional_instructions: Optional[str]
    ) -> List[Dict[str, str]]:
        extra = (
            f"\n\n## Instructions:\n{additional_instructions}"
            if additional_instructions
            else ""
        )
        laughter = (
            " and laughter (e.g. [laughing], [laughs] or &=laughing, &=laughs)"
            if self.allow_laughter
            else ""
        )
        system = (
            "You are a friendly assistant engaging in a spoken telephone conversation "
            "with a user.\n\n## Response Format:\n"
            "- Respond naturally, including backchannels (e.g. yeah, sure, mhm) and "
            f"fillers (e.g. uh, um, hmm){laughter}.\n"
            "- You can also choose to say nothing, in which case respond with [silence].\n"
            "- If the user responds with a backchannel (e.g. yeah, sure, mhm) or with "
            f"[silence], you may continue your previous response.{extra}"
        )
        messages = [{"role": self.system_role, "content": system}]
        for turn in transcript:
            if turn["speaker"] != self.agent_identity:
                if messages[-1]["role"] == "user":
                    messages[-1]["content"] += " " + turn["text"]
                else:
                    messages.append({"role": "user", "content": turn["text"]})
            else:
                if messages[-1]["role"] == self.system_role:
                    messages.append({"role": "user", "content": "[silence]"})
                if messages[-1]["role"] == "assistant":
                    messages[-1]["content"] += " " + turn["text"]
                else:
                    messages.append({"role": "assistant", "content": turn["text"]})
        if len(messages) == 1 or (
            not self.assistant_prefill_supported and messages[-1]["role"] == "assistant"
        ):
            messages.append({"role": "user", "content": "[silence]"})
        return messages

    # -- streaming -----------------------------------------------------------
    def _open_sse(self, messages, top_p: float, max_tokens: int):
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        body = {
            "model": self.model,
            "messages": messages,
            "top_p": top_p,
            "max_tokens": max_tokens,
            "stream": True,
        }
        req = urllib.request.Request(
            f"{self.base_url}/chat/completions", data=json.dumps(body).encode(), headers=headers, method="POST",
        )
        resp = urllib.request.urlopen(req, timeout=120)

        def deltas():
            for payload in iter_sse_data(resp):
                try:
                    delta = json.loads(payload)["choices"][0]["delta"].get("content")
                except (KeyError, IndexError, json.JSONDecodeError):
                    continue
                if delta:
                    yield delta

        return resp, deltas()

    def _prep_stream(self, messages, top_p: float, max_tokens: int) -> None:
        curr = threading.current_thread()
        resp = None
        try:
            resp, stream = self._open_sse(messages, top_p, max_tokens)
            if curr in self.cancelled_threads:
                resp.close()
                return
            self._stream_resp = resp
            self.stream = stream
            self.stream_read_count = 0
        except Exception:
            if resp is not None:
                try:
                    resp.close()
                except Exception:
                    pass
            raise
        finally:
            if self.prep_stream_thread is curr:
                self.prep_stream_thread = None
            self.cancelled_threads.discard(curr)

    def prep_stream(
        self,
        transcript: List[Dict[str, Any]],
        additional_instructions: Optional[str],
        top_p: float = 0.9,
        max_tokens: int = 100,
    ) -> None:
        self.close_stream()
        messages = self.get_messages(transcript, additional_instructions)
        self.prep_stream_thread = threading.Thread(
            target=self._prep_stream, args=(messages, top_p, max_tokens), daemon=True
        )
        self.prep_stream_thread.start()

    def next_chunk(self) -> Optional[str]:
        if self.prep_stream_thread is not None:
            self.prep_stream_thread.join()
        if self.stream is None:
            return None
        chunk = next(self.stream, None)
        if chunk is None:
            self.close_stream()
            return None
        self.stream_read_count += 1
        return chunk

    def next_sentence(self) -> Optional[str]:
        parts: List[str] = []
        while True:
            chunk = self.next_chunk()
            if chunk is None:
                break
            parts.append(chunk)
            if any(chunk.endswith(p) for p in SENTENCE_PUNCT):
                break
        sentence = "".join(parts).replace("\n", " ").replace("[ ", "[").replace(" ]", "]").strip()
        return sentence or None

    def close_stream(self, blocking: bool = False) -> None:
        if self.prep_stream_thread is not None:
            self.cancelled_threads.add(self.prep_stream_thread)
            self.prep_stream_thread = None
        if self._stream_resp is not None:
            try:
                self._stream_resp.close()
            except Exception:
                pass
        self._stream_resp = None
        self.stream = None
        if blocking:
            for thread in list(self.cancelled_threads):
                thread.join()
