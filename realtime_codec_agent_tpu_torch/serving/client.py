"""Completions client: HTTP (OpenAI-compatible) or in-process backend.

Port of realtime_codec_agent_tpu/serving/client.py on the standard library
(``urllib.request``; ``requests`` is not a dependency of the port). The demo
scripts drive either a running CompletionServer / vLLM-style endpoint or an
in-process backend through the same interface (reference demos used the
openai sdk against vLLM, run_demo.py:74-92). Every HTTP call has a timeout.
"""
from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Iterator, Optional, Sequence


def iter_sse_data(resp) -> Iterator[str]:
    """The ``data:`` payloads of a server-sent-events response (a file-like
    HTTP response; chunked transfer is decoded by ``http.client``), up to
    ``[DONE]``."""
    for raw in resp:
        line = raw.decode("utf-8").rstrip("\r\n")
        if not line.startswith("data:"):
            continue
        data = line[len("data:"):].strip()
        if data == "[DONE]":
            return
        yield data


class CompletionsClient:
    def __init__(self, base_url: Optional[str] = None, backend=None, api_key: str = "empty",
                 timeout: float = 600.0):
        if (base_url is None) == (backend is None):
            raise ValueError("provide exactly one of base_url or backend")
        self.base_url = base_url.rstrip("/") if base_url else None
        self.backend = backend
        self.api_key = api_key
        self.timeout = timeout

    def _post(self, payload: dict):
        req = urllib.request.Request(
            f"{self.base_url}/completions",
            data=json.dumps(payload).encode(),
            headers={"Authorization": f"Bearer {self.api_key}", "Content-Type": "application/json"},
            method="POST",
        )
        return urllib.request.urlopen(req, timeout=self.timeout)

    def get_model_name(self) -> Optional[str]:
        if self.backend is not None:
            return self.backend.model_name
        try:
            with urllib.request.urlopen(f"{self.base_url}/models", timeout=10) as resp:
                data = json.loads(resp.read())
        except (urllib.error.URLError, ConnectionError):
            return None
        models = [m for m in data["data"] if m.get("object") == "model"]
        return models[0]["id"] if models else None

    def stream_completion(
        self,
        prompt: str,
        max_tokens: int = 256,
        temperature: float = 1.0,
        top_p: float = 1.0,
        min_p: float = 0.0,
        seed: Optional[int] = None,
        stop: Optional[Sequence[str]] = None,
    ) -> Iterator[str]:
        if self.backend is not None:
            yield from self.backend.generate(
                prompt,
                max_tokens=max_tokens,
                temperature=temperature,
                top_p=top_p,
                min_p=min_p,
                seed=seed,
                stop=stop,
            )
            return
        payload = {
            "model": self.get_model_name(),
            "prompt": prompt,
            "max_tokens": max_tokens,
            "temperature": temperature,
            "top_p": top_p,
            "seed": seed,
            "stop": list(stop) if stop else None,
            "stream": True,
            "skip_special_tokens": False,
            "spaces_between_special_tokens": False,
        }
        if min_p > 0:
            payload["min_p"] = min_p
        with self._post(payload) as resp:
            for data in iter_sse_data(resp):
                text = json.loads(data)["choices"][0]["text"]
                if text:
                    yield text

    def complete(self, prompt: str, **kwargs) -> str:
        return "".join(self.stream_completion(prompt, **kwargs))

    def complete_with_reason(self, prompt: str, **kwargs):
        """(text, finish_reason): 'stop' for stop-string/EOS, 'length' otherwise."""
        if self.backend is not None:
            text = "".join(
                self.backend.generate(
                    prompt,
                    max_tokens=kwargs.get("max_tokens", 256),
                    temperature=kwargs.get("temperature", 1.0),
                    top_p=kwargs.get("top_p", 1.0),
                    min_p=kwargs.get("min_p", 0.0),
                    presence_penalty=kwargs.get("presence_penalty", 0.0),
                    frequency_penalty=kwargs.get("frequency_penalty", 0.0),
                    seed=kwargs.get("seed"),
                    stop=kwargs.get("stop"),
                )
            )
            return text, self.backend.last_finish_reason
        payload = {
            "model": self.get_model_name(),
            "prompt": prompt,
            "stream": False,
            "skip_special_tokens": False,
            "spaces_between_special_tokens": False,
        }
        payload.update({k: v for k, v in kwargs.items() if v is not None})
        if isinstance(payload.get("stop"), str):
            payload["stop"] = [payload["stop"]]
        with self._post(payload) as resp:
            choice = json.loads(resp.read())["choices"][0]
        return choice["text"], choice.get("finish_reason", "stop")
