"""Completion backend over the duplex LM engine, one sequence at a time.

Port of realtime_codec_agent_tpu/serving/backend.py: the stand-in for the
vLLM server the reference uses for offline demos (reference
utils/vllm_utils.py, run_demo*.py). A prompt is prefilled with llama.cpp-
style longest-prefix KV reuse (reference llamacpp_utils.py:119-135), then
generated token by token with stop-string detection and streamed as decoded
text (specials kept, ``skip_special_tokens=False`` semantics).
"""
from __future__ import annotations

import threading
from typing import Iterator, List, Optional, Sequence

from ..lm.engine import DuplexLMEngine
from ..tokenization import CodecTextTokenizer


class CompletionBackend:
    def __init__(
        self,
        engine: DuplexLMEngine,
        tokenizer: CodecTextTokenizer,
        model_name: str = "rtca-tpu-duplex-lm",
    ):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self._lock = threading.Lock()  # one sequence at a time per engine
        self.last_finish_reason: Optional[str] = None  # "stop" | "length"

    def prewarm(self) -> None:
        """Build the kernel library before the first request, so no request
        waits for ``nvcc``; on the CPU there is nothing to do. The engine
        runs eager (no program is compiled per cache bucket or top-k, and B3
        bounds its cache read on the device), so this touches no engine
        state: the KV cache, the token mirror and the sampler stay as they
        were."""
        if self.engine.device.type == "cuda":
            from ..ops import _cuda

            _cuda.load()

    def _prefill_with_prefix_reuse(self, prompt_ids: List[int]) -> None:
        """Keep the longest matching KV prefix, roll back past the divergence,
        eval only the new suffix."""
        eng = self.engine
        cached = eng._input_ids[: eng.n_tokens]
        common = 0
        for a, b in zip(cached, prompt_ids[:-1]):
            if a != b:
                break
            common += 1
        eng.n_tokens = common
        # eval all but the last prompt token; the first eval_and_sample call
        # evals the last one
        if len(prompt_ids) - 1 > common:
            eng.eval(prompt_ids[common:-1])

    def generate(
        self,
        prompt: str,
        max_tokens: int = 256,
        temperature: float = 1.0,
        top_p: float = 1.0,
        top_k: int = 0,
        min_p: float = 0.0,
        seed: Optional[int] = None,
        stop: Optional[Sequence[str]] = None,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
        repeat_penalty: float = 1.0,
    ) -> Iterator[str]:
        """Yields decoded text deltas until max_tokens / stop / EOS."""
        stop = list(stop or [])
        self.last_finish_reason = "length"
        with self._lock:
            eng = self.engine
            eng.init_sampler_for_generate(
                top_k=top_k if top_k else 0,
                top_p=top_p,
                min_p=min_p,
                temp=temperature,
                presence_penalty=presence_penalty,
                frequency_penalty=frequency_penalty,
                repeat_penalty=repeat_penalty,
                seed=seed,
            )
            prompt_ids = self.tokenizer.encode(prompt)
            self._prefill_with_prefix_reuse(prompt_ids)

            out_ids: List[int] = []
            emitted = ""
            pending = [prompt_ids[-1]]
            for _ in range(max_tokens):
                token = eng.eval_and_sample(pending)
                pending = [token]
                if token == self.tokenizer.eos_token_id:
                    self.last_finish_reason = "stop"
                    break
                out_ids.append(token)
                text = self.tokenizer.decode(out_ids, skip_special_tokens=False)
                # stop-string check against the full decoded text
                stop_hit = None
                for s in stop:
                    idx = text.find(s)
                    if idx >= 0:
                        stop_hit = idx
                        break
                if stop_hit is not None:
                    self.last_finish_reason = "stop"
                    final = text[:stop_hit]
                    if len(final) > len(emitted):
                        yield final[len(emitted):]
                    return
                # emit complete new chars (hold back a tail that could be a
                # stop-string prefix)
                hold = max((len(s) - 1 for s in stop), default=0)
                safe = text[: len(text) - hold] if hold else text
                if len(safe) > len(emitted):
                    yield safe[len(emitted):]
                    emitted = safe
            text = self.tokenizer.decode(out_ids, skip_special_tokens=False)
            if len(text) > len(emitted):
                yield text[len(emitted):]
