"""Continuous-batching completion backend over BatchedDecodeEngine.

Port of realtime_codec_agent_tpu/serving/batched_backend.py. Concurrent
requests share one batched forward a token: a worker thread assigns waiting
requests to free batch slots (row-sliced prefill), steps all active rows
together, and routes each row's decoded text deltas to its request stream,
applying per-request stop strings / EOS / max_tokens. This is the
concurrency the reference delegated to vLLM (SURVEY §2.2).

The loop is dispatch-first: dispatch k+1 is launched against the engine's
device-carried state before dispatch k's tokens are read, so the host's
routing of one dispatch overlaps the card's work on the next. Counters for
the serving report: ``dispatches``, ``tokens`` (routed to requests, EOS
included) and ``host_secs`` (the worker's time outside the device read:
admission, launch, routing).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence

from ..lm.batched_engine import BatchedDecodeEngine
from ..tokenization import CodecTextTokenizer

_SENTINEL = object()
_DRAINING = object()  # slot finished but its speculative token is in flight


@dataclass
class _Request:
    prompt_ids: List[int]
    max_tokens: int
    stop: List[str]
    top_k: int
    sampler: dict = field(default_factory=dict)
    out: "queue.Queue" = field(default_factory=queue.Queue)
    # row-local decode state
    out_ids: List[int] = field(default_factory=list)
    emitted: str = ""
    finish_reason: str = "length"


class BatchedCompletionBackend:
    """Thread-safe: ``generate`` may be called from many request threads."""

    def __init__(
        self,
        engine: BatchedDecodeEngine,
        tokenizer: CodecTextTokenizer,
        model_name: str = "rtca-tpu-duplex-lm",
        steps_per_dispatch: int = 8,
    ):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        # tokens decoded per dispatch: the host's launch and routing work is
        # paid once per S tokens and overlaps the next dispatch. Rows that
        # finish mid-dispatch decode junk for the remainder (discarded on
        # the host); stop/EOS latency granularity becomes S tokens.
        self.steps = max(1, int(steps_per_dispatch))
        # run every cache-bucket variant once before the first request
        engine.prewarm(steps_list=(self.steps,))
        self.dispatches = 0
        self.tokens = 0
        self.host_secs = 0.0
        self._stop = False
        self._waiting: "queue.Queue[_Request]" = queue.Queue()
        self._slots: List[Optional[_Request]] = [None] * engine.batch
        self._wake = threading.Event()
        self._tl = threading.local()  # per-request-thread finish reason
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    @property
    def last_finish_reason(self) -> Optional[str]:
        return getattr(self._tl, "finish_reason", None)

    # ------------------------------------------------------------------ API
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
        prompt_ids = self.tokenizer.encode(prompt)
        # validate on the REQUEST thread (a worker-side failure would stall
        # every stream) and bound decoding by the serving cache
        if len(prompt_ids) > self.engine.max_prompt_len():
            raise ValueError(
                f"prompt too long for the serving cache "
                f"({len(prompt_ids)} > {self.engine.max_prompt_len()} tokens)"
            )
        # reserve 2*steps cache slots for the junk tokens a finished row
        # decodes while its final dispatch(es) are in flight
        max_tokens = max(
            1,
            min(
                max_tokens,
                self.engine.max_context - 2 - len(prompt_ids) - 2 * self.steps,
            ),
        )
        req = _Request(
            prompt_ids=prompt_ids,
            max_tokens=max_tokens,
            stop=list(stop or []),
            top_k=top_k,
        )
        req.sampler = dict(
            top_p=top_p, min_p=min_p, temp=temperature,
            repeat_penalty=repeat_penalty, frequency_penalty=frequency_penalty,
            presence_penalty=presence_penalty, top_k=top_k, seed=seed,
        )
        self._waiting.put(req)
        self._wake.set()
        while True:
            item = req.out.get()
            if item is _SENTINEL:
                self._tl.finish_reason = req.finish_reason
                return
            yield item

    # ---------------------------------------------------------------- worker
    def _admit(self) -> None:
        for row, slot in enumerate(self._slots):
            if slot is not None:
                continue
            try:
                req = self._waiting.get_nowait()
            except queue.Empty:
                return
            try:
                self.engine.set_row_sampler(row, **req.sampler)
                self.engine.prefill_row(row, req.prompt_ids)
            except Exception as e:  # release the request; keep serving
                req.finish_reason = f"error: {e}"
                req.out.put(_SENTINEL)
                continue
            self._slots[row] = req

    def _finish(self, row: int, reason: str, flush_tail: bool = True) -> None:
        req = self._slots[row]
        self._slots[row] = None
        req.finish_reason = reason
        # emit any held-back tail (stop-prefix holdback) — except when a stop
        # STRING fired (its prefix must not leak); EOS/length flush it
        text = self.tokenizer.decode(req.out_ids, skip_special_tokens=False)
        if flush_tail and len(text) > len(req.emitted):
            req.out.put(text[len(req.emitted):])
        req.out.put(_SENTINEL)

    def _route_token(self, row: int, token: int) -> None:
        self.tokens += 1
        req = self._slots[row]
        if token == self.tokenizer.eos_token_id:
            self._finish(row, "stop")  # EOS: flush the held-back tail
            return
        req.out_ids.append(token)
        text = self.tokenizer.decode(req.out_ids, skip_special_tokens=False)
        for s in req.stop:
            idx = text.find(s)
            if idx >= 0:
                final = text[:idx]
                if len(final) > len(req.emitted):
                    req.out.put(final[len(req.emitted):])
                self._finish(row, "stop", flush_tail=False)
                return
        hold = max((len(s) - 1 for s in req.stop), default=0)
        safe = text[: len(text) - hold] if hold else text
        if len(safe) > len(req.emitted):
            req.out.put(safe[len(req.emitted):])
            req.emitted = safe
        if (
            len(req.out_ids) >= req.max_tokens
            or self.engine.row_capacity_left(row) <= self.steps + 1
        ):
            self._finish(row, "length")

    def _loop(self) -> None:
        try:
            self._loop_inner()
        except Exception as e:  # defensive: never leave requests hanging
            import traceback

            traceback.print_exc()
            for row, slot in enumerate(self._slots):
                if slot is not None and slot is not _DRAINING:
                    slot.finish_reason = f"error: {e}"
                    slot.out.put(_SENTINEL)
                self._slots[row] = None
            while True:
                try:
                    req = self._waiting.get_nowait()
                except queue.Empty:
                    break
                req.finish_reason = f"error: {e}"
                req.out.put(_SENTINEL)

    def _loop_inner(self) -> None:
        # dispatch-FIRST: step k+1 is launched against the engine's
        # device-carried state before step k's tokens are read, so the
        # host's routing overlaps the card's work. A row that finishes during
        # resolve was already active in the in-flight step — it DRAINS: its
        # speculative token is discarded at the next resolve, then the slot
        # frees for admission.
        pending = None  # (handles, active_mask)
        draining = [False] * self.engine.batch
        while not self._stop:
            t0 = time.perf_counter()
            try:
                self._admit()
            except Exception:
                import traceback

                traceback.print_exc()
            active = [
                s is not None and not draining[row]
                for row, s in enumerate(self._slots)
            ]
            if not any(active) and pending is None:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue

            if any(active):
                # per-request top_k rides the per-row sampler scalars; the
                # top-k stage's width stays 1024
                handles = self.engine.step_async(
                    active, top_k=1024, steps=self.steps
                )
                this = (handles, list(active))
                self.dispatches += 1
            else:
                this = None

            if pending is not None:
                handles, was_active = pending
                self.host_secs += time.perf_counter() - t0
                tokens = self.engine.resolve(handles)
                t0 = time.perf_counter()
                if self.steps == 1:
                    tokens = [[t] for t in tokens]
                for row, (is_active, row_tokens) in enumerate(
                    zip(was_active, tokens)
                ):
                    if draining[row]:
                        # the speculative tokens of a finished request:
                        # discard and free the slot
                        draining[row] = False
                        self._slots[row] = None
                        continue
                    if not is_active:
                        continue
                    for token in row_tokens:
                        if self._slots[row] is None:
                            break  # finished mid-dispatch: rest is junk
                        self._route_token(row, token)
                    if self._slots[row] is None and this is not None:
                        # finished, but already active in the in-flight
                        # dispatch: hold the slot until those tokens resolve
                        self._slots[row] = _DRAINING
                        draining[row] = True
            self.host_secs += time.perf_counter() - t0
            pending = this

    def shutdown(self) -> None:
        """Stop the worker thread (requests still in flight are not
        finished)."""
        self._stop = True
        self._wake.set()
        self._worker.join(timeout=10)
