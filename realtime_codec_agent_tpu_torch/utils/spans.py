"""Spans: named intervals of the program, kept while a ``torch.profiler``
runs and at no other time.

``span(name)`` is a context manager. With no profiler running it returns one
shared no-op context: no ``record_function`` call, no CUDA event, nothing
allocated. While a profiler runs (``torch.autograd.profiler._is_profiler_enabled``,
the process-wide flag, so that a span on autograd's device threads sees it
too) it enters ``torch.profiler.record_function(name)``, which puts the span
in the profiler's timeline on the kernels' clock, and keeps a :class:`Span`:
its name, its step, its parent, its thread, its host interval
(``time.perf_counter_ns``) and, once CUDA is initialized, a pair of timing
events recorded on the current stream at entry and exit (on the CPU, where
work is synchronous, the host interval is the device interval). A span that
raises still closes and is kept.

The parent is the innermost span open on the same thread, or else the
innermost span open on the thread that opened the step (a checkpoint's
recompute runs on autograd's device thread inside the caller's
``train.backward``). A span without a parent opens a step; its children
share its step.

A span entered while a profiler runs, after one entered while none did,
starts a new window. ``window()`` returns the last window's spans, each with
its device interval in milliseconds from the window's first span.

Counters belong to the same windows. ``count(name, n)`` adds ``n`` to the
window's counter ``name`` while a profiler runs, from whichever thread calls
it, and otherwise only marks that the next window starts afresh, as a span
does; ``counters()`` returns the last window's sums.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


@dataclasses.dataclass
class Span:
    name: str
    step: int
    parent: Optional[int]  # index of the enclosing span in the window
    thread: int
    host_start_ns: int
    host_end_ns: Optional[int] = None
    # set by window(): ms from the window's first span (on the card, its start event)
    device_start_ms: Optional[float] = None
    device_end_ms: Optional[float] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)
    index: int = dataclasses.field(default=-1, repr=False)

    @property
    def device_ms(self) -> Optional[float]:
        if self.device_end_ms is None:
            return None
        return self.device_end_ms - self.device_start_ms


class _Recorder:
    """The spans and counters of the current window and the spans open on
    each thread."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.reset()

    def reset(self) -> None:
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = collections.Counter()
        self.steps = 0
        self.fresh = True  # the next span or count kept starts a new window
        self.root: Optional[list] = None  # the open spans of the thread that opened the step

    def begin(self) -> None:
        """Under the lock: start a new window if the profiler was off since the last."""
        if self.fresh:
            self.spans, self.counts, self.steps, self.fresh = [], collections.Counter(), 0, False

    def open_spans(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def _in_window(self, sp: Span) -> bool:
        return sp.index < len(self.spans) and self.spans[sp.index] is sp

    def open(self, name: str) -> Span:
        stack = self.open_spans()
        with self.lock:
            self.begin()
            outer = stack[-1] if stack else (self.root[-1] if self.root else None)
            if outer is not None and not self._in_window(outer):
                outer = None
            if outer is None:
                self.steps += 1
                self.root = stack
            sp = Span(name, outer.step if outer else self.steps, outer.index if outer else None,
                      threading.get_ident(), time.perf_counter_ns(), index=len(self.spans))
            self.spans.append(sp)
        stack.append(sp)
        return sp

    def close(self, sp: Span) -> None:
        sp.host_end_ns = time.perf_counter_ns()
        stack = self.open_spans()
        with self.lock:  # another thread may be reading this stack as the step's
            if stack and stack[-1] is sp:
                stack.pop()


_REC = _Recorder()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "rf", "sp")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.sp = sp = _REC.open(self.name)
        if torch.cuda.is_initialized():
            sp.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            sp.events[0].record()
        return sp

    def __exit__(self, *exc):
        sp = self.sp
        try:
            if sp.events is not None:
                sp.events[1].record()
            _REC.close(sp)
        finally:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around a named interval: a no-op unless a profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        _REC.fresh = True
        return _OFF
    return _On(name)


def on_backward(name: str, fn):
    """``fn``, or while a profiler runs, ``fn`` inside span ``name`` where
    autograd's backward calls it (a checkpoint's recompute): for the
    function handed to ``torch.utils.checkpoint.checkpoint``. Decided when
    called, once a forward: a forward taken with no profiler running gives
    its backward no recompute spans."""
    if not _autograd_profiler._is_profiler_enabled:
        return fn

    def run(*args, **kwargs):
        if torch._C._current_graph_task_id() == -1:
            return fn(*args, **kwargs)
        with span(name):
            return fn(*args, **kwargs)

    return run


def count(name: str, n: int) -> None:
    """Add ``n`` to the window's counter ``name``, kept only while a profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        _REC.fresh = True
        return
    with _REC.lock:
        _REC.begin()
        _REC.counts[name] += n


def counters() -> Dict[str, int]:
    """The last window's counters."""
    with _REC.lock:
        return dict(_REC.counts)


def window() -> List[Span]:
    """The last window's spans in the order they opened, each with its device
    interval (None while it is open). Synchronizes the card first."""
    spans = list(_REC.spans)
    timed = [s for s in spans if s.events is not None]
    if timed:
        torch.cuda.synchronize()
    origin = timed[0].events[0] if timed else None
    host0 = spans[0].host_start_ns if spans else 0
    for s in spans:
        if s.host_end_ns is None:
            continue
        if s.events is not None:
            s.device_start_ms = origin.elapsed_time(s.events[0])
            s.device_end_ms = origin.elapsed_time(s.events[1])
        else:
            s.device_start_ms = (s.host_start_ns - host0) / 1e6
            s.device_end_ms = (s.host_end_ns - host0) / 1e6
    return spans


def reset() -> None:
    """Forget every span kept (for tests)."""
    with _REC.lock:
        _REC.reset()
