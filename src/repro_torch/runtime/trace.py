"""Spans and counters inside the port, off unless an API call turns them on.

A span names one phase of the program's work where it happens: the train
step's forward, backward and optimizer (``train/step.py``), the backward
of every kernel op (``kernels/ops.py``), the sweep and each scored
program's build, warm-up, timed calls and release (``core/tuner.py``,
``core/executor.py``).  Each span records its name, an id, its parent's
id, its thread, its start and end on ``time.time_ns()`` (the clock the
profiler stamps device events on) and a few attributes; with device
timing on, also a pair of CUDA events on the current stream, read as
device ms by :func:`export` after one synchronize.  A counted span also
records how many device allocations the caching allocator made inside it
(``memory_stats()``'s ``num_device_alloc``, :data:`MALLOCS`).

Off (the default), :func:`span` reads one flag and returns a shared null
context: no clock, no event, no ``memory_stats()``, no record.  On, the
spans stay in memory until :func:`clear`.

Parents across threads: a span opened with ``lend=True`` (the train
step's backward, a scored program's warm-up and timed calls) is the
parent of spans opened on another thread that has none open, as
autograd's device thread has when it runs a kernel op's backward.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import List, Optional

import torch

#: the counter of a counted span: the allocator's device allocation calls
MALLOCS = "alloc.device_mallocs"

_NULL = contextlib.nullcontext()


def _mallocs() -> Optional[int]:
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.memory_stats().get("num_device_alloc")


class Span:
    """One open, then closed, span of the tracer (a context manager)."""

    __slots__ = ("tracer", "name", "id", "parent", "thread", "t0", "t1",
                 "attrs", "lend", "counted", "events", "counts")

    def __init__(self, tracer: "Tracer", name: str, lend: bool,
                 counted: bool, attrs: dict):
        self.tracer, self.name, self.attrs = tracer, name, attrs
        self.lend, self.counted = lend, counted
        self.id = next(tracer._ids)
        self.events = self.counts = None

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        self.thread = threading.get_ident()
        if stack:
            self.parent = stack[-1].id
        else:
            with tr._lock:
                self.parent = tr._lent[-1].id if tr._lent else None
        if self.counted:
            self.counts = _mallocs()
        if tr.device_timing:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        stack.append(self)
        if self.lend:
            with tr._lock:
                tr._lent.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        tr = self.tracer
        if self.lend:
            with tr._lock:
                tr._lent.remove(self)
        tr._stack().pop()
        if self.events is not None:
            self.events[1].record()
        if self.counts is not None:
            now = _mallocs()
            self.counts = None if now is None else now - self.counts
        tr._done.append(self)
        return False

    def record(self, synced: bool) -> dict:
        ms = self.events[0].elapsed_time(self.events[1]) \
            if synced and self.events is not None else None
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "thread": self.thread, "t0_ns": self.t0, "t1_ns": self.t1,
                "attrs": dict(self.attrs), "device_ms": ms,
                "counters": {} if self.counts is None
                else {MALLOCS: self.counts}}


class Tracer:
    """The spans of one process, recorded while :attr:`on`."""

    def __init__(self):
        self.on = False
        self.device_timing = False
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._lent: List[Span] = []
        self._done: List[Span] = []

    def _stack(self) -> List[Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def enable(self, device_timing: bool = False):
        """Record spans from now on; with ``device_timing`` each span also
        records a pair of CUDA events (a CUDA device must be there)."""
        if device_timing and not torch.cuda.is_available():
            raise RuntimeError("device timing needs a CUDA device; "
                               "torch.cuda.is_available() is False")
        self.device_timing = device_timing
        self.on = True

    def disable(self):
        """Record no new span (those recorded stay until :meth:`clear`)."""
        self.on = False

    def clear(self):
        """Forget every closed span."""
        self._done = []

    def export(self) -> List[dict]:
        """Every closed span as a dict, in the order they closed:
        ``name``, ``id``, ``parent`` (None at the top), ``thread``,
        ``t0_ns``/``t1_ns`` (``time.time_ns()``), ``attrs``, ``device_ms``
        (None without device timing) and ``counters`` ({:data:`MALLOCS`:
        n} on a counted span on a CUDA device).  Synchronizes once when a
        span holds CUDA events."""
        done = list(self._done)
        synced = any(s.events is not None for s in done)
        if synced:
            torch.cuda.synchronize()
        return [s.record(synced) for s in done]


TRACER = Tracer()
enable, disable, clear, export = (TRACER.enable, TRACER.disable,
                                  TRACER.clear, TRACER.export)


def span(name: str, *, lend: bool = False, counted: bool = False,
         **attrs):
    """A context manager recording the span ``name`` while the tracer is
    on; the shared null context while it is off.  ``lend``: the parent of
    spans opened meanwhile on threads with none open; ``counted``: records
    :data:`MALLOCS` inside it; ``attrs``: plain values kept with it."""
    if not TRACER.on:
        return _NULL
    return Span(TRACER, name, lend, counted, attrs)


def traced(name: str):
    """Decorator: every call of the function inside the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
