"""Spans of the port's layers: on the profiler's clock, or in memory.

``span(name)`` marks one piece of the program's work (``with
tracing.span("tile_fusion.scatter"): ...``), and ``step()`` a training
step, the root whose identifier every span inside it carries.  A span
is in one of three states, or two at once:

- **off** (no profiler is recording and no ``collect()`` is open): one
  shared no-op context, after one read of the profiler's flag and one of
  this module's.  ``record_function`` is never entered.
- **a profiler is recording**: ``record_function(name)``, so the span
  lands in the Kineto trace as a ``user_annotation`` on the clock of the
  device's kernels, and the launches inside it fall under it.
- **inside ``collect()``**: ``(name, start_ns, end_ns, parent, step,
  thread)`` kept in memory on ``time.perf_counter_ns``, read once the
  block has closed (``Spans``).

Parents come from a stack for each thread.  Autograd runs the backward of
CUDA tensors on a device thread of its own, so the backward's spans are
roots there (on the CPU it runs on the calling thread); they carry the
step's identifier all the same.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch.autograd.profiler as _profiler
from torch.autograd.profiler import record_function

#: the training step's root span (``step()``)
STEP = "train_step"

_NOOP = contextlib.nullcontext()
#: the open ``collect()``'s record, else None
_record: "Spans | None" = None
_local = threading.local()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    #: index in ``Spans.spans`` of the enclosing span on the same thread
    parent: int | None
    #: the step identifier: 1 for the first ``step()``, 0 before it
    step: int
    thread: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Spans:
    """What one ``collect()`` recorded: ``spans`` in the order they
    opened, and ``steps``, the count of ``step()`` roots."""

    def __init__(self):
        self.steps = 0
        self.spans: list = []
        self._ids = itertools.count()
        self._done: list = []

    def _close(self) -> None:
        done = sorted(self._done)
        index = {d[0]: k for k, d in enumerate(done)}
        self.spans = [Span(name, t0, t1, index.get(parent), step, thread)
                      for _, name, t0, t1, parent, step, thread in done]

    def roots(self, prefix: str) -> list:
        """The outermost spans whose names start with ``prefix``: no span
        enclosing one on its thread has such a name."""
        out = []
        for s in self.spans:
            if not s.name.startswith(prefix):
                continue
            p = s.parent
            while p is not None and not self.spans[p].name.startswith(prefix):
                p = self.spans[p].parent
            if p is None:
                out.append(s)
        return out

    def self_s(self, name: str) -> float:
        """Seconds inside the spans called ``name`` that none of their
        children covers, summed over those spans."""
        mine = {k for k, s in enumerate(self.spans) if s.name == name}
        ns = sum(self.spans[k].end_ns - self.spans[k].start_ns for k in mine)
        ns -= sum(s.end_ns - s.start_ns for s in self.spans
                  if s.parent in mine)
        return ns / 1e9


class _Open:
    """One span while it is open."""

    __slots__ = ("name", "new_step", "rf", "rec", "ident", "parent", "step",
                 "t0")

    def __init__(self, name: str, new_step: bool):
        self.name, self.new_step = name, new_step

    def __enter__(self):
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = record_function(self.name)
            self.rf.__enter__()
        rec = self.rec = _record
        if rec is not None:
            if self.new_step:
                rec.steps += 1
            stack = _stack()
            self.parent = stack[-1] if stack else None
            self.ident = next(rec._ids)
            self.step = rec.steps
            stack.append(self.ident)
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            t1 = time.perf_counter_ns()
            _stack().pop()
            rec._done.append((self.ident, self.name, self.t0, t1, self.parent,
                              self.step, threading.get_ident()))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str):
    """A context around one piece of work, called ``name``."""
    if _record is None and not _profiler._is_profiler_enabled:
        return _NOOP
    return _Open(name, False)


def step():
    """The training step's root span (``STEP``): it advances the step
    identifier that the spans opened inside it carry, on any thread."""
    if _record is None and not _profiler._is_profiler_enabled:
        return _NOOP
    return _Open(STEP, True)


@contextlib.contextmanager
def collect():
    """Record every span opened in the block, in memory; yields the
    ``Spans``, filled when the block closes.  One at a time."""
    global _record
    if _record is not None:
        raise RuntimeError("a collect() block is already open")
    rec = _record = Spans()
    try:
        yield rec
    finally:
        _record = None
        rec._close()
