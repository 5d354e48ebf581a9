"""Spans and host-sync counters of the batched solve, recorded on request.

    from scipsdp_tpu_torch.utils import trace

    with trace.recording() as rec:
        ipm_solve(...)
    rec.spans      # every span, in the order they opened
    rec.syncs      # Counter: host syncs by site

Off (the default), :func:`span` returns one shared no-op span and
:func:`sync` only calls its function: one read of a module flag each, with
no clock read and nothing recorded.  While a :func:`recording` is open, a
span records its name, its start and end from ``time.perf_counter_ns()``,
its id, its parent's id (the innermost span open when it began), the id of
the ``ipm.solve`` span it belongs to (so that the spans of one request
share an identifier) and attributes known on the host: an attribute never
reads the device.  Spans and counts stay in memory on the
:class:`Recording`; nothing is written to a file.

``Recording.offset_ns`` is ``time.time_ns() - time.perf_counter_ns()``
taken when the recording began: a span's ``start_ns + offset_ns`` lies on
the clock on which ``torch.profiler`` stamps its raw records, so a device
trace taken in the same window can be split by the spans open at each
moment.

The spans of one thread nest: a span must end before its parent does and
before a generator that opened it yields.  One recording at a time.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Optional

SOLVE = "ipm.solve"      # a span that starts a request of its own
SYNC = "ipm.sync"        # the host blocked on the device (see sync)


class Span:
    """One recorded span; ``end_ns`` is None while it is open."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "solve",
                 "attrs", "_rec")

    def __init__(self, rec: "Recording", name: str, attrs: dict):
        stack = rec._stack
        up = stack[-1] if stack else None
        self.name, self.attrs, self._rec = name, attrs, rec
        self.id = len(rec.spans)
        self.parent = None if up is None else up.id
        self.solve = (self.id if name == SOLVE
                      else None if up is None else up.solve)
        self.end_ns = None
        rec.spans.append(self)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def end(self) -> None:
        """Close the span, and any span still open inside it (one that an
        exception skipped)."""
        t = time.perf_counter_ns()
        if self.end_ns is not None:
            return
        stack = self._rec._stack
        while stack:
            top = stack.pop()
            top.end_ns = t
            if top is self:
                break


class _Off:
    """The span of a tracer that is off: it records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self) -> None:
        pass


OFF = _Off()


class Recording:
    """What one :func:`recording` collected."""

    def __init__(self):
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.spans: list = []
        self.syncs: collections.Counter = collections.Counter()
        self._stack: list = []


_rec: Optional[Recording] = None


@contextlib.contextmanager
def recording():
    """Record spans and sync counts inside the ``with`` block; yields the
    :class:`Recording`.  Spans still open when it ends are closed then."""
    global _rec
    if _rec is not None:
        raise RuntimeError("trace.recording: a recording is already open")
    rec = _rec = Recording()
    try:
        yield rec
    finally:
        _rec = None
        if rec._stack:
            rec._stack[0].end()


def span(name: str, **attrs):
    """Open a span: use it as a context manager, or call its ``end()``."""
    rec = _rec
    if rec is None:
        return OFF
    return Span(rec, name, attrs)


def sync(site: str, fn, *args, **kw):
    """``fn(*args, **kw)``: a host read or a blocking copy.  While
    recording, counts one host sync at ``site`` and records the call as an
    ``ipm.sync`` span with that ``site``.  A site counts on every device
    alike, so the CPU counts the syncs the card makes."""
    rec = _rec
    if rec is None:
        return fn(*args, **kw)
    rec.syncs[site] += 1
    with Span(rec, SYNC, {"site": site}):
        return fn(*args, **kw)
