"""Named spans of the program: one recorder for its device and host time.

A span marks a region by name; every name starts with ``sg:``, so a reader
picks the program's spans out of a ``torch.profiler`` trace among its
``aten::`` events.  ``with span("sg:vq"):`` is a span of the process-wide
recorder, which records only while tracing is on: while a
``torch.profiler`` session records (the C++ profiler's own state) or inside
:func:`enabled`.  Otherwise a span is a shared no-op: no CUDA call, no
profiler range, nothing recorded; it is a no-op as well while
``torch.compile`` traces.  ``with span(name, recorder):`` records into
``recorder`` (a :class:`Recorder` the caller made) whether tracing is on or
not, and into the process-wide recorder too while it is: the loops time
their steps, evaluations, batches and collectives this way.

A recording span opens a ``torch.profiler.record_function`` range under its
name while tracing is on, which puts its host interval on the profiler's
clock, the clock of the device trace.  On CUDA it records a pair of CUDA
events on the current stream (none while the stream is captured into a CUDA
graph).  A span's device ms is the stream's time between its two events:
it includes any time the card waited for the host inside the span.  Its
host ms is the host clock's.  Each span keeps its parent, the span open
when it began on the same thread; one begun on a thread with none open
(autograd's backward thread) names the span most recently opened on
another thread and still open, which is the one around ``backward()``.
A span inside an open span of the same name is a no-op, so a loop's span
around a step and the step's own span are one span.

    rec = Recorder(device)
    with span("sg:pretrain.step", rec):
        step(...)
    rec.totals()["sg:pretrain.step"]["device_ms"]
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

_NOOP = contextlib.nullcontext()
_seq = itertools.count()
# open spans by thread (autograd's backward runs on threads of its own)
_stacks: dict = {}
_enabled_depth = 0
_profiler_enabled = getattr(torch._C._autograd, "_profiler_enabled",
                            lambda: False)


class Recorder:
    """Spans by name: per call the parent, the host ms and, on CUDA, the
    device ms (read at the first :meth:`totals` or :meth:`ms` after the
    call, after one sync).  ``device`` None: CUDA events whenever CUDA is
    initialized in the process (the process-wide recorder)."""

    def __init__(self, device=None):
        self.cuda = None if device is None else (
            torch.device(device).type == "cuda")
        self._calls = []        # [name, parent, start, stop, host, device]

    def _on_cuda(self) -> bool:
        if self.cuda is None:
            return torch.cuda.is_initialized()
        return self.cuda

    def _resolve(self):
        pending = [c for c in list(self._calls) if c[2] is not None]
        if not pending:
            return
        torch.cuda.synchronize()
        for c in pending:
            c[5] = c[2].elapsed_time(c[3])
            c[2] = c[3] = None

    def totals(self) -> dict:
        """``{name: {"calls", "device_ms", "host_ms", "parents"}}`` over
        every finished span so far: the device ms summed over the calls
        (None where no call had CUDA events), the host ms summed, and the
        calls under each parent name (None: no parent)."""
        self._resolve()
        out = {}
        for name, parent, _, _, host, dev in list(self._calls):
            t = out.setdefault(name, {"calls": 0, "device_ms": None,
                                      "host_ms": 0.0, "parents": {}})
            t["calls"] += 1
            t["host_ms"] += host
            if dev is not None:
                t["device_ms"] = (t["device_ms"] or 0.0) + dev
            t["parents"][parent] = t["parents"].get(parent, 0) + 1
        return out

    def ms(self, name: str, device: bool = True) -> list:
        """Each finished call of ``name``'s device ms (calls without CUDA
        events left out), or with ``device=False`` its host ms."""
        self._resolve()
        return [c[5] if device else c[4] for c in list(self._calls)
                if c[0] == name and (c[5] is not None or not device)]

    def clear(self):
        self._calls = []

    def take(self) -> dict:
        """:meth:`totals`, then :meth:`clear`."""
        out = self.totals()
        self.clear()
        return out


_RECORDER = Recorder()


class _Span:
    __slots__ = ("name", "sinks", "parent", "seq", "range", "start", "t0")

    def __init__(self, name: str, sinks: list):
        self.name, self.sinks = name, sinks

    def __enter__(self):
        stack = _stacks.setdefault(threading.get_ident(), [])
        self.parent = stack[-1].name if stack else _open_elsewhere()
        self.seq = next(_seq)
        stack.append(self)
        self.range = None
        if _RECORDER in self.sinks:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = None
        if any(s._on_cuda() for s in self.sinks) \
                and not torch.cuda.is_current_stream_capturing():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host = 1e3 * (time.perf_counter() - self.t0)
        stop = None
        if self.start is not None:
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
        if self.range is not None:
            self.range.__exit__(*exc)
        _stacks[threading.get_ident()].pop()
        for s in self.sinks:
            s._calls.append([self.name, self.parent, self.start, stop, host,
                             None])
        return False


def _open_elsewhere():
    """The name of the span most recently opened on another thread and
    still open, or None."""
    me, best = threading.get_ident(), None
    for ident, stack in list(_stacks.items()):
        if ident != me and stack and (best is None
                                      or stack[-1].seq > best.seq):
            best = stack[-1]
    return None if best is None else best.name


def tracing() -> bool:
    """Whether the process-wide recorder records: a ``torch.profiler``
    session records, or :func:`enabled` is open."""
    return _enabled_depth > 0 or _profiler_enabled()


def span(name: str, recorder: Recorder = None):
    """A span named ``name`` (module docstring): recorded into ``recorder``
    when given, and into the process-wide recorder while tracing is on."""
    if recorder is None and (torch.compiler.is_compiling()
                             or not tracing()):
        return _NOOP
    stack = _stacks.get(threading.get_ident())
    if recorder is None and stack and stack[-1].name == name:
        return _NOOP
    sinks = [] if recorder is None else [recorder]
    if tracing():
        sinks.append(_RECORDER)
    return _Span(name, sinks)


@contextlib.contextmanager
def enabled():
    """Tracing on inside the block, with or without a profiler."""
    global _enabled_depth
    _enabled_depth += 1
    try:
        yield
    finally:
        _enabled_depth -= 1


def totals() -> dict:
    """The process-wide recorder's :meth:`Recorder.totals`."""
    return _RECORDER.totals()


def take() -> dict:
    """The process-wide recorder's :meth:`Recorder.take`."""
    return _RECORDER.take()
