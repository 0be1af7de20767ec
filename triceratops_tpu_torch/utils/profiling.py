"""Profiling and tracing of the port, on torch.profiler and the host clock
(counterpart of the JAX package's ``utils/profiling.py``):

* ``span(name)``: a program span, used as a context manager or decorator
  at the site where the work happens (names under ``tri.``: README).
  What a span does is the tracer's mode, set by the caller with
  ``tracing(mode)``:

  - ``"off"`` (the default): ``span`` checks one module-level flag and
    returns a shared no-op; no clock is read and nothing is kept;
  - ``"host"``: each span is kept in memory (up to ``SPAN_CAP``; the rest
    are counted under ``span.dropped``) with its name, start and end
    (``time.perf_counter_ns``), its parent span and the id of the call it
    belongs to: a span opened with no span open starts a call, and its
    descendants share its id;
  - ``"profiler"``: as ``"host"``, and each span is also a
    ``torch.profiler.record_function`` range, so it sits in a profiler's
    Chrome trace on the device events' clock.

  ``spans()`` lists the kept spans, ``summary()`` gives per name the
  count, total and self seconds (self: the span's duration less what its
  children cover). The tracer keeps one stack of open spans: spans are
  opened and closed on one thread.
* ``count(name, n=1)``: adds n to a named counter, in every mode;
  ``counters()`` reads them. ``reset()`` clears spans and counters.
  ``device_counters(names, device)`` gives kernels an int64 array on the
  card to add counts to (a launch hands its address to the kernel only
  while ``enabled()``); ``counters()`` folds each such array into the
  counters of its names and zeroes it, so reading the counters, never a
  launch, waits for the card.
* ``trace(logdir)``: a ``torch.profiler`` trace (host, and the card when
  there is one) around a block, in ``"profiler"`` mode, exported as a
  Chrome trace viewable in Perfetto or chrome://tracing.
* ``timed(label)``: a wall-clock section timer that waits for the card
  at both ends, so the section's queued device work is inside it.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time as _time
from collections import namedtuple

import torch

MODES = ("off", "host", "profiler")
SPAN_CAP = 1 << 19

Span = namedtuple("Span", "name start_ns end_ns parent call")
Span.__doc__ = """A kept span: ``parent`` is the index of its parent in
``spans()`` (-1 for none), ``call`` the id it shares with its call;
``end_ns`` is None while it is open."""

_on = False          # any mode but "off"
_profiler = False    # "profiler" mode
_records = []        # [name, start_ns, end_ns, parent, call] per kept span
_stack = []          # indices into _records of the open spans (-1: dropped)
_counters = {}
_device_counts = {}   # (names, device) -> int64 tensor kernels add to
_calls = 0


class _Noop:
    """What ``span`` returns while tracing is off: a context that does
    nothing and a decorator whose wrapper opens the span only while
    tracing is on. One per name."""
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return wrapper


_NOOPS = {}


class _Span(_Noop):
    """An open span while tracing is on."""
    __slots__ = ("idx", "rf")

    def __enter__(self):
        global _calls
        parent = _stack[-1] if _stack else -1
        if len(_records) >= SPAN_CAP or parent == -2:
            count("span.dropped")
            self.idx = -2
        else:
            if parent < 0:
                _calls += 1
                call = _calls
            else:
                call = _records[parent][4]
            self.idx = len(_records)
            _records.append([self.name, _time.perf_counter_ns(), None,
                             parent, call])
        _stack.append(self.idx)
        self.rf = None
        if _profiler:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return None

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.idx >= 0:
            _records[self.idx][2] = _time.perf_counter_ns()
        _stack.pop()
        return False


def span(name: str):
    """The span ``name`` as a context manager or decorator (module
    docstring). While tracing is off this is the name's shared no-op."""
    if _on:
        return _Span(name)
    noop = _NOOPS.get(name)
    if noop is None:
        noop = _NOOPS[name] = _Noop(name)
    return noop


def enabled() -> bool:
    """Whether tracing is on (mode "host" or "profiler")."""
    return _on


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` (counted in every mode)."""
    _counters[name] = _counters.get(name, 0) + n


def device_counters(names: tuple, device) -> torch.Tensor:
    """The int64 array on ``device``, one entry per name of ``names``,
    that kernels add counts to; made zeroed on first use and kept by the
    tracer, which folds it into the counters when they are read."""
    key = (tuple(names), torch.device(device))
    arr = _device_counts.get(key)
    if arr is None:
        arr = _device_counts[key] = torch.zeros(len(names), dtype=torch.int64,
                                                device=device)
    return arr


def counters() -> dict:
    """A copy of every counter, after the device counters' counts are
    added to them (this waits for the card's queued work) and zeroed."""
    for (names, _), arr in _device_counts.items():
        vals = arr.tolist()
        if any(vals):
            arr.zero_()
            for name, v in zip(names, vals):
                count(name, v)
    return dict(_counters)


def spans() -> list:
    """The kept spans, in the order they opened, as ``Span`` tuples."""
    return [Span(*r) for r in _records]


def summary() -> dict:
    """Per span name over the closed kept spans: {"count", "total_s",
    "self_s"}; self time is a span's duration less its children's."""
    child_ns = [0] * len(_records)
    for name, t0, t1, parent, _ in _records:
        if t1 is not None and parent >= 0:
            child_ns[parent] += t1 - t0
    out = {}
    for (name, t0, t1, _, _), kids in zip(_records, child_ns):
        if t1 is None:
            continue
        row = out.setdefault(name, dict(count=0, total_s=0.0, self_s=0.0))
        row["count"] += 1
        row["total_s"] += (t1 - t0) * 1e-9
        row["self_s"] += (t1 - t0 - kids) * 1e-9
    return out


def reset():
    """Clear the kept spans and the counters; raises inside an open
    span."""
    global _calls
    if _stack:
        raise RuntimeError("profiling.reset() inside an open span")
    _records.clear()
    _counters.clear()
    for arr in _device_counts.values():
        arr.zero_()
    _calls = 0


@contextlib.contextmanager
def tracing(mode: str):
    """Run the block in tracer mode ``mode`` ("off", "host" or
    "profiler"); the previous mode comes back on exit."""
    global _on, _profiler
    if mode not in MODES:
        raise ValueError(f"tracing mode must be one of {MODES}, got {mode!r}")
    saved = _on, _profiler
    _on, _profiler = mode != "off", mode == "profiler"
    try:
        yield
    finally:
        _on, _profiler = saved


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the block, in "profiler" tracing mode (the
    program's spans are ranges of the trace), exported on exit to
    ``<logdir>/trace.json``. Yields the profiler, whose
    ``key_averages()`` the caller may read after the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof, tracing("profiler"):
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(label: str = "section", printer=print):
    """Prints ``[label] <seconds>s`` for the block (host clock, the card
    synchronized at both ends)."""
    _sync()
    t0 = _time.perf_counter()
    yield
    _sync()
    printer(f"[{label}] {_time.perf_counter() - t0:.3f}s")
