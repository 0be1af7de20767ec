"""Profiling and throughput instrumentation, on torch.profiler and CUDA
events (counterpart of the JAX package's ``utils/profiling.py``):

* ``trace(logdir)``: a ``torch.profiler`` trace (host, and the card when
  there is one) around a block, exported as a Chrome trace viewable in
  Perfetto or chrome://tracing.
* ``timed(label)``: a wall-clock section timer that waits for the card
  at both ends, so the section's queued device work is inside it.
* ``throughput(fn, *args, draws, repeats, warmup)``: best time of a call
  and scenario-draws per second, timed with CUDA events when the call's
  output is on the card and with the host clock otherwise.
"""

from __future__ import annotations

import contextlib
import os
import time as _time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the block, exported on exit to
    ``<logdir>/trace.json``. Yields the profiler, whose
    ``key_averages()`` the caller may read after the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
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


def _device_of(out):
    """The device of the first tensor in a (nested) call output, or None."""
    if isinstance(out, torch.Tensor):
        return out.device
    items = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (list, tuple)) else ())
    for item in items:
        dev = _device_of(item)
        if dev is not None:
            return dev
    return None


def throughput(fn, *args, draws: int, repeats: int = 3, warmup: int = 1,
               **kwargs):
    """(best seconds, draws/second) of ``fn(*args, **kwargs)``.

    ``draws`` is the number of scenario-draws one call evaluates (one draw
    = one supersampled model light curve + chi^2). A call whose output
    lies on the card is timed between two CUDA events on the current
    stream, after a synchronize; any other call by the host clock, the
    card synchronized at both ends if it is in use."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    dev = _device_of(out) if warmup else None
    _sync()
    best = float("inf")
    for _ in range(repeats):
        if dev is not None and dev.type == "cuda":
            with torch.cuda.device(dev):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn(*args, **kwargs)
                b.record()
                b.synchronize()
                dt = a.elapsed_time(b) / 1e3
        else:
            t0 = _time.perf_counter()
            fn(*args, **kwargs)
            _sync()
            dt = _time.perf_counter() - t0
        best = min(best, dt)
    return best, draws / best
