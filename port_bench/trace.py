"""Reduction of a ``torch.profiler`` trace of the profiled calls.

The profiler's Chrome trace is read once: the benchmark's host ranges
(``user_annotation`` events: ``capture.CALL_SPAN`` around each call,
``capture.CORE_SPAN`` + core name around each likelihood core), and the
device events (kernels,
copies, sets), each tied to the host range it was launched in through the
runtime call that launched it (the ``correlation`` id). Device time is
the union of the events' intervals, so overlapping events count once.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from .capture import CALL_SPAN, CORE_SPAN

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(intervals, lo, hi):
    """Length of the union of ``intervals`` inside [lo, hi]."""
    return sum(max(0.0, min(b, hi) - max(a, lo))
               for a, b in union(intervals))


@dataclass
class Summary:
    """Seconds and counts over the profiled calls."""
    walls: list = field(default_factory=list)
    busy_s: float = 0.0
    device_events: int = 0
    core_device_s: float = 0.0
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def _inside(ts, ranges):
    for r in ranges:
        if r[0] <= ts <= r[1]:
            return r
    return None


def summarize(events, top=10):
    """Summary of the calls in a Chrome trace's event list."""
    us = 1e-6
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]
    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in host
                   if e["name"] == CALL_SPAN)
    cores = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(CORE_SPAN):])
                   for e in host if e["name"].startswith(CORE_SPAN))
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in LAUNCH_CATS
                 and "correlation" in e.get("args", {})}
    s = Summary(walls=[(b - a) * us for a, b in calls])
    per_call = [[] for _ in calls]
    core_ivs, by_name = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        ts = launch_ts.get(e.get("args", {}).get("correlation"), e["ts"])
        c = _inside(ts, calls)
        if c is None:
            continue
        iv = (e["ts"], e["ts"] + e["dur"])
        per_call[calls.index(c)].append(iv)
        s.device_events += 1
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * us
        if _inside(ts, cores) is not None:
            core_ivs.append(iv)
    gaps = []
    for (lo, hi), ivs in zip(calls, per_call):
        s.busy_s += covered(ivs, lo, hi) * us
        edge = lo
        for a, b in union(ivs) + [[hi, hi]]:
            if a > edge:
                mid = (a + edge) / 2
                r = _inside(mid, cores)
                gaps.append([("core." + r[2]) if r else "outside_core",
                             (a - edge) * us])
            edge = max(edge, b)
    s.core_device_s = sum(b - a for a, b in union(core_ivs)) * us
    s.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    s.idle_gaps = sorted(gaps, key=lambda g: -g[1])[:top]
    return s


def load(path):
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data
