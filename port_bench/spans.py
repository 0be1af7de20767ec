"""The program's own spans over one cell's calls: which span each device
event was launched in and each idle stretch of the card fell in, six
per-layer numbers read from them, and what host-mode tracing costs.

    python3 port_bench/spans.py --workload <cell> --seed <n> --seconds <s>

Set-up is ``run.py``'s (the cell's inputs from the seed, one warm-up call
under the profiler to spend its start-up, one more plain). Then, the
program's tracer (``triceratops_tpu_torch.utils.profiling``) reset before
each phase:

1. profiled calls (as many as ``run.py``'s traced runs make: >= 3 and
   >= 2 s, <= 8), each in the benchmark's call range, under
   ``torch.profiler`` with the tracer in "profiler" mode, so each program
   span is a range of the trace (``by_span``, ``coverage``);
2. ``--seconds`` of calls alternating between the tracer in "host" mode
   and off, in pairs whose order alternates: the host spans and counter
   deltas of the host calls, and each side's median wall (the cost of
   host mode);
3. the profiled calls' keys again under ``capture.Count``, for the chi^2
   work's roofline bound (``run.core_bound``).

Prints the idle and device time by innermost span on stderr and one JSON
line on stdout: the numbers of ``metrics``, ``device_kernels_per_cand`` as
``run.py``'s traced runs read it, the coverage shares, the tables, the
counters per call and the host-mode cost. Exits 2 without a card (as
``run.py``) or when the program has no tracer.

``BENCHMARK.json``'s command stays ``run.py``, which does not switch the
program's tracer on, so its runs, traced or not, are untouched by this
script.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import run as bench  # noqa: E402
from port_bench.capture import CALL_SPAN  # noqa: E402
from port_bench.trace import (  # noqa: E402
    DEVICE_CATS, LAUNCH_CATS, covered, load, summarize, union)

PREFIX = "tri."
NONE = "(none)"
# spans a device event has to be launched under, at any depth
WORK_SPANS = ("tri.row.", "tri.reduce", "tri.gather")


def _tree(ranges):
    """For (start, end, name) ranges sorted by (start, -end), nested as one
    thread's spans are: each range's parent (-1 for none), and the
    innermost open range as a step function of time (change times, range
    index from each on; -1 for none). A child's end is clamped to its
    parent's (the trace rounds to microseconds)."""
    ends = [b for _, b, _ in ranges]
    parent = [-1] * len(ranges)
    times, inner, stack = [], [], []

    def mark(t):
        i = stack[-1] if stack else -1
        if times and times[-1] == t:
            inner[-1] = i
        else:
            times.append(t)
            inner.append(i)
    for i, (a, b, _) in enumerate(ranges):
        while stack and ends[stack[-1]] <= a:
            mark(ends[stack.pop()])
        if stack:
            parent[i] = stack[-1]
            ends[i] = min(b, ends[stack[-1]])
        stack.append(i)
        mark(a)
    while stack:
        mark(ends[stack.pop()])
    return parent, times, inner


def _attribute(events, prefix=PREFIX):
    """The program's ranges (name prefix ``prefix``), their parents, and
    per call range (``CALL_SPAN``): each device event launched in it as
    (innermost range index, (start, end)), and each idle stretch of the
    card in it split by the innermost range open over it as (index,
    seconds). Device events are tied to the range open at the runtime call
    that launched them (``correlation``), as ``trace.summarize`` ties
    them."""
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]
    ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
                     if e["name"].startswith(prefix)),
                    key=lambda r: (r[0], -r[1]))
    parent, times, inner = _tree(ranges)

    def at(t):
        k = bisect.bisect_right(times, t) - 1
        return inner[k] if k >= 0 else -1
    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in host
                   if e["name"] == CALL_SPAN)
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in LAUNCH_CATS
                 and "correlation" in e.get("args", {})}
    per_call = [dict(events=[], idle=[]) for _ in calls]
    starts = [a for a, _ in calls]
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        ts = launch_ts.get(e.get("args", {}).get("correlation"), e["ts"])
        c = bisect.bisect_right(starts, ts) - 1
        if c < 0 or ts > calls[c][1]:
            continue
        per_call[c]["events"].append((at(ts), (e["ts"], e["ts"] + e["dur"])))
    for (lo, hi), pc in zip(calls, per_call):
        edge = lo
        for a, b in union([iv for _, iv in pc["events"]]) + [[hi, hi]]:
            a = min(a, hi)
            if a > edge:
                _split(edge, a, times, inner, pc["idle"])
            edge = max(edge, b)
    return ranges, parent, per_call


def _split(g0, g1, times, inner, out):
    """Append (innermost range index, seconds) for each piece of the idle
    stretch [g0, g1] (microseconds) between the step function's change
    times."""
    k = bisect.bisect_right(times, g0) - 1
    t = g0
    while t < g1:
        nxt = times[k + 1] if k + 1 < len(times) else g1
        end = min(g1, nxt)
        out.append((inner[k] if k >= 0 else -1, (end - t) * 1e-6))
        t = end
        k += 1


def by_span(events, prefix=PREFIX):
    """Per innermost program span (ranges named ``prefix``...; ``NONE``
    where none is open), over the calls of a Chrome trace's event list:
    the device events launched in it, their device seconds (the union of
    their intervals) and the seconds the card sat idle while it was the
    innermost open span."""
    ranges, _, per_call = _attribute(events, prefix)

    def name(i):
        return ranges[i][2] if i >= 0 else NONE
    out, ivs = {}, {}
    for pc in per_call:
        for i, iv in pc["events"]:
            row = out.setdefault(name(i), dict(events=0, device_s=0.0,
                                               idle_s=0.0))
            row["events"] += 1
            ivs.setdefault(name(i), []).append(iv)
        for i, s in pc["idle"]:
            out.setdefault(name(i), dict(events=0, device_s=0.0,
                                         idle_s=0.0))["idle_s"] += s
    for n, iv in ivs.items():
        out[n]["device_s"] = covered(iv, -np.inf, np.inf) * 1e-6
    return out


def coverage(events, prefix=PREFIX, work=WORK_SPANS):
    """Per call: the share (%) of its device events launched under a span
    named by ``work`` (at any depth), and the share of its idle time whose
    innermost open span is a program span other than ``tri.call`` (so
    neither ``tri.call``'s own self time nor outside every program
    span)."""
    ranges, parent, per_call = _attribute(events, prefix)

    def under(i):
        while i >= 0:
            if ranges[i][2].startswith(work):
                return True
            i = parent[i]
        return False
    out = []
    for pc in per_call:
        ev = pc["events"]
        idle = sum(s for _, s in pc["idle"])
        below = sum(s for i, s in pc["idle"]
                    if i >= 0 and ranges[i][2] != "tri.call")
        out.append(dict(
            events_in_work_pct=100.0 * sum(under(i) for i, _ in ev)
            / max(len(ev), 1),
            idle_in_span_pct=100.0 * below / idle if idle else 100.0))
    return out


def _total(summary, prefix):
    return sum(v["total_s"] for k, v in summary.items()
               if k.startswith(prefix))


def _device_s(rows, prefix):
    """Device seconds of the events whose innermost span starts with
    ``prefix``: the sum of each name's union (the names' events do not
    overlap one another: one stream)."""
    return sum(v["device_s"] for k, v in rows.items() if k.startswith(prefix))


def metrics(rows, host_summary, host_counts, host_cands, prof_cands,
            bound_s):
    """The six span metrics, each None where there is nothing to read:
    host ms in ``tri.sample.*`` and in ``tri.gather`` and the ``io.*_read``
    counters, per candidate of the host-mode calls; device events launched
    in ``tri.sample.*`` and device ms of ``tri.core.veto``, per candidate
    of the profiled calls (their ``by_span`` rows); ``bound_s`` over the
    device time of the events launched in ``tri.launch.*`` (%)."""
    def per(x, n, scale=1.0):
        return scale * x / n if n and x is not None else None
    launch_s = _device_s(rows, "tri.launch.")
    return dict(
        sampler_ms_per_cand=per(_total(host_summary, "tri.sample."),
                                host_cands, 1e3),
        sampler_kernels_per_cand=per(sum(
            v["events"] for k, v in rows.items()
            if k.startswith("tri.sample.")), prof_cands),
        veto_device_ms_per_cand=per(_device_s(rows, "tri.core.veto"),
                                    prof_cands, 1e3),
        chi2_kernel_roofline=(100.0 * bound_s / launch_s
                              if launch_s > 0 and bound_s > 0 else None),
        gather_wait_ms_per_cand=per(_total(host_summary, "tri.gather"),
                                    host_cands, 1e3),
        file_reads_per_cand=per(sum(v for k, v in host_counts.items()
                                    if k.startswith("io.")
                                    and k.endswith("_read")), host_cands))


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _profiled(cell, profiling, torch, workdir):
    """Phase 1: the profiled calls in "profiler" mode; their walls,
    candidates, counters and the trace's events."""
    profiling.reset()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    walls, cands = [], 0
    prof.start()
    with profiling.tracing("profiler"):
        while True:
            t0 = time.perf_counter()
            with torch.profiler.record_function(CALL_SPAN):
                out = cell.call(len(walls))
            walls.append(time.perf_counter() - t0)
            cands += len(out["FPP"])
            if (len(walls) >= bench.PROFILE_MAX_CALLS
                    or (len(walls) >= bench.PROFILE_CALLS
                        and sum(walls) >= bench.PROFILE_MIN_S)):
                break
    prof.stop()
    path = Path(workdir) / "spans_trace.json"
    prof.export_chrome_trace(str(path))
    events = load(path)
    path.unlink()
    return walls, cands, profiling.counters(), events


def _host_and_off(cell, profiling, seconds, first):
    """Phase 2: calls ``first``, ``first + 1``, ... for ``seconds``, in
    pairs (host, off) then (off, host) and so on; returns each side's
    walls, the host calls' candidates and counter deltas, and the spans'
    summary."""
    profiling.reset()
    walls = dict(host=[], off=[])
    counts, cands, i = {}, 0, first
    deadline = time.perf_counter() + seconds
    pair = 0
    while time.perf_counter() < deadline or len(walls["host"]) < 3:
        for mode in (("host", "off") if pair % 2 == 0 else ("off", "host")):
            before = profiling.counters()
            t0 = time.perf_counter()
            with profiling.tracing(mode):
                out = cell.call(i)
            walls[mode].append(time.perf_counter() - t0)
            i += 1
            if mode == "host":
                cands += len(out["FPP"])
                for k, v in _delta(profiling.counters(), before).items():
                    counts[k] = counts.get(k, 0) + v
        pair += 1
    return walls, cands, counts, profiling.summary()


def main(argv=None, device="cuda", overrides=None, out=sys.stdout):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(bench.CACHE / sub)
    import torch

    from triceratops_tpu_torch.utils import profiling

    if not hasattr(profiling, "tracing"):
        print("port_bench.spans: the program has no tracer", file=sys.stderr)
        return 2
    w, _, _, _ = bench.spec(args.workload)
    if device == "cuda":
        bench.cuda_ready(w["chips"])
    with tempfile.TemporaryDirectory() as workdir:
        cell = bench.Cell(args.workload, args.seed, device, overrides,
                          workdir)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            cell.entry.call(-1, cell.key(-1))
        cell.entry.call(-1, cell.key(-1))
        if device == "cuda":
            torch.cuda.synchronize()
        p_walls, p_cands, p_counts, events = _profiled(cell, profiling,
                                                       torch, workdir)
        s = summarize(events)
        rows = by_span(events)
        cover = coverage(events)
        del events
        walls, h_cands, h_counts, h_summary = _host_and_off(
            cell, profiling, args.seconds, len(p_walls))
        profiling.reset()
        bound_s = bench.core_bound(cell, range(len(p_walls)))
        rebuilt = profiling.counters().get("build.chi2", 0)
    n_prof, n_host = len(p_walls), len(walls["host"])
    res = dict(
        workload=args.workload, seed=args.seed,
        card=(bench.power_limit() if device == "cuda" else device),
        metrics=metrics(rows, h_summary, h_counts, h_cands, p_cands,
                        bound_s),
        device_kernels_per_cand=(s.device_events / p_cands
                                 if s.device_events else None),
        coverage=cover,
        profiled=dict(calls=n_prof, walls=p_walls,
                      busy_s=s.busy_s, counters_per_call={
                          k: v / n_prof for k, v in p_counts.items()}),
        by_span={k: dict(events_per_call=v["events"] / n_prof,
                         device_ms_per_call=1e3 * v["device_s"] / n_prof,
                         idle_ms_per_call=1e3 * v["idle_s"] / n_prof)
                 for k, v in rows.items()},
        host=dict(calls=n_host, counters_per_call={
            k: v / n_host for k, v in h_counts.items()},
            spans_ms_per_call={k: dict(
                count=v["count"] / n_host,
                total=1e3 * v["total_s"] / n_host,
                self=1e3 * v["self_s"] / n_host)
                for k, v in h_summary.items()}),
        host_mode_cost=dict(
            median_wall_host_s=float(np.median(walls["host"])),
            median_wall_off_s=float(np.median(walls["off"])),
            walls_host=walls["host"], walls_off=walls["off"]),
        build_chi2=dict(profiled=p_counts.get("build.chi2", 0),
                        host_and_off=h_counts.get("build.chi2", 0),
                        bound=rebuilt))
    print(f"port_bench.spans: {args.workload} seed {args.seed}: idle and "
          f"device ms per profiled call by innermost span", file=sys.stderr)
    for k, v in sorted(res["by_span"].items(),
                       key=lambda kv: -kv[1]["idle_ms_per_call"]):
        print(f"  {k:40s} idle {v['idle_ms_per_call']:9.3f}  device "
              f"{v['device_ms_per_call']:9.3f}  events "
              f"{v['events_per_call']:9.1f}", file=sys.stderr)
    print(json.dumps(res), file=out, flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except bench.NoChip as e:
        print(e.code, file=sys.stderr)
        sys.exit(2)
