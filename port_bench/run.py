"""Run one benchmark cell once and print its result as the last line.

    python3 port_bench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

The cell's configuration, traffic mix, limits and metric readers are found
by name from ``BENCHMARK.json`` (``configs/``, ``traffic/``, ``limits/``,
``metrics/``; the entry point the configuration drives in ``entries/``).
Set-up makes the inputs from the seed, builds the program's targets and
makes one warm-up call at the cell's own shapes. The window then calls
the entry back to back (one caller that waits for each result) until
``--seconds`` have passed; the call that crosses the deadline finishes
and counts. With ``--trace 1`` the first calls of the window run under
``torch.profiler`` with the benchmark's host ranges, the rest of the
window runs unprofiled with host-clock spans around the cores, and the
result carries the per-layer metrics instead of the end-to-end ones. After the
window, ``check.py`` decides ``correct``.

Exits non-zero without printing a result when no card (or fewer than the
cell needs) is there, and when ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``triceratops_tpu`` is loaded once the window has closed.
"""

T_START = __import__("time").perf_counter()

import os  # noqa: E402

# one process with few threads: the host's math libraries single-threaded
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "port_bench"
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "triceratops_tpu")
# profiled calls of a traced run: at least PROFILE_CALLS and
# PROFILE_MIN_S seconds of them, at most PROFILE_MAX_CALLS
PROFILE_CALLS = 3
PROFILE_MIN_S = 2.0
PROFILE_MAX_CALLS = 8


class NoChip(SystemExit):
    pass


def forbidden_modules():
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def spec(cell):
    """The cell's entry of BENCHMARK.json, its configuration and mix
    names, and its end-to-end and per-layer metric entries."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise SystemExit(f"unknown workload {cell!r}")
    w = work[cell]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def mine(ms):
        return [m for m in ms if cell in m.get("workloads", [cell])]
    return (w, cfg, mine(bench["end_to_end"]), mine(bench["per_layer"]))


def read_metric(name, rec):
    mod = importlib.import_module(f"port_bench.metrics.{name}")
    return mod.read(rec)


@dataclass
class Record:
    """What the metric readers read."""
    setup_s: float = 0.0
    starts: list = field(default_factory=list)
    ends: list = field(default_factory=list)
    cands: list = field(default_factory=list)
    summary: object = None
    core_host_s: float = 0.0
    profiled_cands: int = 0
    profiled_walls: list = field(default_factory=list)
    bound_s: float = 0.0
    peak_window_bytes: int = 0


def cuda_ready(chips):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoChip(f"port_bench: needs {chips} CUDA device(s), found {n}")


class Cell:
    """A cell set up for one seed: configuration, traffic, entry."""

    def __init__(self, cell, seed, device="cuda", overrides=None,
                 workdir=None):
        from port_bench import traffic

        self.name, self.seed, self.device = cell, int(seed), device
        self.work, cfg_entry, self.e2e, self.per_layer = spec(cell)
        self.cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
        self.cfg.update(overrides or {})
        self.mix = traffic.load_mix(self.work["traffic"])
        self.traffic = traffic.make(self.work["traffic"], seed,
                                    self.cfg.get("per_call", 1),
                                    self.cfg["N"], workdir)
        tri = self.mix["trilegal"]
        self.trilegal = traffic.synthetic_trilegal(
            Path(workdir) / "trilegal.csv", tri["Tmag_target"],
            tri["n_stars"], traffic.sub_seed(seed, 4))
        mod = importlib.import_module(
            f"port_bench.entries.{self.cfg['entry']}")
        self.entry = mod.Entry(self.cfg, self.traffic, self.trilegal, device)

    def key(self, i):
        from port_bench.traffic import sub_seed
        return sub_seed(self.seed, 7, i + 1)

    def call(self, i):
        return self.entry.call(i, self.key(i))


def run_window(cell, seconds, trace, rec):
    """Closed-loop calls until ``seconds`` have passed; returns each
    call's outputs. With ``trace``, returns the stopped profiler too."""
    import torch

    from port_bench import capture

    outs, prof = [], None
    points = cell.entry.wrap_points()
    t_first = time.perf_counter()
    deadline = t_first + seconds
    i = 0
    if trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        with capture.patched(points, capture.spans):
            while True:
                t0 = time.perf_counter()
                with torch.profiler.record_function(capture.CALL_SPAN):
                    outs.append(cell.call(i))
                t1 = time.perf_counter()
                rec.profiled_walls.append(t1 - t0)
                rec.profiled_cands += len(outs[-1]["FPP"])
                i += 1
                if (i >= PROFILE_MAX_CALLS or t1 >= deadline
                        or (i >= PROFILE_CALLS
                            and sum(rec.profiled_walls) >= PROFILE_MIN_S)):
                    break
        prof.stop()
    host = capture.HostSpans()
    with capture.patched(points if trace else [], host):
        while True:
            t0 = time.perf_counter()
            outs.append(cell.call(i))
            t1 = time.perf_counter()
            rec.starts.append(t0)
            rec.ends.append(t1)
            rec.cands.append(len(outs[-1]["FPP"]))
            i += 1
            if t1 >= deadline:
                break
    rec.core_host_s = host.seconds
    return outs, prof


def sampled_calls(n_calls, seed, n_check):
    """The calls ``check.py`` reruns: seeded draws and the last."""
    from port_bench.traffic import sub_seed

    rng = np.random.default_rng(sub_seed(seed, 5))
    picks = {n_calls - 1}
    while len(picks) < min(n_check, n_calls):
        picks.add(int(rng.integers(n_calls)))
    return sorted(picks)


def verify(cell, outs, calls, control=False):
    """The numbers ``check.py`` compares over the window's calls."""
    import torch

    from port_bench import capture, check
    from port_bench.traffic import sub_seed

    nums = [dict(prob_gap=max(check.prob_gap(o, control) for o in outs))]
    for i in calls:
        cap = capture.Capture(check.TOP_DRAWS, check.RANDOM_DRAWS,
                              sub_seed(cell.seed, 6, i), control=control,
                              sampler_draws=check.SAMPLER_DRAWS)
        with capture.patched(cell.entry.wrap_points(), cap):
            again = cell.call(i)
        lay = check.Layout(cell.traffic.candidates(i), cell.cfg["mission"],
                           cell.cfg["N"])
        n = dict(replay_mismatch=0 if control
                 else check.replay_mismatch(outs[i], again))
        n.update(check.work_numbers(cap, lay, outs[i],
                                    cell.entry.candidates_per_call))
        n.update(check.sampler_numbers(cap, lay, cell.trilegal, control))
        n.update(check.core_numbers(cap, lay, cell.cfg, control))
        n.update(check.evidence_numbers(cap, lay, outs[i]["lnZ"], control))
        nums.append(n)
        del cap
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return check.merge(nums)


def core_bound(cell, calls):
    """Seconds of the roofline bound of the chi^2 work of ``calls``,
    rerun under ``capture.Count`` (the same keys: the same work)."""
    from port_bench import capture, roofline

    total = 0.0
    for i in calls:
        cnt = capture.Count(roofline.core_work)
        with capture.patched(cell.entry.wrap_points(), cnt):
            cell.call(i)
        total += sum(roofline.bound_s(b, f) for b, f in cnt.calls)
    return total


def power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def trace_summary(prof, workdir):
    from port_bench import trace

    path = Path(workdir) / "trace.json"
    prof.export_chrome_trace(str(path))
    events = trace.load(path)
    path.unlink()
    return trace.summarize(events)


def main(argv=None, device="cuda", overrides=None, out=sys.stdout):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    import torch

    from port_bench import check

    w, _, _, _ = spec(args.workload)
    if device == "cuda":
        cuda_ready(w["chips"])
    rec = Record()
    with tempfile.TemporaryDirectory() as workdir:
        cell = Cell(args.workload, args.seed, device, overrides, workdir)
        if args.trace:
            # the profiler's first session pays its own start-up: spend it
            # on the warm-up call, in set-up
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]):
                cell.entry.call(-1, cell.key(-1))
        cell.entry.call(-1, cell.key(-1))
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        rec.setup_s = time.perf_counter() - T_START
        outs, prof = run_window(cell, args.seconds, args.trace, rec)
        dev = dict(platform="gpu" if device == "cuda" else device,
                   kind=(torch.cuda.get_device_name(0) if device == "cuda"
                         else "cpu"), count=w["chips"])
        if device == "cuda":
            rec.peak_window_bytes = torch.cuda.max_memory_allocated()
            dev["memory_peak_bytes"] = rec.peak_window_bytes
        else:
            dev["memory_peak_bytes"] = 0
        n_prof = len(rec.profiled_walls)
        if prof is not None:
            rec.summary = trace_summary(prof, workdir)
            prof = None
            dev["busy_s"] = rec.summary.busy_s
            dev["window_s"] = sum(rec.summary.walls)
            rec.bound_s = core_bound(cell, range(n_prof))
        walls = [b - a for a, b in zip(rec.starts, rec.ends)]
        print(f"port_bench: {args.workload} seed {args.seed}: {len(outs)} "
              f"calls, walls (s) {[round(x, 4) for x in walls]}",
              file=sys.stderr)
        if rec.summary is not None:
            print(f"port_bench: profiled calls {n_prof}, walls "
                  f"{rec.summary.walls}; median unprofiled wall "
                  f"{float(np.median(walls))} s; card and power limit: "
                  f"{power_limit()}", file=sys.stderr)
        numbers = verify(cell, outs, sampled_calls(len(outs), args.seed,
                                                   check.CALLS))
        attempted = sum(len(o["FPP"]) for o in outs)
        failed = sum(int(np.sum(~np.isfinite(o["FPP"]))) for o in outs)
        metrics = {}
        for m in (cell.per_layer if args.trace else cell.e2e):
            v = read_metric(m["name"], rec)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    correct, rows = check.judge(numbers, check.load_limits(args.workload))
    result = dict(correct=correct, attempted=attempted, failed=failed,
                  metrics=metrics, device=dev)
    if rec.summary is not None:
        result["breakdown"] = dict(device_ops=rec.summary.device_ops,
                                   idle_gaps=rec.summary.idle_gaps)
    result["checks"] = {k: dict(value=v, limit=lim) for k, v, lim in rows}
    for k, v, lim in rows:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except NoChip as e:
        print(e.code, file=sys.stderr)
        sys.exit(2)
