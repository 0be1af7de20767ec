"""The trace reduction on synthetic events: device time is the union of
intervals, and device events belong to the host range they were launched
in."""

from port_bench import trace
from port_bench.capture import CALL_SPAN, CORE_SPAN


def test_union():
    assert trace.union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]
    assert trace.covered([(0, 2), (1, 3), (5, 6)], 0, 10) == 4
    assert trace.covered([(0, 2), (1, 3), (5, 6)], 2.5, 5.5) == 1.0


def _x(name, ts, dur, cat="cpu_op", corr=None):
    e = dict(ph="X", name=name, ts=ts, dur=dur, cat=cat)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_summary():
    ev = [_x(CALL_SPAN, 0, 100, "user_annotation"),
          _x(CORE_SPAN + "lnL_planet", 10, 40, "user_annotation"),
          _x("cudaLaunchKernel", 12, 1, "cuda_runtime", 1),
          _x("cudaLaunchKernel", 60, 1, "cuda_runtime", 2),
          _x("cudaLaunchKernel", 62, 1, "cuda_runtime", 3),
          _x("chi2", 20, 30, "kernel", 1),     # launched in the core
          _x("add", 65, 10, "kernel", 2),      # outside the core
          _x("add", 70, 10, "kernel", 3),      # overlaps the last
          _x("late", 300, 10, "kernel", 99),   # outside every call
          _x(CALL_SPAN, 0, 100, "gpu_user_annotation")]
    s = trace.summarize(ev)
    assert len(s.walls) == 1 and abs(s.walls[0] - 100e-6) < 1e-12
    assert abs(s.busy_s - 45e-6) < 1e-12       # 30 + union(65..80)
    assert s.device_events == 3
    assert abs(s.core_device_s - 30e-6) < 1e-12
    assert s.device_ops[0][0] == "chi2"
    gaps = sorted((round(g[1] * 1e6), g[0]) for g in s.idle_gaps)
    assert gaps == [(15, "outside_core"), (20, "core.lnL_planet"),
                    (20, "outside_core")]
