"""The span reduction (``spans.by_span``, ``spans.coverage``,
``spans.metrics``) on a hand-made trace: device events go to the innermost
program span they were launched in, idle time to the innermost span open
over it, piece by piece."""

import pytest

from port_bench import spans
from port_bench.capture import CALL_SPAN


def _x(name, ts, dur, cat="user_annotation", corr=None):
    e = dict(ph="X", name=name, ts=ts, dur=dur, cat=cat)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    """One call [0, 100] us: tri.call [5, 95] holds a row [10, 60] (a
    sampler [12, 20], a core [25, 55] with a launch [30, 32]), then a
    gather [70, 90]. Four device events: one from the sampler, the
    kernel, one from tri.call's own code and the gather's copy; one more
    launched after the call."""
    return [
        _x(CALL_SPAN, 0, 100), _x("tri.call", 5, 90),
        _x("tri.row.TP", 10, 50), _x("tri.sample.planet_target", 12, 8),
        _x("tri.core.lnL_planet", 25, 30), _x("tri.launch.k", 30, 2),
        _x("tri.gather", 70, 20),
        _x("cudaLaunchKernel", 15, 1, "cuda_runtime", 1),
        _x("cudaLaunchKernel", 31, 1, "cuda_runtime", 2),
        _x("cudaLaunchKernel", 65, 1, "cuda_runtime", 3),
        _x("cudaMemcpyAsync", 80, 1, "cuda_runtime", 4),
        _x("cudaLaunchKernel", 150, 1, "cuda_runtime", 5),
        _x("mul", 16, 2, "kernel", 1), _x("chi2", 33, 17, "kernel", 2),
        _x("fill", 66, 1, "kernel", 3), _x("copy", 85, 3, "gpu_memcpy", 4),
        _x("late", 151, 5, "kernel", 5)]


def test_by_span():
    rows = spans.by_span(_trace())
    got = {k: (v["events"], round(v["device_s"] * 1e6, 6),
               round(v["idle_s"] * 1e6, 6)) for k, v in rows.items()}
    assert got == {
        spans.NONE: (0, 0.0, 10.0),
        "tri.call": (1, 1.0, 19.0),
        "tri.row.TP": (0, 0.0, 12.0),
        "tri.sample.planet_target": (1, 2.0, 6.0),
        "tri.core.lnL_planet": (0, 0.0, 11.0),
        "tri.launch.k": (1, 17.0, 2.0),
        "tri.gather": (1, 3.0, 17.0)}


def test_coverage_and_metrics():
    (c,) = spans.coverage(_trace())
    assert c["events_in_work_pct"] == pytest.approx(75.0)
    assert c["idle_in_span_pct"] == pytest.approx(100.0 * 48 / 77)
    rows = spans.by_span(_trace())
    host = {"tri.sample.ptp": dict(count=2, total_s=0.004, self_s=0.004),
            "tri.gather": dict(count=1, total_s=0.001, self_s=0.001)}
    m = spans.metrics(rows, host, {"io.molusc_read": 4, "draws.core": 9},
                      host_cands=2, prof_cands=1, bound_s=1.7e-6)
    assert m == pytest.approx(dict(
        sampler_ms_per_cand=2.0, sampler_kernels_per_cand=1.0,
        veto_device_ms_per_cand=0.0, chi2_kernel_roofline=10.0,
        gather_wait_ms_per_cand=0.5, file_reads_per_cand=2.0))


def test_tree_nests_and_clamps():
    """A child that ends a rounding step after its parent is clamped to
    it, and the innermost span steps back to the parent after a child."""
    parent, times, inner = spans._tree(
        [(0, 10, "a"), (2, 11, "b"), (12, 13, "c")])
    assert parent == [-1, 0, -1]
    assert list(zip(times, inner)) == [(0, 0), (2, 1), (10, -1), (12, 2),
                                       (13, -1)]
