"""The port's tracer (``utils/profiling.py``): spans and counters from
``calc_probs`` and ``batch_fpp_full`` down to the likelihood cores, on the
CPU at small N.

* off (the default): ``span`` is a shared no-op and a call keeps nothing;
* host mode: one ``tri.call`` per call, a ``tri.row.*`` span per evidence
  row computed, every sampler and core span under a row and in the call's
  id, self times that add up to the roots' durations; the draws handed to
  the cores and the MOLUSC parses counted; without a MOLUSC file, each
  bound-companion prior block in ``tri.prior.companion`` under its P* or
  S* sampler and its draws counted under ``prior.companion``;
* profiler mode (``profiling.trace``): the same spans as
  ``user_annotation`` ranges of the Chrome trace, nested as in host mode;
* the tracer's own rules: nesting and call ids, the span cap, misuse.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from triceratops_tpu_torch.frontend.target import target
from triceratops_tpu_torch.parallel import sharding
from triceratops_tpu_torch.populations.synthetic import (
    make_synthetic_trilegal)
from triceratops_tpu_torch.utils import profiling

N = 1024
N_T = 20
# rows left to compute: TP, PTP (reads the MOLUSC file) and each nearby
# star's NTP, NEB and NEBx2P
DROP = ["EB", "PEB", "STP", "SEB", "DTP", "DEB", "BTP", "BEB"]
CALC_ROWS = ["TP", "PTP", "NTP", "NEB"]
# the batch path drops rows by name, a twin row apart from its pair
BATCH_DROP = DROP + [f"{name}x2P" for name in DROP if "EB" in name]
CALC_CORES = 5
BATCH_FAMILIES = ("TP", "PTP", "NTP", "NEB")
# the law run keeps the P* and S* rows; the prior blocks each of their
# samplers opens (the twin branch of PEB and SEB its own) and their draws
LAW_DROP = ["EB", "DTP", "DEB", "BTP", "BEB"]
LAW_PRIOR_BLOCKS = {"tri.sample.ptp": [N], "tri.sample.stp": [N],
                    "tri.sample.peb": [N, N // 4],
                    "tri.sample.seb": [N, N // 2]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A small TRILEGAL field and a 60-row MOLUSC posterior."""
    d = tmp_path_factory.mktemp("tracing")
    tri = make_synthetic_trilegal(str(d / "trilegal.csv"), 10.0, n_stars=300,
                                  seed=1)
    rng = np.random.default_rng(2)
    mol = str(d / "molusc.csv")
    pd.DataFrame({"semi-major axis(AU)": 10 ** rng.uniform(0, 4, 60),
                  "eccentricity": rng.uniform(0, 0.9, 60),
                  "mass ratio": rng.uniform(0.1, 1, 60)}).to_csv(mol,
                                                                 index=False)
    return tri, mol


def _curve():
    time = np.linspace(-0.15, 0.15, N_T)
    flux = np.where(np.abs(time) < 0.05, 0.995, 1.0)
    return time, flux + np.random.default_rng(0).normal(0, 5e-4, N_T), 5e-4


def _target(tri):
    star = dict(Jmag=9.3, Hmag=9.1, Kmag=9.0, ra=120.0, dec=-30.0)
    rows = [dict(ID="1000", Tmag=10.0, mass=1.0, rad=1.0, Teff=5800.0,
                 plx=20.0, **star, **{"sep (arcsec)": 0.0,
                                      "PA (E of N)": 0.0}),
            dict(ID="2000", Tmag=13.5, mass=0.8, rad=0.8, Teff=5000.0,
                 plx=5.0, **star, **{"sep (arcsec)": 25.0,
                                     "PA (E of N)": 45.0})]
    t = target.from_stars(pd.DataFrame(rows), ID=1000, trilegal_fname=tri)
    t.calc_depths(tdepth=0.005)
    return t


def _calc_probs(t, mol):
    time, flux, sigma = _curve()
    t.calc_probs(time, flux, sigma, P_orb=3.0, N=N, nsamples=2, verbose=0,
                 device="cpu", key=3, molusc_file=mol, drop_scenario=DROP)


def _traced(mode, fn):
    """Spans, summary and counters of ``fn()`` run in tracer ``mode``."""
    profiling.reset()
    with profiling.tracing(mode):
        fn()
    return profiling.spans(), profiling.summary(), profiling.counters()


@pytest.fixture(scope="module")
def calc_run(files):
    tri, mol = files
    t = _target(tri)
    with profiling.tracing("off"):
        _calc_probs(t, mol)     # warm: the cached field and tables
    return _traced("host", lambda: _calc_probs(t, mol))


@pytest.fixture(scope="module")
def batch_run(files):
    tri, mol = files
    time, flux, sigma = _curve()
    entries = []
    for b in range(2):
        entries.append(dict(
            time=time, flux=flux, sigma=sigma, P_orb=3.0 + b, M_s=1.0,
            R_s=1.0, Teff=5800.0, Z=0.0, plx=20.0, Tmag=10.0, Jmag=9.3,
            Hmag=9.1, Kmag=9.0, trilegal_fname=tri, key=5 + b,
            molusc_file=mol, nearby=[dict(mass=0.8, rad=0.8, Teff=5000.0,
                                          Z=0.0, fluxratio=0.01,
                                          tdepth=0.5)]))

    def run():
        batch, n_t, has_cc = sharding.prepare_target_batch(entries,
                                                           device="cpu")
        sharding.batch_fpp_full(None, batch, N=N, n_t=n_t, ns=2, chunk=256,
                                has_cc=has_cc, drop_scenario=BATCH_DROP,
                                device="cpu")
    return _traced("host", run)


@pytest.fixture(scope="module")
def law_run(files):
    """calc_probs with no MOLUSC file: the bound companions from the law,
    each draw weighed by the companion-rate prior."""
    tri, _ = files
    t = _target(tri)
    time, flux, sigma = _curve()
    return _traced("host", lambda: t.calc_probs(
        time, flux, sigma, P_orb=3.0, N=N, nsamples=2, verbose=0,
        device="cpu", key=3, drop_scenario=LAW_DROP))


def _ancestors(spans, i):
    out = []
    while spans[i].parent >= 0:
        i = spans[i].parent
        out.append(spans[i].name)
    return out


def test_off_is_a_shared_noop(files):
    """Tracing off: ``span`` returns one shared no-op per name, entering it
    keeps nothing, a decorated function runs as itself, and a whole
    calc_probs keeps no span (its counters still count)."""
    a = profiling.span("tri.x")
    assert a is profiling.span("tri.x")
    with a:
        pass

    @profiling.span("tri.y")
    def f(x, *, y=1):
        return x + y
    assert f(1, y=2) == 3 and f.__name__ == "f"
    tri, mol = files
    _calc_probs(_target(tri), mol)
    assert profiling.spans() == [] and profiling.summary() == {}
    assert profiling.counters()["io.molusc_read"] == 1


def test_nesting_call_ids_and_self_time():
    """Host mode: each span's parent is the span open when it opened, a
    span opened with none open starts a call, and self time is the span's
    duration less its children's."""
    with profiling.tracing("host"):
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.span("c"):
                    pass
            with profiling.span("b"):
                pass
        with profiling.span("a"):
            pass
    sp = profiling.spans()
    assert [(s.name, s.parent, s.call) for s in sp] == [
        ("a", -1, 1), ("b", 0, 1), ("c", 1, 1), ("b", 0, 1), ("a", -1, 2)]
    dur = [s.end_ns - s.start_ns for s in sp]
    summ = profiling.summary()
    assert summ["a"]["count"] == 2 and summ["b"]["count"] == 2
    assert summ["a"]["self_s"] == pytest.approx(
        (dur[0] - dur[1] - dur[3] + dur[4]) * 1e-9, abs=1e-12)
    assert summ["b"]["self_s"] == pytest.approx(
        (dur[1] - dur[2] + dur[3]) * 1e-9, abs=1e-12)


def test_cap_drops_and_counts(monkeypatch):
    """Past SPAN_CAP kept spans, further spans (and their children) are
    dropped and counted under ``span.dropped``."""
    monkeypatch.setattr(profiling, "SPAN_CAP", 2)
    with profiling.tracing("host"):
        for _ in range(2):
            with profiling.span("a"):
                with profiling.span("b"):
                    pass
    assert [s.name for s in profiling.spans()] == ["a", "b"]
    assert profiling.counters()["span.dropped"] == 2


def test_device_counters_fold_when_read():
    """An array of ``device_counters`` (on the CPU here; kernels add to it
    on the card) is added to its names' counters when ``counters()`` reads
    them, then zeroed; an array that holds nothing adds no name;
    ``reset()`` zeroes it; ``enabled()`` follows the tracer's mode."""
    assert not profiling.enabled()
    with profiling.tracing("host"):
        assert profiling.enabled()
    names = ("test.a", "test.b")
    arr = profiling.device_counters(names, "cpu")
    assert profiling.device_counters(names, "cpu") is arr
    assert arr.dtype == torch.int64 and arr.tolist() == [0, 0]
    assert "test.a" not in profiling.counters()
    arr += torch.tensor([3, 0])
    assert profiling.counters() == {"test.a": 3, "test.b": 0}
    assert arr.tolist() == [0, 0]
    arr += torch.tensor([2, 5])
    assert profiling.counters() == {"test.a": 5, "test.b": 5}
    arr += 1
    profiling.reset()
    assert arr.tolist() == [0, 0] and profiling.counters() == {}


@pytest.mark.parametrize("misuse", ["reset_inside_span", "unknown_mode"])
def test_misuse_raises(misuse):
    if misuse == "unknown_mode":
        with pytest.raises(ValueError, match="tracing mode"):
            with profiling.tracing("device"):
                pass
        return
    with profiling.tracing("host"), profiling.span("a"):
        with pytest.raises(RuntimeError, match="open span"):
            profiling.reset()


@pytest.mark.parametrize("path", ["calc_probs", "batch_fpp_full"])
def test_host_spans_of_a_call(path, calc_run, batch_run):
    """One ``tri.call``; one row span per evidence row computed, in order;
    every sampler and core span under a row and in the call's id; one
    reduction a core (and the batch's one over the rows); self times add
    up to the roots' durations."""
    sp, summ, _ = calc_run if path == "calc_probs" else batch_run
    calls = [i for i, s in enumerate(sp) if s.name == "tri.call"]
    assert len(calls) == 1 and sp[calls[0]].parent == -1
    call_id = sp[calls[0]].call
    rows = [s.name[len("tri.row."):] for s in sp
            if s.name.startswith("tri.row.")]
    assert rows == (CALC_ROWS if path == "calc_probs"
                    else list(BATCH_FAMILIES))
    cores = [i for i, s in enumerate(sp) if s.name.startswith("tri.core.")
             and s.name != "tri.core.veto"]
    assert len(cores) == CALC_CORES
    for i, s in enumerate(sp):
        if s.name.startswith(("tri.sample.", "tri.core.", "tri.launch.")):
            assert s.call == call_id
            assert any(a.startswith("tri.row.") for a in _ancestors(sp, i))
        if s.name.startswith(("tri.sample.", "tri.core.lnL")):
            assert sp[s.parent].name.startswith("tri.row.")
    assert all(s.end_ns is not None for s in sp)
    assert summ["tri.reduce"]["count"] == CALC_CORES + (path != "calc_probs")
    roots = sum(s.end_ns - s.start_ns for s in sp if s.parent < 0) * 1e-9
    assert sum(r["self_s"] for r in summ.values()) == pytest.approx(
        roots, rel=1e-9)
    if path == "batch_fpp_full":
        prep = [s for s in sp if s.name == "tri.batch.prepare"]
        assert len(prep) == 1 and prep[0].call != call_id


@pytest.mark.parametrize("path", ["calc_probs", "batch_fpp_full"])
def test_counters_of_a_call(path, calc_run, batch_run):
    """``draws.core`` counts the draws handed to the cores (N a row, N // 4
    a twin row) and ``io.molusc_read`` the MOLUSC parses: one for the PTP
    row of calc_probs, one a target for the batch."""
    _, _, counts = calc_run if path == "calc_probs" else batch_run
    B = 1 if path == "calc_probs" else 2
    assert counts["draws.core"] == B * (4 * N + N // 4)
    assert counts["io.molusc_read"] == B
    assert not any(k.startswith("launch.") for k in counts)


@pytest.mark.parametrize("path", ["law", "molusc"])
def test_companion_prior_span_and_counter(path, law_run, calc_run):
    """Without a MOLUSC file each P* and S* sampler opens
    ``tri.prior.companion`` once a branch, directly under its span, and
    ``prior.companion`` counts those branches' draws; a MOLUSC call opens
    none and counts 0."""
    sp, _, counts = law_run if path == "law" else calc_run
    blocks = [s for s in sp if s.name == "tri.prior.companion"]
    if path == "molusc":
        assert blocks == [] and counts.get("prior.companion", 0) == 0
        return
    under = {}
    for s in blocks:
        under.setdefault(sp[s.parent].name, []).append(s)
    assert {k: len(v) for k, v in under.items()} == {
        k: len(v) for k, v in LAW_PRIOR_BLOCKS.items()}
    assert counts["prior.companion"] == sum(
        sum(v) for v in LAW_PRIOR_BLOCKS.values())


def test_profiler_mode_ranges_nest_as_host_spans(files, tmp_path):
    """Under ``profiling.trace`` the program's spans are
    ``user_annotation`` ranges of the Chrome trace, one per kept span,
    in the same order, each inside its parent's range."""
    tri, mol = files
    t = _target(tri)
    with profiling.trace(str(tmp_path)):
        _calc_probs(t, mol)
    sp = profiling.spans()
    with open(os.path.join(tmp_path, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    ranges = sorted((e for e in events if e.get("cat") == "user_annotation"
                     and e.get("ph") == "X"
                     and e["name"].startswith("tri.")),
                    key=lambda e: (e["ts"], -e["dur"]))
    assert [e["name"] for e in ranges] == [s.name for s in sp]
    assert sp[0].name == "tri.call" and len(sp) > 20
    for e, s in zip(ranges, sp):
        if s.parent >= 0:
            p = ranges[s.parent]
            assert p["ts"] <= e["ts"] and (e["ts"] + e["dur"]
                                           <= p["ts"] + p["dur"])
