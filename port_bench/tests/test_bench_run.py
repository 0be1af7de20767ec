"""A whole run on the CPU at a small size: the last line's keys, the
checks last; the import check; the work count."""

import io
import json
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from port_bench import capture, roofline, run

SEED = 2**31 + 202
CELL = "vet.toi465.nb2.molusc.lc100"


@pytest.fixture(scope="module")
def result():
    out = io.StringIO()
    rc = run.main(["--workload", CELL, "--seed", str(SEED),
                   "--seconds", "0.01", "--trace", "0"], device="cpu",
                  overrides={"N": 512}, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_last_line(result):
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(result)
    assert result["correct"] is True
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        result["device"])
    assert set(result["metrics"]) == {"candidates_per_s", "vet_p90_s",
                                      "setup_s"}
    for v in result["checks"].values():
        assert set(v) == {"value", "limit"}


def test_no_card_no_result():
    """Without a card the run exits non-zero before any result."""
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = subprocess.run([sys.executable, str(run.HERE / "run.py"),
                        "--workload", CELL, "--seed", "1",
                        "--seconds", "1"], capture_output=True, text=True,
                       cwd=run.ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "triceratops_tpu_torch.x",
                        types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "triceratops_tpu.ops",
                        types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.forbidden_modules() == ["jax", "triceratops_tpu"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import port_bench.reference, port_bench.check, "
            "port_bench.samplers, port_bench.traffic, port_bench.roofline, "
            "port_bench.trace;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'triceratops_tpu', "
            "'triceratops_tpu_torch'}))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=run.ROOT, timeout=120)
    assert p.stdout.strip() == "[]", p.stderr


def test_work_hand_count():
    """7 exposures, circular edge-on orbits of P = 10 d at a/R = 20: z ~
    12.6 t, so the three exposures at |t| <= 0.05 d are in transit; k =
    0.1 lies in the tab table's second segment, of degree 20. One of the
    five draws is masked out and needs no chi^2 work."""
    C = 5
    d = {n: torch.full((C,), v, dtype=torch.float32) for n, v in dict(
        k=0.1, P=10.0, a_R=20.0, inc=np.pi / 2, e=0.0, w=np.pi / 2,
        u1=0.4, u2=0.2, g=1.0).items()}
    d["mask"] = torch.tensor([True, True, False, True, True])
    time = torch.tensor([-0.3, -0.1, -0.05, 0.0, 0.05, 0.1, 0.3])
    nbytes, flops = roofline.core_work(time, d, dict(exptime=0.00139,
                                                     ns=20))
    r = roofline
    live = C - 1
    hand = (live * (r.FLOPS_ORBIT_DRAW + r.FLOPS_WINDOW_DRAW)
            + 3 * live * (r.FLOPS_KEPLER + 73 + 4 * r.FLOPS_NODE_POINT
                          + r.FLOPS_POINT)
            + 2 * 7 + live * (20 * r.FLOPS_TAB_TERM + r.FLOPS_TAB_DRAW))
    assert flops == hand
    assert nbytes == 4 * (2 * 7 + 9 * live + 2 * C + 152 * 162)


def test_work_same_under_either_schedule():
    """The count reads the cores' inputs only: the same under the v2 and
    the v3 chi^2 schedule."""
    import tempfile

    from triceratops_tpu_torch.ops import lightcurve

    counts = {}
    for sched in ("2", "3"):
        monkey = lightcurve.CHI2_SCHEDULE
        lightcurve.CHI2_SCHEDULE = sched
        try:
            with tempfile.TemporaryDirectory() as wd:
                cell = run.Cell(CELL, SEED, "cpu",
                                {"N": 256}, wd)
                cnt = capture.Count(roofline.core_work)
                with capture.patched(cell.entry.wrap_points(), cnt):
                    cell.call(0)
        finally:
            lightcurve.CHI2_SCHEDULE = monkey
        counts[sched] = cnt.calls
    assert len(counts["2"]) == 21 and counts["2"] == counts["3"]
