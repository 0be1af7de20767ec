"""BENCHMARK.json against the rules of its format, and every cell
resolving its files by name."""

import importlib
import json
import re

import pytest

from port_bench import run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")


@pytest.mark.parametrize("name", [m["name"] for m in METRICS] + CELLS
                         + [c["name"] for c in BENCH["configs"]]
                         + [w["traffic"] for w in BENCH["workloads"]])
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_entries(m):
    assert UNIT.match(m["unit"]), m["unit"]
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    else:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200
    for cell in m.get("workloads", []):
        assert cell in CELLS
    mod = importlib.import_module(f"port_bench.metrics.{m['name']}")
    assert callable(mod.read)


def test_unique_names():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    w, cfg, e2e, per_layer = run.spec(cell)
    assert w["chips"] == 1 and len(w["why"]) <= 200
    conf = json.loads((run.ROOT / cfg["file"]).read_text())
    importlib.import_module(f"port_bench.entries.{conf['entry']}")
    assert (run.HERE / "traffic" / f"{w['traffic']}.json").exists()
    limits = json.loads((run.HERE / "limits" / f"{cell}.json").read_text())
    assert limits
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer
