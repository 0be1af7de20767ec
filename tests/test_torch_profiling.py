"""utils/profiling.py's trace and timed on the CPU (the tracer's spans and
counters: tests/test_torch_tracing.py)."""

import json
import os

import torch

from triceratops_tpu_torch.utils import profiling as tprof


def test_trace_exports_chrome_trace(tmp_path):
    """The block's ops land in <logdir>/trace.json, and the profiler the
    block got reads them back."""
    x = torch.ones(64, 64)
    with tprof.trace(str(tmp_path / "tr")) as prof:
        torch.matmul(x, x).sum()
    with open(os.path.join(tmp_path, "tr", "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert any("matmul" in e.key for e in prof.key_averages())


def test_timed_prints_label():
    got = []
    with tprof.timed("coeffs", printer=got.append):
        torch.ones(8).sum()
    assert len(got) == 1 and got[0].startswith("[coeffs] ")
    assert got[0].endswith("s") and float(got[0][9:-1]) >= 0.0
