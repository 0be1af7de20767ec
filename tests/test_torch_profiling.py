"""Port vs JAX package: utils/profiling.py (trace, timed, throughput) on
the CPU, and throughput's CUDA-event timing on the card."""

import json
import os
import time

import jax.numpy as jnp
import pytest
import torch

from triceratops_tpu.utils import profiling as jprof
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


@pytest.mark.parametrize("out", ["tensor", "nested", "none"])
def test_throughput_calls_and_rate(out):
    """warmup + repeats calls, best time > 0, draws / best; the port and
    the JAX package return the same (seconds, rate) pair shape."""
    calls = []

    def fn(n, scale=1.0):
        calls.append(n)
        v = torch.full((n,), scale)
        return {"tensor": v, "nested": ({"lnZ": [v]}, 3),
                "none": None}[out]

    best, rate = tprof.throughput(fn, 1000, draws=1000, repeats=4, warmup=2,
                                  scale=2.0)
    assert len(calls) == 6
    assert best > 0.0 and rate == pytest.approx(1000 / best)
    jbest, jrate = jprof.throughput(lambda n: jnp.ones(n), 1000, draws=1000,
                                    repeats=2)
    assert jbest > 0.0 and jrate == pytest.approx(1000 / jbest)


def test_device_of_nested_output():
    assert tprof._device_of(({"a": [3, torch.zeros(1)]},)).type == "cpu"
    assert tprof._device_of((1, "x", None)) is None


@pytest.mark.cuda
def test_throughput_times_card_output_with_events(monkeypatch):
    """A call whose output is on the card is timed between two CUDA
    events per repeat: the best time is the device time of one product,
    inside the host wall of a synchronized call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    made = []
    real = torch.cuda.Event

    def event(*args, **kwargs):
        made.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "Event", event)
    x = torch.randn(2048, 2048, device="cuda")
    best, rate = tprof.throughput(torch.matmul, x, x, draws=100, repeats=3)
    assert len(made) == 6 and all(k.get("enable_timing") for k in made)
    assert best > 0.0 and rate == pytest.approx(100 / best)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.matmul(x, x)
    torch.cuda.synchronize()
    assert best <= time.perf_counter() - t0
