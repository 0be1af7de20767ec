"""The traffic generator: the same seed gives the same inputs; what the
mix fixes stays fixed across seeds."""

import numpy as np
import pytest

from port_bench import reference as ref
from port_bench import traffic

SEED = 2**31 + 77


@pytest.mark.parametrize("mix", ["toi465.nb2.lc100", "toi465.nb2.lc8055",
                                 "toi465.nb8.lc100"])
def test_field_deterministic(mix):
    a, b = traffic.make(mix, SEED, 1), traffic.make(mix, SEED, 1)
    c = traffic.make(mix, SEED + 1, 1)
    np.testing.assert_array_equal(a.flux, b.flux)
    np.testing.assert_array_equal(a.time, c.time)
    assert not np.array_equal(a.flux, c.flux)
    assert list(a.stars.ID) == list(c.stars.ID)


def test_field_rows():
    """Every star of each field passes calc_depths' gate: 21, 21 and 39
    rows."""
    for mix, n in (("toi465.nb2.lc100", 21), ("toi465.nb8.lc100", 39)):
        f = traffic.make(mix, SEED, 1)
        fr = ref.flux_ratios(f.stars.Tmag, f.stars["sep (arcsec)"],
                             f.stars["PA (E of N)"])
        d = ref.required_depths(fr, f.tdepth)
        assert ((d > 0) & (d <= 1)).all()
        assert 15 + 3 * (len(d) - 1) == n


def test_long_grid():
    f = traffic.make("toi465.nb2.lc8055", SEED, 1)
    assert len(f.time) == 8055 and np.all(np.diff(f.time) >= 0)
    assert np.abs(f.time).max() < 0.4


def test_catalog_cycle():
    a = traffic.make("tab7.lc100", SEED, 8)
    b = traffic.make("tab7.lc100", SEED + 1, 8)
    first = [t.toi for t in a.candidates(0)]
    assert first == [t.toi for t in b.candidates(0)]
    n = len(a.targets)
    assert [t.toi for t in a.candidates(n)] == first  # cycles
    assert not np.array_equal(a.candidates(0)[0].flux,
                              b.candidates(0)[0].flux)
    np.testing.assert_array_equal(
        a.candidates(3)[1].flux, traffic.make("tab7.lc100", SEED,
                                              8).candidates(3)[1].flux)


def test_trilegal_deterministic(tmp_path):
    p1 = traffic.synthetic_trilegal(tmp_path / "a.csv", 9.7, 300, 5)
    p2 = traffic.synthetic_trilegal(tmp_path / "b.csv", 9.7, 300, 5)
    assert open(p1).read() == open(p2).read()


def test_catalog_nearby():
    """Each replay target carries the first min(NumNFP, 8) of the mix's
    nearby stars."""
    import pandas as pd

    a = traffic.make("tab7.lc100", SEED, 8)
    rows = pd.read_csv(traffic.HERE / "data" / "tab7.csv")
    by_toi = dict(zip(rows.TOI, rows.NumNFP))
    counts = [len(t.stars) - 1 for t in a.targets]
    assert counts == [min(by_toi[t.toi], 8) for t in a.targets]
    assert max(counts) == 8 and min(counts) == 0


def test_molusc_posterior(tmp_path):
    """The posterior is made from the seed, one row per 100 draws, and
    every target of the mix carries it."""
    a = traffic.make("toi465.nb2.molusc.lc100", SEED, 1, 4000, tmp_path)
    text = open(a.molusc).read()
    b = traffic.make("toi465.nb2.molusc.lc100", SEED, 1, 4000, tmp_path)
    assert open(b.molusc).read() == text
    assert len(text.splitlines()) == 1 + 40
    c = traffic.make("tab7.molusc.lc100", SEED + 1, 8, 4000, tmp_path)
    assert {t.molusc for t in c.targets} == {c.targets[0].molusc}
    assert open(c.targets[0].molusc).read() != text
