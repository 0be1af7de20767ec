"""Port vs JAX reference for the rest of the single-target frontend: the
star edits (add_star / remove_star / update_star), calc_probs_ensemble,
the online constructor (target.__init__, _fetch_cutouts, _finish_init),
get_spoc_apertures, the TRILEGAL memo of calc_probs, the funcs network
ladder and small helpers, the published catalogs, plot_field /
plot_fits, and the TRICERATOPS_COEFFS switch.

The network packages (lightkurve, astroquery, astropy, mechanicalsoup)
are stubbed as in tests/test_offline_fits.py and
tests/test_network_fixtures.py: both packages get the same canned
services, so what is compared is each package's own logic. Tolerances:
host-side tables and frames are compared exactly; the ensemble's FPP
within 1e-3 of the reference on shared uniforms (the whole-calc_probs
gate of test_torch_slice.py).
"""

import subprocess
import sys
import types

import matplotlib
matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from triceratops_tpu import target as jtarget  # noqa: E402
from triceratops_tpu import funcs as jfuncs  # noqa: E402
from triceratops_tpu.populations import catalogs as jcat  # noqa: E402
from triceratops_tpu_torch import target as ttarget  # noqa: E402
from triceratops_tpu_torch import funcs as tfuncs  # noqa: E402
from triceratops_tpu_torch.frontend import target as ttarget_mod  # noqa: E402
from triceratops_tpu_torch.frontend.target import ensemble_seed  # noqa: E402
from triceratops_tpu_torch.populations import catalogs as tcat  # noqa: E402

from test_torch_shared import REPO, shared_uniforms  # noqa: F401,E402
from test_torch_slice import _stars, _curve  # noqa: E402
from test_network_fixtures import (  # noqa: E402,F401
    fake_mechanicalsoup, V16_URL, V15_URL, TRILEGAL_V16_HEADER,
    _write_trilegal, _v16_rows, DIR_HTML, _FakeHDU, _FakeHDUList)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the suite
    runs in several worker processes on shared cores, where torch's
    default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**kw):
    return (jtarget.from_stars(_stars(), ID=1000, **kw),
            ttarget.from_stars(_stars(), ID=1000, **kw))


def _same_target(got, want):
    pd.testing.assert_frame_equal(got.stars, want.stars)
    assert len(got.pix_coords) == len(want.pix_coords)
    for g, w in zip(got.pix_coords, want.pix_coords):
        np.testing.assert_array_equal(g, w)


class TestStarEdits:
    def test_from_stars_attributes(self):
        want, got = _pair(sectors=[3, 4])
        _same_target(got, want)
        for name in ("TESS_images", "col0s", "row0s"):
            g, w = getattr(got, name), getattr(want, name)
            assert len(g) == len(w) == 2
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        assert got.trilegal_url is None and want.trilegal_url is None

    def test_add_remove_update(self):
        want, got = _pair(sectors=[1, 2])
        for t in (want, got):
            t.add_star(3000, 15.0, bound=True)
            t.add_star(3001, 16.0, bound=False)
        _same_target(got, want)
        for t in (want, got):
            t.update_star(3001, "mass", 0.4)
            t.update_star("2000", "Teff", 4500.0)
        _same_target(got, want)
        for t in (want, got):
            t.remove_star(["3000", 2001])
            t.remove_star(3001)
        pd.testing.assert_frame_equal(got.stars, want.stars)
        assert list(got.stars["ID"]) == ["1000", "2000"]


class TestEnsemble:
    kw = dict(N=512, nsamples=2, verbose=0, device="cpu",
              drop_scenario=["PTP", "PEB", "STP", "SEB"])

    def _target(self):
        t = ttarget.from_stars(_stars().iloc[:1], ID=1000)
        t.calc_depths(tdepth=0.005)
        return t

    def test_runs_are_seeded_calls(self, tmp_path):
        # a shallow transit, so that TP and EB compete and FPP varies
        # from run to run
        time, flux, sigma = _curve(n_t=40)
        flux = 1.0 + 0.1 * (flux - 1.0)
        t = self._target()
        t.calc_probs_ensemble(time, flux, sigma, P_orb=3.0, n_runs=3,
                              key=7, **self.kw)
        assert t.FPP_runs.shape == (3,) and t.NFPP_runs.shape == (3,)
        assert t.FPP == float(t.FPP_runs.mean())
        assert t.NFPP == float(t.NFPP_runs.mean())
        assert t.FPP_std == float(t.FPP_runs.std()) and t.FPP_std > 0
        runs = t.FPP_runs.copy()
        # deterministic for an int key
        t.calc_probs_ensemble(time, flux, sigma, P_orb=3.0, n_runs=2,
                              key=7, **self.kw)
        np.testing.assert_array_equal(t.FPP_runs, runs[:2])
        # run i is calc_probs with the documented seed
        assert ensemble_seed(7, 1) == int(
            np.random.SeedSequence([7, 1]).generate_state(1)[0])
        t.calc_probs(time, flux, sigma, P_orb=3.0,
                     key=ensemble_seed(7, 1), **self.kw)
        assert t.FPP == runs[1]
        # plot_fits draws the last run's best fits
        t.plot_fits(time, flux, sigma, save=True,
                    fname=str(tmp_path / "fits"), device="cpu")
        assert (tmp_path / "fits.pdf").stat().st_size > 1000

    @pytest.mark.usefixtures("shared_uniforms")
    def test_matches_reference(self):
        """On shared uniforms every run sees the same draws in both
        packages, so the ensembles agree as single calls do."""
        time, flux, sigma = _curve(n_t=40)
        kw = dict(N=2048, nsamples=2, verbose=0,
                  drop_scenario=["PTP", "PEB", "STP", "SEB"])
        want, got = (cls.from_stars(_stars().iloc[:2], ID=1000)
                     for cls in (jtarget, ttarget))
        for t in (want, got):
            t.calc_depths(tdepth=0.005)
        want.calc_probs_ensemble(time, flux, sigma, P_orb=3.0, n_runs=2,
                                 key=3, **kw)
        got.calc_probs_ensemble(time, flux, sigma, P_orb=3.0, n_runs=2,
                                key=3, device="cpu", **kw)
        assert abs(got.FPP - want.FPP) < 1e-3
        assert abs(got.NFPP - want.NFPP) < 1e-3
        np.testing.assert_allclose(got.FPP_runs, want.FPP_runs, atol=1e-3)
        assert got.FPP_std == pytest.approx(want.FPP_std, abs=1e-3)


def test_trilegal_memo(tmp_path, monkeypatch):
    """With a TRILEGAL URL and no file, the first calc_probs saves the
    result once and the background rows use it; the second reuses it."""
    src = _write_trilegal(tmp_path / "result.dat", TRILEGAL_V16_HEADER,
                          _v16_rows(40, Tmag0=10.5))
    monkeypatch.chdir(tmp_path)
    calls = []
    real = ttarget_mod.save_trilegal
    monkeypatch.setattr(ttarget_mod, "save_trilegal",
                        lambda url, ID: calls.append(url) or real(url, ID))
    t = ttarget.from_stars(_stars().iloc[:1], ID=1000)
    t.trilegal_url = src
    t.calc_depths(tdepth=0.005)
    time, flux, sigma = _curve(n_t=30)
    kw = dict(N=256, nsamples=2, verbose=0, device="cpu", key=1,
              drop_scenario=["TP", "EB", "PTP", "PEB", "STP", "SEB", "DEB",
                             "BEB"])
    t.calc_probs(time, flux, sigma, P_orb=3.0, **kw)
    assert t.trilegal_fname == "1000_TRILEGAL.csv"
    assert (tmp_path / t.trilegal_fname).exists()
    assert np.isfinite(t.lnZ[[9, 12]]).all()
    t.calc_probs(time, flux, sigma, P_orb=3.0, **kw)
    assert calls == [src]


# ---------------------------------------------------------------------------
# Online constructor (stubbed lightkurve + astroquery + astropy)
# ---------------------------------------------------------------------------

class _Quantity:
    def __init__(self, value):
        self.value = value

    def to(self, unit):
        return self


class _SkyCoord:
    """Flat-sky stand-in: separation [arcsec] and position angle [deg E of
    N] from the offsets."""

    def __init__(self, ra, dec, unit=None):
        self.ra, self.dec = float(ra), float(dec)

    def _off(self, other):
        return ((other.ra - self.ra) * np.cos(np.deg2rad(self.dec)),
                other.dec - self.dec)

    def separation(self, other):
        return _Quantity(3600.0 * np.hypot(*self._off(other)))

    def position_angle(self, other):
        dx, dy = self._off(other)
        return _Quantity(np.rad2deg(np.arctan2(dx, dy)) % 360.0)


class _WCS:
    def __init__(self, header):
        self.c0 = header["ref"]

    def all_world2pix(self, ra, dec, origin):
        return [np.array((ra - self.c0[0]) * 1000.0 + 5.0),
                np.array((dec - self.c0[1]) * 1000.0 + 6.0)]


def _tic_table(stars):
    cols = ["ID", "Tmag", "Jmag", "Hmag", "Kmag", "ra", "dec", "mass",
            "rad", "Teff", "plx"]
    df = stars[cols].copy()
    df["disposition"] = ""
    df["duplicate_id"] = ""

    class _Table:
        def __getitem__(self, names):
            return types.SimpleNamespace(
                to_pandas=lambda: df[list(names)].copy())

    return _Table()


@pytest.fixture
def online_stack(monkeypatch):
    """lightkurve, astroquery.mast and astropy stubs serving one TIC field
    and a 22 x 22 TessCut per sector (sector 9 fails to download)."""
    calls = {"query_object": [], "tesscut": []}
    stars = _stars()

    lk = types.ModuleType("lightkurve")

    def search_tesscut(target, sector):
        calls["tesscut"].append(sector)

        class _Res:
            def download_all(self, cutout_size):
                if sector == 9:
                    raise OSError("no cutout for this sector")
                flux = np.arange(3 * 22 * 22, dtype=float).reshape(3, 22, 22)
                hdu1 = types.SimpleNamespace(
                    data={"FLUX": flux + sector},
                    header={"1CRV4P": 100 + sector, "2CRV4P": 200})
                hdu2 = types.SimpleNamespace(header={"ref": (120.0, -30.0)})
                return [types.SimpleNamespace(hdu=[None, hdu1, hdu2])]
        return _Res()

    lk.search_tesscut = search_tesscut
    mast = types.ModuleType("astroquery.mast")

    class Catalogs:
        @staticmethod
        def query_object(name, radius, catalog):
            calls["query_object"].append((name, radius, catalog))
            return _tic_table(stars)

    mast.Catalogs = Catalogs
    aq = types.ModuleType("astroquery")
    aq.mast = mast
    wcs_mod = types.ModuleType("astropy.wcs")
    wcs_mod.WCS = _WCS
    coords_mod = types.ModuleType("astropy.coordinates")
    coords_mod.SkyCoord = _SkyCoord
    units_mod = types.ModuleType("astropy.units")
    units_mod.arcsec, units_mod.deg = 1.0, 1.0
    astropy_mod = types.ModuleType("astropy")
    astropy_mod.wcs, astropy_mod.coordinates = wcs_mod, coords_mod
    astropy_mod.units = units_mod
    for name, mod in [("lightkurve", lk), ("astroquery", aq),
                      ("astroquery.mast", mast), ("astropy", astropy_mod),
                      ("astropy.wcs", wcs_mod),
                      ("astropy.coordinates", coords_mod),
                      ("astropy.units", units_mod)]:
        monkeypatch.setitem(sys.modules, name, mod)
    return calls


class TestOnlineConstructor:
    def test_matches_reference(self, online_stack, capsys):
        kw = dict(trilegal_fname="field.csv")
        want = jtarget(1000, [3, 9, 4], **kw)
        got = ttarget(1000, [3, 9, 4], **kw)
        assert online_stack["tesscut"] == [3, 9, 4, 3, 9, 4]
        (q1, q2) = online_stack["query_object"]
        assert q1 == q2 == ("TIC1000", 10 * 20.25, "TIC")
        assert capsys.readouterr().out.count("Sector 9 raised exception") == 2
        pd.testing.assert_frame_equal(got.stars, want.stars)
        assert got.stars["sep (arcsec)"].iloc[1] > 0
        for name in ("TESS_images", "col0s", "row0s", "pix_coords"):
            g, w = getattr(got, name), getattr(want, name)
            assert len(g) == len(w) == 2
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        assert (got.trilegal_fname, got.trilegal_url) == ("field.csv", None)
        assert got.N_pix == want.N_pix == 22

    def test_without_trilegal_file_queries_the_service(
            self, online_stack, fake_mechanicalsoup):
        fake_mechanicalsoup.pages[V16_URL] = ["../tmp/output7.dat"]
        t = ttarget(1000, [3])
        assert t.trilegal_fname is None
        assert t.trilegal_url == "http://stev.oapd.inaf.it/tmp/output7.dat"
        (url, fields), = fake_mechanicalsoup.submissions
        assert (url, fields["eq_alpha"]) == (V16_URL, "120.0")

    def test_invalid_mission(self):
        with pytest.raises(ValueError, match="invalid mission"):
            ttarget(1000, [1], mission="JWST")


class TestSpocApertures:
    def test_per_sector(self, monkeypatch):
        canned = {3: np.array([[5, 6], [5, 7]]), 4: np.array([[8, 9]])}
        aps = {}
        for mod, cls in ((jtarget.__module__, jtarget), (None, ttarget)):
            target_mod = (sys.modules[mod] if mod else ttarget_mod)
            monkeypatch.setattr(target_mod, "get_aperture",
                                lambda ID, s: canned[s])
            aps[cls] = cls.from_stars(_stars(), sectors=[3, 4]) \
                .get_spoc_apertures()
        for g, w in zip(aps[ttarget], aps[jtarget]):
            np.testing.assert_array_equal(g, w)
        assert len(aps[ttarget]) == 2

    def test_failure_degrades(self, monkeypatch, capsys):
        def boom(ID, s):
            raise OSError("archive unreachable")

        monkeypatch.setattr(ttarget_mod, "get_aperture", boom)
        assert ttarget.from_stars(_stars(), sectors=[3]) \
            .get_spoc_apertures() == []
        assert "No SPOC apertures available." in capsys.readouterr().out


# ---------------------------------------------------------------------------
# funcs: the network ladder and helpers, both packages on the same stubs
# ---------------------------------------------------------------------------

class TestFuncs:
    @pytest.mark.parametrize("pages", [
        {V16_URL: ["../tmp/output123.dat"]},
        {V16_URL: [], V15_URL: ["../tmp/out15.dat"]},
        {V16_URL: [], V15_URL: []}])
    def test_query_trilegal_ladder(self, fake_mechanicalsoup, pages, capsys):
        out = {}
        for mod in (jfuncs, tfuncs):
            fake_mechanicalsoup.pages = dict(pages)
            fake_mechanicalsoup.submissions = []
            out[mod] = (mod.query_TRILEGAL(54.8, -42.7, verbose=0),
                        list(fake_mechanicalsoup.submissions),
                        capsys.readouterr().out)
        assert out[tfuncs] == out[jfuncs]

    def test_query_trilegal_without_mechanicalsoup(self, monkeypatch,
                                                   capsys):
        monkeypatch.setitem(sys.modules, "mechanicalsoup", None)
        assert tfuncs.query_TRILEGAL(54.8, -42.7) is None
        assert "mechanicalsoup not available" in capsys.readouterr().out

    def test_save_trilegal(self, tmp_path, monkeypatch, capsys):
        assert tfuncs.save_trilegal(None, 1) == 0.0
        assert "Ignoring BTP" in capsys.readouterr().out
        src = _write_trilegal(tmp_path / "r.dat", TRILEGAL_V16_HEADER,
                              _v16_rows(6))
        monkeypatch.chdir(tmp_path)
        assert tfuncs.save_trilegal(src, 7) == "7_TRILEGAL.csv"
        got = (tmp_path / "7_TRILEGAL.csv").read_bytes()
        assert jfuncs.save_trilegal(src, 7) == "7_TRILEGAL.csv"
        assert (tmp_path / "7_TRILEGAL.csv").read_bytes() == got
        for g, w in zip(tfuncs.trilegal_results("7_TRILEGAL.csv", 11.0),
                        jfuncs.trilegal_results("7_TRILEGAL.csv", 11.0)):
            np.testing.assert_array_equal(g, w)

    def test_find_url_and_aperture(self, monkeypatch):
        import urllib.request as _ur

        monkeypatch.setattr(_ur, "urlopen", lambda url: types.SimpleNamespace(
            read=lambda: DIR_HTML))
        assert (tfuncs.find_url(300038935, sector=1)
                == jfuncs.find_url(300038935, sector=1))
        bitmap = np.array([[0, 1, 1, 0], [1, 3, 3, 1], [1, 3, 2, 1],
                           [0, 1, 1, 0]])
        hdus = _FakeHDUList([_FakeHDU(), _FakeHDU(), _FakeHDU(
            data=bitmap, header={"CRVAL1P": 100, "CRVAL2P": 200})])
        fits_mod = types.ModuleType("astropy.io.fits")
        fits_mod.open = lambda f, mode="readonly": hdus
        io_mod = types.ModuleType("astropy.io")
        io_mod.fits = fits_mod
        astropy_mod = types.ModuleType("astropy")
        astropy_mod.io = io_mod
        for name, mod in [("astropy", astropy_mod), ("astropy.io", io_mod),
                          ("astropy.io.fits", fits_mod)]:
            monkeypatch.setitem(sys.modules, name, mod)
        for mod in (jfuncs, tfuncs):
            monkeypatch.setattr(mod, "find_url", lambda ID, s: "/fake.fits")
        got = tfuncs.get_aperture(300038935, 1)
        np.testing.assert_array_equal(got, jfuncs.get_aperture(300038935, 1))
        assert {tuple(p) for p in got} == {(101, 201), (102, 201),
                                           (101, 202)}

    def test_helpers(self):
        assert tfuncs.segment_ID("42") == jfuncs.segment_ID("42") == "0042"
        for V, Ks in ((9.0, 7.5), (12.0, 6.0), (15.0, 9.5)):
            assert (tfuncs.color_Teff_relations(V, Ks)
                    == jfuncs.color_Teff_relations(V, Ks))
        x, y = np.linspace(0, 4, 9), np.linspace(-1, 3, 7)
        np.testing.assert_array_equal(tfuncs.Gauss2D(x, y, 2.0, 1.0, 0.75, 3),
                                      jfuncs.Gauss2D(x, y, 2.0, 1.0, 0.75, 3))
        assert (tfuncs.Gauss2D(2.5, 1.5, 2.0, 1.0, 0.75, 3)
                == jfuncs.Gauss2D(2.5, 1.5, 2.0, 1.0, 0.75, 3))


@pytest.mark.parametrize("name", ["classified_tois", "unclassified_tois",
                                  "vetting_catalog"])
def test_catalogs(name):
    got = getattr(tcat, name)()
    pd.testing.assert_frame_equal(got, getattr(jcat, name)())
    got.iloc[0, 0] = None      # a copy: the cache stays untouched
    pd.testing.assert_frame_equal(getattr(tcat, name)(),
                                  getattr(jcat, name)())


def test_plot_field(tmp_path):
    t = ttarget.from_stars(_stars(), ID=1000)
    ap = np.array([[10, 10], [10, 11], [11, 10], [11, 11]])
    fig = t.plot_field(sector=1, ap_pixels=ap, save=True,
                       fname=str(tmp_path / "field"))
    assert (tmp_path / "field.pdf").stat().st_size > 1000
    from mpl_toolkits.axes_grid1.anchored_artists import (
        AnchoredDirectionArrows)
    assert sum(isinstance(a, AnchoredDirectionArrows)
               for a in fig.axes[0].artists) == 1


def _backend_picks(fc, tensor):
    """Which coefficient backend ``fc.deficit_coeffs`` dispatches to for
    float32 and for float64 inputs; the two backends are replaced by
    markers, so nothing is computed."""
    fc.cheb_deficit_coeffs = lambda *a: "exact"
    fc.cheb_deficit_coeffs_tab = lambda *a: "tab"
    return [fc.deficit_coeffs(*(tensor(np.ones(4, dt)) for _ in range(3)))
            for dt in (np.float32, np.float64)]


@pytest.fixture(scope="module")
def port_picks():
    """The port's picks under each TRICERATOPS_COEFFS value, each from a
    fresh import of ops/fastcore (the variable is read at import), in one
    process."""
    import inspect

    src = ("import importlib, os, numpy as np, torch\n"
           + inspect.getsource(_backend_picks)
           + "for mode in ('auto', 'exact', 'tab'):\n"
           "    os.environ['TRICERATOPS_COEFFS'] = mode\n"
           "    import triceratops_tpu_torch.ops.fastcore as fc\n"
           "    fc = importlib.reload(fc)\n"
           "    print(fc.COEFFS_BACKEND, *_backend_picks(fc, torch.as_tensor))"
           "\n")
    res = subprocess.run([sys.executable, "-c", src], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return {line.split()[0]: line.split()[1:]
            for line in res.stdout.splitlines()}


@pytest.mark.parametrize("mode", ["auto", "exact", "tab"])
def test_coeffs_switch(mode, port_picks, monkeypatch):
    """TRICERATOPS_COEFFS forces the same coefficient backend in both
    packages, for float32 and float64 inputs (the JAX package's module
    constant is set here, the port's read at a fresh import)."""
    import jax.numpy as jnp
    from triceratops_tpu.ops import fastcore as jfc

    monkeypatch.setattr(jfc, "COEFFS_BACKEND", mode)
    for name in ("cheb_deficit_coeffs", "cheb_deficit_coeffs_tab"):
        monkeypatch.setattr(jfc, name, getattr(jfc, name))
    want = _backend_picks(jfc, jnp.asarray)
    assert port_picks[mode] == want
    assert want == {"auto": ["tab", "exact"], "exact": ["exact", "exact"],
                    "tab": ["tab", "tab"]}[mode]
