"""Shared helpers for the PyTorch port's parity tests, plus the checks
that the port stands alone (no jax import) and that its tables equal the
JAX package's.

Random numbers: torch's Philox and JAX's threefry streams differ, so the
parity tests make every uniform with numpy and hand the same numbers to
both packages. The stream is keyed by (n_streams, N) only, not by call
order, because JAX's jitted samplers bake whatever ``_uniforms`` returns
at trace time. ``shared_uniforms`` patches
``triceratops_tpu.scenarios.engine._uniforms`` and ``_lattice_strat`` (a
test-local copy whose only change is the source of its permutation
uniforms) and the port's ``engine._uniforms``; nothing in either package
changes.

Star and MOLUSC-row indices are drawn the same way on both sides: as
floor(u * hi) from numpy uniforms keyed by the draw count, through
``jax.random.randint`` (patched for the test's duration; ``hi`` may be a
traced value inside the jitted samplers) and the port's
``engine._randint`` seam.

Bound-companion prior: the JAX package forms the cube of the companion's
separation in cm in float32, which overflows, so its log10 Pmax reads
inf; the port computes it in logs and in float64 (README, known
divergences).
``shared_uniforms`` therefore also runs the JAX package's own
``priors.companion._max_porbs`` on float64 inputs (upstream's
arithmetic; tests/conftest.py turns on x64) and hands its float32 cast
on, so the JAX side's law rows are the ones the port is held to.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import triceratops_tpu.scenarios.engine as jeng
from triceratops_tpu.priors import companion as jco
from triceratops_tpu_torch.scenarios import engine as teng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def f32(a):
    return np.asarray(a, np.float32)


def jf(a):
    """float32 jax array (f64 inputs would route the reference to its
    exact paths: tests/conftest.py turns on x64)."""
    return jnp.asarray(f32(a))


def tf(a):
    """float32 CPU tensor."""
    return torch.as_tensor(f32(a))


def uniforms_np(n_streams, N):
    """n_streams float32 U[0, 1) arrays of length N, keyed by
    (n_streams, N)."""
    rng = np.random.default_rng([1234, n_streams, N])
    return [rng.random(N, dtype=np.float32) for _ in range(n_streams)]


def index_uniforms_np(n):
    """float32 U[0, 1) array of length n for index draws, keyed by n."""
    return np.random.default_rng([4321, n]).random(n, dtype=np.float32)


def _jax_randint(key, shape, minval, maxval, dtype=None):
    """jax.random.randint stand-in: floor(u * maxval) in float32, clipped
    to [minval, maxval - 1]; maxval may be traced."""
    del key, dtype
    hi = jnp.asarray(maxval)
    u = jnp.asarray(index_uniforms_np(shape[0]))
    idx = jnp.floor(u * hi.astype(jnp.float32)).astype(jnp.int32)
    return jnp.clip(idx, minval, hi - 1)


def _torch_randint(gen, n, hi):
    u = torch.as_tensor(index_uniforms_np(n))
    return torch.clamp(torch.floor(u * float(hi)).long(), 0, int(hi) - 1)


def _jax_lattice_strat(u, axes, n, key):
    """triceratops_tpu.scenarios.engine._lattice_strat with its
    permutation uniforms taken from ``uniforms_np``."""
    del key
    out = list(u)
    dt = out[axes[0]].dtype
    base = jnp.arange(n, dtype=dt)
    out[axes[0]] = (base + out[axes[0]]) / n
    rest = axes[1:]
    if rest:
        r = jnp.asarray(np.stack(uniforms_np(len(rest), n)))
        perms = jnp.argsort(r, axis=1)
        for j, ax in enumerate(rest):
            out[ax] = (perms[j].astype(dt) + out[ax]) / n
    return out


_JAX_MAX_PORBS = jco._max_porbs


def _jax_max_porbs_f64(*args):
    """triceratops_tpu.priors.companion._max_porbs evaluated on float64
    inputs, cast back to float32; behind an optimization barrier, so XLA
    does not fold it on the shared uniforms while it compiles."""
    args = jax.lax.optimization_barrier(
        tuple(jnp.asarray(a, jnp.float64) for a in args))
    return _JAX_MAX_PORBS(*args).astype(jnp.float32)


@pytest.fixture
def shared_uniforms(monkeypatch):
    jax.clear_caches()
    monkeypatch.setattr(jco, "_max_porbs", _jax_max_porbs_f64)
    monkeypatch.setattr(
        jeng, "_uniforms",
        lambda key, n, N: [jnp.asarray(a) for a in uniforms_np(n, N)])
    monkeypatch.setattr(jeng, "_lattice_strat", _jax_lattice_strat)
    monkeypatch.setattr(
        teng, "_uniforms",
        lambda gen, n, N: [torch.as_tensor(a) for a in uniforms_np(n, N)])
    monkeypatch.setattr(jax.random, "randint", _jax_randint)
    monkeypatch.setattr(teng, "_randint", _torch_randint)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def test_shared_index_draws(shared_uniforms):
    """The patched index draws agree between the packages, stay in
    [0, hi) and accept a traced hi, as DTP's max(N_comp - 1, 1) is."""
    want = np.asarray(jax.jit(lambda hi: jax.random.randint(
        jax.random.key(0), (4096,), 0, jnp.maximum(hi - 1, 1)))(300))
    got = teng._randint(torch.Generator(), 4096, 299).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0 and got.max() == 298


def test_import_without_jax():
    """The port imports torch, numpy, scipy and pandas only (and matplotlib
    for its plots): importing it, the likelihoods, the catalogs, the
    plotting module, the batch path and the catalog replay with jax made
    unimportable succeeds and pulls in no triceratops_tpu module."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import triceratops_tpu_torch, triceratops_tpu_torch.triceratops\n"
        "import triceratops_tpu_torch.populations.synthetic\n"
        "import triceratops_tpu_torch.likelihoods\n"
        "import triceratops_tpu_torch.populations.catalogs\n"
        "import triceratops_tpu_torch.frontend.plotting\n"
        "import triceratops_tpu_torch.parallel.sharding\n"
        "import triceratops_tpu_torch.tools.catalog_replay\n"
        "bad = [m for m in sys.modules if m == 'triceratops_tpu' or "
        "m.startswith('triceratops_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


class TestTables:
    """load_tables against the JAX modules' own numpy constants: equal
    bit for bit in float64, and equal to one cast in float32."""

    def _reference(self):
        from triceratops_tpu.ops import fastcore
        from triceratops_tpu.priors.samplers import _beta_ppf_cheb
        from triceratops_tpu.populations.stellar import _ppoly_arrays
        from triceratops_tpu_torch.tables import SPLINE_NAMES

        cL, cH, _, _ = _beta_ppf_cheb()
        ref = {"tab_C": fastcore._TAB_C64, "dct_T": fastcore._DCT_T,
               "s_nodes": fastcore._S_NODES, "beta_cL": cL, "beta_cH": cH}
        for name in SPLINE_NAMES:
            ref[f"ppoly/{name}"] = _ppoly_arrays(name)
        return ref

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_tables_equal_reference(self, dtype):
        from triceratops_tpu_torch.tables import load_tables

        tabs = load_tables("cpu", dtype)
        ref = self._reference()
        assert set(tabs) == set(ref)
        npdt = np.float64 if dtype == torch.float64 else np.float32
        for key, want in ref.items():
            got = tabs[key]
            pairs = zip(got, want) if key.startswith("ppoly/") else [(got, want)]
            for g, w in pairs:
                assert g.dtype == dtype
                np.testing.assert_array_equal(g.numpy(),
                                              np.asarray(w).astype(npdt),
                                              err_msg=key)

    def test_beta_ranges_and_tab_layout(self):
        from triceratops_tpu.ops import fastcore
        from triceratops_tpu.priors.samplers import _beta_ppf_cheb
        from triceratops_tpu_torch import tables

        assert tables.beta_ppf_cheb()[2:] == _beta_ppf_cheb()[2:]
        for got, want in zip(tables.cheb_k_tables(),
                             (fastcore._TAB_BREAKS, fastcore._TAB_KINDS,
                              fastcore._TAB_DEGS, fastcore._TAB_C64)):
            np.testing.assert_array_equal(got, want)
