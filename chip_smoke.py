"""Smoke run of the PyTorch port (triceratops_tpu_torch) on one NVIDIA GPU.

Drives the port's main path once at full size and checks it:

  1. requires CUDA and prints the card's name and power limit;
  2. builds the chi^2 kernel from csrc/ with nvcc and prints the build time;
  3. compares the kernel with its plain torch version on the card at the
     slice's chunk shape (16384 x 100, GL-4), at a long-curve shape
     (n_t = 8055) and at ns = 1, and times both with CUDA events;
  4. runs target.from_stars -> calc_depths -> calc_probs(N = 1e6,
     nsamples = 20) on a TOI-465-like target with two nearby stars (9 live
     rows; the unported rows dropped) and checks the result and that the
     kernel was launched;
  5. reruns the same seed on the plain torch path and compares per-row lnZ;
  6. times three warm calc_probs calls with different seeds.

Prints a JSON line with the kernel's numbers, then as its last line
{"ok": true, "device": {...}}. Exits non-zero on any failure, without a
CUDA card, and outside a checkout of the repository.

Run from the repository root:  python3 chip_smoke.py
"""

import json
import subprocess
import sys
import time

import numpy as np

N_DRAWS = 1_000_000
NSAMPLES = 20
EXPTIME = 0.00139
UNPORTED = ["PTP", "PEB", "STP", "SEB"]
LIVE_ROWS = [0, 1, 2, 15, 16, 17, 18, 19, 20]
SIGMA_GATE = 5e-4     # noise level of the kernel-comparison inputs


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    # f32 matmuls must stay full precision (the tabulated coefficients'
    # 3e-6 budget is already set by f32 round-off)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are enabled")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")


def phase_build(chi2_core):
    t0 = time.perf_counter()
    so = chi2_core.build(verbose=True)
    dt = time.perf_counter() - t0
    print(f"phase 2: built {so.name} in {dt:.2f} s")
    return dt


def _chunk_inputs(torch, C, n_t, ns, window, seed):
    """One chunk of (q0 ... obs_dev) for chi2_supersampled, built by the
    port's own coefficient and exposure stages from seeded draws (the
    draws of tests/test_pallas_core.py)."""
    from triceratops_tpu_torch.ops import lightcurve as lc
    from triceratops_tpu_torch.ops.fastcore import (
        deficit_coeffs, exposure_z2_poly)
    from triceratops_tpu_torch.core.kepler import projected_z

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    t = f(np.linspace(-window, window, n_t))
    k = 10 ** rng.uniform(-2, -0.7, C)
    aR = np.full(C, 9.6)
    inc = f(np.arccos(rng.uniform(0, 1, C) * (1 + k) / aR))
    k, aR, P = f(k), f(aR), f(np.full(C, 3.0))
    e, w = f(rng.uniform(0, 0.5, C)), f(rng.uniform(-np.pi, np.pi, C))
    u1, u2 = f(np.full(C, 0.4)), f(np.full(C, 0.2))
    g = f(rng.uniform(0.2, 1.0, C))[:, None].contiguous()
    obs = f(rng.normal(0, SIGMA_GATE, n_t))[None, :].contiguous()
    cA, cB1, cB2, *segs = deficit_coeffs(k, u1, u2)
    if ns > 1:
        q0, q1, q2, front = exposure_z2_poly(t, 0.0, P, aR, inc, e, w)
        offs, wgts = lc._gl_exposure_nodes(EXPTIME, ns)
    else:
        z, front = projected_z(t[None, :], 0.0, P[:, None], aR[:, None],
                               inc[:, None], e[:, None], w[:, None])
        q0 = z * z
        q1, q2 = torch.zeros_like(q0), torch.zeros_like(q0)
        offs, wgts = np.zeros(1, np.float32), np.ones(1, np.float32)
    args = (q0.contiguous(), q1.contiguous(), q2.contiguous(),
            front.float(), cA.contiguous(), cB1.contiguous(),
            cB2.contiguous(), torch.stack(segs, 1).contiguous(), g, obs)
    return args, tuple(map(float, offs)), tuple(map(float, wgts))


def _median_ms(torch, fn, reps=20):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_kernel(torch, chi2_core):
    """Kernel vs plain on the card. lnL = const - chi2 / (2 sigma^2), so
    the gates act on d = |chi2_kernel - chi2_plain| / (2 sigma^2):
    p99 < 0.05 and max < 1.0 (tests/test_pallas_core.py), identical finite
    masks, and lnZ of the two within 1e-2 nats. At n_t = 8055 most draws
    miss the curve by ~1e5 in lnL, where f32 summation order alone moves
    lnL by O(1); there the absolute gates apply to the draws within 50 of
    the best lnL (the ones that carry evidence weight) and a relative
    gate (p99 < 1e-3, max < 2e-2, tests/test_pallas_core.py::TestPallasEB)
    to all draws."""
    from triceratops_tpu_torch.core.numerics import log_mean_exp_torch
    from triceratops_tpu_torch.ops.lightcurve import draw_chunk

    def chunk(n_t, ns):
        return -(-draw_chunk(n_t, ns) // chi2_core.DRAW_TILE) \
            * chi2_core.DRAW_TILE

    shapes = [("slice", chunk(100, NSAMPLES), 100, NSAMPLES, 0.15),
              ("long", chunk(8055, NSAMPLES), 8055, NSAMPLES, 0.3),
              ("ns1", chunk(100, 1), 100, 1, 0.15)]
    out = {}
    for i, (name, C, n_t, ns, window) in enumerate(shapes):
        args, offs, wgts = _chunk_inputs(torch, C, n_t, ns, window, seed=i)
        kern = chi2_core.chi2_supersampled(*args, offs=offs, wgts=wgts)
        plain = chi2_core.chi2_supersampled_plain(*args, offs=offs,
                                                  wgts=wgts)
        torch.cuda.synchronize()
        inv = 1.0 / (2.0 * SIGMA_GATE ** 2)
        lnL_k = (-kern.double() * inv).cpu().numpy()
        lnL_p = (-plain.double() * inv).cpu().numpy()
        check(np.array_equal(np.isfinite(lnL_k), np.isfinite(lnL_p)),
              f"{name}: finite masks differ")
        d = np.abs(lnL_k - lnL_p)
        near = lnL_p > lnL_p.max() - 50.0 if name == "long" else slice(None)
        p99, dmax = float(np.quantile(d[near], 0.99)), float(d[near].max())
        check(p99 < 0.05 and dmax < 1.0,
              f"{name}: lnL diff p99 {p99} max {dmax}")
        if name == "long":
            rel = d / (np.abs(lnL_p) + 1.0)
            check(np.quantile(rel, 0.99) < 1e-3 and rel.max() < 2e-2,
                  f"{name}: relative lnL diff {np.quantile(rel, 0.99)}, "
                  f"{rel.max()}")
        dz = abs(float(log_mean_exp_torch(torch.as_tensor(lnL_k), C))
                 - float(log_mean_exp_torch(torch.as_tensor(lnL_p), C)))
        check(dz < 1e-2, f"{name}: lnZ differs by {dz}")
        ms = _median_ms(torch, lambda: chi2_core.chi2_supersampled(
            *args, offs=offs, wgts=wgts))
        plain_ms = _median_ms(torch, lambda: chi2_core.chi2_supersampled_plain(
            *args, offs=offs, wgts=wgts))
        print(f"phase 3: {name} C={C} n_t={n_t} nodes={len(offs)}: lnL diff "
              f"p99 {p99:.3g} max {dmax:.3g}, lnZ diff {dz:.3g}; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20)")
        out[name] = dict(max_abs_err=dmax, ms=ms, plain_ms=plain_ms)
    return out


def toi465_field():
    """A TOI-465-like target (bench.py's fixture: P = 3.18 d, 5.5 Re
    planet, ~100-point folded curve, sigma = 4e-4) plus two nearby stars
    faint enough that each needs a transit depth between 0 and 1."""
    import pandas as pd
    import torch
    from triceratops_tpu_torch.constants import G, MSUN, RSUN, REARTH
    from triceratops_tpu_torch.core.kepler import projected_z
    from triceratops_tpu_torch.ops.occult import occult_quad_deficit

    P, M_s, R_s, rp = 3.18, 1.09, 1.06, 5.5
    n_t = 100
    time_ = np.linspace(-0.15, 0.15, n_t)
    a = ((G * M_s * MSUN) / (4 * np.pi**2) * (P * 86400.0) ** 2) ** (1 / 3)
    c = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    z, front = projected_z(torch.as_tensor(time_), 0.0, c(P),
                           c(a / (R_s * RSUN)), c(np.deg2rad(89.0)), c(0.0),
                           c(0.0))
    D = occult_quad_deficit(c(rp * REARTH / (R_s * RSUN)), z, c(0.35),
                            c(0.25)) * front
    sigma = 4e-4
    rng = np.random.default_rng(42)
    flux = 1.0 - D.numpy() + rng.normal(0, sigma, n_t)
    rows = [dict(ID="465", Tmag=9.7, Jmag=8.9, Hmag=8.7, Kmag=8.6, ra=90.0,
                 dec=-60.0, mass=M_s, rad=R_s, Teff=5950.0, plx=11.0,
                 **{"sep (arcsec)": 0.0, "PA (E of N)": 0.0}),
            dict(ID="4651", Tmag=13.2, Jmag=12.4, Hmag=12.1, Kmag=12.0,
                 ra=90.001, dec=-60.001, mass=0.8, rad=0.8, Teff=5000.0,
                 plx=4.0, **{"sep (arcsec)": 25.0, "PA (E of N)": 45.0}),
            dict(ID="4652", Tmag=14.2, Jmag=13.3, Hmag=13.0, Kmag=12.9,
                 ra=89.999, dec=-60.002, mass=0.6, rad=0.6, Teff=4000.0,
                 plx=3.0, **{"sep (arcsec)": 35.0, "PA (E of N)": 135.0})]
    return pd.DataFrame(rows), time_, flux, sigma, P


def phase_slice(torch, chi2_core, tr):
    stars, time_, flux, sigma, P = toi465_field()
    t = tr.target.from_stars(stars, ID=465, sectors=[1])
    t.calc_depths(tdepth=0.0026)
    td = t.stars["tdepth"].values
    check(((td > 0) & (td <= 1)).all(), f"tdepths {td}: a star drops out")

    def run(seed, backend="auto"):
        t0 = time.perf_counter()
        t.calc_probs(time_, flux, sigma, P_orb=P, N=N_DRAWS,
                     nsamples=NSAMPLES, drop_scenario=UNPORTED, verbose=0,
                     key=seed, device="cuda", backend=backend)
        return time.perf_counter() - t0

    chi2_core.launches = 0
    wall0 = run(1)
    launches = chi2_core.launches
    lnZ, probs = t.lnZ.copy(), t.probs["prob"].to_numpy()
    print(f"phase 4: calc_probs N={N_DRAWS} nsamples={NSAMPLES}: "
          f"{wall0:.3f} s (first call), {launches} kernel launches, "
          f"FPP {t.FPP:.6g}, NFPP {t.NFPP:.6g}")
    print("phase 4: lnZ " + ", ".join(
        f"{s}={v:.4f}" for s, v in zip(t.probs["scenario"].values[LIVE_ROWS],
                                       lnZ[LIVE_ROWS])))
    check(launches > 0, "the kernel was not launched on the main path")
    check(np.isfinite(lnZ[LIVE_ROWS]).all(), f"non-finite lnZ {lnZ}")
    check(abs(probs.sum() - 1.0) < 1e-6, f"probabilities sum {probs.sum()}")
    check(0.0 <= t.FPP <= 1.0, f"FPP {t.FPP}")
    check(int(np.argmax(probs)) == 0, "TP is not the most probable row")

    chi2_core.launches = 0
    wall_plain = run(1, backend="torch")
    check(chi2_core.launches == 0, "the plain path launched the kernel")
    dz = np.abs(t.lnZ[LIVE_ROWS] - lnZ[LIVE_ROWS])
    print(f"phase 5: plain torch path (same seed) {wall_plain:.3f} s; "
          f"per-row |lnZ kernel - lnZ plain| max {dz.max():.3g}")
    check(dz.max() < 1e-2, f"kernel and plain lnZ differ: {dz}")

    walls = [run(seed) for seed in (2, 3, 4)]
    med = float(np.median(walls))
    print(f"phase 6: warm calc_probs walls {[round(w, 4) for w in walls]} s, "
          f"median {med:.4f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def main():
    try:
        import torch
        import triceratops_tpu_torch.triceratops as tr
        from triceratops_tpu_torch.ops import chi2_core
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              "repository root", file=sys.stderr)
        return 2
    try:
        phase_device(torch)
        build_s = phase_build(chi2_core)
        timing = phase_kernel(torch, chi2_core)
        launches = phase_slice(torch, chi2_core, tr)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    slice_t = timing["slice"]
    print(json.dumps({"kernels": [{
        "name": "chi2_supersampled", "route": "cuda",
        "source": "triceratops_tpu_torch/csrc/chi2_supersampled.cu",
        "replaces": "triceratops_tpu/ops/pallas_core.py:120",
        "launches": launches, "max_abs_err": slice_t["max_abs_err"],
        "ms": slice_t["ms"], "plain_ms": slice_t["plain_ms"],
        "build_s": build_s}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
