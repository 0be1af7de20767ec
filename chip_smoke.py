"""Smoke run of the PyTorch port (triceratops_tpu_torch) on one NVIDIA GPU.

Drives the port's main path once at full size and checks it:

  1. requires CUDA and prints the card's name and power limit;
  2. builds the chi^2 kernels (v2 and v3 schedules, each over z^2 planes
     and over the orbit; one source) from csrc/ with nvcc and prints the
     build time; then, with torch.set_float32_matmul_precision("high"),
     computes the tabulated deficit coefficients of 1e5 seeded draws
     across all eight k-segments on the card and holds them to the CPU
     path within 3e-6 (the coefficient products run in IEEE float32
     whatever the caller's setting), checks the setting came back, and
     that with the guard lifted the same call misses 3e-6;
  3. compares each of the four kernels with its plain torch version on the
     card at the main path's shape (n_t = 100, GL-4), at long-curve shapes
     (n_t = 8055 and the full n_t = 20099) and at ns = 1, and times them
     with CUDA events: the plane kernels at the old n_t-bound draw chunk,
     the orbit kernels at the main path's chunk (lightcurve.orbit_chunk)
     beside their yardstick, exposure_z2_poly plus the plane kernel on the
     same draws (on the long curves both at the old chunk, where the
     planes fit);
  4. runs target.from_stars -> calc_depths -> calc_probs(N = 1e6,
     nsamples = 20) on bench.py's configuration (a TOI-465-like target, a
     3000-star synthetic TRILEGAL field) plus two nearby stars: all 21
     rows, v2 schedule; checks the result and that only the v2 orbit
     kernel launched;
  5. reruns the same seed on the plain torch path and compares per-row
     lnZ; then reruns it on the kernel path under TF32
     (set_float32_matmul_precision("high")): per-row lnZ within 1e-2 of 4,
     and prints the same run's distance with the products' guard lifted;
  v3. reruns the same seed under the v3 schedule: only the v3 orbit kernel
     launched, per-row lnZ as in 4; then one warm v3 call;
  6. times three warm calc_probs calls with different seeds (v2);
  7. runs the four dormant nearby-star scenarios (lnZ_NTP_unknown and
     lnZ_NEB_unknown on the TRILEGAL lookalikes of a Tmag 13.2 star,
     lnZ_NTP_evolved and lnZ_NEB_evolved at R_s = 2.0) at N = 1e6 on v2,
     on the plain path and under v3, and the empty-population case; checks
     per-row lnZ across the paths and that only the schedule's orbit
     kernel launched;
  8. runs calc_probs_ensemble(n_runs = 3) of the 21-row call: 63 orbit
     launches, FPP the mean of the runs;
  9. runs likelihoods.simulate_TP_transit_p and lnL_EB_p over 1e5
     parameter rows on the card (float64) against the same call on the
     CPU for the first 256 rows;
 10. runs the multi-target batch path (parallel/sharding.batch_fpp_full)
     on 8 targets at N = 1e6: phase 4's target with its two nearby stars
     and seven one-star targets on curves synthesized from seeded (Rp, P)
     rows, 1.5-6 Re and 1-10 d (tools/catalog_replay._synth_lc): (i) in
     this process alone, cold and warm, checking the rows, that only the
     v2 orbit kernel launched and exactly once per computed row, and
     per-row lnZ against the same 8 targets through calc_probs by
     test_sharding.py's statistical rule; (ii) on a one-rank NCCL grid, identical to (i);
     (iii) on two gloo ranks sharing the card as a 1 x 2 draws grid, by
     the statistical rule against (i);
 11. holds the port's FPP, NFPP and per-row lnZ statistics over K = 16
     seeds at N = 1e6 to the JAX package's K-key record
     (parity/jax_ref.json, parity_ref.py) on its two fixtures, phase 4's
     21-row target and an 11.5 Re planet, by parity_port.py's gates;
     F1's TP and DTP rows against the JAX package's 100-key row record
     (parity/jax_rows.json).

Prints a JSON line with the four kernels' numbers, then as its last line
{"ok": true, "device": {...}}. Exits non-zero on any failure, without a
CUDA card, and outside a checkout of the repository.

Run from the repository root:  python3 chip_smoke.py
With --profile it also traces one warm calc_probs call on the kernel path
and one on the plain path with torch.profiler (device time, idle share,
kernel counts, the top device ops) before the JSON lines.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

import numpy as np

N_DRAWS = 1_000_000
NSAMPLES = 20
EXPTIME = 0.00139
SIGMA_GATE = 5e-4     # noise level of the kernel-comparison inputs
# H100 SXM peaks at the 700 W limit (NVIDIA data sheet): HBM3 bytes/s and
# FP32 (non-tensor) flop/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# FP32 flops (an FMA counts 2) of chi2_supersampled at one point and node:
# z^2 model 4, sqrt 2, segment map 4, sqrt map 4, 2x 1, 17 Clenshaw steps
# x 3, final step and clip 5, node weight 2; and per computed point the
# dilution and chi^2 update, 6
FLOPS_NODE_POINT = 73
FLOPS_POINT = 6
# The orbit source (csrc/chi2_supersampled.cu), one operation per + - * /
# and per sqrt, cbrt, sin, cos, atan2 or rint (so a floor: the IEEE
# functions take several instructions each): per point the Kepler solve
# (kepler_sc) 91 plus the Taylor z^2 model 73, or plus projected_z's 24 at
# ns = 1; per draw its constants and zmax, 38
FLOPS_KEPLER = 91
FLOPS_ORBIT_POINT = {True: FLOPS_KEPLER + 24, False: FLOPS_KEPLER + 73}
FLOPS_ORBIT_DRAW = 38
# device sleep queued before each timed call (~1 ms at the H100's clock)
LEAD_CYCLES = 2_000_000
# phase 7: the nearby star whose lookalikes the unknown-host rows draw, and
# the subgiant radius of the evolved rows
TMAG_LOOKALIKE = 13.2
R_EVOLVED = 2.0
# phase 9: parameter rows of the batch likelihoods, rows checked on the CPU
N_LIKELIHOOD_ROWS = 100_000
N_LIKELIHOOD_CHECK = 256
COUNTERS = ("launches", "launches_v3", "launches_orbit", "launches_orbit_v3")
# phase 10: targets in the batch, the seed of their (Rp, P) rows and the
# ranges they are drawn from [Re], [d]. At sigma = 4e-4 a planet of ~10 Re
# or more makes the companion and background rows needles whose lnZ
# scatters between seeds by more than the statistical rule's gate at 1e6
# draws, in both packages: at 11.5 Re (parity_ref.py's F2) STP has an s.d.
# of 2.54 nats over 20 keys of the JAX package on the CPU and 1.97 over 20
# seeds of the port on an H100 (parity/); up to 6 Re the rule holds
N_BATCH = 8
BATCH_SEED = 10
BATCH_RP = (1.5, 6.0)
BATCH_P = (1.0, 10.0)
# phase 10: the longest a grid's collective or its spawned ranks may take
GRID_TIMEOUT_S = 300
# phase 2: draws of the coefficient check under TF32, their seed, and the
# tolerance of the tabulated coefficients (tests/test_fastcore.py)
N_TF32_DRAWS = 100_000
TF32_SEED = 7
TAB_TOL = 3e-6
# phase 11: seeds per fixture against the JAX package's 20-key record
# (100 keys for F1's TP and DTP rows, parity/jax_rows.json). Against 20
# reference runs the s.d.-ratio gate rejects one estimator's samples with
# probability ~0.04-0.06 per row at 8 seeds and ~0.006-0.015 at 16
# (resamples of the 100 JAX keys, parity_port.py --rows), so over the
# seven gated rows a run of 8 seeds fails by chance about one time in
# four; the first 8 seeds fail it on F1's PTP row (PERF.md, Findings)
K_PARITY = 16


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
    print(f"phase 2: built {so.name} (chi2_supersampled, "
          f"chi2_supersampled_v3, chi2_from_orbit, chi2_from_orbit_v3) in "
          f"{dt:.2f} s")
    return dt


def phase_tf32_coeffs(torch):
    """Phase 2: cheb_deficit_coeffs_tab under TF32 on the card against the
    CPU path on 1e5 seeded (k, u1, u2) draws, k uniform within each of
    the table's eight k-segments: every output within TAB_TOL, and the
    caller's precision setting back after the call. As a control, the
    same call with the products' guard lifted must exceed TAB_TOL, so the
    check is known to see TF32."""
    import contextlib

    from triceratops_tpu_torch.ops import fastcore

    rng = np.random.default_rng(TF32_SEED)
    br = fastcore._TAB_BREAKS
    k = np.concatenate([rng.uniform(br[g], br[g + 1], N_TF32_DRAWS // 8)
                        for g in range(8)])
    u1 = rng.uniform(0.0, 0.8, k.size)
    u2 = np.minimum(rng.uniform(0.0, 0.4, k.size), 1.0 - u1)
    cpu = [torch.as_tensor(a, dtype=torch.float32) for a in (k, u1, u2)]
    want = fastcore.cheb_deficit_coeffs_tab(*cpu)

    def err(guard=None):
        saved = fastcore.full_precision_matmul
        if guard is not None:
            fastcore.full_precision_matmul = guard
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        try:
            got = fastcore.cheb_deficit_coeffs_tab(*(a.cuda() for a in cpu))
            torch.cuda.synchronize()
            kept = torch.get_float32_matmul_precision()
        finally:
            torch.set_float32_matmul_precision(prev)
            fastcore.full_precision_matmul = saved
        return max(float((g.cpu() - w).abs().max())
                   for g, w in zip(got, want)), kept

    e, kept = err()
    e_unguarded, _ = err(contextlib.nullcontext)
    print(f"phase 2: tab coefficients of {k.size} draws on the card under "
          f"TF32 (set_float32_matmul_precision('high')) vs the CPU: max "
          f"|d| {e:.3g} (gate {TAB_TOL}); setting after the call {kept!r}; "
          f"with the products' guard lifted {e_unguarded:.3g}")
    check(e < TAB_TOL, f"tab coefficients under TF32 differ by {e}")
    check(kept == "high", f"the caller's precision came back as {kept!r}")
    check(e_unguarded > TAB_TOL,
          f"with the guard lifted the coefficients differ by only "
          f"{e_unguarded}: TF32 did not engage, so the check saw nothing")
    return e


def _draws(torch, C, n_t, ns, window, seed):
    """One chunk of seeded draws (those of tests/test_pallas_core.py):
    the orbit (time, P, aR, inc, e, w), the rest of the kernels' inputs
    (cA, cB1, cB2, seg, g, obs_dev) from the port's coefficient stage, and
    the exposure nodes."""
    from triceratops_tpu_torch.ops import lightcurve as lc
    from triceratops_tpu_torch.ops.fastcore import deficit_coeffs

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
        offs, wgts = lc._gl_exposure_nodes(EXPTIME, ns)
    else:
        offs, wgts = np.zeros(1, np.float32), np.ones(1, np.float32)
    rest = (cA.contiguous(), cB1.contiguous(), cB2.contiguous(),
            torch.stack(segs, 1).contiguous(), g, obs)
    return ((t, P, aR, inc, e, w), rest, tuple(map(float, offs)),
            tuple(map(float, wgts)))


def _chunk_inputs(torch, chi2_core, C, n_t, ns, window, seed):
    """One chunk of (q0 ... obs_dev) for chi2_supersampled: the planes of
    the seeded draws' exposure z^2 model (chi2_core.orbit_planes)."""
    orbit, rest, offs, wgts = _draws(torch, C, n_t, ns, window, seed)
    return (*chi2_core.orbit_planes(*orbit, ns), *rest), offs, wgts


def _median_ms(torch, fn, reps=20):
    """Median device time of fn() between two CUDA events. Each timed call
    is queued behind ~1 ms of device sleep, so the host's wrapper time
    (checks, ctypes; ~0.05 ms) overlaps the sleep instead of showing as
    device time before a short kernel starts."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(LEAD_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _active_points(torch, q0, q1, q2, front, seg, offs):
    """Points in front with z < zmax at some node: the ones whose deficit
    is not ~0, which run the kernels' full per-node work."""
    zmax2 = (seg[:, 1] + 1.0 / seg[:, 4]) ** 2
    inside = torch.zeros_like(front, dtype=torch.bool)
    for d in offs:
        inside |= (q0 + q1 * d + q2 * (d * d)) < zmax2[:, None]
    return int((inside & (front > 0)).sum())


def _deficit_flops(n_active, n_points, S, n_t):
    """FP32 flops the plane kernels spend past reading their inputs: every
    point evaluates its z^2 model at the nodes to decide whether it is in
    transit; the points in transit run the full per-node work."""
    return (n_active * (S * FLOPS_NODE_POINT + FLOPS_POINT)
            + (n_points - n_active) * S * 4 + 2 * n_t)


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def chi2_bound(torch, args, offs):
    """(bound_ms, bound_by, active share): the least time the card could
    take for chi2_supersampled on these inputs. Bytes: each input read
    once, the output written once. Operations: the FP32 flops this data
    needs (_deficit_flops)."""
    q0, q1, q2, front, cA, cB1, cB2, seg, g, obs = args
    C, n_t = q0.shape
    nbytes = 4 * (sum(a.numel() for a in args) + C)
    n_active = _active_points(torch, q0, q1, q2, front, seg, offs)
    return (*_bound(nbytes, _deficit_flops(n_active, C * n_t, len(offs),
                                           n_t)), n_active / (C * n_t))


def orbit_bound(torch, chi2_core, orbit, rest, offs, ns):
    """(bound_ms, bound_by, active share) of chi2_from_orbit on these
    inputs. Bytes: time, obs, the six per-draw parameters (P, aR, inc, e,
    w, g) and 59 coefficients read once, the output written once.
    Operations: the orbit source's work at every point and draw
    (FLOPS_ORBIT_POINT, FLOPS_ORBIT_DRAW) plus the plane kernels' work on
    the same z^2 model, counted on planes made a draw slice at a time."""
    t, P, aR, inc, e, w = orbit
    seg = rest[3]
    C, n_t = P.shape[0], t.shape[0]
    nbytes = 4 * (sum(a.numel() for a in (*orbit, *rest)) + C)
    step = max(256, (1 << 24) // n_t)
    n_active = 0
    for i in range(0, C, step):
        s = slice(i, i + step)
        planes = chi2_core.orbit_planes(t, P[s], aR[s], inc[s], e[s], w[s],
                                        ns)
        n_active += _active_points(torch, *planes, seg[s], offs)
    flops = (C * n_t * FLOPS_ORBIT_POINT[ns == 1] + C * FLOPS_ORBIT_DRAW
             + _deficit_flops(n_active, C * n_t, len(offs), n_t))
    return (*_bound(nbytes, flops), n_active / (C * n_t))


def _gate(torch, name, kern, plain, C):
    """The kernel-vs-plain gates on lnL = const - chi2 / (2 sigma^2)."""
    from triceratops_tpu_torch.core.numerics import log_mean_exp_torch

    inv = 1.0 / (2.0 * SIGMA_GATE ** 2)
    lnL_k = (-kern.double() * inv).cpu().numpy()
    lnL_p = (-plain.double() * inv).cpu().numpy()
    check(np.array_equal(np.isfinite(lnL_k), np.isfinite(lnL_p)),
          f"{name}: finite masks differ")
    d = np.abs(lnL_k - lnL_p)
    long_curve = name.split()[0] in ("long", "full")
    near = lnL_p > lnL_p.max() - 50.0 if long_curve else slice(None)
    p99, dmax = float(np.quantile(d[near], 0.99)), float(d[near].max())
    check(p99 < 0.05 and dmax < 1.0, f"{name}: lnL diff p99 {p99} max {dmax}")
    if long_curve:
        rel = d / (np.abs(lnL_p) + 1.0)
        check(np.quantile(rel, 0.99) < 1e-3 and rel.max() < 2e-2,
              f"{name}: relative lnL diff {np.quantile(rel, 0.99)}, "
              f"{rel.max()}")
    dz = abs(float(log_mean_exp_torch(torch.as_tensor(lnL_k), C))
             - float(log_mean_exp_torch(torch.as_tensor(lnL_p), C)))
    check(dz < 1e-2, f"{name}: lnZ differs by {dz}")
    return p99, dmax, dz


def phase_kernel(torch, chi2_core):
    """Each kernel vs its plain version on the card. lnL = const - chi2 /
    (2 sigma^2), so the gates act on d = |chi2_kernel - chi2_plain| /
    (2 sigma^2): p99 < 0.05 and max < 1.0 (tests/test_pallas_core.py),
    identical finite masks, and lnZ of the two within 1e-2 nats. At
    n_t = 8055 and 20099 most draws miss the curve by ~1e5 in lnL, where
    f32 summation order alone moves lnL by O(1); there the absolute gates
    apply to the draws within 50 of the best lnL (the ones that carry
    evidence weight) and a relative gate (p99 < 1e-3, max < 2e-2,
    tests/test_pallas_core.py::TestPallasEB) to all draws.

    The plane kernels run at the chunk the n_t-bound draw_chunk gives
    (v2 rounds it to 256, v3 to 128). The orbit kernels are compared at
    the main path's chunk (orbit_chunk(1e6) = 1000192 draws) where the
    plain version's (C, n_t) planes fit (n_t = 100), and at the old chunk
    on the long curves; they are timed at the main path's chunk, and beside their
    yardstick (orbit_planes, i.e. exposure_z2_poly, plus the plane kernel
    of the same schedule) on the draws of the comparison."""
    from triceratops_tpu_torch.ops.lightcurve import draw_chunk, orbit_chunk

    def chunk(n_t, ns, tile):
        return -(-draw_chunk(n_t, ns) // tile) * tile

    c_main = orbit_chunk(N_DRAWS)
    shapes = [("slice", 100, NSAMPLES, 0.15), ("long", 8055, NSAMPLES, 0.3),
              ("full", 20099, NSAMPLES, 1.5), ("ns1", 100, 1, 0.15)]
    out = {}
    for i, (name, n_t, ns, window) in enumerate(shapes):
        C2 = chunk(n_t, ns, chi2_core.DRAW_TILE)
        C3 = chunk(n_t, ns, chi2_core.DRAW_LANES)
        args, offs, wgts = _chunk_inputs(torch, chi2_core, C2, n_t, ns,
                                         window, seed=i)
        # v3's chunk is the first C3 <= C2 draws of the same inputs
        args3 = tuple(a[:C3] for a in args[:9]) + (args[9],)
        row = {}
        for kname, C, a, fn in (
                ("chi2_supersampled", C2, args, chi2_core.chi2_supersampled),
                ("chi2_supersampled_v3", C3, args3,
                 chi2_core.chi2_supersampled_v3)):
            kern = fn(*a, offs=offs, wgts=wgts)
            plain = chi2_core.chi2_supersampled_plain(*a, offs=offs,
                                                      wgts=wgts)
            torch.cuda.synchronize()
            p99, dmax, dz = _gate(torch, f"{name} {kname}", kern, plain, C)
            if kname == "chi2_supersampled":
                ms = _median_ms(torch, lambda: fn(*a, offs=offs, wgts=wgts))
                extra = ""
                tr_ms = None
            else:
                planes = chi2_core.time_major(*a[:4])
                ms = _median_ms(torch, lambda: chi2_core.launch_v3(
                    planes, *a[4:], offs=offs, wgts=wgts))
                tr_ms = _median_ms(torch, lambda: chi2_core.time_major(
                    *a[:4]))
                extra = f", transpose {tr_ms:.4f} ms"
            plain_ms = _median_ms(
                torch, lambda: chi2_core.chi2_supersampled_plain(
                    *a, offs=offs, wgts=wgts), reps=5)
            bound_ms, bound_by, share = chi2_bound(torch, a, offs)
            print(f"phase 3: {name} {kname} C={C} n_t={n_t} "
                  f"nodes={len(offs)}: lnL diff p99 {p99:.3g} max "
                  f"{dmax:.3g}, lnZ diff {dz:.3g}; kernel {ms:.4f} ms"
                  f"{extra}, plain {plain_ms:.4f} ms (medians); bound "
                  f"{bound_ms:.4f} ms ({bound_by}, {share:.4f} of points "
                  f"in transit)")
            row[kname] = dict(max_abs_err=dmax, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              transpose_ms=tr_ms)
        del args, args3, planes
        row.update(_orbit_shape(torch, chi2_core, name, n_t, ns, window, i,
                                c_main if n_t <= 1000 else C2, c_main))
        out[name] = row
    return out


def _orbit_shape(torch, chi2_core, name, n_t, ns, window, seed, C_cmp,
                 C_main):
    """Both orbit kernels at one shape: the gates against the plain version
    and the yardstick at C_cmp draws, the time and bound at C_main."""
    orbit, rest, offs, wgts = _draws(torch, C_cmp, n_t, ns, window, seed)
    kw = dict(offs=offs, wgts=wgts, ns=ns)
    plain = chi2_core.chi2_from_orbit_plain(*orbit, *rest, **kw)
    plain_ms = _median_ms(torch, lambda: chi2_core.chi2_from_orbit_plain(
        *orbit, *rest, **kw), reps=5)
    if C_main != C_cmp:
        main = _draws(torch, C_main, n_t, ns, window, seed)[:2]
    else:
        main = orbit, rest
    bound_ms, bound_by, share = orbit_bound(torch, chi2_core, *main, offs,
                                            ns)
    row = {}
    for kname, plane_fn in (("chi2_from_orbit", chi2_core.chi2_supersampled),
                            ("chi2_from_orbit_v3",
                             chi2_core.chi2_supersampled_v3)):
        fn = getattr(chi2_core, kname)
        kern = fn(*orbit, *rest, **kw)
        torch.cuda.synchronize()
        p99, dmax, dz = _gate(torch, f"{name} {kname}", kern, plain, C_cmp)
        cmp_ms = _median_ms(torch, lambda: fn(*orbit, *rest, **kw))
        yard_ms = _median_ms(torch, lambda: plane_fn(
            *chi2_core.orbit_planes(*orbit, ns), *rest, offs=offs,
            wgts=wgts))
        ms = (cmp_ms if C_main == C_cmp
              else _median_ms(torch, lambda: fn(*main[0], *main[1], **kw)))
        print(f"phase 3: {name} {kname} n_t={n_t} nodes={len(offs)}: at "
              f"C={C_cmp} lnL diff p99 {p99:.3g} max {dmax:.3g}, lnZ diff "
              f"{dz:.3g}; kernel {cmp_ms:.4f} ms, yardstick (planes + "
              f"plane kernel) {yard_ms:.4f} ms, plain {plain_ms:.4f} ms; at "
              f"C={C_main} kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}, {share:.4f} of points in transit) (medians)")
        row[kname] = dict(max_abs_err=dmax, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          yardstick_ms=yard_ms, cmp_ms=cmp_ms, C=C_main,
                          C_cmp=C_cmp)
    return row


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


def make_run(tr, workdir):
    """bench.py's configuration plus two nearby stars, built once; returns
    the target and run(seed, backend="auto"), one calc_probs call on the
    card and its wall in s (host clock; the call ends in a device-to-host
    copy)."""
    from triceratops_tpu_torch.populations.synthetic import (
        make_synthetic_trilegal)

    stars, time_, flux, sigma, P = toi465_field()
    tri = make_synthetic_trilegal(f"{workdir}/trilegal.csv", Tmag_target=9.7,
                                  n_stars=3000, seed=42)
    t = tr.target.from_stars(stars, ID=465, sectors=[1], trilegal_fname=tri)
    t.calc_depths(tdepth=0.0026)
    td = t.stars["tdepth"].values
    check(((td > 0) & (td <= 1)).all(), f"tdepths {td}: a star drops out")

    def run(seed, backend="auto"):
        t0 = time.perf_counter()
        t.calc_probs(time_, flux, sigma, P_orb=P, N=N_DRAWS,
                     nsamples=NSAMPLES, verbose=0, key=seed, device="cuda",
                     backend=backend)
        return time.perf_counter() - t0

    return t, run


def _counts(chi2_core):
    return {n: getattr(chi2_core, n) for n in COUNTERS}


def _reset(chi2_core):
    for n in COUNTERS:
        setattr(chi2_core, n, 0)


def _only(c, name):
    """name rose, every other counter stayed at 0."""
    return c[name] > 0 and all(v == 0 for n, v in c.items() if n != name)


def phase_slice(torch, chi2_core, tr, workdir):
    """Phases 4, 5, v3 and 6 on bench.py's configuration plus two nearby
    stars. Returns each kernel's launches in its path's run (v2 or v3),
    run and the target."""
    import contextlib

    from triceratops_tpu_torch.ops import fastcore, lightcurve

    t, run = make_run(tr, workdir)
    _reset(chi2_core)
    wall0 = run(1)
    main_counts = _counts(chi2_core)
    lnZ, probs = t.lnZ.copy(), t.probs["prob"].to_numpy()
    names = t.probs["scenario"].values
    print(f"phase 4: calc_probs N={N_DRAWS} nsamples={NSAMPLES}, "
          f"{len(lnZ)} rows: {wall0:.3f} s (first call), launches "
          f"{main_counts}; FPP {t.FPP:.6g}, NFPP {t.NFPP:.6g}")
    print("phase 4: lnZ " + ", ".join(
        f"{n}={v:.4f}" for n, v in zip(names, lnZ)))
    check(_only(main_counts, "launches_orbit"),
          f"the main path must launch only the v2 orbit kernel: "
          f"{main_counts}")
    check(len(lnZ) == 21, f"{len(lnZ)} rows, expected 21")
    check(np.isfinite(lnZ).all(), f"non-finite lnZ {lnZ}")
    check(abs(probs.sum() - 1.0) < 1e-6, f"probabilities sum {probs.sum()}")
    check(0.0 <= t.FPP <= 1.0 and 0.0 <= t.NFPP <= 1.0,
          f"FPP {t.FPP}, NFPP {t.NFPP}")
    check(int(np.argmax(probs)) == 0,
          f"TP is not the most probable row: {names[np.argmax(probs)]}")

    _reset(chi2_core)
    wall_plain = run(1, backend="torch")
    check(not any(_counts(chi2_core).values()),
          "the plain path launched a kernel")
    dz = np.abs(t.lnZ - lnZ)
    print(f"phase 5: plain torch path (same seed, N={N_DRAWS}) "
          f"{wall_plain:.3f} s; per-row |lnZ kernel - lnZ plain| max "
          f"{dz.max():.3g}")
    check(dz.max() < 1e-2, f"kernel and plain lnZ differ: {dz}")

    def run_tf32(guard=None):
        """run(1) under TF32, with the products' guard replaced by
        ``guard`` when given; per-row |lnZ - phase 4's|."""
        saved = (fastcore.full_precision_matmul,
                 lightcurve.full_precision_matmul)
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        if guard is not None:
            fastcore.full_precision_matmul = guard
            lightcurve.full_precision_matmul = guard
        try:
            wall = run(1)
        finally:
            torch.set_float32_matmul_precision(prev)
            (fastcore.full_precision_matmul,
             lightcurve.full_precision_matmul) = saved
        return wall, np.abs(t.lnZ - lnZ)

    wall_tf32, dz_tf32 = run_tf32()
    _, dz_lifted = run_tf32(contextlib.nullcontext)
    print(f"phase 5: same seed on the kernel path under TF32 "
          f"{wall_tf32:.3f} s; per-row |lnZ TF32 - lnZ| max "
          f"{dz_tf32.max():.3g}; with the products' guard lifted (not "
          f"gated) {dz_lifted.max():.3g}")
    check(dz_tf32.max() < 1e-2, f"lnZ under TF32 differs: {dz_tf32}")

    lightcurve.CHI2_SCHEDULE = "3"
    try:
        _reset(chi2_core)
        wall_v3 = run(1)
        v3_counts = _counts(chi2_core)
        dz3 = np.abs(t.lnZ - lnZ)
        wall_v3_warm = run(5)
    finally:
        lightcurve.CHI2_SCHEDULE = "2"
    print(f"phase v3: same seed under the v3 schedule {wall_v3:.3f} s, "
          f"warm (seed 5) {wall_v3_warm:.4f} s; launches {v3_counts}; "
          f"per-row |lnZ v3 - lnZ v2| max {dz3.max():.3g}")
    check(_only(v3_counts, "launches_orbit_v3"),
          f"the v3 schedule must launch only the v3 orbit kernel: "
          f"{v3_counts}")
    check(dz3.max() < 1e-2, f"v3 and v2 lnZ differ: {dz3}")

    torch.cuda.reset_peak_memory_stats()
    walls = [run(seed) for seed in (2, 3, 4)]
    med = float(np.median(walls))
    print(f"phase 6: warm calc_probs walls {walls} s, median {med:.4f} s; "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    # each kernel's launches in its own path's run: the plane kernels are
    # on neither path
    return dict(chi2_supersampled=main_counts["launches"],
                chi2_supersampled_v3=v3_counts["launches_v3"],
                chi2_from_orbit=main_counts["launches_orbit"],
                chi2_from_orbit_v3=v3_counts["launches_orbit_v3"]), run, t, med


def _lnz_rows(res):
    """Per-row lnZ of a scenario result: one dict, or (res, res_twin)."""
    rows = (res,) if isinstance(res, dict) else res
    return np.array([float(r["lnZ"]) for r in rows])


def phase_dormant(torch, chi2_core, workdir):
    """Phase 7: the four dormant scenarios on the TOI-465-like curve at
    N = 1e6, each with one seed on v2, on the plain path and under v3.
    Gates per row: |lnZ kernel - lnZ plain| and |lnZ v3 - lnZ v2| < 1e-2,
    only the schedule's orbit counter rose, the plain path launched
    nothing, and every lnZ finite but one: with R_s = 2.0 the logg = 3
    host weighs 0.146 Msun, every EB draw's flux ratio exceeds 1.5 sigma
    and the secondary veto empties NEB_evolved's normal row (as in the
    JAX package, tests/test_torch_dormant.py), which must then be -inf on
    all three paths; so NEB_evolved also runs at sigma = 3e-2, where the
    veto keeps draws. An empty lookalike population (Tmag = -5) returns
    lnZ = -inf and launches nothing. Prints each function's warm wall on
    v2 (a second seed, host clock, ends in a device-to-host copy)."""
    from triceratops_tpu_torch.ops import lightcurve
    from triceratops_tpu_torch.scenarios import api

    _, time_, flux, sigma, P = toi465_field()
    tri = f"{workdir}/trilegal.csv"
    _, n_pos = api._prep_lookalikes(tri, TMAG_LOOKALIKE, "TESS", "cuda")
    print(f"phase 7: {n_pos} TRILEGAL lookalikes of a Tmag "
          f"{TMAG_LOOKALIKE} star (N_pos)")
    check(n_pos > 0, "the lookalike population is empty")
    kw = dict(N=N_DRAWS, nsamples=NSAMPLES, device="cuda")
    calls = (
        ("NTP_unknown", api.lnZ_NTP_unknown,
         (time_, flux, sigma, P, TMAG_LOOKALIKE, tri)),
        ("NEB_unknown", api.lnZ_NEB_unknown,
         (time_, flux, sigma, P, TMAG_LOOKALIKE, tri)),
        ("NTP_evolved", api.lnZ_NTP_evolved,
         (time_, flux, sigma, P, R_EVOLVED, 5200.0, 0.0)),
        ("NEB_evolved", api.lnZ_NEB_evolved,
         (time_, flux, sigma, P, R_EVOLVED, 5200.0, 0.0)),
        ("NEB_evolved sigma=3e-2", api.lnZ_NEB_evolved,
         (time_, flux, 3e-2, P, R_EVOLVED, 5200.0, 0.0)))

    def gen(seed):
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        return g

    walls = {}
    for name, fn, args in calls:
        _reset(chi2_core)
        lz = _lnz_rows(fn(*args, gen=gen(1), **kw))
        c2 = _counts(chi2_core)
        _reset(chi2_core)
        lz_plain = _lnz_rows(fn(*args, gen=gen(1), backend="torch", **kw))
        c_plain = _counts(chi2_core)
        lightcurve.CHI2_SCHEDULE = "3"
        try:
            _reset(chi2_core)
            lz3 = _lnz_rows(fn(*args, gen=gen(1), **kw))
            c3 = _counts(chi2_core)
        finally:
            lightcurve.CHI2_SCHEDULE = "2"
        t0 = time.perf_counter()
        _lnz_rows(fn(*args, gen=gen(2), **kw))
        walls[name] = time.perf_counter() - t0
        vetoed = np.zeros(len(lz), bool)
        if name == "NEB_evolved":
            vetoed[0] = True
        d_plain = np.abs(lz[~vetoed] - lz_plain[~vetoed])
        d3 = np.abs(lz3[~vetoed] - lz[~vetoed])
        print(f"phase 7: {name}: lnZ {lz.tolist()} (v2), plain "
              f"{lz_plain.tolist()}, v3 {lz3.tolist()}; launches v2 {c2}, "
              f"v3 {c3}; warm wall {walls[name]:.4f} s")
        check(np.isfinite(lz[~vetoed]).all(), f"{name}: non-finite lnZ {lz}")
        for other in (lz_plain, lz3):
            check(np.isneginf(other[vetoed]).all()
                  and np.isneginf(lz[vetoed]).all(),
                  f"{name}: the vetoed row is not -inf on every path")
        check(d_plain.max() < 1e-2, f"{name}: kernel and plain lnZ differ "
              f"by {d_plain}")
        check(d3.max() < 1e-2, f"{name}: v3 and v2 lnZ differ by {d3}")
        check(_only(c2, "launches_orbit"),
              f"{name}: v2 must launch only the v2 orbit kernel: {c2}")
        check(_only(c3, "launches_orbit_v3"),
              f"{name}: v3 must launch only the v3 orbit kernel: {c3}")
        check(not any(c_plain.values()),
              f"{name}: the plain path launched a kernel: {c_plain}")
    _reset(chi2_core)
    for fn in (api.lnZ_NTP_unknown, api.lnZ_NEB_unknown):
        res = fn(time_, flux, sigma, P, -5.0, tri, gen=gen(1), **kw)
        check(isinstance(res, dict) and np.isneginf(res["lnZ"]),
              f"empty population: {res}")
    check(not any(_counts(chi2_core).values()),
          f"the empty population launched a kernel: {_counts(chi2_core)}")
    print("phase 7: empty lookalike population (Tmag -5): lnZ = -inf, no "
          "launch")
    return walls


def phase_ensemble(chi2_core, t):
    """Phase 8: calc_probs_ensemble(n_runs = 3) of the 21-row call on v2:
    21 orbit launches per run, FPP the mean of the runs."""
    _, time_, flux, sigma, P = toi465_field()
    _reset(chi2_core)
    t0 = time.perf_counter()
    t.calc_probs_ensemble(time_, flux, sigma, P, n_runs=3, key=11,
                          N=N_DRAWS, nsamples=NSAMPLES, verbose=0,
                          device="cuda")
    wall = time.perf_counter() - t0
    c = _counts(chi2_core)
    print(f"phase 8: calc_probs_ensemble n_runs=3: {wall:.4f} s; FPP "
          f"{t.FPP:.6g} +- {t.FPP_std:.3g} (runs {t.FPP_runs.tolist()}), "
          f"NFPP {t.NFPP:.6g}; launches {c}")
    check(t.FPP == float(t.FPP_runs.mean()), "FPP is not the runs' mean")
    check(np.isfinite(t.FPP_std), f"FPP_std {t.FPP_std}")
    check(_only(c, "launches_orbit") and c["launches_orbit"] == 63,
          f"the ensemble must make 63 v2 orbit launches: {c}")
    return wall


def _likelihood_rows(n, seed=0):
    """n TP parameter rows and n EB parameter rows about the TOI-465-like
    target (the inputs of tests/test_torch_likelihoods.py, widened)."""
    from triceratops_tpu_torch.constants import G, MSUN

    rng = np.random.default_rng(seed)
    R_s = rng.uniform(0.7, 1.4, n)
    M = rng.uniform(0.6, 1.5, n)
    P = rng.uniform(2.5, 4.0, n)
    common = dict(
        P_orb=P, inc=rng.uniform(86.5, 90.0, n),
        a=((G * M * MSUN) / (4 * np.pi**2) * (P * 86400) ** 2) ** (1 / 3),
        R_s=R_s, u1=rng.uniform(0.2, 0.5, n), u2=rng.uniform(0.1, 0.3, n),
        ecc=rng.uniform(0.0, 0.5, n), argp=rng.uniform(0.0, 360.0, n),
        companion_fluxratio=rng.uniform(0.0, 0.6, n))
    tp = [rng.uniform(1.0, 16.0, n)] + list(common.values())
    eb = ([R_s * rng.uniform(0.1, 1.0, n), 10 ** rng.uniform(-5, -0.5, n)]
          + list(common.values()))
    return tp, eb


def phase_likelihoods(torch):
    """Phase 9: simulate_TP_transit_p and lnL_EB_p over 1e5 parameter rows
    on the card (float64, the 100-point curve, nsamples = 20) against the
    same call on the CPU for the first 256 rows: flux within 1e-9, lnL
    within 1e-8 relative with the same veto pattern. Prints the card's
    time (host clock, numpy in and out)."""
    from triceratops_tpu_torch import likelihoods as lk

    _, time_, flux, sigma, _ = toi465_field()
    tp, eb = _likelihood_rows(N_LIKELIHOOD_ROWS)
    m = N_LIKELIHOOD_CHECK
    kw = dict(nsamples=NSAMPLES)
    lk.simulate_TP_transit_p(time_, *(a[:m] for a in tp), device="cuda",
                             **kw)       # first call: CUDA context warm-up
    out = {}
    for name, fn, args, pre in (
            ("simulate_TP_transit_p", lk.simulate_TP_transit_p, tp, ()),
            ("lnL_EB_p", lk.lnL_EB_p, eb, (flux, sigma))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(time_, *pre, *args, device="cuda", **kw)
        ms = 1e3 * (time.perf_counter() - t0)
        want = fn(time_, *pre, *(a[:m] for a in args), device="cpu", **kw)
        head = got[:m]
        if name == "lnL_EB_p":
            check(np.array_equal(np.isinf(head), np.isinf(want)),
                  f"{name}: veto patterns differ")
            fin = np.isfinite(want)
            err = float(np.max(np.abs(head[fin] - want[fin])
                               / np.abs(want[fin]), initial=0.0))
            check(err < 1e-8 and fin.any() and (~fin).any(),
                  f"{name}: lnL relative error {err}, "
                  f"{int(fin.sum())} of {m} rows finite")
            extra = (f", {int(np.isinf(got).sum())} of "
                     f"{N_LIKELIHOOD_ROWS} rows vetoed")
        else:
            err = float(np.max(np.abs(head - want)))
            check(err < 1e-9, f"{name}: flux error {err}")
            extra = ""
        check(np.all(~np.isnan(got)), f"{name}: NaN in the card's output")
        print(f"phase 9: {name} over {N_LIKELIHOOD_ROWS} rows x "
              f"{len(time_)} points x {NSAMPLES} samples on the card: "
              f"{ms:.1f} ms; max error vs CPU on {m} rows {err:.3g}{extra}")
        out[name] = ms
    return out


def _stat_rule(a, b, names):
    """test_sharding.py's per-row rule between two independent runs: within
    1.2 nats (2 for twins, 3 for SEBx2P), or more than 5 nats below the
    winner in both (needle order statistics whose probability weight is
    below e^-5), or -inf in both. Returns the rows that break it, each
    with both values, and the largest |a - b| over the rows the gate
    binds (within 5 nats of a winner)."""
    names = np.asarray(names)
    twin = np.char.endswith(names, "x2P")
    gate = np.where(names == "SEBx2P", 3.0, np.where(twin, 2.0, 1.2))
    both_inf = np.isneginf(a) & np.isneginf(b)
    with np.errstate(invalid="ignore"):
        d = np.where(both_inf, 0.0, np.abs(a - b))
    deep = (a < np.max(a) - 5.0) & (b < np.max(b) - 5.0)
    bad = ~((d < gate) | deep | both_inf)
    live = ~deep & ~both_inf
    return ([f"{n}: {x:.3f} vs {y:.3f}" for n, x, y in
             zip(names[bad], a[bad], b[bad])],
            float(np.max(d[live], initial=0.0)))


def _row_names(n_rows):
    from triceratops_tpu_torch.parallel.sharding import FULL_SCENARIOS

    return list(FULL_SCENARIOS) + ["NTP", "NEB", "NEBx2P"] * (
        (n_rows - 15) // 3)


def _batch_rank(rank, store, entries, out_dir):
    """One of the two gloo ranks of phase 10 (iii), on cuda:0: the batch
    over a 1 x 2 draws grid; rank r writes its results, wall and kernel
    launches to out_dir."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist
    from triceratops_tpu_torch.ops import chi2_core
    from triceratops_tpu_torch.parallel import sharding

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=2, rank=rank,
                            timeout=timedelta(seconds=GRID_TIMEOUT_S))
    try:
        mesh = sharding.make_mesh(2, n_target_shards=1)
        batch, n_t, has_cc = sharding.prepare_target_batch(entries,
                                                           device="cuda:0")
        _reset(chi2_core)
        t0 = time.perf_counter()
        fpp, nfpp, lnZ = sharding.batch_fpp_full(
            mesh, batch, N=N_DRAWS, n_t=n_t, ns=NSAMPLES, has_cc=has_cc,
            device="cuda:0")
        wall = time.perf_counter() - t0
        np.savez(os.path.join(out_dir, f"gloo_rank{rank}.npz"), fpp=fpp,
                 nfpp=nfpp, lnZ=lnZ, wall=wall,
                 launches=json.dumps(_counts(chi2_core)))
    finally:
        dist.destroy_process_group()


def phase_batch(torch, chi2_core, t465, workdir, warm_median):
    """Phase 10: batch_fpp_full over 8 targets at N = 1e6 (ns = 20, n_t =
    100, sigma = 4e-4, the 3000-star field): phase 4's target with its two
    nearby stars, and seven one-star targets from seeded (Rp, P) rows
    (BATCH_RP, BATCH_P) through tools/catalog_replay.build_target. Each
    run must launch the v2 orbit kernel exactly once per computed row (15
    per target plus 3 per nearby star) and nothing else. Returns the warm
    run's launches."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from triceratops_tpu_torch.parallel import sharding
    from triceratops_tpu_torch.tools import catalog_replay

    _, time_, flux, sigma, P = toi465_field()
    cases = [(t465, time_, flux, sigma, P)]
    rng = np.random.default_rng(BATCH_SEED)
    for i in range(1, N_BATCH):
        row = {"TOI": 9000.01 + i, "TICID": 900000 + i,
               "Rp": rng.uniform(*BATCH_RP), "Porb": rng.uniform(*BATCH_P)}
        cases.append(catalog_replay.build_target(
            row, f"{workdir}/trilegal.csv", device="cuda"))
    entries = [sharding.target_entry(*c, key=100 + i)
               for i, c in enumerate(cases)]
    batch, n_t, has_cc = sharding.prepare_target_batch(entries, device="cuda")
    expected = sum(15 + 3 * len(e["nearby"]) for e in entries)
    kw = dict(N=N_DRAWS, n_t=n_t, ns=NSAMPLES, has_cc=has_cc, device="cuda")

    def timed(mesh):
        _reset(chi2_core)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sharding.batch_fpp_full(mesh, batch, **kw)
        return out, time.perf_counter() - t0, _counts(chi2_core)

    def launches_ok(c, what):
        check(_only(c, "launches_orbit") and c["launches_orbit"] == expected,
              f"{what}: expected {expected} v2 orbit launches only, got {c}")

    cold, wall_cold, c_cold = timed(None)
    warm, wall_warm, c_warm = timed(None)
    launches_ok(c_cold, "phase 10 (i) cold")
    launches_ok(c_warm, "phase 10 (i) warm")
    fpp, nfpp, lnZ = warm
    names = _row_names(lnZ.shape[1])
    valid = np.zeros(lnZ.shape, bool)
    for i, e in enumerate(entries):
        valid[i, :15 + 3 * len(e["nearby"])] = True
    check(np.isfinite(lnZ[valid]).all(), f"non-finite batch lnZ {lnZ}")
    check(np.isneginf(lnZ[~valid]).all(), "a padding nearby slot is finite")
    check(np.all((fpp >= 0) & (fpp <= 1) & (nfpp >= 0) & (nfpp <= 1)),
          f"FPP {fpp}, NFPP {nfpp}")
    rerun = float(np.max(np.abs(cold[2][valid] - lnZ[valid])))
    print(f"phase 10 (i): batch_fpp_full, {N_BATCH} targets x N={N_DRAWS}, "
          f"mesh=None: cold {wall_cold:.4f} s, warm {wall_warm:.4f} s = "
          f"{wall_warm / N_BATCH:.4f} s/target (phase 6 warm median "
          f"{warm_median:.4f} s per 21-row call); {c_warm['launches_orbit']} "
          f"orbit launches per call (expected {expected}); cold vs warm "
          f"max |d lnZ| {rerun:.3g}")
    print("phase 10 (i): FPP " + ", ".join(f"{v:.4g}" for v in fpp)
          + "; NFPP " + ", ".join(f"{v:.4g}" for v in nfpp))

    walls, worst = [], 0.0
    for i, (t, tm, fl, sg, Pp) in enumerate(cases):
        t0 = time.perf_counter()
        t.calc_probs(tm, fl, sg, P_orb=Pp, N=N_DRAWS, nsamples=NSAMPLES,
                     verbose=0, key=200 + i, device="cuda")
        walls.append(time.perf_counter() - t0)
        n = len(t.lnZ)
        bad, d = _stat_rule(lnZ[i, :n], t.lnZ, names[:n])
        check(not bad, f"phase 10 (i) target {i}, batch vs calc_probs: "
              f"{bad}")
        worst = max(worst, d)
    print(f"phase 10 (i): the same targets through calc_probs "
          f"{sum(walls):.4f} s = {sum(walls) / N_BATCH:.4f} s/target (warm); "
          f"per-row lnZ within the statistical rule, largest |d| within 5 "
          f"nats of the winner {worst:.3g}")

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{workdir}/nccl",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=GRID_TIMEOUT_S))
    try:
        mesh = sharding.make_mesh()
        nccl, wall_nccl, c_nccl = timed(mesh)
    finally:
        dist.destroy_process_group()
    launches_ok(c_nccl, "phase 10 (ii)")
    same = all(np.array_equal(a, b) for a, b in zip(nccl, warm))
    print(f"phase 10 (ii): one-rank NCCL grid {dict(mesh.shape)}: "
          f"{wall_nccl:.4f} s; identical to (i): {same}")
    check(same, "the one-rank NCCL grid differs from mesh=None")

    t0 = time.perf_counter()
    ranks = mp.spawn(_batch_rank, args=(f"{workdir}/gloo", entries, workdir),
                     nprocs=2, join=False)
    while not ranks.join(timeout=5):
        if time.perf_counter() - t0 > GRID_TIMEOUT_S:
            for p in ranks.processes:
                p.kill()
            raise SmokeFailure(f"the gloo ranks did not finish in "
                               f"{GRID_TIMEOUT_S} s")
    wall_spawn = time.perf_counter() - t0
    ranks = [np.load(os.path.join(workdir, f"gloo_rank{r}.npz"))
             for r in range(2)]
    for r in ranks:
        launches_ok(json.loads(str(r["launches"])), "phase 10 (iii) rank")
    check(all(np.array_equal(ranks[0][k], ranks[1][k])
              for k in ("fpp", "nfpp", "lnZ")),
          "the two gloo ranks returned different batches")
    lnZ2 = ranks[0]["lnZ"]
    worst = 0.0
    for i in range(N_BATCH):
        bad, d = _stat_rule(lnZ2[i], lnZ[i], names)
        check(not bad, f"phase 10 (iii) target {i}, 1 x 2 grid vs (i): "
              f"{bad}")
        worst = max(worst, d)
    print(f"phase 10 (iii): two gloo ranks on cuda:0, draws grid 1 x 2 "
          f"(N_local = {N_DRAWS // 2}): batch call {float(ranks[0]['wall']):.4f}"
          f" / {float(ranks[1]['wall']):.4f} s (first call in each rank), "
          f"{wall_spawn:.1f} s with process start; per rank "
          f"{expected} orbit launches; per-row lnZ within the statistical "
          f"rule of (i), largest |d| within 5 nats of the winner "
          f"{worst:.3g}")
    return c_warm["launches_orbit"]


def phase_parity():
    """Phase 11: parity_port.check over K_PARITY seeds per fixture against
    the JAX package's committed record, no plain-rejection runs; fails on
    any gate. Returns its wall (s, host clock)."""
    import parity_port

    t0 = time.perf_counter()
    summary, ok = parity_port.check(K=K_PARITY, K_plain=0, verbose=False)
    wall = time.perf_counter() - t0
    for line in summary["table"].splitlines():
        print(f"phase 11: {line}")
    fails = [f"{name}: {f}" for name, r in summary["gates"].items()
             for f in r["failures"]]
    for name, r in summary["gates"].items():
        floors = [k for k in ("FPP", "NFPP") if r[k]["floor"]]
        if floors:
            print(f"phase 11: {name}: {', '.join(floors)} below 1e-2 on "
                  f"both sides: limit floored at 1e-3")
    longer = [f"{name} {r['row']} ({r['K_ref']} keys)"
              for name, g in summary["gates"].items() for r in g["rows"]
              if r["K_ref"] != g["K_ref"]]
    print(f"phase 11: K = {K_PARITY} port seeds per fixture vs the JAX "
          f"record's K = {summary['gates']['F1']['K_ref']}"
          f"{' (' + ', '.join(longer) + ')' if longer else ''} (jax "
          f"{summary['ref_jax_version']}, {summary['ref_cpu']}): "
          f"{wall:.1f} s; {'all gates pass' if ok else fails}")
    check(ok, f"phase 11 parity gates: {fails}")
    return wall


def phase_profile(torch, run, backends=("auto", "torch")):
    """One warm call per path under torch.profiler (CPU + CUDA), beside an
    unprofiled warm call of the same path: the kernel launches of the
    profiled call, device time (the summed durations of the device events:
    kernels, copies and sets, each once), the device's idle share against
    the unprofiled wall, the count of device events ("CUDA kernels"), host
    self time, the top kernels and the torch ops that launch the most
    device time, and the top host ops. Host ranges mark the likelihood
    cores (api.lnL_planet / lnL_eb, whole chunk loops) and the per-chunk
    coefficient stage inside them (lightcurve.deficit_coeffs)."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from triceratops_tpu_torch.ops import chi2_core, lightcurve
    from triceratops_tpu_torch.scenarios import api

    def ranged(name, fn):
        def inner(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return inner

    def launch_counts():
        return {n: v for n, v in vars(chi2_core).items()
                if n.startswith("launches")}

    marks = [(lightcurve, "deficit_coeffs", "range: deficit_coeffs"),
             (api, "lnL_planet", "range: lnL core"),
             (api, "lnL_eb", "range: lnL core")]
    for backend in backends:
        wall = run(6, backend)
        saved = [getattr(m, n) for m, n, _ in marks]
        for m, n, label in marks:
            setattr(m, n, ranged(label, getattr(m, n)))
        before = launch_counts()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall_prof = run(6, backend)
        finally:
            for (m, n, _), f in zip(marks, saved):
                setattr(m, n, f)
        launched = {n: v - before[n] for n, v in launch_counts().items()}
        # a kernel is also in its launching op's self device time, and a
        # range's device-side span covers its kernels: count device events
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("range: ")]
        device_ms = sum(e.device_time_total for e in dev) / 1e3
        per_kernel, calls = Counter(), Counter()
        for e in dev:
            per_kernel[e.name] += e.device_time_total
            calls[e.name] += 1
        ka = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CPU]
        host_ms = sum(e.self_cpu_time_total for e in ka) / 1e3
        print(f"profile {backend}: warm wall {wall:.4f} s unprofiled, "
              f"{wall_prof:.4f} s profiled; launches {launched}; device "
              f"time {device_ms:.1f} ms, idle share "
              f"{1.0 - device_ms / (1e3 * wall):.3f}; {len(dev)} CUDA "
              f"kernels; host self time {host_ms:.1f} ms")
        for name, us in per_kernel.most_common(6):
            print(f"profile {backend}:   kernel {name[:60]}: {calls[name]} "
                  f"calls, {us / 1e3:.2f} ms device")
        for e in sorted(ka, key=lambda e: e.self_device_time_total,
                        reverse=True)[:6]:
            print(f"profile {backend}:   op {e.key[:50]}: {e.count} calls, "
                  f"{e.self_device_time_total / 1e3:.2f} ms device")
        for e in ka:
            if e.key.startswith("range: "):
                print(f"profile {backend}:   {e.key}: {e.count} calls, "
                      f"{e.cpu_time_total / 1e3:.1f} ms host (inclusive)")
        for e in sorted(ka, key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:6]:
            print(f"profile {backend}:   host {e.key[:50]}: {e.count} "
                  f"calls, {e.self_cpu_time_total / 1e3:.1f} ms self")


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
        phase_tf32_coeffs(torch)
        timing = phase_kernel(torch, chi2_core)
        with tempfile.TemporaryDirectory() as workdir:
            launches, run, t, med = phase_slice(torch, chi2_core, tr,
                                                workdir)
            phase_dormant(torch, chi2_core, workdir)
            phase_ensemble(chi2_core, t)
            phase_likelihoods(torch)
            launches["chi2_from_orbit"] = phase_batch(torch, chi2_core, t,
                                                      workdir, med)
            phase_parity()
            if "--profile" in sys.argv[1:]:
                phase_profile(torch, run)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    # each kernel at the main path's shape (n_t = 100, GL-4): the plane
    # kernels at their old 16384-draw chunk, the orbit kernels at
    # orbit_chunk(1e6); no single PyTorch call computes this function, so
    # no library time. Launches: orbit v2 in phase 10's warm batch call,
    # orbit v3 in phase v3's call, the plane kernels on neither path
    src = "triceratops_tpu_torch/csrc/chi2_supersampled.cu"
    kernels = []
    for name, replaces in (
            ("chi2_supersampled", "triceratops_tpu/ops/pallas_core.py:120"),
            ("chi2_supersampled_v3", "triceratops_tpu/ops/pallas_core.py:267"),
            ("chi2_from_orbit", "triceratops_tpu/ops/pallas_core.py:120"),
            ("chi2_from_orbit_v3",
             "triceratops_tpu/ops/pallas_core.py:267")):
        k = timing["slice"][name]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": k["max_abs_err"], "ms": k["ms"],
               "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
               "bound_by": k["bound_by"], "library_ms": None,
               "build_s": build_s}
        for key in ("transpose_ms", "yardstick_ms", "C"):
            if k.get(key) is not None:
                row[key] = k[key]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
