"""Smoke run of the PyTorch port (triceratops_tpu_torch) on one NVIDIA GPU.

Drives the port's main path once at full size and checks it:

  1. requires CUDA and prints the card's name and power limit;
  2. builds the chi^2 kernels (v2 and v3 schedules, each over z^2 planes
     and over the orbit, and each schedule's orbit instance that computes
     its deficit coefficients itself; one source) from csrc/ with nvcc and
     prints the build time and the compiler's register report; then, with
     torch.set_float32_matmul_precision("high"), computes the tabulated
     deficit coefficients of 1e5 seeded draws across all eight k-segments
     on the card and holds them to the CPU path within 3e-6 (the
     coefficient products run in IEEE float32 whatever the caller's
     setting), checks the setting came back, and that with the guard
     lifted the same call misses 3e-6; and holds the tab kernel's own
     coefficient function (chi2_core.deficit_coeffs_tab) on the same draws
     to the CPU path within 3e-6; and, under the same setting, the exact
     kernel's coefficient function (chi2_core.deficit_coeffs_exact) to the
     CPU's exact coefficients (fastcore.cheb_deficit_coeffs) within 3e-6,
     and prints that instance's registers, local memory and warps per SM;
  samplers. builds the sampler kernels (csrc/samplers.cu) with their
     register report and runs every branch of every sampler the rows run
     (SAMPLER_VARIANTS) at 1,000,192 draws on the card against its plain
     torch chain (``<sampler>.plain``) on generators of one seed: every
     field and mask bit for bit, one ``launch.sampler.<entry>`` a branch,
     and each path's time by CUDA events;
  3. compares each of the seven kernels with its plain torch version on the
     card at the main path's shape (n_t = 100, GL-4), at long-curve shapes
     (n_t = 8055 and the full n_t = 20099) and at ns = 1, and times them
     with CUDA events: the plane kernels at the old n_t-bound draw chunk,
     the orbit kernels at the main path's chunk (lightcurve.orbit_chunk)
     beside their yardstick, for orbit v2 / v3 exposure_z2_poly plus the
     plane kernel on the same draws (on the long curves both at the old
     chunk, where the planes fit), for the tab kernels the torch tab
     coefficient stage plus orbit v2 / v3 and for the exact kernel the
     torch exact stage plus orbit v2, whose result they are also gated
     against (the exact kernel's plain version takes the v2 kernels' skip
     rule, chi2_core.V2_GROUP: the float32 exact series keeps up to ~6e-6
     beyond zmax, which every v2 kernel drops at the 32-point groups it
     skips; the every-point plain version's distance is printed); prints
     the orbit v2, tab and exact kernels'
     registers, local memory and resident warps per SM (the instance the
     shape runs: from chi2_core.V2_WINDOW_MIN_T exposures on, for the
     exact kernel V2_EXACT_WINDOW_MIN_T, the windowed one, which solves
     only the 32-point groups of a draw holding a point of its transit
     window), for the windowed tab and exact kernels the share of (draw,
     group) pairs they solved, and for the v3
     orbit kernels, which skip the solve outside each draw's transit
     window, both bounds (window_bound,
     a solve inside the windows only, and a solve at every point), the
     share of (draw, point) pairs outside their draw's window (after
     checking that every active point lies inside it) and the tab kernel's
     time on the same draws; then the five orbit kernels with a target
     axis, one launch over 8 targets x 1000192 draws (n_t = 100, GL-4,
     each target its own curve), against the plain version per target,
     draw for draw against one launch per target, and timed beside 8x the
     one-target launch and the summed bound;
  4. runs target.from_stars -> calc_depths -> calc_probs(N = 1e6,
     nsamples = 20) on bench.py's configuration (a TOI-465-like target, a
     3000-star synthetic TRILEGAL field) plus two nearby stars: all 21
     rows, v2 schedule; checks the result and that only the tab kernel
     launched (no torch coefficient stage);
  5. reruns the same seed on the plain torch path and compares per-row
     lnZ; then under TRICERATOPS_COEFFS=exact (fastcore.COEFFS_BACKEND),
     the exact kernel, which computes the exact coefficients itself: only
     it launched, once per row, per-row lnZ within 1e-2 of the plain path
     on the same coefficients (and the distance to 4 printed); the same
     seed on the torch-stage route (the torch exact coefficient stage into
     orbit v2, the routing predicate naming no in-kernel stage): only
     orbit v2 launched, once per row, per-row lnZ within 1e-2 of the exact
     kernel's on the rows within 50 nats of the winner; three warm calls of
     the exact kernel's route (seeds 2, 3, 4), their median and peak
     device memory; then reruns it on the
     kernel path under TF32 (set_float32_matmul_precision("high")): per-row lnZ
     within 1e-2 of 4, and prints the same run's distance with the
     products' guard lifted;
  v3. reruns the same seed under the v3 schedule: only the v3 tab kernel
     launched, once per row, per-row lnZ as in 4; then one warm v3 call;
     then the same seed under the v3 schedule and exact coefficients (the
     torch exact stage into orbit v3): only orbit v3 launched, once per
     row, per-row lnZ within 1e-2 of 5's exact run on the rows within 50
     nats of the winner;
  long. runs the 21-row call on a seeded synthetic curve of
     bench_longlc.py's window shape (8055 points in |t| < 0.4 d, 2-min
     exposures, 4's planet) under schedules 2 and 3 on one seed: only the
     schedule's tab kernel launched, once per row; per-row lnZ within
     1e-2 nats on the rows within 50 nats of the winner, the same -inf
     rows; prints both schedules' first and warm walls and the share of
     (draw, group) pairs the tab kernel solved (the warm call traced);
  7. runs the four dormant nearby-star scenarios (lnZ_NTP_unknown and
     lnZ_NEB_unknown on the TRILEGAL lookalikes of a Tmag 13.2 star,
     lnZ_NTP_evolved and lnZ_NEB_evolved at R_s = 2.0) at N = 1e6 on v2,
     on the plain path and under v3, and the empty-population case; checks
     per-row lnZ across the paths and that only the schedule's tab kernel
     launched;
  8. runs calc_probs_ensemble(n_runs = 3) of the 21-row call: 63 tab
     launches, FPP the mean of the runs;
  9. runs likelihoods.simulate_TP_transit_p and lnL_EB_p over 1e5
     parameter rows on the card (float64) against the same call on the
     CPU for the first 256 rows;
 10. runs the multi-target batch path (parallel/sharding.batch_fpp_full)
     on 8 targets at N = 1e6: phase 4's target with its two nearby stars
     and seven one-star targets on curves synthesized from seeded (Rp, P)
     rows, 1.5-6 Re and 1-10 d (tools/catalog_replay._synth_lc): (i) in
     this process alone, cold and warm, checking the rows, that only the
     tab kernel launched, exactly once per computed row over the
     batch (21: one program per row over all targets), its peak device
     memory (at most 20 GiB), per-row lnZ against the same targets run one
     at a time (B = 1 batches, the same seeds) within 1e-3 nats, and
     against the same 8 targets through calc_probs by test_sharding.py's
     statistical rule; (ii) on a one-rank NCCL grid, identical to (i);
     (iii) on two gloo ranks sharing the card as a 1 x 2 draws grid, by
     the statistical rule against (i);
 11. holds the port's FPP, NFPP and per-row lnZ statistics over K = 16
     seeds at N = 1e6 to the JAX package's K-key record
     (parity/jax_ref.json, parity_ref.py) on its two fixtures, phase 4's
     21-row target and an 11.5 Re planet, by parity_port.py's gates;
     F1's TP and DTP rows against the JAX package's 100-key row record
     (parity/jax_rows.json).

Prints a JSON line with the seven kernels' numbers, one with the sampler
phase's rows, then as its last line
{"ok": true, "device": {...}}. Exits non-zero on any failure, without a
CUDA card, and outside a checkout of the repository. It times kernels
alone; a call's time, idle share and launches come from the benchmark
(port_bench/run.py --trace 1, port_bench/spans.py).

Run from the repository root:  python3 chip_smoke.py
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

import numpy as np

# The H100's peaks and the kernels' FP32 operation counts (an FMA counts
# 2; one operation per + - * / and per IEEE function call, a floor: such a
# function takes several instructions), as port_bench/roofline.py freezes
# them: per point and node of chi2_supersampled (z^2 model 4, sqrt 2,
# segment map 4, sqrt map 4, 2x 1, 17 Clenshaw steps x 3, final step and
# clip 5, node weight 2) and per computed point its dilution and chi^2
# update; per point of the orbit source (csrc/chi2_supersampled.cu) the
# Kepler solve (kepler_sc) plus the Taylor z^2 model, or plus
# projected_z at ns = 1, and per draw its constants and zmax; per
# Chebyshev term in kappa of the tab kernel's coefficient stage
# (tab_coeffs) its 162 basis FMAs and the recurrence step, and per draw
# the 54 outputs' weighted sums, the weights, the kappa map and
# _segments; per draw of the v3 kernels' transit window (transit_window)
# the orbit's bounds and the model's margin, zeff and the arc's half
# width, the spread, sqrt(1 -+ e) and the centres, seven eccentric
# anomalies and their arguments, four mean-anomaly arcs, the window's
# ends and tests
from port_bench.roofline import (
    FLOPS_NODE_POINT, FLOPS_ORBIT_DRAW, FLOPS_ORBIT_POINT, FLOPS_POINT,
    FLOPS_TAB_DRAW, FLOPS_TAB_TERM, FLOPS_WINDOW_DRAW, PEAK_BYTES_S,
    PEAK_FP32_S)

N_DRAWS = 1_000_000
NSAMPLES = 20
EXPTIME = 0.00139
SIGMA_GATE = 5e-4     # noise level of the kernel-comparison inputs
# The exact kernel's coefficient stage per draw (ExactStage), one operation
# per + - * / and per sqrt, sin, cos, atan2, abs, min, max, compare or
# select: per deficit (occult_deficit) 87 outside its Gauss-Legendre loop
# and 19 per node of 11 (the one branch of G a node needs: G_big or
# G_small, 5); per draw 54 deficits and their node positions (2 each), the
# DCT's 54 x 18 multiply-adds (2 each) and _segments 14
FLOPS_DEFICIT = 87 + 11 * 19
FLOPS_EXACT_DRAW = 54 * (FLOPS_DEFICIT + 2) + 54 * 18 * 2 + 14
# device sleep queued before each timed call (~1 ms at the H100's clock)
LEAD_CYCLES = 2_000_000
# phase 3's shapes, shape i on draws of seed i: name, exposures, nsamples
# and the curve's half window [d]
KERNEL_SHAPES = (("slice", 100, NSAMPLES, 0.15), ("long", 8055, NSAMPLES, 0.3),
                 ("full", 20099, NSAMPLES, 1.5), ("ns1", 100, 1, 0.15))
# phase 7: the nearby star whose lookalikes the unknown-host rows draw, and
# the subgiant radius of the evolved rows
TMAG_LOOKALIKE = 13.2
R_EVOLVED = 2.0
# phase 9: parameter rows of the batch likelihoods, rows checked on the CPU
N_LIKELIHOOD_ROWS = 100_000
N_LIKELIHOOD_CHECK = 256
COUNTERS = tuple(f"launch.{name}" for name in (
    "chi2_supersampled", "chi2_supersampled_v3", "chi2_from_orbit",
    "chi2_from_orbit_v3", "chi2_from_orbit_tab", "chi2_from_orbit_v3_tab",
    "chi2_from_orbit_exact", "deficit_coeffs_tab", "deficit_coeffs_exact"))
# the sampler kernels' entries (launch.sampler.<entry>): kept apart from
# COUNTERS, which _only holds to the one chi^2 kernel of a path
SAMPLER_ENTRIES = ("planet", "eb", "twin")
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
# phase 10: the most device memory the warm batch call may take, and how
# far (nats) a row of the batch may sit from its target run alone on the
# same seeds (the coefficient products' rounding differs with the launch
# size)
BATCH_PEAK_GIB = 20.0
BATCH_VS_ONE_NATS = 1e-3
# phase long: exposures of the synthetic long curve, its half window [d]
# (bench_longlc.py's |t| < 0.4 d crop of TOI-1228), its seed, and how far
# below the winner (nats) a row's lnZ is still held to 1e-2 nats
LONG_N_T = 8055
LONG_WINDOW = 0.4
LONG_SEED = 12
LONG_NEAR_NATS = 50.0
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
          f"chi2_supersampled_v3, chi2_from_orbit, chi2_from_orbit_v3, "
          f"chi2_from_orbit_tab, chi2_from_orbit_v3_tab, "
          f"chi2_from_orbit_exact) in {dt:.2f} s")
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

    from triceratops_tpu_torch.ops import chi2_core

    got = chi2_core.deficit_coeffs_tab(*(a.cuda() for a in cpu))
    torch.cuda.synchronize()
    e_kernel = max(float((g.cpu() - w).abs().max())
                   for g, w in zip(got, want))
    bounds = np.arange(0, k.size + 1, N_TF32_DRAWS // 8)
    seg_err = [max(float((g.cpu()[a:b] - w[a:b]).abs().max())
                   for g, w in zip(got, want))
               for a, b in zip(bounds[:-1], bounds[1:])]
    print(f"phase 2: the tab kernel's own coefficient function "
          f"(deficit_coeffs_tab_launch) on the same {k.size} draws vs the "
          f"CPU: max |d| {e_kernel:.3g} (gate {TAB_TOL}); per k-segment "
          + ", ".join(f"{x:.3g}" for x in seg_err))
    check(e_kernel < TAB_TOL,
          f"the in-kernel tab coefficients differ by {e_kernel}")

    # the exact kernel's own coefficient function under the same setting
    # (it runs no matmul) against the CPU's exact coefficients
    want = fastcore.cheb_deficit_coeffs(*cpu)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = chi2_core.deficit_coeffs_exact(*(a.cuda() for a in cpu))
        torch.cuda.synchronize()
    finally:
        torch.set_float32_matmul_precision(prev)
    e_exact = max(float((g.cpu() - w).abs().max())
                  for g, w in zip(got, want))
    seg_err = [max(float((g.cpu()[a:b] - w[a:b]).abs().max())
                   for g, w in zip(got, want))
               for a, b in zip(bounds[:-1], bounds[1:])]
    print(f"phase 2: the exact kernel's own coefficient function "
          f"(deficit_coeffs_exact_launch) on the same {k.size} draws under "
          f"TF32 vs the CPU's exact coefficients (cheb_deficit_coeffs): max "
          f"|d| {e_exact:.3g} (gate {TAB_TOL}); per k-segment "
          + ", ".join(f"{x:.3g}" for x in seg_err))
    check(e_exact < TAB_TOL,
          f"the in-kernel exact coefficients differ by {e_exact}")
    for ns, S in ((NSAMPLES, 4), (1, 1)):
        info = chi2_core.exact_kernel_info(ns, S)
        print(f"phase 2: the exact kernel's instance at ns={ns} ({S} "
              f"nodes): {_info_text(info)}")
    return e, e_kernel, e_exact


def _info_text(info):
    """A kernel_info dict as phase 2 and 3 print it."""
    return (f"{info['registers']} registers, {info['local_bytes']} bytes "
            f"local a thread, {info['blocks_per_sm']} x {info['threads']}"
            f"-thread blocks = {info['warps_per_sm']} warps per SM, "
            f"{info['smem_bytes']} bytes shared a block, "
            f"{info['sms'] * info['blocks_per_sm']} persistent blocks")


def _draws(torch, C, n_t, ns, window, seed):
    """One chunk of seeded draws (those of tests/test_pallas_core.py):
    the orbit (time, P, aR, inc, e, w), the rest of the kernels' inputs
    (cA, cB1, cB2, seg, g, obs_dev) from the port's coefficient stage, the
    exposure nodes, and the tab kernel's per-draw inputs (k, u1, u2, g)
    with g (C,)."""
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
            tuple(map(float, wgts)), (k, u1, u2, g.view(-1)))


def _chunk_inputs(torch, chi2_core, C, n_t, ns, window, seed):
    """One chunk of (q0 ... obs_dev) for chi2_supersampled: the planes of
    the seeded draws' exposure z^2 model (chi2_core.orbit_planes)."""
    orbit, rest, offs, wgts, _ = _draws(torch, C, n_t, ns, window, seed)
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


def _active_mask(torch, q0, q1, q2, front, seg, offs):
    """Points in front with z < zmax at some node: the ones whose deficit
    is not ~0, which run the kernels' full per-node work."""
    zmax2 = (seg[:, 1] + 1.0 / seg[:, 4]) ** 2
    inside = torch.zeros_like(front, dtype=torch.bool)
    for d in offs:
        inside |= (q0 + q1 * d + q2 * (d * d)) < zmax2[:, None]
    return inside & (front > 0)


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
    n_active = int(_active_mask(torch, q0, q1, q2, front, seg, offs).sum())
    return (*_bound(nbytes, _deficit_flops(n_active, C * n_t, len(offs),
                                           n_t)), n_active / (C * n_t))


def point_counts(torch, chi2_core, orbit, rest, offs, ns):
    """What the orbit kernels' work depends on in these inputs, counted on
    the exposure z^2 model's planes made a draw slice at a time: the
    (draw, point) pairs, the active ones (_active_mask), the ones inside
    their draw's transit window (chi2_core.transit_window, the v3
    kernels' window), the active ones outside it (the window misses them:
    must be none), and the pairs the v3 kernels solve: a warp's
    chi2_core.V3_DRAWS draws at every point some draw's window holds."""
    t, P, aR, inc, e, w = orbit
    seg = rest[3]
    C, n_t = P.shape[0], t.shape[0]
    step = max(256, (1 << 24) // n_t // 32 * 32)
    n = dict(C=C, n_t=n_t, active=0, inside=0, missed=0, warp=0)
    for i in range(0, C, step):
        s = slice(i, i + step)
        active = _active_mask(torch, *chi2_core.orbit_planes(
            t, P[s], aR[s], inc[s], e[s], w[s], ns), seg[s], offs)
        zmax = seg[s, 1] + 1.0 / seg[s, 4]
        inside = chi2_core.window_contains(t, P[s], *chi2_core.transit_window(
            P[s], aR[s], inc[s], e[s], w[s], zmax, offs))
        n["active"] += int(active.sum())
        n["inside"] += int(inside.sum())
        n["missed"] += int((active & ~inside).sum())
        D = chi2_core.V3_DRAWS
        n["warp"] += D * int(inside.view(-1, D, n_t).any(1).sum())
    return n


def _orbit_flops(counts, offs, ns):
    """FP32 operations of an orbit kernel that solves at every point: the
    orbit source's work at every point and draw (FLOPS_ORBIT_POINT,
    FLOPS_ORBIT_DRAW) plus the plane kernels' work on the same z^2
    model."""
    C, n_t = counts["C"], counts["n_t"]
    return (C * n_t * FLOPS_ORBIT_POINT[ns == 1] + C * FLOPS_ORBIT_DRAW
            + _deficit_flops(counts["active"], C * n_t, len(offs), n_t))


def _tab_flops(kud):
    """FP32 operations of the tab kernels' coefficient stage: each draw's
    at its own k-segment's degree (FLOPS_TAB_TERM per term,
    FLOPS_TAB_DRAW)."""
    from triceratops_tpu_torch.ops import fastcore

    br = np.asarray(fastcore._TAB_BREAKS, np.float32)
    kc = np.clip(kud[0].cpu().numpy(), br[0], br[-1])
    seg = np.clip(np.searchsorted(br, kc, side="right") - 1, 0, 7)
    deg = np.asarray(fastcore._TAB_DEGS)[seg]
    return int(deg.sum()) * FLOPS_TAB_TERM + kc.size * FLOPS_TAB_DRAW


def _orbit_bytes(orbit, rest):
    """time, obs, the six per-draw parameters (P, aR, inc, e, w, g) and 59
    coefficients read once, the output written once."""
    return 4 * (sum(a.numel() for a in (*orbit, *rest)) + orbit[1].numel())


def _tab_bytes(chi2_core, orbit, rest, table="tab_C"):
    """time, obs, the nine per-draw inputs (P, aR, inc, e, w, k, u1, u2, g)
    read once, the stage's table (the tab kernels' coefficient table, or
    the exact kernel's dct_T) once, the output written once."""
    t, obs = orbit[0], rest[5]
    tab = chi2_core._device_table(t.device, table)
    return 4 * (t.numel() + obs.numel() + 10 * orbit[1].numel()
                + tab.numel())


def _share(counts, key):
    return counts[key] / (counts["C"] * counts["n_t"])


def orbit_bound(orbit, rest, offs, ns, counts):
    """(bound_ms, bound_by, active share) of chi2_from_orbit on these
    inputs (counts: point_counts). Bytes: _orbit_bytes. Operations:
    _orbit_flops, the solve at every point."""
    return (*_bound(_orbit_bytes(orbit, rest),
                    _orbit_flops(counts, offs, ns)), _share(counts, "active"))


def tab_bound(chi2_core, orbit, rest, kud, offs, ns, counts):
    """(bound_ms, bound_by, active share) of chi2_from_orbit_tab on these
    inputs. Bytes: _tab_bytes. Operations: _orbit_flops plus the
    coefficient stage (_tab_flops)."""
    flops = _orbit_flops(counts, offs, ns) + _tab_flops(kud)
    return (*_bound(_tab_bytes(chi2_core, orbit, rest), flops),
            _share(counts, "active"))


def exact_bound(chi2_core, orbit, rest, kud, offs, ns, counts):
    """(bound_ms, bound_by, active share) of chi2_from_orbit_exact on these
    inputs. Bytes: _tab_bytes with dct_T. Operations: _orbit_flops plus
    the exact coefficient stage (FLOPS_EXACT_DRAW per draw)."""
    flops = _orbit_flops(counts, offs, ns) + kud[0].numel() * FLOPS_EXACT_DRAW
    return (*_bound(_tab_bytes(chi2_core, orbit, rest, "dct_T"), flops),
            _share(counts, "active"))


def window_bound(chi2_core, orbit, rest, kud, offs, ns, counts, tab=True):
    """(bound_ms, bound_by, share of (draw, point) pairs outside their
    draw's window) of a v3 orbit kernel that skips the solve outside each
    draw's transit window: chi2_from_orbit_v3_tab (tab) or
    chi2_from_orbit_v3. Operations: per draw its orbit constants and
    window (FLOPS_ORBIT_DRAW, FLOPS_WINDOW_DRAW), the solve and z^2 model
    only at the pairs inside the draw's own window (counts' "inside"), the
    deficit at the active ones, and for tab the coefficient stage. Bytes:
    those of tab_bound or orbit_bound."""
    C, n_t, S = counts["C"], counts["n_t"], len(offs)
    n_in, n_active = counts["inside"], counts["active"]
    flops = (C * (FLOPS_ORBIT_DRAW + FLOPS_WINDOW_DRAW)
             + n_in * FLOPS_ORBIT_POINT[ns == 1]
             + n_active * (S * FLOPS_NODE_POINT + FLOPS_POINT)
             + (n_in - n_active) * S * 4 + 2 * n_t)
    if tab:
        flops += _tab_flops(kud)
        nbytes = _tab_bytes(chi2_core, orbit, rest)
    else:
        nbytes = _orbit_bytes(orbit, rest)
    return (*_bound(nbytes, flops), 1.0 - _share(counts, "inside"))


def _lnl_diff(torch, kern, plain, C, long_curve):
    """|lnL kernel - lnL plain| per draw (lnL = const - chi2 / (2
    sigma^2)), both lnL, its p99 and max over the draws (on a long curve
    over those within 50 of the best plain lnL), and the distance of the
    two lnZ."""
    from triceratops_tpu_torch.core.numerics import log_mean_exp_torch

    inv = 1.0 / (2.0 * SIGMA_GATE ** 2)
    lnL_k = (-kern.double() * inv).cpu().numpy()
    lnL_p = (-plain.double() * inv).cpu().numpy()
    d = np.abs(lnL_k - lnL_p)
    sel = lnL_p > lnL_p.max() - 50.0 if long_curve else slice(None)
    dz = abs(float(log_mean_exp_torch(torch.as_tensor(lnL_k), C))
             - float(log_mean_exp_torch(torch.as_tensor(lnL_p), C)))
    return d, lnL_k, lnL_p, float(np.quantile(d[sel], 0.99)), float(
        d[sel].max()), dz


def _gate(torch, name, kern, plain, C):
    """The kernel-vs-plain gates on lnL = const - chi2 / (2 sigma^2): the
    same finite masks, lnL p99 < 0.05 and max < 1.0 (on a long curve on
    the draws within 50 of the best, and relative gates on all), lnZ within
    1e-2."""
    long_curve = name.split()[0] in ("long", "full")
    d, lnL_k, lnL_p, p99, dmax, dz = _lnl_diff(torch, kern, plain, C,
                                               long_curve)
    check(np.array_equal(np.isfinite(lnL_k), np.isfinite(lnL_p)),
          f"{name}: finite masks differ")
    check(p99 < 0.05 and dmax < 1.0, f"{name}: lnL diff p99 {p99} max {dmax}")
    if long_curve:
        rel = d / (np.abs(lnL_p) + 1.0)
        check(np.quantile(rel, 0.99) < 1e-3 and rel.max() < 2e-2,
              f"{name}: relative lnL diff {np.quantile(rel, 0.99)}, "
              f"{rel.max()}")
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
    out = {}
    for i, (name, n_t, ns, window) in enumerate(KERNEL_SHAPES):
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
    """The five orbit kernels at one shape: the gates against the plain
    version and the yardstick at C_cmp draws, the time and bound at
    C_main. The v3 kernels' bound is window_bound (the solve only inside
    each draw's transit window, what they run), beside the bound of a
    solve at every point (orbit_bound, tab_bound); the transit windows of
    the C_main draws must hold every active point."""
    orbit, rest, offs, wgts, kud = _draws(torch, C_cmp, n_t, ns, window,
                                          seed)
    kw = dict(offs=offs, wgts=wgts, ns=ns)
    plain = chi2_core.chi2_from_orbit_plain(*orbit, *rest, **kw)
    plain_ms = _median_ms(torch, lambda: chi2_core.chi2_from_orbit_plain(
        *orbit, *rest, **kw), reps=5)
    if C_main != C_cmp:
        main = _draws(torch, C_main, n_t, ns, window, seed)
    else:
        main = orbit, rest, offs, wgts, kud
    counts = point_counts(torch, chi2_core, *main[:2], offs, ns)
    check(counts["missed"] == 0, f"{name}: {counts['missed']} active points "
          "lie outside their draw's transit window")
    every = orbit_bound(*main[:2], offs, ns, counts)
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
        v3 = kname == "chi2_from_orbit_v3"
        bound_ms, bound_by, _ = (
            window_bound(chi2_core, *main[:2], main[4], offs, ns, counts,
                         tab=False) if v3 else every)
        if v3:
            extra = (f" (window_bound; orbit_bound, a solve at every point, "
                     f"{every[0]:.4f} ms)")
            info = {}
        else:
            info = chi2_core.v2_kernel_info("copy", ns, len(offs), n_t)
            extra = f"; {_info_text(info)}"
        print(f"phase 3: {name} {kname} n_t={n_t} nodes={len(offs)}: at "
              f"C={C_cmp} lnL diff p99 {p99:.3g} max {dmax:.3g}, lnZ diff "
              f"{dz:.3g}; kernel {cmp_ms:.4f} ms, yardstick (planes + "
              f"plane kernel) {yard_ms:.4f} ms, plain {plain_ms:.4f} ms; at "
              f"C={C_main} kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}){extra}, {every[2]:.4f} of points in transit, "
              f"{1.0 - _share(counts, 'inside'):.4f} of (draw, point) "
              f"pairs outside their draw's window, "
              f"{1.0 - _share(counts, 'warp'):.4f} outside every window of "
              f"their warp (medians)")
        row[kname] = dict(max_abs_err=dmax, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          yardstick_ms=yard_ms, cmp_ms=cmp_ms, C=C_main,
                          C_cmp=C_cmp, **info)
        if v3:
            row[kname]["bound_ms_every_point"] = every[0]
    targs = (*orbit, *kud, rest[5])
    plains = {}
    for kname, (stage, _) in KUD_KERNELS.items():
        if stage not in plains:
            plain_fn = getattr(chi2_core, f"chi2_from_orbit_{stage}_plain")
            plains[stage] = (plain_fn(*targs, **kw), _median_ms(
                torch, lambda: plain_fn(*targs, **kw), reps=5))
        row[kname] = _tab_shape(torch, chi2_core, name, kname, ns,
                                (orbit, rest, kud), main, kw, counts,
                                *plains[stage],
                                row.get("chi2_from_orbit_tab"))
    return row


def exact_plain(chi2_core, *args, **kw):
    """The exact kernel's plain version under the v2 skip rule
    (chi2_core.V2_GROUP): a point counts only in a 32-point group of its
    draw with a point in transit, as in every v2 kernel. The float32 exact
    series keeps up to ~6e-6 at z >= zmax, where the deficit is 0; without
    the rule the plain version adds that at every out-of-transit point the
    kernel skips (lnL p99 up to 0.68 on a 20,099-point curve)."""
    return chi2_core.chi2_from_orbit_exact_plain(
        *args, group=chi2_core.V2_GROUP, **kw)


# The kernels that compute the coefficients themselves from (k, u1, u2):
# their coefficient stage and schedule (the v2 tab kernel first: the v3
# one's row quotes it)
KUD_KERNELS = {"chi2_from_orbit_tab": ("tab", "2"),
               "chi2_from_orbit_v3_tab": ("tab", "3"),
               "chi2_from_orbit_exact": ("exact", "2")}


def _tab_shape(torch, chi2_core, name, kname, ns, cmp, main, kw, counts,
               plain, plain_ms, v2_tab):
    """A kernel of KUD_KERNELS at one shape: on the comparison draws (cmp:
    orbit, rest, kud of _draws) the gates against its plain version
    (plain, timed plain_ms) and against its yardstick's result, the torch
    coefficient stage of the same coefficients (tab or exact) fed to the
    schedule's copy-stage orbit kernel (orbit v2, or orbit v3), and both
    times; on the main path's draws (main, _draws' tuple; counts, their
    point_counts) the time, the yardstick's time and the bound (tab_bound,
    exact_bound, or for v3 window_bound beside tab_bound); and the
    compiler's and occupancy calculator's view of its instance. For v3,
    v2_tab is the tab kernel's row on the same draws."""
    from triceratops_tpu_torch.ops import fastcore

    stage, sched = KUD_KERNELS[kname]
    v3 = sched == "3"
    orbit_fn = (chi2_core.chi2_from_orbit_v3 if v3
                else chi2_core.chi2_from_orbit)
    coeff_fn = (fastcore.cheb_deficit_coeffs if stage == "exact"
                else fastcore.cheb_deficit_coeffs_tab)

    def tab_args(orbit, rest, kud):
        return (*orbit, *kud, rest[5])

    def yardstick(orbit, rest, kud):
        k, u1, u2, g = kud
        cA, cB1, cB2, *segs = coeff_fn(k, u1, u2)
        return orbit_fn(
            *orbit, cA.contiguous(), cB1.contiguous(), cB2.contiguous(),
            torch.stack(segs, 1), g[:, None], rest[5], **kw)

    fn = getattr(chi2_core, kname)
    args = tab_args(*cmp)
    C_cmp, C_main = cmp[0][1].shape[0], main[0][1].shape[0]
    n_t, S = cmp[0][0].shape[0], len(kw["offs"])
    kern = fn(*args, **kw)
    yard = yardstick(*cmp)
    torch.cuda.synchronize()
    vs_every = ""
    if stage == "exact":
        # gated against the plain version under the v2 skip rule
        # (exact_plain); the every-point plain version (plain) is printed
        every_pt = _lnl_diff(torch, kern, plain, C_cmp,
                             name in ("long", "full"))
        vs_every = (f" (under the v2 skip rule; against the every-point "
                    f"plain version p99 {every_pt[3]:.3g} max "
                    f"{every_pt[4]:.3g}, lnZ diff {every_pt[5]:.3g}, not "
                    f"gated)")
        plain = exact_plain(chi2_core, *args, **kw)
    p99, dmax, dz = _gate(torch, f"{name} {kname}", kern, plain, C_cmp)
    yp99, ydmax, ydz = _gate(torch, f"{name} {kname} vs yardstick", kern,
                             yard, C_cmp)
    cmp_ms = _median_ms(torch, lambda: fn(*args, **kw))
    main_args = tab_args(main[0], main[1], main[4])
    ms = (cmp_ms if C_main == C_cmp
          else _median_ms(torch, lambda: fn(*main_args, **kw)))
    yard_ms = _median_ms(torch, lambda: yardstick(main[0], main[1], main[4]))
    every = tab_bound(chi2_core, main[0], main[1], main[4], kw["offs"], ns,
                      counts)
    solved = None
    if not v3 and n_t >= (chi2_core.V2_EXACT_WINDOW_MIN_T if stage == "exact"
                          else chi2_core.V2_WINDOW_MIN_T):
        solved = window_solved(chi2_core, lambda: fn(*main_args, **kw))
    if v3:
        bound_ms, bound_by, skipped = window_bound(
            chi2_core, main[0], main[1], main[4], kw["offs"], ns, counts)
        info = chi2_core.v3_kernel_info(ns, S)
        extra = (f" (window_bound; tab_bound, a solve at every point, "
                 f"{every[0]:.4f} ms), {skipped:.4f} of (draw, point) pairs "
                 f"outside their draw's window, "
                 f"{1.0 - _share(counts, 'warp'):.4f} outside every window "
                 f"of their warp (not solved); the tab kernel on the same "
                 f"draws {v2_tab['ms']:.4f} ms ({v2_tab['ms'] / ms:.3f}x)")
    elif stage == "exact":
        bound_ms, bound_by, _ = exact_bound(chi2_core, main[0], main[1],
                                            main[4], kw["offs"], ns, counts)
        info = chi2_core.exact_kernel_info(ns, S, n_t)
        extra = ""
    else:
        bound_ms, bound_by, _ = every
        info = chi2_core.tab_kernel_info(ns, S, n_t)
        extra = ""
    if solved is not None:
        extra += (f" (windowed: {solved:.4f} of (draw, 32-point group) "
                  f"pairs solved)")
    print(f"phase 3: {name} {kname} n_t={n_t} nodes={S}: at C={C_cmp} vs "
          f"plain lnL diff p99 {p99:.3g} max {dmax:.3g}, lnZ diff "
          f"{dz:.3g}{vs_every}; "
          f"vs yardstick (torch {stage} coefficients + "
          f"{orbit_fn.__name__}) p99 {yp99:.3g} max {ydmax:.3g}, lnZ diff "
          f"{ydz:.3g}; kernel {cmp_ms:.4f} ms, plain {plain_ms:.4f} ms; at "
          f"C={C_main} kernel {ms:.4f} ms, yardstick {yard_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}){extra}; {every[2]:.4f} of points "
          f"in transit (medians); {_info_text(info)}")
    out = dict(max_abs_err=dmax, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, yardstick_ms=yard_ms,
               cmp_ms=cmp_ms, C=C_main, C_cmp=C_cmp, **info)
    if v3:
        out.update(bound_ms_every_point=every[0], skipped=skipped,
                   skipped_by_warps=1.0 - _share(counts, "warp"),
                   tab_ms=v2_tab["ms"])
    if solved is not None:
        out["solved"] = solved
    return out


def window_solved(chi2_core, launch):
    """The share of (draw, 32-point group) pairs that a windowed v2 launch
    (``launch()``, n_t >= chi2_core.V2_WINDOW_MIN_T) solved, from the
    tracer's window counters (they count while the tracer is on)."""
    prof = chi2_core.profiling
    before = prof.counters()
    with prof.tracing("host"):
        launch()
    after = prof.counters()
    walked, solved = (after.get(n, 0) - before.get(n, 0)
                      for n in chi2_core.WINDOW_COUNTERS)
    check(walked > 0, "the windowed v2 kernel counted no groups")
    return solved / walked


def phase_kernel_targets(torch, chi2_core, single):
    """Phase 3, the orbit kernels' target axis: one launch over N_BATCH
    targets x orbit_chunk(1e6) draws at n_t = 100, GL-4, each target its
    own curve (time window and noise) and draws. Each kernel is held to
    the plain version target by target with the phase-3 gates and draw for
    draw to one launch per target, and timed beside N_BATCH x its
    one-target time at the same chunk (``single``, phase 3's slice shape)
    and the bound, the sum of the targets' bounds (orbit_bound, tab_bound,
    exact_bound, window_bound for v3). The tab kernels' plain version on
    these draws is the orbit plain version on the torch tab coefficients
    of ``_draws``; the exact kernel's is its own under the v2 skip rule
    (exact_plain), as in phase 3."""
    from triceratops_tpu_torch.ops.lightcurve import orbit_chunk

    C, n_t = orbit_chunk(N_DRAWS), 100
    per = [_draws(torch, C, n_t, NSAMPLES, 0.1 + 0.02 * b, seed=50 + b)
           for b in range(N_BATCH)]
    offs, wgts = per[0][2:4]
    kw = dict(offs=offs, wgts=wgts, ns=NSAMPLES)
    orbit = [torch.stack([p[0][0] for p in per])] + [
        torch.cat([p[0][i] for p in per]) for i in range(1, 6)]
    rest = [torch.cat([p[1][i] for p in per]) for i in range(6)]
    kud = [torch.cat([p[4][i] for p in per]) for i in range(4)]
    plain = chi2_core.chi2_from_orbit_plain(*orbit, *rest, **kw)
    plain_exact = torch.cat([exact_plain(chi2_core, *p[0], *p[4], p[1][5],
                                         **kw) for p in per])
    counts = [point_counts(torch, chi2_core, p[0], p[1], offs, NSAMPLES)
              for p in per]
    bounds = {
        "chi2_from_orbit": [orbit_bound(p[0], p[1], offs, NSAMPLES, n)
                            for p, n in zip(per, counts)],
        "chi2_from_orbit_v3": [
            window_bound(chi2_core, p[0], p[1], p[4], offs, NSAMPLES, n,
                         tab=False) for p, n in zip(per, counts)],
        "chi2_from_orbit_tab": [
            tab_bound(chi2_core, p[0], p[1], p[4], offs, NSAMPLES, n)
            for p, n in zip(per, counts)],
        "chi2_from_orbit_v3_tab": [
            window_bound(chi2_core, p[0], p[1], p[4], offs, NSAMPLES, n)
            for p, n in zip(per, counts)],
        "chi2_from_orbit_exact": [
            exact_bound(chi2_core, p[0], p[1], p[4], offs, NSAMPLES, n)
            for p, n in zip(per, counts)]}

    def args(kname, o, r, k):
        return (*o, *k, r[5]) if kname in KUD_KERNELS else (*o, *r)

    out = {}
    for kname in bounds:
        fn = getattr(chi2_core, kname)
        bound_ms = sum(b[0] for b in bounds[kname])
        kern = fn(*args(kname, orbit, rest, kud), **kw)
        singles = torch.cat([fn(*args(kname, p[0], p[1], p[4]), **kw)
                             for p in per])
        torch.cuda.synchronize()
        check(torch.equal(kern, singles), f"{kname}: the {N_BATCH}-target "
              "launch differs from one launch per target")
        exact = kname == "chi2_from_orbit_exact"
        ref = plain_exact if exact else plain
        gates = [_gate(torch, f"B={N_BATCH} target {b} {kname}",
                       kern[b * C:(b + 1) * C], ref[b * C:(b + 1) * C], C)
                 for b in range(N_BATCH)]
        ms = _median_ms(torch, lambda: fn(*args(kname, orbit, rest, kud),
                                          **kw))
        one = single[kname]
        print(f"phase 3: targets {kname} B={N_BATCH} x C={C} n_t={n_t} "
              f"nodes={len(offs)}: per target lnL diff p99 <= "
              f"{max(g[0] for g in gates):.3g}, max <= "
              f"{max(g[1] for g in gates):.3g}, lnZ diff <= "
              f"{max(g[2] for g in gates):.3g}; equal to {N_BATCH} "
              f"one-target launches; kernel {ms:.4f} ms (median), "
              f"{N_BATCH} x one target {N_BATCH * one['ms']:.4f} ms; bound "
              f"{bound_ms:.4f} ms ({N_BATCH} x one target's "
              f"{N_BATCH * one['bound_ms']:.4f} ms)")
        out[kname] = dict(ms=ms, bound_ms=bound_ms,
                          max_abs_err=max(g[1] for g in gates))
    return out


# the TOI-465-like planet of phases 4-11: period [d], host mass [Msun] and
# radius [Rsun], planet radius [Re], and the curves' noise
TOI465_P, TOI465_M, TOI465_R, TOI465_RP = 3.18, 1.09, 1.06, 5.5
TOI465_SIGMA = 4e-4


def planet_flux(time_, seed):
    """Flux of the TOI-465-like planet (inc 89 deg, circular) at exposure
    centres time_ (days from mid-transit), plus seeded normal noise of
    TOI465_SIGMA."""
    import torch
    from triceratops_tpu_torch.constants import G, MSUN, RSUN, REARTH
    from triceratops_tpu_torch.core.kepler import projected_z
    from triceratops_tpu_torch.ops.occult import occult_quad_deficit

    P, M_s, R_s, rp = TOI465_P, TOI465_M, TOI465_R, TOI465_RP
    a = ((G * M_s * MSUN) / (4 * np.pi**2) * (P * 86400.0) ** 2) ** (1 / 3)
    c = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    z, front = projected_z(torch.as_tensor(time_), 0.0, c(P),
                           c(a / (R_s * RSUN)), c(np.deg2rad(89.0)), c(0.0),
                           c(0.0))
    D = occult_quad_deficit(c(rp * REARTH / (R_s * RSUN)), z, c(0.35),
                            c(0.25)) * front
    rng = np.random.default_rng(seed)
    return 1.0 - D.numpy() + rng.normal(0, TOI465_SIGMA, len(time_))


def toi465_field():
    """A TOI-465-like target (bench.py's fixture: P = 3.18 d, 5.5 Re
    planet, ~100-point folded curve, sigma = 4e-4) plus two nearby stars
    faint enough that each needs a transit depth between 0 and 1."""
    import pandas as pd

    P, M_s, R_s = TOI465_P, TOI465_M, TOI465_R
    time_ = np.linspace(-0.15, 0.15, 100)
    sigma = TOI465_SIGMA
    flux = planet_flux(time_, 42)
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
    counts = chi2_core.profiling.counters()
    return {n: counts.get(n, 0) for n in COUNTERS}


def _reset(chi2_core):
    chi2_core.profiling.reset()


def _sampler_launches(chi2_core):
    counts = chi2_core.profiling.counters()
    return {e: counts.get(f"launch.sampler.{e}", 0) for e in SAMPLER_ENTRIES}


def _branches(n_rows):
    """The sampler launches of a call that computes n_rows rows: the rows
    come in families of three (X, XEB, XEBx2P), each one planet branch,
    one EB normal branch and its conditioned twin set."""
    return dict.fromkeys(SAMPLER_ENTRIES, n_rows // 3)


def _only(c, name):
    """name rose, every other counter stayed at 0."""
    return c[name] > 0 and all(v == 0 for n, v in c.items() if n != name)


def phase_slice(torch, chi2_core, tr, workdir):
    """Phases 4, 5 and v3 on bench.py's configuration plus two nearby
    stars. Returns each kernel's launches in its path's run (the tab
    kernel on the main path, the exact kernel under
    TRICERATOPS_COEFFS=exact, orbit v2 on the torch-stage route under it,
    the v3 tab kernel under the v3 schedule, orbit v3 under both), the
    target and the sampler launches of phase 4's call."""
    import contextlib

    from triceratops_tpu_torch.ops import fastcore, lightcurve

    t, run = make_run(tr, workdir)
    _reset(chi2_core)
    wall0 = run(1)
    main_counts = _counts(chi2_core)
    main_samplers = _sampler_launches(chi2_core)
    lnZ, probs = t.lnZ.copy(), t.probs["prob"].to_numpy()
    names = t.probs["scenario"].values
    print(f"phase 4: calc_probs N={N_DRAWS} nsamples={NSAMPLES}, "
          f"{len(lnZ)} rows: {wall0:.3f} s (first call), launches "
          f"{main_counts}, sampler launches {main_samplers}; FPP "
          f"{t.FPP:.6g}, NFPP {t.NFPP:.6g}")
    print("phase 4: lnZ " + ", ".join(
        f"{n}={v:.4f}" for n, v in zip(names, lnZ)))
    check(_only(main_counts, "launch.chi2_from_orbit_tab")
          and main_counts["launch.chi2_from_orbit_tab"] == len(lnZ),
          f"the main path must launch only the tab kernel, once per row: "
          f"{main_counts}")
    check(len(lnZ) == 21, f"{len(lnZ)} rows, expected 21")
    check(main_samplers == _branches(len(lnZ)),
          f"the main path must launch one sampler kernel a branch, "
          f"{_branches(len(lnZ))}: {main_samplers}")
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

    # TRICERATOPS_COEFFS=exact: the exact kernel, which computes the exact
    # coefficients itself, held to the plain path on the same coefficients;
    # its distance to phase 4 is the two coefficient backends' (not gated:
    # a tab row sits ~1e-2 nats from its exact row, more on rows far below
    # the winner). Then the torch-stage route, the torch exact coefficient
    # stage into orbit v2 (the routing predicate replaced by one that names
    # no in-kernel stage), held to the exact kernel on the rows that carry
    # weight; three warm calls of the exact kernel's route
    def no_stage(*_):
        return None

    def warm():
        torch.cuda.reset_peak_memory_stats()
        walls = [run(seed) for seed in (2, 3, 4)]
        return walls, torch.cuda.max_memory_allocated() / 2**30

    fastcore.COEFFS_BACKEND = "exact"
    try:
        _reset(chi2_core)
        wall_exact = run(1)
        exact_counts = _counts(chi2_core)
        lnZ_exact = t.lnZ.copy()
        walls_exact, peak_exact = warm()
        saved_route = lightcurve.in_kernel_coeffs
        lightcurve.in_kernel_coeffs = no_stage
        try:
            _reset(chi2_core)
            wall_stage = run(1)
            stage_counts = _counts(chi2_core)
            lnZ_stage = t.lnZ.copy()
        finally:
            lightcurve.in_kernel_coeffs = saved_route
        _reset(chi2_core)
        wall_exact_plain = run(1, backend="torch")
        check(not any(_counts(chi2_core).values()),
              "the plain path launched a kernel under exact coefficients")
    finally:
        fastcore.COEFFS_BACKEND = "auto"
    dz_exact = np.abs(lnZ_exact - t.lnZ)
    near = lnZ_stage > lnZ_stage.max() - LONG_NEAR_NATS
    dz_stage = np.abs(lnZ_exact - lnZ_stage)
    print(f"phase 5: same seed under TRICERATOPS_COEFFS=exact (the exact "
          f"kernel) {wall_exact:.3f} s, plain path {wall_exact_plain:.3f} "
          f"s; launches {exact_counts}; per-row |lnZ kernel - lnZ plain| "
          f"max {dz_exact.max():.3g}; per-row |lnZ exact - lnZ tab (phase "
          f"4)| max {np.abs(lnZ_exact - lnZ).max():.3g} (not gated)")
    print(f"phase 5: exact kernel route warm walls {walls_exact} s, median "
          f"{float(np.median(walls_exact)):.4f} s; peak device memory "
          f"{peak_exact:.3f} GiB")
    print(f"phase 5: same seed on the torch-stage route (torch exact "
          f"coefficients + orbit v2) {wall_stage:.3f} s; launches "
          f"{stage_counts}; per-row |lnZ exact kernel - lnZ torch "
          f"stage| max {dz_stage.max():.3g}, on the rows within "
          f"{LONG_NEAR_NATS} nats of the winner {dz_stage[near].max():.3g}")
    check(_only(exact_counts, "launch.chi2_from_orbit_exact")
          and exact_counts["launch.chi2_from_orbit_exact"] == len(lnZ),
          f"TRICERATOPS_COEFFS=exact must launch only the exact kernel, "
          f"once per row: {exact_counts}")
    check(dz_exact.max() < 1e-2,
          f"exact-kernel and plain lnZ differ: {dz_exact}")
    check(_only(stage_counts, "launch.chi2_from_orbit")
          and stage_counts["launch.chi2_from_orbit"] == len(lnZ),
          f"the torch-stage route must launch only orbit v2, once per row: "
          f"{stage_counts}")
    check(dz_stage[near].max() < 1e-2,
          f"the exact kernel and the torch-stage route differ: {dz_stage}")

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

    # the v3 schedule: the v3 tab kernel, then under exact coefficients
    # orbit v3, each held to the v2 run on the same coefficients
    lightcurve.CHI2_SCHEDULE = "3"
    try:
        _reset(chi2_core)
        wall_v3 = run(1)
        v3_counts = _counts(chi2_core)
        dz3 = np.abs(t.lnZ - lnZ)
        wall_v3_warm = run(5)
        fastcore.COEFFS_BACKEND = "exact"
        try:
            _reset(chi2_core)
            wall_v3_exact = run(1)
            v3_exact_counts = _counts(chi2_core)
            dz3_exact = np.abs(t.lnZ - lnZ_exact)
        finally:
            fastcore.COEFFS_BACKEND = "auto"
    finally:
        lightcurve.CHI2_SCHEDULE = "2"
    print(f"phase v3: same seed under the v3 schedule {wall_v3:.3f} s, "
          f"warm (seed 5) {wall_v3_warm:.4f} s; launches {v3_counts}; "
          f"per-row |lnZ v3 - lnZ v2| max {dz3.max():.3g}")
    print(f"phase v3: same seed under the v3 schedule and "
          f"TRICERATOPS_COEFFS=exact {wall_v3_exact:.3f} s; launches "
          f"{v3_exact_counts}; per-row |lnZ - lnZ exact v2 (phase 5)| max "
          f"{dz3_exact.max():.3g}, on the rows within {LONG_NEAR_NATS} "
          f"nats of the winner "
          f"{dz3_exact[lnZ_exact > lnZ_exact.max() - LONG_NEAR_NATS].max():.3g}")
    check(_only(v3_counts, "launch.chi2_from_orbit_v3_tab")
          and v3_counts["launch.chi2_from_orbit_v3_tab"] == len(lnZ),
          f"the v3 schedule must launch only the v3 tab kernel, once per "
          f"row: {v3_counts}")
    check(dz3.max() < 1e-2, f"v3 and v2 lnZ differ: {dz3}")
    check(_only(v3_exact_counts, "launch.chi2_from_orbit_v3")
          and v3_exact_counts["launch.chi2_from_orbit_v3"] == len(lnZ),
          f"v3 under TRICERATOPS_COEFFS=exact must launch only orbit v3, "
          f"once per row: {v3_exact_counts}")
    # the exact coefficients leave a deficit residue of ~1e-8 beyond zmax
    # (the tab ones ~1e-10), which the v2 kernel keeps in a 32-point group
    # that runs and the v3 kernel drops outside each draw's window; where
    # the curve is deep that moves a row by ~1e-2, so the gate holds the
    # rows that carry weight (within LONG_NEAR_NATS of the winner)
    near = lnZ_exact > lnZ_exact.max() - LONG_NEAR_NATS
    check(dz3_exact[near].max() < 1e-2,
          f"v3 and v2 lnZ under exact coefficients differ: {dz3_exact}")

    # each kernel's launches in its own path's run: the plane kernels are
    # on none
    launches = dict(
        chi2_supersampled=main_counts["launch.chi2_supersampled"],
        chi2_supersampled_v3=v3_counts["launch.chi2_supersampled_v3"],
        chi2_from_orbit=stage_counts["launch.chi2_from_orbit"],
        chi2_from_orbit_exact=exact_counts["launch.chi2_from_orbit_exact"],
        chi2_from_orbit_v3=v3_exact_counts["launch.chi2_from_orbit_v3"],
        chi2_from_orbit_tab=main_counts["launch.chi2_from_orbit_tab"],
        chi2_from_orbit_v3_tab=v3_counts["launch.chi2_from_orbit_v3_tab"])
    return launches, t, main_samplers


def phase_long(chi2_core, t):
    """Phase long: the 21-row calc_probs (N = 1e6, nsamples = 20) of phase
    4's target on a seeded synthetic curve of bench_longlc.py's window
    shape: LONG_N_T exposure centres uniform in |t| < LONG_WINDOW d
    (folded from many transits, 2-min exposures), sorted, phase 4's planet
    and noise. The same seed under schedules 2 (the tab kernel) and 3 (the
    v3 tab kernel, which skips the solve outside each draw's transit
    window): each launches only its kernel, once per row; per-row lnZ
    within 1e-2 nats on the rows within LONG_NEAR_NATS of the winner and
    the same -inf rows. Prints each schedule's first and warm wall (host
    clock, the call ends in a device-to-host copy; the warm call with the
    tracer on) and the share of (draw, group) pairs the windowed tab
    kernel solved in the warm call. Returns the walls."""
    from triceratops_tpu_torch.ops import lightcurve

    rng = np.random.default_rng(LONG_SEED)
    time_ = np.sort(rng.uniform(-LONG_WINDOW, LONG_WINDOW, LONG_N_T))
    flux = planet_flux(time_, LONG_SEED + 1)
    lnZ, walls, counts = {}, {}, {}
    for sched, counter in (("2", "launch.chi2_from_orbit_tab"),
                           ("3", "launch.chi2_from_orbit_v3_tab")):
        lightcurve.CHI2_SCHEDULE = sched
        try:
            calls = []
            for mode in ("off", "host"):
                _reset(chi2_core)
                t0 = time.perf_counter()
                with chi2_core.profiling.tracing(mode):
                    t.calc_probs(time_, flux, TOI465_SIGMA, P_orb=TOI465_P,
                                 N=N_DRAWS, nsamples=NSAMPLES, verbose=0,
                                 key=LONG_SEED, device="cuda")
                calls.append(time.perf_counter() - t0)
                counts[sched] = _counts(chi2_core)
                check(_only(counts[sched], counter)
                      and counts[sched][counter] == len(t.lnZ),
                      f"phase long, schedule {sched}: expected only "
                      f"{counter}, once per row: {counts[sched]}")
        finally:
            lightcurve.CHI2_SCHEDULE = "2"
        lnZ[sched], walls[sched] = t.lnZ.copy(), calls
        if sched == "2":
            c = chi2_core.profiling.counters()
            walked, solved = (c.get(n, 0) for n in chi2_core.WINDOW_COUNTERS)
            check(walked > 0, "phase long: the tab kernel ran unwindowed")
    a, b = lnZ["2"], lnZ["3"]
    names = t.probs["scenario"].values
    check(np.array_equal(np.isneginf(a), np.isneginf(b)),
          f"phase long: -inf rows differ: {a} vs {b}")
    near = np.isfinite(a) & (a > np.max(a) - LONG_NEAR_NATS)
    d = np.abs(a[near] - b[near])
    print(f"phase long: calc_probs N={N_DRAWS} nsamples={NSAMPLES} on "
          f"{LONG_N_T} points (|t| < {LONG_WINDOW} d), {len(a)} rows: "
          f"schedule 2 (tab kernel) {walls['2'][0]:.3f} s first, "
          f"{walls['2'][1]:.4f} s warm (tracer on: {solved / walked:.4f} of "
          f"{walked} (draw, 32-point group) pairs solved); schedule 3 (v3 "
          f"tab kernel) "
          f"{walls['3'][0]:.3f} s first, {walls['3'][1]:.4f} s warm; "
          f"launches {counts['2']} / {counts['3']}; {int(near.sum())} rows "
          f"within {LONG_NEAR_NATS} nats of the winner "
          f"({names[np.argmax(a)]}), per-row |lnZ v3 - lnZ v2| max "
          f"{d.max():.3g}; FPP {t.FPP:.6g} (schedule 3)")
    print("phase long: lnZ v2 " + ", ".join(
        f"{n}={v:.4f}" for n, v in zip(names, a)))
    check(d.max() < 1e-2, f"phase long: v3 and v2 lnZ differ: "
          f"{dict(zip(names[near], d))}")
    return walls


def _lnz_rows(res):
    """Per-row lnZ of a scenario result: one dict, or (res, res_twin)."""
    rows = (res,) if isinstance(res, dict) else res
    return np.array([float(r["lnZ"]) for r in rows])


def phase_dormant(torch, chi2_core, workdir):
    """Phase 7: the four dormant scenarios on the TOI-465-like curve at
    N = 1e6, each with one seed on v2, on the plain path and under v3.
    Gates per row: |lnZ kernel - lnZ plain| and |lnZ v3 - lnZ v2| < 1e-2,
    only the schedule's tab counter rose, the plain path launched
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
        check(_only(c2, "launch.chi2_from_orbit_tab"),
              f"{name}: v2 must launch only the tab kernel: {c2}")
        check(_only(c3, "launch.chi2_from_orbit_v3_tab"),
              f"{name}: v3 must launch only the v3 tab kernel: {c3}")
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
    21 tab-kernel launches per run, FPP the mean of the runs."""
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
    check(_only(c, "launch.chi2_from_orbit_tab")
          and c["launch.chi2_from_orbit_tab"] == 63,
          f"the ensemble must make 63 tab-kernel launches: {c}")
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
                 launches=json.dumps(_counts(chi2_core)),
                 samplers=json.dumps(_sampler_launches(chi2_core)))
    finally:
        dist.destroy_process_group()


def phase_batch(torch, chi2_core, t465, workdir):
    """Phase 10: batch_fpp_full over 8 targets at N = 1e6 (ns = 20, n_t =
    100, sigma = 4e-4, the 3000-star field): phase 4's target with its two
    nearby stars, and seven one-star targets from seeded (Rp, P) rows
    (BATCH_RP, BATCH_P) through tools/catalog_replay.build_target. Each
    run must launch the tab kernel exactly once per computed row of the
    batch (15 plus 3 per nearby-star slot: one family program per row over
    all the targets) and nothing else, and one sampler kernel per branch
    each target samples (``_branches`` of its computed rows). Returns the
    warm run's tab-kernel and sampler launches."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from triceratops_tpu_torch.ops import lightcurve
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
    expected = 15 + 3 * max(len(e["nearby"]) for e in entries)
    kw = dict(N=N_DRAWS, n_t=n_t, ns=NSAMPLES, has_cc=has_cc, device="cuda")

    rows_computed = sum(15 + 3 * len(e["nearby"]) for e in entries)
    branches = _branches(rows_computed)

    def timed(mesh, b=batch):
        _reset(chi2_core)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sharding.batch_fpp_full(mesh, b, **kw)
        return (out, time.perf_counter() - t0,
                (_counts(chi2_core), _sampler_launches(chi2_core)))

    def launches_ok(c, what):
        c, s = c
        check(_only(c, "launch.chi2_from_orbit_tab")
              and c["launch.chi2_from_orbit_tab"] == expected,
              f"{what}: expected {expected} tab-kernel launches only, got "
              f"{c}")
        check(s == branches, f"{what}: expected sampler launches "
              f"{branches}, got {s}")

    cold, wall_cold, c_cold = timed(None)
    torch.cuda.reset_peak_memory_stats()
    warm, wall_warm, c_warm = timed(None)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches_ok(c_cold, "phase 10 (i) cold")
    launches_ok(c_warm, "phase 10 (i) warm")
    check(peak_gib <= BATCH_PEAK_GIB, f"phase 10 (i): the warm batch call "
          f"peaked at {peak_gib:.3f} GiB (limit {BATCH_PEAK_GIB})")
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
          f"{wall_warm / N_BATCH:.4f} s/target; "
          f"{c_warm[0]['launch.chi2_from_orbit_tab']} tab-kernel launches "
          f"per call (expected {expected}), sampler launches {c_warm[1]} "
          f"({rows_computed} rows computed); peak device "
          f"memory {peak_gib:.3f} GiB (DRAW_CAP 2^"
          f"{lightcurve.DRAW_CAP.bit_length() - 1}); cold vs warm max "
          f"|d lnZ| {rerun:.3g}")
    print("phase 10 (i): FPP " + ", ".join(f"{v:.4g}" for v in fpp)
          + "; NFPP " + ", ".join(f"{v:.4g}" for v in nfpp))

    walls, worst = [], 0.0
    for i, e in enumerate(entries):
        one, _, _ = sharding.prepare_target_batch([e], device="cuda")
        (_, _, lnZ1), wall, (c, s) = timed(None, one)
        walls.append(wall)
        rows_i = 15 + 3 * len(e["nearby"])
        check(_only(c, "launch.chi2_from_orbit_tab")
              and c["launch.chi2_from_orbit_tab"] == rows_i
              and s == _branches(rows_i),
              f"phase 10 (i) target {i} alone: {c}, sampler launches {s}")
        n = lnZ1.shape[1]
        check(np.array_equal(np.isneginf(lnZ1[0]), np.isneginf(lnZ[i, :n])),
              f"phase 10 (i) target {i}: -inf rows differ alone")
        fin = np.isfinite(lnZ1[0])
        d = float(np.max(np.abs(lnZ1[0][fin] - lnZ[i, :n][fin])))
        check(d <= BATCH_VS_ONE_NATS, f"phase 10 (i) target {i}: batch vs "
              f"alone, max |d lnZ| {d}")
        worst = max(worst, d)
    print(f"phase 10 (i): the same targets one at a time (B = 1 batches, "
          f"same seeds) {sum(walls):.4f} s = {sum(walls) / N_BATCH:.4f} "
          f"s/target; per-row lnZ vs the batch max |d| {worst:.3g} nats "
          f"(limit {BATCH_VS_ONE_NATS})")

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
        launches_ok((json.loads(str(r["launches"])),
                     json.loads(str(r["samplers"]))), "phase 10 (iii) rank")
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
          f"{expected} tab-kernel launches; per-row lnZ within the "
          f"statistical rule of (i), largest |d| within 5 nats of the winner "
          f"{worst:.3g}")
    return c_warm[0]["launch.chi2_from_orbit_tab"], c_warm[1]


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


# sampler phase: draws a branch (the main path's 1e6 rounded up to the
# draw tile, as lightcurve.orbit_chunk takes it), and the host stars the
# cases take, one on each branch of the mass-ratio laws (M_s >= 1,
# 0.3 <= M_s < 1 with periods above 10 d, 0.1 < M_s < 0.3 with one period
# as the batch path draws it, M_s <= 0.1)
N_SAMPLER = 1_000_192
SAMPLER_STARS = (
    dict(P_lo=2.0, P_hi=4.0, M_s=1.2, R_s=1.1, Teff=6100.0, plx=9.0),
    dict(P_lo=12.0, P_hi=20.0, M_s=0.6, R_s=0.6, Teff=4100.0, plx=21.0),
    dict(P_lo=1.3, P_hi=1.3, M_s=0.2, R_s=0.24, Teff=3200.0, plx=40.0),
    dict(P_lo=5.0, P_hi=6.0, M_s=0.09, R_s=0.12, Teff=2900.0, plx=60.0),
)
# (label, sampler, options): every branch of every sampler the rows run,
# MOLUSC rows and the companion law, with and without the conditioned twin
# draws, a TRILEGAL host and a diluting row, with and without a contrast
# curve; N // 4 twin draws (N // 2 for SEB), as api._twin_n
SAMPLER_VARIANTS = (
    ("TP", "sample_planet_target", dict(stratified=True)),
    ("TP.plain_inc", "sample_planet_target", dict(stratified=False)),
    ("EB", "sample_teb", dict(twin=4)),
    ("EB.shared", "sample_teb", dict(twin=0)),
    ("EB.plain_inc", "sample_teb", dict(twin=4, stratified=False)),
    ("PTP.molusc", "sample_ptp", dict(molusc=True)),
    ("PTP.law", "sample_ptp", dict(molusc=False)),
    ("PTP.law.cc", "sample_ptp", dict(molusc=False, cc=True)),
    ("STP.molusc", "sample_stp", dict(molusc=True)),
    ("STP.law", "sample_stp", dict(molusc=False, cc=True)),
    ("PEB.molusc", "sample_peb", dict(molusc=True, twin=4)),
    ("PEB.law", "sample_peb", dict(molusc=False, twin=4)),
    ("PEB.molusc.shared", "sample_peb", dict(molusc=True, twin=0)),
    ("PEB.law.shared", "sample_peb", dict(molusc=False, twin=0, cc=True)),
    ("SEB.molusc", "sample_seb", dict(molusc=True, twin=2)),
    ("SEB.law", "sample_seb", dict(molusc=False, twin=2)),
    ("SEB.molusc.shared", "sample_seb", dict(molusc=True, twin=0)),
    ("SEB.law.shared", "sample_seb", dict(molusc=False, twin=0, cc=True)),
    ("DTP", "sample_background_planet", dict(on_bg=False)),
    ("DTP.cc", "sample_background_planet", dict(on_bg=False, cc=True)),
    ("BTP", "sample_background_planet", dict(on_bg=True)),
    ("BTP.cc", "sample_background_planet", dict(on_bg=True, cc=True)),
    ("DEB", "sample_background_eb", dict(on_bg=False, twin=4)),
    ("DEB.shared.cc", "sample_background_eb",
     dict(on_bg=False, twin=0, cc=True)),
    ("BEB", "sample_background_eb", dict(on_bg=True, twin=4)),
    ("BEB.cc", "sample_background_eb", dict(on_bg=True, twin=4, cc=True)),
    ("BEB.shared", "sample_background_eb", dict(on_bg=True, twin=0)),
)


def sampler_inputs(torch, N, device, seed=0):
    """The cases' shared inputs on ``device``: MOLUSC mass ratios with
    half zero padding, a 400-row TRILEGAL pack (packs.BG_PACK_FIELDS
    order), the nearest-Z LDC grids to 10000 K (STP) and 13000 K (SEB), a
    contrast curve and the defaults without one."""
    from triceratops_tpu_torch.populations.ldc import grid_at_Z

    rng = np.random.default_rng(seed)
    f32 = np.float32

    def dev(a):
        return torch.as_tensor(np.asarray(a, f32), device=device)

    n = 400
    fr = rng.uniform(1e-3, 0.9, n)
    fr_cc = np.clip(fr * rng.uniform(0.5, 1.5, n), 1e-3, 0.95)
    pack = np.stack([fr, -2.5 * np.log10(fr / (1 - fr)),
                     rng.uniform(0.1, 2.5, n), rng.uniform(0.1, 3.0, n),
                     rng.uniform(3.0, 5.2, n), rng.uniform(2800, 12000, n),
                     rng.uniform(0.2, 0.5, n), rng.uniform(0.1, 0.3, n),
                     fr_cc], axis=1)
    qs = np.where(rng.random(N) < 0.5, rng.uniform(0.02, 1.0, N), 0.0)
    return dict(qs=dev(qs), bg={"pack": dev(pack)},
                ldc10=tuple(dev(t) for t in grid_at_Z(0.0, "TESS", 10000)),
                ldc13=tuple(dev(t) for t in grid_at_Z(0.0, "TESS", 13000)),
                cc=(dev([0.1, 0.2, 0.5, 1.0, 2.0, 3.0]),
                    dev([1.5, 3.0, 5.0, 6.5, 7.5, 8.0]), "J"),
                no_cc=(dev([2.2]), dev([1.0]), None))


def sampler_case(eng, inputs, variant, star, N):
    """(sampler, args, kwargs, launches by entry) of one variant at one of
    SAMPLER_STARS."""
    _, name, o = variant
    st = SAMPLER_STARS[star]
    f32 = np.float32
    P_lo, P_hi = st["P_lo"], st["P_hi"]
    M_s, R_s, Teff, plx = (f32(st[k]) for k in ("M_s", "R_s", "Teff", "plx"))
    seps, cons, cc_filt = inputs["cc" if o.get("cc") else "no_cc"]
    strat = o.get("stratified", True)
    div = o.get("twin", 0)
    kw = dict(N=N, stratified=strat)
    if name in ("sample_teb", "sample_peb", "sample_seb",
                "sample_background_eb"):
        kw["twin_n"] = N // div if div else 0
        launches = ({"eb": 1, "twin": 1} if div and strat else {"eb": 1})
    else:
        kw["flatpriors"] = False
        launches = {"planet": 1}
    comp = dict(use_molusc=o.get("molusc", False), cc_filt=cc_filt)
    qs = inputs["qs"]
    if name == "sample_planet_target":
        args = (P_lo, P_hi, M_s, R_s)
    elif name == "sample_teb":
        args = (P_lo, P_hi, M_s, R_s, Teff)
    elif name in ("sample_ptp", "sample_peb"):
        args = (P_lo, P_hi, M_s, R_s, Teff, plx, qs, seps, cons)
        kw.update(comp)
    elif name in ("sample_stp", "sample_seb"):
        u1_tab, u2_tab = inputs["ldc10" if name == "sample_stp" else "ldc13"]
        args = (P_lo, P_hi, M_s, R_s, Teff, plx, qs, u1_tab, u2_tab, seps,
                cons)
        kw.update(comp)
    else:
        base = (P_lo, P_hi, M_s, R_s)
        if name == "sample_background_eb":
            base += (Teff,)
            kw["cc_filt"] = cc_filt or "TESS"
        args = base + (inputs["bg"], seps, cons)
        kw.update(has_cc=cc_filt is not None, host_is_bg=o["on_bg"])
    return getattr(eng, name), args, kw, launches


def sampler_diffs(torch, want, got, path=""):
    """{field: (draws that differ, largest gap in float32 ulps)} between
    two sampler outputs (a twin dict under "twin."), NaN equal to NaN;
    empty when every field and mask is the same bit for bit."""
    out = {}
    if set(want) != set(got):
        out[path + "<keys>"] = (sorted(set(want) ^ set(got)), None)
    for key in want.keys() & got.keys():
        a, b = want[key], got[key]
        if isinstance(a, dict):
            out.update(sampler_diffs(torch, a, b, f"{path}{key}."))
            continue
        if (a.shape != b.shape or a.dtype != b.dtype):
            out[path + key] = (f"{a.dtype}{tuple(a.shape)} vs "
                               f"{b.dtype}{tuple(b.shape)}", None)
            continue
        if a.dtype != torch.float32:
            n = int((a != b).sum())
            if n:
                out[path + key] = (n, None)
            continue
        ai = a.contiguous().view(torch.int32).long()
        bi = b.contiguous().view(torch.int32).long()
        same = (ai == bi) | (torch.isnan(a) & torch.isnan(b))
        n = int((~same).sum())
        if n:
            out[path + key] = (n, int((ai - bi).abs()[~same].max()))
    return out


def sampler_bytes(torch, name, out):
    """The least bytes a sampler's launches move: each branch's uniform
    streams read (6 for the P* and S* samplers, else 5) and each distinct
    float32 field and bool mask of its output written once (the lattice
    permutations, drawn rows and tables not counted)."""
    streams = 6 if name in ("sample_ptp", "sample_stp", "sample_peb",
                            "sample_seb") else 5
    seen, total = set(), 0
    for br in [out] + ([out["twin"]] if "twin" in out else []):
        if br["P"].data_ptr() not in seen:
            total += 4 * streams * br["P"].numel()
        for v in br.values():
            if (torch.is_tensor(v) and v.dtype in (torch.float32, torch.bool)
                    and v.data_ptr() not in seen):
                seen.add(v.data_ptr())
                total += v.numel() * v.element_size()
    return total


def sampler_counts(profiling):
    return {k: v for k, v in profiling.counters().items()
            if k.startswith("launch.sampler.")}


def phase_samplers(torch):
    """Phase samplers: each variant of SAMPLER_VARIANTS at the first host
    star, N_SAMPLER draws, on the card: the sampler (its kernel launches)
    against its plain chain (``<sampler>.plain``) on generators of one
    seed, every field and mask bit for bit, and the launches of each entry
    (one a branch). Times, by CUDA events: ``ms`` the kernels alone (each
    launch of a call replayed on its recorded inputs by ``_median_ms``,
    summed over the call's launches; ``kernel_ms`` by entry), held to
    ``bound_ms`` (``sampler_bytes`` over PEAK_BYTES_S; operations not
    counted); ``call_ms`` and ``plain_ms`` the whole sampler call on each
    path (median of 3 calls: the kernel path's uniforms, lattice argsort,
    periods and priors in torch besides its launches; the plain chain's
    time its host dispatch)."""
    from triceratops_tpu_torch.ops import sampler_kernels as sk
    from triceratops_tpu_torch.scenarios import engine as eng
    from triceratops_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    sk.build(verbose=True)
    print(f"phase samplers: built the sampler library in "
          f"{time.perf_counter() - t0:.2f} s")
    inputs = sampler_inputs(torch, N_SAMPLER, "cuda")
    rows = []

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def timed(fn, args, kw):
        ms = []
        for seed in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(gen(100 + seed), *args, **kw)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        return sorted(ms)[1]

    def kernel_ms(fn, args, kw):
        """{entry: ms} of one call's launches, each alone: the call's
        sk.launch arguments recorded, then each launch replayed."""
        calls, launch = [], sk.launch

        def record(*a, **k):
            calls.append((a, k))
            return launch(*a, **k)

        sk.launch = record
        try:
            fn(gen(100), *args, **kw)
        finally:
            sk.launch = launch
        return {a[0]: round(_median_ms(torch, lambda: launch(*a, **k),
                                       reps=10), 4) for a, k in calls}

    for variant in SAMPLER_VARIANTS:
        fn, args, kw, launches = sampler_case(eng, inputs, variant, 0,
                                              N_SAMPLER)
        want = fn.plain(gen(1), *args, **kw)
        before = sampler_counts(profiling)
        got = fn(gen(1), *args, **kw)
        after = sampler_counts(profiling)
        torch.cuda.synchronize()
        rose = {k[len("launch.sampler."):]: v - before.get(k, 0)
                for k, v in after.items() if v != before.get(k, 0)}
        diffs = sampler_diffs(torch, want, got)
        check(not diffs, f"phase samplers: {variant[0]} differs from its "
              f"plain chain: {diffs}")
        check(rose == launches, f"phase samplers: {variant[0]} launched "
              f"{rose}, expected {launches}")
        nbytes = sampler_bytes(torch, fn.__name__, got)
        each = kernel_ms(fn, args, kw)
        check(each.keys() == launches.keys(), f"phase samplers: "
              f"{variant[0]} replayed {sorted(each)}, launched {launches}")
        row = dict(variant=variant[0], launches=rose,
                   ms=round(sum(each.values()), 4), kernel_ms=each,
                   bound_ms=round(1e3 * nbytes / PEAK_BYTES_S, 4),
                   bytes=nbytes, call_ms=round(timed(fn, args, kw), 4),
                   plain_ms=round(timed(fn.plain, args, kw), 4))
        rows.append(row)
        print(f"phase samplers: {row}")
    return rows


def kernel_rows(timing, launches, build_s):
    """The chi^2 kernels' rows of the ``kernels`` line."""
    # each kernel at the main path's shape (n_t = 100, GL-4): the plane
    # kernels at their old 16384-draw chunk, the orbit kernels at
    # orbit_chunk(1e6); no single PyTorch call computes this function, so
    # no library time. Launches: the tab kernel in phase 10's warm batch
    # call, the exact kernel in phase 5's TRICERATOPS_COEFFS=exact call,
    # orbit v2 in phase 5's torch-stage route, the v3 tab kernel in phase
    # v3's call and orbit v3 in its exact call, the plane kernels on no
    # path. The v3 orbit kernels' bound_ms is
    # window_bound's (the solve inside each draw's window only, what they
    # run), bound_ms_every_point a solve at every point
    src = "triceratops_tpu_torch/csrc/chi2_supersampled.cu"
    kernels = []
    for name, replaces in (
            ("chi2_supersampled", "triceratops_tpu/ops/pallas_core.py:120"),
            ("chi2_supersampled_v3", "triceratops_tpu/ops/pallas_core.py:267"),
            ("chi2_from_orbit", "triceratops_tpu/ops/pallas_core.py:120"),
            ("chi2_from_orbit_v3",
             "triceratops_tpu/ops/pallas_core.py:267"),
            ("chi2_from_orbit_tab",
             "triceratops_tpu/ops/pallas_core.py:120"),
            ("chi2_from_orbit_v3_tab",
             "triceratops_tpu/ops/pallas_core.py:267"),
            ("chi2_from_orbit_exact",
             "triceratops_tpu/ops/pallas_core.py:120")):
        k = timing["slice"][name]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": k["max_abs_err"], "ms": k["ms"],
               "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
               "bound_by": k["bound_by"], "library_ms": None,
               "build_s": build_s}
        for key in ("transpose_ms", "yardstick_ms", "C", "registers",
                    "local_bytes", "warps_per_sm", "bound_ms_every_point",
                    "skipped", "skipped_by_warps", "tab_ms"):
            if k.get(key) is not None:
                row[key] = k[key]
        if name in timing["targets"]:
            row[f"ms_b{N_BATCH}"] = timing["targets"][name]["ms"]
            row[f"bound_ms_b{N_BATCH}"] = timing["targets"][name]["bound_ms"]
        kernels.append(row)
    return kernels


def main():
    try:
        import torch
        import triceratops_tpu_torch.triceratops as tr
        from triceratops_tpu_torch.ops import chi2_core
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              "repository root", file=sys.stderr)
        return 2
    # each JSON line is printed as soon as the phases it reads have passed,
    # so a later phase's failure leaves it in the output
    try:
        phase_device(torch)
        build_s = phase_build(chi2_core)
        print(json.dumps({"samplers": phase_samplers(torch)}))
        phase_tf32_coeffs(torch)
        timing = phase_kernel(torch, chi2_core)
        timing["targets"] = phase_kernel_targets(torch, chi2_core,
                                                 timing["slice"])
        with tempfile.TemporaryDirectory() as workdir:
            launches, t, calc_samplers = phase_slice(
                torch, chi2_core, tr, workdir)
            phase_long(chi2_core, t)
            phase_dormant(torch, chi2_core, workdir)
            phase_ensemble(chi2_core, t)
            phase_likelihoods(torch)
            launches["chi2_from_orbit_tab"], batch_samplers = phase_batch(
                torch, chi2_core, t, workdir)
            print(json.dumps({"kernels": kernel_rows(timing, launches,
                                                     build_s)}))
            # the sampler kernels' launches on the main path: phase 4's
            # 21-row calc_probs call and phase 10's warm batch call
            print(json.dumps({"sampler_launches": {
                "calc_probs": calc_samplers, f"batch_b{N_BATCH}":
                batch_samplers}}))
            phase_parity()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
