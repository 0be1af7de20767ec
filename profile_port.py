"""Profile warm calc_probs calls of the PyTorch port on one NVIDIA GPU.

First times the tree's plane v2 kernel (``chi2_supersampled``, in every
tree since the first) at 16384 draws x 100 points, GL-4, with
chip_smoke.py's timer. Then builds chip_smoke.py's configuration
(bench.py's TOI-465-like target, a 3000-star synthetic TRILEGAL field
and two nearby stars; N = 1e6, nsamples = 20), makes one warm-up call,
prints chip_smoke.py's phase 6 (three warm calls, seeds 2, 3, 4, and
their median), then runs chip_smoke.py's profile phase on the kernel path
(``backend="auto"``): an unprofiled warm call for the wall, and a call
under torch.profiler for the kernel launches, device time, idle share,
CUDA kernel count, the top device ops and the host ranges.

    python3 profile_port.py [--tree DIR] [--walls] [--schedule 3]
                            [--coeffs exact]

--tree imports the port (triceratops_tpu_torch) from another checkout,
e.g. an unpacked earlier commit, so that two trees are profiled by the
same code in one run. --walls skips the kernel timing and the profile
and prints only the warm walls. --schedule 3 runs every call under the
v3 chi^2 schedule (ops/lightcurve.py::CHI2_SCHEDULE, what
TRICERATOPS_PALLAS_V=3 selects). --coeffs exact runs every call on exact
deficit coefficients (ops/fastcore.py::COEFFS_BACKEND, what
TRICERATOPS_COEFFS=exact selects). The plain torch path's profile is
``chip_smoke.py --profile``.
"""

import argparse
import importlib.util
import sys
import tempfile
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None,
                    help="checkout to import triceratops_tpu_torch from")
    ap.add_argument("--walls", action="store_true",
                    help="only the warm walls of chip_smoke.py's phase 6")
    ap.add_argument("--schedule", choices=("2", "3"), default="2",
                    help="the chi^2 kernel schedule of every call")
    ap.add_argument("--coeffs", choices=("auto", "tab", "exact"),
                    default="auto",
                    help="the deficit coefficients of every call")
    args = ap.parse_args()
    here = Path(__file__).resolve().parent
    tree = Path(args.tree).resolve() if args.tree else here
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  here / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch
    import triceratops_tpu_torch.triceratops as tr
    from triceratops_tpu_torch.ops import fastcore, lightcurve

    lightcurve.CHI2_SCHEDULE = args.schedule
    fastcore.COEFFS_BACKEND = args.coeffs
    smoke.phase_device(torch)
    print(f"profile_port: package {Path(tr.__file__).resolve().parent.parent}"
          f", schedule {args.schedule}, coefficients {args.coeffs}")
    if not args.walls:
        plane_kernel_ms(torch, smoke)
    with tempfile.TemporaryDirectory() as workdir:
        _, run = smoke.make_run(tr, workdir)
        print(f"profile_port: first call {run(1):.3f} s")
        torch.cuda.reset_peak_memory_stats()
        walls = [run(seed) for seed in (2, 3, 4)]
        print(f"profile_port: warm calc_probs walls {walls} s, median "
              f"{sorted(walls)[1]:.4f} s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if not args.walls:
            smoke.phase_profile(torch, run, ("auto",))
    return 0


def plane_kernel_ms(torch, smoke):
    """chip_smoke.py's timing of chi2_supersampled on the planes of its
    seeded n_t = 100 draws (fastcore.exposure_z2_poly, the same in every
    tree)."""
    from triceratops_tpu_torch.ops import chi2_core
    from triceratops_tpu_torch.ops.fastcore import exposure_z2_poly

    C, n_t = 16384, 100
    orbit, rest, offs, wgts, _ = smoke._draws(torch, C, n_t, smoke.NSAMPLES,
                                              0.15, seed=0)
    q0, q1, q2, front = exposure_z2_poly(orbit[0], 0.0, *orbit[1:])
    planes = (q0.contiguous(), q1.contiguous(), q2.contiguous(),
              front.to(q0.dtype))
    ms = smoke._median_ms(torch, lambda: chi2_core.chi2_supersampled(
        *planes, *rest, offs=offs, wgts=wgts))
    print(f"profile_port: chi2_supersampled C={C} n_t={n_t} "
          f"nodes={len(offs)}: {ms:.4f} ms (median)")


if __name__ == "__main__":
    sys.exit(main())
