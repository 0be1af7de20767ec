"""Kernel checks of the PyTorch port on one NVIDIA GPU that compare trees.

    python3 profile_port.py [--tree DIR] --v2-sweep tab,exact,copy
    python3 profile_port.py [--tree DIR] --tab-outputs FILE [--tab-against
                            FILE]

--tree imports the port (triceratops_tpu_torch) from another checkout,
e.g. an unpacked earlier commit, so that two trees are measured by the
same code in one run.
--v2-sweep times the named v2 orbit kernels (tab:
``chi2_from_orbit_tab``, the main path's; exact: ``chi2_from_orbit_exact``;
copy: ``chi2_from_orbit``) at the main path's chunk on chip_smoke.py's
seeded draws, GL-4, over curves of SWEEP_N_T evenly spaced exposures in
each half span of SWEEP_SPANS (the short-curve and the long-curve cells'
spans), with the share of (draw, group) pairs solved where the tree's
kernel is windowed.
--tab-outputs saves the tab kernel's per-draw outputs at chip_smoke.py's
phase-3 shapes (its draws at the main path's chunk) to FILE, and with
--tab-against compares them with another tree's saved outputs:
bit-identical, or the first draw that differs.

A call's time, idle share and launches come from the benchmark
(port_bench/run.py --trace 1, port_bench/spans.py).
"""

import argparse
import importlib.util
import sys
from pathlib import Path

# --v2-sweep: the curves' exposures and half spans [d]
SWEEP_N_T = (32, 64, 100, 256, 512, 1024, 2048, 8055)
SWEEP_SPANS = (0.15, 0.4)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None,
                    help="checkout to import triceratops_tpu_torch from")
    ap.add_argument("--v2-sweep", default=None,
                    help="these v2 orbit kernels' times over curve lengths "
                         "(comma-separated: tab, exact, copy)")
    ap.add_argument("--tab-outputs", default=None,
                    help="save the tab kernel's outputs at phase 3's shapes "
                         "to this file")
    ap.add_argument("--tab-against", default=None,
                    help="compare --tab-outputs with this file's")
    args = ap.parse_args()
    if not (args.v2_sweep or args.tab_outputs):
        ap.error("give --v2-sweep or --tab-outputs")
    here = Path(__file__).resolve().parent
    tree = Path(args.tree).resolve() if args.tree else here
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  here / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch
    import triceratops_tpu_torch.triceratops as tr

    smoke.phase_device(torch)
    print(f"profile_port: package {Path(tr.__file__).resolve().parent.parent}")
    if args.v2_sweep:
        v2_sweep(torch, smoke, args.v2_sweep.split(","))
    if args.tab_outputs:
        tab_outputs(torch, smoke, args.tab_outputs, args.tab_against)
    return 0


def v2_sweep(torch, smoke, kernels):
    """The median device time (chip_smoke.py's timer) of each v2 orbit
    kernel of ``kernels`` ("tab", "exact", "copy") at the main path's chunk
    over SWEEP_SPANS x SWEEP_N_T (module docstring), and where the tree's
    kernel is windowed the share of (draw, 32-point group) pairs it
    solved."""
    from triceratops_tpu_torch.ops import chi2_core
    from triceratops_tpu_torch.ops.lightcurve import orbit_chunk

    C = orbit_chunk(smoke.N_DRAWS)
    ns = smoke.NSAMPLES
    min_t = {k: getattr(chi2_core, "V2_WINDOW_MIN_T", None) for k in kernels}
    if "exact" in min_t:
        min_t["exact"] = getattr(chi2_core, "V2_EXACT_WINDOW_MIN_T",
                                 min_t["exact"])
    for span in SWEEP_SPANS:
        for n_t in SWEEP_N_T:
            orbit, rest, offs, wgts, kud = smoke._draws(torch, C, n_t, ns,
                                                        span, seed=0)
            kw = dict(offs=offs, wgts=wgts, ns=ns)
            calls = {
                "tab": lambda: chi2_core.chi2_from_orbit_tab(
                    *orbit, *kud, rest[5], **kw),
                "exact": lambda: chi2_core.chi2_from_orbit_exact(
                    *orbit, *kud, rest[5], **kw),
                "copy": lambda: chi2_core.chi2_from_orbit(*orbit, *rest,
                                                          **kw)}
            for name in kernels:
                ms = smoke._median_ms(torch, calls[name])
                solved = ""
                if min_t[name] is not None and n_t >= min_t[name]:
                    share = smoke.window_solved(chi2_core, calls[name])
                    solved = f", {share:.4f} of (draw, group) pairs solved"
                print(f"profile_port: {name} sweep |t| < {span} d n_t={n_t} "
                      f"C={C} nodes={len(offs)}: {ms:.4f} ms "
                      f"(median){solved}")


def tab_outputs(torch, smoke, path, against=None):
    """The tab kernel's per-draw outputs at chip_smoke.py's phase-3 shapes
    (shape i on its draws of seed i at the main path's chunk), saved to
    path; with ``against``, another tree's outputs saved there, each
    shape's compared bit for bit."""
    from triceratops_tpu_torch.ops import chi2_core
    from triceratops_tpu_torch.ops.lightcurve import orbit_chunk

    C = orbit_chunk(smoke.N_DRAWS)
    out = {}
    for i, (name, n_t, ns, window) in enumerate(smoke.KERNEL_SHAPES):
        orbit, rest, offs, wgts, kud = smoke._draws(torch, C, n_t, ns,
                                                    window, seed=i)
        out[name] = chi2_core.chi2_from_orbit_tab(
            *orbit, *kud, rest[5], offs=offs, wgts=wgts, ns=ns).cpu()
    torch.save(out, path)
    print(f"profile_port: tab kernel outputs at C={C} saved to {path}")
    if against is None:
        return
    ref = torch.load(against)
    for name, got in out.items():
        want = ref[name]
        differ = got.view(torch.int32) != want.view(torch.int32)
        if not differ.any():
            print(f"profile_port: tab kernel {name}: bit-identical to "
                  f"{against} ({got.numel()} draws)")
            continue
        i = int(torch.nonzero(differ)[0])
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max()
        print(f"profile_port: tab kernel {name}: {int(differ.sum())} of "
              f"{got.numel()} draws differ from {against}, the first draw "
              f"{i}: {got[i].item()!r} against {want[i].item()!r}; largest "
              f"relative difference {float(rel):.3g}")


if __name__ == "__main__":
    sys.exit(main())
