"""Wrappers the benchmark puts around the program's calls into its
likelihood cores and evidence reduction, from its own files.

``patched`` installs them on the module attributes an entry names
(``entries/*.py::wrap_points``) and restores the originals on exit. Four
uses, all in ``--trace 1`` runs or after the window: ``spans`` (a
``torch.profiler.record_function`` range around each core, the profiled
calls), ``HostSpans`` (host-clock time in the cores, the unprofiled
calls), ``Capture`` (sampled draws of each core and the reduction's
inputs, for ``check.py``) and ``Count`` (the work of each core, for
``roofline.py``).
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

from . import reference as ref
from . import samplers

CALL_SPAN = "port_bench.call"
CORE_SPAN = "port_bench.core."

# per-draw arguments of the cores, after (time, obs_dev, sigma)
PLANET_ARGS = ("k", "P", "a_R", "inc", "e", "w", "u1", "u2", "g", "mask")
EB_ARGS = ("k", "ksec", "P", "a_R", "inc", "e", "w", "u1", "u2", "g",
           "g_sec", "mask")


@contextlib.contextmanager
def patched(points, make):
    """Replace each (module, attr, kind) of ``points`` by make(kind, attr,
    original) where that returns a wrapper; restore on exit."""
    saved = []
    try:
        for mod, attr, kind in points:
            orig = getattr(mod, attr)
            w = make(kind, attr, orig)
            if w is not None:
                saved.append((mod, attr, orig))
                setattr(mod, attr, functools.wraps(orig)(w))
        yield
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


def spans(kind, attr, orig):
    """A profiler range around each core call."""
    if kind != "core":
        return None

    def w(*a, **kw):
        with torch.profiler.record_function(CORE_SPAN + attr):
            return orig(*a, **kw)
    return w


class HostSpans:
    """Host seconds inside the cores, by the host clock alone (no
    profiler): the traced run's unprofiled calls."""

    def __init__(self):
        self.seconds = 0.0

    def __call__(self, kind, attr, orig):
        if kind != "core":
            return None

        def w(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
        return w


def core_draws(attr, args, kw):
    """(time, per-draw tensors by name, veto) of one core call."""
    names = EB_ARGS if attr == "lnL_eb" else PLANET_ARGS
    draws = dict(zip(names, args[3:3 + len(names)]))
    veto = attr == "lnL_eb" and kw.get("apply_veto", True)
    return args[0], draws, veto


# the program's sampler functions and the scenario family each draws
SAMPLERS = {"sample_planet_target": "TP", "sample_teb": "EB",
            "sample_ptp": "PTP", "sample_peb": "PEB", "sample_stp": "STP",
            "sample_seb": "SEB", "sample_background_planet": "DTP",
            "sample_background_eb": "DEB"}
# the families whose draws of a drawn background star count as BTP / BEB
ON_BACKGROUND = {"DTP": "BTP", "DEB": "BEB"}
# per-draw fields of a sampler branch held to the reference
DRAW_FIELDS = ("P", "rps", "qs", "eccs", "argps", "incs", "masses", "radii",
               "fluxratios", "fluxratios_comp", "masses_comp", "radii_comp",
               "host_mass", "host_rad", "k", "ksec", "a_R", "inc_rad",
               "w_rad", "g", "g_pri", "g_sec")


def _weight(br):
    """A branch's log weight as the program reduces it: ln prior plus the
    importance weight."""
    return br["lnw"] + br["lnprior"] if "lnprior" in br else br["lnw"]


def _same(a, b):
    """Draws where two float tensors differ, NaN equal to NaN."""
    return int((~((a == b) | (torch.isnan(a) & torch.isnan(b)))).sum())


class Capture:
    """What the timed path did, for ``check.py``.

    Per core call and target: ``top`` draws of highest lnL and ``rand``
    seeded random draws, their inputs and the program's lnL, and the draw
    count. Per sampler call: the scenario family, the star it was handed,
    and per branch (the normal one; the twin 2P one of an EB family) its
    size, the uniforms, drawn star rows and MOLUSC rows at
    ``sampler_draws`` seeded draws, the
    program's draws and log weight there. Per reduction: its draw count,
    whether the weights it reduced are the samplers' bit for bit, and the
    reference's float64 evidence of the program's lnL + weight and, with
    ``control``, the control's (the reference's reduction in bfloat16)
    beside it."""

    def __init__(self, top, rand, seed, control=False, sampler_draws=512):
        self.top, self.rand, self.control = top, rand, control
        self.sampler_draws = sampler_draws
        self.gen = torch.Generator().manual_seed(seed)
        self.cores, self.evidence, self.evidence_control = [], [], []
        self.samplers, self.reductions, self.free_ints = [], [], []
        self._events = None
        self._groups, self._slots, self._k = {}, None, 0
        self._last_lnL = None

    def _reduce(self, rows, n, weights_ok):
        self.reductions.append(dict(n=n, weights_ok=weights_ok))
        self.evidence.append([ref.finalize(r) for r in rows])
        if self.control:
            self.evidence_control.append(
                [ref.finalize(r, torch.bfloat16) for r in rows])

    def _next_weights(self):
        """The samplers' weights the next reduction should reduce: the
        k-th branch since the last sampler calls, every call of its family
        in call order."""
        if self._slots is None:
            self._slots = [(kind, b) for kind, calls in self._groups.items()
                           for b in range(len(calls[0]))]
        if self._k >= len(self._slots):
            return None
        kind, b = self._slots[self._k]
        self._k += 1
        return torch.cat([calls[b].reshape(-1)
                          for calls in self._groups[kind]])

    def __call__(self, kind, attr, orig):
        if kind == "core":
            def w(*a, **kw):
                out = orig(*a, **kw)
                self._last_lnL = out
                self._core(attr, a, kw, out)
                return out
        elif kind == "finalize":
            def w(lnL, lnprior, gather):
                out = orig(lnL, lnprior, gather)
                want = self._next_weights()
                got = torch.as_tensor(lnprior, device=lnL.device)
                ok = (want is not None and want.shape == lnL.shape
                      and _same(got.expand_as(lnL), want) == 0)
                self._reduce([lnL.double() + got.double()], lnL.shape[0], ok)
                return out
        elif kind == "finalize_parts":
            def w(logw):
                out = orig(logw)
                want = self._next_weights()
                lnL = self._last_lnL
                ok = (want is not None and lnL is not None
                      and want.numel() == logw.numel()
                      and _same((lnL + want).view_as(logw), logw) == 0)
                self._reduce(list(logw.reshape(-1, logw.shape[-1])),
                             logw.shape[-1], ok)
                return out
        elif kind == "uniforms":
            def w(gen, n_streams, N):
                out = orig(gen, n_streams, N)
                if self._events is not None:
                    self._events.append(("u", out))
                return out
        elif kind == "randint":
            def w(gen, n, hi):
                out = orig(gen, n, hi)
                if self._events is not None:
                    self._events.append(("i", out))
                else:
                    self.free_ints.append(out.cpu())
                return out
        elif kind == "sampler":
            def w(*a, **kw):
                if self._k:
                    self._groups, self._slots, self._k = {}, None, 0
                self._events = []
                try:
                    d = orig(*a, **kw)
                    events = self._events
                finally:
                    self._events = None
                self._sampler(attr, a, kw, d, events)
                return d
        else:
            return None
        return w

    def _sampler(self, attr, args, kw, d, events):
        fam = SAMPLERS[attr]
        if kw.get("host_is_bg"):
            fam = ON_BACKGROUND[fam]
        branches = [d] + ([d["twin"]] if "twin" in d else [])
        self._groups.setdefault(fam, []).append(
            [_weight(br) for br in branches])
        star = dict(P_lo=float(args[1]), P_hi=float(args[2]),
                    M_s=float(args[3]), R_s=float(args[4]))
        if fam not in ("TP", "DTP", "BTP"):
            star["Teff"] = float(args[5])
        if fam in ("PTP", "PEB", "STP", "SEB"):
            star["plx"] = float(args[6])
        molusc = bool(kw.get("use_molusc"))
        rec = dict(kind=fam, star=star, row=len(self.cores), branches=[],
                   molusc=molusc)
        ev = iter(events)
        lattice = samplers.LATTICE[fam]
        for j, br in enumerate(branches):
            n = br["P"].shape[0]
            idx = torch.randint(0, n, (self.sampler_draws,),
                                generator=self.gen)
            streams = next(x for t, x in ev if t == "u")
            u = [s.double() for s in streams]
            if lattice[j] is not None:
                r = next(x for t, x in ev if t == "u")
                u = samplers.lattice(u, r, lattice[j], n)
            at = idx.to(br["P"].device)
            rows = pos = None
            if fam in samplers.BACKGROUND:
                rows = next(x for t, x in ev if t == "i")[at].cpu()
            if molusc and fam in ("PTP", "PEB", "STP", "SEB"):
                # the posterior row each draw takes: its own index, or the
                # index a twin draw set draws
                pos = (next(x for t, x in ev if t == "i")[at].cpu() if j
                       else idx.clone())
            rec["branches"].append(dict(
                n=n, twin=j == 1, rows=rows, pos=pos,
                u=[x[at].cpu() for x in u],
                draws={f: br[f][at].double().cpu() for f in DRAW_FIELDS
                       if f in br and torch.is_tensor(br[f])
                       and br[f].dim() == 1},
                mask=br["mask"][at].cpu(),
                weight=_weight(br)[at].double().cpu()))
        self.samplers.append(rec)

    def _core(self, attr, args, kw, out):
        time, draws, veto = core_draws(attr, args, kw)
        B = time.shape[0] if time.dim() == 2 else 1
        N = out.numel() // B
        per_target = []
        for b in range(B):
            lnl = out[b * N:(b + 1) * N].detach()
            fin = torch.where(torch.isfinite(lnl), lnl,
                              torch.full_like(lnl, -float("inf")))
            top = torch.topk(fin, min(self.top, N)).indices
            rnd = torch.randint(0, N, (self.rand,), generator=self.gen)
            idx = torch.unique(torch.cat([top.cpu(), rnd])).to(lnl.device)
            per_target.append(dict(
                lnL=lnl[idx].double().cpu(),
                draws={n: v[b * N:(b + 1) * N][idx].detach().clone()
                       for n, v in draws.items()}))
        self.cores.append(dict(attr=attr, veto=veto, targets=per_target,
                               n=[v.shape[0] // B for v in draws.values()]
                               + [N]))


def sampler_points(engine):
    """(module, attribute, kind) of the program's samplers and the seams
    their uniforms and drawn star rows pass through."""
    return ([(engine, "_uniforms", "uniforms"), (engine, "_randint",
                                                  "randint")]
            + [(engine, name, "sampler") for name in SAMPLERS])


class Count:
    """The chi^2 work of each core call (``roofline.core_work``)."""

    def __init__(self, work):
        self.work, self.calls = work, []

    def __call__(self, kind, attr, orig):
        if kind != "core":
            return None

        def w(*a, **kw):
            time, draws, _ = core_draws(attr, a, kw)
            self.calls.append(self.work(time, draws, kw))
            return orig(*a, **kw)
        return w
