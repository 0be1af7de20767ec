"""Multi-target, multi-process execution: target batches x draw shards.

Counterpart of the JAX package's ``parallel/sharding.py``. The workload's
two parallel axes map onto a 2-D grid of processes started by the caller
(``torchrun``, ``torch.multiprocessing``), one per card or CPU worker,
joined by ``torch.distributed``:

* ``targets`` -- a catalog of candidates is embarrassingly parallel: each
  target shard takes a contiguous block of the batch, and its per-target
  reductions stay local;
* ``draws`` -- one target's Monte-Carlo draws split over the draw shards;
  the only communication is the evidence reduction, a max / sum
  logsumexp over the shards (``_combine_lnZ``).

Rank r sits at (r // n_draws, r % n_draws), the row-major layout of the
JAX package's ``devs.reshape(nt, nd)``. ``mesh=None`` is this process
alone: no collective and no process group.

Each rank runs one program per scenario family over all of its targets,
the counterpart of the JAX package's ``_build_family_step`` (a
``jax.vmap`` over the targets): each target samples on its own
generators, the targets' draw sets are concatenated, and each computed
row runs one batched likelihood core (``ops/lightcurve.py``), on a CUDA
tensor one chi^2 kernel launch over all the targets (up to
``lightcurve.DRAW_CAP`` draws); the evidence parts are reduced per target
in one (B_local, N_local) pass, and the results stay on the device until
one transfer at the end. Every (target, draw shard, scenario family)
draws from its own ``torch.Generator``, seeded from
``SeedSequence([seed, d_idx, slot...])`` with the JAX package's key layout
as the slots, so a draw shard's stream does not depend on the grid's
other ranks or on the other targets of its batch.

Spans (``utils/profiling.py``): ``batch_fpp_full`` in ``tri.call``, each
family in ``tri.row.<family>`` (NTP and NEB a nearby slot), the
reductions in ``tri.reduce``, the final read in ``tri.gather``;
``prepare_target_batch`` in ``tri.batch.prepare``, ``target_entry`` in
``tri.batch.entry``.

``batch_fpp_tp_eb`` runs the (TP, EB, EBx2P) set; ``batch_fpp_full`` the
15 target-star scenarios plus NTP / NEB / NEBx2P per nearby star (the
whole calc_probs taxonomy); ``prepare_target_batch`` assembles the
stacked per-target inputs, and ``target_entry`` one target's from a
frontend ``target``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..constants import G, MSUN, RSUN
from ..funcs import renorm_flux
from ..ops.lightcurve import lnL_planet, lnL_eb
from ..populations.ldc import lookup_target, grid_at_Z
from ..populations.molusc import load_molusc_kept
from ..scenarios import engine as eng
from ..scenarios.api import _prep_background
from ..utils import profiling

F32 = np.float32


@dataclass(frozen=True)
class Mesh:
    """A ('targets', 'draws') process grid as this rank sees it.

    ``shape`` is {"targets": nt, "draws": nd}; (t_idx, d_idx) is this
    rank's place (None for a rank past nt * nd). ``targets_group`` joins
    the ranks of this rank's draw shard across target shards (the results'
    gather), ``draws_group`` the ranks of its target shard (the evidence
    reduction); both are None without a process group."""
    shape: dict
    rank: int
    t_idx: int | None
    d_idx: int | None
    targets_group: object = None
    draws_group: object = None
    backend: str | None = None


def make_mesh(n_devices: int | None = None, n_target_shards: int = 1):
    """A ('targets', 'draws') grid over the first ``n_devices`` ranks of
    the default process group (all of them by default; one, this process,
    when ``torch.distributed`` is not initialized). Every rank must call
    it, in the same order: it creates every group of the grid."""
    on = dist.is_initialized()
    world = dist.get_world_size() if on else 1
    rank = dist.get_rank() if on else 0
    n = min(n_devices or world, world)
    nt = n_target_shards
    nd = n // nt
    if nd < 1:
        raise ValueError(
            f"mesh needs >= {nt} ranks for {nt} target shards but only {n} "
            f"are available (world size {world}; start more processes or "
            "pass fewer target shards)")
    inside = rank < nt * nd
    t_idx, d_idx = (rank // nd, rank % nd) if inside else (None, None)
    targets_group = draws_group = None
    if on:
        for d in range(nd):
            g = dist.new_group([t * nd + d for t in range(nt)])
            if d == d_idx:
                targets_group = g
        for t in range(nt):
            g = dist.new_group([t * nd + d for d in range(nd)])
            if t == t_idx:
                draws_group = g
    return Mesh(shape={"targets": nt, "draws": nd}, rank=rank, t_idx=t_idx,
                d_idx=d_idx, targets_group=targets_group,
                draws_group=draws_group,
                backend=dist.get_backend() if on else None)


def _place(mesh):
    """(nt, nd, t_idx, d_idx) of this rank; (1, 1, 0, 0) without a mesh."""
    if mesh is None:
        return 1, 1, 0, 0
    if mesh.t_idx is None:
        raise ValueError(f"rank {mesh.rank} is outside the "
                         f"{mesh.shape['targets']} x {mesh.shape['draws']} "
                         "grid")
    return mesh.shape["targets"], mesh.shape["draws"], mesh.t_idx, mesh.d_idx


def _wire(x, mesh):
    """The tensor the mesh's backend communicates: a CPU copy under gloo
    (which has no CUDA all_gather), the tensor itself under NCCL."""
    return x.cpu() if mesh.backend == "gloo" else x


@profiling.span("tri.reduce")
def _local_lnZ_parts(lnL):
    """(local max, local scaled sumexp) along the last axis, for a
    distributed logsumexp: (B,) tensors for a (B, N) block of B targets'
    draws, 0-d ones for a row of draws."""
    finite = torch.isfinite(lnL)
    safe = torch.where(finite, lnL, torch.full_like(lnL, -math.inf))
    m = torch.amax(safe, dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.full_like(m, -1e30))
    s = torch.sum(torch.where(finite, torch.exp(safe - m_safe[..., None]),
                              torch.zeros_like(lnL)), dim=-1)
    return m_safe, s


def _cat(ds, *names):
    """Each named per-draw array of the targets' draw dicts ``ds``,
    concatenated target-major."""
    return [torch.cat([d[n] for d in ds]) for n in names]


@profiling.span("tri.reduce")
def _combine_lnZ(m, s, ln_n_total, mesh):
    """Cross-rank logsumexp - log(N_total) over the draws axis, for a
    whole (B_local, R) block of (m, s) in one all_reduce(MAX) and one
    all_reduce(SUM); ``ln_n_total`` is (R,). -inf where S == 0."""
    M = m
    if mesh is not None:
        M = _wire(m, mesh).clone()
        dist.all_reduce(M, op=dist.ReduceOp.MAX, group=mesh.draws_group)
        S = _wire(s, mesh) * torch.exp(_wire(m, mesh) - M)
        dist.all_reduce(S, op=dist.ReduceOp.SUM, group=mesh.draws_group)
        M, S = M.to(m.device), S.to(m.device)
    else:
        S = s * torch.exp(m - M)
    lnZ = M + torch.log(S) - ln_n_total
    return torch.where(S > 0.0, lnZ, torch.full_like(lnZ, -math.inf))


def _gather_targets(lnZ, mesh):
    """(B, R) from every target shard's (B_local, R) block, in target
    order, on every rank."""
    if mesh is None:
        return lnZ
    w = _wire(lnZ, mesh)
    parts = [torch.empty_like(w) for _ in range(mesh.shape["targets"])]
    dist.all_gather(parts, w, group=mesh.targets_group)
    return torch.cat(parts).to(lnZ.device)


def _generator(seed, d_idx, *slot, device):
    """The torch.Generator of one (target seed, draw shard, key slot): seeded
    with ``SeedSequence([seed, d_idx, *slot])``'s first 32-bit word, as
    ``frontend.target.ensemble_seed`` seeds a run."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(
        [int(seed), int(d_idx), *slot]).generate_state(1)[0]))
    return g


def _grid_checks(mesh, N, B):
    nt, nd, t_idx, d_idx = _place(mesh)
    if N % nd:
        raise ValueError(f"N={N} must divide the draws axis ({nd})")
    if B % nt:
        raise ValueError(f"B={B} targets must divide the targets axis ({nt})")
    return nt, nd, t_idx, d_idx


def batch_fpp_tp_eb(mesh, keys, times, obs_dev, sigmas, P_orbs, M_ss, R_ss,
                    Teffs, u1s, u2s, *, N: int, n_t: int, ns: int,
                    chunk: int | None = None, exptime: float = 0.00139,
                    device="cuda"):
    """FPP over the (TP, EB, EBx2P) scenario set for a batch of targets.

    The batch splits over 'targets'; each target's N draws split over
    'draws' (N / n_d per shard, i.i.d. per shard from its own generators:
    slot 0 for TP, 1 for EB, as the JAX package's split(fold_in(key, d),
    2)). Returns numpy (FPP (B,), lnZ (B, 3)), FPP = 1 - P(TP), on every
    rank.

    Args are per-target: keys (B,) int seeds, times (B, n_t) exposure
    centers, obs_dev (B, n_t) flux - 1, the rest (B,). ``chunk`` is for
    the CPU route: without it a CUDA core runs one kernel launch over the
    rank's targets (``lightcurve._core_chunk``, ``DRAW_CAP``)."""
    keys = np.asarray(keys)
    nt, nd, t_idx, d_idx = _grid_checks(mesh, N, len(keys))
    N_local = N // nd
    B_local = len(keys) // nt
    twin_local = max(N_local // eng.TWIN_DIV, 1)
    kw = dict(exptime=exptime, n_t=n_t, ns=ns, chunk=chunk)
    mine = slice(t_idx * B_local, (t_idx + 1) * B_local)
    sigma, P_orb, M_s, R_s, Teff, u1, u2 = (
        np.asarray(a, F32)[mine] for a in (sigmas, P_orbs, M_ss, R_ss, Teffs,
                                           u1s, u2s))
    time = torch.as_tensor(np.asarray(times, F32)[mine], device=device)
    obs = torch.as_tensor(np.asarray(obs_dev, F32)[mine], device=device)

    def per_draw(v, n):
        return torch.as_tensor(np.repeat(v, n), device=device)

    tp, eb = [], []
    for i, seed in enumerate(keys[mine]):
        tp.append(eng.sample_planet_target(
            _generator(seed, d_idx, 0, device=device), P_orb[i], P_orb[i],
            M_s[i], R_s[i], N=N_local, flatpriors=False))
        eb.append(eng.sample_teb(
            _generator(seed, d_idx, 1, device=device), P_orb[i], P_orb[i],
            M_s[i], R_s[i], Teff[i], N=N_local, twin_n=twin_local))
    tw = [e["twin"] for e in eb]
    lnL_tp = lnL_planet(time, obs, sigma, *_cat(tp, "k", "P", "a_R",
                                                "inc_rad", "eccs", "w_rad"),
                        per_draw(u1, N_local), per_draw(u2, N_local),
                        torch.ones((B_local * N_local,), device=device),
                        *_cat(tp, "mask"), **kw)
    lnL_eb_ = lnL_eb(time, obs, sigma, *_cat(
        eb, "k", "ksec", "P", "a_R", "inc_rad", "eccs", "w_rad"),
        per_draw(u1, N_local), per_draw(u2, N_local),
        *_cat(eb, "g_pri", "g_sec", "mask"), apply_veto=True, **kw)
    k, ksec, P = _cat(tw, "k", "ksec", "P")
    lnL_twin = lnL_eb(time, obs, sigma, k, ksec, 2.0 * P, *_cat(
        tw, "a_R", "inc_rad", "eccs", "w_rad"), per_draw(u1, twin_local),
        per_draw(u2, twin_local), *_cat(tw, "g_pri", "g_sec", "mask"),
        apply_veto=False, **kw)
    parts = [_local_lnZ_parts((lnL + lnw).view(B_local, -1)) for lnL, lnw in (
        (lnL_tp, *_cat(tp, "lnw")), (lnL_eb_, *_cat(eb, "lnw")),
        (lnL_twin, *_cat(tw, "lnw")))]
    ms = torch.stack([p[0] for p in parts], dim=1)
    ss = torch.stack([p[1] for p in parts], dim=1)
    ln_n = torch.tensor([math.log(N), math.log(N),
                         math.log(twin_local * nd)], dtype=torch.float32,
                        device=device)
    lnZ = _gather_targets(_combine_lnZ(ms, ss, ln_n, mesh), mesh)
    probs = torch.exp(lnZ - torch.logsumexp(lnZ, dim=1, keepdim=True))
    out = torch.cat([1.0 - probs[:, :1], lnZ], dim=1).cpu().numpy()
    return out[:, 0], out[:, 1:]


# ---------------------------------------------------------------------------
# Full 15-scenario batch FPP (the complete target-star taxonomy)
# ---------------------------------------------------------------------------

# scenario row order = the reference's calc_probs target-star block
# (triceratops.py:797-1340)
FULL_SCENARIOS = ("TP", "EB", "EBx2P", "PTP", "PEB", "PEBx2P",
                  "STP", "SEB", "SEBx2P", "DTP", "DEB", "DEBx2P",
                  "BTP", "BEB", "BEBx2P")

# scenario family -> FULL_SCENARIOS row indices it produces
_FAMILY_ROWS = (("TP", (0,)), ("EB", (1, 2)), ("PTP", (3,)),
                ("PEB", (4, 5)), ("STP", (6,)), ("SEB", (7, 8)),
                ("DTP", (9,)), ("DEB", (10, 11)), ("BTP", (12,)),
                ("BEB", (13, 14)))

# the generator slots of each family (the JAX package's key layout:
# ks = split(fold_in(key, d_idx), 8), BTP / BEB on fold_in(ks[6 | 7], 1))
_FAMILY_SLOTS = {"TP": (0,), "EB": (1,), "PTP": (2,), "PEB": (3,),
                 "STP": (4,), "SEB": (5,), "DTP": (6,), "DEB": (7,),
                 "BTP": (6, 1), "BEB": (7, 1)}
_MOLUSC_SLOT = 424242
_NEARBY_SLOT = 100


def _logg(M_s, R_s):
    return float(np.log10(G * (M_s * MSUN) / (R_s * RSUN) ** 2))


@profiling.span("tri.batch.prepare")
def prepare_target_batch(targets: list[dict], mission: str = "TESS",
                         device="cuda"):
    """Stack per-target host inputs into the batch dict of
    ``batch_fpp_full``; returns (batch, n_t, has_cc).

    Each element of ``targets`` is a dict with keys: time (n_t,), flux
    (n_t,), sigma, P_orb, M_s, R_s, Teff, Z, plx, Tmag, Jmag, Hmag, Kmag,
    trilegal_fname, and optionally key (an int seed; default the target's
    index), filt (the band of the background delta-mags, default "TESS"),
    contrast_curve ((seps, |delta mag|) arrays), molusc_file and nearby --
    a list of dicts (mass, rad, Teff, Z, fluxratio, tdepth) for the
    resolved nearby stars that passed the tdepth > 0 gate (NaN stellar
    properties get the solar fallbacks M = R = 1, Teff = 5780). Light
    curves must share one n_t.

    Curves, contrast curves, LDC grids and MOLUSC rows become tensors on
    ``device``; per-target scalars stay host float32 arrays. Each target
    keeps its own TRILEGAL table (``batch["bg"][i]``, n_comp rows): each
    target's samplers run on their own, so nothing is padded. Contrast curves
    are padded to the longest by repeating the last point; MOLUSC rows to
    the longest with zeros (the true counts in ``molusc_kept``); nearby
    slots to the largest count with valid = False. The MOLUSC switch is
    batch-wide: every target carries a molusc_file or none does."""
    B = len(targets)
    n_t = len(targets[0]["time"])
    if any(len(t["time"]) != n_t for t in targets):
        raise ValueError("light curves of one batch must share one n_t: "
                         f"{sorted({len(t['time']) for t in targets})}")
    dev = torch.device(device)

    def tens(a):
        return torch.as_tensor(np.asarray(a, F32), device=dev)

    bg, ncomp = [], []
    for t in targets:
        bg_i, n_i = _prep_background(t["trilegal_fname"], t["Tmag"],
                                     t["Jmag"], t["Hmag"], t["Kmag"], mission,
                                     t.get("filt", "TESS"), True, dev,
                                     need_cc_ratio=True)
        bg.append(bg_i)
        ncomp.append(n_i)

    u1 = np.zeros(B, F32)
    u2 = np.zeros(B, F32)
    tabs10, tabs13 = [], []
    for i, t in enumerate(targets):
        u1[i], u2[i] = lookup_target(t["Z"], t["Teff"],
                                     _logg(t["M_s"], t["R_s"]), mission)
        tabs10.append(grid_at_Z(t["Z"], mission, teff_max=10000))
        tabs13.append(grid_at_Z(t["Z"], mission, teff_max=13000))

    has_cc = any("contrast_curve" in t for t in targets)
    n_cc = max((len(t["contrast_curve"][0]) for t in targets
                if "contrast_curve" in t), default=1)
    seps = np.full((B, n_cc), 2.2, F32)
    cons = np.full((B, n_cc), 1.0, F32)
    for i, t in enumerate(targets):
        if "contrast_curve" in t:
            s_i, c_i = (np.asarray(a, F32) for a in t["contrast_curve"])
            pad = n_cc - len(s_i)
            seps[i] = np.concatenate([s_i, np.repeat(s_i[-1:], pad)])
            cons[i] = np.concatenate([c_i, np.repeat(c_i[-1:], pad)])

    def col(name):
        return np.asarray([t[name] for t in targets], dtype=F32)

    batch = dict(
        key=np.asarray([t.get("key", i) for i, t in enumerate(targets)],
                       np.int64),
        time=tens(np.stack([np.asarray(t["time"], F32) for t in targets])),
        obs_dev=tens(np.stack([np.asarray(t["flux"], np.float64) - 1.0
                               for t in targets])),
        sigma=col("sigma"), P_orb=col("P_orb"), M_s=col("M_s"),
        R_s=col("R_s"), Teff=col("Teff"), plx=col("plx"), u1=u1, u2=u2,
        u1_tab10=tens(np.stack([a for a, _ in tabs10])),
        u2_tab10=tens(np.stack([b for _, b in tabs10])),
        u1_tab13=tens(np.stack([a for a, _ in tabs13])),
        u2_tab13=tens(np.stack([b for _, b in tabs13])),
        bg=bg, n_comp=np.asarray(ncomp, np.int32),
        seps=tens(seps), cons=tens(cons),
    )
    n_molusc = sum("molusc_file" in t for t in targets)
    if n_molusc not in (0, B):
        raise ValueError(
            f"molusc_file set on {n_molusc}/{B} targets: the molusc "
            "switch is batch-wide (all targets or none)")
    if n_molusc:
        with profiling.span("tri.io.molusc"):
            kept = [load_molusc_kept(t["molusc_file"], t["M_s"])
                    for t in targets]
            n_q = max(max(len(q) for q in kept), 1)
            batch["molusc_qs"] = tens(np.stack(
                [np.pad(np.asarray(q, F32), (0, n_q - len(q)))
                 for q in kept]))
        batch["molusc_kept"] = np.asarray([len(q) for q in kept], np.int32)

    K = max((len(t.get("nearby", ())) for t in targets), default=0)
    if K > 0:
        nb = {k: np.zeros((B, K), F32) for k in
              ("M_s", "R_s", "Teff", "u1", "u2", "fluxratio")}
        nb["valid"] = np.zeros((B, K), bool)
        nb["fluxratio"][:] = 1.0
        nb["M_s"][:] = 1.0
        nb["R_s"][:] = 1.0
        nb["Teff"][:] = 5780.0
        for i, t in enumerate(targets):
            for kk, s in enumerate(t.get("nearby", ())):
                m_k = s.get("mass", np.nan)
                r_k = s.get("rad", np.nan)
                T_k = s.get("Teff", np.nan)
                nb["M_s"][i, kk] = 1.0 if np.isnan(m_k) else m_k
                nb["R_s"][i, kk] = 1.0 if np.isnan(r_k) else r_k
                nb["Teff"][i, kk] = 5780.0 if np.isnan(T_k) else T_k
                nb["fluxratio"][i, kk] = s["fluxratio"]
                nb["valid"][i, kk] = True
                logg = _logg(float(nb["M_s"][i, kk]), float(nb["R_s"][i, kk]))
                nb["u1"][i, kk], nb["u2"][i, kk] = lookup_target(
                    s.get("Z", 0.0), nb["Teff"][i, kk], logg, mission)
        batch["nearby"] = nb
    return batch, n_t, has_cc


@profiling.span("tri.batch.entry")
def target_entry(t, time, flux, sigma, P_orb, key=None, Z=0.0):
    """The ``prepare_target_batch`` dict of a frontend ``target`` that
    ``calc_depths`` has run on, set up as ``calc_probs`` sees it: the
    curve renormalized by the target's own flux ratio fr0 (``renorm_flux``)
    and each nearby star past the tdepth > 0 gate with its flux ratio over
    fr0, since the batch path divides the target's curve by a nearby
    star's ratio where ``calc_probs`` renormalizes the raw curve."""
    st = t.stars[t.stars["tdepth"] > 0]
    fr0 = float(st["fluxratio"].values[0])
    flux_r, sigma_r = renorm_flux(np.asarray(flux), sigma, fr0)
    s0 = st.iloc[0]
    entry = dict(
        time=np.asarray(time), flux=flux_r, sigma=sigma_r, P_orb=P_orb,
        M_s=s0["mass"], R_s=s0["rad"], Teff=s0["Teff"], Z=Z, plx=s0["plx"],
        Tmag=s0["Tmag"], Jmag=s0["Jmag"], Hmag=s0["Hmag"], Kmag=s0["Kmag"],
        trilegal_fname=t.trilegal_fname,
        nearby=[dict(mass=s["mass"], rad=s["rad"], Teff=s["Teff"], Z=Z,
                     fluxratio=s["fluxratio"] / fr0, tdepth=s["tdepth"])
                for _, s in st.iloc[1:].iterrows()])
    if key is not None:
        entry["key"] = key
    return entry


def _n_rows(batch):
    nearby = batch.get("nearby")
    return 15 + (3 * nearby["valid"].shape[1] if nearby is not None else 0)


@profiling.span("tri.call")
def batch_fpp_full(mesh, batch: dict, *, N: int, n_t: int, ns: int,
                   chunk: int | None = None, exptime: float = 0.00139,
                   flatpriors: bool = False, has_cc: bool = False,
                   cc_filt: str | None = None, drop_scenario: tuple = (),
                   device="cuda"):
    """FPP / NFPP over the full scenario taxonomy for a batch of targets:
    the 15 target-star scenarios plus NTP / NEB / NEBx2P per nearby-star
    slot when the batch carries a 'nearby' block (reference
    triceratops.py:716-1428).

    ``mesh`` is a ``make_mesh`` grid or None (this process alone). The
    batch splits over 'targets' (B % nt == 0), each target's N draws over
    'draws' (N % nd == 0); the only communication is one all_reduce(MAX)
    and one all_reduce(SUM) of every local row's (max, scaled sum) over
    the draw shards, and one all_gather of the evidences over the target
    shards. Returns numpy (FPP (B,), NFPP (B,), lnZ (B, 15 + 3K)) on every
    rank, rows ordered as FULL_SCENARIOS then (NTP, NEB, NEBx2P) per slot;
    FPP = 1 - (P_TP + P_PTP + P_DTP), NFPP = the nearby rows' probability
    (triceratops.py:1479-1483).

    ``batch`` comes from ``prepare_target_batch``. ``cc_filt`` must be set
    when has_cc. ``drop_scenario`` names from FULL_SCENARIOS read lnZ =
    -inf and run no likelihood core (nearby-star rows cannot be dropped,
    as in the frontend, docs/parity.md item 9); nor do invalid (padding)
    nearby slots. ``chunk`` is for the CPU route: without it a CUDA core
    runs as one kernel launch over the rank's targets
    (``lightcurve._core_chunk``, ``DRAW_CAP``), so a rank makes one launch
    per computed row."""
    B = len(batch["key"])
    nt, nd, t_idx, d_idx = _grid_checks(mesh, N, B)
    eff_cc_filt = cc_filt if has_cc else None
    unknown = set(drop_scenario) - set(FULL_SCENARIOS)
    nearby_rows = unknown & {"NTP", "NEB", "NEBx2P"}
    if nearby_rows:
        raise ValueError(
            f"drop_scenario cannot drop nearby-star rows {sorted(nearby_rows)}: "
            "like the frontend, batch_fpp_full only drops target-star "
            "scenarios (docs/parity.md item 9)")
    if unknown:
        raise ValueError(f"unknown drop_scenario entries: {sorted(unknown)}")
    drop_idx = frozenset(i for i, s in enumerate(FULL_SCENARIOS)
                         if s in drop_scenario)
    N_local = N // nd
    twin_local = max(N_local // eng.TWIN_DIV, 1)
    twin_seb = max(N_local // eng.TWIN_DIV_SEB, 1)
    R = _n_rows(batch)
    n_total = [N] * R
    for i in (2, 5, 11, 14):
        n_total[i] = twin_local * nd
    n_total[8] = twin_seb * nd
    for i in range(17, R, 3):
        n_total[i] = twin_local * nd
    cfg = dict(N=N, N_local=N_local, twin_local=twin_local,
               twin_seb=twin_seb, flatpriors=flatpriors, has_cc=has_cc,
               cc_filt=eff_cc_filt, drop=drop_idx, d_idx=d_idx,
               kw=dict(exptime=exptime, n_t=n_t, ns=ns, chunk=chunk))
    B_local = B // nt
    m, s = _family_step(batch, range(t_idx * B_local, (t_idx + 1) * B_local),
                        R, cfg, torch.device(device))
    ln_n = torch.tensor([math.log(n) for n in n_total], dtype=torch.float32,
                        device=device)
    lnZv = _gather_targets(_combine_lnZ(m, s, ln_n, mesh), mesh)
    fpp, nfpp, lnZv = _combine_rows(lnZv)
    out = torch.cat([fpp[:, None], nfpp[:, None], lnZv], dim=1)
    with profiling.span("tri.gather"):
        out = out.cpu().numpy()
    return out[:, 0], out[:, 1], out[:, 2:]


def _combine_rows(lnZv):
    """(FPP, NFPP, lnZ) from the stacked per-scenario evidences
    (reference triceratops.py:1431-1483)."""
    probs = torch.exp(lnZv - torch.logsumexp(lnZv, dim=1, keepdim=True))
    fpp = torch.clamp_min(1.0 - (probs[:, 0] + probs[:, 3] + probs[:, 9]),
                          0.0)
    if lnZv.shape[1] > 15:
        nfpp = torch.sum(probs[:, 15:], dim=1)
    else:
        nfpp = torch.zeros_like(fpp)
    return fpp, nfpp, lnZv


def _target_inputs(batch, b, cfg, dev):
    """Target b's sampler inputs on this draw shard, the fields the JAX
    package's ``per_target`` reads from its batch row; its MOLUSC mass
    ratios qs0 come from its own generator."""
    N, N_local = cfg["N"], cfg["N_local"]
    seed = batch["key"][b]
    if "molusc_qs" in batch:
        # per-draw companion mass ratios from the MOLUSC posterior with the
        # reference's zero-padding semantics: P(zero) = 1 - kept / N
        # (ml.py:455-464 pads the kept rows to N)
        qs = batch["molusc_qs"][b].to(dev)
        r = eng._randint(_generator(seed, cfg["d_idx"], _MOLUSC_SLOT,
                                    device=dev), N_local, N)
        qs0 = torch.where(r < int(batch["molusc_kept"][b]),
                          qs[torch.clamp(r, 0, qs.shape[0] - 1)],
                          torch.zeros((), device=dev))
    else:
        qs0 = torch.zeros((N_local,), device=dev)
    return dict(
        seed=seed, P_orb=batch["P_orb"][b], M_s=batch["M_s"][b],
        R_s=batch["R_s"][b], Teff=batch["Teff"][b], plx=batch["plx"][b],
        seps=batch["seps"][b].to(dev), cons=batch["cons"][b].to(dev),
        bg={"pack": batch["bg"][b]["pack"].to(dev)}, qs0=qs0,
        u1=torch.full((N_local,), float(batch["u1"][b]), device=dev),
        u2=torch.full((N_local,), float(batch["u2"][b]), device=dev))


def _sample(fam, x, batch, b, cfg, dev):
    """Target b's draws of a target-star family, from its inputs x: (d, u1,
    u2, g, lnprior), the arrays its core reads besides d's (g is None for
    an EB family, whose dilutions are in d)."""
    P_orb, M_s, R_s, Teff = x["P_orb"], x["M_s"], x["R_s"], x["Teff"]
    plx, qs0, seps, cons = x["plx"], x["qs0"], x["seps"], x["cons"]
    u1a, u2a = x["u1"], x["u2"]
    N_local = cfg["N_local"]
    gen = _generator(x["seed"], cfg["d_idx"], *_FAMILY_SLOTS[fam], device=dev)
    comp = dict(N=N_local, use_molusc="molusc_qs" in batch,
                cc_filt=cfg["cc_filt"])
    bgkw = dict(N=N_local, has_cc=cfg["has_cc"])
    fp = dict(flatpriors=cfg["flatpriors"])
    twin = dict(twin_n=cfg["twin_local"])
    if fam == "TP":
        # TP (reference triceratops.py:797)
        d = eng.sample_planet_target(gen, P_orb, P_orb, M_s, R_s, N=N_local,
                                     **fp)
        return d, u1a, u2a, torch.ones_like(u1a), 0.0
    if fam == "EB":
        # EB, EBx2P (:843)
        d = eng.sample_teb(gen, P_orb, P_orb, M_s, R_s, Teff, N=N_local,
                           **twin)
        return d, u1a, u2a, None, 0.0
    if fam == "PTP":
        # PTP (:904)
        d = eng.sample_ptp(gen, P_orb, P_orb, M_s, R_s, Teff, plx, qs0, seps,
                           cons, **comp, **fp)
        return d, u1a, u2a, d["g"], d["lnprior"]
    if fam == "PEB":
        # PEB, PEBx2P (:953)
        d = eng.sample_peb(gen, P_orb, P_orb, M_s, R_s, Teff, plx, qs0, seps,
                           cons, **comp, **twin)
        return d, u1a, u2a, None, d["lnprior"]
    if fam == "STP":
        # STP (:1017)
        d = eng.sample_stp(gen, P_orb, P_orb, M_s, R_s, Teff, plx, qs0,
                           batch["u1_tab10"][b].to(dev),
                           batch["u2_tab10"][b].to(dev), seps, cons, **comp,
                           **fp)
        return d, d["u1s"], d["u2s"], d["g"], d["lnprior"]
    if fam == "SEB":
        # SEB, SEBx2P (:1066)
        d = eng.sample_seb(gen, P_orb, P_orb, M_s, R_s, Teff, plx, qs0,
                           batch["u1_tab13"][b].to(dev),
                           batch["u2_tab13"][b].to(dev), seps, cons, **comp,
                           twin_n=cfg["twin_seb"])
        return d, d["u1s"], d["u2s"], None, d["lnprior"]
    on_bg = fam in ("BTP", "BEB")
    if fam in ("DTP", "BTP"):
        # DTP (:1130), BTP (:1242)
        d = eng.sample_background_planet(gen, P_orb, P_orb, M_s, R_s,
                                         x["bg"], seps, cons,
                                         host_is_bg=on_bg, **bgkw, **fp)
        return (d, d["u1s"] if on_bg else u1a, d["u2s"] if on_bg else u2a,
                d["g"], d["lnprior"])
    # DEB, DEBx2P (:1178); BEB, BEBx2P (:1291)
    d = eng.sample_background_eb(gen, P_orb, P_orb, M_s, R_s, Teff, x["bg"],
                                 seps, cons, host_is_bg=on_bg,
                                 cc_filt=cfg["cc_filt"] or "TESS", **bgkw,
                                 **twin)
    return (d, d["u1s"] if on_bg else u1a, d["u2s"] if on_bg else u2a, None,
            d["lnprior"])


def _family_step(batch, targets, R, cfg, dev):
    """The rank's (B_local, R) local (max, scaled sum) evidence parts on this
    draw shard, for its contiguous ``targets``: per scenario family with a
    kept row, every target samples on its own generators, then each row
    runs one likelihood core over the targets' concatenated draws (the JAX
    package's ``_build_family_step``, a vmap over the targets); then per
    nearby slot NTP, NEB and NEBx2P over the targets where the slot is
    valid. Rows not computed keep (-1e30, 0), which read -inf."""
    drop, kw = cfg["drop"], cfg["kw"]
    N_local, d_idx = cfg["N_local"], cfg["d_idx"]
    mine = slice(targets.start, targets.stop)
    time = batch["time"][mine].to(dev)
    obs = batch["obs_dev"][mine].to(dev)
    sigma = batch["sigma"][mine]
    every = list(range(len(targets)))
    xs = [_target_inputs(batch, b, cfg, dev) for b in targets]
    m = torch.full((len(targets), R), -1e30, device=dev)
    s = torch.zeros((len(targets), R), device=dev)

    def ev(row, rows, lnL, lnw):
        m[rows, row], s[rows, row] = _local_lnZ_parts(
            (lnL + lnw).view(len(rows), -1))

    def joined(draws, i):
        return torch.cat([t[i] for t in draws])

    def planet(row, draws, rows, obs_r, sig_r):
        if row in drop:
            return
        ds = [t[0] for t in draws]
        lnL = lnL_planet(time[rows], obs_r, sig_r, *_cat(
            ds, "k", "P", "a_R", "inc_rad", "eccs", "w_rad"), joined(draws, 1),
            joined(draws, 2), joined(draws, 3), *_cat(ds, "mask"), **kw)
        ev(row, rows, lnL, torch.cat([t[4] + t[0]["lnw"] for t in draws]))

    def eb_pair(row, draws, rows, obs_r, sig_r):
        # row: the normal branch; row + 1: the twin on its own conditioned
        # draw set (one size for every target), whose global denominator
        # is n_twin * nd
        ds = [t[0] for t in draws]
        if row not in drop:
            lnL = lnL_eb(time[rows], obs_r, sig_r, *_cat(
                ds, "k", "ksec", "P", "a_R", "inc_rad", "eccs", "w_rad"),
                joined(draws, 1), joined(draws, 2),
                *_cat(ds, "g_pri", "g_sec", "mask"), apply_veto=True, **kw)
            ev(row, rows, lnL, torch.cat([t[4] + t[0]["lnw"]
                                          for t in draws]))
        if row + 1 not in drop:
            tws = [d["twin"] for d in ds]
            n = tws[0]["P"].shape[0]
            u1t, u2t = (torch.cat([tw.get(f"u{j}s", t[j][:n])
                                   for tw, t in zip(tws, draws)])
                        for j in (1, 2))
            k, ksec, P = _cat(tws, "k", "ksec", "P")
            lnL_t = lnL_eb(time[rows], obs_r, sig_r, k, ksec, 2.0 * P,
                           *_cat(tws, "a_R", "inc_rad", "eccs", "w_rad"),
                           u1t, u2t, *_cat(tws, "g_pri", "g_sec", "mask"),
                           apply_veto=False, **kw)
            ev(row + 1, rows, lnL_t,
               torch.cat([tw["lnprior"] + tw["lnw"] for tw in tws]))

    for fam, idxs in _FAMILY_ROWS:
        if set(idxs) <= drop:
            continue
        with profiling.span(f"tri.row.{fam}"):
            draws = [_sample(fam, x, batch, b, cfg, dev)
                     for b, x in zip(targets, xs)]
            (planet if len(idxs) == 1 else eb_pair)(idxs[0], draws, every,
                                                    obs, sigma)

    # nearby-star rows: NTP and NEB / NEBx2P per slot over the targets where
    # it is valid, on the curve renormalized for that star's share of the
    # aperture (renorm_flux, reference funcs.py:164-177; scenario reuse
    # triceratops.py:1344-1428)
    nearby = batch.get("nearby")
    for kk in range(nearby["valid"].shape[1] if nearby is not None else 0):
        rows = [i for i, b in enumerate(targets) if nearby["valid"][b, kk]]
        if not rows:
            continue
        gb = [targets[i] for i in rows]
        fr = nearby["fluxratio"][gb, kk]
        obs_k = obs[rows] / torch.as_tensor(fr[:, None], device=dev)
        slot = _NEARBY_SLOT + kk
        stars = []
        for i, b in zip(rows, gb):
            nu1, nu2 = (torch.full((N_local,), float(nearby[f][b, kk]),
                                   device=dev) for f in ("u1", "u2"))
            stars.append((xs[i]["seed"], xs[i]["P_orb"], nu1, nu2,
                          *(nearby[f][b, kk] for f in ("M_s", "R_s",
                                                       "Teff"))))
        # each star's NTP and NEB draws come from generators of their own,
        # so drawing every star's NTP draws before any NEB draws changes no
        # draw
        with profiling.span("tri.row.NTP"):
            tp = [(eng.sample_planet_target(
                      _generator(seed, d_idx, slot, 0, device=dev), P_orb,
                      P_orb, nM, nR, N=N_local, flatpriors=cfg["flatpriors"]),
                   nu1, nu2, torch.ones_like(nu1), 0.0)
                  for seed, P_orb, nu1, nu2, nM, nR, _ in stars]
            planet(15 + 3 * kk, tp, rows, obs_k, sigma[rows] / fr)
        with profiling.span("tri.row.NEB"):
            eb = [(eng.sample_teb(
                      _generator(seed, d_idx, slot, 1, device=dev), P_orb,
                      P_orb, nM, nR, nT, N=N_local,
                      twin_n=cfg["twin_local"]), nu1, nu2, None, 0.0)
                  for seed, P_orb, nu1, nu2, nM, nR, nT in stars]
            eb_pair(16 + 3 * kk, eb, rows, obs_k, sigma[rows] / fr)
    return m, s
