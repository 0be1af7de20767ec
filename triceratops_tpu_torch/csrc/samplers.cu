// Fused scenario samplers: one launch turns one sampler branch's uniform
// streams into every per-draw field that branch returns.
//
// Replaces no TPU kernel: the JAX package's samplers
// (scenarios/engine.py::sample_*) are elementwise chains that XLA fuses on
// the TPU. The port's plain versions (triceratops_tpu_torch/scenarios/
// engine.py, priors/samplers.py, populations/stellar.py, populations/
// ldc.py, ops/lightcurve.py) dispatch each operation of those chains as
// its own torch kernel: 200 to 1,400 launches a sampler call at ~17 us of
// host time each against ~3 us of device work, so the card waited on the
// host while the samplers dispatched. Here each branch is one launch:
//   * planet_kernel: a planet branch (TP / NTP, PTP, STP, DTP, BTP);
//   * eb_kernel<Star, false>: an EB normal branch, with its shared-draw
//     twin (engine.py::_eb_branches) when Args::shared_twin is set;
//   * eb_kernel<Star, true>: a conditioned twin draw set (_twin_geom /
//     _twin_pack: q | q >= 0.95 and the grazing-edge inclination mixture).
// Where the host star comes from is the compile-time policy Star:
//   * STAR_T, STAR_P, STAR_D: the target, fixed, from scalars passed by
//     value; STAR_P adds a bound companion that dilutes it, STAR_D a drawn
//     TRILEGAL row that dilutes it;
//   * STAR_S: the bound companion, a q per draw from the MOLUSC rows
//     (gathered) or from the companion law;
//   * STAR_B: the drawn TRILEGAL row (the pack row at the drawn index).
// What stays in torch, so the random streams and the benchmark's seams do
// not change: every uniform (engine._uniforms), every drawn index
// (engine._randint), the Latin-hypercube permutations (one stable argsort;
// the kernel reads them), each EB branch's periods and their mean (the
// binary eccentricity exponent reads the mean from device memory, never
// from the host), and the bound-companion and background priors, which
// run on the fields the kernel writes.
//
// Numerics: op for op with the torch chain on the card, so every field is
// the plain chain's bit for bit. Each torch elementwise op rounds once, so
// every product and sum here is __fmul_rn / __fadd_rn / __fsub_rn (never
// contracted to an FMA; the build keeps nvcc's other defaults, as torch's
// own kernels do), and each libm call is the one torch's kernel makes
// (powf, acosf, sinf, cosf, logf, log10f, log1pf, sqrtf, nearbyintf).
// Torch's own rewrites are mirrored: tensor / Python scalar multiplies by
// the scalar's reciprocal rounded to float32 (the Python side passes it),
// scalar / tensor is reciprocal(tensor) times the scalar, tensor ** Python
// scalar takes torch's special cases (PowSpec), torch.minimum and the
// clamps propagate NaN, searchsorted is torch's upper bound. Every
// constant that the plain chain forms in Python doubles comes in Consts,
// rounded to float32 by the Python side as torch rounds a Python scalar.
//
// What bounds it on an H100: a draw reads 20-52 bytes (5-6 uniforms, the
// lattice permutations, a drawn row's fields) and writes 4 bytes for each
// of its 13-33 fields (69-182 bytes a draw in all, 0.02-0.05 ms at 3.35
// TB/s for 1e6 draws), against ~1,000-3,000 FP32 operations (a few powf,
// the Beta PPF's 16-step Clenshaw, the spline lookups, acosf, sinf, cosf,
// the 0-d mass-ratio law constants), about as long at 67 TFLOP/s. A
// launch of 1e6 draws takes 0.04-0.13 ms, against the ~18 ms of device
// time and ~117 ms of host dispatch the plain chain spent on a 21-row
// call (PERF.md).
// What the design does about it: one thread a draw, every intermediate in
// registers, each output written once and coalesced; the spline and Beta
// tables are read through L1 (their indices differ per draw); the 0-d
// values the plain chain computes once per call (the mass-ratio law's
// normalisations at the host's mass, the flux of the target) each thread
// recomputes, a few operations, instead of a second launch.

#include <cuda_runtime.h>
#include <math.h>

// ---------------------------------------------------------------------------
// The interface, at global scope (the C entry points take Args): Python's
// ops/sampler_kernels.py mirrors these structs field for field (ctypes),
// and checks the field and pack-column names and sizeof(Args) against
// sampler_layout() when it loads the library.
// ---------------------------------------------------------------------------

// tensor ** e for a Python float e, as torch's CUDA pow computes it
// (Pow.cpp: 0 fills ones, 1 copies; PowKernel.cu: 0.5 sqrt, -0.5 rsqrt,
// -1 reciprocal, then on the float32 exponent 2, 3 and -2 by products,
// anything else powf)
enum PowCode { POW_ONES = 0, POW_IDENT, POW_SQRT, POW_RSQRT, POW_RECIP,
               POW_SQUARE, POW_CUBE, POW_INV_SQUARE, POW_GENERIC };
struct PowSpec { int code; float e; };

// priors/samplers.py::_broken3_invcdf, and _q_invcdf_3seg at a Python
// q_min: every constant a Python float
struct Broken3 {
  float inv_norm, c1, add1; PowSpec e1;
  float I1, c2, inv_A1, add2; PowSpec e2;
  float I2, c3, inv_A1A2, add3; PowSpec e3;
  float thr1, thr2;
};

// priors/samplers.py::_sample_q_generic (and q_below_twin_cdf) for one
// (p1, p2, F_twin): 'big' at q_min = 0.1; the 'mid' (3-segment) and
// 'small' (2-segment) branches at the host's q_min = 0.1 / M_s, whose
// 0-d values the kernel computes (QState)
struct QLaw {
  Broken3 big;
  PowSpec e_p1, e_inv_p1, e_p2, e_inv_p2;
  float c_p1, inv_cp1, c03p1, I2m, I3m;
  float c_p2, inv_cp2, inv_A1, inv_A1A2, add03, add095;
  float c1p2, cF, inv_T2, cI3;
  float cdf95_big;
};

struct Consts {
  Broken3 rp_hot, rp_cool;
  float rp_flat_inv, rp_flat_add, rp_m_split;
  QLaw q_bin, q_comp;
  float q_m_floor, q_c01, q_cap, q_m_low, q_m_mid, q_m_big;
  PowSpec beta_ea, beta_eb;
  float beta_split, beta_inv_vmax, beta_inv_wmax;
  float ecc_e_short, ecc_e_long, ecc_p_split;
  float pi, inv180, deg_per_rad, rad_per_deg;
  float G, MSUN, RSUN, REARTH, day_s, inv_4pi2;
  PowSpec e_third;
  float inc_inv_norm, cos_lower, deg_per_rad_inc;
  float k_eps, k_shrink, q_twin, m_hot, r_floor, teff_floor;
  float logg_min, teff_max, logg_inv_step, teff_inv_step;
  float w_scale, w_zero, ten;
  float mix_m1, mix_m2, mix_t1, mix_t2;
  float mix_inv_d1, mix_inv_d2, mix_inv_d3, mix_d1, mix_d2, mix_d3;
};

// output fields (Args::row gives each its row of the (rows, n) output, or
// -1: not written) and masks (Args::mrow, rows of the bool output)
enum Field {
  F_P, F_rps, F_qs, F_eccs, F_argps, F_masses, F_radii, F_fluxratios,
  F_a, F_b, F_incs, F_lnw, F_inc_rad, F_w_rad, F_k, F_ksec, F_a_R,
  F_g, F_g_pri, F_g_sec,
  F_a_twin, F_b_twin, F_incs_twin, F_lnw_twin, F_inc_rad_twin, F_a_R_twin,
  F_fluxratios_comp, F_masses_comp, F_radii_comp, F_u1s, F_u2s,
  F_host_mass, F_host_rad, F_delta_band, F_fluxratios_cc,
  N_FIELDS
};
enum Mask { M_mask, M_mask_twin, N_MASKS };
static const char kLayout[] =
    "P,rps,qs,eccs,argps,masses,radii,fluxratios,a,b,incs,lnw,inc_rad,"
    "w_rad,k,ksec,a_R,g,g_pri,g_sec,a_twin,b_twin,incs_twin,lnw_twin,"
    "inc_rad_twin,a_R_twin,fluxratios_comp,masses_comp,radii_comp,u1s,u2s,"
    "host_mass,host_rad,delta_band,fluxratios_cc;mask,mask_twin;"
    "fluxratios,delta_band,masses,radii,loggs,teffs,u1s,u2s,fluxratios_cc";

// columns of the packed TRILEGAL rows (populations/packs.py::BG_PACK_FIELDS)
enum PackCol { C_FR, C_DELTA, C_MASS, C_RAD, C_LOGG, C_TEFF, C_U1, C_U2,
               C_FR_CC, N_PACK };

// splines (tables.SPLINE_NAMES' device tables, load_tables)
enum Spline { SP_TORRES_RAD, SP_TORRES_TEFF, SP_CDWRF_RAD, SP_CDWRF_TEFF,
              SP_TESS, N_SPLINES };

enum Star { STAR_T, STAR_P, STAR_S, STAR_D, STAR_B };

struct Args {
  const float* u[6];          // uniform streams, n each
  const long long* perm;      // (n_perm, n) lattice permutations or null
  const long long* idx;       // drawn pack rows, or MOLUSC rows of a twin
  const float* qs_in;         // MOLUSC mass ratios (n, or any with idx)
  const float* pack;          // (rows, N_PACK) TRILEGAL rows
  const float* u1_tab;        // (4, n_teff) nearest-Z LDC grid
  const float* u2_tab;
  const float* P;             // EB branches: the periods torch drew
  const float* P_mean;        // EB branches: their mean (device scalar)
  const float* sp_br[N_SPLINES];  // breaks (n) and coefs (4, n - 1)
  const float* sp_cf[N_SPLINES];
  const float* beta_cL;       // Beta PPF Chebyshev series (16 each)
  const float* beta_cH;
  float* out;                 // (rows, n) float32
  unsigned char* mask;        // (mask rows, n) bool
  float* scal;                // P_lo, P_hi, M_s, R_s, Teff, plx
  long long n;
  int sp_n[N_SPLINES];
  int row[N_FIELDS];
  int mrow[N_MASKS];
  int n_teff, n_perm;
  int flatpriors, stratified, use_molusc, shared_twin;
  float inv_n;                // float32 1 / n (the lattice's / n)
  float P_lo, P_hi, M_s, R_s, Teff, plx;
  Consts c;
};

namespace {

constexpr int kThreads = 256;
constexpr int kBetaM = 16;

// ---------------------------------------------------------------------------
// One rounding per torch op
// ---------------------------------------------------------------------------

__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fdiv(float a, float b) {
  return __fdiv_rn(a, b);
}
// torch's reciprocal: 1 / a (also scalar / tensor, times a scalar of 1)
__device__ __forceinline__ float recip(float a) { return __fdiv_rn(1.0f, a); }

// torch.clamp_max / clamp_min / clamp with Python bounds, torch.minimum
__device__ __forceinline__ float clamp_max_(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp_min_(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float minimum_(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float tpow(float b, const PowSpec& s) {
  switch (s.code) {
    case POW_ONES: return 1.0f;
    case POW_IDENT: return b;
    case POW_SQRT: return sqrtf(b);
    case POW_RSQRT: return rsqrtf(b);
    case POW_RECIP: return recip(b);
    case POW_SQUARE: return fmul(b, b);
    case POW_CUBE: return fmul(fmul(b, b), b);
    case POW_INV_SQUARE: return recip(fmul(b, b));
    default: return powf(b, s.e);
  }
}

// ---------------------------------------------------------------------------
// Tables: populations/stellar.py::ppoly_eval, flux_relation,
// stellar_relations; populations/ldc.py::round_index_comp
// ---------------------------------------------------------------------------

__device__ __forceinline__ float ppoly(const Args& a, int s, float x) {
  const float* br = a.sp_br[s];
  const float* cf = a.sp_cf[s];
  const int nb = a.sp_n[s];
  // torch.searchsorted(breaks[1:-1], x, right=True): torch's upper bound
  int lo = 0, hi = nb - 2;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(br[1 + mid] > x)) lo = mid + 1; else hi = mid;
  }
  const int m = nb - 1;
  const float dx = fsub(x, br[lo]);
  float out = cf[lo];
#pragma unroll
  for (int j = 1; j < 4; ++j) out = fadd(fmul(out, dx), cf[j * m + lo]);
  return out;
}

// flux_relation (TESS band): 10 ** spline
__device__ __forceinline__ float flux_tess(const Args& a, float m) {
  return powf(a.c.ten, ppoly(a, SP_TESS, m));
}

// engine._fluxratio_vs_target, ft = the target's flux
__device__ __forceinline__ float fr_vs(const Args& a, float m, float ft) {
  const float f = flux_tess(a, m);
  return fdiv(f, fadd(f, ft));
}

__device__ __forceinline__ void stellar(const Args& a, float m, float max_r,
                                        float max_t, float* r, float* t) {
  const bool hot = m > a.c.m_hot;
  const float rr = hot ? ppoly(a, SP_TORRES_RAD, m) : ppoly(a, SP_CDWRF_RAD, m);
  const float tt = hot ? ppoly(a, SP_TORRES_TEFF, m)
                       : ppoly(a, SP_CDWRF_TEFF, m);
  *r = clamp_min_(minimum_(rr, max_r), a.c.r_floor);
  *t = clamp_min_(minimum_(tt, max_t), a.c.teff_floor);
}

__device__ __forceinline__ float stellar_r(const Args& a, float m,
                                           float max_r) {
  const bool hot = m > a.c.m_hot;
  const float rr = hot ? ppoly(a, SP_TORRES_RAD, m) : ppoly(a, SP_CDWRF_RAD, m);
  return clamp_min_(minimum_(rr, max_r), a.c.r_floor);
}

// engine._companion_ldc with round_index_comp
__device__ __forceinline__ void companion_ldc(const Args& a, float m,
                                              float r, float t, float* u1,
                                              float* u2) {
  const Consts& c = a.c;
  const float num = fmul(fmul(m, c.MSUN), c.G);
  const float rc = clamp_min_(fmul(r, c.RSUN), 1.0f);
  const float logg = log10f(fdiv(num, fmul(rc, rc)));
  // float -> int32 saturates (NaN -> 0), and the offsets wrap as torch's
  // int32 subtraction does: a zero-padded MOLUSC row's logg of -inf
  // lands on the last logg row
  int il = (int)((unsigned)(int)nearbyintf(fmul(logg, c.logg_inv_step)) - 7u);
  int it = (int)((unsigned)(int)nearbyintf(fmul(t, c.teff_inv_step)) - 14u);
  il = min(max(il, 0), 3);
  it = min(max(it, 0), a.n_teff - 1);
  *u1 = a.u1_tab[il * a.n_teff + it];
  *u2 = a.u2_tab[il * a.n_teff + it];
}

// ---------------------------------------------------------------------------
// Priors: priors/samplers.py
// ---------------------------------------------------------------------------

__device__ __forceinline__ float broken3(float x, const Broken3& k) {
  const float xn = fmul(x, k.inv_norm);
  const float s1 = tpow(fadd(fmul(xn, k.c1), k.add1), k.e1);
  const float s2 = tpow(fadd(fmul(fmul(fsub(xn, k.I1), k.c2), k.inv_A1),
                             k.add2), k.e2);
  const float s3 = tpow(fadd(fmul(fmul(fsub(fsub(xn, k.I1), k.I2), k.c3),
                                  k.inv_A1A2), k.add3), k.e3);
  return x <= k.thr1 ? s1 : (x <= k.thr2 ? s2 : s3);
}

__device__ __forceinline__ float sample_rp(const Args& a, float x, float M) {
  const Consts& c = a.c;
  if (a.flatpriors) return fadd(fmul(x, c.rp_flat_inv), c.rp_flat_add);
  const float hot = broken3(x, c.rp_hot);
  const float cool = broken3(x, c.rp_cool);
  return M > c.rp_m_split ? hot : cool;
}

// the 0-d values of _sample_q_generic at one host mass M
struct QState {
  int br;                       // 0: M <= 0.1; 1: big; 2: mid; 3: small
  float qm_p1, qm_p2;           // q_min ** (p1 + 1), q_min ** (p2 + 1)
  float I1, Norm, A2, I2, I3, thr1, thr2;
};

__device__ __forceinline__ QState q_state(const Args& a, float M,
                                          const QLaw& L) {
  const Consts& c = a.c;
  QState s;
  s.br = M <= c.q_m_low ? 0 : (M >= c.q_m_big ? 1 : (M >= c.q_m_mid ? 2 : 3));
  const float q_min = fmul(recip(clamp_min_(M, c.q_m_floor)), c.q_c01);
  const float qm = clamp_max_(q_min, c.q_cap);
  s.qm_p1 = s.qm_p2 = s.I1 = s.Norm = s.A2 = s.I2 = s.I3 = 0.0f;
  s.thr1 = s.thr2 = 0.0f;
  if (s.br == 2) {
    // _q_invcdf_3seg at the 0-d q_min
    s.qm_p1 = tpow(qm, L.e_p1);
    s.I1 = fmul(fsub(L.c03p1, s.qm_p1), L.inv_cp1);
    s.Norm = recip(fadd(fadd(s.I1, L.I2m), L.I3m));
    s.thr1 = fmul(s.Norm, s.I1);
    s.thr2 = fmul(s.Norm, fadd(s.I1, L.I2m));
  } else if (s.br == 3) {
    // _q_invcdf_2seg at the 0-d q_min
    s.qm_p2 = tpow(qm, L.e_p2);
    const float T1 = fmul(fsub(L.c1p2, s.qm_p2), L.inv_cp2);
    s.A2 = fadd(fmul(fmul(T1, L.cF), L.inv_T2), 1.0f);
    s.I2 = fmul(fsub(L.add095, s.qm_p2), L.inv_cp2);
    s.I3 = fmul(fmul(s.A2, L.cI3), L.inv_cp2);
    s.Norm = recip(fadd(s.I2, s.I3));
    s.thr1 = fmul(s.Norm, s.I2);
  }
  return s;
}

__device__ __forceinline__ float q_draw(float x, const QState& s,
                                        const QLaw& L) {
  if (s.br == 0) return 1.0f;
  if (s.br == 1) return broken3(x, L.big);
  const float xn = fdiv(x, s.Norm);
  if (s.br == 2) {
    const float s1 = tpow(fadd(fmul(xn, L.c_p1), s.qm_p1), L.e_inv_p1);
    const float s2 = tpow(fadd(fmul(fmul(fsub(xn, s.I1), L.c_p2), L.inv_A1),
                               L.add03), L.e_inv_p2);
    const float s3 = tpow(fadd(fmul(fmul(fsub(fsub(xn, s.I1), L.I2m), L.c_p2),
                                    L.inv_A1A2), L.add095), L.e_inv_p2);
    return x <= s.thr1 ? s1 : (x <= s.thr2 ? s2 : s3);
  }
  const float s2 = tpow(fadd(fmul(xn, L.c_p2), s.qm_p2), L.e_inv_p2);
  const float s3 = tpow(fadd(fdiv(fmul(fsub(xn, s.I2), L.c_p2), s.A2),
                             L.add095), L.e_inv_p2);
  return x <= s.thr1 ? s2 : s3;
}

// q_below_twin_cdf: P(q < 0.95) at the state's host mass
__device__ __forceinline__ float q_cdf95(const QState& s, const QLaw& L) {
  if (s.br == 0) return 0.0f;
  if (s.br == 1) return L.cdf95_big;
  if (s.br == 2) {
    return fdiv(fadd(s.I1, L.I2m), fadd(fadd(s.I1, L.I2m), L.I3m));
  }
  return fdiv(s.I2, fadd(s.I2, s.I3));
}

// _beta_ppf: Beta(0.867, 3.030) quantile, 16-step Clenshaw
__device__ __forceinline__ float beta_ppf(const Args& a, float u) {
  const Consts& c = a.c;
  const bool hi = u > c.beta_split;
  const float us = clamp_(u, 0.0f, 1.0f);
  const float v = tpow(us, c.beta_ea);
  const float w = tpow(fsub(1.0f, us), c.beta_eb);
  const float t = hi ? w : v;
  const float xx = fsub(hi ? fmul(fmul(w, 2.0f), c.beta_inv_wmax)
                           : fmul(fmul(v, 2.0f), c.beta_inv_vmax), 1.0f);
  const float* cs = hi ? a.beta_cH : a.beta_cL;
  const float two_x = fmul(xx, 2.0f);
  float b1 = 0.0f, b2 = 0.0f;
#pragma unroll
  for (int m = kBetaM - 1; m > 0; --m) {
    const float nb = fsub(fadd(cs[m], fmul(two_x, b1)), b2);
    b2 = b1;
    b1 = nb;
  }
  const float series = fsub(fadd(cs[0], fmul(xx, b1)), b2);
  const float ts = fmul(t, series);
  return clamp_(hi ? fsub(1.0f, ts) : ts, 0.0f, 1.0f);
}

// ---------------------------------------------------------------------------
// Geometry: scenarios/engine.py
// ---------------------------------------------------------------------------

__device__ __forceinline__ float semimajor(const Consts& c, float P,
                                           float M) {
  const float gm = fmul(fmul(fmul(M, c.G), c.MSUN), c.inv_4pi2);
  const float pt = fmul(P, c.day_s);
  return tpow(fmul(gm, fmul(pt, pt)), c.e_third);
}

struct Orbit { float a, Ptra, r; bool coll; };

// _geom_base; R_occ [cm], R_host [Rsun]
__device__ __forceinline__ Orbit geom_base(const Consts& c, float P, float M,
                                           float R_host, float R_occ,
                                           float e, float argp) {
  Orbit o;
  o.a = semimajor(c, P, M);
  const float s = sinf(fmul(fmul(argp, c.pi), c.inv180));
  const float es1 = fadd(fmul(e, s), 1.0f);
  const float one_e2 = fsub(1.0f, fmul(e, e));
  const float e_corr = fdiv(es1, one_e2);
  const float Rh = fmul(R_host, c.RSUN);
  o.Ptra = fmul(fdiv(fadd(R_occ, Rh), o.a), e_corr);
  o.r = fdiv(fmul(o.a, one_e2), es1);
  o.coll = fadd(R_occ, Rh) > fmul(o.a, fsub(1.0f, e));
  return o;
}

struct Inc { float incs, lnw; bool tra_ok; };

// _inc_weighted
__device__ __forceinline__ Inc inc_weighted(const Args& a, float u,
                                            float Ptra) {
  const Consts& c = a.c;
  Inc r;
  if (a.stratified) {
    const float w = clamp_max_(Ptra, 1.0f);
    r.incs = fmul(acosf(fmul(u, w)), c.deg_per_rad);
    r.tra_ok = Ptra <= 1.0f;
    r.lnw = logf(w);
  } else {
    r.incs = fmul(acosf(fsub(c.cos_lower, fmul(u, c.inc_inv_norm))),
                  c.deg_per_rad_inc);
    const float cosi = cosf(fmul(fmul(r.incs, c.pi), c.inv180));
    r.tra_ok = (Ptra <= 1.0f) && (cosi <= Ptra);
    r.lnw = 0.0f;
  }
  return r;
}

// _inc_twin_mixture
__device__ __forceinline__ Inc inc_twin_mixture(const Consts& c, float u,
                                                float Ptra) {
  Inc r;
  const float w = clamp_max_(Ptra, 1.0f);
  const float t = u < c.mix_m1 ? fmul(u, c.mix_inv_d1)
      : (u < c.mix_m2 ? fadd(fmul(fsub(u, c.mix_m1), c.mix_inv_d2), c.mix_t1)
                      : fadd(fmul(fsub(u, c.mix_m2), c.mix_inv_d3), c.mix_t2));
  const float dens = fdiv(u < c.mix_m1 ? c.mix_d1
                          : (u < c.mix_m2 ? c.mix_d2 : c.mix_d3), w);
  r.incs = fmul(acosf(clamp_(fmul(w, t), 0.0f, 1.0f)), c.deg_per_rad);
  r.tra_ok = Ptra <= 1.0f;
  r.lnw = -logf(dens);
  return r;
}

// _impact_param
__device__ __forceinline__ float impact(const Consts& c, float r, float incs,
                                        float R_host) {
  return fdiv(fmul(r, cosf(fmul(fmul(incs, c.pi), c.inv180))),
              fmul(R_host, c.RSUN));
}

// ops/lightcurve.py::eb_radius_ratios
__device__ __forceinline__ void radius_ratios(const Consts& c, float radii,
                                              float R_host, float* k,
                                              float* ksec) {
  float kk = fdiv(radii, R_host);
  *k = fsub(kk, 1.0f) < c.k_eps ? fmul(kk, c.k_shrink) : kk;
  float ks = fdiv(R_host, radii);
  *ksec = fsub(ks, 1.0f) < c.k_eps ? fmul(ks, c.k_shrink) : ks;
}

// ops/lightcurve.py::tp_dilution
__device__ __forceinline__ float tp_dilution(float F, bool host) {
  return host ? recip(fadd(recip(F), 1.0f)) : recip(fadd(F, 1.0f));
}

// ops/lightcurve.py::eb_dilution
__device__ __forceinline__ void eb_dilution(float F_EB, float F_comp,
                                            bool host, float* g_pri,
                                            float* g_sec) {
  float x1, x2, y1;
  if (host) {
    x1 = fdiv(F_EB, F_comp);
    x2 = recip(fadd(F_comp, F_EB));
    y1 = fdiv(F_comp, F_EB);
  } else {
    x1 = F_EB;
    x2 = fdiv(F_comp, fadd(F_EB, 1.0f));
    y1 = recip(F_EB);
  }
  const float x2p = fadd(x2, 1.0f);
  *g_pri = recip(fmul(fadd(x1, 1.0f), x2p));
  *g_sec = recip(fmul(fadd(y1, 1.0f), x2p));
}

__device__ __forceinline__ float odds(float f) { return fdiv(f, fsub(1.0f, f)); }

__device__ __forceinline__ void put(const Args& a, int f, long long i,
                                    float v) {
  const int r = a.row[f];
  if (r >= 0) a.out[(long long)r * a.n + i] = v;
}

__device__ __forceinline__ void put_mask(const Args& a, int m, long long i,
                                         bool v) {
  const int r = a.mrow[m];
  if (r >= 0) a.mask[(long long)r * a.n + i] = v ? 1 : 0;
}

__device__ __forceinline__ void put_scalars(const Args& a) {
  a.scal[0] = a.P_lo; a.scal[1] = a.P_hi; a.scal[2] = a.M_s;
  a.scal[3] = a.R_s; a.scal[4] = a.Teff; a.scal[5] = a.plx;
}

// the bound companion's mass ratio: the MOLUSC row (the draw's own, or the
// row a twin draw set drew) or the companion law
__device__ __forceinline__ float companion_q(const Args& a, long long i,
                                             float u5) {
  if (a.use_molusc) return a.qs_in[a.idx ? a.idx[i] : i];
  return q_draw(u5, q_state(a, a.M_s, a.c.q_comp), a.c.q_comp);
}

// ---------------------------------------------------------------------------
// Planet branch: sample_planet_target, sample_ptp, sample_stp,
// sample_background_planet
// ---------------------------------------------------------------------------

template <int S>
__global__ void __launch_bounds__(kThreads)
planet_kernel(const __grid_constant__ Args a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i == 0) put_scalars(a);
  if (i >= a.n) return;
  const Consts& c = a.c;
  const float u0 = a.u[0][i], u1 = a.u[1][i], u2 = a.u[2][i];
  const float u3 = a.u[3][i], u4 = a.u[4][i];
  const float P = fadd(fmul(u0, fsub(a.P_hi, a.P_lo)), a.P_lo);
  float host_m = a.M_s, host_r = a.R_s, g = 1.0f;
  bool ok = true;
  if (S == STAR_P || S == STAR_S) {
    const float qc = companion_q(a, i, a.use_molusc ? 0.0f : a.u[5][i]);
    const float mc = fmul(qc, a.M_s);
    const float frc = fr_vs(a, mc, flux_tess(a, a.M_s));
    ok = qc != 0.0f;
    put(a, F_masses_comp, i, mc);
    put(a, F_fluxratios_comp, i, frc);
    if (S == STAR_S) {
      float rc, tc, u1c, u2c;
      stellar(a, mc, a.R_s, a.Teff, &rc, &tc);
      companion_ldc(a, mc, rc, tc, &u1c, &u2c);
      put(a, F_radii_comp, i, rc);
      put(a, F_u1s, i, u1c);
      put(a, F_u2s, i, u2c);
      host_m = mc;
      host_r = rc;
    }
    g = tp_dilution(odds(frc), S == STAR_S);
  }
  if (S == STAR_D || S == STAR_B) {
    const float* row = a.pack + a.idx[i] * N_PACK;
    const float frd = row[C_FR];
    put(a, F_fluxratios_comp, i, frd);
    put(a, F_delta_band, i, row[C_DELTA]);
    if (S == STAR_B) {
      host_m = row[C_MASS];
      host_r = row[C_RAD];
      ok = (row[C_LOGG] >= c.logg_min) && (row[C_TEFF] <= c.teff_max);
      put(a, F_u1s, i, row[C_U1]);
      put(a, F_u2s, i, row[C_U2]);
    }
    put(a, F_host_mass, i, host_m);
    put(a, F_host_rad, i, host_r);
    g = tp_dilution(odds(frd), S == STAR_B);
  }
  const float rps = sample_rp(a, u1, host_m);
  const float e = beta_ppf(a, u3);
  const float w = fmul(u4, c.w_scale);
  const float R_occ = fmul(rps, c.REARTH);
  const Orbit o = geom_base(c, P, host_m, host_r, R_occ, e, w);
  const Inc in = inc_weighted(a, u2, o.Ptra);
  const float hr_cm = fmul(host_r, c.RSUN);
  put(a, F_P, i, P);
  put(a, F_rps, i, rps);
  put(a, F_incs, i, in.incs);
  put(a, F_eccs, i, e);
  put(a, F_argps, i, w);
  put(a, F_a, i, o.a);
  put(a, F_b, i, impact(c, o.r, in.incs, host_r));
  put(a, F_lnw, i, in.lnw);
  put(a, F_inc_rad, i, fmul(in.incs, c.rad_per_deg));
  put(a, F_w_rad, i, fmul(fsub(c.w_zero, w), c.rad_per_deg));
  put(a, F_k, i, fdiv(R_occ, hr_cm));
  put(a, F_a_R, i, fdiv(o.a, hr_cm));
  put(a, F_g, i, g);
  put_mask(a, M_mask, i, in.tra_ok && !o.coll && ok);
}

// ---------------------------------------------------------------------------
// EB branches: sample_teb, sample_peb, sample_seb, sample_background_eb
// (normal branch, with the shared-draw twin; or a conditioned twin set)
// ---------------------------------------------------------------------------

template <int S, bool Twin>
__global__ void __launch_bounds__(kThreads)
eb_kernel(const __grid_constant__ Args a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i == 0) put_scalars(a);
  if (i >= a.n) return;
  const Consts& c = a.c;
  const long long n = a.n;
  const bool six = S == STAR_P || S == STAR_S;
  float s1 = a.u[1][i], s2 = a.u[2][i], s3 = a.u[3][i], s4 = a.u[4][i];
  float s5 = six ? a.u[5][i] : 0.0f;
  if (a.n_perm) {
    // _lattice_strat: axis 1 by the identity, axes 2, 4, 3 (and 5) by
    // the permutations, each (pi(i) + u) / n
    s1 = fmul(fadd((float)i, s1), a.inv_n);
    s2 = fmul(fadd((float)a.perm[i], s2), a.inv_n);
    s4 = fmul(fadd((float)a.perm[n + i], s4), a.inv_n);
    s3 = fmul(fadd((float)a.perm[2 * n + i], s3), a.inv_n);
    if (a.n_perm > 3) s5 = fmul(fadd((float)a.perm[3 * n + i], s5), a.inv_n);
  }
  const float P = a.P[i];
  const float ft = flux_tess(a, a.M_s);
  const QState qst = q_state(a, a.M_s, c.q_bin);
  float qs, lnqmass = 0.0f;
  if (Twin) {
    // _twin_q: q | q >= 0.95 by inverse-CDF restriction
    const float u095 = q_cdf95(qst, c.q_bin);
    qs = q_draw(fadd(u095, fmul(s2, fsub(1.0f, u095))), qst, c.q_bin);
    lnqmass = log1pf(-u095);
  } else {
    qs = q_draw(s2, qst, c.q_bin);
  }
  const float expo = *a.P_mean <= c.ecc_p_split ? c.ecc_e_short
                                                 : c.ecc_e_long;
  const float e = powf(s3, expo);
  const float w = fmul(s4, c.w_scale);
  float host_m = a.M_s, host_r = a.R_s, masses, radii, fr, g_pri, g_sec;
  bool ok = true;
  if (S == STAR_T || S == STAR_P) {
    masses = fmul(qs, a.M_s);
    radii = stellar_r(a, masses, a.R_s);
    fr = fr_vs(a, masses, ft);
    float F_comp = 0.0f;
    if (S == STAR_P) {
      const float qc = companion_q(a, i, s5);
      const float mc = fmul(qc, a.M_s);
      const float frc = fr_vs(a, mc, ft);
      ok = qc != 0.0f;
      put(a, F_masses_comp, i, mc);
      put(a, F_fluxratios_comp, i, frc);
      F_comp = odds(frc);
    }
    eb_dilution(odds(fr), F_comp, false, &g_pri, &g_sec);
  } else if (S == STAR_S) {
    const float qc = companion_q(a, i, s5);
    const float mc = fmul(qc, a.M_s);
    float rc, tc, u1c, u2c;
    stellar(a, mc, a.R_s, a.Teff, &rc, &tc);
    const float frc = fr_vs(a, mc, ft);
    companion_ldc(a, mc, rc, tc, &u1c, &u2c);
    masses = fmul(qs, mc);
    radii = stellar_r(a, masses, rc);
    fr = fr_vs(a, masses, ft);
    ok = qc != 0.0f;
    put(a, F_masses_comp, i, mc);
    put(a, F_radii_comp, i, rc);
    put(a, F_fluxratios_comp, i, frc);
    put(a, F_u1s, i, u1c);
    put(a, F_u2s, i, u2c);
    eb_dilution(odds(fr), odds(frc), true, &g_pri, &g_sec);
    host_m = mc;
    host_r = rc;
  } else {
    const float* row = a.pack + a.idx[i] * N_PACK;
    const float frd = row[C_FR];
    put(a, F_fluxratios_comp, i, frd);
    put(a, F_delta_band, i, row[C_DELTA]);
    if (S == STAR_B) {
      host_m = row[C_MASS];
      host_r = row[C_RAD];
      ok = (row[C_LOGG] >= c.logg_min) && (row[C_TEFF] <= c.teff_max);
      masses = fmul(qs, host_m);
      radii = stellar_r(a, masses, host_r);
      // (stellar_relations clamps the radius by the row's radius and the
      // Teff by its Teff; only the radius is kept)
      const float dist_corr = fdiv(frd, fr_vs(a, host_m, ft));
      fr = fmul(fr_vs(a, masses, ft), dist_corr);
      eb_dilution(odds(fr), odds(frd), true, &g_pri, &g_sec);
      put(a, F_u1s, i, row[C_U1]);
      put(a, F_u2s, i, row[C_U2]);
      put(a, F_fluxratios_cc, i, row[C_FR_CC]);
    } else {
      masses = fmul(qs, a.M_s);
      radii = stellar_r(a, masses, a.R_s);
      fr = fr_vs(a, masses, ft);
      eb_dilution(odds(fr), odds(frd), false, &g_pri, &g_sec);
    }
    put(a, F_host_mass, i, host_m);
    put(a, F_host_rad, i, host_r);
  }
  float k, ksec;
  radius_ratios(c, radii, host_r, &k, &ksec);
  const float M_tot = fadd(host_m, masses);
  const float twin_R = fmul(fmul(host_r, 2.0f), c.RSUN);
  const float Rh_cm = fmul(host_r, c.RSUN);
  const float R_occ = fmul(radii, c.RSUN);
  if (Twin) {
    // _twin_geom at 2P with the grazing-edge mixture; _twin_pack
    const float at = semimajor(c, fmul(P, 2.0f), M_tot);
    const float sn = sinf(fmul(fmul(w, c.pi), c.inv180));
    const float es1 = fadd(fmul(e, sn), 1.0f);
    const float one_e2 = fsub(1.0f, fmul(e, e));
    const float Ptra = fmul(fdiv(fadd(R_occ, Rh_cm), at), fdiv(es1, one_e2));
    const float rt = fdiv(fmul(at, one_e2), es1);
    const bool coll = twin_R > fmul(at, fsub(1.0f, e));
    const Inc in = inc_twin_mixture(c, s1, Ptra);
    put(a, F_a, i, at);
    put(a, F_incs, i, in.incs);
    put(a, F_b, i, impact(c, rt, in.incs, host_r));
    put(a, F_lnw, i, fadd(in.lnw, lnqmass));
    put(a, F_inc_rad, i, fmul(in.incs, c.rad_per_deg));
    put(a, F_a_R, i, fdiv(at, Rh_cm));
    put_mask(a, M_mask, i, in.tra_ok && !coll && ok);
  } else {
    // _eb_normal_branch (+ _eb_branches' shared twin), _eb_pack(_normal)
    const Orbit o = geom_base(c, P, M_tot, host_r, R_occ, e, w);
    const Inc in = inc_weighted(a, s1, o.Ptra);
    put(a, F_a, i, o.a);
    put(a, F_incs, i, in.incs);
    put(a, F_b, i, impact(c, o.r, in.incs, host_r));
    put(a, F_lnw, i, in.lnw);
    put(a, F_inc_rad, i, fmul(in.incs, c.rad_per_deg));
    put(a, F_a_R, i, fdiv(o.a, Rh_cm));
    put_mask(a, M_mask, i, in.tra_ok && !o.coll && qs < c.q_twin && ok);
    if (a.shared_twin) {
      const float at = semimajor(c, fmul(P, 2.0f), M_tot);
      const float sn = sinf(fmul(fmul(w, c.pi), c.inv180));
      const float es1 = fadd(fmul(e, sn), 1.0f);
      const float one_e2 = fsub(1.0f, fmul(e, e));
      const float Ptra = fmul(fdiv(fadd(R_occ, Rh_cm), at),
                              fdiv(es1, one_e2));
      const float rt = fdiv(fmul(at, one_e2), es1);
      const bool coll = twin_R > fmul(at, fsub(1.0f, e));
      const Inc it = inc_weighted(a, s1, Ptra);
      put(a, F_a_twin, i, at);
      put(a, F_incs_twin, i, it.incs);
      put(a, F_b_twin, i, impact(c, rt, it.incs, host_r));
      put(a, F_lnw_twin, i, it.lnw);
      put(a, F_inc_rad_twin, i, fmul(it.incs, c.rad_per_deg));
      put(a, F_a_R_twin, i, fdiv(at, Rh_cm));
      put_mask(a, M_mask_twin, i,
               it.tra_ok && !coll && qs >= c.q_twin && ok);
    }
  }
  put(a, F_qs, i, qs);
  put(a, F_eccs, i, e);
  put(a, F_argps, i, w);
  put(a, F_masses, i, masses);
  put(a, F_radii, i, radii);
  put(a, F_fluxratios, i, fr);
  put(a, F_w_rad, i, fmul(fsub(c.w_zero, w), c.rad_per_deg));
  put(a, F_k, i, k);
  put(a, F_ksec, i, ksec);
  put(a, F_g_pri, i, g_pri);
  put(a, F_g_sec, i, g_sec);
}

template <typename K>
int launch(K kernel, const Args* a, void* stream) {
  const long long blocks = (a->n + kThreads - 1) / kThreads;
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sampler_planet_launch(const Args* a, int star, void* stream) {
  switch (star) {
    case STAR_T: return launch(planet_kernel<STAR_T>, a, stream);
    case STAR_P: return launch(planet_kernel<STAR_P>, a, stream);
    case STAR_S: return launch(planet_kernel<STAR_S>, a, stream);
    case STAR_D: return launch(planet_kernel<STAR_D>, a, stream);
    case STAR_B: return launch(planet_kernel<STAR_B>, a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int sampler_eb_launch(const Args* a, int star, void* stream) {
  switch (star) {
    case STAR_T: return launch(eb_kernel<STAR_T, false>, a, stream);
    case STAR_P: return launch(eb_kernel<STAR_P, false>, a, stream);
    case STAR_S: return launch(eb_kernel<STAR_S, false>, a, stream);
    case STAR_D: return launch(eb_kernel<STAR_D, false>, a, stream);
    case STAR_B: return launch(eb_kernel<STAR_B, false>, a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int sampler_twin_launch(const Args* a, int star, void* stream) {
  switch (star) {
    case STAR_T: return launch(eb_kernel<STAR_T, true>, a, stream);
    case STAR_P: return launch(eb_kernel<STAR_P, true>, a, stream);
    case STAR_S: return launch(eb_kernel<STAR_S, true>, a, stream);
    case STAR_D: return launch(eb_kernel<STAR_D, true>, a, stream);
    case STAR_B: return launch(eb_kernel<STAR_B, true>, a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// the interface's names (fields; masks; pack columns) and sizeof(Args),
// for the Python side's check at load
extern "C" const char* sampler_layout(int* args_size) {
  *args_size = (int)sizeof(Args);
  return kLayout;
}
