// Fused exposure z^2 -> supersample -> Chebyshev deficit -> chi^2 for one
// draw chunk, in two schedules. Each schedule is one kernel body, templated
// on where the exposure z^2 model comes from (the z^2 source) and on where
// each draw's deficit coefficients come from (the coefficient stage).
//
// Replaces the JAX package's Pallas TPU kernels
//   * ops/pallas_core.py::chi2_supersampled (body _chi2_kernel, helper
//     _clenshaw_tile; the v2 schedule): chi2_kernel_v2 below, with
//     CopyStage, TabStage or ExactStage;
//   * ops/pallas_core.py::chi2_supersampled_v3 (body _chi2_kernel_v3; the
//     time-major v3 schedule): chi2_kernel_v3 below, with V3CopyStage or
//     V3TabStage;
// and, with the orbit source, the XLA producer that fed them on the TPU
// (ops/lightcurve.py::_chi2_pallas: exposure_z2_poly, or projected_z at
// one node). The tab stages also replace the rest of that producer under
// tabulated coefficients (ops/fastcore.py::cheb_deficit_coeffs_tab: one
// matmul per chunk on the TPU's matrix unit), and ExactStage the rest
// under exact ones (ops/fastcore.py::cheb_deficit_coeffs: the
// occultation deficit of ops/occult.py at 54 nodes per draw, then a DCT
// product). All compute the same function:
//
//   out[c] = sum_t gD (2 obs[t] + gD) + sum_t obs[t]^2,
//   gD     = g[c] * front[c,t] * sum_s wgt[s] D_c(z_s),
//   z_s^2  = q0 + q1 d_s + q2 d_s^2           (exposure node offsets d_s),
//
// with D_c the per-draw three-segment sqrt-map Chebyshev deficit
// (ops/fastcore.py::cheb_deficit_eval), clipped to [0, 1].
//
// The z^2 source gives (q0, q1, q2, front) at one (draw, time) point:
//   * PlaneSource reads them from four f32 planes in device memory,
//     draw-major (C, n_t) for v2 or time-major (n_t, C) for v3 (the TPU
//     kernels' contract);
//   * OrbitSource computes them in registers from the draw's orbit (P,
//     a_R, inc, e, w) and the exposure time: core/kepler.py::z2_taylor
//     (one Markley + Householder-4 Kepler solve, closed-form derivatives)
//     or, at one node, projected_z with q0 = z^2, q1 = q2 = 0.
// The coefficient stage fills a warp's shared-memory slot with a draw's 3
// x 18 coefficients and gives its five segment scalars:
//   * CopyStage (v2) and V3CopyStage (v3) copy them from the (C, 18) x 3
//     and (C, 5) arrays of a coefficient stage run before the kernel;
//   * TabStage (v2) and V3TabStage (v3) compute the tabulated ones from
//     (k, u1, u2) and the (152, 162) table the block staged in shared
//     memory (tab_coeffs);
//   * ExactStage (v2) computes the exact ones from (k, u1, u2): the
//     deficit at the 3 x 18 Chebyshev nodes of the draw's z-segments
//     (occult_deficit), then their DCT from the copy of dct_T the block
//     staged in shared memory.
//
// What bounds it on an H100: with planes, 16 bytes per (draw, time) point
// against ~16 flops to find a point out of transit, so bytes bound it (the
// planes are 26 of the 30 MB a 16384 x 100 launch reads). The orbit source
// reads 4 bytes per time point and 28 per draw (orbit, g, the result)
// besides the coefficients, and spends ~165 FP32 operations per point on the Kepler
// solve and the z^2 model (among them an IEEE sin/cos pair, a cube root, a
// square root and fourteen divisions, each several instructions), plus
// ~300 per point in transit for the deficit at GL-4: operations bound it.
// The copy stages read 236 bytes of coefficients per draw; the tab stages
// read 12 and add ~2 deg 162 + 324 operations per draw (deg <= 24, its
// k-segment's degree); the exact stage reads 12 and adds ~21,000: 54
// deficits of ~350 operations (11 Gauss-Legendre nodes, each an IEEE cosf,
// square root and division, and two atan2f) and a 54 x 18 DCT, about what
// the point loop of a 100-point curve costs: still operations. On a folded
// curve most exposures of a long curve cannot be in transit for a given
// draw; both bodies find them from ~160 operations per draw and ~8 per
// point, before any solve (chi2_kernel_v2 on curves of V2_WINDOW_MIN_T
// points or more, V2_EXACT_WINDOW_MIN_T with the exact stage).
//
// What the design does about it:
//   * point_deficit, the per-point work (sqrt map, recurrence with its
//     segment select, clip, node weights), is one inlined device function
//     that both bodies call, templated on how the slot is laid out
//     (SharedCoeffs: one draw's 54 in a row, the point's segment picks a
//     block; LaneCoeffs: draws in columns); the five segment scalars stay
//     in registers; the recurrence is unrolled;
//   * the orbit source keeps the (C, n_t) planes out of device memory
//     altogether: its per-draw constants (clamped e, n, the mean anomaly at
//     transit, sin/cos w, sin^2/cos^2 inc, sqrt(1 - e^2)) are computed once
//     per warp (v2) or thread (v3), every point runs its own Kepler solve;
//   * v2 (chi2_kernel_v2): persistent blocks of V2_WARPS warps, as many as
//     fit on the card (the occupancy calculator; the launch bounds hold a
//     thread to 64 registers, so two blocks, 32 warps, per SM), whose
//     warps walk the draws, one draw a warp at a time. The stage fills the
//     warp's slot (one copy of the 54 coefficients per warp: all 54 in
//     every lane's registers took 106 registers a thread and allowed 16
//     warps per SM), then lanes stride over time, so plane loads are
//     coalesced and the orbit source keeps all lanes busy on the solve; a
//     32-point group in which no lane is in front with z < zmax at any
//     node skips the square roots and the recurrence (__any_sync); the
//     per-draw sum is a __shfl_xor_sync butterfly. On a curve of at least
//     Stage::kWindowMinT points (V2_WINDOW_MIN_T, V2_EXACT_WINDOW_MIN_T
//     with the exact stage) the orbit instances take the windowed body
//     (Win), in blocks of V2_WIN_WARPS = 32 warps, one per SM (the tab
//     stage's table once per SM, the rest of shared memory L1 for the
//     curve): the warp computes its draw's transit window (transit_window,
//     as v3, its seven eccentric anomalies on seven lanes at once), each
//     lane tests its exposure against it and a group in
//     which no lane is inside skips the Kepler solve and the z^2 model as
//     well, adding obs^2 alone as a group out of transit does. The window
//     holds every exposure that can be in transit, so the output is the
//     unwindowed body's bit for bit; a warp serves one draw, so it solves
//     its draw's own window, not a union. On a sorted curve most groups
//     of a long curve skip the solve; on a shuffled one nearly every group
//     solves, at ~8 operations a point more. TabStage's block copies
//     the (152, 162) coefficient table (98,496 bytes) into shared memory
//     once, with one TMA bulk copy completed on an mbarrier (the table
//     allows two copies per SM); per draw the warp computes the tabulated
//     coefficients (tab_coeffs: the k-segment's kappa, the Chebyshev
//     recurrence in kappa, 27 lanes x 2 outputs of the three basis sums
//     over the segment's table rows, the limb-darkening weights). In
//     ExactStage lanes 0-26 each evaluate two of the draw's 54 node
//     deficits into the warp's scratch row, then each forms two
//     coefficients from the scratch row and the block's dct_T. The (C, 18)
//     coefficients, and the torch stages' (C, 152), (C, 162) or (C, 18,
//     11) intermediates, never reach device memory;
//   * v3 (chi2_kernel_v3): draws on lanes, as on the TPU (one draw per
//     lane there): a warp takes V3_DRAWS = 8 consecutive draws, four lanes
//     each, and walks the time axis four points a step, so the lanes of a
//     step read neighbouring plane entries (time-major) or time values.
//     Persistent blocks of 32 warps, one per SM (the most that 64
//     registers a thread and the tab instance's table plus 32 slots in
//     shared memory allow); a warp's draws keep their coefficients in its
//     shared-memory slot, coefficient-major with an odd pitch (the copy
//     stage copies them from the (C, 18) arrays, the tab stage computes
//     them with tab_coeffs from the table the block staged, one TMA bulk
//     copy as TabStage). Per draw, before any solve, the orbit
//     source bounds the mean-anomaly window outside which no node can be
//     in transit (transit_window); per TIME_SUB steps each lane tests its
//     points against its draw's window and the warp ORs the bits, so the
//     Kepler solve and the deficit run only at steps some lane's window
//     holds, and the deficit only where some lane is in transit. Transits
//     of a folded curve sit at t = 0 for every draw, so the windows
//     overlap; the warp solves the union of its draws' windows, and
//     fewer draws a warp (8, not the TPU's 32 lanes) keep that union
//     close to each draw's own window. A draw's four lanes add their sums
//     with two shuffles: no atomic.
// All are deterministic. Points inside a group or block that does run keep
// their ~1e-8 deficit residue at z >= zmax, as on the TPU.
//
// Targets: the orbit entry points take B targets in one launch (the
// counterpart of jax.vmap over the Pallas call, whose grid gains a target
// axis). The C draws are target-major, Cb = C / B per target, and draw c
// reads its own target's exposure times and observed curve, rows
// b = c / Cb of time (B, n_t) and obs (B, n_t). In chi2_kernel_v2 a warp
// serves one draw at a time and in chi2_kernel_v3 V3_DRAWS draws of one
// target (Cb % 32 == 0), so b is uniform over the warp and the warp votes
// stay per target, and a draw's result does not depend on the launch it is
// in. The plane entry points are one target (Cb = C).
//
// Float32 semantics: square roots and divisions stay IEEE, sin/cos/atan2
// are the accurate sinf/cosf/atan2f (no --use_fast_math, no __sinf), the
// cube root is cbrtf (the torch version's |x|^(1/3) pow differs by an ulp;
// the Householder-4 step absorbs it), rounding to the nearest 2pi turn is
// rintf (half to even, as torch.round), and sign(0) is 0 as torch.sign.
// nvcc contracts a*b + c into FMAs; the two places where that would undo a
// deliberate rounding, the compensated 2pi wrap and the sum of squares
// cu^2 + cos^2(i) su^2, are written with __fmul_rn / __fadd_rn so they
// round each product on its own, as core/kepler.py does. In tab_coeffs
// the Chebyshev recurrence in kappa is written the same way (a rounding
// there grows with the degree); the basis sums and the weights are plain
// FMAs, and every scalar of the table's segments is the float32 that
// torch rounds fastcore.py's Python floats to. occult_deficit rounds every
// + - * / on its own, as torch does, with occult.py's constants and
// Gauss-Legendre nodes rounded to float32 as torch rounds them; its node
// positions likewise; only the DCT sums are FMAs. In chi2_kernel_v3 a lane
// sums a quarter of a whole curve, so its sum of gD (2 obs + gD) is
// compensated (Kahan, with the same intrinsics) and sum obs^2 is taken in
// double.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int M_CHEB = 18;
constexpr int MAX_NODES = 4;
// chi2_kernel_v3: warps per persistent block (one block of the tab
// instance per SM holds the table and 32 warp slots, at most 64 registers
// a thread), draws per warp and the lanes that share a draw (lane l takes
// draw l % V3_DRAWS and every V3_SPLIT-th time step from l / V3_DRAWS),
// the draw multiple the wrappers check, the time steps of one window vote,
// and a warp's coefficient slot: coefficient-major [3 M_CHEB][V3_PITCH]
// floats with draw d in column d (an odd pitch puts the column written for
// one draw, and a coefficient's row read by the draws, in distinct banks),
// padded to 16 bytes
constexpr int V3_WARPS = 32;
constexpr int V3_THREADS = V3_WARPS * 32;
constexpr int V3_DRAWS = 8;
constexpr int V3_SPLIT = 32 / V3_DRAWS;
constexpr int V3_DRAW_LANES = 128;
constexpr int TIME_SUB = 8;
constexpr int V3_PITCH = V3_DRAWS + 1;
constexpr int V3_SLOT = 3 * M_CHEB * V3_PITCH + 2;
// chi2_kernel_v2: warps per persistent block and blocks per SM the
// registers must allow (2 x 16 warps: at most 64 registers a thread; the
// tab stage's table allows two copies per SM), floats of one draw's
// coefficient slot (A, B1, B2 rows of M_CHEB, padded), the lanes that form
// the 54 coefficients, two each, and a row of the coefficient launches'
// output (the 54, then zsplit, zmid, invA, invB1, invB2)
constexpr int V2_WARPS = 16;
constexpr int V2_MIN_BLOCKS = 2;
// chi2_kernel_v2: the fewest exposures at which an orbit launch takes the
// windowed instance (Win: the per-draw transit window, then the Kepler
// solve only in the 32-point groups it holds), with the copy and tab
// stages and with the exact one, and that instance's warps per block. On
// an H100, on evenly spaced points in |t| < 0.15 or 0.4 d, the windowed
// tab and copy instances are slower at 32 and 64 points (every group holds
// a window point) and faster from 100 on: by 4 % at 100 points in 0.15 d,
// by 13 % or more from 256 on. 100-point calc_probs calls, which the host
// paces, read no gain from it, so the windowed instance starts at 256.
// The exact instance, whose stage is most of a draw's work on a short
// curve, wins from 512 on. chi2_core.py keeps the same values. The
// windowed blocks take a whole SM (one copy of the tab stage's table per
// SM), which leaves the rest of the SM's shared memory to L1, where a long
// curve's exposure times and observations stay for the groups that read
// them without a solve
constexpr int V2_WINDOW_MIN_T = 256;
constexpr int V2_EXACT_WINDOW_MIN_T = 512;
constexpr int V2_WIN_WARPS = 32;
constexpr int V2_THREADS = V2_WARPS * 32;
constexpr int COEF_SLOT = 64;
constexpr int OUT_LANES = 3 * M_CHEB / 2;
constexpr int COEF_OUT = 3 * M_CHEB + 5;
// the tab stages' coefficient table: k-segments and columns (3 z-segments
// x M_CHEB x 3 basis functions)
constexpr int TAB_SEGS = 8;
constexpr int TAB_COLS = 3 * M_CHEB * 3;
// ExactStage: occult.py's Gauss-Legendre order in float32, and the floats
// of its table in shared memory (dct_T, M_CHEB x M_CHEB, then the M_CHEB
// S-nodes, padded to 16 bytes)
constexpr int N_GL = 11;
constexpr int EXACT_TABLE = (M_CHEB * M_CHEB + M_CHEB + 3) / 4 * 4;

// core/kepler.py's constants: each Python double rounded once to f32, as
// torch and jax round a Python scalar that meets a float32 tensor
constexpr double PI_D = 3.141592653589793;
constexpr float E_MAX = 0.995f;
constexpr float PI_F = (float)PI_D;
constexpr float TWO_PI_F = (float)(2.0 * PI_D);
constexpr float HALF_PI_F = (float)(PI_D / 2.0);
constexpr float WRAP_HEAD = 6.28125f;   // 2pi = head + tail, head * k exact
constexpr float WRAP_TAIL = (float)0.001935307179586232;
constexpr float MARKLEY_C0 = (float)(3.0 * PI_D * PI_D);
constexpr float MARKLEY_C1 = (float)(1.6 * PI_D);
constexpr float MARKLEY_DEN = (float)(PI_D * PI_D - 6.0);
constexpr float SIXTH = (float)(1.0 / 6.0);
constexpr float THIRD = (float)(1.0 / 3.0);
constexpr float INV_TWO_PI_F = (float)(1.0 / (2.0 * PI_D));
constexpr float THREE_HALF_PI_F = (float)(1.5 * PI_D);
// The transit window's margins (transit_window; chi2_core.py keeps the
// same values): an absolute pad in mean anomaly (rad), a relative margin
// for float32 rounding of z^2 and its model, a per-point relative margin
// on |n t|, the shortest arc of true anomaly (rad) whose mean-anomaly arc
// is trusted, and the half width that stands for the whole orbit
constexpr float WIN_PAD = 1e-4f;
constexpr float WIN_REL = 1e-5f;
constexpr float WIN_REL_M = 1e-6f;
constexpr float WIN_MIN_ARC = 1e-3f;
constexpr float WIN_WHOLE = 4.0f;

struct Nodes {
  float off[MAX_NODES];
  float off2[MAX_NODES];
  float wgt[MAX_NODES];
};

// The per-draw inputs of the copy stages besides the z^2 source.
struct Chi2Args {
  const float* cA;
  const float* cB1;
  const float* cB2;
  const float* seg;
  const float* g;
  const float* obs;   // (B, n_t), row c / Cb for draw c
  float* out;
  int Cb;             // draws per target
};

// One draw's coefficients in its warp's shared-memory slot, A at 0, B1 at
// M_CHEB, B2 at 2 M_CHEB (the same m of the three rows in three banks),
// and the segment scalars in registers. segment() names the coefficient
// row of a point's z-segment and coef() reads one coefficient of it (the
// accessor point_deficit is written against).
struct SharedCoeffs {
  const float* slot;
  float zsplit, zmid, invA, invB1, invB2, zmax2;

  using Seg = const float*;
  __device__ __forceinline__ Seg segment(bool inB1, bool inB2) const {
    return slot + (inB2 ? 2 * M_CHEB : (inB1 ? M_CHEB : 0));
  }
  __device__ __forceinline__ float coef(Seg sg, int m) const {
    return sg[m];
  }
};

// ---------------------------------------------------------------------------
// z^2 sources. Each has target(row), the source for the target whose rows
// of time and obs start at offset row, a Draw of per-draw state (draw(c),
// once per draw) and point(d, t, q0, q1, q2, front) for one exposure t of
// that draw.

// The four planes in device memory, draw-major (C, n_t) for v2 or
// time-major (n_t, C) for v3; stride is the length of a row (n_t or C).
// A draw's transit window (transit_window): its exposures can be in
// transit only where n t, wrapped to within pi of mid, lies within half
// of mid. half < 0: never; half >= WIN_WHOLE: the whole orbit.
struct Window {
  float mid, half;

  __device__ __forceinline__ bool contains(float n, float t) const {
    const float x = n * t;
    const float y = x - mid;
    const float yw = y - TWO_PI_F * rintf(y * INV_TWO_PI_F);
    return half >= WIN_WHOLE || fabsf(yw) <= half + WIN_REL_M * fabsf(x);
  }
};

template <bool TimeMajor>
struct PlaneSource {
  const float* q0;
  const float* q1;
  const float* q2;
  const float* front;
  int64_t stride;
  static constexpr bool kOneNode = false;
  static constexpr bool kWindow = false;   // no orbit: every point runs

  struct Draw {
    int64_t base;
  };
  // one target: the planes hold no time axis of their own
  __device__ __forceinline__ PlaneSource target(int64_t) const {
    return *this;
  }
  __device__ __forceinline__ Draw draw(int c) const {
    return {TimeMajor ? (int64_t)c : (int64_t)c * stride};
  }
  __device__ __forceinline__ void point(const Draw& d, int t, float& a0,
                                        float& a1, float& a2,
                                        float& fr) const {
    const int64_t i = TimeMajor ? d.base + (int64_t)t * stride : d.base + t;
    a0 = __ldg(q0 + i);
    a1 = __ldg(q1 + i);
    a2 = __ldg(q2 + i);
    fr = __ldg(front + i);
  }
};

// torch.sign: 0 at 0
__device__ __forceinline__ float sign0(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// core/kepler.py::solve_kepler_sc, float32 branch, returning (sinE, cosE):
// compensated 2pi wrap, Markley (1995) starter on |Mw|, one staged
// Householder-4 step, third-order Taylor rotation of the pair. e is
// already clamped to [0, E_MAX].
__device__ __forceinline__ void kepler_sc(float M, float e, float& sinE,
                                          float& cosE) {
  const float k = rintf(M / TWO_PI_F);
  const float Mw = __fsub_rn(__fsub_rn(M, __fmul_rn(k, WRAP_HEAD)),
                             __fmul_rn(k, WRAP_TAIL));
  const float s = sign0(Mw);
  const float Ma = fabsf(Mw);
  const float alpha =
      (MARKLEY_C0 + MARKLEY_C1 * (PI_F - Ma) / (1.0f + e)) / MARKLEY_DEN;
  const float d = 3.0f * (1.0f - e) + alpha * e;
  const float q = 2.0f * alpha * d * (1.0f - e) - Ma * Ma;
  const float r = 3.0f * alpha * d * (d - 1.0f + e) * Ma + Ma * Ma * Ma;
  const float cb = cbrtf(fabsf(r) + sqrtf(fmaxf(q * q * q + r * r, 0.0f)));
  const float w = cb * cb;
  const float E = (2.0f * r * w / (w * w + w * q + q * q) + Ma) / d;
  float sE, cE;
  sincosf(E, &sE, &cE);
  const float f = E - e * sE - Ma;
  const float fp = 1.0f - e * cE;
  const float fpp = e * sE;
  const float fppp = e * cE;
  const float d1 = -f / fp;
  const float d2 = -f / (fp + 0.5f * d1 * fpp);
  const float dE = -f / (fp + 0.5f * d2 * fpp + d2 * d2 * fppp * SIXTH);
  sinE = s * (sE + dE * (cE - 0.5f * dE * (sE + dE * cE * THIRD)));
  cosE = cE - dE * (sE + 0.5f * dE * (cE - dE * sE * THIRD));
}

// Eccentric anomaly of true anomaly f, as kepler.py::mean_anomaly_at_transit
// forms it (sm = sqrt(1 - e), sp = sqrt(1 + e)).
__device__ __forceinline__ float ecc_anomaly(float f, float sm, float sp) {
  float sh, ch;
  sincosf(f / 2.0f, &sh, &ch);
  return 2.0f * atan2f(sm * sh, sp * ch);
}

// The mean anomaly swept going forward from eccentric anomaly E1 to E2
// (the E arc taken in [0, 2pi)); s1, s2 are their sines.
__device__ __forceinline__ float mean_arc(float E1, float s1, float E2,
                                          float s2, float e) {
  const float dE = E2 - E1;
  return dE - TWO_PI_F * floorf(dE * INV_TWO_PI_F) - e * (s2 - s1);
}

// The draw's transit window in mean anomaly about its transit (n t = 0),
// outside which no exposure node can count (model z^2 < zmax2 with the
// exposure centre in front), computed once per draw before any solve.
// z^2 = r^2 (cos^2 u + C sin^2 u) with u = w + f and r >= rmin = aR (1 - e),
// so a node's z < zeff needs |cos u| < sqrt((zeff^2 / rmin^2 - C) / S) =
// sin(th): u within th of pi/2 (in front) or 3pi/2 (behind). zeff^2 pads
// zmax2 by the most the quadratic model can undershoot z^2 at a node,
// |d|^3 / 6 max|d^3 z^2 / dt^3| <= |d|^3 / 6 (2 rmax J + 6 V A) with V,
// A, J bounds on the orbit's speed, acceleration and jerk (the sky
// projection only shrinks them), and by WIN_REL for float32 rounding.
// Both ends u = pi/2 -+ th map to M through E(f); the arc is padded by
// the nodes' spread n max|d| and WIN_PAD. A centre in front with a node
// near u = 3pi/2 needs the mean-anomaly gap between u = pi (or 2pi) and
// that branch within the spread: then, and where no th exists
// (zeff >= rmin), the window is the whole orbit; where even u = pi/2
// keeps z >= zeff it is empty. The seven eccentric anomalies (and their
// sines) are most of the work: with Warp, the whole warp computes one
// draw's window, lane j < 7 the j-th anomaly, shared by shuffles; without,
// each thread computes its own draw's (v3: the lanes hold 8 draws).
template <bool Warp>
__device__ __forceinline__ Window transit_window(float e, float aR, float n,
                                                 float S, float C, float w,
                                                 float zmax2, float dmax,
                                                 int lane) {
  const float ome = 1.0f - e, ope = 1.0f + e;
  const float rmin = aR * ome, rmax = aR * ope;
  const float V = aR * n * sqrtf(ope / ome);
  const float A = aR * n * n / (ome * ome);
  const float J = 4.0f * n * n * V / (ome * ome * ome);
  const float d2 = dmax * dmax;
  const float T =
      d2 * dmax * SIXTH * (2.0f * rmax * J + 6.0f * V * A) +
      WIN_REL * (rmax * rmax + 2.0f * rmax * V * dmax + (V * V + rmax * A) * d2);
  const float zeff2 = (zmax2 + T) * (1.0f + WIN_REL);
  const float x = zeff2 / (rmin * rmin) - C;
  if (!(x > 0.0f)) return {0.0f, -1.0f};
  const float th = asinf(sqrtf(fminf(x / S, 1.0f)));
  if (!(HALF_PI_F - th > WIN_MIN_ARC)) return {0.0f, WIN_WHOLE};
  const float spread = n * dmax + WIN_PAD;
  const float sm = sqrtf(ome), sp = sqrtf(ope);
  const float fc = HALF_PI_F - w;
  const float fs = THREE_HALF_PI_F - w;
  // the true anomalies of the arc's centre and ends, and of the ends of
  // the arcs from u = pi to the branch behind the star and from it to 2pi
  const float f[7] = {fc, fc - th, fc + th, PI_F - w, fs - th, fs + th, -w};
  float E[7], sE[7];
  if constexpr (Warp) {
    float fl = f[0];
#pragma unroll
    for (int j = 1; j < 7; ++j) fl = lane == j ? f[j] : fl;
    const float El = ecc_anomaly(fl, sm, sp);
    const float sl = sinf(El);
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      E[j] = __shfl_sync(0xffffffffu, El, j);
      sE[j] = __shfl_sync(0xffffffffu, sl, j);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      E[j] = ecc_anomaly(f[j], sm, sp);
      sE[j] = sinf(E[j]);
    }
  }
  const float a = mean_arc(E[1], sE[1], E[0], sE[0], e);
  const float b = mean_arc(E[0], sE[0], E[2], sE[2], e);
  const float gap = fminf(mean_arc(E[3], sE[3], E[4], sE[4], e),
                          mean_arc(E[5], sE[5], E[6], sE[6], e));
  if (!(gap > spread) || !(a + b + 2.0f * spread < TWO_PI_F))
    return {0.0f, WIN_WHOLE};
  return {0.5f * (b - a), 0.5f * (a + b) + spread};
}

// The draw's orbit. Projected = false: core/kepler.py::z2_taylor at the
// exposure centre (q1 = dz^2/dt, q2 = d^2z^2/dt^2 / 2); Projected = true:
// projected_z, q0 = z^2 and q1 = q2 = 0 (the one-node path).
template <bool Projected>
struct OrbitSource {
  const float* time;
  const float* P;
  const float* aR;
  const float* inc;
  const float* ecc;
  const float* w;
  static constexpr bool kOneNode = Projected;
  static constexpr bool kWindow = true;

  struct Draw {
    float e, Mtc, sw, cw, S, C, ome2, aR;
    float n;          // 2pi / P as torch forms it: (1 / P) * 2pi
    float P;          // projected_z: M = M_tc + 2pi t / P
    float aRen, aRenn, nome2, m2enno;   // products z2_taylor forms first
  };

  __device__ __forceinline__ OrbitSource target(int64_t row) const {
    OrbitSource s = *this;
    s.time = time + row;
    return s;
  }

  __device__ __forceinline__ Draw draw(int c) const {
    Draw d;
    const float e = fminf(fmaxf(__ldg(ecc + c), 0.0f), E_MAX);
    const float wc = __ldg(w + c);
    const float ic = __ldg(inc + c);
    d.e = e;
    d.P = __ldg(P + c);
    d.aR = __ldg(aR + c);
    d.n = (1.0f / d.P) * TWO_PI_F;
    // kepler.py::mean_anomaly_at_transit
    const float nu_tc = HALF_PI_F - wc;
    float sh, ch;
    sincosf(nu_tc / 2.0f, &sh, &ch);
    const float E_tc = 2.0f * atan2f(sqrtf(1.0f - e) * sh, sqrtf(1.0f + e) * ch);
    d.Mtc = E_tc - e * sinf(E_tc);
    sincosf(wc, &d.sw, &d.cw);
    float si, ci;
    sincosf(ic, &si, &ci);
    d.S = si * si;
    d.C = ci * ci;
    d.ome2 = sqrtf((1.0f - e) * (1.0f + e));
    d.aRen = d.aR * e * d.n;
    d.aRenn = d.aRen * d.n;
    d.nome2 = d.n * d.ome2;
    d.m2enno = -2.0f * e * d.n * d.n * d.ome2;
    return d;
  }

  // draw c's transit window (d = draw(c)) for zmax^2 and nodes within
  // dmax of the exposure centre, computed by the thread or (Warp) by the
  // whole warp, whose lanes all hold draw c
  template <bool Warp = false>
  __device__ __forceinline__ Window window(const Draw& d, int c, float zmax2,
                                           float dmax, int lane = 0) const {
    return transit_window<Warp>(d.e, d.aR, d.n, d.S, d.C, __ldg(w + c),
                                zmax2, dmax, lane);
  }

  __device__ __forceinline__ float time_at(int ti) const {
    return __ldg(time + ti);
  }

  __device__ __forceinline__ void point(const Draw& d, int ti, float& a0,
                                        float& a1, float& a2,
                                        float& fr) const {
    const float t = __ldg(time + ti);
    const float e = d.e;
    float sinE, cosE;
    if (Projected) {
      kepler_sc(d.Mtc + TWO_PI_F * t / d.P, e, sinE, cosE);
      const float beta = 1.0f - e * cosE;
      const float inv_beta = 1.0f / beta;
      const float cnu = (cosE - e) * inv_beta;
      const float snu = d.ome2 * sinE * inv_beta;
      const float su = d.sw * cnu + d.cw * snu;
      const float cu = d.cw * cnu - d.sw * snu;
      const float z = d.aR * beta *
                      sqrtf(__fadd_rn(__fmul_rn(cu, cu),
                                      __fmul_rn(d.C, __fmul_rn(su, su))));
      a0 = z * z;
      a1 = 0.0f;
      a2 = 0.0f;
      fr = su > 0.0f ? 1.0f : 0.0f;
      return;
    }
    kepler_sc(d.Mtc + d.n * t, e, sinE, cosE);
    const float beta = 1.0f - e * cosE;
    const float r = d.aR * beta;
    const float rdot = d.aRen * sinE / beta;
    const float rdd =
        d.aRenn * (cosE * beta - e * sinE * sinE) / (beta * beta * beta);
    const float nudot = d.nome2 / (beta * beta);
    const float nudd = d.m2enno * sinE / (beta * beta * beta * beta);
    const float inv_beta = 1.0f / beta;
    const float cnu = (cosE - e) * inv_beta;
    const float snu = d.ome2 * sinE * inv_beta;
    const float su = d.sw * cnu + d.cw * snu;
    const float cu = d.cw * cnu - d.sw * snu;
    const float s2u = 2.0f * su * cu;
    const float c2u = 1.0f - 2.0f * su * su;
    const float A =
        __fadd_rn(__fmul_rn(cu, cu), __fmul_rn(d.C, __fmul_rn(su, su)));
    const float rrS = r * r * d.S;
    a0 = r * r * A;
    a1 = 2.0f * r * rdot * A - rrS * s2u * nudot;
    a2 = 0.5f * (2.0f * (rdot * rdot + r * rdd) * A -
                 4.0f * r * rdot * d.S * s2u * nudot -
                 rrS * (2.0f * c2u * nudot * nudot + s2u * nudd));
    fr = su > 0.0f ? 1.0f : 0.0f;
  }
};

// ---------------------------------------------------------------------------

// z^2 at each exposure node from the quadratic model; returns whether any
// node lies inside zmax.
template <int S>
__device__ __forceinline__ bool exposure_z2(float a0, float a1, float a2,
                                            const Nodes& nodes, float zmax2,
                                            float (&z2)[S]) {
  bool inside = false;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    z2[s] = a0 + a1 * nodes.off[s] + a2 * nodes.off2[s];
    inside |= z2[s] < zmax2;
  }
  return inside;
}

// Node-weighted mean deficit at one point: sqrt map, per-point segment
// select, 18-step Clenshaw, clip to [0, 1]. Coeffs is SharedCoeffs or
// LaneCoeffs.
template <int S, class Coeffs>
__device__ __forceinline__ float point_deficit(const float (&z2)[S],
                                               const Coeffs& k,
                                               const Nodes& nodes) {
  float dbar = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float z = sqrtf(fmaxf(z2[s], 0.0f));
    const bool inB2 = z >= k.zmid;
    const bool inB1 = (z >= k.zsplit) && !inB2;
    float sx = inB2 ? (z - k.zmid) * k.invB2
                    : (inB1 ? (z - k.zsplit) * k.invB1 : z * k.invA);
    sx = fminf(fmaxf(sx, 0.0f), 1.0f);
    const float x = sqrtf(sx) - sqrtf(1.0f - sx);
    const float two_x = 2.0f * x;
    const typename Coeffs::Seg sg = k.segment(inB1, inB2);
    float bb1 = 0.0f, bb2 = 0.0f;
#pragma unroll
    for (int m = M_CHEB - 1; m > 0; --m) {
      const float cm = k.coef(sg, m);
      const float nb = cm + two_x * bb1 - bb2;
      bb2 = bb1;
      bb1 = nb;
    }
    const float c0 = k.coef(sg, 0);
    const float D = fminf(fmaxf(c0 + x * bb1 - bb2, 0.0f), 1.0f);
    dbar = dbar + nodes.wgt[s] * D;
  }
  return dbar;
}

// The v2 schedule's sum for one draw, run by its warp: lanes stride the
// time axis, a 32-point group with no lane in transit skips the deficit,
// and a butterfly leaves the draw's sum in every lane. Win: each lane
// first tests its exposure against the draw's transit window (win), and a
// group with no lane inside it skips the Kepler solve as well and adds
// obs^2 alone, as a group with no lane in transit does (the window holds
// every exposure that can be in transit, so the sum is the same bit for
// bit); solved counts the groups that ran the solve.
template <bool Win, class Src, int S, class Coeffs>
__device__ __forceinline__ float draw_chi2(const Src& src,
                                           const typename Src::Draw& d,
                                           const Window& win,
                                           const Coeffs& k, float gc,
                                           const float* obs, int n_t,
                                           const Nodes& nodes, int lane,
                                           unsigned& solved) {
  float acc = 0.0f;
  for (int t0 = 0; t0 < n_t; t0 += 32) {
    const int t = t0 + lane;
    const bool inb = t < n_t;
    if constexpr (Win) {
      const bool near = inb && win.contains(d.n, src.time_at(t));
      if (!__any_sync(0xffffffffu, near)) {
        if (inb) {
          const float ob = __ldg(obs + t);
          acc += ob * ob;
        }
        continue;
      }
      ++solved;
    }
    float z2[S];
    float fr = 0.0f, ob = 0.0f;
    bool active = false;
    if (inb) {
      float a0, a1, a2;
      src.point(d, t, a0, a1, a2, fr);
      ob = __ldg(obs + t);
      active = exposure_z2<S>(a0, a1, a2, nodes, k.zmax2, z2);
      active &= fr > 0.0f;
      acc += ob * ob;
    }
    if (!__any_sync(0xffffffffu, active)) continue;
    if (!inb) continue;
    const float gD = gc * (point_deficit<S>(z2, k, nodes) * fr);
    acc += gD * (2.0f * ob + gD);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

// ---------------------------------------------------------------------------
// Coefficient stages: what they share, and the tabulated coefficients.

// fastcore.py::_segments for one draw: the three z-segments' breaks and
// widths (each width floored at 1e-6), from the unclipped k
struct ZSegs {
  float zsplit, zmid, wA, wB1, wB2;
};

__device__ __forceinline__ ZSegs z_segments(float kd, float slope,
                                            float floor_) {
  const float zsplit = fabsf(1.0f - kd);
  const float zmax = 1.0f + kd;
  const float c = fminf(fmaxf(slope * zsplit, floor_), (zmax - zsplit) / 2.0f);
  const float zmid = zsplit + c;
  return {zsplit, zmid, fmaxf(zsplit, 1e-6f), fmaxf(c, 1e-6f),
          fmaxf(zmax - zmid, 1e-6f)};
}

// The SharedCoeffs of a draw whose coefficients are in slot.
__device__ __forceinline__ SharedCoeffs shared_coeffs(const float* slot,
                                                      const ZSegs& zs) {
  SharedCoeffs k;
  k.slot = slot;
  k.zsplit = zs.zsplit;
  k.zmid = zs.zmid;
  k.invA = 1.0f / zs.wA;
  k.invB1 = 1.0f / zs.wB1;
  k.invB2 = 1.0f / zs.wB2;
  const float zm = k.zmid + 1.0f / k.invB2;
  k.zmax2 = zm * zm;
  return k;
}

// The coefficient table's k-segments (fastcore.py::_tab_kappa_onehot), each
// scalar the float32 that torch rounds fastcore.py's Python float to.
struct TabSegs {
  float lo[TAB_SEGS];     // the segment's lower break
  float shift[TAB_SEGS];  // kind 0, 3: lo; kind 1: log lo; kind 2: hi
  float den[TAB_SEGS];    // hi - lo, or log hi - log lo (kind 1)
  int kind[TAB_SEGS];     // 0 linear, 1 log, 2 sqrt toward hi, 3 toward lo
  int deg[TAB_SEGS];      // Chebyshev terms in kappa
  int row0[TAB_SEGS];     // the segment's first row of the table
  float kmin, kmax;       // the table's k range (clip)
  float slope, floor_;    // _BREAK_SLOPE, _BREAK_FLOOR of _segments
  int n_rows;             // rows of the table (sum of deg)
};

// The per-draw inputs of the stages that compute the coefficients from
// (k, u1, u2), besides the z^2 source.
struct KudArgs {
  const float* k;
  const float* u1;
  const float* u2;
  const float* g;
  const float* obs;     // (B, n_t), row c / Cb for draw c
  const float* table;   // the stage's table in device memory
  float* out;
  int Cb;               // draws per target
};

__host__ __device__ constexpr int tab_floats(int n_rows) {
  return n_rows * TAB_COLS;
}

// Copy the table (bytes, a multiple of 16) from device memory into the
// block's shared memory: one TMA bulk copy issued by thread 0, completed on
// an mbarrier that every thread then waits on.
__device__ __forceinline__ void stage_table(float* dst, const float* src,
                                            uint32_t bytes) {
  __shared__ uint64_t bar;
  const uint32_t bar_a = (uint32_t)__cvta_generic_to_shared(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_a)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_a),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
        "l"((uint64_t)__cvta_generic_to_global(src)), "r"(bytes), "r"(bar_a)
        : "memory");
  }
  __syncthreads();
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar_a)
        : "memory");
  } while (!done);
}

// One draw's tabulated deficit coefficients (fastcore.py::
// cheb_deficit_coeffs_tab), computed by its warp from the table in shared
// memory: lanes 0..26 write the 54 coefficients to slot (segment s, term m
// at s M_CHEB + m), two each; every lane returns the segment scalars of
// _segments(k) in k. The caller syncs the warp before reading the slot.
__device__ __forceinline__ void tab_coeffs(const float* tab,
                                           const TabSegs& ts, float kd,
                                           float u1, float u2, int lane,
                                           float* slot, SharedCoeffs& k) {
  const float kc = fminf(fmaxf(kd, ts.kmin), ts.kmax);
  // the active k-segment: the last whose lower break kc reaches
  float shift = ts.shift[0], den = ts.den[0];
  int kind = ts.kind[0], deg = ts.deg[0], row0 = ts.row0[0];
#pragma unroll
  for (int j = 1; j < TAB_SEGS; ++j) {
    if (kc >= ts.lo[j]) {
      shift = ts.shift[j];
      den = ts.den[j];
      kind = ts.kind[j];
      deg = ts.deg[j];
      row0 = ts.row0[j];
    }
  }
  float t;
  if (kind == 0) {
    t = (kc - shift) / den;
  } else if (kind == 1) {
    t = (logf(kc) - shift) / den;
  } else if (kind == 2) {
    t = 1.0f - sqrtf(fmaxf(shift - kc, 0.0f) / den);
  } else {
    t = sqrtf(fmaxf(kc - shift, 0.0f) / den);
  }
  const float kappa = fminf(fmaxf(2.0f * t - 1.0f, -1.0f), 1.0f);

  if (lane < OUT_LANES) {
    // basis sums sum_j T_j(kappa) tab[row0 + j, col] over this lane's six
    // columns (outputs 2 lane and 2 lane + 1, three basis functions each)
    const float2* col =
        reinterpret_cast<const float2*>(tab + row0 * TAB_COLS + 6 * lane);
    float bas[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const float two_k = 2.0f * kappa;
    float Tj = 1.0f, Tn = kappa;   // T_j and T_{j+1}
    for (int j = 0; j < deg; ++j) {
      const float2* r = col + j * (TAB_COLS / 2);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float2 v = r[q];
        bas[2 * q] = fmaf(Tj, v.x, bas[2 * q]);
        bas[2 * q + 1] = fmaf(Tj, v.y, bas[2 * q + 1]);
      }
      const float Tnn = __fsub_rn(__fmul_rn(two_k, Tn), Tj);
      Tj = Tn;
      Tn = Tnn;
    }
    // the rows are [A0, A1, J] / (pi k^2): limb-darkening weights
    const float om = __fsub_rn(__fsub_rn(1.0f, u1 / 3.0f), u2 / 6.0f);
    const float kk = fminf(kd, ts.kmax);
    const float scale = (kk * kk) / om;
    const float w0 = (1.0f - u1 - 2.0f * u2) * scale;
    const float w1 = (u1 + 2.0f * u2) * scale;
    const float w2 = u2 * scale;
    float2 o;
    o.x = fmaf(bas[2], w2, fmaf(bas[1], w1, bas[0] * w0));
    o.y = fmaf(bas[5], w2, fmaf(bas[4], w1, bas[3] * w0));
    reinterpret_cast<float2*>(slot)[lane] = o;
  }

  // _segments on the unclipped k
  k = shared_coeffs(slot, z_segments(kd, ts.slope, ts.floor_));
}

// ---------------------------------------------------------------------------
// The exact coefficient stage.

// occult.py's Python floats as torch rounds them against float32 tensors
constexpr float TWO_THIRDS = (float)(2.0 / 3.0);

// ExactStage's constants: fastcore.py's S-nodes and _segments' break, and
// occult.py's float32 Gauss-Legendre rule (sin^2 t_j and the weights of
// _gl_tables(_N_GL_F32)), each rounded to float32 as torch rounds them.
struct ExactConsts {
  float s_nodes[M_CHEB];
  float sin2t[N_GL];
  float wgt[N_GL];
  float slope, floor_;    // _BREAK_SLOPE, _BREAK_FLOOR
};

// occult.py::_stable_angle
__device__ __forceinline__ float stable_angle(float num1, float num2,
                                              float cos_2x) {
  return atan2f(sqrtf(__fmul_rn(fmaxf(num1, 0.0f), fmaxf(num2, 0.0f))),
                cos_2x);
}

// occult.py::occult_quad_deficit in float32 at one (p, z): the same
// operations in the same order, each + - * / rounded on its own as torch
// rounds it (the __f*_rn intrinsics keep nvcc from contracting them into
// FMAs), on the Gauss-Legendre nodes of ExactConsts. D in [0, 1].
__device__ __forceinline__ float occult_deficit(float p, float z, float u1,
                                                float u2,
                                                const ExactConsts& ec) {
  z = fminf(fabsf(z), __fadd_rn(__fadd_rn(1.0f, p), 1.0f));
  const float pp = __fmul_rn(p, p);
  const float zz = __fmul_rn(z, z);
  const float zmp = __fsub_rn(z, p), zpp = __fadd_rn(z, p);
  const float zp2m = __fsub_rn(1.0f, __fmul_rn(zmp, zmp));
  const float zp2p = __fsub_rn(__fmul_rn(zpp, zpp), 1.0f);
  const float zm1 = __fsub_rn(z, 1.0f), zp1 = __fadd_rn(z, 1.0f);
  const float kappa1 = stable_angle(__fsub_rn(pp, __fmul_rn(zm1, zm1)),
                                    __fsub_rn(__fmul_rn(zp1, zp1), pp),
                                    __fsub_rn(__fadd_rn(zz, 1.0f), pp));
  const float eta0 =
      stable_angle(zp2p, zp2m, __fsub_rn(__fsub_rn(1.0f, zz), pp));
  const float d_eta = __fsub_rn(PI_F, eta0);
  const float sin_eta0 = sinf(eta0);
  const float cos_eta0 = cosf(eta0);

  const float A0 = __fadd_rn(
      kappa1, __fmul_rn(p, __fsub_rn(__fmul_rn(p, d_eta),
                                     __fmul_rn(z, sin_eta0))));
  const float zz_pp = __fadd_rn(zz, pp);
  const float j1 = __fmul_rn(
      -__fadd_rn(__fmul_rn(zz_pp, z), __fmul_rn(__fmul_rn(2.0f, z), pp)),
      sin_eta0);
  const float j2 = __fmul_rn(__fmul_rn(zz_pp, p), d_eta);
  const float j3 = __fmul_rn(
      __fmul_rn(__fmul_rn(2.0f, zz), p),
      __fsub_rn(d_eta / 2.0f, __fmul_rn(sin_eta0, cos_eta0) / 2.0f));
  const float J = __fadd_rn(kappa1 / 2.0f,
                            __fmul_rn(__fmul_rn(2.0f, p) / 4.0f,
                                      __fadd_rn(__fadd_rn(j1, j2), j3)));

  // A1's quadrature over the occulter arc, eta = eta0 + d_eta sin^2 t
  const float zp2 = __fmul_rn(__fmul_rn(2.0f, z), p);
  float quad = 0.0f;
#pragma unroll
  for (int j = 0; j < N_GL; ++j) {
    const float cos_k = cosf(__fadd_rn(eta0, __fmul_rn(d_eta, ec.sin2t[j])));
    const float r2 = __fadd_rn(zz_pp, __fmul_rn(zp2, cos_k));
    const float one_m = fmaxf(__fsub_rn(1.0f, r2), 0.0f);
    const bool big = r2 > 1e-3f;
    const float G =
        big ? __fsub_rn(1.0f, __fmul_rn(one_m, sqrtf(one_m))) /
                  __fmul_rn(3.0f, r2)
            : __fadd_rn(__fsub_rn(0.5f, r2 / 8.0f), __fmul_rn(r2, r2) / 48.0f);
    const float integrand = __fmul_rn(G, __fadd_rn(__fmul_rn(z, cos_k), p));
    quad = __fadd_rn(quad, __fmul_rn(ec.wgt[j], integrand));
  }
  const float A1 = __fadd_rn(__fmul_rn(TWO_THIRDS, kappa1),
                             __fmul_rn(__fmul_rn(__fmul_rn(2.0f, p), d_eta),
                                       quad));

  const float omega = __fsub_rn(__fsub_rn(1.0f, u1 / 3.0f), u2 / 6.0f);
  const float two_u2 = __fmul_rn(2.0f, u2);
  const float D =
      __fadd_rn(__fadd_rn(__fmul_rn(__fsub_rn(__fsub_rn(1.0f, u1), two_u2),
                                    A0),
                          __fmul_rn(__fadd_rn(u1, two_u2), A1)),
                __fmul_rn(u2, J)) /
      __fmul_rn(PI_F, omega);
  return fminf(fmaxf(D, 0.0f), 1.0f);
}

// ---------------------------------------------------------------------------
// The v2 schedule (chi2_kernel_v2): a warp per draw.
//
// Its coefficient stages. Each says how many floats a warp needs besides
// its slot (kScratch) and how many the block's table takes in shared
// memory, stages that table (begin: every thread, ends synced), and fills
// a warp's slot with one draw's 54 coefficients (fill: the whole warp;
// returns the draw's SharedCoeffs, and the caller syncs the warp before
// reading the slot); and says where the per-draw g, obs and out live.

// The coefficients a coefficient stage made before the kernel ((C, 18) x 3
// and seg (C, 5)), copied into the slot: plane v2 and orbit v2.
struct CopyStage {
  Chi2Args p;
  static constexpr int kScratch = 0;
  static constexpr int kWindowMinT = V2_WINDOW_MIN_T;

  __host__ __device__ int table_floats() const { return 0; }
  __device__ __forceinline__ void begin(float*) const {}

  __device__ __forceinline__ SharedCoeffs fill(const float*, float*,
                                               float* slot, int c,
                                               int lane) const {
    if (lane < M_CHEB) {
      const int64_t i = (int64_t)c * M_CHEB + lane;
      slot[lane] = __ldg(p.cA + i);
      slot[M_CHEB + lane] = __ldg(p.cB1 + i);
      slot[2 * M_CHEB + lane] = __ldg(p.cB2 + i);
    }
    SharedCoeffs k;
    k.slot = slot;
    k.zsplit = __ldg(p.seg + c * 5 + 0);
    k.zmid = __ldg(p.seg + c * 5 + 1);
    k.invA = __ldg(p.seg + c * 5 + 2);
    k.invB1 = __ldg(p.seg + c * 5 + 3);
    k.invB2 = __ldg(p.seg + c * 5 + 4);
    const float zmax = k.zmid + 1.0f / k.invB2;
    k.zmax2 = zmax * zmax;
    return k;
  }
  __device__ __forceinline__ const float* g() const { return p.g; }
  __device__ __forceinline__ const float* obs() const { return p.obs; }
  __device__ __forceinline__ float* out() const { return p.out; }
  __host__ __device__ int Cb() const { return p.Cb; }
};

// The tabulated coefficients (tab_coeffs) from the table the block staged
// with one TMA bulk copy: the tab instance.
struct TabStage {
  KudArgs p;   // p.table: the (n_rows, TAB_COLS) table, 16-byte aligned
  TabSegs ts;
  static constexpr int kScratch = 0;
  static constexpr int kWindowMinT = V2_WINDOW_MIN_T;

  __host__ __device__ int table_floats() const {
    return tab_floats(ts.n_rows);
  }
  __device__ __forceinline__ void begin(float* smem) const {
    stage_table(smem, p.table, 4u * tab_floats(ts.n_rows));
  }
  __device__ __forceinline__ SharedCoeffs fill(const float* table, float*,
                                               float* slot, int c,
                                               int lane) const {
    SharedCoeffs k;
    tab_coeffs(table, ts, __ldg(p.k + c), __ldg(p.u1 + c), __ldg(p.u2 + c),
               lane, slot, k);
    return k;
  }
  __device__ __forceinline__ const float* g() const { return p.g; }
  __device__ __forceinline__ const float* obs() const { return p.obs; }
  __device__ __forceinline__ float* out() const { return p.out; }
  __host__ __device__ int Cb() const { return p.Cb; }
};

// The exact coefficients (fastcore.py::cheb_deficit_coeffs): the deficit
// at the 3 x M_CHEB Chebyshev nodes of the draw's z-segments, node j of
// segment s at z = lo_s + w_s S_j (lo_A = 0), lanes 0..26 two nodes each
// into the warp's scratch row; then lanes 0..26 two coefficients each,
// c[s][m] = sum_j D[s][j] dct_T[j][m], from the block's copy of dct_T:
// the exact instance.
struct ExactStage {
  KudArgs p;   // p.table: dct_T (M_CHEB, M_CHEB)
  ExactConsts ec;
  static constexpr int kScratch = COEF_SLOT;   // the 54 node deficits
  static constexpr int kWindowMinT = V2_EXACT_WINDOW_MIN_T;

  __host__ __device__ int table_floats() const { return EXACT_TABLE; }
  // dct_T, then the S-nodes
  __device__ __forceinline__ void begin(float* smem) const {
    for (int i = threadIdx.x; i < M_CHEB * M_CHEB; i += blockDim.x)
      smem[i] = __ldg(p.table + i);
    if (threadIdx.x < M_CHEB)
      smem[M_CHEB * M_CHEB + threadIdx.x] = ec.s_nodes[threadIdx.x];
    __syncthreads();
  }
  __device__ __forceinline__ SharedCoeffs fill(const float* table,
                                               float* scratch, float* slot,
                                               int c, int lane) const {
    const float kd = __ldg(p.k + c), u1 = __ldg(p.u1 + c),
                u2 = __ldg(p.u2 + c);
    const ZSegs zs = z_segments(kd, ec.slope, ec.floor_);
    // the lane's two nodes (or outputs) 2 lane, 2 lane + 1: segment s,
    // index j0, j0 + 1 within it (M_CHEB is even)
    const int s = 2 * lane / M_CHEB;
    const int j0 = 2 * lane - s * M_CHEB;
    if (lane < OUT_LANES) {
      const float lo = s == 0 ? 0.0f : (s == 1 ? zs.zsplit : zs.zmid);
      const float wd = s == 0 ? zs.wA : (s == 1 ? zs.wB1 : zs.wB2);
      const float* s_nodes = table + M_CHEB * M_CHEB;
      float D[2];
#pragma unroll 1
      for (int i = 0; i < 2; ++i)
        D[i] = occult_deficit(
            kd, __fadd_rn(lo, __fmul_rn(wd, s_nodes[j0 + i])), u1, u2, ec);
      reinterpret_cast<float2*>(scratch)[lane] = make_float2(D[0], D[1]);
    }
    __syncwarp();
    if (lane < OUT_LANES) {
      const float* Ds = scratch + s * M_CHEB;
      float c0 = 0.0f, c1 = 0.0f;
#pragma unroll
      for (int j = 0; j < M_CHEB; ++j) {
        const float2 t =
            *reinterpret_cast<const float2*>(table + j * M_CHEB + j0);
        c0 = fmaf(Ds[j], t.x, c0);
        c1 = fmaf(Ds[j], t.y, c1);
      }
      reinterpret_cast<float2*>(slot)[lane] = make_float2(c0, c1);
    }
    return shared_coeffs(slot, zs);
  }
  __device__ __forceinline__ const float* g() const { return p.g; }
  __device__ __forceinline__ const float* obs() const { return p.obs; }
  __device__ __forceinline__ float* out() const { return p.out; }
  __host__ __device__ int Cb() const { return p.Cb; }
};

// Floats of a v2 warp's region (the stage's scratch, then the slot), and
// the dynamic shared memory of a block: the stage's table and the warps'
// regions.
template <class Stage>
__host__ __device__ constexpr int v2_warp_floats() {
  return Stage::kScratch + COEF_SLOT;
}

template <class Stage>
__host__ __device__ constexpr int v2_smem_bytes(int table_floats,
                                                int warps = V2_WARPS) {
  return 4 * (table_floats + warps * v2_warp_floats<Stage>());
}

// Warps per block of chi2_kernel_v2's instance, windowed or not.
template <bool Win>
__host__ __device__ constexpr int v2_warps() {
  return Win ? V2_WIN_WARPS : V2_WARPS;
}

// The v2 schedule in persistent blocks, each staging its stage's table
// once; warp w of the grid takes draws w, w + (warps in the grid), ...: the
// stage fills the warp's slot, then draw_chi2 runs the point loop on it.
// Win (orbit sources, launches of at least Stage::kWindowMinT points): per
// draw the orbit source's transit window (Src::window), and draw_chi2
// solves only the 32-point groups it holds; win_counts, when not null,
// gets the warp's (draw, group) pairs walked and solved, one atomic each
// at exit. At most 64 registers a thread: two blocks of V2_WARPS warps per
// SM, or one of V2_WIN_WARPS (Win).
template <class Src, int S, class Stage, bool Win>
__global__ void __launch_bounds__(v2_warps<Win>() * 32,
                                  Win ? 1 : V2_MIN_BLOCKS)
chi2_kernel_v2(Src src_all, const __grid_constant__ Stage st, int C,
               int n_t, Nodes nodes, unsigned long long* win_counts) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* scratch =
      smem + st.table_floats() + warp * v2_warp_floats<Stage>();
  float* slot = scratch + Stage::kScratch;
  st.begin(smem);
  float dmax = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) dmax = fmaxf(dmax, fabsf(nodes.off[s]));
  unsigned walked = 0, solved = 0;

  constexpr int kWarps = v2_warps<Win>();
  for (int c = blockIdx.x * kWarps + warp; c < C; c += gridDim.x * kWarps) {
    const int64_t row = (int64_t)(c / st.Cb()) * n_t;   // the draw's target
    const Src src = src_all.target(row);
    const SharedCoeffs k = st.fill(smem, scratch, slot, c, lane);
    __syncwarp();
    const float gc = __ldg(st.g() + c);
    const typename Src::Draw d = src.draw(c);
    Window win{0.0f, WIN_WHOLE};
    if constexpr (Win) {
      win = src.template window<true>(d, c, k.zmax2, dmax, lane);
      walked += (n_t + 31) / 32;
    }
    const float acc = draw_chi2<Win, Src, S>(
        src, d, win, k, gc, st.obs() + row, n_t, nodes, lane, solved);
    if (lane == 0) st.out()[c] = acc;
    __syncwarp();   // every lane is done with the slot
  }
  if constexpr (Win) {
    if (win_counts && lane == 0) {
      atomicAdd(win_counts, (unsigned long long)walked);
      atomicAdd(win_counts + 1, (unsigned long long)solved);
    }
  }
}

// A stage's coefficients alone over C draws into out (C, COEF_OUT): the
// 54 coefficients (A, B1, B2 rows of M_CHEB) and zsplit, zmid, invA,
// invB1, invB2; the same blocks, staging and slots as chi2_kernel_v2.
template <class Stage>
__global__ void __launch_bounds__(V2_THREADS)
coeffs_kernel(const __grid_constant__ Stage st, float* out, int C) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* scratch =
      smem + st.table_floats() + warp * v2_warp_floats<Stage>();
  float* slot = scratch + Stage::kScratch;
  st.begin(smem);

  for (int c = blockIdx.x * V2_WARPS + warp; c < C;
       c += gridDim.x * V2_WARPS) {
    const SharedCoeffs k = st.fill(smem, scratch, slot, c, lane);
    __syncwarp();
    float* o = out + (int64_t)c * COEF_OUT;
    for (int i = lane; i < 3 * M_CHEB; i += 32) o[i] = slot[i];
    if (lane == 0) {
      o[3 * M_CHEB] = k.zsplit;
      o[3 * M_CHEB + 1] = k.zmid;
      o[3 * M_CHEB + 2] = k.invA;
      o[3 * M_CHEB + 3] = k.invB1;
      o[3 * M_CHEB + 4] = k.invB2;
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// The v3 schedule (chi2_kernel_v3): draws on lanes, V3_SPLIT lanes a draw.

// A lane's draw in its warp's coefficient slot (column d of the
// coefficient-major [3 M_CHEB][V3_PITCH] slot; the point's segment picks a
// row block), and its segment scalars in registers.
struct LaneCoeffs {
  const float* col;
  float zsplit, zmid, invA, invB1, invB2, zmax2;

  using Seg = const float*;
  __device__ __forceinline__ Seg segment(bool inB1, bool inB2) const {
    return col + (inB2 ? 2 * M_CHEB : (inB1 ? M_CHEB : 0)) * V3_PITCH;
  }
  __device__ __forceinline__ float coef(Seg sg, int m) const {
    return sg[m * V3_PITCH];
  }
};

// The coefficient stages of chi2_kernel_v3. Each fills a warp's slot with
// the V3_DRAWS draws c0 .. c0 + V3_DRAWS - 1 and returns the LaneCoeffs of
// the lane's draw d (the caller syncs the warp before reading the slot),
// and says where the per-draw g, obs and out live. V3CopyStage copies the
// coefficients a stage before the kernel made ((C, 18) x 3 and seg (C,
// 5)); V3TabStage computes the tabulated ones from (k, u1, u2) with
// tab_coeffs, from the table the block staged in shared memory.
struct V3CopyStage {
  Chi2Args p;
  static constexpr int kScratch = 0;   // floats a warp needs besides its slot

  __device__ __forceinline__ int table_floats() const { return 0; }
  __device__ __forceinline__ void begin(float*) const {}

  // the warp's 3 x V3_DRAWS M_CHEB consecutive coefficients, coalesced,
  // into the slot's columns
  __device__ __forceinline__ LaneCoeffs load(const float*, float*,
                                             float* slot, int c0, int lane,
                                             int d) const {
    const float* src[3] = {p.cA, p.cB1, p.cB2};
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float* a = src[s] + (int64_t)c0 * M_CHEB;
#pragma unroll
      for (int r = 0; r < (V3_DRAWS * M_CHEB + 31) / 32; ++r) {
        const int q = lane + 32 * r;
        const int i = q / M_CHEB, m = q - i * M_CHEB;
        if (q < V3_DRAWS * M_CHEB)
          slot[(s * M_CHEB + m) * V3_PITCH + i] = __ldg(a + q);
      }
    }
    const int c = c0 + d;
    LaneCoeffs k;
    k.col = slot + d;
    k.zsplit = __ldg(p.seg + c * 5 + 0);
    k.zmid = __ldg(p.seg + c * 5 + 1);
    k.invA = __ldg(p.seg + c * 5 + 2);
    k.invB1 = __ldg(p.seg + c * 5 + 3);
    k.invB2 = __ldg(p.seg + c * 5 + 4);
    const float zmax = k.zmid + 1.0f / k.invB2;
    k.zmax2 = zmax * zmax;
    return k;
  }
  __device__ __forceinline__ const float* g() const { return p.g; }
  __device__ __forceinline__ const float* obs() const { return p.obs; }
  __device__ __forceinline__ float* out() const { return p.out; }
  __device__ __forceinline__ int Cb() const { return p.Cb; }
};

struct V3TabStage {
  KudArgs p;
  TabSegs ts;
  static constexpr int kScratch = COEF_SLOT;   // tab_coeffs' output

  __device__ __forceinline__ int table_floats() const {
    return tab_floats(ts.n_rows);
  }
  __device__ __forceinline__ void begin(float* smem) const {
    stage_table(smem, p.table, 4u * tab_floats(ts.n_rows));
  }

  // per draw i of the warp's: tab_coeffs into the scratch, then the 54
  // values into column i; the lanes of draw i keep the segment scalars
  __device__ __forceinline__ LaneCoeffs load(const float* table,
                                             float* scratch, float* slot,
                                             int c0, int lane, int d) const {
    const int c = c0 + d;
    const float kv = __ldg(p.k + c), u1v = __ldg(p.u1 + c),
                u2v = __ldg(p.u2 + c);
    LaneCoeffs mine;
    for (int i = 0; i < V3_DRAWS; ++i) {
      SharedCoeffs k;
      tab_coeffs(table, ts, __shfl_sync(0xffffffffu, kv, i),
                 __shfl_sync(0xffffffffu, u1v, i),
                 __shfl_sync(0xffffffffu, u2v, i), lane, scratch, k);
      __syncwarp();
      for (int o = lane; o < 3 * M_CHEB; o += 32)
        slot[o * V3_PITCH + i] = scratch[o];
      if (d == i) {
        mine.zsplit = k.zsplit;
        mine.zmid = k.zmid;
        mine.invA = k.invA;
        mine.invB1 = k.invB1;
        mine.invB2 = k.invB2;
        mine.zmax2 = k.zmax2;
      }
      __syncwarp();   // the scratch is free for the next draw
    }
    mine.col = slot + d;
    return mine;
  }
  __device__ __forceinline__ const float* g() const { return p.g; }
  __device__ __forceinline__ const float* obs() const { return p.obs; }
  __device__ __forceinline__ float* out() const { return p.out; }
  __device__ __forceinline__ int Cb() const { return p.Cb; }
};

// Floats of a v3 warp's region (the stage's scratch, then the slot), and
// the dynamic shared memory of a block of `warps` warps: the table (tab)
// and the warps' regions.
template <class Stage>
__host__ __device__ constexpr int v3_warp_floats() {
  return Stage::kScratch + V3_SLOT;
}

template <class Stage>
__host__ __device__ constexpr int v3_smem_bytes(int table_floats,
                                                int warps = V3_WARPS) {
  return 4 * (table_floats + warps * v3_warp_floats<Stage>());
}

// The v3 schedule in persistent blocks of up to V3_WARPS warps; warp w of
// the grid takes the V3_DRAWS-draw groups w, w + (warps in the grid), ...;
// lane l draw c0 + l % V3_DRAWS and the time steps t with t % V3_SPLIT ==
// l / V3_DRAWS. Per group: the stage fills the warp's coefficient slot,
// each lane forms its draw's orbit constants and transit window
// (Src::window), then the warp walks the time axis V3_SPLIT points a step,
// TIME_SUB steps a block. A lane's bit j says whether its point of step j
// lies in its draw's window; the warp ORs the bits (__reduce_or_sync), so
// a block outside every lane's window skips the Kepler solve and the
// deficit, and only the steps some lane needs are solved. A solved step
// runs the deficit when any lane is in front with z < zmax at a node
// (__any_sync); a skipped point adds 0. The plane source has no window:
// every step is read. The lanes of a draw add their sums with shuffles:
// no atomic, and a draw's result does not depend on the launch it is in.
template <class Src, int S, class Stage>
__global__ void __launch_bounds__(V3_THREADS, 1)
chi2_kernel_v3(Src src_all, const __grid_constant__ Stage st, int C,
               int n_t, Nodes nodes) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d = lane % V3_DRAWS;     // the lane's draw in the group
  const int sub = lane / V3_DRAWS;   // its time steps' offset
  float* scratch =
      smem + st.table_floats() + warp * v3_warp_floats<Stage>();
  float* slot = scratch + Stage::kScratch;
  st.begin(smem);
  float dmax = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) dmax = fmaxf(dmax, fabsf(nodes.off[s]));
  const int n_steps = (n_t + V3_SPLIT - 1) / V3_SPLIT;

  for (int c0 = (blockIdx.x * (blockDim.x >> 5) + warp) * V3_DRAWS; c0 < C;
       c0 += gridDim.x * (blockDim.x >> 5) * V3_DRAWS) {
    const int c = c0 + d;
    const int64_t row = (int64_t)(c0 / st.Cb()) * n_t;   // the target
    const Src src = src_all.target(row);
    const float* obs = st.obs() + row;
    const LaneCoeffs k = st.load(smem, scratch, slot, c0, lane, d);
    __syncwarp();

    const float gc = __ldg(st.g() + c);
    const typename Src::Draw dr = src.draw(c);
    Window win{0.0f, WIN_WHOLE};
    if constexpr (Src::kWindow) win = src.window(dr, c, k.zmax2, dmax);

    // sum_t gD (2 obs + gD), compensated (acc - comp is the sum): a lane
    // adds its draw's in-transit terms in sequence, and where the model
    // fits a deep transit they cancel most of sum_t obs^2, which would
    // leave a plain float sum's rounding at ~1e-2 nats of lnL over ~1e3
    // in-transit points
    float acc = 0.0f, comp = 0.0f;
    for (int s0 = 0; s0 < n_steps; s0 += TIME_SUB) {
      const int steps = min(TIME_SUB, n_steps - s0);
      unsigned bits = (1u << steps) - 1u;
      if constexpr (Src::kWindow) {
        unsigned mine = 0u;
#pragma unroll
        for (int j = 0; j < TIME_SUB; ++j) {
          const int t = (s0 + j) * V3_SPLIT + sub;
          if (j < steps && t < n_t && win.contains(dr.n, src.time_at(t)))
            mine |= 1u << j;
        }
        bits = __reduce_or_sync(0xffffffffu, mine);
      }
      while (bits) {
        const int t = (s0 + __ffs(bits) - 1) * V3_SPLIT + sub;
        bits &= bits - 1u;
        const bool inb = t < n_t;
        const int ti = inb ? t : n_t - 1;   // past the end: solved, dropped
        float a0, a1, a2, fr;
        src.point(dr, ti, a0, a1, a2, fr);
        float z2[S];
        const bool active = exposure_z2<S>(a0, a1, a2, nodes, k.zmax2, z2) &&
                            fr > 0.0f && inb;
        if (!__any_sync(0xffffffffu, active)) continue;
        if (!inb) continue;
        const float ob = __ldg(obs + ti);
        const float gD = gc * (point_deficit<S>(z2, k, nodes) * fr);
        const float y = __fsub_rn(gD * (2.0f * ob + gD), comp);
        const float sum = __fadd_rn(acc, y);
        comp = __fsub_rn(__fsub_rn(sum, acc), y);
        acc = sum;
      }
    }

    // the draw's lanes' sums, then sum_t obs^2 (the same for every draw of
    // the target), in double: lane-strided, then a butterfly
    double chi2 = (double)acc - (double)comp;
#pragma unroll
    for (int o = V3_DRAWS; o < 32; o <<= 1)
      chi2 += __shfl_xor_sync(0xffffffffu, chi2, o);
    double obs2 = 0.0;
    for (int t = lane; t < n_t; t += 32)
      obs2 += (double)obs[t] * (double)obs[t];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      obs2 += __shfl_xor_sync(0xffffffffu, obs2, o);
    if (sub == 0) st.out()[c] = (float)(chi2 + obs2);
    __syncwarp();   // every lane is done with the slot
  }
}

Nodes make_nodes(const float* offs, const float* wgts, int n_nodes) {
  Nodes nodes = {};
  for (int s = 0; s < n_nodes; ++s) {
    nodes.off[s] = offs[s];
    nodes.off2[s] = offs[s] * offs[s];
    nodes.wgt[s] = wgts[s];
  }
  return nodes;
}

// f(std::integral_constant<int, S>{}) with S = n_nodes (1..4; the
// projected orbit source has one node only); cudaErrorInvalidValue for
// another count.
template <class Src, class F>
int with_nodes(int n_nodes, F&& f) {
  if (n_nodes < 1 || n_nodes > MAX_NODES || (Src::kOneNode && n_nodes != 1))
    return (int)cudaErrorInvalidValue;
  if constexpr (Src::kOneNode) {
    return f(std::integral_constant<int, 1>{});
  } else {
    switch (n_nodes) {
      case 1: return f(std::integral_constant<int, 1>{});
      case 2: return f(std::integral_constant<int, 2>{});
      case 3: return f(std::integral_constant<int, 3>{});
      default: return f(std::integral_constant<int, 4>{});
    }
  }
}

// What one kernel instance gets at its block shape and dynamic shared
// memory, read once per device, instance, block and size: the instance is
// first opted into that much dynamic shared memory (above the 48 KB
// default), then the occupancy calculator gives its resident blocks per
// SM. Returns a CUDA error code, 0 on success.
struct Setup {
  const void* fn = nullptr;
  int dev = -1, threads = 0, smem = 0, blocks = 0, sms = 0;
};
constexpr int MAX_SETUPS = 128;

int kernel_setup(const void* fn, int threads, int smem, const Setup** out) {
  static Setup setups[MAX_SETUPS];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int i = 0;
  for (; i < MAX_SETUPS && setups[i].fn; ++i) {
    if (setups[i].fn == fn && setups[i].dev == dev &&
        setups[i].threads == threads && setups[i].smem == smem) {
      *out = &setups[i];
      return 0;
    }
  }
  if (i == MAX_SETUPS) return (int)cudaErrorInvalidValue;
  Setup su;
  su.fn = fn;
  su.dev = dev;
  su.threads = threads;
  su.smem = smem;
  err = cudaDeviceGetAttribute(&su.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&su.blocks, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (su.blocks < 1) return (int)cudaErrorInvalidConfiguration;
  setups[i] = su;
  *out = &setups[i];
  return 0;
}

// Registers, local memory (spills), resident blocks per SM, threads and
// dynamic shared memory of a block, and the SMs, of instance fn at its
// launch shape, into out[0..5]. Returns a CUDA error code, 0 on success.
int kernel_info(const void* fn, int threads, int smem, int* out) {
  const Setup* su = nullptr;
  const int err = kernel_setup(fn, threads, smem, &su);
  if (err) return err;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = su->blocks;
  out[3] = threads;
  out[4] = smem;
  out[5] = su->sms;
  return 0;
}

bool tab_segs_ok(const TabSegs& ts) {
  if (ts.n_rows < 1 || (4 * tab_floats(ts.n_rows)) % 16) return false;
  for (int g = 0; g < TAB_SEGS; ++g) {
    if (ts.kind[g] < 0 || ts.kind[g] > 3 || ts.deg[g] < 1 ||
        ts.row0[g] < 0 || ts.row0[g] + ts.deg[g] > ts.n_rows)
      return false;
  }
  return true;
}

// Blocks of a persistent v2 launch over C draws in blocks of `warps`
// warps: as many as fit on the device at once, no more than the draws'
// warps.
int v2_grid(const Setup& su, int C, int warps = V2_WARPS) {
  return std::min(su.sms * su.blocks, (C + warps - 1) / warps);
}

// Whether a v2 launch of Src and Stage over n_t exposures takes the
// windowed instance.
template <class Src, class Stage>
bool v2_windowed(int n_t) {
  return Src::kWindow && n_t >= Stage::kWindowMinT;
}

template <class Src, int S, class Stage, bool Win>
int launch_v2_nodes(const Src& src, const Stage& st, int C, int n_t,
                    const Nodes& nodes, unsigned long long* win_counts,
                    cudaStream_t stream) {
  constexpr int kWarps = v2_warps<Win>();
  const int smem = v2_smem_bytes<Stage>(st.table_floats(), kWarps);
  const void* fn = (const void*)chi2_kernel_v2<Src, S, Stage, Win>;
  const Setup* su = nullptr;
  const int err = kernel_setup(fn, 32 * kWarps, smem, &su);
  if (err) return err;
  chi2_kernel_v2<Src, S, Stage, Win>
      <<<v2_grid(*su, C, kWarps), 32 * kWarps, smem, stream>>>(
          src, st, C, n_t, nodes, win_counts);
  return (int)cudaGetLastError();
}

// Launch chi2_kernel_v2 over Src and Stage with S = n_nodes (1..4; the
// projected orbit source has one node only), windowed where v2_windowed
// says so (win_counts: its counters, or null). Returns a CUDA error code,
// 0 on success.
template <class Src, class Stage>
int launch_v2(const Src& src, const Stage& st, int C, int n_t,
              const float* offs, const float* wgts, int n_nodes,
              unsigned long long* win_counts, void* stream) {
  const int Cb = st.Cb();
  if (C <= 0 || Cb <= 0 || C % Cb) return (int)cudaErrorInvalidValue;
  const Nodes nodes = make_nodes(offs, wgts, n_nodes);
  const bool win = v2_windowed<Src, Stage>(n_t);
  return with_nodes<Src>(n_nodes, [&](auto s) {
    constexpr int S = decltype(s)::value;
    if constexpr (Src::kWindow) {
      if (win)
        return launch_v2_nodes<Src, S, Stage, true>(
            src, st, C, n_t, nodes, win_counts, (cudaStream_t)stream);
    }
    return launch_v2_nodes<Src, S, Stage, false>(
        src, st, C, n_t, nodes, nullptr, (cudaStream_t)stream);
  });
}

// Launch coeffs_kernel over Stage. Returns a CUDA error code, 0 on
// success.
template <class Stage>
int launch_coeffs(const Stage& st, float* out, int C, void* stream) {
  if (C <= 0) return (int)cudaErrorInvalidValue;
  const int smem = v2_smem_bytes<Stage>(st.table_floats());
  const Setup* su = nullptr;
  const int err =
      kernel_setup((const void*)coeffs_kernel<Stage>, V2_THREADS, smem, &su);
  if (err) return err;
  coeffs_kernel<Stage><<<v2_grid(*su, C), V2_THREADS, smem,
                         (cudaStream_t)stream>>>(st, out, C);
  return (int)cudaGetLastError();
}

template <class Src, int S, class Stage>
int launch_v3_nodes(const Src& src, const Stage& st, int table_floats, int C,
                    int n_t, const Nodes& nodes, cudaStream_t stream) {
  const Setup* su = nullptr;
  const int err = kernel_setup((const void*)chi2_kernel_v3<Src, S, Stage>,
                               V3_THREADS, v3_smem_bytes<Stage>(table_floats),
                               &su);
  if (err) return err;
  // persistent: as many full blocks as fit at once, no more than the draws
  // need; fewer draw groups than would fill every SM's block go to smaller
  // blocks spread over the SMs
  const int groups = C / V3_DRAWS;
  const int warps =
      std::max(1, std::min(V3_WARPS, (groups + su->sms - 1) / su->sms));
  const int grid =
      std::min(su->sms * su->blocks, (groups + warps - 1) / warps);
  chi2_kernel_v3<Src, S, Stage>
      <<<grid, warps * 32, v3_smem_bytes<Stage>(table_floats, warps),
         stream>>>(src, st, C, n_t, nodes);
  return (int)cudaGetLastError();
}

// Launch chi2_kernel_v3 over Src and Stage with S = n_nodes (1..4; the
// projected orbit source has one node only); table_floats is the stage's
// table in shared memory (0 for V3CopyStage). Returns a CUDA error code, 0
// on success.
template <class Src, class Stage>
int launch_v3(const Src& src, const Stage& st, int table_floats, int C,
              int n_t, const float* offs, const float* wgts, int n_nodes,
              void* stream) {
  const int Cb = st.p.Cb;
  if (C <= 0 || C % V3_DRAW_LANES || Cb <= 0 || C % Cb || Cb % 32)
    return (int)cudaErrorInvalidValue;
  const Nodes nodes = make_nodes(offs, wgts, n_nodes);
  return with_nodes<Src>(n_nodes, [&](auto s) {
    return launch_v3_nodes<Src, decltype(s)::value>(
        src, st, table_floats, C, n_t, nodes, (cudaStream_t)stream);
  });
}

// Launch chi2_kernel_v2 (V3 false) or chi2_kernel_v3 (true) with Stage over
// the orbit of the draws; projected != 0 selects projected_z.
template <bool V3, class Stage>
int launch_orbit(const float* time, const float* P, const float* aR,
                 const float* inc, const float* e, const float* w,
                 const Stage& st, int table_floats, int C, int n_t,
                 const float* offs, const float* wgts, int n_nodes,
                 int projected, unsigned long long* win_counts,
                 void* stream) {
  if constexpr (V3) {
    if (projected)
      return launch_v3(OrbitSource<true>{time, P, aR, inc, e, w}, st,
                       table_floats, C, n_t, offs, wgts, n_nodes, stream);
    return launch_v3(OrbitSource<false>{time, P, aR, inc, e, w}, st,
                     table_floats, C, n_t, offs, wgts, n_nodes, stream);
  } else {
    if (projected)
      return launch_v2(OrbitSource<true>{time, P, aR, inc, e, w}, st, C, n_t,
                       offs, wgts, n_nodes, win_counts, stream);
    return launch_v2(OrbitSource<false>{time, P, aR, inc, e, w}, st, C, n_t,
                     offs, wgts, n_nodes, win_counts, stream);
  }
}

// The v2 (V3 false; windowed or not) or v3 orbit instance of Stage for
// projected and n_nodes (nullptr for a count the source does not take).
template <bool V3, class Stage>
const void* orbit_kernel(bool projected, int n_nodes, bool windowed = false) {
  const void* fn = nullptr;
  auto pick = [&](auto src) {
    using Src = decltype(src);
    return with_nodes<Src>(n_nodes, [&](auto s) {
      constexpr int S = decltype(s)::value;
      if constexpr (V3)
        fn = (const void*)chi2_kernel_v3<Src, S, Stage>;
      else if (windowed)
        fn = (const void*)chi2_kernel_v2<Src, S, Stage, true>;
      else
        fn = (const void*)chi2_kernel_v2<Src, S, Stage, false>;
      return 0;
    });
  };
  if (projected)
    pick(OrbitSource<true>{});
  else
    pick(OrbitSource<false>{});
  return fn;
}

// v2 stage codes of the info entry point
constexpr int STAGE_COPY = 0;
constexpr int STAGE_TAB = 1;
constexpr int STAGE_EXACT = 2;

// kernel_info of chi2_kernel_v2's orbit instance with Stage (its table
// table_floats floats) that a launch of n_t exposures runs.
template <class Stage>
int v2_info(int n_nodes, int projected, int table_floats, int n_t,
            int* out) {
  const bool win = v2_windowed<OrbitSource<false>, Stage>(n_t);
  const int warps = win ? V2_WIN_WARPS : V2_WARPS;
  const void* fn = orbit_kernel<false, Stage>(projected != 0, n_nodes, win);
  if (!fn) return (int)cudaErrorInvalidValue;
  return kernel_info(fn, 32 * warps,
                     v2_smem_bytes<Stage>(table_floats, warps), out);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Pointers are device pointers
// except offs/wgts, which are host arrays of n_nodes floats, and segs /
// consts, host structs. Each returns cudaGetLastError() after the launch.

// v2 on planes: q0, q1, q2, front are draw-major (C, n_t).
extern "C" int chi2_supersampled_launch(
    const float* q0, const float* q1, const float* q2, const float* front,
    const float* cA, const float* cB1, const float* cB2, const float* seg,
    const float* g, const float* obs, float* out, int C, int n_t,
    const float* offs, const float* wgts, int n_nodes, void* stream) {
  return launch_v2(PlaneSource<false>{q0, q1, q2, front, n_t},
                   CopyStage{Chi2Args{cA, cB1, cB2, seg, g, obs, out, C}}, C,
                   n_t, offs, wgts, n_nodes, nullptr, stream);
}

// v3 on planes: q0t, q1t, q2t, frontt are time-major (n_t, C); C % 128 == 0.
extern "C" int chi2_supersampled_v3_launch(
    const float* q0t, const float* q1t, const float* q2t,
    const float* frontt, const float* cA, const float* cB1, const float* cB2,
    const float* seg, const float* g, const float* obs, float* out, int C,
    int n_t, const float* offs, const float* wgts, int n_nodes,
    void* stream) {
  return launch_v3(PlaneSource<true>{q0t, q1t, q2t, frontt, C},
                   V3CopyStage{Chi2Args{cA, cB1, cB2, seg, g, obs, out, C}},
                   0, C, n_t, offs, wgts, n_nodes, stream);
}

// v2 on the orbit for B = C / Cb targets: time and obs (B, n_t); P, aR,
// inc, e, w (C,), target-major. projected != 0 selects projected_z and
// needs n_nodes == 1. At n_t >= V2_WINDOW_MIN_T the windowed instance
// runs and adds its (draw, group) pairs walked and solved to win_counts[0]
// and [1] (a device array; null: not counted); below it win_counts is not
// read.
extern "C" int chi2_from_orbit_launch(
    const float* time, const float* P, const float* aR, const float* inc,
    const float* e, const float* w, const float* cA, const float* cB1,
    const float* cB2, const float* seg, const float* g, const float* obs,
    float* out, int C, int n_t, const float* offs, const float* wgts,
    int n_nodes, int projected, int Cb, unsigned long long* win_counts,
    void* stream) {
  return launch_orbit<false>(time, P, aR, inc, e, w,
                             CopyStage{Chi2Args{cA, cB1, cB2, seg, g, obs,
                                                out, Cb}},
                             0, C, n_t, offs, wgts, n_nodes, projected,
                             win_counts, stream);
}

// v3 on the orbit: the same arguments; C % 128 == 0, Cb % 32 == 0.
extern "C" int chi2_from_orbit_v3_launch(
    const float* time, const float* P, const float* aR, const float* inc,
    const float* e, const float* w, const float* cA, const float* cB1,
    const float* cB2, const float* seg, const float* g, const float* obs,
    float* out, int C, int n_t, const float* offs, const float* wgts,
    int n_nodes, int projected, int Cb, void* stream) {
  return launch_orbit<true>(
      time, P, aR, inc, e, w,
      V3CopyStage{Chi2Args{cA, cB1, cB2, seg, g, obs, out, Cb}}, 0, C, n_t,
      offs, wgts, n_nodes, projected, nullptr, stream);
}

// v2 with the tabulated coefficients computed in the kernel (TabStage),
// for B = C / Cb targets: time and obs (B, n_t); P, aR, inc, e, w, k, u1,
// u2, g (C,), target-major; tab the (n_rows, 162) coefficient table,
// 16-byte aligned; segs a host TabSegs. projected != 0 selects projected_z
// and needs n_nodes == 1; win_counts as chi2_from_orbit_launch.
extern "C" int chi2_from_orbit_tab_launch(
    const float* time, const float* P, const float* aR, const float* inc,
    const float* e, const float* w, const float* k, const float* u1,
    const float* u2, const float* g, const float* obs, const float* tab,
    float* out, int C, int n_t, const float* offs, const float* wgts,
    int n_nodes, int projected, int Cb, const void* segs,
    unsigned long long* win_counts, void* stream) {
  const TabSegs& ts = *static_cast<const TabSegs*>(segs);
  if (!tab_segs_ok(ts)) return (int)cudaErrorInvalidValue;
  return launch_orbit<false>(
      time, P, aR, inc, e, w,
      TabStage{KudArgs{k, u1, u2, g, obs, tab, out, Cb}, ts}, 0, C, n_t,
      offs, wgts, n_nodes, projected, win_counts, stream);
}

// v2 with the exact coefficients computed in the kernel (ExactStage): the
// arguments of chi2_from_orbit_tab_launch with dct the (18, 18) dct_T of
// the exact coefficients in place of the table and consts a host
// ExactConsts in place of segs; windowed from V2_EXACT_WINDOW_MIN_T.
extern "C" int chi2_from_orbit_exact_launch(
    const float* time, const float* P, const float* aR, const float* inc,
    const float* e, const float* w, const float* k, const float* u1,
    const float* u2, const float* g, const float* obs, const float* dct,
    float* out, int C, int n_t, const float* offs, const float* wgts,
    int n_nodes, int projected, int Cb, const void* consts,
    unsigned long long* win_counts, void* stream) {
  const ExactConsts& ec = *static_cast<const ExactConsts*>(consts);
  return launch_orbit<false>(
      time, P, aR, inc, e, w,
      ExactStage{KudArgs{k, u1, u2, g, obs, dct, out, Cb}, ec}, 0, C, n_t,
      offs, wgts, n_nodes, projected, win_counts, stream);
}

// v3 with the tabulated coefficients computed in the kernel (V3TabStage):
// the arguments of chi2_from_orbit_tab_launch; C % 128 == 0, Cb % 32 == 0.
extern "C" int chi2_from_orbit_v3_tab_launch(
    const float* time, const float* P, const float* aR, const float* inc,
    const float* e, const float* w, const float* k, const float* u1,
    const float* u2, const float* g, const float* obs, const float* tab,
    float* out, int C, int n_t, const float* offs, const float* wgts,
    int n_nodes, int projected, int Cb, const void* segs, void* stream) {
  const TabSegs& ts = *static_cast<const TabSegs*>(segs);
  if (!tab_segs_ok(ts)) return (int)cudaErrorInvalidValue;
  return launch_orbit<true>(
      time, P, aR, inc, e, w,
      V3TabStage{KudArgs{k, u1, u2, g, obs, tab, out, Cb}, ts},
      tab_floats(ts.n_rows), C, n_t, offs, wgts, n_nodes, projected, nullptr,
      stream);
}

// TabStage's coefficients alone (coeffs_kernel): out (C, 59) from k, u1,
// u2 (C,), the table and segs as chi2_from_orbit_tab_launch. For checking
// the in-kernel coefficients; the chi^2 path never calls it.
extern "C" int deficit_coeffs_tab_launch(const float* k, const float* u1,
                                         const float* u2, const float* tab,
                                         float* out, int C, const void* segs,
                                         void* stream) {
  const TabSegs& ts = *static_cast<const TabSegs*>(segs);
  if (!tab_segs_ok(ts)) return (int)cudaErrorInvalidValue;
  return launch_coeffs(
      TabStage{KudArgs{k, u1, u2, nullptr, nullptr, tab, nullptr, C}, ts},
      out, C, stream);
}

// ExactStage's coefficients alone: out (C, 59) from k, u1, u2 (C,), dct
// and consts as chi2_from_orbit_exact_launch.
extern "C" int deficit_coeffs_exact_launch(const float* k, const float* u1,
                                           const float* u2, const float* dct,
                                           float* out, int C,
                                           const void* consts,
                                           void* stream) {
  const ExactConsts& ec = *static_cast<const ExactConsts*>(consts);
  return launch_coeffs(
      ExactStage{KudArgs{k, u1, u2, nullptr, nullptr, dct, nullptr, C}, ec},
      out, C, stream);
}

// What the compiler and the occupancy calculator give chi2_kernel_v2's
// orbit instance for n_nodes and projected with stage (0 CopyStage, 1
// TabStage at a table of n_rows rows, 2 ExactStage), the instance a launch
// of n_t exposures runs (windowed from the stage's kWindowMinT on): out[0]
// registers a thread, out[1] local memory bytes a thread (spills), out[2]
// resident blocks per SM, out[3] threads a block, out[4] dynamic shared
// memory bytes a block, out[5] the device's SMs.
extern "C" int chi2_from_orbit_v2_info(int stage, int n_nodes, int projected,
                                       int n_rows, int n_t, int* out) {
  if (stage == STAGE_COPY)
    return v2_info<CopyStage>(n_nodes, projected, 0, n_t, out);
  if (stage == STAGE_TAB && n_rows >= 1)
    return v2_info<TabStage>(n_nodes, projected, tab_floats(n_rows), n_t,
                             out);
  if (stage == STAGE_EXACT)
    return v2_info<ExactStage>(n_nodes, projected, EXACT_TABLE, n_t, out);
  return (int)cudaErrorInvalidValue;
}

// What the compiler and the occupancy calculator give chi2_kernel_v3's
// orbit instance for n_nodes and projected, with the tab stage (tab != 0,
// a table of n_rows rows) or the copy one: out as chi2_from_orbit_v2_info.
extern "C" int chi2_from_orbit_v3_info(int n_nodes, int projected, int tab,
                                       int n_rows, int* out) {
  if (tab && n_rows < 1) return (int)cudaErrorInvalidValue;
  const void* fn =
      tab ? orbit_kernel<true, V3TabStage>(projected != 0, n_nodes)
          : orbit_kernel<true, V3CopyStage>(projected != 0, n_nodes);
  if (!fn) return (int)cudaErrorInvalidValue;
  const int smem = tab ? v3_smem_bytes<V3TabStage>(tab_floats(n_rows))
                       : v3_smem_bytes<V3CopyStage>(0);
  return kernel_info(fn, V3_THREADS, smem, out);
}
