// Fused exposure z^2 -> supersample -> Chebyshev deficit -> chi^2 for one
// draw chunk: two schedules, each built over two z^2 sources chosen at
// compile time, and in each schedule an orbit instance that also computes
// the draws' deficit coefficients itself.
//
// Replaces the JAX package's Pallas TPU kernels
//   * ops/pallas_core.py::chi2_supersampled (body _chi2_kernel, helper
//     _clenshaw_tile; the v2 schedule): chi2_kernel and chi2_kernel_tab
//     below;
//   * ops/pallas_core.py::chi2_supersampled_v3 (body _chi2_kernel_v3; the
//     time-major v3 schedule): chi2_kernel_v3 below, with ExactStage or
//     TabStage;
// and, with the orbit source, the XLA producer that fed them on the TPU
// (ops/lightcurve.py::_chi2_pallas: exposure_z2_poly, or projected_z at
// one node); chi2_kernel_tab and chi2_kernel_v3 with TabStage also replace
// the rest of that producer, the tabulated coefficient stage
// (ops/fastcore.py::cheb_deficit_coeffs_tab: one matmul per chunk on the
// TPU's matrix unit). All compute the same function:
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
//
// What bounds it on an H100: with planes, 16 bytes per (draw, time) point
// against ~16 flops to find a point out of transit, so bytes bound it (the
// planes are 26 of the 30 MB a 16384 x 100 launch reads). The orbit source
// reads 4 bytes per time point and 260 bytes per draw, and spends ~165
// FP32 operations per point on the Kepler solve and the z^2 model (among
// them an IEEE sin/cos pair, a cube root, a square root and fourteen
// divisions, each several instructions), plus ~300 per point in transit
// for the deficit at GL-4: operations bound it. chi2_kernel_tab reads 40
// bytes per draw instead of 260 and adds ~2 deg 162 + 324 operations per
// draw (deg <= 24, its k-segment's degree) for the coefficients: still
// operations. On a folded curve most exposures of a long curve cannot be
// in transit for a given draw; chi2_kernel_v3 finds them from ~160
// operations per draw and ~8 per point, before any solve.
//
// What the design does about it:
//   * point_deficit, the per-point work (sqrt map, recurrence with its
//     segment select, clip, node weights), is one inlined device function
//     that every kernel calls, templated on where the draw's 3 x 18
//     coefficients live: in registers (DrawCoeffs: every lane holds all
//     54, loaded from the (C, 18) arrays) or in the warp's shared-memory
//     slot (SharedCoeffs: one copy per warp, the point's segment picks a
//     row); the five segment scalars stay in registers; the recurrence is
//     unrolled;
//   * the orbit source keeps the (C, n_t) planes out of device memory
//     altogether: its per-draw constants (clamped e, n, the mean anomaly at
//     transit, sin/cos w, sin^2/cos^2 inc, sqrt(1 - e^2)) are computed once
//     per warp (v2) or thread (v3), every point runs its own Kepler solve;
//   * v2 (chi2_kernel): one warp per draw, lanes striding over time, so
//     plane loads are coalesced and the orbit source keeps all lanes busy
//     on the solve; a 32-point group in which no lane is in front with
//     z < zmax at any node skips the square roots and the recurrence
//     (__any_sync); the per-draw sum is a __shfl_xor_sync butterfly;
//   * chi2_kernel_tab: the v2 schedule in persistent blocks (as many as
//     fit on the card, from the occupancy calculator) whose warps walk the
//     draws. Each block copies the (152, 162) coefficient table (98,496
//     bytes) into shared memory once, with one TMA bulk copy completed on
//     an mbarrier. Per draw the warp computes fastcore.py's tabulated
//     coefficients itself (tab_coeffs: the k-segment's kappa, the
//     Chebyshev recurrence in kappa, 27 lanes x 2 outputs of the three
//     basis sums over the segment's table rows, the limb-darkening
//     weights) into its own slot, then runs the v2 point loop on it. The
//     (C, 152) and (C, 162) products of the torch stage and the (C, 59)
//     coefficients never reach device memory, and freeing the 54
//     coefficient registers lets 16-warp blocks run two to an SM (the
//     table allows two copies per SM);
//   * v3 (chi2_kernel_v3): draws on lanes, as on the TPU (one draw per
//     lane there): a warp takes V3_DRAWS = 8 consecutive draws, four lanes
//     each, and walks the time axis four points a step, so the lanes of a
//     step read neighbouring plane entries (time-major) or time values.
//     Persistent blocks of 32 warps, one per SM (the most that 64
//     registers a thread and the tab instance's table plus 32 slots in
//     shared memory allow); a warp's draws keep their coefficients in its
//     shared-memory slot, coefficient-major with an odd pitch (the exact
//     stage copies them from the (C, 18) arrays, the tab stage computes
//     them with tab_coeffs from the table the block staged, one TMA bulk
//     copy as chi2_kernel_tab). Per draw, before any solve, the orbit
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
// b = c / Cb of time (B, n_t) and obs (B, n_t). In chi2_kernel Cb is a
// multiple of the block's draws, so a block never mixes targets: b is
// computed from the block index, a value uniform over the block that the
// compiler keeps in uniform registers, and the warp votes stay per
// target. In chi2_kernel_tab a warp serves one draw at a time and in
// chi2_kernel_v3 V3_DRAWS draws of one target (Cb % 32 == 0), so b is
// uniform over the warp, and a draw's result does not depend on the launch
// it is in. The plane entry points are one target (Cb = C).
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
// torch rounds fastcore.py's Python floats to. In chi2_kernel_v3 a lane
// sums a quarter of a whole curve, so its sum of gD (2 obs + gD) is
// compensated (Kahan, with the same intrinsics) and sum obs^2 is taken in
// double.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int M_CHEB = 18;
constexpr int MAX_NODES = 4;
constexpr int WARPS_PER_BLOCK = 8;
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
// chi2_kernel_tab: warps per block and blocks per SM the registers must
// allow (2 x 16 warps: at most 64 registers a thread), floats per warp
// slot, the coefficient table's segments and columns (3 z-segments x
// M_CHEB x 3 basis functions), and the lanes that form the 54 outputs,
// two each
constexpr int TAB_WARPS = 16;
constexpr int TAB_MIN_BLOCKS = 2;
constexpr int TAB_THREADS = TAB_WARPS * 32;
constexpr int TAB_SLOT = 64;
constexpr int TAB_SEGS = 8;
constexpr int TAB_COLS = 3 * M_CHEB * 3;
constexpr int TAB_OUT_LANES = 3 * M_CHEB / 2;
constexpr int TAB_OUT = 3 * M_CHEB + 5;   // deficit_coeffs_tab_launch's row

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

// The per-draw inputs every kernel reads besides its z^2 source.
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

// One draw's deficit coefficients and segment scalars, in registers.
// segment() names the coefficient row of a point's z-segment and coef()
// reads one coefficient of it (the accessor point_deficit is written
// against).
struct DrawCoeffs {
  float a[M_CHEB], b1[M_CHEB], b2[M_CHEB];
  float zsplit, zmid, invA, invB1, invB2, zmax2;

  struct Seg {
    bool inB1, inB2;
  };
  __device__ __forceinline__ Seg segment(bool inB1, bool inB2) const {
    return {inB1, inB2};
  }
  __device__ __forceinline__ float coef(const Seg& sg, int m) const {
    return sg.inB2 ? b2[m] : (sg.inB1 ? b1[m] : a[m]);
  }
};

// One draw's coefficients in its warp's shared-memory slot, A at 0, B1 at
// M_CHEB, B2 at 2 M_CHEB (the same m of the three rows in three banks),
// and the segment scalars in registers.
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

__device__ __forceinline__ void load_coeffs(DrawCoeffs& k, const Chi2Args& p,
                                            int c) {
#pragma unroll
  for (int m = 0; m < M_CHEB; ++m) {
    k.a[m] = __ldg(p.cA + (int64_t)c * M_CHEB + m);
    k.b1[m] = __ldg(p.cB1 + (int64_t)c * M_CHEB + m);
    k.b2[m] = __ldg(p.cB2 + (int64_t)c * M_CHEB + m);
  }
  k.zsplit = __ldg(p.seg + c * 5 + 0);
  k.zmid = __ldg(p.seg + c * 5 + 1);
  k.invA = __ldg(p.seg + c * 5 + 2);
  k.invB1 = __ldg(p.seg + c * 5 + 3);
  k.invB2 = __ldg(p.seg + c * 5 + 4);
  const float zmax = k.zmid + 1.0f / k.invB2;
  k.zmax2 = zmax * zmax;
}

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
// (the E arc taken in [0, 2pi)).
__device__ __forceinline__ float mean_arc(float E1, float E2, float e) {
  const float dE = E2 - E1;
  return dE - TWO_PI_F * floorf(dE * INV_TWO_PI_F) - e * (sinf(E2) - sinf(E1));
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
// keeps z >= zeff it is empty.
__device__ __forceinline__ Window transit_window(float e, float aR, float n,
                                                 float S, float C, float w,
                                                 float zmax2, float dmax) {
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
  const float Ec = ecc_anomaly(fc, sm, sp);
  const float a = mean_arc(ecc_anomaly(fc - th, sm, sp), Ec, e);
  const float b = mean_arc(Ec, ecc_anomaly(fc + th, sm, sp), e);
  const float fs = THREE_HALF_PI_F - w;
  const float gap =
      fminf(mean_arc(ecc_anomaly(PI_F - w, sm, sp),
                     ecc_anomaly(fs - th, sm, sp), e),
            mean_arc(ecc_anomaly(fs + th, sm, sp), ecc_anomaly(-w, sm, sp),
                     e));
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
  // dmax of the exposure centre
  __device__ __forceinline__ Window window(const Draw& d, int c, float zmax2,
                                           float dmax) const {
    return transit_window(d.e, d.aR, d.n, d.S, d.C, __ldg(w + c), zmax2,
                          dmax);
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
// select, 18-step Clenshaw, clip to [0, 1]. Coeffs is DrawCoeffs or
// SharedCoeffs.
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
// and a butterfly leaves the draw's sum in every lane.
template <class Src, int S, class Coeffs>
__device__ __forceinline__ float draw_chi2(const Src& src,
                                           const typename Src::Draw& d,
                                           const Coeffs& k, float gc,
                                           const float* obs, int n_t,
                                           const Nodes& nodes, int lane) {
  float acc = 0.0f;
  for (int t0 = 0; t0 < n_t; t0 += 32) {
    const int t = t0 + lane;
    const bool inb = t < n_t;
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

template <class Src, int S>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
chi2_kernel(Src src_all, Chi2Args p, int C, int n_t, Nodes nodes) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (c >= C) return;  // whole warp leaves together

  // the block's target (Cb % WARPS_PER_BLOCK == 0)
  const int64_t row =
      (int64_t)((blockIdx.x * WARPS_PER_BLOCK) / p.Cb) * n_t;
  const Src src = src_all.target(row);
  DrawCoeffs k;
  load_coeffs(k, p, c);
  const float gc = __ldg(p.g + c);
  const typename Src::Draw d = src.draw(c);
  const float acc =
      draw_chi2<Src, S>(src, d, k, gc, p.obs + row, n_t, nodes, lane);
  if (lane == 0) p.out[c] = acc;
}

// ---------------------------------------------------------------------------
// The tabulated coefficient stage inside the kernel (chi2_kernel_tab).

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

// The per-draw inputs of chi2_kernel_tab besides its orbit.
struct TabArgs {
  const float* k;
  const float* u1;
  const float* u2;
  const float* g;
  const float* obs;   // (B, n_t), row c / Cb for draw c
  const float* tab;   // (n_rows, TAB_COLS) in device memory
  float* out;
  int Cb;             // draws per target
};

__host__ __device__ constexpr int tab_floats(int n_rows) {
  return n_rows * TAB_COLS;
}

__host__ __device__ constexpr int tab_smem_bytes(int n_rows) {
  return 4 * (tab_floats(n_rows) + TAB_WARPS * TAB_SLOT);
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

  if (lane < TAB_OUT_LANES) {
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
  const float zsplit = fabsf(1.0f - kd);
  const float zmax = 1.0f + kd;
  const float c =
      fminf(fmaxf(ts.slope * zsplit, ts.floor_), (zmax - zsplit) / 2.0f);
  const float zmid = zsplit + c;
  k.slot = slot;
  k.zsplit = zsplit;
  k.zmid = zmid;
  k.invA = 1.0f / fmaxf(zsplit, 1e-6f);
  k.invB1 = 1.0f / fmaxf(c, 1e-6f);
  k.invB2 = 1.0f / fmaxf(zmax - zmid, 1e-6f);
  const float zm = k.zmid + 1.0f / k.invB2;
  k.zmax2 = zm * zm;
}

// The v2 schedule with the coefficients computed in the kernel: persistent
// blocks, each staging the table once; warp w of the grid takes draws w,
// w + (warps in the grid), ... At most 64 registers a thread at two blocks
// per SM.
template <class Src, int S>
__global__ void __launch_bounds__(TAB_THREADS, TAB_MIN_BLOCKS)
chi2_kernel_tab(Src src_all, TabArgs p, int C, int n_t, Nodes nodes,
                const __grid_constant__ TabSegs ts) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* slot = smem + tab_floats(ts.n_rows) + warp * TAB_SLOT;
  stage_table(smem, p.tab, 4u * tab_floats(ts.n_rows));

  for (int c = blockIdx.x * TAB_WARPS + warp; c < C;
       c += gridDim.x * TAB_WARPS) {
    const int64_t row = (int64_t)(c / p.Cb) * n_t;   // the draw's target
    const Src src = src_all.target(row);
    SharedCoeffs k;
    tab_coeffs(smem, ts, __ldg(p.k + c), __ldg(p.u1 + c), __ldg(p.u2 + c),
               lane, slot, k);
    __syncwarp();
    const float gc = __ldg(p.g + c);
    const typename Src::Draw d = src.draw(c);
    const float acc =
        draw_chi2<Src, S>(src, d, k, gc, p.obs + row, n_t, nodes, lane);
    if (lane == 0) p.out[c] = acc;
    __syncwarp();   // every lane is done with the slot
  }
}

// tab_coeffs alone over C draws into out (C, TAB_OUT): the 54
// coefficients (A, B1, B2 rows of M_CHEB) and zsplit, zmid, invA, invB1,
// invB2; the same blocks, staging and slots as chi2_kernel_tab.
__global__ void __launch_bounds__(TAB_THREADS)
coeffs_tab_kernel(const float* kd, const float* u1, const float* u2,
                  const float* tab, float* out, int C,
                  const __grid_constant__ TabSegs ts) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* slot = smem + tab_floats(ts.n_rows) + warp * TAB_SLOT;
  stage_table(smem, tab, 4u * tab_floats(ts.n_rows));

  for (int c = blockIdx.x * TAB_WARPS + warp; c < C;
       c += gridDim.x * TAB_WARPS) {
    SharedCoeffs k;
    tab_coeffs(smem, ts, kd[c], u1[c], u2[c], lane, slot, k);
    __syncwarp();
    float* o = out + (int64_t)c * TAB_OUT;
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
// and says where the per-draw g, obs and out live. ExactStage copies the coefficients the torch stage made
// ((C, 18) x 3 and seg (C, 5)); TabStage computes the tabulated ones from
// (k, u1, u2) with tab_coeffs, from the table the block staged in shared
// memory.
struct ExactStage {
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

struct TabStage {
  TabArgs p;
  TabSegs ts;
  static constexpr int kScratch = TAB_SLOT;   // tab_coeffs' output

  __device__ __forceinline__ int table_floats() const {
    return tab_floats(ts.n_rows);
  }
  __device__ __forceinline__ void begin(float* smem) const {
    stage_table(smem, p.tab, 4u * tab_floats(ts.n_rows));
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

template <class Src, int S>
void launch_nodes(const Src& src, const Chi2Args& p, int C, int n_t,
                  const Nodes& nodes, cudaStream_t st) {
  chi2_kernel<Src, S><<<(C + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK,
                        WARPS_PER_BLOCK * 32, 0, st>>>(src, p, C, n_t,
                                                       nodes);
}

// Launch the v2 kernel over Src with S = n_nodes (1..4; the projected
// orbit source has one node only). Returns cudaGetLastError().
template <class Src>
int launch(const Src& src, const Chi2Args& p, int C, int n_t,
           const float* offs, const float* wgts, int n_nodes, void* stream) {
  if (n_nodes < 1 || n_nodes > MAX_NODES || (Src::kOneNode && n_nodes != 1))
    return (int)cudaErrorInvalidValue;
  if (p.Cb <= 0 || C % p.Cb || p.Cb % WARPS_PER_BLOCK)
    return (int)cudaErrorInvalidValue;
  const Nodes nodes = make_nodes(offs, wgts, n_nodes);
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (Src::kOneNode) {
    launch_nodes<Src, 1>(src, p, C, n_t, nodes, st);
  } else {
    switch (n_nodes) {
      case 1: launch_nodes<Src, 1>(src, p, C, n_t, nodes, st); break;
      case 2: launch_nodes<Src, 2>(src, p, C, n_t, nodes, st); break;
      case 3: launch_nodes<Src, 3>(src, p, C, n_t, nodes, st); break;
      default: launch_nodes<Src, 4>(src, p, C, n_t, nodes, st); break;
    }
  }
  return (int)cudaGetLastError();
}

// Resident blocks per SM of one chi2_kernel_v3 instance at its dynamic
// shared memory, read once per device, instance and size: the instance is
// first opted into that much dynamic shared memory (above the 48 KB
// default). Returns a CUDA error code, 0 on success.
struct V3Setup {
  const void* fn = nullptr;
  int dev = -1, smem = 0, blocks = 0, sms = 0;
};
constexpr int V3_SETUPS = 64;

int v3_setup(const void* fn, int smem, const V3Setup** out) {
  static V3Setup setups[V3_SETUPS];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int i = 0;
  for (; i < V3_SETUPS && setups[i].fn; ++i) {
    if (setups[i].fn == fn && setups[i].dev == dev &&
        setups[i].smem == smem) {
      *out = &setups[i];
      return 0;
    }
  }
  if (i == V3_SETUPS) return (int)cudaErrorInvalidValue;
  V3Setup su;
  su.fn = fn;
  su.dev = dev;
  su.smem = smem;
  err = cudaDeviceGetAttribute(&su.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&su.blocks, fn,
                                                      V3_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (su.blocks < 1) return (int)cudaErrorInvalidConfiguration;
  setups[i] = su;
  *out = &setups[i];
  return 0;
}

// The chi2_kernel_v3 instance of a stage for the orbit source and node
// count.
template <class Stage>
const void* v3_orbit_kernel(bool projected, int n_nodes) {
  if (projected)
    return (const void*)chi2_kernel_v3<OrbitSource<true>, 1, Stage>;
  switch (n_nodes) {
    case 1: return (const void*)chi2_kernel_v3<OrbitSource<false>, 1, Stage>;
    case 2: return (const void*)chi2_kernel_v3<OrbitSource<false>, 2, Stage>;
    case 3: return (const void*)chi2_kernel_v3<OrbitSource<false>, 3, Stage>;
    default: return (const void*)chi2_kernel_v3<OrbitSource<false>, 4, Stage>;
  }
}

template <class Src, int S, class Stage>
int launch_v3_nodes(const Src& src, const Stage& st, int table_floats, int C,
                    int n_t, const Nodes& nodes, cudaStream_t stream) {
  const V3Setup* su = nullptr;
  const int err = v3_setup((const void*)chi2_kernel_v3<Src, S, Stage>,
                           v3_smem_bytes<Stage>(table_floats), &su);
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
// table in shared memory (0 for ExactStage). Returns a CUDA error code, 0
// on success.
template <class Src, class Stage>
int launch_v3(const Src& src, const Stage& st, int table_floats, int C,
              int n_t, const float* offs, const float* wgts, int n_nodes,
              void* stream) {
  if (n_nodes < 1 || n_nodes > MAX_NODES || (Src::kOneNode && n_nodes != 1))
    return (int)cudaErrorInvalidValue;
  const int Cb = st.p.Cb;
  if (C <= 0 || C % V3_DRAW_LANES || Cb <= 0 || C % Cb || Cb % 32)
    return (int)cudaErrorInvalidValue;
  const Nodes nodes = make_nodes(offs, wgts, n_nodes);
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (Src::kOneNode) {
    return launch_v3_nodes<Src, 1>(src, st, table_floats, C, n_t, nodes, s);
  } else {
    switch (n_nodes) {
      case 1:
        return launch_v3_nodes<Src, 1>(src, st, table_floats, C, n_t, nodes,
                                       s);
      case 2:
        return launch_v3_nodes<Src, 2>(src, st, table_floats, C, n_t, nodes,
                                       s);
      case 3:
        return launch_v3_nodes<Src, 3>(src, st, table_floats, C, n_t, nodes,
                                       s);
      default:
        return launch_v3_nodes<Src, 4>(src, st, table_floats, C, n_t, nodes,
                                       s);
    }
  }
}

// Launch the v2 kernel (V3 false) or chi2_kernel_v3 with Stage over the
// orbit of the draws; projected != 0 selects projected_z.
template <bool V3, class Stage>
int launch_orbit(const float* time, const float* P, const float* aR,
                 const float* inc, const float* e, const float* w,
                 const Stage& st, int table_floats, int C, int n_t,
                 const float* offs, const float* wgts, int n_nodes,
                 int projected, void* stream) {
  if constexpr (V3) {
    if (projected)
      return launch_v3(OrbitSource<true>{time, P, aR, inc, e, w}, st,
                       table_floats, C, n_t, offs, wgts, n_nodes, stream);
    return launch_v3(OrbitSource<false>{time, P, aR, inc, e, w}, st,
                     table_floats, C, n_t, offs, wgts, n_nodes, stream);
  } else {
    if (projected)
      return launch(OrbitSource<true>{time, P, aR, inc, e, w}, st, C, n_t,
                    offs, wgts, n_nodes, stream);
    return launch(OrbitSource<false>{time, P, aR, inc, e, w}, st, C, n_t,
                  offs, wgts, n_nodes, stream);
  }
}

// chi2_kernel_tab's instances (the projected source at one node, the
// Taylor source at 1..4 nodes) and coeffs_tab_kernel.
constexpr int TAB_KERNELS = 6;
constexpr int TAB_COEFFS_KERNEL = TAB_KERNELS - 1;
constexpr int MAX_DEVICES = 64;

const void* tab_kernel(int i) {
  switch (i) {
    case 0: return (const void*)chi2_kernel_tab<OrbitSource<true>, 1>;
    case 1: return (const void*)chi2_kernel_tab<OrbitSource<false>, 1>;
    case 2: return (const void*)chi2_kernel_tab<OrbitSource<false>, 2>;
    case 3: return (const void*)chi2_kernel_tab<OrbitSource<false>, 3>;
    case 4: return (const void*)chi2_kernel_tab<OrbitSource<false>, 4>;
    default: return (const void*)coeffs_tab_kernel;
  }
}

// The instance of chi2_kernel_tab for a source and node count.
int tab_index(bool projected, int n_nodes) {
  return projected ? 0 : n_nodes;
}

struct TabSetup {
  int smem = 0;                   // dynamic shared memory a block, bytes
  int sms = 0;                    // the device's SMs
  int blocks[TAB_KERNELS] = {};   // resident blocks per SM, per instance
};

// Opt every instance into the dynamic shared memory of a table of n_rows
// rows (above the 48 KB default) and read how many of its blocks fit on an
// SM: once per device and table size, before the first launch. Returns a
// CUDA error code, 0 on success.
int tab_setup(int n_rows, const TabSetup** out) {
  static TabSetup setups[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const int smem = tab_smem_bytes(n_rows);
  if (setups[dev].smem != smem) {
    TabSetup su;
    err = cudaDeviceGetAttribute(&su.sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
    for (int i = 0; i < TAB_KERNELS; ++i) {
      err = cudaFuncSetAttribute(tab_kernel(i),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return (int)err;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &su.blocks[i], tab_kernel(i), TAB_THREADS, smem);
      if (err != cudaSuccess) return (int)err;
      if (su.blocks[i] < 1) return (int)cudaErrorInvalidConfiguration;
    }
    su.smem = smem;
    setups[dev] = su;
  }
  *out = &setups[dev];
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

// Blocks of a persistent launch of instance i over C draws: as many as fit
// on the device at once, no more than the draws' warps.
int tab_grid(const TabSetup& su, int i, int C) {
  return std::min(su.sms * su.blocks[i], (C + TAB_WARPS - 1) / TAB_WARPS);
}

template <class Src, int S>
void launch_tab_nodes(const TabSetup& su, const Src& src, const TabArgs& p,
                      int C, int n_t, const Nodes& nodes, const TabSegs& ts,
                      cudaStream_t st) {
  chi2_kernel_tab<Src, S>
      <<<tab_grid(su, tab_index(Src::kOneNode, S), C), TAB_THREADS, su.smem,
         st>>>(src, p, C, n_t, nodes, ts);
}

// Launch chi2_kernel_tab over Src with S = n_nodes (1..4; the projected
// source has one node only). Returns a CUDA error code, 0 on success.
template <class Src>
int launch_tab(const Src& src, const TabArgs& p, int C, int n_t,
               const float* offs, const float* wgts, int n_nodes,
               const TabSegs& ts, void* stream) {
  if (n_nodes < 1 || n_nodes > MAX_NODES || (Src::kOneNode && n_nodes != 1))
    return (int)cudaErrorInvalidValue;
  if (C <= 0 || p.Cb <= 0 || C % p.Cb || !tab_segs_ok(ts))
    return (int)cudaErrorInvalidValue;
  const TabSetup* su = nullptr;
  const int err = tab_setup(ts.n_rows, &su);
  if (err) return err;
  const Nodes nodes = make_nodes(offs, wgts, n_nodes);
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (Src::kOneNode) {
    launch_tab_nodes<Src, 1>(*su, src, p, C, n_t, nodes, ts, st);
  } else {
    switch (n_nodes) {
      case 1:
        launch_tab_nodes<Src, 1>(*su, src, p, C, n_t, nodes, ts, st);
        break;
      case 2:
        launch_tab_nodes<Src, 2>(*su, src, p, C, n_t, nodes, ts, st);
        break;
      case 3:
        launch_tab_nodes<Src, 3>(*su, src, p, C, n_t, nodes, ts, st);
        break;
      default:
        launch_tab_nodes<Src, 4>(*su, src, p, C, n_t, nodes, ts, st);
        break;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Pointers are device pointers
// except offs/wgts, which are host arrays of n_nodes floats. Each returns
// cudaGetLastError() after the launch.

// v2 on planes: q0, q1, q2, front are draw-major (C, n_t).
extern "C" int chi2_supersampled_launch(
    const float* q0, const float* q1, const float* q2, const float* front,
    const float* cA, const float* cB1, const float* cB2, const float* seg,
    const float* g, const float* obs, float* out, int C, int n_t,
    const float* offs, const float* wgts, int n_nodes, void* stream) {
  return launch(PlaneSource<false>{q0, q1, q2, front, n_t},
                Chi2Args{cA, cB1, cB2, seg, g, obs, out, C}, C, n_t, offs,
                wgts, n_nodes, stream);
}

// v3 on planes: q0t, q1t, q2t, frontt are time-major (n_t, C); C % 128 == 0.
extern "C" int chi2_supersampled_v3_launch(
    const float* q0t, const float* q1t, const float* q2t,
    const float* frontt, const float* cA, const float* cB1, const float* cB2,
    const float* seg, const float* g, const float* obs, float* out, int C,
    int n_t, const float* offs, const float* wgts, int n_nodes,
    void* stream) {
  return launch_v3(PlaneSource<true>{q0t, q1t, q2t, frontt, C},
                   ExactStage{Chi2Args{cA, cB1, cB2, seg, g, obs, out, C}}, 0,
                   C, n_t, offs, wgts, n_nodes, stream);
}

// v2 on the orbit for B = C / Cb targets: time and obs (B, n_t); P, aR,
// inc, e, w (C,), target-major. projected != 0 selects projected_z and
// needs n_nodes == 1.
extern "C" int chi2_from_orbit_launch(
    const float* time, const float* P, const float* aR, const float* inc,
    const float* e, const float* w, const float* cA, const float* cB1,
    const float* cB2, const float* seg, const float* g, const float* obs,
    float* out, int C, int n_t, const float* offs, const float* wgts,
    int n_nodes, int projected, int Cb, void* stream) {
  return launch_orbit<false>(time, P, aR, inc, e, w,
                             Chi2Args{cA, cB1, cB2, seg, g, obs, out, Cb}, 0,
                             C, n_t, offs, wgts, n_nodes, projected, stream);
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
      ExactStage{Chi2Args{cA, cB1, cB2, seg, g, obs, out, Cb}}, 0, C, n_t,
      offs, wgts, n_nodes, projected, stream);
}

// v3 with the coefficients computed in the kernel (chi2_kernel_v3 with
// TabStage): the arguments of chi2_from_orbit_tab_launch; C % 128 == 0,
// Cb % 32 == 0.
extern "C" int chi2_from_orbit_v3_tab_launch(
    const float* time, const float* P, const float* aR, const float* inc,
    const float* e, const float* w, const float* k, const float* u1,
    const float* u2, const float* g, const float* obs, const float* tab,
    float* out, int C, int n_t, const float* offs, const float* wgts,
    int n_nodes, int projected, int Cb, const void* segs, void* stream) {
  const TabSegs& ts = *static_cast<const TabSegs*>(segs);
  if (!tab_segs_ok(ts)) return (int)cudaErrorInvalidValue;
  return launch_orbit<true>(time, P, aR, inc, e, w,
                            TabStage{TabArgs{k, u1, u2, g, obs, tab, out, Cb},
                                     ts},
                            tab_floats(ts.n_rows), C, n_t, offs, wgts,
                            n_nodes, projected, stream);
}


// v2 with the coefficients computed in the kernel (chi2_kernel_tab), for
// B = C / Cb targets: time and obs (B, n_t); P, aR, inc, e, w, k, u1, u2, g
// (C,), target-major; tab the (n_rows, 162) coefficient table, 16-byte
// aligned; segs a host TabSegs. projected != 0 selects projected_z and
// needs n_nodes == 1.
extern "C" int chi2_from_orbit_tab_launch(
    const float* time, const float* P, const float* aR, const float* inc,
    const float* e, const float* w, const float* k, const float* u1,
    const float* u2, const float* g, const float* obs, const float* tab,
    float* out, int C, int n_t, const float* offs, const float* wgts,
    int n_nodes, int projected, int Cb, const void* segs, void* stream) {
  const TabSegs& ts = *static_cast<const TabSegs*>(segs);
  const TabArgs p{k, u1, u2, g, obs, tab, out, Cb};
  if (projected)
    return launch_tab(OrbitSource<true>{time, P, aR, inc, e, w}, p, C, n_t,
                      offs, wgts, n_nodes, ts, stream);
  return launch_tab(OrbitSource<false>{time, P, aR, inc, e, w}, p, C, n_t,
                    offs, wgts, n_nodes, ts, stream);
}

// chi2_kernel_tab's coefficient stage alone (coeffs_tab_kernel): out
// (C, 59) from k, u1, u2 (C,), the same arguments otherwise. For checking
// the in-kernel coefficients; the chi^2 path never calls it.
extern "C" int deficit_coeffs_tab_launch(const float* k, const float* u1,
                                         const float* u2, const float* tab,
                                         float* out, int C, const void* segs,
                                         void* stream) {
  const TabSegs& ts = *static_cast<const TabSegs*>(segs);
  if (C <= 0 || !tab_segs_ok(ts)) return (int)cudaErrorInvalidValue;
  const TabSetup* su = nullptr;
  const int err = tab_setup(ts.n_rows, &su);
  if (err) return err;
  coeffs_tab_kernel<<<tab_grid(*su, TAB_COEFFS_KERNEL, C), TAB_THREADS,
                      su->smem, (cudaStream_t)stream>>>(k, u1, u2, tab, out,
                                                        C, ts);
  return (int)cudaGetLastError();
}

// What the compiler and the occupancy calculator give chi2_kernel_tab's
// instance for n_nodes and projected at a table of n_rows rows: out[0]
// registers a thread, out[1] local memory bytes a thread (spills), out[2]
// resident blocks per SM, out[3] threads a block, out[4] dynamic shared
// memory bytes a block, out[5] the device's SMs.
extern "C" int chi2_from_orbit_tab_info(int n_nodes, int projected,
                                        int n_rows, int* out) {
  if (n_nodes < 1 || n_nodes > MAX_NODES || (projected && n_nodes != 1))
    return (int)cudaErrorInvalidValue;
  const TabSetup* su = nullptr;
  const int err = tab_setup(n_rows, &su);
  if (err) return err;
  const int i = tab_index(projected != 0, n_nodes);
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, tab_kernel(i));
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = su->blocks[i];
  out[3] = TAB_THREADS;
  out[4] = su->smem;
  out[5] = su->sms;
  return 0;
}

// What the compiler and the occupancy calculator give chi2_kernel_v3's
// orbit instance for n_nodes and projected, with the tab stage (tab != 0,
// a table of n_rows rows) or the exact one: out[0] registers a thread,
// out[1] local memory bytes a thread (spills), out[2] resident blocks per
// SM, out[3] threads a block, out[4] dynamic shared memory bytes a block,
// out[5] the device's SMs.
extern "C" int chi2_from_orbit_v3_info(int n_nodes, int projected, int tab,
                                       int n_rows, int* out) {
  if (n_nodes < 1 || n_nodes > MAX_NODES || (projected && n_nodes != 1) ||
      (tab && n_rows < 1))
    return (int)cudaErrorInvalidValue;
  const void* fn = tab ? v3_orbit_kernel<TabStage>(projected != 0, n_nodes)
                       : v3_orbit_kernel<ExactStage>(projected != 0, n_nodes);
  const int smem = tab ? v3_smem_bytes<TabStage>(tab_floats(n_rows))
                       : v3_smem_bytes<ExactStage>(0);
  const V3Setup* su = nullptr;
  const int err = v3_setup(fn, smem, &su);
  if (err) return err;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = su->blocks;
  out[3] = V3_THREADS;
  out[4] = smem;
  out[5] = su->sms;
  return 0;
}
