// Fused supersample -> Chebyshev deficit -> chi^2 for one draw chunk, in
// two schedules that share their per-point math.
//
// Replaces the JAX package's Pallas TPU kernels
//   * ops/pallas_core.py::chi2_supersampled (body _chi2_kernel, helper
//     _clenshaw_tile; the v2 schedule): chi2_kernel below;
//   * ops/pallas_core.py::chi2_supersampled_v3 (body _chi2_kernel_v3; the
//     time-major v3 schedule): chi2_kernel_v3 below.
// Both compute the same function:
//
//   out[c] = sum_t gD (2 obs[t] + gD) + sum_t obs[t]^2,
//   gD     = g[c] * front[c,t] * sum_s wgt[s] D_c(z_s),
//   z_s^2  = q0 + q1 d_s + q2 d_s^2           (exposure node offsets d_s),
//
// with D_c the per-draw three-segment sqrt-map Chebyshev deficit
// (ops/fastcore.py::cheb_deficit_eval), clipped to [0, 1].
//
// What bounds it on an H100: every (draw, time) point costs 16 bytes of
// q0/q1/q2/front, read once for all nodes; a point in transit also costs,
// per node, two IEEE square roots for the sqrt map, one for z and an
// 18-step Clenshaw recurrence with a per-point segment select (~73 FP32
// flops), ~300 flops per point at GL-4, far above the card's FP32 balance
// point. The out-of-transit skip leaves the FP32 work to the points near
// the transit (~27 % of them at the main path's n_t = 100, 3-14 % on long
// curves), so on that data the least time is set by the bytes
// (chip_smoke.py prints the bound for each shape).
//
// What the design does about it:
//   * point_deficit, the per-point work (sqrt map, recurrence with its
//     segment select, clip, node weights), is one inlined device function
//     that both kernels call; the draw's 3 x 18 coefficients and 5 segment
//     scalars live in registers and the recurrence is fully unrolled;
//   * v2 (chi2_kernel): one warp per draw, lanes striding over time, so
//     the draw-major (C, n_t) planes are read coalesced; a 32-point group
//     in which no lane is in front with z < zmax at any node skips the
//     square roots and the recurrence (__any_sync); the per-draw sum is a
//     __shfl_xor_sync butterfly;
//   * v3 (chi2_kernel_v3): one thread per draw, the 32 draws of a warp
//     consecutive, each thread walking the time axis of the time-major
//     (n_t, C) planes, so every time step is one coalesced 128-byte load
//     per plane per warp; the skip is v3's block skip in warp form: a
//     block of 32 draws x TIME_SUB time steps in which no (draw, time,
//     node) is in front with z < zmax skips the square roots and the
//     recurrence. Each thread owns its draw's sum: no shuffle, no atomic.
//     v3 has C threads in all, so at small C it keeps few warps per SM.
// Both are deterministic. Points inside a group or block that does run keep
// their ~1e-8 deficit residue at z >= zmax, as on the TPU. The square roots
// and divisions stay IEEE (no --use_fast_math): the f32 error budget of the
// deficit is ~1e-6 and approximate sqrt eats into it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int M_CHEB = 18;
constexpr int MAX_NODES = 4;
constexpr int WARPS_PER_BLOCK = 8;
constexpr int V3_THREADS = 32;    // one warp per block spreads small C
constexpr int V3_DRAW_LANES = 128;
constexpr int TIME_SUB = 8;

struct Nodes {
  float off[MAX_NODES];
  float off2[MAX_NODES];
  float wgt[MAX_NODES];
};

// One draw's deficit coefficients and segment scalars, in registers.
struct DrawCoeffs {
  float a[M_CHEB], b1[M_CHEB], b2[M_CHEB];
  float zsplit, zmid, invA, invB1, invB2, zmax2;
};

__device__ __forceinline__ void load_coeffs(
    DrawCoeffs& k, const float* __restrict__ cA,
    const float* __restrict__ cB1, const float* __restrict__ cB2,
    const float* __restrict__ seg, int c) {
#pragma unroll
  for (int m = 0; m < M_CHEB; ++m) {
    k.a[m] = cA[(int64_t)c * M_CHEB + m];
    k.b1[m] = cB1[(int64_t)c * M_CHEB + m];
    k.b2[m] = cB2[(int64_t)c * M_CHEB + m];
  }
  k.zsplit = seg[c * 5 + 0];
  k.zmid = seg[c * 5 + 1];
  k.invA = seg[c * 5 + 2];
  k.invB1 = seg[c * 5 + 3];
  k.invB2 = seg[c * 5 + 4];
  const float zmax = k.zmid + 1.0f / k.invB2;
  k.zmax2 = zmax * zmax;
}

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
// select, 18-step Clenshaw, clip to [0, 1].
template <int S>
__device__ __forceinline__ float point_deficit(const float (&z2)[S],
                                               const DrawCoeffs& k,
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
    float bb1 = 0.0f, bb2 = 0.0f;
#pragma unroll
    for (int m = M_CHEB - 1; m > 0; --m) {
      const float cm = inB2 ? k.b2[m] : (inB1 ? k.b1[m] : k.a[m]);
      const float nb = cm + two_x * bb1 - bb2;
      bb2 = bb1;
      bb1 = nb;
    }
    const float c0 = inB2 ? k.b2[0] : (inB1 ? k.b1[0] : k.a[0]);
    const float D = fminf(fmaxf(c0 + x * bb1 - bb2, 0.0f), 1.0f);
    dbar = dbar + nodes.wgt[s] * D;
  }
  return dbar;
}

template <int S>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
chi2_kernel(const float* __restrict__ q0, const float* __restrict__ q1,
            const float* __restrict__ q2, const float* __restrict__ front,
            const float* __restrict__ cA, const float* __restrict__ cB1,
            const float* __restrict__ cB2, const float* __restrict__ seg,
            const float* __restrict__ g, const float* __restrict__ obs,
            float* __restrict__ out, int C, int n_t, Nodes nodes) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (c >= C) return;  // whole warp leaves together

  DrawCoeffs k;
  load_coeffs(k, cA, cB1, cB2, seg, c);
  const float gc = g[c];

  const int64_t row = (int64_t)c * n_t;
  float acc = 0.0f;
  for (int t0 = 0; t0 < n_t; t0 += 32) {
    const int t = t0 + lane;
    const bool inb = t < n_t;
    float z2[S];
    float fr = 0.0f, ob = 0.0f;
    bool active = false;
    if (inb) {
      fr = front[row + t];
      ob = obs[t];
      active = exposure_z2<S>(q0[row + t], q1[row + t], q2[row + t], nodes,
                              k.zmax2, z2);
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
  if (lane == 0) out[c] = acc;
}

template <int S>
__global__ void __launch_bounds__(V3_THREADS)
chi2_kernel_v3(const float* __restrict__ q0t, const float* __restrict__ q1t,
               const float* __restrict__ q2t,
               const float* __restrict__ frontt,
               const float* __restrict__ cA, const float* __restrict__ cB1,
               const float* __restrict__ cB2, const float* __restrict__ seg,
               const float* __restrict__ g, const float* __restrict__ obs,
               float* __restrict__ out, int C, int n_t, Nodes nodes) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * V3_THREADS + threadIdx.x;  // C % 128 == 0

  // sum_t obs^2, the same for every draw: lane-strided, then a butterfly
  float obs2 = 0.0f;
  for (int t = lane; t < n_t; t += 32) obs2 += obs[t] * obs[t];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    obs2 += __shfl_xor_sync(0xffffffffu, obs2, o);

  DrawCoeffs k;
  load_coeffs(k, cA, cB1, cB2, seg, c);
  const float gc = g[c];

  float acc = 0.0f;
  for (int t0 = 0; t0 < n_t; t0 += TIME_SUB) {
    // the block's 4 x TIME_SUB loads are issued together: the row index is
    // clamped (no branch), and rows past the curve's end get front = 0
    float a0[TIME_SUB], a1[TIME_SUB], a2[TIME_SUB], fr[TIME_SUB];
#pragma unroll
    for (int j = 0; j < TIME_SUB; ++j) {
      const int64_t i = (int64_t)min(t0 + j, n_t - 1) * C + c;
      a0[j] = q0t[i];
      a1[j] = q1t[i];
      a2[j] = q2t[i];
      const float f = frontt[i];
      fr[j] = t0 + j < n_t ? f : 0.0f;
    }
    float z2[TIME_SUB][S];
    bool active = false;
#pragma unroll
    for (int j = 0; j < TIME_SUB; ++j) {
      const bool inside = exposure_z2<S>(a0[j], a1[j], a2[j], nodes,
                                         k.zmax2, z2[j]);
      active |= inside && fr[j] > 0.0f;
    }
    if (!__any_sync(0xffffffffu, active)) continue;
#pragma unroll
    for (int j = 0; j < TIME_SUB; ++j) {
      if (t0 + j < n_t) {
        const float ob = obs[t0 + j];
        const float gD = gc * (point_deficit<S>(z2[j], k, nodes) * fr[j]);
        acc += gD * (2.0f * ob + gD);
      }
    }
  }
  out[c] = acc + obs2;
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

// Launch KERNEL<S> with S = n_nodes (1..4) on one grid.
#define LAUNCH_BY_NODES(KERNEL, GRID, BLOCK, ST, ...)            \
  switch (n_nodes) {                                              \
    case 1: KERNEL<1><<<GRID, BLOCK, 0, ST>>>(__VA_ARGS__); break; \
    case 2: KERNEL<2><<<GRID, BLOCK, 0, ST>>>(__VA_ARGS__); break; \
    case 3: KERNEL<3><<<GRID, BLOCK, 0, ST>>>(__VA_ARGS__); break; \
    default: KERNEL<4><<<GRID, BLOCK, 0, ST>>>(__VA_ARGS__); break; \
  }

}  // namespace

// Plain C entry points (loaded with ctypes). Pointers are device pointers
// except offs/wgts, which are host arrays of n_nodes floats. Each returns
// cudaGetLastError() after the launch.

// v2: q0, q1, q2, front are draw-major (C, n_t).
extern "C" int chi2_supersampled_launch(
    const float* q0, const float* q1, const float* q2, const float* front,
    const float* cA, const float* cB1, const float* cB2, const float* seg,
    const float* g, const float* obs, float* out, int C, int n_t,
    const float* offs, const float* wgts, int n_nodes, void* stream) {
  if (n_nodes < 1 || n_nodes > MAX_NODES) return (int)cudaErrorInvalidValue;
  const Nodes nodes = make_nodes(offs, wgts, n_nodes);
  const dim3 block(WARPS_PER_BLOCK * 32);
  const dim3 grid((C + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  cudaStream_t st = (cudaStream_t)stream;
  LAUNCH_BY_NODES(chi2_kernel, grid, block, st, q0, q1, q2, front, cA, cB1,
                  cB2, seg, g, obs, out, C, n_t, nodes)
  return (int)cudaGetLastError();
}

// v3: q0t, q1t, q2t, frontt are time-major (n_t, C); C % 128 == 0.
extern "C" int chi2_supersampled_v3_launch(
    const float* q0t, const float* q1t, const float* q2t,
    const float* frontt, const float* cA, const float* cB1, const float* cB2,
    const float* seg, const float* g, const float* obs, float* out, int C,
    int n_t, const float* offs, const float* wgts, int n_nodes,
    void* stream) {
  if (n_nodes < 1 || n_nodes > MAX_NODES) return (int)cudaErrorInvalidValue;
  if (C <= 0 || C % V3_DRAW_LANES) return (int)cudaErrorInvalidValue;
  const Nodes nodes = make_nodes(offs, wgts, n_nodes);
  const dim3 block(V3_THREADS);
  const dim3 grid(C / V3_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  LAUNCH_BY_NODES(chi2_kernel_v3, grid, block, st, q0t, q1t, q2t, frontt, cA,
                  cB1, cB2, seg, g, obs, out, C, n_t, nodes)
  return (int)cudaGetLastError();
}
