// Fused supersample -> Chebyshev deficit -> chi^2 for one draw chunk.
//
// Replaces the JAX package's ops/pallas_core.py::chi2_supersampled (the
// Pallas TPU kernel _chi2_kernel / _clenshaw_tile). Same contract:
//
//   out[c] = sum_t gD (2 obs[t] + gD) + sum_t obs[t]^2,
//   gD     = g[c] * front[c,t] * sum_s wgt[s] D_c(z_s),
//   z_s^2  = q0 + q1 d_s + q2 d_s^2           (exposure node offsets d_s),
//
// with D_c the per-draw three-segment sqrt-map Chebyshev deficit
// (ops/fastcore.py::cheb_deficit_eval), clipped to [0, 1].
//
// What bounds it on an H100: FP32 ALU and SFU work, not bytes. Per
// (draw, time, node) it does two IEEE square roots for the sqrt map, one
// for z, and an 18-step Clenshaw recurrence with a per-point segment
// select (~70 FP32 ops), against 16 bytes of q0/q1/q2/front read once per
// (draw, time) for all nodes. At GL-4 that is ~300 flops per 16 bytes,
// far above the card's FP32 balance point.
//
// What the design does about it:
//   * one warp per draw, lanes striding over time: the (C, n_t) planes are
//     read coalesced, exactly once, and the z^2 model is evaluated from
//     registers for every node, so nothing but the inputs touches memory;
//   * the draw's 3 x 18 coefficients and 5 segment scalars are loaded once
//     per warp (a broadcast load) into registers, and the recurrence is
//     fully unrolled, so the select is two predicated moves per step;
//   * the out-of-transit skip of the TPU kernel is kept at warp
//     granularity: a 32-point group in which no lane is in front with
//     z < zmax at any node skips the square roots and the recurrence
//     (__any_sync). Such points contribute D(zmax) ~ 0 in the plain path;
//   * the per-draw sum is a __shfl_xor_sync butterfly: no atomics, so a
//     run is deterministic.
// The square roots and divisions stay IEEE (no --use_fast_math): the f32
// error budget of the deficit is ~1e-6 and approximate sqrt eats into it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int M_CHEB = 18;
constexpr int MAX_NODES = 4;
constexpr int WARPS_PER_BLOCK = 8;

struct Nodes {
  float off[MAX_NODES];
  float off2[MAX_NODES];
  float wgt[MAX_NODES];
};

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

  float a[M_CHEB], b1c[M_CHEB], b2c[M_CHEB];
#pragma unroll
  for (int m = 0; m < M_CHEB; ++m) {
    a[m] = cA[(int64_t)c * M_CHEB + m];
    b1c[m] = cB1[(int64_t)c * M_CHEB + m];
    b2c[m] = cB2[(int64_t)c * M_CHEB + m];
  }
  const float zsplit = seg[c * 5 + 0];
  const float zmid = seg[c * 5 + 1];
  const float invA = seg[c * 5 + 2];
  const float invB1 = seg[c * 5 + 3];
  const float invB2 = seg[c * 5 + 4];
  const float zmax = zmid + 1.0f / invB2;
  const float zmax2 = zmax * zmax;
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
      const float a0 = q0[row + t], a1 = q1[row + t], a2 = q2[row + t];
      fr = front[row + t];
      ob = obs[t];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        z2[s] = a0 + a1 * nodes.off[s] + a2 * nodes.off2[s];
        active |= z2[s] < zmax2;
      }
      active &= fr > 0.0f;
      acc += ob * ob;
    }
    if (!__any_sync(0xffffffffu, active)) continue;
    if (!inb) continue;
    float dbar = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float z = sqrtf(fmaxf(z2[s], 0.0f));
      const bool inB2 = z >= zmid;
      const bool inB1 = (z >= zsplit) && !inB2;
      float sx = inB2 ? (z - zmid) * invB2
                      : (inB1 ? (z - zsplit) * invB1 : z * invA);
      sx = fminf(fmaxf(sx, 0.0f), 1.0f);
      const float x = sqrtf(sx) - sqrtf(1.0f - sx);
      const float two_x = 2.0f * x;
      float bb1 = 0.0f, bb2 = 0.0f;
#pragma unroll
      for (int m = M_CHEB - 1; m > 0; --m) {
        const float cm = inB2 ? b2c[m] : (inB1 ? b1c[m] : a[m]);
        const float nb = cm + two_x * bb1 - bb2;
        bb2 = bb1;
        bb1 = nb;
      }
      const float c0 = inB2 ? b2c[0] : (inB1 ? b1c[0] : a[0]);
      const float D = fminf(fmaxf(c0 + x * bb1 - bb2, 0.0f), 1.0f);
      dbar = dbar + nodes.wgt[s] * D;
    }
    const float gD = gc * (dbar * fr);
    acc += gD * (2.0f * ob + gD);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[c] = acc;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers
// except offs/wgts, which are host arrays of n_nodes floats. Returns
// cudaGetLastError() after the launch.
extern "C" int chi2_supersampled_launch(
    const float* q0, const float* q1, const float* q2, const float* front,
    const float* cA, const float* cB1, const float* cB2, const float* seg,
    const float* g, const float* obs, float* out, int C, int n_t,
    const float* offs, const float* wgts, int n_nodes, void* stream) {
  if (n_nodes < 1 || n_nodes > MAX_NODES) return (int)cudaErrorInvalidValue;
  Nodes nodes = {};
  for (int s = 0; s < n_nodes; ++s) {
    nodes.off[s] = offs[s];
    nodes.off2[s] = offs[s] * offs[s];
    nodes.wgt[s] = wgts[s];
  }
  const dim3 block(WARPS_PER_BLOCK * 32);
  const dim3 grid((C + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_nodes) {
    case 1:
      chi2_kernel<1><<<grid, block, 0, st>>>(q0, q1, q2, front, cA, cB1, cB2,
                                              seg, g, obs, out, C, n_t, nodes);
      break;
    case 2:
      chi2_kernel<2><<<grid, block, 0, st>>>(q0, q1, q2, front, cA, cB1, cB2,
                                              seg, g, obs, out, C, n_t, nodes);
      break;
    case 3:
      chi2_kernel<3><<<grid, block, 0, st>>>(q0, q1, q2, front, cA, cB1, cB2,
                                              seg, g, obs, out, C, n_t, nodes);
      break;
    default:
      chi2_kernel<4><<<grid, block, 0, st>>>(q0, q1, q2, front, cA, cB1, cB2,
                                              seg, g, obs, out, C, n_t, nodes);
      break;
  }
  return (int)cudaGetLastError();
}
