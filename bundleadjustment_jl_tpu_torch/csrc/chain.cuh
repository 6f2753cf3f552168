// Device functions shared by the assembly (assemble.cu) and trial-objective
// (objective.cu) kernels: the closed-form BAL linearization and projection
// chain, one observation row per call, plus a deterministic block sum.
//
// This is the arithmetic of the JAX package's
// `ops/pallas_linearize.py:linearize_chain` / `project_chain`, written out
// in the same order as the plain PyTorch version (`ops/chain.py`). It must
// be compiled without --use_fast_math: sqrtf, sincosf, the divides and the
// theta^2 <= 1e-24 Taylor branch stay IEEE so kernel and plain agree.
#pragma once

#include <cuda_runtime.h>

// Threads per block of every kernel in this package. The block sums below
// assume blockDim.x == BA_BLOCK.
constexpr int BA_BLOCK = 256;
constexpr float BA_SMALL_THETA_SQ = 1e-24f;

struct BaCam {
  float r[3], t[3], k1, k2, f;
};

__device__ __forceinline__ BaCam ba_load_cam(const float* __restrict__ p) {
  BaCam c;
  c.r[0] = p[0]; c.r[1] = p[1]; c.r[2] = p[2];
  c.t[0] = p[3]; c.t[1] = p[4]; c.t[2] = p[5];
  c.k1 = p[6]; c.k2 = p[7]; c.f = p[8];
  return c;
}

__device__ __forceinline__ void ba_cross(const float a[3], const float b[3],
                                         float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// Entry (a, b) of the cross-product matrix: hat(v) @ u == cross(v, u).
// Called with compile-time a, b inside unrolled loops, so it folds away.
__device__ __forceinline__ float ba_hat(const float v[3], int a, int b) {
  if (a == 0 && b == 1) return -v[2];
  if (a == 0 && b == 2) return v[1];
  if (a == 1 && b == 0) return v[2];
  if (a == 1 && b == 2) return -v[0];
  if (a == 2 && b == 0) return -v[1];
  if (a == 2 && b == 1) return v[0];
  return 0.0f;
}

// Rotated point R(r) X, with the small-angle Taylor branch.
__device__ __forceinline__ void ba_rotate(const BaCam& cam, const float X[3],
                                          float RX[3]) {
  const float* r = cam.r;
  const float th2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  const bool safe = th2 > BA_SMALL_THETA_SQ;
  const float th = sqrtf(safe ? th2 : 1.0f);
  const float inv_th = 1.0f / th;
  const float k[3] = {r[0] * inv_th, r[1] * inv_th, r[2] * inv_th};
  float sn, cs;
  sincosf(th, &sn, &cs);
  const float one_c = 1.0f - cs;
  float kxX[3], rxX[3], rxrxX[3];
  ba_cross(k, X, kxX);
  const float kdX = k[0] * X[0] + k[1] * X[1] + k[2] * X[2];
  ba_cross(r, X, rxX);
  ba_cross(r, rxX, rxrxX);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float big = cs * X[a] + sn * kxX[a] + one_c * kdX * k[a];
    const float small = X[a] + rxX[a] + 0.5f * rxrxX[a];
    RX[a] = safe ? big : small;
  }
}

// Weighted residual of one row; zero when z == 0 or w == 0.
__device__ __forceinline__ void ba_project_residual(const BaCam& cam,
                                                    const float X[3],
                                                    float ox, float oy,
                                                    float w, float res[2]) {
  float RX[3];
  ba_rotate(cam, X, RX);
  const float p1[3] = {RX[0] + cam.t[0], RX[1] + cam.t[1], RX[2] + cam.t[2]};
  const float z = p1[2];
  const bool z_ok = z != 0.0f;
  const float inv_z = 1.0f / (z_ok ? z : 1.0f);
  const float p2x = -p1[0] * inv_z, p2y = -p1[1] * inv_z;
  const float n2 = p2x * p2x + p2y * p2y;
  const float frho = cam.f * (1.0f + cam.k1 * n2 + cam.k2 * n2 * n2);
  const float valid = z_ok ? w : 0.0f;
  res[0] = (frho * p2x - ox) * valid;
  res[1] = (frho * p2y - oy) * valid;
}

// Full chain: weighted residual res[2], Jc[9 i + a] (a: d/dr 0-2, d/dt 3-5,
// d/d(k1, k2, f) 6-8) and Jp[3 i + b], zeroed when z == 0 or w == 0.
__device__ __forceinline__ void ba_linearize(const BaCam& cam,
                                             const float X[3], float ox,
                                             float oy, float w, float Jc[18],
                                             float Jp[6], float res[2]) {
  const float* r = cam.r;
  const float th2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  const bool safe = th2 > BA_SMALL_THETA_SQ;
  const float th = sqrtf(safe ? th2 : 1.0f);
  const float inv_th = 1.0f / th;
  const float k[3] = {r[0] * inv_th, r[1] * inv_th, r[2] * inv_th};
  float sn, cs;
  sincosf(th, &sn, &cs);
  const float one_c = 1.0f - cs;
  float kxX[3], rxX[3], rxrxX[3];
  ba_cross(k, X, kxX);
  const float kdX = k[0] * X[0] + k[1] * X[1] + k[2] * X[2];
  ba_cross(r, X, rxX);
  ba_cross(r, rxX, rxrxX);
  const float rdX = r[0] * X[0] + r[1] * X[1] + r[2] * X[2];

  // Stage 1: RX = R(r) X, R = d(RX)/dX, D = d(RX)/dr.
  float RX[3], R[3][3], D[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float rx_big = cs * X[a] + sn * kxX[a] + one_c * kdX * k[a];
    const float rx_small = X[a] + rxX[a] + 0.5f * rxrxX[a];
    RX[a] = safe ? rx_big : rx_small;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const float e = (a == b) ? 1.0f : 0.0f;
      const float r_big = cs * e + sn * ba_hat(k, a, b) + one_c * k[a] * k[b];
      const float r_small =
          e + ba_hat(r, a, b) + 0.5f * (r[a] * r[b] - th2 * e);
      const float d_big =
          -sn * X[a] * k[b] + cs * kxX[a] * k[b] -
          sn * inv_th * (ba_hat(X, a, b) + kxX[a] * k[b]) +
          sn * kdX * k[a] * k[b] +
          one_c * inv_th * (k[a] * X[b] + kdX * (e - 2.0f * k[a] * k[b]));
      const float d_small =
          -ba_hat(X, a, b) - 0.5f * (ba_hat(rxX, a, b) + X[a] * r[b] - rdX * e);
      R[a][b] = safe ? r_big : r_small;
      D[a][b] = safe ? d_big : d_small;
    }
  }

  // Stage 2: perspective divide p2 = -p1[:2] / z.
  const float p1[3] = {RX[0] + cam.t[0], RX[1] + cam.t[1], RX[2] + cam.t[2]};
  const float z = p1[2];
  const bool z_ok = z != 0.0f;
  const float inv_z = 1.0f / (z_ok ? z : 1.0f);
  const float p2[2] = {-p1[0] * inv_z, -p1[1] * inv_z};

  // Stage 3: radial distortion and focal.
  const float f = cam.f, k1 = cam.k1, k2 = cam.k2;
  const float n2 = p2[0] * p2[0] + p2[1] * p2[1];
  const float rho = 1.0f + k1 * n2 + k2 * n2 * n2;
  const float frho = f * rho;
  const float g = 2.0f * k1 + 4.0f * k2 * n2;
  const float B[2][2] = {
      {f * (rho + g * p2[0] * p2[0]), f * g * p2[0] * p2[1]},
      {f * g * p2[0] * p2[1], f * (rho + g * p2[1] * p2[1])}};
  const float fn2 = f * n2;
  const float inv_z2 = inv_z * inv_z;
  const float valid = z_ok ? w : 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float BA[3] = {-B[i][0] * inv_z, -B[i][1] * inv_z,
                         (B[i][0] * p1[0] + B[i][1] * p1[1]) * inv_z2};
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      Jp[3 * i + b] =
          (BA[0] * R[0][b] + BA[1] * R[1][b] + BA[2] * R[2][b]) * valid;
      Jc[9 * i + b] =
          (BA[0] * D[0][b] + BA[1] * D[1][b] + BA[2] * D[2][b]) * valid;
      Jc[9 * i + 3 + b] = BA[b] * valid;
    }
    Jc[9 * i + 6] = fn2 * p2[i] * valid;
    Jc[9 * i + 7] = fn2 * n2 * p2[i] * valid;
    Jc[9 * i + 8] = rho * p2[i] * valid;
  }
  res[0] = (frho * p2[0] - ox) * valid;
  res[1] = (frho * p2[1] - oy) * valid;
}

// Index of (lo, hi), lo <= hi, in the row-major upper triangle of a 9x9.
__host__ __device__ __forceinline__ int ba_tri9(int lo, int hi) {
  return lo * 9 - (lo * (lo - 1)) / 2 + (hi - lo);
}

// Deterministic block sum of K per-thread values into dst[0..K) (global or
// shared memory): warp shuffles, then warp 0..K partials in a fixed order.
// Every thread of the block must call it (it synchronizes).
template <int K>
__device__ __forceinline__ void ba_block_sum(float (&acc)[K],
                                             float* __restrict__ dst) {
  __shared__ float part[BA_BLOCK / 32][K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < BA_BLOCK / 32; ++i) s += part[i][k];
    dst[k] = s;
  }
}

// Second pass of a two-level reduction: out[s] = sum_i part[s * nparts + i],
// one block per s, deterministic.
static __global__ void ba_sum_rows_kernel(const float* __restrict__ part,
                                          int nparts,
                                          float* __restrict__ out) {
  float acc[1] = {0.0f};
  const float* p = part + (size_t)blockIdx.x * nparts;
  for (int i = threadIdx.x; i < nparts; i += BA_BLOCK) acc[0] += p[i];
  ba_block_sum<1>(acc, out + blockIdx.x);
}

#define BA_RETURN_IF_LAUNCH_FAILED()        \
  do {                                      \
    const cudaError_t e_ = cudaGetLastError(); \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)
