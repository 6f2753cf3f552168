// Device code shared by K2 (cam_reduce.cu), K6's camera products
// (seg_prod_reduce.cu), K5's camera direction (seg_block_reduce.cu) and
// K3's camera pass (matvec.cu): per-camera sums of a per-row product, one
// block per camera over that camera's rows, then a fixed-order block sum.
//
// A camera's rows are the columns j in [cam_starts[c], cam_starts[c+1]) of
// the camera order; row = cam_perm[j] is the point-sorted row behind column
// j. The kernels differ only in where a column's values lie:
//
//   K6, K5 (kPermuted = false): the operand is a camera-sorted copy
//       (JR_cam_t, W_cam_t), so column j is read at position j
//       (coalesced);
//   K2, K3 (kPermuted = true): the operand is point-sorted (JR_t, W_t), so
//       column j is read at position row (gathered through cam_perm).
//
// A per-point operand (Hpp_inv, t, op) is read at pnt_idx[row] either way.
// JR is (26, n) structure-of-arrays: rows 0-17 Jc (9 i + a), 18-23 Jp,
// 24-25 r; W is (27, n), row 3 a + b.
//
// W is read in its storage type T (float, bf16 or f16; w_store.cuh) and
// widened at the load; products and sums are float.
//
// Each product keeps its sums in registers: SYM of them are the upper
// triangle (ba_tri9 order) of a symmetric 9x9, written out as all 81, and
// the remaining K - SYM are written as they are. No atomics: deterministic,
// and a camera without rows gives exact zeros.
#pragma once

#include "chain.cuh"
#include "w_store.cuh"

namespace {

// Y = W C for a row's 9x3 W (Wr[3 a + b]) and the point's symmetric C,
// read as the packed upper triangle of its 3x3 (the TPU kernel's sym6).
__device__ __forceinline__ void ba_wc(const float (&Wr)[27],
                                      const float* __restrict__ h,
                                      float (&Y)[9][3]) {
  const float C[3][3] = {{h[0], h[1], h[2]},
                         {h[1], h[4], h[5]},
                         {h[2], h[5], h[8]}};
#pragma unroll
  for (int a = 0; a < 9; ++a)
#pragma unroll
    for (int cc = 0; cc < 3; ++cc)
      Y[a][cc] = Wr[3 * a] * C[0][cc] + Wr[3 * a + 1] * C[1][cc] +
                 Wr[3 * a + 2] * C[2][cc];
}

template <int K, class T>
__device__ __forceinline__ void ba_load_w(const T* __restrict__ W,
                                          long long n, long long col,
                                          float (&Wr)[K]) {
#pragma unroll
  for (int e = 0; e < K; ++e) Wr[e] = ba_ldw(W, e * n + col);
}

// acc[0..45) += upper triangle of (W C) W'.
__device__ __forceinline__ void ba_add_wcw(float* acc, const float (&Y)[9][3],
                                           const float (&Wr)[27]) {
  int q = 0;
#pragma unroll
  for (int a = 0; a < 9; ++a)
#pragma unroll
    for (int d = a; d < 9; ++d)
      acc[q++] += Y[a][0] * Wr[3 * d] + Y[a][1] * Wr[3 * d + 1] +
                  Y[a][2] * Wr[3 * d + 2];
}

// acc[0..9) += W t, t a point's 3-vector.
__device__ __forceinline__ void ba_add_wt(float* acc, const float (&Wr)[27],
                                          const float* __restrict__ t) {
  const float tp[3] = {t[0], t[1], t[2]};
#pragma unroll
  for (int a = 0; a < 9; ++a)
    acc[a] += Wr[3 * a] * tp[0] + Wr[3 * a + 1] * tp[1] +
              Wr[3 * a + 2] * tp[2];
}

// [Jc'Jc upper (45) | Jc'r (9)] (`_prod_cam90`).
struct ProdCam90 {
  static constexpr int K = 54, SYM = 45;
  const float* JR;
  long long n;
  __device__ __forceinline__ void add(float (&acc)[K], long long col,
                                      int /*row*/) const {
    float Jc[18];
#pragma unroll
    for (int k = 0; k < 18; ++k) Jc[k] = JR[k * n + col];
    const float r0 = JR[24 * n + col], r1 = JR[25 * n + col];
    int q = 0;
#pragma unroll
    for (int a = 0; a < 9; ++a) {
#pragma unroll
      for (int d = a; d < 9; ++d)
        acc[q++] += Jc[a] * Jc[d] + Jc[9 + a] * Jc[9 + d];
      acc[45 + a] += Jc[a] * r0 + Jc[9 + a] * r1;
    }
  }
};

// W C W' upper (45), C = Hpp_inv of the row's point (`_prod_wcw`).
template <class T>
struct ProdWcw81 {
  static constexpr int K = 45, SYM = 45;
  const T* W;
  const int* pnt_idx;
  const float* hpp_inv;
  long long n;
  __device__ __forceinline__ void add(float (&acc)[K], long long col,
                                      int row) const {
    float Wr[27], Y[9][3];
    ba_load_w(W, n, col, Wr);
    ba_wc(Wr, hpp_inv + 9 * (size_t)pnt_idx[row], Y);
    ba_add_wcw(acc, Y, Wr);
  }
};

// [W C W' upper (45) | W t (9)], C = Hpp_inv, t = Hpp_inv g_p of the row's
// point (`_prod_wcw_rhs`).
template <class T>
struct ProdWcwRhs {
  static constexpr int K = 54, SYM = 45;
  const T* W;
  const int* pnt_idx;
  const float* hpp_inv;
  const float* t;
  long long n;
  __device__ __forceinline__ void add(float (&acc)[K], long long col,
                                      int row) const {
    const int p = pnt_idx[row];
    float Wr[27], Y[9][3];
    ba_load_w(W, n, col, Wr);
    ba_wc(Wr, hpp_inv + 9 * (size_t)p, Y);
    ba_add_wcw(acc, Y, Wr);
    ba_add_wt(acc + 45, Wr, t + 3 * (size_t)p);
  }
};

// W op (9), op a per-point 3-vector (`_prod_w_op`).
template <class T>
struct ProdWOp {
  static constexpr int K = 9, SYM = 0;
  const T* W;
  const int* pnt_idx;
  const float* op;
  long long n;
  __device__ __forceinline__ void add(float (&acc)[K], long long col,
                                      int row) const {
    float Wr[27];
    ba_load_w(W, n, col, Wr);
    ba_add_wt(acc, Wr, op + 3 * (size_t)pnt_idx[row]);
  }
};

// One block per camera: out row c = [the symmetric 9x9 from the SYM upper
// sums (81, when SYM = 45) | the remaining K - SYM sums].
template <class Prod, bool kPermuted>
__global__ void __launch_bounds__(BA_BLOCK) ba_cam_prod_kernel(
    Prod prod, const int* __restrict__ cam_perm,
    const int* __restrict__ cam_starts, float* __restrict__ out) {
  constexpr int K = Prod::K, SYM = Prod::SYM;
  constexpr int D_OUT = (SYM ? 81 : 0) + (K - SYM);
  const int c = blockIdx.x;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  const int end = cam_starts[c + 1];
  for (int j = cam_starts[c] + threadIdx.x; j < end; j += BA_BLOCK) {
    const int row = cam_perm[j];
    prod.add(acc, kPermuted ? (long long)row : (long long)j, row);
  }
  __shared__ float tot[K];
  ba_block_sum<K>(acc, tot);
  __syncthreads();
  for (int k = threadIdx.x; k < D_OUT; k += BA_BLOCK) {
    float v;
    if constexpr (SYM == 0) {
      v = tot[k];
    } else if (k < 81) {
      const int a = k / 9, d = k % 9;
      v = tot[a <= d ? ba_tri9(a, d) : ba_tri9(d, a)];
    } else {
      v = tot[SYM + (k - 81)];
    }
    out[D_OUT * (size_t)c + k] = v;
  }
}

// Launch on ``stream``; 0 or the CUDA error of the launch.
template <bool kPermuted, class Prod>
int ba_launch_cam_prod(const Prod& prod, const int* cam_perm,
                       const int* cam_starts, int ncams, float* out,
                       void* stream) {
  if (ncams > 0) {
    ba_cam_prod_kernel<Prod, kPermuted>
        <<<ncams, BA_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            prod, cam_perm, cam_starts, out);
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}

// ba_launch_cam_prod of Prod<T>{W, args...} for the storage type T of
// ``w_dtype``.
template <bool kPermuted, template <class> class Prod, class... Args>
int ba_launch_w_prod(const void* W, int w_dtype, const int* cam_perm,
                     const int* cam_starts, int ncams, float* out,
                     void* stream, Args... args) {
  return ba_with_w_type(w_dtype, [&](auto tag) {
    using T = BA_W_TYPE(tag);
    return ba_launch_cam_prod<kPermuted>(
        Prod<T>{static_cast<const T*>(W), args...}, cam_perm, cam_starts,
        ncams, out, stream);
  });
}

}  // namespace
