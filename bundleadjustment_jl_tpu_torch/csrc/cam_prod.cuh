// Device code shared by K2 (cam_reduce.cu, through cam_pass.cuh), K3's
// camera pass (matvec.cu, through cam_pass.cuh) and K6's camera products
// (seg_prod_reduce.cu): the per-row products whose per-camera sums K2 and
// K6 take, and the camera-sorted reduce. K5's camera direction
// (seg_block_reduce.cu) and K6's W C W' column ranges (seg_prod_reduce.cu)
// take their products and the run-sum pass.
//
// Camera-sorted copy (K6 cam90: JR_cam_t), ba_launch_cam_prod: one block
// per camera strides over its columns j in [cam_starts[c], cam_starts[c+1])
// (coalesced), then a fixed-order block sum. The point-sorted rows read in
// point-order tiles (K2, K3) are cam_pass.cuh's.
//
// A product is a type with K sums, SYM of them the upper triangle
// (ba_tri9 order) of a symmetric 9x9, written out as all 81, and the
// remaining K - SYM as they are; NPL planes of the row operand (plane(e):
// the source plane of staged plane e); NA + NB floats of per-point operands
// (a: (npnts, NA), b: (npnts, NB), at the row's point); and apply(acc, ld,
// a, b), ld(e) the row's plane e widened to float. Each keeps its sums in
// registers. JR is (26, n) structure-of-arrays: rows 0-17 Jc (9 i + a),
// 18-23 Jp, 24-25 r; W is (27, n), row 3 a + b, read in its storage type
// (float, bf16 or f16; w_store.cuh) and widened at the load; products and
// sums are float.
#pragma once

#include "chain.cuh"
#include "w_store.cuh"

// A product's operands: planes x (NPL used of them, (., n)) and the
// per-point a (npnts, NA) and b (npnts, NB) at pnt_idx[row].
template <class S>
struct BaRows {
  const S* x;
  long long n;
  const int* pnt_idx;
  const float* a;
  const float* b;
};

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

template <class Ld>
__device__ __forceinline__ void ba_load_w(Ld ld, float (&Wr)[27]) {
#pragma unroll
  for (int e = 0; e < 27; ++e) Wr[e] = ld(e);
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

// [Jc'Jc upper (45) | Jc'r (9)] over JR (`_prod_cam90`): planes Jc 0-17
// and r 24-25.
struct ProdCam90 {
  static constexpr int K = 54, SYM = 45, NPL = 20, NA = 0, NB = 0;
  __host__ __device__ static constexpr int plane(int e) {
    return e < 18 ? e : e + 6;
  }
  template <class Ld>
  __device__ static void apply(float (&acc)[K], Ld ld, const float*,
                               const float*) {
    float Jc[18];
#pragma unroll
    for (int k = 0; k < 18; ++k) Jc[k] = ld(k);
    const float r0 = ld(18), r1 = ld(19);
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

// W C W' upper (45), C = Hpp_inv (a) of the row's point (`_prod_wcw`).
struct ProdWcw81 {
  static constexpr int K = 45, SYM = 45, NPL = 27, NA = 9, NB = 0;
  __host__ __device__ static constexpr int plane(int e) { return e; }
  template <class Ld>
  __device__ static void apply(float (&acc)[K], Ld ld, const float* a,
                               const float*) {
    float Wr[27], Y[9][3];
    ba_load_w(ld, Wr);
    ba_wc(Wr, a, Y);
    ba_add_wcw(acc, Y, Wr);
  }
};

// [W C W' upper (45) | W t (9)], C = Hpp_inv (a), t = Hpp_inv g_p (b) of
// the row's point (`_prod_wcw_rhs`).
struct ProdWcwRhs {
  static constexpr int K = 54, SYM = 45, NPL = 27, NA = 9, NB = 3;
  __host__ __device__ static constexpr int plane(int e) { return e; }
  template <class Ld>
  __device__ static void apply(float (&acc)[K], Ld ld, const float* a,
                               const float* b) {
    float Wr[27], Y[9][3];
    ba_load_w(ld, Wr);
    ba_wc(Wr, a, Y);
    ba_add_wcw(acc, Y, Wr);
    ba_add_wt(acc + 45, Wr, b);
  }
};

// W op (9), op (a) a per-point 3-vector (`_prod_w_op`).
struct ProdWOp {
  static constexpr int K = 9, SYM = 0, NPL = 27, NA = 3, NB = 0;
  __host__ __device__ static constexpr int plane(int e) { return e; }
  template <class Ld>
  __device__ static void apply(float (&acc)[K], Ld ld, const float* a,
                               const float*) {
    float Wr[27];
    ba_load_w(ld, Wr);
    ba_add_wt(acc, Wr, a);
  }
};

// Camera c's output row from the K block sums: [the symmetric 9x9 from
// the SYM upper sums (81, when SYM = 45) | the remaining K - SYM sums].
template <int K, int SYM>
__device__ __forceinline__ void ba_cam_out(const float* tot,
                                           float* __restrict__ out) {
  constexpr int D_OUT = (SYM ? 81 : 0) + (K - SYM);
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
    out[k] = v;
  }
}

template <class Prod>
__host__ __device__ constexpr int ba_d_out() {
  return (Prod::SYM ? 81 : 0) + (Prod::K - Prod::SYM);
}

// Camera-sorted copy: one block per camera over its columns (a product
// without per-point operands).
template <class Prod, class S>
__global__ void __launch_bounds__(BA_BLOCK) ba_cam_prod_kernel(
    BaRows<S> in, const int* __restrict__ cam_starts,
    float* __restrict__ out) {
  constexpr int K = Prod::K;
  static_assert(Prod::NA + Prod::NB == 0, "no per-point operands");
  const int c = blockIdx.x;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  const int end = cam_starts[c + 1];
  for (int j = cam_starts[c] + threadIdx.x; j < end; j += BA_BLOCK)
    Prod::apply(
        acc, [&](int e) { return ba_ldw(in.x, Prod::plane(e) * in.n + j); },
        nullptr, nullptr);
  __shared__ float tot[K];
  ba_block_sum<K>(acc, tot);
  __syncthreads();
  ba_cam_out<K, Prod::SYM>(tot, out + ba_d_out<Prod>() * (size_t)c);
}

// The second pass of a run-partial design (K5's camera direction): one
// block per camera sums its runs' partials in run order.
template <class Prod>
__global__ void __launch_bounds__(BA_BLOCK) ba_run_sum_kernel(
    const float* __restrict__ partial, const int* __restrict__ cam_run_starts,
    float* __restrict__ out) {
  constexpr int K = Prod::K;
  const int c = blockIdx.x;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  const int end = cam_run_starts[c + 1];
  for (int r = cam_run_starts[c] + threadIdx.x; r < end; r += BA_BLOCK) {
    const float* p = partial + (size_t)K * r;
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] += p[k];
  }
  __shared__ float tot[K];
  ba_block_sum<K>(acc, tot);
  __syncthreads();
  ba_cam_out<K, Prod::SYM>(tot, out + ba_d_out<Prod>() * (size_t)c);
}

// Launch on ``stream``; 0 or the CUDA error of the launch.
template <class Prod, class S>
int ba_launch_cam_prod(const BaRows<S>& in, const int* cam_starts, int ncams,
                       float* out, void* stream) {
  if (ncams > 0) {
    ba_cam_prod_kernel<Prod, S>
        <<<ncams, BA_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            in, cam_starts, out);
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}

// f(BaRows<T>{W, n, pnt_idx, a, b}) for the storage type T of ``w_dtype``.
template <class F>
int ba_with_w_rows(const void* W, int w_dtype, long long n,
                   const int* pnt_idx, const float* a, const float* b,
                   F&& f) {
  return ba_with_w_type(w_dtype, [&](auto tag) {
    using T = BA_W_TYPE(tag);
    return f(BaRows<T>{static_cast<const T*>(W), n, pnt_idx, a, b});
  });
}

}  // namespace
