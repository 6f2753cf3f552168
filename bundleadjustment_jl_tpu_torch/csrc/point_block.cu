// The Schur elimination's per-point 3x3 block work (no TPU kernel: the JAX
// package leaves it to XLA, `ops/normal.py:inv3x3_damped_flat` and the
// `einsum`s of `ops/schur.py`). Two kernels over the flat point blocks
// Hpp_f (npnts*9, row-major 3a+b) and a per-point 3-vector (npnts*3):
//
//   ba_point_inv_kernel (stage 2, once an iteration):
//     Hpp_inv = adj(Hpp + lam I) / det, or where det is not finite or not
//     above 8 tiny the inverse of the clamped damped diagonal; hatted by
//     1 / s^2 with a float16 W's range scale s; and Hpp_inv (s g_p), the
//     operand of K2 W C W' | W t and of the reduced right-hand side.
//   ba_point_quad_kernel (stage 5, once an iteration):
//     sum_p dp_p . (Hpp_p dp_p), the point term of ||J d||^2.
//
// Added because PyTorch ran this work as a batched cuBLAS gemv and ~25
// element-wise ops plus a 9-column torch.stack: ~104 ms of a ~414 ms
// Final-13682 solve, ~60x its bound (PERF.md, section 5).
//
// Bound: bytes. At Final-13682 (4,456,117 points) the inverse reads Hpp
// and g_p and writes Hpp_inv and the product, 428 MB (0.128 ms at 3.35
// TB/s); the product-sum reads Hpp and dp, 214 MB (0.064 ms).
//
// Design: a block of BA_BLOCK threads takes BA_PB_POINTS consecutive
// points, one a thread. One point's 36-byte row is not 16-byte aligned, so
// a thread-per-point gather would not coalesce: the block stages its
// contiguous range of Hpp and of the 3-vectors through shared memory with
// 16-byte loads (the range starts on a multiple of 4 floats), each thread
// computes its point from shared memory (odd strides 9 and 3: no bank
// conflicts) and writes its results back in place, and the block stores
// the range with 16-byte stores. The last block masks the ragged tail.
//
// The inverse is the plain twin's arithmetic operation for operation, each
// rounded as it is (__fmul_rn / __fsub_rn / __fadd_rn: no contraction into
// FMAs; IEEE reciprocals, as torch's `1.0 / x`), so it equals the twin's
// float32 inverse bit for bit. In a 2-byte working dtype (code `rnd`, 1
// bfloat16, 2 float16) the twin rounds the inverse, the hat and the
// product's factors to that dtype: so does the kernel.
//
// A 3x3 block times a vector takes the order of the twin's einsum (a
// cuBLAS batched gemv): fma(m1, x1, m0 x0) + m2 x2, each row. On an H100
// (CUDA 12.8) that gives the einsum's bits for all 13.4M products at
// Final-13682 (of 18 orders tried, the only one; 84% for the unfused left
// to right sum), so the solve makes the twin's decisions in stage 2.
//
// The product-sum adds each block's points in a fixed order
// (ba_block_sum) into a partial a block, then one block adds the partials
// in a fixed order: no atomics, so repeats are bit-identical.
#include <cfloat>

#include "chain.cuh"
#include "w_store.cuh"

// Points a block: one a thread.
constexpr int BA_PB_POINTS = BA_BLOCK;

static_assert(BA_PB_POINTS % 4 == 0, "a block's range starts 16-byte aligned");

namespace {

// v rounded to the working dtype of code `rnd` (0: float32, itself).
__device__ __forceinline__ float ba_round(float v, int rnd) {
  if (rnd == 1) return __bfloat162float(__float2bfloat16_rn(v));
  if (rnd == 2) return __half2float(__float2half_rn(v));
  return v;
}

// The range scale s, stored as W_CODES `code`.
__device__ __forceinline__ float ba_load_scale(const void* p, int code) {
  if (code == 1) return ba_ldw(static_cast<const __nv_bfloat16*>(p), 0);
  if (code == 2) return ba_ldw(static_cast<const __half*>(p), 0);
  return ba_ldw(static_cast<const float*>(p), 0);
}

// Copy n floats from src + start to the block's shared s, 16 bytes a load
// where `vec` (src + start 16-byte aligned), the remainder one by one.
__device__ __forceinline__ void ba_stage_in(const float* __restrict__ src,
                                            long long start, int n,
                                            float* __restrict__ s, int vec) {
  int done = 0;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src + start);
    float4* d4 = reinterpret_cast<float4*>(s);
    done = n & ~3;
    for (int i = threadIdx.x; i < (n >> 2); i += BA_BLOCK) d4[i] = s4[i];
  }
  for (int i = done + threadIdx.x; i < n; i += BA_BLOCK) s[i] = src[start + i];
}

// The reverse of ba_stage_in: the block's shared s to dst + start.
__device__ __forceinline__ void ba_stage_out(float* __restrict__ dst,
                                             long long start, int n,
                                             const float* __restrict__ s,
                                             int vec) {
  int done = 0;
  if (vec) {
    float4* d4 = reinterpret_cast<float4*>(dst + start);
    const float4* s4 = reinterpret_cast<const float4*>(s);
    done = n & ~3;
    for (int i = threadIdx.x; i < (n >> 2); i += BA_BLOCK) d4[i] = s4[i];
  }
  for (int i = done + threadIdx.x; i < n; i += BA_BLOCK) dst[start + i] = s[i];
}

// Row k of the block m (9, row-major) times x, in the twin's order.
__device__ __forceinline__ float ba_row_dot(const float* m, const float* x,
                                            int k) {
  return __fadd_rn(fmaf(m[3 * k + 1], x[1], __fmul_rn(m[3 * k], x[0])),
                   __fmul_rn(m[3 * k + 2], x[2]));
}

// Not inf and not NaN.
__device__ __forceinline__ bool ba_finite(float x) {
  return fabsf(x) <= FLT_MAX;
}

// The damped inverse of one block m (9, row-major) into m, as
// `inv3x3_damped_flat` computes it in float32 (its `1.0 / x` is an IEEE
// reciprocal: __frcp_rn).
__device__ __forceinline__ void ba_inv3x3_damped(float* m, float lam) {
  const float tiny8 = 8.0f * FLT_MIN;
  const float a = __fadd_rn(m[0], lam), b = m[1], c = m[2];
  const float d = m[3], e = __fadd_rn(m[4], lam), f = m[5];
  const float g = m[6], h = m[7], i = __fadd_rn(m[8], lam);
  const float adj[9] = {
      __fsub_rn(__fmul_rn(e, i), __fmul_rn(f, h)),
      __fsub_rn(__fmul_rn(c, h), __fmul_rn(b, i)),
      __fsub_rn(__fmul_rn(b, f), __fmul_rn(c, e)),
      __fsub_rn(__fmul_rn(f, g), __fmul_rn(d, i)),
      __fsub_rn(__fmul_rn(a, i), __fmul_rn(c, g)),
      __fsub_rn(__fmul_rn(c, d), __fmul_rn(a, f)),
      __fsub_rn(__fmul_rn(d, h), __fmul_rn(e, g)),
      __fsub_rn(__fmul_rn(b, g), __fmul_rn(a, h)),
      __fsub_rn(__fmul_rn(a, e), __fmul_rn(b, d))};
  const float det = __fadd_rn(
      __fadd_rn(__fmul_rn(a, adj[0]), __fmul_rn(b, adj[3])),
      __fmul_rn(c, adj[6]));
  const bool ok = ba_finite(det) && det > tiny8;
  if (ok) {
    const float inv_det = __frcp_rn(det);
#pragma unroll
    for (int k = 0; k < 9; ++k) m[k] = __fmul_rn(adj[k], inv_det);
  } else {
    const float diag[3] = {a, e, i};
#pragma unroll
    for (int k = 0; k < 9; ++k) m[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      m[4 * k] = __frcp_rn(fmaxf(ba_finite(diag[k]) ? diag[k] : 0.0f, tiny8));
  }
}

__global__ void __launch_bounds__(BA_BLOCK) ba_point_inv_kernel(
    const float* __restrict__ hpp, const float* __restrict__ gp, float lam,
    const void* __restrict__ scale, int scale_code, int rnd, long long npnts,
    int vec, float* __restrict__ hinv, float* __restrict__ prod) {
  __shared__ __align__(16) float sh[12 * BA_PB_POINTS];
  float* sh_m = sh;
  float* sh_v = sh + 9 * BA_PB_POINTS;
  const long long p0 = (long long)blockIdx.x * BA_PB_POINTS;
  const int np = (int)min((long long)BA_PB_POINTS, npnts - p0);
  ba_stage_in(hpp, 9 * p0, 9 * np, sh_m, vec);
  ba_stage_in(gp, 3 * p0, 3 * np, sh_v, vec);
  __syncthreads();
  if ((int)threadIdx.x < np) {
    float* m = sh_m + 9 * threadIdx.x;
    float* v = sh_v + 3 * threadIdx.x;
    ba_inv3x3_damped(m, lam);
#pragma unroll
    for (int k = 0; k < 9; ++k) m[k] = ba_round(m[k], rnd);
    float x[3] = {v[0], v[1], v[2]};
    if (scale != nullptr) {
      // Hpp_inv / square(s) and g_p * s, each in the working dtype, the
      // square in the scale's own dtype (torch's type promotion).
      const float s = ba_load_scale(scale, scale_code);
      const float s2 = ba_round(ba_round(__fmul_rn(s, s), scale_code), rnd);
      const float sw = ba_round(s, rnd);
#pragma unroll
      for (int k = 0; k < 9; ++k) m[k] = ba_round(__fdiv_rn(m[k], s2), rnd);
#pragma unroll
      for (int k = 0; k < 3; ++k) x[k] = ba_round(__fmul_rn(x[k], sw), rnd);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = ba_row_dot(m, x, k);
  }
  __syncthreads();
  ba_stage_out(hinv, 9 * p0, 9 * np, sh_m, vec);
  ba_stage_out(prod, 3 * p0, 3 * np, sh_v, vec);
}

__global__ void __launch_bounds__(BA_BLOCK) ba_point_quad_kernel(
    const float* __restrict__ hpp, const float* __restrict__ dp, int rnd,
    long long npnts, int vec, float* __restrict__ part) {
  __shared__ __align__(16) float sh[12 * BA_PB_POINTS];
  float* sh_m = sh;
  float* sh_v = sh + 9 * BA_PB_POINTS;
  const long long p0 = (long long)blockIdx.x * BA_PB_POINTS;
  const int np = (int)min((long long)BA_PB_POINTS, npnts - p0);
  ba_stage_in(hpp, 9 * p0, 9 * np, sh_m, vec);
  ba_stage_in(dp, 3 * p0, 3 * np, sh_v, vec);
  __syncthreads();
  float acc[1] = {0.0f};
  if ((int)threadIdx.x < np) {
    const float* m = sh_m + 9 * threadIdx.x;
    const float* v = sh_v + 3 * threadIdx.x;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      acc[0] += ba_round(__fmul_rn(v[k], ba_round(ba_row_dot(m, v, k), rnd)),
                         rnd);
  }
  ba_block_sum<1>(acc, part + blockIdx.x);
}

}  // namespace

// Blocks (and partials of ba_point_quad) for npnts points.
extern "C" long long ba_point_blocks(long long npnts) {
  return (npnts + BA_PB_POINTS - 1) / BA_PB_POINTS;
}

// hpp (npnts*9,), gp (npnts*3,); scale: null or one value stored as
// W_CODES scale_code; rnd: W_CODES of the working dtype the results are
// rounded to (the operands are float32 either way); vec: every pointer
// 16-byte aligned. Writes hinv (npnts*9,) and prod (npnts*3,).
extern "C" int ba_point_inv(const float* hpp, const float* gp, float lam,
                            const void* scale, int scale_code, int rnd,
                            long long npnts, int vec, float* hinv,
                            float* prod, void* stream) {
  if (rnd < 0 || rnd > 2 || scale_code < 0 || scale_code > 2)
    return (int)cudaErrorInvalidValue;
  const long long nb = ba_point_blocks(npnts);
  if (nb == 0) return 0;
  ba_point_inv_kernel<<<(unsigned)nb, BA_BLOCK, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      hpp, gp, lam, scale, scale_code, rnd, npnts, vec, hinv, prod);
  BA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// hpp (npnts*9,), dp (npnts*3,); part (ba_point_blocks(npnts),) scratch;
// out (1,): sum_p dp_p . (Hpp_p dp_p).
extern "C" int ba_point_quad(const float* hpp, const float* dp, int rnd,
                             long long npnts, int vec, float* part,
                             float* out, void* stream) {
  if (rnd < 0 || rnd > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = ba_point_blocks(npnts);
  if (nb > 0) {
    ba_point_quad_kernel<<<(unsigned)nb, BA_BLOCK, 0, s>>>(hpp, dp, rnd,
                                                          npnts, vec, part);
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  ba_sum_rows_kernel<<<1, BA_BLOCK, 0, s>>>(part, (int)nb, out);
  BA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}
