// Device code shared by K2 (cam_reduce.cu), K3's camera pass (matvec.cu)
// and K6's camera products (seg_prod_reduce.cu): per-camera sums of a
// per-row product, in two designs that differ in where a camera's rows
// lie. K5's camera direction (seg_block_reduce.cu) and K6's W C W' column
// ranges (seg_prod_reduce.cu) take their products and run-sum pass.
//
// Camera-sorted copy (K6 cam90: JR_cam_t), ba_launch_cam_prod: one block
// per camera strides over its columns j in [cam_starts[c], cam_starts[c+1])
// (coalesced), then a fixed-order block sum.
//
// Point-sorted rows read through cam_perm (K2, K3: JR_t, W_t),
// ba_launch_cam_tiles, plan `ops/plans.py:TilePlan`: the counterpart of
// the TPU kernels `bundleadjustment_jl_tpu/ops/pallas_schur.py`
// `_cam_scatter_kernel` (`cam_scatter_reduce`, :1109) and the camera pass
// of `_mv_scatter_kernel` (`matvec_cam_scatter`, :1550). Read in camera order,
// each of a row's planes is a 4 or 2 B load at a random row: a 32 B sector
// for each, 8x (f32) to 16x (bf16) the bytes needed, and at Final-4585 W
// (1.0 GB) is far larger than the 50 MB L2. So the rows are read in point
// order instead, in tiles of BA_TILE_ROWS rows:
//
//   pass 1, one block per tile: stage the tile's rows of every plane the
//     product reads (cp.async, 16 B a thread, coalesced) and the per-point
//     operands of the tile's contiguous point range in shared memory; each
//     thread takes one run (a maximal stretch of cam_perm with one camera
//     and one tile), sums its rows in cam_perm order from shared memory,
//     and its warp writes the runs' K sums, 8 runs at a time through
//     shared memory, to rows r (the runs' ids) of a (nruns, K) f32 scratch
//     buffer, consecutive lanes on consecutive floats;
//   pass 2, one block per camera: sum the camera's runs in run order, then
//     a fixed-order block sum.
//
// No atomics: deterministic, and a camera without rows gives exact zeros.
// Traffic: the planes once, coalesced, plus 2 K 4 B a run (written, read).
// Runs per row ~ ncams (1 - exp(-R / ncams)) / R: ~0.95 at Final-4585
// (every run is about one row, whatever R), ~0.53 at Dubrovnik-356. What
// bounds it now: the partials' bytes for the d90 / d81 products (432 B a
// row at Final-4585 against 108 B of W), and for w_op the tile stage, which
// a block loads whole before it sums (overlap comes only from other
// blocks on the SM).
//
// BA_TILE_ROWS = 512 (R), measured on an NVIDIA H100 80GB HBM3 at 700 W by
// `python -m bundleadjustment_jl_tpu_torch.tile_sweep` against 256 and 1024
// (PERF.md): at Final-4585, 512 is the fastest for every W form (w_op
// 0.98 ms against 1.03 at 256 and 1.47 at 1024): a 1024-row tile stages
// 124 KB for w_op in f32, one block an SM, so no block's loads overlap
// another's sums; a 256-row tile makes more runs (0.97 a row against
// 0.95), which the d90 products feel. K3 at Dubrovnik-356 takes 0.21 ms at
// 256 and 512, 0.25 at 1024.
//
// A product is a type with K sums, SYM of them the upper triangle
// (ba_tri9 order) of a symmetric 9x9, written out as all 81, and the
// remaining K - SYM as they are; NPL planes of the row operand (plane(e):
// the source plane of staged plane e); NA + NB floats of per-point operands
// (a: (npnts, NA), b: (npnts, NB), at the row's point); and apply(acc, ld,
// a, b), ld(e) the row's staged plane e widened to float. Each keeps its
// sums in registers. JR is (26, n) structure-of-arrays: rows 0-17 Jc
// (9 i + a), 18-23 Jp, 24-25 r; W is (27, n), row 3 a + b, read in its
// storage type (float, bf16 or f16; w_store.cuh) and widened at the load;
// products and sums are float.
#pragma once

#include <cstdint>

#include "chain.cuh"
#include "w_store.cuh"

// Rows of a K2 tile (ops/plans.py:TILE_ROWS; a plan of another size is
// refused). A multiple of 8, so a tile of 2-byte W is whole 16 B chunks.
constexpr int BA_TILE_ROWS = 512;
// Runs a warp of the tile pass writes out at once (stage: 8 x K floats a
// warp).
constexpr int BA_STAGE_RUNS = 8;

// The plan as ops/_cuda.py:TilePlanC passes it (ops/plans.py:TilePlan).
struct BaTilePlan {
  const int* tile_rows;        // (n,) cam_perm's rows in tile order
  const int* tile_run_starts;  // (ntiles+1,) each tile's runs, tile order
  const int* tile_run_bounds;  // (nruns+1,) each run's span of tile_rows
  const int* tile_runs;        // (nruns,) the run id of each, tile order
  const int* cam_run_starts;   // (ncams+1,) each camera's runs, by id
  int ntiles;
  int rows;                    // R of the plan
};

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

__device__ __forceinline__ void ba_cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void ba_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Shared memory of one pass-1 block: the tile's NPL planes in the storage
// type, then a (R, NA) and b (R, NB) of up to R points.
template <class Prod, class S>
constexpr size_t ba_tile_smem() {
  return (size_t)Prod::NPL * BA_TILE_ROWS * sizeof(S) +
         (size_t)(Prod::NA + Prod::NB) * BA_TILE_ROWS * sizeof(float);
}

// Pass 1: one block per tile; a thread per run (tile order) sums the run's
// rows from shared memory into partial[run id].
template <class Prod, class S>
__global__ void __launch_bounds__(BA_BLOCK) ba_tile_pass_kernel(
    BaRows<S> in, BaTilePlan plan, float* __restrict__ partial) {
  constexpr int K = Prod::K, NPL = Prod::NPL, NA = Prod::NA, NB = Prod::NB;
  constexpr int R = BA_TILE_ROWS, V = 16 / sizeof(S);
  extern __shared__ __align__(16) unsigned char ba_smem[];
  S* sx = reinterpret_cast<S*>(ba_smem);
  float* sa = reinterpret_cast<float*>(ba_smem + (size_t)NPL * R * sizeof(S));
  float* sb = sa + R * NA;
  const int t = blockIdx.x;
  const long long t0 = (long long)t * R;
  const int len = (int)min((long long)R, in.n - t0);

  // Rows [t0, t0 + len) of each plane. 16 B copies need 16 B aligned plane
  // starts; then len is whole chunks too (R and n multiples of V).
  if (in.n % V == 0 && (reinterpret_cast<uintptr_t>(in.x) & 15) == 0) {
    const int nv = len / V;
    for (int i = threadIdx.x; i < NPL * nv; i += BA_BLOCK) {
      const int e = i / nv, c = i - e * nv;
      ba_cp_async16(sx + e * R + c * V,
                    in.x + Prod::plane(e) * in.n + t0 + (long long)c * V);
    }
  } else {
    for (int i = threadIdx.x; i < NPL * len; i += BA_BLOCK) {
      const int e = i / len, c = i - e * len;
      sx[e * R + c] = in.x[Prod::plane(e) * in.n + t0 + c];
    }
  }
  // The per-point operands of the tile's points [p0, p0 + np), staged when
  // they fit (points without rows can make the range longer than R).
  int pbase = 0;
  const float* A = in.a;
  const float* B = in.b;
  if constexpr (NA + NB > 0) {
    const int p0 = in.pnt_idx[t0];
    const int np = in.pnt_idx[t0 + len - 1] + 1 - p0;
    if (np <= R) {
      for (int i = threadIdx.x; i < np * NA; i += BA_BLOCK)
        sa[i] = in.a[(size_t)p0 * NA + i];
      for (int i = threadIdx.x; i < np * NB; i += BA_BLOCK)
        sb[i] = in.b[(size_t)p0 * NB + i];
      pbase = p0;
      A = sa;
      B = sb;
    }
  }
  ba_cp_async_wait_all();
  __syncthreads();

  // A warp writes its runs' sums BA_STAGE_RUNS at a time through shared
  // memory, consecutive lanes on consecutive floats of one run: a thread
  // storing its own K sums would make every store instruction touch 32
  // sectors, and those transactions, not the bytes, bounded the pass.
  __shared__ float stage[BA_BLOCK / 32][BA_STAGE_RUNS * K];
  __shared__ int stage_run[BA_BLOCK / 32][BA_STAGE_RUNS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s_end = plan.tile_run_starts[t + 1];
  for (int s0 = plan.tile_run_starts[t]; s0 < s_end; s0 += BA_BLOCK) {
    const int s = s0 + threadIdx.x;
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.f;
    int run = -1;
    if (s < s_end) {
      run = plan.tile_runs[s];
      const int q1 = plan.tile_run_bounds[s + 1];
      for (int q = plan.tile_run_bounds[s]; q < q1; ++q) {
        const int loc = plan.tile_rows[q] - (int)t0;
        const float* a = nullptr;
        const float* b = nullptr;
        if constexpr (NA + NB > 0) {
          const int p = in.pnt_idx[t0 + loc] - pbase;
          a = A + (size_t)NA * p;
          b = B + (size_t)NB * p;
        }
        Prod::apply(acc, [&](int e) { return ba_ldw(sx, e * R + loc); }, a,
                    b);
      }
    }
    for (int g = 0; g < 32; g += BA_STAGE_RUNS) {
      if (lane >= g && lane < g + BA_STAGE_RUNS) {
        stage_run[warp][lane - g] = run;
#pragma unroll
        for (int k = 0; k < K; ++k)
          stage[warp][(lane - g) * K + k] = acc[k];
      }
      __syncwarp();
      for (int i = lane; i < BA_STAGE_RUNS * K; i += 32) {
        const int j = i / K;
        const int r = stage_run[warp][j];
        if (r >= 0) partial[(size_t)K * r + (i - j * K)] = stage[warp][i];
      }
      __syncwarp();
    }
  }
}

// Pass 2: one block per camera sums its runs' partials in run order.
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

// Both passes on ``stream`` (partial: (nruns, Prod::K) f32 scratch); 0 or
// the CUDA error of a launch.
template <class Prod, class S>
int ba_launch_cam_tiles(const BaRows<S>& in, const BaTilePlan* plan,
                        float* partial, int ncams, float* out,
                        void* stream) {
  if (plan->rows != BA_TILE_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Dynamic and static shared memory together pass 48 KB at most sizes:
  // opt in once per instantiation.
  constexpr size_t smem = ba_tile_smem<Prod, S>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      ba_tile_pass_kernel<Prod, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (plan->ntiles > 0) {
    ba_tile_pass_kernel<Prod, S>
        <<<plan->ntiles, BA_BLOCK, smem, s>>>(in, *plan, partial);
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  if (ncams > 0) {
    ba_run_sum_kernel<Prod>
        <<<ncams, BA_BLOCK, 0, s>>>(partial, plan->cam_run_starts, out);
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
