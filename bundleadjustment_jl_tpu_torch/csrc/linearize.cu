// Kernel K7: the linearization, one observation row per thread; and K8,
// its W-only form over the camera order.
//
// K7 replaces the TPU kernel `bundleadjustment_jl_tpu/ops/pallas_linearize.py`
// `_linearize_kernel` (dispatched by `linearize_w_kminor`). Per row it runs
// the chain (`linearize_chain`, chain.cuh) and writes
//
//   JR (26, n): rows 0-17 Jc (9 i + a), 18-23 Jp (18 + 3 i + b),
//               24-25 the weighted residual
//   W  (27, n): row 3 a + b = sum_i Jc[9 i + a] Jp[3 i + b]
//
// the JAX package's `JR_t[:26]` and `W_t[:27]`. Padding rows (w = 0) and
// rows with z = 0 give exact zeros through the chain's `valid` factor.
//
// K8 replaces `_linearize_w_only_kernel` (dispatched by `linearize_w_only`):
// the camera-sorted W of the huge-n route with camera scatter off,
// W_cam (27, n) with column j = W of row cam_perm[j], re-linearized rather
// than permuted. The same chain on the same row gives the same values as
// K7's W[:, cam_perm]. The TPU side builds camera-sorted (16, n) operand
// copies in two half slices first. Here the problem's row data come in
// camera order from a plan built once per problem (`ops/plans.py`
// CamRowPlan: pt2d[cam_perm], w[cam_perm], cam_idx[cam_perm] and
// pnt_idx[cam_perm]), so every per-row field is a coalesced read (20 B a
// row). An earlier K8 read them through cam_perm: four loads at a random
// row (a 32 B sector each for 4-8 B) behind the cam_perm load, then the
// camera and point behind those; at Final-4585 the row arrays (37-74 MB)
// miss the 50 MB L2, and it ran at 0.27 of its bound (PERF.md, K8).
//
// Design: structure-of-arrays output, so the 32 threads of a warp store
// 32 neighbouring values of each plane; the camera and point of a row are
// gathered loads (9 + 3 floats: a warp's columns are almost always one
// camera, and the points, 16 MB at Final-4585, stay in L2). A K8 thread
// takes one column: two a thread, so that a 2-byte W stores 4 B a plane,
// measured slower (PERF.md, K8).
//
// W is stored as float, bf16 or f16 (w_store.cuh; the TPU kernels'
// `w_dtype`): computed in float, rounded once at the store. JR stays
// float.
//
// Bound: K7 writes 53 floats = 212 B a row in f32 (288 MB at
// Dubrovnik-356, n = 1,360,384; 158 B a row with a 2-byte W) and reads
// ~32 B of problem data; ~300 FLOP a row. K8 writes 108 B a row in f32,
// 54 B in bf16 / f16 (1.0 / 0.5 GB at Final-4585), and reads 20 B a row
// of the plan plus the gathered camera and point: the bytes bound both.
//
// K2 cam90 past shared memory (ba_cam_relin_cam90_kernel) stands in for
// `bundleadjustment_jl_tpu/ops/pallas_schur.py` `_cam_scatter_kernel`
// with `_prod_cam90` (`cam_scatter_reduce`, :1109) where the (ncams, 54)
// camera sums do not fit a block's shared memory (ops/plans.py
// cam_pass_path: "records"): [Jc'Jc (81) | Jc'r (9)] a camera, [Hcc | g_c]
// of the split assembly. The records path (cam_pass.cuh) read K7's 20 JR
// planes and wrote them out again as 96 B row records (2.78 GB at
// Final-13682), then gathered them a block a camera. Here the rows' inputs
// are read instead of K7's output: one block a camera walks the camera's
// rows in camera order from the plan's copies (pt2d, w and the point of
// each column: 16 B a row, coalesced), gathers the point, runs K7's chain
// (ba_linearize) for the row's Jc and r and adds ProdCam90 in registers;
// nothing is written a row. The walk is the records path's (thread t takes
// columns cam_starts[c] + t + k BA_BLOCK in order k, then ba_block_sum),
// and the chain compiles to K7's bits (see the kernel), so [Hcc | g_c] is
// bit-identical to the records path's. A thread loads the next column's
// row data and point while the current column's chain runs, and two
// blocks share an SM.
// Bound: 16 B a row of the plan plus the points (53 MB at Final-13682)
// once, 265 + 216 operations a row (the chain's Jc and r, bench.py): the
// operations bind (0.21 ms at Final-13682, 13.9 GFLOP).
//
// K2 W C W' | W t on route B1 (ba_cam_relin_wcw_rhs_kernel) stands in for the
// same TPU kernel with `_prod_wcw_rhs`, once an LM iteration: [sum W C W' (81)
// | sum W t (9)] a camera, C = Hpp_inv and t = Hpp_inv g_p of the row's point.
// The records path read K7's 27 W planes and wrote them out as 64 B row
// records (1.86 GB a call at Final-13682 in bf16), then gathered them a block
// a camera with Hpp_inv and t by point. Here the walk above re-runs
// K7's chain a column for Jc and Jp, forms W = Jc' Jp as K7 does, rounds
// it to W's storage type as K7 stores it (w_store.cuh; a float16 W times
// its range scale first, as the solver scales K7's float32 W) and adds
// ProdWcwRhs at the point's Hpp_inv and t; nothing is written a row. The
// order is the records path's, so the sums are bit-identical to it over
// K7's W. The per-point operands are read packed, [X | Hpp_inv | t] in
// one 64 B record a point (a pass before the walk, in the same call), so
// that a column gathers two 32 B sectors for them (from the three arrays
// as they are, ~5: 1.8x as long at Final-13682; PERF.md).
// Bound: the plan's 16 B a row, the state, Hpp_inv and t once; 300 + 81
// + 459 operations a row (the chain, W, the product, bench.py): the
// operations bind (0.39 ms at Final-13682, 26.2 GFLOP).
#include "cam_prod.cuh"
#include "chain.cuh"
#include "w_store.cuh"

namespace {

template <class T>
__global__ void ba_linearize_kernel(
    const float* __restrict__ cams, const float* __restrict__ points,
    const float* __restrict__ pt2d, const float* __restrict__ w,
    const int* __restrict__ cam_idx, const int* __restrict__ pnt_idx,
    long long n, float* __restrict__ JR, T* __restrict__ W) {
  const long long row = (long long)blockIdx.x * BA_BLOCK + threadIdx.x;
  if (row >= n) return;
  const BaCam cam = ba_load_cam(cams + 9 * cam_idx[row]);
  const float* x = points + 3 * pnt_idx[row];
  const float X[3] = {x[0], x[1], x[2]};
  float Jc[18], Jp[6], res[2];
  ba_linearize(cam, X, pt2d[2 * row], pt2d[2 * row + 1], w[row], Jc, Jp,
               res);
#pragma unroll
  for (int k = 0; k < 18; ++k) JR[k * n + row] = Jc[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) JR[(18 + k) * n + row] = Jp[k];
  JR[24 * n + row] = res[0];
  JR[25 * n + row] = res[1];
#pragma unroll
  for (int a = 0; a < 9; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      ba_stw(W, (3 * a + b) * n + row,
             Jc[a] * Jp[b] + Jc[9 + a] * Jp[3 + b]);
}

// K8's row data in camera order (ops/plans.py:CamRowPlan).
struct BaCamRows {
  const float* pt2d;   // (n, 2) pt2d[cam_perm]
  const float* w;      // (n,) w[cam_perm]
  const int* cam;      // (n,) cam_idx[cam_perm]
  const int* pnt;      // (n,) pnt_idx[cam_perm]
};

// A thread per camera-order column j: the chain at its camera and point,
// its row data read coalesced.
template <class T>
__global__ void __launch_bounds__(BA_BLOCK) ba_linearize_w_only_kernel(
    const float* __restrict__ cams, const float* __restrict__ points,
    BaCamRows rows, long long n, T* __restrict__ W_cam) {
  const long long j = (long long)blockIdx.x * BA_BLOCK + threadIdx.x;
  if (j >= n) return;
  const BaCam cam = ba_load_cam(cams + 9 * rows.cam[j]);
  const float* x = points + 3 * rows.pnt[j];
  const float X[3] = {x[0], x[1], x[2]};
  const float2 o = reinterpret_cast<const float2*>(rows.pt2d)[j];
  float Jc[18], Jp[6], res[2];
  ba_linearize(cam, X, o.x, o.y, rows.w[j], Jc, Jp, res);
#pragma unroll
  for (int a = 0; a < 9; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      ba_stw(W_cam, (3 * a + b) * n + j,
             Jc[a] * Jp[b] + Jc[9 + a] * Jp[3 + b]);
}

// Blocks an SM must hold at once (__launch_bounds__): 2 caps the
// registers at 128 a thread (none spilled), so that two blocks' loads and
// chains overlap (1: ~140 registers, one block an SM, 1.3x as long at
// Final-13682; PERF.md).
constexpr int BA_RELIN_MIN_BLOCKS = 2;

// One column's inputs: its observation, weight and point.
struct BaRelinRow {
  float2 o;
  float w;
  float X[3];
};

__device__ __forceinline__ BaRelinRow ba_relin_load(
    const float* __restrict__ points, const BaCamRows& rows, int j, int p) {
  BaRelinRow r;
  r.o = reinterpret_cast<const float2*>(rows.pt2d)[j];
  r.w = rows.w[j];
  const float* x = points + 3 * (size_t)p;
  r.X[0] = x[0];
  r.X[1] = x[1];
  r.X[2] = x[2];
  return r;
}

// K2 cam90 past shared memory: a block a camera over its camera-order
// columns j in [cam_starts[c], cam_starts[c+1]), each column's Jc and r by
// the chain, [Jc'Jc | Jc'r] summed as the records path sums it.
__global__ void __launch_bounds__(BA_BLOCK, BA_RELIN_MIN_BLOCKS)
    ba_cam_relin_cam90_kernel(const float* __restrict__ cams,
                              const float* __restrict__ points,
                              BaCamRows rows,
                              const int* __restrict__ cam_starts,
                              float* __restrict__ out) {
  constexpr int K = ProdCam90::K;
  const int c = blockIdx.x;
  const BaCam cam = ba_load_cam(cams + 9 * (size_t)c);
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  float jp_sum = 0.f;
  const int last = cam_starts[c + 1] - 1;
  int j = cam_starts[c] + threadIdx.x;
  if (j <= last) {
    // Loads run a column ahead (the point index two), at indices clamped to
    // the camera's last column, so that the loop body has no branch.
    BaRelinRow next = ba_relin_load(points, rows, j, rows.pnt[j]);
    int pnt_ahead = rows.pnt[min(j + BA_BLOCK, last)];
    for (; j <= last; j += BA_BLOCK) {
      const BaRelinRow cur = next;
      next = ba_relin_load(points, rows, min(j + BA_BLOCK, last), pnt_ahead);
      pnt_ahead = rows.pnt[min(j + 2 * BA_BLOCK, last)];
      // The camera made opaque once a column, so that the chain's
      // camera-only terms are not hoisted out of the loop: held across it
      // they spill at 128 registers (1.12x as long at Final-13682).
      BaCam cm = cam;
      asm volatile(""
                   : "+f"(cm.r[0]), "+f"(cm.r[1]), "+f"(cm.r[2]),
                     "+f"(cm.t[0]), "+f"(cm.t[1]), "+f"(cm.t[2]), "+f"(cm.k1),
                     "+f"(cm.k2), "+f"(cm.f));
      float Jc[18], Jp[6], res[2];
      ba_linearize(cm, cur.X, cur.o.x, cur.o.y, cur.w, Jc, Jp, res);
      jp_sum += Jp[0] + Jp[1] + Jp[2] + Jp[3] + Jp[4] + Jp[5];
      ProdCam90::apply(
          acc, [&](int e) { return e < 18 ? Jc[e] : res[e - 18]; }, nullptr,
          nullptr);
    }
  }
  // Jp goes to global memory, as in K7, though nothing reads it: thread
  // 0 stores the thread's sum to the block's output row, which ba_cam_out
  // overwrites after the barrier. Without a store of Jp, nvcc 12.9
  // (V12.9.86) contracted the chain's products into FMAs otherwise than
  // in K7, and Jc's last bits differed from K7's in whole cameras (1,445
  // of 13,682 at Final-13682, whether Jp was left dead or passed to an
  // empty asm or to shared memory; PERF.md). chip_smoke.py and the card
  // tests hold the walk to the records path bit for bit.
  if (threadIdx.x == 0) out[ba_d_out<ProdCam90>() * (size_t)c] = jp_sum;
  __shared__ float tot[K];
  ba_block_sum<K>(acc, tot);
  __syncthreads();
  ba_cam_out<K, ProdCam90::SYM>(tot, out + ba_d_out<ProdCam90>() * (size_t)c);
}

// Blocks an SM the W C W' | W t walk must hold at once (__launch_bounds__):
// 2 caps the registers at 128 a thread, none spilled (1: 168 registers,
// 1.25x as long at Final-13682; PERF.md).
constexpr int BA_RELIN_WCW_MIN_BLOCKS = 2;

// The per-point operands of the W C W' | W t walk packed a point:
// [X (3) | Hpp_inv (9) | t (3) | 0], 64 B, two 32 B sectors.
constexpr int BA_PNT_OPS = 16;

// One column of the W C W' | W t walk: its observation, weight, point
// index and point.
struct BaRelinPnt {
  float2 o;
  float w;
  int p;
  float X[3];
};

__device__ __forceinline__ BaRelinPnt ba_relin_pnt_load(
    const float* __restrict__ pnt_ops, const BaCamRows& rows, int j, int p) {
  BaRelinPnt r;
  r.o = reinterpret_cast<const float2*>(rows.pt2d)[j];
  r.w = rows.w[j];
  r.p = p;
  const float* x = pnt_ops + BA_PNT_OPS * (size_t)p;
  r.X[0] = x[0];
  r.X[1] = x[1];
  r.X[2] = x[2];
  return r;
}

// [X | Hpp_inv | t | 0] a point, a thread a point.
__global__ void __launch_bounds__(BA_BLOCK) ba_pack_pnt_ops_kernel(
    const float* __restrict__ points, const float* __restrict__ hpp_inv,
    const float* __restrict__ t, int npnts, float4* __restrict__ out) {
  const int p = blockIdx.x * BA_BLOCK + threadIdx.x;
  if (p >= npnts) return;
  const float* x = points + 3 * (size_t)p;
  const float* h = hpp_inv + 9 * (size_t)p;
  const float* v = t + 3 * (size_t)p;
  float4* o = out + (BA_PNT_OPS / 4) * (size_t)p;
  o[0] = make_float4(x[0], x[1], x[2], h[0]);
  o[1] = make_float4(h[1], h[2], h[3], h[4]);
  o[2] = make_float4(h[5], h[6], h[7], h[8]);
  o[3] = make_float4(v[0], v[1], v[2], 0.f);
}

// K2 W C W' | W t on route B1: a block a camera over its
// camera-order columns, each column's W = Jc' Jp by the chain, as K7 stores
// it in T (a float16 W times its range scale first), then ProdWcwRhs at the
// column's point's Hpp_inv and t, summed as the records path sums it.
template <class T>
__global__ void __launch_bounds__(BA_BLOCK, BA_RELIN_WCW_MIN_BLOCKS)
    ba_cam_relin_wcw_rhs_kernel(const float* __restrict__ cams,
                                const float* __restrict__ pnt_ops,
                                BaCamRows rows,
                                const int* __restrict__ cam_starts,
                                const float* __restrict__ w_scale,
                                float* __restrict__ out) {
  constexpr int K = ProdWcwRhs::K;
  const int c = blockIdx.x;
  const BaCam cam = ba_load_cam(cams + 9 * (size_t)c);
  const float s = w_scale == nullptr ? 1.f : *w_scale;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  const int last = cam_starts[c + 1] - 1;
  int j = cam_starts[c] + threadIdx.x;
  if (j <= last) {
    // Loads a column ahead, as the cam90 walk's.
    BaRelinPnt next = ba_relin_pnt_load(pnt_ops, rows, j, rows.pnt[j]);
    int pnt_ahead = rows.pnt[min(j + BA_BLOCK, last)];
    for (; j <= last; j += BA_BLOCK) {
      const BaRelinPnt cur = next;
      next = ba_relin_pnt_load(pnt_ops, rows, min(j + BA_BLOCK, last),
                               pnt_ahead);
      pnt_ahead = rows.pnt[min(j + 2 * BA_BLOCK, last)];
      BaCam cm = cam;
      asm volatile(""
                   : "+f"(cm.r[0]), "+f"(cm.r[1]), "+f"(cm.r[2]),
                     "+f"(cm.t[0]), "+f"(cm.t[1]), "+f"(cm.t[2]), "+f"(cm.k1),
                     "+f"(cm.k2), "+f"(cm.f));
      float Jc[18], Jp[6], res[2];
      ba_linearize(cm, cur.X, cur.o.x, cur.o.y, cur.w, Jc, Jp, res);
      float Wr[27];
#pragma unroll
      for (int a = 0; a < 9; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          float v = Jc[a] * Jp[b] + Jc[9 + a] * Jp[3 + b];
          if constexpr (std::is_same<T, __half>::value) v *= s;
          Wr[3 * a + b] = ba_w_as_stored<T>(v);
        }
      const float* op = pnt_ops + BA_PNT_OPS * (size_t)cur.p;
      ProdWcwRhs::apply(acc, [&](int e) { return Wr[e]; }, op + 3, op + 12);
    }
  }
  __shared__ float tot[K];
  ba_block_sum<K>(acc, tot);
  __syncthreads();
  ba_cam_out<K, ProdWcwRhs::SYM>(tot,
                                 out + ba_d_out<ProdWcwRhs>() * (size_t)c);
}

}  // namespace

// cams (ncams, 9); points (npnts, 3); JR (26, n) and W (27, n) out, W in
// storage w_dtype (w_store.cuh).
extern "C" int ba_linearize_rows(const float* cams, const float* points,
                                 const float* pt2d, const float* w,
                                 const int* cam_idx, const int* pnt_idx,
                                 long long n, float* JR, void* W, int w_dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  return ba_with_w_type(w_dtype, [&](auto tag) {
    using T = BA_W_TYPE(tag);
    ba_linearize_kernel<T><<<(unsigned)((n + BA_BLOCK - 1) / BA_BLOCK),
                             BA_BLOCK, 0, s>>>(cams, points, pt2d, w,
                                               cam_idx, pnt_idx, n, JR,
                                               static_cast<T*>(W));
    BA_RETURN_IF_LAUNCH_FAILED();
    return 0;
  });
}

// cams (ncams, 9); points (npnts, 3); the plan's camera-order rows
// pt2d_cam (n, 2), w_cam (n,), cam_col (n,), cam_pnt (n,); W_cam (27, n)
// out, camera order, in storage w_dtype.
extern "C" int ba_linearize_w_only(const float* cams, const float* points,
                                   const float* pt2d_cam, const float* w_cam,
                                   const int* cam_col, const int* cam_pnt,
                                   long long n, void* W_cam, int w_dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const BaCamRows rows{pt2d_cam, w_cam, cam_col, cam_pnt};
  return ba_with_w_type(w_dtype, [&](auto tag) {
    using T = BA_W_TYPE(tag);
    ba_linearize_w_only_kernel<T>
        <<<(unsigned)((n + BA_BLOCK - 1) / BA_BLOCK), BA_BLOCK, 0, s>>>(
            cams, points, rows, n, static_cast<T*>(W_cam));
    BA_RETURN_IF_LAUNCH_FAILED();
    return 0;
  });
}

// cams (ncams, 9); points (npnts, 3); the plan's camera-order rows
// pt2d_cam (n, 2), w_cam (n,), cam_pnt (n,); cam_starts (ncams+1,); out
// (ncams, 90) [Hcc (81) | g_c (9)] a camera.
extern "C" int ba_cam_relin_cam90(const float* cams, const float* points,
                                  const float* pt2d_cam, const float* w_cam,
                                  const int* cam_pnt, const int* cam_starts,
                                  int ncams, float* out, void* stream) {
  if (ncams <= 0) return 0;
  const BaCamRows rows{pt2d_cam, w_cam, nullptr, cam_pnt};
  ba_cam_relin_cam90_kernel<<<ncams, BA_BLOCK, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      cams, points, rows, cam_starts, out);
  BA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// cams (ncams, 9); points (npnts, 3); hpp_inv (npnts, 9) and t (npnts, 3)
// of the point blocks; the plan's camera-order rows pt2d_cam (n, 2), w_cam
// (n,), cam_pnt (n,); cam_starts (ncams+1,); W's storage w_dtype, and for
// float16 the range scale w_scale (1,) or null (1); pnt_ops (npnts, 16)
// scratch, [X | Hpp_inv | t | 0] a point; out (ncams, 90) [sum W C W' (81)
// | sum W t (9)] a camera.
extern "C" int ba_cam_relin_wcw_rhs(const float* cams, const float* points,
                                    const float* hpp_inv, const float* t,
                                    const float* pt2d_cam,
                                    const float* w_cam, const int* cam_pnt,
                                    const int* cam_starts,
                                    const float* w_scale, int w_dtype,
                                    int npnts, int ncams, float* pnt_ops,
                                    float* out, void* stream) {
  if (ncams <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npnts > 0) {
    ba_pack_pnt_ops_kernel<<<(npnts + BA_BLOCK - 1) / BA_BLOCK, BA_BLOCK, 0,
                             s>>>(points, hpp_inv, t, npnts,
                                  reinterpret_cast<float4*>(pnt_ops));
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  const BaCamRows rows{pt2d_cam, w_cam, nullptr, cam_pnt};
  return ba_with_w_type(w_dtype, [&](auto tag) {
    using T = BA_W_TYPE(tag);
    ba_cam_relin_wcw_rhs_kernel<T><<<ncams, BA_BLOCK, 0, s>>>(
        cams, pnt_ops, rows, cam_starts, w_scale, out);
    BA_RETURN_IF_LAUNCH_FAILED();
    return 0;
  });
}
