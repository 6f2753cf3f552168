// Kernel K6: segment sums of a per-row product, three products.
//
// Replaces the TPU kernel `bundleadjustment_jl_tpu/ops/pallas_schur.py`
// `_prod_reduce_kernel` (dispatched by `seg_prod_reduce`) with the products
// the camera-sorted route runs:
//
//   jtj_pnt  (`_prod_pnt12`): [Jp'Jp (9) | Jp'r (3)] per point over the
//            point-sorted JR rows                          -> (npnts, 12)
//   jtj_cam  (`_prod_cam90`): [Jc'Jc (81) | Jc'r (9)] per camera over the
//            camera-sorted JR rows                         -> (ncams, 90)
//   wcw_cam  (`_prod_wcw`):   sum W C W' (81) per camera over the
//            camera-sorted W rows, C = Hpp_inv[pnt_k]       -> (ncams, 81)
//
// JR is (26, n) structure-of-arrays: rows 0-17 Jc (9 i + a), 18-23 Jp
// (18 + 3 i + b), 24-25 r; W is (27, n), row 3 a + b.
//
// Design.
//
// jtj_pnt: one block per ~1024-row point range (plan
// `ops/plans.py:point_blocks`), a thread a row, each point's rows summed
// in row order by its owner thread: K5's point walk (wtv_point.cuh), see
// ba_jtj_pnt_kernel below.
//
// jtj_cam: one block per camera strides over its columns (coalesced),
// keeps the 45 upper-triangle sums of the symmetric 9x9 plus 9 for Jc'r in
// registers, and reduces them in a fixed order (ba_block_sum); its kernel,
// cam_prod.cuh ba_launch_cam_prod, is K2's product over the camera-sorted
// copy.
//
// wcw_cam, plan `ops/plans.py:CamColPlan` (its own column range,
// ops/plans.py:WCW_BLOCK_COLS). A block per camera paid, per row, a chain
// of three dependent loads (cam_perm[j], pnt_idx at a random row, then
// Hpp_inv at that point), and a block's work followed its camera's length
// (PERF.md, K6 wcw81). Now:
//
//   pass 1, a warp per range of camera-sorted columns (WCW_BLOCK_COLS;
//     a block a range, its warps' sums added in shared memory, measured
//     slower: PERF.md): each lane takes BA_WCW_COLS consecutive columns
//     and issues all 27 plane loads and its points' Hpp_inv gathers
//     before it uses one; the column's point comes from the plan's
//     cam_pnt (read coalesced, the next chunk's loaded ahead). The
//     range's runs (one camera's columns within the range) are taken in
//     order: each lane adds the products of its columns in the run to its
//     45 sums, chunk after chunk, and when the run ends the warp sums the
//     lanes' in a fixed order (a transposed warp sum: 48 shuffles for the
//     45 sums, where a shuffle tree would take 225) and writes them to
//     partial[run] (a warp sum every chunk costs as much as the products:
//     PERF.md, K6 wcw81). A column's product is computed once, in its
//     run's turn; a chunk that meets several runs (cameras of a few rows)
//     takes a turn per run;
//   pass 2, a thread per output entry: sums the camera's runs in run
//     order and writes the symmetric 81.
//
// No atomics: deterministic, a camera without rows gives exact zeros. The
// TPU kernel's sequential grid and VMEM accumulator have no counterpart.
//
// Bound: each product reads its rows once: 32 B a row for jtj_pnt (and
// writes 48 B a point), 80 B
// for jtj_cam, 108 B of W (54 B stored as bf16 / f16, w_store.cuh) plus a
// gathered 24 B of Hpp_inv and a 4 B cam_pnt for wcw_cam (147 MB of f32 W
// at Dubrovnik-356); ~170 FMA a row for the 9x9 products.
#include "cam_cols.cuh"
#include "cam_prod.cuh"
#include "wtv_point.cuh"

// Rows a thread of jtj_pnt's point walk takes in one chunk, as K1's point
// pass (assemble.cu): a chunk of 1280 rows holds a ~1024-row point range
// and most last points in one pass, and its nine values a row fit in 46 KB
// of static shared memory (wtv_point.cuh asserts it). Swept by `python -m
// bundleadjustment_jl_tpu_torch.tile_sweep --sweep pnt12` (PERF.md).
constexpr int BA_PNT12_ROWS_PER_THREAD = 5;

// Columns a lane of the W C W' pass takes: BA_WCW_COLS * sizeof(storage)
// bytes of each plane of W (8 B of a float W, 4 B of a bf16 / f16 one).
// Measured by `python -m bundleadjustment_jl_tpu_torch.tile_sweep --sweep
// wcw` (PERF.md, K6 wcw81): 4 columns (16 B of a float W, 8 B of a 2-byte
// one) spill or fill the register file and were slower in f32 and bf16.
constexpr int BA_WCW_COLS = 2;

namespace {

// The 45 upper-triangle sums padded to 48 for the transposed warp sum.
constexpr int BA_WCW_PAD = 48;

// The first of the 3 sums lane ``lane`` holds after ba_warp_sum48 (lanes
// L and L ^ 1 hold the same three; 45 and up are padding).
__device__ __forceinline__ int ba_wcw_slot(int lane) {
  return ((lane >> 4) & 1) * 24 + ((lane >> 3) & 1) * 12 +
         ((lane >> 2) & 1) * 6 + ((lane >> 1) & 1) * 3;
}

// One halving step of the transposed warp sum: lanes with ``bit`` set keep
// v[H..2H), the others v[0..H), each adding its partner's (lane ^ bit)
// copy of the half it keeps. The kept half moves to v[0..H).
template <int H>
__device__ __forceinline__ void ba_halve(float (&v)[BA_WCW_PAD], int bit) {
  const bool hi = (threadIdx.x & bit) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float keep = hi ? v[i + H] : v[i];
    const float send = hi ? v[i] : v[i + H];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
  }
}

// The warp's sums of v[0..48) in a fixed order: lane L gets out[i] = the
// sum of v[ba_wcw_slot(L) + i] over the 32 lanes, i < 3. Lane pairs add
// the same two values (a + b == b + a), so every lane of a pair agrees.
__device__ __forceinline__ void ba_warp_sum48(float (&v)[BA_WCW_PAD],
                                              float (&out)[3]) {
  ba_halve<24>(v, 16);
  ba_halve<12>(v, 8);
  ba_halve<6>(v, 4);
  ba_halve<3>(v, 2);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = v[i] + __shfl_xor_sync(0xffffffffu, v[i], 1);
}

// acc[0..45) += upper triangle of W C W' for one column, w(e) its plane e
// and h the upper triangle of its point's Hpp_inv (00, 01, 02, 11, 12,
// 22): cam_prod.cuh's ba_wc and ba_add_wcw, the same sums, with a row of
// Y = W C at a time.
template <class Wv>
__device__ __forceinline__ void ba_add_wcw_col(float* acc, Wv w,
                                               const float (&h)[6]) {
  const float C[3][3] = {{h[0], h[1], h[2]},
                         {h[1], h[3], h[4]},
                         {h[2], h[4], h[5]}};
  int q = 0;
#pragma unroll
  for (int a = 0; a < 9; ++a) {
    float y[3];
#pragma unroll
    for (int cc = 0; cc < 3; ++cc)
      y[cc] = w(3 * a) * C[0][cc] + w(3 * a + 1) * C[1][cc] +
              w(3 * a + 2) * C[2][cc];
#pragma unroll
    for (int d = a; d < 9; ++d)
      acc[q++] += y[0] * w(3 * d) + y[1] * w(3 * d + 1) + y[2] * w(3 * d + 2);
  }
}

// Pass 1 of wcw_cam: a warp per column range, BA_BLOCK / 32 ranges a
// block; partial (nruns, 45).
template <class S>
__global__ void __launch_bounds__(BA_BLOCK) ba_wcw_range_kernel(
    const S* __restrict__ W, long long n, const float* __restrict__ hpp,
    BaCamColPlan plan, float* __restrict__ partial) {
  constexpr int V = BA_WCW_COLS;
  constexpr int B = V * (int)sizeof(S);       // bytes of a plane's load
  constexpr int NW = B / 4;                   // words of a plane's load
  static_assert(B % 4 == 0, "whole words of each plane");
  constexpr int CHUNK = 32 * V;               // columns a warp takes at once
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (BA_BLOCK / 32) + (threadIdx.x >> 5);
  if (b >= plan.nranges) return;
  const long long c0 = (long long)b * plan.cols;
  const int len = (int)min((long long)plan.cols, n - c0);
  // The range's runs, in order: run_bounds[r0 + nr] is the next range's
  // first column (or n), so every run's end is run_bounds[. + 1] - c0.
  const int* rb = plan.run_bounds + plan.range_run_starts[b];
  float* out = partial + 45 * (size_t)plan.range_run_starts[b];
  const bool vec = ba_cam_vec<B>(W, n, plan.cam_pnt);
  const int slot = ba_wcw_slot(lane);
  const bool writer = (lane & 1) == 0 && slot < 45;   // one of each pair

  // The points of the lane's columns in the first chunk; each chunk then
  // loads the next chunk's, so its Hpp_inv gathers wait only on its own W
  // loads.
  int pk[V];
  ba_ld_points(plan.cam_pnt + c0, lane * V, len, vec, pk);
  // The lane's sums of the run open at the chunk's start: the products of
  // its columns in the run, in column order.
  float acc[BA_WCW_PAD];
#pragma unroll
  for (int q = 0; q < BA_WCW_PAD; ++q) acc[q] = 0.f;
  // The open run [lo, hi) (local columns), its id r within the range.
  int r = 0, lo = 0, hi = (int)(__ldg(rb + 1) - c0);
  for (int s0 = 0; s0 < len; s0 += CHUNK) {
    const int l0 = s0 + lane * V;              // first local column
    const int nv = max(0, min(V, len - l0));   // columns of this lane
    const int s1 = min(s0 + CHUNK, len);
    const long long j0 = c0 + l0;
    // Every plane's load and every point's C (the upper triangle of its
    // Hpp_inv: entries 0, 1, 2, 4, 5, 8) issued before the first is used.
    unsigned raw[27][NW];
#pragma unroll
    for (int e = 0; e < 27; ++e)
      ba_ld_plane(W + e * n + j0, vec && nv == V, nv, raw[e]);
    float h[V][6];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float* hp = hpp + 9 * (size_t)pk[k];
      const bool on = k < nv;
      h[k][0] = on ? __ldg(hp + 0) : 0.f;
      h[k][1] = on ? __ldg(hp + 1) : 0.f;
      h[k][2] = on ? __ldg(hp + 2) : 0.f;
      h[k][3] = on ? __ldg(hp + 4) : 0.f;
      h[k][4] = on ? __ldg(hp + 5) : 0.f;
      h[k][5] = on ? __ldg(hp + 8) : 0.f;
    }
    ba_ld_points(plan.cam_pnt + c0, l0 + CHUNK, len, vec, pk);
    // The runs that meet the chunk, in order (the open run starts at or
    // before s0): each lane adds the products of its columns in the run;
    // a run that ends in the chunk is summed over the warp and written.
    while (true) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (k < nv && l0 + k >= lo && l0 + k < hi)
          ba_add_wcw_col(acc, [&](int e) { return ba_col(W, raw[e], k); },
                         h[k]);
      }
      if (hi > s1) break;        // the run goes on in the next chunk
      float s3[3];
      ba_warp_sum48(acc, s3);
      if (writer) {
#pragma unroll
        for (int i = 0; i < 3; ++i) out[45 * (size_t)r + slot + i] = s3[i];
      }
#pragma unroll
      for (int q = 0; q < BA_WCW_PAD; ++q) acc[q] = 0.f;
      if (hi == len) break;      // the range's last run
      const bool chunk_ends = hi == s1;
      ++r;
      lo = hi;
      hi = (int)(__ldg(rb + r + 1) - c0);
      if (chunk_ends) break;     // the next run starts the next chunk
    }
  }
}

// Pass 2 of wcw_cam: out[c][9 a + d] = the sum, in run order, of camera
// c's runs' upper-triangle entry (min(a, d), max(a, d)): a thread per
// output entry (a camera holds a few runs, ~5 at Final-4585; a block per
// camera with a 45-wide block sum, cam_prod.cuh ba_run_sum_kernel, took
// 0.043 ms there: PERF.md, K6 wcw81). Both halves of the symmetric 9x9 sum
// the same values in the same order; a camera without runs gets zeros.
__global__ void __launch_bounds__(BA_BLOCK) ba_wcw_run_sum_kernel(
    const float* __restrict__ partial, const int* __restrict__ cam_run_starts,
    int ncams, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * BA_BLOCK + threadIdx.x;
  if (i >= 81LL * ncams) return;
  const int c = (int)(i / 81), k = (int)(i % 81);
  const int a = k / 9, d = k % 9;
  const int t = a <= d ? ba_tri9(a, d) : ba_tri9(d, a);
  float s = 0.f;
  for (int r = cam_run_starts[c]; r < cam_run_starts[c + 1]; ++r)
    s += partial[45 * (size_t)r + t];
  out[i] = s;
}

template <class S>
int ba_launch_wcw_cam(const S* W, long long n, const float* hpp,
                      const BaCamColPlan& plan, int ncams, float* partial,
                      float* out, void* stream) {
  if (const int rc = ba_check_cam_cols(plan)) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan.nranges > 0) {
    constexpr int NG = BA_BLOCK / 32;   // ranges a block
    ba_wcw_range_kernel<S><<<(plan.nranges + NG - 1) / NG, BA_BLOCK, 0, s>>>(
        W, n, hpp, plan, partial);
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  if (ncams > 0) {
    ba_wcw_run_sum_kernel<<<(unsigned)((81LL * ncams + BA_BLOCK - 1) /
                                       BA_BLOCK),
                            BA_BLOCK, 0, s>>>(partial, plan.cam_run_starts,
                                              ncams, out);
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}

// jtj_pnt: K5's point walk (wtv_point.cuh ba_point_walk, plan
// `ops/plans.py:point_blocks`), as K1's point pass takes it. A thread per
// point read rows 6-7 apart in each lane, ~24 sectors a warp load for 32
// floats, and lanes waited for the warp's longest point (PERF.md, K6
// pnt12). Now a thread per row loads the row's Jp (6) and r (2), lanes on
// neighbouring rows, and puts its [Jp'Jp upper (00, 01, 02, 11, 12, 22) |
// Jp'r] in shared memory; each point's owner thread sums its rows in row
// order and writes the symmetric 9 and the 3 (out must be 16 B aligned).
__global__ void __launch_bounds__(BA_BLOCK) ba_jtj_pnt_kernel(
    const float* __restrict__ JR, const int* __restrict__ pnt_idx,
    const int* __restrict__ pnt_starts, const int* __restrict__ block_pnts,
    long long n, float* __restrict__ out) {
  ba_point_walk<9, BA_PNT12_ROWS_PER_THREAD>(
      pnt_idx, pnt_starts, block_pnts,
      [&](int row, float (&y)[9]) {
        float Jp[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) Jp[k] = __ldg(JR + (18 + k) * n + row);
        const float r0 = __ldg(JR + 24 * n + row);
        const float r1 = __ldg(JR + 25 * n + row);
        int q = 0;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
#pragma unroll
          for (int e = b; e < 3; ++e)
            y[q++] = Jp[b] * Jp[e] + Jp[3 + b] * Jp[3 + e];
          y[6 + b] = Jp[b] * r0 + Jp[3 + b] * r1;
        }
      },
      [&](int p, float (&s)[9]) {
        // 48 B a point, 16 B aligned: three 16 B stores (twelve 4 B ones,
        // a quarter as many store instructions, measured ~8% slower at
        // Final-4585: PERF.md, K6 pnt12).
        float4* o = reinterpret_cast<float4*>(out + 12 * (size_t)p);
        o[0] = make_float4(s[0], s[1], s[2], s[1]);
        o[1] = make_float4(s[3], s[4], s[2], s[4]);
        o[2] = make_float4(s[5], s[6], s[7], s[8]);
      });
}

}  // namespace

// JR (26, n) point-sorted; block_pnts (nblocks+1,) point ranges; out
// (npnts, 12).
extern "C" int ba_jtj_pnt_reduce(const float* JR, const int* pnt_idx,
                                 const int* pnt_starts,
                                 const int* block_pnts, int nblocks,
                                 long long n, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nblocks > 0) {
    ba_jtj_pnt_kernel<<<nblocks, BA_BLOCK, 0, s>>>(JR, pnt_idx, pnt_starts,
                                                   block_pnts, n, out);
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}

// JR_cam (26, n) camera-sorted; out (ncams, 90).
extern "C" int ba_jtj_cam_reduce(const float* JR_cam, const int* cam_starts,
                                 int ncams, long long n, float* out,
                                 void* stream) {
  return ba_launch_cam_prod<ProdCam90>(
      BaRows<float>{JR_cam, n, nullptr, nullptr, nullptr}, cam_starts, ncams,
      out, stream);
}

// W_cam (27, n) camera-sorted, in storage w_dtype; hpp_inv (npnts, 9);
// plan of ops/plans.py:CamColPlan; partial (nruns, 45) f32 scratch; out
// (ncams, 81).
extern "C" int ba_wcw_cam_reduce(const void* W_cam, int w_dtype,
                                 const float* hpp_inv,
                                 const BaCamColPlan* plan, int ncams,
                                 long long n, float* partial, float* out,
                                 void* stream) {
  return ba_with_w_type(w_dtype, [&](auto tag) {
    using T = BA_W_TYPE(tag);
    return ba_launch_wcw_cam(static_cast<const T*>(W_cam), n, hpp_inv, *plan,
                             ncams, partial, out, stream);
  });
}
