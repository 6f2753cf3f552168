// Device code shared by K5's point direction (seg_block_reduce.cu), K3's
// point pass (matvec.cu), and K1's point pass (assemble.cu) and K6's point
// product (seg_prod_reduce.cu) through ba_point_walk: each point's segment
// of the point-sorted rows, reduced
// and, for K5 and K3, optionally folded with its damped inverse block,
//
//   s   = sum_{k in p} W_k' v[cam_k]  (+ add_p)
//   out = sign * Hpp_inv_p s   (sign * s when hpp_inv is null)
//
// The counterpart of the point direction of the TPU kernel
// `bundleadjustment_jl_tpu/ops/pallas_schur.py` `_seg_reduce_kernel`
// (`_seg_block_reduce`, :647) and of the point pass of `_mv_scatter_kernel`
// (`matvec_cam_scatter`, :1550). A thread per point read rows 6-7 apart
// in each lane (the rows per point), ~24 sectors a warp load for 32 floats,
// and lanes waited for the warp's longest point.
//
// Design: one block per contiguous point range of about 1024 rows (plan
// `ops/plans.py:point_blocks`, built once per problem). The block walks
// its rows [pnt_starts[p0], pnt_starts[p1]) in chunks of BA_PNT_CHUNK:
//
//   1. one thread per row (lanes on neighbouring rows, so every plane load
//      is coalesced) computes the row's W_k' v[cam_k] (v, <= 165 KB, read
//      through the read-only cache) into shared memory;
//   2. the owner thread of each point whose rows end in the chunk sums its
//      rows' 3-vectors in row order and writes its output; the point that
//      runs past the chunk keeps its sum so far in shared memory (carry)
//      for the next chunk, so a segment may be longer than a chunk (the
//      last point holds the padding rows; real BAL points hold hundreds).
//
// Row order and each row's inner order are those of a sequential walk, so
// the sums equal a thread-per-point walk's up to FMA contraction. W is read
// in its storage type T (w_store.cuh) and widened at the load.
//
// Bound: W once at full coalescing (108 B a row in f32, 54 B in bf16 / f16)
// plus 4 B of cam_idx; v, the fold and the output per point.
#pragma once

#include "chain.cuh"
#include "w_store.cuh"

// Rows of one chunk of K5's walk: 6 a thread. A block's range is ~1024
// rows (ops/plans.py:POINT_BLOCK_ROWS), so its last point may run ~500
// rows past the target and still take one chunk.
constexpr int BA_PNT_ROWS_PER_THREAD = 6;
constexpr int BA_PNT_CHUNK = BA_BLOCK * BA_PNT_ROWS_PER_THREAD;

namespace {

// out_p = sign * Hpp_inv_p (s + add_p), without the fold when hpp_inv is
// null, without the add when add is null.
__device__ __forceinline__ void ba_point_out(
    int p, float (&s)[3], const float* __restrict__ hpp_inv,
    const float* __restrict__ add, float sign, float* __restrict__ out) {
  if (add != nullptr) {
    s[0] += add[3 * (size_t)p];
    s[1] += add[3 * (size_t)p + 1];
    s[2] += add[3 * (size_t)p + 2];
  }
  if (hpp_inv == nullptr) {
#pragma unroll
    for (int a = 0; a < 3; ++a) out[3 * (size_t)p + a] = sign * s[a];
    return;
  }
  const float* h = hpp_inv + 9 * (size_t)p;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    out[3 * (size_t)p + a] =
        sign * (h[3 * a] * s[0] + h[3 * a + 1] * s[1] + h[3 * a + 2] * s[2]);
}

// The walk of one block over its point range [block_pnts[b],
// block_pnts[b+1]) in chunks of BA_BLOCK * RPT rows. row(r, y) gives row
// r's D values (one thread per row: lanes on neighbouring rows); out(p, s)
// writes point p from the sum of its rows' values, taken in row order by
// the point's owner thread, the point running past a chunk carrying its sum
// to the next. K5's point direction (D = 3), K1's point pass and K6's
// point product (D = 9) walk so; every thread of the block must call it.
template <int D, int RPT, class Row, class Out>
__device__ __forceinline__ void ba_point_walk(
    const int* __restrict__ pnt_idx, const int* __restrict__ pnt_starts,
    const int* __restrict__ block_pnts, Row row, Out out) {
  constexpr int CHUNK = BA_BLOCK * RPT;
  static_assert(D * CHUNK * sizeof(float) <= 48 * 1024,
                "the chunk's values must fit in static shared memory");
  __shared__ float sy[D][CHUNK];
  __shared__ float carry[D];
  const int p_end = block_pnts[blockIdx.x + 1];
  int p_next = block_pnts[blockIdx.x];  // first point not yet written
  bool carried = false;                 // carry holds p_next's sum so far
  const int r1 = pnt_starts[p_end];
  for (int c0 = pnt_starts[p_next];; c0 += CHUNK) {
    const int c1 = min(c0 + CHUNK, r1);
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = c0 + k * BA_BLOCK + threadIdx.x;
      if (r < c1) {
        float y[D];
        row(r, y);
#pragma unroll
        for (int d = 0; d < D; ++d) sy[d][r - c0] = y[d];
      }
    }
    __syncthreads();
    // Points before p_fin end within the chunk (or have no rows).
    const bool last = c1 == r1;
    const int p_fin = last ? p_end : pnt_idx[c1];
    for (int p = p_next + threadIdx.x; p < p_fin; p += BA_BLOCK) {
      const bool cont = carried && p == p_next;
      float s[D];
#pragma unroll
      for (int d = 0; d < D; ++d) s[d] = cont ? carry[d] : 0.f;
      const int e = pnt_starts[p + 1];
      for (int r = max(pnt_starts[p], c0); r < e; ++r)
#pragma unroll
        for (int d = 0; d < D; ++d) s[d] += sy[d][r - c0];
      out(p, s);
    }
    if (last) break;
    // Point p_fin holds row c1; if it started before c1 it carries.
    const int pc_start = pnt_starts[p_fin];
    __syncthreads();
    if (pc_start < c1) {
      if (threadIdx.x == 0) {
        const bool cont = carried && p_fin == p_next;
        float s[D];
#pragma unroll
        for (int d = 0; d < D; ++d) s[d] = cont ? carry[d] : 0.f;
        for (int r = max(pc_start, c0); r < c1; ++r)
#pragma unroll
          for (int d = 0; d < D; ++d) s[d] += sy[d][r - c0];
#pragma unroll
        for (int d = 0; d < D; ++d) carry[d] = s[d];
      }
      carried = true;
    } else {
      carried = false;
    }
    p_next = p_fin;
    __syncthreads();
  }
}

template <class T>
__global__ void __launch_bounds__(BA_BLOCK) ba_wtv_point_kernel(
    const T* __restrict__ W, const float* __restrict__ v,
    const int* __restrict__ cam_idx, const int* __restrict__ pnt_idx,
    const int* __restrict__ pnt_starts, const int* __restrict__ block_pnts,
    const float* __restrict__ hpp_inv, const float* __restrict__ add,
    float sign, long long n, float* __restrict__ out) {
  ba_point_walk<3, BA_PNT_ROWS_PER_THREAD>(
      pnt_idx, pnt_starts, block_pnts,
      [&](int row, float (&y)[3]) {
        const float* vc = v + 9 * (size_t)cam_idx[row];
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          float acc = 0.f;
#pragma unroll
          for (int a = 0; a < 9; ++a)
            acc += ba_ldw(W, (3 * a + b) * n + row) * __ldg(vc + a);
          y[b] = acc;
        }
      },
      [&](int p, float (&s)[3]) {
        ba_point_out(p, s, hpp_inv, add, sign, out);
      });
}

// Launch on ``stream``: one block per point range of ``block_pnts``
// (nblocks+1 bounds); 0 or the CUDA error of the launch.
template <class T>
int ba_launch_wtv_point(const T* W, const float* v, const int* cam_idx,
                        const int* pnt_idx, const int* pnt_starts,
                        const int* block_pnts, int nblocks,
                        const float* hpp_inv, const float* add, float sign,
                        long long n, float* out, void* stream) {
  if (nblocks > 0) {
    ba_wtv_point_kernel<T>
        <<<nblocks, BA_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            W, v, cam_idx, pnt_idx, pnt_starts, block_pnts, hpp_inv, add,
            sign, n, out);
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}

}  // namespace
