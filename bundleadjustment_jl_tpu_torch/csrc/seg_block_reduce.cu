// Kernel K5: segment sums of the 9x3 W blocks against a gathered vector,
// in both directions.
//
// Replaces the TPU kernel `bundleadjustment_jl_tpu/ops/pallas_schur.py`
// `_seg_reduce_kernel` (dispatched by `_seg_block_reduce`, :647) as reached
// by
//
//   wtv_point_reduce: out_p = sign * Hpp_inv_p (sum_{k in p} W_k' v[cam_k]
//                     + add_p), the fold and add optional   -> (npnts, 3)
//   wt_cam_reduce:    out_c = sum_{cam_k = c} W_k t[pnt_k]    -> (ncams, 9)
//                     over the camera-sorted W
//
// The camera-sorted route's two-pass Schur matvec is the point direction
// with the fold, then the camera direction; back-substitution is the
// point direction with add = g_p and sign = -1; the reduced right-hand
// side and the |J d|^2 cross term are the camera direction.
//
// Point direction (wtv_point.cuh, shared with K3's point pass and K1's
// point pass): one block per contiguous point range of ~1024 rows (plan
// `ops/plans.py:point_blocks`), one thread per row, so lanes read
// neighbouring rows and every plane load is coalesced; the rows' 3-vectors
// go through shared memory to each point's owner thread, which sums them
// in row order and folds.
//
// Camera direction, plan `ops/plans.py:CamColPlan`. An earlier block per
// camera paid, per row, a chain of three dependent loads (cam_perm[j],
// then pnt_idx at a random row, then t), 27 scalar plane loads whatever
// W's width (so a 2-byte W was slower, not faster), and a block's work
// followed its camera's length. Now:
//
//   pass 1, one block per range of CAM_BLOCK_COLS camera-sorted columns:
//     each thread takes V consecutive columns, BA_CAM_LOAD_BYTES of each
//     plane (a scalar path for planes not aligned so), and issues all 27
//     plane loads before it uses one (with 16 B a plane and the loads among
//     the products, a 2-byte W kept too few bytes in flight and was slower
//     than a float W: PERF.md, K5 camera). The column's point comes from the
//     plan's cam_pnt = pnt_idx[cam_perm] (coalesced, the next chunk's loaded
//     ahead), t[point] is a gather from L2 (t: 16 MB at Final-4585). The
//     range's runs (one camera's columns within the range) are summed by a
//     segmented scan of the block, keyed by the run heads: each thread's V
//     columns, then warp shuffles, then the warps in order through shared
//     memory, with the sum of the run still open carried from one chunk of
//     256 V columns to the next; the thread holding a run's last column
//     writes its 9 sums to partial[run]. A range may hold hundreds of runs
//     (cameras of a few rows), so there is no per-camera loop;
//   pass 2 (cam_prod.cuh ba_run_sum_kernel, W op's output): one block per
//     camera sums its runs in run order.
//
// No atomics: the order of every sum is fixed by the layout, so repeats are
// bit-identical, and a camera without rows gives exact zeros. The TPU
// kernel's camera table, its pre-gathered (16, n) operand and the (8, n)
// handoff layout have no counterpart.
//
// W is read in its storage type (float, bf16 or f16: w_dtype, w_store.cuh)
// and widened at the load; operands and sums are float.
//
// Bound: each direction streams W once, 108 B a row in f32, 54 B in bf16 /
// f16 (147 / 73 MB at Dubrovnik-356, n = 1,360,384), plus 4-8 B of
// indices; ~54 FMA a row: the bytes. The camera direction reaches ~0.8 of
// it with a float W at Final-4585 and ~0.45 with a 2-byte W, which takes
// about the float W's time there (PERF.md, K5 camera: not W's bytes).
#include "cam_cols.cuh"
#include "cam_prod.cuh"
#include "wtv_point.cuh"

namespace {

// Segmented sum operator on (head seen, 9 sums): (f1, v1) + (f2, v2) =
// (f1 | f2, f2 ? v2 : v1 + v2).
__device__ __forceinline__ void ba_seg_add(bool lf, const float (&lv)[9],
                                           bool& f, float (&v)[9]) {
  if (!f) {
#pragma unroll
    for (int a = 0; a < 9; ++a) v[a] = lv[a] + v[a];
  }
  f = f || lf;
}

// Pass 1: one block per range; partial (nruns, 9).
template <class S>
__global__ void __launch_bounds__(BA_BLOCK) ba_wt_cam_range_kernel(
    const S* __restrict__ W, long long n, const float* __restrict__ t,
    BaCamColPlan plan, float* __restrict__ partial) {
  constexpr int V = ba_cam_v<S>();
  constexpr int CHUNK = BA_BLOCK * V;
  constexpr int NW = BA_BLOCK / 32;
  extern __shared__ int sbound[];      // the range's run starts, local
  __shared__ float wsum[NW][9];        // each warp's segmented total
  __shared__ int wflag[NW];
  __shared__ float wpre[NW][9];        // the sum open before each warp
  __shared__ float carry[9];           // the sum open at the chunk's end
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long c0 = (long long)blockIdx.x * plan.cols;
  const int len = (int)min((long long)plan.cols, n - c0);
  const int r0 = plan.range_run_starts[blockIdx.x];
  const int nr = plan.range_run_starts[blockIdx.x + 1] - r0;
  for (int i = threadIdx.x; i < nr; i += BA_BLOCK)
    sbound[i] = (int)(plan.run_bounds[r0 + i] - c0);
  if (threadIdx.x == 0) sbound[nr] = len;
  if (threadIdx.x < 9) carry[threadIdx.x] = 0.f;
  __syncthreads();
  // Vector loads of W's planes (V values) and of cam_pnt (c0, s0 and l0
  // are multiples of V).
  const bool vec = ba_cam_vec<BA_CAM_LOAD_BYTES>(W, n, plan.cam_pnt);

  // The points of the thread's columns in the first chunk; each chunk then
  // loads the next chunk's, so a chunk's t gathers wait only on its own W
  // loads, not on a cam_pnt load before them.
  int pk[V];
  ba_ld_points(plan.cam_pnt + c0, threadIdx.x * V, len, vec, pk);
  for (int s0 = 0; s0 < len; s0 += CHUNK) {
    const int l0 = s0 + threadIdx.x * V;       // first local column
    const int nv = max(0, min(V, len - l0));   // columns of this thread
    const long long j0 = c0 + l0;
    // y[k] = W_k t[cam_pnt[k]] of each column k. Every plane's load is
    // issued before the first is used: 27 loads in flight a thread.
    float y[V][9];
    {
      unsigned raw[27][BA_CAM_WORDS];
#pragma unroll
      for (int e = 0; e < 27; ++e)
        ba_ld_plane(W + e * n + j0, vec && nv == V, nv, raw[e]);
      float tp[V][3];
#pragma unroll
      for (int k = 0; k < V; ++k) {
#pragma unroll
        for (int b = 0; b < 3; ++b)
          tp[k][b] = k < nv ? __ldg(t + 3 * (size_t)pk[k] + b) : 0.f;
      }
      ba_ld_points(plan.cam_pnt + c0, l0 + CHUNK, len, vec, pk);
#pragma unroll
      for (int a = 0; a < 9; ++a) {
        float wv[3][V];
#pragma unroll
        for (int b = 0; b < 3; ++b) ba_unpack(W, raw[3 * a + b], wv[b]);
#pragma unroll
        for (int k = 0; k < V; ++k)
          y[k][a] = wv[0][k] * tp[k][0] + wv[1][k] * tp[k][1] +
                    wv[2][k] * tp[k][2];
      }
    }
    // The run of the thread's first column: the last run start <= l0.
    int ri = 0;
    if (nv > 0) {
      int hi = nr - 1;
      while (ri < hi) {
        const int mid = (ri + hi + 1) >> 1;
        if (sbound[mid] <= l0) ri = mid; else hi = mid - 1;
      }
    }
    // The thread's own segmented total: from its last run head on.
    bool f = false;
    float v[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    {
      int r = ri;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (k < nv) {
          if (r + 1 < nr && sbound[r + 1] <= l0 + k) ++r;
          const bool head = sbound[r] == l0 + k;
#pragma unroll
          for (int a = 0; a < 9; ++a) v[a] = head ? y[k][a] : v[a] + y[k][a];
          f = f || head;
        }
      }
    }
    // Inclusive segmented scan over the warp's lanes.
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      float up[9];
#pragma unroll
      for (int a = 0; a < 9; ++a) up[a] = __shfl_up_sync(0xffffffffu, v[a], off);
      const bool uf = __shfl_up_sync(0xffffffffu, (int)f, off) != 0;
      if (lane >= off) ba_seg_add(uf, up, f, v);
    }
    if (lane == 31) {
#pragma unroll
      for (int a = 0; a < 9; ++a) wsum[warp][a] = v[a];
      wflag[warp] = f;
    }
    // The exclusive value of this lane within its warp.
    float ev[9];
#pragma unroll
    for (int a = 0; a < 9; ++a) {
      ev[a] = __shfl_up_sync(0xffffffffu, v[a], 1);
      if (lane == 0) ev[a] = 0.f;
    }
    bool ef = __shfl_up_sync(0xffffffffu, (int)f, 1) != 0 && lane > 0;
    __syncthreads();
    // Warps in order, from the sum left open by the previous chunk.
    if (threadIdx.x < 9) {
      const int a = threadIdx.x;
      float open = carry[a];
      for (int w = 0; w < NW; ++w) {
        wpre[w][a] = open;
        open = wflag[w] ? wsum[w][a] : open + wsum[w][a];
      }
      carry[a] = open;
    }
    __syncthreads();
    // The sum open before the thread's first column, then its columns in
    // order; a run's last column writes the run's sums.
    float run[9];
#pragma unroll
    for (int a = 0; a < 9; ++a) run[a] = ef ? ev[a] : wpre[warp][a] + ev[a];
    {
      int r = ri;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (k < nv) {
          if (r + 1 < nr && sbound[r + 1] <= l0 + k) ++r;
          const bool head = sbound[r] == l0 + k;
#pragma unroll
          for (int a = 0; a < 9; ++a)
            run[a] = head ? y[k][a] : run[a] + y[k][a];
          if (sbound[r + 1] == l0 + k + 1) {
            float* o = partial + 9 * (size_t)(r0 + r);
#pragma unroll
            for (int a = 0; a < 9; ++a) o[a] = run[a];
          }
        }
      }
    }
    __syncthreads();
  }
}

template <class S>
int ba_launch_wt_cam(const S* W, long long n, const float* t,
                     const BaCamColPlan& plan, int ncams, float* partial,
                     float* out, void* stream) {
  if (const int rc = ba_check_cam_cols(plan)) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan.nranges > 0) {
    ba_wt_cam_range_kernel<S>
        <<<plan.nranges, BA_BLOCK, (plan.cols + 1) * sizeof(int), s>>>(
            W, n, t, plan, partial);
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  if (ncams > 0) {
    ba_run_sum_kernel<ProdWOp><<<ncams, BA_BLOCK, 0, s>>>(
        partial, plan.cam_run_starts, out);
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}

}  // namespace

// W (27, n) point-sorted, in storage w_dtype; v (ncams, 9); block_pnts
// (nblocks+1,) point ranges; hpp_inv (npnts, 9) or null; add (npnts, 3) or
// null; out (npnts, 3).
extern "C" int ba_wtv_point_reduce(const void* W, int w_dtype,
                                   const float* v, const int* cam_idx,
                                   const int* pnt_idx, const int* pnt_starts,
                                   const int* block_pnts, int nblocks,
                                   const float* hpp_inv, const float* add,
                                   float sign, long long n, float* out,
                                   void* stream) {
  return ba_with_w_type(w_dtype, [&](auto tag) {
    using T = BA_W_TYPE(tag);
    return ba_launch_wtv_point(static_cast<const T*>(W), v, cam_idx, pnt_idx,
                               pnt_starts, block_pnts, nblocks, hpp_inv, add,
                               sign, n, out, stream);
  });
}

// W_cam (27, n) camera-sorted, in storage w_dtype; t (npnts, 3); plan of
// ops/plans.py:CamColPlan; partial (nruns, 9) f32 scratch; out (ncams, 9).
extern "C" int ba_wt_cam_reduce(const void* W_cam, int w_dtype,
                                const float* t, const BaCamColPlan* plan,
                                int ncams, long long n, float* partial,
                                float* out, void* stream) {
  return ba_with_w_type(w_dtype, [&](auto tag) {
    using T = BA_W_TYPE(tag);
    return ba_launch_wt_cam(static_cast<const T*>(W_cam), n, t, *plan, ncams,
                            partial, out, stream);
  });
}
