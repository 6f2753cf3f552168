// Kernel K3: the Schur coupling product over W, both directions over one
// staged tile.
//
// Replaces the TPU kernels `bundleadjustment_jl_tpu/ops/pallas_schur.py`
// `_mv_scatter_kernel` / `_mv_scatter_fac_kernel` (dispatched by
// `matvec_cam_scatter`, :1550):
//
//   t_p   = sign * Hpp_inv_p (sum_{k in p} W_k' v[cam_k] + g_p)
//   out_c = sum_{cam_k = c} W_k t[pnt_k]
//
// With g_p = 0, sign = +1 this is the W Hpp_inv W' v term of S v; with
// g_p, sign = -1, t is the back-substituted point step dp and out the
// |J d|^2 cross term's camera sums.
//
// Design (cam_pass.cuh): G blocks walk the plan's visits of point-bounded
// tiles of at most BA_TILE_ROWS rows, tiles ahead in flight (cp.async).
// A visit stages its tile's W once, as the TPU kernel keeps it in VMEM for
// both directions, and
//
//   1. point pass: a thread per row (coalesced from shared memory) forms
//      W_k' v[cam_k] into shared memory, then the owner thread of each point
//      the tile owns sums its rows in row order (as K5's point walk,
//      wtv_point.cuh), folds t_p, writes it to t and keeps it in shared
//      memory;
//   2. camera pass: W op's (cam_reduce.cu): each row's W_k t_p in row
//      order, then a thread per run (one camera's rows of the tile) sums
//      them and adds the sums to the block's accumulator row of the camera
//      in shared memory, or past shared memory writes them to the run's
//      row of per-run sums, which one block a camera then sums.
//
// A point of more than BA_TILE_ROWS rows is cut into tiles of its own,
// visited twice: their point passes first (carrying its sum to its last
// tile, which folds t_p), then their camera passes. A second kernel sums
// each camera's G accumulator rows in block order. No atomics: fixed-order
// sums, bit-identical repeats, no bound on the camera count.
//
// W is read in its storage type (float, bf16 or f16: w_dtype, w_store.cuh)
// and widened at the load; t, the sums and the fold are float.
//
// Bound: the least traffic reads W once (108 B a row in f32, 147 MB at
// Dubrovnik-356, n = 1,360,384; half that in bf16 / f16), and this design
// reads it once; plus cam_idx, pnt_idx and the plan (~12 B a row), v and
// the point operands. ~54 FMA a row a direction.
#include "cam_pass.cuh"

namespace {

// EMIT_ACC: the camera sums in shared memory, out the (G, ncams, 9)
// slices; EMIT_RUNS: each run's sums to out (nruns, 9).
template <class S, int EMIT>
__global__ void __launch_bounds__(BA_BLOCK) ba_matvec_kernel(
    BaRows<S> in, BaTilePlan plan, const float* __restrict__ v,
    const int* __restrict__ cam_idx, const int* __restrict__ pnt_starts,
    const float* __restrict__ hpp_inv, const float* __restrict__ gp,
    float sign, int ncams, float* t, float* __restrict__ out) {
  using L = BaStage<ProdWOp, S, true>;
  constexpr int NST = L::NST, C = L::C, P = L::P;
  extern __shared__ __align__(16) unsigned char ba_smem[];
  __shared__ BaTileMeta meta[NST];
  __shared__ float carry[3];
  float* ys = reinterpret_cast<float*>(ba_smem + L::YS);
  float* sy = reinterpret_cast<float*>(ba_smem + L::SY);
  float* st = reinterpret_cast<float*>(ba_smem + L::ST);
  float* acc = reinterpret_cast<float*>(ba_smem + L::ALL);
  if constexpr (EMIT == BA_EMIT_ACC) ba_acc_zero(acc, ncams * 9);
  // The span: visits from the first START visit at or after count g / G.
  auto start_at = [&](int j) {
    while (j < plan.nvisits && !(__ldg(plan.visits + j) & BA_VISIT_START))
      ++j;
    return j;
  };
  const int lo = start_at(ba_span(plan.nvisits, blockIdx.x, gridDim.x));
  const int hi = start_at(ba_span(plan.nvisits, blockIdx.x + 1, gridDim.x));
  auto head = [&](int code) {
    return ba_tile_head(plan, code >> 3, code & 7);
  };
  auto stage = [&](const BaTileHead& h, int b) {
    ba_stage_tile<ProdWOp, S, true>(ba_smem + b * L::BYTES, meta[b], h, in,
                                    plan, cam_idx, pnt_starts, hpp_inv, gp);
  };
  // Where the camera pass finds t: st[p - st_base] when the last point
  // pass kept it in shared memory, else t itself.
  int st_base = 0;
  bool st_ok = false;
  int j = lo;
  for (int k = 0; k < NST - 1; ++k, ++j) {
    if (j < hi) stage(head(__ldg(plan.visits + j)), k);
    ba_cp_commit();
  }
  // The head of visit j and the code of visit j + 1, read a visit ahead.
  BaTileHead next{};
  int code_next = 0;
  if (j < hi) next = head(__ldg(plan.visits + j));
  if (j + 1 < hi) code_next = __ldg(plan.visits + j + 1);
  for (int i = lo, k = 0; i < hi; ++i, ++k, ++j) {
    BaTileHead after{};
    int code_after = 0;
    if (j + 1 < hi) after = head(code_next);
    if (j + 2 < hi) code_after = __ldg(plan.visits + j + 2);
    if (j < hi) stage(next, (k + NST - 1) % NST);
    ba_cp_commit();
    ba_cp_wait<NST - 1>();
    __syncthreads();
    const int b = k % NST;
    const BaTileMeta& m = meta[b];
    const unsigned char* buf = ba_smem + b * L::BYTES;
    if (m.flags & BA_VISIT_POINT) {
      const int len = m.r1 - m.r0;
      const S* sx = reinterpret_cast<const S*>(buf + L::X) + m.o_x;
      const int* ccam = reinterpret_cast<const int*>(buf + L::CCAM) + m.o_ccam;
      for (int loc = threadIdx.x; loc < len; loc += BA_BLOCK) {
        const float* vc = v + 9 * (size_t)ccam[loc];
#pragma unroll
        for (int bb = 0; bb < 3; ++bb) {
          float y = 0.f;
#pragma unroll
          for (int a = 0; a < 9; ++a)
            y += ba_ldw(sx, (long long)(3 * a + bb) * L::SP + loc) *
                 __ldg(vc + a);
          sy[bb * C + loc] = y;
        }
      }
      __syncthreads();
      const int nq = m.q1 - m.q0;
      const int* sps = reinterpret_cast<const int*>(buf + L::PS) + m.o_ps;
      const float* shpp = reinterpret_cast<const float*>(buf + L::HPP) + m.o_hpp;
      const float* sgp = reinterpret_cast<const float*>(buf + L::GP) + m.o_gp;
      for (int jq = threadIdx.x; jq < nq; jq += BA_BLOCK) {
        const int p = m.q0 + jq;
        const int ps0 = m.pts_staged ? sps[jq] : __ldg(pnt_starts + p);
        const int ps1 = m.pts_staged ? sps[jq + 1] : __ldg(pnt_starts + p + 1);
        // Only a long point's last tile holds a point that began before it.
        const bool cont = jq == 0 && ps0 < m.r0;
        float s[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) s[d] = cont ? carry[d] : 0.f;
        for (int r = max(ps0, m.r0); r < ps1; ++r)
#pragma unroll
          for (int d = 0; d < 3; ++d) s[d] += sy[d * C + r - m.r0];
        if (gp != nullptr) {
          const float* g = m.pts_staged ? sgp + 3 * jq : gp + 3 * (size_t)p;
#pragma unroll
          for (int d = 0; d < 3; ++d) s[d] += g[d];
        }
        const float* h = m.pts_staged ? shpp + 9 * jq : hpp_inv + 9 * (size_t)p;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float tp =
              sign * (h[3 * a] * s[0] + h[3 * a + 1] * s[1] + h[3 * a + 2] * s[2]);
          t[3 * (size_t)p + a] = tp;
          if (nq <= P) st[3 * jq + a] = tp;
        }
      }
      if (nq == 0 && threadIdx.x == 0) {
        // A tile inside a long point: its rows carry to the point's next
        // tile (the point's first tile starts the carry).
        float s[3];
#pragma unroll
        for (int d = 0; d < 3; ++d)
          s[d] = (m.flags & BA_VISIT_START) ? 0.f : carry[d];
        for (int r = 0; r < len; ++r)
#pragma unroll
          for (int d = 0; d < 3; ++d) s[d] += sy[d * C + r];
#pragma unroll
        for (int d = 0; d < 3; ++d) carry[d] = s[d];
      }
      if (nq > 0) {
        st_base = m.q0;
        st_ok = nq <= P;
      }
      __syncthreads();
    }
    if (m.flags & BA_VISIT_CAMERA) {
      float tl[3];
      ba_tile_runs<ProdWOp, S, true, EMIT>(
          buf, m, acc, ys, out,
          [&](int p, const float*& a, const float*& bb) {
            // t written this launch: read through L2 (__ldcg), never the
            // read-only path.
#pragma unroll
            for (int d = 0; d < 3; ++d)
              tl[d] = st_ok ? st[3 * (p - st_base) + d]
                            : __ldcg(t + 3 * (size_t)p + d);
            a = tl;
            bb = nullptr;
          });
    }
    __syncthreads();
    next = after;
    code_next = code_after;
  }
  if constexpr (EMIT == BA_EMIT_ACC) ba_acc_out(acc, ncams * 9, out);
}

// K3 on ``stream``: BA_PATH_SMEM with ``nblocks`` = G blocks and scratch
// the (G, ncams, 9) slices; BA_PATH_RUNS with scratch the (nruns, 9)
// partials.
template <class S>
int ba_launch_matvec(const BaRows<S>& in, const BaTilePlan& plan,
                     const float* v, const int* cam_idx,
                     const int* pnt_starts, const float* hpp_inv,
                     const float* gp, float sign, int ncams, int path,
                     int nblocks, float* t, float* scratch, float* out,
                     void* stream) {
  using L = BaStage<ProdWOp, S, true>;
  if (plan.rows != BA_TILE_ROWS || ncams <= 0 || nblocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == BA_PATH_RUNS) {
    static const size_t limit =
        ba_smem_limit(ba_matvec_kernel<S, BA_EMIT_RUNS>);
    const size_t bytes = L::ALL + (size_t)BA_TILE_ROWS * 9 * 4;
    if (bytes > limit) return static_cast<int>(cudaErrorInvalidValue);
    ba_matvec_kernel<S, BA_EMIT_RUNS><<<nblocks, BA_BLOCK, bytes, s>>>(
        in, plan, v, cam_idx, pnt_starts, hpp_inv, gp, sign, ncams, t,
        scratch);
    BA_RETURN_IF_LAUNCH_FAILED();
    return ba_launch_runs_sum<9>(scratch, plan, ncams, out, s);
  }
  if (path != BA_PATH_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  static const size_t limit = ba_smem_limit(ba_matvec_kernel<S, BA_EMIT_ACC>);
  const size_t bytes = L::ALL + (size_t)ncams * 9 * 4;
  if (bytes > limit) return static_cast<int>(cudaErrorInvalidValue);
  ba_matvec_kernel<S, BA_EMIT_ACC><<<nblocks, BA_BLOCK, bytes, s>>>(
      in, plan, v, cam_idx, pnt_starts, hpp_inv, gp, sign, ncams, t,
      scratch);
  BA_RETURN_IF_LAUNCH_FAILED();
  return ba_launch_slice_sum<9, 0>(scratch, nblocks, ncams, out, s);
}

}  // namespace

// W (27, n) planes in storage w_dtype; v (ncams, 9); plan: the K2 tiles
// and K3's visits; hpp_inv (npnts, 9); gp (npnts, 3) or null; path and
// nblocks of ops/plans.py:cam_pass_path; t (npnts, 3) out; scratch the
// path's (nblocks, ncams, 9) slices or (nruns, 9) partials, f32; out
// (ncams, 9).
extern "C" int ba_matvec(const void* W, int w_dtype, const float* v,
                         const int* cam_idx, const int* pnt_idx,
                         const int* pnt_starts, const BaTilePlan* plan,
                         const float* hpp_inv, const float* gp, float sign,
                         int ncams, long long n, int path, int nblocks,
                         float* t, float* scratch, float* out,
                         void* stream) {
  return ba_with_w_type(w_dtype, [&](auto tag) {
    using T = BA_W_TYPE(tag);
    return ba_launch_matvec<T>(
        BaRows<T>{static_cast<const T*>(W), n, pnt_idx, nullptr, nullptr},
        *plan, v, cam_idx, pnt_starts, hpp_inv, gp, sign, ncams, path,
        nblocks, t, scratch, out, stream);
  });
}

// K3's sizes for storage w_dtype (which 0: the stages and the unbuffered
// part, before the shared accumulators; 1: the most dynamic shared memory
// its block pass may take on this card); -1 for an unknown storage.
extern "C" long long ba_matvec_bytes(int w_dtype, int which) {
  long long got = -1;
  ba_with_w_type(w_dtype, [&](auto tag) {
    using T = BA_W_TYPE(tag);
    if (which == 0)
      got = BaStage<ProdWOp, T, true>::ALL;
    else if (which == 1)
      got = (long long)ba_smem_limit(ba_matvec_kernel<T, BA_EMIT_ACC>);
    return 0;
  });
  return got;
}
