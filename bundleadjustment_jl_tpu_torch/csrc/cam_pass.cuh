// The camera direction over the point-sorted rows, read through cam_perm:
// per-camera sums of a per-row product (K2, cam_reduce.cu) and K3's fused
// matvec (matvec.cu). The counterpart of the TPU kernels
// `bundleadjustment_jl_tpu/ops/pallas_schur.py` `_cam_scatter_kernel`
// (`cam_scatter_reduce`, :1109) and `_mv_scatter_kernel`
// (`matvec_cam_scatter`, :1550), which keep a camera accumulator in VMEM
// and a tile of W there for both of K3's directions.
//
// Read in camera order, each of a row's planes is a 2 or 4 B load at a
// random row: a 32 B sector each. So the rows are read in point order, in
// tiles of at most BA_TILE_ROWS (C) rows cut at point boundaries (plan
// `ops/plans.py:TilePlan`; a point longer than C rows is cut into tiles of
// its own), and within a tile each camera's rows form one *run*.
//
// Per-block sums (BA_PATH_SMEM): a fixed number G of blocks (a plan
// constant, never the card's SM count) each walks a contiguous span of
// tiles in order, staging each tile with cp.async (the tile's planes, its
// rows in camera order, its runs, the rows' points and the per-point
// operands): the 45- and 54-sum products a tile ahead, so one tile's
// loads overlap the previous tile's sums in their one block an SM; W op
// and K3 one tile at a time in several blocks an SM, which overlap one
// another (G counts them: ops/plans.py:cam_pass_path). A thread per run sums the run's rows from shared memory and adds
// the sums into the block's own accumulator row of the run's camera, in
// shared memory: a camera has one run a tile, so no two threads touch one
// row, and tiles are apart by a barrier. The W op product (9 sums) first
// forms every row's 9 values in row order, a thread a row (neighbouring
// rows, no bank conflicts), and a run then sums 9 values a row instead of
// reading 27 planes at its scattered rows. Each block writes its
// accumulators out once at the end; a second kernel sums each camera's G
// rows in block order. Traffic: the rows once, coalesced, plus 2 G ncams
// K 4 B, against 2 K 4 B a run of the per-run partials this replaces (a
// run a row at 13,682 cameras).
//
// Past shared memory (the (ncams, K) floats do not fit beside the stages):
//
//   - W op and K3 (BA_PATH_RUNS): each run's 9 sums written in tile order
//     (in order, a tile's runs side by side), then one block a camera
//     sums its runs through the plan's cam_runs;
//   - the 45- and 54-sum products (BA_PATH_RECORDS): pass 1 stops forming
//     products; it writes each row's planes (and its point) as one record
//     of whole 32 B sectors, in row order (reads and writes in order);
//     pass 2 is one block a camera over its rows (cam_perm), each read at
//     its record, then a fixed-order block sum, as K6 does over its
//     camera-sorted copies. The solves take it for route A's W C W' |
//     W t alone (W C W': the Schur check): the split assembly sums cam90,
//     and route B1's W C W' | W t, without records, re-deriving each row's
//     Jc and r, or its W, in camera order (linearize.cu,
//     ba_cam_relin_cam90_kernel and ba_cam_relin_wcw_rhs_kernel, in this
//     pass 2's order); the records remain as those walks' references.
//
// Measured and dropped (PERF.md): accumulators in global memory, a slice
// a block (2.4-2.5 ms for W op at Final-4585 against 0.93 for the per-run
// partials before: a run's read-modify-write of 9 floats at a random
// camera is 18 uncoalesced L2 accesses); the cameras cut into ranges, one a block of
// each span (every block of a span stages the whole tile: H x the staging
// for 1 / H of the sums, slower than runs or records at every H > 1);
// records written in camera order through the inverse of cam_perm (the
// scattered record writes: cam90 at Final-4585 2.31 ms against 1.04 in
// row order).
//
// K3 (matvec.cu, ba_launch_matvec): the tiles' visits (plan `visits`)
// walked by G blocks; a visit stages its tile once and does both
// directions over it: the point pass (each row's W' v[cam] into shared
// memory, then each point's rows summed in row order by its owner thread,
// folded into t_p = sign Hpp_inv_p (s + g_p), written to t and kept in
// shared memory) and the camera pass (W op's, with t). A point cut into
// several tiles is visited twice: its tiles' point passes first (carrying
// its sum), then their camera passes.
//
// No atomics: every sum is taken in a fixed order that depends on the
// problem alone, so a repeat launch is bit-identical; a camera without
// rows gives exact zeros; no limit on the camera count.
#pragma once

#include <cstdint>

#include "cam_prod.cuh"

// C: the most rows a tile holds (ops/plans.py:TILE_ROWS; a plan of another
// size is refused). Tiles cut at point boundaries hold about C - C / 8 rows
// on average (ops/plans.py:tile_bounds).
constexpr int BA_TILE_ROWS = 512;
// Points whose operands a tile stages; a tile that spans more (points
// without rows) reads them from global memory.
constexpr int BA_TILE_PNTS = 128;
// Tiles a block has in flight (1: staged, then summed; 2: double-buffered):
// the 45- and 54-sum products (one block an SM: ~175 registers a thread),
// and W op and K3 (64 registers: several blocks an SM, which overlap one
// another's loads and sums). Chosen by measurement (`tile_sweep --sweep
// tiles`, PERF.md).
constexpr int BA_STAGES = 2;
constexpr int BA_STAGES_K9 = 1;

// Paths (ops/plans.py:PATHS).
constexpr int BA_PATH_SMEM = 0;
constexpr int BA_PATH_RECORDS = 1;
constexpr int BA_PATH_RUNS = 2;

// Flags of a K3 visit (ops/plans.py:VISIT_*): visits[i] = tile << 3 | flags.
constexpr int BA_VISIT_POINT = 1;
constexpr int BA_VISIT_CAMERA = 2;
constexpr int BA_VISIT_START = 4;   // a block's span may start here

// The plan as ops/_cuda.py:TilePlanC passes it (ops/plans.py:TilePlan and
// RecordPlan).
struct BaTilePlan {
  const int* tile_bounds;      // (ntiles+1,) each tile's rows
  const int* tile_pnts;        // (ntiles+1,) the points each tile owns
  const int* tile_run_starts;  // (ntiles+1,) each tile's runs
  const int* run_cam;          // (nruns,) each run's camera
  const short* run_ends;       // (nruns,) each run's end in its tile's rows
  const short* tile_rows;      // (n,) each tile's rows by camera, local
  const int* visits;           // (nvisits,) K3's walk
  const int* cam_runs;         // (nruns,) the runs by camera (tile order)
  const int* cam_run_starts;   // (ncams+1,) each camera's stretch of them
  const int* cam_perm;         // (n,) the rows in camera order
  const int* cam_starts;       // (ncams+1,)
  int ntiles;
  int nruns;
  int nvisits;
  int rows;                    // C of the plan
  int npnts;
};

__host__ __device__ constexpr size_t ba_al16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

// The shared-memory layout of one stage buffer: the tile's NPL planes in
// the storage type S (C + 2 V a plane: the copy starts at a 16 B boundary
// below the tile's first row), its rows by camera and its runs' ends (16
// bit), its runs' cameras, its rows' points (forms with per-point operands,
// and K3), and the per-point operands of up to BA_TILE_PNTS points; K3
// (MV) also its rows' cameras, and the pnt_starts, Hpp_inv and g_p of the
// points it owns.
template <class Prod, class S, bool MV>
struct BaStage {
  static constexpr int C = BA_TILE_ROWS, P = BA_TILE_PNTS;
  static constexpr int NPL = Prod::NPL, NA = MV ? 0 : Prod::NA,
                       NB = MV ? 0 : Prod::NB;
  static constexpr bool PNT = MV || NA + NB > 0;
  static constexpr int SP = C + 2 * (16 / (int)sizeof(S));
  static constexpr size_t X = 0;
  static constexpr size_t ROWS = X + ba_al16((size_t)NPL * SP * sizeof(S));
  static constexpr size_t ENDS = ROWS + ba_al16((C + 16) * 2);
  static constexpr size_t RCAM = ENDS + ba_al16((C + 16) * 2);
  static constexpr size_t RPNT = RCAM + ba_al16((C + 8) * 4);
  static constexpr size_t A = RPNT + (PNT ? ba_al16((C + 8) * 4) : 0);
  static constexpr size_t B = A + (NA ? ba_al16((P * NA + 8) * 4) : 0);
  static constexpr size_t CCAM = B + (NB ? ba_al16((P * NB + 8) * 4) : 0);
  static constexpr size_t PS = CCAM + (MV ? ba_al16((C + 8) * 4) : 0);
  static constexpr size_t HPP = PS + (MV ? ba_al16((P + 1 + 8) * 4) : 0);
  static constexpr size_t GP = HPP + (MV ? ba_al16((P * 9 + 8) * 4) : 0);
  static constexpr size_t BYTES = GP + (MV ? ba_al16((P * 3 + 8) * 4) : 0);
  // The unbuffered part after the stages: the 9-sum products' per-row
  // values (YS, row order); K3's rows' W' v (SY, in the same place: the
  // point pass is done with them before the camera pass forms YS) and its
  // owned points' t (ST).
  static constexpr bool ROW_FIRST = Prod::K == 9;
  static constexpr int NST = Prod::K == 9 ? BA_STAGES_K9 : BA_STAGES;
  static constexpr size_t YS = NST * BYTES;
  static constexpr size_t SY = YS;
  static constexpr size_t ST =
      YS + (ROW_FIRST ? ba_al16(9 * C * 4) : MV ? ba_al16(3 * C * 4) : 0);
  static constexpr size_t ALL = ST + (MV ? ba_al16(3 * P * 4) : 0);
};

// What a stage buffer holds: its tile and, for each staged array, where
// the tile's first element lies in it.
struct BaTileMeta {
  int flags, r0, r1, q0, q1, s0, s1, qe;
  int o_x, o_rows, o_ends, o_rcam, o_pnt, o_a, o_b, o_ccam, o_ps, o_hpp,
      o_gp;
  int pts_staged;  // the per-point operands (or K3's point data) staged
};

// A tile's bounds, read from the plan a tile ahead of its stage.
struct BaTileHead {
  int flags, r0, r1, q0, q1, s0, s1;
};

namespace {

__device__ __forceinline__ BaTileHead ba_tile_head(const BaTilePlan& plan,
                                                   int t, int flags) {
  BaTileHead h;
  h.flags = flags;
  h.r0 = __ldg(plan.tile_bounds + t);
  h.r1 = __ldg(plan.tile_bounds + t + 1);
  h.q0 = __ldg(plan.tile_pnts + t);
  h.q1 = __ldg(plan.tile_pnts + t + 1);
  h.s0 = __ldg(plan.tile_run_starts + t);
  h.s1 = __ldg(plan.tile_run_starts + t + 1);
  return h;
}

__device__ __forceinline__ void ba_cp16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void ba_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void ba_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copy of src[lo, hi) (of an array of ``total`` elements) into
// dst, which has room for hi - lo + 2 (16 / sizeof(T)) elements; returns
// where src[lo] lands. Whole 16 B chunks go by cp.async when src is 16 B
// aligned, the rest element by element (those stores, like the copies
// after their wait, are seen by the block after its next barrier).
template <class T>
__device__ __forceinline__ int ba_stage(T* dst, const T* src, long long lo,
                                        long long hi, long long total) {
  constexpr int V = 16 / (int)sizeof(T);
  if (hi <= lo) return 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) != 0) {
    for (long long r = lo + threadIdx.x; r < hi; r += BA_BLOCK)
      dst[r - lo] = src[r];
    return 0;
  }
  const long long a0 = lo / V * V;
  const long long a1 = min((hi + V - 1) / V * V, total / V * V);
  const int nch = a1 > a0 ? (int)((a1 - a0) / V) : 0;
  for (int i = threadIdx.x; i < nch; i += BA_BLOCK)
    ba_cp16(dst + (long long)i * V, src + a0 + (long long)i * V);
  for (long long r = max(a1, lo) + threadIdx.x; r < hi; r += BA_BLOCK)
    dst[r - a0] = src[r];
  return (int)(lo - a0);
}

// Issue the stage of tile h into buffer ``buf`` (every thread calls it);
// thread 0 records what it staged in ``meta``.
template <class Prod, class S, bool MV>
__device__ __forceinline__ void ba_stage_tile(
    unsigned char* buf, BaTileMeta& meta, const BaTileHead& h,
    const BaRows<S>& in, const BaTilePlan& plan, const int* cam_idx,
    const int* pnt_starts, const float* hpp_inv, const float* gp) {
  using L = BaStage<Prod, S, MV>;
  constexpr int NPL = L::NPL, V = 16 / (int)sizeof(S);
  BaTileMeta m;
  m.flags = h.flags;
  m.r0 = h.r0;
  m.r1 = h.r1;
  m.q0 = h.q0;
  m.q1 = h.q1;
  m.s0 = h.s0;
  m.s1 = h.s1;
  S* sx = reinterpret_cast<S*>(buf + L::X);
  // The planes: one flat loop of 16 B chunks when every plane starts
  // aligned, else plane by plane.
  if ((reinterpret_cast<uintptr_t>(in.x) & 15) == 0 &&
      (in.n * (long long)sizeof(S)) % 16 == 0) {
    const long long a0 = h.r0 / V * V;
    const int nch = (int)(((long long)h.r1 + V - 1) / V * V - a0) / V;
    // Chunk i = e nch + c, stepped BA_BLOCK at a time without a division.
    int e = threadIdx.x / nch, c = threadIdx.x - e * nch;
    const int de = BA_BLOCK / nch, dc = BA_BLOCK - de * nch;
    for (; e < NPL; e += de, c += dc) {
      if (c >= nch) {
        c -= nch;
        ++e;
        if (e >= NPL) break;
      }
      ba_cp16(sx + (long long)e * L::SP + (long long)c * V,
              in.x + Prod::plane(e) * in.n + a0 + (long long)c * V);
    }
    m.o_x = (int)(h.r0 - a0);
  } else {
    // Planes that start off a 16 B boundary: element by element, every
    // plane from its first row.
    const int len = h.r1 - h.r0;
    for (int i = threadIdx.x; i < NPL * len; i += BA_BLOCK) {
      const int e = i / len, c = i - e * len;
      sx[(long long)e * L::SP + c] = in.x[Prod::plane(e) * in.n + h.r0 + c];
    }
    m.o_x = 0;
  }
  m.o_rows = ba_stage(reinterpret_cast<short*>(buf + L::ROWS),
                      plan.tile_rows, h.r0, h.r1, in.n);
  m.o_ends = ba_stage(reinterpret_cast<short*>(buf + L::ENDS), plan.run_ends,
                      h.s0, h.s1, plan.nruns);
  m.o_rcam = ba_stage(reinterpret_cast<int*>(buf + L::RCAM), plan.run_cam,
                      h.s0, h.s1, plan.nruns);
  m.o_pnt = m.o_a = m.o_b = m.o_ccam = m.o_ps = m.o_hpp = m.o_gp = 0;
  m.qe = max(h.q1, h.q0 + 1);
  m.pts_staged = 0;
  if constexpr (L::PNT)
    m.o_pnt = ba_stage(reinterpret_cast<int*>(buf + L::RPNT), in.pnt_idx,
                       h.r0, h.r1, in.n);
  if constexpr (L::NA + L::NB > 0) {
    // The rows' points lie in [q0, max(q1, q0 + 1)): a tile inside a long
    // point owns none of them.
    if (m.qe - h.q0 <= L::P) {
      m.pts_staged = 1;
      if constexpr (L::NA > 0)
        m.o_a = ba_stage(reinterpret_cast<float*>(buf + L::A), in.a,
                         (long long)h.q0 * L::NA, (long long)m.qe * L::NA,
                         (long long)plan.npnts * L::NA);
      if constexpr (L::NB > 0)
        m.o_b = ba_stage(reinterpret_cast<float*>(buf + L::B), in.b,
                         (long long)h.q0 * L::NB, (long long)m.qe * L::NB,
                         (long long)plan.npnts * L::NB);
    }
  }
  if constexpr (MV) {
    m.o_ccam = ba_stage(reinterpret_cast<int*>(buf + L::CCAM), cam_idx,
                        h.r0, h.r1, in.n);
    if (h.q1 - h.q0 <= L::P) {
      m.pts_staged = 1;
      m.o_ps = ba_stage(reinterpret_cast<int*>(buf + L::PS), pnt_starts,
                        h.q0, h.q1 + 1, plan.npnts + 1);
      m.o_hpp = ba_stage(reinterpret_cast<float*>(buf + L::HPP), hpp_inv,
                         9LL * h.q0, 9LL * h.q1, 9LL * plan.npnts);
      if (gp != nullptr)
        m.o_gp = ba_stage(reinterpret_cast<float*>(buf + L::GP), gp,
                          3LL * h.q0, 3LL * h.q1, 3LL * plan.npnts);
    }
  }
  if (threadIdx.x == 0) meta = m;
}

// Where a run's sums go: the block's shared accumulator row of its camera,
// or (the runs path) its own row of the per-run partials.
constexpr int BA_EMIT_ACC = 0;
constexpr int BA_EMIT_RUNS = 1;

// The camera pass of one staged tile: a thread per run sums its rows (in
// row order) with Prod and adds the sums to its camera's row of the
// block's shared accumulators acc, or (EMIT_RUNS, acc then the tile's run
// sums) writes them to partial[run]. A 9-sum
// product first forms every row's values in row order (a thread a row:
// neighbouring rows, no bank conflicts) into ys, and a run then sums 9 of
// them a row. pnt_op(p, a, b) gives the per-point operands of point p.
// Every thread calls it.
template <class Prod, class S, bool MV, int EMIT, class PntOp>
__device__ __forceinline__ void ba_tile_runs(const unsigned char* buf,
                                             const BaTileMeta& m, float* acc,
                                             float* ys,
                                             float* __restrict__ partial,
                                             PntOp pnt_op) {
  using L = BaStage<Prod, S, MV>;
  constexpr int K = Prod::K, C = L::C;
  const S* sx = reinterpret_cast<const S*>(buf + L::X) + m.o_x;
  const short* rows = reinterpret_cast<const short*>(buf + L::ROWS) + m.o_rows;
  const short* ends = reinterpret_cast<const short*>(buf + L::ENDS) + m.o_ends;
  const int* rcam = reinterpret_cast<const int*>(buf + L::RCAM) + m.o_rcam;
  const int* rpnt = reinterpret_cast<const int*>(buf + L::RPNT) + m.o_pnt;
  auto row_sums = [&](int loc, float (&y)[K]) {
    const float* a = nullptr;
    const float* b = nullptr;
    if constexpr (L::PNT) pnt_op(rpnt[loc], a, b);
    Prod::apply(
        y, [&](int e) { return ba_ldw(sx, (long long)e * L::SP + loc); }, a,
        b);
  };
  if constexpr (L::ROW_FIRST) {
    const int len = m.r1 - m.r0;
    for (int loc = threadIdx.x; loc < len; loc += BA_BLOCK) {
      float y[K];
#pragma unroll
      for (int k = 0; k < K; ++k) y[k] = 0.f;
      row_sums(loc, y);
#pragma unroll
      for (int k = 0; k < K; ++k) ys[k * C + loc] = y[k];
    }
    __syncthreads();
  }
  const int nr = m.s1 - m.s0;
  for (int i = threadIdx.x; i < nr; i += BA_BLOCK) {
    const int q1 = ends[i];
    float sums[K];
#pragma unroll
    for (int k = 0; k < K; ++k) sums[k] = 0.f;
    for (int q = i == 0 ? 0 : ends[i - 1]; q < q1; ++q) {
      if constexpr (L::ROW_FIRST) {
        const int loc = rows[q];
#pragma unroll
        for (int k = 0; k < K; ++k) sums[k] += ys[k * C + loc];
      } else {
        row_sums(rows[q], sums);
      }
    }
    // EMIT_RUNS: acc holds the tile's runs' sums (C x K), written out
    // whole below, a float a thread: one run's sums a thread would make
    // each store instruction touch 32 sectors.
    float* dst = acc + (size_t)(EMIT == BA_EMIT_ACC ? rcam[i] : i) * K;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if constexpr (EMIT == BA_EMIT_ACC) {
        dst[k] += sums[k];
      } else {
        dst[k] = sums[k];
      }
    }
  }
  if constexpr (EMIT == BA_EMIT_RUNS) {
    __syncthreads();
    float* out = partial + (size_t)m.s0 * K;
    for (int j = threadIdx.x; j < nr * K; j += BA_BLOCK) out[j] = acc[j];
  }
}

// The tiles of span g of G over ``count`` items: [count g / G,
// count (g + 1) / G).
__device__ __forceinline__ int ba_span(int count, int g, int G) {
  return (int)((long long)count * g / G);
}

// Zero the block's accumulators (``count`` floats) before its first tile.
__device__ __forceinline__ void ba_acc_zero(float* acc, int count) {
  for (int i = threadIdx.x; i < count; i += BA_BLOCK) acc[i] = 0.f;
}

// After the block's last tile: its accumulators out to slice blockIdx.x,
// ``count`` floats.
__device__ __forceinline__ void ba_acc_out(const float* acc, int count,
                                           float* __restrict__ slices) {
  float* dst = slices + (size_t)blockIdx.x * count;
  for (int i = threadIdx.x; i < count; i += BA_BLOCK) dst[i] = acc[i];
}

// K2, pass 1: block b walks the tiles of span b of G, L::NST in
// flight; EMIT_ACC: sums the runs into shared memory, then writes them to
// out[b] of the (G, ncams, K) slices; EMIT_RUNS: writes each run's sums to
// out (nruns, K).
template <class Prod, class S, int EMIT>
__global__ void __launch_bounds__(BA_BLOCK) ba_cam_pass_kernel(
    BaRows<S> in, BaTilePlan plan, int ncams, float* __restrict__ out) {
  using L = BaStage<Prod, S, false>;
  constexpr int K = Prod::K, NST = L::NST;
  extern __shared__ __align__(16) unsigned char ba_smem[];
  __shared__ BaTileMeta meta[NST];
  float* ys = reinterpret_cast<float*>(ba_smem + L::YS);
  float* acc = reinterpret_cast<float*>(ba_smem + L::ALL);
  if constexpr (EMIT == BA_EMIT_ACC) ba_acc_zero(acc, ncams * K);
  const int lo = ba_span(plan.ntiles, blockIdx.x, gridDim.x);
  const int hi = ba_span(plan.ntiles, blockIdx.x + 1, gridDim.x);
  auto stage = [&](const BaTileHead& h, int b) {
    ba_stage_tile<Prod, S, false>(ba_smem + b * L::BYTES, meta[b], h, in,
                                  plan, nullptr, nullptr, nullptr, nullptr);
  };
  int t = lo;
  for (int k = 0; k < NST - 1; ++k, ++t) {
    if (t < hi) stage(ba_tile_head(plan, t, BA_VISIT_CAMERA), k);
    ba_cp_commit();
  }
  BaTileHead next{};
  if (t < hi) next = ba_tile_head(plan, t, BA_VISIT_CAMERA);
  for (int i = lo, k = 0; i < hi; ++i, ++k, ++t) {
    // t = i + NST - 1: stage it; read the head of the tile after it.
    BaTileHead after{};
    if (t + 1 < hi) after = ba_tile_head(plan, t + 1, BA_VISIT_CAMERA);
    if (t < hi) stage(next, (k + NST - 1) % NST);
    ba_cp_commit();
    ba_cp_wait<NST - 1>();
    __syncthreads();
    const int b = k % NST;
    const BaTileMeta& m = meta[b];
    const unsigned char* buf = ba_smem + b * L::BYTES;
    const float* sa = reinterpret_cast<const float*>(buf + L::A) + m.o_a;
    const float* sb = reinterpret_cast<const float*>(buf + L::B) + m.o_b;
    ba_tile_runs<Prod, S, false, EMIT>(
        buf, m, acc, ys, out, [&](int p, const float*& a, const float*& bb) {
          if (m.pts_staged) {
            a = sa + (size_t)L::NA * (p - m.q0);
            bb = sb + (size_t)L::NB * (p - m.q0);
          } else {
            a = in.a + (size_t)L::NA * p;
            bb = in.b + (size_t)L::NB * p;
          }
        });
    __syncthreads();
    next = after;
  }
  if constexpr (EMIT == BA_EMIT_ACC) ba_acc_out(acc, ncams * K, out);
}

// Pass 2 of the runs path: one block per camera sums its runs' partials
// (cam_runs[cam_run_starts[c] .. cam_run_starts[c+1]), tile order), then a
// fixed-order block sum.
template <int K>
__global__ void __launch_bounds__(BA_BLOCK) ba_runs_sum_kernel(
    const float* __restrict__ partial, const int* __restrict__ cam_runs,
    const int* __restrict__ cam_run_starts, float* __restrict__ out) {
  const int c = blockIdx.x;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  const int end = cam_run_starts[c + 1];
  for (int j = cam_run_starts[c] + threadIdx.x; j < end; j += BA_BLOCK) {
    const float* p = partial + (size_t)K * __ldg(cam_runs + j);
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] += p[k];
  }
  __shared__ float tot[K];
  ba_block_sum<K>(acc, tot);
  __syncthreads();
  ba_cam_out<K, 0>(tot, out + K * (size_t)c);
}

// Pass 2 of the per-block sums: out[c] = the sums of camera c's G rows in
// block order, as (ncams, d_out) (the symmetric 81 written out whole).
template <int K, int SYM>
__global__ void __launch_bounds__(BA_BLOCK) ba_slice_sum_kernel(
    const float* __restrict__ slices, int G, int ncams,
    float* __restrict__ out) {
  constexpr int D = (SYM ? 81 : 0) + (K - SYM);
  const long long i = (long long)blockIdx.x * BA_BLOCK + threadIdx.x;
  if (i >= (long long)ncams * D) return;
  const int c = (int)(i / D), ko = (int)(i - (long long)c * D);
  int k = ko;
  if constexpr (SYM > 0) {
    if (ko < 81) {
      const int a = ko / 9, d = ko % 9;
      k = a <= d ? ba_tri9(a, d) : ba_tri9(d, a);
    } else {
      k = SYM + ko - 81;
    }
  }
  const size_t stride = (size_t)ncams * K;
  const float* p = slices + (size_t)c * K + k;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += p[g * stride];
  out[i] = s;
}

// A record of one row in camera order: its NPL planes in the storage type
// (packed two to a word when 2 B) and, for a product with per-point
// operands, its point in the last word; whole 32 B sectors.
template <class Prod, class S>
struct BaRec {
  static constexpr bool PNT = Prod::NA + Prod::NB > 0;
  static constexpr int BYTES =
      (int)((Prod::NPL * sizeof(S) + (PNT ? 4 : 0) + 31) / 32 * 32);
  static constexpr int WORDS = BYTES / 4;
};

__device__ __forceinline__ unsigned ba_rec_bits(const float* p,
                                                long long i) {
  return __float_as_uint(p[i]);
}
template <class S>
__device__ __forceinline__ unsigned ba_rec_bits(const S* p, long long i) {
  return reinterpret_cast<const unsigned short*>(p)[i];
}

// Element e of a record's words, widened to float.
template <class S>
__device__ __forceinline__ float ba_rec_ld(const unsigned* w, int e) {
  if constexpr (sizeof(S) == 4) {
    return __uint_as_float(w[e]);
  } else {
    const unsigned short u =
        (unsigned short)((e & 1) ? w[e >> 1] >> 16 : w[e >> 1] & 0xffffu);
    if constexpr (std::is_same<S, __nv_bfloat16>::value) {
      return __uint_as_float((unsigned)u << 16);
    } else {
      return __half2float(__ushort_as_half(u));
    }
  }
}

// Records, pass 1: a thread per row, its planes read coalesced, packed
// into shared memory and written out by the block a word a thread, in
// row order (a record a thread would make each store instruction touch 32
// sectors).
template <class Prod, class S>
__global__ void __launch_bounds__(BA_BLOCK) ba_rec_write_kernel(
    BaRows<S> in, unsigned* __restrict__ rec) {
  using R = BaRec<Prod, S>;
  constexpr int WS = R::WORDS + 1;  // odd: a word's lanes on 32 banks
  __shared__ unsigned stage[BA_BLOCK * WS];
  const long long i0 = (long long)blockIdx.x * BA_BLOCK;
  const long long i = i0 + threadIdx.x;
  if (i < in.n) {
    unsigned w[R::WORDS];
#pragma unroll
    for (int q = 0; q < R::WORDS; ++q) w[q] = 0u;
#pragma unroll
    for (int e = 0; e < Prod::NPL; ++e) {
      const unsigned v = ba_rec_bits(in.x, Prod::plane(e) * in.n + i);
      if constexpr (sizeof(S) == 4) {
        w[e] = v;
      } else {
        w[e >> 1] |= (e & 1) ? v << 16 : v;
      }
    }
    if constexpr (R::PNT) w[R::WORDS - 1] = (unsigned)__ldg(in.pnt_idx + i);
#pragma unroll
    for (int q = 0; q < R::WORDS; ++q) stage[threadIdx.x * WS + q] = w[q];
  }
  __syncthreads();
  const int count = (int)min((long long)BA_BLOCK, in.n - i0) * R::WORDS;
  unsigned* out = rec + i0 * R::WORDS;
  for (int j = threadIdx.x; j < count; j += BA_BLOCK)
    out[j] = stage[(j / R::WORDS) * WS + j % R::WORDS];
}

// Records, pass 2: one block per camera over its rows cam_perm[j], j in
// [cam_starts[c], cam_starts[c+1]), each read at its record, then a
// fixed-order block sum.
template <class Prod, class S>
__global__ void __launch_bounds__(BA_BLOCK) ba_rec_sum_kernel(
    const uint4* __restrict__ rec, const int* __restrict__ cam_perm,
    const int* __restrict__ cam_starts, const float* __restrict__ A,
    const float* __restrict__ B, float* __restrict__ out) {
  using R = BaRec<Prod, S>;
  constexpr int K = Prod::K;
  const int c = blockIdx.x;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  const int end = cam_starts[c + 1];
  for (int j = cam_starts[c] + threadIdx.x; j < end; j += BA_BLOCK) {
    unsigned w[R::WORDS];
    const uint4* src = rec + (size_t)__ldg(cam_perm + j) * (R::WORDS / 4);
#pragma unroll
    for (int q = 0; q < R::WORDS / 4; ++q) {
      const uint4 v = __ldg(src + q);
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
    const float* a = nullptr;
    const float* b = nullptr;
    if constexpr (R::PNT) {
      const size_t p = w[R::WORDS - 1];
      a = A + Prod::NA * p;
      b = B + Prod::NB * p;
    }
    Prod::apply(acc, [&](int e) { return ba_rec_ld<S>(w, e); }, a, b);
  }
  __shared__ float tot[K];
  ba_block_sum<K>(acc, tot);
  __syncthreads();
  ba_cam_out<K, Prod::SYM>(tot, out + ba_d_out<Prod>() * (size_t)c);
}

// The largest dynamic shared memory ``kernel`` may take (the card's
// opt-in limit less its static part), set on it once, with the SM's
// unified L1 / shared memory split asked to its most shared memory, so
// that the blocks an SM ops/plans.py:cam_pass_path counts on can share
// it; 0 if that failed.
template <class Kernel>
size_t ba_smem_limit(Kernel kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr{};
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess)
    return 0;
  const size_t limit = (size_t)optin - attr.sharedSizeBytes;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)limit) != cudaSuccess ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared) != cudaSuccess)
    return 0;
  return limit;
}

template <int K, int SYM>
int ba_launch_slice_sum(const float* slices, int G, int ncams, float* out,
                        cudaStream_t s) {
  constexpr int D = (SYM ? 81 : 0) + (K - SYM);
  const long long total = (long long)ncams * D;
  if (total == 0) return 0;
  ba_slice_sum_kernel<K, SYM>
      <<<(unsigned)((total + BA_BLOCK - 1) / BA_BLOCK), BA_BLOCK, 0, s>>>(
          slices, G, ncams, out);
  BA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// The runs path's second pass (K = 9): one block a camera.
template <int K>
int ba_launch_runs_sum(const float* partial, const BaTilePlan& plan,
                       int ncams, float* out, cudaStream_t s) {
  ba_runs_sum_kernel<K><<<ncams, BA_BLOCK, 0, s>>>(
      partial, plan.cam_runs, plan.cam_run_starts, out);
  BA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// K2 on ``stream`` by ``path``: BA_PATH_SMEM with ``nblocks`` = G blocks
// and scratch the (G, ncams, K) f32 slices; BA_PATH_RUNS (K = 9) with G
// blocks and scratch the (nruns, K) f32 partials; BA_PATH_RECORDS (K > 9)
// with scratch the (n, BaRec::BYTES) records. 0 or the CUDA error
// (cudaErrorInvalidValue for a plan of another C, a path the product does
// not have, or a block past the card's shared memory).
template <class Prod, class S>
int ba_launch_cam_pass(const BaRows<S>& in, const BaTilePlan& plan,
                       int ncams, int path, int nblocks, void* scratch,
                       float* out, void* stream) {
  constexpr int K = Prod::K;
  using L = BaStage<Prod, S, false>;
  if (plan.rows != BA_TILE_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ncams <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == BA_PATH_RECORDS) {
    if constexpr (K > 9) {
      if (in.n > 0) {
        ba_rec_write_kernel<Prod, S>
            <<<(unsigned)((in.n + BA_BLOCK - 1) / BA_BLOCK), BA_BLOCK, 0,
               s>>>(in, static_cast<unsigned*>(scratch));
        BA_RETURN_IF_LAUNCH_FAILED();
      }
      ba_rec_sum_kernel<Prod, S><<<ncams, BA_BLOCK, 0, s>>>(
          static_cast<const uint4*>(scratch), plan.cam_perm, plan.cam_starts,
          in.a, in.b, out);
      BA_RETURN_IF_LAUNCH_FAILED();
      return 0;
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (nblocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  float* part = static_cast<float*>(scratch);
  if (path == BA_PATH_RUNS) {
    if constexpr (K == 9) {
      static const size_t limit =
          ba_smem_limit(ba_cam_pass_kernel<Prod, S, BA_EMIT_RUNS>);
      const size_t bytes = L::ALL + (size_t)BA_TILE_ROWS * K * 4;
      if (bytes > limit) return static_cast<int>(cudaErrorInvalidValue);
      ba_cam_pass_kernel<Prod, S, BA_EMIT_RUNS>
          <<<nblocks, BA_BLOCK, bytes, s>>>(in, plan, ncams, part);
      BA_RETURN_IF_LAUNCH_FAILED();
      return ba_launch_runs_sum<K>(part, plan, ncams, out, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (path != BA_PATH_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  static const size_t limit =
      ba_smem_limit(ba_cam_pass_kernel<Prod, S, BA_EMIT_ACC>);
  const size_t bytes = L::ALL + (size_t)ncams * K * 4;
  if (bytes > limit) return static_cast<int>(cudaErrorInvalidValue);
  ba_cam_pass_kernel<Prod, S, BA_EMIT_ACC>
      <<<nblocks, BA_BLOCK, bytes, s>>>(in, plan, ncams, part);
  BA_RETURN_IF_LAUNCH_FAILED();
  return ba_launch_slice_sum<K, Prod::SYM>(part, nblocks, ncams, out, s);
}

}  // namespace
