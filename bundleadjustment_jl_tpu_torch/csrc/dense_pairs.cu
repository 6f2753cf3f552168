// The dense Schur step's reduced camera system, assembled by camera pairs
// (no TPU kernel: the JAX package builds S from two dense (3 npnts,
// 9 ncams) targets and one matmul, `ops/schur.py:assemble_dense_schur`):
//
//   S = blockdiag(Hcc_l) - sum_p sum_{k,l in p} W_k Hpp_inv[p] W_l'
//
// as a dense row-major (9 ncams, 9 ncams) float32 matrix, both triangles
// written. The sum has only sum_p n_p (n_p + 1) / 2 nonzero 9x9 terms
// (15,102,831 at Venice-1778, ~8.2 GFLOP), where the targets take 382 GB
// and 1,527 TFLOP there.
//
// The plan (`ops/plans.py:PairPlan`) lists every point's pairs of rows
// (i, j), oriented so that cam_i >= cam_j, sorted by their 9x9 block
// (cam_i, cam_j) of S's lower triangle and cut into chunks of at most
// PAIR_CHUNK pairs (a block with no pair has one empty chunk). Three
// kernels:
//
//   ba_pair_rows_kernel: W (27, ldw) in its storage type to two row-major
//     float32 copies, W_k and Y_k = W_k Hpp_inv[p], 28 floats (112 bytes,
//     16-byte aligned) a row, staged through shared memory and written as
//     contiguous 16-byte stores: a pair's gather of a row is then 7
//     aligned 16-byte loads and not 27 loads from 27 planes, and the pair
//     loop reads no point block.
//   ba_pair_chunk_kernel: a group of 9 lanes a chunk (3 groups a warp),
//     lane a the row a of the 9x9 block: for each pair in the chunk's
//     order acc[b] += Y_i[a, :] . W_j[b, :], two pairs' rows loaded before
//     either is added. On a diagonal block a pair of two rows (a point
//     seen twice by one camera) adds Y_j W_i' too, as the targets' sum
//     does. A block of one chunk is written at once: Hcc_l - acc on the
//     diagonal (-acc with no Hcc_l), -acc below it and its transpose
//     above; the chunks of a longer block write their sums to partial
//     slots.
//   ba_pair_merge_kernel: a group a block of several chunks sums its slots
//     in order and writes the block as above.
//
// Every entry of S is written once, by one group, in a fixed order: no
// atomics, so repeat launches are bit-identical. The transposed block is
// written straight from the lanes (lane a: column 9 cam_i + a); the lower
// one goes through shared memory so that its 9 lanes write 9 consecutive
// floats of a row too.
//
// Bound: bytes. At Venice-1778 reading W (540 MB in float32), Hpp_inv (36
// MB) and the plan (140 MB) and writing S once (1,024 MB): 0.52 ms at
// 3.35 TB/s. The kernels move more: the two row copies (1.1 GB written,
// read back in part), and each pair's gather of W_j, which lies in another
// camera's rows (the Y_i rows, of the block row's camera, stay in L2
// while its row of blocks is summed).
#include "chain.cuh"
#include "w_store.cuh"

// Floats a row of the row-major W copy: 27 and one of padding.
constexpr int BA_PAIR_ROW = 28;
// Threads a block of the chunk and merge kernels: 4 warps of 3 groups.
constexpr int BA_PAIR_THREADS = 128;
constexpr int BA_PAIR_GROUPS = BA_PAIR_THREADS / 32 * 3;

namespace {

// Rows of a block of the row pass.
constexpr int BA_PAIR_ROWS_BLOCK = 128;

// The row pass: rows k of [row0, row0 + blockDim) of W (27, ldw) in its
// storage type to wr[k] (W_k, row-major 9x3, float32) and yr[k] (Y_k = W_k
// Hpp_inv[pnt_k]), 28 floats a row, staged in shared memory so that the
// block writes both as contiguous 16-byte stores.
template <class T>
__global__ void __launch_bounds__(BA_PAIR_ROWS_BLOCK) ba_pair_rows_kernel(
    const T* __restrict__ W, long long ldw, long long nobs,
    const float* __restrict__ hinv, const int* __restrict__ pnt,
    float* __restrict__ wr, float* __restrict__ yr) {
  __shared__ __align__(16) float sw[BA_PAIR_ROWS_BLOCK * BA_PAIR_ROW];
  __shared__ __align__(16) float sy[BA_PAIR_ROWS_BLOCK * BA_PAIR_ROW];
  const long long row0 = (long long)blockIdx.x * BA_PAIR_ROWS_BLOCK;
  const long long k = row0 + threadIdx.x;
  float* w = sw + threadIdx.x * BA_PAIR_ROW;
  float* y = sy + threadIdx.x * BA_PAIR_ROW;
  if (k < nobs) {
    float v[27];
#pragma unroll
    for (int e = 0; e < 27; ++e) v[e] = ba_ldw(W, e * ldw + k);
    const float* h = hinv + 9LL * pnt[k];
    float hh[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) hh[e] = __ldg(h + e);
#pragma unroll
    for (int a = 0; a < 9; ++a) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        w[3 * a + c] = v[3 * a + c];
        y[3 * a + c] = fmaf(v[3 * a + 2], hh[6 + c],
                            fmaf(v[3 * a + 1], hh[3 + c],
                                 v[3 * a] * hh[c]));
      }
    }
    w[27] = 0.0f;
    y[27] = 0.0f;
  }
  __syncthreads();
  const long long rows = min((long long)BA_PAIR_ROWS_BLOCK, nobs - row0);
  const int n4 = (int)rows * (BA_PAIR_ROW / 4);
  float4* gw = reinterpret_cast<float4*>(wr + row0 * BA_PAIR_ROW);
  float4* gy = reinterpret_cast<float4*>(yr + row0 * BA_PAIR_ROW);
  const float4* s4w = reinterpret_cast<const float4*>(sw);
  const float4* s4y = reinterpret_cast<const float4*>(sy);
  for (int q = threadIdx.x; q < n4; q += BA_PAIR_ROWS_BLOCK) {
    gw[q] = s4w[q];
    gy[q] = s4y[q];
  }
}

// (ci, cj) of block b = ci (ci + 1) / 2 + cj, cj <= ci.
__device__ __forceinline__ void ba_pair_block(int b, int& ci, int& cj) {
  long long r = (long long)((sqrt(8.0 * (double)b + 1.0) - 1.0) * 0.5);
  while (r * (r + 1) / 2 > b) --r;
  while ((r + 1) * (r + 2) / 2 <= b) ++r;
  ci = (int)r;
  cj = (int)(b - r * (r + 1) / 2);
}

// A pair's operands for lane a: Y_i[a, :] and W_j (27 of 28 floats).
struct BaPairRow {
  float y[3];
  float w[BA_PAIR_ROW];
};

__device__ __forceinline__ void ba_pair_load(const float* __restrict__ wr,
                                             const float* __restrict__ yr,
                                             int i, int j, int a,
                                             BaPairRow& r) {
  const float* yi = yr + (long long)i * BA_PAIR_ROW + 3 * a;
  r.y[0] = __ldg(yi);
  r.y[1] = __ldg(yi + 1);
  r.y[2] = __ldg(yi + 2);
  const float4* w4 =
      reinterpret_cast<const float4*>(wr + (long long)j * BA_PAIR_ROW);
#pragma unroll
  for (int q = 0; q < BA_PAIR_ROW / 4; ++q) {
    const float4 t = __ldg(w4 + q);
    r.w[4 * q] = t.x;
    r.w[4 * q + 1] = t.y;
    r.w[4 * q + 2] = t.z;
    r.w[4 * q + 3] = t.w;
  }
}

// acc[b] += Y_i[a, :] . W_j[b, :] for b < 9.
__device__ __forceinline__ void ba_pair_add(const BaPairRow& r,
                                            float acc[9]) {
#pragma unroll
  for (int b = 0; b < 9; ++b)
    acc[b] += fmaf(r.y[2], r.w[3 * b + 2],
                   fmaf(r.y[1], r.w[3 * b + 1], r.y[0] * r.w[3 * b]));
}

// Write block (ci, cj) of S (n = 9 ncams columns) from its row sums
// acc (lane a holds row a; `sh` the group's 81 floats of shared memory):
// Hcc_l - acc on the diagonal (-acc where hcc is null), else -acc below
// and its transpose above. Every lane of the warp calls it (active or
// not), for the __syncwarp.
__device__ __forceinline__ void ba_pair_store(float* __restrict__ S,
                                              long long n,
                                              const float* __restrict__ hcc,
                                              int ci, int cj, int a,
                                              bool active, const float acc[9],
                                              float* __restrict__ sh) {
  if (active) {
#pragma unroll
    for (int b = 0; b < 9; ++b) sh[9 * a + b] = acc[b];
    if (ci != cj) {
#pragma unroll
      for (int b = 0; b < 9; ++b)
        S[(9LL * cj + b) * n + 9LL * ci + a] = -acc[b];
    }
  }
  __syncwarp();
  if (active) {
    float* col = S + 9LL * ci * n + 9LL * cj + a;
    if (ci == cj && hcc != nullptr) {
      const float* hc = hcc + 81LL * ci + a;
#pragma unroll
      for (int r = 0; r < 9; ++r) col[r * n] = hc[9 * r] - sh[9 * r + a];
    } else {
#pragma unroll
      for (int r = 0; r < 9; ++r) col[r * n] = -sh[9 * r + a];
    }
  }
}

// Each chunk's pairs in order: two pairs' operands loaded before either is
// added, the adds in the pairs' order.
__global__ void __launch_bounds__(BA_PAIR_THREADS) ba_pair_chunk_kernel(
    const float* __restrict__ wr, const float* __restrict__ yr,
    const int* __restrict__ pair_i, const int* __restrict__ pair_j,
    const int* __restrict__ chunk_starts, const int* __restrict__ chunk_block,
    const int* __restrict__ chunk_slot, long long nchunks,
    const float* __restrict__ hcc, long long n, float* __restrict__ part,
    float* __restrict__ S) {
  __shared__ float sh[BA_PAIR_GROUPS][81];
  const int lane = threadIdx.x & 31;
  const int grp = (threadIdx.x >> 5) * 3 + min(lane / 9, 2);
  const int a = lane - 9 * min(lane / 9, 2);
  const long long c = (long long)blockIdx.x * BA_PAIR_GROUPS + grp;
  const bool active = lane < 27 && c < nchunks;
  float acc[9];
#pragma unroll
  for (int b = 0; b < 9; ++b) acc[b] = 0.0f;
  int ci = 0, cj = 0, slot = -1;
  if (active) {
    ba_pair_block(chunk_block[c], ci, cj);
    slot = chunk_slot[c];
    const int end = chunk_starts[c + 1];
    for (int q = chunk_starts[c]; q < end; q += 2) {
      const bool two = q + 1 < end;
      const int i0 = pair_i[q], j0 = pair_j[q];
      const int i1 = two ? pair_i[q + 1] : i0, j1 = two ? pair_j[q + 1] : j0;
      BaPairRow r0, r1;
      ba_pair_load(wr, yr, i0, j0, a, r0);
      ba_pair_load(wr, yr, i1, j1, a, r1);
      ba_pair_add(r0, acc);
      // On a diagonal block a pair of two rows adds Y_j W_i' too.
      if (ci == cj && i0 != j0) {
        ba_pair_load(wr, yr, j0, i0, a, r0);
        ba_pair_add(r0, acc);
      }
      if (two) {
        ba_pair_add(r1, acc);
        if (ci == cj && i1 != j1) {
          ba_pair_load(wr, yr, j1, i1, a, r1);
          ba_pair_add(r1, acc);
        }
      }
    }
    if (slot >= 0) {
#pragma unroll
      for (int b = 0; b < 9; ++b) part[81LL * slot + 9 * a + b] = acc[b];
    }
  }
  ba_pair_store(S, n, hcc, ci, cj, a, active && slot < 0, acc, sh[grp]);
}

__global__ void __launch_bounds__(BA_PAIR_THREADS) ba_pair_merge_kernel(
    const float* __restrict__ part, const int* __restrict__ multi_block,
    const int* __restrict__ multi_slots, long long nmulti,
    const float* __restrict__ hcc, long long n, float* __restrict__ S) {
  __shared__ float sh[BA_PAIR_GROUPS][81];
  const int lane = threadIdx.x & 31;
  const int grp = (threadIdx.x >> 5) * 3 + min(lane / 9, 2);
  const int a = lane - 9 * min(lane / 9, 2);
  const long long m = (long long)blockIdx.x * BA_PAIR_GROUPS + grp;
  const bool active = lane < 27 && m < nmulti;
  float acc[9];
#pragma unroll
  for (int b = 0; b < 9; ++b) acc[b] = 0.0f;
  int ci = 0, cj = 0;
  if (active) {
    ba_pair_block(multi_block[m], ci, cj);
    for (int s = multi_slots[m]; s < multi_slots[m + 1]; ++s) {
      const float* p = part + 81LL * s + 9 * a;
#pragma unroll
      for (int b = 0; b < 9; ++b) acc[b] += p[b];
    }
  }
  ba_pair_store(S, n, hcc, ci, cj, a, active, acc, sh[grp]);
}

}  // namespace

// W (27, ldw) stored as W_CODES w_dtype, its first nobs columns the true
// rows; hinv (npnts*9,) Hpp_inv; pnt (ldw,) pnt_idx; hcc: null or
// (ncams*81,) Hcc_l; the plan's arrays (`ops/plans.py:PairPlan`); rows
// (2*nobs*28,) scratch, 16-byte aligned (the W rows, then the Y rows), and
// part (nslots*81,). Writes S (9 ncams, 9 ncams), every entry.
extern "C" int ba_dense_pairs(const void* W, int w_dtype, long long ldw,
                              long long nobs, const float* hinv,
                              const int* pnt, const float* hcc,
                              const int* pair_i, const int* pair_j,
                              const int* chunk_starts, const int* chunk_block,
                              const int* chunk_slot, long long nchunks,
                              const int* multi_block, const int* multi_slots,
                              long long nmulti, long long ncams, float* rows,
                              float* part, float* S, void* stream) {
  if (reinterpret_cast<unsigned long long>(rows) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wr = rows;
  float* yr = rows + nobs * BA_PAIR_ROW;
  if (nobs > 0) {
    const int rc = ba_with_w_type(w_dtype, [&](auto tag) -> int {
      using T = BA_W_TYPE(tag);
      ba_pair_rows_kernel<T>
          <<<(unsigned)((nobs + BA_PAIR_ROWS_BLOCK - 1) / BA_PAIR_ROWS_BLOCK),
             BA_PAIR_ROWS_BLOCK, 0, s>>>(static_cast<const T*>(W), ldw, nobs,
                                         hinv, pnt, wr, yr);
      BA_RETURN_IF_LAUNCH_FAILED();
      return 0;
    });
    if (rc != 0) return rc;
  } else if (w_dtype < 0 || w_dtype > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = 9 * ncams;
  if (nchunks > 0) {
    ba_pair_chunk_kernel<<<(unsigned)((nchunks + BA_PAIR_GROUPS - 1) /
                                      BA_PAIR_GROUPS),
                           BA_PAIR_THREADS, 0, s>>>(
        wr, yr, pair_i, pair_j, chunk_starts, chunk_block, chunk_slot,
        nchunks, hcc, n, part, S);
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  if (nmulti > 0) {
    ba_pair_merge_kernel<<<(unsigned)((nmulti + BA_PAIR_GROUPS - 1) /
                                      BA_PAIR_GROUPS),
                           BA_PAIR_THREADS, 0, s>>>(
        part, multi_block, multi_slots, nmulti, hcc, n, S);
    BA_RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}
