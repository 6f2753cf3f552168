// Kernel K9: a streaming-read probe, the card's achievable read rate.
//
// Replaces the TPU kernel `scripts/tpu_mv_sweep.py` `dma_probe` (its
// `pallas_call`): for a (32, n) float array `big` and 0-2 float rows s1, s2
// of length n,
//
//   out[r] = sum_j big[r, j] + sum_j s1[j] + sum_j s2[j]     -> (32,)
//
// The TPU probe measured a chunked DMA loop's fixed cost; here the same sums
// measure how fast the card streams a large array from device memory, the
// denominator the mv sweep holds every kernel against.
//
// Design for Hopper: grid (blocks per row, 32 + nsmall), one input row per
// blockIdx.y. Each thread walks its row in a grid-stride loop of 16-byte
// float4 loads, four independent loads in flight, neighbouring threads on
// neighbouring addresses; each block sums its threads in a fixed order
// (ba_block_sum) into one partial. A second single pass sums, for each
// output row, its own partials and then the small rows' partials, in a
// fixed order: deterministic, no atomics. Rows whose length or start is not
// a multiple of 16 bytes take the scalar form of the same loop.
//
// Bound: bytes. It reads (32 + nsmall) * 4 * n bytes once and writes 128;
// one add a value. At n = 1,360,384 (Dubrovnik-356's rows) and nsmall = 0
// that is 174.1 MB, 52 us at 3.35 TB/s.
#include "chain.cuh"

namespace {

constexpr int BA_PROBE_ROWS = 32;
constexpr int BA_PROBE_UNROLL = 4;

template <bool kVec>
__global__ void __launch_bounds__(BA_BLOCK) ba_stream_probe_kernel(
    const float* __restrict__ big, const float* __restrict__ s1,
    const float* __restrict__ s2, long long n, float* __restrict__ part) {
  const int y = blockIdx.y;
  const float* row = y < BA_PROBE_ROWS ? big + (long long)y * n
                                       : (y == BA_PROBE_ROWS ? s1 : s2);
  const long long stride = (long long)gridDim.x * BA_BLOCK;
  float acc[1] = {0.0f};
  if constexpr (kVec) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const long long n4 = n / 4;
    long long i = (long long)blockIdx.x * BA_BLOCK + threadIdx.x;
    for (; i + (BA_PROBE_UNROLL - 1) * stride < n4;
         i += BA_PROBE_UNROLL * stride) {
      float4 v[BA_PROBE_UNROLL];
#pragma unroll
      for (int u = 0; u < BA_PROBE_UNROLL; ++u) v[u] = r4[i + u * stride];
#pragma unroll
      for (int u = 0; u < BA_PROBE_UNROLL; ++u)
        acc[0] += (v[u].x + v[u].y) + (v[u].z + v[u].w);
    }
    for (; i < n4; i += stride) {
      const float4 v = r4[i];
      acc[0] += (v.x + v.y) + (v.z + v.w);
    }
  } else {
    for (long long i = (long long)blockIdx.x * BA_BLOCK + threadIdx.x; i < n;
         i += stride)
      acc[0] += row[i];
  }
  ba_block_sum<1>(acc, part + (size_t)y * gridDim.x + blockIdx.x);
}

// out[r] = sum of row r's partials + sum of the small rows' partials.
__global__ void __launch_bounds__(BA_BLOCK) ba_stream_probe_sum_kernel(
    const float* __restrict__ part, int nparts, int nsmall,
    float* __restrict__ out) {
  const int r = blockIdx.x;
  float acc[2] = {0.0f, 0.0f};
  for (int i = threadIdx.x; i < nparts; i += BA_BLOCK) {
    acc[0] += part[(size_t)r * nparts + i];
    for (int k = 0; k < nsmall; ++k)
      acc[1] += part[(size_t)(BA_PROBE_ROWS + k) * nparts + i];
  }
  __shared__ float tot[2];
  ba_block_sum<2>(acc, tot);
  __syncthreads();
  if (threadIdx.x == 0) out[r] = tot[0] + tot[1];
}

}  // namespace

// Partials per input row that ba_stream_probe writes: enough blocks over
// the 32 + nsmall rows to keep every SM of the card busy.
extern "C" int ba_stream_probe_blocks(long long n) {
  const long long per_block = (long long)BA_BLOCK * 4 * BA_PROBE_UNROLL;
  const long long want = (n + per_block - 1) / per_block;
  return (int)(want < 1 ? 1 : (want > 64 ? 64 : want));
}

// big (32, n); s1, s2 (n,) or null (nsmall = 0, 1 or 2 of them, in order);
// vec: every row starts on a 16-byte boundary and n % 4 == 0; part
// ((32 + nsmall) * ba_stream_probe_blocks(n),) scratch; out (32,).
extern "C" int ba_stream_probe(const float* big, const float* s1,
                               const float* s2, int nsmall, long long n,
                               int vec, float* part, float* out,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nsmall < 0 || nsmall > 2) return (int)cudaErrorInvalidValue;
  const int nb = ba_stream_probe_blocks(n);
  const dim3 grid((unsigned)nb, (unsigned)(BA_PROBE_ROWS + nsmall));
  if (vec)
    ba_stream_probe_kernel<true><<<grid, BA_BLOCK, 0, s>>>(big, s1, s2, n,
                                                           part);
  else
    ba_stream_probe_kernel<false><<<grid, BA_BLOCK, 0, s>>>(big, s1, s2, n,
                                                            part);
  BA_RETURN_IF_LAUNCH_FAILED();
  ba_stream_probe_sum_kernel<<<BA_PROBE_ROWS, BA_BLOCK, 0, s>>>(part, nb,
                                                                nsmall, out);
  BA_RETURN_IF_LAUNCH_FAILED();
  return 0;
}
