// Device code shared by the kernels that walk the camera-sorted columns in
// ranges (plan `ops/plans.py:CamColPlan`): K5's camera direction
// (seg_block_reduce.cu) and K6's W C W' product (seg_prod_reduce.cu).
//
// A range's thread takes V consecutive columns, B bytes of each plane of
// W (K5: BA_CAM_LOAD_BYTES; K6: BA_WCW_COLS columns): one aligned 4, 8 or
// 16 B load a plane, or a scalar path for planes not aligned so. The column's
// point comes from the plan's cam_pnt = pnt_idx[cam_perm], read coalesced
// (ba_ld_points).
#pragma once

#include <cstdint>

#include "chain.cuh"
#include "w_store.cuh"

// Bytes of each plane one thread loads: its columns, V =
// BA_CAM_LOAD_BYTES / sizeof(storage), 2 float or 4 bf16 / f16 columns (16 B
// a plane measured slower with a 2-byte W: PERF.md, K5 camera).
constexpr int BA_CAM_LOAD_BYTES = 8;
// A plan's column range must be a multiple of BA_CAM_COL_ALIGN, so every
// thread's columns start aligned in each plane, and at most BA_CAM_COLS_MAX
// (the range's run bounds are staged in shared memory). The kernels refuse
// other plans.
constexpr int BA_CAM_COL_ALIGN = 8;
constexpr int BA_CAM_COLS_MAX = 8192;

// The plan as ops/_cuda.py:CamColPlanC passes it (ops/plans.py:CamColPlan).
struct BaCamColPlan {
  const int* cam_pnt;           // (n,) pnt_idx[cam_perm]
  const int* run_bounds;        // (nruns+1,) each run's columns
  const int* range_run_starts;  // (nranges+1,) each range's runs
  const int* cam_run_starts;    // (ncams+1,) each camera's runs
  int nranges;
  int cols;                     // C of the plan
};

namespace {

// Columns a thread takes from a W stored as S when it loads B bytes a
// plane, and the 32-bit words of one plane's load at K5's width.
template <class S, int B = BA_CAM_LOAD_BYTES>
__host__ __device__ constexpr int ba_cam_v() {
  return B / (int)sizeof(S);
}
constexpr int BA_CAM_WORDS = BA_CAM_LOAD_BYTES / 4;

// 0 if ``plan`` is one the range kernels take, else cudaErrorInvalidValue.
inline int ba_check_cam_cols(const BaCamColPlan& plan) {
  if (plan.cols <= 0 || plan.cols % BA_CAM_COL_ALIGN != 0 ||
      plan.cols > BA_CAM_COLS_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The raw bits of W's element i.
__device__ __forceinline__ unsigned ba_bits(const float* p, long long i) {
  return __float_as_uint(p[i]);
}
template <class S>
__device__ __forceinline__ unsigned ba_bits(const S* p, long long i) {
  return reinterpret_cast<const unsigned short*>(p)[i];
}

// A thread's V columns of one plane starting at p, as NW (1, 2 or 4)
// words: one aligned 4, 8 or 16 B load, or (``vec`` false) one element at
// a time, the nv columns it has and zeros for the rest.
template <class S, int NW>
__device__ __forceinline__ void ba_ld_plane(const S* p, bool vec, int nv,
                                            unsigned (&w)[NW]) {
  static_assert(NW == 1 || NW == 2 || NW == 4, "a word, uint2 or uint4");
  constexpr int V = ba_cam_v<S, 4 * NW>();
  if (vec) {
    if constexpr (NW == 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else if constexpr (NW == 2) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = q.x; w[1] = q.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    }
    return;
  }
  constexpr int PER = V / NW;   // elements a word
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    w[i] = 0u;
#pragma unroll
    for (int h = 0; h < PER; ++h) {
      const int k = i * PER + h;
      if (k < nv) w[i] |= ba_bits(p, k) << (16 * h);
    }
  }
}

// The V floats of a plane's words.
__device__ __forceinline__ void ba_unpack(const float*,
                                          const unsigned (&w)[BA_CAM_WORDS],
                                          float (&o)[BA_CAM_WORDS]) {
#pragma unroll
  for (int i = 0; i < BA_CAM_WORDS; ++i) o[i] = __uint_as_float(w[i]);
}
// bf16 -> float is exact: the bits, shifted 16.
__device__ __forceinline__ void ba_unpack(const __nv_bfloat16*,
                                          const unsigned (&w)[BA_CAM_WORDS],
                                          float (&o)[2 * BA_CAM_WORDS]) {
#pragma unroll
  for (int i = 0; i < BA_CAM_WORDS; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void ba_unpack(const __half*,
                                          const unsigned (&w)[BA_CAM_WORDS],
                                          float (&o)[2 * BA_CAM_WORDS]) {
#pragma unroll
  for (int i = 0; i < BA_CAM_WORDS; ++i) {
    o[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
    o[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
  }
}

// Column k (a compile-time index after unrolling) of a plane's NW words,
// widened: the element ba_unpack puts at o[k].
template <int NW>
__device__ __forceinline__ float ba_col(const float*,
                                        const unsigned (&w)[NW], int k) {
  return __uint_as_float(w[k]);
}
template <int NW>
__device__ __forceinline__ float ba_col(const __nv_bfloat16*,
                                        const unsigned (&w)[NW], int k) {
  const unsigned x = w[k >> 1];
  return __uint_as_float((k & 1) ? (x & 0xffff0000u) : (x << 16));
}
template <int NW>
__device__ __forceinline__ float ba_col(const __half*,
                                        const unsigned (&w)[NW], int k) {
  const unsigned x = w[k >> 1];
  return __half2float(
      __ushort_as_half((unsigned short)((k & 1) ? (x >> 16) : (x & 0xffffu))));
}

// pk[k] = cam[l0 + k] for the thread's columns l0 + k < len (0 past it):
// one 16 B (or 8 B) load when they are whole and aligned (``vec``).
template <int V>
__device__ __forceinline__ void ba_ld_points(const int* cam, int l0, int len,
                                             bool vec, int (&pk)[V]) {
  const int nv = max(0, min(V, len - l0));
  if constexpr (V == 1) {
    pk[0] = nv > 0 ? __ldg(cam + l0) : 0;
  } else if (vec && nv == V) {
#pragma unroll
    for (int i = 0; i < (V + 3) / 4; ++i) {
      int q[4];
      if constexpr (V >= 4) {
        const int4 v4 = __ldg(reinterpret_cast<const int4*>(cam + l0) + i);
        q[0] = v4.x; q[1] = v4.y; q[2] = v4.z; q[3] = v4.w;
      } else {
        const int2 v2 = __ldg(reinterpret_cast<const int2*>(cam + l0));
        q[0] = v2.x; q[1] = v2.y; q[2] = q[3] = 0;
      }
#pragma unroll
      for (int h = 0; h < 4; ++h)
        if (4 * i + h < V) pk[4 * i + h] = q[h];
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) pk[k] = k < nv ? cam[l0 + k] : 0;
  }
}

// Whether the V-column vector loads (B bytes a plane) of W's planes and of
// cam_pnt are aligned: plane starts (n a multiple of V, W aligned to the
// load) and cam_pnt on 16 B. Every thread's first column is a multiple of
// V.
template <int B, class S>
__device__ __forceinline__ bool ba_cam_vec(const S* W, long long n,
                                           const int* cam_pnt) {
  return n % ba_cam_v<S, B>() == 0 &&
         reinterpret_cast<uintptr_t>(W) % B == 0 &&
         (reinterpret_cast<uintptr_t>(cam_pnt) & 15) == 0;
}

}  // namespace
