// Register top-k lists and online logsumexp, shared by topk_lse.cu and
// vocab_topk.cu.
//
// A list is KP (value, index) pairs sorted by lax.top_k's total order:
// larger value first, equal values in ascending index order. Because the
// order is total, the first k of a merge of lists are the top-k of their
// union whatever order the lists were filled in, so lax.top_k's tie order
// holds through every merge. (m, s) stands for the logsumexp m + log(s).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace vct {

constexpr int kSentinelIdx = 0x7fffffff;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

template <int KP>
__device__ __forceinline__ void list_init(float (&tv)[KP], int (&ti)[KP]) {
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    tv[j] = -INFINITY;
    ti[j] = kSentinelIdx;
  }
}

template <int KP>
__device__ __forceinline__ void list_insert(float (&tv)[KP], int (&ti)[KP],
                                            float v, int i) {
  if (!better(v, i, tv[KP - 1], ti[KP - 1])) return;
  tv[KP - 1] = v;
  ti[KP - 1] = i;
#pragma unroll
  for (int j = KP - 1; j > 0; --j) {
    if (better(tv[j], ti[j], tv[j - 1], ti[j - 1])) {
      const float fv = tv[j];
      tv[j] = tv[j - 1];
      tv[j - 1] = fv;
      const int fi = ti[j];
      ti[j] = ti[j - 1];
      ti[j - 1] = fi;
    }
  }
}

template <int KP>
__device__ __forceinline__ void list_pop(float (&tv)[KP], int (&ti)[KP]) {
#pragma unroll
  for (int j = 0; j < KP - 1; ++j) {
    tv[j] = tv[j + 1];
    ti[j] = ti[j + 1];
  }
  tv[KP - 1] = -INFINITY;
  ti[KP - 1] = kSentinelIdx;
}

// Merges the 32 sorted lists of a warp. Round r leaves the warp's r-th best
// (value, index) in (out_v[r], out_i[r]) on every lane.
template <int KP>
__device__ __forceinline__ void warp_merge(float (&tv)[KP], int (&ti)[KP],
                                           float (&out_v)[KP],
                                           int (&out_i)[KP]) {
#pragma unroll
  for (int r = 0; r < KP; ++r) {
    float bv = tv[0];
    int bi = ti[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFullMask, bv, off);
      const int oi = __shfl_xor_sync(kFullMask, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    out_v[r] = bv;
    out_i[r] = bi;
    if (tv[0] == bv && ti[0] == bi) list_pop<KP>(tv, ti);
  }
}

__device__ __forceinline__ void lse_add(float& m, float& s, float x) {
  if (x == -INFINITY) return;  // exp(-inf) contributes nothing
  if (x > m) {
    s = s * expf(m - x) + 1.0f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
  } else if (m2 > m) {
    s = s * expf(m - m2) + s2;
    m = m2;
  } else {
    s += s2 * expf(m2 - m);
  }
}

__device__ __forceinline__ void warp_lse(float& m, float& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(kFullMask, m, off);
    const float s2 = __shfl_xor_sync(kFullMask, s, off);
    lse_merge(m, s, m2, s2);
  }
}

__device__ __forceinline__ float lse_value(float m, float s) {
  return m == -INFINITY ? -INFINITY : m + logf(s);
}

}  // namespace vct
