// Register top-k lists, their merges across lanes, and (max, sum of exp)
// pairs, shared by topk_lse.cu and vocab_topk.cu.
//
// A list is KP (value, index) pairs sorted by lax.top_k's total order:
// larger value first, equal values in ascending index order. KP is k
// rounded up to a power of two, so a list has a compile-time size and stays
// in registers; its first k entries are the top-k under the same order.
// Because the order is total, the first k of a merge of lists are the top-k
// of their union whatever order the lists were filled in, so lax.top_k's tie
// order holds through every merge. (m, s) stands for the logsumexp
// m + log(s).
//
// Both kernels keep the per-element cost to one compare: an element is
// inserted only when it beats a threshold that never exceeds the row's k-th
// value (the list's own k-th entry, list_init_top; warp_kth_desc: the k-th
// largest of a warp's lane maxima, each a distinct element of the row), and
// an insert is the rare case. The merges take k rounds, not KP.

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

// A list that keeps only the top k (k <= KP) with its k-th entry at a
// fixed place: the first KP - k entries are (+inf, -1), which every real
// entry ranks below, so list_insert never moves them and the k-th best is
// always entry KP - 1 (a runtime index into a register list would put it
// in local memory). list_drop_top removes them once the list is complete.
template <int KP>
__device__ __forceinline__ void list_init_top(float (&tv)[KP], int (&ti)[KP], int k) {
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    tv[j] = j < KP - k ? INFINITY : -INFINITY;
    ti[j] = j < KP - k ? -1 : kSentinelIdx;
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

template <int KP>
__device__ __forceinline__ void list_drop_top(float (&tv)[KP], int (&ti)[KP], int k) {
  for (int p = 0; p < KP - k; ++p) list_pop<KP>(tv, ti);
}

// Merges the sorted lists of each group of W consecutive lanes (W a power of
// two, every lane of the warp taking part). Round r < k leaves the group's
// r-th best (value, index) in (out_v[r], out_i[r]) on each of its lanes.
template <int KP, int W = 32>
__device__ __forceinline__ void group_merge(float (&tv)[KP], int (&ti)[KP],
                                            float (&out_v)[KP], int (&out_i)[KP], int k) {
#pragma unroll
  for (int r = 0; r < KP; ++r) {
    if (r < k) {
      float bv = tv[0];
      int bi = ti[0];
#pragma unroll
      for (int off = W / 2; off > 0; off >>= 1) {
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
}

// The k-th largest (k <= 32) of the warp's 32 values v, on every lane: a
// bitonic sort across lanes into descending order, read from lane k - 1.
__device__ __forceinline__ float warp_kth_desc(float v, int k) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const float o = __shfl_xor_sync(kFullMask, v, stride);
      const bool desc = (lane & size) == 0;   // this block's direction
      const bool lower = (lane & stride) == 0;
      v = lower == desc ? fmaxf(v, o) : fminf(v, o);
    }
  }
  return __shfl_sync(kFullMask, v, k - 1);
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

// Merges the (m, s) pairs of each group of W consecutive lanes.
template <int W = 32>
__device__ __forceinline__ void group_lse(float& m, float& s) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(kFullMask, m, off);
    const float s2 = __shfl_xor_sync(kFullMask, s, off);
    lse_merge(m, s, m2, s2);
  }
}

__device__ __forceinline__ float lse_value(float m, float s) {
  return m == -INFINITY ? -INFINITY : m + logf(s);
}

}  // namespace vct
