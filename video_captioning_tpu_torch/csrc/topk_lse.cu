// Exact row top-k plus row logsumexp over a (N, V) float32 matrix, in one
// pass over the logits.
//
// Replaces: video_captioning_tpu/ops/topk_pallas.py, _topk_lse_kernel
// (reached through topk2d_lse_pallas / topk2d_lse from the beam step,
// generation/beam.py).
//
// Contract (held by the tests against the plain PyTorch version in
// ops/topk.py): values and indices equal lax.top_k's, including its tie
// order (equal values come out in ascending index order); lse is
// m + log(sum(exp(x - m))) to float32 rounding; a row that is all -inf has
// lse = -inf. 1 <= k <= 16 and k <= V.
//
// What bounds it on an H100: device-memory reads. The beam step calls it
// at (N = B*K = 640, V = 10000): 25.6 MB read once, a few microseconds at
// 3.35 TB/s, against about 30 simple operations per element.
//
// Design: one CTA per row, 256 threads. Each thread walks a strided slice
// of the row in ascending index order and keeps, in registers, its own
// top-KP list sorted by (value desc, index asc) and an online
// (max, sum of exp) pair. KP is k rounded up to a power of two, so the
// list has a compile-time size and stays in registers; the first k of the
// top-KP are the top-k under the same total order. A warp merges its 32
// lists by KP rounds of a butterfly arg-best over the list heads (the
// winner pops its head), then warp 0 merges the 8 warp lists the same way.
// Nothing but the outputs is written to device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSentinelIdx = 0x7fffffff;
constexpr unsigned kFullMask = 0xffffffffu;

// Total order of lax.top_k: larger value first, then smaller index.
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
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

// Online logsumexp: (m, s) stands for m + log(s).
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

template <int KP>
__global__ void __launch_bounds__(kThreads)
    topk_lse_kernel(const float* __restrict__ x, float* __restrict__ vals,
                    int* __restrict__ idx, float* __restrict__ lse, int V,
                    int k) {
  __shared__ float warp_v[kWarps][KP];
  __shared__ int warp_i[kWarps][KP];
  __shared__ float warp_m[kWarps];
  __shared__ float warp_s[kWarps];

  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* xr = x + static_cast<size_t>(row) * V;

  float tv[KP];
  int ti[KP];
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    tv[j] = -INFINITY;
    ti[j] = kSentinelIdx;
  }
  float m = -INFINITY;
  float s = 0.0f;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float v = __ldg(xr + i);
    list_insert<KP>(tv, ti, v, i);
    lse_add(m, s, v);
  }

  float mv[KP];
  int mi[KP];
  warp_merge<KP>(tv, ti, mv, mi);
  warp_lse(m, s);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      warp_v[warp][j] = mv[j];
      warp_i[warp][j] = mi[j];
    }
    warp_m[warp] = m;
    warp_s[warp] = s;
  }
  __syncthreads();

  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      tv[j] = lane < kWarps ? warp_v[lane][j] : -INFINITY;
      ti[j] = lane < kWarps ? warp_i[lane][j] : kSentinelIdx;
    }
    warp_merge<KP>(tv, ti, mv, mi);
    m = lane < kWarps ? warp_m[lane] : -INFINITY;
    s = lane < kWarps ? warp_s[lane] : 0.0f;
    warp_lse(m, s);
    if (lane == 0) {
      float* vr = vals + static_cast<size_t>(row) * k;
      int* ir = idx + static_cast<size_t>(row) * k;
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        if (j < k) {
          vr[j] = mv[j];
          ir[j] = mi[j];
        }
      }
      lse[row] = m == -INFINITY ? -INFINITY : m + logf(s);
    }
  }
}

}  // namespace

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int vct_topk2d_lse_f32(const float* x, float* vals, int* idx,
                                  float* lse, int n, int v, int k,
                                  void* stream) {
  if (n <= 0 || v <= 0 || k < 1 || k > 16 || k > v) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n);
  if (k == 1) {
    topk_lse_kernel<1><<<grid, kThreads, 0, st>>>(x, vals, idx, lse, v, k);
  } else if (k == 2) {
    topk_lse_kernel<2><<<grid, kThreads, 0, st>>>(x, vals, idx, lse, v, k);
  } else if (k <= 4) {
    topk_lse_kernel<4><<<grid, kThreads, 0, st>>>(x, vals, idx, lse, v, k);
  } else if (k <= 8) {
    topk_lse_kernel<8><<<grid, kThreads, 0, st>>>(x, vals, idx, lse, v, k);
  } else {
    topk_lse_kernel<16><<<grid, kThreads, 0, st>>>(x, vals, idx, lse, v, k);
  }
  return static_cast<int>(cudaGetLastError());
}
