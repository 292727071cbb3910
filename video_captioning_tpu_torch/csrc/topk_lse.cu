// Exact row top-k, with or without the row logsumexp, over a (N, V) float32
// matrix, in one pass over the logits.
//
// Replaces: video_captioning_tpu/ops/topk_pallas.py, _topk_lse_kernel
// (reached through topk2d_lse_pallas / topk2d_lse from the beam step,
// generation/beam.py), and, compiled without the logsumexp (kLse = false),
// _topk_kernel (topk2d_pallas).
//
// Contract (held by the tests against the plain PyTorch versions in
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
// top-KP list (topk_list.cuh) and an online (max, sum of exp) pair. KP is
// k rounded up to a power of two, so the list has a compile-time size and
// stays in registers; the first k of the top-KP are the top-k under the
// same total order. A warp merges its 32 lists by KP rounds of a butterfly
// arg-best over the list heads (the winner pops its head), then warp 0
// merges the 8 warp lists the same way. Nothing but the outputs is written
// to device memory.

#include "topk_list.cuh"

namespace {

using namespace vct;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int KP, bool kLse>
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
  list_init<KP>(tv, ti);
  float m = -INFINITY;
  float s = 0.0f;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float v = __ldg(xr + i);
    list_insert<KP>(tv, ti, v, i);
    if (kLse) lse_add(m, s, v);
  }

  float mv[KP];
  int mi[KP];
  warp_merge<KP>(tv, ti, mv, mi);
  if (kLse) warp_lse(m, s);
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
    if (kLse) {
      m = lane < kWarps ? warp_m[lane] : -INFINITY;
      s = lane < kWarps ? warp_s[lane] : 0.0f;
      warp_lse(m, s);
    }
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
      if (kLse) lse[row] = lse_value(m, s);
    }
  }
}

template <bool kLse>
int launch(const float* x, float* vals, int* idx, float* lse, int n, int v,
           int k, void* stream) {
  if (n <= 0 || v <= 0 || k < 1 || k > 16 || k > v) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n);
  if (k == 1) {
    topk_lse_kernel<1, kLse><<<grid, kThreads, 0, st>>>(x, vals, idx, lse, v, k);
  } else if (k == 2) {
    topk_lse_kernel<2, kLse><<<grid, kThreads, 0, st>>>(x, vals, idx, lse, v, k);
  } else if (k <= 4) {
    topk_lse_kernel<4, kLse><<<grid, kThreads, 0, st>>>(x, vals, idx, lse, v, k);
  } else if (k <= 8) {
    topk_lse_kernel<8, kLse><<<grid, kThreads, 0, st>>>(x, vals, idx, lse, v, k);
  } else {
    topk_lse_kernel<16, kLse><<<grid, kThreads, 0, st>>>(x, vals, idx, lse, v, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Both return a cudaError_t: 0 when the launch was accepted.
extern "C" int vct_topk2d_lse_f32(const float* x, float* vals, int* idx,
                                  float* lse, int n, int v, int k,
                                  void* stream) {
  return launch<true>(x, vals, idx, lse, n, v, k, stream);
}

extern "C" int vct_topk2d_f32(const float* x, float* vals, int* idx, int n,
                              int v, int k, void* stream) {
  return launch<false>(x, vals, idx, nullptr, n, v, k, stream);
}
