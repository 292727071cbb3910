// Exact row top-k, with or without the row logsumexp, over a (N, V) float32
// matrix, in one pass over the logits.
//
// Replaces: video_captioning_tpu/ops/topk_pallas.py, _topk_lse_kernel
// (reached through topk2d_lse_pallas / topk2d_lse from the beam step,
// generation/beam.py), and, compiled without the logsumexp (kLse = false),
// _topk_kernel (topk2d_pallas). It replaces the port's first design, whose
// threads walked their slice one scalar load at a time, each element going
// through a dependent list insert and an online exp with a branch: about one
// load in flight a thread, 0.64 TB/s at the beam step's shape.
//
// Contract (held by the tests against the plain PyTorch versions in
// ops/topk.py): values and indices equal lax.top_k's, including its tie
// order (equal values come out in ascending index order); lse is
// m + log(sum(exp(x - m))) to float32 rounding; a row that is all -inf has
// lse = -inf. 1 <= k <= 16 and k <= V. Two launches on the same input give
// the same bits: no atomics, every merge in a fixed order.
//
// What bounds it on an H100: device-memory reads. The beam step calls it
// at (N = B*K = 640, V = 10000): 25.6 MB read once, 7.7 us at 3.35 TB/s,
// against a few simple operations per element. Reaching that rate takes
// about 20 KB in flight on every SM, and little enough arithmetic after a
// row's data arrive that the rows arriving last are not held up by it.
//
// Design: one CTA per row, at most 256 threads (8 warps; 256 at
// V = 10000). A thread issues its whole slice of the row as 16-byte
// cp.async copies into shared memory (4-byte ones where V % 4 != 0 or the
// rows are not 16-byte aligned), all in flight before it waits for any:
// 40 KB of a row in flight and no registers held for it, so five rows stay
// resident on an SM and the 640 rows of the beam step run as one wave. From
// shared memory: the thread's max; a threshold tau, the largest over warps
// of the k-th largest lane maximum (never above the row's k-th value);
// then one more read that sums exp(x - m) against the running max with no
// per-element branch and tests each float4's max against tau, so that only
// the few elements at or above it reach the list insert (topk_list.cuh),
// which appears once in the code. The lists' real entries, when there are
// at most 32 (the usual case), are gathered into one warp and sorted by a
// bitonic network; otherwise a warp merges its lists in k rounds and warp 0
// the warps' lists. Rows longer than a 44 KB chunk take more chunks through
// the same buffer.

#include <algorithm>
#include <cstdint>

#include "topk_list.cuh"

namespace {

using namespace vct;

constexpr int kPerThread = 10;  // 16-byte copies a thread a chunk, at most
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kChunk = 11264;  // elements staged at once: 44 KB, under the 48 KB default with the static arrays
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// exp(d) for d <= 0 (or -inf) by the fast exp2: d * log2(e), then ex2.
__device__ __forceinline__ float exp_le0(float d) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d * kLog2e));
  return r;
}

template <int KP, bool kLse, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
    topk_lse_kernel(const float* __restrict__ x, float* __restrict__ vals,
                    int* __restrict__ idx, float* __restrict__ lse, int V, int k) {
  extern __shared__ float4 xs4[];  // the chunk, padded with -inf to whole float4s
  float* xs = reinterpret_cast<float*>(xs4);
  __shared__ float warp_v[kMaxWarps][KP];
  __shared__ int warp_i[kMaxWarps][KP];
  __shared__ float warp_m[kMaxWarps];
  __shared__ float warp_s[kMaxWarps];
  __shared__ float warp_tau[kMaxWarps];
  __shared__ int warp_cnt[kMaxWarps];
  __shared__ float cand_v[32];
  __shared__ int cand_i[32];

  const int T = blockDim.x;
  const int n_warps = T >> 5;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xr = x + static_cast<size_t>(row) * V;

  float tv[KP];
  int ti[KP];
  list_init<KP>(tv, ti);
  float m = -INFINITY, s = 0.0f, tau = -INFINITY;
  for (int base = 0; base < V; base += kChunk) {
    const int n = min(kChunk, V - base), n4 = (n + 3) / 4;
    if (base > 0) __syncthreads();  // the last chunk's readers are done
    // Every copy of the chunk is issued before any is waited for.
    if (kVec) {  // V % 4 == 0 and 16-byte rows: n % 4 == 0
      for (int q = tid; q < n4; q += T) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(xs4 + q)),
                     "l"(xr + base + 4 * q)
                     : "memory");
      }
    } else {
      for (int e = tid; e < n; e += T) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(xs + e)),
                     "l"(xr + base + e)
                     : "memory");
      }
      if (tid < 4 * n4 - n) xs[n + tid] = -INFINITY;  // the last float4's tail
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // Element 4 q + c of the chunk: this thread's q ascend, so its
    // elements arrive in ascending index order.
    float pm = -INFINITY;
    for (int q = tid; q < n4; q += T) {
      const float4 f = xs4[q];
      pm = fmaxf(fmaxf(pm, fmaxf(f.x, f.y)), fmaxf(f.z, f.w));
    }
    // tau: the largest over warps of the k-th largest lane maximum, each a
    // lower bound of the row's k-th value.
    const float wt = warp_kth_desc(pm, k);
    if (lane == 0) warp_tau[warp] = wt;
    __syncthreads();
    for (int w = 0; w < n_warps; ++w) tau = fmaxf(tau, warp_tau[w]);
    const float mn = fmaxf(m, pm);
    const bool sum = kLse && mn != -INFINITY;  // once a chunk, not an element
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int q = tid; q < n4; q += T) {
      const float4 f = xs4[q];
      if (sum) {
        part[0] += exp_le0(f.x - mn);
        part[1] += exp_le0(f.y - mn);
        part[2] += exp_le0(f.z - mn);
        part[3] += exp_le0(f.w - mn);
      }
      if (fmaxf(fmaxf(f.x, f.y), fmaxf(f.z, f.w)) >= tau) {  // the rare case
#pragma unroll 1
        for (int c = 0; c < 4; ++c) {
          const float v = xs[4 * q + c];
          if (v >= tau) list_insert<KP>(tv, ti, v, base + 4 * q + c);
        }
      }
    }
    if (sum) {
      // m = -inf (nothing seen yet): exp gives 0 and s is 0 already.
      s = s * exp_le0(m - mn) + ((part[0] + part[1]) + (part[2] + part[3]));
      m = mn;
    }
  }

  // The merge. Few elements reach the lists, so their real entries (those
  // with an index) are gathered, in thread order, into one warp and sorted
  // there by a bitonic network; where more than 32 did (ties around the
  // k-th value), a warp merges its lists in k rounds, then warp 0 merges
  // the warps' lists. The (m, s) pairs merge by warps, then in warp 0.
  int n_real = 0;
#pragma unroll
  for (int j = 0; j < KP; ++j) n_real += ti[j] != kSentinelIdx;
  int incl = n_real;  // inclusive prefix over the warp's lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += t;
  }
  if (kLse) group_lse(m, s);
  if (lane == 31) warp_cnt[warp] = incl;
  if (lane == 0) {
    warp_m[warp] = m;
    warp_s[warp] = s;
  }
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < n_warps; ++w) {
    const int c = warp_cnt[w];
    total += c;
    if (w < warp) before += c;
  }
  float mv[KP];
  int mi[KP];
  if (total <= 32) {
    const int off = before + incl - n_real;
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      if (j < n_real) {
        cand_v[off + j] = tv[j];
        cand_i[off + j] = ti[j];
      }
    }
    __syncthreads();
    if (warp == 0) {
      float v = lane < total ? cand_v[lane] : -INFINITY;
      int i = lane < total ? cand_i[lane] : kSentinelIdx;
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
        for (int stride = size / 2; stride > 0; stride >>= 1) {
          const float ov = __shfl_xor_sync(kFullMask, v, stride);
          const int oi = __shfl_xor_sync(kFullMask, i, stride);
          // A descending block keeps the better one in its lower lane.
          const bool keep_better = ((lane & size) == 0) == ((lane & stride) == 0);
          if (keep_better ? better(ov, oi, v, i) : better(v, i, ov, oi)) {
            v = ov;
            i = oi;
          }
        }
      }
      if (lane < k) {
        vals[static_cast<size_t>(row) * k + lane] = v;
        idx[static_cast<size_t>(row) * k + lane] = i;
      }
    }
  } else {
    group_merge<KP>(tv, ti, mv, mi, k);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        if (j < k) {
          warp_v[warp][j] = mv[j];
          warp_i[warp][j] = mi[j];
        }
      }
    }
    __syncthreads();
    if (warp == 0) {  // lanes 0 .. kMaxWarps - 1 hold the warps' lists
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        const bool have = lane < n_warps && j < k;
        tv[j] = have ? warp_v[lane][j] : -INFINITY;
        ti[j] = have ? warp_i[lane][j] : kSentinelIdx;
      }
      group_merge<KP, kMaxWarps>(tv, ti, mv, mi, k);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < KP; ++j) {
          if (j < k) {
            vals[static_cast<size_t>(row) * k + j] = mv[j];
            idx[static_cast<size_t>(row) * k + j] = mi[j];
          }
        }
      }
    }
  }
  if (kLse && warp == 0) {
    m = lane < n_warps ? warp_m[lane] : -INFINITY;
    s = lane < n_warps ? warp_s[lane] : 0.0f;
    group_lse<kMaxWarps>(m, s);
    if (lane == 0) lse[row] = lse_value(m, s);
  }
}

template <int KP, bool kLse>
void launch_kp(const float* x, float* vals, int* idx, float* lse, int n, int v, int k,
               cudaStream_t st) {
  const int chunk = std::min(v, kChunk);
  const int per = (chunk + 4 * kPerThread - 1) / (4 * kPerThread);
  const int threads = std::min(kMaxThreads, std::max(32, (per + 31) / 32 * 32));
  const size_t bytes = static_cast<size_t>((chunk + 3) / 4) * 16;
  if (v % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0) {
    topk_lse_kernel<KP, kLse, true><<<n, threads, bytes, st>>>(x, vals, idx, lse, v, k);
  } else {
    topk_lse_kernel<KP, kLse, false><<<n, threads, bytes, st>>>(x, vals, idx, lse, v, k);
  }
}

template <bool kLse>
int launch(const float* x, float* vals, int* idx, float* lse, int n, int v,
           int k, void* stream) {
  if (n <= 0 || v <= 0 || k < 1 || k > 16 || k > v) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 1) {
    launch_kp<1, kLse>(x, vals, idx, lse, n, v, k, st);
  } else if (k == 2) {
    launch_kp<2, kLse>(x, vals, idx, lse, n, v, k, st);
  } else if (k <= 4) {
    launch_kp<4, kLse>(x, vals, idx, lse, n, v, k, st);
  } else if (k <= 8) {
    launch_kp<8, kLse>(x, vals, idx, lse, n, v, k, st);
  } else {
    launch_kp<16, kLse>(x, vals, idx, lse, n, v, k, st);
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
