// The transformer family's two beam-decode attention kernels.
//
// beam_self_attention: ancestry-indexed cached self-attention of one
// decoder layer at one beam step. For beam k of clip b (row n = b*K + k)
// and each position tau <= t, the key and value are the physical cache row
// (tau, b*K + anc[b, k, tau]); per head the score is q . k / sqrt(dh), the
// softmax is float32, and the context is sum_tau w * v. Positions tau > t,
// which the TPU kernel fills with -1e9, get a weight of exp(-1e9 - m) = 0
// in float32 there, so reading only the prefix gives its result.
//
// beam_cross_attention: one query per beam over the clip's un-expanded
// encoder keys and values (B, S, D); a frame whose mask is <= 0 scores
// -1e9 (a fully masked row gets uniform weights, not NaN). Outputs the
// context and the softmax weights averaged over the heads.
//
// Replaces: video_captioning_tpu/ops/transformer_attn_pallas.py,
// _self_attn_kernel (beam_self_attention) and _cross_attn_kernel
// (beam_cross_attention), which models/transformer.py:
// decode_step_beam_core runs once per decoder block per beam step under
// kernels.transformer_fused_beam_attn (the cross kernel alone under
// kernels.transformer_fused_cross_attn).
//
// Contract (held by the tests against the plain PyTorch versions in
// ops/transformer_attn.py): q and the outputs are float32; the caches and
// the cross keys/values are float32 or bfloat16, read as stored and
// widened to float32, so scores, softmax and sums are float32 either way.
// anc[b, k, tau] lies in [0, K) for tau <= t.
//
// What bounds them on an H100: device-memory reads. The self kernel reads
// each selected cache row's head slice once per beam that selects it:
// at B = 128, K = 5, D = 512, t = 19 in float32, 20 rows x 640 x 512 x 4 B
// x 2 caches = 52 MB, about 16 us at 3.35 TB/s. The cross kernel reads the
// clip's keys and values once per clip, not once per beam: 2 x 128 x 80 x
// 512 x 4 B = 42 MB, about 13 us. Their operations (two FMAs a loaded
// element per beam) are far below the card's float32 rate.
//
// Design: one CTA per (clip, head), one warp per beam (K <= 16 warps).
// Self: each warp reads its own beam's rows, a lane holding up to four of
// the head's dh <= 128 columns at stride 32, so a row slice is one
// coalesced warp load; rows that several beams share come from L2. An
// online softmax (running max, sum and context per warp) needs no storage
// for the scores and takes any T; the TPU kernel's one-hot selection over
// all K slots becomes one index load per position. Cross: the clip's keys
// and values are shared by all K warps, so the CTA stages them through
// shared memory in chunks of 32 frames (any S) and each element leaves
// device memory once; a first version in which every warp read them from
// L2 itself was 4.9x the byte bound. The per-head weights go to a
// (B*K, heads, S) float32 scratch, and a second small launch averages the
// heads in a fixed order (no atomics), so a run repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kMaskFill = -1e9f;
constexpr int kMeanThreads = 256;
constexpr int kChunk = 32;  // frames a cross-attention CTA stages at a time

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Four consecutive elements as float32: one 16-byte (float) or 8-byte
// (bfloat16) load; p is aligned to that size.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

// Rows c0 .. c0 + nch - 1 of a clip's (S, D) keys or values, this head's
// dh columns, into tile[s][0 .. dh) with a row stride of dh + 1. kVec
// (dh % 4 == 0, aligned rows): four elements a load and four loads in
// flight a thread, which the latency of device memory needs.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_rows(float* tile, const T* src, int c0, int nch, int D,
                                           int dh) {
  const int ld = dh + 1;
  if (kVec) {
    const int q4 = dh / 4;
    const int n4 = nch * q4;
    for (int base = threadIdx.x; base < n4; base += 4 * blockDim.x) {
      float4 r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = base + u * blockDim.x;
        if (e < n4) {
          const int s = e / q4;
          r[u] = load4(src + static_cast<size_t>(c0 + s) * D + 4 * (e - s * q4));
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = base + u * blockDim.x;
        if (e < n4) {
          const int s = e / q4;
          float* dst = tile + s * ld + 4 * (e - s * q4);
          dst[0] = r[u].x;
          dst[1] = r[u].y;
          dst[2] = r[u].z;
          dst[3] = r[u].w;
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < nch * dh; e += blockDim.x) {
      const int s = e / dh;
      tile[s * ld + (e - s * dh)] = to_f32(src[static_cast<size_t>(c0 + s) * D + (e - s * dh)]);
    }
  }
}

// Grid (B, heads), 32 * K threads: warp k is beam k of clip blockIdx.x.
// kEpl = ceil(dh / 32) columns a lane.
template <typename T, int kEpl>
__global__ void beam_self_attn_kernel(const float* __restrict__ q, const T* __restrict__ kc,
                                      const T* __restrict__ vc, const int* __restrict__ anc,
                                      float* __restrict__ ctx, int K, int D, int dh,
                                      int T_max, int t, float scale) {
  const int b = blockIdx.x;
  const int col0 = blockIdx.y * dh;
  const int k = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t N = static_cast<size_t>(gridDim.x) * K;
  const size_t n = static_cast<size_t>(b) * K + k;

  float qr[kEpl], acc[kEpl];
#pragma unroll
  for (int i = 0; i < kEpl; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < dh ? __ldg(q + n * D + col0 + d) : 0.0f;
    acc[i] = 0.0f;
  }
  const int* anc_n = anc + n * T_max;
  float m = -INFINITY;
  float l = 0.0f;
#pragma unroll 4
  for (int tau = 0; tau <= t; ++tau) {
    const int j = __ldg(anc_n + tau);
    const size_t row = (static_cast<size_t>(tau) * N + static_cast<size_t>(b) * K + j) * D + col0;
    float s = 0.0f;
    float vv[kEpl];
#pragma unroll
    for (int i = 0; i < kEpl; ++i) {
      const int d = lane + 32 * i;
      vv[i] = 0.0f;
      if (d < dh) {
        s = fmaf(qr[i], to_f32(kc[row + d]), s);
        vv[i] = to_f32(vc[row + d]);
      }
    }
    s = warp_sum(s) * scale;
    const float m_new = fmaxf(m, s);
    const float c = expf(m - m_new);  // 0 at the first position (m = -inf)
    const float p = expf(s - m_new);
    l = fmaf(l, c, p);
#pragma unroll
    for (int i = 0; i < kEpl; ++i) acc[i] = fmaf(p, vv[i], acc[i] * c);
    m = m_new;
  }
#pragma unroll
  for (int i = 0; i < kEpl; ++i) {
    const int d = lane + 32 * i;
    if (d < dh) ctx[n * D + col0 + d] = acc[i] / l;
  }
}

// Grid (B, heads), 32 * K threads: warp k is beam k. The clip's keys, then
// its values, pass through shared memory in chunks of kChunk frames, each
// element read from device memory once for all K beams. Scores: lane l
// scores frame c0 + l of each chunk against its beam's query (rows padded
// to dh + 1 floats, so the 32 lanes hit 32 banks) and keeps it in its own
// slots of wh, the (B*K, heads, S) float32 scratch; the same lane
// normalises and later reads them back, so no other thread touches them.
// Context: lane l holds columns l + 32 i and takes each frame's weight
// from the lane that owns it by a shuffle.
template <typename T, int kEpl, bool kVec>
__global__ void beam_cross_attn_kernel(const float* __restrict__ q, const T* __restrict__ ck,
                                       const T* __restrict__ cv, const float* __restrict__ mask,
                                       float* __restrict__ ctx, float* __restrict__ wh, int K,
                                       int D, int dh, int S, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* tile = smem;               // [kChunk][dh + 1]
  float* qs = smem + kChunk * ld;   // [K][dh]
  const int b = blockIdx.x;
  const int head = blockIdx.y;
  const int H = gridDim.y;
  const int col0 = head * dh;
  const int k = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t n = static_cast<size_t>(b) * K + k;

  for (int e = threadIdx.x; e < K * dh; e += blockDim.x) {
    const int kk = e / dh;
    qs[e] = __ldg(q + (static_cast<size_t>(b) * K + kk) * D + col0 + (e - kk * dh));
  }
  float* w_row = wh + (n * H + head) * S;
  const T* kb = ck + static_cast<size_t>(b) * S * D + col0;
  const T* vb = cv + static_cast<size_t>(b) * S * D + col0;
  const float* mb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * S;
  const float* qk = qs + k * dh;

  float mx = -INFINITY;
  for (int c0 = 0; c0 < S; c0 += kChunk) {
    const int nch = min(kChunk, S - c0);
    __syncthreads();  // the previous chunk is consumed (and qs is written)
    stage_rows<T, kVec>(tile, kb, c0, nch, D, dh);
    __syncthreads();
    if (lane < nch) {
      const float* kr = tile + lane * ld;
      float sc = 0.0f;
#pragma unroll 8
      for (int d = 0; d < dh; ++d) sc = fmaf(qk[d], kr[d], sc);
      sc *= scale;
      if (mb != nullptr && !(__ldg(mb + c0 + lane) > 0.0f)) sc = kMaskFill;
      w_row[c0 + lane] = sc;
      mx = fmaxf(mx, sc);
    }
  }
  mx = warp_max(mx);
  float sum = 0.0f;
  for (int s = lane; s < S; s += 32) {
    const float e = expf(w_row[s] - mx);
    w_row[s] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int s = lane; s < S; s += 32) w_row[s] = w_row[s] / sum;

  float acc[kEpl];
#pragma unroll
  for (int i = 0; i < kEpl; ++i) acc[i] = 0.0f;
  for (int c0 = 0; c0 < S; c0 += kChunk) {
    const int nch = min(kChunk, S - c0);
    __syncthreads();
    stage_rows<T, kVec>(tile, vb, c0, nch, D, dh);
    __syncthreads();
    const float wl = lane < nch ? w_row[c0 + lane] : 0.0f;
    for (int s = 0; s < nch; ++s) {
      const float w = __shfl_sync(kFullMask, wl, s);
#pragma unroll
      for (int i = 0; i < kEpl; ++i) {
        const int d = lane + 32 * i;
        if (d < dh) acc[i] = fmaf(w, tile[s * ld + d], acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kEpl; ++i) {
    const int d = lane + 32 * i;
    if (d < dh) ctx[n * D + col0 + d] = acc[i];
  }
}

// w[n, s] = sum over heads, in head order, of wh[n, h, s], over heads.
__global__ void __launch_bounds__(kMeanThreads)
    head_mean_kernel(const float* __restrict__ wh, float* __restrict__ w, int NS, int H, int S) {
  const int idx = blockIdx.x * kMeanThreads + threadIdx.x;
  if (idx >= NS) return;
  const int n = idx / S;
  const int s = idx - n * S;
  const float* p = wh + static_cast<size_t>(n) * H * S + s;
  float acc = 0.0f;
  for (int h = 0; h < H; ++h) acc += p[static_cast<size_t>(h) * S];
  w[idx] = acc / static_cast<float>(H);
}

template <typename T>
cudaError_t launch_self(const float* q, const void* kc, const void* vc, const int* anc,
                        float* ctx, int B, int K, int H, int D, int T_max, int t,
                        cudaStream_t st) {
  const int dh = D / H;
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));
  const dim3 grid(B, H);
  const int threads = 32 * K;
  const T* kp = static_cast<const T*>(kc);
  const T* vp = static_cast<const T*>(vc);
#define VCT_SELF(EPL)                                                                   \
  beam_self_attn_kernel<T, EPL>                                                         \
      <<<grid, threads, 0, st>>>(q, kp, vp, anc, ctx, K, D, dh, T_max, t, scale)
  switch ((dh + 31) / 32) {
    case 1: VCT_SELF(1); break;
    case 2: VCT_SELF(2); break;
    case 3: VCT_SELF(3); break;
    default: VCT_SELF(4); break;
  }
#undef VCT_SELF
  return cudaGetLastError();
}

template <typename T, int kEpl>
cudaError_t launch_cross_epl(bool vec, dim3 grid, int threads, size_t smem, cudaStream_t st,
                             const float* q, const T* kp, const T* vp, const float* mask,
                             float* ctx, float* wh, int K, int D, int dh, int S, float scale) {
  if (vec) {
    beam_cross_attn_kernel<T, kEpl, true>
        <<<grid, threads, smem, st>>>(q, kp, vp, mask, ctx, wh, K, D, dh, S, scale);
  } else {
    beam_cross_attn_kernel<T, kEpl, false>
        <<<grid, threads, smem, st>>>(q, kp, vp, mask, ctx, wh, K, D, dh, S, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cross(const float* q, const void* ck, const void* cv, const float* mask,
                         float* ctx, float* wh, int B, int K, int H, int D, int S,
                         cudaStream_t st) {
  const int dh = D / H;
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));
  const dim3 grid(B, H);
  const int threads = 32 * K;
  // At most (32 x 129 + 16 x 128) floats, 24.7 KB: no opt-in needed.
  const size_t smem = sizeof(float) * (kChunk * (dh + 1) + K * dh);
  const T* kp = static_cast<const T*>(ck);
  const T* vp = static_cast<const T*>(cv);
  const size_t align = 4 * sizeof(T);
  const bool vec = dh % 4 == 0 && D % 4 == 0 && reinterpret_cast<size_t>(kp) % align == 0 &&
                   reinterpret_cast<size_t>(vp) % align == 0;
#define VCT_CROSS(EPL)                                                                  \
  launch_cross_epl<T, EPL>(vec, grid, threads, smem, st, q, kp, vp, mask, ctx, wh, K, D, dh, S, \
                           scale)
  switch ((dh + 31) / 32) {
    case 1: return VCT_CROSS(1);
    case 2: return VCT_CROSS(2);
    case 3: return VCT_CROSS(3);
    default: return VCT_CROSS(4);
  }
#undef VCT_CROSS
}

bool bad_shape(int B, int K, int H, int D) {
  return B <= 0 || K <= 0 || K > 16 || H <= 0 || D <= 0 || D % H != 0 || D / H > 128;
}

}  // namespace

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns a cudaError_t: 0 when the launch was accepted. q, ctx (B*K, D)
// float32; kc, vc (T, B*K, D) float32 or (cache_bf16) bfloat16; anc
// (B, K, T) int32.
extern "C" int vct_beam_self_attention(const float* q, const void* kc, const void* vc,
                                       const int* anc, float* ctx, int cache_bf16, int B, int K,
                                       int H, int D, int T_max, int t, void* stream) {
  if (bad_shape(B, K, H, D) || t < 0 || t >= T_max) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cache_bf16 ? launch_self<__nv_bfloat16>(q, kc, vc, anc, ctx, B, K, H, D, T_max, t, st)
                 : launch_self<float>(q, kc, vc, anc, ctx, B, K, H, D, T_max, t, st);
  return static_cast<int>(err);
}

// Returns a cudaError_t: 0 when both launches were accepted. q, ctx
// (B*K, D) float32; ck, cv (B, S, D) float32 or (kv_bf16) bfloat16; mask
// (B, S) float32 or null (every frame valid); wh (B*K, H, S) float32
// scratch; w (B*K, S) float32.
extern "C" int vct_beam_cross_attention(const float* q, const void* ck, const void* cv,
                                        const float* mask, float* ctx, float* wh, float* w,
                                        int kv_bf16, int B, int K, int H, int D, int S,
                                        void* stream) {
  if (bad_shape(B, K, H, D) || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      kv_bf16 ? launch_cross<__nv_bfloat16>(q, ck, cv, mask, ctx, wh, B, K, H, D, S, st)
              : launch_cross<float>(q, ck, cv, mask, ctx, wh, B, K, H, D, S, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int NS = B * K * S;
  const int blocks = (NS + kMeanThreads - 1) / kMeanThreads;
  head_mean_kernel<<<blocks, kMeanThreads, 0, st>>>(wh, w, NS, H, S);
  return static_cast<int>(cudaGetLastError());
}
