// One decode step of Bahdanau (additive) attention:
//   dec_proj = W_d h + b_d                       (A per row)
//   scores   = v . tanh(enc_proj + dec_proj) + b_v (S per row)
//   weights  = softmax(mask > 0 ? scores : -1e9)
//   context  = weights . enc_outs                 (E per row)
//
// Replaces: video_captioning_tpu/ops/attention_pallas.py, _attend_kernel
// (bahdanau_attend_pallas), the attention of greedy decoding and of
// eval-mode teacher forcing when kernels.use_pallas_attention is set
// (models/attention.py:attend).
//
// Contract (held by the tests against the plain PyTorch version in
// ops/attention.py): float32 throughout; a row whose mask is all <= 0
// gets uniform weights (every score is -1e9), as the TPU kernel does; b_v
// is read from device memory, so the caller never syncs for it.
//
// What bounds it on an H100: device-memory reads. At B = 128, S = 80,
// A = E = 512 the step reads enc_proj and enc_outs once, 42 MB, about
// 12.5 us at 3.35 TB/s; its operations (one tanh and two FMAs per enc_proj
// element) are far below the card's rates.
//
// Design: two launches. (1) dec_proj for all rows, a warp per output unit
// with the lanes along D reading W_d (A x D) coalesced in its stored
// layout, against 16 rows of h staged in shared memory, so W_d is read
// once per 16 rows. (2) One CTA per batch row streams that row's enc_proj
// and enc_outs (160 KB each at full width) exactly once: a warp per frame
// reduces v . tanh(enc_proj + dec_proj) with 16-byte loads (four in
// flight a lane at A = 512), the S scores stay in shared memory for the
// masked, max-shifted softmax, and each thread then sums weights x
// enc_outs down the frames for one context column, eight frames' loads in
// flight. A row per CTA keeps a CTA on nearly every SM at B = 128; a
// single fused launch with two rows a CTA left half the card idle, and its
// latency-bound dec_proj loop made it 4x slower on an H100.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kProjThreads = 256;
constexpr int kProjRows = 16;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kMaskFill = -1e9f;

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

// dp[b][a] = sum_d h[b][d] * W_d[a][d] + b_d[a]; grid (A / 8, B / 16).
__global__ void __launch_bounds__(kProjThreads)
    dec_proj_kernel(const float* __restrict__ h, const float* __restrict__ w_d,
                    const float* __restrict__ b_d, float* __restrict__ dp, int B,
                    int D, int A) {
  extern __shared__ __align__(16) float hs[];  // [kProjRows][D]
  const int b0 = blockIdx.y * kProjRows;
  const int nr = min(kProjRows, B - b0);
  for (int e = threadIdx.x; e < nr * D; e += kProjThreads) {
    hs[e] = __ldg(h + static_cast<size_t>(b0) * D + e);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int a = blockIdx.x * (kProjThreads / 32) + (threadIdx.x >> 5);
  if (a >= A) return;
  float acc[kProjRows] = {};
  const float* wr = w_d + static_cast<size_t>(a) * D;
  for (int d = lane; d < D; d += 32) {
    const float w = __ldg(wr + d);
#pragma unroll
    for (int r = 0; r < kProjRows; ++r) {
      if (r < nr) acc[r] = fmaf(hs[r * D + d], w, acc[r]);
    }
  }
  const float bias = __ldg(b_d + a);
#pragma unroll
  for (int r = 0; r < kProjRows; ++r) {
    if (r < nr) {
      const float t = warp_sum(acc[r]);
      if (lane == 0) dp[static_cast<size_t>(b0 + r) * A + a] = t + bias;
    }
  }
}

// One CTA per batch row. kVec: A % 4 == 0 and 16-byte aligned rows, so
// enc_proj, dec_proj and v are read as float4.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    attend_row_kernel(const float* __restrict__ dp,
                      const float* __restrict__ enc_proj,
                      const float* __restrict__ enc_outs,
                      const float* __restrict__ v, const float* __restrict__ b_v,
                      const float* __restrict__ mask,
                      float* __restrict__ context, float* __restrict__ weights,
                      int S, int A, int E) {
  extern __shared__ __align__(16) float smem[];
  float* dps = smem;     // [A]
  float* vs = dps + A;   // [A]
  float* sc = vs + A;    // [S]

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int a = threadIdx.x; a < A; a += kThreads) {
    dps[a] = __ldg(dp + static_cast<size_t>(b) * A + a);
    vs[a] = __ldg(v + a);
  }
  __syncthreads();

  const float bias_v = __ldg(b_v);
  for (int s = warp; s < S; s += kWarps) {
    const size_t row = static_cast<size_t>(b) * S + s;
    const float* ep = enc_proj + row * A;
    float acc = 0.0f;
    if (kVec) {
      const float4* ep4 = reinterpret_cast<const float4*>(ep);
      const float4* dp4 = reinterpret_cast<const float4*>(dps);
      const float4* v4 = reinterpret_cast<const float4*>(vs);
#pragma unroll 4
      for (int i = lane; i < A / 4; i += 32) {
        const float4 e = __ldg(ep4 + i);
        const float4 d = dp4[i];
        const float4 w = v4[i];
        acc = fmaf(w.x, tanhf(e.x + d.x), acc);
        acc = fmaf(w.y, tanhf(e.y + d.y), acc);
        acc = fmaf(w.z, tanhf(e.z + d.z), acc);
        acc = fmaf(w.w, tanhf(e.w + d.w), acc);
      }
    } else {
#pragma unroll 4
      for (int a = lane; a < A; a += 32) acc = fmaf(vs[a], tanhf(__ldg(ep + a) + dps[a]), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) sc[s] = __ldg(mask + row) > 0.0f ? acc + bias_v : kMaskFill;
  }
  __syncthreads();

  if (warp == 0) {  // softmax over S
    float mx = -INFINITY;
    for (int s = lane; s < S; s += 32) mx = fmaxf(mx, sc[s]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float ex = expf(sc[s] - mx);
      sc[s] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
    float* wout = weights + static_cast<size_t>(b) * S;
    for (int s = lane; s < S; s += 32) {
      const float w = sc[s] / sum;
      sc[s] = w;
      wout[s] = w;
    }
  }
  __syncthreads();

  const float* eo = enc_outs + static_cast<size_t>(b) * S * E;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float acc = 0.0f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) acc = fmaf(sc[s], __ldg(eo + static_cast<size_t>(s) * E + e), acc);
    context[static_cast<size_t>(b) * E + e] = acc;
  }
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns a cudaError_t: 0 when both launches were accepted. dp is (B, A)
// float32 scratch.
extern "C" int vct_bahdanau_attend_f32(const float* h, const float* w_d,
                                       const float* b_d, const float* enc_proj,
                                       const float* enc_outs, const float* v,
                                       const float* b_v, const float* mask,
                                       float* dp, float* context, float* weights,
                                       int B, int S, int D, int A, int E,
                                       void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || A <= 0 || E <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t proj_smem = sizeof(float) * kProjRows * D;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(dec_proj_kernel), proj_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 proj_grid((A + kProjThreads / 32 - 1) / (kProjThreads / 32),
                       (B + kProjRows - 1) / kProjRows);
  dec_proj_kernel<<<proj_grid, kProjThreads, proj_smem, st>>>(h, w_d, b_d, dp, B, D, A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t row_smem = sizeof(float) * (2 * static_cast<size_t>(A) + S);
  const bool vec = A % 4 == 0 && reinterpret_cast<size_t>(enc_proj) % 16 == 0 &&
                   reinterpret_cast<size_t>(v) % 16 == 0;
  if (vec) {
    err = set_smem(reinterpret_cast<const void*>(attend_row_kernel<true>), row_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attend_row_kernel<true><<<B, kThreads, row_smem, st>>>(
        dp, enc_proj, enc_outs, v, b_v, mask, context, weights, S, A, E);
  } else {
    err = set_smem(reinterpret_cast<const void*>(attend_row_kernel<false>), row_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attend_row_kernel<false><<<B, kThreads, row_smem, st>>>(
        dp, enc_proj, enc_outs, v, b_v, mask, context, weights, S, A, E);
  }
  return static_cast<int>(cudaGetLastError());
}
