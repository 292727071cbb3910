// One stride-1 identity-residual ResNet bottleneck block, fully fused:
//   out = relu(relu(conv3x3(relu(x . W1^T + b1)) + b2) . W3^T + b3 + x)
// over NHWC x (B, H, W, C), float32 or bfloat16, BN folded into the
// weights: w1 (Cm, C), w2 (Cm, 3, 3, Cm) (OIHW in channels_last memory, so
// a row is the 9 x Cm taps of one output channel), w3 (C, Cm), biases in
// x's type. Products accumulate in float32; in bfloat16, y1 and y2 are
// rounded to bfloat16 before the next product, as the TPU kernel does.
//
// Replaces: video_captioning_tpu/ops/bottleneck_pallas.py, _kernel
// (fused_bottleneck), the 12 stride-1 identity blocks of ResNet50 under
// resnet50_variant "fused" and "fused_s2d".
//
// What bounds it on an H100: float32 operations on CUDA cores. Every
// stage's block is about 13.98 GFLOP at B = 32 (0.209 ms at 67 TFLOP/s)
// against 0.1-0.4 GB of x and out (0.03-0.12 ms at 3.35 TB/s).
//
// Design: the TPU kernel keeps a whole image in VMEM; a CTA here has at most
// 227 KB of shared memory (y1 alone is 803 KB at stage 1 in float32), so a
// CTA owns a t x t tile of output pixels of one image and all C channels:
//   1. y1 for the tile plus a one-pixel halo, (t+2)^2 x Cm, into shared
//      memory (the halo recomputes W1). y1 outside the image is zero after
//      the ReLU, as the TPU kernel's padding of y1 makes it, not relu(b1).
//   2. y2 = relu(conv3x3(y1) + b2), t^2 x Cm, into shared memory: one GEMM
//      over K = 9 Cm whose A rows gather the nine shifted halo pixels.
//   3. out = relu(y2 . W3^T + b3 + x) for the tile's pixels inside the image.
// Each phase is the block-wide SIMT product of simt_gemm.cuh, its weights
// streamed from device memory (L2-resident across CTAs); where C and Cm are
// multiples of 16 its vector path prefetches the next k-slice, and in
// bfloat16 runs on the tensor cores (mma.sync m16n8k16, float32
// accumulators). The host picks the
// square tile side t <= 8 that fits shared memory with the least estimated
// time (pick_tile): at B = 32, 8 at 56 x 56, 7 at 28 and 14, 4 at 7 x 7.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "simt_gemm.cuh"

namespace {

using vct_simt::from_f;
using vct_simt::kStageFloats;
using vct_simt::kThreads;
using vct_simt::to_f;

constexpr size_t kSmemBudget = 220 * 1024;

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

template <typename T>
size_t smem_bytes(int t, int Cm) {
  return sizeof(float) * kStageFloats +
         sizeof(T) * static_cast<size_t>((t + 2) * (t + 2) + t * t) * Cm;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    fused_bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                            const T* __restrict__ b1, const T* __restrict__ w2,
                            const T* __restrict__ b2, const T* __restrict__ w3,
                            const T* __restrict__ b3, T* __restrict__ out, int H, int W, int C,
                            int Cm, int t, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  T* y1 = reinterpret_cast<T*>(stage + kStageFloats);  // [(t+2)(t+2)][Cm]
  const int hw = t + 2;
  T* y2 = y1 + static_cast<size_t>(hw * hw) * Cm;       // [t*t][Cm]

  const int b = blockIdx.y;
  const int oy = (blockIdx.x / tiles_w) * t, ox = (blockIdx.x % tiles_w) * t;
  const T* xb = x + static_cast<size_t>(b) * H * W * C;
  T* ob = out + static_cast<size_t>(b) * H * W * C;

  // 1. y1 over the halo tile.
  auto inside = [=](int r, int& gy, int& gx) {
    gy = oy - 1 + r / hw;
    gx = ox - 1 + r % hw;
    return gy >= 0 && gy < H && gx >= 0 && gx < W;
  };
  auto a1 = [=](int r, int k) {
    int gy, gx;
    return inside(r, gy, gx) ? to_f(xb[(static_cast<size_t>(gy) * W + gx) * C + k]) : 0.0f;
  };
  auto a1p = [=](int r, int k0) -> const T* {
    int gy, gx;
    return inside(r, gy, gx) ? xb + (static_cast<size_t>(gy) * W + gx) * C + k0 : nullptr;
  };
  auto e1 = [=](int r, int n, float v) {
    int gy, gx;
    y1[static_cast<size_t>(r) * Cm + n] =
        from_f<T>(inside(r, gy, gx) ? fmaxf(v + to_f(b1[n]), 0.0f) : 0.0f);
  };
  vct_simt::block_gemm_any<kVec>(a1, a1p, w1, hw * hw, Cm, C, stage, e1);
  __syncthreads();

  // 2. y2 = relu(conv3x3(y1) + b2): row r is output pixel (r / t, r % t),
  // k = tap * Cm + ci with tap = 3 dy + dx, w2's channels_last row order.
  auto a2 = [=](int r, int k) {
    const int tap = k / Cm, ci = k - tap * Cm;
    const int py = r / t + tap / 3, px = r % t + tap % 3;
    return to_f(y1[static_cast<size_t>(py * hw + px) * Cm + ci]);
  };
  auto a2p = [=](int r, int k0) -> const T* {  // a k-slice lies within one tap
    const int tap = k0 / Cm;
    const int py = r / t + tap / 3, px = r % t + tap % 3;
    return y1 + static_cast<size_t>(py * hw + px) * Cm + (k0 - tap * Cm);
  };
  auto e2 = [=](int r, int n, float v) {
    y2[static_cast<size_t>(r) * Cm + n] = from_f<T>(fmaxf(v + to_f(b2[n]), 0.0f));
  };
  vct_simt::block_gemm_any<kVec>(a2, a2p, w2, t * t, Cm, 9 * Cm, stage, e2);
  __syncthreads();

  // 3. out = relu(y2 . W3^T + b3 + x) inside the image.
  auto a3 = [=](int r, int k) { return to_f(y2[static_cast<size_t>(r) * Cm + k]); };
  auto a3p = [=](int r, int k0) -> const T* { return y2 + static_cast<size_t>(r) * Cm + k0; };
  auto e3 = [=](int r, int n, float v) {
    const int gy = oy + r / t, gx = ox + r % t;
    if (gy >= H || gx >= W) return;
    const size_t o = (static_cast<size_t>(gy) * W + gx) * C + n;
    ob[o] = from_f<T>(fmaxf((v + to_f(b3[n])) + to_f(xb[o]), 0.0f));
  };
  vct_simt::block_gemm_any<kVec>(a3, a3p, w3, t * t, C, Cm, stage, e3);
}

// The square tile side: the t <= 8 that fits kSmemBudget with the least
// estimated time, waves of CTAs over the SMs times a CTA's work: its
// products (4 (t+2)^2 + 13 t^2 units of Cm^2 multiply-adds) and its read of
// the 17 Cm^2 weights from L2 (worth about 35 units a weight byte, from the
// L2 rate against the SIMT rate); 0 when none fits.
template <typename T>
int pick_tile(int B, int H, int W, int Cm, int sms) {
  int best = 0;
  long long best_cost = 0;
  for (int t = 1; t <= 8; ++t) {
    if (smem_bytes<T>(t, Cm) > kSmemBudget) continue;
    const long long ctas = static_cast<long long>(B) * ((H + t - 1) / t) * ((W + t - 1) / t);
    const long long cost = ((ctas + sms - 1) / sms) *
                           (4LL * (t + 2) * (t + 2) + 13LL * t * t + 35LL * sizeof(T));
    if (best == 0 || cost < best_cost) {
      best = t;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T>
int launch(const T* x, const T* w1, const T* b1, const T* w2, const T* b2, const T* w3,
           const T* b3, T* out, int B, int H, int W, int C, int Cm, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cm <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int t = pick_tile<T>(B, H, W, Cm, sms);
  if (t == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = smem_bytes<T>(t, Cm);
  // Vector loads take every k-slice within one row (and one tap of w2) and
  // 16-byte aligned rows.
  const bool vec = C % vct_simt::kK == 0 && Cm % vct_simt::kK == 0 && aligned16(x) &&
                   aligned16(w1) && aligned16(w2) && aligned16(w3);
  auto kernel = vec ? fused_bottleneck_kernel<T, true> : fused_bottleneck_kernel<T, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + t - 1) / t;
  const dim3 grid(((H + t - 1) / t) * tiles_w, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w1, b1, w2, b2, w3, b3, out, H, W, C, Cm, t, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each returns a cudaError_t: 0 when the launch was accepted.
extern "C" int vct_fused_bottleneck_f32(const float* x, const float* w1, const float* b1,
                                        const float* w2, const float* b2, const float* w3,
                                        const float* b3, float* out, int B, int H, int W, int C,
                                        int Cm, void* stream) {
  return launch<float>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, Cm, stream);
}

extern "C" int vct_fused_bottleneck_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w1,
                                         const __nv_bfloat16* b1, const __nv_bfloat16* w2,
                                         const __nv_bfloat16* b2, const __nv_bfloat16* w3,
                                         const __nv_bfloat16* b3, __nv_bfloat16* out, int B,
                                         int H, int W, int C, int Cm, void* stream) {
  return launch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, Cm, stream);
}
