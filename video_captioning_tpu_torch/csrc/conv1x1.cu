// A 1x1 conv as a matmul with a fused epilogue:
//   out = relu?(x . w^T + b [+ r]), x (M, K), w (N, K), b (N,), r (M, N),
// float32 or bfloat16 operands, float32 products and sums, the epilogue
// applied to the accumulator before the one store, the output in x's type.
//
// Replaces: video_captioning_tpu/ops/conv1x1_pallas.py, _kernel_plain and
// _kernel_res (matmul_bias_act / conv1x1). Neither package calls it on a
// model path; chip_smoke.py holds it against its plain version.
//
// What bounds it on an H100: at stage 1's conv3 (M = 100352, K = 64,
// N = 256, float32, with a residual) the bytes, 231 MB read or written
// once (0.069 ms at 3.35 TB/s), over 3.3 GFLOP (0.049 ms at 67 TFLOP/s).
//
// Design: a CTA owns a 64 x 64 output tile and runs the SIMT tile product
// of simt_gemm.cuh over all of K (where K is a multiple of 16 its vector
// path, on the tensor cores in bfloat16), then the epilogue from registers;
// any M, K and N (ragged tiles are
// masked), so unlike the TPU kernel there is no block-size rule and no
// shape it refuses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "simt_gemm.cuh"

namespace {

using vct_simt::from_f;
using vct_simt::kStageFloats;
using vct_simt::kThreads;
using vct_simt::to_f;

constexpr int kTile = 64;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    matmul_bias_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const T* __restrict__ b, const T* __restrict__ r, T* __restrict__ out,
                           int M, int K, int N, int relu) {
  __shared__ __align__(16) float stage[kStageFloats];
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  auto a = [=](int row, int k) { return to_f(x[static_cast<size_t>(row) * K + k]); };
  auto a_ptr = [=](int row, int k0) { return x + static_cast<size_t>(row) * K + k0; };
  vct_simt::tile_gemm<kTile, kVec>(a, a_ptr, w, M, N, K, m0, n0, stage,
                                   [=](int row, int col, float v) {
    const size_t o = static_cast<size_t>(row) * N + col;
    v += to_f(b[col]);
    if (r != nullptr) v += to_f(r[o]);
    out[o] = from_f<T>(relu ? fmaxf(v, 0.0f) : v);
  });
}

template <typename T>
int launch(const T* x, const T* w, const T* b, const T* r, T* out, int M, int K, int N, int relu,
           void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kTile - 1) / kTile, (N + kTile - 1) / kTile);
  const bool vec = K % vct_simt::kK == 0 && reinterpret_cast<size_t>(x) % 16 == 0 &&
                   reinterpret_cast<size_t>(w) % 16 == 0;
  auto kernel = vec ? matmul_bias_act_kernel<T, true> : matmul_bias_act_kernel<T, false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, w, b, r, out, M, K, N,
                                                                    relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each returns a cudaError_t: 0 when the launch was accepted. r may be null.
extern "C" int vct_matmul_bias_act_f32(const float* x, const float* w, const float* b,
                                       const float* r, float* out, int M, int K, int N, int relu,
                                       void* stream) {
  return launch<float>(x, w, b, r, out, M, K, N, relu, stream);
}

extern "C" int vct_matmul_bias_act_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                        const __nv_bfloat16* b, const __nv_bfloat16* r,
                                        __nv_bfloat16* out, int M, int K, int N, int relu,
                                        void* stream) {
  return launch<__nv_bfloat16>(x, w, b, r, out, M, K, N, relu, stream);
}
