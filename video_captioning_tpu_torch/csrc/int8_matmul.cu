// int8 1x1 conv (matmul) with a fused requant epilogue:
//   acc = xq . wq^T (int8 x int8 -> int32), xq (M, K), wq (N, K)
//   y = float(acc) * scale[c] + bias[c]  [+ float(idq) * s_id]
//   y = relu(y)   (always after the residual join; optional without one)
//   out = clamp(round_half_even(y / s_out), -127, 127) as int8, or y (float)
// Every float operation is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fdiv_rn, rintf), so nvcc contracts nothing into an FMA and
// the result equals the plain PyTorch version (ops/int8_matmul.py) exactly.
//
// Replaces: video_captioning_tpu/ops/int8_matmul_pallas.py, _mm_kernel
// (int8_matmul_requant) and _mm_res_kernel (int8_matmul_residual_requant):
// the int8 ResNet50's conv1 of every block and conv3 of every block under
// kernels.int8_conv1x1_pallas (resnet_int8.py).
//
// What bounds it on an H100: bytes. At stage 1's conv1 (M = 100352,
// K = 256, N = 64) the int8 operands and output are 32 MB (0.0096 ms at
// 3.35 TB/s) against 3.3 G int8 operations (0.0017 ms at 1979 TOP/s on the
// tensor cores).
//
// Design: a CTA owns a 64 x 64 output tile, 256 threads a 4 x 4 block each,
// accumulated with __dp4a (four int8 products a call) over k-slices of 32
// staged in shared memory as packed quads (k-major, so a thread reads its
// four rows and four columns as one 16-byte load each). The epilogue runs
// on the int32 accumulators in registers: the accumulator never reaches
// device memory. Any M, K, N; where K is a multiple of 4 a quad is one
// 4-byte load, else four byte loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kQuads = 8;  // k-slice of 32
constexpr int kPad = 4;

template <bool kVec>
__device__ __forceinline__ int load_quad(const int8_t* __restrict__ row, int k, int K) {
  if (kVec) return k < K ? __ldg(reinterpret_cast<const int*>(row + k)) : 0;
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t byte = k + i < K ? static_cast<uint8_t>(row[k + i]) : 0u;
    v |= byte << (8 * i);
  }
  return static_cast<int>(v);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       const int8_t* __restrict__ idq, float s_id, float s_out, void* out,
                       int M, int K, int N, int relu, int out_int8) {
  __shared__ __align__(16) int as[kQuads][kTile + kPad];
  __shared__ __align__(16) int bs[kQuads][kTile + kPad];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  int acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += 4 * kQuads) {
    // 64 rows x 8 quads of A and of B: two quads a thread each.
    for (int e = tid; e < kTile * kQuads; e += kThreads) {
      const int r = e / kQuads, q = e % kQuads;
      const int row = m0 + r, col = n0 + r;
      as[q][r] = row < M ? load_quad<kVec>(x + static_cast<size_t>(row) * K, k0 + 4 * q, K) : 0;
      bs[q][r] = col < N ? load_quad<kVec>(w + static_cast<size_t>(col) * K, k0 + 4 * q, K) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int4 a = *reinterpret_cast<const int4*>(&as[q][ty * 4]);
      const int4 b = *reinterpret_cast<const int4*>(&bs[q][tx * 4]);
      const int ar[4] = {a.x, a.y, a.z, a.w};
      const int br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= N) continue;
      const size_t o = static_cast<size_t>(row) * N + col;
      float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), scale[col]), bias[col]);
      if (idq != nullptr) {
        y = __fadd_rn(y, __fmul_rn(__int2float_rn(idq[o]), s_id));
      }
      if (relu) y = fmaxf(y, 0.0f);
      if (out_int8) {
        const float q = fminf(fmaxf(rintf(__fdiv_rn(y, s_out)), -127.0f), 127.0f);
        static_cast<int8_t*>(out)[o] = static_cast<int8_t>(q);
      } else {
        static_cast<float*>(out)[o] = y;
      }
    }
  }
}

}  // namespace

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns a cudaError_t: 0 when the launch was accepted. idq null: no
// residual. out is int8 (M, N) when out_int8, else float (M, N).
extern "C" int vct_int8_matmul_requant(const int8_t* x, const int8_t* w, const float* scale,
                                       const float* bias, const int8_t* idq, float s_id,
                                       float s_out, void* out, int M, int K, int N, int relu,
                                       int out_int8, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kTile - 1) / kTile, (N + kTile - 1) / kTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = K % 4 == 0 && reinterpret_cast<size_t>(x) % 4 == 0 &&
                   reinterpret_cast<size_t>(w) % 4 == 0;
  if (vec) {
    int8_matmul_kernel<true><<<grid, kThreads, 0, st>>>(x, w, scale, bias, idq, s_id, s_out, out,
                                                        M, K, N, relu, out_int8);
  } else {
    int8_matmul_kernel<false><<<grid, kThreads, 0, st>>>(x, w, scale, bias, idq, s_id, s_out,
                                                         out, M, K, N, relu, out_int8);
  }
  return static_cast<int>(cudaGetLastError());
}
