// A block-wide float32 SIMT tile product, the float kernel of conv1x1.cu.
//
// 256 threads compute an RM x RN tile of C = A . B^T (RM in {16, 32, 64},
// RN = 4096 / RM), each thread a 4 x 4 block in registers. A is read
// through a functor a(row, k) -> float (device memory or shared memory,
// zeros outside), B from device memory in torch's (N, K) row-major layout
// with element type T (float or __nv_bfloat16), widened to float. Each
// k-slice of kK columns of A and of B is staged in shared memory
// transposed (k-major), so a thread reads its four rows and four columns
// as one 16-byte load each. Products and sums are float32 FMAs; rows and
// columns past M and N are masked, not padded. tile_product_vec is the
// same product for aligned operands, with vector loads and the next slice
// prefetched into registers; tile_product_mma its bfloat16 form on the
// tensor cores (mma.sync, float32 accumulators).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace vct_simt {

constexpr int kThreads = 256;
constexpr int kK = 16;    // k-slice
constexpr int kPad = 4;   // keeps float4 rows aligned, spreads banks
// Floats of shared staging the largest tile (RM = 16, RN = 256) needs.
constexpr int kStageFloats = kK * (16 + kPad) + kK * (256 + kPad);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// acc = A[m0:m0+RM, :] . B[n0:n0+RN, :]^T over all K. Ends with a barrier,
// so the staging buffers may be refilled by the next call.
template <int RM, typename T, typename ALoad>
__device__ __forceinline__ void tile_product(const ALoad& a, const T* __restrict__ B, int M,
                                             int N, int K, int m0, int n0, float* stage,
                                             float (&acc)[4][4]) {
  constexpr int RN = 4096 / RM;
  constexpr int kAs = RM + kPad, kBs = RN + kPad;
  float* as = stage;            // [kK][kAs]
  float* bs = stage + kK * kAs;  // [kK][kBs]
  const int tid = threadIdx.x;
  const int tx = tid % (RN / 4), ty = tid / (RN / 4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kK) {
    // Consecutive threads take consecutive k of one row: coalesced reads.
    for (int e = tid; e < RM * kK; e += kThreads) {
      const int r = e / kK, k = e % kK;
      const int row = m0 + r, kk = k0 + k;
      as[k * kAs + r] = (row < M && kk < K) ? a(row, kk) : 0.0f;
    }
    for (int e = tid; e < RN * kK; e += kThreads) {
      const int c = e / kK, k = e % kK;
      const int col = n0 + c, kk = k0 + k;
      bs[k * kBs + c] = (col < N && kk < K) ? to_f(B[static_cast<size_t>(col) * K + kk]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(as + k * kAs + ty * 4);
      const float4 bv = *reinterpret_cast<const float4*>(bs + k * kBs + tx * 4);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Four consecutive elements widened to float: 16 bytes of float, 8 of bf16.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// tile_product for K a multiple of kK and rows whose kK-slices are
// contiguous and 4-element aligned: a_ptr(row, k0) points at element
// (row, k0) of A, or is null for a row of zeros. Each slice is one 4-element
// vector load per A quad and per B quad, and the next slice's loads are in
// flight while the current one is multiplied.
template <int RM, typename T, typename APtr>
__device__ __forceinline__ void tile_product_vec(const APtr& a_ptr, const T* __restrict__ B, int M,
                                                 int N, int K, int m0, int n0, float* stage,
                                                 float (&acc)[4][4]) {
  constexpr int RN = 4096 / RM;
  constexpr int kAs = RM + kPad, kBs = RN + kPad;
  constexpr int kBQuads = RN * (kK / 4) / kThreads;  // B quads a thread loads
  float* as = stage;
  float* bs = stage + kK * kAs;
  const int tid = threadIdx.x;
  const int tx = tid % (RN / 4), ty = tid / (RN / 4);
  const int ar = tid / 4, aq = tid % 4;  // the A quad of thread tid < 4 RM
  const bool a_loader = tid < 4 * RM;
  const bool a_live = a_loader && m0 + ar < M;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 va = zero, vb[kBQuads];
  auto fetch = [&](int k0) {
    if (a_live) {
      const auto* p = a_ptr(m0 + ar, k0);
      va = p != nullptr ? load4(p + 4 * aq) : zero;
    }
#pragma unroll
    for (int j = 0; j < kBQuads; ++j) {
      const int e = tid + j * kThreads;
      const int col = n0 + e / 4;
      vb[j] = col < N ? load4(B + static_cast<size_t>(col) * K + k0 + 4 * (e % 4)) : zero;
    }
  };
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kK) {
    if (a_loader) {
      as[(4 * aq + 0) * kAs + ar] = va.x;
      as[(4 * aq + 1) * kAs + ar] = va.y;
      as[(4 * aq + 2) * kAs + ar] = va.z;
      as[(4 * aq + 3) * kAs + ar] = va.w;
    }
#pragma unroll
    for (int j = 0; j < kBQuads; ++j) {
      const int e = tid + j * kThreads, c = e / 4, q = e % 4;
      bs[(4 * q + 0) * kBs + c] = vb[j].x;
      bs[(4 * q + 1) * kBs + c] = vb[j].y;
      bs[(4 * q + 2) * kBs + c] = vb[j].z;
      bs[(4 * q + 3) * kBs + c] = vb[j].w;
    }
    __syncthreads();
    if (k0 + kK < K) fetch(k0 + kK);
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(as + k * kAs + ty * 4);
      const float4 bv = *reinterpret_cast<const float4*>(bs + k * kBs + tx * 4);
      const float ar4[4] = {av.x, av.y, av.z, av.w};
      const float br4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar4[i], br4[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// bfloat16 operands on the tensor cores: d += a . b for one m16n8k16 tile,
// float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// tile_product_vec for bfloat16 A and B on the tensor cores: the 8 warps
// each own 16 rows x 32 columns of the tile (four m16n8 tiles, acc[n8][4]).
// A k-slice is staged as bf16 rows of 16 k (A row-major, B as (N, K) rows,
// both k-contiguous, which is the layout mma's "row.col" fragments read as
// 32-bit pairs), padded to 24 so the fragment reads hit distinct banks.
template <int RM, typename APtr>
__device__ __forceinline__ void tile_product_mma(const APtr& a_ptr,
                                                 const __nv_bfloat16* __restrict__ B, int M,
                                                 int N, int K, int m0, int n0, float* stage,
                                                 float (&acc)[4][4]) {
  constexpr int RN = 4096 / RM;
  constexpr int kS = kK + 8;  // bf16 row stride of a staged slice
  static_assert((RM + RN) * kS * 2 <= kStageFloats * 4, "staging overflows");
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(stage);  // [RM][kS]
  __nv_bfloat16* bs = as + RM * kS;                               // [RN][kS]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tq = lane % 4;  // mma fragment coordinates
  const int wm = warp / (RN / 32), wn = warp % (RN / 32);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // Staging: 8 bf16 (16 bytes) a load, two per row of a slice.
  uint4 va = zero, vb[(2 * RN + kThreads - 1) / kThreads];
  auto fetch = [&](int k0) {
    if (tid < 2 * RM) {
      const int row = m0 + tid / 2;
      const __nv_bfloat16* p = row < M ? a_ptr(row, k0) : nullptr;
      va = p != nullptr ? *reinterpret_cast<const uint4*>(p + 8 * (tid % 2)) : zero;
    }
#pragma unroll
    for (int i = 0; i * kThreads < 2 * RN; ++i) {
      const int j = tid + i * kThreads, col = n0 + j / 2;
      vb[i] = j < 2 * RN && col < N
                  ? *reinterpret_cast<const uint4*>(B + static_cast<size_t>(col) * K + k0 +
                                                    8 * (j % 2))
                  : zero;
    }
  };
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kK) {
    if (tid < 2 * RM) *reinterpret_cast<uint4*>(as + (tid / 2) * kS + 8 * (tid % 2)) = va;
#pragma unroll
    for (int i = 0; i * kThreads < 2 * RN; ++i) {
      const int j = tid + i * kThreads;
      if (j < 2 * RN) *reinterpret_cast<uint4*>(bs + (j / 2) * kS + 8 * (j % 2)) = vb[i];
    }
    __syncthreads();
    if (k0 + kK < K) fetch(k0 + kK);
    const __nv_bfloat16* ar = as + (wm * 16 + g) * kS + 2 * tq;
    const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(ar),
                           *reinterpret_cast<const uint32_t*>(ar + 8 * kS),
                           *reinterpret_cast<const uint32_t*>(ar + 8),
                           *reinterpret_cast<const uint32_t*>(ar + 8 * kS + 8)};
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const __nv_bfloat16* br = bs + (wn * 32 + ni * 8 + g) * kS + 2 * tq;
      mma_bf16(acc[ni], a, *reinterpret_cast<const uint32_t*>(br),
               *reinterpret_cast<const uint32_t*>(br + 8));
    }
    __syncthreads();
  }
}

// epi(row, col, value) for each of this thread's tile_product_mma outputs
// inside M x N: accumulator q of n8 tile ni holds row g + 8 (q / 2), column
// 2 tq + q % 2 of that tile.
template <int RM, typename Epi>
__device__ __forceinline__ void for_each_output_mma(const float (&acc)[4][4], int M, int N,
                                                    int m0, int n0, const Epi& epi) {
  constexpr int RN = 4096 / RM;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;
  const int wm = warp / (RN / 32), wn = warp % (RN / 32);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = m0 + wm * 16 + g + (q / 2) * 8;
      const int col = n0 + wn * 32 + ni * 8 + 2 * tq + q % 2;
      if (row < M && col < N) epi(row, col, acc[ni][q]);
    }
  }
}

// epi(row, col, value) for each of this thread's outputs inside M x N.
template <int RM, typename Epi>
__device__ __forceinline__ void for_each_output(const float (&acc)[4][4], int M, int N, int m0,
                                                int n0, const Epi& epi) {
  constexpr int RN = 4096 / RM;
  const int tx = threadIdx.x % (RN / 4), ty = threadIdx.x / (RN / 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) epi(row, col, acc[i][j]);
    }
  }
}

// One RM x RN output tile through the product the operands allow: with
// kVec, A comes through a_ptr (K a multiple of kK, aligned rows) and runs on
// the tensor cores in bfloat16 or the vector SIMT path in float32; else
// element by element through a.
template <int RM, bool kVec, typename T, typename ALoad, typename APtr, typename Epi>
__device__ __forceinline__ void tile_gemm(const ALoad& a, const APtr& a_ptr,
                                          const T* __restrict__ B, int M, int N, int K, int m0,
                                          int n0, float* stage, const Epi& epi) {
  float acc[4][4];
  if constexpr (kVec && std::is_same<T, __nv_bfloat16>::value) {
    tile_product_mma<RM>(a_ptr, B, M, N, K, m0, n0, stage, acc);
    for_each_output_mma<RM>(acc, M, N, m0, n0, epi);
  } else {
    if constexpr (kVec) {
      tile_product_vec<RM>(a_ptr, B, M, N, K, m0, n0, stage, acc);
    } else {
      tile_product<RM>(a, B, M, N, K, m0, n0, stage, acc);
    }
    for_each_output<RM>(acc, M, N, m0, n0, epi);
  }
}

}  // namespace vct_simt
