// Warp-level tensor-core tile products shared by the float32 kernels of the
// port (lstm_cell.cu, fused_bottleneck.cu), with their operand staging.
//
// float32 products on the tensor cores by a 3xTF32 split: each operand
// value a becomes hi = cvt.rna.tf32(a) and lo = cvt.rna.tf32(a - hi), and
// each product is taken as lo.hi + hi.lo + hi.hi on
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 (float32 accumulators). The
// dropped lo.lo term and the rounding of lo leave each product within about
// 2^-21 of the float32 product (an FMA: 2^-24). The split happens in
// registers after the fragment load (ldmatrix), by the rounding's integer
// form: nothing is precomputed and no weight copy is kept. bfloat16 operands take one mma.sync.m16n8k16 (float32
// accumulators) per fragment pair instead.
//
// Staged layout: an operand tile is rows of kTileWords 32-bit words (32
// floats or 64 bf16 of the reduction axis, k contiguous), kStride words
// apart. A is (M, K) row-major and B is torch's (N, K) row-major weight,
// which is the "col" layout mma wants, so no weight is transposed. Both
// tensor-core shapes read their fragments at the same word offsets (rows
// g and g + 8, words t and t + 4 of each 8-word k-step, g = lane / 4,
// t = lane % 4); with kStride = 36 the 32 lanes hit 32 distinct banks.
// Tiles arrive by cp.async (16 bytes, zero-filled past the operand's end)
// into a ring of stages.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace vct_tc {

constexpr int kTileWords = 32;  // words of the reduction axis a staged tile holds
constexpr int kStride = 36;     // staged row stride in words: conflict-free fragments

// Elements of T in one staged k-tile and in one 16-byte chunk.
template <typename T>
__host__ __device__ constexpr int tile_k() { return kTileWords * 4 / static_cast<int>(sizeof(T)); }
template <typename T>
__host__ __device__ constexpr int chunk_k() { return 16 / static_cast<int>(sizeof(T)); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zeros when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// The shared::cluster address of p (this CTA's shared memory) in the shared
// memory of cluster CTA rank.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v rounded to TF32 (10 stored mantissa bits) to nearest, ties away from
// zero: cvt.rna.tf32.f32's rounding on the bit pattern, in two integer
// instructions where the conversion takes a slower pipe.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) {
  return (bits + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo to about 2^-22 relative, hi and lo both TF32 values.
__device__ __forceinline__ void split_tf32(uint32_t bits, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(bits);
  lo = tf32_rna(__float_as_uint(__uint_as_float(bits) - __uint_as_float(hi)));
}

// Four 8 x 4-word matrices from shared memory; lane l gives the row address
// of matrix l / 8 (ldmatrix's b16 view: 8 rows of 16 bytes).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint32_t* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mi][ni] += A[16 mi .., :] . B[8 ni .., :]^T over one k-tile of 32
// words. a_row[mi] is this lane's ldmatrix row for m16 tile mi: its row
// (lane % 16) at word 4 (lane / 16) of the k-tile, anywhere in shared
// memory, so A's rows may be gathered; B points at the warp's first row of
// a staged operand. Four 8-word k-steps: in float32 each is k8 with the
// three split products (small terms first), in bfloat16 one k16 product.
// The tensor cores' float32 accumulation truncates where it aligns
// addends, so over a long reduction the error would grow with the count of
// products a sum has seen; in float32 the k-tile's products go into a fresh
// partial, added to acc with rounded float32 adds, so each truncation is
// relative to one k-tile's partial sum.
template <typename T, int MT, int NT>
__device__ __forceinline__ void warp_mma_rows(float (&acc)[MT][NT][4],
                                              const uint32_t* const (&a_row)[MT],
                                              const uint32_t* __restrict__ B) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
  const int lane = threadIdx.x % 32;
  float part[MT][NT][4];
  if constexpr (kF32) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[mi][ni][q] = 0.0f;
  }
  // B's four matrices are (words 0-3 | 4-7) x (n8 tile 2j | 2j + 1).
  const uint32_t* b_row = B + ((lane / 16) * 8 + lane % 8) * kStride + 4 * ((lane / 8) % 2);
#pragma unroll
  for (int ks = 0; ks < kTileWords / 8; ++ks) {
    uint32_t a[MT][4], b[NT][2];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) ldmatrix_x4(a[mi], a_row[mi] + ks * 8);
#pragma unroll
    for (int nj = 0; nj < NT / 2; ++nj) {
      uint32_t r[4];
      ldmatrix_x4(r, b_row + nj * 16 * kStride + ks * 8);
      b[2 * nj][0] = r[0];
      b[2 * nj][1] = r[1];
      b[2 * nj + 1][0] = r[2];
      b[2 * nj + 1][1] = r[3];
    }
    if constexpr (kF32) {
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(a[mi][q], ah[mi][q], al[mi][q]);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int q = 0; q < 2; ++q) split_tf32(b[ni][q], bh[ni][q], bl[ni][q]);
      // Term by term, so an accumulator's three products stand MT NT
      // instructions apart in the tensor pipe.
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_tf32(part[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_tf32(part[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_tf32(part[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
    } else {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  if constexpr (kF32) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] += part[mi][ni][q];
  }
}

// warp_mma_rows over staged operands: A and B point at the warp's first row
// of each (rows kStride words apart).
template <typename T, int MT, int NT>
__device__ __forceinline__ void warp_mma_ktile(float (&acc)[MT][NT][4],
                                               const uint32_t* __restrict__ A,
                                               const uint32_t* __restrict__ B) {
  const int lane = threadIdx.x % 32;
  const uint32_t* a_row[MT];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    a_row[mi] = A + (mi * 16 + lane % 16) * kStride + 4 * (lane / 16);
  }
  warp_mma_rows<T, MT, NT>(acc, a_row, B);
}

// The (row, col) inside the warp tile of accumulator q of fragment (mi, ni).
__device__ __forceinline__ int frag_row(int mi, int q) {
  return mi * 16 + (threadIdx.x % 32) / 4 + 8 * (q / 2);
}
__device__ __forceinline__ int frag_col(int ni, int q) {
  return ni * 8 + 2 * (threadIdx.x % 4) + q % 2;
}

}  // namespace vct_tc
