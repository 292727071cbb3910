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
// What bounds it on an H100: bytes, at every shape of a ResNet50 forward
// but the last stage's. Stage 1 (M = 100352) moves 13-109 MB a launch
// (0.004-0.033 ms at 3.35 TB/s) for 0.8-6.6 G int8 operations (under
// 0.004 ms at 1979 TOP/s), and the largest of them is a store: 103 MB of
// float32 out of the downsample conv3. Stage 4's conv1 (1568, 2048, 512)
// sits near the ridge, about 650 operations a byte against the card's 590.
// Next come the epilogue's instructions, about 20 an output (25.7 M
// outputs a stage-1 conv3). At stages 2-4 the time on an H100 follows
// neither the tile side (64 x 64, 128 x 64 and 128 x 128 tiles, so L2
// re-reads from 1/32 to 1/64 of M N K, time the same within 5%) nor the
// ldmatrix reads per product (warps owning 64 x 32 are no faster): it
// follows the K stages each CTA walks, a cause not pinned down yet.
//
// Design: products on the int8 tensor cores, mma.sync m16n8k32 s8 x s8 ->
// s32, both operands K-major as they lie (xq rows, wq rows); an int8 row of
// 16 bytes is one b16 row of ldmatrix, so one ldmatrix.x4 gives a whole
// 16 x 32 A fragment, or the B fragments of two n8 tiles. CTAs are
// persistent (as many as stay resident), each walking its output tiles
// (a warp owns 32 x 32; the launcher picks the tile, below) with
// one ring of K stages (four of 64 bytes, or three of 128 bytes from
// K = 256) that runs on across tile boundaries: the next tiles' operands,
// idq tiles and scale / bias columns arrive with 16-byte cp.async while
// this tile's epilogue runs. Rows in shared memory are padded by 16 bytes
// so that ldmatrix's eight rows fall in distinct banks. The epilogue runs
// on the int32 accumulators in registers (the accumulator never reaches
// device memory), and each warp stages its piece in shared memory and
// writes it 16 bytes a lane, a row's chunks on neighbouring lanes. No split
// K: the requant needs the whole sum. Any M and N (masked); K a multiple of
// 16 and xq, wq 16-byte aligned (the wrapper zero-pads K otherwise, which
// adds nothing to the sums).
//
// The requant divides only where it can matter: __fdiv_rn on every output
// costs each its own reciprocal, range check and slow-path branch, and on
// an H100 the 32 launches of a forward take about 1.2 ms that way against
// about 0.77 ms this way (a build with -DVCT_INT8_DIVIDE_ALL=1 divides
// every output; chip_smoke.py times both).
// t = y * r, r = 1 / s_out rounded, lies within 0.75 |t| 2^-22 of the
// quotient q = RN(y / s_out) (two roundings of 2^-24 and r's own). So where
// t sits more than w = |t| 2^-21 inside its rounding interval,
// |t - rint(t)| < 0.5 - w, q rounds to the same integer; where |t| > 200,
// both clamp to the same +-127. Only the few outputs near a half-integer
// (and NaN, and every one where 1 / s_out is not a normal float) take
// __fdiv_rn, in a second pass that only the threads holding one run: every
// output equals the divide's, and the usual path has no branch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kIdqPad = 16;  // int8 tile rows: BN + 16 bytes

struct Epilogue {
  const float* scale;
  const float* bias;
  const int8_t* idq;  // null: no residual
  float s_id;
  float s_out;
  void* out;
  int relu;
  int out_int8;
  int idq_vec;  // idq rows 16-byte aligned: cp.async, else byte loads
  int col_vec;  // scale and bias 16-byte aligned, N % 4 == 0: cp.async
  int out_vec;  // out rows 16-byte aligned: 16-byte stores, else narrower
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, through L2 only; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in_range) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in_range ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16 x 32 s8, row) . b (32 x 8 s8, col), s32 sums. Registers only,
// so not volatile: the compiler may interleave it with the next ldmatrix.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Built with -DVCT_INT8_DIVIDE_ALL=1, every output takes the divide: the
// variant that chip_smoke.py times against this one.
#ifndef VCT_INT8_DIVIDE_ALL
#define VCT_INT8_DIVIDE_ALL 0
#endif

// rint(y * r), r = RN(1 / s_out), and whether it provably equals
// rint(RN(y / s_out)) before the clamp (see the note at the top). Past 200
// both clamp to the same +-127. The window test rounds once, and as 0.5 is
// a float, a rounded sum under 0.5 means the exact sum is under it too.
__device__ __forceinline__ float requant_fast(float y, float r, float s_out, int& exact) {
  if (VCT_INT8_DIVIDE_ALL) {
    exact = 1;
    return rintf(__fdiv_rn(y, s_out));
  }
  const float t = __fmul_rn(y, r);
  const float k = rintf(t);
  const float at = fabsf(t);
  exact = (at > 200.0f) | (__fmaf_rn(at, 0x1p-21f, fabsf(__fsub_rn(t, k))) < 0.5f);
  return k;
}

__device__ __noinline__ float requant_divide(float y, float s_out) {
  return rintf(__fdiv_rn(y, s_out));
}

// An integer-valued float, clamped to +-127, as int8 bits in the low byte:
// adding 1.5 * 2^23 puts a small integer in the low bits of the
// significand (one add in place of a float-to-int conversion).
__device__ __forceinline__ uint32_t int8_bits(float k) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(k, -127.0f), 127.0f), 12582912.0f));
}

// Shared memory of one CTA: a ring of K stages (BM rows of xq and BN rows
// of wq, BK bytes each; rows padded by 16 bytes so that ldmatrix's eight
// 16-byte rows fall in distinct banks), the output staging (int8 or
// float32), a ring of idq tiles and a ring of the tiles' scale and bias
// columns.
template <int BM, int BN, int BK>
struct Layout {
  static constexpr int kStages = BK == 64 ? 4 : 3;
  static constexpr int kStride = BK + 16;
  static constexpr int kStage = (BM + BN) * kStride;
  static constexpr int kIdq = BM * (BN + kIdqPad);
  static constexpr int kCols = 2 * BN * 4;      // scale then bias
  static constexpr int kF32 = BM * (BN + 8) * 4;  // float32 staging: float2 stores conflict-free
  // Tiles in flight: tile j's idq and columns arrive (kStages - 1) K stages
  // ahead of its first product and are read by its epilogue, ktiles
  // stages later.
  __host__ __device__ static constexpr int tile_slots(int ktiles) {
    return 1 + (kStages - 2 + ktiles) / ktiles;
  }
  __host__ __device__ static constexpr int bytes(int ktiles, bool out_int8, bool residual) {
    return kStages * kStage + (out_int8 ? kIdq : kF32) +
           tile_slots(ktiles) * ((residual ? kIdq : 0) + kCols);
  }
};

// A CTA's walk, one K stage a step, over tiles blockIdx.x, blockIdx.x +
// gridDim.x, ...; tiles n-fastest, so neighbouring CTAs share xq rows in L2.
template <int BM, int BN>
struct Cursor {
  int kt, tile, m0, n0, tile_slot;
  __device__ __forceinline__ void at(int t, int ntiles) {
    tile = t;
    m0 = t / ntiles * BM;
    n0 = t % ntiles * BN;
  }
  __device__ __forceinline__ void next(int ktiles, int ntiles, int tile_slots) {
    if (++kt < ktiles) return;
    kt = 0;
    at(tile + gridDim.x, ntiles);
    if (++tile_slot == tile_slots) tile_slot = 0;
  }
};

template <int BM, int BN, int WARPS_M, int WARPS_N, int BK, bool kResidual, bool kOutInt8>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
    int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, Epilogue p,
                       int M, int K, int N) {
  using L = Layout<BM, BN, BK>;
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  constexpr int kStages = L::kStages, kStride = L::kStride;
  constexpr int TM = BM / WARPS_M, TN = BN / WARPS_N;  // a warp's piece
  constexpr int MI = TM / 16, NI = TN / 8;
  constexpr int kRow = BN + kIdqPad;
  // The loader: a thread copies one 16-byte column of rows r0, r0 + kStep,
  // ... of xq and of wq, and one of rows i0, i0 + kIdqStep, ... of idq.
  constexpr int kChunks = BK / 16, kStep = kThreads / kChunks;
  constexpr int kIdqChunks = BN / 16, kIdqStep = kThreads / kIdqChunks;
  static_assert(MI >= 1 && NI % 2 == 0, "warp piece: 16-row and 16-column multiples");
  static_assert(kThreads % kChunks == 0 && BM % kStep == 0 && BN % kStep == 0,
                "whole loader passes over xq and wq rows");
  static_assert(kThreads % kIdqChunks == 0 && BM % kIdqStep == 0, "whole passes over idq rows");

  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t4 = lane & 3;
  const int ntiles = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * ntiles;
  const int ktiles = (K + BK - 1) / BK;
  const int iters = ((tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1) * ktiles;
  const int tile_slots = L::tile_slots(ktiles);
  int8_t* stage = reinterpret_cast<int8_t*>(smem + kStages * L::kStage);  // output staging
  int8_t* idq_ring = stage + (kOutInt8 ? L::kIdq : L::kF32);
  float* col_ring = reinterpret_cast<float*>(idq_ring + (kResidual ? tile_slots * L::kIdq : 0));
  // 1 / s_out, or NaN (every output then divides) where it is not a
  // normal float and the error bound at the top does not hold.
  const float r_rcp = __frcp_rn(p.s_out);
  const float r_out = fabsf(r_rcp) >= 1.17549435e-38f && fabsf(r_rcp) <= 3.40282347e38f
                          ? r_rcp
                          : __int_as_float(0x7fffffff);

  const int r0 = tid / kChunks, c0 = tid % kChunks * 16;
  const int i0 = tid / kIdqChunks, ic0 = tid % kIdqChunks * 16;
  Cursor<BM, BN> ld{0, 0, 0, 0, 0};
  ld.at(blockIdx.x, ntiles);
  const Cursor<BM, BN> first = ld;
  // The K stage under the load cursor into ring slot `slot`, and its tile's
  // idq with its first stage.
  auto load = [&](int slot) {
    uint8_t* as = smem + slot * L::kStage + r0 * kStride + c0;
    const int k = ld.kt * BK + c0;
    const bool k_ok = k < K;
    const int8_t* xa = x + static_cast<size_t>(ld.m0 + r0) * K + k;
#pragma unroll
    for (int j = 0; j < BM / kStep; ++j) {
      const bool ok = k_ok && ld.m0 + r0 + j * kStep < M;
      cp_async16(as + j * kStep * kStride, ok ? xa + static_cast<size_t>(j * kStep) * K : x, ok);
    }
    const int8_t* wb = w + static_cast<size_t>(ld.n0 + r0) * K + k;
#pragma unroll
    for (int j = 0; j < BN / kStep; ++j) {
      const bool ok = k_ok && ld.n0 + r0 + j * kStep < N;
      cp_async16(as + (BM + j * kStep) * kStride,
                 ok ? wb + static_cast<size_t>(j * kStep) * K : w, ok);
    }
    if (ld.kt == 0 && tid < BN / 2) {
      // Thread t < BN / 4: scale[n0 + 4 t ...], then bias likewise.
      const int c = tid % (BN / 4) * 4, col = ld.n0 + c;
      const float* src = (tid < BN / 4 ? p.scale : p.bias) + col;
      float* d = col_ring + ld.tile_slot * 2 * BN + (tid < BN / 4 ? 0 : BN) + c;
      if (p.col_vec) {
        cp_async16(d, col < N ? src : p.scale, col < N);
      } else {
        for (int i = 0; i < 4; ++i) d[i] = col + i < N ? src[i] : 0.0f;
      }
    }
    if (kResidual && ld.kt == 0) {
      int8_t* dst = idq_ring + ld.tile_slot * L::kIdq + i0 * kRow + ic0;
      const int col = ld.n0 + ic0;
      const int8_t* src = p.idq + static_cast<size_t>(ld.m0 + i0) * N + col;
#pragma unroll
      for (int j = 0; j < BM / kIdqStep; ++j) {
        const int row = ld.m0 + i0 + j * kIdqStep;
        int8_t* d = dst + j * kIdqStep * kRow;
        const int8_t* s = src + static_cast<size_t>(j * kIdqStep) * N;
        if (p.idq_vec) {
          const bool ok = row < M && col < N;
          cp_async16(d, ok ? s : p.idq, ok);
        } else {
          for (int i = 0; i < 16; ++i) d[i] = row < M && col + i < N ? s[i] : 0;
        }
      }
    }
  };

  int acc[MI][NI][4];
  // ldmatrix row addresses: A lanes 0-15 rows 0-15 at bytes 0-15, lanes
  // 16-31 the same rows at bytes 16-31 (a0..a3); B lanes 0-7 / 16-23 the
  // first / second n8 tile at bytes 0-15, lanes 8-15 / 24-31 at 16-31.
  const int a_off = (wm * TM + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 16;
  const int b_off =
      (BM + wn * TN + (lane & 7) + (lane >> 4) * 8) * kStride + ((lane >> 3) & 1) * 16;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < iters) {
      load(s);
      ld.next(ktiles, ntiles, tile_slots);
    }
    cp_async_commit();
  }
  Cursor<BM, BN> cc = first;  // the stage being multiplied
  int slot_ld = kStages - 1, slot = 0;
  for (int it = 0; it < iters; ++it) {
    if (cc.kt == 0) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;
    }
    cp_async_wait<kStages - 2>();  // stage `it` has landed
    __syncthreads();               // and every warp is done with stage it - 1
    if (it + kStages - 1 < iters) {
      load(slot_ld);
      ld.next(ktiles, ntiles, tile_slots);
    }
    cp_async_commit();
    slot_ld = slot_ld + 1 == kStages ? 0 : slot_ld + 1;
    const uint8_t* as = smem + slot * L::kStage;
    slot = slot + 1 == kStages ? 0 : slot + 1;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      if (cc.kt * BK + ks >= K) break;  // a k32 step of zero fill only
      uint32_t a[MI][4], b[NI / 2][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) ldmatrix_x4(a[mi], as + a_off + mi * 16 * kStride + ks);
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) ldmatrix_x4(b[np], as + b_off + np * 16 * kStride + ks);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_s8(acc[mi][ni], a[mi], b[ni / 2][(ni & 1) * 2], b[ni / 2][(ni & 1) * 2 + 1]);
    }
    if (cc.kt == ktiles - 1) {
      // The tile's epilogue. Accumulator (mi, ni, j): row g (+ 8 for
      // j >= 2), columns 2 t4 and 2 t4 + 1 of the warp's piece.
      const int m0 = cc.m0, n0 = cc.n0;
      const int8_t* ids = idq_ring + cc.tile_slot * L::kIdq;
      const float* cols = col_ring + cc.tile_slot * 2 * BN;
      float scv[NI][2], biv[NI][2];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          scv[ni][j] = cols[wn * TN + ni * 8 + t4 * 2 + j];
          biv[ni][j] = cols[BN + wn * TN + ni * 8 + t4 * 2 + j];
        }
      auto value = [&](int mi, int ni, int h, int j) {
        float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][h * 2 + j]), scv[ni][j]),
                            biv[ni][j]);
        if (kResidual) {
          const int lr = wm * TM + mi * 16 + g + h * 8, lc = wn * TN + ni * 8 + t4 * 2 + j;
          v = __fadd_rn(v, __fmul_rn(__int2float_rn(ids[lr * kRow + lc]), p.s_id));
        }
        return p.relu ? fmaxf(v, 0.0f) : v;
      };
      // Bit (mi NI + ni) 4 + 2 h + j: that output needs the divide.
      static_assert(MI * NI * 4 <= 32, "a bit for each of the thread's outputs");
      uint32_t inexact = 0;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int lr = wm * TM + mi * 16 + g + h * 8;
            const int lc = wn * TN + ni * 8 + t4 * 2;
            const float y0 = value(mi, ni, h, 0), y1 = value(mi, ni, h, 1);
            if (kOutInt8) {
              int e0, e1;
              const uint32_t q0 = int8_bits(requant_fast(y0, r_out, p.s_out, e0));
              const uint32_t q1 = int8_bits(requant_fast(y1, r_out, p.s_out, e1));
              const int bit = (mi * NI + ni) * 4 + h * 2;
              inexact |= static_cast<uint32_t>(!e0) << bit;
              inexact |= static_cast<uint32_t>(!e1) << (bit + 1);
              *reinterpret_cast<uint16_t*>(stage + lr * kRow + lc) =
                  static_cast<uint16_t>(__byte_perm(q0, q1, 0x0040));
            } else {
              *reinterpret_cast<float2*>(reinterpret_cast<float*>(stage) + lr * (BN + 8) + lc) =
                  make_float2(y0, y1);
            }
          }
        }
      }
      if (!kOutInt8) {
        // The warp's staged piece to device memory, 16 bytes a lane, eight
        // lanes to a row's 128 contiguous bytes.
        __syncwarp();
        constexpr int kLanesRow = TN / 4, kRowsPass = 32 / kLanesRow;
#pragma unroll
        for (int j = 0; j < TM / kRowsPass; ++j) {
          const int r = wm * TM + j * kRowsPass + lane / kLanesRow;
          const int c = wn * TN + lane % kLanesRow * 4, row = m0 + r, col = n0 + c;
          if (row >= M || col >= N) continue;
          const float* src = reinterpret_cast<const float*>(stage) + r * (BN + 8) + c;
          float* dst = static_cast<float*>(p.out) + static_cast<size_t>(row) * N + col;
          if (p.out_vec && col + 4 <= N) {
            *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
          } else {
            for (int i = 0; i < 4 && col + i < N; ++i) dst[i] = src[i];
          }
        }
      }
      if (kOutInt8) {
        if (inexact != 0) {
          // Some output sat near a rounding tie: those take the divide.
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < NI; ++ni)
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                  if (inexact >> ((mi * NI + ni) * 4 + h * 2 + j) & 1) {
                    const float y = value(mi, ni, h, j);
                    stage[(wm * TM + mi * 16 + g + h * 8) * kRow + wn * TN + ni * 8 + t4 * 2 + j] =
                        static_cast<int8_t>(int8_bits(requant_divide(y, p.s_out)));
                  }
                }
        }
        // The warp's staged piece to device memory, 16 bytes a lane, a
        // row's chunks on neighbouring lanes; ragged or unaligned chunks
        // byte by byte. The next epilogue writes the staging only after the
        // next iteration's barrier.
        __syncwarp();
        constexpr int kLanesRow = TN / 16, kRowsPass = 32 / kLanesRow;
#pragma unroll
        for (int j = 0; j < TM / kRowsPass; ++j) {
          const int r = wm * TM + j * kRowsPass + lane / kLanesRow;
          const int c = wn * TN + lane % kLanesRow * 16, row = m0 + r, col = n0 + c;
          if (row >= M || col >= N) continue;
          const int8_t* src = stage + r * kRow + c;
          int8_t* dst = static_cast<int8_t*>(p.out) + static_cast<size_t>(row) * N + col;
          if (p.out_vec && col + 16 <= N) {
            *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
          } else {
            for (int i = 0; i < 16 && col + i < N; ++i) dst[i] = src[i];
          }
        }
      }
    }
    cc.next(ktiles, ntiles, tile_slots);
  }
  cp_async_wait<0>();  // no copy outlives the CTA
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int BK, bool kResidual, bool kOutInt8>
cudaError_t launch_mode(const int8_t* x, const int8_t* w, const Epilogue& p, int M, int K, int N,
                        int sms, cudaStream_t st) {
  auto kernel = int8_matmul_kernel<BM, BN, WARPS_M, WARPS_N, BK, kResidual, kOutInt8>;
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  using L = Layout<BM, BN, BK>;
  // The most any K can ask, then as many CTAs as stay resident.
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       L::bytes(1, kOutInt8, kResidual));
  if (e != cudaSuccess) return e;
  const int smem = L::bytes((K + BK - 1) / BK, kOutInt8, kResidual);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long slots = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  kernel<<<grid, kThreads, smem, st>>>(x, w, p, M, K, N);
  return cudaGetLastError();
}

// One tile shape: 128-byte K stages (three) from K = 256, else 64-byte
// ones (four).
template <int BM, int BN, int WARPS_M, int WARPS_N>
cudaError_t launch(const int8_t* x, const int8_t* w, const Epilogue& p, int M, int K, int N,
                   int sms, cudaStream_t st) {
  auto mode = [&](auto bk, auto residual, auto out_int8) {
    return launch_mode<BM, BN, WARPS_M, WARPS_N, decltype(bk)::value, decltype(residual)::value,
                       decltype(out_int8)::value>(x, w, p, M, K, N, sms, st);
  };
  auto modes = [&](auto bk) {
    using T = std::true_type;
    using F = std::false_type;
    if (p.idq != nullptr) return p.out_int8 ? mode(bk, T{}, T{}) : mode(bk, T{}, F{});
    return p.out_int8 ? mode(bk, F{}, T{}) : mode(bk, F{}, F{});
  };
  return K >= 256 ? modes(std::integral_constant<int, 128>{})
                  : modes(std::integral_constant<int, 64>{});
}

long long tiles(int M, int N, int bm, int bn) {
  return static_cast<long long>((M + bm - 1) / bm) * ((N + bn - 1) / bn);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns a cudaError_t: 0 when the launch was accepted. idq null: no
// residual. out is int8 (M, N) when out_int8, else float (M, N). K must be
// a multiple of 16 and x, w 16-byte aligned (the wrapper pads). tile: -1
// the launcher's choice; 0 (64 x 64) or 1 (128 x 64) forces one, to time
// them against each other.
extern "C" int vct_int8_matmul_requant(const int8_t* x, const int8_t* w, const float* scale,
                                       const float* bias, const int8_t* idq, float s_id,
                                       float s_out, void* out, int M, int K, int N, int relu,
                                       int out_int8, int tile, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || !aligned16(x) || !aligned16(w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const Epilogue p{scale,
                   bias,
                   idq,
                   s_id,
                   s_out,
                   out,
                   relu,
                   out_int8,
                   idq != nullptr && N % 16 == 0 && aligned16(idq),
                   N % 4 == 0 && aligned16(scale) && aligned16(bias),
                   (out_int8 ? N % 16 : N % 4) == 0 && aligned16(out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile < 0) {
    // 128 x 64 where it gives every SM a tile, else 64 x 64.
    tile = tiles(M, N, 128, 64) >= sms ? 1 : 0;
  }
  switch (tile) {
    case 0:
      rc = launch<64, 64, 2, 2>(x, w, p, M, K, N, sms, st);
      break;
    case 1:
      rc = launch<128, 64, 4, 2>(x, w, p, M, K, N, sms, st);
      break;
    default:
      rc = cudaErrorInvalidValue;
  }
  return static_cast<int>(rc);
}
