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
// but two of the last stage's (operations there, near the ridge). The
// earlier design (mma.sync fed by a 3-deep cp.async ring, one CTA an SM)
// ran at 0.29 of the bound over a forward's 32 launches, and a probe of it
// (probe_int8.py) named two limits. Stages 2-4: the serial K walk of each
// CTA, 0.8-7 us a 128-byte K stage with cold operands costing nothing and
// a quarter of M keeping most of the time: too few bytes in flight a CTA.
// Stage 1 (K = 64-256, M = 100352): the epilogue's instructions, about 25
// an output, in CTAs that also wait on their products.
//
// Design: one producer warp and one or two consumer warpgroups a CTA.
// Products by wgmma m64n64k32 s8 x s8 -> s32 with both operands in shared
// memory, K-major as they lie (xq rows, wq rows), in 64-byte rows, 64-byte
// swizzled, fed by the TMA (cp.async.bulk.tensor.2d) through a ring of up
// to 16 stages of 64 bytes of K on full / empty mbarriers: the producer
// keeps every slot in flight. CTAs are persistent and walk the output
// tiles (n fastest, so neighbours share xq rows in L2); the ring runs on
// across tiles, so a tile's epilogue overlaps the next tiles' loads, and
// two to four CTAs share an SM, so one's epilogue overlaps another's
// products. The residual tile (idq) arrives by the TMA up to four tiles
// ahead of its epilogue. The epilogue runs on the accumulators in
// registers with no branch an output (the fast form, whole column tiles
// with aligned rows; lane loads and stores with bounds checks otherwise),
// stages each warp's 16 rows in its own shared memory and stores them 16
// bytes a lane, with no barrier beyond the warp. Each CTA walks a tile's
// whole K: on an H100 a split of K over a thread block cluster (int32
// partials added in rank order through distributed shared memory, exact)
// was never the fastest plan at a forward's 17 shapes, nor was a 64 x 128
// tile (probe_int8.py, chip_smoke.check_int8_matmul), since the ring
// already hides the K walk. The plan (tile, ring depth, CTAs) comes from
// ops/int8_matmul.py:int8_plan, which counts waves of CTAs from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; the C entry validates it.
// K must be a multiple of 16 and xq, wq 16-byte aligned (the wrapper
// zero-pads K otherwise, which adds nothing to the sums).
//
// The requant divides only where it can matter: __fdiv_rn on every output
// costs each its own reciprocal, range check and slow-path branch (a build
// with -DVCT_INT8_DIVIDE_ALL=1 divides every output; chip_smoke.py times
// both).
// t = y * r, r = 1 / s_out rounded, lies within 0.75 |t| 2^-22 of the
// quotient q = RN(y / s_out) (two roundings of 2^-24 and r's own). So where
// t sits more than w = |t| 2^-21 inside its rounding interval,
// |t - rint(t)| < 0.5 - w, q rounds to the same integer; where |t| > 200,
// both clamp to the same +-127. Only the few outputs near a half-integer
// (and NaN, and every one where 1 / s_out is not a normal float) take
// __fdiv_rn: every output equals the divide's.

#include <cuda.h>  // CUtensorMap and its enums (types only: the encoder is looked up at run time)
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kStageK = 64;  // bytes of K a ring stage: one 64-byte swizzled row
constexpr int kMaxStages = 16;
constexpr int kTileSlots = 4;  // tiles whose scale, bias and idq are in flight ahead of their epilogue
constexpr int kSmemMax = 232448;
constexpr int kHead = 1024;   // the mbarriers
constexpr int kSlack = 1024;  // to align the dynamic base to the 1 KB swizzle atom
constexpr int BN = 64;        // columns of every tile: one 64-byte swizzled row of int8

// Tiles by the index a plan names: (rows, columns) 128 x 64 and 64 x 64;
// 64 rows a consumer warpgroup.
__host__ __device__ constexpr int tile_rows(int tile) { return tile == 0 ? 128 : 64; }

// The CTAs an SM each tile's kernel is built for (its registers a thread
// fit that many): two of 128 x 64, four of 64 x 64.
__host__ __device__ constexpr int min_blocks(int wg) { return wg == 2 ? 2 : 4; }

// Dynamic shared memory of a launch; ops/int8_matmul.py:smem_bytes is the
// same sum: the ring, the output staging (the tile's rows, 16 bytes
// padded), kTileSlots tiles' scale and bias columns and idq.
__host__ __device__ constexpr int smem_bytes(int bm, int stages, bool residual, bool out_int8) {
  return kSlack + kHead + stages * (bm + BN) * kStageK + bm * (BN * (out_int8 ? 1 : 4) + 16) +
         kTileSlots * 2 * BN * 4 + (residual ? kTileSlots * bm * BN : 0);
}

struct Maps {
  CUtensorMap a, b, idq;  // xq, wq; idq where the TMA takes it
};

struct Args {
  const float* scale;
  const float* bias;
  const int8_t* idq;  // null: no residual
  void* out;
  float s_id, s_out;
  int M, K, N, relu, stages;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait for the phase of bar with this parity to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16) of contiguous global memory into shared memory
// by the TMA, counted on bar's transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The box of a 2-D tensor map at (c0, c1) into shared memory by the TMA,
// counted on bar's transaction count; parts outside the tensor are zeros.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// A wgmma descriptor of a K-major operand in 64-byte rows, 64-byte
// swizzled (mode 2): start address, 8-row groups 512 bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(512 >> 4) << 32 | static_cast<uint64_t>(2) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define VCT_ACC8(i)                                                                       \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])

// d (+)= A . B, a 64 x 64 x 32 step of the warpgroup, both operands in
// shared memory (K-major), int32 sums; with accumulate = 0 the old d is
// ignored. Thread (warp w, lane l) holds d[4 j + 2 h + e] at row 16 w +
// l / 4 + 8 h, column 8 j + 2 (l % 4) + e.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n"
      "}\n"
      : VCT_ACC8(0), VCT_ACC8(8), VCT_ACC8(16), VCT_ACC8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef VCT_ACC8

// Built with -DVCT_INT8_DIVIDE_ALL=1, every output takes the divide: the
// variant that chip_smoke.py times against this one.
#ifndef VCT_INT8_DIVIDE_ALL
#define VCT_INT8_DIVIDE_ALL 0
#endif

// 1.5 * 2^23: added to a float of magnitude at most 2^22 it leaves the
// integer part in the low bits of the significand.
constexpr float kMagic = 12582912.0f;

// An integer-valued float, clamped to +-127, as int8 bits in the low byte:
// adding 1.5 * 2^23 puts a small integer in the low bits of the
// significand (one add in place of a float-to-int conversion).
__device__ __forceinline__ uint32_t int8_bits(float k) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(k, -127.0f), 127.0f), kMagic));
}

// The int8 bits (low byte) of clamp(rint(y * r), -127, 127), r = RN(1 /
// s_out), and exact = whether they provably equal those of
// rint(RN(y / s_out)) clamped (see the note at the top). rint commutes with
// a clamp to the integers +-127, so the bits come from one add of
// 1.5 * 2^23 to the clamped t. Where |t| >= 127 the quotient, within
// 0.75 |t| 2^-22 of t, clamps to the same +-127; below, the window
// |t| 2^-21 is under 127 * 2^-21 < 2^-14, and t - k is exact. NaN is never
// exact.
__device__ __forceinline__ uint32_t requant_bits(float y, float r, float s_out, int& exact) {
  if (VCT_INT8_DIVIDE_ALL) {
    exact = 1;
    return int8_bits(rintf(__fdiv_rn(y, s_out)));
  }
  const float t = __fmul_rn(y, r);
  const float s = __fadd_rn(fminf(fmaxf(t, -127.0f), 127.0f), kMagic);
  const float k = __fsub_rn(s, kMagic);
  exact = (fabsf(t) >= 127.0f) | (fabsf(__fsub_rn(t, k)) < 0.5f - 0x1p-14f);
  return __float_as_uint(s);
}

__device__ __noinline__ float requant_divide(float y, float s_out) {
  return rintf(__fdiv_rn(y, s_out));
}

// Byte offset of (row r, byte c) in a tile of 64-byte rows as the TMA lays
// it, 64-byte swizzled (16-byte chunks XORed with the row's bits 1-2).
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * BN + (((c >> 4) ^ ((r >> 1) & 3)) << 4) + (c & 15);
}

// The tensor map into the TMA's descriptor cache ahead of its first load.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ float affine(int acc, float sc, float bi) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), sc), bi);
}

// kFast: every operand as the TMA and 16-byte accesses take it (idq by the
// TMA, scale and bias by bulk copies, the output staged a warp's rows at a
// time and stored 16 bytes a lane): an epilogue with no branch an output.
// Otherwise (odd N, unaligned pointers) idq, scale and bias are read and
// the output written by lanes, with bounds checks.
template <int WG, bool kResidual, bool kOutInt8, bool kFast>
__global__ void __launch_bounds__(WG * 128 + 32, min_blocks(WG))
    int8_matmul_kernel(const __grid_constant__ Maps maps, const Args a) {
  constexpr int BM = 64 * WG, NT = 128 * WG, NREG = BN / 2;
  constexpr int kStage = (BM + BN) * kStageK;
  constexpr int kRowBytes = BN * (kOutInt8 ? 1 : 4) + 16;  // padded: no bank conflicts
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + ((((raw + kSlack - 1) / kSlack) * kSlack) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint64_t* tile_full = empty + kMaxStages;
  uint64_t* tile_empty = tile_full + kTileSlots;
  const uint32_t ring = smem_addr(smem + kHead);
  uint8_t* staging = smem + kHead + a.stages * kStage;
  float* cols_s = reinterpret_cast<float*>(staging + BM * kRowBytes);  // [slot][scale, bias][BN]
  uint8_t* idq_s = staging + BM * kRowBytes + kTileSlots * 2 * BN * 4;

  const int tid = threadIdx.x;
  const int M = a.M, K = a.K, N = a.N;
  const int ntn = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * ntn;
  const int kstages = (K + kStageK - 1) / kStageK;

  if (tid == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT / 32);  // each consumer warp
    }
    for (int s = 0; s < kTileSlots; ++s) {
      mbar_init(&tile_full[s], 1);
      mbar_init(&tile_empty[s], NT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NT) {
    // The producer: in the fast form a tile's scale and bias columns (and
    // idq) ahead of its first stage, into one of kTileSlots slots; then
    // every K stage as soon as its slot is free.
    if (tid == NT) {
      prefetch_map(&maps.a);
      prefetch_map(&maps.b);
      int seq = 0, it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
        const int m0 = t / ntn * BM, n0 = t % ntn * BN;
        if (kFast) {
          const int s = it % kTileSlots;
          if (it >= kTileSlots) mbar_wait(&tile_empty[s], (it / kTileSlots - 1) & 1);
          mbar_expect_tx(&tile_full[s], 2 * BN * 4 + (kResidual ? BM * BN : 0));
          bulk_load(cols_s + s * 2 * BN, a.scale + n0, BN * 4, &tile_full[s]);
          bulk_load(cols_s + s * 2 * BN + BN, a.bias + n0, BN * 4, &tile_full[s]);
          if (kResidual) {
            tma_2d(smem_addr(idq_s + s * BM * BN), &maps.idq, n0, m0, &tile_full[s]);
          }
        }
        for (int kk = 0; kk < kstages; ++kk, ++seq) {
          const int slot = seq % a.stages;
          if (seq >= a.stages) mbar_wait(&empty[slot], (seq / a.stages - 1) & 1);
          mbar_expect_tx(&full[slot], kStage);
          const int k0 = kk * kStageK;
          tma_2d(ring + slot * kStage, &maps.a, k0, m0, &full[slot]);
          tma_2d(ring + slot * kStage + BM * kStageK, &maps.b, k0, n0, &full[slot]);
        }
      }
    }
    __syncwarp();
  } else {
    const int wg = tid / 128, warp = tid / 32, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int wrow = 64 * wg + 16 * (warp & 3) + g;  // the tile row of d[4 j], d[4 j + 1]
    // 1 / s_out, or NaN (every output then divides) where it is not a
    // normal float and the error bound at the top does not hold.
    const float r_rcp = __frcp_rn(a.s_out);
    const float r_out = fabsf(r_rcp) >= 1.17549435e-38f && fabsf(r_rcp) <= 3.40282347e38f
                            ? r_rcp
                            : __int_as_float(0x7fffffff);
    // The ReLU as a floor in the float32 form (fmaxf(y, -inf) is y for every
    // y but NaN, which finite operands never make); a select in the int8
    // form. Each is the faster of the two for its form on an H100.
    const float relu_floor = a.relu ? 0.0f : -INFINITY;
    int acc[NREG];
#pragma unroll
    for (int i = 0; i < NREG; ++i) acc[i] = 0;
    int seq = 0, it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      const int m0 = t / ntn * BM, n0 = t % ntn * BN;
      for (int kk = 0; kk < kstages; ++kk, ++seq) {
        const int slot = seq % a.stages;
        mbar_wait(&full[slot], (seq / a.stages) & 1);
        const uint32_t sa = ring + slot * kStage + wg * 64 * kStageK;
        const uint32_t sb = ring + slot * kStage + BM * kStageK;
        // Past K the TMA filled zeros, which add nothing: every k32 step
        // runs (a step skipped on a condition serialises the wgmma).
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kStageK / 32; ++ks) {
          wgmma_s8(acc, wgmma_desc(sa + ks * 32), wgmma_desc(sb + ks * 32), kk > 0 || ks > 0);
        }
        wgmma_commit();
        // The last stage's products are done: its slot is free, released
        // by every consumer warp. This stage's stay in flight.
        if (kk > 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&empty[(seq - 1) % a.stages]);
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[(seq - 1) % a.stages]);

      // The epilogue, from the accumulators: d[4 j + 2 h + e] is the output
      // at tile row wrow + 8 h, column 8 j + 2 t4 + e. A branch-free pass
      // requants every output and marks those near a rounding tie; a
      // second pass, which only the threads holding one run, gives those
      // the divide. The fast form stages the warp's 16 rows in its
      // own shared memory and stores them 16 bytes a lane, a row's chunks
      // on neighbouring lanes: no barrier beyond the warp.
      const uint8_t* ids = idq_s + (it % kTileSlots) * BM * BN;
      const float* cols = cols_s + (it % kTileSlots) * 2 * BN;
      if (kFast) mbar_wait(&tile_full[it % kTileSlots], (it / kTileSlots) & 1);
      // Scale and bias of columns c, c + 1 (zeros past N) and the idq pair
      // at tile row r.
      auto columns = [&](int c, float2& sc, float2& bi) {
        const int col = n0 + c;
        if (kFast) {  // whole column tiles, staged with the tile
          sc = *reinterpret_cast<const float2*>(cols + c);
          bi = *reinterpret_cast<const float2*>(cols + BN + c);
        } else {
          sc.x = col < N ? __ldg(a.scale + col) : 0.0f;
          sc.y = col + 1 < N ? __ldg(a.scale + col + 1) : 0.0f;
          bi.x = col < N ? __ldg(a.bias + col) : 0.0f;
          bi.y = col + 1 < N ? __ldg(a.bias + col + 1) : 0.0f;
        }
      };
      auto identity = [&](int r, int c) {
        if (kFast) {
          const int pair = *reinterpret_cast<const uint16_t*>(ids + swizzled(r, c));
          return make_int2(static_cast<int8_t>(pair & 0xff), static_cast<int8_t>(pair >> 8));
        }
        const int row = m0 + r, col = n0 + c;
        const int8_t* src = a.idq + static_cast<size_t>(row) * N + col;
        return make_int2(row < M && col < N ? src[0] : 0, row < M && col + 1 < N ? src[1] : 0);
      };
      // The residual join, then the ReLU (always after a residual join).
      auto finish = [&](float y, int id) {
        if (kResidual) y = __fadd_rn(y, __fmul_rn(__int2float_rn(id), a.s_id));
        if (!kOutInt8) return fmaxf(y, relu_floor);
        return kResidual || a.relu ? fmaxf(y, 0.0f) : y;
      };
      // This warp's staging: its 16 rows, kRowBytes apart.
      uint8_t* own = staging + (warp * 16) * kRowBytes;
      auto store_pair = [&](int h, int c, uint32_t q, float y0, float y1) {
        const int r = wrow + 8 * h, row = m0 + r, col = n0 + c;
        if (kFast && kOutInt8) {
          *reinterpret_cast<uint16_t*>(own + (g + 8 * h) * kRowBytes + c) =
              static_cast<uint16_t>(q);
        } else if (kFast) {
          *reinterpret_cast<float2*>(own + (g + 8 * h) * kRowBytes + 4 * c) = make_float2(y0, y1);
        } else if (row < M && kOutInt8) {
          int8_t* dst = static_cast<int8_t*>(a.out) + static_cast<size_t>(row) * N + col;
          if (col < N) dst[0] = static_cast<int8_t>(q & 0xff);
          if (col + 1 < N) dst[1] = static_cast<int8_t>(q >> 8);
        } else if (row < M) {
          float* dst = static_cast<float*>(a.out) + static_cast<size_t>(row) * N + col;
          if (col < N) dst[0] = y0;
          if (col + 1 < N) dst[1] = y1;
        }
      };
      uint32_t inexact = 0;  // bit i / 2: the pair d[i], d[i + 1] has an output near a tie
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * t4;
        float2 sc, bi;
        columns(c, sc, bi);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          const int2 id = kResidual ? identity(wrow + 8 * h, c) : make_int2(0, 0);
          const float y0 = finish(affine(acc[i], sc.x, bi.x), id.x);
          const float y1 = finish(affine(acc[i + 1], sc.y, bi.y), id.y);
          uint32_t q = 0;
          if (kOutInt8) {
            int e0, e1;
            q = __byte_perm(requant_bits(y0, r_out, a.s_out, e0),
                            requant_bits(y1, r_out, a.s_out, e1), 0x0040);
            inexact |= static_cast<uint32_t>(!(e0 & e1)) << (i / 2);
          }
          store_pair(h, c, q, y0, y1);
        }
      }
      if (kOutInt8 && inexact != 0) {
        // Some output sat near a rounding tie: its pair is checked again and
        // those outputs take the divide (the rare path, run only by the
        // threads that hold one).
#pragma unroll
        for (int i = 0; i < NREG; ++i) {
          if (!(inexact >> (i / 2) & 1)) continue;
          const int j = i / 4, h = (i / 2) % 2, e = i % 2, c = 8 * j + 2 * t4;
          float2 sc, bi;
          columns(c, sc, bi);
          const int2 id = kResidual ? identity(wrow + 8 * h, c) : make_int2(0, 0);
          const float y = finish(affine(acc[i], e ? sc.y : sc.x, e ? bi.y : bi.x), e ? id.y : id.x);
          int exact;
          requant_bits(y, r_out, a.s_out, exact);
          if (exact) continue;
          const uint32_t q = int8_bits(requant_divide(y, a.s_out)) & 0xff;
          const int r = wrow + 8 * h, row = m0 + r, col = n0 + c + e;
          if (kFast) {
            own[(g + 8 * h) * kRowBytes + c + e] = static_cast<uint8_t>(q);
          } else if (row < M && col < N) {
            static_cast<int8_t*>(a.out)[static_cast<size_t>(row) * N + col] =
                static_cast<int8_t>(q);
          }
        }
      }
      if (kFast) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&tile_empty[it % kTileSlots]);
      }
      if (kFast) {
        // The warp's 16 rows to device memory, 16 bytes a lane.
        constexpr int kChunks = BN * (kOutInt8 ? 1 : 4) / 16;  // a row's 16-byte chunks
        __syncwarp();
#pragma unroll
        for (int i = lane; i < 16 * kChunks; i += 32) {
          const int r = i / kChunks, ch = i % kChunks;
          const int row = m0 + 64 * wg + 16 * (warp & 3) + r;
          const int col = n0 + ch * 16 / (kOutInt8 ? 1 : 4);
          if (row < M && col < N) {
            uint8_t* dst = static_cast<uint8_t*>(a.out) +
                           (static_cast<size_t>(row) * N + col) * (kOutInt8 ? 1 : 4);
            *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(own + r * kRowBytes +
                                                                            ch * 16);
          }
        }
        __syncwarp();  // the staging is read before the next tile writes it
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time by cudaGetDriverEntryPoint
// (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A 2-D tensor map of a row-major (rows, cols) int8 matrix in boxes of
// 64 bytes x box_rows, 64-byte swizzled, zeros outside.
int encode_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                                    reinterpret_cast<void**>(&encode),
                                                    cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      encode = nullptr;
      return static_cast<int>(err != cudaSuccess ? err : cudaErrorSymbolNotFound);
    }
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The kernel of a tile and form, as a function of the tile's shape.
template <int WG>
int launch_tile(const Maps& maps, const Args& args, bool residual, bool out_int8, bool fast,
                int grid, cudaStream_t st) {
  const int smem = smem_bytes(64 * WG, args.stages, residual, out_int8);
  auto form = [&](auto res, auto i8) {
    constexpr bool kRes = decltype(res)::value, kI8 = decltype(i8)::value;
    if (fast) {
      int8_matmul_kernel<WG, kRes, kI8, true><<<grid, WG * 128 + 32, smem, st>>>(maps, args);
    } else {
      int8_matmul_kernel<WG, kRes, kI8, false><<<grid, WG * 128 + 32, smem, st>>>(maps, args);
    }
    return static_cast<int>(cudaGetLastError());
  };
  using T = std::true_type;
  using F = std::false_type;
  if (residual) return out_int8 ? form(T{}, T{}) : form(T{}, F{});
  return out_int8 ? form(F{}, T{}) : form(F{}, F{});
}

// Every instantiation of the tile allowed the most shared memory a CTA may
// take.
template <int WG>
cudaError_t allow_smem() {
#define VCT_FN(r, i, f) reinterpret_cast<const void*>(int8_matmul_kernel<WG, r, i, f>)
  const void* fns[] = {VCT_FN(true, true, true),   VCT_FN(true, false, true),
                       VCT_FN(false, true, true),  VCT_FN(false, false, true),
                       VCT_FN(true, true, false),  VCT_FN(true, false, false),
                       VCT_FN(false, true, false), VCT_FN(false, false, false)};
#undef VCT_FN
  for (const void* f : fns) {
    const cudaError_t err =
        cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// CTAs of the tile's kernel (int8 out, no residual, the fast form; every
// form has the same launch bounds) an SM runs at once at smem bytes a CTA.
template <int WG>
int active_ctas(int smem, int* out) {
  const cudaError_t err = allow_smem<WG>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, int8_matmul_kernel<WG, false, true, true>, WG * 128 + 32, smem));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// cudaOccupancyMaxActiveBlocksPerMultiprocessor of the tile's kernel at
// smem bytes of shared memory a CTA, into *out; also allows every
// instantiation of the tile the most shared memory a CTA may take, once,
// so that no launch sets an attribute. Returns a cudaError_t.
extern "C" int vct_int8_matmul_active_ctas(int tile, int smem, int* out) {
  if (smem < 0 || smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  switch (tile) {
    case 0:
      return active_ctas<2>(smem, out);
    case 1:
      return active_ctas<1>(smem, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One launch. idq null: no residual. out is int8 (M, N) when out_int8,
// else float (M, N). K must be a multiple of 16 and x, w 16-byte aligned
// (the wrapper pads). plan = {tile, stages, grid}
// (ops/int8_matmul.py:int8_plan; the launcher runs only after
// vct_int8_matmul_active_ctas allowed the shared memory): a plan that does
// not fit (a tile that does not exist, a ring of fewer than 2 or more than
// 16 stages, more shared memory than a CTA may take, a grid of more CTAs
// than tiles) is refused with cudaErrorInvalidValue and nothing runs.
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int vct_int8_matmul_requant(const int8_t* x, const int8_t* w, const float* scale,
                                       const float* bias, const int8_t* idq, float s_id,
                                       float s_out, void* out, int M, int K, int N, int relu,
                                       int out_int8, const int* plan, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || !aligned16(x) || !aligned16(w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile = plan[0], stages = plan[1], grid = plan[2];
  const bool residual = idq != nullptr;
  if (tile < 0 || tile > 1) return static_cast<int>(cudaErrorInvalidValue);
  const int bm = tile_rows(tile);
  const long long tiles = static_cast<long long>((M + bm - 1) / bm) * ((N + BN - 1) / BN);
  if (stages < 2 || stages > kMaxStages ||
      smem_bytes(bm, stages, residual, out_int8 != 0) > kSmemMax || grid < 1 || grid > tiles ||
      tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The fast form: whole column tiles (N % 64 == 0), idq as the TMA takes
  // it, out in 16-byte chunks, scale and bias by bulk copies (all 16-byte
  // aligned).
  const bool fast = N % BN == 0 && (!residual || aligned16(idq)) && aligned16(out) &&
                    aligned16(scale) && aligned16(bias);
  const Args args = {scale, bias, idq, out, s_id, s_out, M, K, N, relu, stages};
  Maps maps = {};
  int rc = encode_map(&maps.a, x, M, K, bm);
  if (rc == 0) rc = encode_map(&maps.b, w, N, K, BN);
  if (rc == 0 && fast && residual) rc = encode_map(&maps.idq, idq, M, N, bm);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tile == 0 ? launch_tile<2>(maps, args, residual, out_int8 != 0, fast, grid, st)
                   : launch_tile<1>(maps, args, residual, out_int8 != 0, fast, grid, st);
}
