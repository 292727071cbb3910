// Fused vocabulary projection, exact row top-k and row logsumexp of
// logits = bf16(x) . W + b, without writing the (N, V) logits anywhere.
//
// Replaces: video_captioning_tpu/ops/vocab_topk_pallas.py, _kernel
// (vocab_topk_lse), the beam step's expansion when
// kernels.use_fused_vocab_topk is set (generation/beam.py). It replaces the
// port's first design, a grid of 64-row x 128-column tiles: every tile
// re-read and re-rounded its rows of x, each weight tile was read once a row
// block through registers two k-tiles deep, every tile's logits went
// through shared memory and a full insert and exp a column, and 79 partial
// states a row went to the merge launch.
//
// Contract (held by the tests against the plain PyTorch version in
// ops/vocab_topk.py): x (N, H) float32 is rounded to bf16 (round to
// nearest even, as torch's .to(torch.bfloat16)); W (H, Vp) arrives in bf16
// and b (Vp,) in float32 from pad_vocab_weights, whose padded columns
// carry a float32-min bias (never selected, exp() = 0). The tensor cores
// multiply the bf16 values exactly and accumulate in float32, rounding
// their internal sums their own way, so a logit matches the plain
// version's (exact products, float32 sums in another order) to about 1e-6
// of the logits' scale, not bit for bit; integer-valued operands are exact.
// Given the kernel's logits, the top-k values and indices are exact, in
// lax.top_k's order (value desc, index asc); the lse matches to float32
// rounding. 1 <= k <= 16, any N, H <= 1152. Two launches give the same
// bits: no atomics, every merge in a fixed order.
//
// What bounds it on an H100: operations. At the beam step's shape
// (N = 640, H = 512, Vp = 10112) the product is 6.6 GFLOP, 6.7 us at the
// bf16 tensor-core peak, against 10 MB of weights and 1.3 MB of x read once.
// A weight byte feeds 2 x (rows of a block) operations, so the row block is
// as tall as shared memory allows (128 rows), and L2 feeds the weight
// stream at about 5 row blocks x 10 MB a call.
//
// Design: three launches. (1) x is rounded to bf16 once, into an (N, Hp)
// scratch (Hp = H rounded up to 64, zeros past H). (2) A CTA takes a block
// of RB = 64 NWG rows (128 at H <= 512, else 64) and a span of consecutive
// 128-column vocabulary tiles; the grid is row blocks x spans, sized by the
// wrapper (ops/vocab_topk.py: vocab_partition) to one wave on the card's
// SMs: 5 x 20 CTAs of 4 tiles at the beam step's shape. A producer warp
// loads the CTA's x block once by TMA (128-byte swizzled, resident for the
// whole span) and streams the span's weight k-tiles (64 x 128 bf16, two TMA
// boxes, and a tile's bias with its first k-tile) through a 4-stage ring on
// full / empty mbarriers, without draining between tiles. A product
// warpgroup a 64 rows runs wgmma m64n128k16 with both operands in shared
// memory (x K-major, W N-major), keeping the last stage's products in
// flight while it waits for the next. At a tile's end each thread carries
// its two rows' (m, s) and top-k straight from its accumulators: the bias,
// -inf past Vp, a tile max, one rescale, a sum of exp with no branch a
// column, and a compare against a lower bound of the row's k-th value (its
// quad's largest list k-th, and in the span's first tile the k-th largest
// of the row's 16 group maxima); the few values above it go through a
// per-thread stash in shared memory into the thread's list. At the span's
// end the quad merges its four lists and (m, s) pairs and writes one state
// per (row, span). (3) A warp per row merges the row's span states (a few
// hundred bytes) in span order. The total order of the lists makes every
// merge independent of the order the states arrive in, so cross-tile and
// cross-span ties keep ascending vocabulary order.

#include <cuda.h>  // CUtensorMap and its enums (types only: the encoder is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "topk_list.cuh"

namespace {

using namespace vct;

constexpr int kCols = 128;   // vocabulary columns of a tile
constexpr int kKT = 64;      // k of a ring stage: four wgmma k-steps
constexpr int kStages = 4;
constexpr int kStageBytes = kKT * kCols * 2;  // 16 KB: 2 column halves x 8 k-groups of 1 KB
constexpr int kMaxSmem = 232448;

// RB = 64 NWG rows a CTA: a product warpgroup a 64 rows, and a producer warp.
__host__ __device__ constexpr int mma_threads(int nwg) { return 128 * nwg; }
__host__ __device__ constexpr int threads_of(int nwg) { return mma_threads(nwg) + 32; }

// Dynamic shared memory, 1 KB aligned: barriers, the bias of two tiles, the
// weight ring, the resident x block (Hp a multiple of 64), the product
// threads' stash of 32 floats each. ops/vocab_topk.py:vocab_smem_bytes is
// the same sum.
constexpr int kHead = 2048;
__host__ __device__ constexpr int smem_bytes(int nwg, int hp) {
  return kHead + kStages * kStageBytes + 64 * nwg * hp * 2 + mma_threads(nwg) * 32 * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
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

// The box of a 2-D tensor map at (column c0, row c1) into shared memory by
// the TMA, 128-byte swizzled, counted on bar's transaction count; parts
// of the box outside the tensor are zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
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

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}

#define VCT_ACC8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A . B for a 64 x 128 x 16 step of the warpgroup: A K-major and B
// N-major (transposed) in shared memory, bf16, float32 accumulators; with
// accumulate = 0 the old d is ignored.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : VCT_ACC8(0), VCT_ACC8(8), VCT_ACC8(16), VCT_ACC8(24), VCT_ACC8(32), VCT_ACC8(40),
        VCT_ACC8(48), VCT_ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef VCT_ACC8

// x (N, H) float32 -> x16 (N, Hp) bf16, round to nearest even, zeros past H:
// eight a thread, one 16-byte store.
__global__ void round_x_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ x16,
                               int N, int H, int Hp) {
  const size_t total = static_cast<size_t>(N) * Hp / 8;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = i / (Hp / 8);
    const int c = static_cast<int>(i - r * (Hp / 8)) * 8;
    __nv_bfloat162 o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lo = c + 2 * e < H ? x[r * H + c + 2 * e] : 0.0f;
      const float hi = c + 2 * e + 1 < H ? x[r * H + c + 2 * e + 1] : 0.0f;
      o[e] = __floats2bfloat162_rn(lo, hi);
    }
    *reinterpret_cast<uint4*>(x16 + r * Hp + c) = *reinterpret_cast<const uint4*>(o);
  }
}

// Stage `stage` of the span into its ring slot: weight rows k0 .. k0 + 31
// of the tile's 128 columns, as two 64-column boxes of 4 KB, each four
// 8-row groups of 128-byte rows (k-groups 1 KB apart, the halves 4 KB
// apart). Rows past H and columns past Vp arrive as zeros.
__device__ __forceinline__ void stage_weights(uint32_t ring, uint64_t* full, int stage, int nk,
                                              int t0, const CUtensorMap* map_w, float* bias,
                                              const float* b, int Vp) {
  const int slot = stage % kStages, tile = stage / nk;
  const int v0 = (t0 + tile) * kCols, k0 = (stage % nk) * kKT;
  // A tile's first stage also brings its bias (a multiple of 16 bytes: Vp %
  // 8 == 0), into buffer tile % 2: the epilogue of tile - 2 has read it by
  // the time this slot is free.
  const int bias_bytes = stage % nk == 0 ? min(kCols, Vp - v0) * 4 : 0;
  mbar_expect_tx(&full[slot], kStageBytes + bias_bytes);
  tma_load_2d(ring + slot * kStageBytes, map_w, v0, k0, &full[slot]);
  tma_load_2d(ring + slot * kStageBytes + kStageBytes / 2, map_w, v0 + 64, k0, &full[slot]);
  if (bias_bytes > 0) bulk_load(bias + (tile % 2) * kCols, b + v0, bias_bytes, &full[slot]);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special-function unit (exp(v - m) as 2^(v log2 e - m log2 e)).
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// One of a thread's two rows in the span: its running top-k (k-th entry at
// KP - 1, list_init_top) and (m, s) over the thread's columns 8 j + 2 tq
// and 8 j + 2 tq + 1 (j = 0 .. 15) of every tile: they ascend, so a later
// equal value never beats the list's k-th (its index is larger) and that
// test is strict.
template <int KP>
struct RowState {
  float tv[KP];
  int ti[KP];
  float m, s;
  float q;  // a lower bound of the row's k-th value, the same on the quad's lanes
};

// The tile's 32 logits of one row in a thread's accumulators: d[4 j + off]
// and d[4 j + off + 1] (off 0 for the upper row, 2 for the lower), bias
// added, -inf past Vp (they add nothing to the sums and are never
// candidates). stash: this thread's column of the stash (16 float pairs,
// 2 MT floats apart), where the values go when some of them may enter the
// list, so that the insert reads them by index from shared memory (a
// runtime index into registers would put the accumulators in local
// memory).
template <int KP, int MT>
__device__ __forceinline__ void row_epilogue(RowState<KP>& st, const float (&d)[64], int off,
                                             int v0, int tq, int k, bool own_ok, bool first,
                                             float* stash) {
  const int lane = threadIdx.x & 31;
  float hm = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j) hm = fmaxf(hm, fmaxf(d[4 * j + off], d[4 * j + off + 1]));
  // q: a lower bound of the row's k-th value; only values >= q can enter
  // the top-k. It only grows: each lane's k-th entry is one, and so, in
  // the span's first tile, is the k-th largest of the row's 16 group
  // maxima (8 values of a lane each, distinct elements); the quad keeps
  // the largest.
  float q = st.ti[KP - 1] == kSentinelIdx ? st.q : fmaxf(st.q, st.tv[KP - 1]);
  if (first) {
    float gm[4];
#pragma unroll
    for (int g4 = 0; g4 < 4; ++g4) {
      gm[g4] = -INFINITY;
#pragma unroll
      for (int j = 4 * g4; j < 4 * g4 + 4; ++j) {
        gm[g4] = fmaxf(gm[g4], fmaxf(d[4 * j + off], d[4 * j + off + 1]));
      }
    }
    float all[16];
#pragma unroll
    for (int src = 0; src < 4; ++src) {
#pragma unroll
      for (int g4 = 0; g4 < 4; ++g4) all[4 * src + g4] = __shfl_sync(kFullMask, gm[g4], (lane & ~3) | src);
    }
#pragma unroll
    for (int g4 = 0; g4 < 4; ++g4) {
      int at_least = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) at_least += all[j] >= gm[g4];
      if (at_least >= k) q = fmaxf(q, gm[g4]);
    }
  }
  q = fmaxf(q, __shfl_xor_sync(kFullMask, q, 1));
  q = fmaxf(q, __shfl_xor_sync(kFullMask, q, 2));
  st.q = q;
  const float mn = fmaxf(st.m, hm);
  if (!own_ok || mn == -INFINITY) return;
  const float mn2 = mn * kLog2e;
  float part[2] = {0.0f, 0.0f};
  unsigned cand = 0u;
  // Candidates: values >= q that beat the list's k-th entry (-inf while it
  // has fewer than k; -inf values never do).
  const float thr = st.tv[KP - 1];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v = d[4 * j + off + e];
      part[e] += exp2_approx(fmaf(v, kLog2e, -mn2));
      if (v >= q && v > thr) cand |= 1u << (2 * j + e);
    }
  }
  st.s = st.s * __expf(st.m - mn) + (part[0] + part[1]);
  st.m = mn;
  if (cand == 0u) return;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<float2*>(stash + 2 * MT * j) = make_float2(d[4 * j + off], d[4 * j + off + 1]);
  }
  while (cand) {  // the rare case: one list insert in the code
    const int c = __ffs(cand) - 1;
    cand &= cand - 1;
    const float v = stash[2 * MT * (c / 2) + c % 2];
    if (v > st.tv[KP - 1]) {
      list_insert<KP>(st.tv, st.ti, v, v0 + 8 * (c / 2) + 2 * tq + c % 2);
    }
  }
}

template <int NWG, int KP>
__global__ void __launch_bounds__(threads_of(NWG), 1)
    vocab_span_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                      const float* __restrict__ b, float* __restrict__ pv, int* __restrict__ pi,
                      float* __restrict__ pm, float* __restrict__ ps, int N, int Hp, int Vp, int k,
                      int tiles_per_span) {
  constexpr int RB = 64 * NWG;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  uint64_t* x_full = empty + kStages;  // the x block has arrived
  float* bias = reinterpret_cast<float*>(smem + 1024);  // [tile % 2][128]
  const uint32_t ring = smem_addr(smem + kHead);
  const uint32_t xs = ring + kStages * kStageBytes;
  float* stash = reinterpret_cast<float*>(smem + kHead + kStages * kStageBytes + RB * Hp * 2) +
                 2 * threadIdx.x;  // this thread's column: 16 pairs of floats, 2 MT apart

  const int span = blockIdx.x, n_spans = gridDim.x;
  const int row0 = blockIdx.y * RB;
  const int n_tiles = (Vp + kCols - 1) / kCols;
  const int t0 = span * tiles_per_span;
  const int t1 = min(t0 + tiles_per_span, n_tiles);
  const int nk = Hp / kKT;
  const int total = (t1 - t0) * nk;  // (tile, k-tile) stages through the ring
  const int tid = threadIdx.x, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);  // a thread a product warpgroup
    }
    mbar_init(x_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= mma_threads(NWG)) {
    // The producer warp: the resident x block once ([k-chunk of 64][row]
    // rows of 128 B, 16-byte chunk c of row r at c ^ (r % 8); rows past N
    // are zeros), then every stage of the span as soon as its slot is free.
    if (lane == 0) {
      mbar_expect_tx(x_full, RB * Hp * 2);
      for (int kc = 0; kc < Hp / 64; ++kc) {
        tma_load_2d(xs + kc * RB * 128, &map_x, kc * 64, row0, x_full);
      }
      // At most min(kStages, nk) stages ahead: a tile's bias buffer is not
      // reloaded before the epilogue two tiles back has read it.
      const int depth = min(kStages, nk);
      for (int i = 0; i < total; ++i) {
        if (i >= depth) mbar_wait(&empty[(i - depth) % kStages], ((i - depth) / kStages) & 1);
        stage_weights(ring, full, i, nk, t0, &map_w, bias, b, Vp);
      }
    }
    return;
  }

  // The product warpgroups: warpgroup wg takes rows 64 wg .. 64 wg + 63,
  // thread (warp, g, tq) rows 16 (warp % 4) + g and + 8 of them.
  const int wg = tid / 128;
  const bool wg_ok = row0 + 64 * wg < N;  // whole warpgroups past N skip their products
  const uint32_t xs_wg = xs + 64 * wg * 128;
  const int g = lane / 4, tq = lane % 4;
  const int r_up = row0 + 64 * wg + 16 * ((tid / 32) % 4) + g;  // and r_up + 8
  RowState<KP> up, lo;
  list_init_top<KP>(up.tv, up.ti, k);
  list_init_top<KP>(lo.tv, lo.ti, k);
  up.m = lo.m = up.q = lo.q = -INFINITY;
  up.s = lo.s = 0.0f;
  float acc[64];
  mbar_wait(x_full, 0);
  for (int i = 0; i < total; ++i) {
    const int slot = i % kStages, kt = i % nk;
    mbar_wait(&full[slot], (i / kStages) & 1);
    if (wg_ok) {
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < kKT / 16; ++ks) {
        const int kk = kt * kKT + ks * 16;  // k of this step
        // A: k-chunk kk / 64, 32 bytes a step inside its 128-byte rows;
        // 8-row groups 1 KB apart. B: k-groups 2 ks and 2 ks + 1 (1 KB
        // apart), the column halves half a stage apart.
        const uint64_t da = wgmma_desc(xs_wg + (kk / 64) * (RB * 128) + (kk % 64) * 2, 16, 1024);
        const uint64_t db = wgmma_desc(ring + slot * kStageBytes + ks * 2048, kStageBytes / 2, 1024);
        wgmma_m64n128k16(acc, da, db, kt > 0 || ks > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // The last stage's products are done: its slot is free. This
      // stage's stay in flight unless the tile is complete.
      if (kt == nk - 1) {
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      } else {
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      }
    }
    if (i > 0 && tid % 128 == 0) mbar_arrive(&empty[(i - 1) % kStages]);
    if (kt != nk - 1 || !wg_ok) continue;

    // The tile is complete: add the bias, and carry both rows' top-k and
    // (m, s) straight from the accumulators. Accumulator 4 j + q holds row
    // r_up (+ 8 for q >= 2), column 8 j + 2 tq (+ 1 for odd q).
    const int v0 = (t0 + i / nk) * kCols;
    // Columns past Vp become -inf: they add nothing to the sums and are
    // never candidates, so the epilogue has no branch a column.
    const float* bt = bias + ((i / nk) % 2) * kCols;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * tq;
      const bool ok = v0 + c < Vp;
      const float2 bb = ok ? *reinterpret_cast<const float2*>(bt + c) : make_float2(0.0f, 0.0f);
      acc[4 * j] = ok ? acc[4 * j] + bb.x : -INFINITY;
      acc[4 * j + 1] = ok ? acc[4 * j + 1] + bb.y : -INFINITY;
      acc[4 * j + 2] = ok ? acc[4 * j + 2] + bb.x : -INFINITY;
      acc[4 * j + 3] = ok ? acc[4 * j + 3] + bb.y : -INFINITY;
    }
    const bool first = i / nk == 0;
    row_epilogue<KP, mma_threads(NWG)>(up, acc, 0, v0, tq, k, r_up < N, first, stash);
    row_epilogue<KP, mma_threads(NWG)>(lo, acc, 2, v0, tq, k, r_up + 8 < N, first, stash);
  }

  // The span's state of each row: the four lanes of a quad share it.
  float mv[KP];
  int mi[KP];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    RowState<KP>& st = half == 0 ? up : lo;
    const int row = r_up + 8 * half;
    list_drop_top<KP>(st.tv, st.ti, k);
    group_merge<KP, 4>(st.tv, st.ti, mv, mi, k);
    group_lse<4>(st.m, st.s);
    if (tq == 0 && row < N) {
      const size_t slot = static_cast<size_t>(row) * n_spans + span;
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        if (j < k) {
          pv[slot * k + j] = mv[j];
          pi[slot * k + j] = mi[j];
        }
      }
      pm[slot] = st.m;
      ps[slot] = st.s;
    }
  }
}

// A warp per row, four rows a CTA: lane t holds span t's state (its k
// entries arrive sorted; a lane with more spans inserts the rest), then the
// warp merges in k rounds and the (m, s) pairs in a fixed order.
template <int KP>
__global__ void __launch_bounds__(128)
    vocab_merge_kernel(const float* __restrict__ pv, const int* __restrict__ pi,
                       const float* __restrict__ pm, const float* __restrict__ ps,
                       float* __restrict__ vals, int* __restrict__ idx,
                       float* __restrict__ lse, int n, int n_spans, int k) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  float tv[KP];
  int ti[KP];
  float m = -INFINITY, s = 0.0f;
  const size_t base = static_cast<size_t>(row) * n_spans;
  const bool have = lane < n_spans;
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    tv[j] = have && j < k ? pv[(base + lane) * k + j] : -INFINITY;
    ti[j] = have && j < k ? pi[(base + lane) * k + j] : kSentinelIdx;
  }
  if (have) {
    m = pm[base + lane];
    s = ps[base + lane];
  }
  for (int t = lane + 32; t < n_spans; t += 32) {
    for (int j = 0; j < k; ++j) list_insert<KP>(tv, ti, pv[(base + t) * k + j], pi[(base + t) * k + j]);
    lse_merge(m, s, pm[base + t], ps[base + t]);
  }
  float mv[KP];
  int mi[KP];
  group_merge<KP>(tv, ti, mv, mi, k);
  group_lse(m, s);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      if (j < k) {
        vals[static_cast<size_t>(row) * k + j] = mv[j];
        idx[static_cast<size_t>(row) * k + j] = mi[j];
      }
    }
    lse[row] = lse_value(m, s);
  }
}

// cuTensorMapEncodeTiled, looked up at run time by cudaGetDriverEntryPoint
// (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A 2-D bf16 tensor map of a row-major (rows, cols) matrix with boxes of 64
// columns x box_rows rows, 128-byte swizzled, zeros outside.
int make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
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
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int NWG, int KP>
int launch_span(const __nv_bfloat16* x16, const __nv_bfloat16* w, const float* b, float* pv,
                int* pi, float* pm, float* ps, int n, int h, int hp, int vp, int k,
                int tiles_per_span, int n_spans, cudaStream_t st) {
  const int bytes = smem_bytes(NWG, hp);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w;
  int rc = make_map(&map_x, x16, n, hp, 64 * NWG);
  if (rc == 0) rc = make_map(&map_w, w, h, vp, kKT);
  if (rc != 0) return rc;
  static int set_bytes = 0;  // the largest size this kernel was allowed so far
  if (bytes > set_bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        vocab_span_kernel<NWG, KP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    set_bytes = bytes;
  }
  const dim3 grid(n_spans, (n + 64 * NWG - 1) / (64 * NWG));
  vocab_span_kernel<NWG, KP><<<grid, threads_of(NWG), bytes, st>>>(map_x, map_w, b, pv, pi, pm,
                                                                  ps, n, hp, vp, k, tiles_per_span);
  return static_cast<int>(cudaGetLastError());
}

template <int KP>
int launch(const float* x, const __nv_bfloat16* w, const float* b, __nv_bfloat16* x16,
           float* pv, int* pi, float* pm, float* ps, float* vals, int* idx, float* lse, int n,
           int h, int hp, int vp, int k, int rows, int tiles_per_span, int n_spans,
           cudaStream_t st) {
  const size_t total = static_cast<size_t>(n) * hp / 8;
  const int blocks = static_cast<int>(std::min<size_t>((total + 255) / 256, 4096));
  round_x_kernel<<<blocks, 256, 0, st>>>(x, x16, n, h, hp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc =
      rows == 128
          ? launch_span<2, KP>(x16, w, b, pv, pi, pm, ps, n, h, hp, vp, k, tiles_per_span, n_spans, st)
          : launch_span<1, KP>(x16, w, b, pv, pi, pm, ps, n, h, hp, vp, k, tiles_per_span, n_spans, st);
  if (rc != 0) return rc;
  vocab_merge_kernel<KP><<<(n + 3) / 4, 128, 0, st>>>(pv, pi, pm, ps, vals, idx, lse, n, n_spans, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns a cudaError_t: 0 when the three launches were accepted. The
// partition (rows, tiles_per_span, n_spans) and hp come from
// ops/vocab_topk.py:vocab_partition; x16 holds (N, hp) bf16 of scratch,
// pv/pi (N, n_spans, k) and pm/ps (N, n_spans).
extern "C" int vct_vocab_topk_lse(const float* x, const void* w, const float* b, void* x16,
                                  float* pv, int* pi, float* pm, float* ps, float* vals,
                                  int* idx, float* lse, int n, int h, int hp, int vp, int k,
                                  int rows, int tiles_per_span, int n_spans, void* stream) {
  const int n_tiles = (vp + kCols - 1) / kCols;
  if (n <= 0 || h <= 0 || hp != (h + 63) / 64 * 64 || vp <= 0 || vp % 8 != 0 ||
      reinterpret_cast<size_t>(w) % 16 != 0 || reinterpret_cast<size_t>(x16) % 16 != 0 ||
      reinterpret_cast<size_t>(b) % 16 != 0 ||
      k < 1 || k > 16 || k > vp || (rows != 64 && rows != 128) || tiles_per_span < 1 ||
      n_spans < 1 || n_spans * tiles_per_span < n_tiles ||
      (n_spans - 1) * tiles_per_span >= n_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  __nv_bfloat16* xb = static_cast<__nv_bfloat16*>(x16);
#define VCT_VOCAB_LAUNCH(KP)                                                                    \
  launch<KP>(x, wb, b, xb, pv, pi, pm, ps, vals, idx, lse, n, h, hp, vp, k, rows, tiles_per_span, \
             n_spans, st)
  if (k == 1) return VCT_VOCAB_LAUNCH(1);
  if (k == 2) return VCT_VOCAB_LAUNCH(2);
  if (k <= 4) return VCT_VOCAB_LAUNCH(4);
  if (k <= 8) return VCT_VOCAB_LAUNCH(8);
  return VCT_VOCAB_LAUNCH(16);
#undef VCT_VOCAB_LAUNCH
}
