// One stride-1 identity-residual ResNet bottleneck block, fully fused:
//   out = relu(relu(conv3x3(relu(x . W1^T + b1)) + b2) . W3^T + b3 + x)
// over NHWC x (B, H, W, C), float32 or bfloat16, BN folded into the
// weights: w1 (Cm, C), w2 (Cm, 3, 3, Cm) (OIHW in channels_last memory, so
// a row is the 9 x Cm taps of one output channel), w3 (C, Cm), biases in
// x's type. In bfloat16, y1 and y2 are rounded to bfloat16 before the next
// product, as the TPU kernel does.
//
// Replaces: video_captioning_tpu/ops/bottleneck_pallas.py, _kernel
// (fused_bottleneck), the 12 stride-1 identity blocks of ResNet50 under
// resnet50_variant "fused" and "fused_s2d".
//
// What bounds it on an H100: operations. Every stage's block is about
// 13.98 GFLOP at B = 32: 0.014 ms at the bf16 tensor-core peak, 0.085 ms
// as three TF32 products (float32), against 0.1-0.4 GB of x and out
// (0.03-0.12 ms at 3.35 TB/s). Feeding the tensor cores is the design's
// concern: the weights stream from L2 once a work item, so a work item
// must be tall, and the card must hold every cluster of a launch at once.
//
// Design. The channels are split over a thread block cluster of cs CTAs
// that share one work item: ni whole images, or one ty x tx tile of one
// image with its one-pixel halo. CTA rank q owns y1 and y2 channels
// q ns .. q ns + ns - 1 (ns = 64, 128 or 256: one wgmma's width for two
// warpgroups) and output channels q nc .. (q + 1) nc - 1. Y, in every CTA,
// holds y1 of all channels over the item's halo grid (zero outside the
// image), and later y2 over its pixels:
//   1. y1 for its channels over the x box (the item's halo window clipped
//      to the image), A = x and B = w1 through the ring; each CTA stores
//      its y1 into Y of every CTA of the cluster (distributed shared
//      memory), then the cluster waits on a barrier;
//   2. y2 = relu(conv3x3(y1) + b2) for its channels: one product over
//      K = 9 Cm whose A rows are read straight from Y by ldmatrix at the
//      nine shifted positions (the im2col gather costs nothing); after a
//      barrier (no CTA still reads y1) y2 goes into every Y the same way;
//   3. out = relu(y2 . W3^T + b3 + x) for its output channels, A from Y,
//      in tiles of ns columns; a tile's residual comes by the TMA into the
//      x regions of the ring's slots (idle after phase 1), the output is
//      formed there in place and leaves by a TMA store.
// Products: wgmma (m64 x ns / 2 a warpgroup, A from registers by ldmatrix,
// B K-major from the ring, float32 accumulators). bfloat16 multiplies
// directly; float32 takes the 3xTF32 split of tf32x3.cuh (A split in
// registers, w split into TF32 hi and lo parts once a call by a small
// launch into the caller's scratch, since wgmma reads B straight from
// shared memory), each k-tile's products into a fresh partial added into
// the sum with rounded float32 adds (the tensor cores' truncating
// accumulation otherwise grows with K). A warp waits for its products at
// the end of every k-tile: the next k-tile's A fragments reuse their
// registers, which wgmma reads asynchronously; in bfloat16 phase 1 reads A
// (the x box as the TMA wrote it) by descriptor instead, so one k-tile's
// products stay in flight while the next one's issue. Copies: the TMA, through a
// ring of stages on full / empty mbarriers that runs across the three
// phases, issued by one thread of a producer warpgroup (whose registers go
// to the consumers by setmaxnreg); a stage is a k-tile of 128-byte rows (64
// bfloat16 or 32 float32 of K), 128-byte swizzled: the x box (in phase 1,
// multicast by rank 0 to the whole cluster, whose consumer warps release
// the slot on rank 0's empty barrier) and ns rows of w. Each consumer warp
// releases a slot once its own products are done. The biases sit in shared
// memory as float32. The plan
// (cluster size, ns, work item, ring depth) is the wrapper's
// (ops/bottleneck.py:kernel_plan, waves of clusters counted from
// cudaOccupancyMaxActiveClusters); the C entry validates it and refuses a
// plan that does not fit. C and Cm must be multiples of 8 (the wrapper
// pads other shapes with zeros).

#include <cuda.h>  // CUtensorMap and its enums (types only: the encoder is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tf32x3.cuh"

namespace {

using vct_tc::smem_addr;

constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kConsumerRegs = 232;          // setmaxnreg: 2 x 128 x 232 + 128 x 40 <= 64K
constexpr int kProducerRegs = 40;
constexpr int kMaxStages = 8;
constexpr int kMaxCluster = 8;
constexpr int kHead = 1024;  // the mbarriers
constexpr int kSlack = 1024;  // the ring starts 1024-byte aligned (the swizzle's period)
constexpr size_t kSmemMax = 232448;

// The (ns, mb1, mb2) the kernel is built for: ns channels a CTA, mb1 and
// mb2 blocks of 64 rows in phase 1 and in phases 2-3. A thread keeps
// mb ns / 4 accumulators (float32: as many partials too, so mb ns <= 256
// there: a consumer thread has at most 168 registers).
#define VCT_FB_BF16(X) \
  X(64, 4, 4) X(64, 2, 2) X(64, 2, 1) X(64, 1, 1) X(128, 4, 4) X(128, 2, 2) X(128, 2, 1) \
  X(128, 1, 1) X(256, 2, 2) X(256, 2, 1) X(256, 1, 1)
#define VCT_FB_F32(X) \
  X(64, 2, 2) X(64, 2, 1) X(64, 1, 1) X(128, 2, 2) X(128, 2, 1) X(128, 1, 1) X(256, 1, 1)

// Elements of a k-tile row (128 bytes) and weight tiles a stage (float32:
// hi and lo).
template <typename T>
__host__ __device__ constexpr int ktile() { return 128 / static_cast<int>(sizeof(T)); }
template <typename T>
__host__ __device__ constexpr int wparts() { return sizeof(T) == 4 ? 2 : 1; }

int ceil_div(int a, int b) { return (a + b - 1) / b; }

struct Plan {
  int cs, ns, ni, ty, tx, stages, mb1, mb2;
};

// A plan's shapes: the x box (bx x by pixels of bi images), the halo grid
// (HY x HX a image), phase 1's rows M1 and the pixels M2, the items, the
// output channels a CTA (nc, a multiple of a 128-byte row's elements, so no
// two CTAs' output boxes meet), a Y row's bytes, a ring slot's bytes, the
// CTA's biases' bytes (b1 and b2 of its slice, b3 of its output tiles,
// float32) and the shared memory.
struct Geo {
  int bx, by, bi, HY, HX, npos, M1, M2, tiles_x, tiles, items, nc;
  size_t yrow, slot, bias, smem;
};

Geo geometry(const Plan& p, int B, int H, int W, int C, int esize, int parts) {
  Geo g;
  const bool whole = p.ty == H && p.tx == W;
  g.bx = std::min(p.tx + 2, W);
  g.by = std::min(p.ty + 2, H);
  g.bi = whole ? p.ni : 1;
  g.HY = p.ty + 2;
  g.HX = p.tx + 2;
  g.npos = p.ni * g.HY * g.HX;
  g.M1 = g.bi * g.by * g.bx;
  g.M2 = p.ni * p.ty * p.tx;
  g.tiles_x = ceil_div(W, p.tx);
  g.tiles = ceil_div(H, p.ty) * g.tiles_x;
  g.items = ceil_div(B, p.ni) * g.tiles;
  const int kt = 128 / esize;
  g.nc = ceil_div(ceil_div(C, p.cs), kt) * kt;
  g.yrow = static_cast<size_t>(p.cs) * p.ns * esize + 16;
  g.slot = static_cast<size_t>(p.mb1) * 64 * 128 + static_cast<size_t>(p.ns) * 128 * parts;
  g.bias = static_cast<size_t>(2 + ceil_div(g.nc, p.ns)) * p.ns * 4;
  g.smem = kHead + kSlack + p.stages * g.slot + g.npos * g.yrow + g.bias;
  (void)B;
  return g;
}

template <typename T>
struct Args {
  const T* b1;
  const T* b2;
  const T* b3;
  int B, H, W, C, Cm;
  int cs, ni, ty, tx, stages;
  int bx, by, HY, HX, npos, M1, M2, tiles_x, tiles, nc;
  int yrow, slot, xbytes, wbytes;
};

// x (C, W, H, B) in phase 1's boxes, and (xo) in boxes of a k-tile row of
// channels over the item's pixels, as out (C, W, H, B) is stored; w1 (C,
// Cm); w2 (Cm, 9, Cm); w3 (Cm, C); float32: the TF32 hi parts, and the lo
// parts in w1l, w2l, w3l.
struct Maps {
  CUtensorMap x, xo, out, w1, w2, w3, w1l, w2l, w3l;
};

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The shared::cluster address of shared address a in cluster CTA rank.
__device__ __forceinline__ uint32_t mapa(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
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

// count arrivals on this CTA's bar.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// One arrival, with release at cluster scope, on the barrier at
// shared::cluster address a.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t a) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(a)
               : "memory");
}

// Wait for the phase of bar with this parity to complete; kCluster: with
// acquire at cluster scope (arrivals from other CTAs of the cluster).
template <bool kCluster>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if constexpr (kCluster) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
  } else {
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
}

// Boxes of tensor maps into shared memory by the TMA, counted on bar's
// transaction count; parts outside the tensor are zeros.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}
// The same box into the same offsets of every CTA in mask, each counted on
// its own bar.
__device__ __forceinline__ void tma_4d_multicast(uint32_t dst, const CUtensorMap* map, int c0,
                                                 int c1, int c2, int c3, uint64_t* bar,
                                                 uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::"
      "cluster [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

// Shared memory at src into the box of a 4-D tensor map at coordinates c
// by the TMA (parts outside the tensor are not written), in this thread's
// bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                             uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// This thread's bulk stores have read their shared memory (kRead) or are
// complete.
template <bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (kRead) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}
// Generic-proxy writes to shared memory, made visible to the TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Four 8 x 16-byte matrices from shared memory; lane l gives the row
// address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// A wgmma descriptor of a K-major, 128-byte-swizzled operand: start
// address, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
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
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A . B, a 64 x N x K step of the warpgroup (K 16 in bfloat16, 8 in
// TF32): A from registers (mma.sync's m16 fragments, warp w of the group
// holding rows 16 w ..), B K-major from shared memory (descriptor db);
// float32 accumulators, d[4 j + e] at row g + 8 (e / 2), column
// 8 j + 2 t + e % 2 of the warp's rows (g = lane / 4, t = lane % 4);
// accumulate = 0 ignores the old d.
__device__ __forceinline__ void wgmma_bf16_n32(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : VCT_ACC8(0), VCT_ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : VCT_ACC8(0), VCT_ACC8(8), VCT_ACC8(16), VCT_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : VCT_ACC8(0), VCT_ACC8(8), VCT_ACC8(16), VCT_ACC8(24), VCT_ACC8(32), VCT_ACC8(40), VCT_ACC8(48), VCT_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : VCT_ACC8(0), VCT_ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : VCT_ACC8(0), VCT_ACC8(8), VCT_ACC8(16), VCT_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : VCT_ACC8(0), VCT_ACC8(8), VCT_ACC8(16), VCT_ACC8(24), VCT_ACC8(32), VCT_ACC8(40), VCT_ACC8(48), VCT_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (+)= A . B with both operands from shared memory (descriptors da, db;
// bfloat16, K-major, float32 accumulators, the layout above).
__device__ __forceinline__ void wgmma_bf16_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : VCT_ACC8(0), VCT_ACC8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : VCT_ACC8(0), VCT_ACC8(8), VCT_ACC8(16), VCT_ACC8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : VCT_ACC8(0), VCT_ACC8(8), VCT_ACC8(16), VCT_ACC8(24), VCT_ACC8(32), VCT_ACC8(40), VCT_ACC8(48), VCT_ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef VCT_ACC8

// The step for N columns a warpgroup with A from shared memory (bfloat16).
template <int N>
__device__ __forceinline__ void wgmma_step_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 32) {
    wgmma_bf16_ss_n32(d, da, db, 1);
  } else if constexpr (N == 64) {
    wgmma_bf16_ss_n64(d, da, db, 1);
  } else {
    static_assert(N == 128, "a warpgroup takes 32, 64 or 128 columns");
    wgmma_bf16_ss_n128(d, da, db, 1);
  }
}

// The step for N columns a warpgroup, in T's form (float32: one TF32 term).
template <typename T, int N>
__device__ __forceinline__ void wgmma_step(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  constexpr bool kF32 = sizeof(T) == 4;
  if constexpr (N == 32) {
    if constexpr (kF32) wgmma_tf32_n32(d, a, db, accumulate); else wgmma_bf16_n32(d, a, db, accumulate);
  } else if constexpr (N == 64) {
    if constexpr (kF32) wgmma_tf32_n64(d, a, db, accumulate); else wgmma_bf16_n64(d, a, db, accumulate);
  } else {
    static_assert(N == 128, "a warpgroup takes 32, 64 or 128 columns");
    if constexpr (kF32) wgmma_tf32_n128(d, a, db, accumulate); else wgmma_bf16_n128(d, a, db, accumulate);
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// relu(v + the residual at shared address a) for two adjacent outputs,
// in place, in T.
template <typename T>
__device__ __forceinline__ void store_out(uint32_t a, float v0, float v1) {
  if constexpr (sizeof(T) == 4) {
    float r0, r1;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(r0), "=f"(r1) : "r"(a));
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a), "f"(fmaxf(v0 + r0, 0.0f)),
                 "f"(fmaxf(v1 + r1, 0.0f)));
  } else {
    uint32_t bits;
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(bits) : "r"(a));
    const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bits));
    const __nv_bfloat162 o = __floats2bfloat162_rn(fmaxf(v0 + r.x, 0.0f), fmaxf(v1 + r.y, 0.0f));
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(*reinterpret_cast<const uint32_t*>(&o)));
  }
}

// y = relu(acc + bias) of this thread's outputs into Y of every CTA of a
// cluster of cs: row_at[mb][h] is the Y address of the thread's first
// column in row (mb, h), or 0 for a row not stored; bias points at that
// column's bias in shared memory. This code runs once a phase from a cold
// instruction cache, so it is kept short: the biases in registers, a row's
// values rounded and packed once, one store path for every cluster size
// (mapa, the CTAs in a loop that is not unrolled). Columns past Cm store
// zeros (their weights and biases are zero), as Y holds there already.
template <typename T, int MB, int NW>
__device__ __forceinline__ void store_y_rows(const float (&acc)[MB][NW / 2], const float* bias,
                                             const uint32_t (&row_at)[MB][2], int cs) {
  constexpr int ES = static_cast<int>(sizeof(T));
  float2 b[NW / 8];
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) b[j] = *reinterpret_cast<const float2*>(bias + 8 * j);
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row_at[mb][h] == 0) continue;
      if constexpr (ES == 4) {
        float2 v[NW / 8];
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
          v[j] = make_float2(fmaxf(acc[mb][4 * j + 2 * h] + b[j].x, 0.0f),
                             fmaxf(acc[mb][4 * j + 2 * h + 1] + b[j].y, 0.0f));
        }
#pragma unroll 1
        for (int q = 0; q < cs; ++q) {
          const uint32_t at = mapa(row_at[mb][h], q);
#pragma unroll
          for (int j = 0; j < NW / 8; ++j) {
            asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(at + 8 * j * ES),
                         "f"(v[j].x), "f"(v[j].y));
          }
        }
      } else {
        uint32_t v[NW / 8];
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
          const __nv_bfloat162 p = __hmax2(
              __floats2bfloat162_rn(acc[mb][4 * j + 2 * h] + b[j].x,
                                    acc[mb][4 * j + 2 * h + 1] + b[j].y),
              __float2bfloat162_rn(0.0f));
          v[j] = *reinterpret_cast<const uint32_t*>(&p);
        }
#pragma unroll 1
        for (int q = 0; q < cs; ++q) {
          const uint32_t at = mapa(row_at[mb][h], q);
#pragma unroll
          for (int j = 0; j < NW / 8; ++j) {
            asm volatile("st.shared::cluster.b32 [%0], %1;\n" ::"r"(at + 8 * j * ES), "r"(v[j]));
          }
        }
      }
    }
}

// The consumers' barrier number k: the 256 consumer threads of one CTA (cs
// = 1), or of every CTA of the cluster (each arrives, with release, on
// every CTA's bar[k % 2]; each waits on its own with acquire), so that the
// Y stores before it are seen by every CTA after it. The two barriers take
// turns: a thread's arrivals for k + 1 come after all its arrivals for k,
// so no CTA's barrier k can count an arrival of k + 2. The producer warp
// takes no part.
__device__ __forceinline__ void consumers_sync(uint64_t* bar, int cs, int* k) {
  const int n = (*k)++;
  if (cs == 1) {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    return;
  }
  for (int q = 0; q < cs; ++q) mbar_arrive_cluster(mapa(smem_addr(&bar[n % 2]), q));
  mbar_wait<true>(&bar[n % 2], (n / 2) & 1);
}

// The ring as the consumers see it: slot s at ring + s slot bytes, its
// full and empty barriers, and the stages it has.
struct Ring {
  uint32_t base;
  int stages, slot;
  uint64_t* full;
  uint64_t* empty;
};

// This lane's ldmatrix row address for k-step ks (32 bytes) of k-tile kt in
// row block mb, in phase PHASE: 1, the x box in the stage's slot (128-byte
// rows, swizzled as the TMA wrote them); 2, Y at the pixel's halo position
// (base[mb]) shifted to tap kt / nkc, channels (kt % nkc) KT ..; 3, Y at
// the pixel's row (base[mb]).
template <int PHASE, int MB>
__device__ __forceinline__ uint32_t a_address(int mb, int kt, int ks, uint32_t slot,
                                              const uint32_t (&base)[MB], int nkc, int hx,
                                              int yrow) {
  if constexpr (PHASE == 1) {
    const int lane = threadIdx.x % 32;
    const int r = mb * 64 + threadIdx.x / 32 % 4 * 16 + lane % 16, u = 2 * ks + lane / 16;
    return slot + r * 128 + ((u ^ (r & 7)) << 4);
  } else if constexpr (PHASE == 2) {
    const int tap = kt / nkc, cb = kt - tap * nkc;
    return base[mb] + ((tap / 3) * hx + tap % 3) * yrow + cb * 128 + ks * 32;
  } else {
    return base[mb] + kt * 128 + ks * 32;
  }
}

// acc = one output tile of (64 MB rows) x NS columns of phase PHASE
// (warpgroup wg takes columns wg NS / 2 ..), over nk k-tiles that arrive
// through the ring; *seq counts the stages taken. B is the stage's weight
// tile after the x region (MB1 blocks of 64 rows; float32: hi, then lo). A
// stage is released by each warp once its own products are done (a
// warpgroup's four warps run their rows of a wgmma on their own
// sub-partitions, so one warp's wait says nothing of the others'): `count`
// arrivals on this CTA's empty barrier, and with `remote` one on rank 0's.
// No callbacks: an epilogue passed in would not be inlined, and the
// accumulators would go through local memory. In bfloat16, phase 1 reads
// A (the x box, as the TMA wrote it) by descriptor too: with no A
// registers to reuse, a k-tile's products stay in flight while the next
// k-tile's are issued, and a slot is released one k-tile later.
template <typename T, int NS, int MB, int MB1, int PHASE>
__device__ __forceinline__ void k_loop(float (&acc)[MB][NS / 4], int nk, int* seq, const Ring& rg,
                                       uint32_t count, bool remote, const uint32_t (&base)[MB],
                                       int nkc, int hx, int yrow) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int NW = NS / 2;  // columns a warpgroup
  const int wg = threadIdx.x / 128;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[mb][i] = 0.0f;
  auto release = [&](int s) {
    __syncwarp();
    if (threadIdx.x % 32 == 0) {
      mbar_arrive(&rg.empty[s], count);
      if (remote) mbar_arrive_cluster(mapa(smem_addr(&rg.empty[s]), 0));
    }
  };
  constexpr bool kSS = PHASE == 1 && !kF32;
  int prev = -1;  // kSS: the slot whose products are still in flight
  for (int kt = 0; kt < nk; ++kt) {
    const int s = *seq % rg.stages;
    mbar_wait<false>(&rg.full[s], (*seq / rg.stages) & 1);
    ++*seq;
    const uint32_t slot = rg.base + s * rg.slot;
    const uint32_t bh = slot + MB1 * 8192 + wg * (NW / 8) * 1024;  // this warpgroup's rows
    if constexpr (kSS) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          wgmma_step_ss<NW>(acc[mb], wgmma_desc(slot + mb * 8192 + ks * 32),
                            wgmma_desc(bh + ks * 32));
        }
      }
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();
        release(prev);
      }
      prev = s;
      continue;
    }
    if constexpr (kF32) {
      float part[MB][NW / 2];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ah[MB][4], al[MB][4];
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          uint32_t a[4];
          ldsm_x4(a, a_address<PHASE, MB>(mb, kt, ks, slot, base, nkc, hx, yrow));
#pragma unroll
          for (int q = 0; q < 4; ++q) vct_tc::split_tf32(a[q], ah[mb][q], al[mb][q]);
        }
        wgmma_fence();
        const uint64_t dh = wgmma_desc(bh + ks * 32), dl = wgmma_desc(bh + NS * 128 + ks * 32);
        // Small terms first: lo . hi, hi . lo, then hi . hi.
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) wgmma_step<T, NW>(part[mb], al[mb], dh, ks > 0);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) wgmma_step<T, NW>(part[mb], ah[mb], dl, 1);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) wgmma_step<T, NW>(part[mb], ah[mb], dh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int i = 0; i < NW / 2; ++i) acc[mb][i] += part[mb][i];
    } else {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t a[MB][4];
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          ldsm_x4(a[mb], a_address<PHASE, MB>(mb, kt, ks, slot, base, nkc, hx, yrow));
        }
        wgmma_fence();
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          wgmma_step<T, NW>(acc[mb], a[mb], wgmma_desc(bh + ks * 32), 1);
        }
      }
      // The next k-tile's A fragments reuse these registers, which the
      // products read asynchronously: they must be done first.
      wgmma_commit();
      wgmma_wait<0>();
    }
    release(s);
  }
  if constexpr (kSS) {
    wgmma_wait<0>();
    if (prev >= 0) release(prev);
  }
}

// Thread 0: the residual of output boxes b0 .. b0 + round - 1 of tile nt
// into the x regions of slots 0 .. round - 1 by the TMA, on bar, once the
// last boxes' stores have read those regions.
__device__ __forceinline__ void load_residual(const CUtensorMap* map, const Ring& rg, int round,
                                              uint32_t box_bytes, int c0, int kt, int ox, int oy,
                                              int img0, uint64_t* bar) {
  if (threadIdx.x != 0) return;
  bulk_wait<true>();
  mbar_expect_tx(bar, round * box_bytes);
  for (int b = 0; b < round; ++b) {
    tma_4d(rg.base + b * rg.slot, map, c0 + b * kt, ox, oy, img0, bar);
  }
}

template <typename T, int NS, int MB1, int MB2>
__global__ void __launch_bounds__(kThreads, 1)
    fused_bottleneck_kernel(const __grid_constant__ Maps maps, const Args<T> a) {
  constexpr int KT = ktile<T>();
  constexpr int NW = NS / 2;
  constexpr int ES = static_cast<int>(sizeof(T));
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kSlack - (smem_addr(smem_raw) & (kSlack - 1))) & (kSlack - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [kMaxStages]
  uint64_t* empty = full + kMaxStages;                  // [kMaxStages]
  uint64_t* cbar = empty + kMaxStages;                  // [2]: the consumers' barriers
  uint64_t* rbar = cbar + 2;                            // an output tile's residual has landed
  const uint32_t ring = smem_addr(smem + kHead);
  unsigned char* Y = smem + kHead + a.stages * a.slot;
  const uint32_t y_addr = smem_addr(Y);
  // The biases, float32: b1 and b2 of this CTA's slice, b3 of its output
  // tiles (zeros past Cm, C and its nc channels).
  float* bias1 = reinterpret_cast<float*>(Y + a.npos * a.yrow);
  float* bias2 = bias1 + NS;
  float* bias3 = bias2 + NS;

  const int cs = a.cs;
  const int rank = cs > 1 ? static_cast<int>(cluster_ctarank()) : 0;
  const int item = blockIdx.x / cs;
  const int tile = item % a.tiles, img0 = item / a.tiles * a.ni;
  const int oy = tile / a.tiles_x * a.ty, ox = tile % a.tiles_x * a.tx;
  // The x box: the halo window, kept inside the image.
  const int by0 = min(max(oy - 1, 0), a.H - a.by), bx0 = min(max(ox - 1, 0), a.W - a.bx);
  const int c_lo = rank * NS, sw = min(NS, a.Cm - c_lo);
  const int co_lo = rank * a.nc, nco = min(a.nc, a.C - co_lo);
  const int nk1 = (a.C + KT - 1) / KT, nkc = (a.Cm + KT - 1) / KT, nk2 = 9 * nkc;
  const int nt3 = (a.nc + NS - 1) / NS;
  const int total = nk1 + nk2 + nt3 * nkc;
  const bool multicast = cs > 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      // A release a consumer warp; rank 0's slots in phase 1 are the whole
      // cluster's (multicast x).
      mbar_init(&empty[s], (kConsumers / 32) * (rank == 0 && multicast ? cs : 1));
    }
    mbar_init(&cbar[0], kConsumers * cs);
    mbar_init(&cbar[1], kConsumers * cs);
    mbar_init(rbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    uint4* z = reinterpret_cast<uint4*>(Y);
    const int n = a.npos * a.yrow / 16;
    for (int i = threadIdx.x; i < n; i += kThreads) z[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < (2 + nt3) * NS; i += kThreads) {
      float v = 0.0f;
      if (i < NS) {
        if (c_lo + i < a.Cm) v = to_f(a.b1[c_lo + i]);
      } else if (i < 2 * NS) {
        if (c_lo + i - NS < a.Cm) v = to_f(a.b2[c_lo + i - NS]);
      } else if (i - 2 * NS < nco) {
        v = to_f(a.b3[co_lo + i - 2 * NS]);
      }
      bias1[i] = v;
    }
  }
  if (cs > 1) {
    asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                     : "memory");
  } else {
    __syncthreads();
  }

  if (threadIdx.x >= kConsumers) {
    // The producer: every stage of the three phases, in order, as soon as
    // its slot is free, from one thread; its warpgroup gives its registers
    // to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != kConsumers) return;
    for (int i = 0; i < total; ++i) {
      const int s = i % a.stages, use = i / a.stages;
      if (use > 0) {
        if (rank == 0 && multicast) {
          mbar_wait<true>(&empty[s], (use - 1) & 1);
        } else {
          mbar_wait<false>(&empty[s], (use - 1) & 1);
        }
      }
      const uint32_t slot = ring + s * a.slot;
      const uint32_t wdst = slot + MB1 * 8192;
      const CUtensorMap *mh, *ml;
      int c0, c1, c2 = -1;
      if (i < nk1) {  // x and w1
        mbar_expect_tx(&full[s], a.xbytes + a.wbytes);
        if (!multicast) {
          tma_4d(slot, &maps.x, i * KT, bx0, by0, img0, &full[s]);
        } else if (rank == 0) {
          tma_4d_multicast(slot, &maps.x, i * KT, bx0, by0, img0, &full[s],
                           static_cast<uint16_t>((1u << cs) - 1));
        }
        mh = &maps.w1, ml = &maps.w1l, c0 = i * KT, c1 = c_lo;
      } else if (i < nk1 + nk2) {  // w2: tap j / nkc, channels (j % nkc) KT ..
        const int j = i - nk1;
        mbar_expect_tx(&full[s], a.wbytes);
        mh = &maps.w2, ml = &maps.w2l, c0 = j % nkc * KT, c1 = j / nkc, c2 = c_lo;
      } else {  // w3: output tile j / nkc, k-tile j % nkc
        const int j = i - nk1 - nk2;
        mbar_expect_tx(&full[s], a.wbytes);
        mh = &maps.w3, ml = &maps.w3l, c0 = j % nkc * KT, c1 = co_lo + j / nkc * NS;
      }
      for (int part = 0; part < wparts<T>(); ++part) {
        const CUtensorMap* m = part == 0 ? mh : ml;
        const uint32_t dst = wdst + part * NS * 128;
        if (c2 >= 0) {
          tma_3d(dst, m, c0, c1, c2, &full[s]);
        } else {
          tma_2d(dst, m, c0, c1, &full[s]);
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg, warp wi of it, lane (g, t).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = threadIdx.x % 32, wi = threadIdx.x / 32 % 4, wg = threadIdx.x / 128;
  const int g = lane / 4, t = lane % 4;
  const int P = a.ty * a.tx;
  const Ring rg = {ring, a.stages, a.slot, full, empty};
  int seq = 0;
  int syncs = 0;  // the consumers' barriers passed
  const uint32_t own = rank == 0 && multicast ? cs : 1;  // arrivals a warp's release, phases 2-3
  const int col_y = (c_lo + wg * NW + 2 * t) * ES;  // this thread's first y column's bytes

  // 1. y1 over the x box, into Y of every CTA.
  {
    float acc[MB1][NW / 2];
    const uint32_t unused[MB1] = {};
    k_loop<T, NS, MB1, MB1, 1>(acc, nk1, &seq, rg, 1, multicast && rank != 0, unused, nkc, a.HX,
                               a.yrow);
    uint32_t row_at[MB1][2];
#pragma unroll
    for (int mb = 0; mb < MB1; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // Box row r's halo position; rows past the box, images past B and
        // positions outside the halo window are not stored.
        const int r = mb * 64 + wi * 16 + g + 8 * h;
        const int i = r / (a.by * a.bx), rr = r - i * a.by * a.bx;
        const int hy = by0 + rr / a.bx - oy + 1, hx = bx0 + rr % a.bx - ox + 1;
        const bool in = r < a.M1 && img0 + i < a.B && hy >= 0 && hy < a.HY && hx >= 0 && hx < a.HX;
        row_at[mb][h] = in ? y_addr + ((i * a.HY + hy) * a.HX + hx) * a.yrow + col_y : 0u;
      }
    store_y_rows<T, MB1, NW>(acc, bias1 + wg * NW + 2 * t, row_at, cs);
  }
  consumers_sync(cbar, cs, &syncs);  // every CTA holds y1

  // Row mb of this lane's ldmatrix rows in phases 2-3: pixel r (row 0 past
  // M2), its halo position's Y address and its row's.
  uint32_t pos_addr[MB2], pix_addr[MB2];
#pragma unroll
  for (int mb = 0; mb < MB2; ++mb) {
    const int r0 = mb * 64 + wi * 16 + lane % 16, r = r0 < a.M2 ? r0 : 0;
    const int i = r / P, rr = r - i * P;
    pos_addr[mb] = y_addr + ((i * a.HY + rr / a.tx) * a.HX + rr % a.tx) * a.yrow + lane / 16 * 16;
    pix_addr[mb] = y_addr + r * a.yrow + lane / 16 * 16;
  }

  // 2. y2 = relu(conv3x3(y1) + b2): k-tile kt is tap kt / nkc of the
  // channels (kt % nkc) KT .., w2's channels_last row order.
  {
    float acc[MB2][NW / 2];
    k_loop<T, NS, MB2, MB1, 2>(acc, nk2, &seq, rg, own, false, pos_addr, nkc, a.HX, a.yrow);
    uint32_t row_at[MB2][2];
#pragma unroll
    for (int mb = 0; mb < MB2; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mb * 64 + wi * 16 + g + 8 * h;
        row_at[mb][h] = r < a.M2 ? y_addr + r * a.yrow + col_y : 0u;
      }
    consumers_sync(cbar, cs, &syncs);  // no CTA still reads y1
    store_y_rows<T, MB2, NW>(acc, bias2 + wg * NW + 2 * t, row_at, cs);
  }
  consumers_sync(cbar, cs, &syncs);  // every CTA holds y2

  // 3. out = relu(y2 . W3^T + b3 + x) for output channels co_lo .., in
  // tiles of NS. A tile's output goes out by the TMA from the x regions of
  // the ring's slots (idle after phase 1), a box of a 128-byte row of
  // channels over the item's pixels a slot, `round` boxes at a time: thread
  // 0 loads the boxes' residual there by the TMA (the first round's while
  // the tile's products run), every thread adds its outputs' bias and
  // residual in place, and thread 0 stores the boxes by the TMA.
  {
    constexpr int NB = NS / KT;  // boxes a tile
    const int round = min(NB, a.stages);
    const uint32_t box_bytes = a.M2 * 128;
    uint32_t rphase = 0;
    for (int nt = 0; nt < nt3; ++nt) {
      load_residual(&maps.xo, rg, round, box_bytes, co_lo + nt * NS, KT, ox, oy, img0, rbar);
      float acc[MB2][NW / 2];
      k_loop<T, NS, MB2, MB1, 3>(acc, nkc, &seq, rg, own, false, pix_addr, nkc, a.HX, a.yrow);
      const float2* bias = reinterpret_cast<const float2*>(bias3 + nt * NS + wg * NW + 2 * t);
      for (int b0 = 0; b0 < NB; b0 += round) {
        if (b0 > 0) {
          load_residual(&maps.xo, rg, round, box_bytes, co_lo + nt * NS + b0 * KT, KT, ox, oy,
                        img0, rbar);
        }
        mbar_wait<false>(rbar, rphase);
        rphase ^= 1;
        // Rows past M2 lie in the regions but outside the stored boxes.
#pragma unroll
        for (int mb = 0; mb < MB2; ++mb)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = mb * 64 + wi * 16 + g + 8 * h;
#pragma unroll
            for (int j = 0; j < NW / 8; ++j) {
              const int n = wg * NW + 8 * j + 2 * t, b = n / KT;  // column n of the tile
              if (b < b0 || b >= b0 + round) continue;
              const uint32_t col = (n % KT) * ES;  // the pair's byte in its row
              store_out<T>(ring + (b - b0) * a.slot + r * 128 + (((col >> 4) ^ (r & 7)) << 4) +
                               (col & 15),
                           acc[mb][4 * j + 2 * h] + bias[4 * j].x,
                           acc[mb][4 * j + 2 * h + 1] + bias[4 * j].y);
            }
          }
        fence_proxy_async();
        asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
        if (threadIdx.x == 0) {
          for (int b = b0; b < b0 + round; ++b) {
            if (nt * NS + b * KT < nco) {
              tma_store_4d(&maps.out, co_lo + nt * NS + b * KT, ox, oy, img0,
                           ring + (b - b0) * a.slot);
            }
          }
          bulk_commit();
        }
      }
    }
    if (threadIdx.x == 0) bulk_wait<false>();  // the stores are done before the CTA exits
  }
}

// float32 weights into their TF32 hi and lo parts (tf32x3.cuh's split):
// segment j of three, n[j] values from w[j] into hi[j] and lo[j].
struct SplitArgs {
  const float* w[3];
  float* hi[3];
  float* lo[3];
  size_t n[3];
};

__global__ void split_tf32_kernel(const SplitArgs s) {
  for (int j = 0; j < 3; ++j) {
    for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < s.n[j];
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
      uint32_t h, l;
      vct_tc::split_tf32(__float_as_uint(s.w[j][i]), h, l);
      s.hi[j][i] = __uint_as_float(h);
      s.lo[j][i] = __uint_as_float(l);
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time by cudaGetDriverEntryPoint
// (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A tensor map of `rank` dims (innermost first, strides in bytes of dims 1
// ..), boxes of `box`, 128-byte swizzled, zeros outside.
template <typename T>
int encode_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
               const cuuint64_t* strides, const cuuint32_t* box) {
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
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult rc = encode(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// w1 (C, Cm), w2 (Cm, 9, Cm) and w3 (Cm, C) as maps in boxes of a k-tile
// by ns rows.
template <typename T>
int weight_maps(CUtensorMap* m1, CUtensorMap* m2, CUtensorMap* m3, const T* w1, const T* w2,
                const T* w3, int C, int Cm, int ns) {
  const cuuint64_t es = sizeof(T);
  const cuuint32_t kt = ktile<T>(), rows = static_cast<cuuint32_t>(ns);
  const cuuint64_t d1[2] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(Cm)};
  const cuuint64_t s1[1] = {C * es};
  const cuuint32_t b1[2] = {kt, rows};
  const cuuint64_t d2[3] = {static_cast<cuuint64_t>(Cm), 9, static_cast<cuuint64_t>(Cm)};
  const cuuint64_t s2[2] = {Cm * es, 9 * Cm * es};
  const cuuint32_t b2[3] = {kt, 1, rows};
  const cuuint64_t d3[2] = {static_cast<cuuint64_t>(Cm), static_cast<cuuint64_t>(C)};
  const cuuint64_t s3[1] = {Cm * es};
  int rc = encode_map<T>(m1, w1, 2, d1, s1, b1);
  if (rc == 0) rc = encode_map<T>(m2, w2, 3, d2, s2, b2);
  if (rc == 0) rc = encode_map<T>(m3, w3, 2, d3, s3, b1);
  return rc;
}

template <typename T, int NS, int MB1, int MB2>
int launch_inst(const Maps& maps, const Args<T>& args, size_t smem, int grid, cudaStream_t st) {
  auto kernel = fused_bottleneck_kernel<T, NS, MB1, MB2>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = args.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, maps, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Whether the kernel is built for (ns, mb1, mb2) in T's form.
template <typename T>
bool has_instance(int ns, int mb1, int mb2) {
#define VCT_HAS(n, m1, m2) \
  if (ns == n && mb1 == m1 && mb2 == m2) return true;
  if constexpr (sizeof(T) == 4) {
    VCT_FB_F32(VCT_HAS)
  } else {
    VCT_FB_BF16(VCT_HAS)
  }
#undef VCT_HAS
  return false;
}

template <typename T>
int launch_planned(const Plan& p, const Maps& maps, const Args<T>& args, size_t smem, int grid,
                   cudaStream_t st) {
#define VCT_LAUNCH(n, m1, m2) \
  if (p.ns == n && p.mb1 == m1 && p.mb2 == m2) return launch_inst<T, n, m1, m2>(maps, args, smem, grid, st);
  if constexpr (sizeof(T) == 4) {
    VCT_FB_F32(VCT_LAUNCH)
  } else {
    VCT_FB_BF16(VCT_LAUNCH)
  }
#undef VCT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

// The plan's shapes when it fits the kernel and the card, else false.
template <typename T>
bool validate(const Plan& p, int B, int H, int W, int C, int Cm, Geo* g) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cm <= 0 || C % 8 != 0 || Cm % 8 != 0) return false;
  if (p.cs < 1 || p.cs > kMaxCluster || p.cs * p.ns < Cm || (p.cs - 1) * p.ns >= Cm) return false;
  if (!has_instance<T>(p.ns, p.mb1, p.mb2)) return false;
  if (p.ni < 1 || p.ni > B || p.ty < 1 || p.ty > H || p.tx < 1 || p.tx > W) return false;
  if (p.ni > 1 && (p.ty != H || p.tx != W)) return false;
  if (p.stages < 2 || p.stages > kMaxStages) return false;
  *g = geometry(p, B, H, W, C, static_cast<int>(sizeof(T)), wparts<T>());
  if (g->M1 > 64 * p.mb1 || g->M2 > 64 * p.mb2) return false;
  if (g->bx > 256 || g->by > 256 || g->bi > 256 || p.tx > 256 || p.ty > 256) return false;
  return g->smem <= kSmemMax;
}

template <typename T>
int launch(const T* x, const T* w1, const T* b1, const T* w2, const T* b2, const T* w3,
           const T* b3, T* out, int B, int H, int W, int C, int Cm, const int* plan, float* scratch,
           void* stream) {
  const Plan p = {plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6], plan[7]};
  Geo g;
  if (!validate<T>(p, B, H, W, C, Cm, &g)) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {x, w1, w2, w3, out};
  for (const void* q : ptrs) {
    if (!aligned16(q)) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Maps maps = {};
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dx[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                            static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t sx[3] = {C * es, W * C * es, H * W * C * es};
  const cuuint32_t bx[4] = {static_cast<cuuint32_t>(ktile<T>()), static_cast<cuuint32_t>(g.bx),
                            static_cast<cuuint32_t>(g.by), static_cast<cuuint32_t>(g.bi)};
  const cuuint32_t bo[4] = {static_cast<cuuint32_t>(ktile<T>()), static_cast<cuuint32_t>(p.tx),
                            static_cast<cuuint32_t>(p.ty), static_cast<cuuint32_t>(p.ni)};
  int rc = encode_map<T>(&maps.x, x, 4, dx, sx, bx);
  if (rc == 0) rc = encode_map<T>(&maps.xo, x, 4, dx, sx, bo);
  if (rc == 0) rc = encode_map<T>(&maps.out, out, 4, dx, sx, bo);
  if (rc != 0) return rc;
  const size_t n1 = static_cast<size_t>(Cm) * C, n2 = static_cast<size_t>(Cm) * 9 * Cm;
  if constexpr (sizeof(T) == 4) {
    if (scratch == nullptr || !aligned16(scratch)) return static_cast<int>(cudaErrorInvalidValue);
    // scratch: w1 hi, w1 lo, w2 hi, w2 lo, w3 hi, w3 lo (each rounded up to
    // 4 floats, so every part stays 16-byte aligned).
    auto up4 = [](size_t n) { return (n + 3) / 4 * 4; };
    float* w1h = scratch;
    float* w1l = w1h + up4(n1);
    float* w2h = w1l + up4(n1);
    float* w2l = w2h + up4(n2);
    float* w3h = w2l + up4(n2);
    float* w3l = w3h + up4(n1);
    const SplitArgs sa = {{w1, w2, w3}, {w1h, w2h, w3h}, {w1l, w2l, w3l}, {n1, n2, n1}};
    split_tf32_kernel<<<264, 256, 0, st>>>(sa);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    rc = weight_maps<float>(&maps.w1, &maps.w2, &maps.w3, w1h, w2h, w3h, C, Cm, p.ns);
    if (rc == 0) rc = weight_maps<float>(&maps.w1l, &maps.w2l, &maps.w3l, w1l, w2l, w3l, C, Cm, p.ns);
  } else {
    rc = weight_maps<T>(&maps.w1, &maps.w2, &maps.w3, w1, w2, w3, C, Cm, p.ns);
  }
  if (rc != 0) return rc;
  const Args<T> args = {b1, b2, b3, B, H, W, C, Cm, p.cs, p.ni, p.ty, p.tx, p.stages,
                        g.bx, g.by, g.HY, g.HX, g.npos, g.M1, g.M2, g.tiles_x, g.tiles, g.nc,
                        static_cast<int>(g.yrow), static_cast<int>(g.slot),
                        g.M1 * 128, p.ns * 128 * wparts<T>()};
  return launch_planned<T>(p, maps, args, g.smem, g.items * p.cs, st);
}

// Clusters of cs CTAs of the kernel the card runs at once at the most
// shared memory a CTA may take (one CTA an SM, as every plan runs).
template <typename T>
int active_clusters(int cs, int* out) {
  if (cs < 1 || cs > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fused_bottleneck_kernel<T, 64, 1, 1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemMax));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemMax;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kernel, &cfg));
}

}  // namespace

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// cudaOccupancyMaxActiveClusters of the kernel in float32 (f32 = 1) or
// bfloat16 form at clusters of cs CTAs, into *out. Returns a cudaError_t.
extern "C" int vct_fused_bottleneck_active_clusters(int f32, int cs, int* out) {
  return f32 ? active_clusters<float>(cs, out) : active_clusters<__nv_bfloat16>(cs, out);
}

// One launch under plan = {cluster size, channels a CTA, images an item,
// tile rows, tile columns, ring stages, row blocks of phase 1, of phases
// 2-3} (ops/bottleneck.py:kernel_plan); a plan that does not fit is
// refused (cudaErrorInvalidValue) and nothing runs. float32 takes scratch
// for w's TF32 parts: 2 (ceil4(Cm C) 2 + ceil4(9 Cm^2)) floats, 16-byte
// aligned. Each returns a cudaError_t: 0 when the launch was accepted.
extern "C" int vct_fused_bottleneck_f32(const float* x, const float* w1, const float* b1,
                                        const float* w2, const float* b2, const float* w3,
                                        const float* b3, float* out, int B, int H, int W, int C,
                                        int Cm, const int* plan, float* scratch, void* stream) {
  return launch<float>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, Cm, plan, scratch, stream);
}

extern "C" int vct_fused_bottleneck_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w1,
                                         const __nv_bfloat16* b1, const __nv_bfloat16* w2,
                                         const __nv_bfloat16* b2, const __nv_bfloat16* w3,
                                         const __nv_bfloat16* b3, __nv_bfloat16* out, int B,
                                         int H, int W, int C, int Cm, const int* plan,
                                         float* scratch, void* stream) {
  return launch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, Cm, plan, scratch,
                               stream);
}
