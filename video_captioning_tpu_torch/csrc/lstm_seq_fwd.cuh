// The masked LSTM forward recurrence shared by csrc/lstm_seq.cu (eval) and
// csrc/lstm_seq_train.cu (training, which also streams out the residuals
// its backward reads), and the tensor-core, copy and barrier primitives
// both sources use. Contract: see those files' headers.
//
// Replaces (with lstm_seq.cu): video_captioning_tpu/ops/lstm_seq_pallas.py,
// _kernel (lstm_seq_pallas) and _fwd_train_kernel (lstm_seq_train's
// forward).
//
// What bounds it on an H100: the 80 sequential steps, each of which needs
// the whole previous h of its direction. The work of a step is small
// (2 x 128 x 512 x 2048 bf16 multiply-adds at the encoder's shape: about
// 1 us of tensor-core time spread over the card), so a step costs its
// exchange: publishing h, meeting the other CTAs of the direction, reading
// B x H bf16 of h back through L2, and the gate math on inputs read from
// device memory. Variants of the first narrow design (probe_lstm.py,
// NVIDIA H100 80GB HBM3, 700 W; 11.4 us a step at (80, 2, 128, 2048)):
// without products a step took 10.4 us, products on stale h with no
// copies, wait or publish 6.9, the counter wait with the gate math alone
// 7.2; so the products are about 1 us, and the copies of h, which both of
// an SM's CTAs of 8 units made, the rest beside the wait.
//
// Design: CTA (d, j0) owns hidden units j0..j0+15 of direction d with all
// four gates (64 gate columns), for a slice of up to nb batch rows, for all
// T steps, one CTA an SM (FwdTile, one instantiation, Fwd, for every H).
// Its W_hh slice (H x 64 bf16) stays in registers as mma.sync B fragments,
// spread over 16 warps (512 threads): 8 along K times 2 along the columns
// (warp (kw, nw) owns k-tiles kw, kw + 8, ... for 4 n-tiles), so every
// warp works at every B, B = 1 included. Each step, once the direction's
// counter says h is published, every thread issues its 16-byte cp.async
// share of the step's 32-row h chunks (through L2 only) into a ring of the
// plan's slots (ops/lstm_seq.py:fwd_wide_plan), each slot completing on an
// mbarrier that counts every thread's copies, a freed slot refilled at
// once; m16n8k16 bf16 products with float32 accumulators (A fragments by
// ldmatrix); the 8 K-slices' partial sums meet in shared memory (rows
// padded to 72 floats: the float2 stores hit distinct banks) and are added
// in warp order; the gate math runs in float32, one (row, unit) a thread.
// The float32 h and c of the CTA's (rows, units) stay in shared memory for
// all T steps. It publishes bf16 h to a two-slot exchange buffer and meets
// only the CTAs that share its rows (its direction and row group), at a
// counter in device memory (release add, acquire spin): the directions and
// row groups never wait for each other. The rows are split into as many
// row groups as stay co-resident (2 x 2 x 32 CTAs at H = 512). Units past
// H are masked. Step 0 reads no h (it is zero). The launch is cooperative
// only so that the CTAs that meet are co-resident; rows beyond what fits
// run as further launches (rows are independent).
//
// The first narrow design (8 units and 8 warps a CTA, two CTAs an SM, two
// chunks in flight by cp.async groups) read each h row twice an SM; this
// one keeps its bits (the same k-tiles a warp, the same order of the
// partial sums) and took 0.69 ms against 0.89 at (80, 2, 128, 2048) and
// 0.33 against 0.40 at B = 32 (compare_lstm.py, NVIDIA H100 80GB HBM3,
// 700 W). Staging the next step's xproj in shared memory by cp.async
// moved nothing measurable and was dropped. The first wide form (8 warps
// of 128 registers of W_hh, spills, two 16-row chunks in flight) was
// slower too (PERF.md).
//
// Why not one thread-block cluster per direction with h exchanged through
// distributed shared memory: W_hh of one direction is 2 MB in bf16 at
// H = 512 (2.9 MB at H = 600), so a cluster would need 16 CTAs
// (non-portable, one GPC each), and it would put a direction's whole step
// on 16 SMs. The counters keep the whole card at work and take every H up
// to 1024.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace vct {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHidden = 600;        // the narrow backward sweep's largest H
constexpr int kMaxWideHidden = 1024;   // the kernels' limit
constexpr size_t kMaxSmem = 232448;  // 227 KB a block on Hopper

// ---------------------------------------------------------------- primitives

// d += a . b for one m16n8k16 tile: bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory: lane L gives the address of
// row L % 8 of matrix L / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Two bf16 in one register, lo in the low half (the lower k of a fragment).
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// 16 bytes global -> shared, through L2 only: other CTAs wrote the source
// during this launch, so L1 may hold stale lines.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A barrier of the CTAs of one direction. After a __syncthreads, one
// thread publishes the CTA's writes (fence, then add); a waiting thread
// spins with acquire loads and the CTA follows it through a __syncthreads.
// A step takes microseconds: a wait of 2^34 cycles (seconds) means a CTA
// of the direction is gone, and the kernel traps rather than hang the card.
__device__ __forceinline__ void dir_arrive(unsigned* counter) {
  __threadfence();
  atomicAdd(counter, 1u);
}
__device__ __forceinline__ void dir_wait(const unsigned* counter, unsigned target) {
  const long long start = clock64();
  unsigned v;
  for (;;) {
    asm volatile("ld.acquire.gpu.u32 %0, [%1];\n" : "=r"(v) : "l"(counter) : "memory");
    if (v >= target) break;
    if (clock64() - start > (1ll << 34)) __trap();
  }
  __threadfence();
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// One arrival on bar once every cp.async this thread has issued has landed
// (bar's count includes these arrivals).
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
// Wait for the phase of bar with this parity to complete; a copy that
// never lands traps after about 2^28 tries (seconds) instead of holding
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (long tries = 0; !done; ++tries) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (tries > (1L << 28)) __trap();
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}


// The batch rows of CTA `blockIdx.x` in a grid of (direction, row group,
// unit group): rows [b0, b0 + n) of the launch's slice. The CTAs of one
// (direction, row group) depend on each other; no others do.
struct RowRange {
  int d, group, unit_group, b0, n;
};
template <typename P>
__device__ __forceinline__ RowRange row_range(const P& p, int unit_groups) {
  RowRange r;
  r.unit_group = blockIdx.x % unit_groups;
  r.group = (blockIdx.x / unit_groups) % p.row_groups;
  r.d = blockIdx.x / (unit_groups * p.row_groups);
  r.b0 = p.b0 + r.group * p.nb;
  r.n = min(p.nb, p.b0 + p.slice_rows - r.b0);
  return r;
}

// Cooperative launches of ND x row_groups x unit_groups CTAs. The row
// groups split the B rows among CTAs that run side by side: the most row
// groups (each of at least min_rows rows) whose grid stays co-resident. If
// even one row group a direction does not fit, the rows run as sequential
// slices, halved until they fit. Each launch zeroes its ND x row_groups
// counters (sync holds ND x B) first. P has fields B, ND, b0, nb,
// slice_rows, row_groups and sync. Consecutive runs of `cluster` CTAs
// (unit_groups a multiple of it) form thread block clusters when cluster >
// 1; co-residency is counted in clusters (of 1 CTA otherwise). Returns a
// cudaError_t.
template <typename K, typename P, typename SmemOf>
int launch_recurrence(K* kernel_fn, P p, int unit_groups, int min_rows, SmemOf smem_of,
                      cudaStream_t stream, int threads = kThreads, int cluster = 1) {
  cudaError_t e = cudaFuncSetAttribute(kernel_fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(kMaxSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, coop = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  cudaLaunchAttribute attrs[2] = {};
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  // Whether `groups` row groups of `rows` rows each are co-resident.
  auto fits = [&](int groups, int rows, bool* ok) -> cudaError_t {
    const size_t smem = smem_of(rows);
    *ok = false;
    if (smem > kMaxSmem) return cudaSuccess;
    cfg.gridDim = dim3(p.ND * groups * unit_groups);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attrs;
    cfg.numAttrs = 1;  // the cluster shape
    int clusters = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel_fn, &cfg);
    *ok = clusters * cluster >= p.ND * groups * unit_groups;
    return err;
  };
  bool ok = false;
  int groups = p.B / min_rows > 1 ? p.B / min_rows : 1;
  int rows = 0;
  for (; groups >= 1; --groups) {
    rows = (p.B + groups - 1) / groups;
    if ((e = fits(groups, rows, &ok)) != cudaSuccess) return static_cast<int>(e);
    if (ok) break;
  }
  int slice = p.B;
  if (!ok) {  // one row group; rows in sequential slices
    groups = 1;
    while (!ok) {
      if (slice <= min_rows) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
      slice = (slice + 1) / 2;
      if ((e = fits(1, slice, &ok)) != cudaSuccess) return static_cast<int>(e);
    }
    rows = slice;
  }
  p.row_groups = groups;
  p.nb = rows;
  cfg.gridDim = dim3(p.ND * groups * unit_groups);
  cfg.dynamicSmemBytes = smem_of(rows);
  // Cooperative, and the cluster shape only where there are clusters.
  cfg.attrs = cluster > 1 ? attrs : attrs + 1;
  cfg.numAttrs = cluster > 1 ? 2 : 1;
  for (int b0 = 0; b0 < p.B; b0 += slice) {
    p.b0 = b0;
    p.slice_rows = p.B - b0 < slice ? p.B - b0 : slice;
    if ((e = cudaMemsetAsync(p.sync, 0, sizeof(unsigned) * p.ND * groups, stream)) !=
        cudaSuccess)
      return static_cast<int>(e);
    if ((e = cudaLaunchKernelEx(&cfg, kernel_fn, p)) != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ forward

constexpr int kUnits = 8;             // the kernels take H a multiple of this
constexpr int kFwdRows = 32;          // batch rows of h staged per chunk

// The forward's tiling: Units hidden units a CTA (4 x Units gate columns),
// Rows batch rows of h a staged chunk (Units x Rows = Threads: one epilogue
// item a thread), Threads / 32 warps: Nw along the gate columns (4 Units /
// 8 / Nw n-tiles a warp) times Kw = Threads / 32 / Nw along K (Kt k-tiles of
// W_hh a warp, held in registers; the Kw partial sums meet in shared
// memory, rows PartPad floats longer than the columns, so that their float2
// stores hit distinct banks), MinBlocks CTAs an SM. h arrives through the
// plan's ring of chunk slots, each completing on an mbarrier.
template <int Units, int Rows, int Kt, int MinBlocks, int PartPad, int Threads, int Nw>
struct FwdTile {
  static constexpr int kUnits = Units;
  static constexpr int kRows = Rows;
  static constexpr int kKt = Kt;
  static constexpr int kMinBlocks = MinBlocks;
  static constexpr int kThreads = Threads;
  static constexpr int kKw = Threads / 32 / Nw;
  static constexpr int kNt = 4 * Units / 8 / Nw;
  static constexpr int kMt = Rows / 16;
  static constexpr int kPartStride = 4 * Units + PartPad;
  static_assert(Units * Rows == Threads, "one epilogue item a thread");
  static_assert(PartPad % 2 == 0, "float2 partial stores");
};
// 16 units a CTA (64 gate columns, so 2 x 64 CTAs at H = 1024 are
// co-resident one an SM on 132 SMs), 16 warps: 8 along K times 2 along the
// columns, so the CTA's W_hh slice (H x 64 bf16) is Kt k-tiles x 4 n-tiles
// of B fragments a warp; h staged 32 rows a chunk through a ring of up to
// kMaxRing chunk slots (ops/lstm_seq.py:fwd_wide_plan). 8 k-tiles a warp
// (64 registers a thread) cover H = 1024; below it a warp's k-tiles past H
// are skipped, so the k-tiles a warp and the order of the partial sums
// are the same at every H.
using Fwd = FwdTile<16, kFwdRows, (kMaxWideHidden / 16) / 8, 1, 8, 512, 2>;
constexpr int kMaxRing = 16;

struct FwdParams {
  const void* xproj;           // (T, ND, B, 4H), float32 or bf16
  const __nv_bfloat16* w_hh;   // (ND, H, 4H)
  const float* mask;           // (B, T), 1 = valid; nullptr = all valid
  void* outs;                  // (T, ND, B, H), xproj's type
  void* h_last;                // (ND, B, H)
  void* c_last;                // (ND, B, H)
  __nv_bfloat16* hbuf;         // (2, ND, B, H) exchange of bf16 h
  unsigned* sync;              // (ND, B) counters; ND x row_groups used
  void* gact;                  // residuals (training only): (T, ND, B, 4H)
                               // activated gates [i, f, g, o], xproj's type
  float* h_keep;               // (T, ND, B, H) carried h after step t
  float* c_keep;               // (T, ND, B, H) carried c after step t
  int T, ND, B, H;
  int b0, slice_rows;          // this launch's batch rows
  int nb, row_groups;          // rows a CTA (at most), row groups a direction
  int ring;                    // h chunk slots (the plan's)
};

__host__ __device__ inline int fwd_kpad(int H) { return (H + 15) / 16 * 16; }

// The ring's mbarriers, the h chunk slots (row stride kpad + 8 bf16:
// ldmatrix rows in distinct banks), the Kw partial sums and the float32 h
// and c of nb rows. ops/lstm_seq.py:fwd_wide_smem mirrors it.
__host__ __device__ inline int fwd_bar_bytes(int ring) { return (8 * ring + 15) / 16 * 16; }
template <typename Tile>
inline size_t fwd_smem_bytes(int H, int nb, int ring) {
  return static_cast<size_t>(fwd_bar_bytes(ring)) +
         static_cast<size_t>(ring * Tile::kRows) * (fwd_kpad(H) + 8) * 2 +
         static_cast<size_t>(Tile::kKw) * Tile::kRows * Tile::kPartStride * 4 +
         static_cast<size_t>(nb) * Tile::kUnits * 8;
}

template <typename T, bool kResiduals, typename Tile>
__global__ void __launch_bounds__(Tile::kThreads, Tile::kMinBlocks)
    lstm_seq_fwd_kernel(FwdParams p) {
  constexpr int kThreads = Tile::kThreads;  // shadows the file's: this tile's
  constexpr int kKw = Tile::kKw;
  constexpr int U = Tile::kUnits;
  constexpr int R = Tile::kRows;
  constexpr int PS = Tile::kPartStride;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H;
  const int H4 = 4 * H;
  const int kpad = fwd_kpad(H);
  const int hstride = kpad + 8;
  const int KT = kpad / 16;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [ring]
  __nv_bfloat16* hs =
      reinterpret_cast<__nv_bfloat16*>(smem + fwd_bar_bytes(p.ring));  // [ring][R][hstride]
  float* part = reinterpret_cast<float*>(hs + p.ring * R * hstride);
  float* st_h = part + kKw * R * PS;  // [nb][U]
  float* st_c = st_h + p.nb * U;

  const int unit_groups = (H + U - 1) / U;
  const RowRange rr = row_range(p, unit_groups);
  const int d = rr.d;
  const int j0 = rr.unit_group * U;
  unsigned* counter = p.sync + d * p.row_groups + rr.group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kw = warp % kKw;  // this warp's k-tiles: kw, kw + kKw, ...
  const int nw = warp / kKw;  // and n-tiles: nw * kNt .. nw * kNt + kNt - 1
  const int g = lane >> 2;
  const int tq = lane & 3;

  // B fragments of this warp's k-tiles: B[k][n] = W_hh[d][k][gate, unit
  // j0 + u] for gate column n = gate * U + u (n-tile nt holds gate
  // nt / (U / 8)); zero past H in k and in the units.
  uint32_t wf[Tile::kKt][Tile::kNt][2];
  const __nv_bfloat16* w = p.w_hh + static_cast<size_t>(d) * H * H4;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
  for (int i = 0; i < Tile::kKt; ++i) {
    const int kt = kw + i * kKw;
#pragma unroll
    for (int nt = 0; nt < Tile::kNt; ++nt) {
      const int ntg = nw * Tile::kNt + nt;
      const int unit = j0 + (ntg % (U / 8)) * 8 + g;
      const int col = (ntg / (U / 8)) * H + unit;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = kt * 16 + half * 8 + 2 * tq;
        const bool in = kt < KT && unit < H;
        const __nv_bfloat16 lo = in && k < H ? w[static_cast<size_t>(k) * H4 + col] : zero;
        const __nv_bfloat16 hi = in && k + 1 < H ? w[static_cast<size_t>(k + 1) * H4 + col] : zero;
        wf[i][nt][half] = pack2(lo, hi);
      }
    }
  }
  // Zero k columns past H (never copied into) and the carried state.
  const int kx = kpad - H;
  for (int e = tid; e < p.ring * R * kx; e += kThreads) {
    hs[(e / kx) * hstride + H + e % kx] = zero;
  }
  for (int e = tid; e < rr.n * U; e += kThreads) {
    st_h[e] = 0.0f;
    st_c[e] = 0.0f;
  }
  if (tid == 0) {
    for (int i = 0; i < p.ring; ++i) mbar_init(&bars[i], kThreads);
  }
  __syncthreads();

  const T* xproj = static_cast<const T*>(p.xproj);
  T* outs = static_cast<T*>(p.outs);
  const int n_chunks = (rr.n + R - 1) / R;
  const int er = tid / U;  // epilogue: chunk row
  const int eu = tid % U;  // epilogue: unit
  const int j = j0 + eu;
  const bool unit_in = j < H;
  const int vecs = H / 8;  // 16-byte vectors of an h row
  // Ring: the chunks of steps 1 .. T - 1 in order; chunk g lands in slot
  // g % ring, for the (g / ring)-th time.
  unsigned gbase = 0;

  for (int t = 0; t < p.T; ++t) {
    const __nv_bfloat16* hcur =
        p.hbuf + (static_cast<size_t>(t & 1) * p.ND + d) * p.B * H;
    __nv_bfloat16* hnxt =
        p.hbuf + (static_cast<size_t>((t + 1) & 1) * p.ND + d) * p.B * H;
    const size_t step_row = (static_cast<size_t>(t) * p.ND + d) * p.B + rr.b0;
    // The gate inputs of one chunk row (as loaded) and its mask value,
    // loaded once the chunk's products are done (not live beside their
    // accumulators), their latency behind the partial sums' barrier.
    auto load_x = [&](int c, T (&x)[4], float& m) {
      const int bl = c * R + er;
      if (bl >= rr.n || !unit_in) return;
      const T* xr = xproj + (step_row + bl) * H4 + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = xr[q * H];
      m = p.mask == nullptr ? 1.0f : p.mask[static_cast<size_t>(rr.b0 + bl) * p.T + t];
    };
    // Chunk c's rows of h into slot (gbase + c) % ring by 16-byte cp.async
    // from every thread, each thread's arrival on the slot's mbarrier
    // following its copies.
    auto stage = [&](int c) {
      const int slot = static_cast<int>((gbase + c) % p.ring);
      __nv_bfloat16* dst = hs + slot * R * hstride;
      const int r0 = c * R;
      const int rows = min(R, rr.n - r0);
      for (int e = tid; e < rows * vecs; e += kThreads) {
        const int r = e / vecs;
        const int v = e % vecs;
        cp_async16(dst + r * hstride + v * 8,
                   hcur + static_cast<size_t>(rr.b0 + r0 + r) * H + v * 8);
      }
      mbar_arrive_on_copies(&bars[slot]);
    };
    if (t + 1 < p.T) {  // next step's gate inputs into L2
      const size_t next = step_row + static_cast<size_t>(p.ND) * p.B;
      for (int e = tid; e < rr.n * 4; e += kThreads)
        prefetch_l2(xproj + (next + e / 4) * H4 + (e % 4) * H + j0);
    }
    if (t > 0) {  // step 0's h is zero: no product
      if (tid == 0) dir_wait(counter, static_cast<unsigned>(t * unit_groups));
      __syncthreads();
      for (int c = 0; c < min(p.ring, n_chunks); ++c) stage(c);  // a ring's worth in flight
    }

    for (int c = 0; c < n_chunks; ++c) {
      const int rows = min(R, rr.n - c * R);
      T xv[4];
      float mv = 0.0f;
      if (t == 0) load_x(c, xv, mv);
      if (t > 0) {
        const unsigned gc = gbase + c;
        mbar_wait(&bars[gc % p.ring], (gc / p.ring) & 1);  // chunk c has landed
        __syncthreads();  // for every thread; the last epilogue is done
        // This warp's k-tiles of each m-tile of the chunk, then its partial
        // sums (m-tile by m-tile: 4 kNt accumulators live at a time).
        const __nv_bfloat16* hb = hs + static_cast<int>(gc % p.ring) * R * hstride;
        float* pw = part + kw * R * PS + nw * Tile::kNt * 8;
#pragma unroll
        for (int mi = 0; mi < Tile::kMt; ++mi) {
          if (mi * 16 >= rows) break;
          float acc[Tile::kNt][4];
#pragma unroll
          for (int nt = 0; nt < Tile::kNt; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;
#pragma unroll
          for (int i = 0; i < Tile::kKt; ++i) {
            const int kt = kw + i * kKw;
            if (kt >= KT) break;
            uint32_t a[4];
            ldmatrix_x4(a, hb + (mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * hstride +
                               kt * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int nt = 0; nt < Tile::kNt; ++nt)
              mma_bf16(acc[nt], a, wf[i][nt][0], wf[i][nt][1]);
          }
          // Accumulator q of an m16n8 tile: row g + 8 (q / 2), column 2 tq + q % 2.
#pragma unroll
          for (int nt = 0; nt < Tile::kNt; ++nt) {
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2)
              *reinterpret_cast<float2*>(pw + (mi * 16 + g + h2 * 8) * PS + nt * 8 + 2 * tq) =
                  make_float2(acc[nt][2 * h2], acc[nt][2 * h2 + 1]);
          }
        }
        load_x(c, xv, mv);
        __syncthreads();  // partials written; chunk c's slot is free
        if (c + p.ring < n_chunks) stage(c + p.ring);
      }

      if (er < rows && unit_in) {
        const int bl = c * R + er;
        const int b = rr.b0 + bl;
        const size_t row = step_row + bl;
        float gate[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float s = to_f(xv[q]);
          if (t > 0) {
            float sum = 0.0f;
#pragma unroll
            for (int w8 = 0; w8 < kKw; ++w8) sum += part[(w8 * R + er) * PS + q * U + eu];
            s += sum;
          }
          gate[q] = s;
        }
        const float gi = sigmoid(gate[0]);
        const float gf = sigmoid(gate[1]);
        const float gg = tanhf(gate[2]);
        const float go = sigmoid(gate[3]);
        const int si = bl * U + eu;
        const float c_old = st_c[si];
        const float h_old = st_h[si];
        const float c_new = gf * c_old + gi * gg;
        const float h_new = go * tanhf(c_new);
        const bool valid = mv > 0.0f;
        const float h_keep = valid ? h_new : h_old;
        const float c_keep = valid ? c_new : c_old;
        st_h[si] = h_keep;
        st_c[si] = c_keep;
        store_f(outs + row * H + j, valid ? h_new : 0.0f);
        if (t + 1 < p.T) {
          __stcg(reinterpret_cast<unsigned short*>(hnxt) + static_cast<size_t>(b) * H + j,
                 __bfloat16_as_ushort(__float2bfloat16(h_keep)));
        }
        if (kResiduals) {
          T* ga = static_cast<T*>(p.gact) + row * H4;
          store_f(ga + j, gi);
          store_f(ga + H + j, gf);
          store_f(ga + 2 * H + j, gg);
          store_f(ga + 3 * H + j, go);
          p.h_keep[row * H + j] = h_keep;
          p.c_keep[row * H + j] = c_keep;
        }
        if (t == p.T - 1) {
          const size_t fi = (static_cast<size_t>(d) * p.B + b) * H + j;
          store_f(static_cast<T*>(p.h_last) + fi, h_keep);
          store_f(static_cast<T*>(p.c_last) + fi, c_keep);
        }
      }
    }
    if (t > 0) gbase += n_chunks;
    if (t + 1 < p.T) {  // publish h_{t+1} to the CTAs that share these rows
      __syncthreads();
      if (tid == 0) dir_arrive(counter);
    }
  }
}

// Every H up to kMaxWideHidden, with the ring of its plan
// (1 <= p.ring <= kMaxRing).
template <typename T, bool kResiduals>
int launch_fwd(const FwdParams& p, cudaStream_t stream) {
  const int H = p.H;
  if (p.ring < 1 || p.ring > kMaxRing) return static_cast<int>(cudaErrorInvalidValue);
  const int ring = p.ring;
  return launch_recurrence(&lstm_seq_fwd_kernel<T, kResiduals, Fwd>, p,
                           (H + Fwd::kUnits - 1) / Fwd::kUnits, 16,
                           [H, ring](int nb) { return fwd_smem_bytes<Fwd>(H, nb, ring); },
                           stream, Fwd::kThreads);
}

}  // namespace vct
