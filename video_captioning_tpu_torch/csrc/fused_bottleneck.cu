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
// Products: on the tensor cores through tf32x3.cuh. float32 operands take
// the 3xTF32 split (each product within about 2^-21 of the float32
// product, float32 sums); bfloat16 operands one mma.sync m16n8k16 each,
// float32 accumulators.
//
// What bounds it on an H100: operations. Every stage's block is about
// 13.98 GFLOP at B = 32: 0.209 ms at the float32 CUDA-core peak, 0.085 ms as
// three TF32 products at the tensor-core peak, 0.014 ms in bfloat16, against
// 0.1-0.4 GB of x and out (0.03-0.12 ms at 3.35 TB/s). Feeding the tensor
// cores is the design's concern: an SM's copies into shared memory reach
// only some tens of bytes a cycle, so every k-tile must bring few bytes for
// its products (chip_profile.py reads the parts' cycles).
//
// Design: the TPU kernel keeps a whole image in VMEM; a CTA here has at most
// 227 KB of shared memory, and a CTA that owned a tile of pixels and all
// channels would stream all 17 Cm^2 weights from L2 for a few pixels (17.8
// MB a CTA at 7 x 7). So the channels are split across a thread block
// cluster of cs = ceil(Cm / 64) CTAs that share one work item: ni whole
// images, or one ty x tx tile of one image with a one-pixel halo. CTA rank q
// owns y1 and y2 channels 64 q .. 64 q + 63 and output channels
// nc q .. nc (q + 1) - 1 (nc = ceil(C / cs)):
//   1. y1 for its channels over the item's halo positions inside the image
//      (outside, y1 stays zero, as the TPU kernel's padding of y1 makes it,
//      not relu(b1)), x and w1 streamed, into its slice buffer S; then every
//      CTA gathers all cs slices through distributed shared memory into its
//      own Y, which holds y1 for all channels;
//   2. y2 = relu(conv3x3(y1) + b2) for its channels: one product over
//      K = 9 Cm whose A rows are read straight from Y by ldmatrix at the
//      nine shifted positions (the im2col gather costs nothing), w2's slice
//      streamed, into S; then every CTA gathers y2 into Y the same way;
//   3. out = relu(y2 . W3^T + b3 + x) for its output channels, A from Y.
// Cluster barriers separate the phases. A k-tile of phases 2 and 3 brings
// only 8 KB of weights for its (64 MT) x 64 x 32 words of products, and
// each weight is read once a work item, not once a pixel tile. Each phase is one
// block product: output tiles of 64 MT x 64 (8 consumer warps of 16 MT x 32,
// MT 1 or 2 by the phase's rows), k-tiles of 32 words (32 float32 or 64
// bfloat16) through a 3-stage ring that runs on across output tiles. Two
// producer warps fill the ring with cp.async and signal each slot on an
// mbarrier; the consumers release it on another, so copies overlap the
// products and no CTA-wide barrier is taken a k-tile. The host picks the
// work item (pick_plan) from a cost model of those parts. At B = 32 in
// float32: 14 x 14 tiles at 56 x 56, 7 x 14 tiles at 28 x 28 (cs 2) and at
// 14 x 14 (cs 4), one image a cluster at 7 x 7 (cs 8); in bfloat16 14 x 14
// and 14 x 28 tiles at 56 and 28, whole images at 14 (one) and 7 (two a
// cluster). Cm > 512 (a cluster above 8) is refused.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

using vct_tc::kStride;
using vct_tc::kTileWords;

constexpr int kThreads = 256;         // 8 consumer warps: 4 (rows) x 2 (columns)
constexpr int kProducers = 64;        // 2 producer warps
constexpr int kAll = kThreads + kProducers;
constexpr int kBN = 64;
constexpr int kStages = 3;
constexpr int kSlice = 64;  // y1 / y2 channels a CTA owns
constexpr int kMaxCluster = 8;
constexpr size_t kSmemMax = 227 * 1024;

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

// One 32-bit word of a row from element k on (two for bfloat16), zeros at
// k >= klim.
__device__ __forceinline__ uint32_t load_word(const float* s, int k, int klim) {
  return k < klim ? __float_as_uint(s[k]) : 0u;
}
__device__ __forceinline__ uint32_t load_word(const __nv_bfloat16* s, int k, int klim) {
  const uint32_t lo = k < klim ? __bfloat16_as_ushort(s[k]) : 0u;
  const uint32_t hi = k + 1 < klim ? __bfloat16_as_ushort(s[k + 1]) : 0u;
  return lo | (hi << 16);
}

// Words of a row of S (one CTA's 64 channels) and of Y (all cs x 64
// channels), 4 words of padding each: rows stay 16-byte aligned and
// ldmatrix's eight rows spread over the banks.
template <typename T>
__host__ __device__ constexpr int srow_words() {
  return kSlice * static_cast<int>(sizeof(T)) / 4 + 4;
}
template <typename T>
__host__ __device__ constexpr int yrow_words(int cs) {
  return cs * kSlice * static_cast<int>(sizeof(T)) / 4 + 4;
}

struct Plan {
  int cs, ni, ty, tx;
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Rows of phase 1 (in-image halo positions) and of phases 2-3 (pixels).
int rows1(const Plan& p, int H, int W) {
  return p.ni * std::min(p.ty + 2, H) * std::min(p.tx + 2, W);
}
int rows2(const Plan& p) { return p.ni * p.ty * p.tx; }
int mt_of(int rows) { return rows <= 64 ? 1 : 2; }

// Shared memory: the ring's mbarriers (16 words), the ring of B's k-tiles,
// S, and Y (phase 1's ring of A's k-tiles lives in Y's space before y1
// arrives).
template <typename T>
size_t smem_bytes(const Plan& p, int H, int W) {
  const size_t pos = static_cast<size_t>(p.ni) * (p.ty + 2) * (p.tx + 2);
  const size_t ring = static_cast<size_t>(kStages) * kBN * kStride;
  const size_t ring1 = static_cast<size_t>(kStages) * 64 * mt_of(rows1(p, H, W)) * kStride;
  const size_t s = pos * srow_words<T>();
  const size_t y = std::max(pos * yrow_words<T>(p.cs), ring1);
  return 4 * (16 + ring + s + y);
}

template <typename T>
struct Args {
  const T* x;
  const T* w1;
  const T* b1;
  const T* w2;
  const T* b2;
  const T* w3;
  const T* b3;
  T* out;
  int B, H, W, C, Cm;
  int cs, ni, ty, tx, tiles_x, tiles;  // cluster size; tiles: work items an image group
  int nc;                              // output channels a CTA writes
};

// One staged k-tile row: n elements from src (n = 0: a row of zeros), the
// rest of the tile's 32 words zero.
template <typename T>
__device__ __forceinline__ void stage_row_sync(uint32_t* dst, const T* src, int n) {
  constexpr int WE = 4 / static_cast<int>(sizeof(T));  // elements a word
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    uint4 w;
    uint32_t* wv = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
    for (int j = 0; j < 4; ++j) wv[j] = load_word(src, (q * 4 + j) * WE, n);
    *reinterpret_cast<uint4*>(dst + q * 4) = w;
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(vct_tc::smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(vct_tc::smem_addr(bar))
               : "memory");
}

// Arrive on bar once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   vct_tc::smem_addr(bar))
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
      "}\n" ::"r"(vct_tc::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// 16 bytes from a cluster CTA's shared memory.
__device__ __forceinline__ uint4 ld_cluster16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Y[row][64 q ..] = S of cluster CTA q [row][..] for rows < n and every q:
// the all-gather of the cluster's slices. Four 16-byte chunks in flight a
// thread.
template <typename T>
__device__ __forceinline__ void gather_slices(uint32_t* Y, const uint32_t* S, int n, int cs) {
  constexpr int SW = srow_words<T>(), CH = kSlice * static_cast<int>(sizeof(T)) / 16;
  const int YW = yrow_words<T>(cs);
  const int total = n * cs * CH;
  for (int e0 = threadIdx.x; e0 < total; e0 += 4 * kAll) {
    uint4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + j * kAll;
      if (e < total) {
        const int q = e / (n * CH), rc = e - q * n * CH, r = rc / CH, ch = rc - r * CH;
        v[j] = ld_cluster16(vct_tc::cluster_addr(S + r * SW + ch * 4, q));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + j * kAll;
      if (e < total) {
        const int q = e / (n * CH), rc = e - q * n * CH, r = rc / CH, ch = rc - r * CH;
        *reinterpret_cast<uint4*>(Y + r * YW + q * CH * 4 + ch * 4) = v[j];
      }
    }
  }
}

// The M x N product over nk k-tiles of 32 words, as (64 MT) x kBN output
// tiles; the (output tile, k-tile) pairs run as one sequence through the
// ring, so it does not drain between output tiles. The producer warps stage
// the k-tiles and the consumer warps multiply: slot seq % kStages of the
// ring is filled when its full mbarrier completes phase (seq / kStages) and
// free again when its empty mbarrier does; *seq counts the k-tiles the ring
// has taken, in every thread. B row n of k-tile kt: b_src(kt, n0, n, count)
// points at its first element and sets how many of its tile_k elements
// exist (nullptr: a row of zeros). A: with kStagedA, a_src(kt, m0, r, count)
// the same, staged beside B (ring_a); else a_row(r) is the word offset in Y
// of row r and a_koff(kt) that of k-tile kt, and ldmatrix reads A from Y
// directly. With kVec the rows arrive by 16-byte cp.async (zero-filled past
// count; any is a device address never read), else word by word. After an
// output tile's last k-tile, for each of its outputs inside M x N: info(r)
// (once a row), then store(info, col, (v + bias(col)) + resid(info, col)),
// with every bias and resid of the thread's outputs loaded before the first
// store (a store may alias them as far as the compiler knows). Every thread
// of the CTA calls it.
template <typename T, bool kVec, int MT, bool kStagedA, typename ASrc, typename ARow,
          typename AKoff, typename BSrc, typename Info, typename Bias, typename Resid,
          typename Store>
__device__ void block_gemm(int M, int N, int nk, uint32_t* ring_b, uint32_t* ring_a,
                           uint64_t* full, uint64_t* empty, int* seq, const uint32_t* Y,
                           const T* any, const ASrc& a_src, const ARow& a_row,
                           const AKoff& a_koff, const BSrc& b_src, const Info& info,
                           const Bias& bias, const Resid& resid, const Store& store) {
  constexpr int BM = 64 * MT, WM = 16 * MT;
  constexpr int ROWS = kBN + (kStagedA ? BM : 0);  // staged rows a k-tile
  constexpr int E = vct_tc::chunk_k<T>();           // elements a 16-byte chunk
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
  const int n_n = (N + kBN - 1) / kBN;
  const int total = (M + BM - 1) / BM * n_n * nk;
  const int seq0 = *seq;
  *seq = seq0 + total;
  if (threadIdx.x >= kThreads) {  // a producer
    for (int i = 0; i < total; ++i) {
      const int slot = (seq0 + i) % kStages, use = (seq0 + i) / kStages;
      if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
      const int kt = i % nk, mn = i / nk;
      const int m0 = mn / n_n * BM, n0 = mn % n_n * kBN;
      auto row = [&](int r, int& count, uint32_t*& dst) -> const T* {
        count = 0;
        if (!kStagedA || r < kBN) {
          dst = ring_b + (slot * kBN + r) * kStride;
          return b_src(kt, n0, r, count);
        }
        dst = ring_a + (slot * BM + r - kBN) * kStride;
        return a_src(kt, m0, r - kBN, count);
      };
      if constexpr (kVec) {
        for (int r = threadIdx.x - kThreads; r < ROWS; r += kProducers) {
          int count;
          uint32_t* dst;
          const T* src = row(r, count, dst);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const bool v = src != nullptr && q * E < count;
            vct_tc::cp_async16(dst + q * 4, v ? src + q * E : any, v);
          }
        }
        mbar_arrive_cp_async(&full[slot]);
      } else {
        for (int r = threadIdx.x - kThreads; r < ROWS; r += kProducers) {
          int count;
          uint32_t* dst;
          const T* src = row(r, count, dst);
          stage_row_sync(dst, src, src == nullptr ? 0 : count);
        }
        mbar_arrive(&full[slot]);
      }
    }
    __syncthreads();  // the ring is refilled by the next phase
    return;
  }
  float acc[MT][4][4] = {};
  int a_base[MT];  // this lane's ldmatrix row in Y, a word offset (resident A)
  int m_cur = -1;
  for (int i = 0; i < total; ++i) {
    const int s = (seq0 + i) % kStages, kt = i % nk, mn = i / nk;
    mbar_wait(&full[s], ((seq0 + i) / kStages) & 1);
    const int m0 = mn / n_n * BM, n0 = mn % n_n * kBN;
    if constexpr (!kStagedA) {
      if (m0 != m_cur) {
        m_cur = m0;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const int r = m0 + wm * WM + mi * 16 + lane % 16;
          a_base[mi] = a_row(r < M ? r : 0) + 4 * (lane / 16);
        }
      }
    }
    const bool live = m0 + wm * WM < M && n0 + wn * 32 < N;
    if (live) {
      const uint32_t* rows[MT];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if constexpr (kStagedA) {
          rows[mi] = ring_a + (s * BM + wm * WM + mi * 16 + lane % 16) * kStride + 4 * (lane / 16);
        } else {
          rows[mi] = Y + a_base[mi] + a_koff(kt);
        }
      }
      vct_tc::warp_mma_rows<T, MT, 4>(acc, rows, ring_b + (s * kBN + wn * 32) * kStride);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with slot s
    if (kt == nk - 1 && live) {
      int inf[MT][2];
      float bv[4][2], rv[MT][4][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + wm * WM + vct_tc::frag_row(mi, 2 * h);
          inf[mi][h] = r < M ? info(r) : -1;
        }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = n0 + wn * 32 + vct_tc::frag_col(ni, j);
          bv[ni][j] = c < N ? bias(c) : 0.0f;
        }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = n0 + wn * 32 + vct_tc::frag_col(ni, q);
            const int f = inf[mi][q / 2];
            rv[mi][ni][q] = f >= 0 && c < N ? resid(f, c) : 0.0f;
          }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = n0 + wn * 32 + vct_tc::frag_col(ni, q);
            const int f = inf[mi][q / 2];
            if (f >= 0 && c < N) store(f, c, (acc[mi][ni][q] + bv[ni][q % 2]) + rv[mi][ni][q]);
            acc[mi][ni][q] = 0.0f;
          }
    }
  }
  __syncthreads();  // the ring is refilled by the next phase
}

template <typename T, bool kVec, int MT1, int MT2>
__global__ void __launch_bounds__(kAll, 1) fused_bottleneck_kernel(const Args<T> a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = a.cs;
  const int rank = static_cast<int>(cluster.block_rank());
  const int item = blockIdx.x / cs;
  const int tile = item % a.tiles, img0 = (item / a.tiles) * a.ni;
  const int oy = (tile / a.tiles_x) * a.ty, ox = (tile % a.tiles_x) * a.tx;
  const int HY = a.ty + 2, HX = a.tx + 2, P = a.ty * a.tx, NPOS = a.ni * HY * HX;
  // The halo window clipped to the image: phase 1's rows.
  const int gy0 = max(oy - 1, 0), gx0 = max(ox - 1, 0);
  const int hy = min(oy + a.ty + 1, a.H) - gy0, hx = min(ox + a.tx + 1, a.W) - gx0;
  const int M1 = a.ni * hy * hx, M2 = a.ni * P;
  const int c_lo = rank * kSlice, sw = min(kSlice, a.Cm - c_lo);
  const int co_lo = rank * a.nc, nco = min(a.nc, a.C - co_lo);
  constexpr int SW = srow_words<T>();
  constexpr int KT = vct_tc::tile_k<T>();
  constexpr int TPS = kSlice / KT;  // k-tiles in a 64-channel slice
  const int YW = yrow_words<T>(cs);

  extern __shared__ __align__(16) uint32_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [kStages] and empty [kStages]
  uint64_t* empty = full + kStages;
  uint32_t* ring_b = smem + 16;                    // [kStages][kBN][kStride]
  uint32_t* S = ring_b + kStages * kBN * kStride;  // [NPOS][SW]: this CTA's slice
  uint32_t* Y = S + NPOS * SW;                     // [NPOS][YW]: all channels
  {
    uint4* z = reinterpret_cast<uint4*>(S);
    for (int i = threadIdx.x; i < NPOS * SW / 4; i += kAll) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], kProducers);      // the producers' threads
      mbar_init(&empty[i], kThreads / 32);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int seq = 0;  // k-tiles the ring has taken
  auto none_src = [](int, int, int, int&) -> const T* { return nullptr; };
  auto none_row = [](int) { return 0; };
  auto zero = [](int, int) { return 0.0f; };
  // Halo position (in the item's (ni, HY, HX) grid) of output pixel r.
  auto pixel_pos = [&](int r) {
    const int i = r / P, rr = r - i * P;
    return (i * HY + rr / a.tx) * HX + rr % a.tx;
  };

  // 1. y1 for channels c_lo.. over the in-image halo positions, into S;
  // A (x) and B (w1) through a ring in Y's space.
  {
    auto x_row = [&](int r) -> const T* {
      if (r >= M1) return nullptr;
      const int i = r / (hy * hx), rr = r - i * hy * hx;
      if (img0 + i >= a.B) return nullptr;
      const int gy = gy0 + rr / hx, gx = gx0 + rr % hx;
      return a.x + ((static_cast<size_t>(img0 + i) * a.H + gy) * a.W + gx) * a.C;
    };
    auto a_src = [&](int kt, int m0, int r, int& count) -> const T* {
      count = min(KT, a.C - kt * KT);
      const T* row = x_row(m0 + r);
      return row == nullptr ? nullptr : row + kt * KT;
    };
    auto b_src = [&](int kt, int n0, int n, int& count) -> const T* {
      count = min(KT, a.C - kt * KT);
      return n0 + n < sw ? a.w1 + static_cast<size_t>(c_lo + n0 + n) * a.C + kt * KT : nullptr;
    };
    // A row's halo position, -1 for an image past B.
    auto info = [&](int r) {
      const int i = r / (hy * hx), rr = r - i * hy * hx;
      if (img0 + i >= a.B) return -1;
      return (i * HY + gy0 + rr / hx - oy + 1) * HX + gx0 + rr % hx - ox + 1;
    };
    auto bias = [&](int n) { return to_f(a.b1[c_lo + n]); };
    auto store = [&](int pos, int n, float v) {
      reinterpret_cast<T*>(S + pos * SW)[n] = from_f<T>(fmaxf(v, 0.0f));
    };
    block_gemm<T, kVec, MT1, true>(M1, sw, (a.C + KT - 1) / KT, ring_b, Y, full, empty, &seq, Y, a.x, a_src,
                                   none_row, none_row, b_src, info, bias, zero, store);
  }
  cluster.sync();  // every slice of y1 written
  gather_slices<T>(Y, S, NPOS, cs);
  cluster.sync();  // every CTA holds y1; S may be overwritten

  // 2. y2 = relu(conv3x3(y1) + b2) for channels c_lo.., into S: k-tile kt
  // is tap kt / (cs TPS) of the channels (kt % (cs TPS)) KT.., w2's
  // channels_last row order.
  {
    auto a_row = [&](int r) { return pixel_pos(r) * YW; };
    auto a_koff = [&](int kt) {
      const int tap = kt / (cs * TPS), cb = kt - tap * cs * TPS;
      return ((tap / 3) * HX + tap % 3) * YW + cb * kTileWords;
    };
    auto b_src = [&](int kt, int n0, int n, int& count) -> const T* {
      const int tap = kt / (cs * TPS), cb = kt - tap * cs * TPS;
      count = max(0, min(KT, a.Cm - cb * KT));
      return n0 + n < sw ? a.w2 + static_cast<size_t>(c_lo + n0 + n) * 9 * a.Cm + tap * a.Cm +
                               cb * KT
                         : nullptr;
    };
    auto info = [](int r) { return r; };
    auto bias = [&](int n) { return to_f(a.b2[c_lo + n]); };
    auto store = [&](int r, int n, float v) {
      reinterpret_cast<T*>(S + r * SW)[n] = from_f<T>(fmaxf(v, 0.0f));
    };
    block_gemm<T, kVec, MT2, false>(M2, sw, 9 * cs * TPS, ring_b, nullptr, full, empty, &seq, Y, a.x,
                                    none_src, a_row, a_koff, b_src, info, bias, zero, store);
  }
  cluster.sync();  // every slice of y2 written; no CTA still reads its Y
  gather_slices<T>(Y, S, M2, cs);
  __syncthreads();

  // 3. out = relu(y2 . W3^T + b3 + x) for output channels co_lo.., A = Y.
  {
    auto a_row = [&](int r) { return r * YW; };
    auto a_koff = [](int kt) { return kt * kTileWords; };
    auto b_src = [&](int kt, int n0, int n, int& count) -> const T* {
      count = max(0, min(KT, a.Cm - kt * KT));
      return n0 + n < nco ? a.w3 + static_cast<size_t>(co_lo + n0 + n) * a.Cm + kt * KT
                          : nullptr;
    };
    // A row's output pixel offset in units of C, -1 outside the image.
    auto info = [&](int r) {
      const int i = r / P, rr = r - i * P;
      const int gy = oy + rr / a.tx, gx = ox + rr % a.tx;
      if (img0 + i >= a.B || gy >= a.H || gx >= a.W) return -1;
      return ((img0 + i) * a.H + gy) * a.W + gx;
    };
    auto bias = [&](int n) { return to_f(a.b3[co_lo + n]); };
    auto resid = [&](int px, int n) {
      return to_f(a.x[static_cast<size_t>(px) * a.C + co_lo + n]);
    };
    auto store = [&](int px, int n, float v) {
      a.out[static_cast<size_t>(px) * a.C + co_lo + n] = from_f<T>(fmaxf(v, 0.0f));
    };
    block_gemm<T, kVec, MT2, false>(M2, nco, cs * TPS, ring_b, nullptr, full, empty, &seq, Y, a.x, none_src,
                                    a_row, a_koff, b_src, info, bias, resid, store);
  }
  cluster.sync();  // peers may still read this CTA's S
}

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

// Estimated clocks of a launch under plan p. A k-tile costs the larger of
// its copies' issue (the producers reach about 16 bytes a clock) and its
// products (a cost a k-tile by type and tile height), and a fixed 250; an
// output tile's epilogue 1500 into shared memory or 4000 into device
// memory; the two gathers their bytes at 10 a clock. CTAs that share an SM
// share its tensor cores. Waves of CTAs over the SMs times that. The
// constants follow chip_profile.py's readings of the kernel's parts.
template <typename T>
double plan_cost(const Plan& p, int B, int H, int W, int C, int Cm, int sms) {
  const bool f32 = sizeof(T) == 4;
  const int KT = vct_tc::tile_k<T>(), tps = kSlice / KT;
  const int M1 = rows1(p, H, W), M2 = rows2(p), nc = ceil_div(C, p.cs);
  double cta = 0.0;
  auto phase = [&](int M, int N, int nk, bool staged_a, double epilogue) {
    const int mt = mt_of(M), bm = 64 * mt;
    const double issue = (kBN + (staged_a ? bm : 0)) * kTileWords * 4.0 / 16.0;
    const double products = f32 ? (mt == 2 ? 2200.0 : 1400.0) : (mt == 2 ? 950.0 : 750.0);
    cta += static_cast<double>(ceil_div(M, bm)) * ceil_div(N, kBN) *
           (nk * (std::max(issue, products) + 250.0) + epilogue);
  };
  phase(M1, kSlice, ceil_div(C, KT), true, 1500.0);
  phase(M2, kSlice, 9 * p.cs * tps, false, 1500.0);
  phase(M2, nc, p.cs * tps, false, 4000.0);
  cta += (static_cast<double>(p.ni) * (p.ty + 2) * (p.tx + 2) + M2) * p.cs * kSlice * sizeof(T) /
         10.0;
  const long long ctas = static_cast<long long>(ceil_div(B, p.ni)) * ceil_div(H, p.ty) *
                         ceil_div(W, p.tx) * p.cs;
  const int per_sm =
      std::max(1, std::min(2, static_cast<int>(232448 / (smem_bytes<T>(p, H, W) + 1024))));
  const long long slots = static_cast<long long>(sms) * per_sm;
  return static_cast<double>((ctas + slots - 1) / slots) * per_sm * cta;
}

// The work item with the least estimated time among whole images (1-4 a
// cluster) and square or oblong tiles of sides 1, 2, 4, 7, 8, 14, 16, H, W;
// cs = ceil(Cm / 64). cs 0 when Cm > 512.
template <typename T>
Plan pick_plan(int B, int H, int W, int C, int Cm, int sms) {
  Plan best = {0, 0, 0, 0};
  const int cs = ceil_div(Cm, kSlice);
  if (cs > kMaxCluster) return best;
  double best_cost = 0.0;
  auto consider = [&](const Plan& p) {
    if (smem_bytes<T>(p, H, W) > kSmemMax) return;
    const double cost = plan_cost<T>(p, B, H, W, C, Cm, sms);
    if (best.cs == 0 || cost < best_cost) {
      best = p;
      best_cost = cost;
    }
  };
  for (int ni = 1; ni <= std::min(4, B); ++ni) consider({cs, ni, H, W});
  const int sides[] = {1, 2, 4, 7, 8, 14, 16, H, W};
  for (int ty : sides) {
    for (int tx : sides) {
      if (ty <= H && tx <= W && !(ty == H && tx == W)) consider({cs, 1, ty, tx});
    }
  }
  return best;
}

template <typename T, bool kVec, int MT1, int MT2>
int launch_plan(const Args<T>& args, size_t smem, int items, cudaStream_t st) {
  auto kernel = fused_bottleneck_kernel<T, kVec, MT1, MT2>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(items) * args.cs);
  cfg.blockDim = dim3(kAll);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = args.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec>
int launch_mt(const Args<T>& args, size_t smem, int items, int mt1, int mt2, cudaStream_t st) {
  if (mt1 == 1) {
    return mt2 == 1 ? launch_plan<T, kVec, 1, 1>(args, smem, items, st)
                    : launch_plan<T, kVec, 1, 2>(args, smem, items, st);
  }
  return mt2 == 1 ? launch_plan<T, kVec, 2, 1>(args, smem, items, st)
                  : launch_plan<T, kVec, 2, 2>(args, smem, items, st);
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
  const Plan p = pick_plan<T>(B, H, W, C, Cm, sms);
  if (p.cs == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(p, H, W);
  const Args<T> args = {x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, Cm, p.cs, p.ni, p.ty, p.tx,
                        ceil_div(W, p.tx), ceil_div(H, p.ty) * ceil_div(W, p.tx),
                        ceil_div(C, p.cs)};
  const int items = ceil_div(B, p.ni) * args.tiles;
  const int mt1 = mt_of(rows1(p, H, W)), mt2 = mt_of(rows2(p));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Vector copies take rows whose 16-byte chunks lie within C and Cm.
  constexpr int E = vct_tc::chunk_k<T>();
  const bool vec = C % E == 0 && Cm % E == 0 && aligned16(x) && aligned16(w1) &&
                   aligned16(w2) && aligned16(w3);
  return vec ? launch_mt<T, true>(args, smem, items, mt1, mt2, st)
             : launch_mt<T, false>(args, smem, items, mt1, mt2, st);
}

template <typename T>
int plan_of(int B, int H, int W, int C, int Cm, int* out) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = pick_plan<T>(B, H, W, C, Cm, sms);
  if (p.cs == 0) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = p.cs;
  out[1] = p.ni;
  out[2] = p.ty;
  out[3] = p.tx;
  out[4] = static_cast<int>(smem_bytes<T>(p, H, W));
  return 0;
}

}  // namespace

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The launcher's work item on the current device: out = {cluster size,
// images a cluster, tile rows, tile columns, shared memory bytes a CTA}.
// Each returns a cudaError_t.
extern "C" int vct_fused_bottleneck_plan_f32(int B, int H, int W, int C, int Cm, int* out) {
  return plan_of<float>(B, H, W, C, Cm, out);
}

extern "C" int vct_fused_bottleneck_plan_bf16(int B, int H, int W, int C, int Cm, int* out) {
  return plan_of<__nv_bfloat16>(B, H, W, C, Cm, out);
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
