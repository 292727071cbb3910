// One fused LSTM cell step: gates = x . W_ih^T + h . W_hh^T + b_ih + b_hh
// in torch's packing [i, f, g, o], then c' = sig(f) c + sig(i) tanh(g) and
// h' = sig(o) tanh(c').
//
// Replaces: video_captioning_tpu/ops/lstm_pallas.py, _lstm_cell_kernel
// (lstm_cell_pallas), every decoder cell of greedy and beam decoding when
// kernels.use_pallas_lstm is set (models/decoder.py:_lstm_stack_step).
//
// Contract (held by the tests against the plain PyTorch version in
// ops/lstm_cell.py): float32 operands, float32 gate math; the products run
// on the tensor cores by the 3xTF32 split of tf32x3.cuh, each within about
// 2^-21 of its float32 product, summed in float32 (at the beam step's
// shapes h' and c' land within about 2e-6 of the plain version's). The
// weights are read in their stored (4H, In) and (4H, H) layout and the two
// biases are added inside, so nothing is transposed or combined per step.
// h and c are inputs only: h' and c' go to separate outputs. Sums run in a
// fixed order: two launches on the same inputs give the same bits.
//
// What bounds it on an H100: operations. At the beam step's shape
// (N = B*K = 640, H = 512) layer 0 (In = 1024) does 2 * 640 * 2048 * 1536 =
// 4.0 GFLOP: 60 us at the float32 CUDA-core peak (67 TFLOP/s), 24 us as
// three TF32 products at the tensor-core peak (495 TFLOP/s), against 12.6 MB
// of weights (under 4 us at 3.35 TB/s). What the SMs read from L2 weighs
// too: every row tile reads all the weights and every unit tile all of
// [x ; h], about 250 MB a launch at 64 x 16 tiles.
//
// Design: a CTA owns R = 64 rows and U = 16 hidden units j0..j0+U with
// all four of their gate columns (j, H+j, 2H+j, 3H+j), so the tail runs on
// gates held on-chip and gates never reach device memory. The product runs
// over the concatenated reduction axis [x ; h] (the k-tiles of x against
// W_ih, then those of h against W_hh), 32 k a tile through a kStages-deep
// cp.async ring; four warps each own a quarter of the gate tile. A cluster
// of KS CTAs splits that axis: each takes a contiguous share of the
// k-tiles and leaves its partial gates in shared memory, and after a
// cluster barrier each CTA sums the KS partials of a KS-th of the rows in
// rank order (distributed shared memory), adds the biases and runs the
// tail. So a large tile, which keeps the L2 reads down, still gives the
// card enough CTAs. Operands past N, In and H are zero-filled by the
// copies, not padded; In or H not a multiple of 4, or an unaligned operand,
// takes 4-byte copies. The host splits the reduction in 2 where that gives
// every SM a CTA, else in 4 (pick_tile): 640 CTAs at N = 640, 256 at
// N = 128.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

using vct_tc::kStride;
using vct_tc::kTileWords;

constexpr int kThreads = 128;  // 2 x 2 warps
constexpr int kStages = 4;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int R, int U>
constexpr size_t smem_bytes() {
  return sizeof(uint32_t) * kStages * (R + 4 * U) * kStride;
}

// Stage k-tile kt of [x ; h] and of [W_ih ; W_hh] into ring slot s.
template <int R, int U, bool kVec>
__device__ __forceinline__ void stage_tile(uint32_t* As, uint32_t* Bs, int kt, int n_x,
                                           const float* __restrict__ x,
                                           const float* __restrict__ h,
                                           const float* __restrict__ w_ih,
                                           const float* __restrict__ w_hh, int N, int In, int H,
                                           int row0, int j0) {
  const bool in_x = kt < n_x;
  const float* A = in_x ? x : h;
  const float* W = in_x ? w_ih : w_hh;
  const int K = in_x ? In : H;
  const int k0 = (in_x ? kt : kt - n_x) * kTileWords;
  constexpr int C = 4 * U;
  for (int e = threadIdx.x; e < (R + C) * 8; e += kThreads) {
    const int r = e / 8, k = k0 + (e % 8) * 4;
    const float* src;
    bool ok;
    uint32_t* dst;
    if (r < R) {
      ok = row0 + r < N;
      src = A + static_cast<size_t>(ok ? row0 + r : 0) * K;
      dst = As + r * kStride + (e % 8) * 4;
    } else {
      const int cc = r - R, g = cc / U, u = cc % U;
      ok = j0 + u < H;
      src = W + (static_cast<size_t>(g) * H + (ok ? j0 + u : 0)) * K;
      dst = Bs + cc * kStride + (e % 8) * 4;
    }
    if constexpr (kVec) {
      const bool v = ok && k < K;
      vct_tc::cp_async16(dst, v ? src + k : A, v);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool v = ok && k + i < K;
        vct_tc::cp_async4(dst + i, v ? src + k + i : A, v);
      }
    }
  }
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Grid (row tiles, unit tiles, KS), clusters of the KS CTAs that split the
// reduction axis of one gate tile: CTA rank q takes k-tiles
// [q n_t / KS, (q + 1) n_t / KS) and leaves its partial gates in shared
// memory; then each CTA sums the KS partials of its R / KS rows in rank
// order through distributed shared memory, so the result does not depend
// on timing, and runs their tail.
template <int R, int U, int KS, bool kVec>
__global__ void __launch_bounds__(kThreads)
    lstm_cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const float* __restrict__ c, const float* __restrict__ w_ih,
                     const float* __restrict__ w_hh, const float* __restrict__ b_ih,
                     const float* __restrict__ b_hh, float* __restrict__ h_out,
                     float* __restrict__ c_out, int N, int In, int H) {
  constexpr int C = 4 * U;  // gate columns of a CTA
  constexpr int WM = R / 2, WN = C / 2, MT = WM / 16, NT = WN / 8;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* As = smem;                          // [kStages][R][kStride]
  uint32_t* Bs = smem + kStages * R * kStride;  // [kStages][C][kStride]

  const int row0 = blockIdx.x * R, j0 = blockIdx.y * U, rank = blockIdx.z;
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
  const int n_x = (In + kTileWords - 1) / kTileWords;
  const int n_t = n_x + (H + kTileWords - 1) / kTileWords;
  const int kt0 = rank * n_t / KS, kt1 = (rank + 1) * n_t / KS;

  float acc[MT][NT][4] = {};
  auto stage = [&](int kt) {
    if (kt < kt1) {
      const int s = (kt - kt0) % kStages;
      stage_tile<R, U, kVec>(As + s * R * kStride, Bs + s * C * kStride, kt, n_x, x, h, w_ih,
                             w_hh, N, In, H, row0, j0);
    }
    vct_tc::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) stage(kt0 + s);
  for (int kt = kt0; kt < kt1; ++kt) {
    vct_tc::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed for all; the slot of tile kt - 1 is free
    stage(kt + kStages - 1);
    const int s = (kt - kt0) % kStages;
    vct_tc::warp_mma_ktile<float, MT, NT>(acc, As + (s * R + wm * WM) * kStride,
                                          Bs + (s * C + wn * WN) * kStride);
  }
  vct_tc::cp_async_wait<0>();
  __syncthreads();  // the ring is reused for the gates

  float(*gs)[C + 1] = reinterpret_cast<float(*)[C + 1]>(smem);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        gs[wm * WM + vct_tc::frag_row(mi, q)][wn * WN + vct_tc::frag_col(ni, q)] =
            acc[mi][ni][q];
      }
  cg::this_cluster().sync();  // every partial written, visible cluster-wide

  constexpr int RS = R / KS;  // rows whose tail this CTA runs
  for (int e = threadIdx.x; e < RS * U; e += kThreads) {
    const int r = rank * RS + e / U, u = e % U;
    const int row = row0 + r, j = j0 + u;
    if (row >= N || j >= H) continue;
    float gate[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float sum = 0.0f;
      for (int q = 0; q < KS; ++q) sum += ld_cluster_f32(vct_tc::cluster_addr(&gs[r][g * U + u], q));
      const int col = g * H + j;
      gate[g] = (sum + __ldg(b_ih + col)) + __ldg(b_hh + col);
    }
    const size_t o = static_cast<size_t>(row) * H + j;
    const float c_new = sigmoidf(gate[1]) * __ldg(c + o) + sigmoidf(gate[0]) * tanhf(gate[2]);
    c_out[o] = c_new;
    h_out[o] = sigmoidf(gate[3]) * tanhf(c_new);
  }
  cg::this_cluster().sync();  // peers may still read these partials
}

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

template <int R, int U, int KS>
int launch(bool vec, const float* x, const float* h, const float* c, const float* w_ih,
           const float* w_hh, const float* b_ih, const float* b_hh, float* h_out, float* c_out,
           int n, int in_dim, int hidden, cudaStream_t st) {
  auto kernel = vec ? lstm_cell_kernel<R, U, KS, true> : lstm_cell_kernel<R, U, KS, false>;
  constexpr size_t smem = smem_bytes<R, U>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + R - 1) / R, (hidden + U - 1) / U, KS);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = KS;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, h, c, w_ih, w_hh, b_ih, b_hh, h_out, c_out, n,
                           in_dim, hidden);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// A CTA's tile: kRows rows x kUnits units; the reduction split over 2 or 4 CTAs.
constexpr int kRows = 64, kUnits = 16;

// The tile: split in 2 where that gives every SM a CTA, else in 4.
int pick_tile(int n, int hidden, int sms) {
  const long long ctas =
      static_cast<long long>((n + kRows - 1) / kRows) * ((hidden + kUnits - 1) / kUnits) * 2;
  return ctas >= sms ? 0 : 1;
}

}  // namespace

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The tile the launcher picks for (n, hidden) on the current device: 0
// (split in 2) or 1 (split in 4), or -cudaError_t.
extern "C" int vct_lstm_cell_tile(int n, int hidden) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return pick_tile(n, hidden, sms);
}

// Returns a cudaError_t: 0 when the launch was accepted. tile -1 lets the
// launcher pick; 0 or 1 forces a split in 2 or 4.
extern "C" int vct_lstm_cell_f32(const float* x, const float* h, const float* c,
                                 const float* w_ih, const float* w_hh, const float* b_ih,
                                 const float* b_hh, float* h_out, float* c_out, int n, int in_dim,
                                 int hidden, int tile, void* stream) {
  if (n <= 0 || in_dim <= 0 || hidden <= 0 || tile < -1 || tile > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tile < 0) {
    tile = vct_lstm_cell_tile(n, hidden);
    if (tile < 0) return -tile;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = in_dim % 4 == 0 && hidden % 4 == 0 && aligned16(x) && aligned16(h) &&
                   aligned16(w_ih) && aligned16(w_hh);
  return tile == 0 ? launch<kRows, kUnits, 2>(vec, x, h, c, w_ih, w_hh, b_ih, b_hh, h_out, c_out,
                                              n, in_dim, hidden, st)
                   : launch<kRows, kUnits, 4>(vec, x, h, c, w_ih, w_hh, b_ih, b_hh, h_out, c_out,
                                              n, in_dim, hidden, st);
}
