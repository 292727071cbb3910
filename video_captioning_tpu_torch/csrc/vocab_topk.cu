// Fused vocabulary projection, exact row top-k and row logsumexp of
// logits = bf16(x) . W + b, without writing the (N, V) logits anywhere.
//
// Replaces: video_captioning_tpu/ops/vocab_topk_pallas.py, _kernel
// (vocab_topk_lse), the beam step's expansion when
// kernels.use_fused_vocab_topk is set (generation/beam.py).
//
// Contract (held by the tests against the plain PyTorch version in
// ops/vocab_topk.py): x (N, H) float32 is rounded to bf16 (round to
// nearest even, as torch's .to(torch.bfloat16)); W (H, Vp) arrives in bf16
// and b (Vp,) in float32 from pad_vocab_weights, whose padded columns
// carry a float32-min bias (never selected, exp() = 0). The tensor cores
// multiply the bf16 values exactly and accumulate in float32, rounding
// their internal sums their own way, so a logit matches the plain
// version's (exact products, float32 sums in another order) to about 1e-6
// of the logits' scale, not bit for bit. Given the kernel's logits, the
// top-k values and indices are exact, in lax.top_k's order (value desc,
// index asc); the lse matches to float32 rounding. 1 <= k <= 16.
//
// What bounds it on an H100: operations. At the beam step's shape
// (N = 640, H = 512, Vp = 10112) the product is 6.6 GFLOP, under 7 us at
// the bf16 tensor-core peak, against 10 MB of weights read once. The
// products run on the tensor cores (mma.sync m16n8k16, bf16 operands,
// float32 accumulators); the same tiles on CUDA cores in float32 ran 2.8x
// slower on an H100, near a third of its 67 TFLOP/s float32 peak.
//
// Design: two launches. (1) A CTA computes a kRows x kCols logits tile
// (64 rows x 128 vocab columns) over H in k-tiles of 32: each thread
// stages eight k of one x row (rounded to bf16) and sixteen bf16 weights a
// tile, the next tile's loads issued before the current tile's products
// (two shared-memory buffers, one barrier a tile). Eight warps each own a
// 32 x 32 block: A fragments are read from the row-major x tile, B
// fragments from the k-major weight tile with ldmatrix.trans, and the
// float32 accumulators stay in registers. The tile goes to
// shared memory, and a warp per row keeps per-lane top-KP lists and an
// online (max, sum of exp) over the tile's columns (topk_list.cuh), merges
// them, and writes the tile's partial state (k values, k indices, m, s) to
// a small scratch buffer. (2) A warp per row merges the row's tile states
// (a few KB) into the final top-k and lse. The total order of the lists
// makes the merge independent of the tiles' order, so cross-tile ties keep
// ascending vocabulary order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "topk_list.cuh"

namespace {

using namespace vct;

constexpr int kRows = 64;
constexpr int kCols = 128;
constexpr int kKT = 32;        // k per staged tile
constexpr int kThreads = 256;  // 8 warps, (2 x 4) blocks of 32 x 32 logits
constexpr int kWarps = kThreads / 32;
// Row strides in bf16, padded by 16 bytes so that fragment reads and
// ldmatrix rows fall in distinct banks.
constexpr int kXStride = kKT + 8;
constexpr int kWStride = kCols + 8;

struct Stage {
  __nv_bfloat16 xs[kRows][kXStride];  // x tile, row-major (k contiguous)
  __nv_bfloat16 ws[kKT][kWStride];    // weight tile, k-major (n contiguous)
};
constexpr int kStageBytes = 2 * static_cast<int>(sizeof(Stage));
constexpr int kLsBytes = kRows * (kCols + 1) * 4;
constexpr int kSmemBytes = kStageBytes > kLsBytes ? kStageBytes : kLsBytes;

// d += a . b for one m16n8k16 tile: bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lane L gives the
// address of row L % 8 of matrix L / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Eight consecutive k of one x row as four packed bf16 pairs, zeros past
// the row's end or for a masked row.
template <bool kVec>
__device__ __forceinline__ uint4 load_x8(const float* __restrict__ row, bool ok, int k, int H) {
  float v[8];
  if (kVec) {  // H % 4 == 0: each float4 is all in range or none is
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float4 t = ok && k + 4 * q < H
                           ? __ldg(reinterpret_cast<const float4*>(row + k + 4 * q))
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = ok && k + i < H ? __ldg(row + k + i) : 0.0f;
  }
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}

// Eight bf16 weights W[k][col..col+8] (Vp % 8 == 0: all eight are in range
// or none is).
__device__ __forceinline__ uint4 load_w8(const __nv_bfloat16* __restrict__ w, int k, int col,
                                         int H, int Vp) {
  if (k < H && col < Vp) {
    return __ldg(reinterpret_cast<const uint4*>(w + static_cast<size_t>(k) * Vp + col));
  }
  return make_uint4(0u, 0u, 0u, 0u);
}

template <int KP, bool kVec>
__global__ void __launch_bounds__(kThreads)
    vocab_tile_kernel(const float* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ b, float* __restrict__ pv,
                      int* __restrict__ pi, float* __restrict__ pm,
                      float* __restrict__ ps, int N, int H, int Vp, int k) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  Stage* stage = reinterpret_cast<Stage*>(smem);
  float(*ls)[kCols + 1] = reinterpret_cast<float(*)[kCols + 1]>(smem);

  const int row0 = blockIdx.x * kRows;
  const int tile = blockIdx.y;
  const int n_tiles = gridDim.y;
  const int v0 = tile * kCols;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane / 4, tq = lane % 4;       // mma fragment coordinates
  const int wm = warp / 4, wn = warp % 4;      // this warp's 32 x 32 block
  // This thread's staging: eight k of x row xr; eight columns of weight
  // rows wk and wk + 16.
  const int xr = tid / 4, xk = (tid % 4) * 8;
  const int wk = tid / 16, wc = (tid % 16) * 8;
  const bool x_ok = row0 + xr < N;
  const float* x_row = x + static_cast<size_t>(x_ok ? row0 + xr : 0) * H;

  uint4 vx = load_x8<kVec>(x_row, x_ok, xk, H);
  uint4 vw0 = load_w8(w, wk, v0 + wc, H, Vp);
  uint4 vw1 = load_w8(w, wk + 16, v0 + wc, H, Vp);
  float acc[2][4][4] = {};
  const int k_tiles = (H + kKT - 1) / kKT;
  for (int t = 0; t < k_tiles; ++t) {
    Stage& st = stage[t & 1];
    *reinterpret_cast<uint4*>(&st.xs[xr][xk]) = vx;
    *reinterpret_cast<uint4*>(&st.ws[wk][wc]) = vw0;
    *reinterpret_cast<uint4*>(&st.ws[wk + 16][wc]) = vw1;
    __syncthreads();
    if (t + 1 < k_tiles) {  // next tile's loads in flight during the products
      const int k1 = (t + 1) * kKT;
      vx = load_x8<kVec>(x_row, x_ok, k1 + xk, H);
      vw0 = load_w8(w, k1 + wk, v0 + wc, H, Vp);
      vw1 = load_w8(w, k1 + wk + 16, v0 + wc, H, Vp);
    }
#pragma unroll
    for (int ks = 0; ks < kKT; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&st.xs[r][ks + 2 * tq]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&st.xs[r + 8][ks + 2 * tq]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&st.xs[r][ks + 2 * tq + 8]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&st.xs[r + 8][ks + 2 * tq + 8]);
      }
#pragma unroll
      for (int pair = 0; pair < 2; ++pair) {
        // b0, b1 of n-tiles 2 * pair and 2 * pair + 1.
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, &st.ws[ks + lane % 8 + ((lane / 8) % 2) * 8]
                                    [wn * 32 + pair * 16 + (lane / 16) * 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * pair], a[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * pair + 1], a[mi], bf[2], bf[3]);
        }
      }
    }
  }
  __syncthreads();

  // The barrier after the products frees the stages: the logits tile
  // reuses them. Accumulator d[0..3] of an m16n8 tile holds rows (g, g, g+8,
  // g+8) and columns (2 tq, 2 tq + 1, 2 tq, 2 tq + 1).
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = wm * 32 + mi * 16 + g + (q / 2) * 8;
        const int c = wn * 32 + ni * 8 + 2 * tq + q % 2;
        const float bias = v0 + c < Vp ? __ldg(b + v0 + c) : 0.0f;
        ls[r][c] = acc[mi][ni][q] + bias;
      }
    }
  }
  __syncthreads();

  const int n_cols = min(kCols, Vp - v0);
  for (int r = warp; r < kRows; r += kWarps) {
    const int row = row0 + r;
    if (row >= N) break;  // rows only grow with r
    float tv[KP];
    int ti[KP];
    list_init<KP>(tv, ti);
    float m = -INFINITY, s = 0.0f;
    for (int c = lane; c < n_cols; c += 32) {
      const float v = ls[r][c];
      list_insert<KP>(tv, ti, v, v0 + c);
      lse_add(m, s, v);
    }
    float mv[KP];
    int mi[KP];
    warp_merge<KP>(tv, ti, mv, mi);
    warp_lse(m, s);
    if (lane == 0) {
      const size_t slot = static_cast<size_t>(row) * n_tiles + tile;
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        if (j < k) {
          pv[slot * k + j] = mv[j];
          pi[slot * k + j] = mi[j];
        }
      }
      pm[slot] = m;
      ps[slot] = s;
    }
  }
}

template <int KP>
__global__ void __launch_bounds__(32)
    vocab_merge_kernel(const float* __restrict__ pv, const int* __restrict__ pi,
                       const float* __restrict__ pm, const float* __restrict__ ps,
                       float* __restrict__ vals, int* __restrict__ idx,
                       float* __restrict__ lse, int n_tiles, int k) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  float tv[KP];
  int ti[KP];
  list_init<KP>(tv, ti);
  float m = -INFINITY, s = 0.0f;
  for (int t = lane; t < n_tiles; t += 32) {
    const size_t slot = static_cast<size_t>(row) * n_tiles + t;
    for (int j = 0; j < k; ++j) list_insert<KP>(tv, ti, pv[slot * k + j], pi[slot * k + j]);
    lse_merge(m, s, pm[slot], ps[slot]);
  }
  float mv[KP];
  int mi[KP];
  warp_merge<KP>(tv, ti, mv, mi);
  warp_lse(m, s);
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

template <int KP>
int launch(const float* x, const void* w, const float* b, float* pv, int* pi,
           float* pm, float* ps, float* vals, int* idx, float* lse, int n,
           int h, int vp, int k, cudaStream_t st) {
  const int n_tiles = (vp + kCols - 1) / kCols;
  const dim3 grid((n + kRows - 1) / kRows, n_tiles);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  if (h % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0) {
    vocab_tile_kernel<KP, true><<<grid, kThreads, 0, st>>>(x, wb, b, pv, pi, pm, ps, n, h, vp, k);
  } else {
    vocab_tile_kernel<KP, false><<<grid, kThreads, 0, st>>>(x, wb, b, pv, pi, pm, ps, n, h, vp, k);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  vocab_merge_kernel<KP><<<n, 32, 0, st>>>(pv, pi, pm, ps, vals, idx, lse, n_tiles, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Vocabulary columns of one tile: the scratch holds ceil(Vp / this) tile
// states per row.
extern "C" int vct_vocab_topk_tile_cols() { return kCols; }

// Returns a cudaError_t: 0 when both launches were accepted. pv/pi hold
// (N, n_tiles, k) and pm/ps (N, n_tiles) of scratch.
extern "C" int vct_vocab_topk_lse(const float* x, const void* w, const float* b,
                                  float* pv, int* pi, float* pm, float* ps,
                                  float* vals, int* idx, float* lse, int n,
                                  int h, int vp, int k, void* stream) {
  if (n <= 0 || h <= 0 || vp <= 0 || vp % 8 != 0 || reinterpret_cast<size_t>(w) % 16 != 0 ||
      k < 1 || k > 16 || k > vp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 1) return launch<1>(x, w, b, pv, pi, pm, ps, vals, idx, lse, n, h, vp, k, st);
  if (k == 2) return launch<2>(x, w, b, pv, pi, pm, ps, vals, idx, lse, n, h, vp, k, st);
  if (k <= 4) return launch<4>(x, w, b, pv, pi, pm, ps, vals, idx, lse, n, h, vp, k, st);
  if (k <= 8) return launch<8>(x, w, b, pv, pi, pm, ps, vals, idx, lse, n, h, vp, k, st);
  return launch<16>(x, w, b, pv, pi, pm, ps, vals, idx, lse, n, h, vp, k, st);
}
