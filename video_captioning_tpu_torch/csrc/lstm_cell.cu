// One fused LSTM cell step: gates = x . W_ih^T + h . W_hh^T + b_ih + b_hh
// in torch's packing [i, f, g, o], then c' = sig(f) c + sig(i) tanh(g) and
// h' = sig(o) tanh(c').
//
// Replaces: video_captioning_tpu/ops/lstm_pallas.py, _lstm_cell_kernel
// (lstm_cell_pallas), every decoder cell of greedy and beam decoding when
// kernels.use_pallas_lstm is set (models/decoder.py:_lstm_stack_step).
//
// Contract (held by the tests against the plain PyTorch version in
// ops/lstm_cell.py): float32 operands, float32 products and sums (no TF32,
// no bf16 rounding), float32 gate math. The weights are read in their
// stored (4H, In) and (4H, H) layout and the two biases are added inside,
// so nothing is transposed or combined per step. h and c are inputs only:
// h' and c' go to separate outputs.
//
// What bounds it on an H100: float32 operations on CUDA cores. At the beam
// step's shape (N = B*K = 640, H = 512) layer 0 (In = 1024) does
// 2 * 640 * 2048 * 1536 = 4.0 GFLOP, about 60 us at 67 TFLOP/s, against
// 12.6 MB of weights (under 4 us at 3.35 TB/s).
//
// Design: a CTA owns kRows rows and kUnits hidden units j0..j0+kUnits with
// all four of their gate columns (j, H+j, 2H+j, 3H+j), so the tail runs on
// gates held in shared memory and gates never reach device memory. The
// product is a shared-memory tiled SGEMM over the concatenated reduction
// axis [x ; h] (first the In columns of x against W_ih, then the H columns
// of h against W_hh), 256 threads each accumulating a 4 x 4 block in
// registers. Each thread loads four consecutive k of one row of x (or h)
// and of one weight row per tile, as one 16-byte load where In and H are
// multiples of 4, and the next tile's loads are issued before the current
// tile's products (two shared-memory buffers, one barrier a tile). Rows and
// units past N and H are masked, not padded. No tensor cores: the parity
// runs in float32.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;
constexpr int kUnits = 16;
constexpr int kCols = 4 * kUnits;  // gate columns of a CTA
constexpr int kK = 16;             // reduction tile
constexpr int kThreads = 256;      // (16 x 16) threads, 4 x 4 outputs each
constexpr int kPad = 4;            // keeps float4 rows aligned, spreads banks

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Four consecutive k (k..k+3) of one row, zeros past the row's end or for
// a masked row.
template <bool kVec>
__device__ __forceinline__ void load4(const float* __restrict__ row, bool ok, int k,
                                      int K, float (&v)[4]) {
  if (kVec) {
    const float4 t = ok && k < K ? __ldg(reinterpret_cast<const float4*>(row + k))
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = ok && k + i < K ? __ldg(row + k + i) : 0.0f;
  }
}

// acc += A[row0:row0+kRows, 0:K] . W[gate rows of units j0.., 0:K]^T
template <bool kVec>
__device__ __forceinline__ void accumulate(
    const float* __restrict__ A, const float* __restrict__ W, int K, int N, int H,
    int row0, int j0, float (*as)[kK][kRows + kPad], float (*ws)[kK][kCols + kPad],
    float (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  // This thread's loads: row r of A and weight row of column cc, k-offset kq.
  const int r = tid / 4, cc = tid / 4, kq = (tid % 4) * 4;
  const int g = cc / kUnits, u = cc % kUnits;
  const bool a_ok = row0 + r < N, w_ok = j0 + u < H;
  const float* a_row = A + static_cast<size_t>(a_ok ? row0 + r : 0) * K;
  const float* w_row = W + (static_cast<size_t>(g) * H + (w_ok ? j0 + u : 0)) * K;
  float va[4], vw[4];
  load4<kVec>(a_row, a_ok, kq, K, va);
  load4<kVec>(w_row, w_ok, kq, K, vw);
  const int n_tiles = (K + kK - 1) / kK;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      as[buf][kq + i][r] = va[i];
      ws[buf][kq + i][cc] = vw[i];
    }
    __syncthreads();
    if (t + 1 < n_tiles) {  // next tile's loads in flight during the products
      load4<kVec>(a_row, a_ok, (t + 1) * kK + kq, K, va);
      load4<kVec>(w_row, w_ok, (t + 1) * kK + kq, K, vw);
    }
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[buf][kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[buf][kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();  // the buffers are reused by the next call
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    lstm_cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const float* __restrict__ c,
                     const float* __restrict__ w_ih,
                     const float* __restrict__ w_hh,
                     const float* __restrict__ b_ih,
                     const float* __restrict__ b_hh, float* __restrict__ h_out,
                     float* __restrict__ c_out, int N, int In, int H) {
  __shared__ __align__(16) float as[2][kK][kRows + kPad];
  __shared__ __align__(16) float ws[2][kK][kCols + kPad];
  __shared__ float gs[kRows][kCols + 1];

  const int row0 = blockIdx.x * kRows;
  const int j0 = blockIdx.y * kUnits;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  float acc[4][4] = {};
  accumulate<kVec>(x, w_ih, In, N, H, row0, j0, as, ws, acc);
  accumulate<kVec>(h, w_hh, H, N, H, row0, j0, as, ws, acc);

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int cc = tx * 4 + j;
    const int g = cc / kUnits, u = cc % kUnits;
    const int col = g * H + j0 + u;
    const float bi = j0 + u < H ? __ldg(b_ih + col) : 0.0f;
    const float bh = j0 + u < H ? __ldg(b_hh + col) : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) gs[ty * 4 + i][cc] = (acc[i][j] + bi) + bh;
  }
  __syncthreads();

  for (int e = threadIdx.x; e < kRows * kUnits; e += kThreads) {
    const int r = e / kUnits, u = e % kUnits;
    const int row = row0 + r, j = j0 + u;
    if (row >= N || j >= H) continue;
    const size_t o = static_cast<size_t>(row) * H + j;
    const float ig = sigmoidf(gs[r][u]);
    const float fg = sigmoidf(gs[r][kUnits + u]);
    const float gg = tanhf(gs[r][2 * kUnits + u]);
    const float og = sigmoidf(gs[r][3 * kUnits + u]);
    const float c_new = fg * __ldg(c + o) + ig * gg;
    c_out[o] = c_new;
    h_out[o] = og * tanhf(c_new);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

}  // namespace

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int vct_lstm_cell_f32(const float* x, const float* h,
                                 const float* c, const float* w_ih,
                                 const float* w_hh, const float* b_ih,
                                 const float* b_hh, float* h_out, float* c_out,
                                 int n, int in_dim, int hidden, void* stream) {
  if (n <= 0 || in_dim <= 0 || hidden <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kRows - 1) / kRows, (hidden + kUnits - 1) / kUnits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = in_dim % 4 == 0 && hidden % 4 == 0 && aligned16(x) && aligned16(h) &&
                   aligned16(w_ih) && aligned16(w_hh);
  if (vec) {
    lstm_cell_kernel<true><<<grid, kThreads, 0, st>>>(x, h, c, w_ih, w_hh, b_ih, b_hh, h_out,
                                                      c_out, n, in_dim, hidden);
  } else {
    lstm_cell_kernel<false><<<grid, kThreads, 0, st>>>(x, h, c, w_ih, w_hh, b_ih, b_hh, h_out,
                                                       c_out, n, in_dim, hidden);
  }
  return static_cast<int>(cudaGetLastError());
}
