// Training recurrence of the encoder: the forward that also streams out
// residuals, and the backward sweep over reversed time.
//
// Replaces: video_captioning_tpu/ops/lstm_seq_pallas.py, lstm_seq_train
// (a jax.custom_vjp): _fwd_train / _fwd_train_kernel and _bwd_train /
// _bwd_kernel.
//
// Contract (held by the tests against the plain PyTorch versions in
// ops/lstm_seq_train.py): the forward is lstm_seq's (bf16 h and W_hh in
// the recurrent product, float32 sums, gates and state; padded steps carry
// the state and emit 0) and also writes gact (T, ND, B, 4H), the activated
// gates [i, f, g, o] in xproj's type, and h_keep, c_keep (T, ND, B, H),
// the carried float32 state after each step. The backward, with m the
// mask value at step t, DH and DC the running cotangents of the carried h
// and c (dh_last and dc_last at t = T - 1), h_prev = h_keep[t - 1] and
// c_prev = c_keep[t - 1] (zero at t = 0):
//   dh_new = m (dout + DH)
//   dc_new = m DC + dh_new o (1 - tanh^2 c)
//   dgates = [dc_new g i (1 - i), dc_new c_prev f (1 - f),
//             dc_new i (1 - g^2), dh_new tanh(c) o (1 - o)]
//   DC    <- dc_new f + (1 - m) DC
//   DH    <- bf16(dgates) . bf16(W_hh)^T + (1 - m) DH
//   dW_hh += bf16(h_prev)^T . bf16(dgates)        (float32 sums)
//   dxproj[t] = dgates in float32, cast to xproj's type.
//
// What bounds it on an H100: like the forward, the sweep is sequential in
// T and each step needs all 4H dgates of its direction for the dh product
// (2 * B * H * 4H multiply-adds a step); the dW_hh product is the same
// size again but has no sequential dependence. At T = 80, ND = 2, B = 128,
// H = 512 each is 21.5G multiply-adds, on CUDA cores in this version, and
// the residuals read back are 252 MB.
//
// Design:
// - Forward: the persistent kernel of lstm_seq_fwd.cuh with its residual
//   writes on (each CTA writes the residuals of its own units).
// - Backward sweep: the same persistent shape in reverse time, one
//   cooperative launch of ND * H / 8 CTAs. CTA (d, j0) owns units
//   j0..j0+7 of direction d, that is 32 dgates columns and 8 rows of
//   W_hh[d] (8 x 4H, float32, resident in shared memory for all T steps).
//   Each step: the CTA computes its 32 dgates columns from the residuals
//   and its private float32 DH, DC state, writes them to dxproj, and
//   publishes bf16(dgates) to a double-buffered (2, ND, B, 4H) exchange
//   buffer; one grid barrier; then it stages 16 batch rows of all 4H
//   dgates at a time (read through L2) against its 8 resident W_hh rows
//   to get its units' dh_prev. Two threads share one (row, unit) dot
//   product, each over half of 4H, joined with a warp shuffle.
// - dW_hh: a second, ordinary launch after the sweep: a tiled product
//   over the (T - 1) * B rows of (h_keep[t - 1], dxproj[t]), both rounded
//   to bf16 on load, 64 x 64 output tiles, float32 sums.

#include "lstm_seq_fwd.cuh"

namespace vct {

constexpr int kBwdRows = 16;  // batch rows of dgates staged per pass

inline size_t bwd_smem_bytes(int H) {
  return static_cast<size_t>(kUnits + kBwdRows) * (4 * H + kPad) * sizeof(float);
}

inline int bwd_max_hidden() {
  int h = 0;
  while (bwd_smem_bytes(h + kUnits) <= kMaxSmem) h += kUnits;
  return h;
}

struct BwdParams {
  const void* gact;            // (T, ND, B, 4H), xproj's type
  const float* h_keep;         // (T, ND, B, H)
  const float* c_keep;         // (T, ND, B, H)
  const __nv_bfloat16* w_hh;   // (ND, H, 4H)
  const float* mask;           // (B, T) or nullptr = all valid
  const void* douts;           // (T, ND, B, H), xproj's type
  float* dh_state;             // (ND, B, H): dh_last on entry
  float* dc_state;             // (ND, B, H): dc_last on entry
  __nv_bfloat16* gbuf;         // (2, ND, B, 4H) exchange of bf16(dgates)
  void* dxproj;                // (T, ND, B, 4H), xproj's type
  int T, ND, B, H;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) lstm_seq_bwd_kernel(BwdParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H = p.H;
  const int H4 = 4 * H;
  const int H4p = H4 + kPad;
  float* ws = smem;                    // [kUnits][H4p]: W_hh[d][j0 + u][:]
  float* gs = smem + kUnits * H4p;     // [kBwdRows][H4p]: staged dgates

  const int ctas_per_dir = H / kUnits;
  const int d = blockIdx.x / ctas_per_dir;
  const int j0 = (blockIdx.x % ctas_per_dir) * kUnits;

  const __nv_bfloat16* w = p.w_hh + (static_cast<size_t>(d) * H + j0) * H4;
  for (int e = threadIdx.x; e < kUnits * H4; e += kThreads) {
    const int u = e / H4;
    const int k = e % H4;
    ws[u * H4p + k] = __bfloat162float(w[static_cast<size_t>(u) * H4 + k]);
  }

  const T* gact = static_cast<const T*>(p.gact);
  const T* douts = static_cast<const T*>(p.douts);
  T* dx = static_cast<T*>(p.dxproj);
  const size_t step_rows = static_cast<size_t>(p.ND) * p.B;

  // Phase B thread layout: lane bit 3 picks the half of 4H, so the two
  // halves of one dot product sit 8 lanes apart in the same warp.
  const int pu = threadIdx.x & (kUnits - 1);
  const int half = (threadIdx.x >> 3) & 1;
  const int pr = threadIdx.x >> 4;  // 0 .. kBwdRows - 1

  for (int s = 0; s < p.T; ++s) {
    const int t = p.T - 1 - s;
    __nv_bfloat16* gnow =
        p.gbuf + (static_cast<size_t>(t & 1) * p.ND + d) * p.B * H4;
    __syncthreads();  // this CTA's phase B of step t + 1 has updated dh_state

    // Phase A: the CTA's 32 dgates columns for every batch row.
    for (int e = threadIdx.x; e < p.B * kUnits; e += kThreads) {
      const int b = e / kUnits;
      const int j = j0 + e % kUnits;
      const float m = p.mask == nullptr ? 1.0f : p.mask[static_cast<size_t>(b) * p.T + t];
      const size_t row = (static_cast<size_t>(t) * p.ND + d) * p.B + b;
      const T* ga = gact + row * H4;
      const float gi = load_f(ga + j);
      const float gf = load_f(ga + H + j);
      const float gg = load_f(ga + 2 * H + j);
      const float go = load_f(ga + 3 * H + j);
      const float c_new = p.c_keep[row * H + j];
      const float c_prev = t > 0 ? p.c_keep[(row - step_rows) * H + j] : 0.0f;
      const size_t si = (static_cast<size_t>(d) * p.B + b) * H + j;
      const float DH = p.dh_state[si];
      const float DC = p.dc_state[si];
      const float dh_new = m * (load_f(douts + row * H + j) + DH);
      const float tc = tanhf(c_new);
      const float do_ = dh_new * tc;
      const float dc_new = m * DC + dh_new * go * (1.0f - tc * tc);
      p.dc_state[si] = dc_new * gf + (1.0f - m) * DC;
      const float dg4[4] = {
          dc_new * gg * gi * (1.0f - gi),
          dc_new * c_prev * gf * (1.0f - gf),
          dc_new * gi * (1.0f - gg * gg),
          do_ * go * (1.0f - go),
      };
      T* dxr = dx + row * H4;
      unsigned short* gr =
          reinterpret_cast<unsigned short*>(gnow) + static_cast<size_t>(b) * H4;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        store_f(dxr + g * H + j, dg4[g]);
        __stcg(gr + g * H + j, __bfloat16_as_ushort(__float2bfloat16(dg4[g])));
      }
    }
    grid.sync();  // every CTA has published its dgates of step t

    // Phase B: dh_prev of the CTA's units, 16 batch rows at a time.
    for (int b0 = 0; b0 < p.B; b0 += kBwdRows) {
      const int rows = min(kBwdRows, p.B - b0);
      __syncthreads();  // the previous chunk's readers are done with gs
      const int vecs = H4 / 8;
      for (int e = threadIdx.x; e < rows * vecs; e += kThreads) {
        const int r = e / vecs;
        const int c = e % vecs;
        const int4 raw = __ldcg(
            reinterpret_cast<const int4*>(gnow + static_cast<size_t>(b0 + r) * H4) + c);
        const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 f0 = __bfloat1622float2(pair[0]);
        const float2 f1 = __bfloat1622float2(pair[1]);
        const float2 f2 = __bfloat1622float2(pair[2]);
        const float2 f3 = __bfloat1622float2(pair[3]);
        float4* dst = reinterpret_cast<float4*>(gs + r * H4p + c * 8);
        dst[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
        dst[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
      }
      __syncthreads();
      float acc = 0.0f;
      if (pr < rows) {
        const float* gv = gs + pr * H4p + half * 2 * H;
        const float* wv = ws + pu * H4p + half * 2 * H;
        for (int k = 0; k < 2 * H; k += 4) {
          const float4 a = *reinterpret_cast<const float4*>(gv + k);
          const float4 b = *reinterpret_cast<const float4*>(wv + k);
          acc = fmaf(a.x, b.x, acc);
          acc = fmaf(a.y, b.y, acc);
          acc = fmaf(a.z, b.z, acc);
          acc = fmaf(a.w, b.w, acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 8);
      if (pr < rows && half == 0) {
        const int b = b0 + pr;
        const float m = p.mask == nullptr ? 1.0f : p.mask[static_cast<size_t>(b) * p.T + t];
        const size_t si = (static_cast<size_t>(d) * p.B + b) * H + j0 + pu;
        p.dh_state[si] = acc + (1.0f - m) * p.dh_state[si];
      }
    }
  }
}

constexpr int kTile = 64;     // dW_hh output tile (rows k of H x columns of 4H)
constexpr int kChunk = 16;    // reduction rows staged per pass

// dw[d][k][c] = sum over t >= 1 and b of
//   bf16(h_keep[t - 1][d][b][k]) * bf16(dxproj[t][d][b][c]).
template <typename T>
__global__ void __launch_bounds__(256) lstm_seq_dw_kernel(
    const float* h_keep, const T* dxproj, float* dw, int Tn, int ND, int B, int H) {
  __shared__ __align__(16) float as[kChunk][kTile];
  __shared__ __align__(16) float bs[kChunk][kTile];
  const int H4 = 4 * H;
  const int c0 = blockIdx.x * kTile;
  const int k0 = blockIdx.y * kTile;
  const int d = blockIdx.z;
  const int tx = threadIdx.x % 16;  // 4 columns c each
  const int ty = threadIdx.x / 16;  // 4 rows k each
  const int n_rows = (Tn - 1) * B;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;

  for (int q0 = 0; q0 < n_rows; q0 += kChunk) {
    for (int e = threadIdx.x; e < kChunk * kTile; e += 256) {
      const int rr = e / kTile;
      const int col = e % kTile;
      const int q = q0 + rr;
      float a = 0.0f;
      float v = 0.0f;
      if (q < n_rows) {
        const int t = q / B + 1;
        const int b = q % B;
        const int k = k0 + col;
        const int c = c0 + col;
        if (k < H)
          a = h_keep[((static_cast<size_t>(t - 1) * ND + d) * B + b) * H + k];
        if (c < H4)
          v = load_f(dxproj + ((static_cast<size_t>(t) * ND + d) * B + b) * H4 + c);
      }
      as[rr][col] = __bfloat162float(__float2bfloat16(a));
      bs[rr][col] = __bfloat162float(__float2bfloat16(v));
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kChunk; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(&as[rr][ty * 4]);
      const float4 v = *reinterpret_cast<const float4*>(&bs[rr][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(av[i], vv[jj], acc[i][jj]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= H) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = c0 + tx * 4 + jj;
      if (c < H4) dw[(static_cast<size_t>(d) * H + k) * H4 + c] = acc[i][jj];
    }
  }
}

template <typename T>
int launch_bwd(const BwdParams& p, float* dw, cudaStream_t stream) {
  int rc = launch_cooperative(&lstm_seq_bwd_kernel<T>, p, p.ND * (p.H / kUnits),
                              bwd_smem_bytes(p.H), stream);
  if (rc != 0) return rc;
  const dim3 grid((4 * p.H + kTile - 1) / kTile, (p.H + kTile - 1) / kTile, p.ND);
  lstm_seq_dw_kernel<T><<<grid, 256, 0, stream>>>(
      p.h_keep, static_cast<const T*>(p.dxproj), dw, p.T, p.ND, p.B, p.H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vct

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Largest H both kernels' shared-memory layouts take.
extern "C" int vct_lstm_seq_train_max_hidden() {
  const int f = vct::fwd_max_hidden();
  const int b = vct::bwd_max_hidden();
  return f < b ? f : b;
}

static bool bad_shape(int T, int ND, int B, int H) {
  return T <= 0 || ND <= 0 || B <= 0 || H <= 0 || H % vct::kUnits != 0 ||
         H > vct_lstm_seq_train_max_hidden();
}

// Forward with residuals. Returns a cudaError_t: 0 when the launch was
// accepted.
extern "C" int vct_lstm_seq_train_fwd(
    const void* xproj, int xproj_is_bf16, const void* w_hh, const float* mask,
    void* outs, void* h_last, void* c_last, float* h_state, float* c_state,
    void* hbuf, void* gact, float* h_keep, float* c_keep, int T, int ND, int B,
    int H, void* stream) {
  if (bad_shape(T, ND, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  vct::FwdParams p = {};
  p.xproj = xproj;
  p.w_hh = static_cast<const __nv_bfloat16*>(w_hh);
  p.mask = mask;
  p.outs = outs;
  p.h_last = h_last;
  p.c_last = c_last;
  p.h_state = h_state;
  p.c_state = c_state;
  p.hbuf = static_cast<__nv_bfloat16*>(hbuf);
  p.gact = gact;
  p.h_keep = h_keep;
  p.c_keep = c_keep;
  p.T = T;
  p.ND = ND;
  p.B = B;
  p.H = H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return xproj_is_bf16 ? vct::launch_fwd<__nv_bfloat16, true>(p, st)
                       : vct::launch_fwd<float, true>(p, st);
}

// Backward sweep, then the dW_hh product. dh_state and dc_state hold
// dh_last and dc_last (float32) on entry and are overwritten. Returns a
// cudaError_t.
extern "C" int vct_lstm_seq_train_bwd(
    const void* gact, int is_bf16, const float* h_keep, const float* c_keep,
    const void* w_hh, const float* mask, const void* douts, float* dh_state,
    float* dc_state, void* gbuf, void* dxproj, float* dw, int T, int ND, int B,
    int H, void* stream) {
  if (bad_shape(T, ND, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  vct::BwdParams p = {};
  p.gact = gact;
  p.h_keep = h_keep;
  p.c_keep = c_keep;
  p.w_hh = static_cast<const __nv_bfloat16*>(w_hh);
  p.mask = mask;
  p.douts = douts;
  p.dh_state = dh_state;
  p.dc_state = dc_state;
  p.gbuf = static_cast<__nv_bfloat16*>(gbuf);
  p.dxproj = dxproj;
  p.T = T;
  p.ND = ND;
  p.B = B;
  p.H = H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? vct::launch_bwd<__nv_bfloat16>(p, dw, st)
                 : vct::launch_bwd<float>(p, dw, st);
}
