// The masked LSTM forward recurrence shared by csrc/lstm_seq.cu (eval) and
// csrc/lstm_seq_train.cu (training, which also streams out the residuals
// its backward reads). Design and contract: see those files' headers.
//
// CTA (d, j0) owns hidden units j0..j0+7 of direction d with all four
// gates, so the cell update stays local. Its W_hh columns (4 gates x 8
// units x H) are converted to float32 once and stay resident in shared
// memory for all T steps. The bf16 h that the recurrent product reads is
// double-buffered in device memory: step t reads slot t % 2 and writes
// slot (t + 1) % 2, so one grid-wide barrier per step is enough. Each step
// stages 64 batch rows of h at a time into shared memory (as float32) and
// each thread computes the four gates of one unit for two rows. The
// float32 h and c state of a CTA's units is private to the CTA and lives in
// device memory (B is not bounded). No tensor cores.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace vct {

namespace cg = cooperative_groups;

constexpr int kUnits = 8;          // hidden units per CTA, all four gates
constexpr int kThreads = 256;      // 8 warps; lane & 7 picks the unit
constexpr int kRowsPerChunk = 64;  // batch rows of h staged per pass
constexpr int kPad = 4;            // float32 row padding: no bank conflicts
constexpr size_t kMaxSmem = 232448;  // 227 KB a block on Hopper

struct FwdParams {
  const void* xproj;           // (T, ND, B, 4H), float32 or bf16
  const __nv_bfloat16* w_hh;   // (ND, H, 4H)
  const float* mask;           // (B, T), 1 = valid; nullptr = all valid
  void* outs;                  // (T, ND, B, H), xproj's type
  void* h_last;                // (ND, B, H)
  void* c_last;                // (ND, B, H)
  float* h_state;              // (ND, B, H) float32, zero on entry
  float* c_state;              // (ND, B, H) float32, zero on entry
  __nv_bfloat16* hbuf;         // (2, ND, B, H), slot 0 zero on entry
  void* gact;                  // residuals (training only): (T, ND, B, 4H)
                               // activated gates [i, f, g, o], xproj's type
  float* h_keep;               // (T, ND, B, H) carried h after step t
  float* c_keep;               // (T, ND, B, H) carried c after step t
  int T, ND, B, H;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

inline size_t fwd_smem_bytes(int H) {
  return static_cast<size_t>(4 * kUnits + kRowsPerChunk) * (H + kPad) *
         sizeof(float);
}

// Largest H the forward's shared-memory layout takes.
inline int fwd_max_hidden() {
  int h = 0;
  while (fwd_smem_bytes(h + kUnits) <= kMaxSmem) h += kUnits;
  return h;
}

template <typename T, bool kResiduals>
__global__ void __launch_bounds__(kThreads) lstm_seq_fwd_kernel(FwdParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H = p.H;
  const int H4 = 4 * H;
  const int Hp = H + kPad;
  float* ws = smem;                      // [4 gates][kUnits][Hp]
  float* hs = smem + 4 * kUnits * Hp;    // [kRowsPerChunk][Hp]

  const int ctas_per_dir = H / kUnits;
  const int d = blockIdx.x / ctas_per_dir;
  const int j0 = (blockIdx.x % ctas_per_dir) * kUnits;

  // Resident weights: ws[g][u][k] = W_hh[d][k][g*H + j0 + u].
  const __nv_bfloat16* w = p.w_hh + static_cast<size_t>(d) * H * H4;
  for (int e = threadIdx.x; e < 4 * kUnits * H; e += kThreads) {
    const int k = e / (4 * kUnits);
    const int gu = e % (4 * kUnits);
    const int g = gu / kUnits;
    const int u = gu % kUnits;
    ws[(g * kUnits + u) * Hp + k] =
        __bfloat162float(w[static_cast<size_t>(k) * H4 + g * H + j0 + u]);
  }

  const int lane = threadIdx.x & 31;
  const int u = lane & (kUnits - 1);
  const int r0 = 2 * ((threadIdx.x >> 5) * 4 + (lane >> 3));  // 0, 2, .., 62
  const int j = j0 + u;
  const T* xproj = static_cast<const T*>(p.xproj);
  T* outs = static_cast<T*>(p.outs);
  const size_t dir_state = static_cast<size_t>(d) * p.B * H;

  for (int t = 0; t < p.T; ++t) {
    const __nv_bfloat16* hcur =
        p.hbuf + (static_cast<size_t>(t & 1) * p.ND + d) * p.B * H;
    __nv_bfloat16* hnxt =
        p.hbuf + (static_cast<size_t>((t + 1) & 1) * p.ND + d) * p.B * H;

    for (int b0 = 0; b0 < p.B; b0 += kRowsPerChunk) {
      const int rows = min(kRowsPerChunk, p.B - b0);
      __syncthreads();  // the previous chunk's readers are done with hs
      // Stage h rows as float32. __ldcg reads through L2 only: other CTAs
      // wrote these rows during this launch, so L1 may hold stale lines.
      const int vecs = H / 8;
      for (int e = threadIdx.x; e < rows * vecs; e += kThreads) {
        const int r = e / vecs;
        const int c = e % vecs;
        const int4 raw = __ldcg(
            reinterpret_cast<const int4*>(hcur + static_cast<size_t>(b0 + r) * H) + c);
        const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 f0 = __bfloat1622float2(pair[0]);
        const float2 f1 = __bfloat1622float2(pair[1]);
        const float2 f2 = __bfloat1622float2(pair[2]);
        const float2 f3 = __bfloat1622float2(pair[3]);
        float4* dst = reinterpret_cast<float4*>(hs + r * Hp + c * 8);
        dst[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
        dst[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
      }
      __syncthreads();
      if (r0 >= rows) continue;

      float acc[2][4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[rr][g] = 0.0f;
      const float* h0 = hs + r0 * Hp;
      const float* h1 = hs + (r0 + 1) * Hp;  // unused garbage if r0+1 == rows
      for (int k = 0; k < H; k += 4) {
        const float4 a0 = *reinterpret_cast<const float4*>(h0 + k);
        const float4 a1 = *reinterpret_cast<const float4*>(h1 + k);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float4 wv =
              *reinterpret_cast<const float4*>(ws + (g * kUnits + u) * Hp + k);
          float s0 = acc[0][g];
          s0 = fmaf(a0.x, wv.x, s0);
          s0 = fmaf(a0.y, wv.y, s0);
          s0 = fmaf(a0.z, wv.z, s0);
          s0 = fmaf(a0.w, wv.w, s0);
          acc[0][g] = s0;
          float s1 = acc[1][g];
          s1 = fmaf(a1.x, wv.x, s1);
          s1 = fmaf(a1.y, wv.y, s1);
          s1 = fmaf(a1.z, wv.z, s1);
          s1 = fmaf(a1.w, wv.w, s1);
          acc[1][g] = s1;
        }
      }

#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = r0 + rr;
        if (r >= rows) break;
        const int b = b0 + r;
        const size_t row = (static_cast<size_t>(t) * p.ND + d) * p.B + b;
        const T* xr = xproj + row * H4;
        const float gi = sigmoid(load_f(xr + j) + acc[rr][0]);
        const float gf = sigmoid(load_f(xr + H + j) + acc[rr][1]);
        const float gg = tanhf(load_f(xr + 2 * H + j) + acc[rr][2]);
        const float go = sigmoid(load_f(xr + 3 * H + j) + acc[rr][3]);
        const size_t si = dir_state + static_cast<size_t>(b) * H + j;
        const float c_old = p.c_state[si];
        const float h_old = p.h_state[si];
        const float c_new = gf * c_old + gi * gg;
        const float h_new = go * tanhf(c_new);
        const bool valid =
            p.mask == nullptr || p.mask[static_cast<size_t>(b) * p.T + t] > 0.0f;
        const float h_keep = valid ? h_new : h_old;
        const float c_keep = valid ? c_new : c_old;
        p.h_state[si] = h_keep;
        p.c_state[si] = c_keep;
        store_f(outs + row * H + j, valid ? h_new : 0.0f);
        __stcg(reinterpret_cast<unsigned short*>(hnxt) + static_cast<size_t>(b) * H + j,
               __bfloat16_as_ushort(__float2bfloat16(h_keep)));
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
          store_f(static_cast<T*>(p.h_last) + si, h_keep);
          store_f(static_cast<T*>(p.c_last) + si, c_keep);
        }
      }
    }
    grid.sync();  // every CTA has published h_{t+1} before step t+1 reads it
  }
}

// Cooperative launch of ND * H / kUnits CTAs; refuses a grid that would
// not be co-resident. Returns a cudaError_t.
template <typename K, typename P>
int launch_cooperative(K* kernel_fn, const P& params, int grid, size_t smem,
                       cudaStream_t stream) {
  const void* kern = reinterpret_cast<const void*>(kernel_fn);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0;
  int sms = 0;
  int coop = 0;
  int per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem)) !=
      cudaSuccess)
    return static_cast<int>(e);
  if (per_sm * sms < grid) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  P args = params;
  void* kargs[] = {&args};
  e = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(kThreads), kargs, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kResiduals>
int launch_fwd(const FwdParams& p, cudaStream_t stream) {
  return launch_cooperative(&lstm_seq_fwd_kernel<T, kResiduals>, p,
                            p.ND * (p.H / kUnits), fwd_smem_bytes(p.H), stream);
}

}  // namespace vct
