// A 1x1 conv as a matmul with a fused epilogue:
//   out = relu?(x . w^T + b [+ r]), x (M, K), w (N, K), b (N,), r (M, N),
// float32 or bfloat16 operands, float32 products and sums, the epilogue
// applied to the accumulator before the one store, the output in x's type.
//
// Replaces: video_captioning_tpu/ops/conv1x1_pallas.py, _kernel_plain and
// _kernel_res (matmul_bias_act / conv1x1). Neither package calls it on a
// model path; chip_smoke.py holds it against its plain version.
//
// What bounds it on an H100: at stage 1's conv3 (M = 100352, K = 64,
// N = 256, float32, with a residual) the bytes, 231 MB read or written
// once (0.069 ms at 3.35 TB/s), over 3.3 GFLOP (0.049 ms at 67 TFLOP/s on
// the CUDA cores, 0.020 ms as three TF32 products on the tensor cores).
//
// Design: persistent CTAs, one an SM, each owning a block of up to 256
// columns and walking row blocks of 32 rows, so x is read once where
// N <= 256 and the CTA's w columns are loaded once where they fit in shared
// memory (K <= 64 float32, K <= 256 bf16; otherwise w's k-tiles stream with
// x's). x's k-tiles (32 rows x 32 words) and the residual's tiles (32 rows
// x 256 columns) arrive by 16-byte cp.async, zero-filled past M, N and K,
// through a ring of stages that runs across row blocks: a row block's
// residual is in flight while the one before it computes. Products run on
// the tensor cores: float32 by the 3xTF32 split of tf32x3.cuh (each
// product within about 2^-21 of the float32 product), bfloat16 as m16n8k16
// with float32 sums; 8 warps of 32 columns each cover the block. The
// epilogue reads the residual from its staged tile at the accumulators'
// positions (rows 8 elements longer than the block: conflict-free), writes
// the output back in place and the block leaves by coalesced 16-byte
// stores. Shapes whose rows are not 16-byte multiples (K or N not a
// multiple of 4 in float32, 8 in bf16) or misaligned pointers take the same
// kernel with element-wise staging. Any M, K and N: unlike the TPU kernel
// there is no block-size rule and no shape it refuses.
//
// The first design (a 64 x 64 output tile a CTA, the SIMT product of a shared
// header over all K, the epilogue from registers; the grid's 4 column
// tiles each read x again) took 0.1848 ms by graph replay at stage 1's
// conv3 (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

#include "tf32x3.cuh"

namespace {

using vct_tc::kStride;
using vct_tc::kTileWords;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 32;             // rows a block
constexpr int kBN = 256;            // columns a block: 8 warps of 32
constexpr int kWN = kBN / kWarps;
constexpr int kMT = kBM / 16;       // m16 tiles a warp
constexpr int kNT = kWN / 8;        // n8 tiles a warp
constexpr int kRPad = 8;            // residual rows' extra elements: conflict-free epilogue
constexpr size_t kSmemLimit = 232448;
constexpr int kMaxDevices = 64;
constexpr size_t kXTile = static_cast<size_t>(kBM) * kStride * 4;  // bytes of an x k-tile
constexpr size_t kWTile = static_cast<size_t>(kBN) * kStride * 4;  // bytes of a w k-tile
// Ring stages (k-tiles of x, with w's where they stream): five where w
// stays resident, three where it streams (a stage then holds 41 KB).
constexpr int kStagesResident = 5;
constexpr int kStagesStreamed = 3;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__host__ __device__ constexpr size_t r_tile_bytes() {
  return static_cast<size_t>(kBM) * (kBN + kRPad) * sizeof(T);
}

// Residual tiles in the ring: a row block's tile is issued with its first
// k-tile, at most kStages - 1 stages ahead, and its slot is free once the
// block has left.
__host__ __device__ constexpr int r_slots(int stages, int ktiles) {
  return 1 + (stages - 1 + ktiles - 1) / ktiles;
}

template <typename T, int kStages, bool kResident>
__host__ __device__ constexpr size_t smem_bytes(int ktiles) {
  return (kResident ? ktiles : kStages) * kWTile + kStages * kXTile +
         r_slots(kStages, ktiles) * r_tile_bytes<T>();
}

template <typename T, int kStages, bool kResident, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    matmul_bias_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const T* __restrict__ b, const T* __restrict__ r, T* __restrict__ out,
                           int M, int K, int N, int relu) {
  constexpr int TK = vct_tc::tile_k<T>();   // K values a k-tile
  constexpr int VE = vct_tc::chunk_k<T>();  // values a 16-byte copy
  constexpr int RS = kBN + kRPad;           // residual tile row stride (values)
  extern __shared__ __align__(16) unsigned char smem[];
  const int ktiles = (K + TK - 1) / TK;
  const int rslots = r_slots(kStages, ktiles);
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem);  // [resident ? ktiles : kStages][kBN][kStride]
  uint32_t* xs = ws + (kResident ? ktiles : kStages) * kBN * kStride;  // [kStages][kBM][kStride]
  T* rs = reinterpret_cast<T*>(xs + kStages * kBM * kStride);  // [rslots][kBM][RS]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int n0 = blockIdx.y * kBN;
  const int blocks = (M + kBM - 1) / kBM;
  const int mine = blockIdx.x < blocks ? (blocks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int units = mine * ktiles;

  // A k-tile of `rows` rows of a (rows_total, K) operand from row0 into
  // dst (rows kStride words apart), zeros past rows_total and K.
  auto load_tile = [&](uint32_t* dst, const T* src, int row0, int rows_total, int rows, int kt) {
    const int k0 = kt * TK;
    if constexpr (kVec) {
      constexpr int kChunks = kTileWords / 4;  // 16-byte chunks a row
      for (int e = tid; e < rows * kChunks; e += kThreads) {
        const int rr = e / kChunks, c = e % kChunks;
        const int row = row0 + rr, k = k0 + c * VE;
        const bool ok = row < rows_total && k < K;
        vct_tc::cp_async16(dst + rr * kStride + c * 4,
                           ok ? src + static_cast<size_t>(row) * K + k : src, ok);
      }
    } else {
      T* d = reinterpret_cast<T*>(dst);
      for (int e = tid; e < rows * TK; e += kThreads) {
        const int rr = e / TK, k = e % TK;
        const int row = row0 + rr;
        d[rr * kStride * 4 / static_cast<int>(sizeof(T)) + k] =
            row < rows_total && k0 + k < K ? src[static_cast<size_t>(row) * K + k0 + k] : T(0.0f);
      }
    }
  };
  // The residual's block of rows m0.. and columns n0.. into slot `slot`,
  // zeros past M and N.
  auto load_r = [&](int slot, int m0) {
    T* d = rs + slot * kBM * RS;
    if constexpr (kVec) {
      constexpr int kChunks = kBN / VE;
      for (int e = tid; e < kBM * kChunks; e += kThreads) {
        const int rr = e / kChunks, c = e % kChunks;
        const int row = m0 + rr, col = n0 + c * VE;
        const bool ok = row < M && col < N;
        vct_tc::cp_async16(d + rr * RS + c * VE, ok ? r + static_cast<size_t>(row) * N + col : r,
                           ok);
      }
    } else {
      for (int e = tid; e < kBM * kBN; e += kThreads) {
        const int rr = e / kBN, c = e % kBN;
        const int row = m0 + rr, col = n0 + c;
        d[rr * RS + c] = row < M && col < N ? r[static_cast<size_t>(row) * N + col] : T(0.0f);
      }
    }
  };
  // Unit u: k-tile u % ktiles of the CTA's (u / ktiles)-th row block (and
  // w's k-tile where it streams); a block's first unit also brings its
  // residual.
  auto issue = [&](int u) {
    if (u >= units) return;
    const int i = u / ktiles, kt = u % ktiles;
    const int m0 = (blockIdx.x + i * gridDim.x) * kBM;
    load_tile(xs + (u % kStages) * kBM * kStride, x, m0, M, kBM, kt);
    if (!kResident) load_tile(ws + (u % kStages) * kBN * kStride, w, n0, N, kBN, kt);
    if (kt == 0 && r != nullptr) load_r(i % rslots, m0);
  };

  // The bias of this thread's 8 columns, and w where it stays resident
  // (part of the first stage's group).
  float bias[kNT][2];
#pragma unroll
  for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = n0 + warp * kWN + vct_tc::frag_col(ni, q);
      bias[ni][q] = col < N ? to_f(b[col]) : 0.0f;
    }
  if (kResident) {
    for (int kt = 0; kt < ktiles; ++kt) load_tile(ws + kt * kBN * kStride, w, n0, N, kBN, kt);
  }
#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) {
    issue(u);
    vct_tc::cp_async_commit();
  }

  float acc[kMT][kNT][4];
  for (int u = 0; u < units; ++u) {
    vct_tc::cp_async_wait<kStages - 2>();  // unit u has landed
    __syncthreads();  // for every thread; unit u - 1's slots are free
    issue(u + kStages - 1);
    vct_tc::cp_async_commit();
    const int i = u / ktiles, kt = u % ktiles;
    if (kt == 0) {
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0f;
    }
    vct_tc::warp_mma_ktile<T, kMT, kNT>(
        acc, xs + (u % kStages) * kBM * kStride,
        ws + ((kResident ? kt : u % kStages) * kBN + warp * kWN) * kStride);
    if (kt + 1 < ktiles) continue;

    // Epilogue: bias and residual in float32, ReLU, written over the
    // residual's tile, then the block's coalesced stores.
    const int m0 = (blockIdx.x + i * gridDim.x) * kBM;
    T* tile = rs + (i % rslots) * kBM * RS;
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          T* p = tile + vct_tc::frag_row(mi, q) * RS + warp * kWN + vct_tc::frag_col(ni, q);
          float v = acc[mi][ni][q] + bias[ni][q % 2];
          if (r != nullptr) v += to_f(*p);
          put(p, relu ? fmaxf(v, 0.0f) : v);
        }
    __syncthreads();
    if constexpr (kVec) {
      constexpr int kChunks = kBN / VE;
      for (int e = tid; e < kBM * kChunks; e += kThreads) {
        const int rr = e / kChunks, c = e % kChunks;
        const int row = m0 + rr, col = n0 + c * VE;
        if (row < M && col < N) {
          __stcs(reinterpret_cast<float4*>(out + static_cast<size_t>(row) * N + col),
                 *reinterpret_cast<const float4*>(tile + rr * RS + c * VE));
        }
      }
    } else {
      for (int e = tid; e < kBM * kBN; e += kThreads) {
        const int rr = e / kBN, c = e % kBN;
        const int row = m0 + rr, col = n0 + c;
        if (row < M && col < N) out[static_cast<size_t>(row) * N + col] = tile[rr * RS + c];
      }
    }
  }
  vct_tc::cp_async_wait<0>();  // no copy outlives the CTA
}

template <typename T, int kStages, bool kResident, bool kVec>
int launch_with(const T* x, const T* w, const T* b, const T* r, T* out, int M, int K, int N,
                int relu, cudaStream_t stream) {
  auto kernel = matmul_bias_act_kernel<T, kStages, kResident, kVec>;
  const int ktiles = (K + vct_tc::tile_k<T>() - 1) / vct_tc::tile_k<T>();
  const size_t smem = smem_bytes<T, kStages, kResident>(ktiles);
  // Two driver calls, made once a device and kernel: the kernel may take
  // up to kSmemLimit bytes (each launch asks for its own), and the SM count.
  static std::atomic<int> sms_of[kMaxDevices];  // 0 until read
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int sms = sms_of[dev].load(std::memory_order_acquire);
  if (sms == 0) {
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kSmemLimit))) != cudaSuccess)
      return static_cast<int>(e);
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(e);
    sms_of[dev].store(sms, std::memory_order_release);
  }
  const int col_blocks = (N + kBN - 1) / kBN;
  const int row_blocks = (M + kBM - 1) / kBM;
  const int per_col = sms / col_blocks > 1 ? sms / col_blocks : 1;
  const dim3 grid(row_blocks < per_col ? row_blocks : per_col, col_blocks);
  kernel<<<grid, kThreads, smem, stream>>>(x, w, b, r, out, M, K, N, relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* x, const T* w, const T* b, const T* r, T* out, int M, int K, int N, int relu,
           void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int VE = vct_tc::chunk_k<T>();
  auto aligned = [](const void* p) { return p == nullptr || reinterpret_cast<size_t>(p) % 16 == 0; };
  const bool vec = K % VE == 0 && N % VE == 0 && aligned(x) && aligned(w) && aligned(r) &&
                   aligned(out);
  const int ktiles = (K + vct_tc::tile_k<T>() - 1) / vct_tc::tile_k<T>();
  if (smem_bytes<T, kStagesResident, true>(ktiles) <= kSmemLimit) {
    return vec ? launch_with<T, kStagesResident, true, true>(x, w, b, r, out, M, K, N, relu, st)
               : launch_with<T, kStagesResident, true, false>(x, w, b, r, out, M, K, N, relu, st);
  }
  return vec ? launch_with<T, kStagesStreamed, false, true>(x, w, b, r, out, M, K, N, relu, st)
             : launch_with<T, kStagesStreamed, false, false>(x, w, b, r, out, M, K, N, relu, st);
}

}  // namespace

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each returns a cudaError_t: 0 when the launch was accepted. r may be null.
extern "C" int vct_matmul_bias_act_f32(const float* x, const float* w, const float* b,
                                       const float* r, float* out, int M, int K, int N, int relu,
                                       void* stream) {
  return launch<float>(x, w, b, r, out, M, K, N, relu, stream);
}

extern "C" int vct_matmul_bias_act_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                        const __nv_bfloat16* b, const __nv_bfloat16* r,
                                        __nv_bfloat16* out, int M, int K, int N, int relu,
                                        void* stream) {
  return launch<__nv_bfloat16>(x, w, b, r, out, M, K, N, relu, stream);
}
