// One decode step of Bahdanau (additive) attention:
//   dec_proj = W_d h + b_d                       (A per row)
//   scores   = v . tanh(enc_proj + dec_proj) + b_v (S per row)
//   weights  = softmax(mask > 0 ? scores : -1e9)
//   context  = weights . enc_outs                 (E per row)
//
// Replaces: video_captioning_tpu/ops/attention_pallas.py, _attend_kernel
// (bahdanau_attend_pallas), the attention of greedy decoding and of
// eval-mode teacher forcing when kernels.use_pallas_attention is set
// (models/attention.py:attend).
//
// Contract (held by the tests against the plain PyTorch version in
// ops/attention.py): float32 throughout; a row whose mask is all <= 0
// gets uniform weights (every score is -1e9), as the TPU kernel does; a
// null mask takes every frame; b_v is read from device memory, so the
// caller never syncs for it.
//
// What bounds it on an H100: device-memory reads. At B = 128, S = 80,
// A = E = 512 the step reads enc_proj and enc_outs once, 42 MB, about
// 12.5 us at 3.35 TB/s; its operations (one accurate tanhf and two FMAs per
// enc_proj element) are far below the card's rates, but the tanhf is a
// few dozen instructions, so the work has to spread over every SM.
//
// Design: two launches. (1) dec_proj for all rows: a CTA stages 16 rows of
// h by one bulk copy and each warp takes two units of W_d, lanes along D,
// so each staged h read feeds both. (2) Each row's frames are split over a
// thread-block cluster of CS = min(2, S) CTAs of 512 threads. A CTA's slice
// of enc_proj and of enc_outs (contiguous rows) arrives by one bulk copy a
// chunk of up to 32 frames onto an mbarrier, through a ring, both reads in
// flight from entry, before the CTA waits for dec_proj (griddepcontrol.wait;
// the launch asks for programmatic dependent launch, and dec_proj lets it
// start at once). The CTA then scores its frames (a warp a frame, lanes
// along A, accurate tanhf), keeps a running max m and sum l and an
// unnormalised partial context sum exp(s - m) enc_outs. One cluster
// barrier exchanges the CTAs' (m, l) and context shares through
// distributed shared memory; each CTA then writes its share of the context
// (the partials rescaled and added in rank order) and its own frames'
// weights. No atomics: two launches give the same bits.
//
// Measured on an H100 (compare_attention.py; PERF.md): the first version
// (one 512-thread CTA a row after dec_proj had finished, scalar enc_outs
// loads issued only after the softmax) took 0.0366 ms. Clusters of 4 or 8
// reach only 124 of the 132 SMs, so 128 rows left a second wave; clusters
// of 2 at two CTAs an SM run in one wave: 0.0312 ms, of which dec_proj is
// about 0.011 (the row launch does not start beside it: two dec_proj CTAs
// and a 512-thread row CTA do not fit one SM's registers).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kProjThreads = 256;
constexpr int kProjRows = 16;
constexpr int kProjUnits = 16;  // 2 a warp
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kMaskFill = -1e9f;
constexpr int kRawFrames = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// One arrival on bar that also expects `bytes` more of copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of bar with this parity to complete. A copy that
// never lands (a fault in the plan) traps after about 2^28 tries, seconds,
// instead of holding the card.
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

// bytes (a multiple of 16) of contiguous device memory into shared memory
// by the TMA, counted on bar's transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Store v at p's offset in cluster CTA `rank`'s shared memory.
__device__ __forceinline__ void st_cluster_f32(float* p, int rank, float v) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(smem_addr(p)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// dp[b][a] = sum_d h[b][d] * W_d[a][d] + b_d[a]; grid (A / 16, B / 16).
// The CTA stages its 16 rows of h (one bulk copy when kVec: D % 4 == 0
// and aligned h, W_d; else plain loads), then each warp takes two units at
// once, the lanes along D, so every staged h read feeds four FMAs of each.
template <bool kVec>
__global__ void __launch_bounds__(kProjThreads)
    dec_proj_kernel(const float* __restrict__ h, const float* __restrict__ w_d,
                    const float* __restrict__ b_d, float* __restrict__ dp, int B,
                    int D, int A) {
  // The row launch may start now: it reads dp only after griddepcontrol.wait.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ __align__(16) unsigned char proj_smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(proj_smem);
  float* hs = reinterpret_cast<float*>(proj_smem + 16);  // [kProjRows][D]
  const int b0 = blockIdx.y * kProjRows;
  const int nr = min(kProjRows, B - b0);
  const float* hb = h + static_cast<size_t>(b0) * D;
  if (kVec) {
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_expect_tx(bar, nr * D * 4);
      bulk_load(hs, hb, nr * D * 4, bar);
    }
  } else {
    for (int e = threadIdx.x; e < nr * D; e += kProjThreads) hs[e] = __ldg(hb + e);
  }
  const int lane = threadIdx.x & 31;
  if (kVec) {
    __syncthreads();  // the mbarrier is initialised
    mbar_wait(bar, 0);
  } else {
    __syncthreads();
  }
  const int a_end = min(A, (blockIdx.x + 1) * kProjUnits);
  for (int a0 = blockIdx.x * kProjUnits + 2 * (threadIdx.x >> 5); a0 < a_end;
       a0 += 2 * (kProjThreads / 32)) {
    const int a1 = min(a0 + 1, A - 1);
    float acc[2][kProjRows] = {};
    const float* w0 = w_d + static_cast<size_t>(a0) * D;
    const float* w1 = w_d + static_cast<size_t>(a1) * D;
    if (kVec) {
#pragma unroll 2
      for (int d4 = lane; d4 < D / 4; d4 += 32) {
        const float4 u = __ldg(reinterpret_cast<const float4*>(w0) + d4);
        const float4 v = __ldg(reinterpret_cast<const float4*>(w1) + d4);
#pragma unroll
        for (int r = 0; r < kProjRows; ++r) {
          if (r < nr) {
            const float4 x = reinterpret_cast<const float4*>(hs + r * D)[d4];
            acc[0][r] = fmaf(x.x, u.x, fmaf(x.y, u.y, fmaf(x.z, u.z, fmaf(x.w, u.w, acc[0][r]))));
            acc[1][r] = fmaf(x.x, v.x, fmaf(x.y, v.y, fmaf(x.z, v.z, fmaf(x.w, v.w, acc[1][r]))));
          }
        }
      }
    } else {
      for (int d = lane; d < D; d += 32) {
        const float u = __ldg(w0 + d), v = __ldg(w1 + d);
#pragma unroll
        for (int r = 0; r < kProjRows; ++r) {
          if (r < nr) {
            acc[0][r] = fmaf(hs[r * D + d], u, acc[0][r]);
            acc[1][r] = fmaf(hs[r * D + d], v, acc[1][r]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int a = a0 + u;
      if (a >= a_end) break;
      const float bias = __ldg(b_d + a);
#pragma unroll
      for (int r = 0; r < kProjRows; ++r) {
        if (r < nr) {
          const float t = warp_sum(acc[u][r]);
          if (lane == 0) dp[static_cast<size_t>(b0 + r) * A + a] = t + bias;
        }
      }
    }
  }
}

// The row launch's operands, shape and plan (ops/attention.py:attend_plan:
// cluster size, frames a chunk, ring slots, resident) with the shared-memory
// layout attend_layout fills in.
struct AttendArgs {
  const float* dp;
  const float* enc_proj;
  const float* enc_outs;
  const float* v;
  const float* b_v;
  const float* mask;
  float* context;
  float* weights;
  int S, A, E;
  int CS;        // CTAs a row (the cluster); CTA r takes frames [r S / CS, (r + 1) S / CS)
  int FC;        // frames a chunk, at most 32
  int nst;       // ring slots, each one chunk of enc_proj or of enc_outs
  int resident;  // every chunk in its own slot, loaded once at entry
  int slot_floats, off_dps, off_vs, off_ctx, off_sc, off_stat, off_raw, off_srecv, off_crecv;
  int smem;
};

// Grid B x CS, clusters of the CS CTAs of one row; kThreads threads. kBulk:
// A and E multiples of 4 and 16-byte aligned operands, so each chunk is one
// bulk copy; otherwise every thread loads the chunk when it is needed.
template <bool kBulk>
__global__ void __launch_bounds__(kThreads, 2) attend_cluster_kernel(const AttendArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + 16 * ((8 * a.nst + 15) / 16));
  float* dps = reinterpret_cast<float*>(smem + a.off_dps);  // [A]
  float* vs = reinterpret_cast<float*>(smem + a.off_vs);    // [A]
  float* cx = reinterpret_cast<float*>(smem + a.off_ctx);   // [E] partial context
  float* scs = reinterpret_cast<float*>(smem + a.off_sc);   // [2][FC] chunks' scores
  float* stat = reinterpret_cast<float*>(smem + a.off_stat);  // chunk's rescale, m, l
  float* srecv = reinterpret_cast<float*>(smem + a.off_srecv);  // [CS][2] the cluster's (m, l)
  float* crecv = reinterpret_cast<float*>(smem + a.off_crecv);  // [CS][E / CS] partial contexts

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / a.CS;
  const int S = a.S, A = a.A, E = a.E, FC = a.FC;
  const int s0 = static_cast<int>(static_cast<long>(rank) * S / a.CS);
  const int s1 = static_cast<int>(static_cast<long>(rank + 1) * S / a.CS);
  const int nch = (s1 - s0 + FC - 1) / FC;
  const int total = 2 * nch;  // items: enc_proj chunk c is 2c, enc_outs chunk c is 2c + 1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* ep = a.enc_proj + (static_cast<size_t>(b) * S + s0) * A;
  const float* eo = a.enc_outs + (static_cast<size_t>(b) * S + s0) * E;
  float* wrow = a.weights + static_cast<size_t>(b) * S + s0;
  // The CTA's raw scores until the end: in shared memory, or where they
  // fit no more, in the weights output itself (each read back by the
  // thread that wrote it).
  float* raw = a.off_raw ? reinterpret_cast<float*>(smem + a.off_raw) : wrow;

  auto issue = [&](int j) {  // thread 0: start item j's copy into its slot
    if (j >= total) return;
    const int slot = j % a.nst;
    const int c = j >> 1;
    const int width = (j & 1) ? E : A;
    const int bytes = min(FC, s1 - s0 - c * FC) * width * 4;
    mbar_expect_tx(&bars[slot], bytes);
    bulk_load(ring + static_cast<size_t>(slot) * a.slot_floats,
              ((j & 1) ? eo : ep) + static_cast<size_t>(c) * FC * width, bytes, &bars[slot]);
  };
  auto acquire = [&](int j) -> const float* {
    const int slot = j % a.nst;
    float* tile = ring + static_cast<size_t>(slot) * a.slot_floats;
    if (kBulk) {
      mbar_wait(&bars[slot], static_cast<uint32_t>((j / a.nst) & 1));
    } else {
      const int c = j >> 1;
      const int width = (j & 1) ? E : A;
      const int count = min(FC, s1 - s0 - c * FC) * width;
      const float* src = ((j & 1) ? eo : ep) + static_cast<size_t>(c) * FC * width;
      for (int e = tid; e < count; e += kThreads) tile[e] = __ldg(src + e);
      __syncthreads();
    }
    return tile;
  };

  if (kBulk) {
    if (tid == 0) {
      for (int i = 0; i < a.nst; ++i) mbar_init(&bars[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      const int first = a.resident ? total : min(a.nst, total);
      for (int j = 0; j < first; ++j) issue(j);
    }
  }
  for (int i = tid; i < A; i += kThreads) vs[i] = __ldg(a.v + i);
  for (int i = tid; i < E; i += kThreads) cx[i] = 0.0f;
  const float bias_v = __ldg(a.b_v);
  // dec_proj comes from the launch before this one.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int i = tid; i < A; i += kThreads) dps[i] = a.dp[static_cast<size_t>(b) * A + i];
  __syncthreads();

  float m_run = -INFINITY, l_run = 0.0f;  // warp 0's, the same in every lane
  for (int c = 0; c < nch; ++c) {
    const int fc = min(FC, s1 - s0 - c * FC);
    float* sc = scs + (c & 1) * FC;  // the previous chunk's may still be read
    const float* pt = acquire(2 * c);
    for (int f = warp; f < fc; f += kWarps) {
      const float* row = pt + f * A;
      float acc = 0.0f;
      if (kBulk) {
        const float4* r4 = reinterpret_cast<const float4*>(row);
        const float4* d4 = reinterpret_cast<const float4*>(dps);
        const float4* v4 = reinterpret_cast<const float4*>(vs);
#pragma unroll 4
        for (int i = lane; i < A / 4; i += 32) {
          const float4 e = r4[i];
          const float4 d = d4[i];
          const float4 w = v4[i];
          acc = fmaf(w.x, tanhf(e.x + d.x), acc);
          acc = fmaf(w.y, tanhf(e.y + d.y), acc);
          acc = fmaf(w.z, tanhf(e.z + d.z), acc);
          acc = fmaf(w.w, tanhf(e.w + d.w), acc);
        }
      } else {
#pragma unroll 4
        for (int i = lane; i < A; i += 32) acc = fmaf(vs[i], tanhf(row[i] + dps[i]), acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        const int s = c * FC + f;
        const bool valid = a.mask == nullptr || __ldg(a.mask + static_cast<size_t>(b) * S + s0 + s) > 0.0f;
        const float score = valid ? acc + bias_v : kMaskFill;
        sc[f] = score;
        raw[s] = score;
      }
    }
    __syncthreads();
    if (kBulk && !a.resident && tid == 0) {
      issue(2 * c + a.nst);                  // this chunk's enc_proj slot is free
      if (c > 0) issue(2 * c - 1 + a.nst);   // so is the previous chunk's enc_outs slot
    }
    if (warp == 0) {
      const float x = lane < fc ? sc[lane] : -INFINITY;
      const float m_new = fmaxf(m_run, warp_max(x));
      const float e = lane < fc ? expf(x - m_new) : 0.0f;
      if (lane < fc) sc[lane] = e;
      const float rs = expf(m_run - m_new);  // 0 at the first chunk
      l_run = fmaf(l_run, rs, warp_sum(e));
      m_run = m_new;
      if (lane == 0) {
        stat[0] = rs;
        stat[1] = m_run;
        stat[2] = l_run;
      }
    }
    __syncthreads();
    const float* ot = acquire(2 * c + 1);
    const float rs = stat[0];
    for (int e = tid; e < E; e += kThreads) {
      float acc = cx[e] * rs;
      for (int f = 0; f < fc; ++f) acc = fmaf(sc[f], ot[f * E + e], acc);
      cx[e] = acc;
    }
  }

  // Push this CTA's (m, l) to every CTA of the cluster and each CTA's
  // share of the context columns, [r E / CS, (r + 1) E / CS), to CTA r;
  // after one cluster barrier each CTA reads only its own shared memory.
  const int ecs = (E + a.CS - 1) / a.CS;  // a share's columns, at most
  if (tid < a.CS) {
    st_cluster_f32(srecv + 2 * rank, tid, stat[1]);
    st_cluster_f32(srecv + 2 * rank + 1, tid, stat[2]);
  }
  for (int e = tid; e < E; e += kThreads) {
    // The last CTA whose share starts at or before e.
    const int own = static_cast<int>((static_cast<long>(e + 1) * a.CS + E - 1) / E) - 1;
    const int start = static_cast<int>(static_cast<long>(own) * E / a.CS);
    st_cluster_f32(crecv + rank * ecs + e - start, own, cx[e]);
  }
  cluster.sync();  // every push has landed
  float m_row = -INFINITY;
  for (int r = 0; r < a.CS; ++r) m_row = fmaxf(m_row, srecv[2 * r]);
  float fac[8], l_row = 0.0f;  // exp(m_r - m_row), CS <= 8, and the row's sum in rank order
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    fac[r] = r < a.CS ? expf(srecv[2 * r] - m_row) : 0.0f;
    if (r < a.CS) l_row += srecv[2 * r + 1] * fac[r];
  }
  const int e0 = static_cast<int>(static_cast<long>(rank) * E / a.CS);
  const int e1 = static_cast<int>(static_cast<long>(rank + 1) * E / a.CS);
  for (int e = e0 + tid; e < e1; e += kThreads) {
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r < a.CS) acc += crecv[r * ecs + e - e0] * fac[r];
    }
    a.context[static_cast<size_t>(b) * E + e] = acc / l_row;
  }
  for (int c = 0; c < nch; ++c) {  // the threads that wrote each score
    const int fc = min(FC, s1 - s0 - c * FC);
    for (int f = warp; f < fc; f += kWarps) {
      if (lane == 0) wrow[c * FC + f] = expf(raw[c * FC + f] - m_row) / l_row;
    }
  }
}

int round16(long x) { return static_cast<int>((x + 15) / 16 * 16); }

// The shared-memory layout of a plan (ops/attention.py:attend_smem computes
// the same total). False when the plan does not hold together or does not
// fit a CTA.
bool attend_layout(AttendArgs& a, int B) {
  if (a.CS < 1 || a.CS > 8 || a.CS > a.S || a.FC < 1 || a.FC > 32 || a.nst < 2) return false;
  const int fr = (a.S + a.CS - 1) / a.CS;  // most frames a CTA
  if (a.resident && a.nst < 2 * ((fr + a.FC - 1) / a.FC)) return false;
  a.slot_floats = round16(4L * a.FC * (a.A > a.E ? a.A : a.E)) / 4;
  a.off_dps = round16(8L * a.nst) + a.nst * a.slot_floats * 4;
  a.off_vs = a.off_dps + round16(4L * a.A);
  a.off_ctx = a.off_vs + round16(4L * a.A);
  a.off_sc = a.off_ctx + round16(4L * a.E);
  a.off_stat = a.off_sc + round16(8L * a.FC);
  // The raw scores in shared memory while a CTA's frames fit 4 KB.
  a.off_raw = fr <= kRawFrames ? a.off_stat + 16 : 0;
  a.off_srecv = a.off_stat + 16 + (a.off_raw ? round16(4L * fr) : 0);
  a.off_crecv = a.off_srecv + round16(8L * a.CS);
  a.smem = a.off_crecv + round16(4L * a.CS * ((a.E + a.CS - 1) / a.CS));
  return B > 0 && a.smem <= 232448;
}

template <bool kBulk>
cudaError_t launch_rows(const AttendArgs& a, int B, cudaStream_t st) {
  auto kernel = attend_cluster_kernel<kBulk>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         a.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.CS);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns a cudaError_t: 0 when both launches were accepted. dp is (B, A)
// float32 scratch; mask (B, S) float32 or null (every frame valid). bulk:
// A % 4 == E % 4 == 0 and enc_proj, enc_outs 16-byte aligned; CS, FC, nst,
// resident: the plan of ops/attention.py:attend_plan.
extern "C" int vct_bahdanau_attend_f32(const float* h, const float* w_d,
                                       const float* b_d, const float* enc_proj,
                                       const float* enc_outs, const float* v,
                                       const float* b_v, const float* mask,
                                       float* dp, float* context, float* weights,
                                       int B, int S, int D, int A, int E, int bulk, int CS,
                                       int FC, int nst, int resident, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || A <= 0 || E <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AttendArgs a = {};
  a.dp = dp;
  a.enc_proj = enc_proj;
  a.enc_outs = enc_outs;
  a.v = v;
  a.b_v = b_v;
  a.mask = mask;
  a.context = context;
  a.weights = weights;
  a.S = S;
  a.A = A;
  a.E = E;
  a.CS = CS;
  a.FC = FC;
  a.nst = nst;
  a.resident = resident && bulk;
  if (!attend_layout(a, B) || (bulk && (A % 4 || E % 4))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t proj_smem = 16 + sizeof(float) * kProjRows * D;
  const bool vec4 = D % 4 == 0 && reinterpret_cast<size_t>(h) % 16 == 0 &&
                    reinterpret_cast<size_t>(w_d) % 16 == 0;
  const void* proj = vec4 ? reinterpret_cast<const void*>(dec_proj_kernel<true>)
                          : reinterpret_cast<const void*>(dec_proj_kernel<false>);
  cudaError_t err = set_smem(proj, proj_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 proj_grid((A + kProjUnits - 1) / kProjUnits, (B + kProjRows - 1) / kProjRows);
  if (vec4) {
    dec_proj_kernel<true><<<proj_grid, kProjThreads, proj_smem, st>>>(h, w_d, b_d, dp, B, D, A);
  } else {
    dec_proj_kernel<false><<<proj_grid, kProjThreads, proj_smem, st>>>(h, w_d, b_d, dp, B, D, A);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = bulk ? launch_rows<true>(a, B, st) : launch_rows<false>(a, B, st);
  return static_cast<int>(err);
}
