// The transformer family's two beam-decode attention kernels.
//
// beam_self_attention: ancestry-indexed cached self-attention of one
// decoder layer at one beam step. For beam k of clip b (row n = b*K + k)
// and each position tau <= t, the key and value are the physical cache row
// (tau, b*K + anc[b, k, tau]); per head the score is q . k / sqrt(dh), the
// softmax is float32, and the context is sum_tau w * v. Positions tau > t,
// which the TPU kernel fills with -1e9, get a weight of exp(-1e9 - m) = 0
// in float32 there, so reading only the prefix gives its result.
//
// beam_cross_attention: one query per beam over the clip's un-expanded
// encoder keys and values (B, S, D); a frame whose mask is <= 0 scores
// -1e9 (a fully masked row gets uniform weights, not NaN). Outputs the
// context and the softmax weights averaged over the heads.
//
// Replaces: video_captioning_tpu/ops/transformer_attn_pallas.py,
// _self_attn_kernel (beam_self_attention) and _cross_attn_kernel
// (beam_cross_attention), which models/transformer.py:
// decode_step_beam_core runs once per decoder block per beam step under
// kernels.transformer_fused_beam_attn (the cross kernel alone under
// kernels.transformer_fused_cross_attn).
//
// Contract (held by the tests against the plain PyTorch versions in
// ops/transformer_attn.py): q is float32 or bfloat16 and the outputs are
// in q's dtype (the TPU kernels' out_shape); the caches and the cross
// keys/values are float32 or bfloat16. Every operand is read as stored and
// widened to float32, so scores, softmax and sums are float32 whatever
// the dtypes, and a bfloat16 output is rounded once from the float32
// result. The head-mean weights in bfloat16 follow the TPU kernel's
// rounding (transformer_attn_pallas.py:_cross_attn_kernel): its grid
// averages a block of heads_per_blk heads at a time (128 lanes of heads),
// so each block's float32 sum over H is rounded to bfloat16 and the
// blocks' parts are added in block order, rounded after each add; in
// float32 the heads are summed in order and divided once, as before.
// anc[b, k, tau] lies in [0, K) for tau <= t.
//
// What bounds them on an H100: device-memory reads. The self kernel needs
// each distinct selected cache row's head slice once: at B = 128, K = 5,
// D = 512, t = 19 in float32 and a random ancestry, 8,847 of the 12,800
// rows x 512 x 4 B x 2 caches = 36 MB, about 11 us at 3.35 TB/s (beams
// that share more of their prefix select fewer); a row that several beams
// select leaves device memory once and comes from L2 after. The cross
// kernel reads the clip's keys and values once per clip, not once per
// beam: 2 x 128 x 80 x 512 x 4 B = 42 MB, about 13 us. Their operations (two FMAs a loaded
// element per beam) are far below the card's float32 rate.
//
// A bfloat16 query (the bfloat16 serving artifact's beam state) halves the
// query and context bytes and the weights': at the main shape with
// bfloat16 K/V the cross call moves about 22.4 MB, 6.7 us at 3.35 TB/s.
//
// Self: the first version ran one CTA a (clip, head) and one warp a beam,
// a lane holding columns l + 32 i; each warp read its beam's rows from
// device memory position by position, each row address waiting on its
// ancestry load. Its time followed the instructions issued, not the bytes
// (halving them with bfloat16 caches took a fifth off): each head and
// beam ran its own butterfly, softmax and loop, about 50 warp instructions
// a position. This version keeps every value's floating-point chain of the
// first one, so it gives the same bits, and changes how work and data
// move (ops/transformer_attn.py:self_plan picks the ring):
// - A warp takes a beam and four heads, 8 lanes a head; lane g holds what
//   lanes g, g + 8, g + 16, g + 24 held and adds their partial sums as the
//   butterfly's first two levels paired them, so an instruction serves
//   four heads.
// - The ancestry is read once, 32 positions a load, and broadcast by
//   shuffle; the warp streams its rows by 16-byte cp.async copies through
//   a ring of stages of four positions in shared memory (18 KB in float32
//   at the main shape, twelve CTAs an SM: one wave).
// - Tried and measured slower on an NVIDIA H100 (PERF.md): a CTA staging
//   each distinct row its beams select once, the warps synchronised a
//   chunk at a time (the syncs and the round trip a chunk cost more than
//   the bytes saved); a warp a head with that ring or with a ring of its
//   own; smaller stages with more of them; a deeper ring at fewer CTAs an
//   SM; the four positions' butterflies and exponentials shared.
// The chains: the score is fmaf(q_d, k_d, .) over d = l + 32 i in order
// for each original lane l, then the warp_sum butterfly over lanes
// (offsets 16, 8, 4, 2, 1), then * scale; the online softmax (running max
// m, rescale c = exp(m - m_new), p = exp(s - m_new), l = fmaf(l, c, p),
// acc = fmaf(p, v, acc * c)) goes over tau in order from 0; the context is
// acc / l, rounded once to q's dtype.
//
// Cross: one CTA per (clip, head), one warp per beam (K <= 16 warps). The
// clip's keys and values are shared by all K warps, so the CTA stages its
// head's slice of them in shared memory and each element leaves
// device memory once; a second small launch averages the heads' weights in
// a fixed order. The first version staged 32 frames at a time, each chunk
// loaded by plain loads between two __syncthreads and the next one not
// requested before the last was consumed, so a CTA ran six serial round
// trips to device memory (0.31 of the byte bound at B = 128, K = 5, S = 80,
// D = 512, 8 heads; warm in L2 and cold alike, so latency, not bytes, set
// it). This version keeps every value's floating-point chain of the first
// one, so it gives the same bits, and changes only how data moves
// (ops/transformer_attn.py:cross_plan picks the layout):
// - Every thread issues its share of the slice as 16-byte cp.async copies,
//   keys then values, each chunk completing on an mbarrier: where the whole
//   slice fits 24 KB (bfloat16 at the main shape) one chunk of keys and
//   one of values, both in flight from entry; else 32-frame chunks through
//   two slots, each refilled as soon as it is consumed, so that eleven
//   CTAs fit an SM and the grid runs in one wave (float32 at the main
//   shape; with the slice resident five fit, and it ran slower). The
//   copies need no division a piece.
// - Key rows are padded by 16 bytes, so the 16-byte reads of the score loop
//   (lane l scores frame l + 32 i) hit distinct banks; value rows stay
//   dense, and every shared-memory index is affine in the frame.
// - Tried and measured slower on an NVIDIA H100 (PERF.md): the head mean
//   in the same launch over a cluster of the clip's 8 heads, reading the
//   others' weights through distributed shared memory; keeping the
//   weights in shared memory instead of the L2-resident scratch was no
//   faster.
// Frames are never split across CTAs. The chains: the score is
// fmaf(q_d, k_d, .) over d = 0 .. dh - 1 in order, then * scale, then the
// mask fill; each lane sums exp(s - max) over its frames l, l + 32, ... in
// order, then the warp_sum butterfly, then w / sum; the context is
// fmaf(w_s, v_s, .) over s = 0 .. S - 1 in order; the head mean adds the
// heads in head order from 0 and divides by H. No atomics: a run repeats
// bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <mutex>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kMaskFill = -1e9f;
constexpr int kMeanThreads = 256;
constexpr int kSlots = 2;        // the cross kernel's ring slots
// The self ring (ops/transformer_attn.py:self_plan mirrors these).
constexpr int kSelfHeads = 4;      // heads a self warp, 8 lanes each
constexpr int kSelfPad = 8;        // elements after each head's row slice in a self stage
constexpr int kSelfStage = 4;      // positions a stage (1, 2 or 4)
constexpr int kSelfMaxStages = 3;  // a ring's stages at most (<= 16)
constexpr int kSelfBudget = 20480; // a ring's bytes, past two stages
constexpr int kMaxDevices = 64;  // devices whose kernel attributes are cached

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// A float32 result stored in the output's dtype: as is, or rounded to
// nearest even.
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------- cross

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// One arrival on bar once every cp.async this thread has issued has landed.
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
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

// 16 bytes global -> shared, through L2 only (read once).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// 16 bytes of shared memory as float32: four floats or eight bfloat16.
__device__ __forceinline__ void load16(float (&v)[4], const float* p) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ __forceinline__ void load16(float (&v)[8], const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v[2 * i] = __low2float(h);
    v[2 * i + 1] = __high2float(h);
  }
}

// The cross launch's operands, shape and plan (ops/transformer_attn.py:
// cross_plan: frames a chunk) with the shared-memory layout cross_layout
// fills in.
struct CrossArgs {
  const void* q;  // TQ: float or bfloat16, like ctx
  const void* ck;
  const void* cv;
  const float* mask;
  void* ctx;
  float* wh;  // (B*K, H, S) per-head scores, then weights
  int K, D, dh, S;
  float scale;
  int FC;          // frames a chunk: S (one chunk of keys, one of values) or a multiple of 32
  int nch;         // chunks a tensor; the ring's slot j at j * slot_elems
  int ldk, ldv;    // staged key and value rows' strides in elements
  int slot_elems;  // elements a slot (a chunk of keys at most)
  int off_ring, off_q, smem;
};

// Grid (B, H), 32 * K threads: warp k is beam k. kVec: dh * sizeof(T) and
// D * sizeof(T) multiples of 16 and 16-byte aligned keys and values:
// 16-byte copies, key rows padded by 16 bytes (at dh = 64, 17 or 9 pieces
// a row, so the score loop's 16-byte reads, lane l on row l, hit distinct
// banks), value rows dense (the context loop reads a row's consecutive
// columns); otherwise rows of dh + 1 elements by plain loads. kEpl =
// ceil(dh / 32) context columns a lane. TQ: q's and the context's dtype;
// the K queries' head slice is staged in shared memory as float32,
// widened as it is loaded.
template <typename T, typename TQ, int kEpl, bool kVec>
__global__ void beam_cross_attn_kernel(const CrossArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* ring = reinterpret_cast<T*>(smem + a.off_ring);
  float* qs = reinterpret_cast<float*>(smem + a.off_q);  // [K][dh]
  const TQ* qg = static_cast<const TQ*>(a.q);
  const int b = blockIdx.x;
  const int head = blockIdx.y;
  const int H = gridDim.y;
  const int K = a.K, D = a.D, dh = a.dh, S = a.S, FC = a.FC, nch = a.nch;
  const int ldk = a.ldk, ldv = a.ldv;
  const int col0 = head * dh;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int k = tid >> 5;
  const int lane = tid & 31;
  const size_t n = static_cast<size_t>(b) * K + k;
  const T* kb = static_cast<const T*>(a.ck) + static_cast<size_t>(b) * S * D + col0;
  const T* vb = static_cast<const T*>(a.cv) + static_cast<size_t>(b) * S * D + col0;
  const float* mb = a.mask == nullptr ? nullptr : a.mask + static_cast<size_t>(b) * S;
  constexpr int kEpc = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte piece
  // kVec copies: thread tid moves piece cp of rows cr, cr + crs, ... (a row
  // has at most 32 pieces, and a CTA at least 32 threads; threads past a
  // whole number of rows idle).
  const int pieces = dh / kEpc;
  const int crs = nthr / max(pieces, 1);
  const int cr = tid / max(pieces, 1);
  const int cp = tid - cr * max(pieces, 1);

  // Item j < nch is key chunk j, item nch + c value chunk c; item j lands
  // in slot j % kSlots, for the (j / kSlots)-th time.
  auto issue = [&](int j) {
    if (j >= 2 * nch) return;
    const bool key = j < nch;
    const int c = key ? j : j - nch;
    const int rows = min(FC, S - c * FC);
    const int ld = key ? ldk : ldv;
    const T* src = (key ? kb : vb) + static_cast<size_t>(c) * FC * D;
    T* dst = ring + static_cast<size_t>(j % kSlots) * a.slot_elems;
    if (kVec) {
      for (int r = cr; r < rows && cr < crs; r += crs) {
        cp_async16(dst + r * ld + cp * kEpc, src + static_cast<size_t>(r) * D + cp * kEpc);
      }
      mbar_arrive_on_copies(&bars[j % kSlots]);
    } else {
      for (int e = tid; e < rows * dh; e += nthr) {
        const int r = e / dh;
        dst[r * ld + e - r * dh] = src[static_cast<size_t>(r) * D + e - r * dh];
      }
      mbar_arrive(&bars[j % kSlots]);
    }
  };
  auto acquire = [&](int j) -> const T* {
    mbar_wait(&bars[j % kSlots], static_cast<uint32_t>((j / kSlots) & 1));
    return ring + static_cast<size_t>(j % kSlots) * a.slot_elems;
  };

  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) mbar_init(&bars[i], nthr);
  }
  __syncthreads();  // the barriers are initialised before any arrival
  for (int j = 0; j < kSlots; ++j) issue(j);
  for (int e = tid; e < K * dh; e += nthr) {
    const int kk = e / dh;
    qs[e] = to_f32(__ldg(qg + (static_cast<size_t>(b) * K + kk) * D + col0 + (e - kk * dh)));
  }
  __syncthreads();

  // Scores: lane l scores frames l, l + 32, ... (each chunk starts at a
  // multiple of 32) and keeps them in its own slots of this beam and head's
  // row of wh (L2), which only it reads back.
  float* prow = a.wh + (n * H + head) * S;
  const float* qk = qs + k * dh;
  float mx = -INFINITY;
  for (int j = 0; j < nch; ++j) {
    const T* tile = acquire(j);
    const int c0 = j * FC;
    const int c1 = min(S, c0 + FC);
    for (int s = c0 + lane; s < c1; s += 32) {
      const int r = s - c0;
      const bool valid = mb == nullptr || __ldg(mb + s) > 0.0f;
      float sc = 0.0f;
      if (kVec) {
        const T* row = tile + r * ldk;
#pragma unroll 4
        for (int p = 0; p < pieces; ++p) {
          float kv[kEpc];
          load16(kv, row + p * kEpc);
#pragma unroll
          for (int i = 0; i < kEpc; i += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qk + p * kEpc + i);
            sc = fmaf(q4.x, kv[i], sc);
            sc = fmaf(q4.y, kv[i + 1], sc);
            sc = fmaf(q4.z, kv[i + 2], sc);
            sc = fmaf(q4.w, kv[i + 3], sc);
          }
        }
      } else {
        const T* row = tile + r * ldk;
#pragma unroll 8
        for (int d = 0; d < dh; ++d) sc = fmaf(qk[d], to_f32(row[d]), sc);
      }
      sc *= a.scale;
      if (!valid) sc = kMaskFill;
      prow[s] = sc;
      mx = fmaxf(mx, sc);
    }
    if (j + kSlots < 2 * nch) {  // a ring: refill this slot once every warp is done with it
      __syncthreads();
      issue(j + kSlots);
    }
  }
  mx = warp_max(mx);
  float sum = 0.0f;
  for (int s = lane; s < S; s += 32) {
    const float e = expf(prow[s] - mx);
    prow[s] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int s = lane; s < S; s += 32) prow[s] = prow[s] / sum;

  // Context: lane l holds columns l + 32 i and takes each frame's weight
  // from the lane that owns it by a shuffle.
  float acc[kEpl];
#pragma unroll
  for (int i = 0; i < kEpl; ++i) acc[i] = 0.0f;
  for (int j = nch; j < 2 * nch; ++j) {
    const T* tile = acquire(j);
    const int c0 = (j - nch) * FC;
    const int c1 = min(S, c0 + FC);
    for (int s0 = c0; s0 < c1; s0 += 32) {
      const float wl = s0 + lane < c1 ? prow[s0 + lane] : 0.0f;
      const int m = min(32, c1 - s0);
      const T* vr = tile + (s0 - c0) * ldv + lane;
#pragma unroll 4
      for (int u = 0; u < m; ++u, vr += ldv) {
        const float w = __shfl_sync(kFullMask, wl, u);
#pragma unroll
        for (int i = 0; i < kEpl; ++i) {
          if (lane + 32 * i < dh) acc[i] = fmaf(w, to_f32(vr[32 * i]), acc[i]);
        }
      }
    }
    if (j + kSlots < 2 * nch) {
      __syncthreads();
      issue(j + kSlots);
    }
  }
#pragma unroll
  for (int i = 0; i < kEpl; ++i) {
    const int d = lane + 32 * i;
    if (d < dh) store_out(static_cast<TQ*>(a.ctx) + n * D + col0 + d, acc[i]);
  }
}

// ---------------------------------------------------------------- self

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's cp.async groups are in
// flight (0 <= pending < kSelfMaxStages).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
#define VCT_WAIT(N) \
  case N: asm volatile("cp.async.wait_group " #N ";\n" ::: "memory"); break;
    VCT_WAIT(0) VCT_WAIT(1) VCT_WAIT(2) VCT_WAIT(3) VCT_WAIT(4) VCT_WAIT(5) VCT_WAIT(6)
    VCT_WAIT(7) VCT_WAIT(8) VCT_WAIT(9) VCT_WAIT(10) VCT_WAIT(11) VCT_WAIT(12) VCT_WAIT(13)
    VCT_WAIT(14)
#undef VCT_WAIT
    default: asm volatile("cp.async.wait_group 15;\n" ::: "memory"); break;
  }
}

// The self launch's operands, shape and plan (ops/transformer_attn.py:
// self_plan), with the shared-memory layout self_layout fills in.
struct SelfArgs {
  const void* q;  // TQ: float or bfloat16, like ctx
  const void* kc;
  const void* vc;
  const int* anc;
  void* ctx;
  int K, H, D, dh, T_max, t;
  float scale;
  int stages;       // the ring: stages of kSelfStage positions
  int ldh;          // a head's row slice in a stage: dh + kSelfPad elements
  int stage_elems;  // elements a stage: [position][key, value][head][ldh]
  int smem;
};

// Grid (B * K, ceil(H / kSelfHeads)), one warp a CTA: beam n = blockIdx.x
// and heads 4 y .. 4 y + 3, 8 lanes a head. Lane g of a head's eight holds
// what lanes g, g + 8, g + 16 and g + 24 of the first version's warp held
// (columns g + 8 r + 32 i): its own four partial sums, each over i in that
// version's order; it adds them as the butterfly's offsets 16 and 8
// paired them, (P0 + P2) + (P1 + P3), then shuffles over offsets 4, 2, 1.
// The ancestry is read once, a window of 32 positions at a
// time (lane l holds anc[n, 32 w + l]; the next window's is loaded
// ahead), each position's ancestor broadcast by shuffle. The warp streams
// its beam's rows (the four heads' key and value slices, each padded by
// kSelfPad elements so that the eight-lane reads of the four heads hit
// distinct banks) through a ring of a.stages stages of kSelfStage
// positions, one cp.async group a stage, a.stages - 1 in flight while it
// reads one. Rows that several beams select come from L2 after the first.
// kVec: dh * sizeof(T) and D * sizeof(T) multiples of 16 and 16-byte
// aligned caches: 16-byte cp.async copies; otherwise plain loads.
// kEpl = ceil(dh / 32); kFull: dh == 32 * kEpl, so every column index
// below is in range and a slice's pieces are known at compile time.
template <typename T, typename TQ, int kEpl, bool kVec, bool kFull>
__global__ void __launch_bounds__(32) beam_self_attn_kernel(const SelfArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const ring = reinterpret_cast<T*>(smem);
  const int K = a.K, D = a.D, t = a.t, S = a.stages, ldh = a.ldh;
  const int dh = kFull ? 32 * kEpl : a.dh;
  const size_t N = gridDim.x;
  const size_t n = blockIdx.x;
  const int lane = threadIdx.x;
  const int hq = lane >> 3;  // this lane's head in the warp's four
  const int g = lane & 7;
  const int head = blockIdx.y * kSelfHeads + hq;
  const bool live = head < a.H;
  const int col0 = head * dh;
  const int* anc_n = a.anc + n * a.T_max;
  // Physical row (0, b * K), this lane's head's columns.
  const size_t base = (n - n % K) * D + col0;
  const T* kb = static_cast<const T*>(a.kc) + base;
  const T* vb = static_cast<const T*>(a.vc) + base;
  const TQ* qg = static_cast<const TQ*>(a.q) + n * D + col0;
  constexpr int kEpc = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte piece
  const int pieces = dh / kEpc;                             // a row slice's pieces (kVec)
  // This lane's slice of a stage's position v: key at kv_off + 2 v R, value R further.
  const int R = kSelfHeads * ldh;
  const int kv_off = hq * ldh;

  int cw = 0;  // the window of the stage being read: aw holds it, an the next
  int aw = lane <= t ? __ldg(anc_n + lane) : 0;
  int an = 32 + lane <= t ? __ldg(anc_n + 32 + lane) : 0;
  float qr[4][kEpl], acc[4][kEpl];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int i = 0; i < kEpl; ++i) {
      const int d = g + 8 * r + 32 * i;
      qr[r][i] = live && (kFull || d < dh) ? to_f32(__ldg(qg + d)) : 0.0f;
      acc[r][i] = 0.0f;
    }
  }
  float m = -INFINITY;
  float l = 0.0f;
  const int nst = t / kSelfStage + 1;
  int fill = 0;  // the slot of the next stage to copy
  int read = 0;  // the slot of the next stage to read

  // Stages -S .. -1 only copy stages 0 .. S - 1; stage s >= 0 is read,
  // then stage s + S copied into its slot, as one cp.async group (empty
  // past the prefix; lane g of a head copies its slices' pieces g, g + 8,
  // ...). The ring holds at most kSelfMaxStages stages, so a stage copied
  // lies in window cw or the next.
  for (int s = -S; s < nst; ++s) {
    if (s >= 0) {
      if ((s * kSelfStage) >> 5 != cw) {  // the next window: shift, load the one after
        ++cw;
        aw = an;
        an = 32 * (cw + 1) + lane <= t ? __ldg(anc_n + 32 * (cw + 1) + lane) : 0;
      }
      cp_async_wait(S - 1);  // stage s has landed: this lane's copies,
      __syncwarp();          // and the other lanes'
      const T* st = ring + static_cast<size_t>(read) * a.stage_elems + kv_off;
      read = read + 1 == S ? 0 : read + 1;
      const int np = min(kSelfStage, t + 1 - s * kSelfStage);
#pragma unroll
      for (int v = 0; v < kSelfStage; ++v) {
        if (v < np) {
          const T* kr = st + 2 * v * R;
          const T* vr = kr + R;
          float part[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            part[r] = 0.0f;
#pragma unroll
            for (int i = 0; i < kEpl; ++i) {
              const int d = g + 8 * r + 32 * i;
              if (kFull || d < dh) part[r] = fmaf(qr[r][i], to_f32(kr[d]), part[r]);
            }
          }
          float x = (part[0] + part[2]) + (part[1] + part[3]);
          x += __shfl_xor_sync(kFullMask, x, 4);
          x += __shfl_xor_sync(kFullMask, x, 2);
          x += __shfl_xor_sync(kFullMask, x, 1);
          const float sc = x * a.scale;
          const float m_new = fmaxf(m, sc);
          const float cc = expf(m - m_new);  // 0 at the first position (m = -inf)
          const float p = expf(sc - m_new);
          l = fmaf(l, cc, p);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int i = 0; i < kEpl; ++i) {
              const int d = g + 8 * r + 32 * i;
              const float vv = kFull || d < dh ? to_f32(vr[d]) : 0.0f;
              acc[r][i] = fmaf(p, vv, acc[r][i] * cc);
            }
          }
          m = m_new;
        }
      }
      __syncwarp();  // every lane is done with the slot
    }
    T* dst = ring + static_cast<size_t>(fill) * a.stage_elems + kv_off;
    fill = fill + 1 == S ? 0 : fill + 1;
    const int s1 = s + S;
#pragma unroll
    for (int v = 0; v < kSelfStage; ++v) {
      const int u = s1 * kSelfStage + v;
      if (u <= t) {
        const int ja = __shfl_sync(kFullMask, aw, u & 31);
        const int jn = __shfl_sync(kFullMask, an, u & 31);
        const size_t row = (static_cast<size_t>(u) * N + ((u >> 5) == cw ? ja : jn)) * D;
        T* kd = dst + 2 * v * R;
        if (live && kVec) {
#pragma unroll
          for (int c = 0; c < (pieces + 7) / 8; ++c) {  // a fixed count with kFull
            const int p = g + 8 * c;
            if (p < pieces) {
              cp_async16(kd + p * kEpc, kb + row + p * kEpc);
              cp_async16(kd + R + p * kEpc, vb + row + p * kEpc);
            }
          }
        } else if (live) {
          for (int d = g; d < dh; d += 8) {
            kd[d] = kb[row + d];
            kd[R + d] = vb[row + d];
          }
        }
      }
    }
    cp_async_commit();
  }
  if (!live) return;
  TQ* out = static_cast<TQ*>(a.ctx) + n * D + col0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int i = 0; i < kEpl; ++i) {
      const int d = g + 8 * r + 32 * i;
      if (kFull || d < dh) store_out(out + d, acc[r][i] / l);
    }
  }
}

// w[n, s] = sum over heads, in head order, of wh[n, h, s], over heads.
__global__ void __launch_bounds__(kMeanThreads)
    head_mean_kernel(const float* __restrict__ wh, float* __restrict__ w, int NS, int H, int S) {
  const int idx = blockIdx.x * kMeanThreads + threadIdx.x;
  if (idx >= NS) return;
  const int n = idx / S;
  const int s = idx - n * S;
  const float* p = wh + static_cast<size_t>(n) * H * S + s;
  float acc = 0.0f;
  for (int h = 0; h < H; ++h) acc += p[static_cast<size_t>(h) * S];
  w[idx] = acc / static_cast<float>(H);
}

// The bfloat16 weights, by the TPU kernel's rounding: heads in blocks of
// hpb, each block's float32 sum (in head order) over H rounded, the parts
// added in block order with each sum rounded.
__global__ void __launch_bounds__(kMeanThreads)
    head_mean_bf16_kernel(const float* __restrict__ wh, __nv_bfloat16* __restrict__ w, int NS,
                          int H, int S, int hpb) {
  const int idx = blockIdx.x * kMeanThreads + threadIdx.x;
  if (idx >= NS) return;
  const int n = idx / S;
  const int s = idx - n * S;
  const float* p = wh + static_cast<size_t>(n) * H * S + s;
  float out = 0.0f;
  for (int h0 = 0; h0 < H; h0 += hpb) {
    float acc = 0.0f;
    for (int h = h0; h < h0 + hpb; ++h) acc += p[static_cast<size_t>(h) * S];
    const float part = __bfloat162float(__float2bfloat16_rn(acc / static_cast<float>(H)));
    out = h0 == 0 ? part : __bfloat162float(__float2bfloat16_rn(out + part));
  }
  w[idx] = __float2bfloat16_rn(out);
}

int round16(long x) { return static_cast<int>((x + 15) / 16 * 16); }

// The shared-memory layout of a plan (ops/transformer_attn.py:cross_smem
// computes the same total). False when the plan does not hold together or
// does not fit a CTA.
bool cross_layout(CrossArgs& a, bool vec, int esz) {
  if (a.FC < 1 || a.nch != (a.S + a.FC - 1) / a.FC || (a.nch > 1 && a.FC % 32 != 0)) {
    return false;
  }
  a.ldk = vec ? a.dh + 16 / esz : a.dh + 1;
  a.ldv = vec ? a.dh : a.dh + 1;
  a.slot_elems = round16(static_cast<long>(a.FC) * a.ldk * esz) / esz;
  a.off_ring = round16(8L * kSlots);
  // One chunk a tensor: the key slot, then a value slot of its own size.
  const int staged = a.nch == 1 ? a.slot_elems * esz + round16(static_cast<long>(a.S) * a.ldv * esz)
                                : kSlots * a.slot_elems * esz;
  a.off_q = a.off_ring + staged;
  a.smem = a.off_q + round16(4L * a.K * a.dh);
  return a.smem <= 232448;
}

// A kernel's shared-memory attributes are two driver calls: set once a
// device, and again only for a larger size (the largest so far stays, in
// the caller's allowed, one entry a device). The carveout asks for as many
// CTAs an SM as shared memory allows.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, std::atomic<int> (&allowed)[kMaxDevices],
                       std::mutex& setting) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < kMaxDevices;
  if (!cached || smem > allowed[dev].load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> hold(setting);
    const int bytes = cached ? std::max(smem, allowed[dev].load()) : smem;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (cached) allowed[dev].store(bytes, std::memory_order_release);
  }
  return cudaSuccess;
}

template <typename T, typename TQ, int kEpl, bool kVec>
cudaError_t launch_cross_kernel(const CrossArgs& a, int B, int H, cudaStream_t st) {
  auto kernel = beam_cross_attn_kernel<T, TQ, kEpl, kVec>;
  static std::atomic<int> allowed[kMaxDevices];
  static std::mutex setting;
  const cudaError_t err = allow_smem(kernel, a.smem, allowed, setting);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, H), 32 * a.K, a.smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, typename TQ, int kEpl>
cudaError_t launch_cross_epl(const CrossArgs& a, int B, int H, bool vec, cudaStream_t st) {
  return vec ? launch_cross_kernel<T, TQ, kEpl, true>(a, B, H, st)
             : launch_cross_kernel<T, TQ, kEpl, false>(a, B, H, st);
}

template <typename T, typename TQ>
cudaError_t launch_cross(const CrossArgs& a, int B, int H, bool vec, cudaStream_t st) {
  switch ((a.dh + 31) / 32) {
    case 1: return launch_cross_epl<T, TQ, 1>(a, B, H, vec, st);
    case 2: return launch_cross_epl<T, TQ, 2>(a, B, H, vec, st);
    case 3: return launch_cross_epl<T, TQ, 3>(a, B, H, vec, st);
    default: return launch_cross_epl<T, TQ, 4>(a, B, H, vec, st);
  }
}

// The self plan and its shared-memory layout (ops/transformer_attn.py:
// self_plan computes the same): the ring holds the fewer of the prefix's
// stages and the most, up to kSelfMaxStages, that take at most
// kSelfBudget bytes (at least 2). False when it does not fit a CTA.
bool self_layout(SelfArgs& a, int esz) {
  const int nst = a.t / kSelfStage + 1;
  a.ldh = a.dh + kSelfPad;
  a.stage_elems = kSelfStage * 2 * kSelfHeads * a.ldh;
  const long stage = static_cast<long>(a.stage_elems) * esz;
  int S = 2;
  while (S < kSelfMaxStages && S < nst && (S + 1) * stage <= kSelfBudget) ++S;
  a.stages = std::min(S, nst);
  a.smem = static_cast<int>(a.stages * stage);
  return a.smem <= 232448;
}

template <typename T, typename TQ, int kEpl, bool kVec, bool kFull>
cudaError_t launch_self_kernel(const SelfArgs& a, int B, int H, cudaStream_t st) {
  auto kernel = beam_self_attn_kernel<T, TQ, kEpl, kVec, kFull>;
  static std::atomic<int> allowed[kMaxDevices];
  static std::mutex setting;
  const cudaError_t err = allow_smem(kernel, a.smem, allowed, setting);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * a.K, (H + kSelfHeads - 1) / kSelfHeads), 32, a.smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, typename TQ, int kEpl>
cudaError_t launch_self_epl(const SelfArgs& a, int B, int H, bool vec, cudaStream_t st) {
  const bool full = a.dh == 32 * kEpl;
  if (vec) {
    return full ? launch_self_kernel<T, TQ, kEpl, true, true>(a, B, H, st)
                : launch_self_kernel<T, TQ, kEpl, true, false>(a, B, H, st);
  }
  return full ? launch_self_kernel<T, TQ, kEpl, false, true>(a, B, H, st)
              : launch_self_kernel<T, TQ, kEpl, false, false>(a, B, H, st);
}

template <typename T, typename TQ>
cudaError_t launch_self(const SelfArgs& a, int B, int H, bool vec, cudaStream_t st) {
  switch ((a.dh + 31) / 32) {
    case 1: return launch_self_epl<T, TQ, 1>(a, B, H, vec, st);
    case 2: return launch_self_epl<T, TQ, 2>(a, B, H, vec, st);
    case 3: return launch_self_epl<T, TQ, 3>(a, B, H, vec, st);
    default: return launch_self_epl<T, TQ, 4>(a, B, H, vec, st);
  }
}

bool bad_shape(int B, int K, int H, int D) {
  return B <= 0 || K <= 0 || K > 16 || H <= 0 || D <= 0 || D % H != 0 || D / H > 128;
}

}  // namespace

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns a cudaError_t: 0 when the launch was accepted. q, ctx (B*K, D)
// float32 or (q_bf16) bfloat16; kc, vc (T, B*K, D) float32 or
// (cache_bf16) bfloat16; anc (B, K, T) int32. The plan is self_layout's.
extern "C" int vct_beam_self_attention(const void* q, const void* kc, const void* vc,
                                       const int* anc, void* ctx, int cache_bf16, int q_bf16,
                                       int B, int K, int H, int D, int T_max, int t,
                                       void* stream) {
  if (bad_shape(B, K, H, D) || t < 0 || t >= T_max) return static_cast<int>(cudaErrorInvalidValue);
  const int esz = cache_bf16 ? 2 : 4;
  SelfArgs a = {};
  a.q = q;
  a.kc = kc;
  a.vc = vc;
  a.anc = anc;
  a.ctx = ctx;
  a.K = K;
  a.H = H;
  a.D = D;
  a.dh = D / H;
  a.T_max = T_max;
  a.t = t;
  a.scale = 1.0f / sqrtf(static_cast<float>(a.dh));
  if (!self_layout(a, esz)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (a.dh * esz) % 16 == 0 && (D * esz) % 16 == 0 &&
                   reinterpret_cast<size_t>(kc) % 16 == 0 && reinterpret_cast<size_t>(vc) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (cache_bf16) {
    err = q_bf16 ? launch_self<bf16, bf16>(a, B, H, vec, st)
                 : launch_self<bf16, float>(a, B, H, vec, st);
  } else {
    err = q_bf16 ? launch_self<float, bf16>(a, B, H, vec, st)
                 : launch_self<float, float>(a, B, H, vec, st);
  }
  return static_cast<int>(err);
}

// The self launch's plan at a shape, as vct_beam_self_attention takes it:
// out[0] stages a warp's ring, out[1] shared-memory bytes a CTA. Returns a
// cudaError_t (invalid outside the kernel's domain).
extern "C" int vct_beam_self_plan(int K, int dh, int t, int cache_bf16, int* out) {
  if (K <= 0 || K > 16 || dh <= 0 || dh > 128 || t < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SelfArgs a = {};
  a.K = K;
  a.dh = dh;
  a.t = t;
  if (!self_layout(a, cache_bf16 ? 2 : 4)) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = a.stages;
  out[1] = a.smem;
  return 0;
}

// Returns a cudaError_t: 0 when both launches were accepted. q, ctx
// (B*K, D) and w (B*K, S) float32 or (q_bf16) bfloat16; ck, cv (B, S, D)
// float32 or (kv_bf16) bfloat16; mask (B, S) float32 or null (every frame
// valid); wh (B*K, H, S) float32 scratch. vec: dh * sizeof(T) and
// D * sizeof(T) multiples of 16 and ck, cv 16-byte aligned; FC: frames a
// chunk, the plan of ops/transformer_attn.py:cross_plan; hpb: heads a
// block of the bfloat16 head mean (ops/transformer_attn.py:
// heads_per_block), a divisor of H, unused in float32.
extern "C" int vct_beam_cross_attention(const void* q, const void* ck, const void* cv,
                                        const float* mask, void* ctx, float* wh, void* w,
                                        int kv_bf16, int q_bf16, int B, int K, int H, int D,
                                        int S, int vec, int FC, int hpb, void* stream) {
  if (bad_shape(B, K, H, D) || S <= 0 || (q_bf16 && (hpb < 1 || H % hpb != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int esz = kv_bf16 ? 2 : 4;
  const int dh = D / H;
  if (vec && ((dh * esz) % 16 != 0 || (D * esz) % 16 != 0 ||
              reinterpret_cast<size_t>(ck) % 16 != 0 || reinterpret_cast<size_t>(cv) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CrossArgs a = {};
  a.q = q;
  a.ck = ck;
  a.cv = cv;
  a.mask = mask;
  a.ctx = ctx;
  a.wh = wh;
  a.K = K;
  a.D = D;
  a.dh = dh;
  a.S = S;
  a.scale = 1.0f / sqrtf(static_cast<float>(dh));
  a.FC = FC;
  a.nch = (S + FC - 1) / (FC > 0 ? FC : 1);
  if (!cross_layout(a, vec != 0, esz)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const bool v = vec != 0;
  cudaError_t err;
  if (kv_bf16) {
    err = q_bf16 ? launch_cross<bf16, bf16>(a, B, H, v, st)
                 : launch_cross<bf16, float>(a, B, H, v, st);
  } else {
    err = q_bf16 ? launch_cross<float, bf16>(a, B, H, v, st)
                 : launch_cross<float, float>(a, B, H, v, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int NS = B * K * S;
  const int blocks = (NS + kMeanThreads - 1) / kMeanThreads;
  if (q_bf16) {
    head_mean_bf16_kernel<<<blocks, kMeanThreads, 0, st>>>(wh, static_cast<bf16*>(w), NS, H, S,
                                                           hpb);
  } else {
    head_mean_kernel<<<blocks, kMeanThreads, 0, st>>>(wh, static_cast<float*>(w), NS, H, S);
  }
  return static_cast<int>(cudaGetLastError());
}
