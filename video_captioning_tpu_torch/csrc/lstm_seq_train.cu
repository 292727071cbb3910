// Training recurrence of the encoder: the forward that also streams out
// residuals, the backward sweep over reversed time, and the dW_hh product.
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
// Any B >= 1, H a multiple of 8 up to 1024: one forward tile for every H;
// the backward sweep's narrow form up to 600, its wide form above.
//
// What bounds it on an H100: the sweep is sequential in T, and each step's
// dh product needs all 4H dgates of every row of its direction, so a step
// costs its exchange: B x 4H bf16 dgates read back through L2 by every CTA
// (32 MB a step over the card at B = 128, H = 512, 16 units a CTA). The
// products themselves (2 x B x H x 4H multiply-adds a step, and as many
// again for dW_hh with no sequential dependence) are tensor-core work: 21.5
// G multiply-adds each at T = 80, B = 128, about 43 us at the bf16 peak.
//
// Design:
// - Forward: the kernel of lstm_seq_fwd.cuh with its residual writes on.
// - Backward sweep: the forward's shape in reverse time. CTA (d, j0) owns
//   units j0..j0+15 of direction d (masked past H) for a slice of batch
//   rows; their float32 DH and DC stay in shared memory for all T steps.
//   Its 16 rows of W_hh[d] are bf16 mma.sync B fragments in registers (warp
//   w owns k-tiles w, w + 8, ... of 4H). Each step: phase A computes the
//   CTA's 64 dgates columns elementwise, writes dxproj and publishes
//   bf16(dgates) to the exchange buffer (T, ND, B, 4H), a slot a step, which
//   the dW_hh launch then reads; the CTAs that share its rows meet at their
//   counter; phase B stages 16 rows of bf16 dgates at a time with cp.async
//   (two chunks in flight), runs m16n8k16 products with float32
//   accumulators and sums the warps' partials into DH. The exchange stays
//   bf16 from writer to mma; 16 units a CTA halve what 8 would read.
// - Backward sweep, wide form (600 < H <= 1024): CTAs of 16 units, one an
//   SM (2 x 64 at H = 1024), paired in thread block clusters that split K:
//   each CTA multiplies half of the 4H dgates columns by W_hh of the pair's
//   32 units (64 registers of W_hh a thread over 16 warps) and the two
//   partial DH meet through distributed shared memory, so each SM reads
//   half the dgates it would read alone (lstm_seq_bwd_wide_kernel; see the
//   comment above it). The first wide form (8 warps of 128 registers
//   of W_hh, 244-246 registers a thread; all 4H columns a CTA, two stages
//   in flight, each behind a cp.async wait and two barriers) took 1.458 ms
//   for the backward at (80, 2, 32, 4096), 0.909 ms of it the sweep.
// - dW_hh: one launch after the sweep, a bf16 wgmma GEMM over the (T - 1) B
//   rows of (h_keep[t - 1], bf16 dgates[t]) fed by the TMA, its rows split
//   over the CTAs of a cluster and summed in rank order through distributed
//   shared memory (lstm_seq_dw_kernel; see the comment above it). Its
//   first design (mma.sync from two shared-memory stages, float32 h_keep
//   and dxproj loaded through registers and rounded as stored, the rows
//   split into 2-5 parts whose float32 partials a second launch summed)
//   took 0.095 / 0.360 ms at B = 32 / 128 and 0.333 ms at H = 1024, B =
//   32, against 0.017 / 0.057 / 0.060 for one bf16 bmm on operands cast
//   beforehand (probe_lstm.py). Variants of it (probe_lstm.py) found it bound by getting
//   its operands in: its loads without products took 0.6 of it. Copying
//   the same tiles by 16-byte cp.async from every thread spent the threads'
//   issue slots on the copies and was slower than the TMA; stages of 32
//   rows (a ring of 6) are slower than 64 (a ring of 3) by the stages'
//   fixed cost (probe_lstm.py; PERF.md). This design took 0.029 / 0.085 /
//   0.090 ms against the first's 0.095 / 0.363 / 0.331 in one
//   compare_lstm.py call, the whole backward at B = 32 0.508 against 0.564
//   (NVIDIA H100 80GB HBM3, 700 W).
// The first version (float32 FMAs on CUDA cores, dgates widened to float32
// in shared memory, one grid-wide barrier a step, a float32 SIMT dW_hh)
// took 11.46 ms for the backward at B = 128.

#include <cuda.h>  // CUtensorMap and its enums (types only: the encoder is looked up at run time)

#include "lstm_seq_fwd.cuh"

namespace vct {

constexpr int kBwdUnits = 16;  // hidden units per CTA: 2 n-tiles of 8
constexpr int kBwdRows = 16;   // batch rows of dgates staged per chunk
constexpr int kBwdPartStride = kBwdUnits + 1;
// k-tiles of 16 over 4H per warp: ceil((4 * 600 / 16) / 8) = 19.
constexpr int kBwdKt = (4 * kMaxHidden / 16 + kWarps - 1) / kWarps;

// Row stride (bf16) of the narrow form's staged dgates chunk: all 4H
// columns; + 8 puts ldmatrix rows in distinct banks.
__host__ __device__ inline int bwd_gstride(int H) { return 4 * H + 8; }

inline size_t bwd_smem_bytes(int H, int nb) {
  return static_cast<size_t>(2 * kBwdRows) * bwd_gstride(H) * 2 +
         static_cast<size_t>(kWarps) * kBwdRows * kBwdPartStride * 4 +
         static_cast<size_t>(nb) * kBwdUnits * 8;
}

struct BwdParams {
  const void* gact;            // (T, ND, B, 4H), xproj's type
  const float* h_keep;         // (T, ND, B, H)
  const float* c_keep;         // (T, ND, B, H)
  const __nv_bfloat16* w_hh;   // (ND, H, 4H)
  const float* mask;           // (B, T) or nullptr = all valid
  const void* douts;           // (T, ND, B, H), xproj's type; nullptr = 0
  const float* dh_last;        // (ND, B, H) or nullptr = 0
  const float* dc_last;        // (ND, B, H) or nullptr = 0
  __nv_bfloat16* gbuf;         // (T, ND, B, 4H) exchange of bf16(dgates), a slot a step
  void* dxproj;                // (T, ND, B, 4H), xproj's type
  unsigned* sync;              // (ND, B) counters; ND x row_groups used
  int T, ND, B, H;
  int b0, slice_rows;          // this launch's batch rows
  int nb, row_groups;          // rows a CTA (at most), row groups a direction
};

constexpr int kBatch = 4;  // phase A items a thread loads before it computes

// The narrow form (H <= 600).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) lstm_seq_bwd_kernel(BwdParams p) {
  constexpr int Kt = kBwdKt;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H;
  const int H4 = 4 * H;
  const int gstride = bwd_gstride(H);
  const int KT = H4 / 16;
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][kBwdRows][gstride]
  float* part = reinterpret_cast<float*>(gs + 2 * kBwdRows * gstride);
  float* st_dh = part + kWarps * kBwdRows * kBwdPartStride;  // [nb][kBwdUnits]
  float* st_dc = st_dh + p.nb * kBwdUnits;

  const int unit_groups = (H + kBwdUnits - 1) / kBwdUnits;
  const RowRange rr = row_range(p, unit_groups);
  const int d = rr.d;
  const int j0 = rr.unit_group * kBwdUnits;
  unsigned* counter = p.sync + d * p.row_groups + rr.group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;

  // B fragments: B[k][n] = W_hh[d][j0 + n][k], two consecutive k in one
  // register; zero for units past H. Fragment i is k-tile w + 8 i.
  uint32_t wf[Kt][2][2];
#pragma unroll
  for (int i = 0; i < Kt; ++i) {
    const int kt = warp + i * kWarps;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int jj = j0 + nt * 8 + g;
      const uint32_t* wrow = reinterpret_cast<const uint32_t*>(
          p.w_hh + (static_cast<size_t>(d) * H + (jj < H ? jj : 0)) * H4);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        wf[i][nt][half] =
            kt < KT && jj < H ? __ldg(wrow + (kt * 16 + half * 8 + 2 * tq) / 2) : 0u;
      }
    }
  }
  for (int e = tid; e < rr.n * kBwdUnits; e += kThreads) {
    const int j = j0 + e % kBwdUnits;
    const size_t si = (static_cast<size_t>(d) * p.B + rr.b0 + e / kBwdUnits) * H + j;
    st_dh[e] = p.dh_last != nullptr && j < H ? p.dh_last[si] : 0.0f;
    st_dc[e] = p.dc_last != nullptr && j < H ? p.dc_last[si] : 0.0f;
  }
  __syncthreads();

  const T* gact = static_cast<const T*>(p.gact);
  const T* douts = static_cast<const T*>(p.douts);
  T* dx = static_cast<T*>(p.dxproj);
  const size_t step_rows = static_cast<size_t>(p.ND) * p.B;
  const int n_chunks = (rr.n + kBwdRows - 1) / kBwdRows;
  const int er = tid >> 4;               // phase B epilogue: chunk row
  const int eu = tid & (kBwdUnits - 1);  // phase B epilogue: unit
  const int vecs = H4 / 8;
  const int items = rr.n * kBwdUnits;

  for (int s = 0; s < p.T; ++s) {
    const int t = p.T - 1 - s;
    __nv_bfloat16* gnow = p.gbuf + (static_cast<size_t>(t) * p.ND + d) * p.B * H4;
    const size_t step_row = (static_cast<size_t>(t) * p.ND + d) * p.B + rr.b0;

    // Phase A: the CTA's dgates columns for its rows. Each thread loads the
    // inputs of kBatch (row, unit) items, then computes them, so their
    // loads are in flight together.
    for (int e0 = 0; e0 < items; e0 += kBatch * kThreads) {
      T ga4[kBatch][4];     // i, f, g, o as loaded
      T dout[kBatch];
      float in[kBatch][3];  // c, c_prev, m
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int e = e0 + q * kThreads + tid;
        const int j = j0 + e % kBwdUnits;
        if (e >= items || j >= H) continue;
        const int bl = e / kBwdUnits;
        const size_t row = step_row + bl;
        const T* ga = gact + row * H4 + j;
#pragma unroll
        for (int k = 0; k < 4; ++k) ga4[q][k] = ga[k * H];
        dout[q] = douts == nullptr ? T(0.0f) : douts[row * H + j];
        in[q][0] = p.c_keep[row * H + j];
        in[q][1] = t > 0 ? p.c_keep[(row - step_rows) * H + j] : 0.0f;
        in[q][2] = p.mask == nullptr ? 1.0f : p.mask[static_cast<size_t>(rr.b0 + bl) * p.T + t];
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int e = e0 + q * kThreads + tid;
        const int j = j0 + e % kBwdUnits;
        if (e >= items || j >= H) continue;
        const float gi = to_f(ga4[q][0]), gf = to_f(ga4[q][1]);
        const float gg = to_f(ga4[q][2]), go = to_f(ga4[q][3]);
        const float c_new = in[q][0], c_prev = in[q][1], m = in[q][2];
        const size_t row = step_row + e / kBwdUnits;
        const float DH = st_dh[e];
        const float DC = st_dc[e];
        const float dh_new = m * (to_f(dout[q]) + DH);
        const float tc = tanhf(c_new);
        const float do_ = dh_new * tc;
        const float dc_new = m * DC + dh_new * go * (1.0f - tc * tc);
        st_dc[e] = dc_new * gf + (1.0f - m) * DC;
        const float dg4[4] = {
            dc_new * gg * gi * (1.0f - gi),
            dc_new * c_prev * gf * (1.0f - gf),
            dc_new * gi * (1.0f - gg * gg),
            do_ * go * (1.0f - go),
        };
        T* dxr = dx + row * H4;
        unsigned short* gr = reinterpret_cast<unsigned short*>(gnow) +
                             static_cast<size_t>(rr.b0 + e / kBwdUnits) * H4;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          store_f(dxr + k * H + j, dg4[k]);
          __stcg(gr + k * H + j, __bfloat16_as_ushort(__float2bfloat16(dg4[k])));
        }
      }
    }
    if (t == 0) break;  // the cotangent of the initial state is not needed

    __syncthreads();
    if (tid == 0) {
      dir_arrive(counter);
      dir_wait(counter, static_cast<unsigned>((s + 1) * unit_groups));
    }
    __syncthreads();  // every CTA sharing these rows has published step t

    // Phase B: DH of the CTA's units, 16 rows at a time.
    auto prefetch_prev = [&]() {
      const size_t prev = step_row - step_rows;
      for (int e = tid; e < rr.n * 8; e += kThreads) {
        const size_t row = prev + e / 8;
        const int k = e % 8;
        if (k < 4) prefetch_l2(gact + row * H4 + k * H + j0);
        else if (k == 4) prefetch_l2(p.c_keep + row * H + j0);
        else if (k == 5 && t > 1) prefetch_l2(p.c_keep + (row - step_rows) * H + j0);
        else if (k == 6 && douts != nullptr) prefetch_l2(douts + row * H + j0);
      }
    };
    // Accumulator q of an m16n8 tile: row g + 8 (q / 2), column 2 tq + q % 2.
    auto store_partials = [&](const float (&acc)[2][4]) {
      float* pw = part + warp * kBwdRows * kBwdPartStride;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          pw[(g + (q >> 1) * 8) * kBwdPartStride + nt * 8 + 2 * tq + (q & 1)] = acc[nt][q];
    };
    // DH of chunk c's rows: the warps' partials of the product, plus the
    // carried DH at padded steps.
    auto add_dh = [&](int c, int rows) {
      if (er >= rows || j0 + eu >= H) return;
      const int bl = c * kBwdRows + er;
      const float m =
          p.mask == nullptr ? 1.0f : p.mask[static_cast<size_t>(rr.b0 + bl) * p.T + t];
      float sum = 0.0f;
#pragma unroll
      for (int w8 = 0; w8 < kWarps; ++w8) sum += part[(w8 * kBwdRows + er) * kBwdPartStride + eu];
      const int si = bl * kBwdUnits + eu;
      st_dh[si] = sum + (1.0f - m) * st_dh[si];
    };
    auto stage = [&](int c) {
      __nv_bfloat16* dst = gs + (c & 1) * kBwdRows * gstride;
      const int r0 = c * kBwdRows;
      const int rows = min(kBwdRows, rr.n - r0);
      for (int e = tid; e < rows * vecs; e += kThreads) {
        const int r = e / vecs;
        const int v = e % vecs;
        cp_async16(dst + r * gstride + v * 8,
                   gnow + static_cast<size_t>(rr.b0 + r0 + r) * H4 + v * 8);
      }
    };
    stage(0);
    cp_async_commit();
    if (n_chunks > 1) stage(1);
    cp_async_commit();
    prefetch_prev();  // the next phase A's inputs into L2 while phase B runs
    for (int c = 0; c < n_chunks; ++c) {
      const int rows = min(kBwdRows, rr.n - c * kBwdRows);
      cp_async_wait_one();
      __syncthreads();
      float acc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;
      const __nv_bfloat16* gb = gs + (c & 1) * kBwdRows * gstride;
#pragma unroll
      for (int i = 0; i < kBwdKt; ++i) {
        const int kt = warp + i * kWarps;
        if (kt >= KT) break;
        uint32_t a[4];
        ldmatrix_x4(a, gb + ((lane & 7) + ((lane >> 3) & 1) * 8) * gstride + kt * 16 +
                           (lane >> 4) * 8);
        mma_bf16(acc[0], a, wf[i][0][0], wf[i][0][1]);
        mma_bf16(acc[1], a, wf[i][1][0], wf[i][1][1]);
      }
      store_partials(acc);
      __syncthreads();
      if (c + 2 < n_chunks) stage(c + 2);
      cp_async_commit();
      add_dh(c, rows);
    }
    __syncthreads();  // DH complete before the next phase A reads it
  }
}

// ------------------------------------------------------- wide backward sweep
//
// 600 < H <= 1024 (the wide form). Each step a CTA multiplies the step's
// bf16 dgates of its rows by its W_hh slice; with 16 units a CTA (2 x 64
// CTAs at H = 1024, one an SM) it reads all B x 4H of them, 256 KB a CTA at
// B = 32, four times the forward's h. Probe builds (PERF.md) found
// those bytes set the sweep whatever brings them (cp.async rings of 1 to
// 5 stages, bulk copies, copies multicast to a cluster, a private region
// instead of the shared exchange). So each SM reads half:
// - Pairs of CTAs with neighbouring unit groups (the same rows) form a
//   thread block cluster that owns 32 units, and split K instead of the
//   units: CTA rank r multiplies the dgates of gates 2r and 2r + 1 (columns
//   2rH .. 2(r + 1)H of 4H) by W_hh of all 32 units, 128 KB of dgates a
//   step at B = 32. Each CTA's partial DH of the 32 units goes half to
//   itself and half into its peer's shared memory (distributed shared
//   memory), and after a cluster barrier each adds rank 0's part and rank
//   1's in that order for its own 16 units. An odd count of unit groups is
//   padded with a CTA whose units all lie past H.
// - 16 warps (512 threads), all along K: warp w owns k-tiles w, w + 16,
//   w + 32, w + 48 of each 1024-column chunk of its 2H columns (2 chunks at
//   H = 1024) for the 4 n-tiles of the 32 units: the CTA's W_hh slice
//   (32 units x 2H bf16, 128 KB) is 64 registers of B fragments a thread.
// - dgates arrive in stages of 16 rows x 1024 columns (32 KB) through a
//   ring of slots, as many as fit (bwd_wide_ring; all 4 of a step's
//   stages at B = 32, H = 1024), each thread's 16-byte
//   cp.async share completing on the slot's mbarrier; a slot is refilled as
//   soon as its products are done.
// - A row chunk's products sum over its column chunks in the accumulators;
//   the 16 warps' partials then meet in shared memory at a stride of 40
//   floats (conflict-free float2 stores) and are added in a fixed order.
// - Phase A's inputs of the next step (gact, c_keep at t and t - 1, douts,
//   the mask), which do not depend on the recurrence, are staged into
//   shared memory by cp.async during phase B, on an mbarrier of their own,
//   so phase A reads no device memory on the critical path.
// The counters and the exchange buffer are the narrow form's; the launch
// is launch_recurrence's with clusters of 2.
constexpr int kBwdWideThreads = 512;
constexpr int kBwdWideWarps = kBwdWideThreads / 32;
constexpr int kBwdCluster = 2;                      // CTAs that split K
constexpr int kBwdPairUnits = kBwdCluster * kBwdUnits;  // units of a cluster's product
constexpr int kBwdColTiles = 64;  // k-tiles of 16 a staged column chunk: 1024 columns
constexpr int kBwdColChunks = (4 * kMaxWideHidden / kBwdCluster / 16) / kBwdColTiles;
constexpr int kBwdWideKt = kBwdColTiles / kBwdWideWarps;  // a warp's k-tiles of a chunk
constexpr int kBwdWideNt = kBwdPairUnits / 8;             // n-tiles of the pair's units
constexpr int kBwdWideGStride = kBwdColTiles * 16 + 8;    // bf16 a staged row
constexpr int kBwdWidePart = kBwdPairUnits + 8;  // floats a row of a warp's partials
constexpr int kBwdMaxRing = 8;

__host__ __device__ inline int bwd_wide_bar_bytes(int ring) { return (8 * (ring + 1) + 15) / 16 * 16; }

// The ring's and the staged inputs' mbarriers, the dgates slots, the
// partials, DH and DC of nb rows, this step's mask, the two ranks' partial
// DH of the CTA's units, and the next step's inputs (float32 room whatever
// xproj's type: gact 4 x 16, c and c_prev 16 each, douts 16, the mask).
// ops/lstm_seq_train.py:bwd_wide_smem mirrors it.
__host__ __device__ inline size_t bwd_wide_smem_bytes(int nb, int ring) {
  return static_cast<size_t>(bwd_wide_bar_bytes(ring)) +
         static_cast<size_t>(ring) * kBwdRows * kBwdWideGStride * 2 +
         static_cast<size_t>(kBwdWideWarps) * kBwdRows * kBwdWidePart * 4 +
         static_cast<size_t>(nb) * kBwdUnits * 8 + static_cast<size_t>(nb + 3) / 4 * 16 +
         static_cast<size_t>(kBwdCluster) * nb * kBwdUnits * 4 +
         static_cast<size_t>(nb) * 7 * kBwdUnits * 4 + static_cast<size_t>(nb) * 4;
}

// The ring's slots for CTAs of nb rows: the most that fit, at most a
// step's stages and kBwdMaxRing; 1 when none fits (the launch then takes
// fewer rows a CTA). The launch sizes shared memory by it and the kernel
// lays it out by it. ops/lstm_seq_train.py:bwd_wide_ring mirrors it.
__host__ __device__ inline int bwd_wide_ring(int nb, int H) {
  const int col_chunks = (4 * H / kBwdCluster / 16 + kBwdColTiles - 1) / kBwdColTiles;
  const int stages = (nb + kBwdRows - 1) / kBwdRows * col_chunks;
  int ring = stages < kBwdMaxRing ? stages : kBwdMaxRing;
  while (ring > 1 && bwd_wide_smem_bytes(nb, ring) > kMaxSmem) --ring;
  return ring;
}

// 4 bytes global -> shared, through L1 (the mask: read-only in the launch).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
// 16 bytes global -> shared through L2, or 16 zero bytes when src is null
// (then `other`, a valid address, stands in for it and is not read).
__device__ __forceinline__ void cp_async16_or_zero(void* dst, const void* src,
                                                   const void* other) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src != nullptr ? src : other), "r"(src != nullptr ? 16 : 0)
               : "memory");
}
// v at p in the shared memory of cluster CTA `rank` (this CTA's own included).
__device__ __forceinline__ void st_cluster_f32(float* p, uint32_t rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_addr(p)),
               "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v) : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kBwdWideThreads, 1) lstm_seq_bwd_wide_kernel(BwdParams p) {
  constexpr int kT = kBwdWideThreads;
  constexpr int U = kBwdUnits;
  constexpr int PU = kBwdPairUnits;
  constexpr int VT = 16 / static_cast<int>(sizeof(T));  // T values a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H;
  const int H4 = 4 * H;
  const int KH = H4 / kBwdCluster;  // this CTA's columns of 4H
  const int KT = KH / 16;
  const int ring = bwd_wide_ring(p.nb, H);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [ring] slots, then the inputs'
  uint64_t* in_bar = bars + ring;
  unsigned char* q = smem + bwd_wide_bar_bytes(ring);
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(q);  // [ring][kBwdRows][kBwdWideGStride]
  q += static_cast<size_t>(ring) * kBwdRows * kBwdWideGStride * 2;
  float* part = reinterpret_cast<float*>(q);  // [warps][kBwdRows][kBwdWidePart]
  q += kBwdWideWarps * kBwdRows * kBwdWidePart * 4;
  float* st_dh = reinterpret_cast<float*>(q);  // [nb][U]
  float* st_dc = st_dh + p.nb * U;
  float* st_m = st_dc + p.nb * U;  // [nb] this step's mask
  q += static_cast<size_t>(p.nb) * U * 8 + (p.nb + 3) / 4 * 16;
  float* xp = reinterpret_cast<float*>(q);  // [kBwdCluster][nb][U]: rank r's partial DH
  q += static_cast<size_t>(kBwdCluster) * p.nb * U * 4;
  T* in_ga = reinterpret_cast<T*>(q);  // [nb][4][U]
  q += static_cast<size_t>(p.nb) * 4 * U * 4;
  float* in_c = reinterpret_cast<float*>(q);  // [nb][U]
  float* in_cp = in_c + p.nb * U;             // [nb][U]
  T* in_do = reinterpret_cast<T*>(in_cp + p.nb * U);  // [nb][U]
  float* in_m = reinterpret_cast<float*>(q + static_cast<size_t>(p.nb) * 3 * U * 4);  // [nb]

  // Unit groups padded to whole clusters: a cluster's CTAs share their rows.
  const int unit_groups = ((H + U - 1) / U + kBwdCluster - 1) / kBwdCluster * kBwdCluster;
  const RowRange rr = row_range(p, unit_groups);
  const int d = rr.d;
  const int j0 = rr.unit_group * U;  // this CTA's units (phase A)
  const uint32_t rank = cluster_rank();
  const int pj0 = j0 - static_cast<int>(rank) * U;  // the cluster's units (phase B)
  const int kbase = static_cast<int>(rank) * KH;     // this CTA's columns of 4H
  unsigned* counter = p.sync + d * p.row_groups + rr.group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int n_chunks = (rr.n + kBwdRows - 1) / kBwdRows;
  const int n_cc = (KT + kBwdColTiles - 1) / kBwdColTiles;
  const int n_stages = n_chunks * n_cc;

  // B fragments: B[k][n] = W_hh[d][pj0 + n][kbase + k], two consecutive k
  // in one register; zero for units past H and k-tiles past KT. wf[cc][i]
  // is k-tile w + 16 i of column chunk cc.
  uint32_t wf[kBwdColChunks][kBwdWideKt][kBwdWideNt][2];
#pragma unroll
  for (int cc = 0; cc < kBwdColChunks; ++cc) {
#pragma unroll
    for (int i = 0; i < kBwdWideKt; ++i) {
      const int kt = cc * kBwdColTiles + warp + i * kBwdWideWarps;
#pragma unroll
      for (int nt = 0; nt < kBwdWideNt; ++nt) {
        const int jj = pj0 + nt * 8 + g;
        const uint32_t* wrow = reinterpret_cast<const uint32_t*>(
            p.w_hh + (static_cast<size_t>(d) * H + (jj < H ? jj : 0)) * H4 + kbase);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          wf[cc][i][nt][half] =
              kt < KT && jj < H ? __ldg(wrow + (kt * 16 + half * 8 + 2 * tq) / 2) : 0u;
        }
      }
    }
  }
  for (int e = tid; e < rr.n * U; e += kT) {
    const int j = j0 + e % U;
    const size_t si = (static_cast<size_t>(d) * p.B + rr.b0 + e / U) * H + j;
    st_dh[e] = p.dh_last != nullptr && j < H ? p.dh_last[si] : 0.0f;
    st_dc[e] = p.dc_last != nullptr && j < H ? p.dc_last[si] : 0.0f;
  }
  if (p.mask == nullptr) {  // all valid: the staged mask stays 1
    for (int bl = tid; bl < rr.n; bl += kT) in_m[bl] = 1.0f;
  }
  if (tid == 0) {
    for (int i = 0; i <= ring; ++i) mbar_init(&bars[i], kT);
  }
  __syncthreads();
  cluster_sync();  // both CTAs run before either writes into the other

  const T* gact = static_cast<const T*>(p.gact);
  const T* douts = static_cast<const T*>(p.douts);
  T* dx = static_cast<T*>(p.dxproj);
  const size_t step_rows = static_cast<size_t>(p.ND) * p.B;
  const int items = rr.n * U;

  // Phase A's inputs of step t into shared memory, each thread's copies
  // then its arrival on in_bar. Rows of 16 units: gact's 4 gates and douts
  // in 16 / VT copies each, c_keep at t and t - 1 (zeros at t = 0) in 4.
  auto stage_inputs = [&](int t) {
    const size_t row0 = (static_cast<size_t>(t) * p.ND + d) * p.B + rr.b0;
    constexpr int kGa = 4 * U / VT, kDo = U / VT, kC = U / 4;
    constexpr int kRow = kGa + kDo + 2 * kC;
#pragma unroll 1
    for (int e = tid; e < rr.n * kRow; e += kT) {
      const int bl = e / kRow;
      int v = e % kRow;
      const size_t row = row0 + bl;
      void* dst;
      const void* src = nullptr;  // null: 16 zero bytes
      if (v < kGa) {
        const int k = v / (U / VT), u = (v % (U / VT)) * VT;
        dst = in_ga + (bl * 4 + k) * U + u;
        if (j0 + u < H) src = gact + row * H4 + k * H + j0 + u;
      } else if ((v -= kGa) < kDo) {
        const int u = v * VT;
        dst = in_do + bl * U + u;
        if (douts != nullptr && j0 + u < H) src = douts + row * H + j0 + u;
      } else if ((v -= kDo) < kC) {
        const int u = v * 4;
        dst = in_c + bl * U + u;
        if (j0 + u < H) src = p.c_keep + row * H + j0 + u;
      } else {
        const int u = (v - kC) * 4;
        dst = in_cp + bl * U + u;
        if (t > 0 && j0 + u < H) src = p.c_keep + (row - step_rows) * H + j0 + u;
      }
      cp_async16_or_zero(dst, src, gact);
    }
    if (p.mask != nullptr) {
      for (int bl = tid; bl < rr.n; bl += kT)
        cp_async4(in_m + bl, p.mask + static_cast<size_t>(rr.b0 + bl) * p.T + t);
    }
    mbar_arrive_on_copies(in_bar);
  };

  // Ring: the stages of steps T - 1 .. 1 in order; stage s2 of a step is
  // (row chunk s2 / n_cc, column chunk s2 % n_cc), and the step's stages
  // are chunks gbase .. gbase + n_stages - 1 of the ring: chunk gc lands in
  // slot gc % ring, for the (gc / ring)-th time.
  unsigned gbase = 0;
  stage_inputs(p.T - 1);
  for (int s = 0; s < p.T; ++s) {
    const int t = p.T - 1 - s;
    __nv_bfloat16* gnow = p.gbuf + (static_cast<size_t>(t) * p.ND + d) * p.B * H4;
    const size_t step_row = (static_cast<size_t>(t) * p.ND + d) * p.B + rr.b0;

    // Phase A: the CTA's dgates columns for its rows, from the staged inputs.
    mbar_wait(in_bar, s & 1);
    for (int e = tid; e < items; e += kT) {
      const int bl = e / U;
      const int u = e % U;
      const int j = j0 + u;
      if (j >= H) continue;
      const T* ga = in_ga + bl * 4 * U + u;
      const float gi = to_f(ga[0]), gf = to_f(ga[U]);
      const float gg = to_f(ga[2 * U]), go = to_f(ga[3 * U]);
      const float c_new = in_c[e], c_prev = in_cp[e], m = in_m[bl];
      if (u == 0) st_m[bl] = m;  // the carry of DH at a padded step
      const float DH = st_dh[e];
      const float DC = st_dc[e];
      const float dh_new = m * (to_f(in_do[e]) + DH);
      const float tc = tanhf(c_new);
      const float do_ = dh_new * tc;
      const float dc_new = m * DC + dh_new * go * (1.0f - tc * tc);
      st_dc[e] = dc_new * gf + (1.0f - m) * DC;
      const float dg4[4] = {
          dc_new * gg * gi * (1.0f - gi),
          dc_new * c_prev * gf * (1.0f - gf),
          dc_new * gi * (1.0f - gg * gg),
          do_ * go * (1.0f - go),
      };
      T* dxr = dx + (step_row + bl) * H4;
      unsigned short* gr = reinterpret_cast<unsigned short*>(gnow) +
                           static_cast<size_t>(rr.b0 + bl) * H4;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        store_f(dxr + k * H + j, dg4[k]);
        __stcg(gr + k * H + j, __bfloat16_as_ushort(__float2bfloat16(dg4[k])));
      }
    }
    if (t == 0) break;  // the cotangent of the initial state is not needed

    __syncthreads();  // the staged inputs are read; this step's dgates written
    if (tid == 0) {
      dir_arrive(counter);
      dir_wait(counter, static_cast<unsigned>((s + 1) * unit_groups));
    }
    __syncthreads();  // every CTA sharing these rows has published step t

    // Phase B: this CTA's part of the pair's DH. The next step's inputs go
    // first, so their mbarrier waits on nothing of the ring.
    stage_inputs(t - 1);
    // Thread tid copies 16-byte vector tid % 128 of rows tid / 128,
    // tid / 128 + 4, ... of the stage (a row is at most 128 vectors).
    constexpr int kRowVecs = kBwdColTiles * 2;
    auto stage = [&](int s2) {
      const unsigned gc = gbase + s2;
      const int slot = static_cast<int>(gc % ring);
      const int r0 = (s2 / n_cc) * kBwdRows;
      const int rows = min(kBwdRows, rr.n - r0);
      const int c0 = (s2 % n_cc) * kBwdColTiles * 16;
      const int v = tid % kRowVecs;
      if (v * 8 < KH - c0) {
        __nv_bfloat16* dst = gs + slot * kBwdRows * kBwdWideGStride + v * 8;
        const __nv_bfloat16* src =
            gnow + static_cast<size_t>(rr.b0 + r0) * H4 + kbase + c0 + v * 8;
#pragma unroll 1
        for (int r = tid / kRowVecs; r < rows; r += kT / kRowVecs)
          cp_async16(dst + r * kBwdWideGStride, src + static_cast<size_t>(r) * H4);
      }
      mbar_arrive_on_copies(&bars[slot]);
    };
#pragma unroll 1
    for (int s2 = 0; s2 < min(ring, n_stages); ++s2) stage(s2);
    for (int c = 0; c < n_chunks; ++c) {
      const int rows = min(kBwdRows, rr.n - c * kBwdRows);
      float acc[kBwdWideNt][4];
#pragma unroll
      for (int nt = 0; nt < kBwdWideNt; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[nt][k] = 0.0f;
#pragma unroll
      for (int cc = 0; cc < kBwdColChunks; ++cc) {
        if (cc >= n_cc) break;
        const int s2 = c * n_cc + cc;
        const unsigned gc = gbase + s2;
        const int slot = static_cast<int>(gc % ring);
        mbar_wait(&bars[slot], (gc / ring) & 1);  // stage s2 has landed
        const __nv_bfloat16* gb = gs + slot * kBwdRows * kBwdWideGStride;
#pragma unroll
        for (int i = 0; i < kBwdWideKt; ++i) {
          const int kl = warp + i * kBwdWideWarps;
          if (cc * kBwdColTiles + kl >= KT) break;
          uint32_t a[4];
          ldmatrix_x4(a, gb + ((lane & 7) + ((lane >> 3) & 1) * 8) * kBwdWideGStride +
                             kl * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int nt = 0; nt < kBwdWideNt; ++nt)
            mma_bf16(acc[nt], a, wf[cc][i][nt][0], wf[cc][i][nt][1]);
        }
        if (s2 + ring < n_stages) {
          __syncthreads();  // every warp is done with the slot
          stage(s2 + ring);
        }
      }
      // Accumulator k of an m16n8 tile: row g + 8 (k / 2), column 2 tq + k % 2.
      float* pw = part + warp * kBwdRows * kBwdWidePart;
#pragma unroll
      for (int nt = 0; nt < kBwdWideNt; ++nt)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          *reinterpret_cast<float2*>(pw + (g + h2 * 8) * kBwdWidePart + nt * 8 + 2 * tq) =
              make_float2(acc[nt][2 * h2], acc[nt][2 * h2 + 1]);
      __syncthreads();
      // The warps' partials in order: this CTA's part of DH of the pair's
      // 32 units, each half sent to the CTA that owns those units.
      const int er = tid / PU, eu = tid % PU;
      if (er < rows && pj0 + eu < H) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kBwdWideWarps; ++w) sum += part[(w * kBwdRows + er) * kBwdWidePart + eu];
        st_cluster_f32(xp + (static_cast<int>(rank) * p.nb + c * kBwdRows + er) * U + eu % U,
                       static_cast<uint32_t>(eu / U), sum);
      }
      __syncthreads();  // partials read before the next chunk's
    }
    cluster_sync();  // both ranks' parts of DH are in place
    // DH of the CTA's units: rank 0's part, rank 1's, and the carry at a
    // padded step (the same threads read DH in phase A).
    for (int e = tid; e < items; e += kT) {
      if (j0 + e % U < H)
        st_dh[e] = xp[e] + xp[p.nb * U + e] + (1.0f - st_m[e / U]) * st_dh[e];
    }
    gbase += n_stages;
  }
  cluster_sync();  // the peer may still write into this CTA's partials
}

// dW_hh: an ordinary launch after the sweep, a Hopper GEMM. CTA tiles of
// 128 k (of H) x 256 columns (of 4H), two warpgroups of 64 k each running
// wgmma m64n256k16 with float32 accumulators (128 a thread): A = h^T from
// registers, B = the dgates N-major from shared memory. The reduction's
// rows q = (t - 1) B + b, t >= 1, arrive by the TMA in stages of up to
// kDwK rows (tbox steps x bbox rows) through a ring of kDwRing
// stages on mbarriers: bf16(dgates) from the sweep's exchange buffer,
// which keeps every step's slot (T, ND, B, 4H), so no rounding and half the
// bytes of float32 dxproj, 128-byte swizzled as wgmma reads it; float32
// h_keep, 128-byte swizzled in boxes of 32 k, which each thread reads into
// its A fragments and rounds to bf16 once. The CTAs of a thread block
// cluster (blockIdx.x % parts) split the stages into parts; each
// sends the rows of its tile that another rank owns into that rank's
// shared memory, and each rank adds its rows' parts in rank order and
// stores them, so the result is the same every launch and no partial
// leaves the SMs. The parts and the boxes are the plan's
// (ops/lstm_seq_train.py:dw_plan), which the C entry validates.
constexpr int kDwM = 128;
constexpr int kDwN = 256;
constexpr int kDwK = 64;
constexpr int kDwThreads = 256;    // two warpgroups
constexpr int kDwRing = 3;         // stages in flight
constexpr int kDwMaxParts = 8;     // CTAs of a cluster that split the rows
constexpr int kDwRecvStride = kDwN + 8;  // floats a row of the parts' exchange
// A stage: the dgates (4 boxes of 64 columns, each kDwK rows of 128 bytes),
// then h (4 boxes of 32 k, the same), all 128-byte swizzled; the ring's
// mbarriers after the stages.
constexpr size_t kDwBoxBytes = static_cast<size_t>(kDwK) * 128;
constexpr size_t kDwStageBytes = 8 * kDwBoxBytes;
constexpr size_t kDwRecvBytes = static_cast<size_t>(kDwM) * kDwRecvStride * 4;
constexpr size_t kDwRegion =
    kDwRing * kDwStageBytes > kDwRecvBytes ? kDwRing * kDwStageBytes : kDwRecvBytes;
constexpr size_t kDwSmem = kDwRegion + 8 * kDwRing + 1024;

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return pack2(__float2bfloat16(lo), __float2bfloat16(hi));  // nearest even
}
// v0, v1 at p in the shared memory of cluster CTA `rank`.
__device__ __forceinline__ void st_cluster_f32x2(float* p, uint32_t rank, float v0, float v1) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_addr(p)),
               "r"(rank));
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(remote), "f"(v0), "f"(v1)
               : "memory");
}
// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}

// The box of a 4-D tensor map at coordinates c into shared memory by the
// TMA, counted on bar's transaction count; parts outside the tensor are
// zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

#define VCT_ACC8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d += A . B for a 64 x 256 x 16 step of the warpgroup: A (bf16) in
// registers, mma.sync's m16k16 fragments a warp (warp w of the group holds
// rows 16 w .. 16 w + 15), B (bf16) N-major in shared memory (descriptor
// db); float32 accumulators, 128 a thread: d[4 i + e] is row g + 8 (e / 2),
// column 8 i + 2 tq + e % 2 of the warp's rows.
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : VCT_ACC8(0), VCT_ACC8(8), VCT_ACC8(16), VCT_ACC8(24), VCT_ACC8(32), VCT_ACC8(40),
        VCT_ACC8(48), VCT_ACC8(56), VCT_ACC8(64), VCT_ACC8(72), VCT_ACC8(80), VCT_ACC8(88),
        VCT_ACC8(96), VCT_ACC8(104), VCT_ACC8(112), VCT_ACC8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef VCT_ACC8

// dw[d][k][c] = sum over t >= 1 and b of
//   bf16(h_keep[t - 1][d][b][k]) * dg[t][d][b][c]   (dg: bf16 dgates),
// part `rank` of `parts` taking stages [rank part_steps, (rank + 1)
// part_steps). map_h is h_keep as (H, B, ND, T) float32 in boxes of
// (32, bbox, 1, tbox), map_g dg as (4H, B, ND, T) bf16 in boxes of (64,
// bbox, 1, tbox); stage s holds steps t0 .. t0 + tbox - 1 (t0 = 1 + s / nbc
// tbox) and rows b0 .. b0 + bbox - 1 (b0 = s % nbc bbox), nbc = ceil(B /
// bbox).
__global__ void __launch_bounds__(kDwThreads, 1) lstm_seq_dw_kernel(
    const __grid_constant__ CUtensorMap map_h, const __grid_constant__ CUtensorMap map_g,
    float* __restrict__ dw, int parts, int part_steps, int steps, int nbc, int bbox, int tbox,
    int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDwRegion);  // [kDwRing]
  const int H4 = 4 * H;
  const int n_tiles = (H4 + kDwN - 1) / kDwN;
  const int m_tiles = (H + kDwM - 1) / kDwM;
  const int tile = blockIdx.x / parts;
  const int rank = parts > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int n0 = (tile % n_tiles) * kDwN;
  const int m0 = (tile / n_tiles % m_tiles) * kDwM;
  const int d = tile / (n_tiles * m_tiles);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int mrow = (warp / 4) * 64 + (warp % 4) * 16 + g;  // this thread's first tile row
  const int s_begin = min(steps, rank * part_steps);
  const int k_steps = min(steps, s_begin + part_steps) - s_begin;
  const int rows = bbox * tbox;  // of a stage; the rest of its kDwK stay zero
  const uint32_t stage_tx = static_cast<uint32_t>(8 * rows * 128);
  // Rows past a stage's boxes are never written: zero them in every slot.
  for (int e = tid; e < kDwRing * 8 * (kDwK - rows) * 8; e += kDwThreads) {
    const int r = rows + (e / 8) % (kDwK - rows);
    const int box = e / 8 / (kDwK - rows);  // slot * 8 + box of the slot
    *reinterpret_cast<uint4*>(smem + box * kDwBoxBytes + r * 128 + (e % 8) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    for (int i = 0; i < kDwRing; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the zeros, for the TMA and wgmma
  __syncthreads();
  // Stage s (of the part) into slot s % kDwRing by thread 0: 4 boxes of
  // dgates, then 4 of h.
  auto issue = [&](int s) {
    unsigned char* st = smem + static_cast<size_t>(s % kDwRing) * kDwStageBytes;
    uint64_t* bar = &full[s % kDwRing];
    const int gs = s_begin + s;
    const int t0 = 1 + gs / nbc * tbox;
    const int b0 = gs % nbc * bbox;
    mbar_expect_tx(bar, stage_tx);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      tma_load_4d(st + j * kDwBoxBytes, &map_g, n0 + 64 * j, b0, d, t0, bar);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      tma_load_4d(st + (4 + j) * kDwBoxBytes, &map_h, m0 + 32 * j, b0, d, t0 - 1, bar);
  };
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  if (tid == 0) {
    for (int s = 0; s < kDwRing - 1 && s < k_steps; ++s) issue(s);
  }
  // h of tile row m at stage row q: box m / 32, 16-byte chunk (m % 32) / 4
  // swizzled by q % 8.
  auto h_at = [&](const unsigned char* hst, int q, int m) {
    return *reinterpret_cast<const float*>(hst + (m >> 5) * kDwBoxBytes + q * 128 +
                                           ((((m & 31) >> 2) ^ (q & 7)) << 4) + (m & 3) * 4);
  };
  for (int s = 0; s < k_steps; ++s) {
    __syncthreads();  // every warpgroup is done with stage s - 1: its slot is free
    if (tid == 0 && s + kDwRing - 1 < k_steps) issue(s + kDwRing - 1);
    mbar_wait(&full[s % kDwRing], (s / kDwRing) & 1);  // stage s has landed
    const unsigned char* st = smem + static_cast<size_t>(s % kDwRing) * kDwStageBytes;
    const unsigned char* hst = st + 4 * kDwBoxBytes;
    // A[k][q] = h[q][k] of each k-step: rows mrow, mrow + 8; q 2 tq,
    // 2 tq + 1, and + 8; all written before the fence that wgmma needs.
    uint32_t a[kDwK / 16][4];
#pragma unroll
    for (int ks = 0; ks < kDwK / 16; ++ks) {
      const int q = ks * 16 + 2 * tq;
      a[ks][0] = bf16_pair(h_at(hst, q, mrow), h_at(hst, q + 1, mrow));
      a[ks][1] = bf16_pair(h_at(hst, q, mrow + 8), h_at(hst, q + 1, mrow + 8));
      a[ks][2] = bf16_pair(h_at(hst, q + 8, mrow), h_at(hst, q + 9, mrow));
      a[ks][3] = bf16_pair(h_at(hst, q + 8, mrow + 8), h_at(hst, q + 9, mrow + 8));
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kDwK / 16; ++ks) {
      // B: rows ks * 16 .. + 15 of the stage's dgates, 8-row groups 1024
      // bytes apart, boxes of 64 columns kDwBoxBytes apart.
      wgmma_m64n256k16_rs(acc, a[ks], wgmma_desc(smem_addr(st) + ks * 2048, kDwBoxBytes, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    // The accumulators stay where the products left them until now.
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(acc[i])::"memory");
  }
  // Accumulator 4 i + e: tile row mrow + 8 (e / 2), column 8 i + 2 tq + e % 2.
  if (parts == 1) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = m0 + mrow + half * 8;
      if (k >= H) continue;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = n0 + i * 8 + 2 * tq;
        if (c < H4) {
          *reinterpret_cast<float2*>(dw + (static_cast<size_t>(d) * H + k) * H4 + c) =
              make_float2(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
        }
      }
    }
    return;
  }
  // Rank r owns the tile's rows [r own, (r + 1) own); recv[p][row] holds
  // part p's sums of this rank's rows (it aliases the ring).
  const int own = kDwM / parts;
  float* recv = reinterpret_cast<float*>(smem);
  cluster_sync();  // every CTA of the cluster is done with its ring
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = mrow + half * 8;
    const int owner = row / own;
    float* dst = recv + static_cast<size_t>(rank * own + row - owner * own) * kDwRecvStride;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      st_cluster_f32x2(dst + i * 8 + 2 * tq, static_cast<uint32_t>(owner),
                       acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
    }
  }
  cluster_sync();  // every part of this rank's rows is in place
  for (int e = tid; e < own * (kDwN / 4); e += kDwThreads) {
    const int r = e / (kDwN / 4);
    const int c = n0 + (e % (kDwN / 4)) * 4;
    const int k = m0 + rank * own + r;
    if (k >= H || c >= H4) continue;
    const float* src = recv + static_cast<size_t>(r) * kDwRecvStride + (c - n0);
    float4 v = *reinterpret_cast<const float4*>(src);
    for (int p = 1; p < parts; ++p) {
      const float4 w = *reinterpret_cast<const float4*>(src + static_cast<size_t>(p) * own *
                                                                kDwRecvStride);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    *reinterpret_cast<float4*>(dw + (static_cast<size_t>(d) * H + k) * H4 + c) = v;
  }
}

// cuTensorMapEncodeTiled, looked up at run time by cudaGetDriverEntryPoint
// (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A 4-D tensor map of x (T, ND, B, C) as (C, B, ND, T), elements of
// `bytes` (4: float32, 2: bf16), boxes of (128 / bytes, bbox, 1, tbox),
// 128-byte swizzled, zeros outside.
int dw_map(CUtensorMap* map, const void* x, int bytes, int T, int ND, int B, int C, int bbox,
           int tbox) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                                    reinterpret_cast<void**>(&encode),
                                                    cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      encode = nullptr;
      return static_cast<int>(err != cudaSuccess ? err : cudaErrorSymbolNotFound);
    }
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(B),
                              static_cast<cuuint64_t>(ND), static_cast<cuuint64_t>(T)};
  const cuuint64_t row = static_cast<cuuint64_t>(C) * bytes;
  const cuuint64_t strides[3] = {row, row * B, row * B * ND};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / bytes), static_cast<cuuint32_t>(bbox),
                             1, static_cast<cuuint32_t>(tbox)};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult rc = encode(
      map, bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
      const_cast<void*>(x), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The sweep, then the dW_hh launch in the plan's parts a cluster and
// stages of tbox steps x bbox rows (ops/lstm_seq_train.py:dw_plan).
template <typename T>
int launch_bwd(const BwdParams& p, float* dw, int parts, int bbox, int tbox,
               cudaStream_t stream) {
  const int H = p.H;
  const int unit_groups = (H + kBwdUnits - 1) / kBwdUnits;
  int rc;
  if (H <= kMaxHidden) {
    rc = launch_recurrence(&lstm_seq_bwd_kernel<T>, p, unit_groups, kBwdRows,
                           [H](int nb) { return bwd_smem_bytes(H, nb); }, stream);
  } else {
    rc = launch_recurrence(&lstm_seq_bwd_wide_kernel<T>, p,
                           (unit_groups + kBwdCluster - 1) / kBwdCluster * kBwdCluster, kBwdRows,
                           [H](int nb) { return bwd_wide_smem_bytes(nb, bwd_wide_ring(nb, H)); },
                           stream, kBwdWideThreads, kBwdCluster);
  }
  if (rc != 0) return rc;
  const int nbc = (p.B + bbox - 1) / bbox;
  const int steps = (p.T - 1 + tbox - 1) / tbox * nbc;
  const int tiles = ((4 * H + kDwN - 1) / kDwN) * ((H + kDwM - 1) / kDwM) * p.ND;
  CUtensorMap map_h, map_g;
  rc = dw_map(&map_h, p.h_keep, 4, p.T, p.ND, p.B, H, bbox, tbox);
  if (rc == 0) rc = dw_map(&map_g, p.gbuf, 2, p.T, p.ND, p.B, 4 * H, bbox, tbox);
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaFuncSetAttribute(&lstm_seq_dw_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(kDwSmem)));
  if (rc != 0) return rc;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = parts;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * parts);
  cfg.blockDim = dim3(kDwThreads);
  cfg.dynamicSmemBytes = kDwSmem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = parts > 1 ? 1 : 0;
  rc = static_cast<int>(cudaLaunchKernelEx(&cfg, lstm_seq_dw_kernel, map_h, map_g, dw, parts,
                                           (steps + parts - 1) / parts, steps, nbc, bbox,
                                           tbox, H));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vct

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Largest H both kernels take, and the largest the narrow backward sweep
// takes (the wide sweep runs above it).
extern "C" int vct_lstm_seq_train_max_hidden() { return vct::kMaxWideHidden; }
extern "C" int vct_lstm_seq_train_narrow_max_hidden() { return vct::kMaxHidden; }

static bool bad_shape(int T, int ND, int B, int H) {
  return T <= 0 || ND <= 0 || B <= 0 || H <= 0 || H % vct::kUnits != 0 ||
         H > vct::kMaxWideHidden;
}

// Forward with residuals. hbuf is (2, ND, B, H) bf16 and sync (ND, B)
// unsigned scratch, both uninitialised; ring: the h chunk slots of the
// plan (ops/lstm_seq.py:fwd_wide_plan).
// Returns a cudaError_t: 0 when the launches were accepted.
extern "C" int vct_lstm_seq_train_fwd(
    const void* xproj, int xproj_is_bf16, const void* w_hh, const float* mask,
    void* outs, void* h_last, void* c_last, void* hbuf, void* sync, void* gact,
    float* h_keep, float* c_keep, int T, int ND, int B, int H, int ring, void* stream) {
  if (bad_shape(T, ND, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  vct::FwdParams p = {};
  p.xproj = xproj;
  p.w_hh = static_cast<const __nv_bfloat16*>(w_hh);
  p.mask = mask;
  p.outs = outs;
  p.h_last = h_last;
  p.c_last = c_last;
  p.hbuf = static_cast<__nv_bfloat16*>(hbuf);
  p.sync = static_cast<unsigned*>(sync);
  p.gact = gact;
  p.h_keep = h_keep;
  p.c_keep = c_keep;
  p.T = T;
  p.ND = ND;
  p.B = B;
  p.H = H;
  p.ring = ring;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return xproj_is_bf16 ? vct::launch_fwd<__nv_bfloat16, true>(p, st)
                       : vct::launch_fwd<float, true>(p, st);
}

// Backward sweep, then the dW_hh product. douts, dh_last and dc_last
// (float32) may be null for zeros; gbuf is (T, ND, B, 4H) bf16 (the
// sweep's bf16 dgates of every step, which the dW_hh launch reads) and
// sync (ND, B) unsigned scratch, both uninitialised; h_keep 16-byte
// aligned (the dW_hh launch stages it by 16-byte copies), and at H > 600
// gact, c_keep and douts too (the wide sweep's). Returns a cudaError_t.
extern "C" int vct_lstm_seq_train_bwd(
    const void* gact, int is_bf16, const float* h_keep, const float* c_keep,
    const void* w_hh, const float* mask, const void* douts, const float* dh_last,
    const float* dc_last, void* gbuf, void* sync, void* dxproj, float* dw, int T, int ND, int B,
    int H, int dw_parts, int dw_bbox, int dw_tbox, void* stream) {
  // The dW_hh plan: parts a power of two dividing the tile's rows, up to
  // the cluster limit; a stage's box within its kDwK rows.
  const bool bad_plan = dw_parts < 1 || dw_parts > vct::kDwMaxParts ||
                        (dw_parts & (dw_parts - 1)) != 0 || dw_bbox < 1 || dw_bbox > B ||
                        dw_tbox < 1 || dw_bbox * dw_tbox > vct::kDwK;
  if (bad_shape(T, ND, B, H) || bad_plan) return static_cast<int>(cudaErrorInvalidValue);
  vct::BwdParams p = {};
  p.gact = gact;
  p.h_keep = h_keep;
  p.c_keep = c_keep;
  p.w_hh = static_cast<const __nv_bfloat16*>(w_hh);
  p.mask = mask;
  p.douts = douts;
  p.dh_last = dh_last;
  p.dc_last = dc_last;
  p.gbuf = static_cast<__nv_bfloat16*>(gbuf);
  p.sync = static_cast<unsigned*>(sync);
  p.dxproj = dxproj;
  p.T = T;
  p.ND = ND;
  p.B = B;
  p.H = H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? vct::launch_bwd<__nv_bfloat16>(p, dw, dw_parts, dw_bbox, dw_tbox, st)
                 : vct::launch_bwd<float>(p, dw, dw_parts, dw_bbox, dw_tbox, st);
}
