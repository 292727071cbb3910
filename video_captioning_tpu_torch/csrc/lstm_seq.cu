// Whole masked LSTM recurrence over T steps for ND direction-stacked rows,
// from hoisted input projections, in one persistent launch.
//
// Replaces: video_captioning_tpu/ops/lstm_seq_pallas.py, _kernel
// (lstm_seq_pallas), the encoder's eval-time recurrence
// (models/encoder.py).
//
// Contract (held by the tests against the plain PyTorch version in
// ops/lstm_seq.py): gates = xproj[t] + bf16(h) . bf16(W_hh) with exact
// products and float32 sums; the gate math and the carried h and c are
// float32; a padded step (mask <= 0) carries the state and emits 0; the
// final (h, c) is the state at each row's last valid step. Outputs are in
// xproj's type (float32 or bfloat16). Any B >= 1, H a multiple of 8 up to
// 1024, one tile for every H (lstm_seq_fwd.cuh).
//
// What bounds it on an H100, and the design: see lstm_seq_fwd.cuh (this
// is its kernel without the residual writes). The recurrent product runs
// on the tensor cores (mma.sync m16n8k16, bf16 operands, float32
// accumulators), which compute exactly the contract's bf16 products with
// float32 sums. The first version (float32 FMAs on CUDA cores over
// widened operands, one grid-wide barrier a step) was bound by
// shared-memory reads: 3.07 ms at (80, 2, 128, 2048) f32, about 38 us a
// step; the first tensor-core design about 0.90 ms and 11.4 us a step, and
// this one, a CTA of 16 units an SM, 0.68 ms and 8.5 us a step
// (chip_smoke.py, compare_lstm.py; NVIDIA H100 80GB HBM3, 700 W).

#include "lstm_seq_fwd.cuh"

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Largest H the kernel takes.
extern "C" int vct_lstm_seq_max_hidden() { return vct::kMaxWideHidden; }

// Returns a cudaError_t: 0 when the launches were accepted. hbuf is
// (2, ND, B, H) bf16 and sync (ND, B) unsigned scratch, both uninitialised;
// ring: the h chunk slots of the plan (ops/lstm_seq.py:fwd_wide_plan).
extern "C" int vct_lstm_seq(const void* xproj, int xproj_is_bf16,
                            const void* w_hh, const float* mask, void* outs,
                            void* h_last, void* c_last, void* hbuf, void* sync,
                            int T, int ND, int B, int H, int ring, void* stream) {
  if (T <= 0 || ND <= 0 || B <= 0 || H <= 0 || H % vct::kUnits != 0 ||
      H > vct::kMaxWideHidden) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  vct::FwdParams p = {};
  p.xproj = xproj;
  p.w_hh = static_cast<const __nv_bfloat16*>(w_hh);
  p.mask = mask;
  p.outs = outs;
  p.h_last = h_last;
  p.c_last = c_last;
  p.hbuf = static_cast<__nv_bfloat16*>(hbuf);
  p.sync = static_cast<unsigned*>(sync);
  p.T = T;
  p.ND = ND;
  p.B = B;
  p.H = H;
  p.ring = ring;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return xproj_is_bf16 ? vct::launch_fwd<__nv_bfloat16, false>(p, st)
                       : vct::launch_fwd<float, false>(p, st);
}
