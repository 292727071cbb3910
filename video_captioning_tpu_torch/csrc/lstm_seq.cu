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
// xproj's type (float32 or bfloat16).
//
// What bounds it on an H100: the recurrence is sequential in T, and each
// step needs the whole previous h of its direction. At the encoder's shape
// (T = 80, ND = 2, B = 128, H = 512) a step is 2 * 128 * 512 * 2048 = 268M
// multiply-adds on CUDA cores, and W_hh (2 x 512 x 2048 bf16 = 4 MB) does
// not fit in one SM's shared memory.
//
// Design: a cooperative launch of ND * H / 8 CTAs (128 at H = 512, one per
// SM), the kernel of lstm_seq_fwd.cuh without its residual writes: W_hh
// columns resident in shared memory, h double-buffered in device memory,
// one grid-wide barrier per step. First version: no tensor cores.

#include "lstm_seq_fwd.cuh"

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Largest H the shared-memory layout takes (227 KB a block on Hopper).
extern "C" int vct_lstm_seq_max_hidden() { return vct::fwd_max_hidden(); }

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int vct_lstm_seq(const void* xproj, int xproj_is_bf16,
                            const void* w_hh, const float* mask, void* outs,
                            void* h_last, void* c_last, float* h_state,
                            float* c_state, void* hbuf, int T, int ND, int B,
                            int H, void* stream) {
  if (T <= 0 || ND <= 0 || B <= 0 || H <= 0 || H % vct::kUnits != 0 ||
      H > vct::fwd_max_hidden()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  p.T = T;
  p.ND = ND;
  p.B = B;
  p.H = H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return xproj_is_bf16 ? vct::launch_fwd<__nv_bfloat16, false>(p, st)
                       : vct::launch_fwd<float, false>(p, st);
}
