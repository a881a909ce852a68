// Arguments and index rules of the flash-attention backward kernels, shared by
// the route dispatch in flash_attention_bwd.cu (the fp32 FMA and `mma.sync`
// routes) and the Hopper kernels of flash_attention_bwd_sm90.cu.
#pragma once

#include "common.cuh"

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float* lse;
  float* delta;            // read; written first by the dq kernel when delta_from_out
  void *dq, *dk, *dv;
  const void* out;         // the forward's output, read when delta_from_out
  int B, H, KV, Sq, S, D;
  i64 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss;
  i64 dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss, o_sb, o_sh, o_ss;
  float scale, softcap;
  int causal, window, q_offset, delta_from_out;
};

// qr: q row inside the call (0..Sq-1 is real), kc: kv column.
__device__ __forceinline__ bool visible(const BwdArgs& a, int qr, int kc) {
  bool ok = qr < a.Sq && kc < a.S;
  const int row = a.q_offset + qr;
  if (a.causal) ok = ok && kc <= row;
  if (a.window > 0) ok = ok && kc > row - a.window;
  return ok;
}

// The kv tiles (of BN columns) a q tile of rows r0..r0+rows-1 can see.
__device__ __forceinline__ void kv_range(const BwdArgs& a, int r0, int rows, int BN,
                                         int& jt0, int& jt1) {
  const int row_min = a.q_offset + r0;
  const int row_max = a.q_offset + r0 + rows - 1;
  const int hi = a.causal ? min(a.S, row_max + 1) : a.S;
  const int lo = a.window > 0 ? max(0, row_min - a.window + 1) : 0;
  jt0 = lo / BN;
  jt1 = hi > lo ? (hi + BN - 1) / BN : jt0;
}

// The q tiles (of BQ rows) that can see kv columns c0..c0+cols-1.
__device__ __forceinline__ void q_range(const BwdArgs& a, int c0, int cols, int BQ,
                                        int& qt0, int& nqt) {
  const int cmax = c0 + cols - 1;
  const int lo = a.causal ? max(0, c0 - a.q_offset) : 0;
  const int hi = a.window > 0 ? min(a.Sq - 1, cmax + a.window - 1 - a.q_offset) : a.Sq - 1;
  qt0 = lo / BQ;
  nqt = (cols > 0 && hi >= lo) ? hi / BQ - qt0 + 1 : 0;
}

// The wgmma + TMA kernels (bf16, D = 64 or 128). Returns 0, a cudaError_t of
// a launch, or 1000 + a CUresult of a tensor-map encoding.
int flash_attention_bwd_sm90(const BwdArgs& a, cudaStream_t stream);
