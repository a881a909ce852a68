// Arguments of the flash-attention forward (prefill) kernels, shared by the
// route dispatch in flash_attention.cu and the Hopper kernel in
// flash_attention_sm90.cu.
#pragma once

#include "common.cuh"

struct FlashArgs {
  const void *q, *k, *v;
  void* out;
  float* lse;
  int B, H, KV, Sq, S, D;
  i64 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  float scale, softcap;
  int causal, window, q_offset;
};

// The wgmma + TMA kernel (bf16, D = 64 or 128). Returns 0, a cudaError_t of
// the launch, or 1000 + a CUresult of the tensor-map encoding.
int flash_attention_sm90(const FlashArgs& a, cudaStream_t stream);
