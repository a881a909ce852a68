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

// A query row that sees no column: a window hides every column, row - window
// >= S - 1 (causality hides none of them then). The TPU kernel runs such a row
// over every column with score NEG_INF, so each has p = exp(0) = 1: its output
// is the mean of V over the S columns and lse = NEG_INF + log(S). The CUDA
// routes give it the same: the tiles of a q tile that holds such a row run
// from column 0, and its columns below S take score 0 (p = 1, the row's
// maximum) instead of NEG_INF; its lse is NEG_INF + log(denom). A row that
// sees a column is unchanged: a masked column still has p = 0 exactly.
__host__ __device__ __forceinline__ bool blind_row(int row, int S, int window) {
  return window > 0 && row - window >= S - 1;
}

// The wgmma + TMA kernel (bf16, D = 64 or 128). Returns 0, a cudaError_t of
// the launch, or 1000 + a CUresult of the tensor-map encoding.
int flash_attention_sm90(const FlashArgs& a, cudaStream_t stream);
