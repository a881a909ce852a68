// Causal / sliding-window / soft-capped GQA flash attention (prefill) for
// Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body `_kernel`). That kernel puts the KV tiles on the innermost, sequential
// grid dimension and carries (acc, m, l) in scratch memory from one grid step
// to the next. On this card blocks run in no order and share nothing, so the
// KV walk is a loop inside the block: one block per (batch, q head, 64-row q
// tile), K/V tiles staged through shared memory, fp32 (acc, m, l) in
// registers.
//
// What bounds it on this card: at the serving prompt length (512) the bytes of
// q, k, v and out take longer to move than the tensor cores would need for the
// products, so the floor is the memory one. Two code paths share the design:
//   * bf16 inputs: both products run on the tensor cores (`mma.sync`
//     m16n8k16, fp32 accumulators). Four warps a block, 16 q rows a warp; Q, K
//     and V tiles sit in shared memory with a 16-byte row pad so that
//     `ldmatrix` reads them without bank conflicts; K and V arrive by
//     `cp.async`, the next K tile while the softmax and the second product of
//     the current one run, the next V tile during the next scores, each in its
//     one buffer; the score tile never leaves registers: its accumulator
//     layout is the A-operand layout of the second product, so P is only
//     rounded to bf16 in place;
//   * fp32 inputs: both products are fp32 FMAs on the CUDA cores (exact
//     inputs, no tensor-core rounding), 256 threads a block. This path is
//     bound by its own arithmetic; the parity tests use it, the serving path
//     (bf16) does not.
// bf16 at D = 64, 128 and 256 (the serving and training shapes, gemma2's
// head dim) runs instead on the `wgmma` + TMA kernel of
// flash_attention_sm90.cu; these two paths keep fp32 and bf16 at D = 16 (the
// smoke configs).
// What the design does about the work it can avoid:
//   * the loop visits only the KV tiles a q tile can see: it stops at the
//     causal diagonal and, with a window, starts at the first tile holding a
//     column > row - window (the TPU kernel runs the tiles below the window
//     and masks them whole);
//   * GQA by index: q head h reads kv head h / (H / KV), K/V are never
//     repeated in memory;
//   * operands come in through strides (last dim contiguous), so the model's
//     (B, S, H, D) tensors are read in place without a transpose copy;
//   * the heaviest q tiles (the last ones under a causal mask) are scheduled
//     first.
// A probability of a masked column is exactly 0 (not exp(0)), so a row that
// sees nothing in a visited tile gathers no garbage; a row that sees no column
// at all gives what the TPU kernel gives (blind_row in flash_attention.cuh).
#include <cstdint>

#include "flash_attention.cuh"

namespace {

constexpr int BM = 64;        // q rows per block
constexpr int kThreads = 256; // 16 x 16: thread (ty, tx) owns rows 4*ty..4*ty+3

// ---------------------------------------------------------------------------
// fp32 path: FMAs on the CUDA cores

// Copies `rows` rows of D floats (row r at src + r * stride) into a staged tile
// of row stride D + 1 (odd, so that a column of 16 rows hits 16 different
// banks), zero-filling rows at or beyond `valid`.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, i64 stride, int rows,
                                      int valid) {
  constexpr int NV = D / 4;
  for (int idx = threadIdx.x; idx < rows * NV; idx += kThreads) {
    const int r = idx / NV, c = (idx % NV) * 4;
    float4 raw = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) raw = *reinterpret_cast<const float4*>(src + (i64)r * stride + c);
    float* d = dst + r * (D + 1) + c;
    d[0] = raw.x; d[1] = raw.y; d[2] = raw.z; d[3] = raw.w;
  }
}

template <int D, int BN>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashArgs a) {
  typedef float T;
  constexpr int LD = D + 1;
  constexpr int CN = BN / 16;            // score columns per thread
  constexpr int CD = D / 16;             // output columns per thread
  constexpr int LDS = BN + 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + BM * LD;
  T* sV = sK + BN * LD;
  float* sP = reinterpret_cast<float*>(sV + BN * LD);

  const int nq = gridDim.x;
  const int qi = nq - 1 - blockIdx.x;    // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.KV);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = qi * BM;
  const int rows_here = min(BM, a.Sq - r0);

  const T* qp = (const T*)a.q + (i64)b * a.q_sb + (i64)h * a.q_sh + (i64)r0 * a.q_ss;
  const T* kp = (const T*)a.k + (i64)b * a.k_sb + (i64)hk * a.k_sh;
  const T* vp = (const T*)a.v + (i64)b * a.v_sb + (i64)hk * a.v_sh;

  stage<D>(sQ, qp, a.q_ss, BM, rows_here);

  // KV range this q tile can see
  const int row_min = a.q_offset + r0;
  const int row_max = a.q_offset + r0 + rows_here - 1;
  const int hi = a.causal ? min(a.S, row_max + 1) : a.S;
  const int lo = a.window > 0 && !blind_row(row_max, a.S, a.window)
                     ? max(0, row_min - a.window + 1) : 0;
  const int jt0 = lo / BN;
  const int jt1 = (hi + BN - 1) / BN;

  float m[4], l[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF; l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  for (int jt = jt0; jt < jt1; ++jt) {
    const int c0 = jt * BN;
    __syncthreads();                     // the previous tile is consumed
    stage<D>(sK, kp + (i64)c0 * a.k_ss, a.k_ss, BN, a.S - c0);
    stage<D>(sV, vp + (i64)c0 * a.v_ss, a.v_ss, BN, a.S - c0);
    __syncthreads();

    // scores: rows 4*ty + i, columns tx + 16*c
    float s[4][CN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[CN];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(4 * ty + i) * LD + d];
#pragma unroll
      for (int c = 0; c < CN; ++c) kv[c] = sK[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) s[i][c] += qv[i] * kv[c];
    }

    // mask, online softmax; the 16 threads of a row sit in one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = a.q_offset + r0 + 4 * ty + i;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int col = c0 + tx + 16 * c;
        bool ok = col < a.S;
        if (a.causal) ok = ok && col <= row;
        if (a.window > 0) ok = ok && col > row - a.window;
        s[i][c] = ok ? softcap_f(s[i][c] * a.scale, a.softcap)
                     : (blind_row(row, a.S, a.window) && col < a.S ? 0.f : NEG_INF);
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const float p = s[i][c] > 0.5f * NEG_INF ? expf(s[i][c] - m_new) : 0.f;
        psum += p;
        sP[(4 * ty + i) * LDS + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();                        // rows of sP stay inside one warp

    // acc += P V: rows 4*ty + i, columns tx + 16*c
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float p[4], vv[CD];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(4 * ty + i) * LDS + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = sV[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] += p[i] * vv[c];
    }
    __syncwarp();
  }

  T* op = (T*)a.out + (i64)b * a.o_sb + (i64)h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r < a.Sq) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < CD; ++c)
        op[(i64)r * a.o_ss + tx + 16 * c] = acc[i][c] / denom;
      if (tx == 0)
        a.lse[((i64)b * a.H + h) * a.Sq + r] =
            (blind_row(a.q_offset + r, a.S, a.window) ? NEG_INF : m[i]) + logf(denom);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path
constexpr int kMmaThreads = 128;  // 4 warps x 16 q rows

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // lo -> low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// Asynchronous copy of `rows` rows of D bf16 into a tile of row stride LD
// (16-byte aligned rows): 16 bytes a `cp.async`, rows at or beyond `valid` are
// zero-filled (source size 0). The caller commits and waits.
template <int D, int LD>
__device__ __forceinline__ void stage_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            i64 stride, int rows, int valid) {
  constexpr int NV = D / 8;
  for (int idx = threadIdx.x; idx < rows * NV; idx += kMmaThreads) {
    const int r = idx / NV, c = (idx % NV) * 8;
    const bool ok = r < valid;
    const __nv_bfloat16* g = ok ? src + (i64)r * stride + c : src;
    const uint32_t saddr = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * LD + c));
    const int nbytes = ok ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(saddr), "l"(g), "r"(nbytes) : "memory");
  }
}

__device__ __forceinline__ void async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Waits until at most N of this thread's committed groups are still in flight.
template <int N> __device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <int D, int BN>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma_kernel(FlashArgs a) {
  typedef __nv_bfloat16 T;
  constexpr int LD = D + 8;        // +16 bytes: ldmatrix rows fall on distinct banks
  constexpr int NT_S = BN / 8;     // score tiles (16 x 8) a warp
  constexpr int NT_O = D / 8;      // output tiles (16 x 8) a warp
  constexpr int KS_QK = D / 16;    // k-steps of Q K^T
  constexpr int KS_PV = BN / 16;   // k-steps of P V

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + BM * LD;
  T* sV = sK + BN * LD;

  const int qi = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = qi * BM;
  const int rows_here = min(BM, a.Sq - r0);

  const T* qp = (const T*)a.q + (i64)b * a.q_sb + (i64)h * a.q_sh + (i64)r0 * a.q_ss;
  const T* kp = (const T*)a.k + (i64)b * a.k_sb + (i64)hk * a.k_sh;
  const T* vp = (const T*)a.v + (i64)b * a.v_sb + (i64)hk * a.v_sh;

  stage_async<D, LD>(sQ, qp, a.q_ss, BM, rows_here);
  async_commit();

  const int row_min = a.q_offset + r0;
  const int row_max = a.q_offset + r0 + rows_here - 1;
  const int hi = a.causal ? min(a.S, row_max + 1) : a.S;
  const int lo = a.window > 0 && !blind_row(row_max, a.S, a.window)
                     ? max(0, row_min - a.window + 1) : 0;
  const int jt0 = lo / BN;
  const int jt1 = (hi + BN - 1) / BN;

  // this thread's rows: row_a (and row_a + 8) of the warp's 16
  const int row_a = a.q_offset + r0 + warp * 16 + g;

  float o[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // K and V have one buffer each; their copies are committed in the order
  // K0 V0 K1 V1 ... so "at most one group in flight" means the older one is in.
  // K(j+1) is fetched while tile j's softmax and P V run, V(j+1) while tile
  // j+1's scores run.
  if (jt0 < jt1) {
    stage_async<D, LD>(sK, kp + (i64)jt0 * BN * a.k_ss, a.k_ss, BN, a.S - jt0 * BN);
    async_commit();
    stage_async<D, LD>(sV, vp + (i64)jt0 * BN * a.v_ss, a.v_ss, BN, a.S - jt0 * BN);
    async_commit();
  }

  for (int jt = jt0; jt < jt1; ++jt) {
    const int c0 = jt * BN;
    async_wait<1>();                 // Q and K(jt) have landed (V(jt) may be in flight)
    __syncthreads();

    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

#pragma unroll
    for (int kk = 0; kk < KS_QK; ++kk) {
      uint32_t aq[4];
      ldsm_x4(aq, sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT_S; j += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, sK + ((j + (lane >> 4)) * 8 + (lane & 7)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(s[j], aq, bk[0], bk[1]);
        mma_bf16(s[j + 1], aq, bk[2], bk[3]);
      }
    }

    __syncthreads();                 // every warp is done with sK
    if (jt + 1 < jt1)
      stage_async<D, LD>(sK, kp + (i64)(c0 + BN) * a.k_ss, a.k_ss, BN, a.S - c0 - BN);
    async_commit();                  // (an empty group keeps the count uniform)

    // a tile strictly inside the visible band needs no per-element mask
    const bool full_tile =
        c0 + BN <= a.S && (!a.causal || c0 + BN - 1 <= row_min) &&
        (a.window <= 0 || c0 > row_max - a.window);
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = softcap_f(s[j][e] * a.scale, a.softcap);
        if (!full_tile) {
          const int row = row_a + (e >> 1) * 8;
          const int col = c0 + j * 8 + 2 * t + (e & 1);
          bool ok = col < a.S;
          if (a.causal) ok = ok && col <= row;
          if (a.window > 0) ok = ok && col > row - a.window;
          if (!ok) val = blind_row(row, a.S, a.window) && col < a.S ? 0.f : NEG_INF;
        }
        s[j][e] = val;
      }

    // online softmax: the 4 threads of a quad share rows g and g + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT_S; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = __expf(m[r] - m_new);
      float psum = 0.f;             // this thread's share; the quad is summed at the end
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = s[j][e] > 0.5f * NEG_INF ? __expf(s[j][e] - m_new) : 0.f;
          s[j][e] = p;
          psum += p;
        }
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < NT_O; ++j) { o[j][2 * r] *= alpha; o[j][2 * r + 1] *= alpha; }
    }

    async_wait<1>();                 // V(jt) has landed (K(jt+1) may be in flight)
    __syncthreads();

    // O += P V: the score accumulators are already laid out as the A operand
#pragma unroll
    for (int kk = 0; kk < KS_PV; ++kk) {
      uint32_t ap[4];
      ap[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      ap[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      ap[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      ap[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < NT_O; j += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, sV + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                              (j + (lane >> 4)) * 8);
        mma_bf16(o[j], ap, bv[0], bv[1]);
        mma_bf16(o[j + 1], ap, bv[2], bv[3]);
      }
    }

    __syncthreads();                 // every warp is done with sV
    if (jt + 1 < jt1)
      stage_async<D, LD>(sV, vp + (i64)(c0 + BN) * a.v_ss, a.v_ss, BN, a.S - c0 - BN);
    async_commit();
  }

  async_wait<0>();
  __syncthreads();                   // sQ is complete and no copy is in flight

  // normalise, park the warp's 16 rows in its own part of sQ, store 16 bytes a lane
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    denom[r] = fmaxf(sum, 1e-30f);
  }
  __syncwarp();
  T* sO = sQ + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    *reinterpret_cast<uint32_t*>(sO + g * LD + j * 8 + 2 * t) =
        pack_bf16(o[j][0] / denom[0], o[j][1] / denom[0]);
    *reinterpret_cast<uint32_t*>(sO + (g + 8) * LD + j * 8 + 2 * t) =
        pack_bf16(o[j][2] / denom[1], o[j][3] / denom[1]);
  }
  __syncwarp();
  T* op = (T*)a.out + (i64)b * a.o_sb + (i64)h * a.o_sh;
  for (int idx = lane; idx < 16 * (D / 8); idx += 32) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const int row = r0 + warp * 16 + r;
    if (row < a.Sq)
      *reinterpret_cast<uint4*>(op + (i64)row * a.o_ss + c) =
          *reinterpret_cast<const uint4*>(sO + r * LD + c);
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + warp * 16 + g + 8 * r;
      if (row < a.Sq)
        a.lse[((i64)b * a.H + h) * a.Sq + row] =
            (blind_row(a.q_offset + row, a.S, a.window) ? NEG_INF : m[r]) + logf(denom[r]);
    }
  }
}

template <int D, int BN>
int launch_mma(const FlashArgs& a, cudaStream_t stream) {
  constexpr size_t smem = (size_t)(BM + 2 * BN) * (D + 8) * sizeof(__nv_bfloat16);
  static_assert(smem <= 48 * 1024, "above 48 KB the attribute would have to be set");
  auto kern = flash_fwd_mma_kernel<D, BN>;
  dim3 grid((a.Sq + BM - 1) / BM, a.H, a.B);
  kern<<<grid, kMmaThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// D = 64, 128 and 256 in bf16 are the `wgmma` route's (flash_attention_sm90.cu).
int launch_mma_d(const FlashArgs& a, cudaStream_t stream) {
  switch (a.D) {
    case 16: return launch_mma<16, 64>(a, stream);
    case 64:
    case 128:
    case 256: return -4;
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
template <int D, int BN>
int launch(const FlashArgs& a, cudaStream_t stream) {
  constexpr size_t smem = ((size_t)(BM + 2 * BN) * (D + 1) + (size_t)BM * (BN + 1)) * sizeof(float);
  auto kern = flash_fwd_kernel<D, BN>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((a.Sq + BM - 1) / BM, a.H, a.B);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_d(const FlashArgs& a, cudaStream_t stream) {
  switch (a.D) {
    case 16: return launch<16, 64>(a, stream);
    case 64: return launch<64, 64>(a, stream);
    case 128: return launch<128, 64>(a, stream);
    case 256: return launch<256, 32>(a, stream);
    default: return -1;
  }
}

}  // namespace

// Returns 0, a cudaError_t of the launch, -1 (head dim), -4 (the route does
// not take this dtype or head dim) or 1000 + a CUresult (tensor map).
// dtype: 0 = float32, 1 = bfloat16. route: 0 = fp32 FMAs (float32), 1 =
// `mma.sync` (bfloat16, D = 16), 2 = `wgmma` + TMA (bfloat16, D = 64, 128 or
// 256, flash_attention_sm90.cu); the wrapper picks it from the dtype and the
// head dim alone. Strides are in elements; the last dim of q, k, v and out is
// contiguous and every row start is 16-byte aligned. window <= 0: no window.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int H, int KV, int Sq, int S, int D,
    i64 q_sb, i64 q_sh, i64 q_ss, i64 k_sb, i64 k_sh, i64 k_ss,
    i64 v_sb, i64 v_sh, i64 v_ss, i64 o_sb, i64 o_sh, i64 o_ss,
    float scale, float softcap, int causal, int window, int q_offset,
    int dtype, int route, void* stream) {
  FlashArgs a{q, k, v, out, lse, B, H, KV, Sq, S, D,
              q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
              scale, softcap, causal, window, q_offset};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype != (route == 0 ? 0 : 1)) return -4;  // the route's element type
  switch (route) {
    case 0: return launch_d(a, st);
    case 1: return launch_mma_d(a, st);
    case 2: return (D == 64 || D == 128 || D == 256) ? flash_attention_sm90(a, st) : -4;
    default: return -4;
  }
}
