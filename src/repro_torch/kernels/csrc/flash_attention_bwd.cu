// Flash-attention backward (recompute form) for Hopper, sm_90a.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention_bwd.py::
// flash_attention_bwd (bodies `_dq_kernel` and `_dkv_kernel`). Given q, k, v,
// dout, the forward's log-sum-exp `lse` and `delta = rowsum(dout * out)`, per
// visible (q row, kv column) pair:
//
//     p  = exp(softcap(q.k * scale) - lse)         (0 where masked)
//     dv += p dout          ds = p (dout.v - delta) scale  [* (1 - tanh^2)]
//     dk += ds q            dq += ds k
//
// Two kernels, as the TPU split them:
//   * dq kernel: one block per (64-row q tile, q head, batch). It loops over
//     the K/V tiles the q tile can see (from the first tile the window reaches
//     to the causal diagonal) and keeps dq in fp32 registers. The TPU kernel
//     carried dq in VMEM across a sequential grid dimension; blocks here run in
//     no order, so the walk is a loop inside the block.
//   * dk/dv kernel: one block per (kv tile, kv head, batch). It loops over the
//     kv head's G query heads x the q tiles that can see the tile and keeps dk
//     and dv in fp32, as the TPU grid (b, kv, nk, g*nq) does: the group sum
//     over the G query heads needs no atomics and no per-head partials.
//
// Three routes, chosen by the wrapper from the dtype and the head dim alone
// (kernels/flash_attention_bwd.py::route), share the design:
//   * `wgmma`: bf16 at D = 64 and 128 (the training shapes), the Hopper kernels
//     of flash_attention_bwd_sm90.cu (TMA rings, producer and consumer
//     warpgroups, every product on `wgmma`; its design note says what bounds
//     the backward at the training shape);
//   * `mma`: bf16 at D = 16 (the smoke configs), every product on the tensor
//     cores (`mma.sync` m16n8k16, fp32 accumulators), 4 warps of 16 rows a
//     block, tiles in shared memory with a 16-byte row pad for `ldmatrix`, the
//     next tile's copies (`cp.async`, double-buffered) in flight during the
//     current tile's products. P and dS never leave registers: their
//     accumulator layout is the A-operand layout of the next product, so they
//     are only rounded to bf16 in place (as the forward K1 does with P);
//   * `fma`: fp32 inputs, and bf16 at D = 256 (too many fp32 accumulators for
//     a warp of 16 rows): fp32 FMAs on the CUDA cores, 256 threads a block,
//     tiles widened to fp32 in shared memory with an odd row stride.
// The two-kernel form recomputes the scores and dout.v in both kernels (7
// products where the function needs 5), the price of having no atomics.
// A masked pair has p = 0 exactly, rows past Sq and columns past S are masked,
// and a tile that causality or the window hides entirely is never visited.
#include <cstdint>

#include "flash_attention_bwd.cuh"

namespace {

// p and ds of one pair from the raw product q.k and dp = dout.v.
template <bool FAST>
__device__ __forceinline__ void p_ds(float qk, float dp, float lse, float delta, bool ok,
                                     const BwdArgs& a, float& p, float& ds) {
  float s = qk * a.scale, dcap = 1.f;
  if (a.softcap > 0.f) {
    const float t = tanhf(s / a.softcap);
    s = t * a.softcap;
    dcap = 1.f - t * t;
  }
  p = ok ? (FAST ? __expf(s - lse) : expf(s - lse)) : 0.f;
  ds = p * (dp - delta) * a.scale * dcap;
}

// ---------------------------------------------------------------------------
// FMA path (fp32 inputs; bf16 at D = 256)
constexpr int kThreads = 256;   // 16 x 16: thread (ty, tx)

// Copies `rows` rows of D elements (row r at src + r * stride) into an fp32
// tile of row stride D + 1, zero-filling rows at or beyond `valid`.
template <typename T, int D>
__device__ __forceinline__ void stage_f32(float* dst, const T* src, i64 stride, int rows,
                                          int valid) {
  constexpr int E = Vec16<T>::E;
  constexpr int NV = D / E;
  for (int idx = threadIdx.x; idx < rows * NV; idx += kThreads) {
    const int r = idx / NV, c = (idx % NV) * E;
    float buf[E];
    if (r < valid) {
      load16(src + (i64)r * stride + c, buf);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) buf[e] = 0.f;
    }
    float* d = dst + r * (D + 1) + c;
#pragma unroll
    for (int e = 0; e < E; ++e) d[e] = buf[e];
  }
}

// dq: thread (ty, tx) owns q rows 4*ty + i and columns tx + 16*c.
template <typename T, int D, int BN>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(BwdArgs a) {
  constexpr int BM = 64, LD = D + 1, LDS = BN + 1, CN = BN / 16, CD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sO = sQ + BM * LD;
  float* sK = sO + BM * LD;
  float* sV = sK + BN * LD;
  float* sS = sV + BN * LD;

  const int qi = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (a.H / a.KV);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = qi * BM, rows_here = min(BM, a.Sq - r0);

  const T* qp = (const T*)a.q + (i64)b * a.q_sb + (i64)h * a.q_sh + (i64)r0 * a.q_ss;
  const T* op = (const T*)a.dout + (i64)b * a.do_sb + (i64)h * a.do_sh + (i64)r0 * a.do_ss;
  const T* kp = (const T*)a.k + (i64)b * a.k_sb + (i64)hk * a.k_sh;
  const T* vp = (const T*)a.v + (i64)b * a.v_sb + (i64)hk * a.v_sh;
  stage_f32<T, D>(sQ, qp, a.q_ss, BM, rows_here);
  stage_f32<T, D>(sO, op, a.do_ss, BM, rows_here);

  const float* lrow = a.lse + ((i64)b * a.H + h) * a.Sq;
  const float* drow = a.delta + ((i64)b * a.H + h) * a.Sq;
  float lse[4], dlt[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    lse[i] = r < a.Sq ? lrow[r] : 0.f;
    dlt[i] = r < a.Sq ? drow[r] : 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  int jt0, jt1;
  kv_range(a, r0, rows_here, BN, jt0, jt1);
  for (int jt = jt0; jt < jt1; ++jt) {
    const int c0 = jt * BN;
    __syncthreads();                     // the previous tile is consumed
    stage_f32<T, D>(sK, kp + (i64)c0 * a.k_ss, a.k_ss, BN, a.S - c0);
    stage_f32<T, D>(sV, vp + (i64)c0 * a.v_ss, a.v_ss, BN, a.S - c0);
    __syncthreads();

    float s[4][CN], dp[4][CN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CN; ++c) { s[i][c] = 0.f; dp[i][c] = 0.f; }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[CN], vv[CN];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(4 * ty + i) * LD + d];
        ov[i] = sO[(4 * ty + i) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        kv[c] = sK[(tx + 16 * c) * LD + d];
        vv[c] = sV[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          s[i][c] += qv[i] * kv[c];
          dp[i][c] += ov[i] * vv[c];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        float p, ds;
        p_ds<false>(s[i][c], dp[i][c], lse[i], dlt[i],
                    visible(a, r0 + 4 * ty + i, c0 + tx + 16 * c), a, p, ds);
        sS[(4 * ty + i) * LDS + tx + 16 * c] = ds;
      }
    __syncwarp();                        // a row of sS stays inside one warp

#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float dsv[4], kv[CD];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sS[(4 * ty + i) * LDS + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) kv[c] = sK[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] += dsv[i] * kv[c];
    }
    __syncwarp();
  }

  T* dqp = (T*)a.dq + (i64)b * a.dq_sb + (i64)h * a.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r < a.Sq) {
#pragma unroll
      for (int c = 0; c < CD; ++c) dqp[(i64)r * a.dq_ss + tx + 16 * c] = from_float<T>(acc[i][c]);
    }
  }
}

// dk/dv: thread (ty, tx) owns kv rows RK*ty + i; q columns (scores) and d
// columns (outputs) tx + 16*c.
template <typename T, int D, int BK, int BQ>
__global__ void __launch_bounds__(kThreads) bwd_dkv_kernel(BwdArgs a) {
  constexpr int LD = D + 1, LDP = BQ + 1, RK = BK / 16, CQ = BQ / 16, CD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sO = sQ + BQ * LD;
  float* sP = sO + BQ * LD;
  float* sS = sP + BK * LDP;
  float* sL = sS + BK * LDP;
  float* sD = sL + BQ;

  const int hk = blockIdx.y, b = blockIdx.z, G = a.H / a.KV;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int c0 = blockIdx.x * BK, krows = min(BK, a.S - c0);

  const T* kp = (const T*)a.k + (i64)b * a.k_sb + (i64)hk * a.k_sh + (i64)c0 * a.k_ss;
  const T* vp = (const T*)a.v + (i64)b * a.v_sb + (i64)hk * a.v_sh + (i64)c0 * a.v_ss;
  stage_f32<T, D>(sK, kp, a.k_ss, BK, krows);
  stage_f32<T, D>(sV, vp, a.v_ss, BK, krows);

  float dk[RK][CD], dv[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) { dk[i][c] = 0.f; dv[i][c] = 0.f; }

  int qt0, nqt;
  q_range(a, c0, krows, BQ, qt0, nqt);
  const int n_it = G * nqt;
  for (int it = 0; it < n_it; ++it) {
    const int h = hk * G + it / nqt;
    const int q0 = (qt0 + it % nqt) * BQ;
    const T* qp = (const T*)a.q + (i64)b * a.q_sb + (i64)h * a.q_sh + (i64)q0 * a.q_ss;
    const T* op = (const T*)a.dout + (i64)b * a.do_sb + (i64)h * a.do_sh + (i64)q0 * a.do_ss;
    const i64 lrow = ((i64)b * a.H + h) * a.Sq;
    __syncthreads();                     // the previous q tile is consumed
    stage_f32<T, D>(sQ, qp, a.q_ss, BQ, a.Sq - q0);
    stage_f32<T, D>(sO, op, a.do_ss, BQ, a.Sq - q0);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool ok = q0 + r < a.Sq;
      sL[r] = ok ? a.lse[lrow + q0 + r] : 0.f;
      sD[r] = ok ? a.delta[lrow + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[RK][CQ], dp[RK][CQ];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int c = 0; c < CQ; ++c) { s[i][c] = 0.f; dp[i][c] = 0.f; }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[RK], vv[RK], qv[CQ], ov[CQ];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        kv[i] = sK[(RK * ty + i) * LD + d];
        vv[i] = sV[(RK * ty + i) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < CQ; ++c) {
        qv[c] = sQ[(tx + 16 * c) * LD + d];
        ov[c] = sO[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          s[i][c] += kv[i] * qv[c];
          dp[i][c] += vv[i] * ov[c];
        }
    }
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int c = 0; c < CQ; ++c) {
        const int qc = tx + 16 * c;
        float p, ds;
        p_ds<false>(s[i][c], dp[i][c], sL[qc], sD[qc],
                    visible(a, q0 + qc, c0 + RK * ty + i), a, p, ds);
        sP[(RK * ty + i) * LDP + qc] = p;
        sS[(RK * ty + i) * LDP + qc] = ds;
      }
    __syncwarp();                        // rows of sP / sS stay inside one warp

#pragma unroll 4
    for (int j = 0; j < BQ; ++j) {
      float pv[RK], dsv[RK], ov[CD], qv[CD];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        pv[i] = sP[(RK * ty + i) * LDP + j];
        dsv[i] = sS[(RK * ty + i) * LDP + j];
      }
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        ov[c] = sO[j * LD + tx + 16 * c];
        qv[c] = sQ[j * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dv[i][c] += pv[i] * ov[c];
          dk[i][c] += dsv[i] * qv[c];
        }
    }
    __syncwarp();
  }

  T* dkp = (T*)a.dk + (i64)b * a.dk_sb + (i64)hk * a.dk_sh;
  T* dvp = (T*)a.dv + (i64)b * a.dv_sb + (i64)hk * a.dv_sh;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int r = c0 + RK * ty + i;
    if (r < a.S) {
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        dkp[(i64)r * a.dk_ss + tx + 16 * c] = from_float<T>(dk[i][c]);
        dvp[(i64)r * a.dv_ss + tx + 16 * c] = from_float<T>(dv[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path (D = 16)
constexpr int kMmaThreads = 128;   // 4 warps x 16 rows

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

// Asynchronous copy of `rows` rows of D bf16 into a tile of row stride LD,
// 16 bytes a `cp.async`; rows at or beyond `valid` are zero-filled.
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
template <int N> __device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A (16 x 16, rows of the warp) x B^T for NT 8-column tiles, B's rows being
// the n index with k contiguous (a K or Q tile as stored): acc[j] += A B_j.
template <int NT>
__device__ __forceinline__ void mma_nt(float (&acc)[NT][4], const uint32_t (&af)[4],
                                       const __nv_bfloat16* sB, int LD, int k0, int lane) {
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t bf[4];
    ldsm_x4(bf, sB + ((j + (lane >> 4)) * 8 + (lane & 7)) * LD + k0 + ((lane >> 3) & 1) * 8);
    mma_bf16(acc[j], af, bf[0], bf[1]);
    mma_bf16(acc[j + 1], af, bf[2], bf[3]);
  }
}

// A (16 x 16 from registers) x B for NT 8-column tiles, B's rows being the k
// index with n contiguous (a V, K, Q or dout tile read the other way).
template <int NT>
__device__ __forceinline__ void mma_nn(float (&acc)[NT][4], const uint32_t (&af)[4],
                                       const __nv_bfloat16* sB, int LD, int k0, int lane) {
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t bf[4];
    ldsm_x4_trans(bf, sB + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (j + (lane >> 4)) * 8);
    mma_bf16(acc[j], af, bf[0], bf[1]);
    mma_bf16(acc[j + 1], af, bf[2], bf[3]);
  }
}

// The A fragment of k-step kk from accumulator tiles 2kk and 2kk+1.
template <int NT>
__device__ __forceinline__ void acc_to_a(uint32_t (&af)[4], const float (&acc)[NT][4], int kk) {
  af[0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
  af[1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
  af[2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
  af[3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
}

// dq: warp w owns q rows 16w..16w+15 of a 64-row tile. K/V double-buffered.
template <int D, int BN>
__global__ void __launch_bounds__(kMmaThreads) bwd_dq_mma_kernel(BwdArgs a) {
  typedef __nv_bfloat16 T;
  constexpr int BM = 64, LD = D + 8, NT_S = BN / 8, NT_O = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sO = sQ + BM * LD;
  T* sK0 = sO + BM * LD;          // buffers: K0 V0 K1 V1

  const int qi = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (a.H / a.KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = qi * BM, rows_here = min(BM, a.Sq - r0);

  const T* qp = (const T*)a.q + (i64)b * a.q_sb + (i64)h * a.q_sh + (i64)r0 * a.q_ss;
  const T* op = (const T*)a.dout + (i64)b * a.do_sb + (i64)h * a.do_sh + (i64)r0 * a.do_ss;
  const T* kp = (const T*)a.k + (i64)b * a.k_sb + (i64)hk * a.k_sh;
  const T* vp = (const T*)a.v + (i64)b * a.v_sb + (i64)hk * a.v_sh;
  stage_async<D, LD>(sQ, qp, a.q_ss, BM, rows_here);
  stage_async<D, LD>(sO, op, a.do_ss, BM, rows_here);
  async_commit();

  const int ra = r0 + warp * 16 + g;           // this thread's rows: ra, ra + 8
  const float* lrow = a.lse + ((i64)b * a.H + h) * a.Sq;
  const float* drow = a.delta + ((i64)b * a.H + h) * a.Sq;
  float lse[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse[r] = ra + 8 * r < a.Sq ? lrow[ra + 8 * r] : 0.f;
    dlt[r] = ra + 8 * r < a.Sq ? drow[ra + 8 * r] : 0.f;
  }
  float dq[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  int jt0, jt1;
  kv_range(a, r0, rows_here, BN, jt0, jt1);
  if (jt0 < jt1) {
    stage_async<D, LD>(sK0, kp + (i64)jt0 * BN * a.k_ss, a.k_ss, BN, a.S - jt0 * BN);
    stage_async<D, LD>(sK0 + BN * LD, vp + (i64)jt0 * BN * a.v_ss, a.v_ss, BN, a.S - jt0 * BN);
  }
  async_commit();

  for (int jt = jt0; jt < jt1; ++jt) {
    const int c0 = jt * BN;
    const int buf = (jt - jt0) & 1;
    T* sK = sK0 + buf * 2 * BN * LD;
    T* sV = sK + BN * LD;
    if (jt + 1 < jt1) {
      T* nK = sK0 + (buf ^ 1) * 2 * BN * LD;
      stage_async<D, LD>(nK, kp + (i64)(c0 + BN) * a.k_ss, a.k_ss, BN, a.S - c0 - BN);
      stage_async<D, LD>(nK + BN * LD, vp + (i64)(c0 + BN) * a.v_ss, a.v_ss, BN, a.S - c0 - BN);
    }
    async_commit();
    async_wait<1>();                 // Q, dout and this tile's K/V have landed
    __syncthreads();

    float s[NT_S][4], dp[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) { s[j][e] = 0.f; dp[j][e] = 0.f; }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm_x4(aq, sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      ldsm_x4(ao, sO + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      mma_nt<NT_S>(s, aq, sK, LD, kk * 16, lane);
      mma_nt<NT_S>(dp, ao, sV, LD, kk * 16, lane);
    }
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p, ds;
        p_ds<true>(s[j][e], dp[j][e], lse[e >> 1], dlt[e >> 1],
                   visible(a, ra + 8 * (e >> 1), c0 + j * 8 + 2 * t + (e & 1)), a, p, ds);
        s[j][e] = ds;
      }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t as[4];
      acc_to_a<NT_S>(as, s, kk);
      mma_nn<NT_O>(dq, as, sK, LD, kk * 16, lane);
    }
    __syncthreads();                 // every warp is done with this buffer
  }
  async_wait<0>();

  T* dqp = (T*)a.dq + (i64)b * a.dq_sb + (i64)h * a.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row < a.Sq) {
#pragma unroll
      for (int j = 0; j < NT_O; ++j)
        *reinterpret_cast<uint32_t*>(dqp + (i64)row * a.dq_ss + j * 8 + 2 * t) =
            pack_bf16(dq[j][2 * r], dq[j][2 * r + 1]);
    }
  }
}

// dk/dv: warp w owns kv rows 16w..16w+15 of a 64-row tile; the kv head's G
// query heads x q tiles stream through double-buffered Q / dout tiles.
template <int D, int BQ>
__global__ void __launch_bounds__(kMmaThreads) bwd_dkv_mma_kernel(BwdArgs a) {
  typedef __nv_bfloat16 T;
  constexpr int BK = 64, LD = D + 8, NT_Q = BQ / 8, NT_O = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + BK * LD;
  T* sQ0 = sV + BK * LD;          // buffers: Q0 O0 Q1 O1
  float* sL0 = reinterpret_cast<float*>(sQ0 + 4 * BQ * LD);   // L0 D0 L1 D1

  const int hk = blockIdx.y, b = blockIdx.z, G = a.H / a.KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * BK, krows = min(BK, a.S - c0);

  stage_async<D, LD>(sK, (const T*)a.k + (i64)b * a.k_sb + (i64)hk * a.k_sh + (i64)c0 * a.k_ss,
                     a.k_ss, BK, krows);
  stage_async<D, LD>(sV, (const T*)a.v + (i64)b * a.v_sb + (i64)hk * a.v_sh + (i64)c0 * a.v_ss,
                     a.v_ss, BK, krows);
  async_commit();

  int qt0, nqt;
  q_range(a, c0, krows, BQ, qt0, nqt);
  const int n_it = G * nqt;
  // stage q tile `it` (q head hk*G + it/nqt) into buffer `buf`
  auto stage_q = [&](int it, int buf) {
    const int h = hk * G + it / nqt;
    const int q0 = (qt0 + it % nqt) * BQ;
    T* dQ = sQ0 + buf * 2 * BQ * LD;
    stage_async<D, LD>(dQ, (const T*)a.q + (i64)b * a.q_sb + (i64)h * a.q_sh + (i64)q0 * a.q_ss,
                       a.q_ss, BQ, a.Sq - q0);
    stage_async<D, LD>(dQ + BQ * LD,
                       (const T*)a.dout + (i64)b * a.do_sb + (i64)h * a.do_sh + (i64)q0 * a.do_ss,
                       a.do_ss, BQ, a.Sq - q0);
    float* sL = sL0 + buf * 2 * BQ;
    const i64 lrow = ((i64)b * a.H + h) * a.Sq;
    for (int r = threadIdx.x; r < BQ; r += kMmaThreads) {
      const bool ok = q0 + r < a.Sq;
      sL[r] = ok ? a.lse[lrow + q0 + r] : 0.f;
      sL[BQ + r] = ok ? a.delta[lrow + q0 + r] : 0.f;
    }
  };
  if (n_it > 0) stage_q(0, 0);
  async_commit();

  float dk[NT_O][4], dv[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) { dk[j][e] = 0.f; dv[j][e] = 0.f; }

  const int ka = c0 + warp * 16 + g;           // this thread's kv rows: ka, ka + 8
  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) stage_q(it + 1, buf ^ 1);
    async_commit();
    async_wait<1>();                 // K/V and this q tile have landed
    __syncthreads();
    const int q0 = (qt0 + it % nqt) * BQ;
    const T* sQ = sQ0 + buf * 2 * BQ * LD;
    const T* sO = sQ + BQ * LD;
    const float* sL = sL0 + buf * 2 * BQ;

    float st[NT_Q][4], dpt[NT_Q][4];
#pragma unroll
    for (int j = 0; j < NT_Q; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) { st[j][e] = 0.f; dpt[j][e] = 0.f; }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, sK + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      ldsm_x4(av, sV + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      mma_nt<NT_Q>(st, ak, sQ, LD, kk * 16, lane);
      mma_nt<NT_Q>(dpt, av, sO, LD, kk * 16, lane);
    }
#pragma unroll
    for (int j = 0; j < NT_Q; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + 2 * t + (e & 1);
        float p, ds;
        p_ds<true>(st[j][e], dpt[j][e], sL[qc], sL[BQ + qc],
                   visible(a, q0 + qc, ka + 8 * (e >> 1)), a, p, ds);
        st[j][e] = p;
        dpt[j][e] = ds;
      }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ap[4], as[4];
      acc_to_a<NT_Q>(ap, st, kk);
      acc_to_a<NT_Q>(as, dpt, kk);
      mma_nn<NT_O>(dv, ap, sO, LD, kk * 16, lane);
      mma_nn<NT_O>(dk, as, sQ, LD, kk * 16, lane);
    }
    __syncthreads();                 // every warp is done with this buffer
  }
  async_wait<0>();

  T* dkp = (T*)a.dk + (i64)b * a.dk_sb + (i64)hk * a.dk_sh;
  T* dvp = (T*)a.dv + (i64)b * a.dv_sb + (i64)hk * a.dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ka + 8 * r;
    if (row < a.S) {
#pragma unroll
      for (int j = 0; j < NT_O; ++j) {
        *reinterpret_cast<uint32_t*>(dkp + (i64)row * a.dk_ss + j * 8 + 2 * t) =
            pack_bf16(dk[j][2 * r], dk[j][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvp + (i64)row * a.dv_ss + j * 8 + 2 * t) =
            pack_bf16(dv[j][2 * r], dv[j][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
template <typename Kern>
int launch_k(Kern kern, dim3 grid, int threads, size_t smem, const BwdArgs& a,
             cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

inline int cdiv(int x, int y) { return (x + y - 1) / y; }

template <typename T, int D, int BN, int BK, int BQ>
int launch_fma(const BwdArgs& a, cudaStream_t st) {
  constexpr int BM = 64;
  const size_t smem_dq = ((size_t)(2 * BM + 2 * BN) * (D + 1) + (size_t)BM * (BN + 1)) * sizeof(float);
  int e = launch_k(bwd_dq_kernel<T, D, BN>, dim3(cdiv(a.Sq, BM), a.H, a.B), kThreads, smem_dq, a, st);
  if (e != 0) return e;
  const size_t smem_kv = ((size_t)(2 * BK + 2 * BQ) * (D + 1) + 2 * (size_t)BK * (BQ + 1) + 2 * BQ) *
                         sizeof(float);
  return launch_k(bwd_dkv_kernel<T, D, BK, BQ>, dim3(cdiv(a.S, BK), a.KV, a.B), kThreads, smem_kv, a, st);
}

template <typename T>
int launch_fma_d(const BwdArgs& a, cudaStream_t st) {
  switch (a.D) {
    case 16: return launch_fma<T, 16, 64, 64, 64>(a, st);
    case 64: return launch_fma<T, 64, 64, 64, 64>(a, st);
    case 128: return launch_fma<T, 128, 64, 64, 64>(a, st);
    case 256: return launch_fma<T, 256, 32, 32, 32>(a, st);
    default: return -1;
  }
}

int launch_mma(const BwdArgs& a, cudaStream_t st) {
  constexpr int D = 16, BM = 64, BN = 64, BK = 64, BQ = 64, LD = D + 8;
  const size_t smem_dq = (size_t)(2 * BM + 4 * BN) * LD * sizeof(__nv_bfloat16);
  int e = launch_k(bwd_dq_mma_kernel<D, BN>, dim3(cdiv(a.Sq, BM), a.H, a.B), kMmaThreads, smem_dq, a, st);
  if (e != 0) return e;
  const size_t smem_kv = (size_t)(2 * BK + 4 * BQ) * LD * sizeof(__nv_bfloat16) + 4 * BQ * sizeof(float);
  return launch_k(bwd_dkv_mma_kernel<D, BQ>, dim3(cdiv(a.S, BK), a.KV, a.B), kMmaThreads, smem_kv, a, st);
}

}  // namespace

// Returns 0, a cudaError_t of a launch, 1000 + a CUresult (tensor map), -1
// (head dim) or -4 (the route does not take this dtype, head dim or
// delta_from_out). dtype: 0 = float32, 1 = bfloat16. route: 0 = fp32 FMAs
// (float32 at any head dim, bfloat16 at D = 256), 1 = `mma.sync` (bfloat16,
// D = 16), 2 = `wgmma` + TMA (bfloat16, D = 64 or 128,
// flash_attention_bwd_sm90.cu); the wrapper picks it from the dtype and the
// head dim alone. Strides are in elements; the last dim of every tensor is
// contiguous and every row start is 16-byte aligned; lse and delta are
// contiguous (B, H, Sq) fp32. delta_from_out (the `wgmma` route only): delta
// is written, as rowsum(dout * out), by the dq kernel before it is used.
// window <= 0: no window. Two kernels are launched on `stream`: dq, then dk/dv.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    float* delta, void* dq, void* dk, void* dv, const void* out,
    int B, int H, int KV, int Sq, int S, int D,
    i64 q_sb, i64 q_sh, i64 q_ss, i64 k_sb, i64 k_sh, i64 k_ss,
    i64 v_sb, i64 v_sh, i64 v_ss, i64 do_sb, i64 do_sh, i64 do_ss,
    i64 dq_sb, i64 dq_sh, i64 dq_ss, i64 dk_sb, i64 dk_sh, i64 dk_ss,
    i64 dv_sb, i64 dv_sh, i64 dv_ss, i64 o_sb, i64 o_sh, i64 o_ss,
    float scale, float softcap, int causal, int window, int q_offset,
    int delta_from_out, int dtype, int route, void* stream) {
  BwdArgs a{q, k, v, dout, lse, delta, dq, dk, dv, out, B, H, KV, Sq, S, D,
            q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss,
            dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss, o_sb, o_sh, o_ss,
            scale, softcap, causal, window, q_offset, delta_from_out};
  cudaStream_t st = (cudaStream_t)stream;
  if (delta_from_out && route != 2) return -4;
  switch (route) {
    case 0:
      if (dtype == 0) return launch_fma_d<float>(a, st);
      return D == 256 ? launch_fma<__nv_bfloat16, 256, 32, 32, 32>(a, st) : -4;
    case 1: return dtype == 1 && D == 16 ? launch_mma(a, st) : -4;
    case 2: return dtype == 1 && (D == 64 || D == 128) ? flash_attention_bwd_sm90(a, st) : -4;
    default: return -4;
  }
}
