// Flash-attention backward (recompute form) for Hopper, sm_90a: the `wgmma` +
// TMA route, bf16 at D = 64 and 128.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention_bwd.py::
// flash_attention_bwd (bodies `_dq_kernel` and `_dkv_kernel`) on the training
// shapes; flash_attention_bwd.cu keeps bf16 at D = 16 (`mma.sync`) and fp32
// and bf16 at D = 256 (FMAs). Per visible (q row, kv column) pair:
//
//     p  = exp(softcap(q.k * scale) - lse)         (0 where masked)
//     dv += p dout          ds = p (dout.v - delta) scale  [* (1 - tanh^2)]
//     dk += ds q            dq += ds k
//
// What bounds it on this card: at the training shape (q/dout 8 x 24 x 512 x
// 128, k/v 8 x 8 x 512 x 128, causal) the 5 products the function needs take
// 32 GFLOP, 0.033 ms at the bf16 tensor-core rate, and its 110 MB of inputs
// and outputs 0.033 ms at the memory rate. A causal walk of 512 rows is short:
// the first loads, the softmax-like elementwise work between the products and
// the epilogue weigh as much as the products.
//
// Two kernels, as the TPU split them, with no atomics and no fp32 dq
// workspace (deterministic; the dq kernel recomputes S and dP, 7 products in
// all where 5 suffice):
//   * dk/dv kernel: one block per (64-row kv tile, kv head, batch). A
//     producer warpgroup walks the kv head's G q heads x the 64-row q tiles
//     that can see the kv tile: one thread issues the TMA loads of each q
//     tile and its dout tile into a ring of stages, one warp copies the tile's
//     lse (in log2 units) and delta beside them, and both arrive on the
//     stage's full barrier. The two consumer warpgroups share the 64 kv rows
//     and split the work: the first computes S^T = K Q^T, P^T and dV += P^T
//     dO, the second dP^T = V dO^T, dS^T and dK += dS^T Q, P^T passing from
//     the first to the second through shared memory in fp32 (named barriers,
//     two buffers). With the kv rows as M, P^T and dS^T come out in the
//     accumulator layout that `wgmma` takes as a register A operand, dO and Q
//     read MN-major from shared memory. A consumer that held dK, dV and both
//     score tiles (192 fp32 registers) would spill: ptxas gives each thread of
//     a 384-thread block 168 registers whatever `setmaxnreg` asks later;
//   * dq kernel: one block per (128-row q tile, q head, batch), the heaviest
//     q tiles first and the q heads of a kv head side by side (their K/V tiles
//     come from L2). Q and dO come in once; K and V stream through a TMA ring
//     of 64-row tiles. Two consumer warpgroups of 64 q rows run S = Q K^T,
//     dP = dO V^T and dQ += dS K, dS again a register A operand (its
//     accumulator layout is the A layout: no trip through shared memory);
//   * 128-byte swizzle everywhere, as in the forward K1 (flash_attention_sm90.cu);
//   * a consumer skips a stage that causality or the window hides from all of
//     its 64 rows, and masks only a stage that crosses an edge of the visible
//     band, with a few integer compares an element (FragMask);
//   * dK and dV leave through the K and V tiles in shared memory, each dq
//     consumer's dQ through its rows of the Q tile (bf16, the same swizzle),
//     by TMA stores, which clip rows past S or Sq.
// lse arrives as the forward gives it; delta = rowsum(dout * out) either as the
// caller gives it or, when the caller hands over the forward's output instead,
// computed by the dq kernel from its staged dout tile (one read of out, no
// separate pass) and written for the dk/dv kernel. Rows past Sq and columns
// past S come in as zeros and are masked.
#include <climits>

#include "flash_attention_bwd.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kKvTile = 64;     // dk/dv kernel: kv rows a block
constexpr int kQStep = 64;      // dk/dv kernel: q rows a stage
constexpr int kQTile = 128;     // dq kernel: q rows a block
constexpr int kKvStep = 64;     // dq kernel: kv rows a stage

template <int D>
struct KvLayout {
  static constexpr int NH = D / 64;                 // 64-column boxes a row
  static constexpr int KV_BYTES = kKvTile * D * 2;  // K or V
  static constexpr int T_BYTES = kQStep * D * 2;    // Q or dO, one stage
  static constexpr int P_BYTES = kKvTile * kQStep * 4;   // P^T in fp32, one of two buffers
  static constexpr int ST = 2 * KV_BYTES + 4 * 2 * T_BYTES + 2 * P_BYTES <= 200 * 1024 ? 4 : 2;
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_Q = 2 * KV_BYTES;        // stage s: Q, then dO
  static constexpr int OFF_P = OFF_Q + ST * 2 * T_BYTES;
  static constexpr int OFF_LD = OFF_P + 2 * P_BYTES;    // stage s: lse2[64], delta[64]
  static constexpr int OFF_BAR = OFF_LD + ST * 2 * kQStep * 4;
  static constexpr int SMEM = OFF_BAR + 128 + 1024; // + barriers + alignment slack
};

template <int D>
struct QLayout {
  static constexpr int NH = D / 64;
  static constexpr int T_BYTES = kQTile * D * 2;    // Q or dO
  static constexpr int KV_BYTES = kKvStep * D * 2;  // K or V, one stage
  static constexpr int ST = 2 * T_BYTES + 4 * 2 * KV_BYTES <= 200 * 1024 ? 4 : 2;
  static constexpr int OFF_DO = T_BYTES;
  static constexpr int OFF_K = 2 * T_BYTES;         // stage s: K, then V
  static constexpr int OFF_BAR = OFF_K + ST * 2 * KV_BYTES;
  static constexpr int SMEM = OFF_BAR + 128 + 1024;
};

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// p and ds of one pair, in place: x holds q.k on entry and p on exit, y holds
// dout.v on entry and ds on exit. lse2 is lse in log2 units.
__device__ __forceinline__ void p_ds_sm90(float& x, float& y, float lse2, float delta, bool ok,
                                          const BwdArgs& a) {
  float s2, dcap = 1.f;
  if (a.softcap > 0.f) {
    const float t = tanhf(x * a.scale / a.softcap);
    s2 = t * a.softcap * kLog2e;
    dcap = 1.f - t * t;
  } else {
    s2 = x * (a.scale * kLog2e);
  }
  const float p = ok ? ex2(s2 - lse2) : 0.f;
  x = p;
  y = p * (y - delta) * a.scale * dcap;
}

// The first half of `acc` becomes the bf16 A fragments of its k-steps: k-step
// kk (accumulator columns 16 kk .. 16 kk + 15) -> acc[4 kk .. 4 kk + 3].
__device__ __forceinline__ void pack_a(float (&acc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      acc[4 * kk + q] = __uint_as_float(pack_bf16(acc[8 * kk + 2 * q], acc[8 * kk + 2 * q + 1]));
}


// The mask of one accumulator fragment, as a few integer compares an element.
// The thread's element (j, e) pairs query row qr = qr0 + dq and kv column
// kc = kc0 + dk; it is visible when qr < Sq, kc < S, and the difference
// (q_offset + qr) - kc lies in [lo, hi) (lo = 0 under causality, hi = the
// window).
struct FragMask {
  int diff0, q_lim, k_lim, lo, hi;
  __device__ __forceinline__ FragMask(const BwdArgs& a, int qr0, int kc0)
      : diff0(a.q_offset + qr0 - kc0), q_lim(a.Sq - qr0), k_lim(a.S - kc0),
        lo(a.causal ? 0 : INT_MIN), hi(a.window > 0 ? a.window : INT_MAX) {}
  __device__ __forceinline__ bool ok(int dq, int dk) const {
    const int diff = diff0 + dq - dk;
    return dq < q_lim && dk < k_lim && diff >= lo && diff < hi;
  }
};

// ---------------------------------------------------------------------------
// dk/dv: both consumers own the block's 64 kv rows. Consumer 0 computes S^T,
// P^T and dV; consumer 1 computes dP^T, dS^T and dK. P^T (times the soft
// cap's 1 - tanh^2) goes from the first to the second through shared memory
// in fp32, in the accumulator's own order, two buffers deep, under named
// barriers. Each consumer then holds one 64 x D accumulator and one 64 x 64
// score tile: a consumer holding both dK and dV and both score tiles needs
// more registers than the 168 a thread that three warpgroups get.
enum : int { kBarPFull = 3, kBarPEmpty = 5, kBarTiles = 7 };   // named barriers (+ buffer)

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_dk, const __grid_constant__ CUtensorMap tm_dv,
                    const BwdArgs a) {
  using L = KvLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::OFF_BAR);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + L::ST;
  const int hk = blockIdx.x, b = blockIdx.y, c0 = blockIdx.z * kKvTile;
  const int G = a.H / a.KV;
  int qt0, nqt;
  q_range(a, c0, min(kKvTile, a.S - c0), kQStep, qt0, nqt);
  const int n_it = G * nqt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < L::ST; ++s) {
      mbar_init(&full[s], 1 + 32);   // the TMA thread and the 32 lanes that copy lse / delta
      mbar_init(&empty[s], 2);       // one arrival from each consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
#pragma unroll
      for (int hh = 0; hh < L::NH; ++hh) {
        tma_load_4d(sm + hh * kKvTile * kRow, &tm_k, kv_full, 64 * hh, c0, hk, b);
        tma_load_4d(sm + L::OFF_V + hh * kKvTile * kRow, &tm_v, kv_full, 64 * hh, c0, hk, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % L::ST;
        const int h = hk * G + it / nqt, q0 = (qt0 + it % nqt) * kQStep;
        mbar_wait(&empty[s], ((it / L::ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::T_BYTES);
        unsigned char* sq = sm + L::OFF_Q + s * 2 * L::T_BYTES;
#pragma unroll
        for (int hh = 0; hh < L::NH; ++hh) {
          tma_load_4d(sq + hh * kQStep * kRow, &tm_q, &full[s], 64 * hh, q0, h, b);
          tma_load_4d(sq + L::T_BYTES + hh * kQStep * kRow, &tm_do, &full[s], 64 * hh, q0, h, b);
        }
      }
    } else if (warp == 1) {
      for (int it = 0; it < n_it; ++it) {
        const int s = it % L::ST;
        const int h = hk * G + it / nqt, q0 = (qt0 + it % nqt) * kQStep;
        mbar_wait(&empty[s], ((it / L::ST) & 1) ^ 1);
        float* ld = reinterpret_cast<float*>(sm + L::OFF_LD) + s * 2 * kQStep;
        const i64 base = ((i64)b * a.H + h) * a.Sq;
#pragma unroll
        for (int r = lane; r < kQStep; r += 32) {
          const bool ok = q0 + r < a.Sq;
          ld[r] = ok ? a.lse[base + q0 + r] * kLog2e : 0.f;
          ld[kQStep + r] = ok ? a.delta[base + q0 + r] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---------------- consumers: the block's 64 kv rows ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int tw = threadIdx.x & 127;
    const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, t4 = lane & 3;
    constexpr int NO = D / 2;
    const uint32_t kv_addr = smem_u32(sm + (cw == 0 ? 0 : L::OFF_V));   // K for S^T, V for dP^T
    const int ka = c0 + 16 * warp + g;            // this thread's kv rows: ka, ka + 8
    float* pbuf = reinterpret_cast<float*>(sm + L::OFF_P);   // [buffer][j][thread][4]
    float acc[NO], sc[32];                        // dV or dK; S^T or dP^T
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    int np = 0;                                   // stages that exchanged P^T
    for (int it = 0; it < n_it; ++it) {
      const int s = it % L::ST;
      const int q0 = (qt0 + it % nqt) * kQStep;
      mbar_wait(&full[s], (it / L::ST) & 1);
      const int rmin = a.q_offset + q0, rmax = a.q_offset + min(q0 + kQStep, a.Sq) - 1;
      // the same for both consumers, so that they take the same barriers
      const bool hidden = (a.causal && c0 > rmax) ||
                          (a.window > 0 && c0 + kKvTile - 1 <= rmin - a.window);
      if (!hidden) {
        const uint32_t q_addr = smem_u32(sm + L::OFF_Q + s * 2 * L::T_BYTES);
        const uint32_t do_addr = q_addr + L::T_BYTES;
        const float* ld = reinterpret_cast<const float*>(sm + L::OFF_LD) + s * 2 * kQStep;
        const int pb = np & 1;
        float4* pt4 = reinterpret_cast<float4*>(pbuf + pb * 32 * 128);

        // S^T = K Q^T (consumer 0) or dP^T = V dO^T (consumer 1)
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t ao = (kk >> 2) * (kKvTile * kRow) + (kk & 3) * 32;
          const uint32_t bo = (kk >> 2) * (kQStep * kRow) + (kk & 3) * 32;
          wgmma_ss_n64(sc, desc_sw128(kv_addr + ao, 16),
                       desc_sw128((cw == 0 ? q_addr : do_addr) + bo, 16), kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);

        const bool full_tile = q0 + kQStep <= a.Sq && c0 + kKvTile <= a.S &&
                               (!a.causal || c0 + kKvTile - 1 <= rmin) &&
                               (a.window <= 0 || c0 > rmax - a.window);
        uint32_t b_addr;                          // the B operand of dV += P^T dO or dK += dS^T Q
        if (cw == 0) {
          // P^T; P^T (1 - tanh^2) goes to consumer 1, a float4 a thread and j
          if (np >= 2) bar_sync(kBarPEmpty + pb, 256);
          const FragMask mask(a, q0 + 2 * t4, ka);   // columns are q rows, rows kv columns
          auto p_of = [&](int j, bool masked) {
            float pc[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float s2, dcap = 1.f;
              if (a.softcap > 0.f) {
                const float t = tanhf(sc[4 * j + e] * a.scale / a.softcap);
                s2 = t * a.softcap * kLog2e;
                dcap = 1.f - t * t;
              } else {
                s2 = sc[4 * j + e] * (a.scale * kLog2e);
              }
              const bool ok = !masked || mask.ok(8 * j + (e & 1), 8 * (e >> 1));
              const float p = ok ? ex2(s2 - ld[8 * j + 2 * t4 + (e & 1)]) : 0.f;
              sc[4 * j + e] = p;
              pc[e] = p * dcap;
            }
            pt4[j * 128 + tw] = make_float4(pc[0], pc[1], pc[2], pc[3]);
          };
          if (full_tile) {
#pragma unroll
            for (int j = 0; j < 8; ++j) p_of(j, false);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) p_of(j, true);
          }
          bar_arrive(kBarPFull + pb, 256);
          b_addr = do_addr;
        } else {
          // dS^T = P^T (1 - tanh^2) (dP^T - delta) scale
          bar_sync(kBarPFull + pb, 256);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 p4 = pt4[j * 128 + tw];
            const float pc[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[4 * j + e] = pc[e] * (sc[4 * j + e] - ld[kQStep + 8 * j + 2 * t4 + (e & 1)]) * a.scale;
          }
          bar_arrive(kBarPEmpty + pb, 256);
          b_addr = q_addr;
        }
        ++np;
        pack_a(sc);

        // dV += P^T dO or dK += dS^T Q, 16 q rows a step, dO / Q MN-major
        fence_regs(acc);
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kQStep / 16; ++kk) {
          const uint32_t f[4] = {__float_as_uint(sc[4 * kk]), __float_as_uint(sc[4 * kk + 1]),
                                 __float_as_uint(sc[4 * kk + 2]), __float_as_uint(sc[4 * kk + 3])};
          wgmma_rs_d<D>(acc, f, desc_sw128(b_addr + kk * 16 * kRow, kQStep * kRow));
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
      }
      if (tw == 0) mbar_arrive(&empty[s]);        // done with this stage
    }
    // consumer 0 takes the last arrival consumer 1 made on each P^T buffer
    if (cw == 0) {
      if (np >= 1) bar_sync(kBarPEmpty + ((np - 1) & 1), 256);
      if (np >= 2) bar_sync(kBarPEmpty + (np & 1), 256);
    }

    // dV leaves through the V tile, dK through the K tile, once neither
    // consumer reads them any more
    bar_sync(kBarTiles, 256);
    const uint32_t stg = smem_u32(sm + (cw == 0 ? L::OFF_V : 0));
    stage_acc<D>(stg, acc, kKvTile, 0);
    fence_async_smem();
    wg_sync(1 + cw);
    if (tw == 0 && c0 < a.S) {
#pragma unroll
      for (int hh = 0; hh < L::NH; ++hh)
        tma_store_4d(cw == 0 ? &tm_dv : &tm_dk, stg + hh * kKvTile * kRow, 64 * hh, c0, hk, b);
      bulk_commit();
      bulk_wait_all();
    }
  }
}

// ---------------------------------------------------------------------------
// dq
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_dq, const BwdArgs a) {
  using L = QLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::OFF_BAR);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + L::ST;
  const int h = blockIdx.x, b = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kQTile;   // heaviest q tiles first
  const int hk = h / (a.H / a.KV);
  int jt0, jt1;
  kv_range(a, r0, min(kQTile, a.Sq - r0), kKvStep, jt0, jt1);
  const int n = jt1 - jt0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < L::ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer: one thread issues every copy ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::T_BYTES);
#pragma unroll
      for (int hh = 0; hh < L::NH; ++hh)
#pragma unroll
        for (int half = 0; half < kQTile / 64; ++half) {   // 64-row boxes, as every map has
          const int off = hh * kQTile * kRow + half * 64 * kRow;
          tma_load_4d(sm + off, &tm_q, q_full, 64 * hh, r0 + 64 * half, h, b);
          tma_load_4d(sm + L::OFF_DO + off, &tm_do, q_full, 64 * hh, r0 + 64 * half, h, b);
        }
      for (int i = 0; i < n; ++i) {
        const int s = i % L::ST;
        const int row = (jt0 + i) * kKvStep;
        mbar_wait(&empty[s], ((i / L::ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::KV_BYTES);
        unsigned char* sk = sm + L::OFF_K + s * 2 * L::KV_BYTES;
#pragma unroll
        for (int hh = 0; hh < L::NH; ++hh) {
          tma_load_4d(sk + hh * kKvStep * kRow, &tm_k, &full[s], 64 * hh, row, hk, b);
          tma_load_4d(sk + L::KV_BYTES + hh * kKvStep * kRow, &tm_v, &full[s], 64 * hh, row, hk, b);
        }
      }
    }
  } else {
    // ---------------- consumers: 64 q rows a warpgroup ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int tw = threadIdx.x & 127;
    const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, t4 = lane & 3;
    constexpr int NO = D / 2;
    const uint32_t q_addr = smem_u32(sm) + cw * 64 * kRow;
    const uint32_t do_addr = smem_u32(sm + L::OFF_DO) + cw * 64 * kRow;
    const int wrow0 = r0 + 64 * cw;               // the warpgroup's first q row
    const int ra = wrow0 + 16 * warp + g;         // this thread's q rows: ra, ra + 8
    const int rmin = a.q_offset + wrow0;
    const int rmax = a.q_offset + min(wrow0 + 64, a.Sq) - 1;
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra + 8 * r;
      const i64 i = ((i64)b * a.H + h) * a.Sq + row;
      lse2[r] = row < a.Sq ? a.lse[i] * kLog2e : 0.f;
      dlt[r] = row < a.Sq && !a.delta_from_out ? a.delta[i] : 0.f;
    }
    float dq[NO], sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < NO; ++i) dq[i] = 0.f;

    mbar_wait(q_full, 0);
    if (a.delta_from_out) {
      // delta = rowsum(dout * out) of this thread's two rows: the 4 threads of
      // a row split its D columns, dout from the staged tile, out from memory;
      // written for the dk/dv kernel, which runs next
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int trow = 64 * cw + 16 * warp + g + 8 * r, row = r0 + trow;
        float sum = 0.f;
        if (row < a.Sq) {
          const __nv_bfloat16* op = (const __nv_bfloat16*)a.out + (i64)b * a.o_sb +
                                    (i64)h * a.o_sh + (i64)row * a.o_ss;
#pragma unroll
          for (int jc = t4; jc < D / 8; jc += 4) {
            const uint4 d4 = *reinterpret_cast<const uint4*>(sm + L::OFF_DO + swz(trow, jc, kQTile));
            const uint4 o4 = *reinterpret_cast<const uint4*>(op + 8 * jc);
            const uint32_t dw[4] = {d4.x, d4.y, d4.z, d4.w}, ow[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sum = fmaf(__uint_as_float(dw[e] << 16), __uint_as_float(ow[e] << 16), sum);
              sum = fmaf(__uint_as_float(dw[e] & 0xffff0000u), __uint_as_float(ow[e] & 0xffff0000u), sum);
            }
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        dlt[r] = sum;
        if (t4 == 0 && row < a.Sq) a.delta[((i64)b * a.H + h) * a.Sq + row] = sum;
      }
    }
    for (int i = 0; i < n; ++i) {
      const int s = i % L::ST;
      const int c0 = (jt0 + i) * kKvStep;
      mbar_wait(&full[s], (i / L::ST) & 1);
      const bool hidden = wrow0 >= a.Sq || (a.causal && c0 > rmax) ||
                          (a.window > 0 && c0 + kKvStep - 1 <= rmin - a.window);
      if (!hidden) {
        const uint32_t k_addr = smem_u32(sm + L::OFF_K + s * 2 * L::KV_BYTES);
        const uint32_t v_addr = k_addr + L::KV_BYTES;

        // S = Q K^T and dP = dO V^T
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t ao = (kk >> 2) * (kQTile * kRow) + (kk & 3) * 32;
          const uint32_t bo = (kk >> 2) * (kKvStep * kRow) + (kk & 3) * 32;
          wgmma_ss_n64(sc, desc_sw128(q_addr + ao, 16), desc_sw128(k_addr + bo, 16), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t ao = (kk >> 2) * (kQTile * kRow) + (kk & 3) * 32;
          const uint32_t bo = (kk >> 2) * (kKvStep * kRow) + (kk & 3) * 32;
          wgmma_ss_n64(dp, desc_sw128(do_addr + ao, 16), desc_sw128(v_addr + bo, 16), kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);
        fence_regs(dp);

        const bool full_tile = c0 + kKvStep <= a.S && wrow0 + 64 <= a.Sq &&
                               (!a.causal || c0 + kKvStep - 1 <= rmin) &&
                               (a.window <= 0 || c0 > rmax - a.window);
        if (full_tile) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p_ds_sm90(sc[4 * j + e], dp[4 * j + e], lse2[e >> 1], dlt[e >> 1], true, a);
        } else {
          const FragMask mask(a, ra, c0 + 2 * t4);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p_ds_sm90(sc[4 * j + e], dp[4 * j + e], lse2[e >> 1], dlt[e >> 1],
                        mask.ok(8 * (e >> 1), 8 * j + (e & 1)), a);
        }
        pack_a(dp);

        // dQ += dS K, 16 kv rows a step, K MN-major
        fence_regs(dq);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKvStep / 16; ++kk) {
          const uint32_t f[4] = {__float_as_uint(dp[4 * kk]), __float_as_uint(dp[4 * kk + 1]),
                                 __float_as_uint(dp[4 * kk + 2]), __float_as_uint(dp[4 * kk + 3])};
          wgmma_rs_d<D>(dq, f, desc_sw128(k_addr + kk * 16 * kRow, kKvStep * kRow));
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(dq);
      }
      if (tw == 0) mbar_arrive(&empty[s]);
    }

    // dQ leaves through this warpgroup's rows of the Q tile
    wg_sync(1 + cw);
    stage_acc<D>(smem_u32(sm), dq, kQTile, 64 * cw);
    fence_async_smem();
    wg_sync(1 + cw);
    if (tw == 0 && wrow0 < a.Sq) {
#pragma unroll
      for (int hh = 0; hh < L::NH; ++hh)
        tma_store_4d(&tm_dq, smem_u32(sm) + hh * kQTile * kRow + 64 * cw * kRow, 64 * hh, wrow0, h,
                     b);
      bulk_commit();
      bulk_wait_all();
    }
  }
}

// ---------------------------------------------------------------------------
template <int D>
int launch(const BwdArgs& a, cudaStream_t stream) {
  // every map moves boxes of 64 rows (the dq kernel loads its 128-row Q and
  // dO tiles as two)
  static_assert(kKvTile == 64 && kQStep == 64 && kKvStep == 64, "64-row boxes");
  CUtensorMap tq, tdo, tk, tv, tdq, tdk, tdv;
  int e = make_map(&tq, a.q, D, a.Sq, a.H, a.B, a.q_ss, a.q_sh, a.q_sb, 64);
  if (e == 0) e = make_map(&tdo, a.dout, D, a.Sq, a.H, a.B, a.do_ss, a.do_sh, a.do_sb, 64);
  if (e == 0) e = make_map(&tk, a.k, D, a.S, a.KV, a.B, a.k_ss, a.k_sh, a.k_sb, 64);
  if (e == 0) e = make_map(&tv, a.v, D, a.S, a.KV, a.B, a.v_ss, a.v_sh, a.v_sb, 64);
  if (e == 0) e = make_map(&tdq, a.dq, D, a.Sq, a.H, a.B, a.dq_ss, a.dq_sh, a.dq_sb, 64);
  if (e == 0) e = make_map(&tdk, a.dk, D, a.S, a.KV, a.B, a.dk_ss, a.dk_sh, a.dk_sb, 64);
  if (e == 0) e = make_map(&tdv, a.dv, D, a.S, a.KV, a.B, a.dv_ss, a.dv_sh, a.dv_sb, 64);
  if (e != 0) return e;

  auto kq = bwd_dq_sm90_kernel<D>;
  auto kkv = bwd_dkv_sm90_kernel<D>;
  static bool attrs = false;    // the shared-memory attributes, set once a head dim
  if (!attrs) {
    cudaError_t err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           QLayout<D>::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 KvLayout<D>::SMEM);
    if (err != cudaSuccess) return (int)err;
    attrs = true;
  }
  const dim3 grid_q(a.H, a.B, (a.Sq + kQTile - 1) / kQTile);
  kq<<<grid_q, kThreads, QLayout<D>::SMEM, stream>>>(tq, tdo, tk, tv, tdq, a);
  if ((e = (int)cudaGetLastError()) != 0) return e;
  // the kv tiles that the most q tiles see (the first, under a causal mask) first
  const dim3 grid_kv(a.KV, a.B, (a.S + kKvTile - 1) / kKvTile);
  kkv<<<grid_kv, kThreads, KvLayout<D>::SMEM, stream>>>(tq, tdo, tk, tv, tdk, tdv, a);
  return (int)cudaGetLastError();
}

}  // namespace

int flash_attention_bwd_sm90(const BwdArgs& a, cudaStream_t stream) {
  switch (a.D) {
    case 64: return launch<64>(a, stream);
    case 128: return launch<128>(a, stream);
    default: return -1;
  }
}
