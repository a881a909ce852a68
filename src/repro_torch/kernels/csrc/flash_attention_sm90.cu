// Causal / sliding-window / soft-capped GQA flash attention (prefill) for
// Hopper, sm_90a: the `wgmma` + TMA route, bf16 at D = 64 and 128.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body `_kernel`) on the serving and training shapes; the `mma.sync` and fp32
// kernels of flash_attention.cu keep the other head dims and fp32.
//
// What bounds it on this card: at the serving shape (q 8 x 24 x 512 x 128,
// k/v 8 x 8 x 512 x 128, causal) the 67 MB of q, k, v and out take 0.020 ms
// at the memory rate and the 12.9 GFLOP of visible products 0.013 ms at the
// bf16 tensor-core rate. Each (q tile, head) sees at most four 128-row K/V
// tiles, so what a short walk pays once (the first loads, the epilogue) and
// the softmax between the two products set the pace, not the products.
// What the design does about it:
//   * a persistent grid, one block an SM, each walking work items (a 128-row
//     q tile of one head) heaviest first in a snake order, so that a block's
//     loads for its next item overlap the end of the current one;
//   * a producer warpgroup and two consumer warpgroups of 64 q rows each.
//     One producer thread moves every tile by TMA (`cp.async.bulk.tensor`,
//     4-d tensor maps over the (D, S, heads, batch) strides, so the model's
//     (B, S, H, D) views are read in place): Q once an item into a buffer with
//     a full and an empty barrier, K and V through a ring of stages, each with
//     a full barrier the producer arms with the bytes it expects and an empty
//     barrier both consumers arrive on when done with it. Rows past Sq or S
//     come in as zeros (columns >= S are masked explicitly);
//   * 128-byte swizzle: a bf16 row of D = 128 comes in as two 64-column
//     boxes, each a run of 128-byte rows whose 16-byte chunks are XOR-permuted
//     by row % 8, the layout `wgmma` reads without bank conflicts;
//   * S = Q K^T: `wgmma` m64n128k16, both operands in shared memory, K-major,
//     fp32 accumulators; online softmax in registers on the accumulator
//     fragment (a row lives in the 4 threads of a quad), in log2 units with
//     `ex2.approx`;
//   * O += P V: `wgmma` with A = P from registers (the S accumulator's layout
//     is the register A-operand layout: P is rounded to bf16 pairs in place)
//     and B = V from shared memory, MN-major through the transpose bit;
//   * only the visible K/V tiles are loaded: causal stops at the diagonal, a
//     window starts at its first visible tile; only the diagonal and edge
//     tiles are masked element by element;
//   * epilogue: normalise by max(l, 1e-30), stage the tile in shared memory
//     (the same swizzle) and hand it to a TMA store that runs on while the
//     consumer starts its next item; lse = m + log(denom) in fp32.
// The consumers' registers limit the design: the kernel compiles to 168 a
// thread, and O (64) plus S (64) leave no room to keep a second score tile in
// flight (a schedule that issues S_{i+1} with P_i V_i spills), so each
// consumer runs S, softmax and P V in turn and the two consumers overlap each
// other.
// A probability of a masked column is exactly 0 (not exp(0)), as in the other
// two routes; a row that sees no column gives what the TPU kernel gives
// (blind_row in flash_attention.cuh).
#include "flash_attention.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 128;       // q rows an item (two consumer warpgroups of 64)
constexpr int kBN = 128;       // K/V rows a stage
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups

template <int D>
struct Layout {
  static constexpr int NH = D / 64;                 // 64-column boxes a row
  static constexpr int Q_BYTES = kBM * D * 2;       // = the two consumers' output staging
  static constexpr int KV_BYTES = kBN * D * 2;      // K or V, one stage
  // K/V ring depth: four stages where they fit beside Q and the staging
  static constexpr int ST = 2 * Q_BYTES + 4 * 2 * KV_BYTES <= 200 * 1024 ? 4 : 2;
  static constexpr int OFF_K = Q_BYTES;             // stage s: OFF_K + s * 2 * KV_BYTES
  static constexpr int OFF_O = OFF_K + ST * 2 * KV_BYTES;
  static constexpr int OFF_BAR = OFF_O + Q_BYTES;
  static constexpr int SMEM = OFF_BAR + 128 + 1024; // + barriers + alignment slack
};

struct Sm90Args {
  void* out;
  float* lse;
  int B, H, KV, Sq, S;
  i64 o_sb, o_sh, o_ss;
  float scale, softcap;
  int causal, window, q_offset;
};

// ---------------------------------------------------------------------------
// One work item: a 128-row q tile of one (batch, q head) and the K/V tiles it
// can see. Items are numbered heaviest first (under a causal mask the last q
// tile sees the most K/V tiles), the q heads of one kv head side by side, so
// that their K/V tiles come from L2.
struct Item {
  int h, b, hk, r0, jt0, n_tiles;
};

__device__ __forceinline__ Item item_of(int w, const Sm90Args& a) {
  const int nq = (a.Sq + kBM - 1) / kBM;
  const int bh = a.B * a.H;
  const int qi = nq - 1 - w / bh;
  const int rem = w % bh;
  Item it;
  it.h = rem % a.H;
  it.b = rem / a.H;
  it.hk = it.h / (a.H / a.KV);
  it.r0 = qi * kBM;
  const int rows_here = min(kBM, a.Sq - it.r0);
  const int row_min = a.q_offset + it.r0;
  const int row_max = row_min + rows_here - 1;
  const int hi = a.causal ? min(a.S, row_max + 1) : a.S;
  const int lo = a.window > 0 && !blind_row(row_max, a.S, a.window)
                     ? max(0, row_min - a.window + 1) : 0;
  it.jt0 = lo / kBN;
  it.n_tiles = max(0, (hi + kBN - 1) / kBN - it.jt0);
  return it;
}

// The k-th item of block j of P: a snake over the items (heaviest first), so
// that every block gets a like mix of heavy and light ones.
__device__ __forceinline__ int item_at(int k, int P, int j) {
  return k * P + ((k & 1) ? P - 1 - j : j);
}

// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o, const Sm90Args a) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::OFF_BAR);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = bars + 2 + L::ST;
  const int n_items = ((a.Sq + kBM - 1) / kBM) * a.H * a.B;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2);         // one arrival from each consumer warpgroup
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
      int it = 0;                  // K/V tiles issued so far (the ring's position)
      for (int t = 0, w; (w = item_at(t, gridDim.x, blockIdx.x)) < n_items; ++t) {
        const Item I = item_of(w, a);
        mbar_wait(q_empty, (t & 1) ^ 1);
        mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
        for (int hh = 0; hh < L::NH; ++hh)
          tma_load_4d(sm + hh * kBM * kRow, &tm_q, q_full, 64 * hh, I.r0, I.h, I.b);
        for (int i = 0; i < I.n_tiles; ++i, ++it) {
          const int s = it % L::ST;
          const int row = (I.jt0 + i) * kBN;
          mbar_wait(&empty[s], ((it / L::ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * L::KV_BYTES);
          unsigned char* sk = sm + L::OFF_K + s * 2 * L::KV_BYTES;
          unsigned char* sv = sk + L::KV_BYTES;
#pragma unroll
          for (int hh = 0; hh < L::NH; ++hh) {
            tma_load_4d(sk + hh * kBN * kRow, &tm_k, &full[s], 64 * hh, row, I.hk, I.b);
            tma_load_4d(sv + hh * kBN * kRow, &tm_v, &full[s], 64 * hh, row, I.hk, I.b);
          }
        }
      }
    }
  } else {
    // ---------------- consumers: 64 q rows a warpgroup ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int tw = threadIdx.x & 127;
    const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, t4 = lane & 3;
    constexpr int NO = D / 2;                       // output accumulators a thread
    const uint32_t q_addr = smem_u32(sm) + cw * 64 * kRow;
    const uint32_t stg = smem_u32(sm + L::OFF_O + cw * (L::Q_BYTES / 2));   // output staging
    const float sl2 = a.scale * kLog2e;             // scores are kept in log2 units

    // sc: S, then P in fp32, then P in bf16 pairs (its first half)
    float o[NO], sc[kBN / 2], m[2], l[2], alpha[2];
    int it = 0;
    for (int t = 0, w; (w = item_at(t, gridDim.x, blockIdx.x)) < n_items; ++t) {
      const Item I = item_of(w, a);
      const int n = I.n_tiles;
      const int wrow0 = I.r0 + 64 * cw;               // first q row of the warpgroup
      const int wrow_min = a.q_offset + wrow0, wrow_max = wrow_min + 63;
      const int row_a = wrow_min + 16 * warp + g;     // this thread's rows: row_a, row_a + 8
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] = 0.f;
      m[0] = m[1] = NEG_INF;
      l[0] = l[1] = 0.f;

      mbar_wait(q_full, t & 1);
      if (n == 0 && tw == 0) mbar_arrive(q_empty);
      for (int i = 0; i < n; ++i, ++it) {
        const uint32_t k_addr = smem_u32(sm + L::OFF_K + (it % L::ST) * 2 * L::KV_BYTES);
        const uint32_t v_addr = k_addr + L::KV_BYTES;
        mbar_wait(&full[it % L::ST], (it / L::ST) & 1);

        // S = Q K^T, 16 columns of D a step (32 bytes inside a swizzled row)
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t qo = (kk >> 2) * (kBM * kRow) + (kk & 3) * 32;
          const uint32_t ko = (kk >> 2) * (kBN * kRow) + (kk & 3) * 32;
          wgmma_ss_n128(sc, desc_sw128(q_addr + qo, 16), desc_sw128(k_addr + ko, 16), kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);
        if (i == n - 1 && tw == 0) mbar_arrive(q_empty);   // the last product that reads Q

        // soft cap and mask; a score's log2 value is then sc * k
        const int c0 = (I.jt0 + i) * kBN;
        float k = sl2;
        if (a.softcap > 0.f) {
          const float inv_cap = 1.f / a.softcap, cap_l2 = a.softcap * kLog2e;
#pragma unroll
          for (int e = 0; e < kBN / 2; ++e) sc[e] = tanhf(sc[e] * a.scale * inv_cap) * cap_l2;
          k = 1.f;
        }
        // only tiles that cross an edge of the visible band are masked
        const bool full_tile = c0 + kBN <= a.S && (!a.causal || c0 + kBN - 1 <= wrow_min) &&
                               (a.window <= 0 || c0 > wrow_max - a.window);
        if (!full_tile) {
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = row_a + (e >> 1) * 8;
              const int col = c0 + j * 8 + 2 * t4 + (e & 1);
              bool ok = col < a.S;
              if (a.causal) ok = ok && col <= row;
              if (a.window > 0) ok = ok && col > row - a.window;
              if (!ok) sc[4 * j + e] = blind_row(row, a.S, a.window) && col < a.S ? 0.f : NEG_INF;
            }
        }
        // online softmax: the 4 threads of a quad share rows g and g + 8
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float m4[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF};   // four chains, not one
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j)
            m4[j & 3] = fmaxf(m4[j & 3], fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
          float mx = fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[r], mx > 0.5f * NEG_INF ? mx * k : NEG_INF);
          alpha[r] = ex2(m[r] - m_new);
          float s4[4] = {0.f, 0.f, 0.f, 0.f};   // this thread's share, in four chains
          if (full_tile) {
#pragma unroll
            for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
              for (int e = 2 * r; e < 2 * r + 2; ++e) {
                const float p = ex2(fmaf(sc[4 * j + e], k, -m_new));
                sc[4 * j + e] = p;
                s4[j & 3] += p;
              }
          } else {
            // a masked score's p is 0, also where m_new is NEG_INF
#pragma unroll
            for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
              for (int e = 2 * r; e < 2 * r + 2; ++e) {
                const float x = sc[4 * j + e];
                const float p = x > 0.5f * NEG_INF ? ex2(fmaf(x, k, -m_new)) : 0.f;
                sc[4 * j + e] = p;
                s4[j & 3] += p;
              }
          }
          l[r] = l[r] * alpha[r] + ((s4[0] + s4[1]) + (s4[2] + s4[3]));
          m[r] = m_new;
        }
        // P's k-step kk (score columns 16 kk .. 16 kk + 15) -> sc[4 kk .. 4 kk + 3]
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            sc[4 * kk + q] = __uint_as_float(pack_bf16(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1]));

        // O = alpha O + P V, 16 keys a step
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= alpha[0]; o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1]; o[4 * j + 3] *= alpha[1];
        }
        fence_regs(o);
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          const uint32_t pk[4] = {__float_as_uint(sc[4 * kk]), __float_as_uint(sc[4 * kk + 1]),
                                  __float_as_uint(sc[4 * kk + 2]), __float_as_uint(sc[4 * kk + 3])};
          wgmma_rs_d<D>(o, pk, desc_sw128(v_addr + kk * 16 * kRow, kBN * kRow));
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(o);
        if (tw == 0) mbar_arrive(&empty[it % L::ST]);      // done with this stage
      }

      // epilogue: normalise, stage the 64 x D tile, store 16 bytes a lane
      float inv[2], lse_r[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum = l[r];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float den = fmaxf(sum, 1e-30f);
        inv[r] = 1.f / den;
        lse_r[r] = (m[r] == NEG_INF || blind_row(row_a + 8 * r, a.S, a.window)
                        ? NEG_INF : m[r] * kLn2) + logf(den);
      }
      if (tw == 0) bulk_wait_read();                  // the last item's store has read stg
      wg_sync(1 + cw);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * warp + g + 8 * r;
          sts32(stg + swz(row, j, 64) + 4 * t4,
                pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]));
        }
      fence_async_smem();                             // visible to TMA
      wg_sync(1 + cw);
      if (tw == 0) {                                  // rows past Sq are not written
#pragma unroll
        for (int hh = 0; hh < L::NH; ++hh)
          tma_store_4d(&tm_o, stg + hh * 64 * kRow, 64 * hh, wrow0, I.h, I.b);
        bulk_commit();
      }
      if (t4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = wrow0 + 16 * warp + g + 8 * r;
          if (row < a.Sq) a.lse[((i64)I.b * a.H + I.h) * a.Sq + row] = lse_r[r];
        }
      }
    }
    if (tw == 0) bulk_wait_all();                     // all stored
  }
}

template <int D>
int launch(const FlashArgs& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  int e = make_map(&tq, a.q, D, a.Sq, a.H, a.B, a.q_ss, a.q_sh, a.q_sb, kBM);
  if (e == 0) e = make_map(&tk, a.k, D, a.S, a.KV, a.B, a.k_ss, a.k_sh, a.k_sb, kBN);
  if (e == 0) e = make_map(&tv, a.v, D, a.S, a.KV, a.B, a.v_ss, a.v_sh, a.v_sb, kBN);
  if (e == 0) e = make_map(&to, a.out, D, a.Sq, a.H, a.B, a.o_ss, a.o_sh, a.o_sb, 64);
  if (e != 0) return e;
  auto kern = flash_fwd_sm90_kernel<D>;
  static int sms = 0;                // the card's SMs; the attribute is set with it
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 Layout<D>::SMEM);
    if (err != cudaSuccess) { sms = 0; return (int)err; }
  }
  const Sm90Args args{a.out, a.lse, a.B, a.H, a.KV, a.Sq, a.S, a.o_sb, a.o_sh, a.o_ss,
                      a.scale, a.softcap, a.causal, a.window, a.q_offset};
  const long long items = (long long)((a.Sq + kBM - 1) / kBM) * a.H * a.B;
  const unsigned blocks = (unsigned)(items < sms ? items : sms);   // persistent
  kern<<<blocks, kThreads, Layout<D>::SMEM, stream>>>(tq, tk, tv, to, args);
  return (int)cudaGetLastError();
}

}  // namespace

int flash_attention_sm90(const FlashArgs& a, cudaStream_t stream) {
  switch (a.D) {
    case 64: return launch<64>(a, stream);
    case 128: return launch<128>(a, stream);
    default: return -1;
  }
}
