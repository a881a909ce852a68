// Causal / sliding-window / soft-capped GQA flash attention (prefill) for
// Hopper, sm_90a: the `wgmma` + TMA route, bf16 at D = 64, 128 and 256.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body `_kernel`) on the serving and training shapes; the `mma.sync` and fp32
// kernels of flash_attention.cu keep bf16 at D = 16 and fp32.
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
//
// D = 256 (gemma2's head dim; its prefill, q 2 x 8 x 8192 x 256 causal with
// soft cap 50, needs 550 GFLOP of visible products, 0.556 ms at 989 TFLOP/s:
// operations bound it) runs the same walk, masks and softmax. What D 256
// changes:
//   * registers: O over D is 128 fp32 registers a consumer thread, and a
//     score tile of 80 K/V rows 40 more. With the producer warpgroup ptxas
//     would hold every thread at 168, so the block is the two consumer
//     warpgroups alone, 255 registers a thread (`Roles`): each consumer's
//     first thread loads its own 64 rows of Q, and `kRefill` loads the K/V
//     ring, the first stages and then each stage once both consumers have
//     released it, walking on into the block's next items;
//   * shared memory: Q (128 x 256, 64 KB) and two stages of 80-row K and V
//     (80 KB a stage): 224 KB of the 227. There is no room for a separate
//     output tile, so a consumer stages its O in its own rows of Q after its
//     last S product and loads its next Q there once the TMA store has read
//     them. 80 rows rather than 64: a `wgmma` with A in shared memory reads
//     A again for every instruction, so m64n64k16 reads as many bytes a
//     clock as the SM's shared memory gives; m64n80k16 reads 10 % less, and
//     the kernel runs 8-13 % faster at gemma2-2b's shapes than with 64-row
//     stages (an H100 80GB HBM3 at 700 W, tools/k1_variants.py);
//   * S = Q K^T is m64n80k16 (16 k-steps), O += P V m64n256k16 with P from
//     registers (5 a stage); a stage that causality or the window hides
//     from all of a consumer's 64 rows (under a causal mask the last one of
//     each item, for the first consumer) is waited for and released, not
//     computed;
//   * the two consumers take turns on the tensor cores (named barriers):
//     each issues a product once the other has issued its last one, so that
//     one's softmax tends to run while the other's products do. A schedule
//     that issues S of the next tile with P V of this one (and K and V on
//     barriers of their own) did not fit: it spilled at 255 registers and,
//     with each refill waiting on the other consumer's S, ran at half the
//     speed;
//   * the soft cap is tanh(y) = 1 - 2 / (1 + 2^(2 y log2 e)), one `ex2` and
//     one `rcp` on the special-function unit (absolute error a few 1e-7,
//     times the cap), against `tanhf`'s longer sequence: with the cap, a
//     score costs three special-function operations (0.43 ms at the prefill
//     shape), which the other consumer's products have to hide.
// A probability of a masked column is exactly 0 (not exp(0)), as in the other
// two routes; a row that sees no column gives what the TPU kernel gives
// (blind_row in flash_attention.cuh).
#include "flash_attention.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 128;       // q rows an item (two consumer warpgroups of 64)
constexpr int kBarTurn = 3;    // (D 256) named barrier kBarTurn + cw: consumer cw's turn

template <int D>
struct Layout {
  static constexpr bool kInline = Roles<D>::kInline;
  static constexpr int BN = kInline ? 80 : 128;     // K/V rows a stage
  static constexpr int NH = D / 64;                 // 64-column boxes a row
  static constexpr int Q_BYTES = kBM * D * 2;       // = the two consumers' output staging
  static constexpr int KV_BYTES = BN * D * 2;       // K or V, one stage
  // K/V ring depth: four stages where they fit beside Q and the staging
  static constexpr int ST = 2 * Q_BYTES + 4 * 2 * KV_BYTES <= 200 * 1024 ? 4 : 2;
  static constexpr int OFF_K = Q_BYTES;             // stage s: OFF_K + s * 2 * KV_BYTES
  static constexpr int OFF_O = OFF_K + ST * 2 * KV_BYTES;   // kInline: O leaves through Q
  static constexpr int OFF_BAR = OFF_O + (kInline ? 0 : Q_BYTES);
  static constexpr int SMEM = OFF_BAR + 128 + 1024; // + barriers + alignment slack
  static_assert(SMEM <= 232448, "shared memory a block may have");
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

template <int BN>
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
  it.jt0 = lo / BN;
  it.n_tiles = max(0, (hi + BN - 1) / BN - it.jt0);
  return it;
}

// The k-th item of block j of P: a snake over the items (heaviest first), so
// that every block gets a like mix of heavy and light ones.
__device__ __forceinline__ int item_at(int k, int P, int j) {
  return k * P + ((k & 1) ? P - 1 - j : j);
}

// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(Roles<D>::kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o, const Sm90Args a) {
  using L = Layout<D>;
  using R = Roles<D>;
  constexpr int BN = L::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::OFF_BAR);
  // D 64 / 128: Q's full and empty barriers. D 256: q_full + cw, the full
  // barrier of consumer cw's own rows of Q
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = bars + 2 + L::ST;
  const int n_items = ((a.Sq + kBM - 1) / kBM) * a.H * a.B;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, R::kInline ? 1 : 2);   // one arrival from each consumer warpgroup
#pragma unroll
    for (int s = 0; s < L::ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (!R::kInline && wg == 0) {
    // ---------------- producer: one thread issues every copy ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int it = 0;                  // K/V tiles issued so far (the ring's position)
      for (int t = 0, w; (w = item_at(t, gridDim.x, blockIdx.x)) < n_items; ++t) {
        const Item I = item_of<BN>(w, a);
        mbar_wait(q_empty, (t & 1) ^ 1);
        mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
        for (int hh = 0; hh < L::NH; ++hh)
          tma_load_4d(sm + hh * kBM * kRow, &tm_q, q_full, 64 * hh, I.r0, I.h, I.b);
        for (int i = 0; i < I.n_tiles; ++i, ++it) {
          const int s = it % L::ST;
          const int row = (I.jt0 + i) * BN;
          mbar_wait(&empty[s], ((it / L::ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * L::KV_BYTES);
          unsigned char* sk = sm + L::OFF_K + s * 2 * L::KV_BYTES;
          unsigned char* sv = sk + L::KV_BYTES;
#pragma unroll
          for (int hh = 0; hh < L::NH; ++hh) {
            tma_load_4d(sk + hh * BN * kRow, &tm_k, &full[s], 64 * hh, row, I.hk, I.b);
            tma_load_4d(sv + hh * BN * kRow, &tm_v, &full[s], 64 * hh, row, I.hk, I.b);
          }
        }
      }
    }
  } else {
    // ---------------- consumers: 64 q rows a warpgroup ----------------
    if constexpr (!R::kInline) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = (threadIdx.x - R::kFirstConsumer) / 128;
    const int tw = threadIdx.x & 127;
    const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, t4 = lane & 3;
    constexpr int NO = D / 2;                       // output accumulators a thread
    const uint32_t q_addr = smem_u32(sm) + cw * 64 * kRow;
    const float sl2 = a.scale * kLog2e;             // scores are kept in log2 units

    // (D 256) this warpgroup's 64 rows of item I's Q tile, by its first thread
    auto load_q = [&](const Item& I) {
      mbar_expect_tx(q_full + cw, L::Q_BYTES / 2);
#pragma unroll
      for (int hh = 0; hh < L::NH; ++hh)
        tma_load_4d(sm + hh * kBM * kRow + cw * 64 * kRow, &tm_q, q_full + cw, 64 * hh,
                    I.r0 + 64 * cw, I.h, I.b);
    };
    // (D 256) the refill thread's place in the walk of the block's K/V tiles:
    // tile li of its lt-th item LI, going into ring position lp
    int lt = 0, li = 0, lp = 0;
    Item LI{};
    auto next_tile = [&]() -> bool {   // moves past items with no tile left; false at the end
      while (li == LI.n_tiles) {
        const int w = item_at(++lt, gridDim.x, blockIdx.x);
        if (w >= n_items) return false;
        LI = item_of<BN>(w, a);
        li = 0;
      }
      return true;
    };
    auto load_tile = [&]() {
      const int s = lp % L::ST;
      const int row = (LI.jt0 + li) * BN;
      mbar_expect_tx(&full[s], 2 * L::KV_BYTES);
      unsigned char* sk = sm + L::OFF_K + s * 2 * L::KV_BYTES;
#pragma unroll
      for (int hh = 0; hh < L::NH; ++hh) {
        tma_load_4d(sk + hh * BN * kRow, &tm_k, &full[s], 64 * hh, row, LI.hk, LI.b);
        tma_load_4d(sk + L::KV_BYTES + hh * BN * kRow, &tm_v, &full[s], 64 * hh, row, LI.hk,
                    LI.b);
      }
      ++li;
      ++lp;
    };
    if constexpr (R::kInline) {
      LI = item_of<BN>(item_at(0, gridDim.x, blockIdx.x), a);   // blocks <= items
      if (tw == 0) load_q(LI);
      if (threadIdx.x == R::kRefill)
        for (int k = 0; k < L::ST && next_tile(); ++k) load_tile();
    }

    // (D 256) the two consumers take turns on the tensor cores: each issues a
    // product once the other has issued its last one, and hands the turn on
    // as soon as it has issued its own, so that one's softmax runs while the
    // other's products do. A stage that a consumer does not compute still
    // takes and hands on both of its turns.
    auto my_turn = [&]() {
      if constexpr (R::kInline) bar_sync(kBarTurn + cw, 256);
    };
    auto pass_turn = [&]() {
      if constexpr (R::kInline) bar_arrive(kBarTurn + 1 - cw, 256);
    };
    if constexpr (R::kInline)
      if (cw == 1) pass_turn();                     // the first consumer starts

    // sc: S, then P in fp32, then P in bf16 pairs (its first half)
    float o[NO], sc[BN / 2], m[2], l[2], alpha[2];
    int it = 0;
    for (int t = 0, w; (w = item_at(t, gridDim.x, blockIdx.x)) < n_items; ++t) {
      const Item I = item_of<BN>(w, a);
      const int n = I.n_tiles;
      const int wrow0 = I.r0 + 64 * cw;               // first q row of the warpgroup
      const int wrow_min = a.q_offset + wrow0, wrow_max = wrow_min + 63;
      const int row_a = wrow_min + 16 * warp + g;     // this thread's rows: row_a, row_a + 8
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] = 0.f;
      m[0] = m[1] = NEG_INF;
      l[0] = l[1] = 0.f;

      mbar_wait(R::kInline ? q_full + cw : q_full, t & 1);
      if (!R::kInline && n == 0 && tw == 0) mbar_arrive(q_empty);
      for (int i = 0; i < n; ++i, ++it) {
        const uint32_t k_addr = smem_u32(sm + L::OFF_K + (it % L::ST) * 2 * L::KV_BYTES);
        const uint32_t v_addr = k_addr + L::KV_BYTES;
        const int c0 = (I.jt0 + i) * BN;
        mbar_wait(&full[it % L::ST], (it / L::ST) & 1);
        // a stage narrower than the q tile can lie wholly past the causal
        // diagonal of this warpgroup's rows, or wholly before their window
        // (unless a row sees no column: it takes every column < S)
        const bool hidden =
            BN < kBM && ((a.causal && c0 > wrow_max) ||
                         (a.window > 0 && c0 + BN - 1 <= wrow_min - a.window &&
                          !blind_row(wrow_max, a.S, a.window)));
        if (!hidden) {
          // S = Q K^T, 16 columns of D a step (32 bytes inside a swizzled row)
          fence_regs(sc);
          my_turn();
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t qo = (kk >> 2) * (kBM * kRow) + (kk & 3) * 32;
            const uint32_t ko = (kk >> 2) * (BN * kRow) + (kk & 3) * 32;
            wgmma_ss<BN>(sc, desc_sw128(q_addr + qo, 16), desc_sw128(k_addr + ko, 16), kk > 0);
          }
          wgmma_commit();
          pass_turn();
          wgmma_wait0();
          fence_regs(sc);
          if (!R::kInline && i == n - 1 && tw == 0) mbar_arrive(q_empty);   // the last product that reads Q

          // soft cap and mask; a score's log2 value is then sc * k
          float k = sl2;
          if (a.softcap > 0.f) {
            if constexpr (R::kInline) {
              // cap tanh(y) log2 e with tanh(y) = 1 - 2 / (1 + 2^(2 y log2 e))
              const float c2 = 2.f * a.scale * kLog2e / a.softcap, cap_l2 = a.softcap * kLog2e;
#pragma unroll
              for (int e = 0; e < BN / 2; ++e)
                sc[e] = fmaf(-2.f * cap_l2, rcp(1.f + ex2(sc[e] * c2)), cap_l2);
            } else {
              const float inv_cap = 1.f / a.softcap, cap_l2 = a.softcap * kLog2e;
#pragma unroll
              for (int e = 0; e < BN / 2; ++e) sc[e] = tanhf(sc[e] * a.scale * inv_cap) * cap_l2;
            }
            k = 1.f;
          }
          // only tiles that cross an edge of the visible band are masked
          const bool full_tile = c0 + BN <= a.S && (!a.causal || c0 + BN - 1 <= wrow_min) &&
                                 (a.window <= 0 || c0 > wrow_max - a.window);
          if (!full_tile) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
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
            for (int j = 0; j < BN / 8; ++j)
              m4[j & 3] = fmaxf(m4[j & 3], fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
            float mx = fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[r], mx > 0.5f * NEG_INF ? mx * k : NEG_INF);
            alpha[r] = ex2(m[r] - m_new);
            float s4[4] = {0.f, 0.f, 0.f, 0.f};   // this thread's share, in four chains
            if (full_tile) {
#pragma unroll
              for (int j = 0; j < BN / 8; ++j)
#pragma unroll
                for (int e = 2 * r; e < 2 * r + 2; ++e) {
                  const float p = ex2(fmaf(sc[4 * j + e], k, -m_new));
                  sc[4 * j + e] = p;
                  s4[j & 3] += p;
                }
            } else {
              // a masked score's p is 0, also where m_new is NEG_INF
#pragma unroll
              for (int j = 0; j < BN / 8; ++j)
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
          for (int kk = 0; kk < BN / 16; ++kk)
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
          my_turn();
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) {
            const uint32_t pk[4] = {__float_as_uint(sc[4 * kk]), __float_as_uint(sc[4 * kk + 1]),
                                    __float_as_uint(sc[4 * kk + 2]), __float_as_uint(sc[4 * kk + 3])};
            wgmma_rs_d<D>(o, pk, desc_sw128(v_addr + kk * 16 * kRow, BN * kRow));
          }
          wgmma_commit();
          pass_turn();
          wgmma_wait0();
          fence_regs(o);
        } else if constexpr (R::kInline) {
          my_turn();
          pass_turn();
          my_turn();
          pass_turn();
        }
        if (tw == 0) mbar_arrive(&empty[it % L::ST]);      // done with this stage
        if constexpr (R::kInline) {                         // refill it once both released it
          if (threadIdx.x == R::kRefill && next_tile()) {
            mbar_wait(&empty[it % L::ST], (it / L::ST) & 1);
            load_tile();                                    // ring position it + ST
          }
        }
      }

      // epilogue: normalise, stage the 64 x D tile, store it by TMA
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
      if constexpr (R::kInline) {
        // through this warpgroup's rows of Q, once all four warps' products
        // have read them; its next Q comes in there once the store has read them
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= inv[0]; o[4 * j + 1] *= inv[0];
          o[4 * j + 2] *= inv[1]; o[4 * j + 3] *= inv[1];
        }
        wg_sync(1 + cw);
        stage_acc<D>(smem_u32(sm), o, kBM, 64 * cw);
        fence_async_smem();                           // visible to TMA
        wg_sync(1 + cw);
        if (tw == 0) {                                // rows past Sq are not written
#pragma unroll
          for (int hh = 0; hh < L::NH; ++hh)
            tma_store_4d(&tm_o, q_addr + hh * kBM * kRow, 64 * hh, wrow0, I.h, I.b);
          bulk_commit();
          const int wn = item_at(t + 1, gridDim.x, blockIdx.x);
          if (wn < n_items) {
            bulk_wait_read();
            load_q(item_of<BN>(wn, a));
          }
        }
      } else {
        const uint32_t stg = smem_u32(sm + L::OFF_O + cw * (L::Q_BYTES / 2));   // output staging
        if (tw == 0) bulk_wait_read();                // the last item's store has read stg
        wg_sync(1 + cw);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = 16 * warp + g + 8 * r;
            sts32(stg + swz(row, j, 64) + 4 * t4,
                  pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]));
          }
        fence_async_smem();                           // visible to TMA
        wg_sync(1 + cw);
        if (tw == 0) {                                // rows past Sq are not written
#pragma unroll
          for (int hh = 0; hh < L::NH; ++hh)
            tma_store_4d(&tm_o, stg + hh * 64 * kRow, 64 * hh, wrow0, I.h, I.b);
          bulk_commit();
        }
      }
      if (t4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = wrow0 + 16 * warp + g + 8 * r;
          if (row < a.Sq) a.lse[((i64)I.b * a.H + I.h) * a.Sq + row] = lse_r[r];
        }
      }
    }
    if constexpr (R::kInline)
      if (cw == 0) my_turn();                       // the second consumer's last hand-on
    if (tw == 0) bulk_wait_all();                     // all stored
  }
}

template <int D>
int launch(const FlashArgs& a, cudaStream_t stream) {
  using L = Layout<D>;
  using R = Roles<D>;
  // D 256: each consumer loads its own 64 rows of Q
  CUtensorMap tq, tk, tv, to;
  int e = make_map(&tq, a.q, D, a.Sq, a.H, a.B, a.q_ss, a.q_sh, a.q_sb, R::kInline ? 64 : kBM);
  if (e == 0) e = make_map(&tk, a.k, D, a.S, a.KV, a.B, a.k_ss, a.k_sh, a.k_sb, L::BN);
  if (e == 0) e = make_map(&tv, a.v, D, a.S, a.KV, a.B, a.v_ss, a.v_sh, a.v_sb, L::BN);
  if (e == 0) e = make_map(&to, a.out, D, a.Sq, a.H, a.B, a.o_ss, a.o_sh, a.o_sb, 64);
  if (e != 0) return e;
  auto kern = flash_fwd_sm90_kernel<D>;
  static int sms = 0;                // the card's SMs; the attribute is set with it
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) { sms = 0; return (int)err; }
  }
  const Sm90Args args{a.out, a.lse, a.B, a.H, a.KV, a.Sq, a.S, a.o_sb, a.o_sh, a.o_ss,
                      a.scale, a.softcap, a.causal, a.window, a.q_offset};
  const long long items = (long long)((a.Sq + kBM - 1) / kBM) * a.H * a.B;
  const unsigned blocks = (unsigned)(items < sms ? items : sms);   // persistent
  kern<<<blocks, R::kThreads, L::SMEM, stream>>>(tq, tk, tv, to, args);
  return (int)cudaGetLastError();
}

}  // namespace

int flash_attention_sm90(const FlashArgs& a, cudaStream_t stream) {
  switch (a.D) {
    case 64: return launch<64>(a, stream);
    case 128: return launch<128>(a, stream);
    case 256: return launch<256>(a, stream);
    default: return -1;
  }
}
