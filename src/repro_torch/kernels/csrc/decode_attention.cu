// Single-token GQA decode attention (flash-decode) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::decode_attention
// (body `_kernel`). That kernel walks the cache tile by tile on a sequential
// grid dimension and carries (acc, m, l) in scratch memory between steps.
//
// What bounds it on this card: bytes, if the arithmetic keeps up. One decode
// step reads every valid K and V row once (2 * B * n_valid * KV * D elements)
// and does 4 * G FLOPs per element read: 16 FLOP a byte at G = 8, about 54
// TFLOP/s at the full HBM rate. The CUDA cores cannot issue that: the first
// design (every lane group doing G dot products a row, each closed by a chain
// of shuffles, then G rescales and G x D FMAs for P V) ran qwen3-32b's decode,
// G 8 over 32768 slots, at 9.8x its byte bound, bound by its instruction
// stream. So the bf16 instance (every served model) puts both products on the
// tensor cores, at a cost a cache row that does not grow with G (1..8):
//   * q.k as `mma.sync` m16n8k16: the kv head's G query heads are the M rows
//     (padded to 16: rows 8-15 are zero registers, never computed on), 8
//     cache rows the N columns, D the depth; q's A fragments are loaded once
//     for the whole call (D / 8 registers), K's B fragments come from the
//     ring by `ldmatrix`;
//   * the online softmax runs on the accumulators: thread (g, t4) holds head
//     g's scores of rows 2 t4, 2 t4 + 1 of each 8-row tile, so a head's max
//     over a warp's rows is two shuffles inside its quad;
//   * P V is computed transposed, O^T (D x heads) += V^T P^T: M = 16 columns
//     of D (A = V^T, `ldmatrix.trans` of the ring's V rows), N = the 8 heads,
//     K = 16 cache rows. The score accumulators of head g are exactly the B
//     fragment of P^T, so p is only rounded to bf16 in place, and O takes D / 4
//     registers with no padded half (the other orientation, heads as M,
//     would pad 8 heads to 16 rows and double O's registers). The rescale of O's head columns takes each head's
//     factor from its quad by two shuffles.
// Per 16 cache rows and warp at D 128: 16 `ldmatrix.x4` and 24 `mma.sync`,
// whatever G is, against ~540 cycles of an SM's share of the HBM rate.
//
// With the arithmetic on the tensor cores, the copies set the pace. Per-row
// 16-byte `cp.async` copies held an SM to about 9 GB/s whatever the block
// count, G or layout (qwen3-32b's decode at 0.94 ms, 2.9x its bound; the
// same with the caches head-major, or at G 1), so a dense share (every
// serving path's prefix mask) comes in by TMA: one thread asks for each
// stage as 64-row boxes of 64 columns (128-byte swizzle), completion counted
// on the stage's mbarrier. A box that runs past the share brings other
// slots' rows, whose V rows the warp that reads them zeroes first; rows past
// S come in as zeros. A share that is not dense (a scattered mask) keeps the
// per-row copies, into the same swizzled layout. One block an SM
// (`decode_attention.num_splits`) then reads faster than two; a ring of 6
// stages instead of 3 (192 KB at D 128) moved nothing.
//
// The parts of the first design that stay:
//   * grid (C, KV, B) with the C blocks of one (batch, kv head) forming a
//     thread-block cluster (C <= 8). Each block counts its row's valid slots
//     and takes the rank-th of `nsplit` equal shares of them in order, so no
//     block walks masked rows: on the serving path the mask is a prefix and
//     a share is a contiguous (`dense`) run of rows. Each thread counts a run
//     of the mask, its byte loads independent; one block scan, then one for
//     each of the two runs that hold the share's ends (`find_share`). (The
//     first design scanned the whole row once a round of 1024 slots, 33
//     scans at 32768 slots, each behind a dependent load, before the first
//     copy.);
//   * the share's K and V rows stream through a shared-memory ring (no
//     registers held by loads in flight). A bf16 stage is 64 rows (256 at D
//     16), a 16-row step for each of the block's 4 warps (4 at D 16), its K
//     rows then its V rows, swizzled (padded by 16 bytes a row at D 16) so
//     that `ldmatrix` reads 8 rows from 8 bank groups; a per-row copy that
//     is not made (masked, past the share, or K of an all-masked row)
//     zero-fills its slot, so a p = 0 never meets stale bits;
//   * each warp keeps its own (m, l, O) over its rows; the warps merge in
//     shared memory, then the blocks of the cluster merge through distributed
//     shared memory with the flash-decode rule
//       w_i = exp(m_i - m*) * l_i,  out = sum(acc_i * w_i) / max(sum(w_i), 1e-30),
//     each block finishing a slice of the G x D outputs: no partials in device
//     memory and no second kernel. Blocks with an empty share hold
//     m = NEG_INF, l = 0 and weigh nothing.
// Budget (bf16): registers a thread, D 256: q 32, O 64, scores 8 (D 128: 16,
// 32, 8); ptxas: 181 registers at D 256, 128 at D 128, 79 at D 64, 56 at D
// 16, no spills. Shared memory, the ring 3 x 2 x 64 x 2 D bytes: 96 KB at
// D 128, 192 KB at D 256, 48 KB at D 64; 72 KB at D 16 (3 x 2 x 256 x 48).
// The fp32 instance (used only where the serving path runs fp32 copies, to
// hold the kernels against the einsum path) keeps the first design: lane
// groups of D * 4 / 16 lanes taking rows of the stage, all G heads (pre-scaled,
// in registers) sharing every row streamed, fp32 FMAs on the CUDA cores.
// A row whose mask is all False is what the TPU kernel's arithmetic makes of
// it: every slot takes part with score NEG_INF, so p = exp(0) = 1 everywhere,
// out is the mean of V, m = NEG_INF and l = S. Elsewhere a masked slot has
// p = 0 exactly, the same as exp(NEG_INF - m), and is never loaded.
#include <cooperative_groups.h>

#include "common.cuh"
#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kMaxGroup = 8;     // query heads of one kv head
constexpr int kStages = 3;       // K/V ring depth
constexpr int kStageBytes = 16384;       // fp32 instance: K and V bytes a stage
constexpr int kMmaStageBytes = 24576;    // bf16 instance: a stage of at least 64 rows
constexpr int kMR = 8;           // mask bytes a thread reads a round

template <int D, int GP>
struct Cfg {                                       // the fp32 instance
  static constexpr int E = 4;                      // elements per 16-byte load
  static constexpr int NV = D / E;                 // 16-byte pieces a cache row
  static constexpr int LPR = NV < 32 ? NV : 32;    // lanes per row
  static constexpr int VPL = NV / LPR;             // pieces per lane and row
  static constexpr int EPL = VPL * E;              // elements per lane and row
  static constexpr int RPW = 32 / LPR;             // rows per warp and pass
  static constexpr int NSG = kWarps * RPW;         // lane groups per block
  static constexpr int ROW = D * 4;                // bytes of a K or V row
  static constexpr int UB0 = kStageBytes / (NSG * 2 * ROW);
  static constexpr int UB = UB0 < 1 ? 1 : (UB0 > 4 ? 4 : UB0);  // rows a lane group takes a stage
  static constexpr int R = NSG * UB;               // rows a stage
  static constexpr int STAGE = R * 2 * ROW;        // a row's K, then its V
  static constexpr int RING = kStages * STAGE;
  static constexpr int MERGE = NSG * GP * (D + 2) * 4;  // lane groups' partials, m, l
  static constexpr int SMEM = RING > MERGE ? RING : MERGE;
};

template <int D>
struct MmaCfg {                                    // the bf16 instance
  static constexpr int ROW = D * 2;                // bytes of a K or V row
  // D >= 64: a tile is D / 64 boxes of 64 columns x R rows, 128-byte rows,
  // 16-byte chunks XOR-ed by row % 8 (the layout TMA writes with the
  // 128-byte swizzle), whichever copy fills it; D 16: rows padded by 16 bytes
  static constexpr bool SW = D >= 64;
  static constexpr int LDR = SW ? ROW : ROW + 16;  // a row's pitch (D 16)
  static constexpr int NV = ROW / 16;              // 16-byte chunks a row
  static constexpr int UB0 = kMmaStageBytes / (kWarps * 16 * 2 * ROW);
  static constexpr int UB = UB0 < 1 ? 1 : (UB0 > 4 ? 4 : UB0);  // 16-row steps a warp takes a stage
  static constexpr int RW = 16 * UB;               // rows a warp takes a stage
  static constexpr int R = kWarps * RW;            // rows a stage
  static constexpr int TILE = R * LDR;             // the stage's K rows, then its V rows
  static constexpr int STAGE = 2 * TILE;
  static constexpr int RING = kStages * STAGE;
  static constexpr int MERGE = kWarps * kMaxGroup * (D + 2) * 4;  // warps' partials, m, l
  static constexpr int SMEM = (RING > MERGE ? RING : MERGE) + (SW ? 1024 : 0);  // + alignment
  static_assert(!SW || R == 64, "TMA boxes of 64 rows");

  // byte offset of 8-column chunk `chunk` of row `row` in a K or V tile
  static __device__ __forceinline__ uint32_t off(int row, int chunk) {
    if constexpr (SW) return sm90::swz(row, chunk, R);
    else return (uint32_t)(row * LDR + chunk * 16);
  }
};

__device__ __forceinline__ void widen(const uint4& raw, float* out) {
  out[0] = __uint_as_float(raw.x); out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z); out[3] = __uint_as_float(raw.w);
}

// Bit e set: slot c0 + e (< S) is valid. Eight independent loads.
__device__ __forceinline__ uint32_t mask_bits(const unsigned char* mb, i64 m_ss, int c0, int S) {
  unsigned char v[kMR];
#pragma unroll
  for (int e = 0; e < kMR; ++e) v[e] = c0 + e < S ? mb[(i64)(c0 + e) * m_ss] : 0;
  uint32_t bits = 0;
#pragma unroll
  for (int e = 0; e < kMR; ++e) bits |= (uint32_t)(v[e] != 0) << e;
  return bits;
}

// Position of the k-th set bit of `bits`.
__device__ __forceinline__ int nth_bit(uint32_t bits, int k) {
#pragma unroll
  for (int e = 0; e < kMR; ++e)
    if ((bits >> e) & 1u) {
      if (k == 0) return e;
      --k;
    }
  return kMR;
}

// Exclusive prefix of `c` over the block's threads; `total` gets the sum.
// Two scans that share `sm` must be a __syncthreads apart.
__device__ __forceinline__ int block_scan(int c, int* sm, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) sm[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += sm[w];
    total += sm[w];
  }
  return before + incl - c;
}

// Valid slots of [a, b), kMR slots a load.
__device__ __forceinline__ int count_run(const unsigned char* mb, i64 m_ss, int a, int b) {
  int c = 0;
#pragma unroll 4
  for (int base = a; base < b; base += kMR) c += __popc(mask_bits(mb, m_ss, base, b));
  return c;
}

// Slot of the k-th valid slot of [a, b) (k below their count).
__device__ __forceinline__ int nth_in_run(const unsigned char* mb, i64 m_ss, int a, int b, int k) {
  for (int base = a; base < b; base += kMR) {
    const uint32_t bits = mask_bits(mb, m_ss, base, b);
    const int c = __popc(bits);
    if (k < c) return base + nth_bit(bits, k);
    k -= c;
  }
  return b;
}

// `n` slots cut into kThreads runs: a run's length, a multiple of kMR.
__device__ __forceinline__ int run_span(int n) {
  return ((n + kThreads - 1) / kThreads + kMR - 1) / kMR * kMR;
}

// This block's share of the row: slots [p0, p1), holding the valid ordinals
// [o0, o1) of the rank-th of `nsplit` equal shares (of all S slots when no
// slot is valid). `dense`: every slot of [p0, p1) takes part. Thread t counts
// the run [t span, (t + 1) span) of the mask (its loads independent of one
// another), and one block scan gives each run's first ordinal; where a run is
// longer than one load, the two runs that hold ordinals o0 and o1 - 1 are
// then cut among the threads the same way, one scan each; the thread whose
// piece holds an ordinal finds its slot. sm_pos: 6 ints.
struct Share {
  int p0, p1;
  bool dense, all_masked;
};

__device__ __forceinline__ Share find_share(const unsigned char* mb, i64 m_ss, int S, int rank,
                                            int nsplit, int (*sm_scan)[kWarps], int* sm_pos) {
  const int tid = threadIdx.x;
  const int span = run_span(S);
  const int a0 = min(S, tid * span), a1 = min(S, a0 + span);
  const int c = count_run(mb, m_ss, a0, a1);
  int n_valid;
  const int excl = block_scan(c, sm_scan[0], n_valid);

  Share sh;
  sh.all_masked = n_valid == 0;
  const int total = sh.all_masked ? S : n_valid;
  const int o0 = rank < nsplit ? (int)((i64)total * rank / nsplit) : total;
  const int o1 = rank < nsplit ? (int)((i64)total * (rank + 1) / nsplit) : total;
  sh.p0 = o0;
  sh.p1 = o1;
  sh.dense = true;
  if (!sh.all_masked) {
    sh.p0 = sh.p1 = 0;
    if (o1 > o0) {
      const int ord[2] = {o0, o1 - 1};
      if (span == kMR) {                // S <= kThreads * kMR: a run is one load
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (excl <= ord[e] && ord[e] < excl + c)
            sm_pos[4 + e] = nth_in_run(mb, m_ss, a0, a1, ord[e] - excl);
      } else {
        // the runs that hold the two ordinals, and their ranks there
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (excl <= ord[e] && ord[e] < excl + c) { sm_pos[e] = a0; sm_pos[2 + e] = ord[e] - excl; }
        __syncthreads();
        const int sub = run_span(span);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r0 = sm_pos[e], k = sm_pos[2 + e], r1 = min(S, r0 + span);
          const int b0 = min(r1, r0 + tid * sub), b1 = min(r1, b0 + sub);
          const int ce = count_run(mb, m_ss, b0, b1);
          int unused;
          // sm_scan[1] then [0]: each a __syncthreads after its last use
          const int ee = block_scan(ce, sm_scan[1 - e], unused);
          if (ee <= k && k < ee + ce) sm_pos[4 + e] = nth_in_run(mb, m_ss, b0, b1, k - ee);
        }
      }
      __syncthreads();
      sh.p0 = sm_pos[4];
      sh.p1 = sm_pos[5] + 1;
      sh.dense = sh.p1 - sh.p0 == o1 - o0;
    }
  }
  return sh;
}

// The block's NSG partials (sm_acc[(j * GP + g) * D + d], sm_m / sm_l[j * GP +
// g], written and __syncthreads-ed by the caller) merged into the block's
// one, then the cluster's blocks merged through distributed shared memory,
// each block writing a slice of the G x D outputs.
template <typename T, int D, int GP, int NSG>
__device__ __forceinline__ void merge_and_store(
    cg::cluster_group& cluster, const float* sm_acc, const float* sm_m, const float* sm_l,
    float* sm_bacc, float* sm_bm, float* sm_bl, float* sm_w, float* sm_den,
    T* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out, i64 obase, int G) {
  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float m_star = NEG_INF;
#pragma unroll
    for (int j = 0; j < NSG; ++j) m_star = fmaxf(m_star, sm_m[j * GP + g]);
    float num = 0.f;
#pragma unroll
    for (int j = 0; j < NSG; ++j) num += __expf(sm_m[j * GP + g] - m_star) * sm_acc[(j * GP + g) * D + d];
    sm_bacc[idx] = num;
  }
  if (tid < G) {
    float bm = NEG_INF, bl = 0.f;
#pragma unroll
    for (int j = 0; j < NSG; ++j) bm = fmaxf(bm, sm_m[j * GP + tid]);
#pragma unroll
    for (int j = 0; j < NSG; ++j) bl += __expf(sm_m[j * GP + tid] - bm) * sm_l[j * GP + tid];
    sm_bm[tid] = bm;
    sm_bl[tid] = bl;
  }

  // merge the cluster's blocks; each block finishes a slice of the G x D outputs
  cluster.sync();
  if (tid < G) {
    float mj[kMaxCluster], m_star = NEG_INF, den = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      mj[j] = NEG_INF;
      if (j < csize) mj[j] = cluster.map_shared_rank(sm_bm, j)[tid];
      m_star = fmaxf(m_star, mj[j]);
    }
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j) {
      if (j < csize) {
        const float w = __expf(mj[j] - m_star);
        sm_w[j * GP + tid] = w;
        den += w * cluster.map_shared_rank(sm_bl, j)[tid];
      }
    }
    sm_den[tid] = den;
    if (rank == 0 && m_out != nullptr) { m_out[obase + tid] = m_star; l_out[obase + tid] = den; }
  }
  __syncthreads();
  for (int idx = rank * kThreads + tid; idx < G * D; idx += csize * kThreads) {
    const int g = idx / D;
    float num = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j)
      if (j < csize) num += sm_w[j * GP + g] * cluster.map_shared_rank(sm_bacc, j)[idx];
    out[obase * D + idx] = from_float<T>(num / fmaxf(sm_den[g], 1e-30f));
  }
  cluster.sync();                   // no block leaves while another reads its memory
}

// 16 bytes global -> shared; `load` false writes 16 zero bytes instead and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool load = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src),
                  "r"(load ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// fp32 instance: lane groups on the CUDA cores
template <int D, int GP>
__global__ void __launch_bounds__(kThreads)
decode_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const unsigned char* __restrict__ mask,
                  float* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                  int S, int KV, int G, int nsplit,
                  i64 k_sb, i64 k_ss, i64 k_sh, i64 v_sb, i64 v_ss, i64 v_sh,
                  i64 m_sb, i64 m_ss, float scale, float softcap) {
  using C = Cfg<D, GP>;
  constexpr int E = C::E, NV = C::NV, LPR = C::LPR, VPL = C::VPL, EPL = C::EPL,
                RPW = C::RPW, NSG = C::NSG, ROW = C::ROW, UB = C::UB, R = C::R;

  extern __shared__ __align__(16) unsigned char ring[];  // K/V stages, then partials
  __shared__ float sm_bacc[GP * D];     // this block's merged partial (read by the cluster)
  __shared__ float sm_bm[GP], sm_bl[GP];
  __shared__ float sm_w[kMaxCluster * GP], sm_den[GP];
  __shared__ int sm_scan[2][kWarps];
  __shared__ int sm_pos[6];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lis = lane % LPR;               // lane within its group
  const int sg = warp * RPW + lane / LPR;   // this lane's group

  // q is requested before anything waits on a load
  const unsigned char* mb = mask + (i64)b * m_sb;
  uint4 qraw[GP][VPL];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int vv = 0; vv < VPL; ++vv)
      qraw[g][vv] = g < G ? *reinterpret_cast<const uint4*>(
                                q + ((i64)(b * KV + h) * G + g) * D + (vv * LPR + lis) * E)
                          : make_uint4(0, 0, 0, 0);

  const Share sh = find_share(mb, m_ss, S, rank, nsplit, sm_scan, sm_pos);
  const int p0 = sh.p0, p1 = sh.p1;
  const bool dense = sh.dense, all_masked = sh.all_masked;

  // q, pre-scaled, all G heads of the kv head
  float qf[GP][EPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
#pragma unroll
    for (int vv = 0; vv < VPL; ++vv) widen(qraw[g][vv], &qf[g][vv * E]);
#pragma unroll
    for (int e = 0; e < EPL; ++e) qf[g][e] *= scale;
  }

  const float* kb = k + (i64)b * k_sb + (i64)h * k_sh;
  const float* vb = v + (i64)b * v_sb + (i64)h * v_sh;
  const int nchunks = (p1 - p0 + R - 1) / R;
  // stage st holds rows p0 + c R .. of chunk c: row j's K at (2 j) ROW, its V at (2 j + 1) ROW
  auto issue = [&](int c) {
    unsigned char* st = ring + (c % kStages) * C::STAGE;
    for (int idx = tid; idx < R * 2 * NV; idx += kThreads) {
      const int j = idx / (2 * NV), kvsel = (idx / NV) & 1, pc = idx % NV;
      const int r = p0 + c * R + j;
      if (r < p1 && !(all_masked && kvsel == 0) && (dense || mb[(i64)r * m_ss] != 0)) {
        const float* src = (kvsel ? vb + (i64)r * v_ss : kb + (i64)r * k_ss) + pc * E;
        cp_async16(st + (2 * j + kvsel) * ROW + pc * 16, src);
      }
    }
  };
#pragma unroll
  for (int c = 0; c < kStages; ++c) {
    if (c < nchunks) issue(c);
    cp_async_commit();
  }

  float m[GP], l[GP], acc[GP][EPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = NEG_INF; l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 1>();       // this thread's copies of chunk c have landed
    __syncthreads();                    // and everyone else's
    const unsigned char* st = ring + (c % kStages) * C::STAGE;
    bool ok[UB];
    float sc[UB][GP];
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int j = u * NSG + sg;
      const int r = p0 + c * R + j;
      ok[u] = r < p1 && (dense || mb[(i64)r * m_ss] != 0);
#pragma unroll
      for (int g = 0; g < GP; ++g) sc[u][g] = NEG_INF;
      if (!all_masked) {
        float kf[EPL];
#pragma unroll
        for (int vv = 0; vv < VPL; ++vv)
          widen(*reinterpret_cast<const uint4*>(st + 2 * j * ROW + (vv * LPR + lis) * 16),
                &kf[vv * E]);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          if (g < G) {                  // uniform over the block
            float d = 0.f;
#pragma unroll
            for (int e = 0; e < EPL; ++e) d += qf[g][e] * kf[e];
#pragma unroll
            for (int off = LPR / 2; off > 0; off >>= 1)
              d += __shfl_xor_sync(0xffffffffu, d, off);
            if (softcap > 0.f) d = tanhf(d * inv_cap) * softcap;
            if (ok[u]) sc[u][g] = d;
          }
        }
      }
    }
    float p[UB][GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < UB; ++u) m_new = fmaxf(m_new, sc[u][g]);
      const float alpha = __expf(m[g] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        p[u][g] = ok[u] ? __expf(sc[u][g] - m_new) : 0.f;
        psum += p[u][g];
      }
      l[g] = l[g] * alpha + psum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      if (ok[u]) {
        const int j = u * NSG + sg;
        float vf[EPL];
#pragma unroll
        for (int vv = 0; vv < VPL; ++vv)
          widen(*reinterpret_cast<const uint4*>(st + (2 * j + 1) * ROW + (vv * LPR + lis) * 16),
                &vf[vv * E]);
#pragma unroll
        for (int g = 0; g < GP; ++g)
          if (g < G) {
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[g][e] += p[u][g] * vf[e];
          }
      }
    }
    __syncthreads();                    // everyone is done with this stage
    if (c + kStages < nchunks) issue(c + kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();                      // the ring is free: it takes the partials

  // the lane groups' partials: sm_acc[(sg * GP + g) * D + d], sm_m, sm_l
  float* sm_acc = reinterpret_cast<float*>(ring);
  float* sm_m = sm_acc + NSG * GP * D;
  float* sm_l = sm_m + NSG * GP;
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g < G) {
#pragma unroll
      for (int vv = 0; vv < VPL; ++vv)
#pragma unroll
        for (int e = 0; e < E; ++e)
          sm_acc[(sg * GP + g) * D + (vv * LPR + lis) * E + e] = acc[g][vv * E + e];
      if (lis == 0) { sm_m[sg * GP + g] = m[g]; sm_l[sg * GP + g] = l[g]; }
    }
  }
  __syncthreads();
  merge_and_store<float, D, GP, NSG>(cluster, sm_acc, sm_m, sm_l, sm_bacc, sm_bm, sm_bl, sm_w,
                                     sm_den, out, m_out, l_out, (i64)(b * KV + h) * G, G);
}

// ---------------------------------------------------------------------------
// bf16 instance: both products on the tensor cores
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_mma_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                  const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const unsigned char* __restrict__ mask,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ m_out,
                  float* __restrict__ l_out, int S, int KV, int G, int nsplit,
                  i64 k_sb, i64 k_ss, i64 k_sh, i64 v_sb, i64 v_ss, i64 v_sh,
                  i64 m_sb, i64 m_ss, float scale, float softcap) {
  using C = MmaCfg<D>;
  constexpr int KS = D / 16, UB = C::UB, RW = C::RW, R = C::R, NV = C::NV;
  constexpr int GP = kMaxGroup;

  extern __shared__ __align__(16) unsigned char smem_raw[];  // K/V stages, then partials
  unsigned char* ring = C::SW ? reinterpret_cast<unsigned char*>(
                                    (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023))
                              : smem_raw;
  __shared__ float sm_bacc[GP * D];
  __shared__ float sm_bm[GP], sm_bl[GP];
  __shared__ float sm_w[kMaxCluster * GP], sm_den[GP];
  __shared__ int sm_scan[2][kWarps];
  __shared__ int sm_pos[6];
  __shared__ __align__(8) uint64_t full[kStages];   // TMA stages

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;   // this thread's head (M row) and quad lane

  const unsigned char* mb = mask + (i64)b * m_sb;
  // q as the A operand of q.k: head g's columns 16 kk + 2 t4 (+1) and + 8;
  // the padded heads (g >= G) and M rows 8-15 are zero
  uint32_t qa[KS][2];
  const __nv_bfloat16* qrow = q + ((i64)(b * KV + h) * G + g) * D + 2 * t4;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    qa[kk][0] = g < G ? *reinterpret_cast<const uint32_t*>(qrow + 16 * kk) : 0u;
    qa[kk][1] = g < G ? *reinterpret_cast<const uint32_t*>(qrow + 16 * kk + 8) : 0u;
  }
  if (C::SW && tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) sm90::mbar_init(&full[st], 1);
    sm90::mbar_init_fence();
  }

  const Share sh = find_share(mb, m_ss, S, rank, nsplit, sm_scan, sm_pos);
  const int p0 = sh.p0, p1 = sh.p1;
  const bool dense = sh.dense, all_masked = sh.all_masked;
  // a dense share (the serving path's prefix masks) comes in by TMA (rows
  // past S as zeros); any other by per-row copies
  const bool tma = C::SW && dense;

  const __nv_bfloat16* kb = k + (i64)b * k_sb + (i64)h * k_sh;
  const __nv_bfloat16* vb = v + (i64)b * v_sb + (i64)h * v_sh;
  const int nchunks = (p1 - p0 + R - 1) / R;
  // stage st holds rows p0 + c R + j of chunk c: K row j at off(j, .), V row j
  // at TILE + off(j, .)
  auto tma_issue = [&](int c) {             // one thread
    unsigned char* st = ring + (c % kStages) * C::STAGE;
    uint64_t* bar = &full[c % kStages];
    sm90::mbar_expect_tx(bar, C::STAGE);
#pragma unroll
    for (int hh = 0; hh < D / 64; ++hh) {
      sm90::tma_load_4d(st + hh * R * sm90::kRow, &tm_k, bar, 64 * hh, p0 + c * R, h, b);
      sm90::tma_load_4d(st + C::TILE + hh * R * sm90::kRow, &tm_v, bar, 64 * hh, p0 + c * R, h, b);
    }
  };
  // a slot that is not loaded is zero-filled
  auto issue = [&](int c) {
    unsigned char* st = ring + (c % kStages) * C::STAGE;
    for (int idx = tid; idx < 2 * R * NV; idx += kThreads) {
      const int kvsel = idx / (R * NV), j = (idx / NV) % R, pc = idx % NV;
      const int r = p0 + c * R + j;
      const bool load = r < p1 && !(all_masked && kvsel == 0) && (dense || mb[(i64)r * m_ss] != 0);
      const __nv_bfloat16* src = load ? (kvsel ? vb + (i64)r * v_ss : kb + (i64)r * k_ss) + pc * 8 : kb;
      cp_async16(st + kvsel * C::TILE + C::off(j, pc), src, load);
    }
  };
  __syncthreads();                          // the barriers are initialised
  if (tma) {
    if (tid == 0)
      for (int c = 0; c < kStages && c < nchunks; ++c) tma_issue(c);
  } else {
#pragma unroll
    for (int c = 0; c < kStages; ++c) {
      if (c < nchunks) issue(c);
      cp_async_commit();
    }
  }

  // O^T accumulators: o[mt] holds (d 16 mt + g, heads 2 t4, 2 t4 + 1) and (d + 8, ...)
  float o[KS][4];
#pragma unroll
  for (int mt = 0; mt < KS; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;      // head g over this warp's rows (l: this thread's share)

  for (int c = 0; c < nchunks; ++c) {
    if (tma) {
      sm90::mbar_wait(&full[c % kStages], (c / kStages) & 1);
    } else {
      cp_async_wait<kStages - 1>();     // this thread's copies of chunk c have landed
      __syncthreads();                  // and everyone else's
    }
    unsigned char* sK = ring + (c % kStages) * C::STAGE;
    unsigned char* sV = sK + C::TILE;
    const int j0 = warp * RW;           // the warp's first row of the stage
    const int r0 = p0 + c * R + j0;
    if (r0 < p1) {                      // uniform over the warp
      if (tma && r0 + RW > p1) {
        // the box ran past the share: its V rows there are other slots', zeroed
        // so that p = 0 meets no stale or non-finite value (rows past S came in as zeros)
        for (int idx = lane; idx < (r0 + RW - p1) * NV; idx += 32) {
          const int j = p1 - (p0 + c * R) + idx / NV;
          *reinterpret_cast<uint4*>(sV + C::off(j, idx % NV)) = make_uint4(0u, 0u, 0u, 0u);
        }
        sm90::fence_async_smem();       // before the TMA writes this slot again
        __syncwarp();
      }
      // scores: s[j] holds head g at rows j0 + 8 j + 2 t4 (+1) (and padded heads)
      float s[2 * UB][4];
#pragma unroll
      for (int j = 0; j < 2 * UB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int u = 0; u < UB; ++u) {
          uint32_t bk[4];
          ldsm_x4(bk, sK + C::off(j0 + 16 * u + (lane & 7) + (lane >> 4) * 8,
                                  2 * kk + ((lane >> 3) & 1)));
          mma_bf16(s[2 * u], qa[kk][0], 0u, qa[kk][1], 0u, bk[0], bk[1]);
          mma_bf16(s[2 * u + 1], qa[kk][0], 0u, qa[kk][1], 0u, bk[2], bk[3]);
        }

      // online softmax of head g: the 4 lanes of its quad share it
      bool ok[2 * UB][2];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2 * UB; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = r0 + 8 * j + 2 * t4 + e;
          ok[j][e] = r < p1 && (dense || mb[(i64)r * m_ss] != 0);
          float x = s[j][e] * scale;
          if (softcap > 0.f) x = tanhf(x * inv_cap) * softcap;
          s[j][e] = ok[j][e] && !all_masked ? x : NEG_INF;
          mx = fmaxf(mx, s[j][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = __expf(m_run - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * UB; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ok[j][e] ? __expf(s[j][e] - m_new) : 0.f;
          s[j][e] = p;
          psum += p;
        }
      l_run = l_run * alpha + psum;
      m_run = m_new;
      // O's columns are heads 2 t4 and 2 t4 + 1: their factors from lanes 8 t4 and 8 t4 + 4
      const float a_lo = __shfl_sync(0xffffffffu, alpha, 8 * t4);
      const float a_hi = __shfl_sync(0xffffffffu, alpha, 8 * t4 + 4);
#pragma unroll
      for (int mt = 0; mt < KS; ++mt) {
        o[mt][0] *= a_lo; o[mt][1] *= a_hi; o[mt][2] *= a_lo; o[mt][3] *= a_hi;
      }

      // O^T += V^T P^T, 16 rows a k-step: P^T's B fragment is head g's p of
      // rows 16 u + 2 t4 (+1) and 16 u + 8 + 2 t4 (+1), as the scores lie
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        const uint32_t b0 = pack_bf16(s[2 * u][0], s[2 * u][1]);
        const uint32_t b1 = pack_bf16(s[2 * u + 1][0], s[2 * u + 1][1]);
#pragma unroll
        for (int mt = 0; mt < KS; ++mt) {
          uint32_t av[4];
          ldsm_x4_trans(av, sV + C::off(j0 + 16 * u + (lane & 7) + ((lane >> 4) & 1) * 8,
                                        2 * mt + ((lane >> 3) & 1)));
          mma_bf16(o[mt], av[0], av[1], av[2], av[3], b0, b1);
        }
      }
    }
    __syncthreads();                    // everyone is done with this stage
    if (c + kStages < nchunks) {
      if (!tma) issue(c + kStages);
      else if (tid == 0) tma_issue(c + kStages);
    }
    if (!tma) cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();                      // the ring is free: it takes the partials

  // the warps' partials: sm_acc[(warp * GP + head) * D + d], sm_m, sm_l
  float* sm_acc = reinterpret_cast<float*>(ring);
  float* sm_m = sm_acc + kWarps * GP * D;
  float* sm_l = sm_m + kWarps * GP;
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  float* wacc = sm_acc + warp * GP * D;
#pragma unroll
  for (int mt = 0; mt < KS; ++mt) {
    const int d = 16 * mt + g;
    wacc[(2 * t4) * D + d] = o[mt][0];
    wacc[(2 * t4 + 1) * D + d] = o[mt][1];
    wacc[(2 * t4) * D + d + 8] = o[mt][2];
    wacc[(2 * t4 + 1) * D + d + 8] = o[mt][3];
  }
  if (t4 == 0) { sm_m[warp * GP + g] = m_run; sm_l[warp * GP + g] = l_run; }
  __syncthreads();
  merge_and_store<__nv_bfloat16, D, GP, kWarps>(cluster, sm_acc, sm_m, sm_l, sm_bacc, sm_bm,
                                                sm_bl, sm_w, sm_den, out, m_out, l_out,
                                                (i64)(b * KV + h) * G, G);
}

// ---------------------------------------------------------------------------
struct DecodeArgs {
  const void *q, *k, *v, *mask;
  void* out;
  float *m_out, *l_out;
  int B, S, KV, G, D, nsplit, cluster;
  i64 k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, m_sb, m_ss;
  float scale, softcap;
  cudaStream_t stream;
};

// `attr_set`: the kernel's own flag (its shared-memory attribute, set once)
template <typename T, typename Kern>
int launch_k(Kern kern, int smem, bool& attr_set, const DecodeArgs& a) {
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, a.KV, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, (const T*)a.q, (const T*)a.k, (const T*)a.v,
      (const unsigned char*)a.mask, (T*)a.out, a.m_out, a.l_out, a.S, a.KV, a.G, a.nsplit,
      a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss, a.v_sh, a.m_sb, a.m_ss, a.scale, a.softcap);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int D, int GP>
int launch_fma(const DecodeArgs& a) {
  static bool attr_set = false;
  return launch_k<float>(decode_fma_kernel<D, GP>, Cfg<D, GP>::SMEM, attr_set, a);
}

template <int D>
int launch_fma_g(const DecodeArgs& a) {
  if (a.G == 1) return launch_fma<D, 1>(a);
  if (a.G == 2) return launch_fma<D, 2>(a);
  if (a.G <= 4) return launch_fma<D, 4>(a);
  return launch_fma<D, 8>(a);
}

// The bf16 instance, with the tensor maps of its TMA path (D >= 64): K and V
// as (D, S, KV, B) in 64-column x 64-row boxes (the wrapper hands over strides
// of whole 16 bytes, as TMA needs).
template <int D>
int launch_mma(const DecodeArgs& a) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, MmaCfg<D>::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  CUtensorMap tk{}, tv{};
  if constexpr (MmaCfg<D>::SW) {
    int e = sm90::make_map(&tk, a.k, D, a.S, a.KV, a.B, a.k_ss, a.k_sh, a.k_sb, MmaCfg<D>::R);
    if (e == 0)
      e = sm90::make_map(&tv, a.v, D, a.S, a.KV, a.B, a.v_ss, a.v_sh, a.v_sb, MmaCfg<D>::R);
    if (e != 0) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, a.KV, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = MmaCfg<D>::SMEM;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  typedef __nv_bfloat16 T;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_mma_kernel<D>, tk, tv, (const T*)a.q, (const T*)a.k, (const T*)a.v,
      (const unsigned char*)a.mask, (T*)a.out, a.m_out, a.l_out, a.S, a.KV, a.G, a.nsplit,
      a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss, a.v_sh, a.m_sb, a.m_ss, a.scale, a.softcap);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int launch_d(const DecodeArgs& a, bool bf16) {
  switch (a.D) {
    case 16: return bf16 ? launch_mma<16>(a) : launch_fma_g<16>(a);
    case 64: return bf16 ? launch_mma<64>(a) : launch_fma_g<64>(a);
    case 128: return bf16 ? launch_mma<128>(a) : launch_fma_g<128>(a);
    case 256: return bf16 ? launch_mma<256>(a) : launch_fma_g<256>(a);
    default: return -1;
  }
}

}  // namespace

// Returns 0, a cudaError_t of the launch, -1 (head dim), -2 (group size), -3
// (shares / cluster size) or 1000 + a CUresult (tensor map). dtype: 0 = float32 (CUDA cores), 1 = bfloat16
// (tensor cores). Strides are in elements. m_out and l_out may be null (stats
// not wanted). `cluster` blocks (1, 2, 4 or 8) serve one (batch, kv head);
// the first `nsplit` of them take a share of the valid slots.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* out,
    float* m_out, float* l_out, int B, int S, int KV, int G, int D, int nsplit, int cluster,
    i64 k_sb, i64 k_ss, i64 k_sh, i64 v_sb, i64 v_ss, i64 v_sh, i64 m_sb, i64 m_ss,
    float scale, float softcap, int dtype, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || nsplit < 1 || nsplit > cluster) return -3;
  if (G < 1 || G > kMaxGroup) return -2;
  DecodeArgs a{q, k, v, mask, out, m_out, l_out, B, S, KV, G, D, nsplit, cluster,
               k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, m_sb, m_ss,
               scale, softcap, (cudaStream_t)stream};
  return launch_d(a, dtype == 1);
}
