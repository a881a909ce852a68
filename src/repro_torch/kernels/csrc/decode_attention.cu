// Single-token GQA decode attention (flash-decode) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::decode_attention
// (body `_kernel`). That kernel walks the cache tile by tile on a sequential
// grid dimension and carries (acc, m, l) in scratch memory between steps.
//
// What bounds it on this card: bytes. One decode step reads every valid K and
// V row once (2 * B * n_valid * KV * D elements) and does ~4*G FLOPs per
// element read, far below the ~295 FLOP/byte where the tensor cores would
// matter; at the serving shape those bytes take 5 us, about what one launch
// costs. So the design is one launch, every block of it resident at once,
// each with its whole share of the cache in flight:
//   * grid (C, KV, B) with the C blocks of one (batch, kv head) forming a
//     thread-block cluster (C <= 8). Each block reads its row's mask (eight
//     independent byte loads a thread and round), counts the valid slots and
//     takes the rank-th of `nsplit` equal shares of them in order, so no
//     block walks masked rows: on the serving path the mask is a prefix and
//     a share is a contiguous run of rows;
//   * the share's K and V rows stream through a 3-stage shared-memory ring by
//     16-byte `cp.async` copies (16 KB a stage, 48 KB in flight a block, no
//     registers held by loads in flight), so a serving share (about 130 rows,
//     67 KB of K and V) is about one and a half rings of copies. Each lane
//     group (D * sizeof(T) / 16 lanes) takes rows of the stage; all G query
//     heads of the kv head (pre-scaled, in registers) share every row
//     streamed;
//   * the lane groups merge in shared memory, then the blocks of the cluster
//     merge through distributed shared memory with the flash-decode rule
//       w_i = exp(m_i - m*) * l_i,  out = sum(acc_i * w_i) / max(sum(w_i), 1e-30),
//     each block finishing a slice of the G x D outputs: no partials in device
//     memory and no second kernel. Blocks with an empty share hold
//     m = NEG_INF, l = 0 and weigh nothing.
// A row whose mask is all False is what the TPU kernel's arithmetic makes of
// it: every slot takes part with score NEG_INF, so p = exp(0) = 1 everywhere,
// out is the mean of V, m = NEG_INF and l = S. Elsewhere a masked slot has
// p = 0 exactly, the same as exp(NEG_INF - m), and is never loaded.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kStages = 3;       // K/V ring depth
constexpr int kStageBytes = 16384;
constexpr int kMR = 8;           // mask bytes a thread reads a round

template <typename T, int D, int GP>
struct Cfg {
  static constexpr int E = Vec16<T>::E;            // elements per 16-byte load
  static constexpr int NV = D / E;                 // 16-byte pieces a cache row
  static constexpr int LPR = NV < 32 ? NV : 32;    // lanes per row
  static constexpr int VPL = NV / LPR;             // pieces per lane and row
  static constexpr int EPL = VPL * E;              // elements per lane and row
  static constexpr int RPW = 32 / LPR;             // rows per warp and pass
  static constexpr int NSG = kWarps * RPW;         // lane groups per block
  static constexpr int ROW = D * (int)sizeof(T);   // bytes of a K or V row
  static constexpr int UB0 = kStageBytes / (NSG * 2 * ROW);
  static constexpr int UB = UB0 < 1 ? 1 : (UB0 > 4 ? 4 : UB0);  // rows a lane group takes a stage
  static constexpr int R = NSG * UB;               // rows a stage
  static constexpr int STAGE = R * 2 * ROW;        // a row's K, then its V
  static constexpr int RING = kStages * STAGE;
  static constexpr int MERGE = NSG * GP * (D + 2) * 4;  // lane groups' partials, m, l
  static constexpr int SMEM = RING > MERGE ? RING : MERGE;
};

__device__ __forceinline__ void widen(const uint4& raw, float* out, float) {
  out[0] = __uint_as_float(raw.x); out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z); out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void widen(const uint4& raw, float* out, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x; out[2 * i + 1] = f.y;
  }
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T, int D, int GP>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const unsigned char* __restrict__ mask, T* __restrict__ out,
              float* __restrict__ m_out, float* __restrict__ l_out,
              int S, int KV, int G, int nsplit,
              i64 k_sb, i64 k_ss, i64 k_sh, i64 v_sb, i64 v_ss, i64 v_sh,
              i64 m_sb, i64 m_ss, float scale, float softcap) {
  using C = Cfg<T, D, GP>;
  constexpr int E = C::E, NV = C::NV, LPR = C::LPR, VPL = C::VPL, EPL = C::EPL,
                RPW = C::RPW, NSG = C::NSG, ROW = C::ROW, UB = C::UB, R = C::R;

  extern __shared__ __align__(16) unsigned char ring[];  // K/V stages, then partials
  __shared__ float sm_bacc[GP * D];     // this block's merged partial (read by the cluster)
  __shared__ float sm_bm[GP], sm_bl[GP];
  __shared__ float sm_w[kMaxCluster * GP], sm_den[GP];
  __shared__ int sm_scan[2][kWarps];
  __shared__ int sm_pos[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const int csize = (int)cluster.num_blocks();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lis = lane % LPR;               // lane within its group
  const int sg = warp * RPW + lane / LPR;   // this lane's group

  // the first round of the mask (the whole row where S <= kThreads * kMR) and
  // q are requested before anything waits on a load
  const unsigned char* mb = mask + (i64)b * m_sb;
  const uint32_t bits0 = mask_bits(mb, m_ss, tid * kMR, S);
  uint4 qraw[GP][VPL];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int vv = 0; vv < VPL; ++vv)
      qraw[g][vv] = g < G ? *reinterpret_cast<const uint4*>(
                                q + ((i64)(b * KV + h) * G + g) * D + (vv * LPR + lis) * E)
                          : make_uint4(0, 0, 0, 0);

  // count the row's valid slots: a block scan of the first round, a sum of the rest
  int total0, n_valid;
  const int c_0 = __popc(bits0);
  const int excl0 = block_scan(c_0, sm_scan[0], total0);
  n_valid = total0;
  if (S > kThreads * kMR) {
    int cnt = 0;
    for (int base = kThreads * kMR; base < S; base += kThreads * kMR)
      cnt += __popc(mask_bits(mb, m_ss, base + tid * kMR, S));
    int rest;
    block_scan(cnt, sm_scan[1], rest);
    n_valid += rest;
  }

  // q, pre-scaled, all G heads of the kv head
  float qf[GP][EPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
#pragma unroll
    for (int vv = 0; vv < VPL; ++vv) widen(qraw[g][vv], &qf[g][vv * E], T());
#pragma unroll
    for (int e = 0; e < EPL; ++e) qf[g][e] *= scale;
  }

  // this block's share: valid ordinals [o0, o1) -> slots [p0, p1)
  const bool all_masked = n_valid == 0;
  const int total = all_masked ? S : n_valid;
  const int o0 = rank < nsplit ? (int)((i64)total * rank / nsplit) : total;
  const int o1 = rank < nsplit ? (int)((i64)total * (rank + 1) / nsplit) : total;
  int p0 = o0, p1 = o1;
  bool dense = true;                // every slot of [p0, p1) takes part
  if (!all_masked) {
    p0 = p1 = 0;
    if (o1 > o0) {
      // the slots of ordinals o0 and o1 - 1, round by round (the first from
      // bits0; round r > 0 scans in sm_scan[(r + 1) % 2], which a
      // __syncthreads separates from its last use)
      int run = 0, par = 1;
      for (int base = 0; base < S; base += kThreads * kMR, par ^= 1) {
        const int c0 = base + tid * kMR;
        const uint32_t bits = base == 0 ? bits0 : mask_bits(mb, m_ss, c0, S);
        const int c = __popc(bits);
        int round_total = total0;
        const int excl = run + (base == 0 ? excl0 : block_scan(c, sm_scan[par], round_total));
        if (excl <= o0 && o0 < excl + c) sm_pos[0] = c0 + nth_bit(bits, o0 - excl);
        if (excl <= o1 - 1 && o1 - 1 < excl + c) sm_pos[1] = c0 + nth_bit(bits, o1 - 1 - excl) + 1;
        run += round_total;
      }
      __syncthreads();
      p0 = sm_pos[0];
      p1 = sm_pos[1];
      dense = p1 - p0 == o1 - o0;
    }
  }

  const T* kb = k + (i64)b * k_sb + (i64)h * k_sh;
  const T* vb = v + (i64)b * v_sb + (i64)h * v_sh;
  const int nchunks = (p1 - p0 + R - 1) / R;
  // stage st holds rows p0 + c R .. of chunk c: row j's K at (2 j) ROW, its V at (2 j + 1) ROW
  auto issue = [&](int c) {
    unsigned char* st = ring + (c % kStages) * C::STAGE;
    for (int idx = tid; idx < R * 2 * NV; idx += kThreads) {
      const int j = idx / (2 * NV), kvsel = (idx / NV) & 1, pc = idx % NV;
      const int r = p0 + c * R + j;
      if (r < p1 && !(all_masked && kvsel == 0) && (dense || mb[(i64)r * m_ss] != 0)) {
        const T* src = (kvsel ? vb + (i64)r * v_ss : kb + (i64)r * k_ss) + pc * E;
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
                &kf[vv * E], T());
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
                &vf[vv * E], T());
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

  // merge the block's lane groups into sm_bacc[g * D + d], sm_bm[g], sm_bl[g]
  float* sm_acc = reinterpret_cast<float*>(ring);
  float* sm_m = sm_acc + NSG * GP * D;  // (NSG * GP) each, after the partials
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
  const i64 obase = (i64)(b * KV + h) * G;
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

struct DecodeArgs {
  const void *q, *k, *v, *mask;
  void* out;
  float *m_out, *l_out;
  int B, S, KV, G, D, nsplit, cluster;
  i64 k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, m_sb, m_ss;
  float scale, softcap;
  cudaStream_t stream;
};

template <typename T, int D, int GP>
int launch(const DecodeArgs& a) {
  constexpr int smem = Cfg<T, D, GP>::SMEM;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, D, GP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
      &cfg, decode_kernel<T, D, GP>, (const T*)a.q, (const T*)a.k, (const T*)a.v,
      (const unsigned char*)a.mask, (T*)a.out, a.m_out, a.l_out, a.S, a.KV, a.G, a.nsplit,
      a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss, a.v_sh, a.m_sb, a.m_ss, a.scale, a.softcap);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_g(const DecodeArgs& a) {
  if (a.G == 1) return launch<T, D, 1>(a);
  if (a.G == 2) return launch<T, D, 2>(a);
  if (a.G <= 4) return launch<T, D, 4>(a);
  if (a.G <= 8) return launch<T, D, 8>(a);
  return -2;
}

template <typename T>
int launch_d(const DecodeArgs& a) {
  switch (a.D) {
    case 16: return launch_g<T, 16>(a);
    case 64: return launch_g<T, 64>(a);
    case 128: return launch_g<T, 128>(a);
    case 256: return launch_g<T, 256>(a);
    default: return -1;
  }
}

}  // namespace

// Returns 0, a cudaError_t of the launch, -1 (head dim), -2 (group size) or -3
// (shares / cluster size). dtype: 0 = float32, 1 = bfloat16. Strides are in
// elements. m_out and l_out may be null (stats not wanted). `cluster` blocks
// (1, 2, 4 or 8) serve one (batch, kv head); the first `nsplit` of them take
// a share of the valid slots.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* out,
    float* m_out, float* l_out, int B, int S, int KV, int G, int D, int nsplit, int cluster,
    i64 k_sb, i64 k_ss, i64 k_sh, i64 v_sb, i64 v_ss, i64 v_sh, i64 m_sb, i64 m_ss,
    float scale, float softcap, int dtype, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || nsplit < 1 || nsplit > cluster) return -3;
  DecodeArgs a{q, k, v, mask, out, m_out, l_out, B, S, KV, G, D, nsplit, cluster,
               k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, m_sb, m_ss,
               scale, softcap, (cudaStream_t)stream};
  return dtype == 1 ? launch_d<__nv_bfloat16>(a) : launch_d<float>(a);
}
