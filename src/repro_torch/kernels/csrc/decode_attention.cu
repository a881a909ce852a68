// Single-token GQA decode attention (flash-decode) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::decode_attention
// (body `_kernel`). That kernel walks the cache tile by tile on a sequential
// grid dimension and carries (acc, m, l) in scratch memory between steps.
//
// What bounds it on this card: bytes. One decode step reads every valid K and
// V row once (2 * B * n_valid * KV * D elements) and does ~4*G FLOPs per
// element read, far below the ~295 FLOP/byte where the tensor cores would
// matter. So the design is about keeping 16-byte loads in flight on all SMs:
//   * grid (split, kv_head, batch): the cache length is cut into `nsplit`
//     chunks so that a batch of 8 x 8 kv heads still gives several blocks per
//     SM; a second small kernel merges the partials with the flash-decode rule
//       w_i = exp(m_i - m*) * l_i,  out = sum(out_i * w_i) / max(sum(w_i), 1e-30)
//     and returns the merged stats (m*, sum w_i);
//   * K and V are read in the cache's native (B, S, KV, D) layout through
//     strides, 16 bytes a lane, a group of D*sizeof(T)/16 lanes per cache row;
//   * all G query heads of a kv head are held in registers (pre-scaled) and
//     share every row that is streamed, so a row is read once for the group;
//   * rows whose mask byte is 0 are never loaded (the TPU kernel has to
//     stream them and mask afterwards).
// Each lane group keeps its own online-softmax state; groups are merged in
// shared memory at the end of the block. fp32 accumulation throughout.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 2;  // cache rows per lane group and loop trip

template <typename T, int D, int GP>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const unsigned char* __restrict__ mask,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int S, int KV, int G, int chunk, int nsplit,
                    i64 k_sb, i64 k_ss, i64 k_sh, i64 v_sb, i64 v_ss, i64 v_sh,
                    i64 m_sb, i64 m_ss, float scale, float softcap) {
  constexpr int E = Vec16<T>::E;            // elements per 16-byte load
  constexpr int NV = D / E;                 // loads per cache row
  constexpr int LPR = NV < 32 ? NV : 32;    // lanes per row
  constexpr int VPL = NV / LPR;             // loads per lane and row
  constexpr int EPL = VPL * E;              // elements per lane and row
  constexpr int RPW = 32 / LPR;             // rows per warp and pass
  constexpr int NSG = kWarps * RPW;         // lane groups per block

  __shared__ float sm_acc[NSG * GP * D];
  __shared__ float sm_m[NSG * GP];
  __shared__ float sm_l[NSG * GP];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lis = lane % LPR;               // lane within its group
  const int sg = warp * RPW + lane / LPR;   // this lane's group

  float qf[GP][EPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) qf[g][e] = 0.f;
    if (g < G) {
      const T* qp = q + ((i64)(b * KV + h) * G + g) * D;
#pragma unroll
      for (int vv = 0; vv < VPL; ++vv) load16(qp + (vv * LPR + lis) * E, &qf[g][vv * E]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qf[g][e] *= scale;
    }
  }

  float m[GP], l[GP], acc[GP][EPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = NEG_INF; l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const int s0 = split * chunk;
  const int s1 = min(S, s0 + chunk);
  const T* kb = k + (i64)b * k_sb + (i64)h * k_sh;
  const T* vb = v + (i64)b * v_sb + (i64)h * v_sh;
  const unsigned char* mb = mask + (i64)b * m_sb;

  for (int base = s0; base < s1; base += NSG * kUnroll) {
    bool ok[kUnroll];
    float kf[kUnroll][EPL], vf[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + u * NSG + sg;
      ok[u] = r < s1 && mb[(i64)r * m_ss] != 0;
#pragma unroll
      for (int e = 0; e < EPL; ++e) { kf[u][e] = 0.f; vf[u][e] = 0.f; }
      if (ok[u]) {
#pragma unroll
        for (int vv = 0; vv < VPL; ++vv) {
          load16(kb + (i64)r * k_ss + (vv * LPR + lis) * E, &kf[u][vv * E]);
          load16(vb + (i64)r * v_ss + (vv * LPR + lis) * E, &vf[u][vv * E]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (g < G) {  // uniform over the block
        float sc[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) d += qf[g][e] * kf[u][e];
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, off);
          sc[u] = ok[u] ? softcap_f(d, softcap) : NEG_INF;
        }
        float m_new = m[g];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) m_new = fmaxf(m_new, sc[u]);
        const float alpha = expf(m[g] - m_new);
        float p[kUnroll], psum = 0.f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          p[u] = ok[u] ? expf(sc[u] - m_new) : 0.f;
          psum += p[u];
        }
        l[g] = l[g] * alpha + psum;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          float a = acc[g][e] * alpha;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) a += p[u] * vf[u][e];
          acc[g][e] = a;
        }
      }
    }
  }

  // merge the block's lane groups
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
  const i64 pbase = ((i64)(b * KV + h) * nsplit + split) * G;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float m_star = NEG_INF;
    for (int i = 0; i < NSG; ++i) m_star = fmaxf(m_star, sm_m[i * GP + g]);
    float num = 0.f, den = 0.f;
    for (int i = 0; i < NSG; ++i) {
      const float w = expf(sm_m[i * GP + g] - m_star);
      num += w * sm_acc[(i * GP + g) * D + d];
      den += w * sm_l[i * GP + g];
    }
    part_acc[(pbase + g) * D + d] = num;   // un-normalised: sum p * v
    if (d == 0) { part_ml[(pbase + g) * 2] = m_star; part_ml[(pbase + g) * 2 + 1] = den; }
  }
}

template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml,
                                    T* __restrict__ out, float* __restrict__ m_out,
                                    float* __restrict__ l_out, int nsplit, int G, int D) {
  const i64 bh = blockIdx.x;
  const float* ml = part_ml + bh * nsplit * G * 2;
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float m_star = NEG_INF;
    for (int i = 0; i < nsplit; ++i) m_star = fmaxf(m_star, ml[(i * G + g) * 2]);
    float num = 0.f, den = 0.f;
    for (int i = 0; i < nsplit; ++i) {
      const float e = expf(ml[(i * G + g) * 2] - m_star);
      den += e * ml[(i * G + g) * 2 + 1];
      num += e * part_acc[((bh * nsplit + i) * G + g) * D + d];
    }
    out[(bh * G + g) * D + d] = from_float<T>(num / fmaxf(den, 1e-30f));
    if (d == 0) { m_out[bh * G + g] = m_star; l_out[bh * G + g] = den; }
  }
}

struct DecodeArgs {
  const void *q, *k, *v, *mask;
  void* out;
  float *m_out, *l_out, *part_acc, *part_ml;
  int B, S, KV, G, D, nsplit;
  i64 k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, m_sb, m_ss;
  float scale, softcap;
  cudaStream_t stream;
};

template <typename T, int D, int GP>
int launch(const DecodeArgs& a) {
  const int chunk = (a.S + a.nsplit - 1) / a.nsplit;
  dim3 grid(a.nsplit, a.KV, a.B);
  decode_split_kernel<T, D, GP><<<grid, kThreads, 0, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const unsigned char*)a.mask,
      a.part_acc, a.part_ml, a.S, a.KV, a.G, chunk, a.nsplit,
      a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss, a.v_sh, a.m_sb, a.m_ss,
      a.scale, a.softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge_kernel<T><<<a.B * a.KV, 128, 0, a.stream>>>(
      a.part_acc, a.part_ml, (T*)a.out, a.m_out, a.l_out, a.nsplit, a.G, a.D);
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

// Returns 0, a cudaError_t of the launch, -1 (head dim) or -2 (group size).
// dtype: 0 = float32, 1 = bfloat16. Strides are in elements.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* out,
    float* m_out, float* l_out, float* part_acc, float* part_ml,
    int B, int S, int KV, int G, int D, int nsplit,
    i64 k_sb, i64 k_ss, i64 k_sh, i64 v_sb, i64 v_ss, i64 v_sh, i64 m_sb, i64 m_ss,
    float scale, float softcap, int dtype, void* stream) {
  DecodeArgs a{q, k, v, mask, out, m_out, l_out, part_acc, part_ml,
               B, S, KV, G, D, nsplit,
               k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, m_sb, m_ss,
               scale, softcap, (cudaStream_t)stream};
  return dtype == 1 ? launch_d<__nv_bfloat16>(a) : launch_d<float>(a);
}
