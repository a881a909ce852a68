// RWKV6 (Finch) WKV recurrence for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_wkv.py::rwkv6_wkv (body
// `_kernel`). Per folded (batch x head) and timestep t:
//   y_t = r_t . (S_{t-1} + (u * k_t) v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T
// with a (Dk x Dv) fp32 state S. The TPU kernel walks the sequence in chunks
// on a sequential grid dimension and carries S in VMEM scratch between them.
//
// What bounds it on this card: at the serving shape (BH 256, S 512,
// Dk = Dv = 64, fp32 inputs) one call reads r, k, v, w once (134 MB) and
// writes y (34 MB), and does about 5 FLOP per state element and step (2.7
// GFLOP of fp32 FMAs on the CUDA cores; a recurrence in fp32 has no tensor-core
// form). Bytes and operations are of the same order, about 0.05 ms each. The
// recurrence is sequential in t, so all the parallelism is across the state:
//   * grid (BH, ceil(Dv / 64)): a block of 256 threads owns 64 value columns of
//     one head's state. A pair of columns is split over 8 lanes of one warp,
//     and each lane holds Dk/8 keys of both columns' state in registers for
//     the whole sequence: the state touches memory only once, at the end;
//   * y_t[j] is each lane's partial dot product over its keys, summed over the
//     8 lanes with three shuffles;
//   * r, k, w (TS x Dk) and v (TS x 64) of a run of TS timesteps are staged in
//     shared memory, widened to fp32; the next run is loaded into registers
//     while the current one is computed. A lane reads its keys as float4 (4
//     consecutive keys; 8 lanes read 128 consecutive bytes: no bank
//     conflicts). Shared memory, not the FMAs, set the pace of a first
//     version with one column a thread (every key was read once per column:
//     0.35-0.39 ms at the serving shape on an H100 at 700 W, against 0.22-0.25
//     ms for this one): two columns a thread halve those reads per FMA;
//   * the step loop stops at S: no row past S ever reaches the state (the TPU
//     kernel runs its last chunk to the full chunk length).
// Keys are padded to the template width (32, 64, 128) with r = k = w = 0, so
// a padding key adds nothing to y and its state stays 0.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 64;    // value columns per block
constexpr int kSplit = 8;    // lanes per column pair, each with Dk/8 of the keys

template <typename T, int DKP>
__global__ void __launch_bounds__(kThreads, 2)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ w, const float* __restrict__ u, T* __restrict__ y,
           float* __restrict__ s_out, int S, int Dk, int Dv) {
  constexpr int TS = DKP <= 64 ? 32 : 16;     // timesteps per staged run
  constexpr int NK = DKP / kSplit;            // keys per lane, for each of 2 columns
  constexpr int KPT = TS * DKP / kThreads;    // r/k/w values a thread stages per run
  constexpr int VPT = TS * kCols / kThreads;  // v values a thread stages per run
  static_assert(NK % 4 == 0 && KPT >= 1 && (TS * DKP) % kThreads == 0, "tiling");

  __shared__ __align__(16) float sr[TS * DKP];
  __shared__ __align__(16) float sk[TS * DKP];
  __shared__ __align__(16) float sw[TS * DKP];
  __shared__ __align__(16) float sv[TS * kCols];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int part = lane % kSplit;                            // which keys
  const int cl = 2 * (warp * (32 / kSplit) + lane / kSplit);  // first column
  const int col0 = blockIdx.y * kCols;
  const int col = col0 + cl;
  const i64 bh = blockIdx.x;
  const i64 base_k = bh * S * Dk, base_v = bh * S * Dv;

  // state slot n = 4*m + c holds key 32*m + 4*part + c of columns col, col+1
  float st0[NK], st1[NK], uu[NK];
#pragma unroll
  for (int m = 0; m < NK / 4; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 32 * m + 4 * part + c;
      st0[4 * m + c] = 0.f;
      st1[4 * m + c] = 0.f;
      uu[4 * m + c] = i < Dk ? u[bh * Dk + i] : 0.f;
    }

  float pr[KPT], pk[KPT], pw[KPT], pv[VPT];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int e = 0; e < KPT; ++e) {
      const int idx = e * kThreads + tid;
      const int t = t0 + idx / DKP, i = idx % DKP;
      const bool ok = t < S && i < Dk;
      const i64 off = base_k + (i64)t * Dk + i;
      pr[e] = ok ? to_float(r[off]) : 0.f;
      pk[e] = ok ? to_float(k[off]) : 0.f;
      pw[e] = ok ? to_float(w[off]) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < VPT; ++e) {
      const int idx = e * kThreads + tid;
      const int t = t0 + idx / kCols, c = col0 + idx % kCols;
      pv[e] = (t < S && c < Dv) ? to_float(v[base_v + (i64)t * Dv + c]) : 0.f;
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < S; t0 += TS) {
    __syncthreads();  // every thread is done with the previous run
#pragma unroll
    for (int e = 0; e < KPT; ++e) {
      const int idx = e * kThreads + tid;
      sr[idx] = pr[e]; sk[idx] = pk[e]; sw[idx] = pw[e];
    }
#pragma unroll
    for (int e = 0; e < VPT; ++e) sv[e * kThreads + tid] = pv[e];
    __syncthreads();
    if (t0 + TS < S) fetch(t0 + TS);  // in flight while this run is computed

    const int n = min(TS, S - t0);
    for (int tt = 0; tt < n; ++tt) {
      const float2 v2 = *reinterpret_cast<const float2*>(&sv[tt * kCols + cl]);
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int m = 0; m < NK / 4; ++m) {
        const int o = tt * DKP + 32 * m + 4 * part;
        const float4 r4 = *reinterpret_cast<const float4*>(&sr[o]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sk[o]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[o]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int s = 4 * m + c;
          const float kv0 = kk[c] * v2.x, kv1 = kk[c] * v2.y;
          acc0 = fmaf(rr[c], fmaf(uu[s], kv0, st0[s]), acc0);
          acc1 = fmaf(rr[c], fmaf(uu[s], kv1, st1[s]), acc1);
          st0[s] = fmaf(ww[c], st0[s], kv0);
          st1[s] = fmaf(ww[c], st1[s], kv1);
        }
      }
#pragma unroll
      for (int off = 1; off < kSplit; off <<= 1) {
        acc0 += __shfl_xor_sync(0xffffffffu, acc0, off);
        acc1 += __shfl_xor_sync(0xffffffffu, acc1, off);
      }
      if (part == 0) {
        T* yt = y + base_v + (i64)(t0 + tt) * Dv;
        if (col < Dv) yt[col] = from_float<T>(acc0);
        if (col + 1 < Dv) yt[col + 1] = from_float<T>(acc1);
      }
    }
  }

  float* so = s_out + bh * Dk * Dv;
#pragma unroll
  for (int m = 0; m < NK / 4; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 32 * m + 4 * part + c;
      if (i < Dk && col < Dv) so[(i64)i * Dv + col] = st0[4 * m + c];
      if (i < Dk && col + 1 < Dv) so[(i64)i * Dv + col + 1] = st1[4 * m + c];
    }
}

template <typename T, int DKP>
int launch(const void* r, const void* k, const void* v, const void* w, const float* u,
           void* y, float* s_out, int BH, int S, int Dk, int Dv, cudaStream_t stream) {
  dim3 grid(BH, (Dv + kCols - 1) / kCols);
  wkv_kernel<T, DKP><<<grid, kThreads, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, u, (T*)y, s_out, S, Dk, Dv);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dk(const void* r, const void* k, const void* v, const void* w, const float* u,
              void* y, float* s_out, int BH, int S, int Dk, int Dv, cudaStream_t stream) {
  if (Dk <= 32) return launch<T, 32>(r, k, v, w, u, y, s_out, BH, S, Dk, Dv, stream);
  if (Dk <= 64) return launch<T, 64>(r, k, v, w, u, y, s_out, BH, S, Dk, Dv, stream);
  if (Dk <= 128) return launch<T, 128>(r, k, v, w, u, y, s_out, BH, S, Dk, Dv, stream);
  return -1;
}

}  // namespace

// Returns 0, a cudaError_t of the launch, or -1 (Dk above 128).
// dtype of r, k, v, w and y: 0 = float32, 1 = bfloat16; u and s_out are fp32.
// All tensors contiguous: r, k, w (BH, S, Dk), v and y (BH, S, Dv), u (BH, Dk),
// s_out (BH, Dk, Dv).
extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v, const void* w,
                             const float* u, void* y, float* s_out,
                             int BH, int S, int Dk, int Dv, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 1
      ? launch_dk<__nv_bfloat16>(r, k, v, w, u, y, s_out, BH, S, Dk, Dv, st)
      : launch_dk<float>(r, k, v, w, u, y, s_out, BH, S, Dk, Dv, st);
}
