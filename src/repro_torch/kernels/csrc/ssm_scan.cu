// Mamba selective scan for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py::ssm_scan (body
// `_kernel`). Per batch row b and channel d, from a zero state h (N fp32):
//   h_t = exp(dt_t a_d) * h_{t-1} + (dt_t u_t) B_t,   y_t = C_t . h_t + u_t d_skip_d
// The TPU kernel runs a grid (B, d_in / 512, S / 128) with the sequence
// chunks on a sequential ("arbitrary") dimension and carries the (512 x N)
// state in VMEM scratch from one chunk to the next.
//
// What bounds it on this card: at the serving shape (B 8, S 512, d_in 16384,
// N 16, u/dt bf16) one call reads u and dt (2 x 134.2 MB), B and C (0.5 MB),
// a (1 MB) and writes y (134.2 MB) and h_final (8.4 MB): about 412.7 MB, or
// 0.123 ms at 3.35 TB/s. The work is 1.07 G state-element steps of about 5
// FLOP (5.4 GFLOP, 0.080 ms on the fp32 CUDA cores) and one exp each: the
// same 1.07 G exps on the special-function units (16 a clock on each of the
// 132 SMs) take 0.26-0.29 ms. So the exps, not the memory, should set the
// pace of this design. The recurrence is sequential in t; all the
// parallelism is across (b, d):
//   * one thread owns one (b, d) channel and holds its N states and
//     a * log2(e) in registers for the whole sequence: the state touches
//     memory once, at the end. A loop over t inside the thread replaces the
//     TPU kernel's sequential grid dimension;
//   * each exp is one `ex2.approx.ftz` of dt * a * log2(e) on the
//     special-function unit, and registers are capped at 128 a thread so
//     that 4 blocks (16 warps) share an SM. A first version with `exp2f`
//     (which adds a range fix-up around the same instruction) and no cap
//     (132-179 registers, 2-3 blocks an SM) took 0.75-0.85 ms at the serving
//     shape in bf16 on an H100 at 700 W, this one 0.47 ms, 1.8x the exp
//     bound;
//   * a block covers 128 consecutive channels of one batch row, so every
//     load of u and dt and every store of y is one coalesced row segment;
//   * B_t and C_t of a run of TS steps are staged in shared memory once and
//     read by all 128 channels as broadcasts (float4); u and dt of the next
//     run, and its B and C, are loaded into registers while the current run
//     is computed;
//   * the step loop stops at S: no row past S ever reaches the state (the
//     TPU kernel runs its last chunk to the full chunk length). Channels past
//     d_in (the ragged tail of the last block) read a live channel and write
//     nothing.
// N is padded to the template width (4, 8, 16) with a = B = C = 0, so a
// padding state stays 0 and adds nothing to y.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int TS = 16;          // timesteps per staged run
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error about 2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads, 4)
scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
            const float* __restrict__ bm, const float* __restrict__ cm,
            const float* __restrict__ a, const float* __restrict__ d_skip,
            T* __restrict__ y, float* __restrict__ h_out, int S, int Din, int N) {
  constexpr int BC = TS * NP;                           // B (or C) values of a run
  constexpr int BCPT = (BC + kThreads - 1) / kThreads;  // of them a thread stages
  static_assert(NP % 4 == 0, "float4 reads of B and C");

  __shared__ __align__(16) float sb[BC];
  __shared__ __align__(16) float sc[BC];

  const int tid = threadIdx.x;
  const int d = blockIdx.x * kThreads + tid;
  const bool live = d < Din;
  const int dc = live ? d : Din - 1;
  const i64 b = blockIdx.y;
  const i64 base = b * (i64)S * Din + dc;   // u, dt and y of step t: base + t * Din
  const i64 base_bc = b * (i64)S * N;

  float a2[NP], h[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    a2[n] = n < N ? a[(i64)dc * N + n] * kLog2e : 0.f;
    h[n] = 0.f;
  }
  const float dsk = d_skip[dc];

  float pu[TS], pdt[TS], pb[BCPT], pc[BCPT];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int i = 0; i < TS; ++i) {
      const bool ok = t0 + i < S;
      const i64 off = base + (i64)(t0 + i) * Din;
      pu[i] = ok ? to_float(u[off]) : 0.f;
      pdt[i] = ok ? to_float(dt[off]) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < BCPT; ++e) {
      const int idx = e * kThreads + tid;
      const int t = t0 + idx / NP, n = idx % NP;
      const bool ok = idx < BC && t < S && n < N;
      const i64 off = base_bc + (i64)t * N + n;
      pb[e] = ok ? bm[off] : 0.f;
      pc[e] = ok ? cm[off] : 0.f;
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < S; t0 += TS) {
    float cu[TS], cdt[TS];
#pragma unroll
    for (int i = 0; i < TS; ++i) {
      cu[i] = pu[i];
      cdt[i] = pdt[i];
    }
    __syncthreads();  // every thread is done with the previous run's B and C
#pragma unroll
    for (int e = 0; e < BCPT; ++e) {
      const int idx = e * kThreads + tid;
      if (idx < BC) {
        sb[idx] = pb[e];
        sc[idx] = pc[e];
      }
    }
    __syncthreads();
    if (t0 + TS < S) fetch(t0 + TS);  // in flight while this run is computed

    const int nsteps = min(TS, S - t0);
#pragma unroll
    for (int i = 0; i < TS; ++i) {
      if (i < nsteps) {
        const float dtv = cdt[i], uv = cu[i], du = dtv * uv;
        float acc = 0.f;
#pragma unroll
        for (int n4 = 0; n4 < NP; n4 += 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(&sb[i * NP + n4]);
          const float4 c4 = *reinterpret_cast<const float4*>(&sc[i * NP + n4]);
          const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
          const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int n = n4 + c;
            h[n] = fmaf(ex2(dtv * a2[n]), h[n], du * bb[c]);
            acc = fmaf(h[n], cc[c], acc);
          }
        }
        if (live) y[base + (i64)(t0 + i) * Din] = from_float<T>(fmaf(uv, dsk, acc));
      }
    }
  }

  if (live) {
    float* ho = h_out + ((i64)b * Din + d) * N;
#pragma unroll
    for (int n = 0; n < NP; ++n)
      if (n < N) ho[n] = h[n];
  }
}

template <typename T, int NP>
int launch(const void* u, const void* dt, const float* bm, const float* cm, const float* a,
           const float* d_skip, void* y, float* h_out, int B, int S, int Din, int N,
           cudaStream_t stream) {
  dim3 grid((Din + kThreads - 1) / kThreads, B);
  scan_kernel<T, NP><<<grid, kThreads, 0, stream>>>(
      (const T*)u, (const T*)dt, bm, cm, a, d_skip, (T*)y, h_out, S, Din, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(const void* u, const void* dt, const float* bm, const float* cm, const float* a,
             const float* d_skip, void* y, float* h_out, int B, int S, int Din, int N,
             cudaStream_t stream) {
  if (N <= 4) return launch<T, 4>(u, dt, bm, cm, a, d_skip, y, h_out, B, S, Din, N, stream);
  if (N <= 8) return launch<T, 8>(u, dt, bm, cm, a, d_skip, y, h_out, B, S, Din, N, stream);
  if (N <= 16) return launch<T, 16>(u, dt, bm, cm, a, d_skip, y, h_out, B, S, Din, N, stream);
  return -1;
}

}  // namespace

// Returns 0, a cudaError_t of the launch, or -1 (N above 16).
// dtype of u, dt and y: 0 = float32, 1 = bfloat16; bm, cm, a, d_skip and
// h_out are fp32. All tensors contiguous: u, dt and y (B, S, Din), bm and cm
// (B, S, N), a (Din, N), d_skip (Din,), h_out (B, Din, N).
extern "C" int ssm_scan_fwd(const void* u, const void* dt, const float* bm, const float* cm,
                            const float* a, const float* d_skip, void* y, float* h_out,
                            int B, int S, int Din, int N, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 1
      ? launch_n<__nv_bfloat16>(u, dt, bm, cm, a, d_skip, y, h_out, B, S, Din, N, st)
      : launch_n<float>(u, dt, bm, cm, a, d_skip, y, h_out, B, S, Din, N, st);
}
