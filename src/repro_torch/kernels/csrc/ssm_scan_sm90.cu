// Mamba selective scan for Hopper, sm_90a: the TMA route of K3.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py::ssm_scan (body
// `_kernel`), as ssm_scan.cu does; the wrapper (kernels/ssm_scan.py,
// `route`) sends here every shape whose rows TMA can address: N a multiple
// of 4 (B and C rows of 16-byte multiples) and d_in a multiple of 8 in bf16
// or 4 in fp32. Per batch row b and channel d, from a zero state h (N fp32):
//   h_t = exp(dt_t a_d) * h_{t-1} + (dt_t u_t) B_t,   y_t = C_t . h_t + u_t d_skip_d
//
// What bounds it on this card (an H100 at 700 W; tools/k3_variants.py): at
// the serving shape (B 8, S 512, d_in 16384, N 16, u/dt bf16) the bytes
// take 0.123 ms at 3.35 TB/s and the 1.07 G exps 0.257 ms on the
// special-function units (16 a clock an SM). Per state element and step
// the scan issues two FMULs (dt a, du B), two FFMAs (h, y) and the exp, so
// the instruction stream is as long a bound as the exps: this kernel with
// its exps replaced by one FMA each still takes about 0.26 ms. The kernel
// of the parent design (ssm_scan.cu, now the simple route) took 0.47 ms,
// its registers capped at 128 and full of prefetched u and dt. So:
//   * u, dt (TS x 128 channel tiles) and B, C (TS x N) of each run of TS
//     steps come in by TMA into a ring of kStages stages, completed on an
//     mbarrier; one thread issues the copies and a thread holds only its
//     channel's N states and a * log2(e): under 90 registers a thread;
//   * y goes through shared memory, a TS x 128 tile a stage, and out by a
//     TMA store, double-buffered;
//   * one exp of every 16 a step (kPolyStates) is computed on the FMA pipe
//     by sm90::ex2_poly, as exactly as ex2.approx.ftz but in 10
//     instructions where the special-function unit takes one; the other 15
//     by ex2.approx.ftz. With the instruction stream as long a bound as the
//     exps, 1 of 16 measured 2 % faster than 0 or 2, and 3 to 6 slower
//     (PERF.md, the sweep);
//   * steps past S and channels past d_in come in as zeros from TMA (dt = 0
//     gives a decay of exactly 1 and B = 0 adds nothing, so the state stays
//     as it was) and are clipped from the y store: no row past S reaches
//     the state.
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 128;   // channels a block, one a thread: one TMA box row
constexpr int TS = 16;          // timesteps a stage
constexpr int kPolyStates = 1;  // of every 16 exps a step, those on the FMA pipe
constexpr int kMinBlocks = 4;   // the register cap: 128 a thread (ptxas takes 89)

template <typename T, int NP>
struct Smem {
  // bf16: 38 KB a block, so 5 blocks an SM; fp32: 52 KB, 4
  static constexpr int kStages = sizeof(T) == 2 ? 3 : 2;
  alignas(128) T u[kStages][TS * kThreads];
  alignas(128) T dt[kStages][TS * kThreads];
  alignas(128) T y[2][TS * kThreads];
  alignas(128) float bm[kStages][TS * NP];
  alignas(128) float cm[kStages][TS * NP];
  alignas(8) uint64_t full[kStages];
  static constexpr uint32_t kBytes = 2 * TS * kThreads * sizeof(T) + 2 * TS * NP * sizeof(float);
};

// Whether state n takes the polynomial: kPolyStates of every 16, spread
// over the step.
__device__ __forceinline__ constexpr bool on_poly(int n) {
  return (n * kPolyStates) % 16 < kPolyStates;
}

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tma_scan_kernel(const __grid_constant__ CUtensorMap tm_u, const __grid_constant__ CUtensorMap tm_dt,
                const __grid_constant__ CUtensorMap tm_b, const __grid_constant__ CUtensorMap tm_c,
                const __grid_constant__ CUtensorMap tm_y, const float* __restrict__ a,
                const float* __restrict__ d_skip, float* __restrict__ h_out, int S, int Din) {
  using Sm = Smem<T, NP>;
  constexpr int NS = Sm::kStages;
  static_assert(NP % 4 == 0, "float4 reads of a, B and C");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * kThreads;
  const int d = d0 + tid;
  const int b = blockIdx.y;
  const int nst = (S + TS - 1) / TS;

  auto issue = [&](int k) {   // stage k into slot k % NS
    const int s = k % NS;
    mbar_expect_tx(&sm.full[s], Sm::kBytes);
    tma_load_4d(sm.u[s], &tm_u, &sm.full[s], d0, k * TS, b, 0);
    tma_load_4d(sm.dt[s], &tm_dt, &sm.full[s], d0, k * TS, b, 0);
    tma_load_4d(sm.bm[s], &tm_b, &sm.full[s], 0, k * TS, b, 0);
    tma_load_4d(sm.cm[s], &tm_c, &sm.full[s], 0, k * TS, b, 0);
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) mbar_init(&sm.full[s], 1);
    mbar_init_fence();
    for (int k = 0; k < NS && k < nst; ++k) issue(k);
  }

  const int dc = min(d, Din - 1);   // a channel past d_in reads a live one
  float a2[NP], h[NP];
#pragma unroll
  for (int n4 = 0; n4 < NP; n4 += 4) {
    const float4 v = *reinterpret_cast<const float4*>(a + (i64)dc * NP + n4);
    a2[n4] = v.x * kLog2e;
    a2[n4 + 1] = v.y * kLog2e;
    a2[n4 + 2] = v.z * kLog2e;
    a2[n4 + 3] = v.w * kLog2e;
  }
#pragma unroll
  for (int n = 0; n < NP; ++n) h[n] = 0.f;
  const float dsk = d_skip[dc];
  __syncthreads();   // the barriers are initialised before anyone waits on them

  // a step's decays: they depend on its dt alone, not on the state
  auto decays = [&](float dtv, float (&e)[NP]) {
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      const float x = dtv * a2[n];
      e[n] = on_poly(n) ? ex2_poly(x) : ex2(x);
    }
  };

  for (int k = 0; k < nst; ++k) {
    const int s = k % NS;
    const T* us = sm.u[s] + tid;
    const T* dts = sm.dt[s] + tid;
    T* ys = sm.y[k & 1];
    mbar_wait(&sm.full[s], (k / NS) & 1);
#pragma unroll
    for (int i = 0; i < TS; ++i) {
      const float uv = to_float(us[i * kThreads]);
      const float dtv = to_float(dts[i * kThreads]);
      float e[NP];
      decays(dtv, e);
      const float du = dtv * uv;
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int n4 = 0; n4 < NP; n4 += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(&sm.bm[s][i * NP + n4]);
        const float4 c4 = *reinterpret_cast<const float4*>(&sm.cm[s][i * NP + n4]);
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n4 + j;
          h[n] = fmaf(e[n], h[n], du * bb[j]);
          if (j & 1) acc1 = fmaf(h[n], cc[j], acc1);
          else acc0 = fmaf(h[n], cc[j], acc0);
        }
      }
      ys[i * kThreads + tid] = from_float<T>(fmaf(uv, dsk, acc0 + acc1));
    }
    fence_async_smem();         // this thread's y tile writes, to the TMA store
    if (tid == 0) bulk_wait_read();   // the previous stage's store has read its tile
    __syncthreads();            // slot s is read and the y tile written by everyone
    if (tid == 0) {
      tma_store_4d(&tm_y, smem_u32(ys), d0, k * TS, b, 0);
      bulk_commit();
      if (k + NS < nst) issue(k + NS);
    }
  }

  if (d < Din) {
    float4* ho = reinterpret_cast<float4*>(h_out + ((i64)b * Din + d) * NP);
#pragma unroll
    for (int n4 = 0; n4 < NP; n4 += 4) ho[n4 / 4] = make_float4(h[n4], h[n4 + 1], h[n4 + 2], h[n4 + 3]);
  }
  if (tid == 0) bulk_wait_all();   // the last y tile is stored before the block ends
}

template <typename T, int NP>
int launch(const void* u, const void* dt, const float* bm, const float* cm, const float* a,
           const float* d_skip, void* y, float* h_out, int B, int S, int Din,
           cudaStream_t stream) {
  const CUtensorMapDataType type =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t es = sizeof(T);
  // u, dt and y: (Din, S, B) innermost first; B and C: (N, S, B)
  const cuuint64_t dx[4] = {(cuuint64_t)Din, (cuuint64_t)S, (cuuint64_t)B, 1};
  const cuuint64_t sx[3] = {Din * es, (cuuint64_t)S * Din * es, (cuuint64_t)B * S * Din * es};
  const cuuint32_t bx[4] = {kThreads, TS, 1, 1};
  const cuuint64_t dn[4] = {(cuuint64_t)NP, (cuuint64_t)S, (cuuint64_t)B, 1};
  const cuuint64_t sn[3] = {NP * 4, (cuuint64_t)S * NP * 4, (cuuint64_t)B * S * NP * 4};
  const cuuint32_t bn[4] = {NP, TS, 1, 1};
  CUtensorMap tu, tdt, tb, tc, ty;
  int e = make_map_dense(&tu, type, u, dx, sx, bx);
  if (e == 0) e = make_map_dense(&tdt, type, dt, dx, sx, bx);
  if (e == 0) e = make_map_dense(&ty, type, y, dx, sx, bx);
  if (e == 0) e = make_map_dense(&tb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, bm, dn, sn, bn);
  if (e == 0) e = make_map_dense(&tc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, cm, dn, sn, bn);
  if (e != 0) return e;
  auto kern = tma_scan_kernel<T, NP>;
  constexpr int smem = sizeof(Smem<T, NP>);
  static bool attrs = false;   // dynamic shared memory above 48 KB (fp32), all of it shared
  if (!attrs) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    attrs = true;
  }
  dim3 grid((Din + kThreads - 1) / kThreads, B);
  kern<<<grid, kThreads, smem, stream>>>(tu, tdt, tb, tc, ty, a, d_skip, h_out, S, Din);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(const void* u, const void* dt, const float* bm, const float* cm, const float* a,
             const float* d_skip, void* y, float* h_out, int B, int S, int Din, int N,
             cudaStream_t stream) {
  switch (N) {
    case 4: return launch<T, 4>(u, dt, bm, cm, a, d_skip, y, h_out, B, S, Din, stream);
    case 8: return launch<T, 8>(u, dt, bm, cm, a, d_skip, y, h_out, B, S, Din, stream);
    case 12: return launch<T, 12>(u, dt, bm, cm, a, d_skip, y, h_out, B, S, Din, stream);
    case 16: return launch<T, 16>(u, dt, bm, cm, a, d_skip, y, h_out, B, S, Din, stream);
    default: return -1;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Returns 0, a cudaError_t of the launch, 1000 + a CUresult of a tensor
// map, -1 (N not 4, 8, 12 or 16), -2 (d_in rows not a multiple of 16
// bytes) or -3 (a pointer other than d_skip not 16-byte aligned). Arguments as
// ssm_scan_fwd's (ssm_scan.cu): dtype of u, dt and y 0 = float32,
// 1 = bfloat16; bm, cm, a, d_skip and h_out fp32; all tensors contiguous.
extern "C" int ssm_scan_tma_fwd(const void* u, const void* dt, const float* bm,
                                const float* cm, const float* a, const float* d_skip, void* y,
                                float* h_out, int B, int S, int Din, int N, int dtype,
                                void* stream) {
  const int es = dtype == 1 ? 2 : 4;
  if ((Din * es) % 16 != 0) return -2;
  const void* ptrs[7] = {u, dt, bm, cm, a, y, h_out};   // TMA and float4 operands
  for (const void* p : ptrs)
    if (!aligned16(p)) return -3;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 1
      ? launch_n<__nv_bfloat16>(u, dt, bm, cm, a, d_skip, y, h_out, B, S, Din, N, st)
      : launch_n<float>(u, dt, bm, cm, a, d_skip, y, h_out, B, S, Din, N, st);
}
