// RWKV6 (Finch) WKV recurrence for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_wkv.py::rwkv6_wkv (body
// `_kernel`). Per (batch, head) and timestep t:
//   y_t = r_t . (S_{t-1} + (u * k_t) v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T
// with a (Dk x Dv) fp32 state S. The TPU kernel walks the sequence in chunks
// on a sequential grid dimension and carries S in VMEM scratch between them.
//
// The kernel reads its operands through strides as (B, S, H, D) views with the
// last dim contiguous, so two entries share it: the reference's folded
// (B*H, S, D) layout (H = 1), and the model's own (B, S, H, D) tensors, read
// in place in their dtype (r, k, v in bf16 or fp32, w in fp32) with y written
// in fp32 straight into (B, S, H, Dv): the model makes no fold or unfold copy.
//
// What bounds it on this card: at the serving shape (B 8, S 512, H 32,
// Dk = Dv = 64) the state update is 2.68 GFLOP of fp32 FMAs (0.040 ms at the
// CUDA cores' peak; a recurrence in fp32 has no tensor-core form), and the
// model-layout call moves 121.6 MB (bf16 r, k, v, fp32 w and y: 0.036 ms).
// What the card runs short of is instruction issue and shared-memory
// wavefronts (a 16-byte load is four of them a warp, one value a lane a
// cycle), so the design counts both per state element and step. The
// recurrence is sequential in t, so all the parallelism is across the state:
//   * grid (B * H, ceil(Dv / 64)): a block owns 64 value columns of one
//     head's state; a lane holds a 4-key x 8-column tile of it in registers
//     for the whole sequence (the state touches memory only once, at the
//     end), and the Dk / 4 lanes (16 or 32) that share 8 columns make a
//     column group;
//   * a step's r, k, w (4 keys) and v (8 columns) are two to four 16-byte
//     loads a lane for 32 state elements: r, k, w are read once for 8
//     columns and v once for 4 keys;
//   * the bonus term is a scalar a step: r . (u * k) v^T = c_t v with
//     c_t = sum_i r_i u_i k_i, so a lane adds its share of c_t times v and a
//     state element costs three instructions (k v, r S into y, w S + k v);
//   * y of the 8 columns is summed over the group's lanes by a butterfly
//     reduce-scatter: three exchanges halve the columns a lane carries
//     (8 -> 4 -> 2 -> 1) and one or two more sum the last;
//   * r, k, w (TS x Dk) and v (TS x 64) of a run of TS timesteps come into
//     shared memory in their own dtype by `cp.async`, two runs deep: the next
//     run is in flight while the current one is computed; a bf16 value is
//     widened to fp32 when it is read;
//   * the step loop stops at S: no row past S ever reaches the state (the TPU
//     kernel runs its last chunk to the full chunk length).
// Earlier forms on an H100 at 700 W, at the serving shape: one column a thread
// 0.35-0.39 ms and two 0.22-0.25 ms (shared-memory reads per FMA); four
// columns over 16 lanes 0.18 ms of device time (about 106 instructions for 16
// state elements a step); one column over 2 lanes with 32 keys each 0.21 ms
// (every 16-byte load served 4 state elements: shared-memory wavefronts).
// Keys are padded to the template width (64, 128) with r = k = w = 0, so a
// padding key adds nothing to y and its state stays 0.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kCols = 64;    // value columns per block
constexpr int kCPL = 8;      // columns a lane holds of the state
constexpr int kKPL = 4;      // keys a lane holds of the state

struct WkvArgs {
  const void *r, *k, *v, *w;
  const float* u;
  void* y;
  float* s_out;
  int B, H, S, Dk, Dv;
  // element strides of the (B, S, H, D) views: batch, step, head
  i64 r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh, y_sb, y_ss, y_sh;
  i64 u_sb, u_sh;   // u: element strides of batch and head
};

// four consecutive values of a staged run, widened to fp32
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// `rows` rows of `elems` values (row t at src + t * ss) into a staged run of
// row stride `ld`, 16 bytes a `cp.async`; `elems` fills whole 16-byte chunks.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, i64 ss, int rows,
                                           int elems) {
  constexpr int E = 16 / sizeof(T);
  const int per_row = elems / E;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += blockDim.x) {
    const int t = idx / per_row, c = (idx % per_row) * E;
    cp_async16(dst + t * ld + c, src + (i64)t * ss + c);
  }
}

// A block's shared memory: two runs of TS timesteps in the inputs' dtypes.
template <typename TR, typename TW, int DKP>
struct Run {
  static constexpr int LPG = DKP / kKPL;            // lanes of a column group: 16 or 32
  static constexpr int THREADS = kCols / kCPL * LPG;
  static constexpr int TS = 32;                     // timesteps a run
  static constexpr int K_OFF = TS * DKP * sizeof(TR), W_OFF = 2 * K_OFF;
  static constexpr int V_OFF = W_OFF + TS * DKP * sizeof(TW);
  static constexpr int BYTES = V_OFF + TS * kCols * sizeof(TR);
};

template <typename TR, typename TW, typename TY, int DKP>
__global__ void __launch_bounds__(Run<TR, TW, DKP>::THREADS) wkv_kernel(const WkvArgs a) {
  using R = Run<TR, TW, DKP>;
  constexpr int TS = R::TS, LPG = R::LPG, NT = R::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31;
  const int part = lane % LPG;                   // the lane's keys: 4 part .. 4 part + 3
  const int cl = kCPL * (tid / LPG);             // the lane's columns: cl .. cl + 7
  const int col0 = blockIdx.y * kCols;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const TR* rp = (const TR*)a.r + (i64)b * a.r_sb + (i64)h * a.r_sh;
  const TR* kp = (const TR*)a.k + (i64)b * a.k_sb + (i64)h * a.k_sh;
  const TR* vp = (const TR*)a.v + (i64)b * a.v_sb + (i64)h * a.v_sh + col0;
  const TW* wp = (const TW*)a.w + (i64)b * a.w_sb + (i64)h * a.w_sh;
  const int vcols = min(kCols, a.Dv - col0);

  // padding keys and columns stay 0: no copy ever writes them
  for (int i = tid; i < 2 * R::BYTES / 16; i += NT)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  auto issue = [&](int t0, int buf) {
    unsigned char* base = smem + buf * R::BYTES;
    const int rows = min(TS, a.S - t0);
    stage_rows((TR*)base, DKP, rp + (i64)t0 * a.r_ss, a.r_ss, rows, a.Dk);
    stage_rows((TR*)(base + R::K_OFF), DKP, kp + (i64)t0 * a.k_ss, a.k_ss, rows, a.Dk);
    stage_rows((TW*)(base + R::W_OFF), DKP, wp + (i64)t0 * a.w_ss, a.w_ss, rows, a.Dk);
    stage_rows((TR*)(base + R::V_OFF), kCols, vp + (i64)t0 * a.v_ss, a.v_ss, rows, vcols);
  };

  // st[c][j]: key 4 part + c of column cl + j
  float st[kKPL][kCPL], uu[kKPL];
  const float* up = a.u + (i64)b * a.u_sb + (i64)h * a.u_sh;
#pragma unroll
  for (int c = 0; c < kKPL; ++c) {
    uu[c] = kKPL * part + c < a.Dk ? up[kKPL * part + c] : 0.f;
#pragma unroll
    for (int j = 0; j < kCPL; ++j) st[c][j] = 0.f;
  }

  // after the reduce-scatter the lane holds column cl + 4 b1 + 2 b2 + b3
  const int b1 = (part / (LPG / 2)) & 1, b2 = (part / (LPG / 4)) & 1, b3 = (part / (LPG / 8)) & 1;
  const int ycol = cl + 4 * b1 + 2 * b2 + b3;
  const bool writes_y = part % (LPG / 8) == 0 && ycol < vcols;
  TY* yp = (TY*)a.y + (i64)b * a.y_sb + (i64)h * a.y_sh + col0 + ycol;
  const int n_runs = (a.S + TS - 1) / TS;
  issue(0, 0);
  async_commit();
  for (int run = 0; run < n_runs; ++run) {
    if (run + 1 < n_runs) issue((run + 1) * TS, (run + 1) & 1);
    async_commit();                    // (an empty group keeps the count uniform)
    async_wait1();                     // this run has landed
    __syncthreads();
    const unsigned char* base = smem + (run & 1) * R::BYTES;
    const TR* sr = (const TR*)base;
    const TR* sk = (const TR*)(base + R::K_OFF);
    const TW* sw = (const TW*)(base + R::W_OFF);
    const TR* sv = (const TR*)(base + R::V_OFF);
    const int t0 = run * TS;
    const int n = min(TS, a.S - t0);
#pragma unroll 4
    for (int tt = 0; tt < n; ++tt) {
      const int o = tt * DKP + kKPL * part;
      const float4 r4 = ld4(sr + o), k4 = ld4(sk + o), w4 = ld4(sw + o);
      const float4 va = ld4(sv + tt * kCols + cl), vb = ld4(sv + tt * kCols + cl + 4);
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
      const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
      const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
      const float vv[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
      // the bonus term r . (u * k) v^T is (sum_i r_i u_i k_i) v: this lane's
      // share of the sum, times each column's v
      float cu = 0.f;
#pragma unroll
      for (int c = 0; c < kKPL; ++c) cu = fmaf(rr[c] * uu[c], kk[c], cu);
      float acc[kCPL];
#pragma unroll
      for (int j = 0; j < kCPL; ++j) acc[j] = cu * vv[j];
#pragma unroll
      for (int c = 0; c < kKPL; ++c)
#pragma unroll
        for (int j = 0; j < kCPL; ++j) {
          acc[j] = fmaf(rr[c], st[c][j], acc[j]);
          st[c][j] = fmaf(ww[c], st[c][j], kk[c] * vv[j]);
        }
      // reduce-scatter over the LPG lanes: 8 columns -> 4 -> 2 -> 1, then sum
      float a4[4], a2[2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a4[j] = (b1 ? acc[4 + j] : acc[j]) +
                __shfl_xor_sync(0xffffffffu, b1 ? acc[j] : acc[4 + j], LPG / 2);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        a2[j] = (b2 ? a4[2 + j] : a4[j]) +
                __shfl_xor_sync(0xffffffffu, b2 ? a4[j] : a4[2 + j], LPG / 4);
      float y = (b3 ? a2[1] : a2[0]) + __shfl_xor_sync(0xffffffffu, b3 ? a2[0] : a2[1], LPG / 8);
#pragma unroll
      for (int off = LPG / 16; off > 0; off >>= 1) y += __shfl_xor_sync(0xffffffffu, y, off);
      if (writes_y) yp[(i64)(t0 + tt) * a.y_ss] = from_float<TY>(y);
    }
    __syncthreads();                   // every thread is done with this run's buffer
  }

  float* so = a.s_out + (i64)blockIdx.x * a.Dk * a.Dv + col0 + cl;
#pragma unroll
  for (int c = 0; c < kKPL; ++c)
#pragma unroll
    for (int j = 0; j < kCPL; ++j)
      if (kKPL * part + c < a.Dk && cl + j < vcols)
        so[(i64)(kKPL * part + c) * a.Dv + j] = st[c][j];
}

template <typename TR, typename TW, typename TY, int DKP>
int launch(const WkvArgs& a, cudaStream_t stream) {
  using R = Run<TR, TW, DKP>;
  constexpr int smem = 2 * R::BYTES;
  auto kern = wkv_kernel<TR, TW, TY, DKP>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  dim3 grid(a.B * a.H, (a.Dv + kCols - 1) / kCols);
  kern<<<grid, R::THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TR, typename TW, typename TY>
int launch_dk(const WkvArgs& a, cudaStream_t stream) {
  if (a.Dk <= 64) return launch<TR, TW, TY, 64>(a, stream);
  if (a.Dk <= 128) return launch<TR, TW, TY, 128>(a, stream);
  return -1;
}

}  // namespace

// Returns 0, a cudaError_t of the launch, -1 (Dk above 128), -2 (Dk or Dv not
// a multiple of 8) or -4 (a dtype mix the kernel does not take). rk_dtype is
// the dtype of r, k and v, w_dtype that of w, y_dtype that of y: 0 = float32,
// 1 = bfloat16; the kernel takes (0, 0, 0), (1, 1, 1) and (1, 0, 0). u and
// s_out are fp32; s_out is contiguous (B * H, Dk, Dv). Strides are in
// elements, (batch, step, head) for r, k, v, w and y, whose last dim is
// contiguous and whose rows start 16-byte aligned; (batch, head) for u.
extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v, const void* w,
                             const float* u, void* y, float* s_out,
                             int B, int H, int S, int Dk, int Dv,
                             i64 r_sb, i64 r_ss, i64 r_sh, i64 k_sb, i64 k_ss, i64 k_sh,
                             i64 v_sb, i64 v_ss, i64 v_sh, i64 w_sb, i64 w_ss, i64 w_sh,
                             i64 y_sb, i64 y_ss, i64 y_sh, i64 u_sb, i64 u_sh,
                             int rk_dtype, int w_dtype, int y_dtype, void* stream) {
  if (Dk % 8 != 0 || Dv % 8 != 0) return -2;
  const WkvArgs a{r, k, v, w, u, y, s_out, B, H, S, Dk, Dv,
                  r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh,
                  y_sb, y_ss, y_sh, u_sb, u_sh};
  cudaStream_t st = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf;
  if (rk_dtype == 0 && w_dtype == 0 && y_dtype == 0) return launch_dk<float, float, float>(a, st);
  if (rk_dtype == 1 && w_dtype == 1 && y_dtype == 1) return launch_dk<bf, bf, bf>(a, st);
  if (rk_dtype == 1 && w_dtype == 0 && y_dtype == 0) return launch_dk<bf, float, float>(a, st);
  return -4;
}
