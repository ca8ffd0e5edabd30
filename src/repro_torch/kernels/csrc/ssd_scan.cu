// K4 on Hopper: the Mamba-2 SSD (state-space duality) chunked scan.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:75 ssd_scan (Pallas
// body `_kernel` at :28, pallas_call at :95). Oracle:
// src/repro/kernels/ref.py::ssd_ref (the exact O(S) recurrence), ported as
// src/repro_torch/kernels/ref.py::ssd_ref; the model's own chunked algebra
// is src/repro_torch/models/mamba2.py::ssd_chunked.
//
// What it computes. Per batch row b and head h, with x [B,S,H,P],
// dt [B,S,H] (> 0), A [H] (< 0) and B, C [B,S,N] shared by the heads, the
// recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t,
// evaluated a chunk of Q steps at a time. Within a chunk, with
// cum = cumsum(dt A):
//   y_i  = sum_{j<=i} (C_i . B_j) exp(clip(cum_i - cum_j, -60, 0)) dt_j x_j
//        + exp(clip(cum_i, -60, 0)) (h_in C_i)
//   h_out = exp(clip(cum_Q, -60, 0)) h_in
//        + sum_j exp(clip(cum_Q - cum_j, -60, 0)) dt_j x_j B_j^T
// all in fp32, the [P,N] state carried from chunk to chunk. y comes out in
// x's dtype and the final state [B,H,P,N] in fp32.
//
// What bounds it. At mamba2-2.7b's prefill (B=4, S=2048, H=80, P=64,
// N=128, Q=256) the chunk algebra above is ~86 GFLOP counted densely (the
// full Q x Q products; ~58 GFLOP with the causal half skipped) on 185 MB
// of x, dt, B, C and y, all in fp32 as the TPU kernel does it:
// operations at the 67 TFLOP/s fp32 CUDA-core rate bound it (1.3 ms).
//
// Design (simple and right first):
// * One CTA per (head, batch row): 320 CTAs at full width, each walking
//   its row's chunks in order, so the sequential chunk axis of the TPU grid
//   becomes a loop and the fp32 [P,N] state (64 x 128, 32 KB) stays in
//   shared memory for the whole row.
// * A chunk is cut into tiles of TQ=32 steps. For each query tile i the
//   CTA stages C_i, then for each key tile j <= i stages B_j and x_j,
//   forms the masked scores S = (C_i B_j^T) * decay * dt_j in shared
//   memory and accumulates S x_j in registers (2 x 4 outputs a thread);
//   then adds exp(cum_i) C_i h_in and writes y. A last pass over the key
//   tiles accumulates the state update (8 x 4 entries a thread) and folds
//   it into the state. cum is a warp scan of dt A.
// * x, dt, B and C are read in the model's layout through their strides
//   (the TPU wrapper moves axes with copies; here nothing is copied); only
//   each last dim is contiguous. y is written in the model's layout.
// * Limits: P <= 64 and N <= 128 (mamba2-2.7b's 64 and 128), any Q >= 1
//   with S % Q == 0. Tiles past Q, P or N are zero-filled.
// * Known cost: everything runs on the CUDA cores in fp32, and C B^T,
//   which does not depend on the head, is recomputed by each of the 80
//   head CTAs. Tensor cores and a head-shared C B^T are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PM = 64;    // largest head dim P
constexpr int NM = 128;   // largest state dim N
constexpr int TQ = 32;    // steps a tile
constexpr int THREADS = 256;
constexpr int LDC = NM + 1;  // odd row strides: conflict-free column reads
constexpr int LDS = TQ + 1;
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float decay(float d) { return expf(fminf(fmaxf(d, -60.f), 0.f)); }

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  float* h;  // [B,H,P,N] contiguous
  int S, H, P, N, Q;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  long long y_sb, y_ss, y_sh;
};

size_t smem_floats(int Q) {
  return (size_t)NM * PM         // state, n-major
         + 2 * (size_t)TQ * LDC  // C_i and B_j tiles
         + (size_t)TQ * PM       // x_j tile
         + (size_t)TQ * LDS      // scores
         + 3 * (size_t)Q;        // dt, cum, state-update weights
}

// rows [s, s + TQ) of a [S, width] operand into a [TQ][ld] fp32 tile, zeros
// past the chunk end `lim` and past `width` up to `cols`
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, int cols, const T* src, long long ss,
                                      int s, int lim, int width) {
  for (int i = threadIdx.x; i < TQ * cols; i += THREADS) {
    const int r = i / cols, c = i - r * cols;
    dst[r * ld + c] = s + r < lim && c < width ? to_f(src[(s + r) * ss + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) ssd_fwd(const Params p) {
  extern __shared__ __align__(16) float sm[];
  float* hT = sm;              // [NM][PM] state, h[p][n] at hT[n * PM + p]
  float* Ct = hT + NM * PM;    // [TQ][LDC]
  float* Bt = Ct + TQ * LDC;   // [TQ][LDC]
  float* Xt = Bt + TQ * LDC;   // [TQ][PM]
  float* St = Xt + TQ * PM;    // [TQ][LDS]
  float* dtq = St + TQ * LDS;  // [Q]
  float* cum = dtq + p.Q;      // [Q]
  float* wq = cum + p.Q;       // [Q]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const T* Bm = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* Cm = static_cast<const T*>(p.Cm) + b * p.c_sb;
  T* y = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh;
  const float* dt = p.dt + b * p.dt_sb + h * p.dt_sh;
  const float A = p.A[h];
  const int Q = p.Q, nt = (Q + TQ - 1) / TQ;

  for (int i = tid; i < NM * PM; i += THREADS) hT[i] = 0.f;

  for (int s0 = 0; s0 < p.S; s0 += Q) {
    // dt and cum = cumsum(dt A): one warp, each lane a run of steps
    for (int q = tid; q < Q; q += THREADS) dtq[q] = dt[(s0 + q) * p.dt_ss];
    __syncthreads();
    if (tid < 32) {
      const int seg = (Q + 31) / 32, lo = min(tid * seg, Q), hi = min(lo + seg, Q);
      float run = 0.f;
      for (int q = lo; q < hi; ++q) run += dtq[q] * A;
      float inc = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, inc, o);
        if (tid >= o) inc += v;
      }
      run = inc - run;
      for (int q = lo; q < hi; ++q) cum[q] = run += dtq[q] * A;
    }
    __syncthreads();
    const float last = cum[Q - 1];
    for (int q = tid; q < Q; q += THREADS) wq[q] = decay(last - cum[q]) * dtq[q];

    // y, one query tile at a time
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * TQ;
      stage(Ct, LDC, NM, Cm, p.c_ss, s0 + i0, s0 + Q, p.N);
      float acc[2][4] = {};
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TQ;
        stage(Bt, LDC, NM, Bm, p.b_ss, s0 + j0, s0 + Q, p.N);
        stage(Xt, PM, PM, x, p.x_ss, s0 + j0, s0 + Q, p.P);
        __syncthreads();
        // S[i][j] = (C_i . B_j) decay(cum_i - cum_j) dt_j for j <= i < Q
        float s[2][2] = {};
        for (int n = 0; n < p.N; ++n) {
          const float c0 = Ct[(2 * ty) * LDC + n], c1 = Ct[(2 * ty + 1) * LDC + n];
          const float b0 = Bt[(2 * tx) * LDC + n], b1 = Bt[(2 * tx + 1) * LDC + n];
          s[0][0] = fmaf(c0, b0, s[0][0]);
          s[0][1] = fmaf(c0, b1, s[0][1]);
          s[1][0] = fmaf(c1, b0, s[1][0]);
          s[1][1] = fmaf(c1, b1, s[1][1]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = i0 + 2 * ty + r, j = j0 + 2 * tx + c;
            St[(2 * ty + r) * LDS + 2 * tx + c] =
                i < Q && j <= i ? s[r][c] * decay(cum[i] - cum[j]) * dtq[j] : 0.f;
          }
        __syncthreads();
        // y_i += S x_j
        for (int j = 0; j < TQ; ++j) {
          const float4 xv = *reinterpret_cast<const float4*>(Xt + j * PM + 4 * tx);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float sv = St[(2 * ty + r) * LDS + j];
            acc[r][0] = fmaf(sv, xv.x, acc[r][0]);
            acc[r][1] = fmaf(sv, xv.y, acc[r][1]);
            acc[r][2] = fmaf(sv, xv.z, acc[r][2]);
            acc[r][3] = fmaf(sv, xv.w, acc[r][3]);
          }
        }
        __syncthreads();  // Bt, Xt and St are free for the next key tile
      }
      // y_i += exp(cum_i) h_in C_i
      float cr[2][4] = {};
      for (int n = 0; n < p.N; ++n) {
        const float4 hv = *reinterpret_cast<const float4*>(hT + n * PM + 4 * tx);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float cv = Ct[(2 * ty + r) * LDC + n];
          cr[r][0] = fmaf(cv, hv.x, cr[r][0]);
          cr[r][1] = fmaf(cv, hv.y, cr[r][1]);
          cr[r][2] = fmaf(cv, hv.z, cr[r][2]);
          cr[r][3] = fmaf(cv, hv.w, cr[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + 2 * ty + r;
        if (i >= Q) continue;
        const float e = decay(cum[i]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int pc = 4 * tx + c;
          if (pc < p.P) y[(s0 + i) * p.y_ss + pc] = from_f<T>(acc[r][c] + e * cr[r][c]);
        }
      }
      __syncthreads();  // Ct is free for the next query tile
    }

    // h_out = exp(cum_Q) h_in + sum_j w_j x_j B_j^T, this thread's entries
    // n = 8 ty + r, p = 4 tx + c
    float up[8][4] = {};
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * TQ;
      stage(Bt, LDC, NM, Bm, p.b_ss, s0 + j0, s0 + Q, p.N);
      stage(Xt, PM, PM, x, p.x_ss, s0 + j0, s0 + Q, p.P);
      __syncthreads();
      for (int j = 0; j < TQ && j0 + j < Q; ++j) {
        const float wj = wq[j0 + j];
        const float4 xv = *reinterpret_cast<const float4*>(Xt + j * PM + 4 * tx);
        const float xw[4] = {xv.x * wj, xv.y * wj, xv.z * wj, xv.w * wj};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float bv = Bt[j * LDC + 8 * ty + r];
#pragma unroll
          for (int c = 0; c < 4; ++c) up[r][c] = fmaf(bv, xw[c], up[r][c]);
        }
      }
      __syncthreads();
    }
    const float el = decay(last);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float* hp = hT + (8 * ty + r) * PM + 4 * tx + c;
        *hp = el * *hp + up[r][c];
      }
    __syncthreads();
  }

  float* ho = p.h + ((long long)b * p.H + h) * p.P * p.N;
  for (int i = tid; i < p.P * p.N; i += THREADS) {
    const int pc = i / p.N, n = i - pc * p.N;
    ho[i] = hT[n * PM + pc];
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_floats(p.Q) * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  ssd_fwd<T><<<dim3(p.H, B), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B,S,H,P] with element strides (x_sb, x_ss, x_sh); dt [B,S,H] fp32 with
// (dt_sb, dt_ss, dt_sh); A [H] fp32 contiguous; Bm, Cm [B,S,N] with
// (b_sb, b_ss) and (c_sb, c_ss); y [B,S,H,P] with (y_sb, y_ss, y_sh);
// h [B,H,P,N] fp32 contiguous; x, Bm, Cm and y last dims contiguous.
// dtype 0 = float32, 1 = bfloat16 (x, Bm, Cm and y share it). Q is the
// chunk; S % Q == 0. Returns a cudaError_t (0 on success).
int repro_ssd_scan(int device, int dtype, const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, void* y, float* h, int B, int S, int H, int P,
                   int N, int Q, long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
                   long long dt_ss, long long dt_sh, long long b_sb, long long b_ss,
                   long long c_sb, long long c_ss, long long y_sb, long long y_ss,
                   long long y_sh, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || P <= 0 || P > PM || N <= 0 || N > NM ||
      Q <= 0 || S % Q != 0)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  Params p;
  p.x = x;
  p.dt = dt;
  p.A = A;
  p.Bm = Bm;
  p.Cm = Cm;
  p.y = y;
  p.h = h;
  p.S = S;
  p.H = H;
  p.P = P;
  p.N = N;
  p.Q = Q;
  p.x_sb = x_sb, p.x_ss = x_ss, p.x_sh = x_sh;
  p.dt_sb = dt_sb, p.dt_ss = dt_ss, p.dt_sh = dt_sh;
  p.b_sb = b_sb, p.b_ss = b_ss;
  p.c_sb = c_sb, p.c_ss = c_ss;
  p.y_sb = y_sb, p.y_ss = y_ss, p.y_sh = y_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
