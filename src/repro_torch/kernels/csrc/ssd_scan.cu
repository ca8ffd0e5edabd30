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
// with fp32 sums, the [P,N] state carried from chunk to chunk. y comes out
// in x's dtype and the final state [B,H,P,N] in fp32.
//
// Two routes (src/repro_torch/kernels/ssd_scan.py::_route picks one):
//
// Route "tc" (bf16 x, B and C with 16-byte rows, P and N multiples of 16,
// P <= 64, N <= 128, Q <= 256): Mamba-2's chunked SSD algorithm (Dao and
// Gu, arXiv:2405.21060: chunk states, a state pass, chunk outputs) as three
// kernels on the call's stream, the chunk axis parallel and not a walk.
// * What bounds it. At mamba2-2.7b's prefill (B=4, S=2048, H=80, P=64,
//   N=128, Q=256) the function reads x, dt, B, C and writes y and the final
//   state, 185.1 MB: 0.0552 ms at 3.35 TB/s. Its operations, the causal
//   halves of the chunk products with C B^T counted once a (row, chunk),
//   are 32.52 GFLOP: 0.0329 ms at the 989 TFLOP/s bf16 tensor-core rate.
//   So bytes bound it (`chip_smoke.ssd_bound`). This design moves more: the
//   per-chunk states, 8 x 10.5 MB fp32, are written by (a), read and
//   rewritten by (b) and read by (c), up to ~315 MB more (partly held in the
//   50 MB L2), and the hi + lo terms below double the tensor-core work of
//   the fp32 operands: its own floor is near 0.15 ms.
// * (a) ssd_tc_state, one CTA of 4 warps per (head group of TC_SGROUP,
//   chunk, batch row), two CTAs an SM. It stages the chunk's B rows once
//   for the group, then per head stages x, scans cum = cumsum(dt A) (one
//   warp, fp32; cum and dt go to a small [B,nc,H,2,QM] buffer for (b) and
//   (c)) and forms the chunk's local state S_c = (x o w)^T B, w_j =
//   exp(clip(cum_Q - cum_j)) dt_j, with mma.sync m16n8k16: x o w is fp32,
//   so it enters as hi + lo bf16 terms (the residue of each term is below
//   2^-16 of it), B is bf16 and exact. Warps tile [P,N] 2 x 2. The next
//   head's dt is loaded into registers while this head's products run.
// * (b) ssd_tc_pass, one thread per 4 state entries (b, h, p, n..n+3),
//   sequential over the chunks: h_in[c] = h; h = exp(clip(cum_Q,c)) h +
//   S_c, h_in written in place of S_c (not for c = 0: zero); the final h to
//   the [B,H,P,N] output.
// * (c) ssd_tc_out, one CTA of 8 warps per (head group of TC_GROUP, chunk,
//   batch row), over all of the chunk's rows. The causal triangle of C B^T,
//   bf16 products summed in fp32, is computed once and kept in shared
//   memory (as mma fragments, 136 KB at Q = 256) for every head of the
//   group, so C B^T is computed once per (row, chunk, group) and not once
//   per head, and x and h_in are read once per (row, chunk, head). Warp w
//   owns the row blocks w and 15 - w (16 rows each), so every warp has 17
//   causal key blocks. Per head the CTA stages x, cum, dt and h_in[c]
//   (split into hi + lo bf16 as it is staged); each warp forms y =
//   exp(clip(cum_i)) (C_i h_in^T) on tensor cores from C's fragments (kept
//   in registers) and h_in's two terms, and adds the masked scores CB o
//   exp(clip(cum_i - cum_j)) o dt_j (2^x by ex2.approx.ftz), split hi + lo
//   in registers, times x. y is written in bf16 in model layout. The next
//   head's h_in is loaded into registers while this head's products run.
// * Measured on "NVIDIA H100 80GB HBM3, 700.00 W" at mamba2-2.7b's shape:
//   0.468-0.472 ms a call (launch/k4_probe.py timers, chip_smoke.py), 12%
//   of the bytes bound and ~10x route fwd; ssd_tc_out ~0.26 ms of it.
// * x, B, C and y are read and written through their strides, 16 bytes a
//   cp.async; tiles past Q, P or N are zero-filled.
//
// Route "fwd" (the first port, the chunk walker, kept for fp32 and for the bf16
// calls off route tc's alignment):
// * What bounds it. The same algebra in fp32 on the CUDA cores, the causal
//   halves skipped and C B^T counted once a (row, chunk): 32.52 GFLOP,
//   0.485 ms at the 67 TFLOP/s fp32 rate, so operations bound it.
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
//   head CTAs; the 1.2 waves of 320 CTAs leave the card idle in the tail.

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

// --------------------------------------------------------------------------- //
// Route "tc": the chunked SSD algorithm on tensor cores (bf16 x, B and C)
// --------------------------------------------------------------------------- //
constexpr int TC_PM = 64;      // largest head dim P, a multiple of 16
constexpr int TC_NM = 128;     // largest state dim N, a multiple of 16
constexpr int TC_QM = 256;     // largest chunk Q
constexpr int TC_RB = 16;      // row blocks of 16 in a chunk (TC_QM / 16), two a warp
constexpr int TC_GROUP = 20;   // heads of an output CTA
constexpr int TC_SGROUP = 10;  // heads of a state CTA
constexpr int TC_LDB = TC_NM + 8;  // bf16 row of B, C and a split state (conflict-free ldmatrix)
constexpr int TC_LDX = TC_PM + 8;  // bf16 row of x
// (a): B rows, x rows, w and dt of one head
constexpr int TC_STATE_SMEM = TC_QM * TC_LDB * 2 + TC_QM * TC_LDX * 2 + 2 * TC_QM * 4;
// (c): the causal triangle of C B^T fragments (1 KB a 16 x 16 block), then
// the head's x rows, the state's hi and lo terms, cum and dt; C is staged
// in the triangle's space and B in the head's before C B^T is formed
constexpr int TC_CB_BYTES = TC_RB * (TC_RB + 1) / 2 * 1024;
constexpr int TC_STAGE_BYTES = TC_QM * TC_LDX * 2 + 2 * TC_PM * TC_LDB * 2 + 2 * TC_QM * 4;
constexpr int TC_OUT_SMEM = TC_CB_BYTES + TC_STAGE_BYTES;
static_assert(TC_STATE_SMEM <= MAX_SMEM && 2 * (TC_STATE_SMEM + 1024) <= 233472,
              "two state CTAs an SM");
static_assert(TC_OUT_SMEM <= MAX_SMEM, "the output CTA's shared memory");
static_assert(TC_RB * 16 == TC_QM && TC_QM * TC_LDB * 2 <= TC_CB_BYTES &&
                  TC_QM * TC_LDB * 2 <= TC_STAGE_BYTES,
              "8 warps of two row blocks; C and B staging");

typedef __nv_bfloat16 bf16;

struct TcParams {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* Bm;
  const bf16* Cm;
  bf16* y;
  float* h;   // [B,H,P,N] final state
  float* st;  // [B,nc,H,P,N]: chunk states from (a), h_in from (b)
  float* cd;  // [B,nc,H,2,TC_QM]: cum and dt of each chunk, from (a)
  int B, S, H, P, N, Q, nc;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  long long y_sb, y_ss, y_sh;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) as two bf16 pairs whose sum carries ~16 bits: hi = bf16(x, y) and
// lo = bf16 of what hi rounded away
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// rows [0, rows) of a bf16 operand (row r at src + r * lds, `width` valid
// columns) into dst (row stride ldd), `chunks` 16-byte chunks a row; rows
// >= valid_rows and chunks past width zero-filled
__device__ __forceinline__ void stage_rows(bf16* dst, int ldd, const bf16* src, long long lds,
                                           int rows, int valid_rows, int chunks, int width,
                                           int tid, int nthreads) {
  for (int i = tid; i < rows * chunks; i += nthreads) {
    const int r = i / chunks, k = i - r * chunks;
    const bool ok = r < valid_rows && k * 8 < width;
    cp_async16(dst + r * ldd + k * 8, ok ? src + r * lds + k * 8 : src, ok);
  }
}

// (a) chunk states. Per head of the group: cum = cumsum(dt A) over the
// chunk (to cd, with dt), and S_c = (x o w)^T B into st, w_j = exp(clip(
// cum_Q - cum_j)) dt_j, x o w as hi + lo bf16 terms.
__global__ void __launch_bounds__(128, 2) ssd_tc_state(const TcParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Bs = reinterpret_cast<bf16*>(smem);                   // [QM][LDB]
  bf16* xs = Bs + TC_QM * TC_LDB;                             // [QM][LDX]
  float* wq = reinterpret_cast<float*>(xs + TC_QM * TC_LDX);  // [QM] cum, then w
  float* dq = wq + TC_QM;                                     // [QM] dt

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h0 = blockIdx.x * TC_SGROUP, c = blockIdx.y, b = blockIdx.z;
  const int hn = min(TC_SGROUP, p.H - h0);
  const int Q = p.Q, Q16 = (Q + 15) & ~15, s0 = c * Q;
  const int wm = warp >> 1, wn = warp & 1;  // this warp's P rows 32 wm.., N columns 64 wn..

  // the chunk's B rows, waited for with the first head's x
  stage_rows(Bs, TC_LDB, p.Bm + b * p.b_sb + s0 * p.b_ss, p.b_ss, Q16, Q, TC_NM / 8, p.N, tid,
             128);
  // dt of the next head in registers, loaded while the products of this one run
  float dnext[TC_QM / 128];
  auto load_dt = [&](int h) {
    const float* dt = p.dt + b * p.dt_sb + s0 * p.dt_ss + h * p.dt_sh;
#pragma unroll
    for (int k = 0; k < TC_QM / 128; ++k) {
      const int q = tid + 128 * k;
      dnext[k] = q < Q ? dt[q * p.dt_ss] : 0.f;
    }
  };
  load_dt(h0);
  for (int hi = 0; hi < hn; ++hi) {
    const int h = h0 + hi;
    if (hi) __syncthreads();  // xs, wq and dq are free
    stage_rows(xs, TC_LDX, p.x + b * p.x_sb + s0 * p.x_ss + h * p.x_sh, p.x_ss, Q16, Q,
               TC_PM / 8, p.P, tid, 128);
#pragma unroll
    for (int k = 0; k < TC_QM / 128; ++k) dq[tid + 128 * k] = dnext[k];
    __syncthreads();
    if (warp == 0) {
      // cum: each lane a run of steps, the runs' sums scanned across the warp
      const float A = p.A[h];
      const int seg = (Q + 31) / 32, lo = min(lane * seg, Q), hi_ = min(lo + seg, Q);
      float run = 0.f;
      for (int q = lo; q < hi_; ++q) run += dq[q] * A;
      float inc = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      run = inc - run;
      for (int q = lo; q < hi_; ++q) wq[q] = run += dq[q] * A;
      __syncwarp();
      const float last = wq[Q - 1];
      float* cdh = p.cd + (((long long)b * p.nc + c) * p.H + h) * 2 * TC_QM;
      for (int q = lane; q < Q16; q += 32) {
        const float cq = q < Q ? wq[q] : 0.f;
        cdh[q] = cq;
        cdh[TC_QM + q] = dq[q];
        wq[q] = q < Q ? decay(last - cq) * dq[q] : 0.f;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (hi + 1 < hn) load_dt(h + 1);

    float acc[2][8][4] = {};
    for (int ks = 0; ks < Q16 / 16; ++ks) {
      const float2 w0 = *reinterpret_cast<const float2*>(wq + ks * 16 + 2 * t);
      const float2 w8 = *reinterpret_cast<const float2*>(wq + ks * 16 + 2 * t + 8);
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // A = x^T: rows p, columns q; x is stored [q][p], so transposed loads
        uint32_t r[4];
        ldmatrix_x4_trans(r, xs + (ks * 16 + (lane & 7) + (lane >> 4) * 8) * TC_LDX + wm * 32 +
                                 mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 v = unpack_bf16(r[k]);
          const float2 w = k < 2 ? w0 : w8;  // a0, a1: q = 2t, 2t+1; a2, a3: q + 8
          split_bf16(v.x * w.x, v.y * w.y, ah[mi][k], al[mi][k]);
        }
      }
      uint32_t bb[4][4];
#pragma unroll
      for (int np = 0; np < 4; ++np)
        ldmatrix_x4_trans(bb[np], Bs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * TC_LDB +
                                      wn * 64 + np * 16 + (lane >> 4) * 8);
      // the hi terms, then the lo terms: no accumulator is hit twice in a row
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int np = 0; np < 4; ++np)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const uint32_t(&a)[4] = part ? al[mi] : ah[mi];
            mma_bf16(acc[mi][2 * np], a, bb[np][0], bb[np][1]);
            mma_bf16(acc[mi][2 * np + 1], a, bb[np][2], bb[np][3]);
          }
    }
    float* st = p.st + (((long long)b * p.nc + c) * p.H + h) * p.P * p.N;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int pr = wm * 32 + mi * 16 + g, n = wn * 64 + nb * 8 + 2 * t;
        if (n >= p.N) continue;
        if (pr < p.P)
          *reinterpret_cast<float2*>(st + pr * p.N + n) =
              make_float2(acc[mi][nb][0], acc[mi][nb][1]);
        if (pr + 8 < p.P)
          *reinterpret_cast<float2*>(st + (pr + 8) * p.N + n) =
              make_float2(acc[mi][nb][2], acc[mi][nb][3]);
      }
  }
}

// (b) the state pass: h_in[c] = h; h = exp(clip(cum_Q)) h + S_c over the
// chunks in order, h_in in place of S_c (for c > 0), the final h to p.h.
__global__ void __launch_bounds__(256) ssd_tc_pass(const TcParams p) {
  const int n4 = p.N / 4;
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= (long long)p.B * p.H * p.P * n4) return;
  const int nq = i % n4;
  long long r = i / n4;
  const int pr = r % p.P;
  r /= p.P;
  const int h = r % p.H, b = r / p.H;
  const long long chunk = (long long)p.H * p.P * p.N;  // st floats from one chunk to the next
  float* st = p.st + ((long long)b * p.nc * p.H + h) * p.P * p.N + pr * p.N + nq * 4;
  const float* cq = p.cd + ((long long)b * p.nc * p.H + h) * 2 * TC_QM + p.Q - 1;
  float4 hc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < p.nc; c0 += 4) {  // four chunks' loads in flight
    float4 s[4];
    float e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c0 + k < p.nc) {
        s[k] = *reinterpret_cast<const float4*>(st + (c0 + k) * chunk);
        e[k] = decay(cq[(long long)(c0 + k) * p.H * 2 * TC_QM]);
      }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c0 + k < p.nc) {
        if (c0 + k) *reinterpret_cast<float4*>(st + (c0 + k) * chunk) = hc;
        hc = make_float4(fmaf(e[k], hc.x, s[k].x), fmaf(e[k], hc.y, s[k].y),
                         fmaf(e[k], hc.z, s[k].z), fmaf(e[k], hc.w, s[k].w));
      }
  }
  *reinterpret_cast<float4*>(p.h + (((long long)b * p.H + h) * p.P + pr) * p.N + nq * 4) = hc;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(clip(ci - cj)) dt_j (C B^T)_ij where j <= i, else 0, as 2^clip((ci - cj)
// log2 e, -60 log2 e, 0)
__device__ __forceinline__ float score(float cb, float ci, float cj, float dj, bool on) {
  constexpr float L2E = 1.4426950408889634f;
  return on ? cb * ex2(fminf(fmaxf((ci - cj) * L2E, -60.f * L2E), 0.f)) * dj : 0.f;
}

// (c) chunk outputs for one head group over a whole chunk: C B^T once, then
// per head y = exp(clip(cum_i)) C_i h_in^T + (CB o decay o dt, masked) x.
// Warp w owns the row blocks w and TC_RB - 1 - w, so every warp has the same
// number of causal key blocks.
__global__ void __launch_bounds__(256, 1) ssd_tc_out(const TcParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the causal triangle of C B^T accumulator fragments: row block r, key
  // block kb <= r at tri(r) + kb, each [n8 half][lane] float4
  float4* cbs = reinterpret_cast<float4*>(smem);
  unsigned char* stage = smem + TC_CB_BYTES;
  bf16* xs = reinterpret_cast<bf16*>(stage);                   // [QM][LDX]
  bf16* hh = xs + TC_QM * TC_LDX;                              // [PM][LDB] h_in, hi
  bf16* hl = hh + TC_PM * TC_LDB;                              // [PM][LDB] h_in, lo
  float* cum = reinterpret_cast<float*>(hl + TC_PM * TC_LDB);  // [QM]
  float* dtq = cum + TC_QM;                                    // [QM]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h0 = blockIdx.x * TC_GROUP, c = blockIdx.y, b = blockIdx.z;
  const int hn = min(TC_GROUP, p.H - h0);
  const int Q = p.Q, Q16 = (Q + 15) & ~15, s0 = c * Q;
  const int rb[2] = {warp, TC_RB - 1 - warp};  // this warp's row blocks
  auto tri = [](int r) { return r * (r + 1) / 2; };

  // C B^T: C in the triangle's space and B in the staging space until C's
  // fragments are in registers
  {
    bf16* Cs = reinterpret_cast<bf16*>(smem);  // [QM][LDB]
    bf16* Bs = xs;                             // [QM][LDB]
    stage_rows(Cs, TC_LDB, p.Cm + b * p.c_sb + s0 * p.c_ss, p.c_ss, Q16, Q, TC_NM / 8, p.N,
               tid, 256);
    stage_rows(Bs, TC_LDB, p.Bm + b * p.b_sb + s0 * p.b_ss, p.b_ss, Q16, Q, TC_NM / 8, p.N,
               tid, 256);
    cp_async_wait_all();
    __syncthreads();
  }
  uint32_t ca[2][TC_NM / 16][4];  // C's fragments for the warp's row blocks, kept for every head
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int ks = 0; ks < TC_NM / 16; ++ks)
      ldmatrix_x4(ca[k][ks], reinterpret_cast<const bf16*>(smem) +
                                 (16 * rb[k] + (lane & 15)) * TC_LDB + ks * 16 + (lane >> 4) * 8);
  __syncthreads();  // C is in registers: the triangle's space is free
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (16 * rb[k] >= Q) continue;
    for (int kb = 0; kb <= rb[k]; ++kb) {
      float s[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < TC_NM / 16; ++ks) {
        uint32_t bk[4];
        ldmatrix_x4(bk, xs + (kb * 16 + (lane & 7) + (lane >> 4) * 8) * TC_LDB + ks * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[0], ca[k][ks], bk[0], bk[1]);
        mma_bf16(s[1], ca[k][ks], bk[2], bk[3]);
      }
      float4* out = cbs + (tri(rb[k]) + kb) * 64 + lane;
      out[0] = make_float4(s[0][0], s[0][1], s[0][2], s[0][3]);
      out[32] = make_float4(s[1][0], s[1][1], s[1][2], s[1][3]);
    }
  }

  // h_in of the next head in registers, loaded while the products of this one run
  float4 hnext[TC_PM * TC_NM / 4 / 256];
  auto load_h = [&](int h) {
    const float4* hin = reinterpret_cast<const float4*>(
        p.st + (((long long)b * p.nc + c) * p.H + h) * p.P * p.N);
#pragma unroll
    for (int k = 0; k < TC_PM * TC_NM / 4 / 256; ++k) {
      const int i = tid + 256 * k, pr = i / (TC_NM / 4), nq = i - pr * (TC_NM / 4);
      hnext[k] = pr < p.P && 4 * nq < p.N ? __ldg(hin + pr * (p.N / 4) + nq)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  if (c > 0) load_h(h0);
  for (int hi = 0; hi < hn; ++hi) {
    const int h = h0 + hi;
    __syncthreads();  // B, or the previous head's x, h_in, cum and dt, are read
    stage_rows(xs, TC_LDX, p.x + b * p.x_sb + s0 * p.x_ss + h * p.x_sh, p.x_ss, Q16, Q,
               TC_PM / 8, p.P, tid, 256);
    const float* cdh = p.cd + (((long long)b * p.nc + c) * p.H + h) * 2 * TC_QM;
    for (int i = tid; i < Q16 / 2; i += 256) {  // cum and dt, 4 floats a copy
      const int row = i / (Q16 / 4), k = i - row * (Q16 / 4);
      cp_async16((row ? dtq : cum) + 4 * k, cdh + row * TC_QM + 4 * k, true);
    }
    if (c > 0) {
#pragma unroll
      for (int k = 0; k < TC_PM * TC_NM / 4 / 256; ++k) {
        const int i = tid + 256 * k, pr = i / (TC_NM / 4), nq = i - pr * (TC_NM / 4);
        const float4 v = hnext[k];
        uint2 vh, vl;
        split_bf16(v.x, v.y, vh.x, vl.x);
        split_bf16(v.z, v.w, vh.y, vl.y);
        *reinterpret_cast<uint2*>(hh + pr * TC_LDB + 4 * nq) = vh;
        *reinterpret_cast<uint2*>(hl + pr * TC_LDB + 4 * nq) = vl;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (c > 0 && hi + 1 < hn) load_h(h + 1);

    bf16* y = p.y + b * p.y_sb + s0 * p.y_ss + h * p.y_sh;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = rb[k], i0 = 16 * r;
      if (i0 >= Q) continue;
      float acc[TC_PM / 8][4] = {};
      const int ia = i0 + g, ib = ia + 8;
      const float ci0 = cum[ia], ci1 = cum[ib];
      if (c > 0) {
        // y = exp(clip(cum_i)) C_i h_in^T, h_in as hi + lo terms
#pragma unroll
        for (int ks = 0; ks < TC_NM / 16; ++ks) {
          uint32_t bt[2][TC_PM / 16][4];  // h_in's hi and lo terms
#pragma unroll
          for (int np = 0; np < TC_PM / 16; ++np) {
            const int off = (np * 16 + (lane & 7) + (lane >> 4) * 8) * TC_LDB + ks * 16 +
                            ((lane >> 3) & 1) * 8;
            ldmatrix_x4(bt[0][np], hh + off);
            ldmatrix_x4(bt[1][np], hl + off);
          }
#pragma unroll
          for (int part = 0; part < 2; ++part)
#pragma unroll
            for (int np = 0; np < TC_PM / 16; ++np) {
              mma_bf16(acc[2 * np], ca[k][ks], bt[part][np][0], bt[part][np][1]);
              mma_bf16(acc[2 * np + 1], ca[k][ks], bt[part][np][2], bt[part][np][3]);
            }
        }
        const float e0 = decay(ci0), e1 = decay(ci1);
#pragma unroll
        for (int nb = 0; nb < TC_PM / 8; ++nb) {
          acc[nb][0] *= e0;
          acc[nb][1] *= e0;
          acc[nb][2] *= e1;
          acc[nb][3] *= e1;
        }
      }
      // y += (C B^T o exp(clip(cum_i - cum_j)) o dt_j, j <= i) x, the scores as
      // hi + lo terms
      const float4* cbw = cbs + tri(r) * 64 + lane;
#pragma unroll 2
      for (int kb = 0; kb <= r; ++kb) {
        const float4 c0 = cbw[kb * 64], c1 = cbw[kb * 64 + 32];
        const int j = kb * 16 + 2 * t;
        const float2 cj0 = *reinterpret_cast<const float2*>(cum + j);
        const float2 cj8 = *reinterpret_cast<const float2*>(cum + j + 8);
        const float2 dj0 = *reinterpret_cast<const float2*>(dtq + j);
        const float2 dj8 = *reinterpret_cast<const float2*>(dtq + j + 8);
        uint32_t ah[4], al[4];
        split_bf16(score(c0.x, ci0, cj0.x, dj0.x, j <= ia),
                   score(c0.y, ci0, cj0.y, dj0.y, j < ia), ah[0], al[0]);
        split_bf16(score(c0.z, ci1, cj0.x, dj0.x, j <= ib),
                   score(c0.w, ci1, cj0.y, dj0.y, j < ib), ah[1], al[1]);
        split_bf16(score(c1.x, ci0, cj8.x, dj8.x, j + 8 <= ia),
                   score(c1.y, ci0, cj8.y, dj8.y, j + 8 < ia), ah[2], al[2]);
        split_bf16(score(c1.z, ci1, cj8.x, dj8.x, j + 8 <= ib),
                   score(c1.w, ci1, cj8.y, dj8.y, j + 8 < ib), ah[3], al[3]);
        uint32_t bv[TC_PM / 16][4];
#pragma unroll
        for (int np = 0; np < TC_PM / 16; ++np)
          ldmatrix_x4_trans(bv[np], xs + (kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * TC_LDX +
                                        np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int np = 0; np < TC_PM / 16; ++np) {
            const uint32_t(&a)[4] = part ? al : ah;
            mma_bf16(acc[2 * np], a, bv[np][0], bv[np][1]);
            mma_bf16(acc[2 * np + 1], a, bv[np][2], bv[np][3]);
          }
      }
#pragma unroll
      for (int nb = 0; nb < TC_PM / 8; ++nb) {
        const int col = nb * 8 + 2 * t;
        if (col >= p.P) continue;
        if (ia < Q)
          *reinterpret_cast<__nv_bfloat162*>(y + ia * p.y_ss + col) =
              __floats2bfloat162_rn(acc[nb][0], acc[nb][1]);
        if (ib < Q)
          *reinterpret_cast<__nv_bfloat162*>(y + ib * p.y_ss + col) =
              __floats2bfloat162_rn(acc[nb][2], acc[nb][3]);
      }
    }
  }
}

cudaError_t launch_tc(const TcParams& p, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(ssd_tc_state, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       TC_STATE_SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(ssd_tc_out, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_OUT_SMEM);
  if (e != cudaSuccess) return e;
  ssd_tc_state<<<dim3((p.H + TC_SGROUP - 1) / TC_SGROUP, p.nc, p.B), 128, TC_STATE_SMEM,
                 stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long n4 = (long long)p.B * p.H * p.P * (p.N / 4);
  ssd_tc_pass<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_tc_out<<<dim3((p.H + TC_GROUP - 1) / TC_GROUP, p.nc, p.B), 256, TC_OUT_SMEM, stream>>>(p);
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

// Route "tc". The same arguments as repro_ssd_scan for bf16 x, Bm, Cm and y,
// plus workspaces from the caller: st [B,S/Q,H,P,N] fp32 and cd
// [B,S/Q,H,2,256] fp32. P and N multiples of 16, P <= 64, N <= 128, Q <=
// 256; x, Bm and Cm 16-byte aligned with strides that are multiples of 8
// elements (a dim of extent 1 may pass 0). Three launches on `stream`.
int repro_ssd_scan_tc(int device, const void* x, const float* dt, const float* A, const void* Bm,
                      const void* Cm, void* y, float* h, float* st, float* cd, int B, int S,
                      int H, int P, int N, int Q, long long x_sb, long long x_ss, long long x_sh,
                      long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
                      long long b_ss, long long c_sb, long long c_ss, long long y_sb,
                      long long y_ss, long long y_sh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > TC_PM || P % 16 || N <= 0 || N > TC_NM ||
      N % 16 || Q <= 0 || Q > TC_QM || S % Q != 0 || (long long)B * (S / Q) > 65535)
    return cudaErrorInvalidValue;
  const long long strides[] = {x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss};
  for (long long s : strides)
    if (s % 8) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(Bm) % 16 ||
      reinterpret_cast<uintptr_t>(Cm) % 16 || y_ss % 2 || y_sh % 2 ||
      reinterpret_cast<uintptr_t>(y) % 4)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  TcParams p;
  p.x = static_cast<const bf16*>(x);
  p.dt = dt;
  p.A = A;
  p.Bm = static_cast<const bf16*>(Bm);
  p.Cm = static_cast<const bf16*>(Cm);
  p.y = static_cast<bf16*>(y);
  p.h = h;
  p.st = st;
  p.cd = cd;
  p.B = B;
  p.S = S;
  p.H = H;
  p.P = P;
  p.N = N;
  p.Q = Q;
  p.nc = S / Q;
  p.x_sb = x_sb, p.x_ss = x_ss, p.x_sh = x_sh;
  p.dt_sb = dt_sb, p.dt_ss = dt_ss, p.dt_sh = dt_sh;
  p.b_sb = b_sb, p.b_ss = b_ss;
  p.c_sb = c_sb, p.c_ss = c_ss;
  p.y_sb = y_sb, p.y_ss = y_ss, p.y_sh = y_sh;
  return launch_tc(p, static_cast<cudaStream_t>(stream));
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
