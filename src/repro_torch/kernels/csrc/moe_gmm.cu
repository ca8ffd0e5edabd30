// K3 on Hopper: the grouped (per-expert) matrix product of the MoE expert
// FFNs, out[e] = x[e] @ w[e].
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py:44 moe_gmm (Pallas
// body `_kernel` at :25, pallas_call at :65). Oracle:
// src/repro/kernels/ref.py::moe_gmm_ref, ported as
// src/repro_torch/kernels/ref.py::moe_gmm_ref.
//
// What it computes. x [E,C,D], w [E,D,F] -> out [E,C,F] in x's dtype:
//   out[e,c,f] = sum_d x[e,c,d] * w[e,d,f], summed in fp32.
//
// What bounds it. At decode (deepseek-moe-16b, B=4 routed as one group:
// E=64, C=4, D=2048, F=1408) a call does 2*E*C*D*F = 1.5 GFLOP on 369 MB
// of weights: 4 flops a byte, far below the ~295 where the H100's bf16
// tensor cores take over from HBM, so bytes bound it (0.11 ms at
// 3.35 TB/s) and the kernel must stream every expert's weights once with
// many bytes in flight. At prefill (B=4, S=2048: C = 4 x 241 = 964) it is
// 356 GFLOP on 0.6 GB: operations bound it (0.36 ms at 989 TFLOP/s).
//
// Design (simple and right first; wgmma, TMA and a persistent schedule
// are later work):
// * One CTA per (F tile, C tile, expert). The loop over D inside the CTA
//   takes the place of the TPU's sequential D grid axis and its fp32 VMEM
//   accumulator: the accumulator lives in registers.
// * bf16: mma.sync.m16n8k16 (bf16 in, fp32 accumulate), A (x) by ldmatrix
//   and B (w, [D][F] rows) by ldmatrix.trans from padded shared-memory
//   rows (conflict-free), fed by a 3-stage cp.async ring of BK=32-deep
//   tiles. Two tile shapes: 16 x 128 for a small C (decode: 704 CTAs of 4
//   warps, every expert's weights read once, two stages of 8 KB a CTA in
//   flight) and 128 x 128 for a large C (prefill: each warp a 64 x 32 tile).
// * Ragged C, D and F are masked in the kernel: rows past C and columns
//   past D or F are zero-filled in shared memory (cp.async with 0 source
//   bytes) and never stored, so the wrapper pads nothing by copies (the
//   TPU wrapper pads C, D and F with jnp.pad). x is read through its
//   expert and row strides, so the model's expert-major dispatch buffer
//   [E, rows*C, d] goes in as it is; only each last dim is contiguous.
//   Where a dim or a stride is not a multiple of 8 (16 bytes) the tiles
//   are staged by element loads instead of cp.async.
// * fp32: the same CTA decomposition on the CUDA cores (64 x 64 tiles,
//   4 x 4 outputs a thread, BK=16), the tensor cores having no full-fp32
//   product. It is the exactness path, not a fast one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90
constexpr int BK = 32;            // depth of a k-step (bf16 path)
constexpr int STAGES = 3;         // cp.async ring depth (bf16 path)
constexpr int BM32 = 64, BN32 = 64, BK32 = 16, THREADS32 = 256;  // fp32 path

struct Params {
  const void* x;
  const void* w;
  void* out;
  int C, D, F;
  long long x_se, x_sc;  // x [E,C,D] element strides; d contiguous
  long long w_se, w_sd;  // w [E,D,F]; f contiguous
  long long o_se, o_sc;  // out [E,C,F]; f contiguous
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
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

// --------------------------------------------------------------------------- //
// bf16: mma.sync on the tensor cores
// --------------------------------------------------------------------------- //
// A CTA tile of BM rows of C by BN columns of F, WM x WN warps.
template <int BM, int BN, int WM, int WN>
struct Tile {
  static constexpr int BM_ = BM, BN_ = BN, WN_ = WN;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int TM = BM / WM, TN = BN / WN;  // a warp's tile
  static constexpr int MT = TM / 16, NT = TN / 8;   // its mma tiles
  static constexpr int LDX = BK + 8;                // padded rows:
  static constexpr int LDW = BN + 8;                // conflict-free ldmatrix
  static constexpr int XS = BM * LDX, WS = BK * LDW;  // elements a stage
  static constexpr size_t SMEM = (size_t)STAGES * (XS + WS) * sizeof(bf16);
  static_assert(TM % 16 == 0 && TN % 16 == 0, "warp tile");
};

using Small = Tile<16, 128, 1, 4>;  // C <= 16 (decode)
using Large = Tile<128, 128, 2, 4>;  // prefill

// Stage the k-step at depth k0 into one ring slot: x rows c0.. and w rows
// k0.., zeros past C, D and F. VEC: 16-byte cp.async (D, F and the row
// strides multiples of 8, the bases 16-byte aligned); else element loads.
template <class T, bool VEC>
__device__ __forceinline__ void stage(const Params& p, const bf16* x, const bf16* w, bf16* xs,
                                      bf16* ws, int c0, int n0, int k0) {
  constexpr int BM = T::BM_, BN = T::BN_;
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < BM * (BK / 8); i += T::THREADS) {
      const int r = i / (BK / 8), k = (i % (BK / 8)) * 8;
      const bool ok = c0 + r < p.C && k0 + k < p.D;
      cp_async16(xs + r * T::LDX + k, ok ? x + (c0 + r) * p.x_sc + k0 + k : x, ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < BK * (BN / 8); i += T::THREADS) {
      const int r = i / (BN / 8), n = (i % (BN / 8)) * 8;
      const bool ok = k0 + r < p.D && n0 + n < p.F;
      cp_async16(ws + r * T::LDW + n, ok ? w + (k0 + r) * p.w_sd + n0 + n : w, ok ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < BM * BK; i += T::THREADS) {
      const int r = i / BK, k = i % BK;
      xs[r * T::LDX + k] =
          c0 + r < p.C && k0 + k < p.D ? x[(c0 + r) * p.x_sc + k0 + k] : zero;
    }
    for (int i = threadIdx.x; i < BK * BN; i += T::THREADS) {
      const int r = i / BN, n = i % BN;
      ws[r * T::LDW + n] =
          k0 + r < p.D && n0 + n < p.F ? w[(k0 + r) * p.w_sd + n0 + n] : zero;
    }
  }
}

template <class T, bool VEC>
__global__ void __launch_bounds__(T::THREADS) gmm_bf16(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][BM][LDX]
  bf16* ws = xs + STAGES * T::XS;                 // [STAGES][BK][LDW]
  constexpr int BM = T::BM_, BN = T::BN_;

  const int e = blockIdx.z;
  const int c0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bf16* x = static_cast<const bf16*>(p.x) + e * p.x_se;
  const bf16* w = static_cast<const bf16*>(p.w) + e * p.w_se;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / T::WN_, wn = warp % T::WN_;

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int KT = (p.D + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) stage<T, VEC>(p, x, w, xs + s * T::XS, ws + s * T::WS, c0, n0, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // step kt has landed
    __syncthreads();              // and every warp is done with step kt - 1's slot
    const int nk = kt + STAGES - 1;
    if (nk < KT)
      stage<T, VEC>(p, x, w, xs + (nk % STAGES) * T::XS, ws + (nk % STAGES) * T::WS, c0, n0,
                    nk * BK);
    cp_async_commit();

    const bf16* xb = xs + (kt % STAGES) * T::XS;
    const bf16* wb = ws + (kt % STAGES) * T::WS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
        ldmatrix_x4(a[i], xb + (wm * T::TM + i * 16 + (lane & 15)) * T::LDX + kk * 16 +
                              (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < T::NT / 2; ++j) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, wb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * T::LDW +
                                 wn * T::TN + j * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          mma_bf16(acc[i][2 * j], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(p.out) + e * p.o_se;
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int r = c0 + wm * T::TM + i * 16 + (lane >> 2) + (h >> 1) * 8;
        const int n = n0 + wn * T::TN + j * 8 + (lane & 3) * 2 + (h & 1);
        if (r < p.C && n < p.F) out[r * p.o_sc + n] = __float2bfloat16(acc[i][j][h]);
      }
}

// --------------------------------------------------------------------------- //
// fp32: CUDA cores
// --------------------------------------------------------------------------- //
__global__ void __launch_bounds__(THREADS32) gmm_f32(const Params p) {
  __shared__ float xs[BK32][BM32 + 4];  // x tile, k-major
  __shared__ float ws[BK32][BN32 + 4];
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * BM32, n0 = blockIdx.x * BN32;
  const float* x = static_cast<const float*>(p.x) + e * p.x_se;
  const float* w = static_cast<const float*>(p.w) + e * p.w_se;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < p.D; k0 += BK32) {
    for (int i = threadIdx.x; i < BM32 * BK32; i += THREADS32) {
      const int r = i / BK32, k = i % BK32;
      xs[k][r] = c0 + r < p.C && k0 + k < p.D ? x[(c0 + r) * p.x_sc + k0 + k] : 0.f;
    }
    for (int i = threadIdx.x; i < BK32 * BN32; i += THREADS32) {
      const int k = i / BN32, n = i % BN32;
      ws[k][n] = k0 + k < p.D && n0 + n < p.F ? w[(k0 + k) * p.w_sd + n0 + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK32; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = static_cast<float*>(p.out) + e * p.o_se;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = c0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (r < p.C && n < p.F) out[r * p.o_sc + n] = acc[i][j];
    }
}

// --------------------------------------------------------------------------- //
// host side
// --------------------------------------------------------------------------- //
template <typename K>
cudaError_t launch(K kern, const Params& p, int E, int bm, int bn, int threads, size_t smem,
                   cudaStream_t stream) {
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long ny = (p.C + bm - 1) / bm, nx = (p.F + bn - 1) / bn;
  if (nx > 0x7fffffffLL || ny > 65535 || E > 65535) return cudaErrorInvalidValue;
  kern<<<dim3((unsigned)nx, (unsigned)ny, E), threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_bf16(const Params& p, int E, bool vec, cudaStream_t stream) {
  constexpr int BM = T::BM_, BN = T::BN_;
  if (vec) return launch(gmm_bf16<T, true>, p, E, BM, BN, T::THREADS, T::SMEM, stream);
  return launch(gmm_bf16<T, false>, p, E, BM, BN, T::THREADS, T::SMEM, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// x [E,C,D] with element strides (x_se, x_sc); w [E,D,F] with (w_se,
// w_sd); out [E,C,F] with (o_se, o_sc); every last dim contiguous.
// dtype 0 = float32, 1 = bfloat16 (x, w and out share it). Returns a
// cudaError_t (0 on success).
int repro_moe_gmm(int device, int dtype, const void* x, const void* w, void* out, int E, int C,
                  int D, int F, long long x_se, long long x_sc, long long w_se, long long w_sd,
                  long long o_se, long long o_sc, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  Params p;
  p.x = x;
  p.w = w;
  p.out = out;
  p.C = C;
  p.D = D;
  p.F = F;
  p.x_se = x_se, p.x_sc = x_sc;
  p.w_se = w_se, p.w_sd = w_sd;
  p.o_se = o_se, p.o_sc = o_sc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch(gmm_f32, p, E, BM32, BN32, THREADS32, 0, st);
  if (dtype != 1) return cudaErrorInvalidValue;
  // 16-byte cp.async needs every 8-element chunk inside the row and every
  // row start 16-byte aligned
  bool vec = D % 8 == 0 && F % 8 == 0 && aligned16(x) && aligned16(w);
  const long long strides[4] = {x_se, x_sc, w_se, w_sd};
  for (long long s : strides) vec = vec && s % 8 == 0;
  if (C <= 16) return launch_bf16<Small>(p, E, vec, st);
  return launch_bf16<Large>(p, E, vec, st);
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
