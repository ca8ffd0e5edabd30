// K3 on Hopper: the grouped (per-expert) matrix product of the MoE expert
// FFNs, out[e] = x[e] @ w[e].
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py:44 moe_gmm (Pallas
// body `_kernel` at :25, pallas_call at :65). Oracle:
// src/repro/kernels/ref.py::moe_gmm_ref, ported as
// src/repro_torch/kernels/ref.py::moe_gmm_ref.
//
// What it computes. x [E,C,D], w [E,D,F] -> out [E,C,F] in x's dtype:
//   out[e,c,f] = sum_d x[e,c,d] * w[e,d,f], summed in fp32,
// over every row, the empty capacity slots (zero rows) included.
//
// What bounds it. deepseek-moe-16b (E=64; gate/up D=2048 F=1408, down
// D=1408 F=2048). Served decode (4 rows x capacity 4: C=16) does
// 2*E*C*D*F = 5.9 GFLOP on 369 MB of weights, 16 flops a byte, far below
// the ~295 where the H100's bf16 tensor cores take over from HBM: bytes
// bound it (0.113 ms at 3.35 TB/s), so the kernel must stream every
// expert's weights once with many bytes in flight on every SM. Prefill
// (B=4, S=2048: C = 4 x 241 = 964) is 356 GFLOP on 0.6 GB: operations
// bound it (0.360 ms at 989 TFLOP/s), so it is built around wgmma's rate.
//
// Routes (the wrapper's `moe_gmm._route` picks one; the `route` argument):
//
// Route 2, bf16 prefill (more than DEC_ROWS rows; every stride a multiple
// of 16 bytes, every base 16-byte aligned, D and F multiples of 8):
// `gmm_tma_wgmma`, a persistent grouped GEMM.
// * One CTA an SM. A static tile scheduler walks the tiles t = (expert,
//   N tile, M tile), M fastest, CTA b taking t = b, b + grid, ...: the M
//   tiles that share an expert's weight panel run side by side, and the
//   132 CTAs in flight span two to three experts (x 2.7-3.9 MB + w 5.8 MB
//   each), which L2 holds.
// * Two tile shapes, one wgmma a k16 step for each consumer warpgroup
//   half: tall, TMA_BM = 256 rows by TMA_BN = 128 columns (m64n128k16, a
//   warpgroup's 128 rows as two of them); wide, WIDE_BM = 128 by WIDE_BN =
//   256 (m64n256k16, a warpgroup's 64 rows). A call takes the wide tile
//   where it pads C and F to whole tiles with no more products than the
//   tall one: deepseek's down product (F = 2048: 8 M by 8 N tiles), not
//   gate/up (F = 1408, 11 tall N tiles; wide would pad it by 9%). Both
//   stage 48 KB a k-step; the wide one reads 20 KB from shared memory a k16
//   step against the tall one's 24 KB (the tall tile's w panel goes to the
//   tensor cores once for each of its four 64-row blocks): 2-3% faster at
//   deepseek's down product on an H100 (PERF.md §6).
// * Loads: one thread of a producer warpgroup issues TMA
//   (cp.async.bulk.tensor) from 3-d tensor maps over x [E,C,D] and w
//   [E,D,F] read through their strides (the expert-major dispatch buffer
//   goes in as it is), into a ring of TMA_STAGES stages of TMA_BK = 64-deep
//   k-steps: x as one 128-byte swizzled panel of the tile's rows, w as
//   64-column panels. Each stage has a full mbarrier (TMA's byte count)
//   and an empty one (every consumer thread arrives). Rows past C and
//   columns past D or F arrive as TMA's zeros. The producer warpgroup
//   gives its registers to the consumers (setmaxnreg). Fewer bytes in
//   flight cost time: 3 stages with a whole-tile output staging read
//   0.56 ms against 4 stages' 0.51 at deepseek's prefill on an H100.
// * Products: two consumer warpgroups, fp32 accumulators in registers
//   (128 a thread). x is the K-major A operand; w ([D][F], F contiguous)
//   is the MN-major B operand. A k-step's products are issued before the
//   last k-step's are waited for, and its stage is released after.
// * Epilogue: each consumer rounds its accumulators once to bf16, 64 rows
//   by 128 columns at a time, into 128-byte swizzled staging, and one
//   thread stores each with TMA (rows past C and columns past F are not
//   written). The first half goes through the consumer's own staging;
//   the second through a quarter of the tile's last ring stage, which
//   both consumers' products have left by then, so that it need not wait
//   for the first half's store to read the staging; that stage is
//   released one k-step into the next tile, once its store has read it.
//   The stores drain while the next tile's products run, and the producer
//   runs up to TMA_STAGES k-steps ahead. (Stores from registers, 4 bytes
//   a thread, cost 0.15-0.21 ms a prefill call on an H100: PERF.md §6.)
//
// Route 3, bf16 decode (at most DEC_ROWS rows, the same alignment):
// `gmm_decode_tma_wgmma`, the same persistent walk over (expert, 64-column
// tile of F) with the operands swapped: w^T is wgmma's A (F fills its M of
// 64; MN-major from the w tile) and x^T its B (the <= 16 rows are N;
// K-major), m64n16k16. Its producer warp streams DEC_BK = 128-deep k-steps
// (16 KB of weights, 4 KB of x) into a ring of DEC_STAGES stages, 160 KB
// in flight on every SM, and the 1408 (gate/up) or 2048 (down) tiles split
// over one CTA an SM within one tile of each other.
//
// Route 1, bf16 mma.sync (the kernel before this design, kept for what TMA
// cannot take: a dim, stride or base off 16 bytes, as in the ragged
// 3x5x37x19 case): one CTA per (F tile, C tile, expert),
// mma.sync.m16n8k16 on 128 x 128 tiles from a 3-stage ring of BK=32-deep
// tiles staged by element loads, A by ldmatrix and B by ldmatrix.trans
// from padded rows. Ragged C, D and F are zero-filled in shared memory
// and never stored.
//
// Route 0, fp32: the same CTA decomposition on the CUDA cores (64 x 64
// tiles, 4 x 4 outputs a thread, BK=16), the tensor cores having no
// full-fp32 product. It is the exactness path, not a fast one.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90
constexpr int BK = 32;            // depth of a k-step (mma.sync path)
constexpr int STAGES = 3;         // ring depth (mma.sync path)
constexpr int BM32 = 64, BN32 = 64, BK32 = 16, THREADS32 = 256;  // fp32 path

// The TMA kernels' tiles. The CPU tests' mirror of their plan reads these
// from this file: keep the form `constexpr int NAME = value;`
constexpr int TMA_BM = 256;     // rows of a prefill tile (2 warpgroups x 2 x 64)
constexpr int TMA_BN = 128;     // columns of F a prefill tile (wgmma N)
constexpr int WIDE_BM = 128;    // the wide prefill tile: rows (2 warpgroups x 64)
constexpr int WIDE_BN = 256;    // and columns of F (wgmma N)
constexpr int TMA_BK = 64;      // depth of a prefill k-step
constexpr int TMA_STAGES = 4;   // prefill ring
constexpr int DEC_ROWS = 16;    // the most rows the decode kernel takes (wgmma N)
constexpr int DEC_BN = 64;      // columns of F a decode tile (wgmma M)
constexpr int DEC_BK = 128;     // depth of a decode k-step
constexpr int DEC_STAGES = 8;   // decode ring
constexpr int PANEL = 64;       // bf16 columns of a 128-byte swizzled row

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
// route 1, bf16: mma.sync on the tensor cores
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

using MmaTile = Tile<128, 128, 2, 4>;

// Stage the k-step at depth k0 into one ring slot by element loads: x rows
// c0.. and w rows k0.., zeros past C, D and F.
template <class T>
__device__ __forceinline__ void stage(const Params& p, const bf16* x, const bf16* w, bf16* xs,
                                      bf16* ws, int c0, int n0, int k0) {
  constexpr int BM = T::BM_, BN = T::BN_;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < BM * BK; i += T::THREADS) {
    const int r = i / BK, k = i % BK;
    xs[r * T::LDX + k] = c0 + r < p.C && k0 + k < p.D ? x[(c0 + r) * p.x_sc + k0 + k] : zero;
  }
  for (int i = threadIdx.x; i < BK * BN; i += T::THREADS) {
    const int r = i / BN, n = i % BN;
    ws[r * T::LDW + n] = k0 + r < p.D && n0 + n < p.F ? w[(k0 + r) * p.w_sd + n0 + n] : zero;
  }
}

template <class T>
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
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < KT) stage<T>(p, x, w, xs + s * T::XS, ws + s * T::WS, c0, n0, s * BK);
  for (int kt = 0; kt < KT; ++kt) {
    __syncthreads();  // step kt is staged, and every warp is done with step kt - 1's slot
    const int nk = kt + STAGES - 1;
    if (nk < KT)
      stage<T>(p, x, w, xs + (nk % STAGES) * T::XS, ws + (nk % STAGES) * T::WS, c0, n0, nk * BK);

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
// route 0, fp32: CUDA cores
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
// routes 2 and 3, bf16: TMA, mbarriers, wgmma
// --------------------------------------------------------------------------- //
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// `count` arrivals at once
__device__ __forceinline__ void mbar_arrive(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of a 3-d tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// one box from shared memory to a 3-d tensor map; elements out of the
// tensor's bounds are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // at most N committed groups still in flight
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A shared-memory matrix descriptor for wgmma with the 128-byte swizzle:
// the start address and the leading and stride byte offsets, in bytes
// (the descriptor holds them in 16-byte units).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x 128, fp32) (+)= A (64 x 16, shared, K-major) * B (16 x 128,
// shared, MN-major); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128_bt(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 256, fp32: columns 0-127 in lo, 128-255 in hi) (+)= A (64 x 16,
// shared, K-major) * B (16 x 256, shared, MN-major); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n256_bt(float (&lo)[64], float (&hi)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(lo[0]), "+f"(lo[1]), "+f"(lo[2]), "+f"(lo[3]), "+f"(lo[4]), "+f"(lo[5]), "+f"(lo[6]), "+f"(lo[7]),
        "+f"(lo[8]), "+f"(lo[9]), "+f"(lo[10]), "+f"(lo[11]), "+f"(lo[12]), "+f"(lo[13]), "+f"(lo[14]), "+f"(lo[15]),
        "+f"(lo[16]), "+f"(lo[17]), "+f"(lo[18]), "+f"(lo[19]), "+f"(lo[20]), "+f"(lo[21]), "+f"(lo[22]), "+f"(lo[23]),
        "+f"(lo[24]), "+f"(lo[25]), "+f"(lo[26]), "+f"(lo[27]), "+f"(lo[28]), "+f"(lo[29]), "+f"(lo[30]), "+f"(lo[31]),
        "+f"(lo[32]), "+f"(lo[33]), "+f"(lo[34]), "+f"(lo[35]), "+f"(lo[36]), "+f"(lo[37]), "+f"(lo[38]), "+f"(lo[39]),
        "+f"(lo[40]), "+f"(lo[41]), "+f"(lo[42]), "+f"(lo[43]), "+f"(lo[44]), "+f"(lo[45]), "+f"(lo[46]), "+f"(lo[47]),
        "+f"(lo[48]), "+f"(lo[49]), "+f"(lo[50]), "+f"(lo[51]), "+f"(lo[52]), "+f"(lo[53]), "+f"(lo[54]), "+f"(lo[55]),
        "+f"(lo[56]), "+f"(lo[57]), "+f"(lo[58]), "+f"(lo[59]), "+f"(lo[60]), "+f"(lo[61]), "+f"(lo[62]), "+f"(lo[63]),
        "+f"(hi[0]), "+f"(hi[1]), "+f"(hi[2]), "+f"(hi[3]), "+f"(hi[4]), "+f"(hi[5]), "+f"(hi[6]), "+f"(hi[7]),
        "+f"(hi[8]), "+f"(hi[9]), "+f"(hi[10]), "+f"(hi[11]), "+f"(hi[12]), "+f"(hi[13]), "+f"(hi[14]), "+f"(hi[15]),
        "+f"(hi[16]), "+f"(hi[17]), "+f"(hi[18]), "+f"(hi[19]), "+f"(hi[20]), "+f"(hi[21]), "+f"(hi[22]), "+f"(hi[23]),
        "+f"(hi[24]), "+f"(hi[25]), "+f"(hi[26]), "+f"(hi[27]), "+f"(hi[28]), "+f"(hi[29]), "+f"(hi[30]), "+f"(hi[31]),
        "+f"(hi[32]), "+f"(hi[33]), "+f"(hi[34]), "+f"(hi[35]), "+f"(hi[36]), "+f"(hi[37]), "+f"(hi[38]), "+f"(hi[39]),
        "+f"(hi[40]), "+f"(hi[41]), "+f"(hi[42]), "+f"(hi[43]), "+f"(hi[44]), "+f"(hi[45]), "+f"(hi[46]), "+f"(hi[47]),
        "+f"(hi[48]), "+f"(hi[49]), "+f"(hi[50]), "+f"(hi[51]), "+f"(hi[52]), "+f"(hi[53]), "+f"(hi[54]), "+f"(hi[55]),
        "+f"(hi[56]), "+f"(hi[57]), "+f"(hi[58]), "+f"(hi[59]), "+f"(hi[60]), "+f"(hi[61]), "+f"(hi[62]), "+f"(hi[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 16, fp32) (+)= A (64 x 16, shared, MN-major) * B (16 x 16,
// shared, K-major); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n16_at(float (&d)[8], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The persistent walk of the TMA kernels: CTA blockIdx.x takes tiles
// blockIdx.x, + gridDim.x, ... of `tiles`. The decode kernel's tile t is
// (expert e, N tile n, M tile m), m fastest.
struct TileOf {
  int e, n, m;
  __device__ __forceinline__ TileOf(int t, int mt, int nt) {
    e = t / (mt * nt);
    const int r = t - e * mt * nt;
    n = r / mt;
    m = r - n * mt;
  }
};

struct TmaParams {
  void* out;
  int C, F;
  int KT;             // k-steps of a tile
  int MT, NT, tiles;  // M tiles and N tiles an expert; all tiles
  long long o_se, o_sc;
};


// route 2 (prefill)
constexpr int TMA_THREADS = 384;  // a producer warpgroup and two consumers
constexpr int TMA_X_BYTES = TMA_BM * 128;                         // one panel of 256 rows
constexpr int TMA_W_PANEL = TMA_BK * 128;                         // 64 rows of 64 columns
constexpr int TMA_STAGE_BYTES = TMA_X_BYTES + TMA_BN / PANEL * TMA_W_PANEL;
constexpr int TMA_OUT_BYTES = TMA_BN / PANEL * 64 * 128;  // a consumer's 64 x 128 output staging
constexpr int TMA_SMEM =
    1024 + TMA_STAGES * TMA_STAGE_BYTES + 2 * TMA_OUT_BYTES + 16 * TMA_STAGES;
static_assert(TMA_SMEM <= MAX_SMEM, "shared memory");
static_assert(2 * TMA_OUT_BYTES <= TMA_STAGE_BYTES && TMA_STAGES >= 3,
              "a stage holds both second output halves, and two others load meanwhile");
static_assert(TMA_BM == 256 && TMA_BN == 128 && TMA_BK == PANEL, "the wgmma tiling below");
static_assert(WIDE_BM == 128 && WIDE_BN == 256 &&
                  WIDE_BM * 128 + WIDE_BN / PANEL * TMA_W_PANEL == TMA_STAGE_BYTES,
              "the wide tile's stage is the tall tile's");

// The products of one k-step: consumer warpgroup rows xa of the x panel by
// the w stage at wb (64-column panels TMA_W_PANEL apart: the MN-major B's
// leading byte offset), a k16 step 32 bytes into each swizzled x row and
// 16 rows (2 KB) down the w panels. The tall tile: 128 rows, two 64-row A
// operands 8 KB apart, each by two panels (a0, a1: rows 0-63, 64-127);
// the wide tile: 64 rows by four panels (a0, a1: columns 0-127, 128-255).
// Issued and committed, not waited for.
template <bool FIRST, bool WIDE>
__device__ __forceinline__ void issue_prefill(float (&a0)[64], float (&a1)[64], uint32_t xa,
                                              uint32_t wb) {
  fence_regs(a0);
  fence_regs(a1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TMA_BK / 16; ++kk) {
    const uint64_t db = smem_desc(wb + kk * 2048, TMA_W_PANEL, 1024);
    const int scale = FIRST && kk == 0 ? 0 : 1;
    if (WIDE) {
      wgmma_m64n256_bt(a0, a1, smem_desc(xa + kk * 32, 16, 1024), db, scale);
    } else {
      wgmma_m64n128_bt(a0, smem_desc(xa + kk * 32, 16, 1024), db, scale);
      wgmma_m64n128_bt(a1, smem_desc(xa + 64 * 128 + kk * 32, 16, 1024), db, scale);
    }
  }
  wgmma_commit();
  fence_regs(a0);
  fence_regs(a1);
}

// 64 rows of a consumer's accumulator (rows 16 * warp + lane / 4 and + 8,
// columns 8j + 2 (lane % 4) and + 1), rounded once to bf16, into the
// output staging at stg: two 64-column panels of 64 rows, in the 128-byte
// swizzled layout that the TMA store reads
__device__ __forceinline__ void stage_out(const float (&a)[64], uint32_t stg, int warp, int lane) {
#pragma unroll
  for (int j = 0; j < TMA_BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * 16 + (lane >> 2) + h * 8;
      const int chunk = (j % 8) ^ (row & 7);  // 16-byte chunk, swizzled
      const uint32_t addr = stg + (j / 8) * 64 * 128 + row * 128 + chunk * 16 + (lane & 3) * 4;
      const uint32_t v = pack_bf16(a[4 * j + 2 * h], a[4 * j + 2 * h + 1]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
    }
}

// the wide kernel (WIDE_BM x WIDE_BN tiles) or the tall one (TMA_BM x TMA_BN)
template <bool WIDE>
__global__ void __launch_bounds__(TMA_THREADS, 1)
gmm_tma_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
              const __grid_constant__ CUtensorMap omap, const TmaParams p) {
  constexpr int BM = WIDE ? WIDE_BM : TMA_BM, BN = WIDE ? WIDE_BN : TMA_BN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: stages start on 1024
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // [STAGES][x | w panels]
  const uint32_t outs = ring + TMA_STAGES * TMA_STAGE_BYTES;   // [2][2 panels of 64 rows]
  const uint32_t full = outs + 2 * TMA_OUT_BYTES;              // [STAGES]
  const uint32_t empty = full + 8 * TMA_STAGES;                // [STAGES]

  // the warpgroup, broadcast from lane 0 so that ptxas sees it uniform: a
  // wgmma under a branch it cannot prove uniform is serialised
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < TMA_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const TileOf tile(t, p.MT, p.NT);
      for (int ks = 0; ks < p.KT; ++ks, ++it) {
        const int s = it % TMA_STAGES;
        mbar_wait(empty + 8 * s, ((it / TMA_STAGES) & 1) ^ 1);  // the first round passes
        const uint32_t st = ring + s * TMA_STAGE_BYTES;
        mbar_expect_tx(full + 8 * s, TMA_STAGE_BYTES);
        tma_load(st, &xmap, full + 8 * s, ks * TMA_BK, tile.m * BM, tile.e);
#pragma unroll
        for (int pn = 0; pn < BN / PANEL; ++pn)
          tma_load(st + BM * 128 + pn * TMA_W_PANEL, &wmap, full + 8 * s,
                   tile.n * BN + pn * PANEL, ks * TMA_BK, tile.e);
      }
    }
    return;
  }

  // consumer warpgroup w: rows w * BM / 2 .. (w + 1) * BM / 2 - 1 of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int w = wg - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  float a0[64], a1[64];
  int it = 0;
  // the stage that holds the last tile's second output half until its TMA
  // store has read it (-1: none), released for the whole warpgroup by one
  // thread once the next tile's first products are in flight
  int held = -1;
  auto release_held = [&] {
    if (tid == 0) {
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      mbar_arrive(empty + 8 * held, 128);
    }
    held = -1;
  };
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const TileOf tile(t, p.MT, p.NT);
    // the first k-step overwrites the accumulators; each later one is
    // issued before the one before it is waited for and released
    int s = it % TMA_STAGES;
    mbar_wait(full + 8 * s, (it / TMA_STAGES) & 1);
    issue_prefill<true, WIDE>(a0, a1, ring + s * TMA_STAGE_BYTES + w * (BM / 2) * 128,
                              ring + s * TMA_STAGE_BYTES + BM * 128);
    ++it;
    for (int ks = 1; ks < p.KT; ++ks, ++it) {
      const int prev = s;
      s = it % TMA_STAGES;
      mbar_wait(full + 8 * s, (it / TMA_STAGES) & 1);
      issue_prefill<false, WIDE>(a0, a1, ring + s * TMA_STAGE_BYTES + w * (BM / 2) * 128,
                                 ring + s * TMA_STAGE_BYTES + BM * 128);
      wgmma_wait<1>();
      fence_regs(a0);
      fence_regs(a1);
      mbar_arrive(empty + 8 * prev);
      if (held >= 0) release_held();
    }
    wgmma_wait<0>();
    fence_regs(a0);
    fence_regs(a1);
    if (held >= 0) release_held();  // a tile of one k-step

    // epilogue, a 64-row half at a time: the first through this
    // warpgroup's staging (once the last tile's store has read it), the
    // second through a quarter of this tile's last stage, which both
    // warpgroups' products have then left (bar 3), so that it need not
    // wait for the first's store; each filled, then stored with TMA (rows
    // past C and columns past F are not written), draining while the next
    // tile's products run
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
    auto store_half = [&](const float (&a)[64], uint32_t stg, bool reused, int row0, int col0) {
      if (reused) {
        if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
      }
      stage_out(a, stg, warp, lane);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
      if (tid == 0) {
#pragma unroll
        for (int pn = 0; pn < TMA_BN / PANEL; ++pn)
          tma_store(&omap, stg + pn * 64 * 128, col0 + pn * PANEL, row0, tile.e);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    };
    const uint32_t stg = outs + w * TMA_OUT_BYTES;
    const uint32_t spare = ring + s * TMA_STAGE_BYTES + w * TMA_OUT_BYTES;
    if (WIDE) {
      store_half(a0, stg, true, tile.m * BM + w * 64, tile.n * BN);
      store_half(a1, spare, false, tile.m * BM + w * 64, tile.n * BN + 128);
    } else {
      store_half(a0, stg, true, tile.m * BM + w * 128, tile.n * BN);
      store_half(a1, spare, false, tile.m * BM + w * 128 + 64, tile.n * BN);
    }
    held = s;
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// route 3 (decode)
constexpr int DEC_THREADS = 160;  // a consumer warpgroup and a producer warp
constexpr int DEC_W_BYTES = DEC_BK * 128;                // DEC_BK rows of 64 columns
constexpr int DEC_X_PANEL = DEC_ROWS * 128;              // DEC_ROWS rows of 64 columns
constexpr int DEC_STAGE_BYTES = DEC_W_BYTES + DEC_BK / PANEL * DEC_X_PANEL;
constexpr int DEC_SMEM = 1024 + DEC_STAGES * DEC_STAGE_BYTES + 16 * DEC_STAGES;
static_assert(DEC_SMEM <= MAX_SMEM, "shared memory");
static_assert(DEC_BN == 64 && DEC_ROWS == 16 && DEC_BK % PANEL == 0, "the wgmma tiling below");
static_assert(DEC_X_PANEL % 1024 == 0 && DEC_STAGE_BYTES % 1024 == 0, "swizzle alignment");

// The products of one decode k-step: out^T (64 columns of F x 16 rows)
// += w^T (the w stage at wb: DEC_BK rows of 64 columns, MN-major A, a k16
// step 16 rows = 2 KB down) x^T (the x stage at xb: DEC_BK / 64 panels of
// 16 rows, K-major B, a k16 step 32 bytes into each swizzled row).
template <bool FIRST>
__device__ __forceinline__ void issue_decode(float (&d)[8], uint32_t wb, uint32_t xb) {
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DEC_BK / 16; ++kk)
    wgmma_m64n16_at(d, smem_desc(wb + kk * 2048, DEC_W_BYTES, 1024),
                    smem_desc(xb + (kk / 4) * DEC_X_PANEL + (kk % 4) * 32, 16, 1024),
                    FIRST && kk == 0 ? 0 : 1);
  wgmma_commit();
  fence_regs(d);
}

__global__ void __launch_bounds__(DEC_THREADS, 1)
gmm_decode_tma_wgmma(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const TmaParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // [STAGES][w | x panels]
  const uint32_t full = ring + DEC_STAGES * DEC_STAGE_BYTES;   // [STAGES]
  const uint32_t empty = full + 8 * DEC_STAGES;                // [STAGES]

  // warps 0-3 the consumer warpgroup, warp 4 the producer (broadcast: see
  // gmm_tma_wgmma)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < DEC_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 1) {
    if (threadIdx.x != 128) return;
    int it = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const TileOf tile(t, 1, p.NT);
      for (int ks = 0; ks < p.KT; ++ks, ++it) {
        const int s = it % DEC_STAGES;
        mbar_wait(empty + 8 * s, ((it / DEC_STAGES) & 1) ^ 1);
        const uint32_t st = ring + s * DEC_STAGE_BYTES;
        mbar_expect_tx(full + 8 * s, DEC_STAGE_BYTES);
        tma_load(st, &wmap, full + 8 * s, tile.n * DEC_BN, ks * DEC_BK, tile.e);
#pragma unroll
        for (int pn = 0; pn < DEC_BK / PANEL; ++pn)
          tma_load(st + DEC_W_BYTES + pn * DEC_X_PANEL, &xmap, full + 8 * s,
                   ks * DEC_BK + pn * PANEL, 0, tile.e);
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float d[8];
  int it = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const TileOf tile(t, 1, p.NT);
    int s = it % DEC_STAGES;
    mbar_wait(full + 8 * s, (it / DEC_STAGES) & 1);
    issue_decode<true>(d, ring + s * DEC_STAGE_BYTES, ring + s * DEC_STAGE_BYTES + DEC_W_BYTES);
    ++it;
    for (int ks = 1; ks < p.KT; ++ks, ++it) {
      const int prev = s;
      s = it % DEC_STAGES;
      mbar_wait(full + 8 * s, (it / DEC_STAGES) & 1);
      issue_decode<false>(d, ring + s * DEC_STAGE_BYTES,
                          ring + s * DEC_STAGE_BYTES + DEC_W_BYTES);
      wgmma_wait<1>();
      fence_regs(d);
      mbar_arrive(empty + 8 * prev);
    }
    wgmma_wait<0>();
    fence_regs(d);
    mbar_arrive(empty + 8 * s);

    // d holds out^T: columns f0 and f0 + 8 of F (wgmma's rows), rows
    // 8j + c0 and 8j + c0 + 1 of x (its columns)
    bf16* out = static_cast<bf16*>(p.out) + tile.e * p.o_se;
    const int f0 = tile.n * DEC_BN + warp * 16 + (lane >> 2);
    const int c0 = (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int f = f0 + ((i >> 1) & 1) * 8;
      const int c = c0 + (i >> 2) * 8 + (i & 1);
      if (c < p.C && f < p.F) out[c * p.o_sc + f] = __float2bfloat16(d[i]);
    }
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A map over a bf16 tensor [n2, n1, n0] with element strides (s2, s1), the
// last dim contiguous; dims innermost first. A box is 64 columns of `rows`
// rows of one outer index, 128-byte swizzled in shared memory; what lies
// out of bounds reads as zeros.
bool make_map(CUtensorMap* map, const void* base, int n0, int n1, int n2, long long s1,
              long long s2, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)n0, (cuuint64_t)n1, (cuuint64_t)n2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1 * 2, (cuuint64_t)s2 * 2};
  const cuuint32_t box[3] = {PANEL, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// routes 2 (decode = false) and 3 (decode = true)
cudaError_t launch_tma(const Params& p, int E, int device, bool decode, cudaStream_t stream) {
  bool ok = p.D % 8 == 0 && p.F % 8 == 0 && aligned16(p.x) && aligned16(p.w) &&
            aligned16(p.out) && p.o_se % 8 == 0 && p.o_sc % 8 == 0 && (!decode || p.C <= DEC_ROWS);
  const long long strides[4] = {p.x_se, p.x_sc, p.w_se, p.w_sd};
  for (long long s : strides) ok = ok && s > 0 && s % 8 == 0;
  if (!ok) return cudaErrorInvalidValue;
  TmaParams tp;
  tp.out = p.out;
  tp.C = p.C;
  tp.F = p.F;
  tp.o_se = p.o_se;
  tp.o_sc = p.o_sc;
  tp.KT = (p.D + (decode ? DEC_BK : TMA_BK) - 1) / (decode ? DEC_BK : TMA_BK);
  int sms = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  CUtensorMap xm, wm, om;
  if (decode) {
    tp.MT = 1;
    tp.NT = (p.F + DEC_BN - 1) / DEC_BN;
    tp.tiles = E * tp.NT;
    if (!make_map(&xm, p.x, p.D, p.C, E, p.x_sc, p.x_se, DEC_ROWS) ||
        !make_map(&wm, p.w, p.F, p.D, E, p.w_sd, p.w_se, DEC_BK))
      return cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(gmm_decode_tma_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DEC_SMEM);
    if (e != cudaSuccess) return e;
    gmm_decode_tma_wgmma<<<tp.tiles < sms ? tp.tiles : sms, DEC_THREADS, DEC_SMEM, stream>>>(
        xm, wm, tp);
    return cudaGetLastError();
  }
  // prefill: the wide tile where padding C and F to whole tiles costs no
  // more products than the tall tile's padding
  const auto padded = [&](long long bm, long long bn) {
    return (p.C + bm - 1) / bm * bm * ((p.F + bn - 1) / bn * bn);
  };
  const bool wide = padded(WIDE_BM, WIDE_BN) <= padded(TMA_BM, TMA_BN);
  const int bm = wide ? WIDE_BM : TMA_BM, bn = wide ? WIDE_BN : TMA_BN;
  tp.MT = (p.C + bm - 1) / bm;
  tp.NT = (p.F + bn - 1) / bn;
  const long long tiles = (long long)E * tp.MT * tp.NT;
  if (tiles > 0x7fffffffLL || !make_map(&xm, p.x, p.D, p.C, E, p.x_sc, p.x_se, bm) ||
      !make_map(&wm, p.w, p.F, p.D, E, p.w_sd, p.w_se, TMA_BK) ||
      !make_map(&om, p.out, p.F, p.C, E, p.o_sc, p.o_se, 64))
    return cudaErrorInvalidValue;
  tp.tiles = (int)tiles;
  const auto kern = wide ? gmm_tma_wgmma<true> : gmm_tma_wgmma<false>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TMA_SMEM);
  if (e != cudaSuccess) return e;
  kern<<<tiles < sms ? tiles : sms, TMA_THREADS, TMA_SMEM, stream>>>(xm, wm, om, tp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [E,C,D] with element strides (x_se, x_sc); w [E,D,F] with (w_se,
// w_sd); out [E,C,F] with (o_se, o_sc); every last dim contiguous. route
// (chosen by the wrapper, moe_gmm.py `_route`): 0 = float32 on the CUDA
// cores, 1 = bfloat16 through mma.sync, 2 = bfloat16 through TMA and wgmma
// (prefill), 3 = the same for at most DEC_ROWS rows (decode); 2 and 3 take
// D and F multiples of 8, every stride a positive multiple of 8 elements
// and every base 16-byte aligned. x, w and out share the route's dtype.
// Returns a cudaError_t (0 on success).
int repro_moe_gmm(int device, int route, const void* x, const void* w, void* out, int E, int C,
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
  switch (route) {
    case 0: return launch(gmm_f32, p, E, BM32, BN32, THREADS32, 0, st);
    case 1:
      return launch(gmm_bf16<MmaTile>, p, E, MmaTile::BM_, MmaTile::BN_, MmaTile::THREADS,
                    MmaTile::SMEM, st);
    case 2: return launch_tma(p, E, device, false, st);
    case 3: return launch_tma(p, E, device, true, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
