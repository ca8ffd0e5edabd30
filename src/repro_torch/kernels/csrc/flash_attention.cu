// K2 on Hopper: blocked GQA attention forward (prefill), causal,
// sliding-window or bidirectional.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:88
// flash_attention_fwd (Pallas body `_kernel` at :27, pallas_call at :119).
// Oracle: src/repro/kernels/ref.py::flash_attention_ref, ported as
// src/repro_torch/kernels/ref.py::flash_attention_ref.
//
// What it computes. For batch row b, query head h = kv*G + g, query i and
// key j (positions are the indices, 0-based):
//   out[b,i,h] = sum_j softmax_j(scale * q[b,i,h] . k[b,j,kv]) v[b,j,kv]
// over the keys j < Sk with i >= j (causal) and i - j < window (with a
// window; it applies in bidirectional mode too, as in the Pallas kernel).
// scale = D^-0.5; a masked score is -1e30; the softmax runs online in fp32
// (running max m, sum l, accumulator acc) and the output is
// acc / max(l, 1e-30) in q's dtype, so a row with no valid key is 0.
//
// What bounds it: operations. 4*B*H*D flops an unmasked (query, key) pair
// against the bytes of q, k, v and the output read or written once, bf16
// on 989 TFLOP/s and 3.35 TB/s:
//   smollm-360m   B=4 S=2048 H=15 KV=5 D=64 causal     32.6 us (12.5 us of bytes)
//   hubert-xlarge B=4 S=1024 H=KV=16 D=80 bidir        21.7 us (12.5 us)
//   deepseek-moe  B=4 S=2048 H=KV=16 D=128 causal      69.5 us (40.1 us)
//   recurrentgemma B=4 S=2048 H=16 KV=1 D=256 causal   139.0 us (42.6 us)
//   a long row    B=1 S=32768 H=15 KV=5 D=64 causal    2085 us (50.1 us)
// so the bf16 path is built around the tensor cores' rate.
//
// bf16 design (route 2: TMA, mbarriers, wgmma, warp specialisation):
// * A CTA is one producer warpgroup and NC consumer warpgroups (NC = 3 at
//   D <= 64, 2 above). Each consumer warpgroup owns 64 query rows of one
//   query head, the M of wgmma. The CTA's warpgroups share one KV head's
//   K/V tiles: gc = gcd(G, NC) heads of the GQA group at the same 64
//   queries (smollm-360m G = 3: its three heads; recurrentgemma G = 16: two
//   heads), times NC / gc consecutive blocks of 64 queries of each (G = 1,
//   hubert and deepseek: 128 queries of one head). Heads of one group at
//   the same queries see the same causal or window tiles, so their
//   warpgroups stay in step. Causal calls launch the CTAs with the longest
//   rows first across all heads and rows; bidirectional ones launch a
//   head's CTAs together, to share its K/V in L2.
// * Loads: one thread of the producer issues cp.async.bulk.tensor (TMA)
//   from 4-d tensor maps over the model layout, q [B,S,H,D] and k, v
//   [B,T,KV,D], read through their strides (no transposed copy), into
//   128-byte swizzled panels of 64 columns: Q once, then K and V tiles of
//   BK keys (128 at D <= 128, 64 at D = 256) into two rings of STAGES
//   stages (3; 2 at D = 256), each stage with a full mbarrier (TMA's byte
//   count) and an empty one (every consumer thread arrives). K is released
//   as soon as S is computed, V a tile later, after P V. Rows past Sq and
//   Sk and columns past D arrive as TMA's zeros. The producer warpgroup
//   gives its registers to the consumers (setmaxnreg: 24 against 160 at
//   NC = 3, 240 at NC = 2).
// * S = Q K^T: wgmma.m64nBKk16, Q and K both K-major from shared memory,
//   a k-step 16 columns into the swizzled row. Motivation 1: the old
//   kernel's warps each re-read the whole K and V tile with ldmatrix for
//   16 rows; wgmma reads its B operand once for 64 rows.
// * Softmax in registers, fp32: p = 2^(s * scale*log2e - m * scale*log2e),
//   one FMA and ex2 a score (Motivation 3: one multiply, not two). Only a
//   tile that the causal diagonal, a window edge or Sk crosses evaluates
//   the mask (Motivation 2); each warpgroup runs only over the tiles that
//   the diagonal and window leave live for its rows (the Pallas kernel's
//   `pl.when` skip) and only waits for and releases the others.
// * O += P V: wgmma with P rounded once to bf16 in registers as the A
//   operand (as the TPU's default-precision dot rounds it) and V as the
//   MN-major B operand, one wgmma of N = DP a 16-key k-step (its columns
//   run across the 64-column panels by the descriptor's leading byte
//   offset).
// * Overlap (Motivation 4: the old two-buffer cp.async ring stalled every
//   warp on every load behind two block-wide barriers). Loads come from a
//   warp that does nothing else, and a warpgroup waits only on the
//   mbarrier of the tile it needs. Within a warpgroup, tile t's S and tile
//   t-1's P V are issued together and S_t's softmax runs while P_{t-1} V
//   is on the tensor cores (the first tile is peeled off the loop: ptxas
//   serialises every wgmma when their issue or waits are conditional, and
//   so the warpgroup index is broadcast with __shfl_sync for ptxas to see
//   it uniform). Across warpgroups, named barriers hand round a turn to
//   issue a tile's products, so one warpgroup's softmax runs while
//   another's products keep the tensor cores busy (FA3's ping-pong).
// * Motivation 5: at D = 256 Q stays in shared memory as wgmma's A
//   operand (read by the tensor cores, never re-staged) and K/V tiles are
//   64 keys.
// * Epilogue: O / l in fp32, rounded once to bf16 into the warpgroup's Q
//   tile (free after its last product), then one TMA store a panel in the
//   model layout; rows past Sq and columns past D are not written.
// * Head dims: the kernel is built for DP = 64, 80, 128 and 256 and takes
//   any D that is a multiple of 8 up to DP (D < 64 runs at DP = 64 on
//   TMA's zero columns: no main path has it, and instantiations at 16 and
//   32 spilled). D = 80 (hubert) is two panels, the second holding 16
//   real columns and 48 of TMA's zeros: the products do no padded work (S
//   takes 5 k-steps of 16 columns, P V is a wgmma of N = 80), only shared
//   memory holds the pad (37.5% of the Q, K and V tiles). Registers a consumer thread: the
//   accumulator of 64 rows x DP is DP/2, the scores BK/2 and the previous
//   tile's P BK/4; ptxas reports no spill at any DP.
//
// Route 1, mma.sync (the bf16 kernel before this design, kept for what TMA
// cannot take): a row or head stride that is not a multiple of 16 bytes
// (the smoke configs' D = 20) or a base that is not 16-byte aligned. One
// CTA per (block of queries, KV head, batch row) with the group's heads
// packed in M, each warp 16 rows through mma.sync.m16n8k16, K/V
// double-buffered in shared memory by element loads, D padded there to a
// multiple of 16; D <= 128 or D = 256 (32-key tiles, Q re-read from shared
// memory at each tile).
//
// Route 0, fp32: the same CTA decomposition on the CUDA cores (the tensor
// cores have no full-fp32 product), scores and accumulator in shared
// memory as in K1. It is the exactness path, not a fast one.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90
constexpr int BK32 = 32;          // keys a tile (fp32 path)
constexpr int THREADS32 = 256;    // fp32 path

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int Sq, Sk, D, G;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window;  // window < 0: none
  float scale;
  int gc;  // query heads of the group that one CTA holds
  int bq;  // queries of each head that one CTA holds
};

// (P: Params or TmaParams)
template <typename P>
__device__ __forceinline__ bool valid(const P& p, int qp, int kp) {
  return kp < p.Sk && (!p.causal || qp >= kp) && (p.window < 0 || qp - kp < p.window);
}

// The keys [lo, hi) that queries [qlo, qhi] can see.
template <typename P>
__device__ __forceinline__ void kv_range(const P& p, int qlo, int qhi, int& lo, int& hi) {
  hi = p.causal ? min(p.Sk, qhi + 1) : p.Sk;
  lo = p.window >= 0 ? max(0, qlo - (p.window - 1)) : 0;
}

// CTA coordinates shared by both paths.
struct Cta {
  int q0, kvh, g0, b;
};

__device__ __forceinline__ Cta cta(const Params& p) {
  Cta c;
  c.q0 = (gridDim.x - 1 - blockIdx.x) * p.bq;  // longest causal rows first
  const int chunks = p.G / p.gc;
  c.kvh = blockIdx.y / chunks;
  c.g0 = (blockIdx.y % chunks) * p.gc;
  c.b = blockIdx.z;
  return c;
}

// --------------------------------------------------------------------------- //
// bf16: mma.sync on the tensor cores
// --------------------------------------------------------------------------- //
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage `rows` rows of DP bf16 into shared memory (row stride LD) by element
// loads (this kernel takes the calls whose rows are not 16-byte aligned),
// columns >= D and rows whose pointer is null as zeros.
template <int DP, int LD, typename RowPtr>
__device__ __forceinline__ void stage(bf16* dst, int rows, int D, RowPtr row_ptr) {
  for (int i = threadIdx.x; i < rows * DP; i += blockDim.x) {
    const int r = i / DP;
    const int c = i - r * DP;
    const bf16* src = row_ptr(r);
    dst[r * LD + c] = (src != nullptr && c < D) ? src[c] : __float2bfloat16(0.f);
  }
}

template <int DP>
struct Bf16Cfg {
  static constexpr int LD = DP + 8;          // padded row: conflict-free ldmatrix
  static constexpr int MAXW = DP <= 64 ? 12 : 8;  // warps a CTA (register budget)
  static constexpr bool QREG = DP <= 128;    // Q fragments held in registers
  static constexpr int BK = DP <= 128 ? 64 : 32;  // keys a K/V tile
};

template <int DP>
__global__ void __launch_bounds__(32 * Bf16Cfg<DP>::MAXW)
flash_fwd_bf16(const Params p) {
  constexpr int LD = Bf16Cfg<DP>::LD;
  constexpr bool QREG = Bf16Cfg<DP>::QREG;
  constexpr int BK = Bf16Cfg<DP>::BK;
  constexpr int KT = DP / 16;  // k-steps of Q K^T
  constexpr int NT = DP / 8;   // n-tiles of the output
  constexpr int ST = BK / 8;   // n-tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int M = p.gc * p.bq;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [M][LD]
  bf16* ks = qs + M * LD;                         // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                    // [2][BK][LD]

  const Cta c = cta(p);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bf16* q = static_cast<const bf16*>(p.q) + c.b * p.q_sb;
  const bf16* k = static_cast<const bf16*>(p.k) + c.b * p.k_sb + c.kvh * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + c.b * p.v_sb + c.kvh * p.v_sh;
  const int head0 = c.kvh * p.G + c.g0;

  // rows r = g * bq + i hold query q0 + i of head head0 + g
  stage<DP, LD>(qs, M, p.D, [&](int r) -> const bf16* {
    const int g = r / p.bq;
    const int qp = c.q0 + (r - g * p.bq);
    return qp < p.Sq ? q + qp * p.q_ss + (head0 + g) * p.q_sh : nullptr;
  });

  int lo, hi;
  kv_range(p, c.q0, min(c.q0 + p.bq, p.Sq) - 1, lo, hi);
  const int t_begin = lo / BK;
  const int t_end = hi > lo ? (hi + BK - 1) / BK : t_begin;
  auto load_kv = [&](int t, int buf) {
    const int kv0 = t * BK;
    stage<DP, LD>(ks + buf * BK * LD, BK, p.D, [&](int r) -> const bf16* {
      return kv0 + r < p.Sk ? k + (kv0 + r) * p.k_ss : nullptr;
    });
    stage<DP, LD>(vs + buf * BK * LD, BK, p.D, [&](int r) -> const bf16* {
      return kv0 + r < p.Sk ? v + (kv0 + r) * p.v_ss : nullptr;
    });
  };
  if (t_begin < t_end) load_kv(t_begin, 0);
  __syncthreads();

  // this warp's 16 rows: one head, queries wq0 .. wq0 + 15
  const int wrow = warp * 16;
  const int wg = wrow / p.bq;
  const int wq0 = c.q0 + (wrow - wg * p.bq);
  const bf16* qrow_s = qs + (wrow + (lane & 15)) * LD + (lane >> 4) * 8;
  uint32_t qf[QREG ? KT : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) ldmatrix_x4(qf[kt], qrow_s + kt * 16);
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {NEG, NEG};
  float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int c0 = (lane & 3) * 2;
  const int qrow[2] = {wq0 + (lane >> 2), wq0 + (lane >> 2) + 8};

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) load_kv(t + 1, buf ^ 1);
    __syncthreads();

    const int kv0 = t * BK;
    bool live = true;
    if (p.causal) live = kv0 <= wq0 + 15;
    if (p.window >= 0) live = live && kv0 + BK - 1 >= wq0 - (p.window - 1);
    if (live) {
      const bf16* kb = ks + buf * BK * LD;
      const bf16* vb = vs + buf * BK * LD;
      float s[ST][4];
#pragma unroll
      for (int j = 0; j < ST; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t qa[4];
        if constexpr (QREG) {
          qa[0] = qf[kt][0], qa[1] = qf[kt][1], qa[2] = qf[kt][2], qa[3] = qf[kt][3];
        } else {
          ldmatrix_x4(qa, qrow_s + kt * 16);
        }
#pragma unroll
        for (int np = 0; np < ST / 2; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kb + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kt * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qa, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
        }
      }
      // scale and mask; row maxima over the tile
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = valid(p, qrow[e >> 1], kv0 + j * 8 + c0 + (e & 1)) ? s[j][e] * p.scale
                                                                             : NEG;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_r[i], mx[i]);
        corr[i] = exp2f((m_r[i] - m_new) * LOG2E);
        m_r[i] = m_new;
        l_r[i] *= corr[i];
      }
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float pv = valid(p, qrow[i], kv0 + j * 8 + c0 + (e & 1))
                               ? exp2f((s[j][e] - m_r[i]) * LOG2E)
                               : 0.f;
          s[j][e] = pv;
          l_r[i] += pv;
        }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
      // O += P V: the score accumulators of two n-tiles are the A fragment
      // of one 16-key k-step
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dn = 0; dn < DP / 16; ++dn) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                    dn * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dn], a, bv[0], bv[1]);
          mma_bf16(o[2 * dn + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // the buffer is free for tile t + 2
  }

  bf16* out = static_cast<bf16*>(p.out) + c.b * p.o_sb + (head0 + wg) * p.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    if (qrow[i] >= p.Sq) continue;
    bf16* orow = out + qrow[i] * p.o_ss;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = n * 8 + c0;
      const float x0 = o[n][2 * i] / l;
      const float x1 = o[n][2 * i + 1] / l;
      if (d + 1 < p.D && (p.D & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < p.D) orow[d] = __float2bfloat16(x0);
        if (d + 1 < p.D) orow[d + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// --------------------------------------------------------------------------- //
// fp32: CUDA cores
// --------------------------------------------------------------------------- //
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ __forceinline__ size_t f32_smem_floats(int M, int D) {
  const int ds = D | 1;  // odd row stride: lanes on consecutive rows hit distinct banks
  return 2 * (size_t)M * D           // q (scaled), acc
         + 2 * (size_t)BK32 * ds     // K tile, V tile
         + (size_t)M * BK32          // scores, then probabilities
         + 3 * (size_t)M;            // m, l, corr
}

__global__ void __launch_bounds__(THREADS32) flash_fwd_f32(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D;
  const int ds = D | 1;
  const int M = p.gc * p.bq;
  float* qs = reinterpret_cast<float*>(smem_raw);  // [M][D]
  float* acc = qs + M * D;                          // [M][D]
  float* kt = acc + M * D;                          // [BK32][ds]
  float* vt = kt + BK32 * ds;                       // [BK32][ds]
  float* s = vt + BK32 * ds;                        // [M][BK32]
  float* m = s + M * BK32;                          // [M]
  float* l = m + M;                                 // [M]
  float* corr = l + M;                              // [M]

  const Cta c = cta(p);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int NWARPS = THREADS32 / 32;
  const float* q = static_cast<const float*>(p.q) + c.b * p.q_sb;
  const float* k = static_cast<const float*>(p.k) + c.b * p.k_sb + c.kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + c.b * p.v_sb + c.kvh * p.v_sh;
  const int head0 = c.kvh * p.G + c.g0;

  for (int i = tid; i < M * D; i += THREADS32) {
    const int r = i / D;
    const int d = i - r * D;
    const int g = r / p.bq;
    const int qp = c.q0 + (r - g * p.bq);
    qs[i] = qp < p.Sq ? q[qp * p.q_ss + (head0 + g) * p.q_sh + d] * p.scale : 0.f;
    acc[i] = 0.f;
  }
  for (int r = tid; r < M; r += THREADS32) {
    m[r] = NEG;
    l[r] = 0.f;
  }

  int lo, hi;
  kv_range(p, c.q0, min(c.q0 + p.bq, p.Sq) - 1, lo, hi);
  for (int kv0 = lo / BK32 * BK32; kv0 < hi; kv0 += BK32) {
    for (int i = tid; i < BK32 * D; i += THREADS32) {
      const int j = i / D;
      const int d = i - j * D;
      const bool in = kv0 + j < p.Sk;
      kt[j * ds + d] = in ? k[(kv0 + j) * p.k_ss + d] : 0.f;
      vt[j * ds + d] = in ? v[(kv0 + j) * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < M * BK32; i += THREADS32) {
      const int r = i / BK32;
      const int j = i - r * BK32;
      const int qp = c.q0 + r % p.bq;
      float sc = NEG;
      if (valid(p, qp, kv0 + j)) {
        const float* qr = qs + r * D;
        const float* kr = kt + j * ds;
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
        sc = a;
      }
      s[i] = sc;
    }
    __syncthreads();

    // online softmax, one warp a row, one lane a key: s becomes p
    for (int r = warp; r < M; r += NWARPS) {
      const int qp = c.q0 + r % p.bq;
      const float x = s[r * BK32 + lane];
      const float m_new = fmaxf(m[r], warp_max(x));
      const float pv = valid(p, qp, kv0 + lane) ? expf(x - m_new) : 0.f;
      s[r * BK32 + lane] = pv;
      const float sum = warp_sum(pv);
      if (lane == 0) {
        const float cr = expf(m[r] - m_new);
        corr[r] = cr;
        l[r] = l[r] * cr + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < M * D; i += THREADS32) {
      const int r = i / D;
      const int d = i - r * D;
      const float* pr = s + r * BK32;
      float a = acc[i] * corr[r];
      for (int j = 0; j < BK32; ++j) a = fmaf(pr[j], vt[j * ds + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  float* out = static_cast<float*>(p.out) + c.b * p.o_sb;
  for (int i = tid; i < M * D; i += THREADS32) {
    const int r = i / D;
    const int d = i - r * D;
    const int g = r / p.bq;
    const int qp = c.q0 + (r - g * p.bq);
    if (qp < p.Sq) out[qp * p.o_ss + (head0 + g) * p.o_sh + d] = acc[i] / fmaxf(l[r], 1e-30f);
  }
}

// --------------------------------------------------------------------------- //
// bf16 on Hopper: TMA, mbarriers, wgmma, a producer warp and consumer
// warpgroups
// --------------------------------------------------------------------------- //
// TMA_BQ, TMA_BK, TMA_BK_D256, TMA_WG_D64 and TMA_WG are read from this file
// by the CPU tests' mirror of the tile plan: keep the form
// `constexpr int NAME = value;`
constexpr int TMA_BQ = 64;       // query rows of a consumer warpgroup (wgmma M)
constexpr int TMA_BK = 128;      // keys of a K/V tile, D <= 128
constexpr int TMA_BK_D256 = 64;  // keys of a K/V tile, D = 256
constexpr int TMA_WG_D64 = 3;    // consumer warpgroups, D <= 64
constexpr int TMA_WG = 2;        // consumer warpgroups, D > 64
constexpr int PANEL = 64;        // bf16 columns of a 128-byte swizzled row

// DP: the head dim the kernel is built for (64, 80, 128 or 256); D <= DP,
// and the columns past D arrive as TMA's zeros.
template <int DP>
struct TmaCfg {
  static constexpr int NP = (DP + PANEL - 1) / PANEL;  // 64-column panels
  static constexpr int NC = DP <= 64 ? TMA_WG_D64 : TMA_WG;
  static constexpr int BK = DP <= 128 ? TMA_BK : TMA_BK_D256;
  static constexpr int STAGES = DP <= 128 ? 3 : 2;  // K/V ring
  static constexpr int THREADS = 128 * (NC + 1);
  // registers a thread: the producer warpgroup gives back what the
  // consumers take (65,536 a CTA, one CTA an SM)
  static constexpr int REG_PRODUCER = 24;
  static constexpr int REG_CONSUMER = NC == 3 ? 160 : 240;
  static constexpr int Q_BYTES = TMA_BQ * 128 * NP;  // one warpgroup's Q tile
  static constexpr int KV_BYTES = BK * 128 * NP;     // one K (or V) tile
  static constexpr int SMEM = 1024 + NC * Q_BYTES + STAGES * 2 * KV_BYTES +
                              8 * (1 + 4 * STAGES);
  static_assert(DP == 64 || DP == 80 || DP == 128 || DP == 256, "head dim");
  static_assert(SMEM <= MAX_SMEM, "shared memory");
  static_assert(REG_PRODUCER * 128 + REG_CONSUMER * 128 * NC <= 65536, "registers");
};

struct TmaParams {
  int Sq, Sk, G, gc;  // gc: heads of the group a CTA holds
  int causal, window;
  float scale_log2;   // D^-0.5 * log2(e)
};

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

// one box of a 4-d tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box from shared memory to a 4-d tensor map; elements out of the
// tensor's bounds are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
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

// d (64 x N, fp32) (+)= A (64 x 16, shared, K-major) * B (16 x N, shared,
// K-major); scale_d = 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
// d (64 x N, fp32) += A (64 x 16 bf16, registers) * B (16 x N, shared,
// MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// keeps registers that an in-flight wgmma reads allocated until here
template <int K>
__device__ __forceinline__ void keep_live(const uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    asm volatile("" ::"r"(a[k][0]), "r"(a[k][1]), "r"(a[k][2]), "r"(a[k][3]));
}

// S = Q K^T of one tile into sc, issued and committed (not waited for): Q
// (64 rows) and K (BK keys) K-major, a k-step 16 columns (32 bytes) into a
// 128-byte swizzled row
template <int DP>
__device__ __forceinline__ void issue_qk(float (&sc)[TmaCfg<DP>::BK / 2], uint32_t qs,
                                         uint32_t ks) {
  constexpr int BK = TmaCfg<DP>::BK;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss<BK>(sc, smem_desc(qs + (kk / 4) * TMA_BQ * 128 + off, 16, 1024),
                 smem_desc(ks + (kk / 4) * BK * 128 + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
  fence_regs(sc);
}

// O (64 x DP) += P (64 x BK, bf16 registers) V (BK x DP, the V tile at
// vs), issued and committed (not waited for). V is the MN-major B operand:
// one wgmma of N = DP a k-step of 16 keys (two 8-row groups 1024 bytes
// apart), its columns running across the 64-column panels, which lie
// BK * 128 bytes apart (the leading byte offset).
template <int DP, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2], const uint32_t (&pa)[BK / 16][4],
                                         uint32_t vs) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<DP>(o, pa[kk], smem_desc(vs + kk * 2048, BK * 128, 1024));
  wgmma_commit();
  fence_regs(o);
}

// a consumer thread's rows: row0 and row0 + 8 (scores at columns 8j + c0,
// 8j + c0 + 1); its warpgroup's rows qa..qb
struct Rows {
  int row0, c0, qa, qb;
};

// The online softmax of one tile's raw scores sc (keys from k0), in place:
// sc becomes p = exp(scale * (s - m)), one FMA and ex2 a score; m_r and
// l_r move to the tile; corr is what O is to be scaled by. Only a tile that
// the causal diagonal, the window's edge or Sk crosses evaluates the mask,
// and a masked pair's p is 0.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], const TmaParams& p, int k0,
                                             const Rows& r, float (&m_r)[2], float (&l_r)[2],
                                             float (&corr)[2]) {
  const bool edge = !(k0 + BK <= p.Sk && (!p.causal || k0 + BK - 1 <= r.qa) &&
                      (p.window < 0 || r.qb - k0 < p.window));
  float mx[2] = {NEG, NEG};
  if (edge) {
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int key = k0 + (e >> 2) * 8 + r.c0 + (e & 1);
      if (!valid(p, r.row0 + ((e >> 1) & 1) * 8, key)) sc[e] = NEG;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
  }
  float mc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m_r[h], mx[h]);
    corr[h] = ex2((m_r[h] - m_new) * p.scale_log2);
    m_r[h] = m_new;
    mc[h] = m_new * p.scale_log2;
    l_r[h] *= corr[h];
  }
  if (edge) {
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int key = k0 + (e >> 2) * 8 + r.c0 + (e & 1);
      const int h = (e >> 1) & 1;
      sc[e] = valid(p, r.row0 + h * 8, key) ? ex2(fmaf(sc[e], p.scale_log2, -mc[h])) : 0.f;
      l_r[h] += sc[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int h = (e >> 1) & 1;
      sc[e] = ex2(fmaf(sc[e], p.scale_log2, -mc[h]));
      l_r[h] += sc[e];
    }
  }
}

// P rounded once to bf16 (as the TPU's default-precision dot rounds it):
// the score accumulators of two 8-key column tiles make one 16-key k-step
// of wgmma's A operand
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4], const float (&sc)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int DP>
__global__ void __launch_bounds__(TmaCfg<DP>::THREADS, 1)
flash_fwd_tma_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap, const TmaParams p) {
  using C = TmaCfg<DP>;
  constexpr int BK = C::BK;
  constexpr int NP = C::NP;
  constexpr int STAGES = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on 1024
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;  // [NC][NP][BQ][128 B]
  const uint32_t k_s = q_s + C::NC * C::Q_BYTES;              // [STAGES][NP][BK][128 B]
  const uint32_t v_s = k_s + STAGES * C::KV_BYTES;            // [STAGES][NP][BK][128 B]
  // mbarriers: Q; then a full and an empty one a stage of each of the K
  // and V rings (V is released a tile later than K, after P V)
  const uint32_t q_full = v_s + STAGES * C::KV_BYTES;
  const uint32_t k_full = q_full + 8;              // [STAGES]
  const uint32_t k_empty = k_full + 8 * STAGES;    // [STAGES]
  const uint32_t v_full = k_empty + 8 * STAGES;    // [STAGES]
  const uint32_t v_empty = v_full + 8 * STAGES;    // [STAGES]

  // this CTA: gc heads of one KV head's group times nqb blocks of BQ
  // queries, one (head, block) a consumer warpgroup
  // Causal: the query block is the slowest grid index, reversed, so the
  // CTAs with the longest rows start first across every head and batch
  // row. Otherwise it is the fastest: a head's CTAs run together and share
  // its K/V in L2.
  const int nqb = C::NC / p.gc;
  const int qblk = p.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.x;
  const int hblk = p.causal ? blockIdx.x : blockIdx.y;
  const int q0 = qblk * nqb * TMA_BQ;
  const int chunks = p.G / p.gc;
  const int kvh = hblk / chunks;
  const int head0 = kvh * p.G + (hblk % chunks) * p.gc;
  const int b = p.causal ? blockIdx.y : blockIdx.z;
  // the key tiles that any row of the CTA can see: the producer streams
  // these, and every consumer waits for and releases each of them
  int lo, hi;
  kv_range(p, q0, min(q0 + nqb * TMA_BQ, p.Sq) - 1, lo, hi);
  const int t_begin = lo / BK;
  const int t_end = hi > lo ? (hi + BK - 1) / BK : t_begin;

  // the warpgroup, broadcast from lane 0 so that ptxas sees it uniform: a
  // wgmma under a branch it cannot prove uniform is serialised
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 128 * C::NC);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, 128 * C::NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load; the warpgroup's registers go
    // to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::REG_PRODUCER));
    if (threadIdx.x != 0) return;
    mbar_expect_tx(q_full, C::NC * C::Q_BYTES);
    for (int w = 0; w < C::NC; ++w)
      for (int pn = 0; pn < NP; ++pn)
        tma_load(q_s + w * C::Q_BYTES + pn * TMA_BQ * 128, &qmap, q_full, pn * PANEL,
                 head0 + w % p.gc, q0 + (w / p.gc) * TMA_BQ, b);
    for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
      const int s = i % STAGES;
      const uint32_t ph = ((i / STAGES) & 1) ^ 1;  // the first round passes at once
      mbar_wait(k_empty + 8 * s, ph);
      mbar_expect_tx(k_full + 8 * s, C::KV_BYTES);
      for (int pn = 0; pn < NP; ++pn)
        tma_load(k_s + s * C::KV_BYTES + pn * BK * 128, &kmap, k_full + 8 * s, pn * PANEL, kvh,
                 t * BK, b);
      mbar_wait(v_empty + 8 * s, ph);
      mbar_expect_tx(v_full + 8 * s, C::KV_BYTES);
      for (int pn = 0; pn < NP; ++pn)
        tma_load(v_s + s * C::KV_BYTES + pn * BK * 128, &vmap, v_full + 8 * s, pn * PANEL, kvh,
                 t * BK, b);
    }
    return;
  }

  // consumer warpgroup w: BQ queries from qw0 of one head
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::REG_CONSUMER));
  const int w = wg - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int head = head0 + w % p.gc;
  const int qw0 = q0 + (w / p.gc) * TMA_BQ;
  Rows r;
  r.qa = qw0;                          // first row
  r.qb = min(qw0 + TMA_BQ, p.Sq) - 1;  // last row (< qa: none)
  // accumulator layout (wgmma, as mma.sync's m16n8 per warp): this thread
  // holds rows row0 and row0 + 8, columns 8j + c0 and 8j + c0 + 1
  r.row0 = qw0 + warp * 16 + (lane >> 2);
  r.c0 = (lane & 3) * 2;
  // the tiles these rows see, [lt0, lt1): a contiguous part of the CTA's
  int lt0 = t_end, lt1 = t_end;
  if (r.qb >= r.qa) {
    int wlo, whi;
    kv_range(p, r.qa, r.qb, wlo, whi);
    if (whi > wlo) lt0 = wlo / BK, lt1 = (whi + BK - 1) / BK;
  }
  const uint32_t qw_s = q_s + w * C::Q_BYTES;
  // The consumer warpgroups take turns, round robin, to issue a tile's
  // products (named barrier 4 + w is this warpgroup's turn), so that one
  // warpgroup's softmax runs while another's products keep the tensor
  // cores busy. Every warpgroup takes one turn a tile of the CTA's range.
  auto turn_wait = [&] {
    asm volatile("bar.sync %0, %1;\n" ::"r"(4 + w), "n"(128 * C::NC) : "memory");
  };
  auto turn_pass = [&] {
#pragma unroll
    for (int k = 1; k < C::NC; ++k)
      asm volatile("bar.arrive %0, %1;\n" ::"r"(4 + (w + k) % C::NC), "n"(128 * C::NC)
                   : "memory");
  };
  // a tile that no row here sees is only waited for, its turn passed on,
  // and released
  auto skip = [&](int t) {
    const int i = t - t_begin;
    mbar_wait(k_full + 8 * (i % STAGES), (i / STAGES) & 1);
    mbar_wait(v_full + 8 * (i % STAGES), (i / STAGES) & 1);
    turn_wait();
    turn_pass();
    mbar_arrive(k_empty + 8 * (i % STAGES));
    mbar_arrive(v_empty + 8 * (i % STAGES));
  };

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_r[2] = {NEG, NEG};  // running max of the raw scores
  float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
  float corr[2];              // O's rescale to the last tile's max
  uint32_t pa[BK / 16][4];    // P of the last tile, bf16: wgmma's A

  // warpgroup 0 takes the first turn
  for (int k = 0; k < w; ++k)
    asm volatile("bar.arrive %0, %1;\n" ::"r"(4 + k), "n"(128 * C::NC) : "memory");
  mbar_wait(q_full, 0);
  for (int t = t_begin; t < lt0; ++t) skip(t);
  if (lt0 < lt1) {
    // the first tile: S, then its softmax
    int s = (lt0 - t_begin) % STAGES;
    uint32_t ph = ((lt0 - t_begin) / STAGES) & 1;
    {
      float sc[BK / 2];
      mbar_wait(k_full + 8 * s, ph);
      turn_wait();
      issue_qk<DP>(sc, qw_s, k_s + s * C::KV_BYTES);
      turn_pass();
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(k_empty + 8 * s);
      softmax_tile<BK>(sc, p, lt0 * BK, r, m_r, l_r, corr);
      pack_p<BK>(pa, sc);
    }
    // each further tile t: S_t = Q K_t^T and O += P_{t-1} V_{t-1} go to the
    // tensor cores, and the softmax of S_t runs while P_{t-1} V_{t-1} does
    for (int t = lt0 + 1; t < lt1; ++t) {
      const int s_prev = s;
      const uint32_t ph_prev = ph;
      s = (t - t_begin) % STAGES;
      ph = ((t - t_begin) / STAGES) & 1;
      float sc[BK / 2];
      mbar_wait(k_full + 8 * s, ph);
      mbar_wait(v_full + 8 * s_prev, ph_prev);
      turn_wait();
      issue_qk<DP>(sc, qw_s, k_s + s * C::KV_BYTES);
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) o[e] *= corr[(e >> 1) & 1];
      issue_pv<DP, BK>(o, pa, v_s + s_prev * C::KV_BYTES);
      turn_pass();
      wgmma_wait<1>();  // S_t has landed
      fence_regs(sc);
      mbar_arrive(k_empty + 8 * s);
      softmax_tile<BK>(sc, p, t * BK, r, m_r, l_r, corr);
      wgmma_wait<0>();
      fence_regs(o);
      keep_live(pa);
      mbar_arrive(v_empty + 8 * s_prev);
      pack_p<BK>(pa, sc);
    }
    // the last tile's P V
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) o[e] *= corr[(e >> 1) & 1];
    mbar_wait(v_full + 8 * s, ph);
    issue_pv<DP, BK>(o, pa, v_s + s * C::KV_BYTES);
    wgmma_wait<0>();
    fence_regs(o);
    keep_live(pa);
    mbar_arrive(v_empty + 8 * s);
  }
  for (int t = lt1; t < t_end; ++t) skip(t);

  // epilogue: O / l in fp32, rounded once to bf16 into this warpgroup's Q
  // tile (free since its last product) in the swizzled layout that the TMA
  // store reads; rows past Sq and columns past D are not stored
  if (r.qb < r.qa) return;
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[h] = 1.f / fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * 16 + (lane >> 2) + h * 8;  // row within the tile
      const int chunk = (j % 8) ^ (row & 7);            // 16-byte chunk, swizzled
      const uint32_t addr = qw_s + (j / 8) * TMA_BQ * 128 + row * 128 + chunk * 16 + r.c0 * 2;
      const uint32_t v = pack_bf16(o[4 * j + 2 * h] * inv[h], o[4 * j + 2 * h + 1] * inv[h]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
  if (tid == 0) {
    for (int pn = 0; pn < NP; ++pn)
      tma_store(&omap, qw_s + pn * TMA_BQ * 128, pn * PANEL, head, qw0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// --------------------------------------------------------------------------- //
// host side
// --------------------------------------------------------------------------- //
template <typename K>
cudaError_t launch(K kern, const Params& p, int B, int KV, int threads, size_t smem,
                   cudaStream_t stream) {
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long nq = (p.Sq + p.bq - 1) / p.bq;
  const long long ny = (long long)KV * (p.G / p.gc);
  if (nq > 0x7fffffffLL || ny > 65535) return cudaErrorInvalidValue;
  kern<<<dim3((unsigned)nq, (unsigned)ny, B), threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Rows of a bf16 CTA: as many of the group's heads and as many queries of
// each (a multiple of 16) as the warp budget allows; all G heads and 64
// queries where they fit (smollm-360m: 3 x 64 = 192 rows, 12 warps).
void bf16_rows(int G, int maxw, int& gc, int& bq) {
  for (bq = 64; bq >= 16; bq /= 2)
    if (G * (bq / 16) <= maxw) {
      gc = G;
      return;
    }
  bq = 16;
  for (gc = maxw; G % gc; --gc) {
  }
}

template <int DP>
cudaError_t launch_bf16(Params p, int B, int KV, cudaStream_t stream) {
  bf16_rows(p.G, Bf16Cfg<DP>::MAXW, p.gc, p.bq);
  const int M = p.gc * p.bq;
  const size_t smem = (size_t)(M + 4 * Bf16Cfg<DP>::BK) * Bf16Cfg<DP>::LD * sizeof(bf16);
  const int threads = M / 16 * 32;
  return launch(flash_fwd_bf16<DP>, p, B, KV, threads, smem, stream);
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

// A map over a bf16 tensor [B, S, heads, D] with element strides (sb, ss,
// sh), the last dim contiguous; dims innermost first (D, heads, S, B). A box
// is 64 columns of `rows` positions of one head, 128-byte swizzled in shared
// memory; what lies out of bounds reads as zeros and is not written.
bool make_map(CUtensorMap* map, const void* base, int D, int heads, int S, int B, long long sb,
              long long ss, long long sh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {PANEL, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

template <int DP>
cudaError_t launch_tma(const Params& p, int B, int H, int KV, cudaStream_t stream) {
  using C = TmaCfg<DP>;
  CUtensorMap qm, km, vm, om;
  if (!make_map(&qm, p.q, p.D, H, p.Sq, B, p.q_sb, p.q_ss, p.q_sh, TMA_BQ) ||
      !make_map(&km, p.k, p.D, KV, p.Sk, B, p.k_sb, p.k_ss, p.k_sh, C::BK) ||
      !make_map(&vm, p.v, p.D, KV, p.Sk, B, p.v_sb, p.v_ss, p.v_sh, C::BK) ||
      !make_map(&om, p.out, p.D, H, p.Sq, B, p.o_sb, p.o_ss, p.o_sh, TMA_BQ))
    return cudaErrorInvalidValue;
  TmaParams tp;
  tp.Sq = p.Sq;
  tp.Sk = p.Sk;
  tp.G = p.G;
  tp.gc = gcd(p.G, C::NC);  // heads of the group a CTA holds; NC / gc query blocks
  tp.causal = p.causal;
  tp.window = p.window;
  tp.scale_log2 = p.scale * LOG2E;
  const long long nq = (p.Sq + (C::NC / tp.gc) * TMA_BQ - 1) / ((C::NC / tp.gc) * TMA_BQ);
  const long long ny = (long long)KV * (p.G / tp.gc);
  // (query block, head chunk, batch row) as the kernel reads them
  const dim3 grid = p.causal ? dim3((unsigned)ny, B, (unsigned)nq)
                             : dim3((unsigned)nq, (unsigned)ny, B);
  if (grid.y > 65535 || grid.z > 65535 || grid.x > 0x7fffffffu) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tma_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  flash_fwd_tma_wgmma<DP><<<grid, C::THREADS, C::SMEM, stream>>>(qm, km, vm, om, tp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B,Sq,H,D] with element strides (q_sb, q_ss, q_sh); k and v [B,Sk,KV,D]
// with (k_sb, k_ss, k_sh) and (v_sb, v_ss, v_sh); out [B,Sq,H,D] with
// (o_sb, o_ss, o_sh); every last dim contiguous. route (chosen by the
// wrapper, flash_attention.py `_route`): 0 = float32 on the CUDA cores,
// 1 = bfloat16 through mma.sync, 2 = bfloat16 through TMA and wgmma
// (every stride a multiple of 8 elements, every base 16-byte aligned, D a
// multiple of 8 up to 128, or 256). window < 0 means no window. Returns a
// cudaError_t (0 on success).
int repro_flash_attention(int device, int route, const void* q, const void* k, const void* v,
                          void* out, int B, int H, int KV, int Sq, int Sk, int D,
                          long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                          long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                          long long v_sh, long long o_sb, long long o_ss, long long o_sh,
                          int causal, int window, void* stream) {
  if (B <= 0 || B > 65535 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 || D <= 0)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.G = H / KV;
  p.q_sb = q_sb, p.q_ss = q_ss, p.q_sh = q_sh;
  p.k_sb = k_sb, p.k_ss = k_ss, p.k_sh = k_sh;
  p.v_sb = v_sb, p.v_ss = v_ss, p.v_sh = v_sh;
  p.o_sb = o_sb, p.o_ss = o_ss, p.o_sh = o_sh;
  p.causal = causal != 0;
  p.window = window;
  p.scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  if (route == 0) {
    if (D > 256) return cudaErrorInvalidValue;
    p.gc = p.G;
    for (p.bq = 32; p.bq > 1 && f32_smem_floats(p.G * p.bq, D) * 4 > MAX_SMEM; p.bq /= 2) {
    }
    return launch(flash_fwd_f32, p, B, KV, THREADS32, f32_smem_floats(p.G * p.bq, D) * 4, st);
  }
  const long long strides[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                                 v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  if (route == 2) {
    bool ok = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
    for (long long s : strides) ok = ok && s > 0 && s % 8 == 0;
    if (!ok) return cudaErrorInvalidValue;
    if (D <= 64) return launch_tma<64>(p, B, H, KV, st);
    if (D <= 80) return launch_tma<80>(p, B, H, KV, st);
    if (D <= 128) return launch_tma<128>(p, B, H, KV, st);
    if (D == 256) return launch_tma<256>(p, B, H, KV, st);
    return cudaErrorInvalidValue;
  }
  if (route != 1) return cudaErrorInvalidValue;
  switch ((D + 15) / 16 * 16) {
    case 16: return launch_bf16<16>(p, B, KV, st);
    case 32: return launch_bf16<32>(p, B, KV, st);
    case 48: return launch_bf16<48>(p, B, KV, st);
    case 64: return launch_bf16<64>(p, B, KV, st);
    case 80: return launch_bf16<80>(p, B, KV, st);
    case 96: return launch_bf16<96>(p, B, KV, st);
    case 112: return launch_bf16<112>(p, B, KV, st);
    case 128: return launch_bf16<128>(p, B, KV, st);
    case 256: return D == 256 ? launch_bf16<256>(p, B, KV, st) : cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
