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
// What bounds it: operations. At the smollm-360m prefill shape (B=4,
// S=2048, H=15, KV=5, D=64, causal) a call does 4*B*H*D*S(S+1)/2 = 32.2
// GFLOP on 42 MB of q, k, v and output (770 flops a byte, against the
// ~295 where the H100's bf16 tensor cores take over from HBM as the
// limit): 32.6 us at 989 TFLOP/s against 12.5 us at 3.35 TB/s. So the
// bf16 path runs both products on the tensor cores.
//
// Design (simple and right first; wgmma, TMA and warp specialisation are
// later work):
// * bf16: one CTA per (block of BQ queries, KV head, batch row). The G
//   query heads of the KV head are packed into the M dimension (G*BQ rows,
//   192 for smollm-360m), so each K/V tile in shared memory serves all of
//   them; the TPU kernel re-reads K/V once per query head. Each warp owns
//   16 rows and runs mma.sync.m16n8k16 (bf16 in, fp32 accumulate) for
//   S = Q K^T and O += P V, with ldmatrix (.trans for V) from padded
//   shared-memory rows (no bank conflicts) and P kept in registers.
//   K/V tiles of 64 keys are double-buffered with cp.async.
// * The loop over KV tiles is bounded to the tiles that the causal
//   diagonal and the window leave live (the Pallas kernel's `pl.when`
//   skip, K2's 2x causal saving), and a warp skips the arithmetic of a
//   tile that is wholly masked for its 16 rows. CTAs with the longest
//   causal rows are launched first.
// * D is padded in shared memory to a multiple of 16 with zeros (20 -> 32,
//   120 -> 128) and the padded columns are never written out. The bf16
//   path takes D <= 128 and D = 256 (recurrentgemma-9b's local attention).
// * D = 256 is register-bound: a warp's 16 output rows x 256 fp32
//   accumulators are 128 registers a thread. So at D = 256 Q is not held
//   in registers (64 more) but re-read from shared memory with ldmatrix at
//   each K tile, and K/V tiles are 32 keys (16 score registers, not 32),
//   with 8 warps (128 rows: at G = 16 eight heads of 16 queries). Shared
//   memory: (128 + 4 x 32) rows of 264 bf16 = 135 KB, one CTA an SM.
// * q, k, v and out are read and written through their strides, so the
//   model layout [B,S,H,D] / [B,T,KV,D] needs no transposed copy; only the
//   last dim must be contiguous. Sq and Sk need not be multiples of a
//   block: rows and keys past the end are zero-filled and masked.
// * fp32: the same CTA decomposition on the CUDA cores (the tensor cores
//   have no full-fp32 product), scores and accumulator in shared memory as
//   in K1. It is the exactness path, not a fast one.

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

__device__ __forceinline__ bool valid(const Params& p, int qp, int kp) {
  return kp < p.Sk && (!p.causal || qp >= kp) && (p.window < 0 || qp - kp < p.window);
}

// The keys [lo, hi) that queries [qlo, qhi] can see.
__device__ __forceinline__ void kv_range(const Params& p, int qlo, int qhi, int& lo, int& hi) {
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage `rows` rows of DP bf16 into shared memory (row stride LD), columns
// >= D and rows whose pointer is null as zeros. VEC: 16-byte cp.async
// (D % 8 == 0 and every row 16-byte aligned); otherwise element loads.
template <bool VEC, int DP, int LD, typename RowPtr>
__device__ __forceinline__ void stage(bf16* dst, int rows, int D, const void* any,
                                      RowPtr row_ptr) {
  if constexpr (VEC) {
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
      const int r = i / CH;
      const int c = (i - r * CH) * 8;
      const bf16* src = row_ptr(r);
      const bool ok = src != nullptr && c < D;
      cp_async16(dst + r * LD + c, ok ? static_cast<const void*>(src + c) : any, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += blockDim.x) {
      const int r = i / DP;
      const int c = i - r * DP;
      const bf16* src = row_ptr(r);
      dst[r * LD + c] = (src != nullptr && c < D) ? src[c] : __float2bfloat16(0.f);
    }
  }
}

template <int DP>
struct Bf16Cfg {
  static constexpr int LD = DP + 8;          // padded row: conflict-free ldmatrix
  static constexpr int MAXW = DP <= 64 ? 12 : 8;  // warps a CTA (register budget)
  static constexpr bool QREG = DP <= 128;    // Q fragments held in registers
  static constexpr int BK = DP <= 128 ? 64 : 32;  // keys a K/V tile
};

template <int DP, bool VEC>
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
  stage<VEC, DP, LD>(qs, M, p.D, p.q, [&](int r) -> const bf16* {
    const int g = r / p.bq;
    const int qp = c.q0 + (r - g * p.bq);
    return qp < p.Sq ? q + qp * p.q_ss + (head0 + g) * p.q_sh : nullptr;
  });
  cp_async_commit();

  int lo, hi;
  kv_range(p, c.q0, min(c.q0 + p.bq, p.Sq) - 1, lo, hi);
  const int t_begin = lo / BK;
  const int t_end = hi > lo ? (hi + BK - 1) / BK : t_begin;
  auto load_kv = [&](int t, int buf) {
    const int kv0 = t * BK;
    stage<VEC, DP, LD>(ks + buf * BK * LD, BK, p.D, p.k, [&](int r) -> const bf16* {
      return kv0 + r < p.Sk ? k + (kv0 + r) * p.k_ss : nullptr;
    });
    stage<VEC, DP, LD>(vs + buf * BK * LD, BK, p.D, p.v, [&](int r) -> const bf16* {
      return kv0 + r < p.Sk ? v + (kv0 + r) * p.v_ss : nullptr;
    });
  };
  if (t_begin < t_end) load_kv(t_begin, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
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
    if (t + 1 < t_end) {
      load_kv(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
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
cudaError_t launch_bf16(Params p, int B, int KV, bool vec, cudaStream_t stream) {
  bf16_rows(p.G, Bf16Cfg<DP>::MAXW, p.gc, p.bq);
  const int M = p.gc * p.bq;
  const size_t smem = (size_t)(M + 4 * Bf16Cfg<DP>::BK) * Bf16Cfg<DP>::LD * sizeof(bf16);
  const int threads = M / 16 * 32;
  if (vec) return launch(flash_fwd_bf16<DP, true>, p, B, KV, threads, smem, stream);
  return launch(flash_fwd_bf16<DP, false>, p, B, KV, threads, smem, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// q [B,Sq,H,D] with element strides (q_sb, q_ss, q_sh); k and v [B,Sk,KV,D]
// with (k_sb, k_ss, k_sh) and (v_sb, v_ss, v_sh); out [B,Sq,H,D] with
// (o_sb, o_ss, o_sh); every last dim contiguous. dtype 0 = float32,
// 1 = bfloat16. window < 0 means no window. Returns a cudaError_t (0 on
// success).
int repro_flash_attention(int device, int dtype, const void* q, const void* k, const void* v,
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

  if (dtype == 0) {
    if (D > 256) return cudaErrorInvalidValue;
    p.gc = p.G;
    for (p.bq = 32; p.bq > 1 && f32_smem_floats(p.G * p.bq, D) * 4 > MAX_SMEM; p.bq /= 2) {
    }
    return launch(flash_fwd_f32, p, B, KV, THREADS32, f32_smem_floats(p.G * p.bq, D) * 4, st);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  // 16-byte cp.async needs every row start 16-byte aligned
  const long long st8[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  for (long long s : st8) vec = vec && s % 8 == 0;
  switch ((D + 15) / 16 * 16) {
    case 16: return launch_bf16<16>(p, B, KV, vec, st);
    case 32: return launch_bf16<32>(p, B, KV, vec, st);
    case 48: return launch_bf16<48>(p, B, KV, vec, st);
    case 64: return launch_bf16<64>(p, B, KV, vec, st);
    case 80: return launch_bf16<80>(p, B, KV, vec, st);
    case 96: return launch_bf16<96>(p, B, KV, vec, st);
    case 112: return launch_bf16<112>(p, B, KV, vec, st);
    case 128: return launch_bf16<128>(p, B, KV, vec, st);
    case 256: return D == 256 ? launch_bf16<256>(p, B, KV, vec, st) : cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
