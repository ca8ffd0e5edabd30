// K1 on Hopper: one-token GQA attention against a positional KV cache,
// as split-KV flash decoding.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::flash_decode
// (Pallas body `_kernel`, pallas_call at :93). Oracle:
// src/repro/kernels/ref.py::flash_decode_ref, ported as
// src/repro_torch/kernels/ref.py::flash_decode_ref.
//
// What it computes. For every batch row b and query head h = kv*G + g:
//   out[b,h] = softmax_w(scale * q[b,h] . k[b,kv,w]) @ v[b,kv,w]
// over the slots w whose absolute position c = cache_pos[b,w] is valid:
// 0 <= c <= q_pos[b] and, with a window, q_pos[b] - c < window. The scale is
// D^-0.5, the softmax runs online in fp32 (running max m, sum l, acc), a
// masked score is -1e30, and a row with no valid slot comes out 0, as
// ref.py's `where(valid, p, 0)` makes it. The output has q's dtype.
//
// What bounds it: memory. A call reads K and V once, 2*B*W*KV*D*bytes, and
// does 4*B*H*W*D flops, about 2*G/bytes flops per byte (3 for smollm-360m
// in bf16, 16 for recurrentgemma-9b's MQA): far below the ~295 flops a byte
// where the H100's bf16 tensor cores become the limit. So the design is
// about keeping enough loads in flight on all 132 SMs.
//
// Design.
// * Split-KV grid. A CTA takes one (KV head, group of up to 16 query heads,
//   split of W, batch row), KV heads fastest. B*KV is only 4 to 20 at
//   decode, on 132 SMs, so the wrapper (decode_attention.py `_plan`) cuts W
//   into splits of whole 64-slot tiles, as many as one wave of the CTAs
//   the card holds at once allows (`repro_flash_decode_ctas_per_sm`, CUDA's
//   occupancy query): each CTA then pays its start (Q, the first tiles'
//   latency) and its merge once. With one
//   split a CTA writes the output; with several each writes its partial
//   (m, l, unnormalised fp32 acc) to a workspace and `flash_decode_combine`
//   rescales and sums them per (row, head). An empty or fully masked split
//   has m = -1e30 and l = acc = 0; the combine weighs it exp(m - M), which
//   is 0 beside a valid split and 1 when every split is empty, so a fully
//   masked row comes out 0 (never exp(-inf + inf) or 0/0).
// * bf16 on the tensor cores. The group's query heads are the M dimension
//   of mma.sync.m16n8k16 (padded to 16 rows with zeros); each of the four
//   warps takes 16 slots of every 64-slot tile, computes S = Q K^T and
//   O += P V with fp32 accumulators and its own online softmax, and the
//   warps' (m, l, O) are merged through shared memory at the end. P enters
//   P V as two bf16 terms, hi and what hi rounded away, so the product
//   carries P to ~16 bits (Q, K and V are bf16 already: nothing else is
//   rounded before the fp32 accumulators). D is padded with zeros in
//   shared memory to 16, 32, 64, 128 or 256 (so 20, 80 and 120 run), and
//   the padded columns are never written. At D = 256 Q is re-read from
//   shared memory at each k-step (ldmatrix) rather than held in 64 more
//   registers, as in K2.
// * Loads. K and V tiles go through a cp.async ring of 3 stages (2 at D =
//   256) in shared memory, 16-byte copies read through the strides of the
//   model layout [B,W,KV,D] (no transposed copy), consecutive threads on
//   consecutive chunks of a row, rows padded by 8 bf16 so ldmatrix is free
//   of bank conflicts; Q arrives the same way. Every slot of a split is
//   copied, so that no copy waits on a slot's position (read a tile ahead
//   into validity flags); a masked slot's p is 0, and a warp whose 16
//   slots are all masked skips its arithmetic.
//   Without 16-byte alignment (or with D % 8 != 0) the same ring is filled
//   by element loads.
// * fp32 stays on the CUDA cores (TF32 would break the fp32 tolerance):
//   the same split grid and combine, the group's rows pre-scaled in shared
//   memory and each tile's K and V rows staged in padded fp32 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// TILE, GC and MAX_SPLITS are read from this file by the wrapper's split
// plan (decode_attention.py `_cu_constant`): keep the form `constexpr int
// NAME = value;`
constexpr int TILE = 64;       // slots a tile; split lengths are multiples
constexpr int GC = 16;         // query heads a CTA (one mma M tile)
constexpr int MAX_SPLITS = 128;  // at most the combine's threads
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90
constexpr float NEG = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* cache_pos;
  const int* q_pos;
  void* out;      // [B,H,D], written when nsplit == 1
  float* ws_acc;  // [B,H,nsplit,D] partial accumulators, nsplit > 1
  float* ws_ml;   // [B,H,nsplit,2] partial (m, l), nsplit > 1
  int H, KV, G, W, D;
  long long k_sb, k_sh, k_sw, v_sb, v_sh, v_sw;
  int window;  // < 0: none
  int nsplit, split_len;
  float scale;
};

// CTA coordinates: slots [lo, hi) of KV head kvh, query heads
// kvh*G + g0 .. + gn - 1, row b.
struct Cta {
  int split, kvh, g0, gn, b, lo, hi;
};

__device__ __forceinline__ Cta cta(const Params& p) {
  Cta c;
  c.split = blockIdx.y;
  const int chunks = (p.G + GC - 1) / GC;
  c.kvh = blockIdx.x / chunks;
  c.g0 = (blockIdx.x % chunks) * GC;
  c.gn = min(GC, p.G - c.g0);
  c.b = blockIdx.z;
  c.lo = c.split * p.split_len;
  c.hi = min(p.W, c.lo + p.split_len);
  return c;
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ bool slot_valid(int cpos, int qp, int window) {
  return cpos >= 0 && cpos <= qp && (window < 0 || qp - cpos < window);
}

// Write row r's result: the output (one split) or the partial (several).
template <typename T>
__device__ __forceinline__ void store_row(const Params& p, const Cta& c, int r, int d,
                                          float acc, float m, float l) {
  const long long bh = (long long)c.b * p.H + (long long)c.kvh * p.G + c.g0 + r;
  if (p.nsplit == 1) {
    static_cast<T*>(p.out)[bh * p.D + d] = from_f<T>(acc / fmaxf(l, 1e-30f));
  } else {
    const long long i = bh * p.nsplit + c.split;
    p.ws_acc[i * p.D + d] = acc;
    if (d == 0) {
      p.ws_ml[2 * i] = m;
      p.ws_ml[2 * i + 1] = l;
    }
  }
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

// (x, y) as two bf16 pairs whose sum carries ~16 bits: hi = bf16(x, y) and
// lo = bf16 of what hi rounded away
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

constexpr int WARPS16 = 4;  // bf16 CTA: each warp takes 16 slots of a tile

template <int DP>
struct Bf16Cfg {
  static constexpr int LD = DP + 8;                  // padded row (bf16)
  static constexpr int NST = DP <= 128 ? 3 : 2;      // cp.async ring depth
  static constexpr bool QREG = DP <= 128;            // Q fragments in registers
  static constexpr size_t STAGE = 2 * (size_t)TILE * LD;  // K and V bf16 a stage
  static constexpr size_t SMEM = ((size_t)GC * LD + NST * STAGE) * sizeof(bf16)  // q, ring
                                 + (size_t)NST * TILE * sizeof(int)              // valid flags
                                 + 2 * (size_t)(WARPS16 + 1) * GC * sizeof(float);  // m, l
};

template <int DP, bool VEC>
__global__ void __launch_bounds__(32 * WARPS16) flash_decode_bf16(const Params p) {
  using Cfg = Bf16Cfg<DP>;
  constexpr int LD = Cfg::LD;
  constexpr int NST = Cfg::NST;
  constexpr int KT = DP / 16;  // k-steps of Q K^T
  constexpr int NT = DP / 8;   // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [GC][LD]
  bf16* ring = qs + GC * LD;                      // [NST][K, V][TILE][LD]
  int* okf = reinterpret_cast<int*>(ring + NST * Cfg::STAGE);  // [NST][TILE]
  float* wm = reinterpret_cast<float*>(okf + NST * TILE);      // [WARPS16][GC]
  float* wl = wm + WARPS16 * GC;                               // [WARPS16][GC]
  float* row_m = wl + WARPS16 * GC;                            // [GC], merged
  float* row_l = row_m + GC;                                   // [GC], merged
  float* obuf = reinterpret_cast<float*>(ring);  // [WARPS16][GC][DP], after the loop

  const Cta c = cta(p);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qp = p.q_pos[c.b];
  const int* cp = p.cache_pos + (long long)c.b * p.W;
  const bf16* kb = static_cast<const bf16*>(p.k) + c.b * p.k_sb + c.kvh * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + c.b * p.v_sb + c.kvh * p.v_sh;

  // Q rows of the group, zeros past the group and past D: one cp.async
  // group of its own, ahead of the ring's
  const bf16* qb = static_cast<const bf16*>(p.q) +
                   ((long long)c.b * p.H + (long long)c.kvh * p.G + c.g0) * p.D;
  if constexpr (VEC) {
    constexpr int CH = DP / 8;
    for (int i = tid; i < GC * CH; i += blockDim.x) {
      const int r = i / CH;
      const int col = (i - r * CH) * 8;
      const bool in = r < c.gn && col < p.D;
      cp_async16(qs + r * LD + col, in ? static_cast<const void*>(qb + r * p.D + col) : p.q,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < GC * DP; i += blockDim.x) {
      const int r = i / DP;
      const int d = i - r * DP;
      qs[r * LD + d] = (r < c.gn && d < p.D) ? qb[r * p.D + d] : __float2bfloat16(0.f);
    }
  }
  cp_async_commit();

  const int ntiles = (c.hi - c.lo + TILE - 1) / TILE;
  // stage tile t (in order t = 0, 1, ...): the K and V rows of its slots,
  // consecutive threads on consecutive 16-byte chunks of a row (rows past
  // the split are zero-filled), issued at once; and its validity flags,
  // from the slots' positions that threads 0..63 read one tile ahead, so
  // that no copy waits on a read.
  int cpos_next = tid < TILE && c.lo + tid < c.hi ? cp[c.lo + tid] : -1;
  auto issue = [&](int t) {
    const int st = t % NST;
    bf16* ks = ring + st * Cfg::STAGE;
    bf16* vs = ks + TILE * LD;
    const int w0 = c.lo + t * TILE;
    if constexpr (VEC) {
      constexpr int CH = DP / 8;  // 16-byte chunks a row
#pragma unroll
      for (int k = 0; k < TILE * CH / (32 * WARPS16); ++k) {
        const int i = tid + k * 32 * WARPS16;
        const int j = i / CH;
        const int col = (i - j * CH) * 8;
        const int w = w0 + j;
        const bool in = w < c.hi && col < p.D;
        cp_async16(ks + j * LD + col, in ? static_cast<const void*>(kb + w * p.k_sw + col) : p.k,
                   in ? 16 : 0);
        cp_async16(vs + j * LD + col, in ? static_cast<const void*>(vb + w * p.v_sw + col) : p.v,
                   in ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < TILE * DP / (32 * WARPS16); ++k) {
        const int i = tid + k * 32 * WARPS16;
        const int j = i / DP;
        const int col = i - j * DP;
        const int w = w0 + j;
        const bool in = w < c.hi && col < p.D;
        ks[j * LD + col] = in ? kb[w * p.k_sw + col] : __float2bfloat16(0.f);
        vs[j * LD + col] = in ? vb[w * p.v_sw + col] : __float2bfloat16(0.f);
      }
    }
    if (tid < TILE) {
      okf[st * TILE + tid] = w0 + tid < c.hi && slot_valid(cpos_next, qp, p.window);
      const int wn = w0 + TILE + tid;
      cpos_next = wn < c.hi ? cp[wn] : -1;
    }
  };

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < ntiles) issue(s);
    cp_async_commit();
  }

  cp_async_wait<NST - 1>();  // Q has landed (the ring's tiles may not have)
  __syncthreads();
  const bf16* qrow_s = qs + (lane & 15) * LD + (lane >> 4) * 8;
  uint32_t qf[Cfg::QREG ? KT : 1][4];
  if constexpr (Cfg::QREG) {
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) ldmatrix_x4(qf[kt], qrow_s + kt * 16);
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {NEG, NEG};
  float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int c0 = (lane & 3) * 2;
  const int key0 = warp * 16;  // this warp's slots within a tile

  for (int t = 0; t < ntiles; ++t) {
    if (t + NST - 1 < ntiles) issue(t + NST - 1);
    cp_async_commit();
    cp_async_wait<NST - 1>();  // tile t has landed
    __syncthreads();

    const int st = t % NST;
    const int* ok = okf + st * TILE + key0;
    if (__any_sync(0xffffffffu, ok[lane & 15])) {
      const bf16* ks = ring + st * Cfg::STAGE + key0 * LD;
      const bf16* vs = ring + st * Cfg::STAGE + TILE * LD + key0 * LD;
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t qa[4];
        if constexpr (Cfg::QREG) {
          qa[0] = qf[kt][0], qa[1] = qf[kt][1], qa[2] = qf[kt][2], qa[3] = qf[kt][3];
        } else {
          ldmatrix_x4(qa, qrow_s + kt * 16);
        }
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + ((lane & 7) + (lane >> 4) * 8) * LD + kt * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[0], qa, bk[0], bk[1]);
        mma_bf16(s[1], qa, bk[2], bk[3]);
      }
      // scale and mask; row maxima over the warp's 16 slots
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = ok[j * 8 + c0 + (e & 1)] ? s[j][e] * p.scale : NEG;
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
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float pv = ok[j * 8 + c0 + (e & 1)] ? exp2f((s[j][e] - m_r[i]) * LOG2E) : 0.f;
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
      // O += P V: the two score n-tiles are the A fragment of one k-step,
      // P as hi + lo bf16 terms (two products), so that P is not rounded
      // to 8 bits
      uint32_t a[4], a_lo[4];
      split_bf16(s[0][0], s[0][1], a[0], a_lo[0]);
      split_bf16(s[0][2], s[0][3], a[1], a_lo[1]);
      split_bf16(s[1][0], s[1][1], a[2], a_lo[2]);
      split_bf16(s[1][2], s[1][3], a[3], a_lo[3]);
#pragma unroll
      for (int dn = 0; dn < DP / 16; ++dn) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + dn * 16 +
                                  (lane >> 4) * 8);
        mma_bf16(o[2 * dn], a, bv[0], bv[1]);
        mma_bf16(o[2 * dn + 1], a, bv[2], bv[3]);
        mma_bf16(o[2 * dn], a_lo, bv[0], bv[1]);
        mma_bf16(o[2 * dn + 1], a_lo, bv[2], bv[3]);
      }
    }
    __syncthreads();  // the stage is free for tile t + NST
  }
  cp_async_wait<0>();

  // merge the four warps' (m, l, O): rows r0 = lane / 4 and r0 + 8
  const int r0 = lane >> 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  if ((lane & 3) == 0) {
    wm[warp * GC + r0] = m_r[0];
    wm[warp * GC + r0 + 8] = m_r[1];
    wl[warp * GC + r0] = l_r[0];
    wl[warp * GC + r0 + 8] = l_r[1];
  }
  __syncthreads();
  if (tid < GC) {
    float M = NEG, l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS16; ++w) M = fmaxf(M, wm[w * GC + tid]);
#pragma unroll
    for (int w = 0; w < WARPS16; ++w) l += wl[w * GC + tid] * exp2f((wm[w * GC + tid] - M) * LOG2E);
    row_m[tid] = M;
    row_l[tid] = l;
  }
  float f[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < WARPS16; ++w) M = fmaxf(M, wm[w * GC + r]);
    f[i] = exp2f((m_r[i] - M) * LOG2E);
  }
  float* ob = obuf + warp * GC * DP;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = n * 8 + c0;
    *reinterpret_cast<float2*>(ob + r0 * DP + d) = make_float2(o[n][0] * f[0], o[n][1] * f[0]);
    *reinterpret_cast<float2*>(ob + (r0 + 8) * DP + d) =
        make_float2(o[n][2] * f[1], o[n][3] * f[1]);
  }
  __syncthreads();
  for (int i = tid; i < c.gn * DP; i += blockDim.x) {
    const int r = i / DP;
    const int d = i - r * DP;
    if (d >= p.D) continue;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS16; ++w) acc += obuf[(w * GC + r) * DP + d];
    store_row<bf16>(p, c, r, d, acc, row_m[r], row_l[r]);
  }
}

// --------------------------------------------------------------------------- //
// fp32: CUDA cores
// --------------------------------------------------------------------------- //
constexpr int THREADS32 = 256;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Row stride of a staged K/V row in shared memory: odd, so that lanes
// reading the same column of consecutive rows hit different banks.
__host__ __device__ __forceinline__ int row_stride(int D) { return D | 1; }

__host__ __device__ __forceinline__ size_t f32_smem_floats(int D) {
  return 2 * (size_t)GC * D                  // q (scaled), acc
         + 2 * (size_t)TILE * row_stride(D)  // K tile, V tile
         + (size_t)GC * TILE                 // scores, then probabilities
         + 3 * (size_t)GC                    // m, l, corr
         + TILE;                             // valid flags (as int)
}

template <int VEC>
__global__ void __launch_bounds__(THREADS32) flash_decode_f32(const Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ds = row_stride(D);
  float* qs = smem;                   // [GC, D]
  float* acc = qs + GC * D;           // [GC, D]
  float* kt = acc + GC * D;           // [TILE, ds]
  float* vt = kt + TILE * ds;         // [TILE, ds]
  float* s = vt + TILE * ds;          // [GC, TILE]
  float* m = s + GC * TILE;           // [GC]
  float* l = m + GC;                  // [GC]
  float* corr = l + GC;               // [GC]
  int* valid = reinterpret_cast<int*>(corr + GC);  // [TILE]

  const Cta c = cta(p);
  const int G = c.gn;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int NWARPS = THREADS32 / 32;

  const float* qb = static_cast<const float*>(p.q) +
                    ((long long)c.b * p.H + (long long)c.kvh * p.G + c.g0) * D;
  for (int i = tid; i < G * D; i += THREADS32) {
    qs[i] = qb[i] * p.scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS32) {
    m[g] = NEG;
    l[g] = 0.f;
  }
  const int qp = p.q_pos[c.b];
  const int* cp = p.cache_pos + (long long)c.b * p.W;
  const float* kb = static_cast<const float*>(p.k) + c.b * p.k_sb + c.kvh * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + c.b * p.v_sb + c.kvh * p.v_sh;

  for (int w0 = c.lo; w0 < c.hi; w0 += TILE) {
    const int n = min(TILE, c.hi - w0);
    // 1. validity of the tile's slots
    for (int j = tid; j < TILE; j += THREADS32)
      valid[j] = j < n && slot_valid(cp[w0 + j], qp, p.window);
    __syncthreads();
    // 2. the K and V rows of the valid slots (zeros for the others)
    const int vpr = D / VEC;  // loads a row
    for (int i = tid; i < n * vpr; i += THREADS32) {
      const int j = i / vpr;
      const int col = (i - j * vpr) * VEC;
      float* kd = kt + j * ds + col;
      float* vd = vt + j * ds + col;
      if (!valid[j]) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kd[e] = vd[e] = 0.f;
      } else if constexpr (VEC == 1) {
        *kd = __ldg(kb + (long long)(w0 + j) * p.k_sw + col);
        *vd = __ldg(vb + (long long)(w0 + j) * p.v_sw + col);
      } else {
        const float4 ku = __ldg(reinterpret_cast<const float4*>(kb + (long long)(w0 + j) * p.k_sw + col));
        const float4 vu = __ldg(reinterpret_cast<const float4*>(vb + (long long)(w0 + j) * p.v_sw + col));
        kd[0] = ku.x, kd[1] = ku.y, kd[2] = ku.z, kd[3] = ku.w;
        vd[0] = vu.x, vd[1] = vu.y, vd[2] = vu.z, vd[3] = vu.w;
      }
    }
    __syncthreads();

    // 3. scores: s[g, j] = q_g . k_j, or NEG for a masked or padded slot
    for (int i = tid; i < G * TILE; i += THREADS32) {
      const int g = i / TILE;
      const int j = i - g * TILE;
      float sc = NEG;
      if (valid[j]) {
        const float* qr = qs + g * D;
        const float* kr = kt + j * ds;
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
        sc = a;
      }
      s[i] = sc;
    }
    __syncthreads();

    // 4. online softmax, one warp per query row: s becomes p
    for (int g = warp; g < G; g += NWARPS) {
      float* sr = s + g * TILE;
      float mx = NEG;
      for (int j = lane; j < TILE; j += 32) mx = fmaxf(mx, sr[j]);
      mx = warp_max(mx);
      const float m_old = m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < TILE; j += 32) {
        const float pv = valid[j] ? expf(sr[j] - m_new) : 0.f;
        sr[j] = pv;
        sum += pv;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float cr = expf(m_old - m_new);
        corr[g] = cr;
        l[g] = l[g] * cr + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    // 5. acc[g, d] = acc * corr + sum_j p[g, j] * v[j, d]
    for (int i = tid; i < G * D; i += THREADS32) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pr = s + g * TILE;
      float a = acc[i] * corr[g];
      for (int j = 0; j < n; ++j) a = fmaf(pr[j], vt[j * ds + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += THREADS32) {
    const int g = i / D;
    store_row<float>(p, c, g, i - g * D, acc[i], m[g], l[g]);
  }
}

// --------------------------------------------------------------------------- //
// combine: the splits' partials of one (row, head) into its output
// --------------------------------------------------------------------------- //
constexpr int COMBINE_WARPS = 8;

// One CTA a (row, head): warp w sums splits w, w + 8, ... with its lanes
// over D, and the warps' sums meet in shared memory.
template <typename T>
__global__ void __launch_bounds__(32 * COMBINE_WARPS)
flash_decode_combine(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
                     T* __restrict__ out, int D, int nsplit) {
  constexpr int DV = 256 / 32;  // columns a lane
  __shared__ float wt[32 * COMBINE_WARPS], lw[32 * COMBINE_WARPS];
  __shared__ float part[COMBINE_WARPS][256];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long bh = blockIdx.x;
  const float* ml = ws_ml + bh * nsplit * 2;
  float m_s = NEG, l_s = 0.f;
  if (threadIdx.x < nsplit) m_s = ml[2 * threadIdx.x], l_s = ml[2 * threadIdx.x + 1];
  wt[threadIdx.x] = m_s;  // a thread a split (and more)
  __syncthreads();
  float M = NEG;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, wt[s]);
  __syncthreads();
  // exp(m_s - M): 0 for an empty split beside a valid one, 1 where all are
  // empty (then every l and acc is 0, and the row comes out 0)
  const float w_s = exp2f((m_s - M) * LOG2E);
  wt[threadIdx.x] = w_s;
  lw[threadIdx.x] = l_s * w_s;
  __syncthreads();
  const float* acc = ws_acc + bh * nsplit * D;
  float a[DV];
#pragma unroll
  for (int k = 0; k < DV; ++k) a[k] = 0.f;
#pragma unroll 2
  for (int s = warp; s < nsplit; s += COMBINE_WARPS) {
    const float* as = acc + (long long)s * D;
#pragma unroll
    for (int k = 0; k < DV; ++k) {
      const int d = lane + 32 * k;
      if (d < D) a[k] += as[d] * wt[s];
    }
  }
#pragma unroll
  for (int k = 0; k < DV; ++k) {
    const int d = lane + 32 * k;
    if (d < D) part[warp][d] = a[k];
  }
  __syncthreads();
  float l = 0.f;
  for (int s = 0; s < nsplit; ++s) l += lw[s];  // in order: deterministic
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < COMBINE_WARPS; ++w) x += part[w][d];
    out[bh * D + d] = from_f<T>(x * inv);
  }
}

// --------------------------------------------------------------------------- //
// host side
// --------------------------------------------------------------------------- //
template <typename K>
cudaError_t launch_main(K kern, const Params& p, int B, int threads, size_t smem,
                        cudaStream_t stream) {
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  // KV heads (and head groups) fastest: the CTAs that run together read
  // neighbouring rows of the model layout [B,W,KV,D]
  const long long nx = (long long)p.KV * ((p.G + GC - 1) / GC);
  if (nx > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<dim3((unsigned)nx, p.nsplit, B), threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bf16(const Params& p, int B, bool vec, cudaStream_t stream) {
  constexpr size_t smem = Bf16Cfg<DP>::SMEM;
  if (vec) return launch_main(flash_decode_bf16<DP, true>, p, B, 32 * WARPS16, smem, stream);
  return launch_main(flash_decode_bf16<DP, false>, p, B, 32 * WARPS16, smem, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// 16-byte loads need every row start of q, k and v 16-byte aligned
bool rows_aligned16(const Params& p, int es) {
  const long long st[6] = {p.k_sb, p.k_sh, p.k_sw, p.v_sb, p.v_sh, p.v_sw};
  bool ok = (p.D * es) % 16 == 0 && aligned16(p.q) && aligned16(p.k) && aligned16(p.v);
  for (long long s : st) ok = ok && (s * es) % 16 == 0;
  return ok;
}

template <typename T>
cudaError_t combine(const Params& p, int B, cudaStream_t stream) {
  static_assert(32 * COMBINE_WARPS >= MAX_SPLITS, "a thread a split");
  flash_decode_combine<T><<<B * p.H, 32 * COMBINE_WARPS, 0, stream>>>(
      p.ws_acc, p.ws_ml, static_cast<T*>(p.out), p.D, p.nsplit);
  return cudaGetLastError();
}

template <typename K>
int ctas_per_sm(K kern, int threads, size_t smem) {
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess)
    return 0;
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, threads, smem) == cudaSuccess
             ? n
             : 0;
}

}  // namespace

extern "C" {

// q [B,H,D] and out [B,H,D] contiguous; k and v [B,KV,W,D] with the given
// element strides for b, kv and w and a contiguous last dim; cache_pos
// [B,W] and q_pos [B] contiguous int32. dtype 0 = float32, 1 = bfloat16.
// window < 0 means no window. W is cut into nsplit splits of split_len
// slots (a multiple of 64; the last split may be shorter); with nsplit > 1,
// ws holds B*H*nsplit*(D + 2) floats of workspace. Returns a cudaError_t
// (0 on success).
int repro_flash_decode(int device, int dtype, const void* q, const void* k, const void* v,
                       const void* cache_pos, const void* q_pos, void* out, int B, int H,
                       int KV, int W, int D, long long k_sb, long long k_sh, long long k_sw,
                       long long v_sb, long long v_sh, long long v_sw, int window, int nsplit,
                       int split_len, void* ws, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || W <= 0 || D <= 0 || D > 256 || B > 65535)
    return cudaErrorInvalidValue;
  if (nsplit < 1 || nsplit > MAX_SPLITS || split_len <= 0 || split_len % TILE != 0 ||
      (long long)(nsplit - 1) * split_len >= W || (long long)nsplit * split_len < W ||
      (nsplit > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.cache_pos = static_cast<const int*>(cache_pos);
  p.q_pos = static_cast<const int*>(q_pos);
  p.out = out;
  p.ws_acc = static_cast<float*>(ws);
  p.ws_ml = p.ws_acc == nullptr ? nullptr : p.ws_acc + (long long)B * H * nsplit * D;
  p.H = H, p.KV = KV, p.G = H / KV, p.W = W, p.D = D;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_sw = k_sw;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_sw = v_sw;
  p.window = window;
  p.nsplit = nsplit;
  p.split_len = split_len;
  p.scale = rsqrtf((float)D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  if (dtype == 0) {
    const size_t smem = f32_smem_floats(D) * sizeof(float);
    e = rows_aligned16(p, 4) ? launch_main(flash_decode_f32<4>, p, B, THREADS32, smem, st)
                             : launch_main(flash_decode_f32<1>, p, B, THREADS32, smem, st);
    if (e != cudaSuccess || nsplit == 1) return e;
    return combine<float>(p, B, st);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  const bool vec = rows_aligned16(p, 2);
  if (D <= 16) e = launch_bf16<16>(p, B, vec, st);
  else if (D <= 32) e = launch_bf16<32>(p, B, vec, st);
  else if (D <= 64) e = launch_bf16<64>(p, B, vec, st);
  else if (D <= 128) e = launch_bf16<128>(p, B, vec, st);
  else e = launch_bf16<256>(p, B, vec, st);
  if (e != cudaSuccess || nsplit == 1) return e;
  return combine<bf16>(p, B, st);
}

// CTAs of the main kernel that fit on one SM at once for this dtype and
// head dim (0 on error): the wrapper's split plan fills one wave of them.
int repro_flash_decode_ctas_per_sm(int device, int dtype, int D) {
  if (D <= 0 || D > 256 || cudaSetDevice(device) != cudaSuccess) return 0;
  if (dtype == 0) return ctas_per_sm(flash_decode_f32<4>, THREADS32, f32_smem_floats(D) * 4);
  if (dtype != 1) return 0;
  constexpr int T = 32 * WARPS16;
  if (D <= 16) return ctas_per_sm(flash_decode_bf16<16, true>, T, Bf16Cfg<16>::SMEM);
  if (D <= 32) return ctas_per_sm(flash_decode_bf16<32, true>, T, Bf16Cfg<32>::SMEM);
  if (D <= 64) return ctas_per_sm(flash_decode_bf16<64, true>, T, Bf16Cfg<64>::SMEM);
  if (D <= 128) return ctas_per_sm(flash_decode_bf16<128, true>, T, Bf16Cfg<128>::SMEM);
  return ctas_per_sm(flash_decode_bf16<256, true>, T, Bf16Cfg<256>::SMEM);
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
