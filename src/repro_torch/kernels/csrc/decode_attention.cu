// K1 on Hopper: one-token GQA attention against a positional KV cache.
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
// in bf16): two orders of magnitude below the ~295 flops a byte where the
// H100's bf16 tensor cores would become the limit. So the arithmetic runs
// in fp32 on the CUDA cores, and the design is about the loads.
//
// Design (simple and right first). One CTA per (kv head, batch row) walks
// W in tiles of TILE slots. The G query rows of the group sit in shared
// memory pre-scaled in fp32; each tile's K and V rows are loaded together
// (16-byte loads where the strides allow) into padded fp32 rows, so the
// score and accumulate loops are free of bank conflicts. The mask comes
// from cache_pos/q_pos/window inside the kernel. K and V are read through
// their strides, so the model layout [B,W,KV,D] needs no transposed copy.
// G is any group size (3 for smollm-360m; not a power of two) and D any
// head dim up to 256; W need not be a multiple of TILE.
//
// Known limit: at decode B*KV is 20 CTAs (smollm-360m, batch 4) on 132
// SMs, so most of the card idles. A split-KV grid with a combine pass, and
// tensor cores for the G rows, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;
constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90
constexpr float NEG = -1.0e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

__host__ __device__ __forceinline__ size_t smem_floats(int G, int D) {
  return 2 * (size_t)G * D                   // q (scaled), acc
         + 2 * (size_t)TILE * row_stride(D)  // K tile, V tile
         + (size_t)G * TILE                  // scores, then probabilities
         + 3 * (size_t)G                     // m, l, corr
         + TILE;                             // valid flags (as int)
}

// Stage rows [0, n) of one tile of K and of V, VEC elements per load.
template <typename T, int VEC>
__device__ __forceinline__ void load_tiles(float* kt, float* vt, const T* kb, const T* vb,
                                           long long ksw, long long vsw, int n, int D) {
  const int ds = row_stride(D);
  const int vpr = D / VEC;  // loads per row
#pragma unroll 2
  for (int i = threadIdx.x; i < n * vpr; i += THREADS) {
    const int j = i / vpr;
    const int c = (i - j * vpr) * VEC;
    const T* ks = kb + j * ksw + c;
    const T* vs = vb + j * vsw + c;
    if constexpr (VEC == 1) {
      kt[j * ds + c] = to_f(__ldg(ks));
      vt[j * ds + c] = to_f(__ldg(vs));
    } else {
      const uint4 ku = __ldg(reinterpret_cast<const uint4*>(ks));
      const uint4 vu = __ldg(reinterpret_cast<const uint4*>(vs));
      const T* ke = reinterpret_cast<const T*>(&ku);
      const T* ve = reinterpret_cast<const T*>(&vu);
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        kt[j * ds + c + t] = to_f(ke[t]);
        vt[j * ds + c + t] = to_f(ve[t]);
      }
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ cache_pos, const int* __restrict__ q_pos,
                    T* __restrict__ out, int H, int KV, int W, int D,
                    long long k_sb, long long k_sh, long long k_sw,
                    long long v_sb, long long v_sh, long long v_sw,
                    int window, float scale) {
  extern __shared__ float smem[];
  const int G = H / KV;
  const int ds = row_stride(D);
  float* qs = smem;                   // [G, D]
  float* acc = qs + G * D;            // [G, D]
  float* kt = acc + G * D;            // [TILE, ds]
  float* vt = kt + TILE * ds;         // [TILE, ds]
  float* s = vt + TILE * ds;          // [G, TILE]
  float* m = s + G * TILE;            // [G]
  float* l = m + G;                   // [G]
  float* corr = l + G;                // [G]
  int* valid = reinterpret_cast<int*>(corr + G);  // [TILE]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int NWARPS = THREADS / 32;

  const T* qb = q + ((long long)b * H + (long long)kvh * G) * D;
  for (int i = tid; i < G * D; i += THREADS) {
    qs[i] = to_f(qb[i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m[g] = NEG;
    l[g] = 0.f;
  }
  const int qp = q_pos[b];
  const int* cp = cache_pos + (long long)b * W;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  __syncthreads();

  for (int w0 = 0; w0 < W; w0 += TILE) {
    const int n = min(TILE, W - w0);
    // 1. validity of the tile's slots, and its K and V rows
    for (int j = tid; j < TILE; j += THREADS) {
      int ok = 0;
      if (j < n) {
        const int c = cp[w0 + j];
        ok = c >= 0 && c <= qp && (window < 0 || qp - c < window);
      }
      valid[j] = ok;
    }
    load_tiles<T, VEC>(kt, vt, kb + w0 * k_sw, vb + w0 * v_sw, k_sw, v_sw, n, D);
    __syncthreads();

    // 2. scores: s[g, j] = q_g . k_j, or NEG for a masked or padded slot
    for (int i = tid; i < G * TILE; i += THREADS) {
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

    // 3. online softmax, one warp per query row: s becomes p
    for (int g = warp; g < G; g += NWARPS) {
      float* sr = s + g * TILE;
      float mx = NEG;
      for (int j = lane; j < TILE; j += 32) mx = fmaxf(mx, sr[j]);
      mx = warp_max(mx);
      const float m_old = m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < TILE; j += 32) {
        const float p = valid[j] ? expf(sr[j] - m_new) : 0.f;
        sr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        corr[g] = c;
        l[g] = l[g] * c + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    // 4. acc[g, d] = acc * corr + sum_j p[g, j] * v[j, d]
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pr = s + g * TILE;
      float a = acc[i] * corr[g];
      for (int j = 0; j < n; ++j) a = fmaf(pr[j], vt[j * ds + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  T* ob = out + ((long long)b * H + (long long)kvh * G) * D;
  for (int i = tid; i < G * D; i += THREADS) {
    ob[i] = from_f<T>(acc[i] / fmaxf(l[i / D], 1e-30f));
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* q, const void* k, const void* v, const int* cache_pos,
                   const int* q_pos, void* out, int B, int H, int KV, int W, int D,
                   long long k_sb, long long k_sh, long long k_sw, long long v_sb,
                   long long v_sh, long long v_sw, int window, cudaStream_t stream) {
  const size_t smem = smem_floats(H / KV, D) * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = flash_decode_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(KV, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), cache_pos,
      q_pos, static_cast<T*>(out), H, KV, W, D, k_sb, k_sh, k_sw, v_sb, v_sh, v_sw, window,
      rsqrtf((float)D));
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const int* cache_pos,
                     const int* q_pos, void* out, int B, int H, int KV, int W, int D,
                     long long k_sb, long long k_sh, long long k_sw, long long v_sb,
                     long long v_sh, long long v_sw, int window, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  // 16-byte loads need every row start 16-byte aligned
  const long long es = sizeof(T);
  const bool vec = D % VEC == 0 && aligned16(k) && aligned16(v) &&
                   (k_sb * es) % 16 == 0 && (k_sh * es) % 16 == 0 && (k_sw * es) % 16 == 0 &&
                   (v_sb * es) % 16 == 0 && (v_sh * es) % 16 == 0 && (v_sw * es) % 16 == 0;
  if (vec)
    return launch<T, VEC>(q, k, v, cache_pos, q_pos, out, B, H, KV, W, D, k_sb, k_sh, k_sw,
                          v_sb, v_sh, v_sw, window, stream);
  return launch<T, 1>(q, k, v, cache_pos, q_pos, out, B, H, KV, W, D, k_sb, k_sh, k_sw, v_sb,
                      v_sh, v_sw, window, stream);
}

}  // namespace

extern "C" {

// q [B,H,D] and out [B,H,D] contiguous; k and v [B,KV,W,D] with the given
// element strides for b, kv and w and a contiguous last dim; cache_pos
// [B,W] and q_pos [B] contiguous int32. dtype 0 = float32, 1 = bfloat16.
// window < 0 means no window. Returns a cudaError_t (0 on success).
int repro_flash_decode(int device, int dtype, const void* q, const void* k, const void* v,
                       const void* cache_pos, const void* q_pos, void* out, int B, int H,
                       int KV, int W, int D, long long k_sb, long long k_sh, long long k_sw,
                       long long v_sb, long long v_sh, long long v_sw, int window,
                       void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || W <= 0 || D <= 0 || B > 65535)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int* cpos = static_cast<const int*>(cache_pos);
  const int* qpos = static_cast<const int*>(q_pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, cpos, qpos, out, B, H, KV, W, D, k_sb, k_sh, k_sw, v_sb,
                           v_sh, v_sw, window, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, cpos, qpos, out, B, H, KV, W, D, k_sb, k_sh, k_sw,
                                   v_sb, v_sh, v_sw, window, st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
