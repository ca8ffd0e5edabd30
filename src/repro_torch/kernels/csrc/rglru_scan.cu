// K5 on Hopper: the RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py:52
// rglru_scan_kernel (Pallas body `_kernel` at :27, pallas_call at :66).
// Oracles: src/repro/kernels/ref.py::rglru_ref (the exact step recurrence),
// ported as src/repro_torch/kernels/ref.py::rglru_ref, and
// ref.py::rglru_gated_ref for the gated entry.
//
// What it computes. Two entries share one scan core (rglru_ring):
// * the TPU kernel's function: a, b [B,S,W] and h0 [B,W] fp32; for row b and
//   channel w, h = h0[b,w]; for t in 0..S-1: h = a[b,t,w] h + b[b,t,w],
//   y[b,t,w] = h; y in a's dtype, the final state [B,W] in fp32;
// * the model's gated entry: r, i (the gates' sigmoids) and x [B,S,W] in one
//   dtype, log_a_base = log sigmoid(lambda) [W] fp32. In registers, in fp32,
//   log_a = 8 r log_a_base, a = exp(log_a), b = sqrt(max(1 - exp(2 log_a),
//   1e-12)) (i x), then the same scan from h0; y in x's dtype. a and b never
//   reach device memory. expf and sqrtf (not __expf), the plain version's
//   order of operations, and 1 - e with __fsub_rn (never contracted into an
//   FMA), so a and b equal the plain version's to the ulp; the step is one
//   FMA where the plain version rounds twice.
//
// What bounds it: bytes. At recurrentgemma-9b's prefill (B=4, S=2048,
// W=4096): the first entry in fp32 reads a, b and writes y, 402.8 MB, 0.120
// ms at 3.35 TB/s; the gated entry in bf16 reads r, i, x and writes y, 268.6
// MB, 0.080 ms. The operations (one FMA a step; two expf and a sqrtf an
// element when gated) are far under the fp32 rate.
//
// Design (rglru_ring): bytes in flight. A CTA of RING_THREADS threads owns
// RING_CW channels of one batch row (grid ceil(W/RING_CW) x B: 256 CTAs, two
// an SM, at B=4 W=4096) and walks S in tiles of RING_T steps:
// * a ring of stages in shared memory, each one tile [RING_T x RING_CW] of
//   every input stream, filled by 16-byte cp.async copies that all threads
//   issue NST - 1 tiles ahead (cp.async groups, one a tile). RING_BYTES of
//   ring a CTA keeps 48 KB (fp32 a, b) to 60 KB (bf16 r, i, x) in flight,
//   96-120 KB an SM; rglru_fwd's register prefetch keeps ~16 KB an SM;
// * gated: all threads turn a landed tile of r, i, x into fp32 a and b in
//   shared memory, 16 bytes of each stream a thread;
// * the first RING_CW threads scan: thread c owns channel c, keeps h in a
//   register across tiles and walks the tile's steps out of shared memory
//   (consecutive channels are consecutive words: no bank conflicts);
// * y leaves through a staged tile, one 16-byte store a thread and chunk.
// Ragged S and W are masked (copies past them are zero-filled, stores
// skipped); the copies need 16-byte aligned bases, row and batch strides
// and rows of y (W times the element size a multiple of 16 bytes). Calls
// off that alignment take rglru_fwd (the first entry only; the gated entry
// raises in the wrapper).
//
// rglru_fwd, the first design: one thread per (row, channel) in a
// grid (ceil(W/128), B) of 128 threads, a 16-step double-buffered register
// prefetch; any strides with a contiguous last dim, any S and W.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int U = 16;  // steps a prefetch block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* a;
  const void* b;
  const float* h0;
  void* y;
  float* hout;
  int S, W;
  long long a_sb, a_ss, b_sb, b_ss;
};

template <typename T>
__device__ __forceinline__ void load_block(float (&ra)[U], float (&rb)[U], const T* a,
                                           const T* b, long long a_ss, long long b_ss, int t0,
                                           int S) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    if (t < S) {
      ra[u] = to_f(__ldg(a + t * a_ss));
      rb[u] = to_f(__ldg(b + t * b_ss));
    }
  }
}

template <typename T>
__device__ __forceinline__ float run_block(const float (&ra)[U], const float (&rb)[U], float h,
                                           T* y, int W, int t0, int S) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    if (t < S) {
      h = fmaf(ra[u], h, rb[u]);
      y[(long long)t * W] = from_f<T>(h);
    }
  }
  return h;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rglru_fwd(const Params p) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= p.W) return;
  const int row = blockIdx.y;
  const T* a = static_cast<const T*>(p.a) + row * p.a_sb + w;
  const T* b = static_cast<const T*>(p.b) + row * p.b_sb + w;
  T* y = static_cast<T*>(p.y) + (long long)row * p.S * p.W + w;
  float h = p.h0[(long long)row * p.W + w];

  // two register blocks in turn: the next block's loads are in flight
  // while the current block's FMAs run
  float ca[U], cb[U], na[U], nb[U];
  load_block(ca, cb, a, b, p.a_ss, p.b_ss, 0, p.S);
  for (int t0 = 0; t0 < p.S; t0 += 2 * U) {
    load_block(na, nb, a, b, p.a_ss, p.b_ss, t0 + U, p.S);
    h = run_block(ca, cb, h, y, p.W, t0, p.S);
    load_block(ca, cb, a, b, p.a_ss, p.b_ss, t0 + 2 * U, p.S);
    h = run_block(na, nb, h, y, p.W, t0 + U, p.S);
  }
  p.hout[(long long)row * p.W + w] = h;
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const dim3 grid((p.W + THREADS - 1) / THREADS, B);
  rglru_fwd<T><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}


// --------------------------------------------------------------------------- //
// rglru_ring: both entries, the ring of cp.async tiles
// --------------------------------------------------------------------------- //
constexpr int RING_T = 32;          // steps a tile
constexpr int RING_CW = 64;         // channels a CTA
constexpr int RING_THREADS = 256;   // all copy, (gated) all form a and b, RING_CW scan
constexpr int RING_BYTES = 73728;   // the ring's stages: RING_BYTES / stage bytes, at least 3
constexpr int MAX_SMEM = 232448;    // a block's shared memory on the H100

template <typename T, bool GATED>
struct Ring {
  static constexpr int NS = GATED ? 3 : 2;              // input streams
  static constexpr int V = 16 / int(sizeof(T));         // elements a 16-byte copy
  static constexpr int TILE = RING_T * RING_CW;         // elements of a stream a tile
  static constexpr int STAGE = NS * TILE * int(sizeof(T));
  static constexpr int NST = RING_BYTES / STAGE < 3 ? 3 : RING_BYTES / STAGE;
  static constexpr int AB = GATED ? 2 * TILE * 4 : 0;   // a tile's fp32 a and b
  static constexpr int SMEM = NST * STAGE + AB + TILE * int(sizeof(T));  // + y's tile
  static constexpr int ROW_CHUNKS = RING_CW / V;        // 16-byte chunks a step
  static constexpr int PER = TILE / V / RING_THREADS;   // chunks a thread, a stream
  static constexpr int RSTEP = RING_THREADS / ROW_CHUNKS;
  static_assert(PER * V * RING_THREADS == TILE && RING_THREADS % ROW_CHUNKS == 0, "tile");
  static_assert(SMEM <= MAX_SMEM && RING_CW <= RING_THREADS, "plan");
};

struct RingParams {
  const void* in[3];       // a, b; or r, i, x
  long long sb[3], ss[3];  // their batch and seq strides, elements
  const float* lab;        // log sigmoid(lambda) [W] (gated)
  const float* h0;         // [B,W]
  void* y;                 // [B,S,W] contiguous
  float* hout;             // [B,W]
  int S, W;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of shared memory as fp32 values
__device__ __forceinline__ void ld16(const float* p, float (&f)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
}
__device__ __forceinline__ void ld16(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // a bf16 is the upper half of its fp32
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// the gated entry's decay and input, in the plain version's order
__device__ __forceinline__ void decay_input(float r, float i, float x, float lab, float& a,
                                            float& b) {
  const float log_a = 8.0f * r * lab;
  a = expf(log_a);
  b = sqrtf(fmaxf(__fsub_rn(1.0f, expf(2.0f * log_a)), 1e-12f)) * (i * x);
}

// h through n steps of a tile (a, b at stride RING_CW), y staged
template <int N, typename A, typename T>
__device__ __forceinline__ float scan_steps(const A* a, const A* b, T* y, float h, int n) {
#pragma unroll
  for (int t = 0; t < N; ++t) {
    if (N == RING_T || t < n) {
      h = fmaf(to_f(a[t * RING_CW]), h, to_f(b[t * RING_CW]));
      y[t * RING_CW] = from_f<T>(h);
    }
  }
  return h;
}

template <typename T, bool GATED>
__global__ void __launch_bounds__(RING_THREADS, 2) rglru_ring(const RingParams p) {
  using R = Ring<T, GATED>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* as = reinterpret_cast<float*>(smem + R::NST * R::STAGE);  // gated: a, then b
  T* ys = reinterpret_cast<T*>(smem + R::NST * R::STAGE + R::AB);

  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int w0 = blockIdx.x * RING_CW;
  const int nw = min(RING_CW, p.W - w0);  // this CTA's channels, a multiple of V
  const int ntiles = (p.S + RING_T - 1) / RING_T;
  // this thread's chunks: step t0 + j RSTEP, channels cc .. cc + V - 1
  const int cc = (tid % R::ROW_CHUNKS) * R::V;
  const int t0 = tid / R::ROW_CHUNKS;
  const T* src[R::NS];
#pragma unroll
  for (int s = 0; s < R::NS; ++s)
    src[s] = static_cast<const T*>(p.in[s]) + row * p.sb[s] + w0 + cc;

  // tile k into stage k % NST; one cp.async group a tile, empty past the end
  auto issue = [&](int k) {
    if (k < ntiles) {
      T* st = ring + (k % R::NST) * (R::NS * R::TILE);
#pragma unroll
      for (int s = 0; s < R::NS; ++s) {
#pragma unroll
        for (int j = 0; j < R::PER; ++j) {
          const int t = t0 + j * R::RSTEP, gt = k * RING_T + t;
          const bool ok = gt < p.S && cc < nw;
          cp_async16(st + s * R::TILE + t * RING_CW + cc, ok ? src[s] + gt * p.ss[s] : p.in[s],
                     ok);
        }
      }
    }
    cp_async_commit();
  };

  float lab[R::V];
  if constexpr (GATED) {
#pragma unroll
    for (int v = 0; v < R::V; ++v) lab[v] = cc < nw ? p.lab[w0 + cc + v] : 0.0f;
  }
  float h = tid < nw ? p.h0[(long long)row * p.W + w0 + tid] : 0.0f;
  T* y = static_cast<T*>(p.y) + (long long)row * p.S * p.W + w0;

#pragma unroll
  for (int k = 0; k < R::NST - 1; ++k) issue(k);
  for (int k = 0; k < ntiles; ++k) {
    cp_async_wait<R::NST - 2>();  // this thread's copies of tile k have landed
    __syncthreads();              // everyone's; and stage (k - 1) % NST is free
    issue(k + R::NST - 1);
    const T* st = ring + (k % R::NST) * (R::NS * R::TILE);
    const int n = min(RING_T, p.S - k * RING_T);
    if constexpr (GATED) {
#pragma unroll
      for (int j = 0; j < R::PER; ++j) {
        const int off = (t0 + j * R::RSTEP) * RING_CW + cc;
        float r[R::V], i[R::V], x[R::V], a[R::V], b[R::V];
        ld16(st + off, r);
        ld16(st + R::TILE + off, i);
        ld16(st + 2 * R::TILE + off, x);
#pragma unroll
        for (int v = 0; v < R::V; ++v) decay_input(r[v], i[v], x[v], lab[v], a[v], b[v]);
#pragma unroll
        for (int v = 0; v < R::V; v += 4) {
          *reinterpret_cast<float4*>(as + off + v) = make_float4(a[v], a[v + 1], a[v + 2], a[v + 3]);
          *reinterpret_cast<float4*>(as + R::TILE + off + v) =
              make_float4(b[v], b[v + 1], b[v + 2], b[v + 3]);
        }
      }
      __syncthreads();
      if (tid < nw)
        h = n == RING_T ? scan_steps<RING_T>(as + tid, as + R::TILE + tid, ys + tid, h, n)
                        : scan_steps<RING_T - 1>(as + tid, as + R::TILE + tid, ys + tid, h, n);
    } else {
      if (tid < nw)
        h = n == RING_T ? scan_steps<RING_T>(st + tid, st + R::TILE + tid, ys + tid, h, n)
                        : scan_steps<RING_T - 1>(st + tid, st + R::TILE + tid, ys + tid, h, n);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < R::PER; ++j) {
      const int t = t0 + j * R::RSTEP;
      if (t < n && cc < nw)
        *reinterpret_cast<uint4*>(y + (long long)(k * RING_T + t) * p.W + cc) =
            *reinterpret_cast<const uint4*>(ys + t * RING_CW + cc);
    }
  }
  cp_async_wait<0>();
  if (tid < nw) p.hout[(long long)row * p.W + w0 + tid] = h;
}

template <typename T, bool GATED>
cudaError_t launch_ring(const RingParams& p, int B, cudaStream_t stream) {
  using R = Ring<T, GATED>;
  const cudaError_t e = cudaFuncSetAttribute(
      rglru_ring<T, GATED>, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (e != cudaSuccess) return e;
  rglru_ring<T, GATED><<<dim3((p.W + RING_CW - 1) / RING_CW, B), RING_THREADS, R::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// the ring's copies and stores: 16-byte aligned bases, strides of whole
// 16-byte chunks (a stride of a dim of extent 1 is never stepped), rows of y
bool ring_aligned(const void* const* in, const long long* sb, const long long* ss, int ns,
                  int B, int W, int es) {
  const long long v = 16 / es;
  if (W % v) return false;
  for (int s = 0; s < ns; ++s)
    if (reinterpret_cast<uintptr_t>(in[s]) % 16 || ss[s] % v || (B > 1 && sb[s] % v))
      return false;
  return true;
}

template <bool GATED>
int run_ring(int device, int dtype, RingParams& p, int ns, int B, int S, int W, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  p.S = S;
  p.W = W;
  if (!ring_aligned(p.in, p.sb, p.ss, ns, B, W, dtype == 0 ? 4 : 2) ||
      reinterpret_cast<uintptr_t>(p.y) % 16)
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_ring<float, GATED>(p, B, st)
                    : launch_ring<__nv_bfloat16, GATED>(p, B, st);
}

}  // namespace

extern "C" {

// a, b [B,S,W] with element strides (a_sb, a_ss) and (b_sb, b_ss), last dim
// contiguous, both of dtype 0 = float32 or 1 = bfloat16; h0 [B,W] fp32
// contiguous; y [B,S,W] of a's dtype and hout [B,W] fp32, contiguous.
// Returns a cudaError_t (0 on success).
int repro_rglru_scan(int device, int dtype, const void* a, const void* b, const float* h0,
                     void* y, float* hout, int B, int S, int W, long long a_sb, long long a_ss,
                     long long b_sb, long long b_ss, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  Params p;
  p.a = a;
  p.b = b;
  p.h0 = h0;
  p.y = y;
  p.hout = hout;
  p.S = S;
  p.W = W;
  p.a_sb = a_sb, p.a_ss = a_ss, p.b_sb = b_sb, p.b_ss = b_ss;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, st);
  return cudaErrorInvalidValue;
}

// The same function on the ring (rglru_ring): a, b as above, at the ring's
// alignment (16-byte bases; strides and W a whole number of 16-byte chunks);
// cudaErrorInvalidValue off it.
int repro_rglru_ring(int device, int dtype, const void* a, const void* b, const float* h0,
                     void* y, float* hout, int B, int S, int W, long long a_sb, long long a_ss,
                     long long b_sb, long long b_ss, void* stream) {
  RingParams p = {};
  p.in[0] = a, p.in[1] = b;
  p.sb[0] = a_sb, p.ss[0] = a_ss, p.sb[1] = b_sb, p.ss[1] = b_ss;
  p.h0 = h0, p.y = y, p.hout = hout;
  return run_ring<false>(device, dtype, p, 2, B, S, W, stream);
}

// The gated entry on the ring: r, i, x [B,S,W] of one dtype (0 = float32, 1 =
// bfloat16) with element strides (batch, seq), last dim contiguous, at the
// ring's alignment; lab = log sigmoid(lambda) [W] fp32; h0 [B,W] fp32; y
// [B,S,W] of x's dtype and hout [B,W] fp32, contiguous.
int repro_rglru_gated(int device, int dtype, const void* r, const void* i, const void* x,
                      const float* lab, const float* h0, void* y, float* hout, int B, int S,
                      int W, long long r_sb, long long r_ss, long long i_sb, long long i_ss,
                      long long x_sb, long long x_ss, void* stream) {
  RingParams p = {};
  p.in[0] = r, p.in[1] = i, p.in[2] = x;
  p.sb[0] = r_sb, p.ss[0] = r_ss, p.sb[1] = i_sb, p.ss[1] = i_ss, p.sb[2] = x_sb,
  p.ss[2] = x_ss;
  p.lab = lab, p.h0 = h0, p.y = y, p.hout = hout;
  return run_ring<true>(device, dtype, p, 3, B, S, W, stream);
}

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
