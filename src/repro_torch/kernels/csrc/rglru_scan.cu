// K5 on Hopper: the RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py:52
// rglru_scan_kernel (Pallas body `_kernel` at :27, pallas_call at :66).
// Oracle: src/repro/kernels/ref.py::rglru_ref (the exact step recurrence),
// ported as src/repro_torch/kernels/ref.py::rglru_ref.
//
// What it computes. For batch row b and channel w, with a, b [B,S,W] and
// h0 [B,W] fp32: h = h0[b,w]; for t in 0..S-1: h = a[b,t,w] h + b[b,t,w],
// y[b,t,w] = h. The state is fp32 throughout; y comes out in a's dtype and
// the final state [B,W] in fp32.
//
// What bounds it: bytes. Two loads and a store of each (b, t, w) against
// one FMA: at recurrentgemma-9b's prefill (B=4, S=2048, W=4096, fp32 a, b
// and y) 402.7 MB, 0.120 ms at 3.35 TB/s; the 33.6 MFLOP are nothing.
//
// Design (simple and right first):
// * One thread per (row, channel) holds h in an fp32 register and walks
//   S in order: the TPU grid's sequential seq axis becomes a loop.
//   Consecutive threads take consecutive channels, so every load of
//   a[b,t,:], b[b,t,:] and every store of y[b,t,:] is coalesced.
// * Grid (ceil(W/128), B), 128 threads: at B=4, W=4096 only 16,384
//   threads, a few warps an SM. So memory-level parallelism comes from
//   prefetch: the time loop runs in blocks of U steps, and the loads of
//   the next block's a and b (2U registers) go out before the
//   dependent FMAs of the current one, which keeps ~U x 2 x 128 B in
//   flight a warp.
// * Any S and W: steps past S and channels past W are masked (the TPU
//   kernel requires W % 128 == 0 and S % 256 == 0). a and b are read
//   through their batch and seq strides (the last dim contiguous); y is
//   written contiguous [B,S,W].
// * Later work: a chunk-parallel scan (per-chunk prod a and local h, a
//   carry pass, a fix-up pass) for more threads at small B, and fusing
//   the gate math that forms a and b into the scan.

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

const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
