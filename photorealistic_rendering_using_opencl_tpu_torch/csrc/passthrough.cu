// T2a and T2b: identity copies, the pass-through probes of the fusion-
// barrier test, for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of tools/pallas_barrier_test.py:
// _passthrough (T2a: [N, 3] f32 in [1024, 3] blocks) and _passthrough_flat
// (T2b: [N] f32 viewed as [N/128, 128], in [256, 128] blocks).  On the TPU
// they asked whether a custom call in the middle of an XLA fusion chain
// costs more than its copy; in an eager PyTorch chain there is no fusion to
// break, so they measure what one more launch costs.
//
// Bound: memory, every byte read once and written once.  The TPU's blocks
// are no part of what either computes, a copy, so both copy their buffer as
// flat floats with one body: UNROLL 16-byte vectors in flight a thread, all
// loads made before the stores, over a grid-stride loop on a grid of at
// most the card's resident CTAs.  At the barrier probe's 786,432 floats
// that is 384 CTAs of 128 threads, every vector in flight at once (PR 4's
// 192 CTAs of 256 threads left some SMs twice the bytes of others, and ran
// slower).  The vectors are aligned on the output:
// the floats before its first 16-byte boundary (the head) and after its
// last whole vector (the tail: 3N % 4 floats for T2a's aligned [N, 3]) are
// copied one a thread, after the vectors.  An input whose offset differs
// from the output's modulo 16 bytes (a view with a storage offset) is read
// with scalar loads by the kernel's second instance.
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 4;  // float4 vectors in flight a thread

template <bool kVecLoad>
__device__ __forceinline__ float4 load4(const float* __restrict__ x) {
  if (kVecLoad) return *reinterpret_cast<const float4*>(x);
  return make_float4(x[0], x[1], x[2], x[3]);
}

// y[i] = x[i] for i < n; y + head is 16-byte aligned, and so is x + head
// where kVecLoad
template <bool kVecLoad>
__global__ void __launch_bounds__(THREADS)
passthrough_kernel(const float* __restrict__ x, float* __restrict__ y,
                   long long n, int head) {
  const long long gid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long n4 = (n - head) / 4;
  const float* xv = x + head;
  float4* yv = reinterpret_cast<float4*>(y + head);
  const long long stride = (long long)gridDim.x * THREADS;
  long long k = gid;
  for (; k + (UNROLL - 1) * stride < n4; k += UNROLL * stride) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      v[u] = load4<kVecLoad>(xv + 4 * (k + u * stride));
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) yv[k + u * stride] = v[u];
  }
  for (; k < n4; k += stride) yv[k] = load4<kVecLoad>(xv + 4 * k);
  // the head and the tail, after the vectors so as not to delay their loads
  const long long tail = head + 4 * n4;
  if (gid < head) y[gid] = x[gid];
  if (gid < n - tail) y[tail + gid] = x[tail + gid];
}

template <bool kVecLoad>
int launch(const float* x, float* y, long long n, int head,
           cudaStream_t stream) {
  static int cache[prt::kMaxDevices] = {};
  int ctas = 0;
  const cudaError_t e =
      prt::resident_ctas(passthrough_kernel<kVecLoad>, THREADS, cache, &ctas);
  if (e != cudaSuccess) return (int)e;
  const long long per_block = (long long)THREADS * UNROLL * 4;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > ctas) blocks = ctas;
  passthrough_kernel<kVecLoad><<<(unsigned)blocks, THREADS, 0, stream>>>(
      x, y, n, head);
  return (int)cudaGetLastError();
}

}  // namespace

// y[:n] = x[:n], n > 0 floats, both 4-byte aligned
extern "C" int prt_passthrough(const float* x, float* y, long long n,
                               void* stream) {
  long long head = (16 - (uintptr_t)y % 16) % 16 / 4;
  if (head > n) head = n;
  const cudaStream_t s = (cudaStream_t)stream;
  return ((uintptr_t)x - (uintptr_t)y) % 16
             ? launch<false>(x, y, n, (int)head, s)
             : launch<true>(x, y, n, (int)head, s);
}
