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
// Bound: memory, every byte read once and written once.  T2a: each CTA
// copies one of the TPU kernel's [1024, 3] blocks, 3,072 contiguous floats,
// one float a thread per step.  T2b: the TPU's [256, 128] block is no part
// of what it computes, a copy; one CTA per such block made only 24 CTAs for
// the 132 SMs at the barrier probe's 786,432 floats.  It launches
// enough CTAs to fill the card, FLAT_UNROLL 16-byte vectors a thread, all
// loads made before the stores, over a grid-stride loop: at that size
// every vector is in flight at once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long ROWS_BLOCK = 1024 * 3;     // T2a: a [1024, 3] block
constexpr int FLAT_UNROLL = 4;   // T2b: float4 vectors in flight a thread
constexpr int FLAT_BLOCKS_PER_SM = 8;  // T2b's grid cap: 2,048 threads an SM

__global__ void __launch_bounds__(THREADS)
passthrough_rows_kernel(const float* __restrict__ x, float* __restrict__ y,
                        long long total) {
  const long long base = (long long)blockIdx.x * ROWS_BLOCK;
  for (int e = threadIdx.x; e < ROWS_BLOCK; e += THREADS) {
    const long long k = base + e;
    if (k < total) y[k] = x[k];
  }
}

__global__ void __launch_bounds__(THREADS)
passthrough_flat_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                        long long total4) {
  const long long stride = (long long)gridDim.x * THREADS;
  long long k = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (; k + (FLAT_UNROLL - 1) * stride < total4; k += FLAT_UNROLL * stride) {
    float4 v[FLAT_UNROLL];
#pragma unroll
    for (int u = 0; u < FLAT_UNROLL; ++u) v[u] = x[k + u * stride];
#pragma unroll
    for (int u = 0; u < FLAT_UNROLL; ++u) y[k + u * stride] = v[u];
  }
  for (; k < total4; k += stride) y[k] = x[k];
}

// the current device's SM count, read once (0 and the error on failure)
cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (!cached) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *sms = cached;
  return cudaSuccess;
}

}  // namespace

extern "C" {

int prt_passthrough_rows(const float* x, float* y, long long n_rows,
                         void* stream) {
  const long long total = n_rows * 3;
  const long long blocks = (total + ROWS_BLOCK - 1) / ROWS_BLOCK;
  passthrough_rows_kernel<<<(unsigned)blocks, THREADS, 0,
                            (cudaStream_t)stream>>>(x, y, total);
  return (int)cudaGetLastError();
}

int prt_passthrough_flat(const float* x, float* y, long long n,
                         void* stream) {
  const long long total4 = n / 4;  // the wrapper requires n % 128 == 0
  const long long per_block = (long long)THREADS * FLAT_UNROLL;
  long long blocks = (total4 + per_block - 1) / per_block;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const long long cap = (long long)sms * FLAT_BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;
  passthrough_flat_kernel<<<(unsigned)blocks, THREADS, 0,
                            (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y),
      total4);
  return (int)cudaGetLastError();
}

}  // extern "C"
