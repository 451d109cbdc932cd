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
// Each CTA copies one of the TPU kernel's blocks: T2a 3,072 contiguous
// floats, one float a thread per step; T2b 32,768 contiguous floats as
// 16-byte vectors.  Bound: memory, every byte read once and written once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long ROWS_BLOCK = 1024 * 3;     // T2a: a [1024, 3] block
constexpr long long FLAT_BLOCK4 = 256 * 128 / 4;  // T2b: a [256, 128] block

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
  const long long base = (long long)blockIdx.x * FLAT_BLOCK4;
  for (int e = threadIdx.x; e < FLAT_BLOCK4; e += THREADS) {
    const long long k = base + e;
    if (k < total4) y[k] = x[k];
  }
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
  const long long blocks = (total4 + FLAT_BLOCK4 - 1) / FLAT_BLOCK4;
  passthrough_flat_kernel<<<(unsigned)blocks, THREADS, 0,
                            (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y),
      total4);
  return (int)cudaGetLastError();
}

}  // extern "C"
