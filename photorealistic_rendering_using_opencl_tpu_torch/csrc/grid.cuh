// Grid sizing shared by the kernels' sources.
#pragma once
#include <cuda_runtime.h>

namespace prt {

constexpr int kMaxDevices = 64;

// CTAs of `kernel`, launched with `threads` threads and no dynamic shared
// memory, that the current device holds at once.  `cache` keeps the answer
// per device (0: not read yet); returns the CUDA error, if any.
template <typename Kernel>
inline cudaError_t resident_ctas(Kernel kernel, int threads, int* cache,
                                 int* ctas) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!cache[dev]) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
    if (e != cudaSuccess) return e;
    cache[dev] = sms * per_sm;
  }
  *ctas = cache[dev];
  return cudaSuccess;
}

}  // namespace prt
