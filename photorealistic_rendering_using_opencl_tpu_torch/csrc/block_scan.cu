// K3: per-block exclusive prefix sum of int32 flags, plus each block's
// total, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel photorealistic_rendering_using_opencl_tpu/
// ops/pallas_kernels.py:_block_scan_kernel (launched by
// exclusive_prefix_sum): scans[i] = sum of flags before i within i's block
// of `block` elements, totals[b] = block b's sum.  The block offsets are
// added outside the kernel, as the reference adds them outside its kernel.
//
// Work split: one CTA per block, one thread per element (so `block`, a
// power of two from 32 to 1024, is the CTA size).  Each warp scans its 32
// values with __shfl_up_sync (inclusive), lane 31 parks the warp's total
// in shared memory, warp 0 scans those totals with a second shuffle scan,
// and every warp but the first adds the total of the warps before it.
// The exclusive value is the inclusive one minus the thread's own flag;
// the last thread writes the block total.
//
// Bound: device-memory bytes.  4 B read and 4 B written per element plus
// 4 B per block, and a handful of integer operations per element, so the
// least time is the bytes over the card's memory rate.  The loads and
// stores are coalesced (thread i touches element i); shared memory holds
// only the 32 warp totals.  Integer adds wrap as the reference's int32
// cumsum does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int32_t warp_inclusive_scan(int32_t v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = (int32_t)((uint32_t)v + (uint32_t)y);
  }
  return v;
}

__global__ void block_scan_kernel(const int32_t* __restrict__ flags,
                                  int32_t* __restrict__ scans,
                                  int32_t* __restrict__ totals) {
  __shared__ int32_t warp_sums[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const long long i = (long long)blockIdx.x * blockDim.x + tid;

  const int32_t f = flags[i];
  int32_t v = warp_inclusive_scan(f, lane);
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    // each lane reads and rewrites only its own slot
    int32_t w = lane < n_warps ? warp_sums[lane] : 0;
    w = warp_inclusive_scan(w, lane);
    if (lane < n_warps) warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = (int32_t)((uint32_t)v + (uint32_t)warp_sums[warp - 1]);
  scans[i] = (int32_t)((uint32_t)v - (uint32_t)f);
  if (tid == blockDim.x - 1) totals[blockIdx.x] = v;
}

}  // namespace

extern "C" int prt_block_scan(const int32_t* flags, int32_t* scans,
                              int32_t* totals, long long n_blocks, int block,
                              void* stream) {
  if (block < 32 || block > 1024 || (block & (block - 1)) != 0 ||
      n_blocks < 0 || n_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  block_scan_kernel<<<(unsigned)n_blocks, block, 0, (cudaStream_t)stream>>>(
      flags, scans, totals);
  return (int)cudaGetLastError();
}
