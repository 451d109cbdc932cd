// K3: per-block exclusive prefix sum of int32 flags, plus each block's
// total, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel photorealistic_rendering_using_opencl_tpu/
// ops/pallas_kernels.py:_block_scan_kernel (launched by
// exclusive_prefix_sum): scans[i] = sum of flags before i within i's block
// of `block` elements, totals[b] = block b's sum.  The block offsets are
// added outside the kernel, as the reference adds them outside its kernel.
// Integer adds wrap (unsigned arithmetic) as the reference's int32 cumsum
// does.
//
// Bound: device-memory bytes.  4 B read and 4 B written per element plus
// 4 B per block, and a handful of integer operations per element, so the
// least time is the bytes over the card's memory rate (0.040 ms for the
// 134 MB of 16,777,216 flags).  Reaching it takes enough loads in flight:
// at ~0.6 us of memory latency and 3.35 TB/s the card needs ~15 KB a SM in
// flight, where the first design (one 4-byte flag a thread, CTAs of
// `block` threads behind two barriers) had ~8 KB.
//
// Design: CTAs of 256 threads, 4 consecutive flags a thread, so a CTA
// covers 1,024 flags, 1024 / block whole blocks (or one block of 1,024),
// and a segment of block / 4 threads scans one block:
//   - one 16-byte load a thread (four scalar loads in the second instance,
//     for a flags view that does not start on a 16-byte boundary);
//   - the thread's own 4-element scan, then a warp shuffle scan of the
//     thread sums that restarts at every segment boundary (block 32: 8
//     lanes, block 128: the whole warp);
//   - for blocks of 256-1024 flags (2-8 warps a segment) each warp's total
//     goes to shared memory behind the kernel's one barrier; a thread reads
//     all 8 in two 16-byte loads and adds those of the warps before its own
//     in its segment (a chain of dependent shared loads, one a warp, was
//     the slower form: the launch is a single short wave, so its time is
//     the latency of one load, the scan and one store);
//   - one 16-byte store a thread, and the segment's last thread writes the
//     block total.
// The grid is one CTA per 1,024 flags; threads past the end take part in
// the shuffles and the barrier but load and store nothing (the flag count
// is a multiple of block >= 32, so a thread's 4 flags are all in or all
// out).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int CTA_FLAGS = THREADS * PER_THREAD;
constexpr unsigned FULL = 0xffffffffu;

template <bool kVec>
__global__ void __launch_bounds__(THREADS)
block_scan_kernel(const int32_t* __restrict__ flags,
                  int32_t* __restrict__ scans, int32_t* __restrict__ totals,
                  long long n, int block) {
  __shared__ __align__(16) uint32_t warp_sums[THREADS / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int seg_threads = block / PER_THREAD;  // 8 .. 256, a power of two
  const int seg_shift = 31 - __clz(seg_threads);
  const long long i0 = (long long)blockIdx.x * CTA_FLAGS + PER_THREAD * tid;
  const bool inb = i0 < n;

  uint32_t f[PER_THREAD] = {0u, 0u, 0u, 0u};
  if (inb) {
    if (kVec) {
      const int4 v = *reinterpret_cast<const int4*>(flags + i0);
      f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) f[k] = flags[i0 + k];
    }
  }
  const uint32_t own = f[0] + f[1] + f[2] + f[3];

  // inclusive scan of the thread sums within the segment (or the warp,
  // where a segment spans warps)
  const int seg_lanes = seg_threads < 32 ? seg_threads : 32;
  const int in_seg = lane & (seg_lanes - 1);
  uint32_t v = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL, v, off);
    if (off < seg_lanes && in_seg >= off) v += y;
  }
  if (seg_threads > 32) {  // uniform: the same block for the whole grid
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    // all 8 warp sums in two loads, then the ones before this warp in its
    // segment added (no chain of dependent shared-memory loads)
    const uint4 a = *reinterpret_cast<const uint4*>(warp_sums);
    const uint4 b = *reinterpret_cast<const uint4*>(warp_sums + 4);
    const uint32_t w8[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const int first = warp & ~(seg_threads / 32 - 1);
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k)
      if (k >= first && k < warp) v += w8[k];
  }

  if (inb) {
    uint32_t e = v - own;  // the thread's exclusive offset in its block
    int4 out;
    out.x = (int32_t)e;
    e += f[0];
    out.y = (int32_t)e;
    e += f[1];
    out.z = (int32_t)e;
    e += f[2];
    out.w = (int32_t)e;
    *reinterpret_cast<int4*>(scans + i0) = out;
    if ((tid & (seg_threads - 1)) == seg_threads - 1)
      totals[((long long)blockIdx.x << (10 - 2 - seg_shift)) +
             (tid >> seg_shift)] = (int32_t)v;
  }
}

}  // namespace

extern "C" int prt_block_scan(const int32_t* flags, int32_t* scans,
                              int32_t* totals, long long n_blocks, int block,
                              void* stream) {
  if (block < 32 || block > 1024 || (block & (block - 1)) != 0 ||
      n_blocks < 0 || n_blocks > 0x7fffffffLL || (uintptr_t)scans % 16)
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  const long long n = n_blocks * block;
  const long long ctas = (n + CTA_FLAGS - 1) / CTA_FLAGS;
  const cudaStream_t s = (cudaStream_t)stream;
  if ((uintptr_t)flags % 16)
    block_scan_kernel<false><<<(unsigned)ctas, THREADS, 0, s>>>(
        flags, scans, totals, n, block);
  else
    block_scan_kernel<true><<<(unsigned)ctas, THREADS, 0, s>>>(
        flags, scans, totals, n, block);
  return (int)cudaGetLastError();
}
