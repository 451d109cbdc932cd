// T1: the compute-only ablation of K1 (csrc/mesh_brute.cu), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel tools/bench_kernel.py:make_matmul_only
// (launched by run_matmul_only), the matmul-only leg of the reference's K1
// microbenchmark.
//
// What it computes (the TPU kernel's function): for each ray, the sum over
// the tiles whose relevance bit is set for the ray's block of the column
// sums of A_tile^T . p, i.e. over those tiles' TILE triangles (128, 256
// or 512, PRT_MESH_TILE's sizes, one instance each) of
// den + t*den + u*den + v*den.  Inputs: the relevance words of
// mesh_brute._block_relevance (one row of ceil(nt/32) 32-bit words per
// block of `block` rays, 128 or 256, bit j = tile j; bits at or past nt
// are ignored), the ray pack p [16, N] (rows o, d, d x o, 1; the rows past
// 9 meet all-zero coefficient rows) and the coefficient table A
// [16, 4*Tpad].  Outputs: t [N] (the sum) and i [N] (all zero, as the TPU
// kernel writes them).  Each pair's four dot products are K1's FFMA chains
// (pair_t's den / t*den / u*den / v*den, in its order), then
// (den + t*den) + (u*den + v*den) joins the ray's running sum: K1's
// per-pair arithmetic with the hit test taken out.  The tile sum is not
// factored (sum_c A_c . p = (sum_c A_c) . p would do 1/TILE of the work
// and not be K1's arithmetic).
//
// Bound: FP32 issue.  37 operations a (ray, triangle) pair of a relevant
// tile (the chains 33, an FMA counted twice, the three adds and the
// running sum 4) over the pairs this run's bits select; at 67 TFLOP/s that
// is the FLOP bound.  The pair is 23 FP32 instructions (FFMA, FMUL, FADD:
// 3 + 4 + 6 + 6 + 4), so at one warp instruction a clock a scheduler the
// issue floor is 23 / 18.5 = 1.24x the FLOP bound, and every other
// instruction (loads, addresses, loop control) issues in a slot that FP32
// does not get.
//
// What held the first design (one thread a ray, each relevant tile staged
// in shared memory by the CTA) at 2.9x the FLOP bound: its inner loop was
// already FP32-bound (19 LDS.128 and 92 FP32 instructions a 4 triangles),
// but every tile's staging loop ran 19 dependent global-load -> shared-store
// rounds a thread behind two __syncthreads, with nothing in flight across
// the barriers.  This design:
//   - a CTA takes 128 rays, and each of its 4 warps takes all 128, 4 a
//     lane (rays lane + 32q), so each coefficient it loads serves 4 rays:
//     19 LDS.128 (broadcast) a 4 triangles feed 368 FP32 instructions;
//   - the warps split the group's tiles: each walks the set bits of the
//     block's words with __ffs (bits past nt end the walk) and takes every
//     fourth, so a warp's work is a quarter of a group's and the grid has
//     4x the warps of one a group: the groups' tile counts vary ~4x
//     (chip_smoke.py phase 10), and finer pieces even out the SMs' loads;
//   - a warp copies each of its tiles, in stages of 64 triangles (19 rows
//     x 256 B; a tile is TILE / 64 of them), into a two-stage ring of its
//     own in shared memory with cp.async (one 16-byte piece a lane a
//     row-stage, through the L2, where the whole table sits: ~21 MB for
//     cornell_hi): the next stage is in flight while the warp computes on
//     this one, and __syncwarp after the wait and after the compute is the
//     only synchronisation in the loop;
//   - the 4 running sums of a lane are independent, one a ray; at the end
//     the warps' sums meet in shared memory behind the kernel's one
//     barrier and the first warp adds them in warp order;
//   - launch bounds of 3 CTAs an SM cap the registers at 168; ptxas -v
//     reports 119 and 40,960 B of shared memory, so 4 CTAs (16 warps) fit
//     an SM.
// The CTA reads its words row from its first ray (ray / block), so block
// 128 gives every CTA its own row and block 256 two CTAs a row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NCOEF = 19;  // non-zero coefficient rows of a tile
constexpr int RAYS = 4;    // rays a lane
constexpr int WARP_RAYS = 32 * RAYS;
constexpr int WARPS = 4;  // warps a CTA, each on every WARPS-th tile
constexpr int MIN_CTAS = 3;  // CTAs an SM must hold (sets the register cap)
constexpr int STAGE = 64;  // triangles a stage holds, whatever the tile
constexpr int GROUPS = STAGE / 4;  // 4-triangle groups a stage
constexpr int PIECES = NCOEF * STAGE / 4;  // 16-byte copies a stage: 304

// (table row, column group) of the k-th non-zero coefficient, as in K1:
//   den: rows 3-5; t*den: rows 0-2, 9; u*den, v*den: rows 3-8 each
__host__ __device__ constexpr int coef_row(int k) {
  return k < 3 ? 3 + k : k < 6 ? k - 3 : k == 6 ? 9 : k < 13 ? k - 4 : k - 10;
}
__host__ __device__ constexpr int coef_group(int k) {
  return k < 3 ? 0 : k < 7 ? 1 : k < 13 ? 2 : 3;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, cx, cy, cz;  // o, d, d x o
};

// den + t*den + u*den + v*den of one pair: K1's four chains (pair_t)
__device__ __forceinline__ float pair_sum(const float (&k)[NCOEF],
                                          const Ray& r) {
  const float den = fmaf(k[2], r.dz, fmaf(k[1], r.dy, __fmul_rn(k[0], r.dx)));
  const float tden = __fadd_rn(
      fmaf(k[5], r.oz, fmaf(k[4], r.oy, __fmul_rn(k[3], r.ox))), k[6]);
  const float uden = fmaf(k[12], r.cz, fmaf(k[11], r.cy,
                     fmaf(k[10], r.cx, fmaf(k[9], r.dz,
                     fmaf(k[8], r.dy, __fmul_rn(k[7], r.dx))))));
  const float vden = fmaf(k[18], r.cz, fmaf(k[17], r.cy,
                     fmaf(k[16], r.cx, fmaf(k[15], r.dz,
                     fmaf(k[14], r.dy, __fmul_rn(k[13], r.dx))))));
  return __fadd_rn(__fadd_rn(den, tden), __fadd_rn(uden, vden));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most the newest group of this thread's copies is pending
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float lane4(const float4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

template <int TILE>
__global__ void __launch_bounds__(32 * WARPS, MIN_CTAS)
matmul_only_kernel(const uint32_t* __restrict__ rel, int nwords,
                   const float* __restrict__ pack,
                   const float* __restrict__ feat, long long row_stride,
                   int nt, long long n, int block, float* __restrict__ out_t,
                   int32_t* __restrict__ out_i) {
  constexpr int PARTS = TILE / STAGE;  // stages a tile
  static_assert(TILE % STAGE == 0, "whole stages");
  // per warp, two stages: [stage][coefficient][triangle]
  __shared__ __align__(16) float ring[WARPS][2][NCOEF][STAGE];

  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const long long ray0 = (long long)blockIdx.x * WARP_RAYS;

  Ray r[RAYS];
#pragma unroll
  for (int q = 0; q < RAYS; ++q) {
    const long long i = ray0 + lane + 32 * q;
    float f[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = i < n ? pack[k * n + i] : 0.f;
    r[q] = Ray{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8]};
  }

  // the warp's set bits of the CTA's words row: those of rank wib, wib +
  // WARPS, ... in order, below nt
  const uint32_t* words = rel + ray0 / block * nwords;
  int wi = -1, rank = 0;
  uint32_t bits = 0u;
  auto next_tile = [&]() -> int {
    for (;;) {
      while (bits == 0u) {
        if (++wi >= nwords) return -1;
        bits = __ldg(words + wi);
      }
      const int j = wi * 32 + __ffs(bits) - 1;
      bits &= bits - 1u;
      if (j >= nt) return -1;
      if (rank++ % WARPS == wib) return j;
    }
  };

  // copy part h of tile j into stage s: lane takes pieces lane + 32m
  auto issue = [&](int s, int j, int h) {
    const float* src = feat + (long long)j * 4 * TILE + h * STAGE;
    float* dst = &ring[wib][s][0][0];
    for (int p = lane; p < PIECES; p += 32) {
      const int k = p >> 4, col = (p & 15) * 4;
      cp_async16(dst + k * STAGE + col,
                 src + coef_row(k) * row_stride + coef_group(k) * TILE + col);
    }
  };

  float acc[RAYS];
#pragma unroll
  for (int q = 0; q < RAYS; ++q) acc[q] = 0.f;

  int j = next_tile(), h = 0, s = 0;
  bool have = j >= 0;  // a stage is in flight for the compute below
  if (have) issue(0, j, 0);
  cp_async_commit();
  while (have) {
    // start the next stage, then wait for this one
    if (++h == PARTS) {
      j = next_tile();
      h = 0;
    }
    const bool more = j >= 0;
    if (more) issue(s ^ 1, j, h);
    cp_async_commit();
    cp_async_wait_one();
    __syncwarp();

    const float* st = &ring[wib][s][0][0];
#pragma unroll 1
    for (int g = 0; g < GROUPS; ++g) {
      float4 c4[NCOEF];
#pragma unroll
      for (int k = 0; k < NCOEF; ++k)
        c4[k] = *reinterpret_cast<const float4*>(st + k * STAGE + 4 * g);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float kk[NCOEF];
#pragma unroll
        for (int k = 0; k < NCOEF; ++k) kk[k] = lane4(c4[k], t);
#pragma unroll
        for (int q = 0; q < RAYS; ++q)
          acc[q] = __fadd_rn(acc[q], pair_sum(kk, r[q]));
      }
    }
    __syncwarp();  // every lane is done with stage s before it is refilled
    s ^= 1;
    have = more;
  }

  // warp 0 adds the other warps' sums, in warp order
  __shared__ float part_sum[WARPS][RAYS][32];
#pragma unroll
  for (int q = 0; q < RAYS; ++q) part_sum[wib][q][lane] = acc[q];
  __syncthreads();  // the only CTA barrier
  if (wib != 0) return;
  for (int o = 1; o < WARPS; ++o)
#pragma unroll
    for (int q = 0; q < RAYS; ++q)
      acc[q] = __fadd_rn(acc[q], part_sum[o][q][lane]);
#pragma unroll
  for (int q = 0; q < RAYS; ++q) {
    const long long i = ray0 + lane + 32 * q;
    if (i < n) {
      out_t[i] = acc[q];
      out_i[i] = 0;
    }
  }
}

template <int TILE>
int launch(const uint32_t* rel, int nwords, const float* pack,
           const float* feat, long long row_stride, int nt, long long n,
           int block, float* out_t, int32_t* out_i, cudaStream_t stream) {
  // the ring and the sums take 40,960 B a CTA: ask for the largest
  // shared-memory carveout (on the current device) so that 4 CTAs fit an SM
  const cudaError_t e = cudaFuncSetAttribute(
      matmul_only_kernel<TILE>, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const long long ctas = (n + WARP_RAYS - 1) / WARP_RAYS;
  matmul_only_kernel<TILE><<<(unsigned)ctas, 32 * WARPS, 0, stream>>>(
      rel, nwords, pack, feat, row_stride, nt, n, block, out_t, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `tile`: the table's triangles a tile, 128, 256 or 512; `block`: the rays
// a relevance block, 128 or 256.  Anything else is refused
// (cudaErrorInvalidValue) before a launch.
int prt_matmul_only(const uint32_t* rel, int nwords, const float* pack,
                    const float* feat, long long row_stride, int nt, int tile,
                    long long n, int block, float* out_t, int32_t* out_i,
                    void* stream) {
  // cp.async copies 16-byte pieces: the table and its rows must be aligned
  if ((uintptr_t)feat % 16 || row_stride % 4 || (block != 128 && block != 256))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 128:
      return launch<128>(rel, nwords, pack, feat, row_stride, nt, n, block,
                         out_t, out_i, s);
    case 256:
      return launch<256>(rel, nwords, pack, feat, row_stride, nt, n, block,
                         out_t, out_i, s);
    case 512:
      return launch<512>(rel, nwords, pack, feat, row_stride, nt, n, block,
                         out_t, out_i, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
