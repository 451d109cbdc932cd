// T1: the compute-only ablation of K1 (csrc/mesh_brute.cu), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel tools/bench_kernel.py:make_matmul_only
// (launched by run_matmul_only), the matmul-only leg of the reference's K1
// microbenchmark.
//
// What it computes (the TPU kernel's function): for each ray, the sum over
// the tiles whose relevance bit is set for the ray's block of the column
// sums of A_tile^T . p, i.e. over those tiles' 128 triangles of
// den + t*den + u*den + v*den.  Inputs: the relevance words of
// mesh_brute._block_relevance (one row of ceil(nt/32) 32-bit words per
// block of `block` rays, bit j = tile j), the ray pack p [16, N] (rows
// o, d, d x o, 1; the rows past 9 meet all-zero coefficient rows) and the
// coefficient table A [16, 4*Tpad].  Outputs: t [N] (the sum) and i [N]
// (all zero, as the TPU kernel writes them).
//
// Work split: one thread per ray, `block` rays a CTA (128, K1's CTA, or
// 256, the TPU tool's block).  The relevance bit is the same for every
// thread of the CTA, so the tile loop branches uniformly; a relevant tile's
// 19 non-zero coefficient rows are staged in shared memory as K1 stages
// them, and each thread runs K1's four FFMA dot-product chains over the
// tile's 128 triangles and adds them to a running sum.  Nothing else: no
// slab test, no hit test, no division.  So the kernel times the part of
// K1's work that a tensor-core redesign would replace.
//
// Bound: FP32 instruction throughput, 37 operations a (ray, triangle) pair
// of a relevant tile (the four chains 33, the three adds and the running
// sum 4), over the pairs this run's bits select.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;  // triangles per tile (mesh_brute.TILE)
constexpr int NCOEF = 19;  // non-zero coefficient rows of a tile

// (table row, column group) of each non-zero coefficient, as in K1
__constant__ int kRow[NCOEF] = {3, 4, 5, 0, 1, 2, 9, 3, 4, 5, 6, 7, 8,
                                3, 4, 5, 6, 7, 8};
__constant__ int kGroup[NCOEF] = {0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2,
                                  3, 3, 3, 3, 3, 3};

__global__ void __launch_bounds__(256)
matmul_only_kernel(const uint32_t* __restrict__ rel, int nwords,
                   const float* __restrict__ pack,
                   const float* __restrict__ feat, long long row_stride,
                   int nt, long long n, float* __restrict__ out_t,
                   int32_t* __restrict__ out_i) {
  __shared__ float coef[NCOEF][TILE];

  const int tid = threadIdx.x;
  const long long i = (long long)blockIdx.x * blockDim.x + tid;
  const bool inb = i < n;

  // the ray pack's feature rows, [o, d, d x o] (row 9 is 1 and meets the
  // t*den constant, added as K1 adds it)
  float f[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = inb ? pack[(long long)k * n + i] : 0.f;
  const float ox = f[0], oy = f[1], oz = f[2];
  const float dx = f[3], dy = f[4], dz = f[5];
  const float cx = f[6], cy = f[7], cz = f[8];

  const uint32_t* words = rel + (long long)blockIdx.x * nwords;
  float acc = 0.f;
  for (int j = 0; j < nt; ++j) {
    if (((__ldg(words + (j >> 5)) >> (j & 31)) & 1u) == 0u) continue;

    const float* tile = feat + (long long)j * 4 * TILE;
    for (int e = tid; e < NCOEF * TILE; e += blockDim.x) {
      const int k = e / TILE, c = e - k * TILE;
      coef[k][c] = tile[kRow[k] * row_stride + kGroup[k] * TILE + c];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      const float den = fmaf(coef[2][c], dz,
                        fmaf(coef[1][c], dy, __fmul_rn(coef[0][c], dx)));
      const float tden = __fadd_rn(
          fmaf(coef[5][c], oz,
               fmaf(coef[4][c], oy, __fmul_rn(coef[3][c], ox))),
          coef[6][c]);
      const float uden = fmaf(coef[12][c], cz, fmaf(coef[11][c], cy,
                         fmaf(coef[10][c], cx, fmaf(coef[9][c], dz,
                         fmaf(coef[8][c], dy, __fmul_rn(coef[7][c], dx))))));
      const float vden = fmaf(coef[18][c], cz, fmaf(coef[17][c], cy,
                         fmaf(coef[16][c], cx, fmaf(coef[15][c], dz,
                         fmaf(coef[14][c], dy, __fmul_rn(coef[13][c], dx))))));
      acc = __fadd_rn(acc, __fadd_rn(__fadd_rn(den, tden),
                                     __fadd_rn(uden, vden)));
    }
    __syncthreads();
  }

  if (inb) {
    out_t[i] = acc;
    out_i[i] = 0;
  }
}

}  // namespace

extern "C" {

int prt_matmul_only(const uint32_t* rel, int nwords, const float* pack,
                    const float* feat, long long row_stride, int nt,
                    long long n, int block, float* out_t, int32_t* out_i,
                    void* stream) {
  const long long blocks = (n + block - 1) / block;
  matmul_only_kernel<<<(unsigned)blocks, block, 0, (cudaStream_t)stream>>>(
      rel, nwords, pack, feat, row_stride, nt, n, out_t, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
