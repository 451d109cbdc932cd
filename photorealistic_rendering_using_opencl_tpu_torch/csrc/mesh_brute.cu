// K1: closest-hit / any-hit mesh intersection by exhaustive, tile-pruned
// Moller-Trumbore testing, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel photorealistic_rendering_using_opencl_tpu/
// ops/mesh_brute.py:_make_kernel (launched by _intersect_pallas), together
// with the XLA-side relevance pass _block_relevance that fed it.
//
// What it computes (same semantics as the TPU kernel): for each ray, the
// lowest-t triangle whose den-multiplied test passes and whose t beats the
// lane's t_init, from the coefficient table of pack_brute ([16, 4*Tpad],
// tile-grouped columns [den | t*den | u*den | v*den], 128 triangles a
// tile).  Inactive lanes never record a hit; across tiles a strictly
// smaller t wins, within a tile the lowest index wins ties; an any-hit lane
// stops after the first tile that occludes it; a lane's `exclude` triangle
// never hits; t falls back to t_init on a miss and on any-hit lanes.
//
// Work split: one thread per ray, 128 rays a block.  For each 128-triangle
// tile every live thread slab-tests its ray against the tile's AABB
// (clusters, padded so the prune stays conservative), bounded by its own
// current best t; __syncthreads_or decides whether the block needs the
// tile; if so the block stages the tile's 19 non-zero coefficient rows
// (9.7 KB) in shared memory and each thread whose own slab test passed
// tests all 128 triangles.  This folds the relevance bitmask into the
// kernel: no [N, tiles] pass, and one kernel for every mesh size.
//
// Bound: FP32 instruction throughput.  A ray-triangle pair costs ~35 FP32
// operations (19 FFMA for the four dot products, the sign tests, one
// division on a hit), so an unpruned 524,288-ray x 81,920-triangle
// dispatch would be ~1.5 PFLOP, tens of seconds at the card's 67 TFLOP/s.
// The per-thread tile skip is what keeps the work near the rays' own paths
// through the mesh: a thread only tests tiles whose AABB its ray enters
// before its current best hit, and a warp whose 32 rays all skip a tile
// executes nothing for it.
// Plain FP32 FFMA throughout (no TF32/bf16 tensor cores, no fast math):
// the single-pass reduced-precision form flips winners (see PERF.md).
//
// Work counters: when `counters` is not null, the kernel also adds up, in
// three 64-bit words, the (block, tile) pairs it tested, the (ray, tile)
// pairs whose thread tested the tile's 128 triangles, and the (ray, tile)
// slab tests of live rays.  They measure the data-dependent work that
// bounds the kernel; the render path passes null and pays one uniform
// branch per tile.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;   // triangles per tile (mesh_brute.TILE)
constexpr int RAYS = 128;   // rays per block, one per thread
constexpr int NCOEF = 19;   // non-zero coefficient rows of a tile
constexpr float EPS = 1e-5f;  // ops/math.py EPS

// (table row, column group) of each non-zero coefficient; the group q is
// den(0) | t*den(1) | u*den(2) | v*den(3), the row indexes the ray feature
// [o(0:3), d(3:6), d x o(6:9), 1(9)].
__constant__ int kRow[NCOEF] = {3, 4, 5,            // den:   n . d
                                0, 1, 2, 9,         // t*den: -n . o + n.p0
                                3, 4, 5, 6, 7, 8,   // u*den
                                3, 4, 5, 6, 7, 8};  // v*den
__constant__ int kGroup[NCOEF] = {0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2,
                                  3, 3, 3, 3, 3, 3};

__device__ __forceinline__ float safe_inv(float d) {
  // the reference's slab guard: |d| < 1e-12 -> +-1e-12
  if (fabsf(d) < 1e-12f) d = d >= 0.f ? 1e-12f : -1e-12f;
  return 1.f / d;
}

__global__ void __launch_bounds__(RAYS)
mesh_brute_kernel(const float* __restrict__ feat, long long row_stride,
                  int nt, const float* __restrict__ clusters,
                  const float* __restrict__ origin,
                  const float* __restrict__ direction,
                  const float* __restrict__ t_init,
                  const uint8_t* __restrict__ active,
                  const uint8_t* __restrict__ any_hit,
                  const int32_t* __restrict__ exclude, long long n,
                  float* __restrict__ out_t, int32_t* __restrict__ out_tri,
                  unsigned long long* __restrict__ counters) {
  __shared__ float coef[NCOEF][TILE];

  const int tid = threadIdx.x;
  const long long i = (long long)blockIdx.x * RAYS + tid;
  const bool inb = i < n;

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f;
  float tinit = 0.f;
  bool act = false, anyh = false;
  int excl = -1;
  if (inb) {
    ox = origin[3 * i + 0]; oy = origin[3 * i + 1]; oz = origin[3 * i + 2];
    dx = direction[3 * i + 0]; dy = direction[3 * i + 1];
    dz = direction[3 * i + 2];
    tinit = t_init[i];
    act = active[i] != 0;
    anyh = any_hit[i] != 0;
    excl = exclude[i];
  }
  // d x o, the reference's feature order (mesh_brute._ray_features), each
  // product and difference rounded on its own (no FMA contraction), as the
  // twin's separate elementwise ops round them
  const float cx = __fsub_rn(__fmul_rn(dy, oz), __fmul_rn(dz, oy));
  const float cy = __fsub_rn(__fmul_rn(dz, ox), __fmul_rn(dx, oz));
  const float cz = __fsub_rn(__fmul_rn(dx, oy), __fmul_rn(dy, ox));
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);

  // inactive lanes park at -inf: they can never record a hit
  float best = act ? tinit : -CUDART_INF_F;
  int best_i = -1;
  bool live = inb && act;

  for (int j = 0; j < nt; ++j) {
    bool need = false;
    if (counters) {
      const unsigned live_mask = __ballot_sync(0xffffffffu, live);
      if ((tid & 31) == 0 && live_mask)
        atomicAdd(&counters[2], (unsigned long long)__popc(live_mask));
    }
    if (live) {
      const float* cl = clusters + 8 * (long long)j;
      const float lx = __ldg(cl + 0), ly = __ldg(cl + 1), lz = __ldg(cl + 2);
      const float hx = __ldg(cl + 3), hy = __ldg(cl + 4), hz = __ldg(cl + 5);
      // pad the box so rounding in the den-multiplied t can never place a
      // hit outside it (empty tiles keep their inverted +-3e38 bounds)
      const float pad = 1e-4f * (1.f + fmaxf(fmaxf(fabsf(lx), fabsf(hx)),
                                   fmaxf(fmaxf(fabsf(ly), fabsf(hy)),
                                         fmaxf(fabsf(lz), fabsf(hz)))));
      const float ax = (lx - pad - ox) * ix, bx = (hx + pad - ox) * ix;
      const float ay = (ly - pad - oy) * iy, by = (hy + pad - oy) * iy;
      const float az = (lz - pad - oz) * iz, bz = (hz + pad - oz) * iz;
      const float ent = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)),
                              fmaxf(fminf(az, bz), 0.f));
      const float ext = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)),
                              fmaxf(az, bz));
      need = ent <= fminf(ext, best);
    }
    if (!__syncthreads_or(need)) continue;
    if (counters) {
      const unsigned need_mask = __ballot_sync(0xffffffffu, need);
      if (tid == 0) atomicAdd(&counters[0], 1ull);
      if ((tid & 31) == 0 && need_mask)
        atomicAdd(&counters[1], (unsigned long long)__popc(need_mask));
    }

    const float* tile = feat + (long long)j * 4 * TILE + tid;
#pragma unroll
    for (int k = 0; k < NCOEF; ++k)
      coef[k][tid] = tile[kRow[k] * row_stride + kGroup[k] * TILE];
    __syncthreads();

    if (need) {
      float tmin = CUDART_INF_F;
      int targ = -1;
      const int base = j * TILE;
#pragma unroll 4
      for (int c = 0; c < TILE; ++c) {
        // each dot product is one FFMA chain over the ray features in
        // table-row order (the zero rows would add exact zeros), the
        // operation sequence of an FP32 GEMM's k-loop
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
        const float den2 = __fmul_rn(den, den);
        const float m = fminf(fminf(__fmul_rn(uden, den), __fmul_rn(vden, den)),
                              __fmul_rn(__fsub_rn(__fsub_rn(den, uden), vden),
                                        den));
        const float td = __fmul_rn(tden, den);
        if (m >= 0.f && td > __fmul_rn(EPS, den2) && base + c != excl) {
          const float s = __fdiv_rn(td, den2);
          if (s < tmin) { tmin = s; targ = c; }
        }
      }
      if (tmin < best) {
        best = anyh ? -CUDART_INF_F : tmin;
        best_i = base + targ;
        if (anyh) live = false;  // first occluding tile ends the lane
      }
    }
    __syncthreads();
  }

  if (inb) {
    const bool got = best_i >= 0;
    out_t[i] = (got && isfinite(best)) ? best : tinit;
    out_tri[i] = best_i;
  }
}

}  // namespace

extern "C" {

int prt_mesh_brute(const float* feat, long long row_stride, int nt,
                   const float* clusters, const float* origin,
                   const float* direction, const float* t_init,
                   const uint8_t* active, const uint8_t* any_hit,
                   const int32_t* exclude, long long n, float* out_t,
                   int32_t* out_tri, unsigned long long* counters,
                   void* stream) {
  const long long blocks = (n + RAYS - 1) / RAYS;
  mesh_brute_kernel<<<(unsigned)blocks, RAYS, 0, (cudaStream_t)stream>>>(
      feat, row_stride, nt, clusters, origin, direction, t_init, active,
      any_hit, exclude, n, out_t, out_tri, counters);
  return (int)cudaGetLastError();
}

const char* prt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
