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
// tile-grouped columns [den | t*den | u*den | v*den], TILE triangles a
// tile: 128, 256 or 512, PRT_MESH_TILE's sizes, one instance of the kernel
// each, picked by the C entry's `tile`).  Inactive lanes never record a
// hit; tiles are visited in table
// order; across tiles a strictly smaller t wins, within a tile the lowest
// index wins ties; an any-hit lane stops after the first tile that occludes
// it and returns that tile's winner; a lane's `exclude` triangle never
// hits; t falls back to t_init on a miss and on any-hit lanes.
//
// What bounds it.  The work depends on the rays: ~41 FP32 operations per
// (ray, triangle) pair of each tile whose padded AABB the ray enters before
// its current best hit, plus ~38 per slab test.  On the cornell_hi tables
// that is 0.2-0.4 ms at the card's 67 TFLOP/s (PERF.md), and the FP32 rate
// was never the limit: the compute-only ablation T1 (csrc/matmul_only.cu)
// ran 125x this kernel's (ray, tile) work in 1.74x its time.  What held the
// first design (one thread per ray, the tile staged per block behind
// __syncthreads_or) 5.5-48x above the bound was its granularity: a staged
// tile cost three block barriers, and each thread whose ray needed it ran
// all 128 triangles alone while most lanes of its warp idled (1-22% of the
// staged thread slots tested triangles).  What bounds this design is the
// slab-test sweep: a warp with a live lane tests every tile's box, in table
// order, so ~1 ms of a render launch is 16,384 warps x 640 tiles of slab
// tests whatever the triangle work (PERF.md).
//
// Design.  One thread per ray, but every decision is a warp's:
// - each block first writes every tile's padded AABB to shared memory
//   (32 B a tile; the pad depends on the cluster alone), behind the one
//   block barrier; the tile loop has none.
// - each live lane slab-tests the tile's box against its current best;
//   __ballot_sync gives the warp's mask; a warp no lane needs skips the
//   tile, and a warp whose lanes are all done leaves the loop.
// - spread mode (fewer than PER_THREAD_FROM lanes need the tile): every
//   lane tests TILE / 32 of the tile's triangles (c = lane + 32q), PASS of them
//   a pass, their 19 non-zero coefficients each loaded (coalesced) into
//   registers; for each needing lane (walked with __ffs) its ray is
//   broadcast with __shfl_sync, every lane tests its triangles, and a
//   5-step xor-shuffle reduction takes the lexicographic minimum of (t, c),
//   which is exactly the sequential loop's "strict <, lowest c first".  The
//   owning lane keeps the minimum over the passes and applies the
//   across-tile rule.  Every lane slot tests a triangle.  Fewer triangles a
//   pass hold fewer registers, for more warps an SM, which the slab tests
//   (most of the render path's time) need.
// - per-thread mode (at least PER_THREAD_FROM lanes need it): each
//   needing lane runs the TILE triangles itself, the coefficients broadcast
//   from L1/L2 (the whole table, ~21 MB for cornell_hi, sits in the 50 MB
//   L2; a warp-private copy in shared memory measured slower, PERF.md).
// The per-pair arithmetic is the first design's, op by op, so every (ray,
// triangle) t is bit-identical to it and to the plain twin.
// Plain FP32 FFMA throughout (no TF32/bf16 tensor cores, no fast math):
// the single-pass reduced-precision form flips winners (see PERF.md).
//
// `norel` (PRT_MESH_NOREL, the reference's debug switch) skips the slab
// tests: every live lane needs every tile.  The result is the same, since
// the padded prune is conservative; only the work grows.
//
// Work counters: when `counters` is not null, the kernel also adds up, in
// five 64-bit words, the (warp, tile) pairs a warp processed, the (ray,
// tile) pairs whose ray needed the tile's triangles, the (ray, tile) slab
// tests of live rays, and of the first two those run in per-thread mode.
// They measure the data-dependent work that bounds the kernel and the lane
// slots it spends on it; the render path passes null and pays one uniform
// branch per tile.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int NCOEF = 19;     // non-zero coefficient rows of a tile
constexpr float EPS = 1e-5f;  // ops/math.py EPS
constexpr unsigned FULL = 0xffffffffu;

// The configuration: rays per block, the popcount from which a warp
// switches to per-thread mode (33: never), and the triangles a lane holds
// per spread-mode pass.  Chosen by `python3 chip_smoke.py --k1-sweep`,
// which builds this file once for each configuration of its grid through
// these macros (the kernel library is built with the defaults alone) and
// times each on phase 3's populations; its table is in PERF.md.
#ifndef PRT_K1_BLOCK_RAYS
#define PRT_K1_BLOCK_RAYS 128
#endif
#ifndef PRT_K1_PER_THREAD_FROM
#define PRT_K1_PER_THREAD_FROM 32
#endif
#ifndef PRT_K1_PASS
#define PRT_K1_PASS 2
#endif
constexpr int BLOCK_RAYS = PRT_K1_BLOCK_RAYS;
constexpr int PER_THREAD_FROM = PRT_K1_PER_THREAD_FROM;
constexpr int PASS = PRT_K1_PASS;
static_assert(BLOCK_RAYS % 32 == 0 && BLOCK_RAYS <= 1024, "whole warps");
static_assert(PER_THREAD_FROM >= 1 && PER_THREAD_FROM <= 33, "a popcount");

// (table row, column group) of the k-th non-zero coefficient; the group is
// den(0) | t*den(1) | u*den(2) | v*den(3), the row indexes the ray feature
// [o(0:3), d(3:6), d x o(6:9), 1(9)]:
//   den: rows 3-5; t*den: rows 0-2, 9; u*den, v*den: rows 3-8 each
__host__ __device__ constexpr int coef_row(int k) {
  return k < 3 ? 3 + k : k < 6 ? k - 3 : k == 6 ? 9 : k < 13 ? k - 4 : k - 10;
}
__host__ __device__ constexpr int coef_group(int k) {
  return k < 3 ? 0 : k < 7 ? 1 : k < 13 ? 2 : 3;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, cx, cy, cz;  // o, d, d x o
  int excl;
};

__device__ __forceinline__ Ray shfl_ray(const Ray& r, int src) {
  Ray s;
  s.ox = __shfl_sync(FULL, r.ox, src);
  s.oy = __shfl_sync(FULL, r.oy, src);
  s.oz = __shfl_sync(FULL, r.oz, src);
  s.dx = __shfl_sync(FULL, r.dx, src);
  s.dy = __shfl_sync(FULL, r.dy, src);
  s.dz = __shfl_sync(FULL, r.dz, src);
  s.cx = __shfl_sync(FULL, r.cx, src);
  s.cy = __shfl_sync(FULL, r.cy, src);
  s.cz = __shfl_sync(FULL, r.cz, src);
  s.excl = __shfl_sync(FULL, r.excl, src);
  return s;
}

// One ray-triangle test -> t, +inf when it does not hit.  Each dot product
// is one FFMA chain over the ray features in table-row order (the zero rows
// would add exact zeros), the operation sequence of an FP32 GEMM's k-loop,
// which is what the twin's matmul rounds like.
__device__ __forceinline__ float pair_t(const float (&k)[NCOEF], const Ray& r,
                                        int tri) {
  const float den = fmaf(k[2], r.dz, fmaf(k[1], r.dy, __fmul_rn(k[0], r.dx)));
  const float tden = __fadd_rn(
      fmaf(k[5], r.oz, fmaf(k[4], r.oy, __fmul_rn(k[3], r.ox))), k[6]);
  const float uden = fmaf(k[12], r.cz, fmaf(k[11], r.cy,
                     fmaf(k[10], r.cx, fmaf(k[9], r.dz,
                     fmaf(k[8], r.dy, __fmul_rn(k[7], r.dx))))));
  const float vden = fmaf(k[18], r.cz, fmaf(k[17], r.cy,
                     fmaf(k[16], r.cx, fmaf(k[15], r.dz,
                     fmaf(k[14], r.dy, __fmul_rn(k[13], r.dx))))));
  const float den2 = __fmul_rn(den, den);
  const float m = fminf(fminf(__fmul_rn(uden, den), __fmul_rn(vden, den)),
                        __fmul_rn(__fsub_rn(__fsub_rn(den, uden), vden), den));
  const float td = __fmul_rn(tden, den);
  if (m >= 0.f && td > __fmul_rn(EPS, den2) && tri != r.excl)
    return __fdiv_rn(td, den2);
  return CUDART_INF_F;
}

__device__ __forceinline__ float safe_inv(float d) {
  // the reference's slab guard: |d| < 1e-12 -> +-1e-12
  if (fabsf(d) < 1e-12f) d = d >= 0.f ? 1e-12f : -1e-12f;
  return 1.f / d;
}

// The lane's running best over one tile's triangles, then the across-tile
// rule: a strictly smaller t wins; an any-hit lane ends at its first
// occluding tile.
__device__ __forceinline__ void take_tile(float tmin, int tri, bool anyh,
                                          float& best, int& best_i,
                                          bool& live) {
  if (tmin < best) {
    best = anyh ? -CUDART_INF_F : tmin;
    best_i = tri;
    if (anyh) live = false;  // first occluding tile ends the lane
  }
}

// Tile j's triangles for the warp's needing lanes `mask` (see the header).
// Spread mode takes the lane's SLOTS triangles in SLOTS / PASS passes of
// PASS triangles: fewer coefficient registers, more broadcasts and
// reductions.
template <int TILE>
__device__ __forceinline__ void test_tile(
    const float* __restrict__ feat, long long row_stride, int j,
    unsigned mask, bool need, int lane, const Ray& r, bool anyh, float& best,
    int& best_i, bool& live) {
  constexpr int SLOTS = TILE / 32;  // triangles a lane tests in spread mode
  static_assert(SLOTS % PASS == 0, "PASS divides a lane's triangles");
  const float* tile = feat + (long long)j * 4 * TILE;
  const int base = j * TILE;
  if (__popc(mask) < PER_THREAD_FROM) {
    // spread mode; the owning lane's minimum over the passes so far (a
    // later pass's triangles have higher indices: strict < keeps ties)
    float own_t = CUDART_INF_F;
    int own_c = TILE;
#pragma unroll
    for (int q0 = 0; q0 < SLOTS; q0 += PASS) {
      // this lane's triangles c = lane + 32q of the pass, in registers
      float cf[PASS][NCOEF];
#pragma unroll
      for (int p = 0; p < PASS; ++p)
#pragma unroll
        for (int k = 0; k < NCOEF; ++k)
          cf[p][k] = __ldg(tile + coef_row(k) * row_stride
                           + coef_group(k) * TILE + lane + 32 * (q0 + p));
      unsigned left = mask;
      while (left) {
        const int src = __ffs(left) - 1;
        left &= left - 1;
        const Ray s = shfl_ray(r, src);
        float tmin = CUDART_INF_F;
        int targ = TILE;
#pragma unroll
        for (int p = 0; p < PASS; ++p) {
          const int c = lane + 32 * (q0 + p);
          const float t = pair_t(cf[p], s, base + c);
          if (t < tmin) { tmin = t; targ = c; }
        }
        // lexicographic minimum of (t, c) over the warp
#pragma unroll
        for (int off = 16; off; off >>= 1) {
          const float ot = __shfl_xor_sync(FULL, tmin, off);
          const int oc = __shfl_xor_sync(FULL, targ, off);
          if (ot < tmin || (ot == tmin && oc < targ)) { tmin = ot; targ = oc; }
        }
        if (lane == src && tmin < own_t) { own_t = tmin; own_c = targ; }
      }
    }
    take_tile(own_t, base + own_c, anyh, best, best_i, live);
    return;
  }
  // per-thread mode: each needing lane runs the tile's TILE triangles, the
  // coefficients broadcast from L1/L2
  if (!need) return;
  float tmin = CUDART_INF_F;
  int targ = -1;
#pragma unroll 4
  for (int c = 0; c < TILE; ++c) {
    float k[NCOEF];
#pragma unroll
    for (int q = 0; q < NCOEF; ++q)
      k[q] = __ldg(tile + coef_row(q) * row_stride + coef_group(q) * TILE + c);
    const float t = pair_t(k, r, base + c);
    if (t < tmin) { tmin = t; targ = c; }
  }
  take_tile(tmin, base + targ, anyh, best, best_i, live);
}

template <int TILE>
__global__ void __launch_bounds__(BLOCK_RAYS)
mesh_brute_kernel(const float* __restrict__ feat, long long row_stride,
                  int nt, const float* __restrict__ clusters,
                  const float* __restrict__ origin,
                  const float* __restrict__ direction,
                  const float* __restrict__ t_init,
                  const uint8_t* __restrict__ active,
                  const uint8_t* __restrict__ any_hit,
                  const int32_t* __restrict__ exclude, long long n,
                  float* __restrict__ out_t, int32_t* __restrict__ out_tri,
                  unsigned long long* __restrict__ counters, int norel) {
  // every tile's padded AABB, (lo.xyz, hi.x) (hi.yz, -, -), filled once a
  // block: the pad is a function of the cluster alone
  extern __shared__ float4 boxes[];
  for (int j = threadIdx.x; j < nt; j += BLOCK_RAYS) {
    const float* cl = clusters + 8 * (long long)j;
    const float lx = cl[0], ly = cl[1], lz = cl[2];
    const float hx = cl[3], hy = cl[4], hz = cl[5];
    // pad the box so rounding in the den-multiplied t can never place a
    // hit outside it (empty tiles keep their inverted +-3e38 bounds)
    const float pad = 1e-4f * (1.f + fmaxf(fmaxf(fabsf(lx), fabsf(hx)),
                                 fmaxf(fmaxf(fabsf(ly), fabsf(hy)),
                                       fmaxf(fabsf(lz), fabsf(hz)))));
    boxes[2 * j] = make_float4(lx - pad, ly - pad, lz - pad, hx + pad);
    boxes[2 * j + 1] = make_float4(hy + pad, hz + pad, 0.f, 0.f);
  }
  __syncthreads();  // the only block barrier

  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * BLOCK_RAYS + threadIdx.x;
  const bool inb = i < n;

  Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, -1};
  float tinit = 0.f;
  bool act = false, anyh = false;
  if (inb) {
    r.ox = origin[3 * i + 0]; r.oy = origin[3 * i + 1];
    r.oz = origin[3 * i + 2];
    r.dx = direction[3 * i + 0]; r.dy = direction[3 * i + 1];
    r.dz = direction[3 * i + 2];
    tinit = t_init[i];
    act = active[i] != 0;
    anyh = any_hit[i] != 0;
    r.excl = exclude[i];
  }
  // d x o, the reference's feature order (mesh_brute._ray_features), each
  // product and difference rounded on its own (no FMA contraction), as the
  // twin's separate elementwise ops round them
  r.cx = __fsub_rn(__fmul_rn(r.dy, r.oz), __fmul_rn(r.dz, r.oy));
  r.cy = __fsub_rn(__fmul_rn(r.dz, r.ox), __fmul_rn(r.dx, r.oz));
  r.cz = __fsub_rn(__fmul_rn(r.dx, r.oy), __fmul_rn(r.dy, r.ox));
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);

  // inactive lanes park at -inf: they can never record a hit
  float best = act ? tinit : -CUDART_INF_F;
  int best_i = -1;
  bool live = inb && act;

  for (int j = 0; j < nt; ++j) {
    const unsigned live_mask = __ballot_sync(FULL, live);
    if (!live_mask) break;  // every lane of the warp is done
    bool need = false;
    if (live && norel) {
      need = true;
    } else if (live) {
      // the padded slab test, bounded by the lane's current best
      const float4 a = boxes[2 * j], b = boxes[2 * j + 1];
      const float ax = (a.x - r.ox) * ix, bx = (a.w - r.ox) * ix;
      const float ay = (a.y - r.oy) * iy, by = (b.x - r.oy) * iy;
      const float az = (a.z - r.oz) * iz, bz = (b.y - r.oz) * iz;
      const float ent = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)),
                              fmaxf(fminf(az, bz), 0.f));
      const float ext = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)),
                              fmaxf(az, bz));
      need = ent <= fminf(ext, best);
    }
    const unsigned mask = __ballot_sync(FULL, need);
    if (counters && lane == 0) {
      const int k_need = __popc(mask);
      atomicAdd(&counters[2], (unsigned long long)__popc(live_mask));
      if (mask) {
        atomicAdd(&counters[0], 1ull);
        atomicAdd(&counters[1], (unsigned long long)k_need);
        if (k_need >= PER_THREAD_FROM) {
          atomicAdd(&counters[3], 1ull);
          atomicAdd(&counters[4], (unsigned long long)k_need);
        }
      }
    }
    if (mask)
      test_tile<TILE>(feat, row_stride, j, mask, need, lane, r, anyh, best,
                      best_i, live);
  }

  if (inb) {
    const bool got = best_i >= 0;
    out_t[i] = (got && isfinite(best)) ? best : tinit;
    out_tri[i] = best_i;
  }
}

template <int TILE>
int launch(const float* feat, long long row_stride, int nt,
           const float* clusters, const float* origin, const float* direction,
           const float* t_init, const uint8_t* active, const uint8_t* any_hit,
           const int32_t* exclude, long long n, float* out_t, int32_t* out_tri,
           unsigned long long* counters, int norel, cudaStream_t stream) {
  // the tile boxes take 32 B a tile, whatever the tile's size; above the
  // default 48 KB a launch must opt in, on the current device, which this
  // sets on every such launch (a few microseconds; 1,536 tiles and up).
  // The card's opt-in limit (227 KB on an H100: 7,264 tiles) makes larger
  // tables fail here; the brute backend's largest, 262,144 triangles, is
  // 2,048 tiles of 128.
  const int smem = nt * 2 * (int)sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mesh_brute_kernel<TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (n + BLOCK_RAYS - 1) / BLOCK_RAYS;
  mesh_brute_kernel<TILE><<<(unsigned)blocks, BLOCK_RAYS, smem, stream>>>(
      feat, row_stride, nt, clusters, origin, direction, t_init, active,
      any_hit, exclude, n, out_t, out_tri, counters, norel);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `tile`: the table's triangles a tile, 128, 256 or 512; any other size is
// refused (cudaErrorInvalidValue) before a launch
int prt_mesh_brute(const float* feat, long long row_stride, int nt, int tile,
                   const float* clusters, const float* origin,
                   const float* direction, const float* t_init,
                   const uint8_t* active, const uint8_t* any_hit,
                   const int32_t* exclude, long long n, float* out_t,
                   int32_t* out_tri, unsigned long long* counters,
                   int norel, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 128:
      return launch<128>(feat, row_stride, nt, clusters, origin, direction,
                         t_init, active, any_hit, exclude, n, out_t, out_tri,
                         counters, norel, s);
    case 256:
      return launch<256>(feat, row_stride, nt, clusters, origin, direction,
                         t_init, active, any_hit, exclude, n, out_t, out_tri,
                         counters, norel, s);
    case 512:
      return launch<512>(feat, row_stride, nt, clusters, origin, direction,
                         t_init, active, any_hit, exclude, n, out_t, out_tri,
                         counters, norel, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* prt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
