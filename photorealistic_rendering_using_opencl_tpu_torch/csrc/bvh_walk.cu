// W1: the skip-link BVH walk, one thread a ray, for Hopper (sm_90a).
//
// No TPU kernel: it replaces the reference's XLA while_loop
// photorealistic_rendering_using_opencl_tpu/ops/intersect.py:
// _bvh_traverse_chunk (driven by bvh_traverse), the stackless form of the
// OpenCL reference's per-thread stack walk.  Eager PyTorch would go back to
// the host at every node step; here a ray walks the whole tree in one
// thread.  Its plain twin is the port's intersect._bvh_traverse_chunk, and
// every output (t, tri, u, v, node visits) is bitwise the twin's.
//
// The tree (scene/bvh_build.py: pack_for_device): node rows of 8 floats,
// bmin | bmax | bitcast(miss) | bitcast(meta), meta = (leaf_idx << 3) |
// count for a leaf and 0 for an inner node; links [8M] (hit, miss) pairs,
// one threading for each direction octant (near child first); leaf rows of
// 4 triangles x 9 floats, padded with zero triangles.
//
// A step: the lane's node row (two 16-byte loads) and its octant's links
// (one 8-byte load), the slab test against its best t, and only when the
// ray enters a leaf's box the leaf row (nine 16-byte loads) and its
// triangles, in order, each against the best t so far.  Then the hit link
// for an inner box the ray enters, the miss link otherwise; an any-hit
// lane stops at its first hit.
//
// Bound: the tables (under 50 MB up to ~300,000 triangles) stay in the
// 50 MB L2, so device memory gives only the tables once and the rays' own
// bytes (3.35 TB/s), while every visit's fetch (40 B a visit, 144 B more a
// leaf entered) comes through the L2 at its read rate; against the slab
// and triangle tests' FP32 operations over 67 TFLOP/s.  chip_smoke.py
// (w1_bound) computes the three from the counters below and a measured L2
// rate, and takes the largest.  A first, simple design: lanes of a warp
// diverge as their walks part, and nothing is shared between them.
//
// Numerics, held bitwise to the twin (and the twin to the reference on the
// CPU):
// - XLA's CPU backend contracts the reference's crosses and 3-term dot
//   products into FMAs (component i of a x b is fma(a_j, b_k, -(a_k b_j)),
//   a dot is fma(a2, b2, fma(a1, b1, a0 b0))); the twin rounds those as one
//   FMA too (ops/math.py: fma32), and here they are __fmaf_rn.  Every other
//   product, sum and difference is its own rounding (__fmul_rn, __fadd_rn,
//   __fsub_rn), so no flag can contract more;
// - reciprocals are IEEE divisions (__fdiv_rn), whatever the flags;
// - min and max propagate NaN (PTX min.NaN / max.NaN), as torch.minimum,
//   torch.amax and jnp.minimum do, so a NaN ray's boxes are all missed.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int LEAF = 4;        // triangles a leaf row holds
constexpr float EPS = 1e-5f;   // ops/math.py EPS
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z)};
}

// component i: fma(a_j, b_k, -(a_k * b_j))
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {__fmaf_rn(a.y, b.z, -__fmul_rn(a.z, b.y)),
          __fmaf_rn(a.z, b.x, -__fmul_rn(a.x, b.z)),
          __fmaf_rn(a.x, b.y, -__fmul_rn(a.y, b.x))};
}

// fma(a.z, b.z, fma(a.y, b.y, a.x * b.x))
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return __fmaf_rn(a.z, b.z, __fmaf_rn(a.y, b.y, __fmul_rn(a.x, b.x)));
}

// the reference's triangle test: true when the triangle is hit closer than
// t_best; then t, u, v are set
__device__ __forceinline__ bool tri_test(V3 p0, V3 p1, V3 p2, V3 o, V3 d,
                                         float t_best, float& t, float& u,
                                         float& v) {
  const V3 e1 = sub(p0, p1);
  const V3 e2 = sub(p2, p0);
  const V3 n = cross(e1, e2);
  const V3 c = sub(p0, o);
  const V3 r = cross(d, c);
  const float den = dot(n, d);
  const float inv_det = __fdiv_rn(
      1.0f, fabsf(den) < 1e-20f ? copysignf(1e-20f, den) : den);
  u = __fmul_rn(dot(r, e2), inv_det);
  v = __fmul_rn(dot(r, e1), inv_det);
  const float w = __fsub_rn(__fsub_rn(1.0f, u), v);
  t = __fmul_rn(dot(n, c), inv_det);
  return u >= 0.0f && v >= 0.0f && w >= 0.0f && t > EPS && t < t_best;
}

__device__ __forceinline__ float inv_dir(float x) {
  return __fdiv_rn(1.0f, fabsf(x) < 1e-12f ? copysignf(1e-12f, x) : x);
}

__global__ void __launch_bounds__(THREADS)
bvh_walk_kernel(const float4* __restrict__ nodes,
                const int2* __restrict__ links,
                const float4* __restrict__ leaves, int m,
                const float* __restrict__ origin,
                const float* __restrict__ direction,
                const float* __restrict__ t_init,
                const uint8_t* __restrict__ active,
                const uint8_t* __restrict__ any_hit, long long n,
                float* __restrict__ out_t, int32_t* __restrict__ out_tri,
                float* __restrict__ out_u, float* __restrict__ out_v,
                int32_t* __restrict__ out_steps,
                unsigned long long* __restrict__ counters) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool inb = i < n;
  unsigned visits = 0, leaf_visits = 0, tests = 0;
  if (inb) {
    const V3 o = {origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]};
    const V3 d = {direction[3 * i], direction[3 * i + 1],
                  direction[3 * i + 2]};
    const V3 id = {inv_dir(d.x), inv_dir(d.y), inv_dir(d.z)};
    const long long base =
        (long long)((d.x < 0.f) | ((d.y < 0.f) << 1) | ((d.z < 0.f) << 2)) *
        m;
    const bool anyh = any_hit[i] != 0;
    float t = t_init[i], u = 0.f, v = 0.f;
    int tri = -1;
    int node = active[i] ? 0 : m;
    while (node < m) {
      ++visits;
      const float4 a = nodes[2 * (long long)node];
      const float4 b = nodes[2 * (long long)node + 1];
      const int2 lk = links[base + node];
      const float lx = __fmul_rn(__fsub_rn(a.x, o.x), id.x);
      const float ly = __fmul_rn(__fsub_rn(a.y, o.y), id.y);
      const float lz = __fmul_rn(__fsub_rn(a.z, o.z), id.z);
      const float hx = __fmul_rn(__fsub_rn(a.w, o.x), id.x);
      const float hy = __fmul_rn(__fsub_rn(b.x, o.y), id.y);
      const float hz = __fmul_rn(__fsub_rn(b.y, o.z), id.z);
      const float entry = max_nan(
          max_nan(max_nan(min_nan(lx, hx), min_nan(ly, hy)), min_nan(lz, hz)),
          EPS);
      const float exit_ = min_nan(
          min_nan(min_nan(max_nan(lx, hx), max_nan(ly, hy)), max_nan(lz, hz)),
          t);
      const bool box_hit = entry <= exit_;
      const int meta = __float_as_int(b.w);
      const int count = meta & 7;
      if (box_hit && count > 0) {
        ++leaf_visits;
        const int leaf = meta >> 3;
        const float4* row = leaves + 9 * (long long)leaf;
        float f[36];
#pragma unroll
        for (int q = 0; q < 9; ++q) {
          const float4 x = row[q];
          f[4 * q] = x.x;
          f[4 * q + 1] = x.y;
          f[4 * q + 2] = x.z;
          f[4 * q + 3] = x.w;
        }
#pragma unroll
        for (int k = 0; k < LEAF; ++k) {
          if (k < count) {
            ++tests;
            const float* p = f + 9 * k;
            float tk, uk, vk;
            if (tri_test({p[0], p[1], p[2]}, {p[3], p[4], p[5]},
                         {p[6], p[7], p[8]}, o, d, t, tk, uk, vk)) {
              t = tk;
              u = uk;
              v = vk;
              tri = leaf * LEAF + k;
            }
          }
        }
      }
      node = (box_hit && count == 0) ? lk.x : lk.y;
      if (anyh && tri >= 0) node = m;
    }
    out_t[i] = t;
    out_tri[i] = tri;
    out_u[i] = u;
    out_v[i] = v;
    if (out_steps) out_steps[i] = (int32_t)visits;
  }
  if (counters) {
    const unsigned sv = __reduce_add_sync(FULL, visits);
    const unsigned sl = __reduce_add_sync(FULL, leaf_visits);
    const unsigned st = __reduce_add_sync(FULL, tests);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(&counters[0], (unsigned long long)sv);
      atomicAdd(&counters[1], (unsigned long long)sl);
      atomicAdd(&counters[2], (unsigned long long)st);
    }
  }
}

}  // namespace

// One thread a ray over n > 0 rays; nodes, links and leaves start on
// 16-byte boundaries; out_steps and counters may be null.
extern "C" int prt_bvh_walk(const float* nodes, const int32_t* links,
                            const float* leaves, int m, const float* origin,
                            const float* direction, const float* t_init,
                            const uint8_t* active, const uint8_t* any_hit,
                            long long n, float* out_t, int32_t* out_tri,
                            float* out_u, float* out_v, int32_t* out_steps,
                            unsigned long long* counters, void* stream) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  bvh_walk_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const int2*>(links),
      reinterpret_cast<const float4*>(leaves), m, origin, direction, t_init,
      active, any_hit, n, out_t, out_tri, out_u, out_v, out_steps, counters);
  return (int)cudaGetLastError();
}
