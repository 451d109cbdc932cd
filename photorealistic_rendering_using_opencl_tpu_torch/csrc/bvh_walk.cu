// W1: the skip-link BVH walk for Hopper (sm_90a): warps that refill their
// finished lanes from their CTA's block of rays.
//
// No TPU kernel: it replaces the reference's XLA while_loop
// photorealistic_rendering_using_opencl_tpu/ops/intersect.py:293
// _bvh_traverse_chunk (driven by bvh_traverse), the stackless form of the
// OpenCL reference's per-thread stack walk.  Eager PyTorch would go back to
// the host at every node step; here a ray walks the whole tree inside one
// launch.  Its plain twin is the port's intersect._bvh_traverse_chunk, and
// every output (t, tri, u, v, node visits) is bitwise the twin's.
//
// The tree (scene/bvh_build.py: pack_for_device): node rows of 8 floats,
// bmin | bmax | bitcast(miss) | bitcast(meta), meta = (leaf_idx << 3) |
// count for a leaf and 0 for an inner node; links [8M] (hit, miss) pairs,
// one threading for each direction octant (near child first); leaf rows of
// 4 triangles x 9 floats, padded with zero triangles.
//
// A ray's walk: a step reads its node row (two 16-byte loads) and its
// octant's links (one 8-byte load) and slab-tests the box against its best
// t; when the ray enters a leaf's box, the leaf's triangles are tested, in
// order, each against the best t so far.  Then the hit link for an inner
// box the ray enters, the miss link otherwise; an any-hit ray stops at its
// first hit.  The design below changes only which lane walks which ray, and
// when, and how a leaf's bytes are loaded: every ray's node sequence, tests
// and arithmetic are the twin's.
//
// Bound: the tables (under 50 MB up to ~300,000 triangles) stay in the
// 50 MB L2, so device memory gives only the tables once and the rays' own
// bytes (3.35 TB/s), while every visit's fetch (40 B a visit, 144 B more a
// leaf entered) comes through the L2 at its read rate; against the slab
// and triangle tests' FP32 operations over 67 TFLOP/s.  chip_smoke.py
// (w1_bound) computes the three from the counters below and a measured L2
// rate, and takes the largest.  The walk is bound by the latency of each
// step's dependent L2 round trip, hidden by the warps an SM holds, and by
// the steps that idle lanes sit through.  What the first design (one
// thread a ray, 128 rays a CTA, 80 registers) lost there, and what this
// one does:
// - a warp lived as long as its longest walk, and lanes whose ray was done
//   idled in it (node-loop SIMT efficiency 0.19-0.54 on chip_smoke.py's
//   phase 21 populations).  Here a CTA takes a block of BLOCK_RAYS rays a
//   lane, handed out by a counter in shared memory: a warp claims rays for
//   its idle lanes (one atomic, lanes by rank in a ballot), and its busy
//   lanes leave their walk to refill once REFILL lanes are idle, while the
//   block has rays.  An inactive ray is finished at fetch.  A pool for the
//   whole launch (one wave of persistent CTAs, a global counter) lost on
//   the coherent populations: the warps' rays came from far-apart parts of
//   the batch, and a lane had only ~4 rays to refill with (PERF.md);
// - the leaf branch kept a leaf's 36 floats live (80 registers, 24 warps an
//   SM).  Here a triangle's 9 floats are loaded (three 16-byte pieces) just
//   before its test: 64 registers, 32 warps an SM.
// Nothing is allocated and no other kernel runs: the pool lives in shared
// memory.
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
#include <stdint.h>

// chip_smoke.py's refill sweep builds copies with other values; the
// library is built with this one
#ifndef PRT_W1_REFILL
#define PRT_W1_REFILL 16
#endif

namespace {

constexpr int THREADS = 128;
constexpr int BLOCK_RAYS = 2;  // rays a lane, on average, in a CTA's block
constexpr int LEAF = 4;        // triangles a leaf row holds
constexpr float EPS = 1e-5f;   // ops/math.py EPS
constexpr unsigned FULL = 0xffffffffu;
// a warp's busy lanes leave their walk for a refill once this many of its
// lanes are idle; picked by chip_smoke.py's sweep on phase 21's populations
constexpr int REFILL = PRT_W1_REFILL;
static_assert(REFILL >= 1 && REFILL <= 32, "REFILL is a count of lanes");

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
// t_best; t, u, v are set either way (they do not depend on t_best)
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

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(FULL, x, s);
  return x;
}

// the lane's first in the group of lanes running this instruction
__device__ __forceinline__ bool first_active(int lane) {
  return lane == __ffs(__activemask()) - 1;
}

// triangle k (9 floats from float 9k) of a 144-byte leaf row: the three
// 16-byte pieces that hold it
template <int k>
__device__ __forceinline__ void leaf_triangle(const float4* row, V3& p0,
                                              V3& p1, V3& p2) {
  constexpr int q = 9 * k / 4, s = 9 * k % 4;
  const float4 a = row[q], b = row[q + 1], c = row[q + 2];
  const float f[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                       b.z, b.w, c.x, c.y, c.z, c.w};
  p0 = {f[s], f[s + 1], f[s + 2]};
  p1 = {f[s + 3], f[s + 4], f[s + 5]};
  p2 = {f[s + 6], f[s + 7], f[s + 8]};
}

template <int k>
__device__ __forceinline__ void leaf_test(const float4* row, int leaf,
                                          int count, V3 o, V3 d, float& t,
                                          float& u, float& v, int& tri) {
  if (k < count) {
    V3 p0, p1, p2;
    leaf_triangle<k>(row, p0, p1, p2);
    float tk, uk, vk;
    if (tri_test(p0, p1, p2, o, d, t, tk, uk, vk)) {
      t = tk;
      u = uk;
      v = vk;
      tri = leaf * LEAF + k;
    }
  }
}

// at least one CTA an SM: ptxas then gives the render instance 64
// registers (32 warps an SM), which measured faster than the 56 (36 warps)
// it takes without the bound
template <bool kCount>
__global__ void __launch_bounds__(THREADS, 1)
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
  // the CTA's block of rays [first, first + block_n), handed out in order
  __shared__ unsigned handed;
  if (threadIdx.x == 0) handed = 0;
  __syncthreads();
  const long long first = (long long)blockIdx.x * THREADS * BLOCK_RAYS;
  const long long block_n = min((long long)THREADS * BLOCK_RAYS, n - first);
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  // the work counters: a lane's visits, leaves entered and triangle tests;
  // the warp steps and the warp steps with a leaf entered, counted by the
  // first lane of each group of lanes that runs them together
  unsigned long long c_visits = 0, c_leaves = 0, c_tests = 0;
  unsigned long long c_wsteps = 0, c_wleaf = 0;
  // the lane's ray in flight
  V3 o = {0.f, 0.f, 0.f}, d = o, id = o;
  long long ray = 0;
  unsigned base = 0;
  float t = 0.f, u = 0.f, v = 0.f;
  int tri = -1, node = 0, steps = 0;
  bool anyh = false, busy = false, more = true;

  for (;;) {
    unsigned idle = __ballot_sync(FULL, !busy);
    // refill: the block's next popc(idle) rays to the idle lanes by rank
    while (more && (idle == FULL || __popc(idle) >= REFILL)) {
      const unsigned want = __popc(idle);
      unsigned start = 0;
      if (lane == 0) start = atomicAdd(&handed, want);
      start = __shfl_sync(FULL, start, 0);
      more = start + want < block_n;
      const long long j = first + start + __popc(idle & below);
      if (!busy && j < first + block_n) {
        ray = j;
        t = t_init[j];
        if (active[j] && m > 0) {
          o = {origin[3 * j], origin[3 * j + 1], origin[3 * j + 2]};
          d = {direction[3 * j], direction[3 * j + 1], direction[3 * j + 2]};
          id = {inv_dir(d.x), inv_dir(d.y), inv_dir(d.z)};
          base = (unsigned)((d.x < 0.f) | ((d.y < 0.f) << 1) |
                            ((d.z < 0.f) << 2)) * (unsigned)m;
          anyh = any_hit[j] != 0;
          u = v = 0.f;
          tri = -1;
          node = steps = 0;
          busy = true;
        } else {  // finished at fetch: it visits no node
          out_t[j] = t;
          out_tri[j] = -1;
          out_u[j] = 0.f;
          out_v[j] = 0.f;
          if (out_steps) out_steps[j] = 0;
        }
      }
      idle = __ballot_sync(FULL, !busy);
    }
    if (idle == FULL) break;  // no ray left in the warp or its block

    // the busy lanes walk, each its own ray, as in the first design: until
    // the ray is done, or, while the block has rays, until REFILL lanes
    // are idle
    if (busy) {
      do {
        if (kCount && first_active(lane)) ++c_wsteps;
        ++steps;
        const float4 a = __ldg(nodes + 2 * node);
        const float4 b = __ldg(nodes + 2 * node + 1);
        const int2 lk = __ldg(links + (base + (unsigned)node));
        const float lx = __fmul_rn(__fsub_rn(a.x, o.x), id.x);
        const float ly = __fmul_rn(__fsub_rn(a.y, o.y), id.y);
        const float lz = __fmul_rn(__fsub_rn(a.z, o.z), id.z);
        const float hx = __fmul_rn(__fsub_rn(a.w, o.x), id.x);
        const float hy = __fmul_rn(__fsub_rn(b.x, o.y), id.y);
        const float hz = __fmul_rn(__fsub_rn(b.y, o.z), id.z);
        const float entry =
            max_nan(max_nan(max_nan(min_nan(lx, hx), min_nan(ly, hy)),
                            min_nan(lz, hz)),
                    EPS);
        const float exit_ =
            min_nan(min_nan(min_nan(max_nan(lx, hx), max_nan(ly, hy)),
                            max_nan(lz, hz)),
                    t);
        const bool box_hit = entry <= exit_;
        const int meta = __float_as_int(b.w);
        const int count = meta & 7;
        if (box_hit && count > 0) {
          const int leaf = meta >> 3;
          if (kCount) {
            if (first_active(lane)) ++c_wleaf;
            ++c_leaves;
            c_tests += min(count, LEAF);
          }
          const float4* row = leaves + 9 * (long long)leaf;
          leaf_test<0>(row, leaf, count, o, d, t, u, v, tri);
          leaf_test<1>(row, leaf, count, o, d, t, u, v, tri);
          leaf_test<2>(row, leaf, count, o, d, t, u, v, tri);
          leaf_test<3>(row, leaf, count, o, d, t, u, v, tri);
        }
        node = (anyh && tri >= 0) ? m : (box_hit && count == 0) ? lk.x : lk.y;
      } while (node < m && (!more || __popc(__activemask()) > 32 - REFILL));
      if (node >= m) {
        out_t[ray] = t;
        out_tri[ray] = tri;
        out_u[ray] = u;
        out_v[ray] = v;
        if (out_steps) out_steps[ray] = steps;
        if (kCount) c_visits += steps;
        busy = false;
      }
    }
  }

  if (kCount) {
    c_visits = warp_sum(c_visits);
    c_leaves = warp_sum(c_leaves);
    c_tests = warp_sum(c_tests);
    c_wsteps = warp_sum(c_wsteps);
    c_wleaf = warp_sum(c_wleaf);
    if (lane == 0) {
      atomicAdd(&counters[0], c_visits);
      atomicAdd(&counters[1], c_leaves);
      atomicAdd(&counters[2], c_tests);
      atomicAdd(&counters[3], c_wsteps);
      atomicAdd(&counters[4], c_wleaf);
    }
  }
}

}  // namespace

// n > 0 rays, a CTA for each block of THREADS * BLOCK_RAYS; nodes and links
// start on 16-byte boundaries, leaves on 16 (its rows are 144 bytes);
// out_steps and counters (5 words) may be null.
extern "C" int prt_bvh_walk(const float* nodes, const int32_t* links,
                            const float* leaves, int m, const float* origin,
                            const float* direction, const float* t_init,
                            const uint8_t* active, const uint8_t* any_hit,
                            long long n, float* out_t, int32_t* out_tri,
                            float* out_u, float* out_v, int32_t* out_steps,
                            unsigned long long* counters, void* stream) {
  const long long per = (long long)THREADS * BLOCK_RAYS;
  const unsigned blocks = (unsigned)((n + per - 1) / per);
  const cudaStream_t s = (cudaStream_t)stream;
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  const int2* l2 = reinterpret_cast<const int2*>(links);
  const float4* f4 = reinterpret_cast<const float4*>(leaves);
  if (counters)
    bvh_walk_kernel<true><<<blocks, THREADS, 0, s>>>(
        n4, l2, f4, m, origin, direction, t_init, active, any_hit, n, out_t,
        out_tri, out_u, out_v, out_steps, counters);
  else
    bvh_walk_kernel<false><<<blocks, THREADS, 0, s>>>(
        n4, l2, f4, m, origin, direction, t_init, active, any_hit, n, out_t,
        out_tri, out_u, out_v, out_steps, counters);
  return (int)cudaGetLastError();
}
