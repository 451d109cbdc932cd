// K1's reduced-precision forms on the tensor cores (K1tc): closest-hit /
// any-hit mesh intersection with the den-multiplied Moller-Trumbore
// quantities computed by bf16 wgmma, for Hopper (sm_90a).  The kernel and
// its launchers; mesh_brute_tc.cu holds the C entries and the instances
// for tiles of 128 triangles, mesh_brute_tc_256.cu and mesh_brute_tc_512.cu
// those for 256 and 512 (three sources, so that nvcc builds the 27
// instances, 3 forms x 3 tiles x 3 blocks, in parallel).
//
// Replaces the split and bf16-table branches of the Pallas TPU kernel
// photorealistic_rendering_using_opencl_tpu/ops/mesh_brute.py:_make_kernel
// (:301; the split at :339-357, the bf16 table at :366-368, the dot at
// :396-404), launched by _intersect_pallas, together with the XLA-side
// relevance pass _block_relevance that fed it.  K1 (mesh_brute.cu) stays
// the FP32 form; this kernel runs the three reduced ones
// (ops/mesh_brute.py: reduced_form):
//   form 0, "bf16":   one term, table and ray features rounded to bf16 (the
//                     bf16 table, or PRT_MESH_PRECISION=default's single
//                     pass over the f32 table cast to bf16);
//   form 1, "bf16x3": the stacked-K split, terms (0,0) (1,0) (0,1);
//   form 2, "bf16x6": terms (0,0) (1,0) (2,0) (0,1) (1,1) (0,2),
// a term (i, j) adding table part i times ray part j, each part bf16 and
// rounded to nearest-even from what the parts before it left
// (mesh_brute.hi_lo_parts; the table's parts come split, the rays' are
// split here with __float2bfloat16_rn and subtraction).
//
// What it computes (ops/mesh_brute.py: intersect_reduced_plain, its plain
// version): the TPU kernel's result in the form.  A block is the
// reference's BLOCK rays in lane order (PRT_MESH_BLOCK: 128, 256 or 512),
// a tile its TILE triangles (PRT_MESH_TILE: 128, 256 or 512), one instance
// for each pair; a tile is tested for every lane of a block when some
// active ray of the block enters the tile's unpadded box, from EPS on, no
// later than its t_init (the reference's relevance words, all ones under
// `norel`).  In a reduced form this prune is part of the result: a false
// hit can lie outside its tile's box, so the kernel takes the reference's
// prune and not K1's padded per-lane one.  In a split form the control
// values (t_init, the active and any-hit flags, the excluded triangle) are
// rebuilt from the ray's distinct parts, as the reference's kernel rebuilds
// them: bf16x3's two parts round t_init, and t falls back to that rounded
// value.  Tiles go in table order; across tiles a strictly smaller t wins,
// within a tile the lowest index wins ties; an inactive lane never records
// a hit; an any-hit lane stops after the first tile that occludes it, with
// that tile's winner; a lane's excluded triangle never hits.
//
// What bounds it: for every relevant (block, tile) pair, every ray of the
// block against every triangle of the tile, T terms of 4 quantities over
// K = 16 features (10 of them non-zero): 128 T bf16 tensor-core operations
// a pair, 80 T of them needed; ~13 FP32 operations a pair for the hit
// test, ~20 a (ray, tile) for the relevance slab tests; the bytes are the
// table's image (128 B a triangle and table part), the boxes and the rays,
// once.  At the card's peaks (989 TFLOP/s bf16, 67 TFLOP/s FP32) the
// tensor work bounds bf16x6 and bf16x3 and the FP32 hit test bf16.
//
// Design (Hopper: wgmma on a shared-memory ring filled by bulk copies).
// - Rays are wgmma's M, the table N: one m64nNk16 bf16 wgmma a term, A (64
//   rays x 16 features) in registers, built once a ray part, B (16 features
//   x N columns) a slab of the table in shared memory; a form's T terms
//   chain into the same f32 accumulators in Form<>'s order, the first one
//   writing them.
// - The table's image (mesh_brute.tc_fragments) orders a tile's columns
//   n = 16m + 8h + 2tig + b <-> (triangle 4m + tig, quantity 2h + b) and
//   lays them out as wgmma's K-major core matrices without swizzle
//   ([n / 8][feature / 8][n % 8][feature % 8]).  With m64nN's accumulator
//   layout (register 4i + e of lane 4g + tig in warp w: row 16w + g + 8(e
//   >> 1), column 8i + 2tig + (e & 1)) a thread then holds den, t*den,
//   u*den and v*den of one (ray, triangle) pair in d[8m + 2r + {0, 1, 4,
//   5}] (ray g + 8r, triangle 4m + tig): the hit test runs in registers,
//   with the plain version's f32 operations, each rounded on its own, and
//   a ray's candidates lie on the 4 lanes of a quad, so a tile's winner is
//   2 xor-shuffles.  The test takes two passes over a slab's 2 x N / 16
//   pairs a thread: the sign tests of every pair with no branch (so that
//   the pairs' chains interleave), then the division of the few that pass,
//   skipped where an exact FMA sign shows t cannot beat the lane's tile
//   minimum.
// - A CTA is 128 rays: two consumer warpgroups of 64 and one producer warp.
//   The producer walks the block's relevant tiles and keeps the ring's
//   stages of STAGE_TRIS triangles (every table part of the form; as many
//   stages as RING_BYTES holds, at most MAX_STAGES) in flight, one 1-D
//   cp.async.bulk a part completing on the stage's mbarrier; the consumers
//   wgmma the stage that has arrived, N / 4 triangles at a time, test the
//   hits and release the stage.  Three CTAs share an SM (72 registers a
//   thread), so one's tensor work overlaps the others' hit tests.
// - A relevance block of 256 or 512 rays is a cluster of 2 or 4 CTAs: each
//   slab-tests only its own rays, ORs its words into every CTA of the
//   cluster through distributed shared memory, and one cluster barrier
//   later every CTA holds the block's words.  A warp first tests its rays
//   against the union box of a word's 32 tiles and skips the word when no
//   ray enters it (exact: see add_relevance).
// - An any-hit lane leaves at its first occluder; a warp whose lanes are
//   all done skips the hit tests, a warpgroup whose lanes are all done
//   stops starting wgmma and only drains the ring; the producer stops when
//   both warpgroups of its CTA are done.
// N, the stage, the ring and the CTAs an SM are constexprs chosen on the
// card (PERF.md: K1tc); a second accumulator set (the next slab's wgmma
// during this one's hit test) and N = 128 were slower there.
//
// Where it parts from the plain version: the tensor cores add a term's 16
// products (and the accumulator) in their own order and rounding, so a
// quantity may differ from the plain version's f32 sum in its last bits;
// a winner can move only where that moves a sign test or a t comparison.
// (On an H100 its outputs are bitwise those of the mma.sync kernel it
// replaced: the same products, in the same order, on the same units.)
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// the launch's arguments (ops/mesh_brute.py: _MeshBruteTcKernel)
struct TcArgs {
  const void* frag;  // the form's table image, mesh_brute.tc_fragments
  int nt;            // tiles of the table
  const float* clusters;
  const float* origin;
  const float* direction;
  const float* t_init;
  const uint8_t* active;
  const uint8_t* any_hit;
  const int32_t* exclude;
  long long n;
  float* out_t;
  int32_t* out_tri;
  int norel;
};

// TC_INFO ints of an instance's resources (prt_mesh_brute_tc_resources)
constexpr int TC_INFO = 10;

// the launch of one tile size's instances for relevance block `block` and
// form `form`, or, with `info` given, that instance's resources (TC_INFO
// ints) and no launch; cudaErrorInvalidValue for a block or form with no
// instance (one definition in each of the three sources)
int mesh_brute_tc_launch_128(const TcArgs& a, int block, int form,
                             cudaStream_t stream, int* info);
int mesh_brute_tc_launch_256(const TcArgs& a, int block, int form,
                             cudaStream_t stream, int* info);
int mesh_brute_tc_launch_512(const TcArgs& a, int block, int form,
                             cudaStream_t stream, int* info);

namespace {

// the kernel's shape, chosen on the card (PERF.md, K1tc): columns a wgmma
// (N / 4 triangles), triangles a ring stage, the most stages and the
// ring's bytes (a form takes as many stages of its parts as fit, up to the
// most), CTAs an SM the registers are capped for
constexpr int N = 64;
constexpr int STAGE_TRIS = 64;
constexpr int MAX_STAGES = 4;
constexpr int RING_BYTES = 73728;
constexpr int CTAS_PER_SM = 3;
static_assert(N == 64, "the wgmma below is m64n64k16");
static_assert(STAGE_TRIS % (N / 4) == 0 && 128 % STAGE_TRIS == 0,
              "whole wgmma slabs a stage, whole stages a tile");

constexpr int MAX_WORDS = 256;        // relevance words a block: 8,192 tiles
constexpr float EPS = 1e-5f;          // ops/math.py EPS
constexpr unsigned FULL = 0xffffffffu;
constexpr int CTA_RAYS = 128;         // two consumer warpgroups of 64 rays
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 32 * CONSUMER_WARPS + 32;  // and the producer warp
constexpr int TRI_BYTES = 128;        // 4 quantities x 16 features, bf16
// the table image's core matrices: the next 8 features 128 bytes on (the
// leading byte offset), the next 8 columns 256 bytes on (the stride byte
// offset); no swizzle
constexpr uint64_t DESC_HI = ((uint64_t)(128 >> 4) << 16)
                             | ((uint64_t)(256 >> 4) << 32);

// the forms' terms (table part i, ray part j), in the reference's order
template <int FORM> struct Form;
template <> struct Form<0> {
  static constexpr int T = 1, RAY_PARTS = 1, TABLE_PARTS = 1;
  static constexpr bool SPLIT = false;
  __device__ static constexpr int ti(int) { return 0; }
  __device__ static constexpr int tj(int) { return 0; }
};
template <> struct Form<1> {
  static constexpr int T = 3, RAY_PARTS = 2, TABLE_PARTS = 2;
  static constexpr bool SPLIT = true;
  __device__ static constexpr int ti(int t) { return t == 1 ? 1 : 0; }
  __device__ static constexpr int tj(int t) { return t == 2 ? 1 : 0; }
};
template <> struct Form<2> {
  static constexpr int T = 6, RAY_PARTS = 3, TABLE_PARTS = 3;
  static constexpr bool SPLIT = true;
  __device__ static constexpr int ti(int t) {
    return t == 1 || t == 4 ? 1 : t == 2 ? 2 : 0;
  }
  __device__ static constexpr int tj(int t) {
    return t < 3 ? 0 : t < 5 ? 1 : 2;
  }
};

// the dynamic shared memory of a form with P table parts: the ring (which
// holds the words' union boxes before the first stage arrives), its full
// and empty mbarriers, the CTA's own relevance words and the block's, and
// the flags (each consumer warpgroup's "done", the producer's count of
// stages started once it stops)
template <int P> struct Smem {
  static constexpr int PART_BYTES = STAGE_TRIS * TRI_BYTES;
  static constexpr int STAGE_BYTES = P * PART_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE_BYTES < MAX_STAGES
                                    ? RING_BYTES / STAGE_BYTES : MAX_STAGES;
  static constexpr int FULL_BAR = STAGES * STAGE_BYTES;
  static constexpr int EMPTY_BAR = FULL_BAR + 8 * STAGES;
  static constexpr int REL_OWN = EMPTY_BAR + 8 * STAGES;
  static constexpr int REL = REL_OWN + 4 * MAX_WORDS;
  static constexpr int FLAGS = REL + 4 * MAX_WORDS;
  static constexpr int BYTES = FLAGS + 16;
  static_assert(PART_BYTES % 16 == 0, "bulk copies of whole 16 bytes");
  static_assert(STAGES >= 2, "a ring of two stages at least");
  static_assert(FULL_BAR >= 32 * MAX_WORDS, "the union boxes fit the ring");
};

// x cut into P bf16 parts, as mesh_brute.hi_lo_parts cuts it
template <int P>
__device__ __forceinline__ void split(float x, __nv_bfloat16 (&p)[P]) {
  float rem = x;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    p[k] = __float2bfloat16_rn(rem);
    rem = __fsub_rn(rem, __bfloat162float(p[k]));
  }
}

// a control value as the split forms rebuild it: the parts summed in f32,
// first to last
template <int P>
__device__ __forceinline__ float rebuilt(float x) {
  __nv_bfloat16 p[P];
  split<P>(x, p);
  float s = __bfloat162float(p[0]);
#pragma unroll
  for (int k = 1; k < P; ++k) s = __fadd_rn(s, __bfloat162float(p[k]));
  return s;
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo)
         | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ float safe_inv(float d) {
  // the reference's slab guard: |d| < 1e-12 -> +-1e-12
  if (fabsf(d) < 1e-12f) d = d >= 0.f ? 1e-12f : -1e-12f;
  return __fdiv_rn(1.f, d);
}

// ---- shared memory, mbarriers, bulk copies, clusters (PTX) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// `bytes` from global `src` to this CTA's shared `dst`, completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// `v` ORed into the word at shared address `addr` of the cluster's CTA
// `rank`
__device__ __forceinline__ void cluster_or(uint32_t addr, uint32_t rank,
                                           uint32_t v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("red.shared::cluster.or.b32 [%0], %1;\n" ::"r"(remote), "r"(v)
               : "memory");
}

// whether `v` holds on some thread of consumer warpgroup `wg` (its 128
// threads meet at named barrier 1 + wg)
__device__ __forceinline__ bool warpgroup_any(bool v, int wg) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, 128, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r) : "r"((uint32_t)v), "r"(1 + wg) : "memory");
  return r != 0;
}

// ---- wgmma ----

// the descriptor of a K-major B slab at shared address `addr`
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return DESC_HI | (uint64_t)((addr & 0x3FFFF) >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma (CUTLASS's warpgroup_fence_operand)
template <int K>
__device__ __forceinline__ void fence_operand(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32) = A (64 x 16, bf16, registers) . B (16 x N, bf16, shared
// memory at `desc`), the first term of a slab (d written, not read), and
// d += A . B, each later term
__device__ __forceinline__ void wgmma_first(float (&d)[N / 2],
    const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

__device__ __forceinline__ void wgmma_acc(float (&d)[N / 2],
    const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Whether a ray (origin o, inverse direction i, t_init tin) enters the box
// (lo4.x, lo4.y, lo4.z) - (lo4.w, hi4.x, hi4.y) from EPS on, no later than
// tin: the reference's slab test, each difference and product rounded on
// its own.  (Its first exit bound is fminf(inf, x), which is x: no operand
// here is NaN.)
__device__ __forceinline__ bool enters(float4 lo4, float4 hi4, float ox,
                                       float oy, float oz, float ix,
                                       float iy, float iz, float tin) {
  float lo = __fmul_rn(__fsub_rn(lo4.x, ox), ix);
  float hi = __fmul_rn(__fsub_rn(lo4.w, ox), ix);
  float ent = fmaxf(EPS, fminf(lo, hi)), ext = fmaxf(lo, hi);
  lo = __fmul_rn(__fsub_rn(lo4.y, oy), iy);
  hi = __fmul_rn(__fsub_rn(hi4.x, oy), iy);
  ent = fmaxf(ent, fminf(lo, hi)); ext = fminf(ext, fmaxf(lo, hi));
  lo = __fmul_rn(__fsub_rn(lo4.z, oz), iz);
  hi = __fmul_rn(__fsub_rn(hi4.y, oz), iz);
  ent = fmaxf(ent, fminf(lo, hi)); ext = fminf(ext, fmaxf(lo, hi));
  return ent <= fminf(ext, tin);
}

// The union box of each relevance word's 32 tile boxes, into `ub` (two
// float4 a word, as the table's boxes; .w of the second: bit 0 when some
// box counts, bit 1 when some box is the table's empty sentinel, min >
// max, for which the union says nothing); warp `warp` of `warps` takes
// every warps-th word, a lane a box, a butterfly of minima and maxima.
__device__ __forceinline__ void union_boxes(float4* ub, const TcArgs& a,
                                            int warp, int warps, int lane) {
  const float4* boxes = (const float4*)a.clusters;
  const int nwords = (a.nt + 31) >> 5;
  for (int w = warp; w < nwords; w += warps) {
    const int j = 32 * w + lane;
    float4 lo4 = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                             -CUDART_INF_F);
    float4 hi4 = make_float4(-CUDART_INF_F, -CUDART_INF_F, 0.f, 0.f);
    bool counts = false, empty = false;
    if (j < a.nt) {
      const float4 l = __ldg(boxes + 2 * j), h = __ldg(boxes + 2 * j + 1);
      empty = !(l.x <= l.w && l.y <= h.x && l.z <= h.y);
      if (!empty) {
        lo4 = l;
        hi4 = h;
        counts = true;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo4.x = fminf(lo4.x, __shfl_xor_sync(FULL, lo4.x, off));
      lo4.y = fminf(lo4.y, __shfl_xor_sync(FULL, lo4.y, off));
      lo4.z = fminf(lo4.z, __shfl_xor_sync(FULL, lo4.z, off));
      lo4.w = fmaxf(lo4.w, __shfl_xor_sync(FULL, lo4.w, off));
      hi4.x = fmaxf(hi4.x, __shfl_xor_sync(FULL, hi4.x, off));
      hi4.y = fmaxf(hi4.y, __shfl_xor_sync(FULL, hi4.y, off));
    }
    const int flags = (__any_sync(FULL, counts) ? 1 : 0)
                      | (__any_sync(FULL, empty) ? 2 : 0);
    if (lane == 0) {
      ub[2 * w] = lo4;
      ub[2 * w + 1] = make_float4(hi4.x, hi4.y, 0.f, __int_as_float(flags));
    }
  }
}

// The CTA's part of its block's relevance words (the reference's
// _block_relevance): bit j of `rel` set when some active ray of the CTA
// enters tile j's unpadded box from EPS on, no later than its t_init.  A
// consumer thread tests ray r against the words of parity `par`, a ballot
// a tile, one atomicOr a warp and word.  A word whose union box (`ub`)
// no active ray of the warp enters is skipped whole: rounding is
// monotone, so a box inside the union is entered only by a ray that
// enters the union, and the words are those of the tile-by-tile tests.
// A word holding an empty tile's sentinel box is tested tile by tile.
__device__ __forceinline__ void add_relevance(unsigned* rel, const float4* ub,
                                              const TcArgs& a, long long r,
                                              int lane, int par) {
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tin = 0.f;
  const bool act = r < a.n && __ldg(a.active + r) != 0;
  if (act) {
    ox = __ldg(a.origin + 3 * r + 0); oy = __ldg(a.origin + 3 * r + 1);
    oz = __ldg(a.origin + 3 * r + 2);
    dx = __ldg(a.direction + 3 * r + 0); dy = __ldg(a.direction + 3 * r + 1);
    dz = __ldg(a.direction + 3 * r + 2);
    tin = __ldg(a.t_init + r);
  }
  if (!__any_sync(FULL, act)) return;
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const float4* boxes = (const float4*)a.clusters;
  const int nwords = (a.nt + 31) >> 5;
  for (int w = par; w < nwords; w += 2) {
    const float4 ulo = ub[2 * w], uhi = ub[2 * w + 1];
    const int flags = __float_as_int(uhi.w);
    if (!(flags & 2)) {
      const bool maybe = act && (flags & 1)
                         && enters(ulo, uhi, ox, oy, oz, ix, iy, iz, tin);
      if (!__any_sync(FULL, maybe)) continue;
    }
    unsigned word = 0;
    const int last = min(32, a.nt - 32 * w);
    // every lane tests (an inactive one on zeros, its answer dropped), so
    // that the tests of several tiles interleave
#pragma unroll 4
    for (int jj = 0; jj < last; ++jj) {
      const float4 lo4 = __ldg(boxes + 2 * (32 * w + jj));
      const float4 hi4 = __ldg(boxes + 2 * (32 * w + jj) + 1);
      const bool need = act && enters(lo4, hi4, ox, oy, oz, ix, iy, iz, tin);
      if (__ballot_sync(FULL, need)) word |= 1u << jj;
    }
    if (lane == 0 && word) atomicOr(&rel[w], word);
  }
}

// the block's relevance word w, without bits past the table's last tile
__device__ __forceinline__ unsigned rel_word(const unsigned* rel, int w,
                                             int nt) {
  const int rest = nt - 32 * w;
  return rest >= 32 ? rel[w] : rel[w] & ((1u << rest) - 1u);
}

template <int FORM, int TILE, int BLOCK>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
mesh_brute_tc_kernel(const TcArgs a) {
  using F = Form<FORM>;
  using L = Smem<F::TABLE_PARTS>;
  constexpr int SPAN = BLOCK / CTA_RAYS;      // CTAs a relevance block
  constexpr int SLABS = TILE / STAGE_TRIS;    // stages a tile
  constexpr int CHUNKS = STAGE_TRIS / (N / 4);  // wgmma a stage and term
  constexpr int NM = N / 16;                  // triangles a thread a chunk
  static_assert(BLOCK % CTA_RAYS == 0 && SPAN <= 8, "a cluster a block");
  static_assert(TILE % STAGE_TRIS == 0, "whole stages a tile");
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t ring = smem_u32(smem);
  const uint32_t full_bar = ring + L::FULL_BAR;
  const uint32_t empty_bar = ring + L::EMPTY_BAR;
  unsigned* rel_own = (unsigned*)(smem + L::REL_OWN);
  unsigned* rel = (unsigned*)(smem + L::REL);
  volatile int* flags = (volatile int*)(smem + L::FLAGS);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nt = a.nt, nwords = (nt + 31) >> 5;
  const long long first = (long long)blockIdx.x * CTA_RAYS;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMER_WARPS);
    }
    flags[0] = 0;
    flags[1] = 0;
    flags[2] = 0x7fffffff;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int w = tid; w < nwords; w += THREADS) {
    rel_own[w] = 0u;
    rel[w] = a.norel ? FULL : 0u;
  }
  // the block's relevance words: each CTA its own rays, ORed into every
  // CTA of the cluster
  float4* ub = (float4*)smem;  // the words' union boxes, in the ring
  if (!a.norel) union_boxes(ub, a, warp, CONSUMER_WARPS + 1, lane);
  if constexpr (SPAN > 1) cluster_sync(); else __syncthreads();
  if (!a.norel && warp < CONSUMER_WARPS)
    add_relevance(SPAN > 1 ? rel_own : rel, ub, a, first + (tid & 127), lane,
                  tid >> 7);
  __syncthreads();
  if constexpr (SPAN > 1) {
    if (!a.norel) {
      for (int w = tid; w < nwords; w += THREADS) {
        const unsigned v = rel_own[w];
        if (v) {
#pragma unroll
          for (int r = 0; r < SPAN; ++r) cluster_or(smem_u32(rel + w), r, v);
        }
      }
    }
    cluster_sync();
  }

  if (warp == CONSUMER_WARPS) {
    // the producer: every stage of every relevant tile, in table order,
    // until both consumer warpgroups are done
    if (lane == 0) {
      // the union boxes' shared memory, read by the threads, becomes the
      // bulk copies' (the async proxy's) from here on
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint8_t* frag = (const uint8_t*)a.frag;
      int slab = 0;
      bool stop = false;
      for (int w = 0; w < nwords && !stop; ++w) {
        unsigned bits = rel_word(rel, w, nt);
        while (bits) {
          const int j = 32 * w + __ffs(bits) - 1;
          bits &= bits - 1u;
          if (flags[0] && flags[1]) {
            stop = true;
            break;
          }
#pragma unroll 1
          for (int s = 0; s < SLABS; ++s, ++slab) {
            const int st = slab % L::STAGES;
            mbar_wait(empty_bar + 8 * st, ((slab / L::STAGES) & 1) ^ 1);
            mbar_expect_tx(full_bar + 8 * st, L::STAGE_BYTES);
#pragma unroll
            for (int p = 0; p < F::TABLE_PARTS; ++p)
              bulk_copy(ring + st * L::STAGE_BYTES + p * L::PART_BYTES,
                        frag + (((long long)p * nt + j) * TILE
                                + s * STAGE_TRIS) * TRI_BYTES,
                        L::PART_BYTES, full_bar + 8 * st);
          }
        }
      }
      flags[2] = slab;
    }
    return;
  }

  // a consumer thread: rays g and g + 8 of its warp's 16 rows of its
  // warpgroup's 64
  const int wg = warp >> 2, g = lane >> 2, tig = lane & 3;
  uint32_t afr[F::RAY_PARTS][4];
  float best[2], tin_r[2];
  int best_i[2], ex_i[2];
  bool anyh_r[2], live[2], inb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = first + 64 * wg + 16 * (warp & 3) + g + 8 * r;
    inb[r] = i < a.n;
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    float tin = 0.f, exf = 0.f;
    bool act = false, anyh = false;
    if (inb[r]) {
      ox = a.origin[3 * i + 0]; oy = a.origin[3 * i + 1];
      oz = a.origin[3 * i + 2];
      dx = a.direction[3 * i + 0]; dy = a.direction[3 * i + 1];
      dz = a.direction[3 * i + 2];
      tin = a.t_init[i];
      act = a.active[i] != 0;
      anyh = a.any_hit[i] != 0;
      exf = (float)a.exclude[i];
    }
    // A: features 2tig, 2tig+1 (register r) and 2tig+8, 2tig+9 (register
    // 2 + r) of row g + 8r, each ray part j a register set; a padded lane
    // is the reference's zero pack.  d x o, each product and difference
    // rounded on its own.
    const float cx = __fsub_rn(__fmul_rn(dy, oz), __fmul_rn(dz, oy));
    const float cy = __fsub_rn(__fmul_rn(dz, ox), __fmul_rn(dx, oz));
    const float cz = __fsub_rn(__fmul_rn(dx, oy), __fmul_rn(dy, ox));
    const float one = inb[r] ? 1.f : 0.f;
    const float v0 = tig == 0 ? ox : tig == 1 ? oz : tig == 2 ? dy : cx;
    const float v1 = tig == 0 ? oy : tig == 1 ? dx : tig == 2 ? dz : cy;
    const float v2 = tig == 0 ? cz : 0.f;
    const float v3 = tig == 0 ? one : 0.f;
    __nv_bfloat16 p0[F::RAY_PARTS], p1[F::RAY_PARTS], p2[F::RAY_PARTS],
        p3[F::RAY_PARTS];
    split<F::RAY_PARTS>(v0, p0);
    split<F::RAY_PARTS>(v1, p1);
    split<F::RAY_PARTS>(v2, p2);
    split<F::RAY_PARTS>(v3, p3);
#pragma unroll
    for (int j = 0; j < F::RAY_PARTS; ++j) {
      afr[j][r] = pack2(p0[j], p1[j]);
      afr[j][2 + r] = pack2(p2[j], p3[j]);
    }
    // the control values as the form reads them
    tin_r[r] = tin;
    float ex_r = exf;
    bool act_r = act;
    anyh_r[r] = anyh;
    if (F::SPLIT) {
      tin_r[r] = rebuilt<F::RAY_PARTS>(tin);
      ex_r = rebuilt<F::RAY_PARTS>(exf);
      act_r = rebuilt<F::RAY_PARTS>(act ? 1.f : 0.f) > 0.5f;
      anyh_r[r] = rebuilt<F::RAY_PARTS>(anyh ? 1.f : 0.f) > 0.5f;
    }
    // inactive lanes park at -inf: they can never record a hit.  So does a
    // lane whose t_init is not finite in bf16 (inf, or past bf16's range)
    // in form 0: the reference multiplies its control values by the
    // table's zero rows, and 0 x inf makes every quantity of the lane NaN.
    // (The split forms' rebuilt t_init is NaN then, which no t beats.)
    const bool nan_lane =
        !F::SPLIT && !isfinite(__bfloat162float(__float2bfloat16_rn(tin)));
    // the excluded triangle as the index it equals (the reference compares
    // the index as a float with the rebuilt value; one that is no index
    // excludes nothing)
    ex_i[r] = ex_r >= 0.f && ex_r < 16777216.f && ex_r == floorf(ex_r)
                  ? (int)ex_r : -1;
    best[r] = act_r && !nan_lane ? tin_r[r] : -CUDART_INF_F;
    best_i[r] = -1;
    live[r] = inb[r] && act_r && !nan_lane;
  }

  int total = 0;  // stages the producer starts while a warpgroup is live
  for (int w = 0; w < nwords; ++w) total += __popc(rel_word(rel, w, nt));
  total *= SLABS;
  float d[N / 2];
  int slab = 0;
  bool wg_live = true;
  for (int w = 0; w < nwords && wg_live; ++w) {
    unsigned bits = rel_word(rel, w, nt);
    while (bits) {
      const int j = 32 * w + __ffs(bits) - 1;
      bits &= bits - 1u;
      wg_live = warpgroup_any(live[0] || live[1], wg);
      if (!wg_live) break;
      const bool warp_live = __any_sync(FULL, live[0] || live[1]);
      float rt[2] = {CUDART_INF_F, CUDART_INF_F};
      int rc[2] = {TILE, TILE};
#pragma unroll 1
      for (int s = 0; s < SLABS; ++s, ++slab) {
        const int st = slab % L::STAGES;
        mbar_wait(full_bar + 8 * st, (slab / L::STAGES) & 1);
        const uint32_t stage = ring + st * L::STAGE_BYTES;
#pragma unroll 1
        for (int c = 0; c < CHUNKS; ++c) {
          wgmma_fence();
#pragma unroll
          for (int t = 0; t < F::T; ++t) {
            const uint64_t desc = b_desc(stage + F::ti(t) * L::PART_BYTES
                                         + c * (N / 4) * TRI_BYTES);
            if (t == 0) wgmma_first(d, afr[F::tj(t)], desc);
            else wgmma_acc(d, afr[F::tj(t)], desc);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_operand(d);
          if (!warp_live) continue;
          // the hit test of this thread's 2 x NM (ray, triangle) pairs, ray
          // g + 8r and triangle 4m + tig of the slab, whose index in the
          // tile grows with (s, c, m), so a strict < keeps the lowest.
          // First every pair's sign tests, with no branch, so that the
          // pairs interleave; then the division of the pairs that pass
          float td[NM][2], den2[NM][2];
          unsigned pass = 0;
#pragma unroll
          for (int m = 0; m < NM; ++m) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float den = d[8 * m + 2 * r], tden = d[8 * m + 2 * r + 1];
              const float uden = d[8 * m + 2 * r + 4];
              const float vden = d[8 * m + 2 * r + 5];
              den2[m][r] = __fmul_rn(den, den);
              const float mn = fminf(
                  fminf(__fmul_rn(uden, den), __fmul_rn(vden, den)),
                  __fmul_rn(__fsub_rn(__fsub_rn(den, uden), vden), den));
              td[m][r] = __fmul_rn(tden, den);
              if (mn >= 0.f && td[m][r] > __fmul_rn(EPS, den2[m][r]))
                pass |= 1u << (2 * m + r);
            }
          }
          if (!pass) continue;
          const int c0 = s * STAGE_TRIS + c * (N / 4) + tig;
#pragma unroll
          for (int m = 0; m < NM; ++m) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              // t = td / den2 beats rt only when td - rt den2 < 0 (the
              // FMA's sign is exact): the other passes skip the division
              if (((pass >> (2 * m + r)) & 1u)
                  && __fmaf_rn(-rt[r], den2[m][r], td[m][r]) < 0.f
                  && j * TILE + c0 + 4 * m != ex_i[r]) {
                const float t = __fdiv_rn(td[m][r], den2[m][r]);
                if (t < rt[r]) { rt[r] = t; rc[r] = c0 + 4 * m; }
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar + 8 * st);
      }
      // the tile's winner of each ray: the lexicographic minimum of (t,
      // index) over the quad; the across-tile rule; an any-hit lane ends
      // at its first occluder
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float ot = __shfl_xor_sync(FULL, rt[r], off);
          const int oc = __shfl_xor_sync(FULL, rc[r], off);
          if (ot < rt[r] || (ot == rt[r] && oc < rc[r])) {
            rt[r] = ot;
            rc[r] = oc;
          }
        }
        if (rt[r] < best[r]) {
          best[r] = anyh_r[r] ? -CUDART_INF_F : rt[r];
          best_i[r] = j * TILE + rc[r];
          if (anyh_r[r]) live[r] = false;
        }
      }
    }
  }

  if (!wg_live) {
    // done: tell the producer, then drain the stages it still starts (the
    // other warpgroup may be live), so that no copy is in flight at exit
    if ((tid & 127) == 0) flags[wg] = 1;
    while (slab < total) {
      const int st = slab % L::STAGES;
      int got = 0;
      if (lane == 0) {
        while (!got) {
          if (mbar_try_wait(full_bar + 8 * st, (slab / L::STAGES) & 1)) got = 1;
          else if (flags[2] <= slab) got = 2;
        }
        if (got == 1) mbar_arrive(empty_bar + 8 * st);
      }
      if (__shfl_sync(FULL, got, 0) == 2) break;
      ++slab;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (tig == r && inb[r]) {
      const long long i = first + 64 * wg + 16 * (warp & 3) + g + 8 * r;
      a.out_t[i] = (best_i[r] >= 0 && isfinite(best[r])) ? best[r] : tin_r[r];
      a.out_tri[i] = best_i[r];
    }
  }
}

template <int FORM, int TILE, int BLOCK>
int launch_form(const TcArgs& a, cudaStream_t stream, int* info) {
  constexpr int SPAN = BLOCK / CTA_RAYS;
  constexpr int SMEM = Smem<Form<FORM>::TABLE_PARTS>::BYTES;
  const auto kernel = mesh_brute_tc_kernel<FORM, TILE, BLOCK>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPAN;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (info) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return (int)e;
    int ctas = 0, clusters = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, THREADS,
                                                      SMEM);
    if (e != cudaSuccess) return (int)e;
    cfg.gridDim = dim3(SPAN);
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    const int vals[TC_INFO] = {fa.numRegs, (int)fa.localSizeBytes,
                               (int)fa.sharedSizeBytes, SMEM, THREADS, ctas,
                               clusters, N, Smem<Form<FORM>::TABLE_PARTS>::STAGES,
                               STAGE_TRIS};
    for (int k = 0; k < TC_INFO; ++k) info[k] = vals[k];
    return (int)cudaGetLastError();
  }
  const long long blocks = (a.n + BLOCK - 1) / BLOCK;
  cfg.gridDim = dim3((unsigned)(blocks * SPAN));
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int TILE, int BLOCK>
int launch_block(const TcArgs& a, int form, cudaStream_t stream, int* info) {
  switch (form) {
    case 0: return launch_form<0, TILE, BLOCK>(a, stream, info);
    case 1: return launch_form<1, TILE, BLOCK>(a, stream, info);
    case 2: return launch_form<2, TILE, BLOCK>(a, stream, info);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the instances of one tile: every relevance block and form
template <int TILE>
int launch_tile(const TcArgs& a, int block, int form, cudaStream_t stream,
                int* info) {
  switch (block) {
    case 128: return launch_block<TILE, 128>(a, form, stream, info);
    case 256: return launch_block<TILE, 256>(a, form, stream, info);
    case 512: return launch_block<TILE, 512>(a, form, stream, info);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
