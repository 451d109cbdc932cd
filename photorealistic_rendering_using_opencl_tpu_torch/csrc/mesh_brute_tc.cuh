// K1's reduced-precision forms on the tensor cores: closest-hit / any-hit
// mesh intersection with the den-multiplied Moller-Trumbore quantities
// computed by bf16 mma.sync, for Hopper (sm_90a).  The kernel and its
// launchers; mesh_brute_tc.cu holds the C entry and the instances for
// tiles of 128 triangles, mesh_brute_tc_256.cu and mesh_brute_tc_512.cu
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
// for each pair; a tile is tested for every
// lane of a block when some active ray of the block enters the tile's
// unpadded box, from EPS on, no later than its t_init (the reference's
// relevance words, all ones under `norel`).  In a reduced form this prune
// is part of the result: a false hit can lie outside its tile's box, so
// the kernel takes the reference's prune and not K1's padded per-lane one.
// In a split form the control values (t_init, the active and any-hit
// flags, the excluded triangle) are rebuilt from the ray's distinct parts,
// as the reference's kernel rebuilds them: bf16x3's two parts round
// t_init, and t falls back to that rounded value.  Tiles go in table
// order; across tiles a strictly smaller t wins, within a tile the lowest
// index wins ties; an inactive lane never records a hit; an any-hit lane
// stops after the first tile that occludes it, with that tile's winner; a
// lane's excluded triangle never hits.
//
// Design, simple first.  A CTA is one block of 128 or 256 rays, or half a
// block of 512 (a CTA of 512 threads could hold at most 128 registers a
// thread, fewer than the kernel uses), a warp 32 of them.  The CTA first
// computes the block's relevance bits (each thread slab-tests its ray, and
// in a half block also the other half's ray of its rank, against every
// tile box, a ballot a tile, one atomicOr a warp into shared memory, one
// barrier): the prune is the whole block's, so the two CTAs of a 512-ray
// block compute the same bits, each for itself.  For each relevant tile a
// warp with a live lane runs the tile's TILE triangles in TILE / 16 chunks
// of 16.  A chunk is 4 quantities x 4 groups of 8 rays x T terms of
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: A is quantity q
// (den, t*den, u*den, v*den) of the chunk's 16 triangles over the 16 ray
// features (its fragments pre-arranged by mesh_brute.tc_fragments, one
// 16-byte load a lane), B the 8 rays' features (rows 10-15 zero: the
// control values stay out of the products, and a lane whose t_init would
// make the reference's products NaN records no hit), with f32
// accumulators.  So
// den, t*den, u*den and v*den of a (triangle, ray) pair sit in the same
// lane's accumulators and the hit test runs in registers, with the plain
// version's f32 operations, each rounded on its own.  Each lane keeps the
// lowest (t, index) of its two triangles a chunk for its 8 rays; a 3-step
// xor-shuffle over the 8 lanes that share a ray column gives the tile's
// winner, which the ray's own lane applies.
//
// Where it parts from the plain version: the tensor cores add a term's 16
// products (and the accumulator) in their own order and rounding, so a
// quantity may differ from the plain version's f32 sum in its last bits;
// a winner can move only where that moves a sign test or a t comparison.
//
// What bounds it, from the code: for every relevant (block, tile) pair,
// for each warp of the block, TILE / 16 chunks x 4 quantities x 4 ray
// groups x T mma of 4,096 operations, 128 T bf16 tensor-core operations a
// (ray, triangle) pair.
// The work the function needs is less: 80 T operations a pair (the 10
// non-zero features of the 4 quantities), on the block's active lanes
// only, each any-hit lane up to its first occluding tile; ~13 FP32
// operations a pair for the hit test, and ~20 a (ray, tile) for the
// relevance slab tests (twice in a 512-ray block); the bytes are the
// fragments (128 B a triangle and table part), the boxes and the rays,
// once.  At the card's peaks (989
// TFLOP/s bf16, 67 TFLOP/s FP32) the tensor work bounds bf16x6 and bf16x3
// and the FP32 hit test bounds bf16; mma.sync reaches a part of the bf16
// peak only.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// the launch's arguments (ops/mesh_brute.py: _MeshBruteTcKernel)
struct TcArgs {
  const void* frag;  // the form's fragments, mesh_brute.tc_fragments
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

// the launch of one tile size's instances for relevance block `block` and
// form `form`; cudaErrorInvalidValue for a block or form with no instance
// (one definition in each of the three sources)
int mesh_brute_tc_launch_128(const TcArgs& a, int block, int form,
                             cudaStream_t stream);
int mesh_brute_tc_launch_256(const TcArgs& a, int block, int form,
                             cudaStream_t stream);
int mesh_brute_tc_launch_512(const TcArgs& a, int block, int form,
                             cudaStream_t stream);

namespace {

constexpr int CHUNK = 16;             // triangles an A fragment holds
constexpr int MAX_WORDS = 256;        // relevance words a block: 8,192 tiles
constexpr float EPS = 1e-5f;          // ops/math.py EPS
constexpr unsigned FULL = 0xffffffffu;

// rays a CTA for a relevance block of `block` rays: the block itself up to
// 256 rays, half of a 512-ray block
__host__ __device__ constexpr int cta_rays(int block) {
  return block < 256 ? block : 256;
}

// the forms' terms (table part i, ray part j), in the reference's order
template <int FORM> struct Form;
template <> struct Form<0> {
  static constexpr int T = 1, RAY_PARTS = 1;
  static constexpr bool SPLIT = false;
  __device__ static constexpr int ti(int) { return 0; }
  __device__ static constexpr int tj(int) { return 0; }
};
template <> struct Form<1> {
  static constexpr int T = 3, RAY_PARTS = 2;
  static constexpr bool SPLIT = true;
  __device__ static constexpr int ti(int t) { return t == 1 ? 1 : 0; }
  __device__ static constexpr int tj(int t) { return t == 2 ? 1 : 0; }
};
template <> struct Form<2> {
  static constexpr int T = 6, RAY_PARTS = 3;
  static constexpr bool SPLIT = true;
  __device__ static constexpr int ti(int t) {
    return t == 1 || t == 4 ? 1 : t == 2 ? 2 : 0;
  }
  __device__ static constexpr int tj(int t) {
    return t < 3 ? 0 : t < 5 ? 1 : 2;
  }
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

// d += A (16 x 16, row) . B (16 x 8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint4& a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float safe_inv(float d) {
  // the reference's slab guard: |d| < 1e-12 -> +-1e-12
  if (fabsf(d) < 1e-12f) d = d >= 0.f ? 1e-12f : -1e-12f;
  return __fdiv_rn(1.f, d);
}

// Ray r's part of its block's relevance words (the reference's
// _block_relevance): bit j of `rel` set when some active ray of the warp
// (this lane's r, when in bounds) enters tile j's unpadded box from EPS on,
// no later than its t_init; a ballot a tile, one atomicOr a warp.
__device__ __forceinline__ void add_relevance(unsigned* rel, const TcArgs& a,
                                              long long r, int lane) {
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
  for (int j = 0; j < a.nt; ++j) {
    bool need = false;
    if (act) {
      const float* cl = a.clusters + 8 * (long long)j;
      float ent = EPS, ext = CUDART_INF_F;
      float lo = __fmul_rn(__fsub_rn(__ldg(cl + 0), ox), ix);
      float hi = __fmul_rn(__fsub_rn(__ldg(cl + 3), ox), ix);
      ent = fmaxf(ent, fminf(lo, hi)); ext = fminf(ext, fmaxf(lo, hi));
      lo = __fmul_rn(__fsub_rn(__ldg(cl + 1), oy), iy);
      hi = __fmul_rn(__fsub_rn(__ldg(cl + 4), oy), iy);
      ent = fmaxf(ent, fminf(lo, hi)); ext = fminf(ext, fmaxf(lo, hi));
      lo = __fmul_rn(__fsub_rn(__ldg(cl + 2), oz), iz);
      hi = __fmul_rn(__fsub_rn(__ldg(cl + 5), oz), iz);
      ent = fmaxf(ent, fminf(lo, hi)); ext = fminf(ext, fmaxf(lo, hi));
      need = ent <= fminf(ext, tin);
    }
    const unsigned b = __ballot_sync(FULL, need);
    if (lane == 0 && b) atomicOr(&rel[j >> 5], 1u << (j & 31));
  }
}

template <int FORM, int TILE, int BLOCK>
__global__ void __launch_bounds__(BLOCK < 256 ? BLOCK : 256)
mesh_brute_tc_kernel(const TcArgs a) {
  using F = Form<FORM>;
  constexpr int CTA = cta_rays(BLOCK);  // rays a CTA
  constexpr int SPAN = BLOCK / CTA;     // CTAs a relevance block
  constexpr int NCHUNK = TILE / CHUNK;  // chunks a tile
  static_assert(BLOCK % CTA == 0 && CTA % 32 == 0, "whole warps and CTAs");
  static_assert(TILE % CHUNK == 0, "whole chunks");
  const uint4* __restrict__ frag = (const uint4*)a.frag;
  const int nt = a.nt;
  __shared__ unsigned rel[MAX_WORDS];
  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const long long i = (long long)blockIdx.x * CTA + tid;
  const bool inb = i < a.n;

  // this thread's own ray (a padded lane is the reference's zero pack)
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tin = 0.f, exf = 0.f;
  bool act = false, anyh = false;
  if (inb) {
    ox = a.origin[3 * i + 0]; oy = a.origin[3 * i + 1];
    oz = a.origin[3 * i + 2];
    dx = a.direction[3 * i + 0]; dy = a.direction[3 * i + 1];
    dz = a.direction[3 * i + 2];
    tin = a.t_init[i];
    act = a.active[i] != 0;
    anyh = a.any_hit[i] != 0;
    exf = (float)a.exclude[i];
  }

  // the block's relevance words: the rays of SPAN CTAs from the block's
  // first, this thread taking the one of its rank in each CTA's span
  const int nwords = (nt + 31) >> 5;
  for (int w = tid; w < nwords; w += CTA) rel[w] = a.norel ? FULL : 0u;
  __syncthreads();
  if (!a.norel) {
    const long long first = (long long)(blockIdx.x / SPAN) * BLOCK;
#pragma unroll 1
    for (int k = 0; k < SPAN; ++k)
      add_relevance(rel, a, first + (long long)k * CTA + tid, lane);
  }
  __syncthreads();  // the only other block barrier

  // the control values as the form reads them
  float tin_r = tin, ex_r = exf;
  bool act_r = act, anyh_r = anyh;
  if (F::SPLIT) {
    tin_r = rebuilt<F::RAY_PARTS>(tin);
    ex_r = rebuilt<F::RAY_PARTS>(exf);
    act_r = rebuilt<F::RAY_PARTS>(act ? 1.f : 0.f) > 0.5f;
    anyh_r = rebuilt<F::RAY_PARTS>(anyh ? 1.f : 0.f) > 0.5f;
  }
  // inactive lanes park at -inf: they can never record a hit.  So does a
  // lane whose t_init is not finite in bf16 (inf, or past bf16's range) in
  // form 0: the reference multiplies its control values by the table's
  // zero rows, and 0 x inf makes every quantity of the lane NaN.  (The
  // split forms' rebuilt t_init is NaN then, which no t beats.)
  const bool nan_lane =
      !F::SPLIT && !isfinite(__bfloat162float(__float2bfloat16_rn(tin)));
  float best = act_r && !nan_lane ? tin_r : -CUDART_INF_F;
  int best_i = -1;
  bool live = inb && act_r && !nan_lane;

  // B fragments: for ray group r (rays 8r..8r+7 of the warp) this lane
  // holds features 2*tig, 2*tig+1, 2*tig+8, 2*tig+9 of ray 8r+g, each
  // ray part j a register pair; and the excluded triangle of the 8 rays
  // whose results it computes (ray 8r + 2*tig + c, slot 2r + c)
  uint32_t bf[F::RAY_PARTS][4][2];
  float ex_slot[8];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int src = 8 * r + g;
    const float sox = __shfl_sync(FULL, ox, src);
    const float soy = __shfl_sync(FULL, oy, src);
    const float soz = __shfl_sync(FULL, oz, src);
    const float sdx = __shfl_sync(FULL, dx, src);
    const float sdy = __shfl_sync(FULL, dy, src);
    const float sdz = __shfl_sync(FULL, dz, src);
    const bool src_in = __shfl_sync(FULL, (int)inb, src) != 0;
    // d x o, each product and difference rounded on its own
    const float cx = __fsub_rn(__fmul_rn(sdy, soz), __fmul_rn(sdz, soy));
    const float cy = __fsub_rn(__fmul_rn(sdz, sox), __fmul_rn(sdx, soz));
    const float cz = __fsub_rn(__fmul_rn(sdx, soy), __fmul_rn(sdy, sox));
    const float one = src_in ? 1.f : 0.f;
    const float v0 = tig == 0 ? sox : tig == 1 ? soz : tig == 2 ? sdy : cx;
    const float v1 = tig == 0 ? soy : tig == 1 ? sdx : tig == 2 ? sdz : cy;
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
      bf[j][r][0] = pack2(p0[j], p1[j]);
      bf[j][r][1] = pack2(p2[j], p3[j]);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c)
      ex_slot[2 * r + c] = __shfl_sync(FULL, ex_r, 8 * r + 2 * tig + c);
  }
  // where this lane's own ray's result sits after the reduction
  const int own_src = (lane & 7) >> 1;
  const int own_slot = (lane >> 3) * 2 + (lane & 1);

  for (int j = 0; j < nt; ++j) {
    if (!((rel[j >> 5] >> (j & 31)) & 1u)) continue;  // the block's bit
    if (!__any_sync(FULL, live)) break;  // no lane of the warp can change
    float rt[8];
    int rc[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) { rt[s] = CUDART_INF_F; rc[s] = TILE; }
    const float base = (float)(j * TILE);
#pragma unroll 1
    for (int ch = 0; ch < NCHUNK; ++ch) {
      float acc[4][4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][r][e] = 0.f;
#pragma unroll
      for (int t = 0; t < F::T; ++t) {
        const uint4* fa =
            frag + ((((long long)F::ti(t) * nt + j) * NCHUNK + ch) * 4) * 32
            + lane;
        uint4 af[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) af[q] = __ldg(fa + 32 * q);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mma(acc[q][r], af[q], bf[F::tj(t)][r][0], bf[F::tj(t)][r][1]);
      }
      // the hit test of this lane's 16 (triangle, ray) pairs: accumulator
      // e is triangle g (e < 2) or g + 8, ray 2*tig + (e & 1) of group r
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = ch * CHUNK + g + (e >= 2 ? 8 : 0);
        const float cf = __fadd_rn((float)c, base);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int s = 2 * r + (e & 1);
          const float den = acc[0][r][e], tden = acc[1][r][e];
          const float uden = acc[2][r][e], vden = acc[3][r][e];
          const float den2 = __fmul_rn(den, den);
          const float m = fminf(
              fminf(__fmul_rn(uden, den), __fmul_rn(vden, den)),
              __fmul_rn(__fsub_rn(__fsub_rn(den, uden), vden), den));
          const float td = __fmul_rn(tden, den);
          if (m >= 0.f && td > __fmul_rn(EPS, den2) && cf != ex_slot[s]) {
            const float t = __fdiv_rn(td, den2);
            if (t < rt[s]) { rt[s] = t; rc[s] = c; }  // c grows: ties keep
          }
        }
      }
    }
    // the lexicographic minimum of (t, c) over the 8 lanes of a ray column
#pragma unroll
    for (int s = 0; s < 8; ++s)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        const float ot = __shfl_xor_sync(FULL, rt[s], off);
        const int oc = __shfl_xor_sync(FULL, rc[s], off);
        if (ot < rt[s] || (ot == rt[s] && oc < rc[s])) {
          rt[s] = ot;
          rc[s] = oc;
        }
      }
    float tmin = CUDART_INF_F;
    int targ = TILE;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const float v = __shfl_sync(FULL, rt[s], own_src);
      const int vc = __shfl_sync(FULL, rc[s], own_src);
      if (s == own_slot) { tmin = v; targ = vc; }
    }
    // the across-tile rule; an any-hit lane ends at its first occluder
    if (tmin < best) {
      best = anyh_r ? -CUDART_INF_F : tmin;
      best_i = j * TILE + targ;
      if (anyh_r) live = false;
    }
  }

  if (inb) {
    a.out_t[i] = (best_i >= 0 && isfinite(best)) ? best : tin_r;
    a.out_tri[i] = best_i;
  }
}

template <int FORM, int TILE, int BLOCK>
int launch_form(const TcArgs& a, cudaStream_t stream) {
  constexpr int CTA = cta_rays(BLOCK);
  const long long ctas = (a.n + CTA - 1) / CTA;
  mesh_brute_tc_kernel<FORM, TILE, BLOCK><<<(unsigned)ctas, CTA, 0, stream>>>(
      a);
  return (int)cudaGetLastError();
}

template <int TILE, int BLOCK>
int launch_block(const TcArgs& a, int form, cudaStream_t stream) {
  switch (form) {
    case 0: return launch_form<0, TILE, BLOCK>(a, stream);
    case 1: return launch_form<1, TILE, BLOCK>(a, stream);
    case 2: return launch_form<2, TILE, BLOCK>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the instances of one tile: every relevance block and form
template <int TILE>
int launch_tile(const TcArgs& a, int block, int form, cudaStream_t stream) {
  switch (block) {
    case 128: return launch_block<TILE, 128>(a, form, stream);
    case 256: return launch_block<TILE, 256>(a, form, stream);
    case 512: return launch_block<TILE, 512>(a, form, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
