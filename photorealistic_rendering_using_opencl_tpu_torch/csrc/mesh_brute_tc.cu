// K1's reduced-precision forms on the tensor cores (K1tc), for Hopper
// (sm_90a): the C entries, and the kernel's instances for tiles of 128
// triangles.  The kernel, what it computes, its design and its bound are
// in mesh_brute_tc.cuh; the instances for tiles of 256 and 512 triangles
// are in mesh_brute_tc_256.cu and mesh_brute_tc_512.cu.
//
// Replaces the split and bf16-table branches of the Pallas TPU kernel
// photorealistic_rendering_using_opencl_tpu/ops/mesh_brute.py:_make_kernel
// (:301; the split at :339-357, the bf16 table at :366-368, the dot at
// :396-404), launched by _intersect_pallas, together with the XLA-side
// relevance pass _block_relevance that fed it.
#include "mesh_brute_tc.cuh"

int mesh_brute_tc_launch_128(const TcArgs& a, int block, int form,
                             cudaStream_t stream, int* info) {
  return launch_tile<128>(a, block, form, stream, info);
}

namespace {

int dispatch(const TcArgs& a, int tile, int block, int form,
             cudaStream_t stream, int* info) {
  switch (tile) {
    case 128: return mesh_brute_tc_launch_128(a, block, form, stream, info);
    case 256: return mesh_brute_tc_launch_256(a, block, form, stream, info);
    case 512: return mesh_brute_tc_launch_512(a, block, form, stream, info);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// `tile`: the table's triangles a tile, `block`: the rays a relevance
// block, each 128, 256 or 512; `form` 0 (bf16), 1 (bf16x3) or 2 (bf16x6).
// Anything else is refused (cudaErrorInvalidValue) before a launch.
int prt_mesh_brute_tc(const void* frag, int nt, int tile, int block,
                      const float* clusters, const float* origin,
                      const float* direction, const float* t_init,
                      const uint8_t* active, const uint8_t* any_hit,
                      const int32_t* exclude, long long n, float* out_t,
                      int32_t* out_tri, int form, int norel, void* stream) {
  if (nt < 1 || nt > MAX_WORDS * 32) return (int)cudaErrorInvalidValue;
  const TcArgs a{frag, nt, clusters, origin, direction, t_init, active,
                 any_hit, exclude, n, out_t, out_tri, norel};
  return dispatch(a, tile, block, form, (cudaStream_t)stream, nullptr);
}

// The resources of the (tile, block, form) instance on the current device,
// into out[TC_INFO]: registers a thread, local (spill) bytes a thread,
// static and dynamic shared memory a CTA, threads a CTA, CTAs an SM and
// clusters the card can hold at once (the occupancy calculator), and the
// build's N, stages and triangles a stage.
int prt_mesh_brute_tc_resources(int tile, int block, int form, int* out) {
  const TcArgs a{};
  return dispatch(a, tile, block, form, nullptr, out);
}

}  // extern "C"
