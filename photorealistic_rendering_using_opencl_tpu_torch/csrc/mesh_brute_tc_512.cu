// The tensor-core kernel's instances for tiles of 512 triangles (every
// form and relevance block): see mesh_brute_tc.cuh.
#include "mesh_brute_tc.cuh"

int mesh_brute_tc_launch_512(const TcArgs& a, int block, int form,
                             cudaStream_t stream, int* info) {
  return launch_tile<512>(a, block, form, stream, info);
}
