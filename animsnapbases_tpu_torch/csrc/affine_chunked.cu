// Kernel 5's default build (every option of ChunkOptions on): the chunk
// kernel of affine_chunked.cuh for both storage types.
#include "affine_chunked.cuh"

CHUNK_BUILD(31)

// clusters of the default build (bfloat16 storage) resident at once with
// smem bytes a block
extern "C" int affine_chunked_max_clusters(int smem) {
  return ksm::max_clusters(ksm::affine_chunk<float, __nv_bfloat16, 31>, smem);
}
