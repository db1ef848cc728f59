// Kernel 5's default build (every option of ChunkOptions on): the chunk
// kernel of affine_chunked.cuh for both storage types.
#include "affine_chunked.cuh"

CHUNK_BUILD(31)
