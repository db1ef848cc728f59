// Kernel 5's exact-free builds (floor_exact=False: a bound trip stops the
// chunk, no (r, N) y slice is read), with every choice of fold_vc,
// static_rb and sqrt_free_bound: the chunk kernel of affine_chunked.cuh
// for both storage types.  Template argument bits: affine_chunked.cuh
// CHUNK_*.
#include "affine_chunked.cuh"

CHUNK_BUILD(29)
CHUNK_BUILD(25)
CHUNK_BUILD(21)
CHUNK_BUILD(17)
CHUNK_BUILD(13)
CHUNK_BUILD(9)
CHUNK_BUILD(5)
CHUNK_BUILD(1)
