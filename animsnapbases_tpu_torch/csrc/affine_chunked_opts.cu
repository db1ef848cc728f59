// Kernel 5's other exact builds: with the bound and any of fold_vc,
// static_rb and sqrt_free_bound off, and without the bound
// (floor_bound_skip=False: the exact check every step) with any choice of
// fold_vc and static_rb.  The chunk kernel of affine_chunked.cuh for both
// storage types.  Template argument bits: affine_chunked.cuh CHUNK_*.
#include "affine_chunked.cuh"

CHUNK_BUILD(27)
CHUNK_BUILD(23)
CHUNK_BUILD(19)
CHUNK_BUILD(15)
CHUNK_BUILD(11)
CHUNK_BUILD(7)
CHUNK_BUILD(3)
CHUNK_BUILD(30)
CHUNK_BUILD(26)
CHUNK_BUILD(22)
CHUNK_BUILD(18)
