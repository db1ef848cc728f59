// Helpers the resident and affine kernels share: the storage type of the
// big (3, r, N) matrices (bfloat16 or float32) against the state type,
// round-to-nearest arithmetic the compiler does not contract, and warp and
// block reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ksm {

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

// storage type -> state type
template <typename T>
__device__ __forceinline__ T widen(T x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// a state value rounded to the storage type M, kept in the state type T
template <typename M, typename T>
struct Round {
  __device__ static T apply(T x) { return x; }
};
template <>
struct Round<__nv_bfloat16, float> {
  __device__ static float apply(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// min and max of x[0..n) over the block, into *mn and *mx (every thread
// sees them after the call).  `red` holds 2 * (blockDim.x / 32) values.
template <typename T>
__device__ void block_minmax(const T* x, int n, T* red, T* mn, T* mx) {
  T lo = x[0], hi = x[0];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    lo = lo < x[i] ? lo : x[i];
    hi = hi > x[i] ? hi : x[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T l = __shfl_down_sync(0xffffffffu, lo, off);
    const T h = __shfl_down_sync(0xffffffffu, hi, off);
    lo = lo < l ? lo : l;
    hi = hi > h ? hi : h;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane == 0) {
    red[warp] = lo;
    red[nw + warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < nw; ++w) {
      lo = lo < red[w] ? lo : red[w];
      hi = hi > red[nw + w] ? hi : red[nw + w];
    }
    *mn = lo;
    *mx = hi;
  }
  __syncthreads();
}

}  // namespace ksm
