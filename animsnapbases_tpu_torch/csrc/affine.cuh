// The affine-coordinate step pieces of kernels 3 and 4 (affine.cu): the
// block-level counterparts of animsnapbases_tpu/ops/pallas_resident.py
// `_make_affine_ctx` (predictor, free_step).  Kernel 5
// (affine_chunked.cuh) runs one dimension's row of each in each block of
// its cluster, in the same arithmetic, and shares `affine_row`.
//
// Coefficient state, dims-leading as everywhere in the port:
//   ap, av (3, 3): row d holds dim d's coefficients over [b0, b1, fa];
//   wp, wv (3, r): reduced coordinates over the lift U.
// Every function here is called by all threads of one block and splits its
// entries over the threads; callers put a barrier between dependent calls.
#pragma once

#include "iteration.cuh"
#include "storage.cuh"

namespace ksm {

// The damped predictor: asn = ap + dt*avd + e2, avd = eta*av,
// wsn = wp + dt*eta*wv, with round-to-nearest operations in the plain
// version's order (ops/affine.py AffineContext.predictor).  Threads tid
// of nt split the entries (each entry is one thread's, whichever).
template <typename T>
__device__ void affine_predictor_by(int tid, int nt, const T* ap,
                                    const T* av, const T* wp, const T* wv,
                                    int r, T dt, T eta, T* asn, T* avd,
                                    T* wsn) {
  const bool damp = eta != T(1);
  for (int i = tid; i < 9; i += nt) {
    const T a = damp ? mul_rn(eta, av[i]) : av[i];
    avd[i] = a;
    asn[i] = add_rn(add_rn(ap[i], mul_rn(dt, a)), (i % 3) == 2 ? T(1) : T(0));
  }
  for (int i = tid; i < 3 * r; i += nt) {
    const T v = damp ? mul_rn(eta, wv[i]) : wv[i];
    wsn[i] = add_rn(wp[i], mul_rn(dt, v));
  }
}

// ... split over the threads of the block
template <typename T>
__device__ void affine_predictor(const T* ap, const T* av, const T* wp,
                                 const T* wv, int r, T dt, T eta, T* asn,
                                 T* avd, T* wsn) {
  affine_predictor_by(threadIdx.x, blockDim.x, ap, av, wp, wv, r, dt, eta,
                      asn, avd, wsn);
}

// rbc = rb_ex - rb_lin with
// rb_lin[d, k] = asn[d,0] bu0 + asn[d,1] bu1 + asn[d,2] bu_fa
//               + sum_j wsn[d, j] M_utac[d, j, k]
template <typename T>
__device__ void affine_rb_const(const T* asn, const T* wsn, const T* bu0,
                                const T* bu1, const T* bufa,
                                const T* mutac, const T* rbex, int r,
                                T* rbc) {
  for (int i = threadIdx.x; i < 3 * r; i += blockDim.x) {
    const int d = i / r, k = i - d * r;
    const T* Md = mutac + (size_t)d * r * r + k;
    const T* wd = wsn + d * r;
    T acc = T(0);
    for (int j = 0; j < r; ++j) acc += wd[j] * Md[(size_t)j * r];
    const T lin = asn[3 * d] * bu0[i] + asn[3 * d + 1] * bu1[i] +
                  asn[3 * d + 2] * bufa[i] + acc;
    rbc[i] = rbex[i] - lin;
  }
}

// out[d, c] = asn[d,0] x0[d, c] + asn[d,1] x1[d, c] + asn[d,2] x2[d, c]
//             + sum_k wsn[d, k] map[d, k, c]   for c < width,
// with x* read at row stride ld and map (3, r, width).  Kernels 3 and 4
// form snT_sel this way (x* = the anchors' and fa's selected prefix, map =
// U_selT); kernel 5 forms Vc (x* = their gathered columns, map = UG_allT).
template <typename T>
__device__ void affine_combine(const T* asn, const T* wsn, const T* x0,
                               const T* x1, const T* x2, int ld,
                               const T* map, int r, int width, T* out) {
  for (int i = threadIdx.x; i < 3 * width; i += blockDim.x) {
    const int d = i / width, c = i - d * width;
    const T* md = map + (size_t)d * r * width + c;
    const T* wd = wsn + d * r;
    T acc = T(0);
    for (int k = 0; k < r; ++k) acc += wd[k] * md[(size_t)k * width];
    const size_t x = (size_t)d * ld + c;
    out[i] = asn[3 * d] * x0[x] + asn[3 * d + 1] * x1[x] +
             asn[3 * d + 2] * x2[x] + acc;
  }
}

// The coefficient update of a free step, without the cancelling subtract:
// ap = asn, av = avd + e2/dt, wq = wsn + u, wv = (wq - wp)/dt, wp = wq.
template <typename T>
__device__ void affine_update(T* ap, T* av, T* wp, T* wv, const T* asn,
                              const T* avd, const T* wsn, const T* u, int r,
                              T dt) {
  for (int i = threadIdx.x; i < 9; i += blockDim.x) {
    ap[i] = asn[i];
    av[i] = avd[i] + ((i % 3) == 2 ? T(1) / dt : T(0));
  }
  for (int i = threadIdx.x; i < 3 * r; i += blockDim.x) {
    const T wq = wsn[i] + u[i];
    wv[i] = (wq - wp[i]) / dt;
    wp[i] = wq;
  }
}

// Reset to unit coefficients over new anchors.
template <typename T>
__device__ void affine_reset(T* ap, T* av, T* wp, T* wv, int r) {
  for (int i = threadIdx.x; i < 9; i += blockDim.x) {
    const int j = i % 3;
    ap[i] = j == 0 ? T(1) : T(0);
    av[i] = j == 1 ? T(1) : T(0);
  }
  for (int i = threadIdx.x; i < 3 * r; i += blockDim.x) {
    wp[i] = T(0);
    wv[i] = T(0);
  }
}

// a[0] b0 + a[1] b1 + a[2] fa + acc: the base part of a materialized entry
// beside its lift sum acc
template <typename T>
__device__ __forceinline__ T affine_base(const T* a, T b0, T b1, T fa,
                                         T acc) {
  return a[0] * b0 + a[1] * b1 + a[2] * fa + acc;
}

// One dim-row of a materialization at column v:
// a[0] b0[v] + a[1] b1[v] + a[2] fa[v] + sum_k w[k] U[k, v], with w
// already rounded to the storage type and U the (r, N) slice of that dim.
// (affine.cu's batched floor test runs the same sum for a group of sims.)
template <typename T, typename M>
__device__ __forceinline__ T affine_row(const T* a, const T* w, T b0, T b1,
                                        T fa, const M* U, int N, int r,
                                        int v) {
  T acc = T(0);
  for (int k = 0; k < r; ++k) acc += w[k] * widen(U[(size_t)k * N + v]);
  return affine_base(a, b0, b1, fa, acc);
}

}  // namespace ksm
