// The affine-coordinate step pieces of kernels 3, 4 (affine.cu) and 5
// (affine_chunked.cuh): the counterparts of animsnapbases_tpu/ops/
// pallas_resident.py `_make_affine_ctx` (predictor, free_step).  Every
// piece but the O(N) materialization is separable by dimension, so each
// comes as one dimension's row, which block d of a cluster (one block a
// dimension, iteration_cluster.cuh) runs on its own rows; the O(N)
// launches of affine.cu, one block over all three rows, run the same
// entries.  Each entry is one thread's arithmetic whichever thread runs
// it, so the row forms equal the one-block forms they replaced bit for bit.
//
// Coefficient state, dims-leading as everywhere in the port:
//   ap, av (3, 3): row d holds dim d's coefficients over [b0, b1, fa];
//   wp, wv (3, r): reduced coordinates over the lift U.
// Every function here is called by all threads of one block and splits its
// entries over the threads; callers put a barrier between dependent calls.
#pragma once

#include "iteration_cluster.cuh"
#include "storage.cuh"

namespace ksm {

// The slots of the device counters' int64 block (utils/profiling.py
// DEVICE_COUNTERS), which kernels 3 and 5 take as `counts` (null: not
// counted) and add to with at most one atomicAdd per sim per launch (per
// contact-mode step in kernel 3)
enum : int {
  COUNT_K5_EXACT_CHECKS = 0,     // steps kernel 5 ran its exact y-row check
  COUNT_K3_CONTACT_STEPS = 1,    // sim-steps kernel 3 ran in contact mode
  COUNT_K5_INTERVAL_CLEARS = 2   // steps kernel 5's interval bound cleared
                                 // after its Cauchy-Schwarz bound tripped
};

__device__ __forceinline__ void count_add(unsigned long long* counts,
                                          int slot, unsigned long long n) {
  if (counts && n) atomicAdd(counts + slot, n);
}

// Entry j of one dimension's row of the damped predictor: j < 3 a base
// coefficient (ap, av, asn, avd: that row's 3), else reduced coordinate
// j - 3 (wp, wv, wsn: its r): asn = ap + dt*avd + e2, avd = eta*av,
// wsn = wp + dt*eta*wv, with round-to-nearest operations in the plain
// version's order (ops/affine.py AffineContext.predictor).
template <typename T>
__device__ __forceinline__ void affine_predict_entry(int j, const T* ap,
                                                     const T* av, const T* wp,
                                                     const T* wv, T dt, T eta,
                                                     T* asn, T* avd, T* wsn) {
  const bool damp = eta != T(1);
  if (j < 3) {
    const T a = damp ? mul_rn(eta, av[j]) : av[j];
    avd[j] = a;
    asn[j] = add_rn(add_rn(ap[j], mul_rn(dt, a)), j == 2 ? T(1) : T(0));
  } else {
    const int q = j - 3;
    const T v = damp ? mul_rn(eta, wv[q]) : wv[q];
    wsn[q] = add_rn(wp[q], mul_rn(dt, v));
  }
}

// One dimension's row of the predictor, split over the block
template <typename T>
__device__ __forceinline__ void affine_predictor_row(const T* ap, const T* av,
                                                     const T* wp, const T* wv,
                                                     int r, T dt, T eta,
                                                     T* asn, T* avd, T* wsn) {
  for (int j = threadIdx.x; j < 3 + r; j += blockDim.x)
    affine_predict_entry(j, ap, av, wp, wv, dt, eta, asn, avd, wsn);
}

// All three rows (ap, av, asn, avd (3, 3); wp, wv, wsn (3, r)), threads
// tid of nt splitting the entries
template <typename T>
__device__ void affine_predictor_by(int tid, int nt, const T* ap,
                                    const T* av, const T* wp, const T* wv,
                                    int r, T dt, T eta, T* asn, T* avd,
                                    T* wsn) {
  for (int i = tid; i < 3 * (3 + r); i += nt) {
    const int d = i / (3 + r), j = i - d * (3 + r);
    affine_predict_entry(j, ap + 3 * d, av + 3 * d, wp + d * r, wv + d * r,
                         dt, eta, asn + 3 * d, avd + 3 * d, wsn + d * r);
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

// One dimension's rb_const: rbc = rb_ex - rb_lin with
// rb_lin[k] = asn[0] bu0[k] + asn[1] bu1[k] + asn[2] bu_fa[k]
//             + sum_j wsn[j] M_utac_d[j, k]
// (wsn 16-byte aligned in shared memory: gemv's x)
template <typename T>
__device__ __forceinline__ void affine_rb_const_row(
    const T* asn, const T* wsn, const T* bu0, const T* bu1, const T* bufa,
    const Operand<T>& mutac, const T* rbex, int r, T* rbc) {
  gemv(wsn, mutac, r, r, [&](int n, T acc) {
    const T lin = asn[0] * bu0[n] + asn[1] * bu1[n] + asn[2] * bufa[n] + acc;
    rbc[n] = rbex[n] - lin;
  });
}

// One dimension's out[c] = asn[0] x0[c] + asn[1] x1[c] + asn[2] x2[c]
//                          + sum_k wsn[k] map[k, c]   for c < width.
// Kernels 3, 4 and kernel 5 without fold_vc form the selected prefix
// snT_sel this way (x* = the anchors' and fa's row, map = U_selT_d);
// kernel 5 with fold_vc forms Vc (x* = their gathered columns, map = UG_d).
template <typename T>
__device__ __forceinline__ void affine_combine_row(const T* asn, const T* wsn,
                                                   const T* x0, const T* x1,
                                                   const T* x2,
                                                   const Operand<T>& map,
                                                   int r, int width, T* out) {
  gemv(wsn, map, r, width, [&](int n, T acc) {
    out[n] = asn[0] * x0[n] + asn[1] * x1[n] + asn[2] * x2[n] + acc;
  });
}

// One dimension's coefficient update after a free step, without the
// cancelling subtract: ap = asn, av = avd + e2/dt, wq = wsn + u,
// wv = (wq - wp)/dt, wp = wq.
template <typename T>
__device__ __forceinline__ void affine_update_row(T* ap, T* av, T* wp, T* wv,
                                                  const T* asn, const T* avd,
                                                  const T* wsn, const T* u,
                                                  int r, T dt) {
  for (int j = threadIdx.x; j < 3 + r; j += blockDim.x) {
    if (j < 3) {
      ap[j] = asn[j];
      av[j] = avd[j] + (j == 2 ? T(1) / dt : T(0));
    } else {
      const int q = j - 3;
      const T wq = wsn[q] + u[q];
      wv[q] = (wq - wp[q]) / dt;
      wp[q] = wq;
    }
  }
}

// One dimension's reset to unit coefficients over new anchors
template <typename T>
__device__ __forceinline__ void affine_reset_row(T* ap, T* av, T* wp, T* wv,
                                                 int r) {
  for (int j = threadIdx.x; j < 3 + r; j += blockDim.x) {
    if (j < 3) {
      ap[j] = j == 0 ? T(1) : T(0);
      av[j] = j == 1 ? T(1) : T(0);
    } else {
      wp[j - 3] = T(0);
      wv[j - 3] = T(0);
    }
  }
}

// ... of all three rows
template <typename T>
__device__ void affine_reset(T* ap, T* av, T* wp, T* wv, int r) {
  for (int d = 0; d < 3; ++d)
    affine_reset_row(ap + 3 * d, av + 3 * d, wp + d * r, wv + d * r, r);
}

// Dimension d's rows of a sim's flat coefficients coef (ap (9), av (9),
// wp (3r), wv (3r): ops/affine.py split_coef) copied into the row
// buffers ap, av (3), wp, wv (r), or with `store` from them back
template <typename T>
__device__ __forceinline__ void coef_rows(T* coef, int d, int r, T* ap,
                                          T* av, T* wp, T* wv, bool store) {
  for (int j = threadIdx.x; j < 6 + 2 * r; j += blockDim.x) {
    T* g;
    T* s;
    if (j < 3) {
      g = coef + 3 * d + j;
      s = ap + j;
    } else if (j < 6) {
      g = coef + 9 + 3 * d + j - 3;
      s = av + j - 3;
    } else if (j < 6 + r) {
      g = coef + 18 + d * r + j - 6;
      s = wp + j - 6;
    } else {
      g = coef + 18 + 3 * r + d * r + j - 6 - r;
      s = wv + j - 6 - r;
    }
    if (store)
      *g = *s;
    else
      *s = *g;
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
