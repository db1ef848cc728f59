// Entry-wise 3x3 strain projections of the tet constraints, per thread.
//
// The device counterpart of ops/strain3d.py, which transcribes
// animsnapbases_tpu/ops/strain3d.py (eigh3_entries :39, _swap_cols :84,
// svd3_rotation_basis :103, tet_strain_fhat :171, polar_rotation :180):
// cyclic Jacobi on F^T F with branch-free rotations, 5 sweeps, the 3-sort
// network that keeps det V = +1, and the rotation-parametrized SVD
// F = U diag(s0, s1, +-s2) V^T with det U = det V = +1, in which the tet
// strain clamp is U diag(clip s) V^T and the polar rotation U V^T.
//
// Numerics: built without fast math, so the divisions and square roots of
// the rotations are IEEE (-prec-div, -prec-sqrt); tau * tau overflows to
// infinity for |a_pq| just above the 1e-30 threshold, and the rotation is
// then the identity, as in the plain version.  Matrices are 9 entries in
// row-major order.
#pragma once

namespace ksm {

template <typename T>
__device__ __forceinline__ void jacobi_rotation(T app, T aqq, T apq, T& c,
                                                T& s) {
  const bool small = (apq < T(0) ? -apq : apq) < T(1e-30);
  const T tau = (aqq - app) / (T(2) * (small ? T(1) : apq));
  const T sgn = tau >= T(0) ? T(1) : T(-1);
  T t = sgn / ((tau < T(0) ? -tau : tau) + sqrt(T(1) + tau * tau));
  t = small ? T(0) : t;
  c = T(1) / sqrt(T(1) + t * t);
  s = t * c;
}

// one rotation (p, q) of the symmetric entries a[3][3] (only the upper
// triangle is read and written) and of the columns p, q of v
template <typename T>
__device__ __forceinline__ void jacobi_apply(T a[3][3], T v[9], int p,
                                             int q, int o) {
  T c, s;
  jacobi_rotation(a[p][p], a[q][q], a[p][q], c, s);
  const T app = a[p][p], aqq = a[q][q], apq = a[p][q];
  a[p][p] = c * c * app - T(2) * c * s * apq + s * s * aqq;
  a[q][q] = s * s * app + T(2) * c * s * apq + c * c * aqq;
  // the off-diagonal entries (p, o) and (q, o), o the third index, in the
  // upper triangle's storage
  T& apo = p < o ? a[p][o] : a[o][p];
  T& aqo = q < o ? a[q][o] : a[o][q];
  const T po = apo, qo = aqo;
  apo = c * po - s * qo;
  aqo = s * po + c * qo;
  a[p][q] = T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T vp = v[3 * i + p], vq = v[3 * i + q];
    v[3 * i + p] = c * vp - s * vq;
    v[3 * i + q] = s * vp + c * vq;
  }
}

template <typename T>
__device__ __forceinline__ void swap_cols(T w[3], T v[9], int i, int j) {
  const bool d = w[j] > w[i];
  const T wi = w[i], wj = w[j];
  w[i] = d ? wj : wi;
  w[j] = d ? wi : wj;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const T a = v[3 * r + i], b = v[3 * r + j];
    v[3 * r + i] = d ? b : a;
    v[3 * r + j] = d ? -a : b;
  }
}

// U, s (descending, >= 0) and V of F, det U = det V = +1
template <typename T>
__device__ __forceinline__ void svd3_rotation_basis(const T f[9], T U[9],
                                                    T s[3], T v[9]) {
  T a[3][3];
  a[0][0] = f[0] * f[0] + f[3] * f[3] + f[6] * f[6];
  a[0][1] = f[0] * f[1] + f[3] * f[4] + f[6] * f[7];
  a[0][2] = f[0] * f[2] + f[3] * f[5] + f[6] * f[8];
  a[1][1] = f[1] * f[1] + f[4] * f[4] + f[7] * f[7];
  a[1][2] = f[1] * f[2] + f[4] * f[5] + f[7] * f[8];
  a[2][2] = f[2] * f[2] + f[5] * f[5] + f[8] * f[8];
  a[1][0] = a[2][0] = a[2][1] = T(0);  // unused: the upper triangle is read
#pragma unroll
  for (int i = 0; i < 9; ++i) v[i] = (i % 4 == 0) ? T(1) : T(0);
#pragma unroll 1
  for (int sweep = 0; sweep < 5; ++sweep) {
    jacobi_apply(a, v, 0, 1, 2);
    jacobi_apply(a, v, 0, 2, 1);
    jacobi_apply(a, v, 1, 2, 0);
  }
  T w[3] = {a[0][0], a[1][1], a[2][2]};
  swap_cols(w, v, 0, 1);
  swap_cols(w, v, 1, 2);
  swap_cols(w, v, 0, 1);
#pragma unroll
  for (int i = 0; i < 3; ++i) s[i] = sqrt(w[i] > T(0) ? w[i] : T(0));
  // B = F V, columns 0 and 1
  T b0[3], b1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    b0[i] = f[3 * i] * v[0] + f[3 * i + 1] * v[3] + f[3 * i + 2] * v[6];
    b1[i] = f[3 * i] * v[1] + f[3 * i + 1] * v[4] + f[3 * i + 2] * v[7];
  }
  const T inv0 = T(1) / (s[0] > T(1e-30) ? s[0] : T(1e-30));
  T u0[3], u1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) u0[i] = b0[i] * inv0;
  const T dot01 = u0[0] * b1[0] + u0[1] * b1[1] + u0[2] * b1[2];
  T r1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) r1[i] = b1[i] - dot01 * u0[i];
  const T n1 = sqrt(r1[0] * r1[0] + r1[1] * r1[1] + r1[2] * r1[2]);
  const T inv1 = T(1) / (n1 > T(1e-30) ? n1 : T(1e-30));
#pragma unroll
  for (int i = 0; i < 3; ++i) u1[i] = r1[i] * inv1;
  U[0] = u0[0];
  U[3] = u0[1];
  U[6] = u0[2];
  U[1] = u1[0];
  U[4] = u1[1];
  U[7] = u1[2];
  U[2] = u0[1] * u1[2] - u0[2] * u1[1];
  U[5] = u0[2] * u1[0] - u0[0] * u1[2];
  U[8] = u0[0] * u1[1] - u0[1] * u1[0];
}

// U diag(d) V^T
template <typename T>
__device__ __forceinline__ void compose_u_diag_vt(const T U[9], const T d[3],
                                                  const T V[9], T out[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = U[3 * i] * d[0] * V[3 * j] +
                       U[3 * i + 1] * d[1] * V[3 * j + 1] +
                       U[3 * i + 2] * d[2] * V[3 * j + 2];
}

// the tet strain clamp Fhat (smin <= smax), or with `polar` the rotation
template <typename T>
__device__ __forceinline__ void tet_projection(const T f[9], bool polar,
                                               T smin, T smax, T out[9]) {
  T U[9], s[3], V[9];
  svd3_rotation_basis(f, U, s, V);
  T d[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T lo = s[i] > smin ? s[i] : smin;
    d[i] = polar ? T(1) : (lo < smax ? lo : smax);
  }
  compose_u_diag_vt(U, d, V, out);
}

}  // namespace ksm
