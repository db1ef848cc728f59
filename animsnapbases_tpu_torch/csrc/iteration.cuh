// The pieces of the hyper-reduced local-global iteration loop that every
// kernel shares: the element table's projection emitters, the sparse
// gather and the operand struct.  The loop itself runs on a cluster of
// three blocks per sim (iteration_cluster.cuh) in kernels 1-5.  It is the
// body of animsnapbases_tpu/ops/pallas_resident.py `_make_iteration_loop`
// and of pallas_reduced.py `build_fused_reduced_iterations`: it carries rb
// (3, r), forms the gathered vertex values as Vall = Vc + rb C_allT
// (C_allT = usel_inv G_allT precomposed in float64 on the host), evaluates
// one projection row per column of the element table (the five kinds of
// pallas_reduced.py TERM_DISPATCH: tris_strain 2x2 clamp, edge_spring,
// tets_strain and tets_deformation_gradient 3x3 Jacobi, verts_bending),
// and forms rb = rb_const + pT WT.  At the end u = rb inv3.
//
// Element table (built by ops/fused_reduced.py `fused_operands`): column j
// of pT is one projection row, of kind `kind[j]`, whose vertex slots read
// Vall columns eg[s][j] (s < 4); its rest data lies in rows of ef (13, m):
//   tris_strain: P0T 0-2, P1T 3-5, DmInv 6-9, row_is0 10, smin 11, smax 12
//   edge_spring: rest length 0
//   tets_*:      DmInv 0-8 (row-major), r0 9, r1 10, smin 11, smax 12
//   verts_bending: rest curvature 0, tri normal 1-3, dot with normal 4,
//                prevent_flips 5
// Block form (all p rows of each selected element, pallas_reduced.py
// `_block_major`) needs no emitter of its own: its row k of an element is
// a column with a fixed row (tris row_is0 1 then 0; tets (r0, r1) = (1, 0),
// (0, 1), (0, 0)), the columns in WT_all's row-major block order.
//
// The gather Vc = snT_sel G_allT is sparse by columns (CSR: gptr, gcol,
// gw): a one-hot column of tris, springs and tets has one entry of weight
// 1, a bending column the weighted star Laplacian of its vertex.  The sum
// accumulates in float64: a star of absolute positions ~20 units high
// cancels to its curvature (ROADMAP Queue C), and a one-hot column is
// then its vertex value bit for bit.
// Layout is dims-leading as in the JAX package: positions (3, n), per
// element values (., m), matrices (3, r, .).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "strain3d.cuh"

namespace ksm {

enum : int {
  KIND_TRI = 0,
  KIND_SPRING = 1,
  KIND_TET_STRAIN = 2,
  KIND_TET_DEFGRAD = 3,
  KIND_BENDING = 4
};

template <typename T>
struct Iter {
  const T* C;      // (3, r, g)  C_allT
  const T* inv;    // (3, r, r)  inv(U^T A U), symmetric
  const T* WT;     // (3, m, r)  WT_all
  const int* gptr;    // (g + 1,) Vc column c: entries gptr[c] .. gptr[c+1]
  const int* gcol;    // (nnz,)   their snT_sel columns
  const double* gw;   // (nnz,)   and weights
  const int* kind;    // (m,)
  const int* eg;      // (4, m)
  const T* ef;     // (13, m)
  int r, g, m;
};

__device__ __forceinline__ float tsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ float thypot(float x, float y) {
  return hypotf(x, y);
}
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T tclip(T x, T lo, T hi) {
  return tmin(tmax(x, lo), hi);
}

// (cos x, sin x) from (cos 2x, sin 2x); x in (-pi/2, pi/2].  The root is
// taken of the larger of (1 + c2)/2 and (1 - c2)/2 and the other value from
// s2, so neither cancels as c2 -> -1 (ops/strain2d.py _half_angle)
template <typename T>
__device__ __forceinline__ void half_angle(T c2, T s2, T& cx, T& sx) {
  if (c2 >= T(0)) {
    cx = tsqrt((T(1) + c2) * T(0.5));
    sx = s2 / (T(2) * cx);
  } else {
    const T h = tsqrt((T(1) - c2) * T(0.5));
    sx = s2 >= T(0) ? h : -h;
    cx = (s2 >= T(0) ? s2 : -s2) / (T(2) * h);
  }
}

// Fhat = U clip(Sigma) V^T of F = [[a, b], [c, d]], trig-free
// (ops/strain2d.py clamped_fhat_2x2).  Q and R are hypotenuses taken
// without squaring: near F ~ I the off-diagonal residues can be ~1e-20,
// whose float32 squares are subnormal and keep only a few digits.

template <typename T>
__device__ __forceinline__ void clamped_fhat_2x2(T a, T b, T c, T d, T smin,
                                                 T smax, T& f00, T& f01,
                                                 T& f10, T& f11) {
  const T E = (a + d) * T(0.5);
  const T Fv = (a - d) * T(0.5);
  const T G = (c + b) * T(0.5);
  const T H = (c - b) * T(0.5);
  const T Q = thypot(E, H);
  const T R = thypot(Fv, G);
  const T sx = Q + R;
  const T sy = Q - R;
  const T invQ = T(1) / tmax(Q, T(1e-30));
  const T invR = T(1) / tmax(R, T(1e-30));
  const bool ok_q = Q > T(1e-30);
  const bool ok_r = R > T(1e-30);
  const T ca1 = ok_r ? Fv * invR : T(1);
  const T sa1 = ok_r ? G * invR : T(0);
  const T ca2 = ok_q ? E * invQ : T(1);
  const T sa2 = ok_q ? H * invQ : T(0);
  T c1, s1, c2, s2;
  half_angle(ca1, sa1, c1, s1);
  half_angle(ca2, sa2, c2, s2);
  const T cp = c2 * c1 - s2 * s1;
  const T sp = s2 * c1 + c2 * s1;
  const T ct = c1 * c2 + s1 * s2;
  const T st = s1 * c2 - c1 * s2;
  const T shx = tclip(sx, smin, smax);
  const T sgn = sy >= T(0) ? T(1) : T(-1);
  const T shy = sgn * tclip(sy >= T(0) ? sy : -sy, smin, smax);
  f00 = shx * cp * ct + shy * sp * st;
  f01 = shx * cp * st - shy * sp * ct;
  f10 = shx * sp * ct - shy * cp * st;
  f11 = shx * sp * st + shy * cp * ct;
}

template <typename T>
struct Row3 {
  T x[3];
};

// A tet column's projection row (pallas_reduced.py _tet_p :250-278): F from
// the edge vectors to the fourth vertex and DmInv, the clamp (tets_strain)
// or the polar rotation (tets_deformation_gradient), then the blend
// r0 row0 + r1 row1 + r2 row2 with r2 = 1 - r0 - r1, as the JAX emitter
// takes it (a block column's (r0, r1) is one of (1, 0), (0, 1), (0, 0),
// whose blend is that row exactly).  Out of line, its arguments by value:
// the Jacobi's registers then do not weigh on the loop around it.
template <typename T>
__device__ __noinline__ Row3<T> project_tet(const int* eg, const T* ef,
                                            const T* vall, int m, int g,
                                            int j, bool polar) {
  const int g4 = eg[3 * m + j];
  T ds[3][3];  // ds[k][i]: Ds column k, entry i
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int gk = eg[k * m + j];
#pragma unroll
    for (int i = 0; i < 3; ++i) ds[k][i] = vall[i * g + gk] - vall[i * g + g4];
  }
  T f[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      f[3 * i + c] = ds[0][i] * ef[c * m + j] +
                     ds[1][i] * ef[(3 + c) * m + j] +
                     ds[2][i] * ef[(6 + c) * m + j];
  T p[9];
  tet_projection(f, polar, ef[11 * m + j], ef[12 * m + j], p);
  const T r0 = ef[9 * m + j], r1 = ef[10 * m + j];
  const T r2 = T(1) - r0 - r1;
  Row3<T> out;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    // row k, entry d: Fhat[k][d] for the strain, R[d][k] for the rotation
    const T p0 = polar ? p[3 * d] : p[d];
    const T p1 = polar ? p[3 * d + 1] : p[3 + d];
    const T p2 = polar ? p[3 * d + 2] : p[6 + d];
    out.x[d] = r0 * p0 + r1 * p1 + r2 * p2;
  }
  return out;
}

// the projection row of table column j (pallas_reduced.py _tri_p,
// _spring_p, _tet_p, _bending_p) from the gathered values Vall (3, g)
template <typename T>
__device__ __forceinline__ void project_element(const Iter<T>& op,
                                                const T* vall, int j,
                                                T out[3]) {
  const int m = op.m, g = op.g;
  const T* ef = op.ef;
  const int kind = op.kind[j];
  if (kind == KIND_TRI) {
    const int g1 = op.eg[j], g2 = op.eg[m + j], g3 = op.eg[2 * m + j];
    T e1[3], e2[3], P0[3], P1[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const T v1 = vall[d * g + g1];
      e1[d] = vall[d * g + g2] - v1;
      e2[d] = vall[d * g + g3] - v1;
      P0[d] = ef[d * m + j];
      P1[d] = ef[(3 + d) * m + j];
    }
    const T a = P0[0] * e1[0] + P0[1] * e1[1] + P0[2] * e1[2];
    const T b = P0[0] * e2[0] + P0[1] * e2[1] + P0[2] * e2[2];
    const T c = P1[0] * e1[0] + P1[1] * e1[1] + P1[2] * e1[2];
    const T d_ = P1[0] * e2[0] + P1[1] * e2[1] + P1[2] * e2[2];
    const T D00 = ef[6 * m + j], D01 = ef[7 * m + j];
    const T D10 = ef[8 * m + j], D11 = ef[9 * m + j];
    T f00, f01, f10, f11;
    clamped_fhat_2x2(a * D00 + b * D10, a * D01 + b * D11,
                     c * D00 + d_ * D10, c * D01 + d_ * D11,
                     ef[11 * m + j], ef[12 * m + j], f00, f01, f10, f11);
    const bool row0 = ef[10 * m + j] > T(0);
    const T fh0 = row0 ? f00 : f01;
    const T fh1 = row0 ? f10 : f11;
#pragma unroll
    for (int d = 0; d < 3; ++d) out[d] = P0[d] * fh0 + P1[d] * fh1;
  } else if (kind == KIND_SPRING) {
    const int g0 = op.eg[j], g1 = op.eg[m + j];
    T s[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) s[d] = vall[d * g + g1] - vall[d * g + g0];
    const T len = tsqrt(s[0] * s[0] + s[1] * s[1] + s[2] * s[2]);
    const bool keep = len > T(0);
    const T inv_len = keep ? T(1) / tmax(len, T(1e-30)) : T(0);
    const T delta = T(0.5) * (len - ef[j]);
#pragma unroll
    for (int d = 0; d < 3; ++d)
      out[d] = keep ? T(0.5) * s[d] - delta * inv_len * s[d] : T(0);
  } else if (kind == KIND_BENDING) {
    // the star Laplacian of the vertex is its one gathered column
    const int g0 = op.eg[j];
    T s[3], n[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      s[d] = vall[d * g + g0];
      n[d] = ef[(1 + d) * m + j];
    }
    const T rest = ef[j];
    const T norm = tsqrt(s[0] * s[0] + s[1] * s[1] + s[2] * s[2]);
    const T scale = rest / tmax(norm, T(1e-30));
    const bool flat = norm < T(1e-10);
#pragma unroll
    for (int d = 0; d < 3; ++d) out[d] = flat ? n[d] * rest : s[d] * scale;
    if (ef[5 * m + j] > T(0)) {
      const T dots = n[0] * out[0] + n[1] * out[1] + n[2] * out[2];
      if (norm > T(1e-5) && dots * ef[4 * m + j] < T(0)) {
#pragma unroll
        for (int d = 0; d < 3; ++d) out[d] = -out[d];
      }
    }
  } else {  // KIND_TET_STRAIN, KIND_TET_DEFGRAD
    const Row3<T> p = project_tet(op.eg, ef, vall, m, g, j,
                                  kind == KIND_TET_DEFGRAD);
#pragma unroll
    for (int d = 0; d < 3; ++d) out[d] = p.x[d];
  }
}

// Vc column c of one dim's row x (its snT_sel values): the weighted sum of
// the column's entries, in float64 (one entry of weight 1 for a one-hot
// column: then x at its vertex, bit for bit)
template <typename T>
__device__ __forceinline__ T gather_col(const Iter<T>& op, const T* x,
                                        int c) {
  double acc = 0.0;
  for (int e = op.gptr[c]; e < op.gptr[c + 1]; ++e)
    acc += op.gw[e] * (double)x[op.gcol[e]];
  return (T)acc;
}

template <typename T>
__host__ inline Iter<T> make_iter(const void* C, const void* inv,
                                  const void* WT, const void* gptr,
                                  const void* gcol, const void* gw,
                                  const void* kind, const void* eg,
                                  const void* ef, int r, int g, int m) {
  Iter<T> op;
  op.C = static_cast<const T*>(C);
  op.inv = static_cast<const T*>(inv);
  op.WT = static_cast<const T*>(WT);
  op.gptr = static_cast<const int*>(gptr);
  op.gcol = static_cast<const int*>(gcol);
  op.gw = static_cast<const double*>(gw);
  op.kind = static_cast<const int*>(kind);
  op.eg = static_cast<const int*>(eg);
  op.ef = static_cast<const T*>(ef);
  op.r = r;
  op.g = g;
  op.m = m;
  return op;
}

// Raise the dynamic shared-memory cap of `kernel` when `bytes` exceeds
// the 48 KB default (up to the SM's 227 KB).
template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace ksm

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
