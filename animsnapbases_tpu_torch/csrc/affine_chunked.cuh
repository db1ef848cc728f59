// Kernel 5: one chunk of the chunked affine tier 1, in every build.
//
// Replaces: animsnapbases_tpu/ops/pallas_resident.py
//   build_resident_affine_chunked, the chunk kernel _make_chunk_kernel
//   (:1309-1496, pallas_call :1539) with its five build options as the
//   template argument O (CHUNK_* bits below; ops/affine_chunked.py
//   ChunkOptions).  Its outer loop (_body, :1498-1634) is Python in
//   ops/affine_chunked.py.  Each option set a caller can reach is
//   instantiated once per storage type: affine_chunked.cu holds the
//   default build, affine_chunked_free.cu the exact-free builds and
//   affine_chunked_opts.cu the others, so the default library compiles as
//   before and the three build side by side.
// From unit coefficients over the chunk's anchors P, V, each of up to
// `steps` steps:
//   the damped predictor in coefficients (asn, wsn);
//   with the bound (CHUNK_BOUND), the O(r) floor bound on the y row:
//     lb_aff from the y-row minima and maxima of P, V and fa; the step may
//     clamp when m = lb_aff - floor_h - eps (1 + |lb_aff|) < 0 or
//     m^2 < (1.25 umax)^2 ||wsn_y||^2 (CHUNK_SQRT_FREE), or else when
//     lb_aff - wn umax - (0.25 wn umax + eps (1 + |lb_aff|)) < floor_h
//     with wn = ||wsn_y||;
//   in the exact builds (CHUNK_EXACT), when the bound trips or on every
//     step without the bound, the exact y row a0 P_y + a1 V_y + a2 fa_y +
//     wsn_y U_y, and the chunk stops before the first step it clamps; in
//     the exact-free build a bound trip is the stop, and the (r, N) y
//     slice of the lift is never read (the caller passes no lift);
//   rb_const = rb_i - (a0 bu0 + a1 bu1 + a2 bu_fa + wsn M_utac), rb_i the
//     row min(i, T - 1) of the target-term schedule from the chunk's first
//     step (the JAX kernel's rb_seq rows, :1363-1369, :1463-1465; the outer
//     loop hands each chunk the schedule from its first step on),
//   the gathered values Vc: with CHUNK_FOLD a0 b0s + a1 b1s + a2 fas +
//     wsn UG_allT (the gathered columns); without it the predictor at the
//     selected prefix, a0 P_sel + a1 V_sel + a2 fa_sel + wsn U_selT, into
//     shared memory and through the star gather (gather_col), as kernels 3
//     and 4 form it;
//   the iteration loop and solve (iteration.cuh), the coefficient update.
// It writes ap, av, wp, wv and k, the steps done.  The exact builds with
// the bound take the y-row minima and maxima, of P and V once per chunk and
// of fa in the first chunk of a call (ADVICE r5), into `ymm`; the
// exact-free build reads them from `ymm` (the outer loop takes them).
//
// What bounds it on this card: per step it reads only small operands (the
// (3, r) and (3, g) coefficient operands, M_utac, UG_allT or U_selT and the
// loop's operands, ~0.3 MB in float32 at the bench scene) unless the exact
// check runs; that reads the (r, N) y slice of the lift (1.8 MB in bfloat16
// at 14,400 vertices, 24 MB at 250,000).  By bytes that is well under a
// microsecond per step; as for kernel 1, the latency of the single block's
// dependent chains sets the time.
//
// What the design does about it: ONE thread block runs the whole chunk,
// as kernel 1 runs its loop, so no launch or device-memory round trip
// separates the steps.  The coefficient state (ap, av, wp, wv), the
// per-chunk operands (bu0, bu1, bu_fa, and b0s, b1s, fas with CHUNK_FOLD)
// and, when they fit beside the loop's buffers, M_utac and inv3 (2 x 49 KB
// at r = 64 in float32) live in shared memory for the whole chunk, which
// takes the r-long dependent-load chains of rb_lin and the solve off L2.  A
// static target term (T = 1, CHUNK_STATIC) is staged there once too; an
// animated schedule's rows do not fit (a 1,024-step chunk's are 786 KB at
// r = 64), so each step reads its own row, 768 B, from L2 where rb_const
// is formed (one load per entry, no dependent chain), as every step does
// without CHUNK_STATIC.  The branch of a step (bound clear, exact check,
// stop) is block-uniform: one thread decides the bound, __syncthreads_or
// the exact check.  The options are template arguments, so a build carries
// no code (and no registers) of the branches it does not take.
//
// The batched build (nb sims, the JAX kernel's nb = B; the tier 1 of
// make_batched_run's large-model route) runs one block per sim on a grid of
// nb blocks, each the solo chunk on sim b's buffers (sim-major: P, V, fa
// (nb, 3, N); b0s, b1s, fas (nb, 3, g); bu0, bu1, bu_fa (nb, 3, r); ymm
// (nb, 6); out (nb, 18 + 6r); k (nb,)), M_utac and inv3 staged per block.
// At r = 64 a block's shared memory (~120 KB) allows one block per SM, so
// up to 132 sims run in one wave and more in further waves.  Each block
// records its own k_b; the whole-batch exit (stop before the first step at
// which any sim clamps, or trips its bound in the exact-free build) is made
// by the caller (ops/affine_chunked.py), which launches the chunk again for
// min k_b steps when the k_b differ.  No block waits for another: a
// grid-wide barrier hangs when blocks are not co-resident.
#pragma once

#include "affine.cuh"

namespace ksm {

constexpr int THREADS = 256;
constexpr size_t SMEM_MAX = 232448;  // 227 KB a block can use

// the build options (ops/affine_chunked.py ChunkOptions.code)
enum : int {
  CHUNK_BOUND = 1,       // floor_bound_skip: the O(r) bound first
  CHUNK_EXACT = 2,       // floor_exact: the exact y row decides
  CHUNK_FOLD = 4,        // fold_vc: Vc through the G-composed operands
  CHUNK_STATIC = 8,      // static_rb: a one-row schedule staged once
  CHUNK_SQRT_FREE = 16,  // sqrt_free_bound: the bound on squared magnitudes
  CHUNK_DEFAULT = 31
};

extern __shared__ __align__(16) unsigned char chunk_smem[];

template <typename T, typename M>
struct Chunk {
  const T* P;  // (3, N) the anchors: the exact builds read their y rows,
  const T* V;  // the builds without CHUNK_FOLD their selected prefixes
  const T* fa;
  T* ymm;             // (6,) minima of P_y, V_y, fa_y, then maxima
  const T* b0s;       // (3, g) gathered columns of P, V, fa (CHUNK_FOLD)
  const T* b1s;
  const T* fas;
  const T* bu0;       // (3, r) U^T A_c of P, V, fa
  const T* bu1;
  const T* bufa;
  const T* rbex;      // rb_T rows of (3, r) from the chunk's first step
  const M* ulift;     // (3, r, N), the exact builds only
  const T* mutac;     // (3, r, r)
  const T* UG;        // (3, r, g) with CHUNK_FOLD
  T* out;             // ap (9), av (9), wp (3r), wv (3r)
  int* k;
  long long rb_sim;   // elements from a sim's schedule to the next
  int N, steps, first, stage, rb_T;
  int r, g;           // for the per-sim offsets
  T dt, eta, floor_h, c2, eps;
  // what only some builds read: the selected prefix's map and width
  // (without CHUNK_FOLD), the bound's lift constant (without
  // CHUNK_SQRT_FREE)
  const T* usel;      // (3, r, n_sel)
  int n_sel;
  T umax;
};

template <int O>
__host__ __device__ inline size_t chunk_smem_elems(int r, int g, int m,
                                                   int n_sel, bool stage) {
  // the loop's buffers; ap, av, asn, avd; wp, wv, wsn, u, bu0, bu1, bu_fa,
  // rb_ex; wy; b0s, b1s, fas (CHUNK_FOLD) or snT_sel; red, ymm; M_utac and
  // inv3 when staged
  const size_t cols = (O & CHUNK_FOLD) ? 9 * (size_t)g : 3 * (size_t)n_sel;
  return iter_smem_elems(r, g, m) + 36 + 8 * 3 * r + r + cols + 16 + 8 +
         (stage ? 6 * (size_t)r * r : 0);
}

// the chunk of sim b: the per-sim buffers are laid out sim after sim
template <int O, typename T, typename M>
__device__ Chunk<T, M> chunk_of_sim(Chunk<T, M> a, int b) {
  const size_t x = (size_t)b * 3 * a.N, gs = (size_t)b * 3 * a.g;
  const size_t rs = (size_t)b * 3 * a.r;
  a.P += x;
  a.V += x;
  a.fa += x;
  a.ymm += (size_t)b * 6;
  if (O & CHUNK_FOLD) {
    a.b0s += gs;
    a.b1s += gs;
    a.fas += gs;
  }
  a.bu0 += rs;
  a.bu1 += rs;
  a.bufa += rs;
  a.rbex += (size_t)b * a.rb_sim;
  a.out += (size_t)b * (18 + 6 * a.r);
  a.k += b;
  return a;
}

template <typename T, typename M, int O>
__global__ void affine_chunk(Chunk<T, M> all, Iter<T> op,
                             int num_iterations) {
  constexpr bool bound = (O & CHUNK_BOUND) != 0;
  constexpr bool exact = (O & CHUNK_EXACT) != 0;
  constexpr bool fold = (O & CHUNK_FOLD) != 0;
  constexpr bool sqrt_free = (O & CHUNK_SQRT_FREE) != 0;
  static_assert(bound || exact, "the exact-free build needs the bound");
  __shared__ int maybe;
  const Chunk<T, M> a = chunk_of_sim<O>(all, blockIdx.x);
  const int r = op.r, g = op.g, m = op.m, N = a.N, n_sel = a.n_sel;
  const int tid = threadIdx.x, nt = blockDim.x;
  T* rbc = reinterpret_cast<T*>(chunk_smem);
  T* rb = rbc + 3 * r;
  T* vc = rb + 3 * r;
  T* vall = vc + 3 * g;
  T* pt = vall + 3 * g;
  T* ap = pt + 3 * m;
  T* av = ap + 9;
  T* asn = av + 9;
  T* avd = asn + 9;
  T* wp = avd + 9;
  T* wv = wp + 3 * r;
  T* wsn = wv + 3 * r;
  T* u = wsn + 3 * r;
  T* bu0 = u + 3 * r;
  T* bu1 = bu0 + 3 * r;
  T* bufa = bu1 + 3 * r;
  T* rbex = bufa + 3 * r;
  T* wy = rbex + 3 * r;    // r: wsn_y rounded to the storage type
  T* b0s = wy + r;         // CHUNK_FOLD: b0s, b1s, fas (3g each)
  T* b1s = b0s + 3 * g;
  T* fas = b1s + 3 * g;
  T* snsel = wy + r;       // else snT_sel (3 n_sel)
  T* red = wy + r + (fold ? 9 * g : 3 * n_sel);  // 16: block reductions
  T* ymm = red + 16;       // 8
  T* mutac_s = ymm + 8;    // 3 r r, when staged
  T* inv_s = mutac_s + 3 * r * r;

  const bool static_rb = (O & CHUNK_STATIC) && a.rb_T == 1;
  for (int i = tid; i < 3 * r; i += nt) {
    bu0[i] = a.bu0[i];
    bu1[i] = a.bu1[i];
    bufa[i] = a.bufa[i];
    if (static_rb) rbex[i] = a.rbex[i];
  }
  if (fold) {
    for (int i = tid; i < 3 * g; i += nt) {
      b0s[i] = a.b0s[i];
      b1s[i] = a.b1s[i];
      fas[i] = a.fas[i];
    }
  }
  Iter<T> ops = op;
  const T* mutac = a.mutac;
  if (a.stage) {
    for (int i = tid; i < 3 * r * r; i += nt) {
      mutac_s[i] = a.mutac[i];
      inv_s[i] = op.inv[i];
    }
    mutac = mutac_s;
    ops.inv = inv_s;
  }
  affine_reset(ap, av, wp, wv, r);
  if (bound && exact) {
    // the bound's y-row minima and maxima
    block_minmax(a.P + N, N, red, ymm + 0, ymm + 3);
    block_minmax(a.V + N, N, red, ymm + 1, ymm + 4);
    if (a.first) {
      block_minmax(a.fa + N, N, red, ymm + 2, ymm + 5);
      if (tid == 0) {
        a.ymm[2] = ymm[2];
        a.ymm[5] = ymm[5];
      }
    } else if (tid == 0) {
      ymm[2] = a.ymm[2];
      ymm[5] = a.ymm[5];
    }
    if (tid == 0) {
      a.ymm[0] = ymm[0];
      a.ymm[1] = ymm[1];
      a.ymm[3] = ymm[3];
      a.ymm[4] = ymm[4];
    }
  } else if (bound && tid < 6) {
    ymm[tid] = a.ymm[tid];  // the exact-free build: taken by the caller
  }
  __syncthreads();

  const M* Uy = exact ? a.ulift + (size_t)r * N : nullptr;
  int k = 0;
  for (int i = 0; i < a.steps; ++i) {
    affine_predictor(ap, av, wp, wv, r, a.dt, a.eta, asn, avd, wsn);
    __syncthreads();
    if (exact)
      for (int j = tid; j < r; j += nt) wy[j] = Round<M, T>::apply(wsn[r + j]);
    if (bound) {
      if (tid < 32) {
        T s2 = T(0);
        for (int j = tid; j < r; j += 32) s2 += wsn[r + j] * wsn[r + j];
        s2 = warp_sum(s2);
        if (tid == 0) {
          T lb = T(0);
          for (int j = 0; j < 3; ++j) {
            const T c = asn[3 + j];
            lb += c >= T(0) ? c * ymm[j] : c * ymm[3 + j];
          }
          const T rel = a.eps * (T(1) + (lb < T(0) ? -lb : lb));
          if (sqrt_free) {
            const T mm = lb - a.floor_h - rel;
            maybe = (mm < T(0)) || (mm * mm < a.c2 * s2);
          } else {
            // the slack is 0.25 (BOUND_SLACK - 1) of the lift term
            const T wn = tsqrt(s2);
            const T slack = T(0.25) * wn * a.umax + rel;
            maybe = lb - wn * a.umax - slack < a.floor_h;
          }
        }
      }
      __syncthreads();
    }
    if (exact) {
      if (!bound || maybe) {
        int hit = 0;
        for (int v = tid; v < N; v += nt)
          hit |= affine_row(asn + 3, wy, a.P[N + v], a.V[N + v], a.fa[N + v],
                            Uy, N, r, v) < a.floor_h;
        if (__syncthreads_or(hit)) break;
      }
    } else if (maybe) {
      break;  // the exact-free build: a bound trip is the stop
    }
    affine_rb_const(asn, wsn, bu0, bu1, bufa, mutac,
                    static_rb ? rbex
                              : a.rbex + (size_t)min(i, a.rb_T - 1) * 3 * r,
                    r, rbc);
    if (fold) {
      affine_combine(asn, wsn, b0s, b1s, fas, g, a.UG, r, g, vc);
    } else {
      affine_combine(asn, wsn, a.P, a.V, a.fa, N, a.usel, r, n_sel, snsel);
      __syncthreads();
      for (int j = tid; j < 3 * g; j += nt) {
        const int d = j / g, c = j - d * g;
        vc[j] = gather_col(ops, snsel + d * n_sel, c);
      }
    }
    __syncthreads();
    iterate_block(ops, rbc, rb, vc, vall, pt, num_iterations);
    solve_block(ops, rb, u);
    __syncthreads();
    affine_update(ap, av, wp, wv, asn, avd, wsn, u, r, a.dt);
    __syncthreads();
    k = i + 1;
  }
  for (int i = tid; i < 18 + 6 * r; i += nt)
    a.out[i] = i < 9 ? ap[i] : i < 18 ? av[i - 9]
             : i < 18 + 3 * r ? wp[i - 18] : wv[i - 18 - 3 * r];
  if (tid == 0) *a.k = k;
}

template <typename T, typename M, int O>
int launch_chunk(const void* P, const void* V, const void* fa, void* ymm,
                 const void* b0s, const void* b1s, const void* fas,
                 const void* bu0, const void* bu1, const void* bufa,
                 const void* rbex, const void* ulift, const void* mutac,
                 const void* UG, const void* usel, const void* C,
                 const void* inv, const void* WT, const void* gptr,
                 const void* gcol, const void* gw, const void* kind,
                 const void* eg, const void* ef, void* out, void* k, int N,
                 int r, int g, int m, int n_sel, int steps,
                 int num_iterations, int first, int nb, double dt,
                 double eta, double floor_h, double c2, double eps,
                 double umax, int rb_T, long long rb_sim, void* stream) {
  const Iter<T> op =
      make_iter<T>(C, inv, WT, gptr, gcol, gw, kind, eg, ef, r, g, m);
  Chunk<T, M> a;
  a.P = static_cast<const T*>(P);
  a.V = static_cast<const T*>(V);
  a.fa = static_cast<const T*>(fa);
  a.ymm = static_cast<T*>(ymm);
  a.b0s = static_cast<const T*>(b0s);
  a.b1s = static_cast<const T*>(b1s);
  a.fas = static_cast<const T*>(fas);
  a.bu0 = static_cast<const T*>(bu0);
  a.bu1 = static_cast<const T*>(bu1);
  a.bufa = static_cast<const T*>(bufa);
  a.rbex = static_cast<const T*>(rbex);
  a.rb_T = rb_T;
  a.rb_sim = rb_sim;
  a.ulift = static_cast<const M*>(ulift);
  a.mutac = static_cast<const T*>(mutac);
  a.UG = static_cast<const T*>(UG);
  a.usel = static_cast<const T*>(usel);
  a.out = static_cast<T*>(out);
  a.k = static_cast<int*>(k);
  a.N = N;
  a.r = r;
  a.g = g;
  a.n_sel = n_sel;
  a.steps = steps;
  a.first = first;
  a.dt = (T)dt;
  a.eta = (T)eta;
  a.floor_h = (T)floor_h;
  a.c2 = (T)c2;
  a.eps = (T)eps;
  a.umax = (T)umax;
  // stage M_utac and inv3 in shared memory when they fit
  a.stage = sizeof(T) * chunk_smem_elems<O>(r, g, m, n_sel, true) <=
            SMEM_MAX;
  const size_t smem = sizeof(T) * chunk_smem_elems<O>(r, g, m, n_sel,
                                                      a.stage);
  cudaError_t e = allow_smem(affine_chunk<T, M, O>, smem);
  if (e != cudaSuccess) return e;
  affine_chunk<T, M, O><<<nb, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      a, op, num_iterations);
  return cudaGetLastError();
}

}  // namespace ksm

// The C entry point of one build: nb sims (nb = 1: the solo chunk); rbex:
// rb_T rows of (3, r) per sim from the chunk's first step, sim b's at
// b * rb_sim (0: shared by the sims)
#define CHUNK_ENTRY(NAME, T, M, O)                                           \
  extern "C" int NAME(                                                       \
      const void* P, const void* V, const void* fa, void* ymm,               \
      const void* b0s, const void* b1s, const void* fas, const void* bu0,    \
      const void* bu1, const void* bufa, const void* rbex,                   \
      const void* ulift, const void* mutac, const void* UG,                  \
      const void* usel, const void* C, const void* inv, const void* WT,      \
      const void* gptr, const void* gcol, const void* gw, const void* kind,  \
      const void* eg, const void* ef, void* out, void* k, int N, int r,      \
      int g, int m, int n_sel, int steps, int num_iterations, int first,     \
      int nb, double dt, double eta, double floor_h, double c2, double eps,  \
      double umax, int rb_T, long long rb_sim, void* stream) {               \
    return ksm::launch_chunk<T, M, O>(                                       \
        P, V, fa, ymm, b0s, b1s, fas, bu0, bu1, bufa, rbex, ulift, mutac,    \
        UG, usel, C, inv, WT, gptr, gcol, gw, kind, eg, ef, out, k, N, r, g, \
        m, n_sel, steps, num_iterations, first, nb, dt, eta, floor_h, c2,    \
        eps, umax, rb_T, rb_sim, stream);                                    \
  }

// a build for both storage types: affine_chunk_f32_f32_o<O> and
// affine_chunk_f32_bf16_o<O> (ops/affine_chunked.py symbol)
#define CHUNK_BUILD(O)                                     \
  CHUNK_ENTRY(affine_chunk_f32_f32_o##O, float, float, O)  \
  CHUNK_ENTRY(affine_chunk_f32_bf16_o##O, float, __nv_bfloat16, O)
