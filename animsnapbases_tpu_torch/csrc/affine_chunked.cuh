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
//   in the exact builds with the bound, where that bound trips, the
//     per-mode interval bound: with w = wsn_y rounded to the storage type
//     (wy, what the exact row reads) and lo_j, hi_j the minimum and
//     maximum over the N vertices of row j of the lift's y slice (`yrange`,
//     widened from the storage type as the exact row widens it), the step
//     is certified when
//       lb_aff + iv - (0.25 ia + eps (1 + |lb_aff|)) >= floor_h,
//       iv = sum_j (w_j >= 0 ? w_j lo_j : w_j hi_j),
//       ia = sum_j |w_j| max(-lo_j, hi_j);
//     iv is at most every vertex's lift sum_j w_j U_jv in exact arithmetic,
//     and the exact row's float sum and this one each round by under
//     r u ia (u the state type's unit roundoff: 2.9e-6 ia at r = 48 in
//     float32), so 0.25 ia covers both with room, as the Cauchy-Schwarz
//     bound's 25 % covers its own, and eps (1 + |lb_aff|) the anchors' part
//     as there: a step this bound certifies never has an exact row under
//     the floor.  Either bound clearing certifies the step;
//   in the exact builds (CHUNK_EXACT), when both bounds fail or on every
//     step without the bound, the exact y row a0 P_y + a1 V_y + a2 fa_y +
//     wsn_y U_y, and the chunk stops before the first step it clamps; in
//     the exact-free build a trip of the Cauchy-Schwarz bound is the stop
//     (no interval bound: the JAX package's rule), and the (r, N) y slice
//     of the lift is never read (the caller passes no lift);
//   rb_const = rb_i - (a0 bu0 + a1 bu1 + a2 bu_fa + wsn M_utac), rb_i the
//     row min(i, T - 1) of the target-term schedule from the chunk's first
//     step (the JAX kernel's rb_seq rows, :1363-1369, :1463-1465; the outer
//     loop hands each chunk the schedule from its first step on),
//   the gathered values Vc: with CHUNK_FOLD a0 b0s + a1 b1s + a2 fas +
//     wsn UG_allT (the gathered columns); without it the predictor at the
//     selected prefix, a0 P_sel + a1 V_sel + a2 fa_sel + wsn U_selT, into
//     shared memory and through the star gather (gather_col), as kernels 3
//     and 4 form it;
//   the iteration loop and solve (iteration_cluster.cuh), the coefficient
//   update.
// It writes ap, av, wp, wv and k, the steps done, and counts into the
// device counters (`counts`, affine.cuh COUNT_*; null: not counted) the
// steps that ran the exact check and those the interval bound certified:
// the y block's verdict thread keeps them in registers and adds them once
// at the chunk's end.  The exact builds with
// the bound take the y-row minima and maxima, of P and V once per chunk and
// of fa in the first chunk of a call (ADVICE r5), into `ymm`; the
// exact-free build reads them from `ymm` (the outer loop takes them).
//
// What bounds it on this card: per step it reads only small operands (the
// (3, r) and (3, g) coefficient operands, M_utac, UG_allT or U_selT and the
// loop's operands, ~0.3 MB in float32 at the bench scene) unless the exact
// check runs; that reads the (r, N) y slice of the lift (1.8 MB in bfloat16
// at 14,400 vertices, 24 MB at 250,000).  By bytes that is well under a
// microsecond per step; as for kernel 1, the latency of the dependent
// chains sets the time.
//
// What the design does about it: ONE cluster of three thread blocks runs
// the whole chunk, block d owning dimension d, so no launch or
// device-memory round trip separates the steps.  Every piece of a step but
// the loop's projections and the floor test is separable by dimension
// (the predictor, rb_const, the gathered values, the solve, the update:
// affine.cuh's pieces, here one row each), so block d keeps dimension d's
// coefficient state (ap, av, wp, wv rows), its per-chunk operands (bu0,
// bu1, bu_fa, and b0s, b1s, fas with CHUNK_FOLD) and, as the staging plan
// says (ops/cluster.py: the loop's C_d and WT_d, then inv3_d, then M_utac_d
// and UG_d or U_selT_d; ~156 KB at the bench widths), the operands it
// reads every step in its shared memory for the whole chunk; the loop
// (iteration_cluster.cuh) exchanges Vall through distributed shared
// memory.  A static target term (T = 1, CHUNK_STATIC) is staged once too;
// an animated schedule's rows do not fit, so each step reads its own row
// from L2 where rb_const is formed.  The y block (d = 1) holds what the
// floor test reads (the interval bound's 2r constants staged in its shared
// memory): it decides the bounds (the sums in its first warp, the verdict
// in one thread) and the exact check
// (__syncthreads_or) and writes the step's verdict into every block's
// shared memory before the loop's first exchange; all three read it after
// that exchange and stop together, so no block leaves the step loop
// while a peer waits at a barrier.  The exact builds with the bound take
// the three y rows' minima and maxima one row a block at the chunk's
// start.  The options are template arguments, so a build carries no code
// (and no registers) of the branches it does not take.
//
// The batched build (nb sims, the JAX kernel's nb = B; the tier 1 of
// make_batched_run's large-model route) runs one cluster per sim on a grid
// of (3, nb) blocks, each cluster the solo chunk on sim b's buffers
// (sim-major: P, V, fa (nb, 3, N); b0s, b1s, fas (nb, 3, g); bu0, bu1,
// bu_fa (nb, 3, r); ymm (nb, 6); out (nb, 18 + 6r); k (nb,)).  At ~167 KB a
// block, one block fits on an SM, so a wave holds 44 sims and more run in
// further waves.  Each cluster records its own k_b; the whole-batch exit
// (stop before the first step at which any sim clamps, or trips its bound
// in the exact-free build) is made by the caller (ops/affine_chunked.py),
// which launches the chunk again for min k_b steps when the k_b differ.
// No cluster waits for another: a grid-wide barrier hangs when clusters
// are not co-resident.
#pragma once

#include "affine.cuh"
#include "iteration_cluster.cuh"

namespace ksm {

// the build options (ops/affine_chunked.py ChunkOptions.code)
enum : int {
  CHUNK_BOUND = 1,       // floor_bound_skip: the O(r) bound first
  CHUNK_EXACT = 2,       // floor_exact: the exact y row decides
  CHUNK_FOLD = 4,        // fold_vc: Vc through the G-composed operands
  CHUNK_STATIC = 8,      // static_rb: a one-row schedule staged once
  CHUNK_SQRT_FREE = 16,  // sqrt_free_bound: the bound on squared magnitudes
  CHUNK_DEFAULT = 31
};

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
  const T* yrange;    // (2, r): lo, hi of the lift's y rows (exact + bound)
  const T* mutac;     // (3, r, r)
  const T* UG;        // (3, r, g) with CHUNK_FOLD
  T* out;             // ap (9), av (9), wp (3r), wv (3r)
  int* k;
  long long rb_sim;   // elements from a sim's schedule to the next
  int N, steps, first, rb_T;
  int r, g;           // for the per-sim offsets
  T dt, eta, floor_h, c2, eps;
  // what only some builds read: the selected prefix's map and width
  // (without CHUNK_FOLD), the bound's lift constant (without
  // CHUNK_SQRT_FREE)
  const T* usel;      // (3, r, n_sel)
  int n_sel;
  T umax;
};

// Offsets of a block's buffers beside the loop's (-1: read from L2)
struct ChunkLayout {
  LoopLayout loop;
  int coef;                                  // ap, av, asn, avd: 4 each
  int wp, wv, wsn, u, bu0, bu1, bufa, rbex;  // r each
  int wy;                                    // r: wsn_y in the storage type
  int ylo, yhi;                              // r each: the y block's yrange
  int cols;   // CHUNK_FOLD: b0s, b1s, fas (3 rows of pad4(g)); else snT_sel
  int red, ymm;                              // 16: reductions; 8: bound
  int mutac, map;                            // staged, or -1
};

template <int O>
__host__ __device__ inline ChunkLayout chunk_layout(Carve& cv, int r, int g,
                                                    int m, int n_sel,
                                                    int plan) {
  constexpr bool fold = (O & CHUNK_FOLD) != 0;
  ChunkLayout L;
  L.loop = loop_layout(cv, r, g, m, plan);
  L.coef = cv.take(16);
  L.wp = cv.take(r);
  L.wv = cv.take(r);
  L.wsn = cv.take(r);
  L.u = cv.take(r);
  L.bu0 = cv.take(r);
  L.bu1 = cv.take(r);
  L.bufa = cv.take(r);
  L.rbex = cv.take(r);
  L.wy = cv.take(r);
  L.ylo = cv.take(r);
  L.yhi = cv.take(r);
  L.cols = cv.take(fold ? 3 * pad4(g) : n_sel);
  L.red = cv.take(16);
  L.ymm = cv.take(8);
  L.mutac = cv.take_if(plan & STAGE_MUTAC, r * pad4(r));
  L.map = cv.take_if(plan & STAGE_MAP, r * pad4(fold ? g : n_sel));
  return L;
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
__global__ void __cluster_dims__(3, 1, 1)
    __launch_bounds__(CLUSTER_THREADS, 1)
        affine_chunk(Chunk<T, M> all, Iter<T> op, int num_iterations,
                     const int* lane_cols, int ms, int plan,
                     unsigned long long* counts) {
  constexpr bool bound = (O & CHUNK_BOUND) != 0;
  constexpr bool exact = (O & CHUNK_EXACT) != 0;
  constexpr bool fold = (O & CHUNK_FOLD) != 0;
  constexpr bool sqrt_free = (O & CHUNK_SQRT_FREE) != 0;
  constexpr bool interval = bound && exact;
  static_assert(bound || exact, "the exact-free build needs the bound");
  cg::cluster_group cl = cg::this_cluster();
  const int d = (int)cl.block_rank();  // the dimension; 1: the y block
  const Chunk<T, M> a = chunk_of_sim<O>(all, blockIdx.y);
  const int r = op.r, g = op.g, m = op.m, N = a.N, n_sel = a.n_sel;
  const int tid = threadIdx.x, nt = blockDim.x;
  T* smem = smem_at<T>(0);
  Carve cv;
  const ChunkLayout L = chunk_layout<O>(cv, r, g, m, n_sel, plan);
  const ClusterLoop<T> c = cluster_loop(op, L.loop, d, lane_cols, ms);
  // dimension d's rows of the coefficient state and step values
  T* ap = smem + L.coef;
  T* av = ap + 4;
  T* asn = ap + 8;
  T* avd = ap + 12;
  T* wp = smem + L.wp;
  T* wv = smem + L.wv;
  T* wsn = smem + L.wsn;
  T* u = smem + L.u;
  T* bu0 = smem + L.bu0;
  T* bu1 = smem + L.bu1;
  T* bufa = smem + L.bufa;
  T* rbex = smem + L.rbex;
  T* wy = smem + L.wy;
  T* ylo = smem + L.ylo;  // the y block's interval constants
  T* yhi = smem + L.yhi;
  T* b0s = smem + L.cols;  // CHUNK_FOLD
  T* b1s = b0s + pad4(g);
  T* fas = b1s + pad4(g);
  T* snsel = smem + L.cols;  // else
  T* ymm = smem + L.ymm;     // the bound's 6, then this block's y row's 2
  // [0, 1]: the step's verdict by step parity (written by the y block into
  // every block), [2]: the y block's bound
  int* flags = reinterpret_cast<int*>(smem + L.loop.misc);
  const Operand<T> mutac = operand(L.mutac, a.mutac + (size_t)d * r * r, r, r);
  const Operand<T> map =
      fold ? operand(L.map, a.UG + (size_t)d * r * g, r, g)
           : operand(L.map, a.usel + (size_t)d * r * n_sel, r, n_sel);

  const bool static_rb = (O & CHUNK_STATIC) && a.rb_T == 1;
  for (int i = tid; i < r; i += nt) {
    bu0[i] = a.bu0[d * r + i];
    bu1[i] = a.bu1[d * r + i];
    bufa[i] = a.bufa[d * r + i];
    if (static_rb) rbex[i] = a.rbex[d * r + i];
    if (interval && d == 1) {
      ylo[i] = a.yrange[i];
      yhi[i] = a.yrange[r + i];
    }
  }
  if (fold) {
    for (int i = tid; i < g; i += nt) {
      b0s[i] = a.b0s[d * g + i];
      b1s[i] = a.b1s[d * g + i];
      fas[i] = a.fas[d * g + i];
    }
  }
  affine_reset_row(ap, av, wp, wv, r);  // unit coefficients over the anchors
  if (bound && exact) {
    // the bound's y-row minima and maxima, one row a block: P, V and, in
    // the first chunk of a call, fa
    if (d < 2 || a.first)
      block_minmax((d == 0 ? a.P : d == 1 ? a.V : a.fa) + N, N,
                   smem + L.red, ymm + 6, ymm + 7);
  } else if (bound && d == 1 && tid < 6) {
    ymm[tid] = a.ymm[tid];  // the exact-free build: taken by the caller
  }
  cp_async_wait_all();
  // the staged operands are in, and every block of the cluster has started
  cl.sync();
  if (bound && exact && d == 1 && tid < 6) {
    const int src = tid % 3;  // ymm[tid]: row src's minimum, or maximum
    if (src == 2 && !a.first) {
      ymm[tid] = a.ymm[tid];
    } else {
      ymm[tid] = cl.map_shared_rank(ymm, src)[6 + tid / 3];
      a.ymm[tid] = ymm[tid];
    }
  }
  int* peer_flags[CLUSTER_SIZE];
  for (int e = 0; e < CLUSTER_SIZE; ++e)
    peer_flags[e] = cl.map_shared_rank(flags, e);

  const M* Uy = exact ? a.ulift + (size_t)r * N : nullptr;
  int k = 0;
  int checks = 0;  // the y block's thread 0: steps of the exact check
  int clears = 0;  // ... and steps the interval bound certified
  for (int i = 0; i < a.steps; ++i) {
    // the damped predictor of dimension d
    affine_predictor_row(ap, av, wp, wv, r, a.dt, a.eta, asn, avd, wsn);
    __syncthreads();
    if (d == 1) {
      // the step's verdict, decided here and written into every block
      if (exact)
        for (int j = tid; j < r; j += nt) wy[j] = Round<M, T>::apply(wsn[j]);
      if (bound && tid < 32) {
        // ||wsn_y||^2 and, for the interval bound, its sums iv and ia over
        // the rounded coordinates (the values wy holds)
        T s2 = T(0), iv = T(0), ia = T(0);
        for (int j = tid; j < r; j += 32) {
          s2 += wsn[j] * wsn[j];
          if (interval) {
            const T w = Round<M, T>::apply(wsn[j]);
            const T lo = ylo[j], hi = yhi[j];
            iv += w >= T(0) ? w * lo : w * hi;
            ia += (w < T(0) ? -w : w) * (-lo > hi ? -lo : hi);
          }
        }
        s2 = warp_sum(s2);
        if (interval) {
          iv = warp_sum(iv);
          ia = warp_sum(ia);
        }
        if (tid == 0) {
          T lb = T(0);
          for (int j = 0; j < 3; ++j) {
            const T cj = asn[j];
            lb += cj >= T(0) ? cj * ymm[j] : cj * ymm[3 + j];
          }
          const T rel = a.eps * (T(1) + (lb < T(0) ? -lb : lb));
          bool trip;
          if (sqrt_free) {
            const T mm = lb - a.floor_h - rel;
            trip = (mm < T(0)) || (mm * mm < a.c2 * s2);
          } else {
            // the slack is 0.25 (BOUND_SLACK - 1) of the lift term
            const T wn = tsqrt(s2);
            const T slack = T(0.25) * wn * a.umax + rel;
            trip = lb - wn * a.umax - slack < a.floor_h;
          }
          if (interval && trip) {
            // the interval bound (header; INTERVAL_SLACK 0.25)
            const bool clear = lb + iv - (T(0.25) * ia + rel) >= a.floor_h;
            clears += clear;
            trip = !clear;
          }
          flags[2] = trip;
        }
      }
      __syncthreads();
      int stop = bound ? flags[2] : 1;
      if (tid == 0) checks += exact && stop;
      if (exact && stop) {
        int hit = 0;
        for (int v = tid; v < N; v += nt)
          hit |= affine_row(asn, wy, a.P[N + v], a.V[N + v], a.fa[N + v], Uy,
                            N, r, v) < a.floor_h;
        stop = __syncthreads_or(hit);
      }
      if (tid == 0) {
        for (int e = 0; e < CLUSTER_SIZE; ++e) {
          if (e == d)
            flags[i & 1] = stop;
          else if (num_iterations > 0)
            // counted on the peer's barrier of the step's first iteration
            st_async(peer_addr(smem_addr(flags + (i & 1)), e), stop,
                     c.peer_bar_a[e] + 8 * ((i * num_iterations) & 1));
          else
            peer_flags[e][i & 1] = stop;
        }
      }
    }
    // rb_const = rb_i - (a0 bu0 + a1 bu1 + a2 bu_fa + wsn M_utac) and Vc
    // of dimension d
    const T* rbx = static_rb ? rbex
                             : a.rbex + (size_t)min(i, a.rb_T - 1) * 3 * r +
                                   (size_t)d * r;
    affine_rb_const_row(asn, wsn, bu0, bu1, bufa, mutac, rbx, r, c.rbc);
    if (fold) {
      affine_combine_row(asn, wsn, b0s, b1s, fas, map, r, g, c.vc);
    } else {
      const size_t x = (size_t)d * N;
      affine_combine_row(asn, wsn, a.P + x, a.V + x, a.fa + x, map, r, n_sel,
                         snsel);
      __syncthreads();
      for (int j = tid; j < g; j += nt) c.vc[j] = gather_col(op, snsel, j);
    }
    __syncthreads();
    if (iterate_cluster(c, num_iterations, flags + (i & 1),
                        i * num_iterations, d != 1 ? 4 : 0))
      break;
    solve_cluster(c, [&](int n, T acc) { u[n] = acc; });
    __syncthreads();
    // the coefficient update of dimension d
    affine_update_row(ap, av, wp, wv, asn, avd, wsn, u, r, a.dt);
    __syncthreads();
    k = i + 1;
  }
  coef_rows(a.out, d, r, ap, av, wp, wv, true);
  if (d == 0 && tid == 0) *a.k = k;
  if (d == 1 && tid == 0) {
    count_add(counts, COUNT_K5_EXACT_CHECKS, checks);
    count_add(counts, COUNT_K5_INTERVAL_CLEARS, clears);
  }
  // no block leaves while a peer may still read its shared memory
  cl.sync();
}

// shared memory of a block (bytes) for the staging plan's bits
template <int O>
inline size_t chunk_smem_bytes(int r, int g, int m, int n_sel, int plan) {
  Carve cv;
  chunk_layout<O>(cv, r, g, m, n_sel, plan);
  return 4 * (size_t)cv.at;
}

template <typename T, typename M, int O>
int launch_chunk(const void* P, const void* V, const void* fa, void* ymm,
                 const void* b0s, const void* b1s, const void* fas,
                 const void* bu0, const void* bu1, const void* bufa,
                 const void* rbex, const void* ulift, const void* yrange,
                 const void* mutac, const void* UG, const void* usel,
                 const void* C, const void* inv, const void* WT,
                 const void* gptr, const void* gcol, const void* gw,
                 const void* kind, const void* eg, const void* ef, void* out,
                 void* k, int N,
                 int r, int g, int m, int n_sel, int steps,
                 int num_iterations, int first, int nb, double dt,
                 double eta, double floor_h, double c2, double eps,
                 double umax, int rb_T, long long rb_sim, const void* lane_cols,
                 int ms, int plan, int smem, void* stream, void* counts) {
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
  a.yrange = static_cast<const T*>(yrange);
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
  // the wrapper's plan must size the blocks as this carving does
  if ((size_t)smem != chunk_smem_bytes<O>(r, g, m, n_sel, plan) ||
      (size_t)smem > CLUSTER_SMEM_MAX)
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(affine_chunk<T, M, O>, smem);
  if (e != cudaSuccess) return e;
  affine_chunk<T, M, O><<<dim3(CLUSTER_SIZE, nb), CLUSTER_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      a, op, num_iterations, static_cast<const int*>(lane_cols), ms, plan,
      static_cast<unsigned long long*>(counts));
  return cudaGetLastError();
}

}  // namespace ksm

// The C entry point of one build: nb sims (nb = 1: the solo chunk); rbex:
// rb_T rows of (3, r) per sim from the chunk's first step, sim b's at
// b * rb_sim (0: shared by the sims); yrange (2, r): the interval bound's
// constants, shared by the sims (null where the build has no interval
// bound); lane_cols (ms,): the loop's projection order; plan: the staging
// plan's bits, smem its bytes a block (ops/cluster.py); counts: the device
// counters' block (null: not counted)
#define CHUNK_ENTRY(NAME, T, M, O)                                           \
  extern "C" int NAME(                                                       \
      const void* P, const void* V, const void* fa, void* ymm,               \
      const void* b0s, const void* b1s, const void* fas, const void* bu0,    \
      const void* bu1, const void* bufa, const void* rbex,                   \
      const void* ulift, const void* yrange, const void* mutac,              \
      const void* UG, const void* usel, const void* C, const void* inv,      \
      const void* WT, const void* gptr, const void* gcol, const void* gw,    \
      const void* kind, const void* eg, const void* ef, void* out, void* k,  \
      int N, int r, int g, int m, int n_sel, int steps, int num_iterations,  \
      int first, int nb, double dt, double eta, double floor_h, double c2,   \
      double eps, double umax, int rb_T, long long rb_sim,                   \
      const void* lane_cols, int ms, int plan, int smem, void* stream,       \
      void* counts) {                                                        \
    return ksm::launch_chunk<T, M, O>(                                       \
        P, V, fa, ymm, b0s, b1s, fas, bu0, bu1, bufa, rbex, ulift, yrange,   \
        mutac, UG, usel, C, inv, WT, gptr, gcol, gw, kind, eg, ef, out, k,   \
        N, r, g, m, n_sel, steps, num_iterations, first, nb, dt, eta,        \
        floor_h, c2, eps, umax, rb_T, rb_sim, lane_cols, ms, plan, smem,     \
        stream, counts);                                                     \
  }

// a build for both storage types: affine_chunk_f32_f32_o<O> and
// affine_chunk_f32_bf16_o<O> (ops/affine_chunked.py symbol)
#define CHUNK_BUILD(O)                                     \
  CHUNK_ENTRY(affine_chunk_f32_f32_o##O, float, float, O)  \
  CHUNK_ENTRY(affine_chunk_f32_bf16_o##O, float, __nv_bfloat16, O)
