// Kernel 5: one chunk of the chunked affine tier 1.
//
// Replaces: animsnapbases_tpu/ops/pallas_resident.py
//   build_resident_affine_chunked, the chunk kernel _make_chunk_kernel
//   (:1309-1496, pallas_call :1539), with floor_bound_skip, floor_exact,
//   fold_vc and sqrt_free_bound on, and static_rb on or off as the target
//   term's schedule has one row or more (below).  Its outer loop (_body,
//   :1498-1634) is Python in ops/affine_chunked.py.
// From unit coefficients over the chunk's anchors P, V, each of up to
// `steps` steps:
//   the damped predictor in coefficients (asn, wsn);
//   the O(r) floor bound on the y row: lb_aff from the y-row minima and
//     maxima of P, V and fa, m = lb_aff - floor_h - eps (1 + |lb_aff|); the
//     step may clamp when m < 0 or m^2 < (1.25 umax)^2 ||wsn_y||^2;
//   only then the exact y row a0 P_y + a1 V_y + a2 fa_y + wsn_y U_y, and
//     the chunk stops before the first step it clamps;
//   rb_const = rb_i - (a0 bu0 + a1 bu1 + a2 bu_fa + wsn M_utac), rb_i the
//     row min(i, T - 1) of the target-term schedule from the chunk's first
//     step (the JAX kernel's rb_seq rows, :1363-1369, :1463-1465; the outer
//     loop hands each chunk the schedule from its first step on),
//   Vc = a0 b0s + a1 b1s + a2 fas + wsn UG_allT (the gathered columns),
//   the iteration loop and solve (iteration.cuh), the coefficient update.
// It writes ap, av, wp, wv and k, the steps done.  It also takes the y-row
// minima and maxima, of P and V once per chunk and of fa in the first
// chunk of a call (ADVICE r5), into `ymm`.
//
// What bounds it on this card: per step it reads only small operands (the
// (3, r) and (3, g) coefficient operands, M_utac, UG_allT and the loop's
// operands, ~0.3 MB in float32 at the bench scene) unless the bound trips;
// the exact check then reads the (r, N) y slice of the lift (1.8 MB in
// bfloat16).  By bytes that is well under a microsecond per step; as for
// kernel 1, the latency of the single block's dependent chains sets the
// time.
//
// What the design does about it: ONE thread block runs the whole chunk,
// as kernel 1 runs its loop, so no launch or device-memory round trip
// separates the steps.  The coefficient state (ap, av, wp, wv), the
// per-chunk operands (bu0, bu1, bu_fa, b0s, b1s, fas) and, when they
// fit beside the loop's buffers, M_utac and inv3 (2 x 49 KB at r = 64 in
// float32) live in shared memory for the whole chunk, which takes the
// r-long dependent-load chains of rb_lin and the solve off L2.  A static
// target term (T = 1, the JAX static_rb) is staged there once too; an
// animated schedule's rows do not fit (a 1,024-step chunk's are 786 KB at
// r = 64), so each step reads its own row, 768 B, from L2 where rb_const
// is formed (one load per entry, no dependent chain).  The
// branch of a step (bound clear, exact check, stop) is block-uniform:
// one thread decides the bound, __syncthreads_or the exact check.
//
// The batched build (nb sims, the JAX kernel's nb = B; the tier 1 of
// make_batched_run's large-model route) runs one block per sim on a grid of
// nb blocks, each the solo chunk on sim b's buffers (sim-major: P, V, fa
// (nb, 3, N); b0s, b1s, fas (nb, 3, g); bu0, bu1, bu_fa (nb, 3, r); ymm
// (nb, 6); out (nb, 18 + 6r); k (nb,)), M_utac and inv3 staged per block.
// At r = 64 a block's shared memory (~120 KB) allows one block per SM, so
// up to 132 sims run in one wave and more in further waves.  Each block
// records its own k_b; the whole-batch exit (stop before the first step at
// which any sim clamps) is made by the caller (ops/affine_chunked.py),
// which launches the chunk again for min k_b steps when the k_b differ.
// No block waits for another: a grid-wide barrier hangs when blocks are
// not co-resident.
#include "affine.cuh"

namespace ksm {

constexpr int THREADS = 256;
constexpr size_t SMEM_MAX = 232448;  // 227 KB a block can use

extern __shared__ __align__(16) unsigned char chunk_smem[];

template <typename T, typename M>
struct Chunk {
  const T* P;  // (3, N) the anchors: the chunk reads their y rows
  const T* V;
  const T* fa;
  T* ymm;             // (6,) minima of P_y, V_y, fa_y, then maxima
  const T* b0s;       // (3, g) gathered columns of P, V, fa
  const T* b1s;
  const T* fas;
  const T* bu0;       // (3, r) U^T A_c of P, V, fa
  const T* bu1;
  const T* bufa;
  const T* rbex;      // rb_T rows of (3, r) from the chunk's first step
  const M* ulift;     // (3, r, N)
  const T* mutac;     // (3, r, r)
  const T* UG;        // (3, r, g)
  T* out;             // ap (9), av (9), wp (3r), wv (3r)
  int* k;
  long long rb_sim;   // elements from a sim's schedule to the next
  int N, steps, first, stage, rb_T;
  int r, g;           // for the per-sim offsets
  T dt, eta, floor_h, c2, eps;
};

__host__ __device__ inline size_t chunk_smem_elems(int r, int g, int m,
                                                   bool stage) {
  // the loop's buffers; ap, av, asn, avd; wp, wv, wsn, u, bu0, bu1, bu_fa,
  // rb_ex; wy; b0s, b1s, fas; red, ymm; M_utac and inv3 when staged
  return iter_smem_elems(r, g, m) + 36 + 8 * 3 * r + r + 9 * g + 16 + 8 +
         (stage ? 6 * (size_t)r * r : 0);
}

// the chunk of sim b: the per-sim buffers are laid out sim after sim
template <typename T, typename M>
__device__ Chunk<T, M> chunk_of_sim(Chunk<T, M> a, int b) {
  const size_t x = (size_t)b * 3 * a.N, gs = (size_t)b * 3 * a.g;
  const size_t rs = (size_t)b * 3 * a.r;
  a.P += x;
  a.V += x;
  a.fa += x;
  a.ymm += (size_t)b * 6;
  a.b0s += gs;
  a.b1s += gs;
  a.fas += gs;
  a.bu0 += rs;
  a.bu1 += rs;
  a.bufa += rs;
  a.rbex += (size_t)b * a.rb_sim;
  a.out += (size_t)b * (18 + 6 * a.r);
  a.k += b;
  return a;
}

template <typename T, typename M>
__global__ void affine_chunk(Chunk<T, M> all, Iter<T> op,
                             int num_iterations) {
  __shared__ int maybe;
  const Chunk<T, M> a = chunk_of_sim(all, blockIdx.x);
  const int r = op.r, g = op.g, m = op.m, N = a.N;
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
  T* b0s = wy + r;
  T* b1s = b0s + 3 * g;
  T* fas = b1s + 3 * g;
  T* red = fas + 3 * g;    // 16: block reductions
  T* ymm = red + 16;       // 8
  T* mutac_s = ymm + 8;    // 3 r r, when staged
  T* inv_s = mutac_s + 3 * r * r;

  const bool static_rb = a.rb_T == 1;
  for (int i = tid; i < 3 * r; i += nt) {
    bu0[i] = a.bu0[i];
    bu1[i] = a.bu1[i];
    bufa[i] = a.bufa[i];
    if (static_rb) rbex[i] = a.rbex[i];
  }
  for (int i = tid; i < 3 * g; i += nt) {
    b0s[i] = a.b0s[i];
    b1s[i] = a.b1s[i];
    fas[i] = a.fas[i];
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
  __syncthreads();

  const M* Uy = a.ulift + (size_t)r * N;
  int k = 0;
  for (int i = 0; i < a.steps; ++i) {
    affine_predictor(ap, av, wp, wv, r, a.dt, a.eta, asn, avd, wsn);
    __syncthreads();
    for (int j = tid; j < r; j += nt) wy[j] = Round<M, T>::apply(wsn[r + j]);
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
        const T mm = lb - a.floor_h - a.eps * (T(1) + (lb < T(0) ? -lb : lb));
        maybe = (mm < T(0)) || (mm * mm < a.c2 * s2);
      }
    }
    __syncthreads();
    if (maybe) {
      int hit = 0;
      for (int v = tid; v < N; v += nt)
        hit |= affine_row(asn + 3, wy, a.P[N + v], a.V[N + v], a.fa[N + v],
                          Uy, N, r, v) < a.floor_h;
      if (__syncthreads_or(hit)) break;
    }
    affine_rb_const(asn, wsn, bu0, bu1, bufa, mutac,
                    static_rb ? rbex
                              : a.rbex + (size_t)min(i, a.rb_T - 1) * 3 * r,
                    r, rbc);
    affine_combine(asn, wsn, b0s, b1s, fas, g, a.UG, r, g, vc);
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

template <typename T, typename M>
int launch_chunk(const void* P, const void* V, const void* fa, void* ymm,
                 const void* b0s, const void* b1s, const void* fas,
                 const void* bu0, const void* bu1, const void* bufa,
                 const void* rbex, const void* ulift, const void* mutac,
                 const void* UG, const void* C, const void* inv,
                 const void* WT, const void* gptr, const void* gcol,
                 const void* gw, const void* kind, const void* eg,
                 const void* ef, void* out, void* k, int N,
                 int r, int g, int m, int steps, int num_iterations,
                 int first, int nb, double dt, double eta, double floor_h,
                 double c2, double eps, int rb_T, long long rb_sim,
                 void* stream) {
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
  a.out = static_cast<T*>(out);
  a.k = static_cast<int*>(k);
  a.N = N;
  a.r = r;
  a.g = g;
  a.steps = steps;
  a.first = first;
  a.dt = (T)dt;
  a.eta = (T)eta;
  a.floor_h = (T)floor_h;
  a.c2 = (T)c2;
  a.eps = (T)eps;
  // stage M_utac and inv3 in shared memory when they fit
  a.stage = sizeof(T) * chunk_smem_elems(r, g, m, true) <= SMEM_MAX;
  const size_t smem = sizeof(T) * chunk_smem_elems(r, g, m, a.stage);
  cudaError_t e = allow_smem(affine_chunk<T, M>, smem);
  if (e != cudaSuccess) return e;
  affine_chunk<T, M><<<nb, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(a, op,
                                                            num_iterations);
  return cudaGetLastError();
}

}  // namespace ksm

// nb sims (nb = 1: the solo chunk); rbex: rb_T rows of (3, r) per sim from
// the chunk's first step, sim b's at b * rb_sim (0: shared by the sims)
#define CHUNK_ENTRY(NAME, T, M)                                              \
  extern "C" int NAME(                                                       \
      const void* P, const void* V, const void* fa, void* ymm,               \
      const void* b0s, const void* b1s, const void* fas, const void* bu0,    \
      const void* bu1, const void* bufa, const void* rbex,                   \
      const void* ulift, const void* mutac, const void* UG, const void* C,   \
      const void* inv, const void* WT, const void* gptr, const void* gcol,   \
      const void* gw, const void* kind, const void* eg, const void* ef,      \
      void* out, void* k, int N, int r, int g, int m, int steps,             \
      int num_iterations, int first, int nb,                                 \
      double dt, double eta, double floor_h, double c2, double eps,          \
      int rb_T, long long rb_sim, void* stream) {                            \
    return ksm::launch_chunk<T, M>(                                          \
        P, V, fa, ymm, b0s, b1s, fas, bu0, bu1, bufa, rbex, ulift, mutac,    \
        UG, C, inv, WT, gptr, gcol, gw, kind, eg, ef, out, k, N, r, g, m,    \
        steps, num_iterations, first, nb, dt, eta, floor_h, c2, eps, rb_T,   \
        rb_sim, stream);                                                     \
  }

CHUNK_ENTRY(affine_chunk_f32_f32, float, float)
CHUNK_ENTRY(affine_chunk_f32_bf16, float, __nv_bfloat16)
