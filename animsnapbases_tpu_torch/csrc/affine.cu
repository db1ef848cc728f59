// Kernels 3 and 4: the affine-coordinate resident loops.
//
// Replaces: animsnapbases_tpu/ops/pallas_resident.py
//   build_resident_affine (:558-977, pallas_call :948), kernel 3, in its two
//   builds: contact_mode=False, the lean build (mode LEAN, or LEAN_NO_FLOOR),
//   and contact_mode=True (mode CONTACT, :710-715, :732-871, :928-936);
//   build_resident_affine_exit (:980-1142, pallas_call :1122): kernel 4
//   (mode EXIT), solo and batched (below).
// Both carry the state as base coefficients over the anchors b0, b1 and
// the force term fa, plus reduced coordinates (ops/affine.py, affine.cuh).
// Each step i of num_steps:
//   rebase when i > 0 and i % rebase_every == 0: materialize P and V, make
//     them the anchors, reset the coefficients, mark the projections stale;
//   the exact floor test on the y row of the predictor (floor on);
//   a free step in affine coordinates: bu0/bu1 = U^T A_c of the anchors
//     (when stale), rb_const from bu* and M_utac, snT_sel from the anchors'
//     selected prefix and U_selT, the iteration loop, the coefficient update;
//     rb_const takes row min(i, T - 1) of the sim's target-term schedule
//     (the JAX kernels' rb_seq, :686, :754-755, :1051, :1083-1084), as the
//     lean contact tail and a contact-mode step do; the host loop hands
//     each step's launches that row (the buPy/buVy recursion reads none);
//   on a clamped step, kernel 4 stops (that step is not applied; the call
//     reports the steps done) and kernel 3's lean build runs the
//     re-anchoring contact tail: the standard step on the materialized
//     predictor, whose result becomes the new anchors.
// At the end, P and V are materialized into the anchor buffers.
//
// Contact mode (mode CONTACT): a sim whose floor test clamps enters it at
// that step and keeps it until the next rebase.  Its x/z rows stay in
// affine coordinates; its y row is carried materialized (Py, Vy) with its
// projections buPy, buVy (U^T A_c of the y row through the y slice), kept by
// the recursion buPy' = buPy + dt eta buVy + bu_fa_y + pc + u_y M_utac_y,
// where pc projects the clamp's correction corr_y of the y predictor.  A
// contact step so reads the (r, N) y slices of U^T A_c and of the lift once
// each, for pc and for the lift of u_y, in place of the lean tail's full
// predictor, projection and lift.  Its launches:
//   mode_predict (128-vertex tiles): on entry Py, Vy materialized from the
//     coefficients; sn_y = Py + dt eta Vy + fa_y, clamped at the floor, into
//     the y row of sn; per-tile float64 partials of pc;
//   mode_solve (one cluster per sim): on entry buPy, buVy from bu0, bu1, bu_fa
//     and M_utac; rb_const and snT_sel with their y rows from the recursion
//     and the clamped sn_y; the loop; the coefficient update; the buPy/buVy
//     recursion; mode on;
//   mode_lift (vertices): q_y = sn_y + U_y u_y, Vy = (q_y - Py)/dt, Py = q_y.
// The entry rides in the first two (the JAX kernel's _enter_contact is a
// branch of its own): one launch fewer per step, and a launch that does
// nothing still costs 2-15 us on an H100 (PERF.md).  A rebase in contact
// mode materializes x/z from the coefficients and y from Py/Vy and leaves
// contact mode; the output does the same.
//
// What bounds it on this card: a free step reads the (r, N) y slice of the
// lift for the floor test (1.8 MB in bfloat16 at the bench scene) and a few
// r x r and r x n_sel operands, ~0.6 us at the HBM rate; its iteration loop
// is kernel 1's latency chain, which sets the time.  A lean contact step
// costs what a step of kernel 2 costs; a contact-mode step reads the two y
// slices (3.7 MB) and the y state, ~1.2 us, and still runs the loop.
//
// What the design does about it: as kernel 2 does, one C loop in this file
// enqueues every step's launches on the caller's stream, and nothing
// returns to the host between steps.  Which branch a step takes is known
// only on the device, so each launch reads a device-resident flag block
// (stale projections, done, steps done, contact mode, and one slot per
// step: bit 0 the floor test clamped, bit 1 a contact-mode step) and
// returns at once when its branch is not taken: 6 launches per step for
// kernel 3 with the floor on (either build), 3 for kernel 4, 2 more on
// rebase steps.  (A cooperative launch with grid.sync() would need every
// block resident at once and hangs the card if one is not; the per-launch
// flags need neither and reuse what kernel 2 proved.)  O(N) work (the floor
// test, projections, materializations) runs on grids of 128-vertex tiles.
// The step's serial part (free_step, contact_solve, mode_solve) runs on
// one cluster of three blocks per sim (iteration_cluster.cuh), block d
// owning dimension d: its rows of the coefficients, of rb_const and of the
// selected prefix (affine.cuh's row pieces, as kernel 5 runs them), the
// loop's operands C_d, WT_d, inv3_d and then M_utac_d and U_selT_d staged
// in its shared memory as the staging plan says (ops/cluster.py, kernel
// "affine": bits STAGE_*; the launch refuses a plan whose bytes differ),
// the rows of Vall pushed to the peers with st.async.  In contact mode the
// y block owns the y-only work: the pc sum, s, the buPy/buVy recursion
// with M_utac's y block and the Vc row gathered from the clamped sn_y; the
// x and z blocks run the affine rows.  Each output of a product is one
// thread's chain in the order of the one-block loop these kernels ran
// before, so the cluster kernels equal it bit for bit.  Projections
// through U^T A_c accumulate in float64, in per-tile partials summed in a
// fixed order (no atomics), as in kernel 2.
//
// Flags read by three blocks: each block of a cluster reads the sim's
// flags at its start and decides its branch from them; the y block writes
// them back (F_STALE, F_DONE, F_K, F_MODE and the step's S_CONTACT) only
// after the cluster barrier at the end of the launch, which every block
// passes after its read (kernel 4's F_DONE on a clamped step is written on
// the way out of a launch that all three blocks leave at their start).  So
// the three blocks take the same branch, and all return early together:
// a block that left while its peers waited at their transaction barriers
// would hang the card.
//
// The batched builds of kernel 3 (nb sims, the JAX kernel's nb = B; the
// routes of make_batched_run below CHUNKED_TIER1_MIN_VERTS) keep sim-major
// (nb, 3, N) states and per-sim coefficients, projections, partials, y
// states and flags.  The contact branch is PER SIM: in the lean build a sim
// whose predictor the floor clamps takes the re-anchoring tail, the others
// take the free step; in the contact-mode build each sim has its own mode
// slot, entered when its own predictor clamps; the cluster of a sim whose
// branch is not taken returns at its start.  (The JAX kernel sends the
// whole batch through the exact tail, or into contact mode with one mode
// flag, when any sim clamps; the clamp is the identity for the airborne
// sims, so both are exact, and per sim does not pay a contact step for
// each of them.)  The cluster launches run on a grid of (3, nb) blocks,
// one cluster a sim; the O(N) launches on a grid of (tiles, up to SIM_Y)
// blocks that loop over the sims; the floor test on (vertex blocks, sim
// groups of Y_GROUP), each lift element read once for the group.  Waves
// in the batched builds: a block of the full plan (~164 KB at the bench
// widths) leaves room for one on an SM, so fewer clusters than sims may be
// resident; the wrapper then takes the plan that stages less where that
// needs fewer waves of clusters (ops/cluster.py launch_plan), and the
// blocks hold their registers to two blocks an SM (__launch_bounds__).
// Every sim's arithmetic runs in the order of the solo call (nb = 1), and
// no plan changes a result, so sim b of a batched call equals the solo
// call from sim b's state bit for bit.
//
// The batched build of kernel 4 (mode EXIT, nb sims; the JAX kernel's nb >
// 1, pallas_resident.py:980, call :1122) runs the same launches on the same
// grids, one cluster a sim.  Each sim keeps its own F_DONE and F_K: its
// floor test sets its step's slot, its free_step cluster then sets F_DONE
// and returns, and from there every launch leaves that sim alone (the
// rebase's materialization and reset included) until the output
// materializes its state of F_K steps.  The JAX kernel stops the whole
// batch at the first step any sim would clamp; the wrapper
// (ops/affine.py resident_affine_exit_batched) takes k = min F_K over the
// sims and, when they differ, launches again for k steps from the same
// inputs, so no cluster waits for another.
#include "affine.cuh"

namespace ksm {

constexpr int TILE = 128;
constexpr int THREADS = 256;
constexpr int SIM_Y = 8;    // sim rows of the O(N) grids
constexpr int Y_GROUP = 8;  // sims per block of the batched floor test
enum : int { LEAN_NO_FLOOR = 0, EXIT = 1, LEAN = 2, CONTACT = 3 };
// flag slots of a sim; the slot of step i (F_STEP + i) holds S_CLAMPED
// when the floor test clamped and S_CONTACT when the step ran in contact
// mode
enum : int { F_STALE = 0, F_DONE = 1, F_K = 2, F_MODE = 3, F_STEP = 4 };
enum : int { S_CLAMPED = 1, S_CONTACT = 2 };
// what a projection reads; which sims an O(N) launch serves at a step
enum : int { SRC_FA = 0, SRC_ANCHORS = 1 };
enum : int { GATE_ALWAYS = 0, GATE_REFRESH = 1, GATE_CLAMPED = 2,
             GATE_NOT_DONE = 3, GATE_STALE = 4, GATE_CONTACT = 5,
             GATE_MODE = 6 };

extern __shared__ __align__(16) unsigned char affine_smem[];

template <typename T, typename M>
struct Affine {
  T* b0;  // (3, N) anchors, then the outputs
  T* b1;
  const T* fa;
  const T* rbex;   // this step's (3, r) row of sim 0's target schedule
  const M* ulift;  // (3, r, N), shared
  const M* utac;   // (3, r, N), shared
  const T* mutac;  // (3, r, r), shared
  const T* uselT;  // (3, r, n_sel), shared
  T* coef;         // ap (9), av (9), wp (3r), wv (3r)
  T* bu;           // bu0, bu1, bu_fa (3r each)
  T* sn;           // (3, N) contact tail: the clamped predictor
  T* Pm;           // (3, N) contact tail: the materialized P
  T* u;            // (3r)
  double* partial; // (nblk, 2, 3r)
  T* ys;           // (2, N) contact mode: Py, Vy
  T* ybu;          // (2r) contact mode: buPy, buVy
  double* pcpart;  // (nblk, r) contact mode: partials of pc
  int* flags;      // F_* slots, then one slot per step
  long long rb_sim;  // elements from a sim's schedule to the next (0: shared)
  int N, r, n_sel, nblk, nb, flag_stride;
  T dt, eta, floor_h;

  __device__ T* ap() const { return coef; }
  __device__ T* av() const { return coef + 9; }
  __device__ T* wp() const { return coef + 18; }
  __device__ T* wv() const { return coef + 18 + 3 * r; }

  // the same struct over sim b's buffers (the per-sim ones are laid out
  // sim after sim).  The O(N) launches use it; the cluster launches
  // (free_step, contact_solve, mode_solve) offset only the pointers they
  // use: a copy of the whole struct there made the solo free step 98 -> 138
  // us (tools/time_solo_kernels.py's profile on an H100)
  __device__ Affine at(int b) const {
    Affine s = *this;
    const size_t x = (size_t)b * 3 * N;
    s.b0 += x;
    s.b1 += x;
    s.fa += x;
    s.sn += x;
    s.Pm += x;
    s.coef += (size_t)b * (18 + 6 * r);
    s.bu += (size_t)b * 9 * r;
    s.u += (size_t)b * 3 * r;
    s.partial += (size_t)b * nblk * 2 * 3 * r;
    s.ys += (size_t)b * 2 * N;
    s.ybu += (size_t)b * 2 * r;
    s.pcpart += (size_t)b * nblk * r;
    s.flags += (size_t)b * flag_stride;
    return s;
  }
};

// The shared memory of a block of the cluster launches (free_step,
// contact_solve, mode_solve), the loop's buffers and staged operands
// first; every launch carves the same pieces, so one plan sizes the three
// (ops/cluster.py, kernel "affine")
struct AffineLayout {
  LoopLayout loop;
  int coef;                 // ap, av, asn, avd: 4 each
  int wp, wv, wsn, u, sy;   // r each (sy: contact mode's s, the y block)
  int sel;                  // n_sel: the dimension's row of snT_sel
  int mutac, usel;          // staged M_utac_d, U_selT_d, or -1
};

__host__ __device__ inline AffineLayout affine_layout(Carve& cv, int r, int g,
                                                      int m, int n_sel,
                                                      int plan) {
  AffineLayout L;
  L.loop = loop_layout(cv, r, g, m, plan);
  L.coef = cv.take(16);
  L.wp = cv.take(r);
  L.wv = cv.take(r);
  L.wsn = cv.take(r);
  L.u = cv.take(r);
  L.sy = cv.take(r);
  L.sel = cv.take(n_sel);
  L.mutac = cv.take_if(plan & STAGE_MUTAC, r * pad4(r));
  L.usel = cv.take_if(plan & STAGE_MAP, r * pad4(n_sel));
  return L;
}

// shared memory of a block (bytes) for the staging plan's bits
inline size_t affine_smem_bytes(int r, int g, int m, int n_sel, int plan) {
  Carve cv;
  affine_layout(cv, r, g, m, n_sel, plan);
  return 4 * (size_t)cv.at;
}

// One cluster block's rows of dimension d in its shared memory
template <typename T>
struct Rows {
  T *ap, *av, *asn, *avd;  // 3 each
  T *wp, *wv, *wsn, *u, *sy, *sel;
};

template <typename T>
__device__ __forceinline__ Rows<T> rows_of(const AffineLayout& L) {
  T* smem = smem_at<T>(0);
  Rows<T> w;
  w.ap = smem + L.coef;
  w.av = w.ap + 4;
  w.asn = w.ap + 8;
  w.avd = w.ap + 12;
  w.wp = smem + L.wp;
  w.wv = smem + L.wv;
  w.wsn = smem + L.wsn;
  w.u = smem + L.u;
  w.sy = smem + L.sy;
  w.sel = smem + L.sel;
  return w;
}

// The O(N) launches run on blocks (tile, y) that serve the sims y,
// y + gridDim.y, ...: of the 32 of them from `base` on, the bit mask of
// those whose gate is open at step i, the same in every thread.  One
// warp reads the 32 sims' flags at once (a sim-by-sim read paid a flag
// load's latency per sim: a no-op refresh launch took 18 us per step at
// 64 sims on an H100).
template <typename T, typename M>
__device__ unsigned open_sims(const Affine<T, M>& a, int base, int gate,
                              int step) {
  __shared__ unsigned mask;
  __syncthreads();  // every thread has read the previous round's mask
  if (threadIdx.x < 32) {
    const int b = base + threadIdx.x * gridDim.y;
    bool open = b < a.nb;
    if (open && gate != GATE_ALWAYS) {
      const int* fl = a.flags + (size_t)b * a.flag_stride;
      if (gate == GATE_REFRESH)
        open = !fl[F_DONE] && fl[F_STALE] && !fl[F_STEP + step];
      else if (gate == GATE_CLAMPED)
        open = fl[F_STEP + step];
      else if (gate == GATE_STALE)
        open = !fl[F_DONE] && fl[F_STALE];
      else if (gate == GATE_CONTACT)
        open = fl[F_MODE] || (fl[F_STEP + step] & S_CLAMPED);
      else if (gate == GATE_MODE)
        open = fl[F_MODE];
      else
        open = !fl[F_DONE];
    }
    const unsigned m = __ballot_sync(0xffffffffu, open);
    if (threadIdx.x == 0) mask = m;
  }
  __syncthreads();
  return mask;
}

// the sim of bit j of a mask from `base`
__device__ __forceinline__ int sim_of(int base, unsigned m) {
  return base + (__ffs(m) - 1) * gridDim.y;
}

// Per-tile float64 partials of U^T A_c x0 (and x1), x rounded to the
// storage type first: x0 = fa (SRC_FA) or x0, x1 = b0, b1 (SRC_ANCHORS),
// for the sims whose `gate` is open at step i.
template <typename T, typename M>
__global__ void project_partials(Affine<T, M> all, int src, int gate,
                                 int step) {
  __shared__ T xs[2][3][TILE];
  const int N = all.N, r = all.r;
  const int n0 = blockIdx.x * TILE;
  const int len = min(TILE, N - n0);
  const int nx = src == SRC_ANCHORS ? 2 : 1;
  for (int base = blockIdx.y; base < all.nb; base += 32 * gridDim.y)
  for (unsigned m = open_sims(all, base, gate, step); m; m &= m - 1) {
    const Affine<T, M> a = all.at(sim_of(base, m));
    __syncthreads();
    for (int i = threadIdx.x; i < nx * 3 * TILE; i += blockDim.x) {
      const int s = i / (3 * TILE), rem = i - s * 3 * TILE;
      const int d = rem / TILE, t = rem - d * TILE;
      const T* x = src == SRC_FA ? a.fa : (s ? a.b1 : a.b0);
      xs[s][d][t] = t < len ? Round<M, T>::apply(x[(size_t)d * N + n0 + t])
                            : T(0);
    }
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    for (int o = warp; o < nx * 3 * r; o += nw) {
      const int s = o / (3 * r), q = o - s * 3 * r, d = q / r;
      const M* row = a.utac + (size_t)q * N + n0;
      double acc = 0.0;
      for (int t = lane; t < len; t += 32)
        acc += (double)widen(row[t]) * (double)xs[s][d][t];
      acc = warp_sum(acc);
      if (lane == 0)
        a.partial[((size_t)blockIdx.x * 2 + s) * 3 * r + q] = acc;
    }
  }
}

// out[i] = (T) sum over a sim's nblk tiles of partial slot s, in tile order
template <typename T>
__device__ void sum_partials(const double* partial, int nblk, int r, int s,
                             T* out) {
  const int n = 3 * r;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    double acc = 0.0;
    for (int b = 0; b < nblk; ++b)
      acc += partial[((size_t)b * 2 + s) * n + i];
    out[i] = (T)acc;
  }
}

// Dimension d's rows of bu0 and bu1 (slots 0 and 1 of a sim's partials)
// summed as sum_partials sums them; out0, out1 the rows (r each)
template <typename T>
__device__ void sum_partial_rows(const double* partial, int nblk, int r,
                                 int d, T* out0, T* out1) {
  const int n = 3 * r;
  for (int i = threadIdx.x; i < 2 * r; i += blockDim.x) {
    const int s = i / r, k = i - s * r;
    double acc = 0.0;
    for (int b = 0; b < nblk; ++b)
      acc += partial[((size_t)b * 2 + s) * n + d * r + k];
    (s ? out1 : out0)[k] = (T)acc;
  }
}

// Start of a call, one block per sim: bu_fa = U^T A_c fa (once per call),
// unit coefficients over the entry state, stale projections.
template <typename T, typename M>
__global__ void init_call(Affine<T, M> all) {
  const Affine<T, M> a = all.at(blockIdx.x);
  sum_partials(a.partial, a.nblk, a.r, 0, a.bu + 6 * a.r);
  affine_reset(a.ap(), a.av(), a.wp(), a.wv(), a.r);
  if (threadIdx.x == 0) a.flags[F_STALE] = 1;
}

// The exact floor test of step i on the y row of the predictor, one vertex
// per thread, for the sims y*SG .. y*SG + SG - 1 of blockIdx.y's group:
// each element of the lift's y slice is read once for all of them.  Warp
// s forms sim s's predictor (the whole block, for one sim).  A sim in
// contact mode is not tested.
template <typename T, typename M, int SG>
__global__ void y_check(Affine<T, M> all, int step) {
  const int N = all.N, r = all.r;
  const int b0 = blockIdx.y * SG;
  const int ns = min(SG, all.nb - b0);
  T* asn = reinterpret_cast<T*>(affine_smem);  // SG x 9
  T* avd = asn + SG * 9;                        // SG x 9
  T* wsn = avd + SG * 9;                        // SG x 3r
  const int lanes = SG == 1 ? blockDim.x : 32;
  const int tid = SG == 1 ? threadIdx.x : threadIdx.x & 31;
  const int nw = SG == 1 ? 1 : blockDim.x >> 5;
  for (int s = SG == 1 ? 0 : threadIdx.x >> 5; s < ns; s += nw) {
    const T* coef = all.coef + (size_t)(b0 + s) * (18 + 6 * r);
    affine_predictor_by(tid, lanes, coef, coef + 9, coef + 18,
                        coef + 18 + 3 * r, r, all.dt, all.eta, asn + 9 * s,
                        avd + 9 * s, wsn + 3 * r * s);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SG * r; i += blockDim.x) {
    const int s = i / r, k = i - s * r;
    T* w = wsn + 3 * r * s + r + k;
    *w = s < ns ? Round<M, T>::apply(*w) : T(0);
  }
  __syncthreads();
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  T acc[SG];
#pragma unroll
  for (int s = 0; s < SG; ++s) acc[s] = T(0);
  if (v < N) {
    const M* U = all.ulift + (size_t)r * N + v;
    for (int k = 0; k < r; ++k) {
      const T c = widen(U[(size_t)k * N]);
#pragma unroll
      for (int s = 0; s < SG; ++s) acc[s] += wsn[3 * r * s + r + k] * c;
    }
  }
#pragma unroll
  for (int s = 0; s < SG; ++s) {
    if (s >= ns) break;
    const Affine<T, M> a = all.at(b0 + s);
    int hit = 0;
    if (v < N && !a.flags[F_DONE] && !a.flags[F_MODE]) {
      const T y = affine_base(asn + 9 * s + 3, a.b0[N + v], a.b1[N + v],
                              a.fa[N + v], acc[s]);
      hit = y < a.floor_h;
    }
    if (__syncthreads_or(hit) && threadIdx.x == 0)
      atomicOr(a.flags + F_STEP + step, S_CLAMPED);
  }
}

// The free step of step i, one cluster per sim (block d: dimension d):
// skipped when the step clamped (kernel 4 then stops for good) or the sim
// is in contact mode.
template <typename T, typename M>
__global__ void __cluster_dims__(3, 1, 1)
    __launch_bounds__(CLUSTER_THREADS, 2)
        free_step(Affine<T, M> a, Iter<T> op, int step, int mode,
                  int num_iterations, const int* lane_cols, int ms,
                  int plan) {
  cg::cluster_group cl = cg::this_cluster();
  const int d = (int)cl.block_rank();  // the dimension; 1: the y block
  const int b = blockIdx.y;            // the sim
  const int r = op.r, n_sel = a.n_sel, N = a.N;
  // the flags as they stand at the launch, read by all three blocks (the
  // y block writes them after the last cluster barrier)
  int* fl = a.flags + (size_t)b * a.flag_stride;
  const bool stale = fl[F_STALE];
  if (fl[F_DONE] || fl[F_MODE]) return;
  if (fl[F_STEP + step]) {
    // all three blocks return here, before any touches a peer
    if (mode == EXIT && d == 1 && threadIdx.x == 0) fl[F_DONE] = 1;
    return;
  }
  Carve cv;
  const AffineLayout L = affine_layout(cv, r, op.g, op.m, n_sel, plan);
  const ClusterLoop<T> c = cluster_loop(op, L.loop, d, lane_cols, ms);
  const Operand<T> mutac =
      operand(L.mutac, a.mutac + (size_t)d * r * r, r, r);
  const Operand<T> usel =
      operand(L.usel, a.uselT + (size_t)d * r * n_sel, r, n_sel);
  const Rows<T> w = rows_of<T>(L);
  T* coef = a.coef + (size_t)b * (18 + 6 * r);  // ap, av, wp, wv
  T* bu0 = a.bu + (size_t)b * 9 * r + (size_t)d * r;  // bu1, bu_fa: 3r, 6r on
  const size_t x = (size_t)b * 3 * N + (size_t)d * N;  // row d of the state
  coef_rows(coef, d, r, w.ap, w.av, w.wp, w.wv, false);
  if (stale)
    sum_partial_rows(a.partial + (size_t)b * a.nblk * 2 * 3 * r, a.nblk, r,
                     d, bu0, bu0 + 3 * r);
  cp_async_wait_all();
  // the staged operands are in, every block has read the flags, and every
  // block of the cluster has started (its shared memory may be written)
  cl.sync();
  affine_predictor_row(w.ap, w.av, w.wp, w.wv, r, a.dt, a.eta, w.asn, w.avd,
                       w.wsn);
  __syncthreads();
  affine_rb_const_row(w.asn, w.wsn, bu0, bu0 + 3 * r, bu0 + 6 * r, mutac,
                      a.rbex + (size_t)b * a.rb_sim + (size_t)d * r, r,
                      c.rbc);
  affine_combine_row(w.asn, w.wsn, a.b0 + x, a.b1 + x, a.fa + x, usel, r,
                     n_sel, w.sel);
  __syncthreads();
  for (int j = threadIdx.x; j < op.g; j += blockDim.x)
    c.vc[j] = gather_col(op, w.sel, j);
  __syncthreads();
  iterate_cluster(c, num_iterations);
  solve_cluster(c, [&](int n, T acc) { w.u[n] = acc; });
  __syncthreads();
  affine_update_row(w.ap, w.av, w.wp, w.wv, w.asn, w.avd, w.wsn, w.u, r,
                    a.dt);
  __syncthreads();
  coef_rows(coef, d, r, w.ap, w.av, w.wp, w.wv, true);
  // no block leaves while a peer may still read its shared memory
  cl.sync();
  if (d == 1 && threadIdx.x == 0) {
    if (stale) fl[F_STALE] = 0;
    if (mode == EXIT) fl[F_K] += 1;
  }
}

// Contact tail (kernel 3), part 1, on 128-vertex tiles, for each sim whose
// step i clamped: Pm = the materialized P, sn = the materialized predictor
// with the y row clamped, and the per-tile partials of U^T A_c sn.
template <typename T, typename M>
__global__ void contact_predict(Affine<T, M> all, int step) {
  const int N = all.N, r = all.r;
  T* asn = reinterpret_cast<T*>(affine_smem);  // 9
  T* avd = asn + 9;                             // 9
  T* wsn = avd + 9;                             // 3r, rounded below
  T* wpr = wsn + 3 * r;                         // 3r, rounded
  T* sns = wpr + 3 * r;                         // 3 x TILE, rounded
  const int n0 = blockIdx.x * TILE;
  const int len = min(TILE, N - n0);
  for (int base = blockIdx.y; base < all.nb; base += 32 * gridDim.y)
  for (unsigned m = open_sims(all, base, GATE_CLAMPED, step); m;
       m &= m - 1) {
    const Affine<T, M> a = all.at(sim_of(base, m));
    __syncthreads();
    affine_predictor(a.ap(), a.av(), a.wp(), a.wv(), r, a.dt, a.eta, asn,
                     avd, wsn);
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * r; i += blockDim.x) {
      wsn[i] = Round<M, T>::apply(wsn[i]);
      wpr[i] = Round<M, T>::apply(a.wp()[i]);
    }
    __syncthreads();
    const T* ap = a.ap();
    for (int i = threadIdx.x; i < 3 * TILE; i += blockDim.x) {
      const int d = i / TILE, t = i - d * TILE;
      T s = T(0);
      if (t < len) {
        const int v = n0 + t;
        const size_t x = (size_t)d * N + v;
        const M* U = a.ulift + (size_t)d * r * N;
        a.Pm[x] = affine_row(ap + 3 * d, wpr + d * r, a.b0[x], a.b1[x],
                             a.fa[x], U, N, r, v);
        s = affine_row(asn + 3 * d, wsn + d * r, a.b0[x], a.b1[x], a.fa[x],
                       U, N, r, v);
        if (d == 1 && s < a.floor_h) s = a.floor_h;
        a.sn[x] = s;
        s = Round<M, T>::apply(s);
      }
      sns[i] = s;
    }
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    for (int o = warp; o < 3 * r; o += nw) {
      const int d = o / r;
      const M* row = a.utac + (size_t)o * N + n0;
      double acc = 0.0;
      for (int t = lane; t < len; t += 32)
        acc += (double)widen(row[t]) * (double)sns[d * TILE + t];
      acc = warp_sum(acc);
      if (lane == 0) a.partial[(size_t)blockIdx.x * 2 * 3 * r + o] = acc;
    }
  }
}

// Contact tail, part 2, one cluster per sim (block d: dimension d):
// rb_const from the partials, the loop on the clamped predictor's selected
// columns, u; then unit coefficients over the anchors the lift below
// writes, with stale projections.  (It stages the loop's operands only:
// M_utac_d and U_selT_d are not read here.)
template <typename T, typename M>
__global__ void __cluster_dims__(3, 1, 1)
    __launch_bounds__(CLUSTER_THREADS, 2)
        contact_solve(Affine<T, M> a, Iter<T> op, int step,
                      int num_iterations, const int* lane_cols, int ms,
                      int plan) {
  cg::cluster_group cl = cg::this_cluster();
  const int d = (int)cl.block_rank();
  const int b = blockIdx.y;
  const int r = op.r, N = a.N;
  int* fl = a.flags + (size_t)b * a.flag_stride;
  if (!fl[F_STEP + step]) return;  // no block of this launch writes it
  Carve cv;
  const AffineLayout L = affine_layout(cv, r, op.g, op.m, a.n_sel, plan);
  const ClusterLoop<T> c = cluster_loop(op, L.loop, d, lane_cols, ms);
  const double* partial = a.partial + (size_t)b * a.nblk * 2 * 3 * r;
  const T* rbex = a.rbex + (size_t)b * a.rb_sim + (size_t)d * r;
  for (int k = threadIdx.x; k < r; k += blockDim.x) {
    double acc = 0.0;
    for (int t = 0; t < a.nblk; ++t)
      acc += partial[(size_t)t * 2 * 3 * r + d * r + k];
    c.rbc[k] = rbex[k] - (T)acc;
  }
  const T* sn = a.sn + (size_t)b * 3 * N + (size_t)d * N;
  for (int j = threadIdx.x; j < op.g; j += blockDim.x)
    c.vc[j] = gather_col(op, sn, j);
  cp_async_wait_all();
  cl.sync();
  iterate_cluster(c, num_iterations);
  T* u = a.u + (size_t)b * 3 * r + (size_t)d * r;
  solve_cluster(c, [&](int n, T acc) { u[n] = acc; });
  T* coef = a.coef + (size_t)b * (18 + 6 * r);
  affine_reset_row(coef + 3 * d, coef + 9 + 3 * d, coef + 18 + d * r,
                   coef + 18 + 3 * r + d * r, r);
  cl.sync();
  if (d == 1 && threadIdx.x == 0) fl[F_STALE] = 1;
}

// Contact tail, part 3, over the 3N entries of each sim whose step i
// clamped: q = sn + U u; the new anchors are b0 = q and b1 = (q - Pm)/dt.
template <typename T, typename M>
__global__ void contact_lift(Affine<T, M> all, int step) {
  const int N = all.N, r = all.r;
  T* us = reinterpret_cast<T*>(affine_smem);
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int base = blockIdx.y; base < all.nb; base += 32 * gridDim.y)
  for (unsigned m = open_sims(all, base, GATE_CLAMPED, step); m;
       m &= m - 1) {
    const Affine<T, M> a = all.at(sim_of(base, m));
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * r; i += blockDim.x)
      us[i] = Round<M, T>::apply(a.u[i]);
    __syncthreads();
    if (idx < (size_t)3 * N) {
      const int d = (int)(idx / N);
      const int v = (int)(idx - (size_t)d * N);
      const M* col = a.ulift + (size_t)d * r * N + v;
      const T* ud = us + d * r;
      T acc = T(0);
      for (int k = 0; k < r; ++k) acc += ud[k] * widen(col[(size_t)k * N]);
      const T q = a.sn[idx] + acc;
      a.b1[idx] = (q - a.Pm[idx]) / a.dt;
      a.b0[idx] = q;
    }
  }
}

// Contact mode, part 1, on 128-vertex tiles, for each sim in contact mode
// at step i (already, or entering now because its floor test clamped): on
// entry Py, Vy materialized from the coefficients (pallas_resident.py:
// 842-853); the y predictor sn_y = Py + dt eta Vy + fa_y clamped at the
// floor into the y row of sn; the per-tile float64 partials of
// pc = U_y^T A_c corr_y, corr_y = clamped - sn_y rounded to the storage
// type.
template <typename T, typename M>
__global__ void mode_predict(Affine<T, M> all, int step) {
  const int N = all.N, r = all.r;
  T* c = reinterpret_cast<T*>(affine_smem);  // y rows: ap, av (3 each)
  T* wy = c + 6;                              // round(wp_y), round(wv_y)
  T* cs = wy + 2 * r;                         // TILE: rounded corr_y
  const int n0 = blockIdx.x * TILE;
  const int len = min(TILE, N - n0);
  for (int base = blockIdx.y; base < all.nb; base += 32 * gridDim.y)
  for (unsigned m = open_sims(all, base, GATE_CONTACT, step); m;
       m &= m - 1) {
    const Affine<T, M> a = all.at(sim_of(base, m));
    const bool enter = a.flags[F_STEP + step] & S_CLAMPED;
    __syncthreads();
    if (enter) {
      for (int i = threadIdx.x; i < 6 + 2 * r; i += blockDim.x) {
        if (i < 6)
          c[i] = a.coef[9 * (i / 3) + 3 + i % 3];
        else {
          const int s = (i - 6) / r, k = i - 6 - s * r;
          wy[i - 6] = Round<M, T>::apply(a.coef[18 + 3 * r * s + r + k]);
        }
      }
      __syncthreads();
    }
    const bool damp = a.eta != T(1);
    for (int t = threadIdx.x; t < TILE; t += blockDim.x) {
      T corr = T(0);
      if (t < len) {
        const int v = n0 + t;
        T py, vy;
        if (enter) {
          const M* U = a.ulift + (size_t)r * N;
          const T b0 = a.b0[N + v], b1 = a.b1[N + v], fa = a.fa[N + v];
          py = affine_row(c, wy, b0, b1, fa, U, N, r, v);
          vy = affine_row(c + 3, wy + r, b0, b1, fa, U, N, r, v);
          a.ys[v] = py;
          a.ys[N + v] = vy;
        } else {
          py = a.ys[v];
          vy = a.ys[N + v];
        }
        const T vd = damp ? mul_rn(a.eta, vy) : vy;
        const T sn = add_rn(add_rn(py, mul_rn(a.dt, vd)), a.fa[N + v]);
        const T cl = sn < a.floor_h ? a.floor_h : sn;
        a.sn[N + v] = cl;
        corr = Round<M, T>::apply(cl - sn);
      }
      cs[t] = corr;
    }
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    for (int o = warp; o < r; o += nw) {
      const M* row = a.utac + (size_t)(r + o) * N + n0;
      double acc = 0.0;
      for (int t = lane; t < len; t += 32)
        acc += (double)widen(row[t]) * (double)cs[t];
      acc = warp_sum(acc);
      if (lane == 0) a.pcpart[(size_t)blockIdx.x * r + o] = acc;
    }
  }
}

// Contact mode, part 2, one cluster per sim in contact mode at step i
// (pallas_resident.py:762-819), block d dimension d: on entry the
// projections buPy, buVy of the y rows of P and V (:854-863); rb_const
// with its y row rb_ex_y - s, s = buPy + dt eta buVy + bu_fa_y + pc;
// snT_sel's x and z rows, Vc's y row from the clamped sn_y; the loop and
// its solve u; the coefficient update (its y row unused in contact mode);
// buPy' = s + u_y M_utac_y, buVy' = (buPy' - buPy)/dt; the step's slot and
// the mode set, and the step counted (COUNT_K3_CONTACT_STEPS).  The y block
// does the y-only work, the x and z blocks the affine rows.
template <typename T, typename M>
__global__ void __cluster_dims__(3, 1, 1)
    __launch_bounds__(CLUSTER_THREADS, 2)
        mode_solve(Affine<T, M> a, Iter<T> op, int step, int num_iterations,
                   const int* lane_cols, int ms, int plan,
                   unsigned long long* counts) {
  cg::cluster_group cl = cg::this_cluster();
  const int d = (int)cl.block_rank();  // 1: the y block
  const int b = blockIdx.y;
  const int r = op.r, n_sel = a.n_sel, N = a.N;
  const int tid = threadIdx.x, nt = blockDim.x;
  // the flags as they stand at the launch (written after the last cluster
  // barrier)
  int* fl = a.flags + (size_t)b * a.flag_stride;
  const bool stale = fl[F_STALE];  // only a sim entering at a rebase step
  const bool enter = fl[F_STEP + step] & S_CLAMPED;
  if (!fl[F_MODE] && !enter) return;
  Carve cv;
  const AffineLayout L = affine_layout(cv, r, op.g, op.m, n_sel, plan);
  const ClusterLoop<T> c = cluster_loop(op, L.loop, d, lane_cols, ms);
  const Operand<T> mutac =
      operand(L.mutac, a.mutac + (size_t)d * r * r, r, r);
  const Operand<T> usel =
      operand(L.usel, a.uselT + (size_t)d * r * n_sel, r, n_sel);
  const Rows<T> w = rows_of<T>(L);
  T* coef = a.coef + (size_t)b * (18 + 6 * r);
  T* bu0 = a.bu + (size_t)b * 9 * r + (size_t)d * r;
  const T* bu1 = bu0 + 3 * r;
  const T* bufa = bu0 + 6 * r;
  T* ybu = a.ybu + (size_t)b * 2 * r;  // buPy, buVy
  const T* rbex = a.rbex + (size_t)b * a.rb_sim + (size_t)d * r;
  coef_rows(coef, d, r, w.ap, w.av, w.wp, w.wv, false);
  if (stale)
    sum_partial_rows(a.partial + (size_t)b * a.nblk * 2 * 3 * r, a.nblk, r,
                     d, bu0, bu0 + 3 * r);
  cp_async_wait_all();
  cl.sync();
  affine_predictor_row(w.ap, w.av, w.wp, w.wv, r, a.dt, a.eta, w.asn, w.avd,
                       w.wsn);
  __syncthreads();
  if (d == 1) {
    if (enter) {
      // buPy (buVy) = the y rows of ap (av) over bu0, bu1, bu_fa
      // + wp_y (wv_y) M_utac_y
      affine_combine_row(w.ap, w.wp, bu0, bu1, bufa, mutac, r, r, ybu);
      affine_combine_row(w.av, w.wv, bu0, bu1, bufa, mutac, r, r, ybu + r);
      __syncthreads();
    }
    const double* pcpart = a.pcpart + (size_t)b * a.nblk * r;
    const bool damp = a.eta != T(1);
    for (int k = tid; k < r; k += nt) {
      double acc = 0.0;
      for (int t = 0; t < a.nblk; ++t) acc += pcpart[(size_t)t * r + k];
      const T bv = damp ? mul_rn(a.eta, ybu[r + k]) : ybu[r + k];
      const T bupsn = add_rn(add_rn(ybu[k], mul_rn(a.dt, bv)), bufa[k]);
      w.sy[k] = add_rn(bupsn, (T)acc);
      c.rbc[k] = rbex[k] - w.sy[k];
    }
    const T* sny = a.sn + (size_t)b * 3 * N + N;
    for (int j = tid; j < op.g; j += nt) c.vc[j] = gather_col(op, sny, j);
  } else {
    const size_t x = (size_t)b * 3 * N + (size_t)d * N;
    affine_rb_const_row(w.asn, w.wsn, bu0, bu1, bufa, mutac, rbex, r, c.rbc);
    affine_combine_row(w.asn, w.wsn, a.b0 + x, a.b1 + x, a.fa + x, usel, r,
                       n_sel, w.sel);
    __syncthreads();
    for (int j = tid; j < op.g; j += nt) c.vc[j] = gather_col(op, w.sel, j);
  }
  __syncthreads();
  iterate_cluster(c, num_iterations);
  solve_cluster(c, [&](int n, T acc) { w.u[n] = acc; });
  __syncthreads();
  if (d == 1) {
    T* uy = a.u + (size_t)b * 3 * r + r;  // for mode_lift
    gemv(w.u, mutac, r, r, [&](int n, T acc) {
      const T bup = w.sy[n] + acc;
      ybu[r + n] = (bup - ybu[n]) / a.dt;
      ybu[n] = bup;
      uy[n] = w.u[n];
    });
  }
  affine_update_row(w.ap, w.av, w.wp, w.wv, w.asn, w.avd, w.wsn, w.u, r,
                    a.dt);
  __syncthreads();
  coef_rows(coef, d, r, w.ap, w.av, w.wp, w.wv, true);
  cl.sync();
  if (d == 1 && tid == 0) {
    if (stale) fl[F_STALE] = 0;
    fl[F_MODE] = 1;
    fl[F_STEP + step] |= S_CONTACT;
    count_add(counts, COUNT_K3_CONTACT_STEPS, 1);
  }
}

// Contact mode, part 3, one vertex per thread, for each sim in contact
// mode: q_y = sn_y + U_y round(u_y); Vy = (q_y - Py)/dt, Py = q_y.
template <typename T, typename M>
__global__ void mode_lift(Affine<T, M> all, int step) {
  const int N = all.N, r = all.r;
  T* us = reinterpret_cast<T*>(affine_smem);
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  for (int base = blockIdx.y; base < all.nb; base += 32 * gridDim.y)
  for (unsigned m = open_sims(all, base, GATE_MODE, step); m; m &= m - 1) {
    const Affine<T, M> a = all.at(sim_of(base, m));
    __syncthreads();
    for (int i = threadIdx.x; i < r; i += blockDim.x)
      us[i] = Round<M, T>::apply(a.u[r + i]);
    __syncthreads();
    if (v < N) {
      const M* col = a.ulift + (size_t)r * N + v;
      T acc = T(0);
      for (int k = 0; k < r; ++k) acc += us[k] * widen(col[(size_t)k * N]);
      const T q = a.sn[N + v] + acc;
      a.ys[N + v] = (q - a.ys[v]) / a.dt;
      a.ys[v] = q;
    }
  }
}

// P and V materialized in place over the anchors (a rebase, or the
// output), for every sim; for a sim in contact mode the y row is Py, Vy
// (pallas_resident.py:739-742, :931-934).  With `skip_done` a sim is
// skipped once kernel 4 stopped.
template <typename T, typename M>
__global__ void materialize(Affine<T, M> all, int skip_done) {
  const int N = all.N, r = all.r;
  T* c = reinterpret_cast<T*>(affine_smem);  // ap, av, round(wp), round(wv)
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int gate = skip_done ? GATE_NOT_DONE : GATE_ALWAYS;
  for (int base = blockIdx.y; base < all.nb; base += 32 * gridDim.y)
  for (unsigned m = open_sims(all, base, gate, 0); m; m &= m - 1) {
    const Affine<T, M> a = all.at(sim_of(base, m));
    __syncthreads();
    for (int i = threadIdx.x; i < 18 + 6 * r; i += blockDim.x)
      c[i] = i < 18 ? a.coef[i] : Round<M, T>::apply(a.coef[i]);
    __syncthreads();
    const bool ymode = a.flags[F_MODE];
    if (idx < (size_t)3 * N) {
      const int d = (int)(idx / N);
      const int v = (int)(idx - (size_t)d * N);
      if (ymode && d == 1) {
        a.b0[idx] = a.ys[v];
        a.b1[idx] = a.ys[N + v];
      } else {
        const M* U = a.ulift + (size_t)d * r * N;
        const T b0 = a.b0[idx], b1 = a.b1[idx], fa = a.fa[idx];
        const T P = affine_row(c + 3 * d, c + 18 + d * r, b0, b1, fa, U, N,
                               r, v);
        const T V = affine_row(c + 9 + 3 * d, c + 18 + 3 * r + d * r, b0,
                               b1, fa, U, N, r, v);
        a.b0[idx] = P;
        a.b1[idx] = V;
      }
    }
  }
}

// After a rebase's materialization, one block per sim: unit coefficients,
// stale projections, contact mode left.
template <typename T, typename M>
__global__ void rebase_reset(Affine<T, M> all) {
  const Affine<T, M> a = all.at(blockIdx.x);
  if (a.flags[F_DONE]) return;
  affine_reset(a.ap(), a.av(), a.wp(), a.wv(), a.r);
  if (threadIdx.x == 0) {
    a.flags[F_STALE] = 1;
    a.flags[F_MODE] = 0;
  }
}

// Every launch of a call on stream s, each counted in `launched`
template <typename T, typename M, int SG>
cudaError_t enqueue_affine(Affine<T, M> a, const Iter<T>& op, int num_steps,
                           int num_iterations, int rebase_every, int mode,
                           int rb_rows, const int* lane_cols, int ms,
                           int plan, int smem, cudaStream_t s,
                           unsigned long long* counts, long long& launched) {
  const int N = a.N, r = a.r, nb = a.nb;
  const int ys = min(nb, SIM_Y);
  const dim3 grid_tiles(a.nblk, ys);
  const dim3 grid_entries((3 * N + THREADS - 1) / THREADS, ys);
  const dim3 grid_y((N + THREADS - 1) / THREADS, (nb + SG - 1) / SG);
  const dim3 grid_cluster(CLUSTER_SIZE, nb);  // one cluster a sim
  const size_t smem_pred = sizeof(T) * (18 + 6 * r + 3 * TILE);
  const size_t smem_mat = sizeof(T) * (18 + 6 * r);
  const size_t smem_y = sizeof(T) * SG * (18 + 3 * r);
  const size_t smem_mpred = sizeof(T) * (6 + 2 * r + TILE);
  const dim3 grid_verts((N + THREADS - 1) / THREADS, ys);
  // the wrapper's plan must size the cluster blocks as this carving does
  if ((size_t)smem != affine_smem_bytes(r, op.g, op.m, a.n_sel, plan) ||
      (size_t)smem > CLUSTER_SMEM_MAX)
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(free_step<T, M>, smem);
  if (e == cudaSuccess) e = allow_smem(contact_solve<T, M>, smem);
  if (e == cudaSuccess) e = allow_smem(mode_solve<T, M>, smem);
  if (e == cudaSuccess) e = allow_smem(contact_predict<T, M>, smem_pred);
  if (e == cudaSuccess) e = allow_smem(materialize<T, M>, smem_mat);
  if (e == cudaSuccess) e = allow_smem(y_check<T, M, SG>, smem_y);
  if (e == cudaSuccess) e = allow_smem(mode_predict<T, M>, smem_mpred);
  if (e != cudaSuccess) return e;
  project_partials<T, M><<<grid_tiles, THREADS, 0, s>>>(a, SRC_FA,
                                                        GATE_ALWAYS, 0);
  init_call<T, M><<<nb, THREADS, 0, s>>>(a);
  launched += 2;
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const bool floor_test = mode != LEAN_NO_FLOOR;
  const T* rb0 = a.rbex;
  for (int i = 0; i < num_steps; ++i) {
    // step i's row of the schedule (each launch copies the struct)
    a.rbex = rb0 + (size_t)min(i, rb_rows - 1) * 3 * r;
    if (i > 0 && i % rebase_every == 0) {
      materialize<T, M><<<grid_entries, THREADS, smem_mat, s>>>(a, 1);
      rebase_reset<T, M><<<nb, THREADS, 0, s>>>(a);
      launched += 2;
    }
    if (floor_test) {
      y_check<T, M, SG><<<grid_y, THREADS, smem_y, s>>>(a, i);
      launched += 1;
    }
    // contact mode needs the anchors' projections on its entry too
    project_partials<T, M><<<grid_tiles, THREADS, 0, s>>>(
        a, SRC_ANCHORS, mode == CONTACT ? GATE_STALE : GATE_REFRESH, i);
    free_step<T, M><<<grid_cluster, CLUSTER_THREADS, smem, s>>>(
        a, op, i, mode, num_iterations, lane_cols, ms, plan);
    launched += 2;
    if (mode == CONTACT) {
      mode_predict<T, M><<<grid_tiles, THREADS, smem_mpred, s>>>(a, i);
      mode_solve<T, M><<<grid_cluster, CLUSTER_THREADS, smem, s>>>(
          a, op, i, num_iterations, lane_cols, ms, plan, counts);
      mode_lift<T, M><<<grid_verts, THREADS, sizeof(T) * r, s>>>(a, i);
      launched += 3;
    }
    if (mode == LEAN) {
      contact_predict<T, M><<<grid_tiles, THREADS, smem_pred, s>>>(a, i);
      contact_solve<T, M><<<grid_cluster, CLUSTER_THREADS, smem, s>>>(
          a, op, i, num_iterations, lane_cols, ms, plan);
      contact_lift<T, M><<<grid_entries, THREADS, sizeof(T) * 3 * r, s>>>(
          a, i);
      launched += 3;
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  materialize<T, M><<<grid_entries, THREADS, smem_mat, s>>>(a, 0);
  launched += 1;
  return cudaGetLastError();
}

template <typename T, typename M>
int launch_affine(void* b0, void* b1, const void* fa, const void* rbex,
                  const void* ulift, const void* utac, const void* mutac,
                  const void* uselT, const void* C, const void* inv,
                  const void* WT, const void* gptr, const void* gcol,
                  const void* gw, const void* kind, const void* eg,
                  const void* ef, void* coef, void* bu,
                  void* sn, void* Pm, void* u, void* partial, void* ys,
                  void* ybu, void* pcpart, void* flags,
                  int N, int r, int n_sel, int g, int m, int num_steps,
                  int num_iterations, int rebase_every, int mode, int nb,
                  int flag_stride, double dt, double eta, double floor_h,
                  int rb_rows, long long rb_sim, const void* lane_cols,
                  int ms, int plan, int smem, void* stream, void* counts,
                  void* launched) {
  const Iter<T> op =
      make_iter<T>(C, inv, WT, gptr, gcol, gw, kind, eg, ef, r, g, m);
  Affine<T, M> a;
  a.b0 = static_cast<T*>(b0);
  a.b1 = static_cast<T*>(b1);
  a.fa = static_cast<const T*>(fa);
  a.rbex = static_cast<const T*>(rbex);
  a.ulift = static_cast<const M*>(ulift);
  a.utac = static_cast<const M*>(utac);
  a.mutac = static_cast<const T*>(mutac);
  a.uselT = static_cast<const T*>(uselT);
  a.coef = static_cast<T*>(coef);
  a.bu = static_cast<T*>(bu);
  a.sn = static_cast<T*>(sn);
  a.Pm = static_cast<T*>(Pm);
  a.u = static_cast<T*>(u);
  a.partial = static_cast<double*>(partial);
  a.ys = static_cast<T*>(ys);
  a.ybu = static_cast<T*>(ybu);
  a.pcpart = static_cast<double*>(pcpart);
  a.flags = static_cast<int*>(flags);
  a.rb_sim = rb_sim;
  a.N = N;
  a.r = r;
  a.n_sel = n_sel;
  a.nblk = (N + TILE - 1) / TILE;
  a.nb = nb;
  a.flag_stride = flag_stride;
  a.dt = (T)dt;
  a.eta = (T)eta;
  a.floor_h = (T)floor_h;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lanes = static_cast<const int*>(lane_cols);
  unsigned long long* cnt = static_cast<unsigned long long*>(counts);
  long long n = 0;
  const int e =
      nb == 1 ? enqueue_affine<T, M, 1>(a, op, num_steps, num_iterations,
                                       rebase_every, mode, rb_rows, lanes, ms,
                                       plan, smem, s, cnt, n)
              : enqueue_affine<T, M, Y_GROUP>(
                    a, op, num_steps, num_iterations, rebase_every, mode,
                    rb_rows, lanes, ms, plan, smem, s, cnt, n);
  if (launched) *static_cast<long long*>(launched) = n;
  return e;
}

// The largest number of clusters resident at once with smem bytes a block,
// over the three cluster launches in both storage types (-1: none)
inline int affine_clusters(int smem) {
  int n = max_clusters(free_step<float, float>, smem);
  const int more[] = {
      max_clusters(free_step<float, __nv_bfloat16>, smem),
      max_clusters(contact_solve<float, float>, smem),
      max_clusters(contact_solve<float, __nv_bfloat16>, smem),
      max_clusters(mode_solve<float, float>, smem),
      max_clusters(mode_solve<float, __nv_bfloat16>, smem)};
  for (int k : more) n = k < n ? k : n;
  return n;
}

}  // namespace ksm

// b0, b1, fa, sn, Pm: (nb, 3, N); coef (nb, 18 + 6r); bu (nb, 9r); u (nb, 3r);
// partial (nb, nblk, 2, 3r) float64; in mode CONTACT ys (nb, 2, N), ybu
// (nb, 2r) and pcpart (nb, nblk, r) float64 (unused, and may be null, in
// the other modes); flags (nb, flag_stride) int32; rbex: rb_rows rows of
// (3, r) per sim, sim b's at b * rb_sim (0: one schedule shared by the
// sims), step i reading row min(i, rb_rows - 1); nb = 1 is the solo call;
// lane_cols (ms,): the loop's projection order; plan: the staging plan's
// bits, smem its bytes a block of the cluster launches (ops/cluster.py);
// counts: the device counters' block (null: not counted); launched (host
// int64, or null): the kernels the call enqueued
#define AFFINE_ENTRY(NAME, T, M)                                             \
  extern "C" int NAME(                                                       \
      void* b0, void* b1, const void* fa, const void* rbex,                 \
      const void* ulift, const void* utac, const void* mutac,                \
      const void* uselT, const void* C, const void* inv, const void* WT,     \
      const void* gptr, const void* gcol, const void* gw, const void* kind,  \
      const void* eg, const void* ef,                                        \
      void* coef, void* bu, void* sn, void* Pm, void* u, void* partial,      \
      void* ys, void* ybu, void* pcpart, void* flags, int N, int r,          \
      int n_sel, int g, int m, int num_steps, int num_iterations,            \
      int rebase_every, int mode, int nb, int flag_stride, double dt,        \
      double eta, double floor_h, int rb_rows, long long rb_sim,             \
      const void* lane_cols, int ms, int plan, int smem, void* stream,       \
      void* counts, void* launched) {                                        \
    return ksm::launch_affine<T, M>(                                         \
        b0, b1, fa, rbex, ulift, utac, mutac, uselT, C, inv, WT, gptr, gcol, \
        gw, kind, eg, ef, coef, bu, sn, Pm, u, partial, ys, ybu, pcpart,     \
        flags, N, r, n_sel, g, m, num_steps, num_iterations, rebase_every,   \
        mode, nb, flag_stride, dt, eta, floor_h, rb_rows, rb_sim, lane_cols, \
        ms, plan, smem, stream, counts, launched);                           \
  }

AFFINE_ENTRY(resident_affine_f32_f32, float, float)
AFFINE_ENTRY(resident_affine_f32_bf16, float, __nv_bfloat16)

extern "C" int affine_tile() { return ksm::TILE; }

// clusters of the cluster launches resident at once with smem bytes a block
extern "C" int affine_max_clusters(int smem) {
  return ksm::affine_clusters(smem);
}
