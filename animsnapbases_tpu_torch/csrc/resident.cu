// Kernel 2: the standard resident multi-step loop.
//
// Replaces: animsnapbases_tpu/ops/pallas_resident.py
//   build_resident_multistep (:415-555, pallas_call :544).
// Each step i of num_steps on the permuted state P, V (3, N):
//   sn = P + dt*eta*V + fa            (fa = dt^2 fext / m, per call)
//   sn_y = max(sn_y, floor_h)         (floor on: y row only)
//   rb_const = rb_i - ut_acT . sn     (NT contraction over N)
//     rb_i the row min(i, T - 1) of the target-term schedule (the JAX
//     kernel's rb_seq, :482, :504-505): T rows of (3, r), sim b's at
//     rb_sim elements after sim b - 1's (0: one schedule for every sim)
//   the iteration loop on snT_sel = sn[:, :n_sel], u = rb inv3
//   q = sn + U_liftT^T u,  V = (q - P)/dt,  P = q
// As in the JAX kernel, sn and u are rounded to the storage type of the
// big matrices (bfloat16 or float32) before they meet them.  Products
// accumulate in the state type, except the NT contraction (float64, below).
//
// What bounds it on this card: per step it streams the two (3, r, N)
// matrices (2 x 3 x 64 x 14,400 x 2 B = 11.1 MB in bfloat16 at the bench
// scene, L2-resident on the 50 MB L2) and does ~11 MFLOP of matrix-vector
// work on them, spread over the SMs; the iteration loop in the middle is
// the same latency chain as kernel 1.  At the bench scene the latency of
// that chain, not bytes or FLOPs, sets the step time.  An animated
// schedule adds one (3, r) row per sim and step (768 B at r = 64).
//
// What the design does about it: three launches per step on the caller's
// stream, enqueued by one host loop in this file (no host read-back and no
// Python between steps; the loop hands launch (b) its step's schedule row):
//   (a) predict_project: a grid over 128-vertex tiles forms sn, writes it,
//       and writes one partial (3, r) of ut_acT . sn per tile (one warp
//       per output row, coalesced reads of ut_acT along N);
//   (b) resident_iterate: one cluster of three blocks per sim
//       (iteration_cluster.cuh), block d owning dimension d: it sums its
//       rows of the partials in a fixed order (deterministic, no atomics;
//       113 tiles at 14,400 vertices, 1,954 at 250,000), forms rb_const_d,
//       gathers Vc_d from the selected prefix of sn_d and runs the loop on
//       its staged operands (C_d, WT_d, inv3_d as the staging plan says:
//       ops/cluster.py, kernel "resident"), the rows of Vall pushed to the
//       peers with st.async.  Each output is one thread's chain in the
//       order of the one-block loop it ran before, so it equals it bit for
//       bit.  The contraction over N accumulates in float64, in (a) and
//       (b): its 14,400 terms cancel to ~4e-4 of their absolute sum (A_c
//       annihilates translations, and the state sits ~20 units up): with a
//       float32 sum in tile order one step of the bench scene came out
//       6.2x further from float64 in P than a float32 cuBLAS product.  The
//       float64 work is ~2.8 MFLOP a step; rb_const itself is rounded back
//       to the state type.  The plain version accumulates it the same way.
//   (c) lift_update: a grid over the 3N entries forms q and V.  Each
//       thread reads and then writes only its own entry of P and V, so the
//       update is in place.
// The predictor uses round-to-nearest intrinsics that the compiler does
// not contract into an FMA, so sn is bit-for-bit what the plain version
// (ops/resident.py) computes and the storage-type rounding of sn agrees.
//
// The batched build (nb sims, the JAX kernel's nb = B; the contact windows
// of make_batched_run's large-model route) keeps the states sim-major,
// (nb, 3, N), and runs the same three launches per step:
//   (a) on a grid of (tiles, sim groups): a block loads the sn tiles of up
//       to SIM_GROUP sims and reads each element of ut_acT once for all of
//       them, so the (3, r, N) matrix is read nb / SIM_GROUP times a step,
//       not nb times;
//   (b) on a grid of (3, nb) blocks, one cluster a sim, on the plan that
//       needs the fewest waves of clusters (ops/cluster.py launch_plan);
//   (c) on a grid of (entry blocks, sim groups): each U_liftT element is
//       read once for the group's sims.
// Each sim's sums run in the same order as in the solo launch (nb = 1,
// built with a group of one), so sim b of a batched call equals the solo
// call from sim b's state bit for bit.
#include <type_traits>

#include "iteration_cluster.cuh"
#include "storage.cuh"

namespace ksm {

constexpr int TILE = 128;
constexpr int THREADS = 256;
constexpr int SIM_GROUP = 8;  // sims per block of launches (a) and (c)

extern __shared__ __align__(16) unsigned char resident_smem[];

// (a) predictor, floor clamp and the per-tile partial of ut_acT . sn, for
// the sims b0 .. b0 + SG - 1 of blockIdx.y's group.  Sim b's partial of
// tile t lands at partial[(b * nblk + t) * 3r].
template <typename T, typename M, int SG>
__global__ void predict_project(const T* P, const T* V, const T* fa, T* sn,
                                double* partial, const M* utac, int N, int r,
                                int nb, T dtv, int floor_on, T floor_h) {
  __shared__ T sns[SG][3][TILE];
  const int n0 = blockIdx.x * TILE;
  const int len = min(TILE, N - n0);
  const int b0 = blockIdx.y * SG;
  const int ns = min(SG, nb - b0);
  for (int i = threadIdx.x; i < SG * 3 * TILE; i += blockDim.x) {
    const int s = i / (3 * TILE), rem = i - s * 3 * TILE;
    const int d = rem / TILE, t = rem - d * TILE;
    T x = T(0);
    if (s < ns && t < len) {
      const size_t idx = (size_t)(b0 + s) * 3 * N + (size_t)d * N + n0 + t;
      x = add_rn(add_rn(P[idx], mul_rn(dtv, V[idx])), fa[idx]);
      if (floor_on && d == 1 && x < floor_h) x = floor_h;
      sn[idx] = x;
      x = Round<M, T>::apply(x);
    }
    sns[s][d][t] = x;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int nblk = gridDim.x;
  for (int o = warp; o < 3 * r; o += nw) {
    const int d = o / r;
    const M* row = utac + (size_t)o * N + n0;  // (d, k) row of (3, r, N)
    double acc[SG];
#pragma unroll
    for (int s = 0; s < SG; ++s) acc[s] = 0.0;
    for (int t = lane; t < len; t += 32) {
      const double w = (double)widen(row[t]);
#pragma unroll
      for (int s = 0; s < SG; ++s) acc[s] += w * (double)sns[s][d][t];
    }
#pragma unroll
    for (int s = 0; s < SG; ++s) {
      const double v = warp_sum(acc[s]);
      if (lane == 0 && s < ns)
        partial[((size_t)(b0 + s) * nblk + blockIdx.x) * 3 * r + o] = v;
    }
  }
}

// (b) reduction of the partials and the iteration loop, one cluster per
// sim, block d dimension d
template <typename T>
__global__ void __cluster_dims__(3, 1, 1)
    __launch_bounds__(CLUSTER_THREADS, 2)
        resident_iterate(Iter<T> op, const T* sn, int N,
                         const double* partial, int nblk, const T* rb_extra,
                         long long rb_sim, T* u, int num_iterations,
                         const int* lane_cols, int ms, int plan) {
  const int r = op.r;
  const int d = (int)cg::this_cluster().block_rank();  // the dimension
  const int b = blockIdx.y;                            // the sim
  Carve cv;
  const LoopLayout L = loop_layout(cv, r, op.g, op.m, plan);
  const ClusterLoop<T> c = cluster_loop(op, L, d, lane_cols, ms);
  // row d of this step's row of sim b's schedule, of its partials, its sn
  rb_extra += (size_t)b * rb_sim + (size_t)d * r;
  partial += (size_t)b * nblk * 3 * r + (size_t)d * r;
  sn += (size_t)b * 3 * N + (size_t)d * N;
  for (int k = threadIdx.x; k < r; k += blockDim.x) {
    double s = 0.0;
    for (int t = 0; t < nblk; ++t) s += partial[(size_t)t * 3 * r + k];
    c.rbc[k] = rb_extra[k] - (T)s;
  }
  for (int j = threadIdx.x; j < op.g; j += blockDim.x)
    c.vc[j] = gather_col(op, sn, j);
  cp_async_wait_all();
  // the staged operands are in, and every block of the cluster has started
  cg::this_cluster().sync();
  iterate_cluster(c, num_iterations);
  u += ((size_t)b * 3 + d) * r;
  solve_cluster(c, [&](int k, T acc) { u[k] = acc; });
  // no block leaves while a peer may still read its shared memory
  cg::this_cluster().sync();
}

// (c) lift q = sn + U u and the velocity update, in place, for the sims of
// blockIdx.y's group: each U_liftT element is read once for all of them
template <typename T, typename M, int SG>
__global__ void lift_update(T* P, T* V, const T* sn, const T* u,
                            const M* ulift, int N, int r, int nb, T dt) {
  T* us = reinterpret_cast<T*>(resident_smem);  // SG x 3r
  const int b0 = blockIdx.y * SG;
  const int ns = min(SG, nb - b0);
  for (int i = threadIdx.x; i < SG * 3 * r; i += blockDim.x)
    us[i] = i < ns * 3 * r ? Round<M, T>::apply(u[(size_t)b0 * 3 * r + i])
                           : T(0);
  __syncthreads();
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)3 * N) return;
  const int d = (int)(idx / N);
  const int n = (int)(idx - (size_t)d * N);
  const M* col = ulift + (size_t)d * r * N + n;
  T acc[SG];
#pragma unroll
  for (int s = 0; s < SG; ++s) acc[s] = T(0);
  for (int k = 0; k < r; ++k) {
    const T c = widen(col[(size_t)k * N]);
#pragma unroll
    for (int s = 0; s < SG; ++s) acc[s] += us[s * 3 * r + d * r + k] * c;
  }
#pragma unroll
  for (int s = 0; s < SG; ++s) {
    if (s < ns) {
      const size_t x = (size_t)(b0 + s) * 3 * N + idx;
      const T q = sn[x] + acc[s];
      V[x] = (q - P[x]) / dt;
      P[x] = q;
    }
  }
}

// The step's three launches for sim groups of SG (SG = 1: the solo call),
// each counted in `launched`.
template <typename T, typename M, int SG>
cudaError_t enqueue_steps(const Iter<T>& op, T* P, T* V, const T* fa,
                          const T* rb_extra, const M* ulift, const M* utac,
                          T* sn, double* part, T* u, int N, int r, int nb,
                          int num_steps, int num_iterations, T dt, T dtv,
                          int floor_on, T floor_h, int rb_rows,
                          long long rb_sim, const int* lane_cols, int ms,
                          int plan, int smem, cudaStream_t s,
                          long long& launched) {
  const int nblk = (N + TILE - 1) / TILE;
  const int groups = (nb + SG - 1) / SG;
  const dim3 grid_a(nblk, groups);
  const dim3 grid_c((3 * N + THREADS - 1) / THREADS, groups);
  const size_t smem_lift = sizeof(T) * SG * 3 * r;
  // the wrapper's plan must size the cluster blocks as this carving does
  if ((size_t)smem != loop_smem_bytes(r, op.g, op.m, plan) ||
      (size_t)smem > CLUSTER_SMEM_MAX)
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(resident_iterate<T>, smem);
  if (e == cudaSuccess) e = allow_smem(lift_update<T, M, SG>, smem_lift);
  if (e != cudaSuccess) return e;
  for (int step = 0; step < num_steps; ++step) {
    predict_project<T, M, SG><<<grid_a, THREADS, 0, s>>>(
        P, V, fa, sn, part, utac, N, r, nb, dtv, floor_on, floor_h);
    resident_iterate<T><<<dim3(CLUSTER_SIZE, nb), CLUSTER_THREADS, smem, s>>>(
        op, sn, N, part, nblk,
        rb_extra + (size_t)min(step, rb_rows - 1) * 3 * r, rb_sim, u,
        num_iterations, lane_cols, ms, plan);
    lift_update<T, M, SG><<<grid_c, THREADS, smem_lift, s>>>(
        P, V, sn, u, ulift, N, r, nb, dt);
    launched += 3;
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <typename T, typename M>
int launch_resident(void* P, void* V, const void* fa, const void* rb_extra,
                    const void* ulift, const void* utac, const void* C,
                    const void* inv, const void* WT, const void* gptr,
                    const void* gcol, const void* gw, const void* kind,
                    const void* eg, const void* ef, void* sn,
                    void* partial, void* u, int N, int r, int g,
                    int m, int num_steps, int num_iterations, int nb,
                    double dt, double dtv, int floor_on, double floor_h,
                    int rb_rows, long long rb_sim, const void* lane_cols,
                    int ms, int plan, int smem, void* stream,
                    void* launched) {
  const Iter<T> op =
      make_iter<T>(C, inv, WT, gptr, gcol, gw, kind, eg, ef, r, g, m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long n = 0;
  auto run = [&](auto group) {
    constexpr int SG = decltype(group)::value;
    return enqueue_steps<T, M, SG>(
        op, static_cast<T*>(P), static_cast<T*>(V),
        static_cast<const T*>(fa), static_cast<const T*>(rb_extra),
        static_cast<const M*>(ulift), static_cast<const M*>(utac),
        static_cast<T*>(sn), static_cast<double*>(partial),
        static_cast<T*>(u), N, r, nb, num_steps, num_iterations, (T)dt,
        (T)dtv, floor_on, (T)floor_h, rb_rows, rb_sim,
        static_cast<const int*>(lane_cols), ms, plan, smem, s, n);
  };
  const int e = nb == 1 ? run(std::integral_constant<int, 1>{})
                        : run(std::integral_constant<int, SIM_GROUP>{});
  if (launched) *static_cast<long long*>(launched) = n;
  return e;
}

}  // namespace ksm

// P, V, fa, sn: (nb, 3, N); partial (nb, nblk, 3, r) float64; u (nb, 3, r);
// rb_extra: rb_rows rows of (3, r) per sim, sim b's at b * rb_sim (0: one
// schedule shared by the sims); nb = 1 is the solo call; lane_cols (ms,):
// the loop's projection order; plan: the staging plan's bits, smem its
// bytes a block of (b) (ops/cluster.py); launched (host int64, or null):
// the kernels the call enqueued
#define RESIDENT_ENTRY(NAME, T, M)                                           \
  extern "C" int NAME(void* P, void* V, const void* fa,                      \
                      const void* rb_extra, const void* ulift,               \
                      const void* utac, const void* C, const void* inv,      \
                      const void* WT, const void* gptr,                      \
                      const void* gcol, const void* gw, const void* kind,    \
                      const void* eg, const void* ef, void* sn,              \
                      void* partial, void* u, int N, int r, int g, int m,    \
                      int num_steps, int num_iterations, int nb, double dt,  \
                      double dtv, int floor_on, double floor_h, int rb_rows, \
                      long long rb_sim, const void* lane_cols, int ms,       \
                      int plan, int smem, void* stream, void* launched) {    \
    return ksm::launch_resident<T, M>(                                       \
        P, V, fa, rb_extra, ulift, utac, C, inv, WT, gptr, gcol, gw, kind,   \
        eg, ef, sn, partial, u, N, r, g, m, num_steps, num_iterations, nb,   \
        dt, dtv, floor_on, floor_h, rb_rows, rb_sim, lane_cols, ms, plan,    \
        smem, stream, launched);                                             \
  }

RESIDENT_ENTRY(resident_multistep_f32_f32, float, float)
RESIDENT_ENTRY(resident_multistep_f32_bf16, float, __nv_bfloat16)

extern "C" int resident_tile() { return ksm::TILE; }

// clusters of (b) resident at once with smem bytes a block
extern "C" int resident_max_clusters(int smem) {
  return ksm::max_clusters(ksm::resident_iterate<float>, smem);
}
