// Kernel 1: one step's fused hyper-reduced local-global iteration loop.
//
// Replaces: animsnapbases_tpu/ops/pallas_reduced.py
//   build_fused_reduced_iterations (:393-489, pallas_call :481).
// Computes u (3, r) from snT_sel (3, n_sel) and rb_const (3, r):
//   Vc = snT_sel G_allT (hoisted), then num_iterations of
//   Vall = Vc + rb C_allT; pT = projection rows; rb = rb_const + pT WT_all,
//   and finally u = rb inv3.
//
// What bounds it on this card: neither bytes (~0.3 MB of operands) nor
// operations (~0.1 MFLOP per iteration).  It is a serial chain of small
// dependent contractions (rb -> Vall -> pT -> rb) with a nonlinear step
// in the middle, so it is bound by latency.
//
// What the design does about it: the loop runs on one cluster of three
// thread blocks per sim (iteration_cluster.cuh), block d owning dimension
// d: the operands of its dimension (C_d 51 KB, WT_d 20 KB, inv3_d 16 KB in
// float32 at the bench widths) are staged in its shared memory once per
// call, as the staging plan (ops/cluster.py) says, so no iteration reads
// L2, and the three rows of Vall meet through distributed shared memory at
// one transaction barrier a block per iteration.  Block d gathers its own
// Vc_d by the sparse columns of G_allT (iteration.cuh gather_col: one entry
// for the one-hot tris, spring and tet columns, the weighted star of a
// bending column, summed in float64) before the loop; C_allT and inv3 are taken as
// the host precomposed them in float64 (usel_inv is never folded into WT).
//
// The batched build (the JAX kernel under `vmap`; make_batched_step) runs
// one cluster per sim on a grid of (3, nb) blocks: cluster b reads sim b's
// snT_sel and rb_const at its sim stride and writes its u.  Each cluster
// does exactly what the solo launch (nb = 1) does, in the same order, so
// sim b of a batched call equals the solo call from sim b's inputs bit for
// bit.
#include "iteration_cluster.cuh"

namespace ksm {

template <typename T>
__global__ void __cluster_dims__(3, 1, 1)
    __launch_bounds__(CLUSTER_THREADS, 1)
        fused_cluster_kernel(Iter<T> op, const T* snT, int ld_sn,
                             long long sim_sn, const T* rb_const, T* u,
                             int num_iterations, const int* lane_cols, int ms,
                             int plan) {
  const int r = op.r, g = op.g, m = op.m;
  const int d = (int)cg::this_cluster().block_rank();  // the dimension
  const int b = blockIdx.y;                            // the sim
  Carve cv;
  const LoopLayout L = loop_layout(cv, r, g, m, plan);
  const ClusterLoop<T> c = cluster_loop(op, L, d, lane_cols, ms);
  snT += b * sim_sn + (size_t)d * ld_sn;
  rb_const += ((size_t)b * 3 + d) * r;
  u += ((size_t)b * 3 + d) * r;
  for (int i = threadIdx.x; i < r; i += blockDim.x) c.rbc[i] = rb_const[i];
  for (int i = threadIdx.x; i < g; i += blockDim.x)
    c.vc[i] = gather_col(op, snT, i);
  cp_async_wait_all();
  // the staged operands are in, and every block of the cluster has started
  // (its shared memory may be written)
  cg::this_cluster().sync();
  iterate_cluster(c, num_iterations);
  solve_cluster(c, [&](int k, T acc) { u[k] = acc; });
  // no block leaves while a peer may still read its shared memory
  cg::this_cluster().sync();
}

template <typename T>
int launch_fused(const void* snT, int ld_sn, long long sim_sn,
                 const void* rb_const, const void* C, const void* inv,
                 const void* WT, const void* gptr, const void* gcol,
                 const void* gw, const void* kind, const void* eg,
                 const void* ef, void* u, int r, int g, int m,
                 int num_iterations, int nb, const void* lane_cols, int ms,
                 int plan, int smem, void* stream) {
  const Iter<T> op =
      make_iter<T>(C, inv, WT, gptr, gcol, gw, kind, eg, ef, r, g, m);
  // the wrapper's plan must size the blocks as this carving does
  if ((size_t)smem != loop_smem_bytes(r, g, m, plan) ||
      (size_t)smem > CLUSTER_SMEM_MAX)
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fused_cluster_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  fused_cluster_kernel<T><<<dim3(CLUSTER_SIZE, nb), CLUSTER_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      op, static_cast<const T*>(snT), ld_sn, sim_sn,
      static_cast<const T*>(rb_const), static_cast<T*>(u), num_iterations,
      static_cast<const int*>(lane_cols), ms, plan);
  return cudaGetLastError();
}

}  // namespace ksm

// nb sims: snT_sel of sim b at snT + b * sim_sn (rows ld_sn apart),
// rb_const and u (nb, 3, r) contiguous; nb = 1 is the solo launch.
// lane_cols (ms,): the projection order; plan: the staging plan's bits,
// smem its bytes a block (ops/cluster.py).
#define FUSED_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const void* snT, int ld_sn, long long sim_sn,          \
                      const void* rb_const, const void* C, const void* inv,  \
                      const void* WT, const void* gptr,                      \
                      const void* gcol, const void* gw, const void* kind,    \
                      const void* eg, const void* ef, void* u, int r, int g, \
                      int m, int num_iterations, int nb,                     \
                      const void* lane_cols, int ms, int plan, int smem,     \
                      void* stream) {                                        \
    return ksm::launch_fused<T>(snT, ld_sn, sim_sn, rb_const, C, inv, WT,    \
                                gptr, gcol, gw, kind, eg, ef, u, r, g, m,  \
                                num_iterations, nb, lane_cols, ms, plan,     \
                                smem, stream);                               \
  }

FUSED_ENTRY(fused_reduced_iterations_f32, float)

// clusters resident at once with smem bytes a block
extern "C" int fused_reduced_max_clusters(int smem) {
  return ksm::max_clusters(ksm::fused_cluster_kernel<float>, smem);
}
