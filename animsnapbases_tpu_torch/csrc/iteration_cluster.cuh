// The hyper-reduced local-global iteration loop on a cluster of three
// thread blocks, block d owning dimension d: the one loop of the port,
// which kernels 1 (fused_reduced.cu), 2 (resident.cu), 3 and 4 (affine.cu)
// and 5 (affine_chunked.cuh) run.
//
// It computes the body of animsnapbases_tpu/ops/pallas_resident.py
// `_make_iteration_loop` with iteration.cuh's emitters and gather: from
// rb (3, r), Vall = Vc + rb C_allT, one projection row per column of the
// element table, rb = rb_const + pT WT_all; at the end u = rb inv3.  Every
// step of it but the projections is separable by dimension, so block d of
// the cluster holds dimension d's operands and rows:
//
//   phase A   Vall_d = Vc_d + rb_d C_d             (C_d (r, g) of C_allT)
//   exchange  every block gets all three rows of Vall
//   project   all m rows, keeping pT_d
//   phase C   rb_d = rbc_d + pT_d WT_d             (WT_d (m, r))
//   solve     u_d = rb_d inv3_d
//
// The exchange runs through distributed shared memory (DSMEM): each block
// writes its row into its peers' buffers with st.async, whose bytes the
// peer's transaction barrier (mbarrier) counts, and waits at its own
// barrier for the two rows it receives: one-way latency, no cluster-wide
// round trip.  Vall is double buffered by iteration parity: a peer may
// write iteration i + 1's row while a slower block still projects
// iteration i's.  On the H100 this exchange took ~230 SM cycles against
// ~1,100 for the same writes followed by a cluster barrier (cluster.sync()
// compiles to a GPU-scope fence and an L1 invalidate); pulling the peers'
// rows after the barrier, or splitting the projections over the blocks
// with a second barrier, were slower still (PERF.md, slice 8).
//
// What bounds it on this card: latency.  Per block an iteration at the
// bench widths (r = 64, g = 200, m = 80) is 12,800 + 5,120 FMAs, ~70 KB
// read from shared memory (~550 cycles of the SM's 128 B/clk), 80
// projections and one exchange.  What the design does about it: the
// operands a block reads every iteration (C_d, WT_d) and then inv3_d live
// in its shared memory when the staging plan says so (ops/cluster.py
// `staging_plan`, computed on the host: bits STAGE_*), copied in once per
// launch with cp.async; what does not fit is read from L2.  Each output of
// a product is one thread's chain over its row index, in the order of the
// one-block loop (one block a sim, all three dimensions) that every kernel
// ran before, so the plan never changes a result and the kernels equal
// that loop bit for bit.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "iteration.cuh"

namespace ksm {

namespace cg = cooperative_groups;

constexpr int CLUSTER_THREADS = 256;
constexpr int CLUSTER_SIZE = 3;  // the kernels' __cluster_dims__(3, 1, 1)
constexpr size_t CLUSTER_SMEM_MAX = 232448;  // 227 KB a block can use

// The staging plan's bits (ops/cluster.py STAGE_BITS)
enum : int {
  STAGE_C = 1,      // C_d (r, g)
  STAGE_WT = 2,     // WT_d (m, r)
  STAGE_INV = 4,    // inv3_d (r, r)
  STAGE_MUTAC = 8,  // kernels 3-5: M_utac_d (r, r)
  STAGE_MAP = 16    // kernel 5: UG_d (r, g); kernels 3, 4 and kernel 5
                    // without fold_vc: U_selT_d (r, n_sel)
};

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// The dynamic shared memory of a cluster kernel.  Every buffer of the loop
// is an offset into it, so that the compiler sees shared-memory pointers
// (LDS, STS) where the functions below are inlined into the kernel.
extern __shared__ __align__(16) unsigned char cluster_smem[];
template <typename T>
__device__ __forceinline__ T* smem_at(int off) {
  return reinterpret_cast<T*>(cluster_smem) + off;
}

// Bump allocation of the dynamic shared memory, in elements of 4 bytes;
// every piece starts 16-byte aligned.  The host runs the same carving to
// size the launch.
struct Carve {
  int at = 0;
  __host__ __device__ int take(int n) {
    const int o = at;
    at += pad4(n);
    return o;
  }
  __host__ __device__ int take_if(bool on, int n) { return on ? take(n) : -1; }
};

// Offsets of the loop's buffers and staged operands (-1: read from L2)
struct LoopLayout {
  int rbc, rb, vc, vall, pt, misc;  // misc: 16 words (flags, reductions)
  int C, WT, inv;
};

__host__ __device__ inline LoopLayout loop_layout(Carve& cv, int r, int g,
                                                  int m, int plan) {
  LoopLayout L;
  const int rp = pad4(r), gp = pad4(g);
  L.rbc = cv.take(rp);
  L.rb = cv.take(rp);
  L.vc = cv.take(gp);
  L.vall = cv.take(6 * gp);  // two buffers of three rows
  L.pt = cv.take(m);
  L.misc = cv.take(16);
  L.C = cv.take_if(plan & STAGE_C, r * gp);
  L.WT = cv.take_if(plan & STAGE_WT, m * rp);
  L.inv = cv.take_if(plan & STAGE_INV, r * rp);
  return L;
}

// shared memory of a block (bytes) of a kernel whose block holds the loop's
// buffers alone (kernels 1 and 2), for the staging plan's bits
inline size_t loop_smem_bytes(int r, int g, int m, int plan) {
  Carve cv;
  loop_layout(cv, r, g, m, plan);
  return 4 * (size_t)cv.at;
}

// ---------------------------------------------------------------------------
// staging
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows x cols of src (contiguous) into dst (rows, pad4(cols)), the pad
// columns zero; asynchronous until cp_async_wait_all()
template <typename T>
__device__ void stage_rows(T* dst, const T* src, int rows, int cols) {
  static_assert(sizeof(T) == 4, "staging copies 4-byte elements");
  const int tid = threadIdx.x, nt = blockDim.x, ld = pad4(cols);
  if (cols == ld && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = rows * cols / 4;
    for (int i = tid; i < n4; i += nt) cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = tid; i < rows * ld; i += nt) {
      const int row = i / ld, c = i - row * ld;
      if (c < cols)
        cp_async4(dst + i, src + (size_t)row * cols + c);
      else
        dst[i] = T(0);
    }
  }
}

// An operand of one dimension: staged in shared memory at offset `off`
// (row stride padded to 4) or, off < 0, read in place from device memory
template <typename T>
struct Operand {
  const T* p;  // in device memory
  int off, ld;
};

template <typename T>
__device__ __forceinline__ Operand<T> operand(int off, const T* src,
                                              int rows, int cols) {
  if (off < 0) return Operand<T>{src, -1, cols};
  stage_rows(smem_at<T>(off), src, rows, cols);
  return Operand<T>{src, off, pad4(cols)};
}

// ---------------------------------------------------------------------------
// distributed shared memory and transaction barriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// the address of the same shared-memory word in block `rank` of the cluster
__device__ __forceinline__ unsigned peer_addr(unsigned a, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(a), "r"(rank));
  return out;
}
// a 4-byte store into a peer's shared memory that counts its bytes on the
// peer's transaction barrier `bar`
__device__ __forceinline__ void st_async(unsigned addr, unsigned v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(v), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// this thread's arrival; tx_bytes > 0: and the bytes the phase awaits
__device__ __forceinline__ void mbar_arrive(unsigned bar, int tx_bytes) {
  if (tx_bytes > 0)
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(tx_bytes)
        : "memory");
  else
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                 : "memory");
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// until the phase of parity `parity` has completed; a phase still open
// after 10 s (a lost row: a step's longest wait, the y block's exact
// check, takes milliseconds) fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(unsigned bar, int parity) {
  unsigned long long t0 = 0;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = global_ns();
    else if (global_ns() - t0 > 10000000000ull)
      __trap();
  }
}

// ---------------------------------------------------------------------------
// the products
// ---------------------------------------------------------------------------

// epi(n, sum_k x[k] A[k, n]) for n < N, A (K, N) at row stride lda: one
// thread a column, its sum a chain of fused multiply-adds over k = 0, 1,
// ..., K - 1 from 0, the order of the one-block loop this replaces, so the
// results equal its bit for bit.  x
// is read four entries at a time (16 bytes, x 16-byte aligned) and the
// loop unrolled to 16 rows, so that a row's loads are in flight while the
// chain runs; the warp's 32 columns are consecutive words of a row.
// Called by all threads of the block.
template <typename T, typename Epi>
__device__ __forceinline__ void gemv_rows(const T* x, const T* A, int lda,
                                          int K, int N, Epi epi) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const T* a = A + n;
    T acc = T(0);
    int k = 0;
#pragma unroll 4
    for (; k + 4 <= K; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(x + k);
      acc += v.x * a[(size_t)k * lda];
      acc += v.y * a[(size_t)(k + 1) * lda];
      acc += v.z * a[(size_t)(k + 2) * lda];
      acc += v.w * a[(size_t)(k + 3) * lda];
    }
    for (; k < K; ++k) acc += x[k] * a[(size_t)k * lda];
    epi(n, acc);
  }
}

// ... with A staged (the compiler then reads it from shared memory) or in
// device memory
template <typename T, typename Epi>
__device__ __forceinline__ void gemv(const T* x, const Operand<T>& A, int K,
                                     int N, Epi epi) {
  if (A.off >= 0)
    gemv_rows(x, smem_at<const T>(A.off), A.ld, K, N, epi);
  else
    gemv_rows(x, A.p, A.ld, K, N, epi);
}

// ---------------------------------------------------------------------------
// the loop
// ---------------------------------------------------------------------------

// Built with -DKSM_LOOP_CLOCKS (tools/loop_phases.py), thread 0 of each
// block of the first sim adds the SM cycles of each phase of each
// iteration to loop_clocks[block][phase]: 0 phase A, 1 the exchange, 2 its
// own projections, 3 the block's last ones, 4 phase C, 5 its barrier.
#ifdef KSM_LOOP_CLOCKS
__device__ unsigned long long loop_clocks[CLUSTER_SIZE][8];
#define LOOP_CLOCK(i)                                               \
  do {                                                              \
    if (blockIdx.y == 0 && threadIdx.x == 0) {                      \
      const unsigned long long t_ = clock64();                      \
      atomicAdd(&loop_clocks[d][i], t_ - t_clock);                  \
      t_clock = t_;                                                 \
    }                                                               \
  } while (0)
#else
#define LOOP_CLOCK(i) \
  do {                \
  } while (0)
#endif

// One block's view of the loop: its dimension, the element table and
// gather (op, with g the padded row stride of Vall), its buffers and its
// operands, and its peers' buffers in the cluster
template <typename T>
struct ClusterLoop {
  Iter<T> op;          // op.g: the padded row length of Vall
  int d, r, g, m;
  const int* lane_cols;  // (ms,) the projection order: column of thread t
  int ms;
  T *rbc, *rb, *vc, *vall, *pt;
  Operand<T> C, WT, inv;
  // the two transaction barriers (one per Vall buffer) and, as
  // shared::cluster addresses, the peers' Vall buffers and barriers
  unsigned bar, peer_vall_a[CLUSTER_SIZE], peer_bar_a[CLUSTER_SIZE];
};

// The loop of one cluster block: carve its buffers, stage C_d, WT_d and
// inv3_d as `plan` says (the caller waits for the copies).  lane_cols
// (ops/fused_reduced.py warp_runs): the element table's columns in runs of
// one kind that start at a multiple of 32 threads (-1: idle), so that no
// warp runs two kinds' emitters one after the other.
template <typename T>
__device__ __forceinline__ ClusterLoop<T> cluster_loop(const Iter<T>& op,
                                                       const LoopLayout& L,
                                                       int d,
                                                       const int* lane_cols,
                                                       int ms) {
  T* smem = smem_at<T>(0);
  ClusterLoop<T> c;
  const int r = op.r, g = op.g, m = op.m;
  c.op = op;
  c.op.g = pad4(g);
  c.lane_cols = lane_cols;
  c.ms = ms;
  c.d = d;
  c.r = r;
  c.g = g;
  c.m = m;
  c.rbc = smem + L.rbc;
  c.rb = smem + L.rb;
  c.vc = smem + L.vc;
  c.vall = smem + L.vall;
  c.pt = smem + L.pt;
  c.C = operand(L.C, op.C + (size_t)d * r * g, r, g);
  c.WT = operand(L.WT, op.WT + (size_t)d * m * r, m, r);
  c.inv = operand(L.inv, op.inv + (size_t)d * r * r, r, r);
  c.bar = smem_addr(smem + L.misc + 8);
  for (int e = 0; e < CLUSTER_SIZE; ++e) {
    c.peer_vall_a[e] = peer_addr(smem_addr(c.vall), e);
    c.peer_bar_a[e] = peer_addr(c.bar, e);
  }
  // every thread arrives at a phase (thread 0 with the bytes it awaits);
  // the caller's cluster barrier makes the barriers visible to the peers
  if (threadIdx.x == 0) {
    mbar_init(c.bar, blockDim.x);
    mbar_init(c.bar + 8, blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return c;
}

template <typename T>
__device__ __forceinline__ T pick(const T o[3], int d) {
  return d == 0 ? o[0] : d == 1 ? o[1] : o[2];
}

// num_iterations of the loop from rbc_d and vc_d; on exit rb_d holds the
// last rhs.  Every block of the cluster calls it.  When `stop` is given,
// the blocks read it after their first exchange (a peer wrote it as
// flag_bytes more bytes of the first phase) and return true, all
// together, when it is set; with no iterations they meet at one cluster
// barrier for it (a peer wrote it with a plain store before).  Each block
// awaits the peers' rows at its own transaction barrier: iteration G (G0 +
// it, counted over the launch) at barrier G % 2, phase parity (G / 2) % 2.
// A peer writes iteration G + 2's row into a buffer only after it has
// this block's row of G + 1, which this block sends after projecting
// iteration G.
template <typename T>
__device__ __forceinline__ bool iterate_cluster(const ClusterLoop<T>& c,
                                                int num_iterations,
                                                const int* stop = nullptr,
                                                int G0 = 0,
                                                int flag_bytes = 0) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int d = c.d, r = c.r, g = c.g, m = c.m, gp = c.op.g;
  for (int i = tid; i < r; i += nt) c.rb[i] = T(0);
  const int j0 = tid < c.ms ? c.lane_cols[tid] : -1;  // this thread's column
  if (num_iterations == 0) {
    cg::this_cluster().sync();
    return stop != nullptr && *stop != 0;
  }
  __syncthreads();
#ifdef KSM_LOOP_CLOCKS
  unsigned long long t_clock = clock64();
#endif
  for (int it = 0; it < num_iterations; ++it) {
    const int G = G0 + it, b = G & 1;
    const int buf = b * 3 * gp;
    T* vall = c.vall + buf;
    // phase A: this block's row of Vall, into its peers' buffers too
    gemv(c.rb, c.C, r, g, [&](int n, T acc) {
      const T v = c.vc[n] + acc;
      vall[d * gp + n] = v;
      const unsigned at = 4u * (buf + d * gp + n);
#pragma unroll
      for (int e = 0; e < CLUSTER_SIZE; ++e)
        if (e != d)
          st_async(c.peer_vall_a[e] + at, __float_as_uint(v),
                   c.peer_bar_a[e] + 8 * b);
    });
    LOOP_CLOCK(0);
    const int bytes = (CLUSTER_SIZE - 1) * g * 4 + (it == 0 ? flag_bytes : 0);
    mbar_arrive(c.bar + 8 * b, tid == 0 ? bytes : 0);
    mbar_wait(c.bar + 8 * b, (G >> 1) & 1);
    LOOP_CLOCK(1);
    if (it == 0 && stop != nullptr && *stop != 0) return true;
    for (int t = tid; t < c.ms; t += nt) {
      const int j = t == tid ? j0 : c.lane_cols[t];
      if (j < 0) continue;
      T o[3];
      project_element(c.op, vall, j, o);
      c.pt[j] = pick(o, d);
    }
    LOOP_CLOCK(2);
    __syncthreads();
    LOOP_CLOCK(3);
    // phase C
    gemv(c.pt, c.WT, m, r, [&](int n, T acc) { c.rb[n] = c.rbc[n] + acc; });
    LOOP_CLOCK(4);
    __syncthreads();
    LOOP_CLOCK(5);
  }
  return false;
}

// u_d = rb_d inv3_d (inv3 symmetric: row form), through epi(k, u_k)
template <typename T, typename Epi>
__device__ __forceinline__ void solve_cluster(const ClusterLoop<T>& c, Epi epi) {
  gemv(c.rb, c.inv, c.r, c.r, epi);
}

// The largest number of clusters of `kernel` resident at once with
// `smem` bytes a block (cudaOccupancyMaxActiveClusters); -1 when the card
// cannot place even one or refuses the query.
template <typename K>
__host__ inline int max_clusters(K kernel, size_t smem) {
  if (allow_smem(kernel, smem) != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER_SIZE, 1, 1);
  cfg.blockDim = dim3(CLUSTER_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return n;
}

}  // namespace ksm

#ifdef KSM_LOOP_CLOCKS
// loop_clocks into out (3 x 8), then zero
extern "C" int loop_clocks_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, ksm::loop_clocks,
                                       sizeof(ksm::loop_clocks));
  if (e != cudaSuccess) return e;
  static const unsigned long long zero[ksm::CLUSTER_SIZE * 8] = {};
  return cudaMemcpyToSymbol(ksm::loop_clocks, zero, sizeof(zero));
}
#endif
