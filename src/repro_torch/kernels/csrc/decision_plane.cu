// Hand-written Hopper kernels for HEFT placement: the fused cost matrix,
// the upward ranks and the insertion-based candidate-EFT sweep, in
// float64, built by nvcc into a plain-C shared library and bound with
// ctypes (see kernels/_build.py).
//
// Build flags: -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false.
// Both kernels are held bitwise against host float64 references:
// fused_cost against predict_blr_np -> store.compute.scale ->
// store.compute.cost_matrix, and eft_sweep (through the schedule it yields)
// against sched.heft.heft_schedule_matrix.  Each C entry point launches on
// the caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "predictive.cuh"

namespace {

// ---------------------------------------------------------------------------
// fused_cost
// ---------------------------------------------------------------------------
// Replaces the TPU kernel repro/kernels/decision_plane.py::fused_cost
// (_cost_kernel): the posterior predictive of each task row, then the
// factor scaling with the mean floor, then the quantile shift, giving the
// (T, N) HEFT cost matrix W = max(mean, 1e-3) * fc [+ z * (std * fc)],
// fc = base[i, j] * corr[j].
//
// Bound on the H100: bytes in the body (the static factors read and W
// written, 16 bytes a cell, for a few float64 operations), and the launch
// at the main path's 1000 x 100, where the body is about half a
// microsecond and a launch several.  So the design works on what a launch
// costs its caller and on one short dependent chain inside it:
//   * One packed slab in (kernels.decision_plane.pack_cost): the T task
//     rows in the predictive's column groups (predictive.cuh), then the N
//     node corrections, one copy up.  The static factor matrix `base`
//     stays resident on the card between refits (TenantBinding.
//     device_base_factors), so no (T, N) matrix is built on the host or
//     copied up in a warm round; its cell times the node's correction is
//     the factor, one IEEE multiply as on the host.
//   * The predictive once a row.  A block takes kCostRows rows; that many
//     lanes read their rows from the groups (coalesced) and leave the
//     floored mean and the std in shared memory, while every lane has
//     already issued the loads of its first cells of `base` and their
//     corrections, so the two round trips to memory overlap.  One
//     __syncthreads follows.
//   * Then a streaming pass: each lane writes two cells at a time as a
//     double2, reading `base` through the read-only path without
//     allocating in L1 and storing W with streaming stores.  kCostRows is
//     even, so a tile's first cell is even and every pair is on 16 bytes
//     for any N; a pair may straddle two rows.  A ragged last tile, an odd
//     cell count (one single cell at the end) and N = 1 are handled here.
//   * Index arithmetic in 32 bits inside a tile (the wrapper takes fewer
//     than 2^31 cells), one 32-bit divide a pair, no 64-bit divide.
// The mean floor is numpy.maximum's: NaN propagates and -0.0 becomes 1e-3
// (CUDA's fmax would drop a NaN, so it is not used).  Built with
// --fmad=false, W is bitwise the host's.
constexpr int kCostRows = 8;       // task rows a block (even)
constexpr int kCostThreads = 256;
constexpr int kCostEarly = 2;      // pairs a lane loads before the barrier

__device__ __forceinline__ double2 ld_stream2(const double* p) {
  double2 v;
  asm("ld.global.nc.L1::no_allocate.v2.f64 {%0, %1}, [%2];"
      : "=d"(v.x), "=d"(v.y)
      : "l"(p));
  return v;
}

__device__ __forceinline__ double ld_stream(const double* p) {
  double v;
  asm("ld.global.nc.L1::no_allocate.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}

// One pair of a tile: its cells' factors' operands as loaded, and where
// they go.  The second cell is absent at the end of an odd tile.
struct CostPair {
  double2 b;        // base at the two cells
  double2 c;        // their nodes' corrections
  int r0, r1;       // their rows in the tile
  bool two;
};

__device__ __forceinline__ CostPair cost_load(const double* __restrict__ tb,
                                              const double* __restrict__ corr,
                                              int pr, int cells, int n) {
  CostPair q;
  const int c = 2 * pr;
  q.r0 = c / n;
  const int j0 = c - q.r0 * n;
  int j1 = j0 + 1;
  q.r1 = q.r0;
  if (j1 == n) {
    j1 = 0;
    q.r1 += 1;
  }
  q.two = c + 1 < cells;
  if (q.two) {
    q.b = ld_stream2(tb + c);
    q.c = make_double2(__ldg(corr + j0), __ldg(corr + j1));
  } else {
    q.b = make_double2(ld_stream(tb + c), 0.0);
    q.c = make_double2(__ldg(corr + j0), 0.0);
  }
  return q;
}

__device__ __forceinline__ double cost_cell(double m, double s, double b,
                                            double c, double z, int has_z) {
  const double fc = b * c;
  double w = m * fc;
  if (has_z) w = w + z * (s * fc);
  return w;
}

__device__ __forceinline__ void cost_store(double* __restrict__ tw,
                                           const CostPair& q, int pr,
                                           const double* m, const double* s,
                                           double z, int has_z) {
  const double w0 = cost_cell(m[q.r0], s[q.r0], q.b.x, q.c.x, z, has_z);
  if (q.two) {
    const double w1 = cost_cell(m[q.r1], s[q.r1], q.b.y, q.c.y, z, has_z);
    __stcs(reinterpret_cast<double2*>(tw + 2 * pr), make_double2(w0, w1));
  } else {
    __stcs(tw + 2 * pr, w0);
  }
}

__global__ void __launch_bounds__(kCostThreads)
fused_cost_kernel(const double* __restrict__ slab,
                  const double* __restrict__ base, double* __restrict__ w,
                  int t, int n, long long p, double z, int has_z) {
  __shared__ double s_mean[kCostRows];
  __shared__ double s_std[kCostRows];
  const int i0 = blockIdx.x * kCostRows;
  const int rows = min(kCostRows, t - i0);
  const int cells = rows * n;
  const int pairs = (cells + 1) >> 1;
  const size_t off = static_cast<size_t>(i0) * n;   // even: 16-byte aligned
  const double* tb = base + off;
  double* tw = w + off;
  const double* corr = slab + kQuerySlots * p;

  CostPair early[kCostEarly];
#pragma unroll
  for (int k = 0; k < kCostEarly; ++k) {
    const int pr = threadIdx.x + k * kCostThreads;
    if (pr < pairs) early[k] = cost_load(tb, corr, pr, cells, n);
  }
  if (threadIdx.x < rows) {
    double mean, std;
    lotaru_slab_predictive(slab, p, i0 + threadIdx.x, &mean, &std);
    s_mean[threadIdx.x] = (mean < 1e-3) ? 1e-3 : mean;
    s_std[threadIdx.x] = std;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kCostEarly; ++k) {
    const int pr = threadIdx.x + k * kCostThreads;
    if (pr < pairs) cost_store(tw, early[k], pr, s_mean, s_std, z, has_z);
  }
#pragma unroll 4
  for (int pr = threadIdx.x + kCostEarly * kCostThreads; pr < pairs;
       pr += kCostThreads)
    cost_store(tw, cost_load(tb, corr, pr, cells, n), pr, s_mean, s_std, z,
               has_z);
}

// ---------------------------------------------------------------------------
// eft_sweep
// ---------------------------------------------------------------------------
// Replaces the TPU kernel repro/kernels/decision_plane.py::eft_sweep_pallas
// (_sweep_kernel; the jitted form is _sweep): one workflow's whole HEFT
// insertion sweep in one launch.  Tasks go in rank order (order[t], -1 for
// a masked row); for each, every node computes its ready time from the
// dependency rows, searches its busy intervals for the earliest gap that
// fits the task, and the node with the earliest finish wins (ties to the
// lowest node index, as np.argmin).  The winner's interval is inserted in
// (begin, end) order.  The TPU kernel kept the interval stacks, the finish
// times and a (T+1, N) row of communication times per placed task in VMEM
// and ran the serial task loop inside one grid step.
//
// Bound on the H100: latency.  The T tasks are a serial chain (each
// placement changes the intervals the next one searches), and the bytes
// (W, ready times and dependency rows, read once) take microseconds.  A
// step costs its chain of dependent instructions (shared loads, shuffles,
// float64 compares and divides, L2 hits: tens to hundreds of cycles each),
// and a warp issues in order, so a warp alone on a scheduler waits out
// each of them; the step ends when the last warp reaches its barrier.
// Design: one thread block, the serial loop over tasks inside it (one
// launch instead of T), and each link of a step's chain short:
//
//  * P lanes a node (4 up to 128 nodes, 2 up to 256, 1 up to 512).  The
//    lanes of a node split its gap search into P runs of columns and its
//    dependency terms into P shares, and combine them with xor shuffles;
//    the extra warps fill each scheduler's waits.
//  * State on chip.  The interval stacks, laid out (S, N) so that a warp's
//    gap search reads consecutive doubles, the rank order, each step's
//    dependency terms (compacted once, as the order is fixed, without the
//    row placed the step before, which a flag marks), a three-slot ring of
//    each node's W and ready0 cells for the task two steps ahead
//    (cp.async) and, where they fit, the (N, N) link rates and locality
//    live in dynamic shared memory; each node's live interval count lives
//    in a register of its lanes.  A node's live count bounds
//    its gap search and insert: columns at or past it are (inf, inf) pads,
//    which change neither, so the result is that of the full S-column
//    search.
//  * Arrival times instead of communication rows.  When a task is placed,
//    every lane of every node computes the time its output reaches the
//    node, fin + (same ? 0 : gb8 / gbps) (the reference's fin[d] +
//    comm[d, j]: the same IEEE operations on the same operands), and stores
//    it in the node's column of a (T + 1) x N device row; each lane then
//    reads only its own stores, so no barrier or fence guards the rows.  A
//    step issues the loads of the next task's dependency terms when it
//    starts and folds them into that task's ready time when it ends.  The
//    task placed in the current step is not stored yet: the next step takes
//    its arrival time from the register that computed it.
//  * One barrier a step, and an argmin in integers.  np.argmin's order on
//    (eft, node) is the order of an unsigned key (NaN first, -0.0 as +0.0)
//    and the node index; three __reduce_min_sync give a warp's minimum.
//    Each warp writes its minimum to a slot double-buffered on t & 1; after
//    the step's one __syncthreads every warp reduces the slots itself and
//    finds the same winner.
//  * Insert on chip.  The winner's own warp inserts: its lanes cover the S
//    columns, a ballot counts the searchsorted position, the lanes shift
//    the tail one column up, and a __syncwarp precedes the next gap search.
//
// Shapes whose stacks and rows do not fit in the block's opt-in shared
// memory, or with more than 512 nodes, take the global route: the same
// step with one barrier, the integer argmin, the warp insert and the
// arrival rows, but with a lane a node, the stacks and counts in device
// scratch, the inputs read where they lie, and a thread looping over its
// nodes.  The wrapper picks the route from the shapes and the device's
// limit (decision_plane.sweep_route); the shared entry refuses a shape it
// cannot hold.  Only max, add, divide and compare are used, so both routes
// are bitwise the host sweep.
//
// eft_sweep_many (replacing the jitted TPU function eft_sweep_many, a vmap
// of the sweep over B workflows padded to one shape) is the shared route's
// kernel launched with B blocks: block b runs the step loop above on lane
// b's operands, read from a lane table of pointers, so no operand is
// stacked or padded but the rank order.  The lanes' steps are independent,
// so B <= 132 lanes take about one lane's time at one block an SM (1000 x
// 100, S = 48, D = 10: 131,392 bytes of shared memory a block).
//
// Built with -DLOTARU_SWEEP_CLOCKS (sweep_clocks.py), the shared route adds
// up clock64() cycles per phase of a step for each warp; otherwise
// SWEEP_MARK is nothing.
constexpr int kSweepMaxThreads = 1024;   // the global route's block
constexpr int kOnChipMaxNodes = 512;     // the shared route's block
constexpr int kCellSlots = 3;            // W, ready0 ring: this step, +1, +2
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;
constexpr int kHand = 1 << 30;           // a step's task depends on the last

#ifdef LOTARU_SWEEP_CLOCKS
constexpr int kClockPhases = 7;
__device__ long long g_sweep_clocks[32 * kClockPhases + 1];
#define SWEEP_MARK(p)                      \
  {                                        \
    const long long now_ = clock64();      \
    clocks[p] += now_ - clock_last;        \
    clock_last = now_;                     \
  }
#else
#define SWEEP_MARK(p)
#endif

// numpy.maximum: NaN propagates
__device__ __forceinline__ double np_max(double a, double b) {
  return (a > b || isnan(a)) ? a : b;
}

// an 8-byte global -> shared copy, complete after cp_async_wait_all
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// np.argmin's order on values as an unsigned key: NaN first (0), then the
// values in order, -0.0 equal to +0.0; ties then go to the lower node
__device__ __forceinline__ unsigned long long argmin_key(double v) {
  const long long b = __double_as_longlong(v == 0.0 ? 0.0 : v);
  const unsigned long long k = b < 0 ? ~static_cast<unsigned long long>(b)
                                     : static_cast<unsigned long long>(b) |
                                           (1ull << 63);
  return isnan(v) ? 0ull : k;
}

// the lexicographic minimum of (key, node) over the warp, in every lane
__device__ __forceinline__ void warp_min(unsigned long long& key,
                                         unsigned& node) {
  const unsigned hi = static_cast<unsigned>(key >> 32);
  const unsigned lo = static_cast<unsigned>(key);
  const unsigned mh = __reduce_min_sync(kFull, hi);
  const unsigned ml = __reduce_min_sync(kFull, hi == mh ? lo : ~0u);
  node = __reduce_min_sync(kFull, hi == mh && lo == ml ? node : ~0u);
  key = (static_cast<unsigned long long>(mh) << 32) | ml;
}

// the step's winner from the nw warp slots, in every lane of the calling
// warp; the winner's (eft, est) come from the slot of the warp of its
// first lane (thread node * P, or node % nt where a thread loops)
__device__ __forceinline__ int block_winner(const unsigned long long* sk,
                                            const unsigned* sj,
                                            const double* sv,
                                            const double* se, int nw,
                                            int nt, int P, int lane,
                                            double& v, double& est) {
  unsigned long long key = lane < nw ? sk[lane] : kNoKey;
  unsigned node = lane < nw ? sj[lane] : ~0u;
  warp_min(key, node);
  int owner = static_cast<int>(node) * P;
  if (owner >= nt) owner %= nt;
  v = sv[owner >> 5];
  est = se[owner >> 5];
  return static_cast<int>(node);
}

// earliest candidate start over stack columns [k0, k1) (column stride N)
// of a task of duration dur, ready at `ready` (not NaN): the earliest
// max(ready, end of the previous interval) whose [start, start + dur)
// ends by the column's begin; inf if none
__device__ __forceinline__ double gap_run(const double* b0,
                                          const double* b1, int N, int k0,
                                          int k1, double ready,
                                          double dur) {
  double e = INFINITY;
  double prev = k0 > 0 ? b1[(long long)(k0 - 1) * N] : -INFINITY;
  const double rd = ready + dur;
#pragma unroll 1
  for (int k = k0; k < k1; ++k) {
    // cand = np_max(ready, prev), and cand + dur as the sum of whichever
    // it is, both sums formed before the choice
    const double begin = b0[(long long)k * N];
    const bool from_prev = !(ready > prev);
    const double cand = from_prev ? prev : ready;
    const bool fits = from_prev ? prev + dur <= begin : rd <= begin;
    if (fits && cand < e) e = cand;
    prev = b1[(long long)k * N];
  }
  return e;
}

// the first of two candidates unless the second is smaller: the running
// minimum's rule, so combining runs in column order keeps the earliest of
// equal values
__device__ __forceinline__ double first_min(double a, double b) {
  return b < a ? b : a;
}

// earliest start of a task on a node whose stack holds `live` intervals,
// the columns [0, live] split into P runs, one a lane, combined in column
// order over the node's P lanes.  A NaN ready time makes every candidate
// NaN, and nothing fits.
__device__ __forceinline__ double gap_search(const double* b0,
                                             const double* b1, int N,
                                             int live, double ready,
                                             double dur, int P, int sub,
                                             int lane, bool own) {
  double e = INFINITY;
  if (own && !isnan(ready)) {
    const int run = (live + P) / P;
    const int k0 = min(sub * run, live + 1);
    e = gap_run(b0, b1, N, k0, min(k0 + run, live + 1), ready, dur);
  }
  for (int off = 1; off < P; off <<= 1) {
    const double other = __shfl_xor_sync(kFull, e, off);
    e = (lane & off) ? first_min(other, e) : first_min(e, other);
  }
  return e;
}

// numpy.maximum over the P lanes of a node (aligned groups of P lanes)
__device__ __forceinline__ double lanes_max(double x, int P) {
  for (int off = 1; off < P; off <<= 1)
    x = np_max(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// insert (ei, fi) into node js's stack of c intervals (c may exceed S: the
// last column then drops), by the whole warp: a ballot counts the
// searchsorted position in (begin, end) order, and each lane moves its
// columns up one, from the top chunk down so no lane reads a column
// another has written
__device__ __forceinline__ void warp_insert(double* b0, double* b1, int N,
                                            int S, int c, double ei,
                                            double fi, int lane) {
  const int live = min(c, S);
  int pos = 0;
#pragma unroll 1
  for (int k0 = 0; k0 < live; k0 += 32) {
    const int k = k0 + lane;
    bool lt = false;
    if (k < live) {
      const double a = b0[(long long)k * N];
      const double b = b1[(long long)k * N];
      lt = a < ei || (a == ei && b < fi);
    }
    pos += __popc(__ballot_sync(kFull, lt));
  }
  const int top = min(c, S - 1);
#pragma unroll 1
  for (int k0 = top & ~31; k0 >= 0 && k0 + 31 >= pos; k0 -= 32) {
    const int k = k0 + lane;
    const bool mv = k > pos && k <= top;
    double a = 0.0, b = 0.0;
    if (mv) {
      a = b0[(long long)(k - 1) * N];
      b = b1[(long long)(k - 1) * N];
    }
    __syncwarp();
    if (mv) {
      b0[(long long)k * N] = a;
      b1[(long long)k * N] = b;
    } else if (k == pos && pos < S) {
      b0[(long long)k * N] = ei;
      b1[(long long)k * N] = fi;
    }
  }
  __syncwarp();
}

// bytes of dynamic shared memory the shared route needs: 8-byte words for
// the stacks, the W and ready0 ring, the slots' eft, est and key; 4-byte
// words for the order, each step's count and compacted dependency terms,
// and the slots' node
__host__ __device__ inline long long sweep_smem_bytes(long long T,
                                                      long long N,
                                                      long long S,
                                                      long long D) {
  return 8 * (2 * S * N + 2 * kCellSlots * N + 3 * 64) +
         4 * (2 * T + T * D + 64);
}

// bytes the (N, N) link rates and locality add, staged where they fit
__host__ __device__ inline long long sweep_comm_bytes(long long N) {
  return 9 * N * N;
}

// lanes a node on the shared route
__host__ __device__ inline int sweep_lanes(int N) {
  return N <= 128 ? 4 : N <= 256 ? 2 : 1;
}

// One workflow's operands on the shared route, as the lane table holds
// them (six 8-byte words a lane): W and ready0 (T_b, N), the dependency
// rows (T_b, D_b), the output sizes (T_b) and the available times (N).
// A lane's steps read only the rows its order names (row 0 for a masked
// step), so T_b may be less than the launch's T.
struct SweepLane {
  const double* W;
  const double* ready0;
  const int* dep;
  const double* gb8;
  const double* avail;
  long long D;
};
static_assert(sizeof(SweepLane) == 48, "the lane table's row");

// Block b sweeps lane b: lanes[b], or lane0 when lanes is NULL (one
// workflow, the lane passed by value).  The order is (B, T); the outputs
// and the arrival rows are stacked a lane each: arr (B, T + 1, N), counts
// (B, N), assign, est and eft (B, T + 1), row T of each lane its dump row
// for masked steps.  D is the widest lane's dependency count: the stride
// of the compacted terms in shared memory.
__global__ void __launch_bounds__(kOnChipMaxNodes)
eft_sweep_onchip_kernel(const SweepLane* __restrict__ lanes,
                        const SweepLane lane0,
                        const int* __restrict__ order, int D,
                        const unsigned char* __restrict__ same,
                        const double* __restrict__ gbps, int T, int N,
                        int S, int P, int stage_comm, double* arr,
                        int* cnt_out, int* assign, double* est_out,
                        double* eft_out) {
  const SweepLane lane_ops = lanes ? lanes[blockIdx.x] : lane0;
  const double* __restrict__ W = lane_ops.W;
  const double* __restrict__ ready0 = lane_ops.ready0;
  const int* __restrict__ dep = lane_ops.dep;
  const double* __restrict__ gb8 = lane_ops.gb8;
  const double* __restrict__ avail = lane_ops.avail;
  const int Dl = static_cast<int>(lane_ops.D);
  {
    const long long b = blockIdx.x;
    order += b * T;
    arr += b * (T + 1) * N;
    cnt_out += b * N;
    assign += b * (T + 1);
    est_out += b * (T + 1);
    eft_out += b * (T + 1);
  }
  extern __shared__ unsigned long long smem[];
  double* b0 = reinterpret_cast<double*>(smem);
  double* b1 = b0 + (long long)S * N;
  double* cells = b1 + (long long)S * N;   // [slot][dur, r0][N]
  double* sv = cells + 2 * kCellSlots * N;
  double* se = sv + 64;
  unsigned long long* sk = reinterpret_cast<unsigned long long*>(se + 64);
  int* ord = reinterpret_cast<int*>(sk + 64);
  int* nd = ord + T;          // each step's terms, | kHand if it hands over
  int* dp = nd + T;           // each step's terms, clamped to T
  unsigned* sj = reinterpret_cast<unsigned*>(dp + (long long)T * D);
  double* s_gbps = reinterpret_cast<double*>(smem) +
                   sweep_smem_bytes(T, N, S, D) / 8;
  unsigned char* s_same = reinterpret_cast<unsigned char*>(s_gbps + N * N);

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const double inf = INFINITY;
  const int sub = tid % P;           // this lane's share of its node
  const bool own = tid / P < N;
  const int j = own ? tid / P : 0;   // lanes past the nodes shadow node 0
  const bool lead = own && sub == 0; // the lane that writes for the node

  // Each step's dependency terms, fixed by the order alone: the terms of
  // its task's row (row 0 for a masked step, as the reference) but the row
  // placed in the step before (T for a masked one), whose arrival time the
  // step takes from registers (kHand marks that it is a term).  A
  // dependency index past T reads the dump row T (the reference clamps);
  // -1 marks no dependency.
  for (int t = tid; t < T; t += nt) {
    ord[t] = order[t];
    const long long r = order[t] >= 0 ? order[t] : 0;
    const int skip = t == 0 ? -2 : order[t - 1] >= 0 ? order[t - 1] : T;
    int c = 0, hand = 0;
    for (int k = 0; k < Dl; ++k) {
      const int d = min(dep[r * Dl + k], T);
      if (d == skip)
        hand = kHand;
      else if (d >= 0)
        dp[(long long)t * D + c++] = d;
    }
    nd[t] = c | hand;
  }
  if (stage_comm) {
    for (int k = tid; k < N * N; k += nt) {
      s_gbps[k] = gbps[k];
      s_same[k] = same[k];
    }
  }
  // node_available seeds a [0, avail) busy prefix; the rest are pads.
  // Rows never placed arrive at 0.0 (a zero finish time and no transfer).
  const bool has = own && avail[j] > 0.0;
  int my_cnt = has ? 1 : 0;
  if (lead) {
    b0[j] = has ? 0.0 : inf;
    b1[j] = has ? avail[j] : inf;
    for (int k = 1; k < S; ++k) {
      b0[(long long)k * N + j] = inf;
      b1[(long long)k * N + j] = inf;
    }
  }
  if (own)
    for (int k = 0; k <= T; ++k) arr[(long long)k * N + j] = 0.0;
  const double* rate_of = stage_comm ? s_gbps : gbps;
  const unsigned char* same_of = stage_comm ? s_same : same;
  __syncthreads();

  auto row = [&](int t) { return ord[t] >= 0 ? ord[t] : 0; };
  auto copy_cells = [&](int t) {   // task t's W and ready0 cells
    if (lead && t < T) {
      double* c = cells + (t % kCellSlots) * 2 * N;
      const long long at = (long long)row(t) * N + j;
      cp_async8(c + j, W + at);
      cp_async8(c + N + j, ready0 + at);
    }
  };
  auto cell = [&](int t, int which) {
    return cells[(t % kCellSlots) * 2 * N + which * N + j];
  };
  // this lane's share of step t's dependency terms: the arrival times at
  // node j of terms sub and sub + P, loaded into registers (-inf where
  // none)
  auto dep_load = [&](int t, double& x0, double& x1) {
    const int* terms = dp + (long long)t * D;
    const int n = nd[t] & ~kHand;
    x0 = own && sub < n ? arr[(long long)terms[sub] * N + j] : -inf;
    x1 = own && sub + P < n ? arr[(long long)terms[sub + P] * N + j] : -inf;
  };
  // ready0 folded with step t's terms: each lane's share (the two loaded,
  // then any past them loaded now), then the node's P lanes together
  auto dep_fold = [&](int t, double ready, double x0, double x1) {
    const int* terms = dp + (long long)t * D;
    const int n = nd[t] & ~kHand;
    double m = np_max(x0, x1);
#pragma unroll 1
    for (int k = sub + 2 * P; k < n; k += P)
      if (own) m = np_max(m, arr[(long long)terms[k] * N + j]);
    return np_max(ready, lanes_max(m, P));
  };

  double part = 0.0;        // the step's ready time, less the hand-over
  double arr_prev = 0.0;    // the last placed row's arrival at node j
  copy_cells(0);
  copy_cells(1);
  cp_async_wait_all();
  __syncthreads();
  if (T > 0) {
    double x0, x1;
    dep_load(0, x0, x1);
    part = dep_fold(0, cell(0, 1), x0, x1);
  }

#ifdef LOTARU_SWEEP_CLOCKS
  long long clocks[kClockPhases] = {};
  long long clock_last = clock64();
  const long long clock_start = clock_last;
#endif
  for (int t = 0; t < T; ++t) {
    const int o = ord[t];
    const bool valid = o >= 0;
    const int i = valid ? o : 0;
    const int iw = valid ? o : T;   // row T: the masked rows' dump
    const double dur = cell(t, 0);
    const double out8 = __ldg(gb8 + i);
    double ready = part;
    if (nd[t] & kHand) ready = np_max(ready, arr_prev);
    // in flight across the step: the next step's dependency terms and step
    // t + 2's cells
    const bool more = t + 1 < T;
    double x0 = -inf, x1 = -inf;
    if (more) dep_load(t + 1, x0, x1);
    copy_cells(t + 2);
    SWEEP_MARK(0)   // ready time, the next task's loads and copies issued

    const double e = gap_search(b0 + j, b1 + j, N, min(my_cnt, S - 1),
                                ready, dur, P, sub, lane, own);
    SWEEP_MARK(1)   // gap search
    const double eft = e + dur;
    unsigned long long key = own ? argmin_key(eft) : kNoKey;
    unsigned node = own ? static_cast<unsigned>(j) : ~0u;
    warp_min(key, node);
    const int buf = (t & 1) * 32;
    if (lead && node == static_cast<unsigned>(j)) {
      sk[buf + warp] = key;
      sj[buf + warp] = node;
      sv[buf + warp] = eft;
      se[buf + warp] = e;
    }
    SWEEP_MARK(2)   // the warp's argmin and its slot
    __syncthreads();
    SWEEP_MARK(3)   // the barrier
    double v, est;
    const int js = block_winner(sk + buf, sj + buf, sv + buf, se + buf, nw,
                                nt, P, lane, v, est);
    SWEEP_MARK(4)   // the block's argmin
    // this node's transfer time from the winner, overlapping the insert
    const long long aj = (long long)js * N + j;
    const bool local = same_of[aj];
    const double comm = local ? 0.0 : out8 / rate_of[aj];
    if (warp == (js * P) >> 5) {   // the winning node's warp
      const int c = __shfl_sync(kFull, my_cnt, (js * P) & 31);
      // masked rows insert (inf, inf): a no-op on the pad columns
      warp_insert(b0 + js, b1 + js, N, S, c, valid ? est : inf,
                  valid ? v : inf, lane);
      if (own && j == js) my_cnt = c + 1;
      if (lead && j == js) {
        assign[iw] = js;
        est_out[iw] = est;
        eft_out[iw] = v;
      }
    }
    SWEEP_MARK(5)   // transfer time and the winner warp's insert
    // every lane of the node stores the row, so each reads its own stores
    arr_prev = v + comm;
    if (own) arr[(long long)iw * N + j] = arr_prev;
    cp_async_wait_all();
    if (more) part = dep_fold(t + 1, cell(t + 1, 1), x0, x1);
    SWEEP_MARK(6)   // arrival time stored, the next task's ready folded
  }
#ifdef LOTARU_SWEEP_CLOCKS
  if (lane == 0)
    for (int p = 0; p < kClockPhases; ++p)
      g_sweep_clocks[warp * kClockPhases + p] = clocks[p];
  if (tid == 0) g_sweep_clocks[32 * kClockPhases] = clock64() - clock_start;
#endif

  // final interval count per node (begins below +inf)
  if (lead) {
    const int live = min(my_cnt, S);
    int c = 0;
    for (int k = 0; k < live; ++k) c += b0[(long long)k * N + j] < inf;
    cnt_out[j] = c;
  }
}

__global__ void __launch_bounds__(kSweepMaxThreads)
eft_sweep_global_kernel(const double* __restrict__ W,
                        const int* __restrict__ order,
                        const int* __restrict__ dep, int D,
                        const double* __restrict__ gb8,
                        const double* __restrict__ ready0,
                        const double* __restrict__ avail,
                        const unsigned char* __restrict__ same,
                        const double* __restrict__ gbps, int T, int N,
                        int S, double* b0, double* b1, double* arr,
                        int* cnt, int* assign, double* est_out,
                        double* eft_out) {
  __shared__ double sv[64], se[64];
  __shared__ unsigned long long sk[64];
  __shared__ unsigned sj[64];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const double inf = INFINITY;

  for (int j = tid; j < N; j += nt) {
    const bool has = avail[j] > 0.0;
    b0[j] = has ? 0.0 : inf;
    b1[j] = has ? avail[j] : inf;
    for (int k = 1; k < S; ++k) {
      b0[(long long)k * N + j] = inf;
      b1[(long long)k * N + j] = inf;
    }
    cnt[j] = has ? 1 : 0;
    for (int k = 0; k <= T; ++k) arr[(long long)k * N + j] = 0.0;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int o = order[t];
    const bool valid = o >= 0;
    const long long i = valid ? o : 0;
    const int iw = valid ? o : T;

    // this thread's best node, by (key, node): its nodes come in order.
    // A node's arrival rows are its own thread's stores.
    unsigned long long key = kNoKey;
    unsigned node = ~0u;
    double bv = 0.0, be = 0.0;
    for (int j = tid; j < N; j += nt) {
      double ready = ready0[i * N + j];
      for (int k = 0; k < D; ++k) {
        const int d = min(dep[i * D + k], T);
        if (d >= 0) ready = np_max(ready, arr[(long long)d * N + j]);
      }
      const double dur = W[i * N + j];
      const double e =
          isnan(ready) ? inf
                       : gap_run(b0 + j, b1 + j, N, 0, min(cnt[j], S - 1) + 1,
                                 ready, dur);
      const unsigned long long kj = argmin_key(e + dur);
      if (kj < key) {
        key = kj;
        node = j;
        bv = e + dur;
        be = e;
      }
    }
    const unsigned mine = node;
    warp_min(key, node);
    const int buf = (t & 1) * 32;
    if (mine == node && node != ~0u) {
      sk[buf + warp] = key;
      sj[buf + warp] = node;
      sv[buf + warp] = bv;
      se[buf + warp] = be;
    }
    __syncthreads();
    double v, est;
    const int js = block_winner(sk + buf, sj + buf, sv + buf, se + buf, nw,
                                nt, 1, lane, v, est);
    const int owner = js % nt;      // the thread that owns the winner
    if (warp == (owner >> 5)) {
      const int c = cnt[js];
      warp_insert(b0 + js, b1 + js, N, S, c, valid ? est : inf,
                  valid ? v : inf, lane);
      if (tid == owner) {
        cnt[js] = c + 1;
        assign[iw] = js;
        est_out[iw] = est;
        eft_out[iw] = v;
      }
    }
    for (int j = tid; j < N; j += nt) {
      const long long aj = (long long)js * N + j;
      arr[(long long)iw * N + j] = v + (same[aj] ? 0.0 : gb8[i] / gbps[aj]);
    }
  }

  for (int j = tid; j < N; j += nt) {
    const int live = min(cnt[j], S);
    int c = 0;
    for (int k = 0; k < live; ++k) c += b0[(long long)k * N + j] < inf;
    cnt[j] = c;
  }
}


// ---------------------------------------------------------------------------
// upward_rank
// ---------------------------------------------------------------------------
// Replaces the jitted TPU function repro/kernels/decision_plane.py::
// upward_rank (a fori_loop over the rows in reverse topo order, which the
// sweep's host wrapper fed with w_avg from W's row sums): HEFT's upward
// rank of every task, rank[i] = w_avg[i] + max(0, max over successors s of
// (avg_comm[i] + rank[s])), with w_avg[i] = W[i].cumsum()[-1] / N.
//
// Both routes are bitwise the host recurrence: each W row is summed left
// to right (numpy's cumsum order: the first cell, then one add a cell) and
// divided once by N; the walk goes level by level from the sinks, the rows
// of a level being independent, and only max and add touch the ranks.  A
// lane's flag is 1 where its W holds a cell that is not finite.
//
// Bound on the H100: latency.  W's bytes (T * N * 8 read once) take 0.24 us
// at 1000 x 100; the walk is a chain of L dependent levels (30 on the replan
// DAG, T on a chain), each a few dependent reads of the ranks and tables,
// float64 adds and compares and a barrier.  So the design keeps the chain
// on chip and short:
//
//   * The shared route (upward_rank_cluster_kernel) runs a lane on a
//     thread-block cluster of C blocks (8 at one lane, fewer where B * C
//     would oversubscribe the SMs).  The workers (every block but the
//     leader; the leader alone in a cluster of one) stage contiguous tiles
//     of their share of W's rows in shared memory with coalesced 8-byte
//     cp.async copies, stored transposed at an odd row stride so that a
//     thread a row then reads neighbouring words, sum each staged row in
//     order and send w_avg and their flag into the leader's shared memory
//     with st.async, which completes on the leader's mbarrier: no cluster
//     barrier (and no device-wide fence) at the end.
//   * Meanwhile one thread of the leader bulk-copies the lane's tables
//     (avg_comm, succ_ptr, level_ptr, level_rows, succ_idx; cp.async.bulk,
//     completing on an mbarrier), their 16-byte aligned bodies; the last
//     < 16 bytes of each come by plain loads.  The leader then describes
//     the rows in level order, (row, successor range, first successor,
//     avg_comm), 24 bytes a row, so that the walk reads shared memory only
//     and its reads of the tables never wait on a rank.
//   * The walk: a level of more than 32 rows takes the whole block, a
//     thread a row, and ends with one __syncthreads; a run of levels of at
//     most 32 rows (every level of a chain) is walked by warp 0 alone, a
//     lane a row, __syncwarp between levels, each lane's row of the next
//     level read under this one.  A row's successors' ranks go
//     into running maxima and avg_comm is added once: rounding to nearest
//     is monotonic, so a + max(rank[s]) is max(a + rank[s]) bit for bit,
//     and a NaN is never taken, as Python's max(best, c) never takes one.
//   * The global route (upward_rank_kernel, PR 28's kernel) serves lanes
//     whose tables, one W row and the row descriptors do not fit the
//     opt-in shared memory, or whose tables are not 16-byte aligned: a
//     block a lane, a thread a row summing W from device memory, the tables
//     read from device memory, the ranks in shared memory where 8 * T bytes
//     fit, one __syncthreads a level.
//
// The launch is shaped before it by kernels/decision_plane.py::
// rank_config, from the shapes, the pointers and the card: the route, the
// cluster size, the rows of a W tile, the dynamic shared memory and the
// leader's layout (RankSmem), which the kernel takes as given.  CUDA
// refuses a launch past the card's opt-in shared memory.
//
// Built with -DLOTARU_RANK_CLOCKS (rank_clocks.py), the shared route's
// thread 0 of each block of lane 0 records clock64() at the ends of its
// phases; otherwise RANK_MARK is nothing.
constexpr int kRankMaxThreads = 1024;     // the global route's block
constexpr int kRankThreads = 512;         // the shared route's block
constexpr int kRankMaxCluster = 16;       // 16 is a non-portable size

// One workflow's operands (eight 8-byte words a lane): W (T, N), avg_comm
// (T), the successor CSR (T + 1, E) and the level CSR (L + 1, T).
struct RankLane {
  const double* W;
  const double* avg_comm;
  const int* succ_ptr;
  const int* succ_idx;
  const int* level_ptr;
  const int* level_rows;
  long long T;
  long long L;
};
static_assert(sizeof(RankLane) == 64, "the lane table's row");

// Byte offsets of the leader's shared memory, each 16-byte aligned: the
// head (the tables' and the sums' mbarriers at 0 and 8, a flag a block
// from 16), rank (T float64: w_avg, then the ranks), avg_comm (T),
// succ_ptr (T + 1), level_ptr (L + 1), level_rows (T) and succ_idx (E),
// then `end`, where a worker's W tile or the leader's row descriptors
// start (kernels/decision_plane.py::rank_layout, for the largest lane).
struct RankSmem {
  int rank, ac, sp, lp, lr, si, end;
};

#ifdef LOTARU_RANK_CLOCKS
// per block of lane 0, in cycles: tables issued (from the start), W staging
// and row sums (all tiles), sums sent (from the start), and for the leader
// the rows described, the sums in, the walk's end and the output's end
// (from the start), then the walk's cycles in wide levels and in narrow
// runs
constexpr int kRankPhases = 10;
__device__ long long g_rank_clocks[kRankMaxCluster * kRankPhases];
#define RANK_MARK(p) \
  if (threadIdx.x == 0) clocks[p] = clock64() - clock_start;
#define RANK_STORE()                                              \
  if (lane_id == 0 && threadIdx.x == 0)                           \
    for (int p_ = 0; p_ < kRankPhases; ++p_)                      \
      g_rank_clocks[me * kRankPhases + p_] = clocks[p_];
#else
#define RANK_MARK(p)
#define RANK_STORE()
#endif

// one thread: the 16-byte multiple at the head of `bytes` at src (its
// body) into dst as a bulk copy completing on bar
__device__ __forceinline__ void bulk_body(void* dst, const void* src,
                                          long long bytes, unsigned bar) {
  const unsigned body = static_cast<unsigned>(bytes & ~15LL);
  if (body)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
          "l"(src), "r"(body), "r"(bar)
        : "memory");
}

// the elements of an array past its 16-byte body, by plain loads
template <typename V>
__device__ __forceinline__ void bulk_tail(V* dst, const V* src,
                                          long long count) {
  const long long first = (count * (long long)sizeof(V)) & ~15LL;
  for (long long e = first / (long long)sizeof(V); e < count; ++e)
    dst[e] = src[e];
}

__device__ __forceinline__ void mbar_wait_parity(unsigned bar,
                                                 unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one row of the walk: rank[i] += max(0, max over successors of
// (avg_comm[i] + rank[s]))
__device__ __forceinline__ void rank_row(int i, double* rk, const double* ac,
                                         const int* sp, const int* si) {
  const double a = ac[i];
  double best = 0.0;
  const int e1 = sp[i + 1];
  for (int e = sp[i]; e < e1; ++e) {
    const double c = a + rk[si[e]];
    best = c > best ? c : best;          // Python's max(best, c)
  }
  rk[i] = rk[i] + best;
}

// The leader's tables whose sizes need a read of device memory or that
// end in a ragged tail: thread 0 the bulk copy of succ_idx's body (E =
// succ_ptr[T]; the second arrival on bar), threads 32 and 64 every array's
// last < 16 bytes by plain loads.
__device__ __forceinline__ void rank_tables_rest(
    const RankLane& L, int T, int NL, unsigned bar, double* sac, int* ssp,
    int* slp, int* slr, int* ssi) {
  if (threadIdx.x == 0) {
    const long long size = 4LL * L.succ_ptr[T];
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(static_cast<unsigned>(size & ~15LL))
                 : "memory");
    bulk_body(ssi, L.succ_idx, size, bar);
  } else if (threadIdx.x == 32) {
    bulk_tail(sac, L.avg_comm, T);
    bulk_tail(ssp, L.succ_ptr, T + 1);
  } else if (threadIdx.x == 64) {
    bulk_tail(slp, L.level_ptr, NL + 1);
    bulk_tail(slr, L.level_rows, T);
    bulk_tail(ssi, L.succ_idx, L.succ_ptr[T]);
  }
}

// a remote store of the cluster's leader (rank 0): the value lands in its
// shared memory at `addr` (a shared::cluster address) and completes
// `bytes` on its mbarrier at `bar`
__device__ __forceinline__ unsigned lead_addr(const void* p) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n"
               : "=r"(a)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return a;
}
__device__ __forceinline__ void st_async_f64(unsigned addr, double v,
                                             unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f64"
      " [%0], %1, [%2];\n" ::"r"(addr), "d"(v), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async_b32(unsigned addr, int v,
                                             unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32"
      " [%0], %1, [%2];\n" ::"r"(addr), "r"(v), "r"(bar) : "memory");
}

// rank[i] = w_avg[i] + max(0, max over successors of (avg_comm[i] +
// rank[s])) for a row described in level order: d = (i, the successors
// past the first [d.y, d.z), the first successor or -1), a = avg_comm[i],
// w = w_avg[i].  The successors' ranks go into four running maxima (NaN
// is never taken), then a is added once: rounding to nearest is monotonic,
// so a + max(rank[s]) is max(a + rank[s]) bit for bit (a tie of -0.0 and
// +0.0 sums to at most +0.0 either way, which the max with 0.0 keeps).
__device__ __forceinline__ void rank_desc(int4 d, double a, double w,
                                          double* rk, const int* si) {
  double m0 = -INFINITY, m1 = -INFINITY, m2 = -INFINITY, m3 = -INFINITY;
  if (d.w >= 0) {
    const double r = rk[d.w];
    m0 = r > m0 ? r : m0;
  }
  int e = d.y;
  for (; e + 4 <= d.z; e += 4) {
    const double r0 = rk[si[e]], r1 = rk[si[e + 1]];
    const double r2 = rk[si[e + 2]], r3 = rk[si[e + 3]];
    m0 = r0 > m0 ? r0 : m0;
    m1 = r1 > m1 ? r1 : m1;
    m2 = r2 > m2 ? r2 : m2;
    m3 = r3 > m3 ? r3 : m3;
  }
  for (; e < d.z; ++e) {
    const double r = rk[si[e]];
    m0 = r > m0 ? r : m0;
  }
  m0 = m1 > m0 ? m1 : m0;
  m2 = m3 > m2 ? m3 : m2;
  m0 = m2 > m0 ? m2 : m0;
  const double c = a + m0;
  rk[d.x] = w + (c > 0.0 ? c : 0.0);     // Python's max(0.0, c)
}

// The shared route: a cluster of C blocks a lane (grid B * C), its shared
// memory laid out as `lay`; tile_rows the rows of a W tile (stored
// transposed at stride tile_rows | 1).
__global__ void __launch_bounds__(kRankThreads)
upward_rank_cluster_kernel(const RankLane* __restrict__ lanes,
                           const RankLane lane0, int N, int Tmax,
                           const RankSmem lay, int tile_rows,
                           double* rank_out, int* bad_out) {
  extern __shared__ __align__(16) unsigned char rank_smem[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int me = static_cast<int>(cluster.block_rank());
  const int lane_id = blockIdx.x / C;     // a cluster: C consecutive blocks
  const RankLane L = lanes ? lanes[lane_id] : lane0;
  const int T = static_cast<int>(L.T), NL = static_cast<int>(L.L);
  const int tid = threadIdx.x, nt = blockDim.x;
#ifdef LOTARU_RANK_CLOCKS
  long long clocks[kRankPhases] = {};
  const long long clock_start = clock64();
#endif

  // the head: the tables' mbarrier, the W sums' mbarrier, a flag a block
  const unsigned bar =
      static_cast<unsigned>(__cvta_generic_to_shared(rank_smem));
  const unsigned bar_w = bar + 8;
  int* sbad = reinterpret_cast<int*>(rank_smem + 16);
  double* srank = reinterpret_cast<double*>(rank_smem + lay.rank);
  double* sac = reinterpret_cast<double*>(rank_smem + lay.ac);
  int* ssp = reinterpret_cast<int*>(rank_smem + lay.sp);
  int* slp = reinterpret_cast<int*>(rank_smem + lay.lp);
  int* slr = reinterpret_cast<int*>(rank_smem + lay.lr);
  int* ssi = reinterpret_cast<int*>(rank_smem + lay.si);
  // past the tables: a W tile (the workers) or the leader's row
  // descriptors in level order, (i, successors past the first, the first)
  // and avg_comm
  double* tile = reinterpret_cast<double*>(rank_smem + lay.end);
  int4* desc = reinterpret_cast<int4*>(rank_smem + lay.end);
  double* desc_a = reinterpret_cast<double*>(desc + T);

  // The workers sum W's rows: every block but the leader, or the leader
  // alone in a cluster of one.  The leader bulk-copies its tables meanwhile
  // and expects the workers' sums and flags on bar_w.
  const int workers = C > 1 ? C - 1 : 1, wk = C > 1 ? me - 1 : 0;
  if (me == 0 && tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 2;\n" ::"r"(bar)
                 : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_w)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const long long size[4] = {8LL * T, 4LL * (T + 1), 4LL * (NL + 1),
                               4LL * T};
    const long long bytes = (size[0] & ~15LL) + (size[1] & ~15LL) +
                            (size[2] & ~15LL) + (size[3] & ~15LL);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(static_cast<unsigned>(bytes)) : "memory");
    bulk_body(sac, L.avg_comm, size[0], bar);
    bulk_body(ssp, L.succ_ptr, size[1], bar);
    bulk_body(slp, L.level_ptr, size[2], bar);
    bulk_body(slr, L.level_rows, size[3], bar);
    const unsigned remote = C > 1 ? 8u * T + 4u * (C - 1) : 0u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar_w), "r"(remote) : "memory");
  }
  RANK_MARK(0)   // tables issued
  // every block has started once all have arrived: remote stores wait
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  bool waited = false;
  int bad = 0;
  if (C == 1 || me > 0) {
    const int per = (T + workers - 1) / workers;
    const int r_lo = min(T, wk * per), r_hi = min(T, r_lo + per);
    const int stride = tile_rows | 1;
    const unsigned lead_rank = lead_addr(srank), lead_bar = lead_addr(
        rank_smem + 8);
#ifdef LOTARU_RANK_CLOCKS
    long long t_stage = 0, t_sum = 0;
#endif
    for (int row0 = r_lo; row0 < r_hi; row0 += tile_rows) {
#ifdef LOTARU_RANK_CLOCKS
      const long long c0 = clock64();
#endif
      const int rows = min(tile_rows, r_hi - row0);
      const double* src = L.W + (long long)row0 * N;
      if (N > 0) {
        // element e of the tile's row-major box: row e / N, column e % N;
        // neighbouring threads read neighbouring words of W
        const int dr = nt / N, dk = nt - dr * N;
        int r = tid / N, k = tid - r * N;
        for (int e = tid; e < rows * N; e += nt) {
          cp_async8(tile + (long long)k * stride + r, src + e);
          r += dr;
          k += dk;
          if (k >= N) {
            k -= N;
            ++r;
          }
        }
      }
      if (!waited) {
        if (C == 1) rank_tables_rest(L, T, NL, bar, sac, ssp, slp, slr, ssi);
        asm volatile("barrier.cluster.wait;\n" ::: "memory");
        waited = true;
      }
      cp_async_wait_all();
      __syncthreads();
#ifdef LOTARU_RANK_CLOCKS
      const long long c1 = clock64();
      t_stage += c1 - c0;
#endif
      // each row summed left to right (the first cell, then one add a
      // cell), then one division
      for (int r = tid; r < rows; r += nt) {
        double s = 0.0;                  // W.sum(1) of an empty row
        if (N > 0) {
          s = tile[r];
          bad |= !isfinite(s);
#pragma unroll 8
          for (int k = 1; k < N; ++k) {
            const double w = tile[(long long)k * stride + r];
            bad |= !isfinite(w);
            s = s + w;
          }
          s = s / static_cast<double>(N);
        }
        if (C > 1)
          st_async_f64(lead_rank + 8u * (row0 + r), s, lead_bar);
        else
          srank[row0 + r] = s;
      }
      __syncthreads();                   // the tile is free again
#ifdef LOTARU_RANK_CLOCKS
      t_sum += clock64() - c1;
#endif
    }
#ifdef LOTARU_RANK_CLOCKS
    if (tid == 0) {
      clocks[1] = t_stage;
      clocks[2] = t_sum;
    }
#endif
    if (!waited) {
      if (C == 1) rank_tables_rest(L, T, NL, bar, sac, ssp, slp, slr, ssi);
      asm volatile("barrier.cluster.wait;\n" ::: "memory");
      waited = true;
    }
    bad = __syncthreads_or(bad);
    if (C > 1) {
      if (tid == 0) st_async_b32(lead_addr(sbad + me), bad, lead_bar);
      RANK_MARK(3)   // sums sent
      RANK_STORE()
      return;                            // a worker's part is done
    }
  }
  RANK_MARK(3)   // sums done (a cluster of one)
  if (!waited) {                         // the leader of a cluster of more
    rank_tables_rest(L, T, NL, bar, sac, ssp, slp, slr, ssi);
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
  }

  // the rows described in level order, for a walk whose reads of the
  // tables do not wait on the ranks (the tails' plain stores are in after
  // the barrier)
  mbar_wait_parity(bar, 0);
  __syncthreads();
  for (int k = tid; k < T; k += nt) {
    const int i = slr[k], e0 = ssp[i], e1 = ssp[i + 1];
    desc[k] = make_int4(i, e0 + 1, e1, e0 < e1 ? ssi[e0] : -1);
    desc_a[k] = sac[i];
  }
  RANK_MARK(4)   // tables in, rows described
  mbar_wait_parity(bar_w, 0);
  __syncthreads();
  for (int b = 1; b < C; ++b) bad |= sbad[b];
  RANK_MARK(5)   // the workers' sums and flags in

  // A wide level (more than 32 rows) takes the block, a thread a row, and
  // one __syncthreads.  A run of narrow levels is warp 0's alone, a lane
  // a row, __syncwarp between levels, each lane's row of the next level
  // read under this one; the other warps
  // find the run's end (32 levels a ballot) and wait at the run's one
  // __syncthreads.
  const int warp = tid >> 5, lane = tid & 31;
  for (int l = 0; l < NL;) {
#ifdef LOTARU_RANK_CLOCKS
    const long long w0 = clock64();
#endif
    const int lo = slp[l], hi = slp[l + 1];
    if (hi - lo > 32) {
      for (int k = lo + tid; k < hi; k += nt)
        rank_desc(desc[k], desc_a[k], srank[desc[k].x], srank, ssi);
      __syncthreads();
      ++l;
#ifdef LOTARU_RANK_CLOCKS
      if (tid == 0) clocks[8] += clock64() - w0;
#endif
      continue;
    }
    int end = NL;                        // the first wide level past l
    for (int m0 = l + 1; m0 < NL; m0 += 32) {
      const int m = m0 + lane;
      const unsigned wide =
          __ballot_sync(kFull, m < NL && slp[m + 1] - slp[m] > 32);
      if (wide) {
        end = m0 + __ffs(wide) - 1;
        break;
      }
    }
    if (warp == 0) {
      // level m's row of this lane in registers; the next level's end, and
      // the one after's, read a level ahead
      int hi_c = hi;
      int hi_n = l + 1 < end ? slp[l + 2] : hi;
      const int k = lo + lane;
      bool v = k < hi_c;
      int4 d = desc[v ? k : lo];
      double a = desc_a[v ? k : lo];
      for (int m = l; m < end; ++m) {
        const int kn = hi_c + lane;
        const bool nv = kn < hi_n;
        const int4 nd = desc[nv ? kn : lo];
        const double na = desc_a[nv ? kn : lo];
        const int hi_nn = m + 2 < end ? slp[m + 3] : hi_n;
        if (v) rank_desc(d, a, srank[d.x], srank, ssi);   // w_avg: unwalked
        __syncwarp();
        d = nd;
        a = na;
        v = nv;
        hi_c = hi_n;
        hi_n = hi_nn;
      }
    }
    __syncthreads();
    l = end;
#ifdef LOTARU_RANK_CLOCKS
    if (tid == 0) clocks[9] += clock64() - w0;
#endif
  }
  RANK_MARK(6)   // walked
  double* out = rank_out + (long long)lane_id * Tmax;
  for (int i = tid; i < Tmax; i += nt) out[i] = i < T ? srank[i] : -INFINITY;
  if (tid == 0) bad_out[lane_id] = bad;
  RANK_MARK(7)   // written
  RANK_STORE()
}

__global__ void __launch_bounds__(kRankMaxThreads)
upward_rank_kernel(const RankLane* __restrict__ lanes, const RankLane lane0,
                   int N, int Tmax, int in_smem, double* rank_out,
                   int* bad_out) {
  extern __shared__ double srank_g[];
  const RankLane L = lanes ? lanes[blockIdx.x] : lane0;
  const int T = static_cast<int>(L.T);
  double* out = rank_out + (long long)blockIdx.x * Tmax;
  double* rk = in_smem ? srank_g : out;

  int bad = 0;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const double* row = L.W + (long long)i * N;
    double s = 0.0;                          // W.sum(1) of an empty row
    if (N > 0) {
      s = row[0];
      bad |= !isfinite(s);
#pragma unroll 4
      for (int k = 1; k < N; ++k) {
        const double w = row[k];
        bad |= !isfinite(w);
        s = s + w;
      }
      s = s / static_cast<double>(N);
    }
    rk[i] = s;
  }
  bad = __syncthreads_or(bad);

  for (long long l = 0; l < L.L; ++l) {
    const int lo = L.level_ptr[l], hi = L.level_ptr[l + 1];
    for (int k = lo + threadIdx.x; k < hi; k += blockDim.x)
      rank_row(L.level_rows[k], rk, L.avg_comm, L.succ_ptr, L.succ_idx);
    __syncthreads();
  }

  for (int i = threadIdx.x; i < Tmax; i += blockDim.x) {
    if (i >= T)
      out[i] = -INFINITY;
    else if (in_smem)
      out[i] = rk[i];
  }
  if (threadIdx.x == 0) bad_out[blockIdx.x] = bad;
}

// cudaFuncSetAttribute once a device for the largest dynamic shared
// memory asked so far (and for the non-portable cluster size, once), not
// on every launch
cudaError_t rank_cluster_attrs(int device, int smem_bytes, int cluster) {
  static int smem_set[64];
  static bool wide_set[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (smem_bytes > smem_set[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        upward_rank_cluster_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    smem_set[device] = smem_bytes;
  }
  if (cluster > 8 && !wide_set[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        upward_rank_cluster_kernel,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide_set[device] = true;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* lotaru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The cost matrix of a packed slab (kernels.decision_plane.pack_cost: t
// task rows in column groups of p = t rounded up to even slots, then n
// node corrections at slot kQuerySlots * p) and the resident (t, n) static
// factors `base`, both 16-byte aligned, into w (t, n); t * n < 2^31.
int lotaru_fused_cost(const double* slab, const double* base, double* w,
                      int t, int n, double z, int has_z, void* stream) {
  if (t <= 0 || n <= 0) return 0;
  const long long p = t + (t & 1);
  const int blocks = (t + kCostRows - 1) / kCostRows;
  fused_cost_kernel<<<blocks, kCostThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      slab, base, w, t, n, p, z, has_z);
  return static_cast<int>(cudaGetLastError());
}

long long lotaru_eft_sweep_smem_bytes(int T, int N, int S, int D) {
  return sweep_smem_bytes(T, N, S, D);
}

int lotaru_smem_optin(int device) {
  int bytes = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  return bytes;
}

#ifdef LOTARU_SWEEP_CLOCKS
// the last shared-route launch's cycles: per warp and phase, then the total
int lotaru_sweep_clocks(long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_sweep_clocks, sizeof(g_sweep_clocks)));
}
#endif

}  // extern "C"

namespace {

// the shared route for B lanes: lanes (device) or, at B = 1, lane0
int launch_onchip(const SweepLane* lanes, const SweepLane& lane0, int B,
                  const int* order, int D, const unsigned char* same,
                  const double* gbps, int T, int N, int S, double* arr,
                  int* cnt, int* assign, double* est, double* eft,
                  cudaStream_t s) {
  int device = 0;
  cudaGetDevice(&device);
  const long long optin = lotaru_smem_optin(device);
  long long bytes = sweep_smem_bytes(T, N, S, D);
  if (N > kOnChipMaxNodes || bytes > optin)
    return static_cast<int>(cudaErrorInvalidValue);
  const int stage_comm = bytes + sweep_comm_bytes(N) <= optin;
  if (stage_comm) bytes += sweep_comm_bytes(N);
  const cudaError_t err = cudaFuncSetAttribute(
      eft_sweep_onchip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = sweep_lanes(N);
  const int threads = ((N * P + 31) / 32) * 32;
  eft_sweep_onchip_kernel<<<B, threads, bytes, s>>>(
      lanes, lane0, order, D, same, gbps, T, N, S, P, stage_comm, arr, cnt,
      assign, est, eft);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// route 0: the stacks, order, dependency rows and output sizes in shared
// memory (b0 and b1 are not read and may be NULL); the shape must fit the
// device's opt-in limit with at most 512 nodes, or the call returns
// cudaErrorInvalidValue and launches nothing.  Route 1: the stacks in the
// device scratch b0, b1 (S, N), a thread looping over nodes.  Both use
// arr ((T + 1) x N float64 scratch, the arrival rows) and write the final
// interval counts to cnt (N).
int lotaru_eft_sweep(const double* W, const int* order, const int* dep,
                     int D, const double* gb8, const double* ready0,
                     const double* avail, const unsigned char* same,
                     const double* gbps, int T, int N, int S, int route,
                     double* b0, double* b1, double* arr, int* cnt,
                     int* assign, double* est, double* eft, void* stream) {
  if (N <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    const SweepLane lane0{W, ready0, dep, gb8, avail, D};
    return launch_onchip(nullptr, lane0, 1, order, D, same, gbps, T, N, S,
                         arr, cnt, assign, est, eft, s);
  }
  int threads = ((N + 31) / 32) * 32;
  if (threads > kSweepMaxThreads) threads = kSweepMaxThreads;
  eft_sweep_global_kernel<<<1, threads, 0, s>>>(
      W, order, dep, D, gb8, ready0, avail, same, gbps, T, N, S, b0, b1,
      arr, cnt, assign, est, eft);
  return static_cast<int>(cudaGetLastError());
}

// B workflows on one cluster on the shared route, block b sweeping lane b
// of the device table `lanes` (B rows of SweepLane, 48 bytes each); order
// (B, T), D the widest lane's dependency count, outputs stacked a lane each
// (see eft_sweep_onchip_kernel).  Refuses a shape as route 0 of
// lotaru_eft_sweep does.
int lotaru_eft_sweep_many(const void* lanes, int B, const int* order,
                          int D, const unsigned char* same,
                          const double* gbps, int T, int N, int S,
                          double* arr, int* cnt, int* assign, double* est,
                          double* eft, void* stream) {
  if (B <= 0 || N <= 0 || S <= 0) return 0;
  const SweepLane none{};
  return launch_onchip(static_cast<const SweepLane*>(lanes), none, B, order,
                       D, same, gbps, T, N, S, arr, cnt, assign, est, eft,
                       static_cast<cudaStream_t>(stream));
}

// B workflows' upward ranks, lane b from row b of the device table `table`
// (B rows of RankLane, 64 bytes each) or, when table is NULL and B = 1,
// from the host row `host_row` (passed to the kernel by value).  rank (B,
// Tmax) gets -inf past each lane's T; bad (B) gets 1 where the lane's W
// holds a non-finite cell.  The launch comes shaped by
// kernels/decision_plane.py::rank_config.  Route 0 (shared): a cluster of
// `cluster` blocks a lane (1, 2, 4, 8 or 16, else cudaErrorInvalidValue),
// W tiles of tile_rows rows, smem_bytes of dynamic shared memory laid out
// as layout[7] (RankSmem's fields in order); every lane's tables must be
// 16-byte aligned.  Route 1 (global): a block a lane, the ranks in
// smem_bytes = 8 Tmax of shared memory, or in the output row when 0.
int lotaru_upward_rank(const void* table, const void* host_row, int B,
                       int N, int Tmax, int route, int cluster,
                       int tile_rows, int smem_bytes, const int* layout,
                       double* rank, int* bad, void* stream) {
  const RankLane* lanes = static_cast<const RankLane*>(table);
  const RankLane* lane0 = static_cast<const RankLane*>(host_row);
  if (B <= 0) return 0;
  if (!lanes && (B != 1 || !lane0))
    return static_cast<int>(cudaErrorInvalidValue);
  const RankLane by_value = lanes ? RankLane{} : *lane0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int device = 0;
  cudaGetDevice(&device);
  if (route == 0) {
    if (!layout || tile_rows < 1 ||
        (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8 &&
         cluster != kRankMaxCluster))
      return static_cast<int>(cudaErrorInvalidValue);
    const RankSmem lay{layout[0], layout[1], layout[2], layout[3],
                       layout[4], layout[5], layout[6]};
    cudaError_t err = rank_cluster_attrs(device, smem_bytes, cluster);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(B * cluster));
    cfg.blockDim = dim3(kRankThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, upward_rank_cluster_kernel, lanes,
                             by_value, N, Tmax, lay, tile_rows, rank, bad);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        upward_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = ((Tmax + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > kRankMaxThreads) threads = kRankMaxThreads;
  upward_rank_kernel<<<B, threads, smem_bytes, s>>>(
      lanes, by_value, N, Tmax, smem_bytes > 0, rank, bad);
  return static_cast<int>(cudaGetLastError());
}

#ifdef LOTARU_RANK_CLOCKS
// the last shared-route launch's clocks: per block of lane 0 (its rank in
// the cluster), kRankPhases values each
int lotaru_rank_clocks(long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_rank_clocks, sizeof(g_rank_clocks)));
}
#endif

}  // extern "C"
