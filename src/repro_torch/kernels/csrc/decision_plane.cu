// Hand-written Hopper kernels for HEFT placement: the fused cost matrix and
// the insertion-based candidate-EFT sweep, in float64, built by nvcc into a
// plain-C shared library and bound with ctypes (see kernels/_build.py).
//
// Build flags: -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false.
// Both kernels are held bitwise against host float64 references:
// fused_cost against predict_blr_np -> store.compute.scale ->
// store.compute.cost_matrix, and eft_sweep (through the schedule it yields)
// against sched.heft.heft_schedule_matrix.  Each C entry point launches on
// the caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

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
// (T, N) HEFT cost matrix W = max(mean, 1e-3) * f [+ z * (std * f)].
//
// Bound on the H100: memory.  A cell reads its factor and writes its cost
// (16 bytes) for a handful of float64 operations; the 88 bytes of a task's
// posterior row are read once per row and served from the cache for the
// row's other cells.  Design: one thread per (task, node) cell,
// grid-stride; a thread recomputes its row's predictive (about 20
// operations) rather than staging it, which keeps the kernel one pass with
// no shared memory.  The TPU kernel ran float32; here the predictive is the
// float64 code of bayes_predict (predictive.cuh), so W is bitwise the
// host's.  The mean floor is numpy.maximum's: NaN propagates and -0.0
// becomes 1e-3 (CUDA's fmax would drop a NaN, so it is not used).
constexpr int kCostThreads = 256;

__global__ void __launch_bounds__(kCostThreads)
fused_cost_kernel(const double* __restrict__ x,
                  const double* __restrict__ mu,
                  const double* __restrict__ sigma,
                  const double* __restrict__ beta,
                  const double* __restrict__ x_mu,
                  const double* __restrict__ x_sd,
                  const double* __restrict__ y_mu,
                  const double* __restrict__ y_sd,
                  const double* __restrict__ f, double* __restrict__ w,
                  long long t, int n, double z, int has_z) {
  const long long cells = t * (long long)n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < cells; c += stride) {
    double mean, std;
    lotaru_predictive(x, mu, sigma, beta, x_mu, x_sd, y_mu, y_sd, c / n,
                      &mean, &std);
    const double fc = f[c];
    const double m = (mean < 1e-3) ? 1e-3 : mean;
    double wc = m * fc;
    if (has_z) wc = wc + z * (std * fc);
    w[c] = wc;
  }
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
// (begin, end) order and its communication row is recorded for the task's
// successors.
//
// Bound on the H100: latency.  The T tasks are a serial chain (each
// placement changes the intervals the next one searches), and the bytes
// (W, ready times and dependency rows, read once) take microseconds.  A
// step is a dependent sequence: dependency loads, the gap search, a
// block-wide argmin, one thread's insert, and three barriers.  Design: one
// thread block, one thread per node (a thread loops over nodes when N
// exceeds the block), and the serial loop over tasks inside the block, so
// the sweep costs one launch instead of T.  Each node's interval stack,
// its live count and its column of the communication rows are touched
// only by the node's own thread; the stacks live in device-memory scratch
// laid out (S, N), so a warp's gap search reads consecutive addresses, and
// they are right at every S the host's overflow retry reaches (at S = 192
// and N = 100 they take 307 KB, past the 227 KB of shared memory a block
// may use).  A node's live count bounds its gap search and insert: columns
// at or past it are (inf, inf) pads, which change neither, so the result
// is that of the full S-column search.  Only max, add, divide and compare
// are used, so the float64 result is bitwise the host sweep's.
constexpr int kSweepMaxThreads = 1024;

// numpy.maximum: NaN propagates
__device__ __forceinline__ double np_max(double a, double b) {
  return (a > b || isnan(a)) ? a : b;
}

// np.argmin's order: the first NaN wins, else the smaller value, ties to
// the lower index
__device__ __forceinline__ bool before(double av, int aj, double bv,
                                       int bj) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an || bn) return an && (!bn || aj < bj);
  return av < bv || (av == bv && aj < bj);
}

__global__ void __launch_bounds__(kSweepMaxThreads)
eft_sweep_kernel(const double* __restrict__ W,
                 const int* __restrict__ order,
                 const int* __restrict__ dep, int D,
                 const double* __restrict__ gb8,
                 const double* __restrict__ ready0,
                 const double* __restrict__ avail,
                 const unsigned char* __restrict__ same,
                 const double* __restrict__ gbps, int T, int N, int S,
                 double* b0, double* b1, int* cnt, double* fin, double* comm,
                 int* assign, double* est_out, double* eft_out) {
  __shared__ double s_v[32];
  __shared__ int s_j[32];
  __shared__ int s_sel;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const double inf = INFINITY;

  // node_available seeds a [0, avail) busy prefix; the rest are pads
  for (int j = tid; j < N; j += nt) {
    const bool has = avail[j] > 0.0;
    b0[j] = has ? 0.0 : inf;
    b1[j] = has ? avail[j] : inf;
    for (int k = 1; k < S; ++k) {
      b0[(long long)k * N + j] = inf;
      b1[(long long)k * N + j] = inf;
    }
    cnt[j] = has ? 1 : 0;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int o = order[t];
    const bool valid = o >= 0;
    const long long i = valid ? o : 0;
    const long long iw = valid ? i : T;  // row T: the masked rows' dump

    double best_v = 0.0, best_est = 0.0;
    int best_j = -1;
    for (int j = tid; j < N; j += nt) {
      double ready = ready0[i * N + j];
      for (int k = 0; k < D; ++k) {
        const int d = dep[i * D + k];
        if (d >= 0) ready = np_max(ready, fin[d] + comm[(long long)d * N + j]);
      }
      const double dur = W[i * N + j];
      // gap search: the earliest candidate start max(ready, end of the
      // previous interval) whose [start, start + dur) ends by the next
      // interval's begin
      const int live = min(cnt[j], S - 1);
      double e = inf;
      double prev = -inf;
      for (int k = 0; k <= live; ++k) {
        const double cand = np_max(ready, prev);
        if (cand + dur <= b0[(long long)k * N + j] && cand < e) e = cand;
        prev = b1[(long long)k * N + j];
      }
      const double eft = e + dur;
      if (best_j < 0 || before(eft, j, best_v, best_j)) {
        best_v = eft;
        best_est = e;
        best_j = j;
      }
    }

    // block argmin of (eft, node)
    double v = best_v;
    int jj = best_j;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const double ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oj = __shfl_down_sync(0xffffffffu, jj, off);
      if (oj >= 0 && (jj < 0 || before(ov, oj, v, jj))) {
        v = ov;
        jj = oj;
      }
    }
    if (lane == 0) {
      s_v[warp] = v;
      s_j[warp] = jj;
    }
    __syncthreads();
    if (warp == 0) {
      const int nw = (nt + 31) >> 5;
      v = lane < nw ? s_v[lane] : 0.0;
      jj = lane < nw ? s_j[lane] : -1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const double ov = __shfl_down_sync(0xffffffffu, v, off);
        const int oj = __shfl_down_sync(0xffffffffu, jj, off);
        if (oj >= 0 && (jj < 0 || before(ov, oj, v, jj))) {
          v = ov;
          jj = oj;
        }
      }
      if (lane == 0) s_sel = jj;
    }
    __syncthreads();
    const int js = s_sel;

    if (best_j == js) {  // the winning node's own thread
      const double estj = best_est, eftj = best_v;
      // masked rows insert (inf, inf): a no-op on the pad columns
      const double est_ins = valid ? estj : inf;
      const double eft_ins = valid ? eftj : inf;
      const int c = cnt[js];
      const int live = min(c, S);
      // counting searchsorted in (begin, end) order
      int pos = 0;
      for (int k = 0; k < live; ++k) {
        const double a = b0[(long long)k * N + js];
        const double b = b1[(long long)k * N + js];
        pos += (a < est_ins) + (a == est_ins && b < eft_ins);
      }
      for (int k = min(c, S - 1); k > pos; --k) {
        b0[(long long)k * N + js] = b0[(long long)(k - 1) * N + js];
        b1[(long long)k * N + js] = b1[(long long)(k - 1) * N + js];
      }
      if (pos < S) {
        b0[(long long)pos * N + js] = est_ins;
        b1[(long long)pos * N + js] = eft_ins;
      }
      cnt[js] = c + 1;
      assign[iw] = js;
      est_out[iw] = estj;
      eft_out[iw] = eftj;
      fin[iw] = eftj;
    }
    const double g = gb8[i];
    for (int k = tid; k < N; k += nt) {
      const long long jk = (long long)js * N + k;
      comm[iw * N + k] = same[jk] ? 0.0 : g / gbps[jk];
    }
    __syncthreads();
  }

  // final interval count per node (begins below +inf)
  for (int j = tid; j < N; j += nt) {
    const int live = min(cnt[j], S);
    int c = 0;
    for (int k = 0; k < live; ++k) c += b0[(long long)k * N + j] < inf;
    cnt[j] = c;
  }
}

}  // namespace

extern "C" {

const char* lotaru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int lotaru_fused_cost(const double* x, const double* mu, const double* sigma,
                      const double* beta, const double* x_mu,
                      const double* x_sd, const double* y_mu,
                      const double* y_sd, const double* f, double* w,
                      long long t, int n, double z, int has_z,
                      void* stream) {
  const long long cells = t * (long long)n;
  if (cells <= 0) return 0;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long blocks = (cells + kCostThreads - 1) / kCostThreads;
  const long long cap = 16LL * sms;
  if (blocks > cap) blocks = cap;
  fused_cost_kernel<<<(unsigned)blocks, kCostThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, mu, sigma, beta, x_mu, x_sd, y_mu, y_sd, f, w, t, n, z, has_z);
  return static_cast<int>(cudaGetLastError());
}

int lotaru_eft_sweep(const double* W, const int* order, const int* dep,
                     int D, const double* gb8, const double* ready0,
                     const double* avail, const unsigned char* same,
                     const double* gbps, int T, int N, int S, double* b0,
                     double* b1, int* cnt, double* fin, double* comm,
                     int* assign, double* est, double* eft, void* stream) {
  if (N <= 0 || S <= 0) return 0;
  int threads = ((N + 31) / 32) * 32;
  if (threads > kSweepMaxThreads) threads = kSweepMaxThreads;
  eft_sweep_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      W, order, dep, D, gb8, ready0, avail, same, gbps, T, N, S, b0, b1, cnt,
      fin, comm, assign, est, eft);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
