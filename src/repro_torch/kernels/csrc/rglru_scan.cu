// Hand-written Hopper kernel for the RG-LRU linear recurrence of the
// Griffin (RecurrentGemma) recurrent block, built by nvcc into a plain-C
// shared library and bound with ctypes (see kernels/_build.py).
//
// Build flags: -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false.
// --fmad=false keeps each step's a*h + gx a separately rounded multiply and
// add, which is what makes the kernel bitwise equal to its plain version
// (kernels/ref.py::rglru_scan_ref).  The C entry point launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

// 64 threads a block: B*W = 8,192 channels at RecurrentGemma-9B's width
// make 128 blocks, one for each of 128 of the 132 SMs, where 256-thread
// blocks would leave 100 SMs idle.
constexpr int kThreads = 64;
constexpr int kUnroll = 32;

// Replaces the TPU kernel repro/kernels/rglru_scan.py::rglru_scan
// (_rglru_kernel): h_t = a_t * h_{t-1} + gx_t over (B, T, W) float32, from
// h0 (B, W).
//
// Bound on the H100: memory.  Each (b, t, w) reads a and gx and writes h,
// 12 bytes, for two float32 operations.  The TPU kernel streamed the time
// axis through VMEM tiles with the carry in scratch; here one thread owns
// one (b, w) channel and walks T in order with h in a register, so nothing
// but a, gx and h touches memory.  Consecutive threads take consecutive w,
// so each step's loads and store are coalesced across a warp.  The loads
// of the next kUnroll steps are issued before the current kUnroll steps'
// dependent chain of updates runs, so a thread keeps 2 * kUnroll loads in
// flight.  The time axis stays sequential:
// only B*W threads exist, far from filling the card (a chunked two-pass
// scan is the way to more parallelism, left for later work).
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ gx,
                  const float* __restrict__ h0, float* __restrict__ h,
                  int batch, int steps, int width) {
  const long long ch = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= (long long)batch * width) return;
  const long long b = ch / width;
  const long long w = ch - b * width;
  const long long base = b * (long long)steps * width + w;
  const float* ap = a + base;
  const float* gp = gx + base;
  float* hp = h + base;
  float hv = h0[ch];
  // chunks of kUnroll steps; the next chunk's loads are issued before the
  // current chunk's dependent chain runs
  float a_next[kUnroll], g_next[kUnroll];
  const int full = steps / kUnroll * kUnroll;
  if (full > 0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a_next[u] = ap[(long long)u * width];
      g_next[u] = gp[(long long)u * width];
    }
  }
  for (int t = 0; t < full; t += kUnroll) {
    float av[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = a_next[u];
      gv[u] = g_next[u];
    }
    if (t + kUnroll < full) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        a_next[u] = ap[(long long)(t + kUnroll + u) * width];
        g_next[u] = gp[(long long)(t + kUnroll + u) * width];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      hv = av[u] * hv + gv[u];
      hp[(long long)(t + u) * width] = hv;
    }
  }
  for (int t = full; t < steps; ++t) {
    hv = ap[(long long)t * width] * hv + gp[(long long)t * width];
    hp[(long long)t * width] = hv;
  }
}

// The scan's gradient, for training.  No TPU kernel is replaced: the JAX
// package differentiates its associative scan; this computes the same
// gradient.  Given h (the forward's output), a, h0 and g = dL/dh, one
// thread a (b, w) channel walks t from T - 1 down:
//   dh_t = g_t + a_{t+1} dh_{t+1}   (dh_{T-1} = g_{T-1})
//   da_t = dh_t h_{t-1}  (h_{-1} = h0),   dgx_t = dh_t,   dh0 = a_0 dh_0.
// Bound on the H100: memory (a, h and g read, da and dgx written: 20 bytes
// for three operations a step).  As in the forward, the loads of the next
// chunk of kBwdUnroll steps (a, g and h_{t-1}) are issued before the
// current chunk's dependent chain runs.  Blocks of 32 threads: the
// training shape's B*W = 4,096 channels make 128 blocks, one for each of
// 128 of the 132 SMs.  With --fmad=false each step's g + a * dh is a
// separately rounded multiply and add, so the kernel is bitwise
// kernels/ref.py::rglru_scan_bwd_ref.
constexpr int kBwdThreads = 32;
constexpr int kBwdUnroll = 16;

__global__ void __launch_bounds__(kBwdThreads)
rglru_scan_bwd_kernel(const float* __restrict__ a,
                      const float* __restrict__ h,
                      const float* __restrict__ h0,
                      const float* __restrict__ g, float* __restrict__ da,
                      float* __restrict__ dgx, float* __restrict__ dh0,
                      int batch, int steps, int width) {
  const long long ch = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= (long long)batch * width) return;
  const long long b = ch / width;
  const long long w = ch - b * width;
  const long long base = b * (long long)steps * width + w;
  const float* ap = a + base;
  const float* hp = h + base;
  const float* gp = g + base;
  float* dap = da + base;
  float* dgp = dgx + base;
  const float h_init = h0[ch];
  float dh = 0.f;
  float a_next = 0.f;                  // a_{t+1} once t < T - 1
  // the top T % kBwdUnroll steps one at a time, then whole chunks down to 0
  const int rem = steps % kBwdUnroll;
  for (int t = steps - 1; t >= steps - rem; --t) {
    const float gv = gp[(long long)t * width];
    const float hv = t > 0 ? hp[(long long)(t - 1) * width] : h_init;
    dh = t == steps - 1 ? gv : gv + a_next * dh;
    dgp[(long long)t * width] = dh;
    dap[(long long)t * width] = dh * hv;
    a_next = ap[(long long)t * width];
  }
  float a_n[kBwdUnroll], g_n[kBwdUnroll], h_n[kBwdUnroll];
  int t0 = steps - rem - kBwdUnroll;
  if (t0 >= 0) {
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      a_n[u] = ap[(long long)(t0 + u) * width];
      g_n[u] = gp[(long long)(t0 + u) * width];
      h_n[u] = t0 + u > 0 ? hp[(long long)(t0 + u - 1) * width] : h_init;
    }
  }
  for (; t0 >= 0; t0 -= kBwdUnroll) {
    float av[kBwdUnroll], gv[kBwdUnroll], hv[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      av[u] = a_n[u];
      gv[u] = g_n[u];
      hv[u] = h_n[u];
    }
    const int t1 = t0 - kBwdUnroll;
    if (t1 >= 0) {
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        a_n[u] = ap[(long long)(t1 + u) * width];
        g_n[u] = gp[(long long)(t1 + u) * width];
        h_n[u] = t1 + u > 0 ? hp[(long long)(t1 + u - 1) * width] : h_init;
      }
    }
#pragma unroll
    for (int u = kBwdUnroll - 1; u >= 0; --u) {
      const int t = t0 + u;
      dh = t == steps - 1 ? gv[u] : gv[u] + a_next * dh;
      dgp[(long long)t * width] = dh;
      dap[(long long)t * width] = dh * hv[u];
      a_next = av[u];
    }
  }
  dh0[ch] = a_next * dh;
}

}  // namespace

extern "C" {

const char* lotaru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int lotaru_rglru_scan(const float* a, const float* gx, const float* h0,
                      float* h, int batch, int steps, int width,
                      cudaStream_t stream) {
  const long long channels = (long long)batch * width;
  const int blocks = (int)((channels + kThreads - 1) / kThreads);
  rglru_scan_kernel<<<blocks, kThreads, 0, stream>>>(a, gx, h0, h, batch,
                                                      steps, width);
  return static_cast<int>(cudaGetLastError());
}

// da, dgx (B, T, W) and dh0 (B, W) float32 from a, h, g (B, T, W) and h0.
int lotaru_rglru_scan_bwd(const float* a, const float* h, const float* h0,
                          const float* g, float* da, float* dgx, float* dh0,
                          int batch, int steps, int width,
                          cudaStream_t stream) {
  const long long channels = (long long)batch * width;
  const int blocks = (int)((channels + kBwdThreads - 1) / kBwdThreads);
  rglru_scan_bwd_kernel<<<blocks, kBwdThreads, 0, stream>>>(
      a, h, h0, g, da, dgx, dh0, batch, steps, width);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
