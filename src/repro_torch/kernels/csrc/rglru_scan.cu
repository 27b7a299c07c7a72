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

}  // extern "C"
