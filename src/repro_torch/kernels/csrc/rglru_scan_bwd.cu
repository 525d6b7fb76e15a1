// K4-bwd: the gradient of the RG-LRU linear recurrence, hand-written for
// Hopper (sm_90a).
//
// The TPU kernel `repro/kernels/rglru_scan.py::rglru_scan` has no backward:
// the JAX package differentiates its associative scan
// (`repro/nn/rglru.py::rglru`). The forward (`rglru_scan.cu`) is
// y_t = h_t = a_t h_{t-1} + b_t with h_{-1} = h0 (zeros if none). Given dy
// and d(h_last), the backward is the same recurrence run in reverse:
//   g_{S-1} = dy_{S-1} + dh_last,  g_t = dy_t + a_{t+1} g_{t+1}
//   db_t = g_t,  da_t = g_t h_{t-1},  dh0 = a_0 g_0
// all in fp32. h_{t-1} is the forward's fp32 y, which the autograd
// Function keeps for this (`kernels/rglru_scan.py`).
//
// Layout: a, y, dy, da and db are fp32 (B, S, W); h0, dh_last and dh0 fp32
// (B, W); h0, dh_last and dh0 may be null (zeros in, nothing out).
//
// Bound on the H100 SXM (3.35 TB/s): the bytes. a, y and dy are read once
// and da and db written once, 20 bytes a step of a lane; at RecurrentGemma's
// training call (B 4, S 256, W 2560) that is 52.4 MB, 15.6 us.
//
// Design: one thread a (b, w) lane walks t from S - 1 down to 0, the lanes
// of a warp adjacent in W, so every warp load or store is one 128-byte
// line. A thread loads T steps of a, y and dy into registers before the
// chain of FMAs that consumes them, so 3 T loads a thread are in flight.
// Simple and right first: the parallelism is B * W lanes, not S (at the
// training call 10240 threads, 160 CTAs of 64), which leaves the card's
// memory system partly idle; the chunked walk of the forward would split S
// as well.

#include <cuda_runtime.h>

namespace {

constexpr int T = 8;         // steps a thread has in registers at once
constexpr int THREADS = 64;  // lanes a CTA

__global__ void __launch_bounds__(THREADS)
rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ y,
                 const float* __restrict__ h0, const float* __restrict__ dy,
                 const float* __restrict__ dh_last, float* __restrict__ da,
                 float* __restrict__ db, float* __restrict__ dh0, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const long lane = (long)blockIdx.y * W + w;          // (b, w) in (B, W)
  const long col = (long)blockIdx.y * S * W + w;       // (b, 0, w) in (B, S, W)
  const float h_init = h0 ? h0[lane] : 0.f;
  float g = dh_last ? dh_last[lane] : 0.f;   // g_{t+1} (with a_{t+1} = 1 past the end)
  float a_next = 1.f;
  for (int t1 = S; t1 > 0; t1 -= T) {        // steps t1 - 1 down to t1 - T
    float ar[T], yr[T], dyr[T];
#pragma unroll
    for (int u = 0; u < T; ++u) {
      const int t = t1 - 1 - u;
      const long off = col + (long)t * W;
      ar[u] = t >= 0 ? __ldcs(a + off) : 1.f;
      dyr[u] = t >= 0 ? __ldcs(dy + off) : 0.f;
      yr[u] = t >= 1 ? __ldcs(y + off - W) : h_init;   // h_{t-1}
    }
#pragma unroll
    for (int u = 0; u < T; ++u) {
      const int t = t1 - 1 - u;
      if (t < 0) break;
      g = fmaf(a_next, g, dyr[u]);
      const long off = col + (long)t * W;
      __stcs(db + off, g);
      __stcs(da + off, g * yr[u]);
      a_next = ar[u];
    }
  }
  if (dh0) dh0[lane] = a_next * g;   // a_0 g_0
}

}  // namespace

// Launches on `stream` and does not synchronise; returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int rglru_scan_bwd(const void* a, const void* y, const void* h0, const void* dy,
                              const void* dh_last, void* da, void* db, void* dh0, int B, int S,
                              int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  rglru_bwd_kernel<<<dim3((W + THREADS - 1) / THREADS, B), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(y), static_cast<const float*>(h0),
      static_cast<const float*>(dy), static_cast<const float*>(dh_last), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(dh0), S, W);
  return (int)cudaGetLastError();
}
