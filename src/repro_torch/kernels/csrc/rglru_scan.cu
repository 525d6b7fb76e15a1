// K4: the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t (RecurrentGemma
// prefill), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/rglru_scan.py::rglru_scan` (body
// `_rglru_kernel`). Same function: a sequential scan over S for every
// (batch, width) lane, with the carry h in fp32. What the model needs beyond
// the Pallas kernel (`repro/nn/rglru.py::rglru`, :49-64) is added here: an
// optional initial state h0 (null means zeros) and the last state h_S out,
// which prefill hands to decode. Any S and W are accepted (the Pallas kernel
// asserted that its blocks divide them).
//
// Layout: a and b are fp32 (B, S, W); y is (B, S, W) in fp32 or bf16 (the
// model's dtype, so that the cast of h is never a separate pass); h0 and
// h_last are fp32 (B, W). Each h_t is computed in fp32 and rounded once.
//
// Bound on the H100 SXM (3.35 TB/s): the bytes. Every element of a and b is
// read once and every element of y written once; the 2 * B * S * W flops are
// nothing next to them. At the serving call (B 4, S 512, W 2560, fp32 a and
// b, bf16 y) that is 41.9 MB read and 10.5 MB written, 15.6 us (18.8 us with
// an fp32 y).
//
// Design against that bound: one thread per (b, w) lane walks S with h in
// a register; neighbouring threads hold neighbouring w, so every load and
// store is coalesced. The loads of a_t and b_t do not depend on h, so each
// thread loads U steps of both ahead of the dependent chain, keeping 2 * U
// loads in flight. At the serving call that is only B * W = 10 240 lanes
// (80 CTAs of 128 on 132 SMs), too few loads in flight to reach the
// bandwidth: a chunked two-pass scan over S (per-chunk (prod a, h) pairs,
// then a carry pass) is the next step, in a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;  // threads (lanes of W) per CTA
constexpr int U = 16;    // steps of a and b loaded ahead of the chain

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_last,
             int S, int W) {
  const int w = blockIdx.x * NT + threadIdx.x;
  if (w >= W) return;
  const long base = (long)blockIdx.y * S * W + w;
  const float* ab = a + base;
  const float* bb = b + base;
  T* yb = y + base;
  float h = h0 ? h0[(long)blockIdx.y * W + w] : 0.f;

  int t0 = 0;
  for (; t0 + U <= S; t0 += U) {
    float ar[U], br[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ar[u] = ab[(long)(t0 + u) * W];
      br[u] = bb[(long)(t0 + u) * W];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = fmaf(ar[u], h, br[u]);
      yb[(long)(t0 + u) * W] = from_f<T>(h);
    }
  }
  for (int t = t0; t < S; ++t) {  // the ragged tail, fewer than U steps
    h = fmaf(ab[(long)t * W], h, bb[(long)t * W]);
    yb[(long)t * W] = from_f<T>(h);
  }
  if (h_last) h_last[(long)blockIdx.y * W + w] = h;
}

template <typename T>
int launch(const void* a, const void* b, const void* h0, void* y, void* h_last, int B, int S,
           int W, cudaStream_t stream) {
  dim3 grid((W + NT - 1) / NT, B);
  rglru_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(h_last), S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// out_dtype: 0 float32, 1 bfloat16 (y's type; a, b, h0 and h_last are
// fp32). h0 and h_last may be null. Returns cudaGetLastError() after the
// launch (0 on success); launches on `stream` and does not synchronise.
extern "C" int rglru_scan(int out_dtype, const void* a, const void* b, const void* h0, void* y,
                          void* h_last, int B, int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return launch<float>(a, b, h0, y, h_last, B, S, W, st);
    case 1: return launch<__nv_bfloat16>(a, b, h0, y, h_last, B, S, W, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
