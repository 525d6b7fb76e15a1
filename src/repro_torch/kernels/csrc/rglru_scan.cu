// K4: the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t (RecurrentGemma
// prefill), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/rglru_scan.py::rglru_scan` (body
// `_rglru_kernel`). Same function: a scan over S for every (batch, width)
// lane, with the carry h in fp32. What the model needs beyond the Pallas
// kernel (`repro/nn/rglru.py::rglru`, :49-64) is added here: an optional
// initial state h0 (null means zeros) and the last state h_S out, which
// prefill hands to decode. Any S and W are accepted (the Pallas kernel
// asserted that its blocks divide them).
//
// Layout: a and b are fp32 (B, S, W); y is (B, S, W) in fp32 or bf16 (the
// model's dtype, so that the cast of h is never a separate pass); h0 and
// h_last are fp32 (B, W). Each h_t is computed in fp32 and rounded once.
//
// Bound on the H100 SXM (3.35 TB/s): the bytes. Every element of a and b is
// read from device memory once and every element of y written once; h0 is
// read and h_last written once; the 2 * B * S * W flops are nothing next to
// them. At the serving call (B 4, S 512, W 2560, fp32 a and b, bf16 y) that
// is 41.9 MB read and 10.5 MB written (52.5 MB), 15.7 us (18.8 us with an
// fp32 y).
//
// Design: a chunked scan over S, so that parallelism comes from S as well
// as from (B, W), and every byte still crosses the memory bus once.
// - A CTA owns a strip of LW = 32 lanes of one batch row (a warp's width:
//   each warp load of a or b is one 128-byte line, each warp store of a
//   bf16 y two whole 32-byte sectors) and walks S in tiles of NC * T = 64
//   steps. Its NC = 8 chunks of T = 8 steps split a tile, one chunk the
//   LW / 32 warps of a strip (here one), one lane a thread. At the serving
//   call that is 80 x 4 = 320 CTAs of 256 threads, all resident at once
//   (four fit an SM at 64 registers a thread), walking 8 tiles each.
// - Load first: a thread loads its chunk's T steps of a and of b into
//   registers before the first dependent FMA, and the next tile's chunk
//   before this tile's walks, so 2T to 4T loads a thread are in flight
//   while it computes.
// - Local pass: each thread walks its T steps from h = 0 and keeps the
//   chunk's pair (A = prod a, H = local h_T), which it writes to shared
//   memory.
// - Carry: after one __syncthreads, each thread folds the pairs of the
//   chunks before its own into the tile's incoming h, with (A1, H1) then
//   (A2, H2) = (A1 A2, A2 H1 + H2); folding all NC pairs gives the tile's
//   outgoing h (every thread folds in the same order, so all agree).
// - Re-walk: each thread walks its T steps again from its chunk's true
//   incoming h, reading a and b from its registers, never from device
//   memory, and writes y. Steps past S and lanes past W load as the
//   identity step (a 1, b 0) and store nothing.
// The pairs are double-buffered by tile, so one __syncthreads a tile
// suffices: a thread writes tile k + 2's pairs only after the barrier of
// tile k + 1, which every thread passes after its reads of tile k's.
// LW, T, NC and MIN_CTAS are the fastest of a sweep on the H100,
// tools/k4_plan_sweep.py: longer chunks hold more registers, and more
// chunks a tile more threads, so fewer CTAs fit an SM; shorter chunks put
// too few loads in flight; a strip of 64 lanes, whose bf16 rows leave as
// whole 128-byte lines, was 7-18% slower (half the CTAs). rglru_scan_plan
// reports the plan of a launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int LW = 32;        // lanes of W a CTA: a multiple of a warp's 32
constexpr int T = 8;          // steps a chunk (a thread's share of a tile)
constexpr int NC = 8;         // chunks a tile
constexpr int MIN_CTAS = 4;   // CTAs an SM holds: 64 registers a thread
constexpr int TILE = T * NC;
constexpr int THREADS = LW * NC;

__host__ __device__ __forceinline__ int tiles_of(int S) { return (S + TILE - 1) / TILE; }

template <typename Y> __device__ __forceinline__ Y from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// a chunk's T steps of a and b from step t of a lane's column (stride W),
// streamed past L1 (each is read once); the identity step where t + u >= S
// or the lane is past W
__device__ __forceinline__ void load_chunk(float (&ar)[T], float (&br)[T],
                                           const float* __restrict__ pa,
                                           const float* __restrict__ pb, int t, int S, int W,
                                           bool live) {
#pragma unroll
  for (int u = 0; u < T; ++u) {
    const bool in = live && t + u < S;
    const long off = (long)(t + u) * W;
    ar[u] = in ? __ldcs(pa + off) : 1.f;
    br[u] = in ? __ldcs(pb + off) : 0.f;
  }
}

template <typename Y>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
rglru_chunk_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ h0, Y* __restrict__ y,
                   float* __restrict__ h_last, int S, int W) {
  __shared__ float2 pairs[2][NC][LW];   // (prod a, local h) of each chunk, by tile parity
  const int lane = threadIdx.x % LW, c = threadIdx.x / LW;
  const int w = blockIdx.x * LW + lane;
  const bool live = w < W;
  const long col = (long)blockIdx.y * S * W + (live ? w : 0);
  const float* pa = a + col;
  const float* pb = b + col;
  Y* py = y + col;
  // the carry into the tile, the same in every chunk
  float h = (h0 && live) ? h0[(long)blockIdx.y * W + w] : 0.f;
  const int tiles = tiles_of(S);

  float ar[T], br[T];
  load_chunk(ar, br, pa, pb, c * T, S, W, live);
#pragma unroll 1
  for (int k = 0; k < tiles; ++k) {
    const int t0 = k * TILE + c * T;   // this chunk's first step
    float na[T], nb[T];                // the next tile's chunk, in flight meanwhile
    if (k + 1 < tiles) load_chunk(na, nb, pa, pb, t0 + TILE, S, W, live);
    // local pass: the chunk's pair, from h = 0
    float A = 1.f, H = 0.f;
#pragma unroll
    for (int u = 0; u < T; ++u) {
      A *= ar[u];
      H = fmaf(ar[u], H, br[u]);
    }
    float2(&pk)[NC][LW] = pairs[k & 1];
    pk[c][lane] = make_float2(A, H);
    __syncthreads();
    // carry: fold the pairs in order; the fold before chunk c is its
    // incoming h, the fold of all NC the next tile's
    float hc = h;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float2 p = pk[j][lane];
      hc = j == c ? h : hc;
      h = fmaf(p.x, h, p.y);
    }
    // re-walk from the true incoming h, a and b from registers
    if (live) {
      const int n = min(T, S - t0);
#pragma unroll
      for (int u = 0; u < T; ++u) {
        hc = fmaf(ar[u], hc, br[u]);
        if (u < n) py[(long)(t0 + u) * W] = from_f<Y>(hc);
      }
    }
    if (k + 1 < tiles) {
#pragma unroll
      for (int u = 0; u < T; ++u) {
        ar[u] = na[u];
        br[u] = nb[u];
      }
    }
  }
  if (h_last && live && c == 0) h_last[(long)blockIdx.y * W + w] = h;
}

// a CTA for each strip of LW lanes of each batch row
dim3 grid_of(int B, int W) { return dim3((W + LW - 1) / LW, B); }

template <typename Y>
int launch(const void* a, const void* b, const void* h0, void* y, void* h_last, int B, int S,
           int W, cudaStream_t stream) {
  rglru_chunk_kernel<Y><<<grid_of(B, W), THREADS, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<Y*>(y), static_cast<float*>(h_last), S, W);
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

// The plan of a launch at (B, S, W), into out[6]: lanes a strip (LW), steps
// a chunk (T), chunks a tile (NC), tiles of S, CTAs, and the CTAs an SM
// holds by the occupancy calculator (bf16 y). Returns the CUDA error code
// (0 on success).
extern "C" int rglru_scan_plan(int B, int S, int W, int* out) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rglru_chunk_kernel<__nv_bfloat16>, THREADS, 0);
  const dim3 grid = grid_of(B, W);
  const int plan[6] = {LW, T, NC, tiles_of(S), (int)(grid.x * grid.y), per_sm};
  for (int i = 0; i < 6; ++i) out[i] = plan[i];
  return (int)err;
}
