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
// Design: the reverse of K4's chunked scan (`rglru_chunk_kernel`), so that
// parallelism comes from S as well as from (B, W) and every byte still
// crosses the memory bus once.
// - A CTA owns a strip of LW = 32 lanes of one batch row and walks S in
//   tiles of NC * T = 64 steps from the end; its NC = 8 chunks of T = 8
//   steps split a tile, one warp a chunk, one lane a thread. At the
//   training call that is 80 x 4 = 320 CTAs of 256 threads, all resident
//   at once, walking 4 tiles each.
// - Load first: a thread holds its chunk's a_{t+1} and dy_t (the a range
//   shifted by one step, so chunks still read disjoint bytes; a_S is 1)
//   and y_{t-1} (h0 at t = 0) in registers, and loads the next tile's
//   chunk before this tile's walks.
// - Local pass: each thread walks its T steps down from g = 0 and keeps the
//   chunk's pair (A = prod a, G = local g at its first step), which it
//   writes to shared memory.
// - Carry: after one __syncthreads, each thread folds the pairs of the
//   chunks above its own into the tile's incoming g (from the tile above),
//   g <- A_j g + G_j for j = NC - 1 down; folding all NC gives the g that
//   enters the tile below.
// - Re-walk: each thread walks its T steps again from its chunk's true
//   incoming g, reading a, dy and y from its registers, and writes db and
//   da. Steps past S load as the identity step (a 1, dy 0) and store
//   nothing; lanes past W load the identity and store nothing.
// The pairs are double-buffered by tile, so one __syncthreads a tile
// suffices, as in K4. dh0 = a_0 g_0 reads a_0 once a lane (it lies outside
// every chunk's shifted range). rglru_scan_bwd_plan reports the plan of a
// launch.

#include <cuda_runtime.h>

namespace {

constexpr int LW = 32;        // lanes of W a CTA: a multiple of a warp's 32
constexpr int T = 8;          // steps a chunk (a thread's share of a tile)
constexpr int NC = 8;         // chunks a tile
constexpr int MIN_CTAS = 3;   // CTAs an SM holds: 85 registers a thread
constexpr int TILE = T * NC;
constexpr int THREADS = LW * NC;

__host__ __device__ __forceinline__ int tiles_of(int S) { return (S + TILE - 1) / TILE; }

// a chunk's T steps from step t of a lane's column (stride W), streamed
// past L1 (each is read once): a_{t+u+1} (1 at or past S), dy_{t+u} (0
// past S) and y_{t+u-1} (h_init before step 0; 0 past S, where nothing
// is stored); the identity step for a lane past W
__device__ __forceinline__ void load_chunk(float (&ar)[T], float (&dr)[T], float (&yr)[T],
                                           const float* __restrict__ pa,
                                           const float* __restrict__ pdy,
                                           const float* __restrict__ py, float h_init, int t,
                                           int S, int W, bool live) {
#pragma unroll
  for (int u = 0; u < T; ++u) {
    const int s = t + u;
    ar[u] = live && s + 1 < S ? __ldcs(pa + (long)(s + 1) * W) : 1.f;
    dr[u] = live && s < S ? __ldcs(pdy + (long)s * W) : 0.f;
    yr[u] = !live || s >= S ? 0.f : s == 0 ? h_init : __ldcs(py + (long)(s - 1) * W);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
rglru_bwd_chunk_kernel(const float* __restrict__ a, const float* __restrict__ y,
                       const float* __restrict__ h0, const float* __restrict__ dy,
                       const float* __restrict__ dh_last, float* __restrict__ da,
                       float* __restrict__ db, float* __restrict__ dh0, int S, int W) {
  __shared__ float2 pairs[2][NC][LW];   // (prod a, local g) of each chunk, by tile parity
  const int lane = threadIdx.x % LW, c = threadIdx.x / LW;
  const int w = blockIdx.x * LW + lane;
  const bool live = w < W;
  const long row = (long)blockIdx.y * W + (live ? w : 0);   // (b, w) in (B, W)
  const long col = (long)blockIdx.y * S * W + (live ? w : 0);
  const float* pa = a + col;
  const float* py = y + col;
  const float* pdy = dy + col;
  const float h_init = (h0 && live) ? h0[row] : 0.f;
  // the g entering the tile from above, the same in every chunk: g_S =
  // dh_last (with a_S = 1)
  float g = (dh_last && live) ? dh_last[row] : 0.f;
  const int tiles = tiles_of(S);

  float ar[T], dr[T], yr[T];
  load_chunk(ar, dr, yr, pa, pdy, py, h_init, (tiles - 1) * TILE + c * T, S, W, live);
#pragma unroll 1
  for (int k = tiles - 1; k >= 0; --k) {
    const int t0 = k * TILE + c * T;   // this chunk's first step
    float na[T], nd[T], ny[T];         // the next tile's chunk (the one below), in flight
    if (k > 0) load_chunk(na, nd, ny, pa, pdy, py, h_init, t0 - TILE, S, W, live);
    // local pass, last step first, from g = 0: the chunk's pair
    float A = 1.f, G = 0.f;
#pragma unroll
    for (int u = T - 1; u >= 0; --u) {
      A *= ar[u];
      G = fmaf(ar[u], G, dr[u]);
    }
    float2(&pk)[NC][LW] = pairs[k & 1];
    pk[c][lane] = make_float2(A, G);
    __syncthreads();
    // carry: fold the pairs from the top chunk down; the fold above chunk c
    // is its incoming g, the fold of all NC the tile below's
    float gc = g;
#pragma unroll
    for (int j = NC - 1; j >= 0; --j) {
      const float2 p = pk[j][lane];
      gc = j == c ? g : gc;
      g = fmaf(p.x, g, p.y);
    }
    // re-walk from the true incoming g, a, dy and y from registers
    if (live) {
#pragma unroll
      for (int u = T - 1; u >= 0; --u) {
        gc = fmaf(ar[u], gc, dr[u]);   // g_{t0 + u}
        if (t0 + u < S) {
          const long off = col + (long)(t0 + u) * W;
          __stcs(db + off, gc);
          __stcs(da + off, gc * yr[u]);
        }
      }
    }
    if (k > 0) {
#pragma unroll
      for (int u = 0; u < T; ++u) {
        ar[u] = na[u];
        dr[u] = nd[u];
        yr[u] = ny[u];
      }
    }
  }
  if (dh0 && live && c == 0) dh0[row] = __ldcs(pa) * g;   // a_0 g_0
}

// a CTA for each strip of LW lanes of each batch row
dim3 grid_of(int B, int W) { return dim3((W + LW - 1) / LW, B); }

}  // namespace

// Launches on `stream` and does not synchronise; returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int rglru_scan_bwd(const void* a, const void* y, const void* h0, const void* dy,
                              const void* dh_last, void* da, void* db, void* dh0, int B, int S,
                              int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  rglru_bwd_chunk_kernel<<<grid_of(B, W), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(y), static_cast<const float*>(h0),
      static_cast<const float*>(dy), static_cast<const float*>(dh_last), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(dh0), S, W);
  return (int)cudaGetLastError();
}

// The plan of a launch at (B, S, W), into out[6]: lanes a strip (LW), steps
// a chunk (T), chunks a tile (NC), tiles of S, CTAs, and the CTAs an SM
// holds by the occupancy calculator. Returns the CUDA error code (0 on
// success).
extern "C" int rglru_scan_bwd_plan(int B, int S, int W, int* out) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rglru_bwd_chunk_kernel, THREADS, 0);
  const dim3 grid = grid_of(B, W);
  const int plan[6] = {LW, T, NC, tiles_of(S), (int)(grid.x * grid.y), per_sm};
  for (int i = 0; i < 6; ++i) out[i] = plan[i];
  return (int)err;
}
