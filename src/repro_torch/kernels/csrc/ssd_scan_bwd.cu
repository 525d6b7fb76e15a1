// K3-bwd: the gradient of the Mamba2 SSD chunked scan, hand-written for
// Hopper (sm_90a), its products on the tensor cores. Three routes, chosen
// by dtype, P and N alone (`ssd_scan_bwd_route`):
// - fp32 in and out: the 3xTF32 kernels below (`ssd_scan_bwd`);
// - bf16 (x, b, c and dy in, dx, db and dc out: the training at the
//   reference's production dtypes) with P a multiple of 64 and N 64 or
//   128, K3's forward `wgmma` widths: bf16 `wgmma` on TMA-fed tiles
//   (namespace `wg`, `ssd_scan_bwd_wgmma`);
// - bf16 at other widths: the 3xTF32 kernels on bf16 operands staged as
//   fp32 (`ssd_scan_bwd_bf16`, "staged").
//
// The TPU kernel `repro/kernels/ssd_scan.py::ssd_scan` has no backward: the
// JAX package differentiates its plain chunked scan
// (`repro/nn/ssd.py::ssd_chunked`). This computes what `jax.vjp` of that
// function computes, for the forward of `ssd_scan.cu`, over chunks of the
// forward's own L = 64 steps. Per (batch, head), with cs the inclusive
// cumsum of dt a within a chunk, cs_L its last value, w_s = exp(cs_L - cs_s)
// dt_s and M[t,s] = (C_t . B_s) exp(cs_t - cs_s) dt_s for s <= t:
//   forward   y_t = sum_s M[t,s] x_s + exp(cs_t) S_{c-1} C_t
//             S_c = exp(cs_L) S_{c-1} + sum_s w_s x_s B_s^T  (S (P, N))
// Given dy and d(final state), with dS_c = dL/dS_c (the state leaving chunk
// c; d(final state) for the last):
//   dS_{c-1} = exp(cs_L) dS_c + sum_t exp(cs_t) dy_t^T C_t, dh0 = dS_{-1},
// and per chunk, with dM[t,s] = dy_t . x_s, dG = dM exp(cs_t - cs_s) dt_s
// and R = dM (C_t . B_s) exp(cs_t - cs_s), all masked to s <= t:
//   dx_s = sum_t M[t,s] dy_t + w_s dS_c B_s
//   dC_t = sum_s dG[t,s] B_s + exp(cs_t) dy_t S_{c-1}
//   dB_s = sum_t dG[t,s] C_t + w_s x_s dS_c
//   d(cs)_t = sum_s R[t,s] dt_s - dt_t sum_u R[u,t] + exp(cs_t) C_t .
//             (dy_t S_{c-1}) - dw_t w_t, dw_t = x_t . (dS_c B_t); at the
//             last step also sum_s dw_s w_s + exp(cs_L) <dS_c, S_{c-1}>
//   ddt_t = sum_u R[u,t] + dw_t exp(cs_L - cs_t) + a rc_t,
//   da = sum over chunks, steps and batch of dt_t rc_t, rc_t = sum_{u >= t} d(cs)_u.
// The decay is masked before exp (exp(cs_t - cs_s) overflows for s > t),
// and exp(cs_t - cs_s) is never split into exp(cs_t) exp(-cs_s), whose
// second factor overflows. A ragged tail (S % 64) loads as zeros (dt 0, so
// cs stays constant and the state neither decays nor updates) and stores
// nothing, as in the forward.
//
// Layouts are the forward's: x, dy, dx (B, S, H, P); dt, ddt (B, S, H);
// a, da (H,); b, c, db, dc (B, S, G, N) with G dividing H, head h in group
// h / (H / G); h0, dstate, dh0 (B, H, P, N), each may be null (zeros in,
// nothing out). fp32, or on the bf16 route x, b, c, dy, dx, db and dc
// bf16 while dt, a, h0, dstate, ddt, da and dh0 stay fp32, as the forward
// takes them.
//
// Design: the chunk-parallel split of `ssd_tf32.cuh` (Dao and Gu,
// arXiv:2405.21060, section 7), which K3's fp32 route shares; every unit
// of work is a (chunk, 64 columns p, head, batch), 1280 at the train call.
// Five launches:
// 1. `ssd_bwd_state_kernel`: each chunk's own state s_c (into `states`, and
//    cs_L into `decay`) and its share of the state's gradient ds_c (into
//    `dstates`), the two halves of one grid.
// 2. `ssd_bwd_pass_kernel`: S_{c-1} forward from h0 and dS_c backward from
//    d(final state), in place, one thread 16 elements; the backward half
//    writes dh0. The backward recomputes the states (the first halves of
//    1 and 2) rather than have the forward keep them, which would hold 42
//    MB a layer at the train call (2.7 GB over Mamba2's 64 layers) from
//    the forward to the backward and widen both wrappers' signatures.
// 3. `ssd_bwd_chunk_kernel`, one CTA of 8 warps per unit, two an SM:
//    - x and dy (64 x 64) stay in shared memory; B, C, S_{c-1} and dS_c
//      stream over N in 16-column slabs through two cp.async stages.
//    - Phase 1, over N: C B^T and B dS^T; then dy x^T. Warp w holds a
//      16 x 32 tile (rows 16 (w / 2), columns 32 (w % 2)); C B^T and dy x^T
//      skip the tiles above the diagonal. On the accumulators: M, dG and
//      R (the decay masked before exp), R's row and column sums, M and dG
//      into shared memory; dx = M^T dy + w_s B dS^T, written once, and
//      dw_s.
//    - Phase 2, over N again: warps 0-3 dC (rows t: exp(cs_t) dy S_{c-1}
//      plus dG B over s <= t) and C_t . (dy_t S_{c-1}), warps 4-7 dB (rows
//      s: w_s x dS plus dG^T C over t >= s), and <dS_c, S_{c-1}>.
//    - Warp 0: d(cs), its reverse cumsum within the chunk (lane l takes
//      steps 63 - l and 31 - l, so an inclusive shuffle scan sums each
//      step's later ones), ddt and the chunk's share of da.
//    Every product is 3xTF32 `mma.sync.m16n8k8` (`mma_tf32.cuh`), as K1 and
//    K1-bwd: each fp32 operand split into a TF32 big part (rounded to
//    nearest) and a small one (truncated), three products into fp32
//    accumulators; one TF32 product would miss the fp32 checks.
// 4-5. `ssd_bwd_reduce_bc_kernel`, `ssd_bwd_reduce_dt_kernel`: dB and dC
//    sum over a group's H / G heads and the p tiles, ddt over p tiles, da
//    over p tiles, batch and chunks, each in a fixed order from per-unit
//    partials (dB and dC (p tiles, B, S, H, N): 42 MB each at the train
//    call). No atomics: every element has one writer, so the result is the
//    same from run to run.
// Shared memory: (1) 51 KB, four CTAs an SM; (3) 94 KB, two.
//
// The staged bf16 route widens x, B, C and dy to fp32 as they are staged
// (`ssd_tf32.cuh`'s bf16 `load_tile`: exact), so every product, sum and
// workspace is the fp32 route's, and rounds dx, dB and dC to bf16 once, as
// they are stored. Its copies are plain loads and stores rather than
// cp.async (which cannot widen), so the streamed slabs no longer fly behind
// the products. Where both operands of a product come straight from bf16
// inputs (C B^T, dy x^T), their small TF32 parts are zero and one TF32
// product would do; this route still issues three (a later redesign's
// saving). Bound at the Mamba2 bf16 train call (the shapes below, x, dy,
// dx, b, c, db, dc in bf16): 33.2 MB, 9.9 us; the 9.44 GFLOP at the bf16
// rate 9.5 us: bound by the bytes. The 3xTF32 products it issues take 57.2
// us at their rate, which is the bound of this design.
//
// Bound on the H100 SXM (3.35 TB/s; 495 TFLOP/s TF32, so 165 for 3xTF32;
// 67 TFLOP/s fp32 CUDA cores) at the Mamba2 train call (B 4, S 256, H 80,
// P 64, G 1, N 128, fp32, no h0, no dstate): x, dy and dx 21.0 MB each, b,
// c, db, dc 0.5 MB each, dt and ddt 0.3 MB each: 65.6 MB, 19.6 us. The
// operations, a chunk and head: the five products over the chunk's
// triangle (C B^T and dy x^T, M^T dy, dG B and dG^T C; 2080 pairs of 64 x
// 64) and the five P x N products over its 64 steps (dS B_s, x_s dS,
// dy S_{c-1}, the dS share and the state recompute), 7.37 MFLOP; 1280
// chunk-heads make 9.44 GFLOP: 0.0572 ms at the 3xTF32 rate, 0.141 ms on
// the CUDA cores. So the card's bound is the operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <type_traits>

#include "hopper.cuh"
#include "ssd_tf32.cuh"

namespace {

using ssd::FragA;
using ssd::L;
using ssd::PT;
using ssd::XP;

constexpr int NT = 256;            // threads of the chunk kernel: 8 warps
constexpr int NW = NT / 32;
constexpr int NS = 16;             // columns n a slab of B, C, S_{c-1} and dS_c
constexpr int NJ2 = NS / 8;        // 8-column tiles a warp of phase 2
constexpr int SP = NS + 4;         // row pitch of a slab
constexpr int SLAB = L * SP;
constexpr int STAGE = 4 * SLAB;    // B, C, S_{c-1}, dS_c
// x, dy, dG; the two stages (M, after phase 1); dt, cs, w, exp(cs); R's
// row sums by column half, column sums by row block; dw by p half; the
// C . (dy S) term; the warps' <dS, S>
constexpr int SMEM_FLOATS = 3 * L * XP + 2 * STAGE + 4 * L + 2 * L + 4 * L + 2 * L + L + NW;
constexpr size_t CHUNK_SMEM = sizeof(float) * SMEM_FLOATS;

static_assert(L * XP <= 2 * STAGE, "M fits where the stages were");
static_assert(NW == 8 && L == 64 && PT == 64, "the warps' tiles cover 64 x 64");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum over the 4 lanes of an accumulator row (lanes 4 g .. 4 g + 3)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 1. kind 0 (blockIdx.z < B): s_c into states, cs_L into decay; kind 1: ds_c
// into dstates. Grid (chunks, p tiles x H, 2 B). T: the inputs' dtype.
template <typename T>
__global__ void __launch_bounds__(ssd::STATE_NT, 4)
ssd_bwd_state_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                     const T* __restrict__ dy, const T* __restrict__ cm,
                     const float* __restrict__ dt, const float* __restrict__ a,
                     float* __restrict__ states, float* __restrict__ dstates,
                     float* __restrict__ decay, int B, int S, int H, int P, int G, int N, int NC,
                     int vec) {
  const int npt = (P + PT - 1) / PT, h = blockIdx.y / npt, kind = blockIdx.z >= (unsigned)B;
  ssd::state_chunk(kind, kind ? dy : x, kind ? cm : bm, dt, a[h], kind ? dstates : states, decay,
                   blockIdx.z - kind * B, h, blockIdx.x, blockIdx.y % npt, S, H, P, G, N, NC,
                   vec);
}

// 2. kind 0: S_{c-1} from h0 (null: zeros); kind 1: dS_c from dstate (null:
// zeros), dh0 what is left (null: dropped). Grid (ssd::pass_ctas, H, 2 B).
__global__ void __launch_bounds__(ssd::PASS_NT)
ssd_bwd_pass_kernel(float* __restrict__ states, float* __restrict__ dstates,
                    const float* __restrict__ decay, const float* __restrict__ h0,
                    const float* __restrict__ dstate, float* __restrict__ dh0, int B, int H,
                    int P, int N, int NC, int vec4) {
  const int kind = blockIdx.z >= (unsigned)B;
  ssd::pass_chunks(kind, kind ? dstates : states, decay, kind ? dstate : h0,
                   kind ? dh0 : nullptr, blockIdx.z - kind * B, blockIdx.y, H, P, N, NC, vec4);
}

// 3. every gradient of one chunk and p tile, given S_{c-1} (states) and dS_c
// (dstates). Grid (chunks, p tiles x H, B). T: the dtype of x, b, c, dy
// and dx.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const T* __restrict__ bm,
                     const T* __restrict__ cm, const T* __restrict__ dy,
                     const float* __restrict__ states, const float* __restrict__ dstates,
                     T* __restrict__ dx, float* __restrict__ dbp, float* __restrict__ dcp,
                     float* __restrict__ ddtp, float* __restrict__ dap, int B, int S, int H,
                     int P, int G, int N, int NC, int vec) {
  float* sX = ssd::dyn_smem();     // [L][XP] x: steps s, columns p
  float* sDY = sX + L * XP;        // [L][XP] dy: steps t, columns p
  float* sdG = sDY + L * XP;       // [L][XP] dG[t][s]
  float* stg = sdG + L * XP;       // [2][STAGE]; M[t][s] ([L][XP]) after phase 1
  float* sdt = stg + 2 * STAGE;    // [L]
  float* scs = sdt + L;            // [L] inclusive cumsum of dt a
  float* sw = scs + L;             // [L] exp(cs_L - cs_s) dt_s
  float* secs = sw + L;            // [L] exp(cs_t)
  float* srow = secs + L;          // [2][L] sum_s R[t][s] dt_s by column half
  float* scol = srow + 2 * L;      // [4][L] sum_t R[t][s] by row block
  float* sdw = scol + 4 * L;       // [2][L] x_s . (dS B_s) by p half
  float* sint = sdw + 2 * L;       // [L] exp(cs_t) C_t . (dy_t S_{c-1})
  float* sred = sint + L;          // [NW] each warp's share of <dS, S_{c-1}>
  float* sM = stg;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int npt = (P + PT - 1) / PT;
  const int c = blockIdx.x, pt = blockIdx.y % npt, h = blockIdx.y / npt, b = blockIdx.z;
  const int grp = h / (H / G), t0 = c * L, p0 = pt * PT;
  const float A = a[h];
  const long xs = (long)H * P, xo = (long)b * S * xs + (long)h * P + p0;
  const T* bb = bm + (long)b * S * G * N + (long)grp * N;
  const T* cb = cm + (long)b * S * G * N + (long)grp * N;
  const long so = (((long)b * H + h) * NC + c) * P * N + (long)p0 * N;
  const long part = ((long)pt * B + b) * S;   // this unit's rows of the partials

  // slab k: columns 16 k .. 16 k + 15 of B, C (the chunk's steps), S_{c-1}
  // (phase 2 only) and dS_c (the tile's rows p) into stage k % 2
  auto issue = [&](int k, bool with_s) {
    float* d = stg + (k & 1) * STAGE;
    const int n0 = k * NS;
    ssd::load_tile<NT>(d, SP, bb + n0, (long)G * N, t0, L, S, NS, N - n0, vec);
    ssd::load_tile<NT>(d + SLAB, SP, cb + n0, (long)G * N, t0, L, S, NS, N - n0, vec);
    if (with_s)
      ssd::load_tile<NT>(d + 2 * SLAB, SP, states + so + n0, N, 0, PT, P - p0, NS, N - n0, vec);
    ssd::load_tile<NT>(d + 3 * SLAB, SP, dstates + so + n0, N, 0, PT, P - p0, NS, N - n0, vec);
  };
  // runs the slabs through the two stages, body(tile B, C, S, dS, n0) on
  // each: the next slab's copies fly during this one's products
  auto stream = [&](bool with_s, auto&& body) {
    const int nk = (N + NS - 1) / NS;
    issue(0, with_s);
    tf32x3::cp_async_commit();
    for (int k = 0; k < nk; ++k) {
      if (k + 1 < nk) {
        issue(k + 1, with_s);
        tf32x3::cp_async_commit();
        tf32x3::cp_async_wait<1>();
      } else {
        tf32x3::cp_async_wait<0>();
      }
      __syncthreads();
      const float* d = stg + (k & 1) * STAGE;
      body(d, d + SLAB, d + 2 * SLAB, d + 3 * SLAB, k * NS);
      __syncthreads();   // the stage is read before the next slab's copies land in it
    }
  };

  ssd::load_tile<NT>(sX, XP, x + xo, xs, t0, L, S, PT, P - p0, vec);
  ssd::load_tile<NT>(sDY, XP, dy + xo, xs, t0, L, S, PT, P - p0, vec);
  ssd::load_dt(sdt, dt + (long)b * S * H + h, t0, S, H);
  __syncthreads();
  if (warp == 0) ssd::scan_chunk(sdt, A, scs, sw, secs, lane);

  // ---- phase 1: warp w's tile, rows 16 rb .., columns 32 ch ..
  const int rb = warp / 2, ch = warp % 2;
  const bool live = ch == 0 || rb >= 2;   // some s <= t in the tile
  float gacc[4][4] = {}, uacc[4][4] = {}, macc[4][4] = {};   // C B^T, B dS^T, dy x^T
  stream(false, [&](const float* tB, const float* tC, const float*, const float* tD, int) {
#pragma unroll
    for (int kk = 0; kk < NS / 8; ++kk) {
      const FragA fb = tf32x3::load_a(tB + 16 * rb * SP + 8 * kk, SP, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tf32x3::mma3(uacc[j], fb,
                     tf32x3::load_b_nk(tD + (32 * ch + 8 * j) * SP + 8 * kk, SP, lane));
      if (live) {
        const FragA fc = tf32x3::load_a(tC + 16 * rb * SP + 8 * kk, SP, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (32 * ch + 8 * j <= 16 * rb + 15)
            tf32x3::mma3(gacc[j], fc,
                         tf32x3::load_b_nk(tB + (32 * ch + 8 * j) * SP + 8 * kk, SP, lane));
      }
    }
  });
  if (live) {
#pragma unroll 2
    for (int kk = 0; kk < PT / 8; ++kk) {
      const FragA fy = tf32x3::load_a(sDY + 16 * rb * XP + 8 * kk, XP, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (32 * ch + 8 * j <= 16 * rb + 15)
          tf32x3::mma3(macc[j], fy,
                       tf32x3::load_b_nk(sX + (32 * ch + 8 * j) * XP + 8 * kk, XP, lane));
    }
  }
  // M, dG, R's sums: element i of tile j is row t = 16 rb + g + 8 (i / 2),
  // column s = 32 ch + 8 j + 2 tq + i % 2
  {
    float rowp[2] = {0.f, 0.f}, colp[4][2] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 16 * rb + g + 8 * (i / 2), s = 32 * ch + 8 * j + 2 * tq + i % 2;
        float m = 0.f, dg = 0.f;
        if (s <= t) {   // the mask before exp
          const float e = expf(scs[t] - scs[s]), dts = sdt[s];
          const float ge = gacc[j][i] * e;
          const float r = macc[j][i] * ge;
          m = ge * dts;
          dg = macc[j][i] * e * dts;
          rowp[i / 2] = fmaf(r, dts, rowp[i / 2]);
          colp[j][i % 2] += r;
        }
        sM[t * XP + s] = m;
        sdG[t * XP + s] = dg;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float v = quad_sum(rowp[r]);
      if (tq == 0) srow[ch * L + 16 * rb + g + 8 * r] = v;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = colp[j][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) scol[rb * L + 32 * ch + 8 * j + 2 * tq + e] = v;
      }
  }
  __syncthreads();

  // dx[s][p] = sum_{t >= s} M[t][s] dy[t][p] + w_s (dS B_s)[p], and dw_s:
  // the tile of B dS^T, rows s = 16 rb + .., columns p = 32 ch + ..
  {
    float xacc[4][4] = {};
    for (int kk = 2 * rb; kk < L / 8; ++kk) {
      const FragA fm = ssd::load_a_km2(sM + 8 * kk * XP + 16 * rb, XP, g, tq);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tf32x3::mma3(xacc[j], fm, ssd::load_b_kn2(sDY + 8 * kk * XP + 32 * ch + 8 * j, XP, g, tq));
    }
    float dwp[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = 16 * rb + g + 8 * (i / 2), p = 32 * ch + 8 * j + 2 * tq + i % 2;
        dwp[i / 2] = fmaf(sX[s * XP + p], uacc[j][i], dwp[i / 2]);
        if (t0 + s < S && p0 + p < P)
          ssd::put(dx + xo + (long)(t0 + s) * xs + p, fmaf(sw[s], uacc[j][i], xacc[j][i]));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float v = quad_sum(dwp[r]);
      if (tq == 0) sdw[ch * L + 16 * rb + g + 8 * r] = v;
    }
  }
  __syncthreads();   // every read of M is done: the stages take its place

  // ---- phase 2: warps 0-3 dC (rows t = 16 r2 + ..), 4-7 dB (rows s)
  const int r2 = warp % 4;
  float ip = 0.f, intp[2] = {0.f, 0.f};
  stream(true, [&](const float* tB, const float* tC, const float* tS, const float* tD, int n0) {
    float acc[NJ2][4] = {};
    if (warp < 4) {
      // Z = dy S_{c-1} over p; C_t . Z_t; exp(cs_t) Z + sum_{s <= t} dG B
#pragma unroll 2
      for (int kk = 0; kk < PT / 8; ++kk) {
        const FragA fy = tf32x3::load_a(sDY + 16 * r2 * XP + 8 * kk, XP, lane);
#pragma unroll
        for (int j = 0; j < NJ2; ++j)
          tf32x3::mma3(acc[j], fy, tf32x3::load_b_kn(tS + 8 * kk * SP + 8 * j, SP, g, tq));
      }
#pragma unroll
      for (int j = 0; j < NJ2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 16 * r2 + g + 8 * (i / 2), n = 8 * j + 2 * tq + i % 2;
          intp[i / 2] = fmaf(tC[t * SP + n], acc[j][i], intp[i / 2]);
          acc[j][i] *= secs[t];
        }
      for (int kk = 0; kk < 2 * r2 + 2; ++kk) {
        const FragA fg = tf32x3::load_a(sdG + 16 * r2 * XP + 8 * kk, XP, lane);
#pragma unroll
        for (int j = 0; j < NJ2; ++j)
          tf32x3::mma3(acc[j], fg, tf32x3::load_b_kn(tB + 8 * kk * SP + 8 * j, SP, g, tq));
      }
#pragma unroll
      for (int j = 0; j < NJ2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 16 * r2 + g + 8 * (i / 2), n = n0 + 8 * j + 2 * tq + i % 2;
          if (t0 + t < S && n < N) dcp[((part + t0 + t) * H + h) * N + n] = acc[j][i];
        }
    } else {
      // V = x dS_c over p; w_s V + sum_{t >= s} dG^T C
#pragma unroll 2
      for (int kk = 0; kk < PT / 8; ++kk) {
        const FragA fx = tf32x3::load_a(sX + 16 * r2 * XP + 8 * kk, XP, lane);
#pragma unroll
        for (int j = 0; j < NJ2; ++j)
          tf32x3::mma3(acc[j], fx, tf32x3::load_b_kn(tD + 8 * kk * SP + 8 * j, SP, g, tq));
      }
#pragma unroll
      for (int j = 0; j < NJ2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] *= sw[16 * r2 + g + 8 * (i / 2)];
      for (int kk = 2 * r2; kk < L / 8; ++kk) {
        const FragA fg = ssd::load_a_km2(sdG + 8 * kk * XP + 16 * r2, XP, g, tq);
#pragma unroll
        for (int j = 0; j < NJ2; ++j)
          tf32x3::mma3(acc[j], fg, ssd::load_b_kn2(tC + 8 * kk * SP + 8 * j, SP, g, tq));
      }
#pragma unroll
      for (int j = 0; j < NJ2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = 16 * r2 + g + 8 * (i / 2), n = n0 + 8 * j + 2 * tq + i % 2;
          if (t0 + s < S && n < N) dbp[((part + t0 + s) * H + h) * N + n] = acc[j][i];
        }
    }
    for (int i = threadIdx.x; i < PT * NS; i += NT) {
      const int r = i / NS, col = i % NS;
      ip = fmaf(tD[r * SP + col], tS[r * SP + col], ip);
    }
  });
  if (warp < 4) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float v = quad_sum(intp[r]);
      const int t = 16 * r2 + g + 8 * r;
      if (tq == 0) sint[t] = secs[t] * v;
    }
  }
  ip = warp_sum(ip);
  if (lane == 0) sred[warp] = ip;
  __syncthreads();

  // ---- warp 0: d(cs), its reverse cumsum, ddt and the chunk's share of da.
  // Lane l takes steps 63 - l and 31 - l, so that an inclusive scan over
  // the lanes sums each step's later ones.
  if (warp == 0) {
    const float dw0 = sdw[lane] + sdw[L + lane], dw1 = sdw[lane + 32] + sdw[L + lane + 32];
    const float ww = warp_sum(dw0 * sw[lane] + dw1 * sw[lane + 32]);
    float ipt = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) ipt += sred[w];
    const float eL = secs[L - 1];
    float col[2], dwt[2], dcs[2];
    const int ts[2] = {L - 1 - lane, L / 2 - 1 - lane};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = ts[k];
      col[k] = (scol[t] + scol[L + t]) + (scol[2 * L + t] + scol[3 * L + t]);
      dwt[k] = sdw[t] + sdw[L + t];
      dcs[k] = (srow[t] + srow[L + t]) - sdt[t] * col[k] + sint[t] - dwt[k] * sw[t];
    }
    if (lane == 0) dcs[0] += ww + eL * ipt;   // step L - 1: cs_L's own terms
    float r0 = dcs[0], r1 = dcs[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u0 = __shfl_up_sync(0xffffffffu, r0, o);
      const float u1 = __shfl_up_sync(0xffffffffu, r1, o);
      if (lane >= o) {
        r0 += u0;
        r1 += u1;
      }
    }
    r1 += __shfl_sync(0xffffffffu, r0, 31);
    const float rc[2] = {r0, r1};
    float da_acc = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = ts[k];
      da_acc = fmaf(sdt[t], rc[k], da_acc);
      if (t0 + t < S)
        ddtp[(part + t0 + t) * H + h] =
            fmaf(A, rc[k], fmaf(dwt[k], expf(scs[L - 1] - scs[t]), col[k]));
    }
    da_acc = warp_sum(da_acc);
    if (lane == 0) dap[(((long)pt * B + b) * NC + c) * H + h] = da_acc;
  }
}

// 4. dB and dC (B, S, G, N) as the sums of their heads' and p tiles'
// partials (p tiles, B, S, H, N). A CTA takes RED_OUT outputs (four columns
// n each with vec, float4, else one) and RED_SPLIT threads an output, each
// summing a contiguous quarter of the group's heads over the p tiles (tile
// then head order); the quarters are then added in order.
constexpr int RED_OUT = 64, RED_SPLIT = 4;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float add4(float a, float b) { return a + b; }

template <typename V, typename T>
__device__ __forceinline__ void reduce_bc(const float* __restrict__ dbp,
                                          const float* __restrict__ dcp, T* __restrict__ db,
                                          T* __restrict__ dc, int NPT, int B, int S, int H,
                                          int G, int N) {
  __shared__ V red[2][RED_SPLIT][RED_OUT];
  constexpr int per = sizeof(V) / sizeof(float);
  const int nq = N / per, o = threadIdx.x % RED_OUT, split = threadIdx.x / RED_OUT;
  const long i = (long)blockIdx.x * RED_OUT + o;   // (b, s, g, n / per)
  const bool live = i < (long)B * S * G * nq;
  const int n = (int)(i % nq) * per, g = (int)((i / nq) % G);
  const long bs = i / ((long)nq * G);   // b S + s
  const int rep = H / G, r0 = split * rep / RED_SPLIT, r1 = (split + 1) * rep / RED_SPLIT;
  V sb{}, sc{};
  if (live)
    for (int pt = 0; pt < NPT; ++pt) {
      const long row = ((long)pt * B * S + bs) * H + (long)g * rep;
#pragma unroll 4
      for (int r = r0; r < r1; ++r) {
        sb = add4(sb, *reinterpret_cast<const V*>(dbp + (row + r) * N + n));
        sc = add4(sc, *reinterpret_cast<const V*>(dcp + (row + r) * N + n));
      }
    }
  red[0][split][o] = sb;
  red[1][split][o] = sc;
  __syncthreads();
  if (split != 0 || !live) return;
  for (int k = 1; k < RED_SPLIT; ++k) {
    sb = add4(sb, red[0][k][o]);
    sc = add4(sc, red[1][k][o]);
  }
  const long out = (bs * G + g) * N + n;
  ssd::put(db + out, sb);
  ssd::put(dc + out, sc);
}

template <typename T>
__global__ void __launch_bounds__(RED_OUT * RED_SPLIT)
ssd_bwd_reduce_bc_kernel(const float* __restrict__ dbp, const float* __restrict__ dcp,
                         T* __restrict__ db, T* __restrict__ dc, int NPT, int B, int S, int H,
                         int G, int N, int vec) {
  if (vec)
    reduce_bc<float4>(dbp, dcp, db, dc, NPT, B, S, H, G, N);
  else
    reduce_bc<float>(dbp, dcp, db, dc, NPT, B, S, H, G, N);
}

// 5. ddt (B, S, H) as the sum of the p tiles' partials; da (H,) as the sum
// of the (p tile, batch, chunk) partials: one thread an element
__global__ void __launch_bounds__(256)
ssd_bwd_reduce_dt_kernel(const float* __restrict__ ddtp, const float* __restrict__ dap,
                         float* __restrict__ ddt, float* __restrict__ da, int NPT, int B, int S,
                         int H, int NC) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  const long n1 = (long)B * S * H;
  if (i < n1) {
    float v = 0.f;
    for (int pt = 0; pt < NPT; ++pt) v += ddtp[(long)pt * n1 + i];
    ddt[i] = v;
  } else if (i < n1 + H) {
    const int h = (int)(i - n1);
    float v = 0.f;
    for (long k = 0; k < (long)NPT * B * NC; ++k) v += dap[k * H + h];
    da[h] = v;
  }
}

// The five launches on `stream` for inputs of dtype T (float, or bf16 for
// x, b, c, dy, dx, db and dc); no synchronisation.
template <typename T>
int run(const void* x, const void* dt, const void* a, const void* b, const void* c,
        const void* h0, const void* dy, const void* dstate, void* dx, void* ddt, void* da,
        void* db, void* dc, void* dh0, void* states, void* dstates, void* decay, void* dbp,
        void* dcp, void* ddtp, void* dap, int B, int S, int H, int P, int G, int N,
        cudaStream_t st) {
  const int NPT = (P + PT - 1) / PT, NC = (S + L - 1) / L;
  static std::atomic<unsigned long long> opted_state{0}, opted_chunk{0};
  cudaError_t err = hopper::opt_in_smem((const void*)ssd_bwd_state_kernel<T>,
                                        (int)ssd::STATE_SMEM, opted_state);
  if (err == cudaSuccess)
    err = hopper::opt_in_smem((const void*)ssd_bwd_chunk_kernel<T>, (int)CHUNK_SMEM, opted_chunk);
  if (err != cudaSuccess) return (int)err;
  // 16-byte staging of x, dy, b, c (4 fp32 or 8 bf16 values) and of the
  // fp32 states
  const int vec = ssd::vec_ok(P, N, {x, dy, b, c, states, dstates}, 16 / (int)sizeof(T));
  const T* xf = static_cast<const T*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const T* bf = static_cast<const T*>(b);
  const T* cf = static_cast<const T*>(c);
  const T* dyf = static_cast<const T*>(dy);
  float* sf = static_cast<float*>(states);
  float* dsf = static_cast<float*>(dstates);
  float* decf = static_cast<float*>(decay);

  ssd_bwd_state_kernel<T><<<dim3(NC, NPT * H, 2 * B), ssd::STATE_NT, ssd::STATE_SMEM, st>>>(
      xf, bf, dyf, cf, dtf, af, sf, dsf, decf, B, S, H, P, G, N, NC, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool vec4 = (long)P * N % 4 == 0 &&
                    ssd::aligned16({states, dstates, h0, dstate, dh0});
  ssd_bwd_pass_kernel<<<dim3(ssd::pass_ctas(P, N, vec4), H, 2 * B), ssd::PASS_NT, 0, st>>>(
      sf, dsf, decf, static_cast<const float*>(h0), static_cast<const float*>(dstate),
      static_cast<float*>(dh0), B, H, P, N, NC, vec4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk_kernel<T><<<dim3(NC, NPT * H, B), NT, CHUNK_SMEM, st>>>(
      xf, dtf, af, bf, cf, dyf, sf, dsf, static_cast<T*>(dx), static_cast<float*>(dbp),
      static_cast<float*>(dcp), static_cast<float*>(ddtp), static_cast<float*>(dap), B, S, H, P,
      G, N, NC, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int bc_vec4 = N % 4 == 0 && ssd::aligned16({dbp, dcp, db, dc});
  const long n_bc = (long)B * S * G * (bc_vec4 ? N / 4 : N);
  ssd_bwd_reduce_bc_kernel<T><<<(unsigned)((n_bc + RED_OUT - 1) / RED_OUT),
                                RED_OUT * RED_SPLIT, 0, st>>>(
      static_cast<const float*>(dbp), static_cast<const float*>(dcp), static_cast<T*>(db),
      static_cast<T*>(dc), NPT, B, S, H, G, N, bc_vec4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n_dt = (long)B * S * H + H;
  ssd_bwd_reduce_dt_kernel<<<(unsigned)((n_dt + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ddtp), static_cast<const float*>(dap), static_cast<float*>(ddt),
      static_cast<float*>(da), NPT, B, S, H, NC);
  return (int)cudaGetLastError();
}

bool valid(int B, int S, int H, int P, int G, int N, const void* h0, const void* dh0) {
  const int NPT = (P + PT - 1) / PT;
  return B > 0 && S > 0 && H > 0 && P > 0 && G > 0 && H % G == 0 && N > 0 && N <= ssd::NMAX &&
         2 * B <= 65535 && NPT * H <= 65535 && (h0 == nullptr) == (dh0 == nullptr);
}

// The shared memory and CTAs an SM of the route's kernel `kernel` (0 state,
// 1 pass, 2 chunk, 3 dB/dC reduce, 4 ddt/da reduce) on the current device.
template <typename T>
int occupancy(int kernel, int* smem, int* ctas_per_sm) {
  static std::atomic<unsigned long long> opted_state{0}, opted_chunk{0};
  const void* fn[5] = {(const void*)ssd_bwd_state_kernel<T>, (const void*)ssd_bwd_pass_kernel,
                       (const void*)ssd_bwd_chunk_kernel<T>,
                       (const void*)ssd_bwd_reduce_bc_kernel<T>,
                       (const void*)ssd_bwd_reduce_dt_kernel};
  const int threads[5] = {ssd::STATE_NT, ssd::PASS_NT, NT, RED_OUT * RED_SPLIT, 256};
  const int bytes[5] = {(int)ssd::STATE_SMEM, 0, (int)CHUNK_SMEM, 0, 0};
  if (kernel < 0 || kernel > 4) return (int)cudaErrorInvalidValue;
  cudaError_t err = hopper::opt_in_smem(fn[0], bytes[0], opted_state);
  if (err == cudaSuccess) err = hopper::opt_in_smem(fn[2], bytes[2], opted_chunk);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, fn[kernel], threads[kernel],
                                                        bytes[kernel]);
  *smem = bytes[kernel];
  return (int)err;
}

// ---- the wgmma route (bf16, P a multiple of 64, N 64 or 128) ---------------
//
// What the two routes above compute, for bf16 x, B, C and dy, with every
// product on bf16 `wgmma` (fp32 accumulators) fed by TMA. Operands that are
// bf16 inputs enter as they are (C B^T and dy x^T are exact); every fp32
// operand (v = w x and exp(cs) dy in the state walks, S_{c-1} and dS_c, M
// and dG) enters as HALVES bf16 parts, hi = bf16(v) and lo = bf16(v - hi),
// one wgmma a part into the same accumulator, as K3's forward carries its
// state (`ssd_scan.cu`): each such operand to 2^-17 of itself, where one
// part (2^-9) would miss the fp32 checks the plain version holds it to.
//
// Kernels launched by one C call:
// 1. `ssd_bwd_wgmma_state_kernel<N>`: one warpgroup per (64 columns p, head,
//    batch, direction) walks the chunks with the state in registers, as K3's
//    forward state path does (`ssd_wgmma_kernel`): forward from h0, writing
//    S_{c-1} before chunk c's update S <- exp(cs_L) S + v^T B (v = w x), or
//    backward from d(final state), writing dS_c before dS <- exp(cs_L) dS +
//    v^T C (v = exp(cs) dy), dh0 what is left. v is formed from the x or dy
//    tile by ldmatrix.trans and split hi + lo; B or C is the MN-major
//    operand. Each state leaves as two bf16 planes (hi, lo: the bytes of
//    fp32) through a 128B-swizzled tile and a TMA store, into the workspace
//    (2, B, H, chunks, HALVES, P, N), which the chunk kernel reads by TMA
//    as operands, with no split of its own. The walk replaces the fp32
//    route's state kernel and its in-place passing.
// 2. `ssd_bwd_wgmma_chunk_kernel<N, ONE_P>`: one CTA of two warpgroups per
//    (slice of a group's heads, chunk, batch, group). B and C of the chunk
//    are loaded once; the CTA walks its heads in order, and for each its
//    64-column p tiles, through two TMA stages of x, dy and the planes of
//    S_{c-1} and dS_c (P 64, ONE_P: a stage a head; P > 64: first each p
//    tile's x and dy for the scores, then each p tile in full). The
//    warpgroups split the work by the rows of their products:
//    - warpgroup 1, rows t: dy x^T and C B^T; on their accumulators the
//      decay e = exp(cs_t - cs_s) (selected to 0 where s > t before it
//      meets any other factor), dG = dM e dt_s packed hi + lo in registers,
//      M = G e dt_s split hi + lo into two 64 x 64 bf16 tiles in shared
//      memory for warpgroup 0, R = dM G e summed both ways; dC += dG B +
//      exp(cs_t) Z, Z = dy S_{c-1} (B and the planes MN-major), dC held in
//      fp32 registers over the slice's heads; C_t . Z_t; <dS_c, S_{c-1}>
//      over the planes; it issues every load, and its warp 0 forms each
//      head's d(cs), its reverse cumsum, ddt (written once) and the chunk's
//      share of da from the sums both warpgroups hand over through shared
//      memory.
//    - warpgroup 0, rows s: x dy^T (transposed, so that dG^T lands in the
//      accumulator in the layout of wgmma's register A), dG^T packed; dB +=
//      dG^T C + w (x dS), held like dC; U = B dS^T, dw_s = x_s . U_s, and dx
//      = w U + M^T dy, M^T the MN-major A operand from warpgroup 1's tiles,
//      written once in bf16.
//    Where S_{c-1} or dS_c is zeros (chunk 0 without h0, the last chunk
//    without d(final state)) its planes are neither written nor loaded: the
//    products run on the stage's stale bytes and their results are
//    selected to zero (no branch between a wgmma and its wait, which would
//    make ptxas serialise the kernel's wgmmas).
//    The heads of a slice sum into dB and dC in order, so no head's dB or
//    dC leaves the CTA: the partials are (slices, B, S, G, N), not (p
//    tiles, B, S, H, N).
// 3. `ssd_bwd_wgmma_reduce_kernel`: dB and dC as the sums of the slices'
//    partials, in order, rounded to bf16 once; da as the sum of the
//    (batch, chunk) shares. No atomics anywhere, so two calls give the
//    same bits.
// Slices: the caller's (`ssd_scan.bwd_slices`): as many as keep the chunk
// CTAs (B x chunks x G x slices, one an SM: 213 KB of shared memory at N
// 128 and 254 registers a thread) within one wave, each CTA summing the
// heads that leaves it. At the Mamba2 train call (B 4, S 256, H 80, G 1,
// P 64, N 128) that is 8 slices of 10 heads, 128 CTAs; partials 4.2 MB
// each.
// Bytes at the train call: the planes 63 MB written and read once (of 84
// MB: a quarter are zeros), x and dy read twice (the state walk and the
// chunk kernel, 42 MB each), dx written, B and C from L2: about 260 MB,
// 0.08 ms at 3.35 TB/s, against the function's 33.2 MB (its bound, 9.9
// us). The state walk runs at that rate for its bytes; the chunk kernel's
// own bound is 0.04 ms, and its chain of products, splits and hand-overs
// a head keeps it near twice that (`tools/k3_bwd_variants.py`).

namespace wg {

using bf16 = __nv_bfloat16;

constexpr int WG = 128;        // threads of a warpgroup
constexpr int STAGES = 2;      // tiles in flight
constexpr int HALVES = 2;      // bf16 parts of an fp32 operand
constexpr int SLAB = L * 128;  // 64 rows of 64 bf16, one 128-byte swizzle atom wide
constexpr float LOG2E = 1.4426950408889634f;
// named barriers (0 is __syncthreads): each warpgroup of the chunk CTA is
// done with a stage; both have handed over a head's sums; warpgroup 1 has
// written the head's M tiles
constexpr int BAR_A = 1, BAR_B = 2, BAR_ALL = 3, BAR_M_READY = 4;
// the per-step sums each head's two warpgroups hand over: dw_s (warpgroup
// 0); sum_t R[t][s] by warp, sum_s R[t][s] dt_s, exp(cs_t) C_t . Z_t and
// the warps' <dS, S> (warpgroup 1); two sets, by the head's parity
constexpr int X_COL = 0, X_DW = 4 * L, X_ROW = 5 * L, X_CZ = 6 * L, X_IP = 7 * L;
constexpr int X_SET = 7 * L + 8;

static_assert(L == 64 && PT == 64, "a chunk and a p tile are one wgmma m64 tile each");

template <int N>
struct Cfg {
  static constexpr int NS = N / 64;                 // 64-wide slabs of a row of N
  static constexpr int NT = NS * SLAB;              // a 64-row tile of N columns
  // the state walk: x or dy and B or C a stage, the outgoing planes
  static constexpr int W_STAGE = SLAB + NT;
  static constexpr int W_SMEM = 1024 + STAGES * W_STAGE + HALVES * NT + 8 * STAGES;
  // the chunk CTA: B, C; a stage is x, dy, S_{c-1} hi, lo, dS_c hi, lo;
  // then M's tiles, hi and lo, the handed-over sums and the barriers
  static constexpr int C_STAGE = 2 * SLAB + 2 * HALVES * NT;
  static constexpr int C_SMEM =
      1024 + 2 * NT + STAGES * C_STAGE + HALVES * SLAB + 2 * X_SET * 4 + 8 * (1 + 2 * STAGES);
  static_assert(C_SMEM <= 232448, "over the SM's shared memory");
};

// Byte offset of element (row r, column c) in a 128B-swizzled slab: the
// 16-byte chunk c / 8 of row r sits at chunk (c / 8) ^ (r % 8).
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
}

__device__ __forceinline__ void st_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ float2 ld_bf16x2(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// The fp32 pair (v0, v1) as HALVES bf16 pairs, largest first: what is left
// after k parts is below 2^(-9 k) of the pair's values.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t (&out)[HALVES]) {
#pragma unroll
  for (int k = 0; k < HALVES; ++k) {
    const __nv_bfloat162 part = __floats2bfloat162_rn(v0, v1);
    out[k] = *reinterpret_cast<const uint32_t*>(&part);
    v0 -= __low2float(part);
    v1 -= __high2float(part);
  }
}

// Stores of accumulator values where `ok`, as predicated stores: a branch
// around them would put reads of wgmma's accumulators on a divergent path,
// and ptxas then serialises every wgmma of the kernel.
__device__ __forceinline__ void st_bf16x2_if(bf16* p, float v0, float v1, bool ok) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t@q st.global.b32 [%0], %1;\n\t}" ::"l"(p),
      "r"(hopper::pack_bf16(v0, v1)), "r"((int)ok)
      : "memory");
}
__device__ __forceinline__ void st_f32x2_if(float* p, float v0, float v1, bool ok) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\t@q st.global.v2.f32 [%0], {%1, %2};\n\t}" ::"l"(p),
      "f"(v0), "f"(v1), "r"((int)ok)
      : "memory");
}

// Inclusive scan over the warp of the chunk's dt a (in log2 units), lane l
// holding steps l (v0) and l + 32 (v1); returns cs at the chunk's end.
__device__ __forceinline__ float scan_chunk(float& v0, float& v1, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u0 = __shfl_up_sync(0xffffffffu, v0, o);
    const float u1 = __shfl_up_sync(0xffffffffu, v1, o);
    if (lane >= o) {
      v0 += u0;
      v1 += u1;
    }
  }
  v1 += __shfl_sync(0xffffffffu, v0, 31);
  return __shfl_sync(0xffffffffu, v1, 31);
}

// 2^x to the hardware's approximation (relative error below 2^-22)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Step s of the chunk from a pair held as (steps lane, lane + 32); whether
// s < 32 must be the same across the warp.
__device__ __forceinline__ float at_step(float lo, float hi, int s) {
  return __shfl_sync(0xffffffffu, s < 32 ? lo : hi, s & 31);
}

// A chunk's dt at steps lane and lane + 32 of head h (0 past S)
__device__ __forceinline__ void dt_of(const float* __restrict__ dtb, int t0, int S, int H, int h,
                                      int lane, float& d0, float& d1) {
  const int t = t0 + lane;
  d0 = t < S ? dtb[(long)t * H + h] : 0.f;
  d1 = t + 32 < S ? dtb[(long)(t + 32) * H + h] : 0.f;
}

// The (64 x N) accumulator fragment st (register i: row r0 + 8 ((i / 2) %
// 2), column 8 (i / 4) + c0 + i % 2) as its HALVES bf16 planes, each N / 64
// 128B-swizzled slabs, plane k at tile + k N / 64 slabs.
template <int N>
__device__ __forceinline__ void store_planes(uint32_t tile, const float (&st)[N / 2], int r0,
                                             int c0) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const uint32_t slab = tile + (j / 8) * SLAB;
    const int col = 8 * (j % 8) + c0;
    uint32_t a[HALVES], b[HALVES];
    split_bf16(st[4 * j], st[4 * j + 1], a);
    split_bf16(st[4 * j + 2], st[4 * j + 3], b);
#pragma unroll
    for (int k = 0; k < HALVES; ++k) {
      st_b32(slab + k * Cfg<N>::NT + sw128(r0, col), a[k]);
      st_b32(slab + k * Cfg<N>::NT + sw128(r0 + 8, col), b[k]);
    }
  }
}

// The descriptor of the 128B-swizzled tile at shared address `addr`, with
// `addr` passed through an empty asm: the compiler can neither hoist it out
// of the loops nor compute a product's descriptors all ahead of its first
// wgmma (either holds dozens of registers through the kernel). Adding byte
// offset / 16 to it steps the start address (below 256 KB, no carry).
__device__ __forceinline__ uint64_t fresh_desc(uint32_t addr, uint32_t lbo) {
  asm volatile("" : "+r"(addr));
  return hopper::desc_sw128(addr, lbo, 1024);
}

// acc (64 x 64) (+)= X (64 x K) . Y^T for 64-row tiles X and Y at shared
// addresses x and y, both K-major (K = ks values): ks / 16 k-steps, four a
// slab, 32 bytes apart; issued, not waited for
__device__ __forceinline__ void kmajor(float (&acc)[32], uint32_t x, uint32_t y, int ks,
                                       bool accumulate) {
#pragma unroll
  for (int j = 0; j < ks / 16; ++j) {
    const uint32_t off = (j / 4) * SLAB + (j % 4) * 32;
    hopper::wgmma_m64n64k16_ss(acc, fresh_desc(x + off, 16), fresh_desc(y + off, 16),
                               accumulate || j > 0);
  }
}

// acc (64 x N) += A (64 x 64: four k16 blocks, HALVES parts, of bf16 pairs
// in registers) . B (64 rows x N, MN-major from the slabs of a 64-row tile
// at shared address b); issued, not waited for
template <int N>
__device__ __forceinline__ void wide(float (&acc)[N / 2], const uint32_t (&a)[HALVES][4][4],
                                     uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = fresh_desc(b + kk * 16 * 128, SLAB);
#pragma unroll
    for (int hv = 0; hv < HALVES; ++hv) {
      if constexpr (N == 128)
        hopper::wgmma_m64n128k16_rs_tb(acc, a[hv][kk], db);
      else
        hopper::wgmma_m64n64k16_rs_tb(acc, a[hv][kk], db);
    }
  }
}

// acc (64 x 64) = X (64 x 64 p, K-major at x) . (plane hi + plane lo)
// (64 p x 64 columns n, MN-major: the 64-wide slab at `plane` and its lo
// plane `lo` bytes on); issued, not waited for
__device__ __forceinline__ void by_planes(float (&acc)[32], uint32_t x, uint32_t plane,
                                          uint32_t lo) {
#pragma unroll
  for (int hv = 0; hv < HALVES; ++hv)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_m64n64k16_ss_tb(acc, fresh_desc(x + kk * 32, 16),
                                    fresh_desc(plane + hv * lo + kk * 16 * 128, SLAB),
                                    hv > 0 || kk > 0);
}

// 1. The state walk. Grid (P / 64, H, 2 B); kind 0 (blockIdx.z < B) the
// states S_{c-1} from h0 (null: zeros), kind 1 the gradients dS_c from
// dstate (null: zeros), dh0 what is left (null: not formed). ws: the
// planes (2, B, H, chunks, HALVES, P, N) through the map tws.
template <int N>
__global__ void __launch_bounds__(WG, 2)
ssd_bwd_wgmma_state_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tdy,
                           const __grid_constant__ CUtensorMap tb,
                           const __grid_constant__ CUtensorMap tcm,
                           const __grid_constant__ CUtensorMap tws, const float* __restrict__ dt,
                           const float* __restrict__ a, const float* __restrict__ h0,
                           const float* __restrict__ dstate, float* __restrict__ dh0, int B,
                           int S, int H, int P, int G, int NC) {
  using C = Cfg<N>;
  constexpr int NS = C::NS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;   // the stages
  const uint32_t sout = base + STAGES * C::W_STAGE;                      // the planes out
  const uint32_t full0 = sout + HALVES * C::NT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p0 = blockIdx.x * PT, h = blockIdx.y;
  const int kind = blockIdx.z >= (unsigned)B, b = blockIdx.z - kind * B;
  const int g = h / (H / G);
  const float A2 = a[h] * LOG2E;   // cs in log2 units: exp(x) = exp2(x log2 e)
  const float* dtb = dt + (long)b * S * H;
  const CUtensorMap* tv = kind ? &tdy : &tx;   // v's source: x or dy
  const CUtensorMap* tu = kind ? &tcm : &tb;   // the other operand: B or C
  float* fin = kind ? dh0 : nullptr;
  // updates: every chunk's but the last forward; backward the last only
  // for dh0
  const int nupd = NC - 1 + (fin != nullptr);
  auto chunk_of = [&](int k) { return kind ? NC - 1 - k : k; };

  auto load = [&](int k) {   // chunk k of the walk into stage k % STAGES
    const int c = chunk_of(k);
    const uint32_t sv = base + (k % STAGES) * C::W_STAGE, su = sv + SLAB,
                   bar = full0 + 8 * (k % STAGES);
    hopper::mbar_arrive_expect_tx(bar, C::W_STAGE);
    hopper::tma_load_4d(sv, tv, bar, p0, h, c * L, b);
#pragma unroll
    for (int s = 0; s < NS; ++s) hopper::tma_load_4d(su + s * SLAB, tu, bar, 64 * s, g, c * L, b);
  };

  if (tid == 0) {
    hopper::prefetch_tensormap(tv);
    hopper::prefetch_tensormap(tu);
    hopper::prefetch_tensormap(&tws);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(full0 + 8 * s, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 0; k < STAGES && k < nupd; ++k) load(k);

  // The state, rows p0 + r0 / r1, columns n = 8 j + c0 (+1): the update's
  // accumulator, one m64nNk16 fragment.
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8, c0 = 2 * (lane % 4);
  const float* init = kind ? dstate : h0;
  const long so = ((long)b * H + h) * P * N;
  float st[N / 2];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int n = 8 * j + c0;
    float2 u = make_float2(0.f, 0.f), v = make_float2(0.f, 0.f);
    if (init != nullptr) {
      u = *reinterpret_cast<const float2*>(init + so + (long)(p0 + r0) * N + n);
      v = *reinterpret_cast<const float2*>(init + so + (long)(p0 + r1) * N + n);
    }
    st[4 * j] = u.x;
    st[4 * j + 1] = u.y;
    st[4 * j + 2] = v.x;
    st[4 * j + 3] = v.y;
  }

  float dn0 = 0.f, dn1 = 0.f;   // dt of the next update's chunk
  if (nupd > 0) dt_of(dtb, chunk_of(0) * L, S, H, h, lane, dn0, dn1);
  for (int k = 0; k < NC; ++k) {
    const int c = chunk_of(k);
    // the state entering chunk c (forward) or leaving it (backward), as
    // its planes, once the last chunk's have left the tile; not the first
    // state when it is zeros (no h0, or no d(final state)): the chunk
    // kernel reads no planes for it
    const bool zero = k == 0 && init == nullptr;
    if (tid == 0) hopper::bulk_wait_read<0>();
    __syncthreads();
    if (!zero) store_planes<N>(sout, st, r0, c0);
    hopper::fence_proxy_async();
    __syncthreads();
    if (tid == 0 && !zero) {
      const int row = ((((kind * B + b) * H + h) * NC + c) * HALVES) * P + p0;
#pragma unroll
      for (int hv = 0; hv < HALVES; ++hv)
#pragma unroll
        for (int s = 0; s < NS; ++s)
          hopper::tma_store_4d(&tws, sout + (hv * NS + s) * SLAB, 64 * s, 0, row + hv * P, 0);
      hopper::bulk_commit();
    }
    if (k >= nupd) break;

    const uint32_t sv = base + (k % STAGES) * C::W_STAGE, su = sv + SLAB;
    const float d0 = dn0, d1 = dn1;
    if (k + 1 < nupd) dt_of(dtb, chunk_of(k + 1) * L, S, H, h, lane, dn0, dn1);
    float v0 = d0 * A2, v1 = d1 * A2;
    const float csL = scan_chunk(v0, v1, lane);
    // the steps' weights: w_s = exp(cs_L - cs_s) dt_s, or exp(cs_t)
    const float w0 = kind ? exp2f(v0) : exp2f(csL - v0) * d0;
    const float w1 = kind ? exp2f(v1) : exp2f(csL - v1) * d1;
    hopper::mbar_wait(full0 + 8 * (k % STAGES), (k / STAGES) & 1);
    const float eL = exp2f(csL);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) st[i] *= eL;

    // st += v^T U, v[s][p] = w_s x[s][p] (or dy), in two passes of 32 steps
    // s: v in HALVES bf16 parts, the A operand (rows p, k = s), from the
    // tile's transpose as four 8x8 matrices a k16 block, register q of
    // block kk holding columns s = 16 kk + 8 (q / 2) + c0 (+1); U the
    // MN-major operand; one wgmma a part and k16 block
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      uint32_t vf[HALVES][2][4];
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const int kk = 2 * pass + k2;
        uint32_t xt[4];
        const int m = lane / 8;
        hopper::ldmatrix_x4_trans(
            xt, sv + sw128(16 * kk + 8 * (m / 2) + lane % 8, 16 * warp + 8 * (m % 2)));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int s = 16 * kk + 8 * (q / 2) + c0;
          uint32_t parts[HALVES];
          split_bf16(at_step(w0, w1, s) * __uint_as_float(xt[q] << 16),
                     at_step(w0, w1, s + 1) * __uint_as_float(xt[q] & 0xffff0000u), parts);
#pragma unroll
          for (int hv = 0; hv < HALVES; ++hv) vf[hv][k2][q] = parts[hv];
        }
      }
      hopper::reg_fence(st);
      hopper::wgmma_fence();
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
        for (int hv = 0; hv < HALVES; ++hv) {
          const uint64_t du = hopper::desc_sw128(su + (2 * pass + k2) * 16 * 128, SLAB, 1024);
          if constexpr (N == 128)
            hopper::wgmma_m64n128k16_rs_tb(st, vf[hv][k2], du);
          else
            hopper::wgmma_m64n64k16_rs_tb(st, vf[hv][k2], du);
        }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(st);
    }
    __syncthreads();   // every warp is done with the stage: refill it
    if (tid == 0 && k + STAGES < nupd) load(k + STAGES);
  }

  if (fin != nullptr) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int n = 8 * j + c0;
      *reinterpret_cast<float2*>(fin + so + (long)(p0 + r0) * N + n) =
          make_float2(st[4 * j], st[4 * j + 1]);
      *reinterpret_cast<float2*>(fin + so + (long)(p0 + r1) * N + n) =
          make_float2(st[4 * j + 2], st[4 * j + 3]);
    }
  }
  if (tid == 0) hopper::bulk_wait<0>();
}

// What both warpgroups of a chunk CTA walk: its tiles in shared memory and
// their barriers, its slice of heads and the steps that bring their tiles.
struct Walk {
  const CUtensorMap *tx, *tdy, *tws;
  unsigned char* smem;                    // the dynamic shared memory, at shared address raw
  uint32_t raw, sb, sc, ring, full0, empty0;   // B, C, the stages, their barriers
  uint32_t sm;                            // a head's M (rows t, columns s), hi then lo
  float* xf;                              // the two sets of handed-over sums
  const float* dtb;                       // dt of this batch row, (S, H)
  const float* a;
  bf16* dx;
  float* ddt;
  float* dap;
  int B, S, H, P, NC, b, c, t0, h_begin, h_end, npt, sph, nsteps;
  bool s_zero, ds_zero;
  // S_{c-1} is zeros (chunk 0 without h0), dS_c is zeros (the last chunk
  // without d(final state)): their planes were never written, are not
  // loaded, and the products with them are taken as zeros

  // step i: head h_begin + i / sph, its p tile, and whether it brings x and
  // dy for dy x^T (dm), the planes for the rest (main), or both (P 64)
  __device__ __forceinline__ void decode(int i, int& pt, bool& dm, bool& main_) const {
    const int j = i % sph;
    dm = npt == 1 || j < npt;
    main_ = npt == 1 || j >= npt;
    pt = j < npt ? j : j - npt;
  }

  // step i's tiles into stage i % STAGES, by TMA
  template <int N>
  __device__ __forceinline__ void issue(int i) const {
    constexpr int NS = N / 64, NT = Cfg<N>::NT;
    int pt;
    bool dm, main_;
    decode(i, pt, dm, main_);
    const int hh = h_begin + i / sph;
    const uint32_t st = ring + (i % STAGES) * Cfg<N>::C_STAGE, bar = full0 + 8 * (i % STAGES);
    const int kinds = main_ ? 2 - s_zero - ds_zero : 0;   // plane pairs loaded
    hopper::mbar_arrive_expect_tx(bar, 2 * SLAB + kinds * HALVES * NT);
    hopper::tma_load_4d(st, tx, bar, PT * pt, hh, t0, b);
    hopper::tma_load_4d(st + SLAB, tdy, bar, PT * pt, hh, t0, b);
    if (main_)
#pragma unroll
      for (int kind = 0; kind < 2; ++kind)
#pragma unroll
        for (int hv = 0; hv < HALVES; ++hv) {
          if (kind == 0 ? s_zero : ds_zero) continue;
          const int row = ((((kind * B + b) * H + hh) * NC + c) * HALVES + hv) * P + PT * pt;
#pragma unroll
          for (int s = 0; s < NS; ++s)
            hopper::tma_load_4d(st + 2 * SLAB + (kind * HALVES + hv) * NT + s * SLAB, tws, bar,
                                64 * s, 0, row, 0);
        }
  }
};

// Keeps registers that an issued wgmma reads (its A operand) allocated
// until after the wait for it, so that the compiler does not give them to
// values computed meanwhile.
__device__ __forceinline__ void keep(uint32_t (&r)[HALVES][4][4]) {
#pragma unroll
  for (int hv = 0; hv < HALVES; ++hv)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(r[hv][kk][q])::"memory");
}

// One warpgroup's walk over the slice's heads (the roles: the kernel's
// note above). S_ROWS (warpgroup 0): x dy^T, dG^T, U = B dS^T, dx and dB;
// else (warpgroup 1): dy x^T and C B^T, dG, the M tiles, Z = dy S_{c-1}, dC
// and <dS, S>. acc: dB or dC of the slice's heads, rows t0 + r0 / r1.
// ONE_P (P 64): every step is a head in full. Else a head's steps are its p
// tiles' x and dy for the scores (DM), then its first p tile with the
// scores' use (FIRST), then the other p tiles (REST). Each kind of step is
// its own code, its wgmmas issued and waited for inside it: ptxas
// serialises every wgmma of a kernel where a branch at run time separates
// a wgmma from its wait. The register budget (255 a thread, every one in
// use) sets how little of a step's work can overlap: moving a product
// beside the CUDA cores' work, as tried, spilled and lost more than it hid.
constexpr int K_DM = 1, K_FIRST = 2, K_PLANES = 4;   // what a step does
constexpr int K_FULL = K_DM | K_FIRST | K_PLANES, K_REST = K_PLANES;

template <int N, bool S_ROWS, bool ONE_P>
__device__ __forceinline__ void chunk_walk(const Walk& w, float (&acc)[N / 2], int wt) {
  constexpr int NS = N / 64, NT = Cfg<N>::NT;
  const int warp = wt / 32, lane = wt % 32;
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8, c0 = 2 * (lane % 4);
  float dn0 = 0.f, dn1 = 0.f;   // dt of the next head
  if (w.nsteps > 0) dt_of(w.dtb, w.t0, w.S, w.H, w.h_begin, lane, dn0, dn1);
  int i = 0;
  for (int hh = w.h_begin; hh < w.h_end; ++hh) {
    float* X = w.xf + ((hh - w.h_begin) & 1) * X_SET;
    const float d0 = dn0, d1 = dn1;
    if (hh + 1 < w.h_end) dt_of(w.dtb, w.t0, w.S, w.H, hh + 1, lane, dn0, dn1);
    const float A = w.a[hh], A2 = A * LOG2E;
    float v0 = d0 * A2, v1 = d1 * A2;   // cs in log2 units
    const float csL = scan_chunk(v0, v1, lane);
    // this thread's rows: cs, dt, and w_s (rows s) or exp(cs_t) (rows t)
    const float cs_r[2] = {at_step(v0, v1, r0), at_step(v0, v1, r1)};
    const float dt_r[2] = {at_step(d0, d1, r0), at_step(d0, d1, r1)};
    float k_r[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) k_r[e] = S_ROWS ? exp2f(csL - cs_r[e]) * dt_r[e] : exp2f(cs_r[e]);

    float dm[32];                   // x dy^T (rows s) or dy x^T (rows t), over the p tiles
#pragma unroll
    for (int e = 0; e < 32; ++e) dm[e] = 0.f;
    float sum1[2] = {0.f, 0.f}, sum2[2] = {0.f, 0.f}, ip = 0.f;

    // rows s, p tile pt: U = B dS^T; dw_s = x_s . U_s; dx = w U + M^T dy
    // (M^T the MN-major A operand from rows t's M tiles, dy MN-major),
    // written once in bf16; dB += w (x dS), one 64-wide slab of N a product
    auto dx_and_v = [&](int pt, uint32_t sx, uint32_t sdy, uint32_t sdS) {
      float u[32];
      hopper::wgmma_fence();
      kmajor(u, w.sb, sdS, N, false);
      kmajor(u, w.sb, sdS + NT, N, true);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(u);
#pragma unroll
      for (int e = 0; e < 32; ++e) u[e] = w.ds_zero ? 0.f : u[e];   // stale planes: zeros
#pragma unroll
      for (int ix = 0; ix < 32; ix += 2) {
        const int half = (ix / 2) % 2, q = half ? r1 : r0;
        const float2 xv = ld_bf16x2(sx + sw128(q, 8 * (ix / 4) + c0));
        sum2[half] = fmaf(xv.x, u[ix], fmaf(xv.y, u[ix + 1], sum2[half]));
        u[ix] *= k_r[half];
        u[ix + 1] *= k_r[half];
      }
      hopper::reg_fence(u);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int hv = 0; hv < HALVES; ++hv)
          hopper::wgmma_m64n64k16_ss_tt(u, fresh_desc(w.sm + hv * SLAB + kk * 16 * 128, SLAB),
                                        fresh_desc(sdy + kk * 16 * 128, SLAB));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(u);
      bf16* dxb = w.dx + ((long)w.b * w.S + w.t0) * w.H * w.P + (long)hh * w.P + PT * pt;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = half ? r1 : r0;
#pragma unroll
        for (int j8 = 0; j8 < 8; ++j8) {
          const int ix = 4 * j8 + 2 * half;
          st_bf16x2_if(dxb + (long)q * w.H * w.P + 8 * j8 + c0, u[ix], u[ix + 1],
                       w.t0 + q < w.S);
        }
      }
#pragma unroll
      for (int hf = 0; hf < NS; ++hf) {
        float v[32];
        hopper::wgmma_fence();
        by_planes(v, sx, sdS + hf * SLAB, NT);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::reg_fence(v);
#pragma unroll
        for (int e = 0; e < 32; ++e)
          acc[32 * hf + e] = fmaf(k_r[(e / 2) % 2], w.ds_zero ? 0.f : v[e], acc[32 * hf + e]);
      }
    };

    auto step = [&](auto kind_of, int pt) {
      constexpr int KIND = decltype(kind_of)::value;
      const int stg = i % STAGES;
      const uint32_t sx = w.ring + stg * Cfg<N>::C_STAGE, sdy = sx + SLAB, sS = sdy + SLAB,
                     sdS = sS + HALVES * NT;
      hopper::mbar_wait(w.full0 + 8 * stg, (i / STAGES) & 1);

      // the scores over this p tile, x dy^T (rows s) or dy x^T (rows t);
      // rows t add G = C B^T with the first p tile's planes
      constexpr bool WITH_G = (KIND & K_FIRST) != 0 && !S_ROWS;
      float gs[32];
      if constexpr (WITH_G) {
#pragma unroll
        for (int e = 0; e < 32; ++e) gs[e] = 0.f;
        hopper::reg_fence(gs);
      }
      if constexpr ((KIND & K_DM) != 0 || WITH_G) {
        hopper::reg_fence(dm);
        hopper::wgmma_fence();
        if constexpr ((KIND & K_DM) != 0) kmajor(dm, S_ROWS ? sx : sdy, S_ROWS ? sdy : sx, PT, pt > 0);
        if constexpr (WITH_G) kmajor(gs, w.sc, w.sb, N, false);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::reg_fence(dm);
        if constexpr (WITH_G) hopper::reg_fence(gs);
      }
      uint32_t dg[HALVES][4][4];    // dG^T (rows s) or dG (rows t)
      if constexpr ((KIND & K_FIRST) != 0) {
        // the score tile, rows q and columns k (rows s: k = t, the mask t >=
        // s; rows t: k = s, s <= t); e = exp(cs_t - cs_s), 0 off the mask
        // (where exp may overflow: the select comes before any product);
        // dG = dM e dt_s. Rows t also form M = G e dt_s, hi + lo, into the
        // M tiles for rows s's dx, and R = dM G e: its weighted sums over s
        // (R dt_s, by row) and its sums over t (by column: this thread's two
        // rows, then its warp's sixteen by shuffles: lanes 0 .. 3 hold
        // columns 8 j + 2 lane (+1); the warps' sums are added by the d(cs)
        // warp). Registers 8 kk .. 8 kk + 7 are A's k16 block kk.
#pragma unroll
        for (int j8 = 0; j8 < 8; ++j8) {
          const int k0 = 8 * j8 + c0;
          const float cs_k0 = at_step(v0, v1, k0), cs_k1 = at_step(v0, v1, k0 + 1);
          const float dt_k0 = S_ROWS ? 0.f : at_step(d0, d1, k0);
          const float dt_k1 = S_ROWS ? 0.f : at_step(d0, d1, k0 + 1);
          float colp[2] = {0.f, 0.f};
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int ix = 4 * j8 + 2 * half, q = half ? r1 : r0;
            const float w0 = S_ROWS ? dt_r[half] : dt_k0, w1 = S_ROWS ? dt_r[half] : dt_k1;
            float e0 = exp2_fast(S_ROWS ? cs_k0 - cs_r[half] : cs_r[half] - cs_k0);
            float e1 = exp2_fast(S_ROWS ? cs_k1 - cs_r[half] : cs_r[half] - cs_k1);
            e0 = (S_ROWS ? k0 >= q : k0 <= q) ? e0 : 0.f;
            e1 = (S_ROWS ? k0 + 1 >= q : k0 + 1 <= q) ? e1 : 0.f;
            uint32_t parts[HALVES];
            split_bf16(dm[ix] * e0 * w0, dm[ix + 1] * e1 * w1, parts);
#pragma unroll
            for (int hv = 0; hv < HALVES; ++hv) dg[hv][j8 / 2][2 * (j8 % 2) + half] = parts[hv];
            if constexpr (!S_ROWS) {
              const float ge0 = gs[ix] * e0, ge1 = gs[ix + 1] * e1;
              const float rr0 = dm[ix] * ge0, rr1 = dm[ix + 1] * ge1;
              sum1[half] += fmaf(rr0, w0, rr1 * w1);
              colp[0] += rr0;
              colp[1] += rr1;
              split_bf16(ge0 * w0, ge1 * w1, parts);
              const uint32_t at = sw128(q, k0);
#pragma unroll
              for (int hv = 0; hv < HALVES; ++hv) st_b32(w.sm + hv * SLAB + at, parts[hv]);
            }
          }
          if constexpr (!S_ROWS) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = colp[e];
              v += __shfl_xor_sync(0xffffffffu, v, 4);
              v += __shfl_xor_sync(0xffffffffu, v, 8);
              v += __shfl_xor_sync(0xffffffffu, v, 16);
              if (lane < 4) X[X_COL + warp * L + k0 + e] = v;
            }
          }
        }
        if constexpr (!S_ROWS) {
          // the M tiles are written: rows s may read them (through the async
          // proxy, which wgmma reads shared memory by)
          hopper::fence_proxy_async();
          hopper::bar_arrive(BAR_M_READY, 2 * WG);
        }
        // dB += dG^T C (rows s), dC += dG B (rows t): the other tile MN-major
        hopper::reg_fence(acc);
        hopper::wgmma_fence();
        wide<N>(acc, dg, S_ROWS ? w.sc : w.sb);
        hopper::wgmma_commit();
        if constexpr (S_ROWS) {
          hopper::wgmma_wait<0>();
          hopper::reg_fence(acc);
          keep(dg);
          hopper::bar_sync(BAR_M_READY, 2 * WG);   // rows t's M tiles
          dx_and_v(pt, sx, sdy, sdS);
        }
      } else if constexpr (S_ROWS && (KIND & K_PLANES) != 0) {
        dx_and_v(pt, sx, sdy, sdS);
      }
      if constexpr (!S_ROWS && (KIND & K_PLANES) != 0) {
        // Z = dy S_{c-1} (rows t), one 64-wide slab of N a product, the first
        // beside dC's product and <dS, S> (the planes share one swizzle, so
        // element k of each is the same (p, n)); then dC += exp(cs_t) Z and
        // C_t . Z_t
        const uint4* gS = reinterpret_cast<const uint4*>(w.smem + (sS - w.raw));
        const uint4* gdS = reinterpret_cast<const uint4*>(w.smem + (sdS - w.raw));
#pragma unroll
        for (int hf = 0; hf < NS; ++hf) {
          float z[32];
          hopper::wgmma_fence();
          by_planes(z, sdy, sS + hf * SLAB, NT);
          hopper::wgmma_commit();
          if (hf == 0) {
            float ipk = 0.f;
#pragma unroll 1
            for (int k = wt; k < NT / 16; k += WG) {
              const uint4 sh = gS[k], sl = gS[NT / 16 + k], dh = gdS[k], dl = gdS[NT / 16 + k];
              const uint32_t w4[4][4] = {{sh.x, sh.y, sh.z, sh.w}, {sl.x, sl.y, sl.z, sl.w},
                                         {dh.x, dh.y, dh.z, dh.w}, {dl.x, dl.y, dl.z, dl.w}};
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float s0 =
                    __uint_as_float(w4[0][q] << 16) + __uint_as_float(w4[1][q] << 16);
                const float s1 = __uint_as_float(w4[0][q] & 0xffff0000u) +
                                 __uint_as_float(w4[1][q] & 0xffff0000u);
                const float e0 =
                    __uint_as_float(w4[2][q] << 16) + __uint_as_float(w4[3][q] << 16);
                const float e1 = __uint_as_float(w4[2][q] & 0xffff0000u) +
                                 __uint_as_float(w4[3][q] & 0xffff0000u);
                ipk = fmaf(e0, s0, fmaf(e1, s1, ipk));
              }
            }
            ip += w.s_zero || w.ds_zero ? 0.f : ipk;   // stale planes: zeros
          }
          hopper::wgmma_wait<0>();
          hopper::reg_fence(acc);
          hopper::reg_fence(z);
          if constexpr ((KIND & K_FIRST) != 0) {
            if (hf == 0) keep(dg);
          }
#pragma unroll
          for (int e = 0; e < 32; ++e) z[e] = w.s_zero ? 0.f : z[e];   // stale planes: zeros
          uint32_t scz = w.sc + hf * SLAB;
          asm volatile("" : "+r"(scz));
#pragma unroll
          for (int ix = 0; ix < 32; ix += 2) {
            const int half = (ix / 2) % 2, q = half ? r1 : r0;
            const float2 cv = ld_bf16x2(scz + sw128(q, 8 * (ix / 4) + c0));
            sum2[half] = fmaf(cv.x, z[ix], fmaf(cv.y, z[ix + 1], sum2[half]));
            acc[32 * hf + ix] = fmaf(k_r[half], z[ix], acc[32 * hf + ix]);
            acc[32 * hf + ix + 1] = fmaf(k_r[half], z[ix + 1], acc[32 * hf + ix + 1]);
          }
        }
      }

      // this warpgroup is done with the stage; once both are, it takes the
      // step STAGES on
      hopper::bar_sync(S_ROWS ? BAR_A : BAR_B, WG);
      if (wt == 0) {
        if constexpr (S_ROWS) {
          hopper::mbar_arrive(w.empty0 + 8 * stg);
        } else {
          hopper::mbar_wait(w.empty0 + 8 * stg, (i / STAGES) & 1);
          if (i + STAGES < w.nsteps) w.issue<N>(i + STAGES);
        }
      }
      ++i;
    };
    if constexpr (ONE_P) {
      step(std::integral_constant<int, K_FULL>(), 0);
    } else {
#pragma unroll 1
      for (int pt = 0; pt < w.npt; ++pt) step(std::integral_constant<int, K_DM>(), pt);
      step(std::integral_constant<int, K_FIRST | K_PLANES>(), 0);
#pragma unroll 1
      for (int pt = 1; pt < w.npt; ++pt) step(std::integral_constant<int, K_REST>(), pt);
    }

    // the head's sums by step: rows s dw_s, rows t sum_s R[t][s] dt_s,
    // exp(cs_t) C_t . Z_t and <dS, S> (and sum_t R[t][s] went with M)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s1 = sum1[half], s2 = sum2[half];
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
      s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
      const int q = half ? r1 : r0;
      if (lane % 4 == 0) {
        if constexpr (S_ROWS) {
          X[X_DW + q] = s2;
        } else {
          X[X_ROW + q] = s1;
          X[X_CZ + q] = k_r[half] * s2;
        }
      }
    }
    if constexpr (!S_ROWS) {
#pragma unroll
      for (int o = 16; o > 0; o /= 2) ip += __shfl_xor_sync(0xffffffffu, ip, o);
      if (lane == 0) X[X_IP + warp] = ip;
    }
    hopper::bar_sync(BAR_ALL, 2 * WG);

    // rows t's warp 0: d(cs), its reverse cumsum, ddt and the chunk's share
    // of da. Lane l takes steps 63 - l and 31 - l, so that an inclusive scan
    // over the lanes sums each step's later ones.
    if (!S_ROWS && warp == 0) {
      const float w0 = exp2f(csL - v0) * d0, w1 = exp2f(csL - v1) * d1;
      float ww = X[X_DW + lane] * w0 + X[X_DW + lane + 32] * w1;
#pragma unroll
      for (int o = 16; o > 0; o /= 2) ww += __shfl_xor_sync(0xffffffffu, ww, o);
      const float ipt = (X[X_IP] + X[X_IP + 1]) + (X[X_IP + 2] + X[X_IP + 3]);
      const int ts[2] = {L - 1 - lane, L / 2 - 1 - lane};
      float col[2], dwt[2], dcs[2], decay[2], dts[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = ts[k];
        const float cst = at_step(v0, v1, t);
        dts[k] = at_step(d0, d1, t);
        decay[k] = exp2f(csL - cst);
        col[k] = (X[X_COL + t] + X[X_COL + L + t]) + (X[X_COL + 2 * L + t] + X[X_COL + 3 * L + t]);
        dwt[k] = X[X_DW + t];
        dcs[k] = X[X_ROW + t] - dts[k] * col[k] + X[X_CZ + t] - dwt[k] * (decay[k] * dts[k]);
      }
      if (lane == 0) dcs[0] += ww + exp2f(csL) * ipt;   // step L - 1: cs_L's own terms
      float q0 = dcs[0], q1 = dcs[1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, q0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, q1, o);
        if (lane >= o) {
          q0 += u0;
          q1 += u1;
        }
      }
      q1 += __shfl_sync(0xffffffffu, q0, 31);
      const float rc[2] = {q0, q1};
      float da_acc = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = ts[k];
        da_acc = fmaf(dts[k], rc[k], da_acc);
        if (w.t0 + t < w.S)
          w.ddt[((long)w.b * w.S + w.t0 + t) * w.H + hh] =
              fmaf(A, rc[k], fmaf(dwt[k], decay[k], col[k]));
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2) da_acc += __shfl_xor_sync(0xffffffffu, da_acc, o);
      if (lane == 0) w.dap[((long)w.b * w.NC + w.c) * w.H + hh] = da_acc;
    }
  }
}

// 2. Every gradient of one chunk for a slice of a group's heads. Grid
// (slices, chunks, B G), two warpgroups (`chunk_walk`). dx (B, S, H, P)
// bf16 and ddt (B, S, H) written once; dbp and dcp (slices, B, S, G, N) the
// slice's sums of dB and dC; dap (B, chunks, H) each chunk's share of da.
template <int N, bool ONE_P>
__global__ void __launch_bounds__(2 * WG, 1)
ssd_bwd_wgmma_chunk_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tdy,
                           const __grid_constant__ CUtensorMap tb,
                           const __grid_constant__ CUtensorMap tcm,
                           const __grid_constant__ CUtensorMap tws, const float* __restrict__ dt,
                           const float* __restrict__ a, bf16* __restrict__ dx,
                           float* __restrict__ ddt, float* __restrict__ dbp,
                           float* __restrict__ dcp, float* __restrict__ dap, int B, int S, int H,
                           int P, int G, int NC, int slices, int has_h0, int has_dstate) {
  using C = Cfg<N>;
  constexpr int NS = C::NS;
  extern __shared__ unsigned char smem_raw[];
  Walk w;
  w.raw = hopper::smem_u32(smem_raw);
  w.smem = smem_raw;
  w.sb = (w.raw + 1023u) & ~1023u;   // B, C of the chunk, then the stages
  w.sc = w.sb + C::NT;
  w.ring = w.sc + C::NT;
  w.sm = w.ring + STAGES * C::C_STAGE;
  const uint32_t xch = w.sm + HALVES * SLAB;   // the two sets of sums
  const uint32_t bcbar = xch + 2 * X_SET * 4;
  w.full0 = bcbar + 8;
  w.empty0 = w.full0 + 8 * STAGES;
  w.xf = reinterpret_cast<float*>(smem_raw + (xch - w.raw));

  // the warpgroup, broadcast from lane 0 so that the compiler knows that it
  // is the same across the warp
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / WG, 0), wt = tid % WG;
  const int slice = blockIdx.x, c = blockIdx.y, b = blockIdx.z / G, g = blockIdx.z % G;
  const int rep = H / G, per = (rep + slices - 1) / slices;
  w.tx = &tx;
  w.tdy = &tdy;
  w.tws = &tws;
  w.dtb = dt + (long)b * S * H;
  w.a = a;
  w.dx = dx;
  w.ddt = ddt;
  w.dap = dap;
  w.B = B;
  w.S = S;
  w.H = H;
  w.P = P;
  w.NC = NC;
  w.b = b;
  w.c = c;
  w.t0 = c * L;
  w.h_begin = g * rep + min(slice * per, rep);
  w.h_end = g * rep + min(slice * per + per, rep);
  w.npt = P / PT;
  w.sph = w.npt == 1 ? 1 : 2 * w.npt;   // steps a head
  w.nsteps = (w.h_end - w.h_begin) * w.sph;
  w.s_zero = c == 0 && !has_h0;
  w.ds_zero = c == NC - 1 && !has_dstate;

  if (tid == 0) {
    hopper::prefetch_tensormap(&tx);
    hopper::prefetch_tensormap(&tdy);
    hopper::prefetch_tensormap(&tb);
    hopper::prefetch_tensormap(&tcm);
    hopper::prefetch_tensormap(&tws);
    hopper::mbar_init(bcbar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(w.full0 + 8 * s, 1);
      hopper::mbar_init(w.empty0 + 8 * s, 1);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == WG) {   // warpgroup 1's first thread issues every load
    hopper::mbar_arrive_expect_tx(bcbar, 2 * C::NT);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      hopper::tma_load_4d(w.sb + s * SLAB, &tb, bcbar, 64 * s, g, w.t0, b);
      hopper::tma_load_4d(w.sc + s * SLAB, &tcm, bcbar, 64 * s, g, w.t0, b);
    }
    for (int i = 0; i < STAGES && i < w.nsteps; ++i) w.issue<N>(i);
  }

  // dB (warpgroup 0) or dC (warpgroup 1) of the slice's heads
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  hopper::mbar_wait(bcbar, 0);
  // the slice's dB or dC, rows t0 + r0 / r1
  auto store = [&](float* part) {
    const int warp = wt / 32, lane = wt % 32;
    const int r0 = 16 * warp + lane / 4, r1 = r0 + 8, c0 = 2 * (lane % 4);
    float* out = part + (((long)slice * B + b) * S + w.t0) * G * N + (long)g * N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = half ? r1 : r0;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int ix = 4 * j + 2 * half;
        st_f32x2_if(out + (long)q * G * N + 8 * j + c0, acc[ix], acc[ix + 1], w.t0 + q < S);
      }
    }
  };
  if (wg == 0) {
    chunk_walk<N, true, ONE_P>(w, acc, wt);
    store(dbp);
  } else {
    chunk_walk<N, false, ONE_P>(w, acc, wt);
    store(dcp);
  }
}

// 3. dB and dC (B, S, G, N) bf16 as the sums of the slices' partials, in
// order, four columns a thread; then da (H,) as the sum of the (batch,
// chunk) shares, one thread a head.
__global__ void __launch_bounds__(256)
ssd_bwd_wgmma_reduce_kernel(const float* __restrict__ dbp, const float* __restrict__ dcp,
                            const float* __restrict__ dap, bf16* __restrict__ db,
                            bf16* __restrict__ dc, float* __restrict__ da, int slices, long n4,
                            int BNC, int H) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  if (i < n4) {
    float4 sb = reinterpret_cast<const float4*>(dbp)[i];
    float4 scc = reinterpret_cast<const float4*>(dcp)[i];
    for (int k = 1; k < slices; ++k) {
      sb = add4(sb, reinterpret_cast<const float4*>(dbp)[k * n4 + i]);
      scc = add4(scc, reinterpret_cast<const float4*>(dcp)[k * n4 + i]);
    }
    ssd::put(db + 4 * i, sb);
    ssd::put(dc + 4 * i, scc);
  } else if (i < n4 + H) {
    const int h = (int)(i - n4);
    float v = 0.f;
    for (int k = 0; k < BNC; ++k) v += dap[(long)k * H + h];
    da[h] = v;
  }
}

template <int N>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
           const void* h0, const void* dy, const void* dstate, void* dx, void* ddt, void* da,
           void* db, void* dc, void* dh0, void* ws, void* dbp, void* dcp, void* dap, int B, int S,
           int H, int P, int G, int slices, cudaStream_t st) {
  using C = Cfg<N>;
  const int NC = (S + L - 1) / L;
  CUtensorMap tx, tdy, tb, tcm, tws;
  cudaError_t err = hopper::tma_map_bshd(&tx, x, B, S, H, P, L);
  if (err == cudaSuccess) err = hopper::tma_map_bshd(&tdy, dy, B, S, H, P, L);
  if (err == cudaSuccess) err = hopper::tma_map_bshd(&tb, b, B, S, G, N, L);
  if (err == cudaSuccess) err = hopper::tma_map_bshd(&tcm, c, B, S, G, N, L);
  // the planes as rows of N: (2, B, H, chunks, HALVES, P) rows
  if (err == cudaSuccess)
    err = hopper::tma_map_bshd(&tws, ws, 1, 2 * B * H * NC * HALVES * P, 1, N, L);
  // P 64 (one p tile) takes the chunk kernel whose every step is a head
  const bool one_p = P == PT;
  const void* chunk = one_p ? (const void*)ssd_bwd_wgmma_chunk_kernel<N, true>
                            : (const void*)ssd_bwd_wgmma_chunk_kernel<N, false>;
  static std::atomic<unsigned long long> state_in{0}, one_in{0}, tiles_in{0};
  if (err == cudaSuccess)
    err = hopper::opt_in_smem((const void*)ssd_bwd_wgmma_state_kernel<N>, C::W_SMEM, state_in);
  if (err == cudaSuccess) err = hopper::opt_in_smem(chunk, C::C_SMEM, one_p ? one_in : tiles_in);
  if (err != cudaSuccess) return (int)err;
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  ssd_bwd_wgmma_state_kernel<N><<<dim3(P / PT, H, 2 * B), WG, C::W_SMEM, st>>>(
      tx, tdy, tb, tcm, tws, dtf, af, static_cast<const float*>(h0),
      static_cast<const float*>(dstate), static_cast<float*>(dh0), B, S, H, P, G, NC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(slices, NC, B * G);
#define K3_BWD_CHUNK_ARGS                                                                    \
  tx, tdy, tb, tcm, tws, dtf, af, static_cast<bf16*>(dx), static_cast<float*>(ddt),          \
      static_cast<float*>(dbp), static_cast<float*>(dcp), static_cast<float*>(dap), B, S, H, P, \
      G, NC, slices, h0 != nullptr, dstate != nullptr
  if (one_p)
      ssd_bwd_wgmma_chunk_kernel<N, true><<<grid, 2 * WG, C::C_SMEM, st>>>(K3_BWD_CHUNK_ARGS);
  else
    ssd_bwd_wgmma_chunk_kernel<N, false><<<grid, 2 * WG, C::C_SMEM, st>>>(K3_BWD_CHUNK_ARGS);
#undef K3_BWD_CHUNK_ARGS
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n4 = (long)B * S * G * N / 4;
  ssd_bwd_wgmma_reduce_kernel<<<(unsigned)((n4 + H + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(dbp), static_cast<const float*>(dcp),
      static_cast<const float*>(dap), static_cast<bf16*>(db), static_cast<bf16*>(dc),
      static_cast<float*>(da), slices, n4, B * NC, H);
  return (int)cudaGetLastError();
}

// The shared memory and CTAs an SM of the route's kernel `kernel` (0 state
// walk, 1 chunk at P 64, 2 reduce) at state size N on the current device.
template <int N>
int occupancy(int kernel, int* smem, int* ctas_per_sm) {
  using C = Cfg<N>;
  static std::atomic<unsigned long long> state_in{0}, chunk_in{0};
  const void* fn[3] = {(const void*)ssd_bwd_wgmma_state_kernel<N>,
                       (const void*)ssd_bwd_wgmma_chunk_kernel<N, true>,
                       (const void*)ssd_bwd_wgmma_reduce_kernel};
  const int threads[3] = {WG, 2 * WG, 256};
  const int bytes[3] = {C::W_SMEM, C::C_SMEM, 0};
  if (kernel < 0 || kernel > 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = hopper::opt_in_smem(fn[0], bytes[0], state_in);
  if (err == cudaSuccess) err = hopper::opt_in_smem(fn[1], bytes[1], chunk_in);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, fn[kernel], threads[kernel],
                                                        bytes[kernel]);
  *smem = bytes[kernel];
  return (int)err;
}

}  // namespace wg

}  // namespace

#define K3_BWD_ARGS                                                                           \
  x, dt, a, b, c, h0, dy, dstate, dx, ddt, da, db, dc, dh0, states, dstates, decay, dbp, dcp, \
      ddtp, dap, B, S, H, P, G, N, static_cast<cudaStream_t>(stream)
#define K3_BWD_PARAMS                                                                         \
  const void *x, const void *dt, const void *a, const void *b, const void *c, const void *h0, \
      const void *dy, const void *dstate, void *dx, void *ddt, void *da, void *db, void *dc,  \
      void *dh0, void *states, void *dstates, void *decay, void *dbp, void *dcp, void *ddtp,  \
      void *dap, int B, int S, int H, int P, int G, int N, void *stream

// All fp32. x, dy, dx (B, S, H, P); dt, ddt (B, S, H); a, da (H,); b, c,
// db, dc (B, S, G, N); h0, dstate, dh0 (B, H, P, N), each may be null. The
// workspaces: states and dstates (B, H, chunks, P, N) and decay (B, H,
// chunks), chunks being ceil(S / 64); dbp and dcp (p tiles, B, S, H, N);
// ddtp (p tiles, B, S, H); dap (p tiles, B, chunks, H), p tiles being
// ceil(P / 64). Launches the five kernels on `stream` and does not
// synchronise; returns cudaGetLastError() after each launch (0 on success).
extern "C" int ssd_scan_bwd(K3_BWD_PARAMS) {
  if (!valid(B, S, H, P, G, N, h0, dh0)) return (int)cudaErrorInvalidValue;
  return run<float>(K3_BWD_ARGS);
}

// The staged bf16 route: x, b, c, dy, dx, db and dc bf16, everything else
// (dt, a, h0, dstate, ddt, da, dh0 and the workspaces) fp32, as
// ssd_scan_bwd.
extern "C" int ssd_scan_bwd_bf16(K3_BWD_PARAMS) {
  if (!valid(B, S, H, P, G, N, h0, dh0)) return (int)cudaErrorInvalidValue;
  return run<__nv_bfloat16>(K3_BWD_ARGS);
}

#undef K3_BWD_ARGS
#undef K3_BWD_PARAMS

// The shared memory and CTAs an SM of K3-bwd's kernel `kernel` (0 state, 1
// pass, 2 chunk, 3 dB/dC reduce, 4 ddt/da reduce) on the current device, of
// the fp32 route and of the staged bf16 one. Returns a CUDA error (0 on success).
extern "C" int ssd_scan_bwd_occupancy(int kernel, int* smem, int* ctas_per_sm) {
  return occupancy<float>(kernel, smem, ctas_per_sm);
}
extern "C" int ssd_scan_bwd_bf16_occupancy(int kernel, int* smem, int* ctas_per_sm) {
  return occupancy<__nv_bfloat16>(kernel, smem, ctas_per_sm);
}

// The route (dtype, P, N) takes: 0 the 3xTF32 route (fp32: `ssd_scan_bwd`),
// 1 the staged route (bf16 at other widths: `ssd_scan_bwd_bf16`), 2 the
// wgmma route (bf16, P a multiple of 64, N 64 or 128: `ssd_scan_bwd_wgmma`).
// dtype: 0 float32, 1 bfloat16.
extern "C" int ssd_scan_bwd_route(int dtype, int P, int N) {
  return (dtype == 1) + (dtype == 1 && P % 64 == 0 && (N == 64 || N == 128));
}

// The wgmma route: x, b, c, dy, dx, db and dc bf16; dt, a, h0, dstate, ddt,
// da and dh0 fp32 in the layouts of ssd_scan_bwd; P a multiple of 64, N 64
// or 128. The workspaces: ws (2, B, H, chunks, 2, P, N) bf16, the planes of
// S_{c-1} and dS_c; dbp and dcp (slices, B, S, G, N) fp32; dap (B, chunks,
// H) fp32. `slices` (1 .. H / G) cuts each group's heads into that many
// runs of ceil(H / G / slices), one chunk CTA each. Every bf16 pointer
// 16-byte aligned. Launches the three kernels on `stream` and does not
// synchronise; returns cudaGetLastError() after each launch (0 on success).
extern "C" int ssd_scan_bwd_wgmma(const void* x, const void* dt, const void* a, const void* b,
                                  const void* c, const void* h0, const void* dy,
                                  const void* dstate, void* dx, void* ddt, void* da, void* db,
                                  void* dc, void* dh0, void* ws, void* dbp, void* dcp, void* dap,
                                  int B, int S, int H, int P, int G, int N, int slices,
                                  void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 || P % 64 != 0 ||
      (N != 64 && N != 128) || slices < 1 || slices > H / G || 2 * B > 65535 ||
      (S + 63) / 64 > 65535 || (long)B * G > 65535 || (h0 == nullptr) != (dh0 == nullptr) ||
      4L * B * H * ((S + 63) / 64) * P > 0x7fffffffL)   // the planes' rows, a TMA coordinate
    return (int)cudaErrorInvalidValue;
  for (const void* p : {x, b, c, dy, (const void*)dx, (const void*)db, (const void*)dc,
                        (const void*)ws})
    if (p == nullptr || reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 64)
    return wg::launch<64>(x, dt, a, b, c, h0, dy, dstate, dx, ddt, da, db, dc, dh0, ws, dbp, dcp,
                          dap, B, S, H, P, G, slices, st);
  return wg::launch<128>(x, dt, a, b, c, h0, dy, dstate, dx, ddt, da, db, dc, dh0, ws, dbp, dcp,
                         dap, B, S, H, P, G, slices, st);
}

// The shared memory and CTAs an SM of the wgmma route's kernel `kernel` (0
// state walk, 1 chunk, 2 reduce) at state size N (64 or 128) on the current
// device. Returns a CUDA error (0 on success).
extern "C" int ssd_scan_bwd_wgmma_occupancy(int kernel, int N, int* smem, int* ctas_per_sm) {
  if (N == 64) return wg::occupancy<64>(kernel, smem, ctas_per_sm);
  if (N == 128) return wg::occupancy<128>(kernel, smem, ctas_per_sm);
  return (int)cudaErrorInvalidValue;
}
