// K3-bwd: the gradient of the Mamba2 SSD chunked scan, hand-written for
// Hopper (sm_90a), its products on the tensor cores as 3xTF32. Two routes
// of the same kernels: fp32 in and out, and bf16 (x, b, c and dy in, dx, db
// and dc out, the training at the reference's production dtypes).
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
// The bf16 route widens x, B, C and dy to fp32 as they are staged
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

// The bf16 route: x, b, c, dy, dx, db and dc bf16, everything else (dt, a,
// h0, dstate, ddt, da, dh0 and the workspaces) fp32, as ssd_scan_bwd.
extern "C" int ssd_scan_bwd_bf16(K3_BWD_PARAMS) {
  if (!valid(B, S, H, P, G, N, h0, dh0)) return (int)cudaErrorInvalidValue;
  return run<__nv_bfloat16>(K3_BWD_ARGS);
}

#undef K3_BWD_ARGS
#undef K3_BWD_PARAMS

// The shared memory and CTAs an SM of K3-bwd's kernel `kernel` (0 state, 1
// pass, 2 chunk, 3 dB/dC reduce, 4 ddt/da reduce) on the current device, of
// the fp32 route and of the bf16 one. Returns a CUDA error (0 on success).
extern "C" int ssd_scan_bwd_occupancy(int kernel, int* smem, int* ctas_per_sm) {
  return occupancy<float>(kernel, smem, ctas_per_sm);
}
extern "C" int ssd_scan_bwd_bf16_occupancy(int kernel, int* smem, int* ctas_per_sm) {
  return occupancy<__nv_bfloat16>(kernel, smem, ctas_per_sm);
}
