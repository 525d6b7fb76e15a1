// K3-bwd: the gradient of the Mamba2 SSD chunked scan, hand-written for
// Hopper (sm_90a), fp32 on the CUDA cores.
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
// Given dy and d(final state), the kernel runs three passes:
// 1. state recompute: the state entering each chunk, S_{c-1}, by the
//    forward's recurrence from h0 (zeros if none), into a workspace
//    (B, H, chunks, P, N) fp32 (42 MB at the train call). Recomputing keeps
//    K3's serving routes as they are: nothing is saved by the forward.
// 2. the chunks in reverse, carrying dS = dL/dS_c in shared memory, seeded
//    with d(final state); per chunk, with dM[t,s] = dy_t . x_s,
//    dG = dM exp(cs_t - cs_s) dt_s and R = dM (C_t . B_s) exp(cs_t - cs_s):
//      dx_s = sum_t M[t,s] dy_t + w_s dS B_s
//      dC_t = sum_s dG[t,s] B_s + exp(cs_t) dy_t S_{c-1}
//      dB_s = sum_t dG[t,s] C_t + w_s x_s dS
//      d(cs)_t = sum_s R[t,s] dt_s - dt_t sum_u R[u,t] + exp(cs_t) C_t .
//                (dy_t S_{c-1}) - dw_t w_t, dw_t = x_t . (dS B_t); at the
//                last step also sum_s dw_s w_s + exp(cs_L) <dS, S_{c-1}>
//      ddt_t = sum_u R[u,t] + dw_t exp(cs_L - cs_t) + a rc_t,
//      da += sum_t dt_t rc_t, rc_t = sum_{u >= t} d(cs)_u
//    then dS <- exp(cs_L) dS + sum_t exp(cs_t) dy_t^T C_t; after the first
//    chunk dS is dh0.
// 3. reduce: dB and dC sum over a group's H / G heads and the CTAs' p
//    tiles, ddt over p tiles, da over p tiles and batch, each in a fixed
//    order from per-CTA partials (fp32, (p tiles, B, S, H, N) for dB and
//    dC: 42 MB each at the train call). No atomics: every element has one
//    writer, so the result is the same from run to run.
// The decay is masked before exp (exp(cs_t - cs_s) overflows for s > t),
// and exp(cs_t - cs_s) is never split into exp(cs_t) exp(-cs_s), whose
// second factor overflows. A ragged tail (S % 64) loads as zeros (dt 0, so
// cs stays constant and the state neither decays nor updates) and stores
// nothing, as in the forward.
//
// Layouts are the forward's: x, dy, dx (B, S, H, P); dt, ddt (B, S, H);
// a, da (H,); b, c, db, dc (B, S, G, N) with G dividing H, head h in group
// h / (H / G); h0, dstate, dh0 (B, H, P, N), each may be null (zeros in,
// nothing out). All fp32.
//
// Design: one CTA of 256 threads per (64 head columns p, head, batch), as
// in K3's CUDA-core route, holding a chunk's B, C, x, dy (fp32, rows padded
// by one float so that neither operand of a product has bank conflicts),
// S_{c-1}, dS, M and dG in shared memory, 198 KB at N 128: one CTA an SM.
// Each product runs in 4 x 4 (4 x 8 where N wide) register tiles; the
// products over the chunk's triangle walk only its live half. Row sums of
// a tile reduce by shuffles over the 16 threads of a row group, column sums
// over a warp's two row groups by a shuffle and then over the 8 warps in
// order through shared memory.
//
// Bound on the H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 CUDA cores) at the
// Mamba2 train call (B 4, S 256, H 80, P 64, G 1, N 128, fp32, no h0, no
// dstate): x, dy and dx 21.0 MB each, b, c, db, dc 0.5 MB each, dt and ddt
// 0.3 MB each: 65.6 MB, 19.6 us. The operations, a chunk and head: the five
// products over the chunk's triangle (C B^T and dy x^T, M^T dy, dG B and
// dG^T C; 2080 pairs of 64 x 64) and the five P x N products over its 64
// steps (dS B_s, x_s dS, dy S_{c-1}, the dS update and the state
// recompute), 7.37 MFLOP; 1280 chunk-heads make 9.44 GFLOP, 0.141 ms. So
// the card's bound is the operations.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int L = 64;          // steps a chunk (the forward's)
constexpr int PT = 64;         // head columns p a CTA
constexpr int NMAX = 128;      // largest state size N
constexpr int NT = 256;        // threads a CTA
constexpr int NW = NT / 32;    // warps a CTA
constexpr int CG = 16;         // threads sharing one row group
constexpr int NJ = NMAX / CG;  // state columns a thread
constexpr int LP = L + 1;      // padded row of the M and dG tiles
constexpr int XP = PT + 1;     // padded row of the x and dy tiles

static_assert(L == 64, "the cs scan covers the chunk with two values a lane");
static_assert((NT / CG) * 4 == L && (NT / CG) * 4 == PT, "row groups must cover the tiles");
static_assert(CG * 4 == L && CG * 4 == PT, "column groups must cover the tiles");

size_t smem_bytes(int N) {
  const size_t NP = N + 1;
  return sizeof(float) * (2 * L * NP + 2 * PT * NP + 2 * L * XP + 2 * L * LP + 7 * L + NW * L +
                          NW);
}

// sum over the 16 threads of a row group (lanes 0-15 or 16-31 of a warp)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = CG / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// warp 0: the inclusive cumsum of dt a over the chunk (lane l holding steps
// l and l + 32), w_s = exp(cs_L - cs_s) dt_s, and exp(cs_t) when asked
__device__ __forceinline__ void scan_chunk(const float* sdt, float A, float* scs, float* sw,
                                           float* secs, int lane) {
  float v0 = sdt[lane] * A, v1 = sdt[lane + 32] * A;
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
  const float last = __shfl_sync(0xffffffffu, v1, 31);
  scs[lane] = v0;
  scs[lane + 32] = v1;
  sw[lane] = expf(last - v0) * sdt[lane];
  sw[lane + 32] = expf(last - v1) * sdt[lane + 32];
  if (secs != nullptr) {
    secs[lane] = expf(v0);
    secs[lane + 32] = expf(v1);
  }
}

__global__ void __launch_bounds__(NT, 1)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ bm,
                     const float* __restrict__ cm, const float* __restrict__ h0,
                     const float* __restrict__ dy, const float* __restrict__ dstate,
                     float* __restrict__ dx, float* __restrict__ dh0, float* __restrict__ states,
                     float* __restrict__ dbp, float* __restrict__ dcp, float* __restrict__ ddtp,
                     float* __restrict__ dap, int B, int S, int H, int P, int G, int N, int NC) {
  const int NP = N + 1;
  extern __shared__ float smem[];
  float* sB = smem;                // [L][NP]
  float* sC = sB + L * NP;         // [L][NP]
  float* sS = sC + L * NP;         // [PT][NP]: the state entering the chunk
  float* sdS = sS + PT * NP;       // [PT][NP]: dL/d(the state leaving it)
  float* sX = sdS + PT * NP;       // [L][XP]
  float* sDY = sX + L * XP;        // [L][XP]
  float* sM = sDY + L * XP;        // [L][LP]: M[t][s]
  float* sdG = sM + L * LP;        // [L][LP]: dG[t][s]
  float* sdt = sdG + L * LP;       // [L]
  float* scs = sdt + L;            // [L] inclusive cumsum of dt a
  float* sw = scs + L;             // [L] exp(cs_L - cs_s) dt_s
  float* secs = sw + L;            // [L] exp(cs_t)
  float* srow = secs + L;          // [L] sum_s R[t][s] dt_s
  float* sdw = srow + L;           // [L] x_t . (dS B_t)
  float* sint = sdw + L;           // [L] exp(cs_t) C_t . (dy_t S_{c-1})
  float* scol = sint + L;          // [NW][L] each warp's sum_t R[t][s]
  float* sred = scol + NW * L;     // [NW] each warp's share of <dS, S_{c-1}>

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = tid / CG;         // rows rg*4 .. rg*4+3
  const int cg = tid % CG;         // columns cg + CG*j
  const int pt = blockIdx.x, p0 = pt * PT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const float A = a[h];
  const long xs = (long)H * P;     // stride of one step in x / dy / dx
  const long bs = (long)G * N;     // stride of one step in b / c
  const long xo = (long)b * S * xs + (long)h * P;
  const float* dtb = dt + (long)b * S * H + h;
  const float* bb = bm + (long)b * S * bs + (long)g * N;
  const float* cb = cm + (long)b * S * bs + (long)g * N;
  const long so = ((long)b * H + h) * P * N;            // this head's state
  float* st = states + ((long)b * H + h) * NC * P * N;  // chunk c's at st + c P N
  const long part = ((long)pt * B + b) * S;             // this CTA's rows of the partials

  for (int i = tid; i < PT * N; i += NT) {
    const int r = i / N, n = i % N, p = p0 + r;
    sS[r * NP + n] = (h0 != nullptr && p < P) ? h0[so + (long)p * N + n] : 0.f;
    sdS[r * NP + n] = (dstate != nullptr && p < P) ? dstate[so + (long)p * N + n] : 0.f;
  }

  // ---- 1. the state entering each chunk, into the workspace
  for (int c = 0; c < NC; ++c) {
    const int t0 = c * L;
    __syncthreads();  // sS holds S_{c-1}; the last chunk is done with every tile
    for (int i = tid; i < PT * N; i += NT) {
      const int r = i / N, n = i % N, p = p0 + r;
      if (p < P) st[(long)c * P * N + (long)p * N + n] = sS[r * NP + n];
    }
    if (c == NC - 1) break;
    for (int i = tid; i < L * N; i += NT) {
      const int r = i / N, n = i % N, t = t0 + r;
      sB[r * NP + n] = t < S ? bb[(long)t * bs + n] : 0.f;
    }
    for (int i = tid; i < L * PT; i += NT) {
      const int r = i / PT, q = i % PT, t = t0 + r, p = p0 + q;
      sX[r * XP + q] = (t < S && p < P) ? x[xo + (long)t * xs + p] : 0.f;
    }
    if (tid < L) sdt[tid] = t0 + tid < S ? dtb[(long)(t0 + tid) * H] : 0.f;
    __syncthreads();
    if (warp == 0) scan_chunk(sdt, A, scs, sw, nullptr, lane);
    __syncthreads();
    // S[p][n] = exp(cs_L) S[p][n] + sum_s x[s][p] w_s B[s][n]
    float acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    for (int s = 0; s < L; ++s) {
      const float ws = sw[s];
      float xv[4], bv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = sX[s * XP + rg * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = cg + CG * j;
        bv[j] = n < N ? sB[s * NP + n] * ws : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
    }
    const float eL = expf(scs[L - 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int r = rg * 4 + i, n = cg + CG * j;
        if (n < N) sS[r * NP + n] = fmaf(eL, sS[r * NP + n], acc[i][j]);
      }
  }

  // ---- 2. the chunks in reverse
  float da_acc = 0.f;   // warp 0: this CTA's share of da
  for (int c = NC - 1; c >= 0; --c) {
    const int t0 = c * L;
    __syncthreads();  // the last chunk is done with every tile
    for (int i = tid; i < L * N; i += NT) {
      const int r = i / N, n = i % N, t = t0 + r;
      const bool in = t < S;
      sB[r * NP + n] = in ? bb[(long)t * bs + n] : 0.f;
      sC[r * NP + n] = in ? cb[(long)t * bs + n] : 0.f;
    }
    for (int i = tid; i < L * PT; i += NT) {
      const int r = i / PT, q = i % PT, t = t0 + r, p = p0 + q;
      const bool in = t < S && p < P;
      sX[r * XP + q] = in ? x[xo + (long)t * xs + p] : 0.f;
      sDY[r * XP + q] = in ? dy[xo + (long)t * xs + p] : 0.f;
    }
    for (int i = tid; i < PT * N; i += NT) {
      const int r = i / N, n = i % N, p = p0 + r;
      sS[r * NP + n] = p < P ? st[(long)c * P * N + (long)p * N + n] : 0.f;
    }
    if (tid < L) sdt[tid] = t0 + tid < S ? dtb[(long)(t0 + tid) * H] : 0.f;
    __syncthreads();
    if (warp == 0) scan_chunk(sdt, A, scs, sw, secs, lane);
    __syncthreads();

    // M, dG, and R's row and column sums: rows t = rg*4 + i, columns
    // s = cg + CG*j
    {
      float gacc[4][4], macc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) gacc[i][j] = macc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(rg * 4 + i) * NP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sB[(cg + CG * j) * NP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) gacc[i][j] = fmaf(cv[i], bv[j], gacc[i][j]);
      }
#pragma unroll 4
      for (int q = 0; q < PT; ++q) {
        float yv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) yv[i] = sDY[(rg * 4 + i) * XP + q];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = sX[(cg + CG * j) * XP + q];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) macc[i][j] = fmaf(yv[i], xv[j], macc[i][j]);
      }
      float rowp[4] = {0.f, 0.f, 0.f, 0.f}, colp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = rg * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = cg + CG * j;
          float m = 0.f, dg = 0.f;
          if (s <= t) {   // the mask before exp
            const float e = expf(scs[t] - scs[s]), dts = sdt[s];
            const float ge = gacc[i][j] * e;
            const float r = macc[i][j] * ge;
            m = ge * dts;
            dg = macc[i][j] * e * dts;
            rowp[i] = fmaf(r, dts, rowp[i]);
            colp[j] += r;
          }
          sM[t * LP + s] = m;
          sdG[t * LP + s] = dg;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = row_sum(rowp[i]);
        if (cg == 0) srow[rg * 4 + i] = v;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = colp[j] + __shfl_xor_sync(0xffffffffu, colp[j], 16);
        if (lane < CG) scol[warp * L + cg + CG * j] = v;
      }
    }
    __syncthreads();

    // dx[s][p] = sum_{t >= s} M[t][s] dy[t][p] + w_s (dS B_s)[p], and
    // dw_s = x_s . (dS B_s): rows s = rg*4 + i, columns p = cg + CG*j
    {
      float a1[4][4], u[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) a1[i][j] = u[i][j] = 0.f;
      for (int t = rg * 4; t < L; ++t) {
        float mv[4], yv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = sM[t * LP + rg * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) yv[j] = sDY[t * XP + cg + CG * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) a1[i][j] = fmaf(mv[i], yv[j], a1[i][j]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float bv[4], dv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) bv[i] = sB[(rg * 4 + i) * NP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) dv[j] = sdS[(cg + CG * j) * NP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) u[i][j] = fmaf(bv[i], dv[j], u[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = rg * 4 + i;
        const float ws = sw[s];
        float dwp = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = cg + CG * j, p = p0 + q;
          dwp = fmaf(sX[s * XP + q], u[i][j], dwp);
          if (t0 + s < S && p < P) dx[xo + (long)(t0 + s) * xs + p] = fmaf(ws, u[i][j], a1[i][j]);
        }
        const float v = row_sum(dwp);
        if (cg == 0) sdw[s] = v;
      }
    }

    // dC[t][n] = sum_{s <= t} dG[t][s] B[s][n] + exp(cs_t) Z[t][n] with
    // Z[t][n] = sum_p dy[t][p] S_{c-1}[p][n], and exp(cs_t) C_t . Z_t: rows
    // t = rg*4 + i, columns n = cg + CG*j
    {
      float c1[4][NJ], z[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) c1[i][j] = z[i][j] = 0.f;
      for (int s = 0; s < rg * 4 + 4; ++s) {
        float gv[4], bv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = sdG[(rg * 4 + i) * LP + s];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = cg + CG * j;
          bv[j] = n < N ? sB[s * NP + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) c1[i][j] = fmaf(gv[i], bv[j], c1[i][j]);
      }
#pragma unroll 4
      for (int q = 0; q < PT; ++q) {
        float yv[4], sv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) yv[i] = sDY[(rg * 4 + i) * XP + q];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = cg + CG * j;
          sv[j] = n < N ? sS[q * NP + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) z[i][j] = fmaf(yv[i], sv[j], z[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = rg * 4 + i;
        const float e = secs[t];
        float ip = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = cg + CG * j;
          if (n < N) {
            ip = fmaf(sC[t * NP + n], z[i][j], ip);
            if (t0 + t < S)
              dcp[((part + t0 + t) * H + h) * N + n] = fmaf(e, z[i][j], c1[i][j]);
          }
        }
        const float v = row_sum(ip);
        if (cg == 0) sint[t] = e * v;
      }
    }

    // dB[s][n] = sum_{t >= s} dG[t][s] C[t][n] + w_s (x_s dS)[n]: rows
    // s = rg*4 + i, columns n = cg + CG*j
    {
      float b1[4][NJ], v[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) b1[i][j] = v[i][j] = 0.f;
      for (int t = rg * 4; t < L; ++t) {
        float gv[4], cv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = sdG[t * LP + rg * 4 + i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = cg + CG * j;
          cv[j] = n < N ? sC[t * NP + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) b1[i][j] = fmaf(gv[i], cv[j], b1[i][j]);
      }
#pragma unroll 4
      for (int q = 0; q < PT; ++q) {
        float xv[4], dv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = sX[(rg * 4 + i) * XP + q];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = cg + CG * j;
          dv[j] = n < N ? sdS[q * NP + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) v[i][j] = fmaf(xv[i], dv[j], v[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = rg * 4 + i;
        const float ws = sw[s];
        if (t0 + s >= S) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = cg + CG * j;
          if (n < N) dbp[((part + t0 + s) * H + h) * N + n] = fmaf(ws, v[i][j], b1[i][j]);
        }
      }
    }

    // dS <- exp(cs_L) dS + sum_t exp(cs_t) dy[t]^T C[t], and <dS, S_{c-1}>:
    // rows p = rg*4 + i, columns n = cg + CG*j
    {
      float acc[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
      for (int t = 0; t < L; ++t) {
        const float e = secs[t];
        float yv[4], cv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) yv[i] = sDY[t * XP + rg * 4 + i] * e;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = cg + CG * j;
          cv[j] = n < N ? sC[t * NP + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(yv[i], cv[j], acc[i][j]);
      }
      const float eL = secs[L - 1];
      float ip = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int r = rg * 4 + i, n = cg + CG * j;
          if (n < N) {
            const float old = sdS[r * NP + n];
            ip = fmaf(old, sS[r * NP + n], ip);
            acc[i][j] = fmaf(eL, old, acc[i][j]);
          }
        }
      ip = warp_sum(ip);
      if (lane == 0) sred[warp] = ip;
      __syncthreads();  // every read of the old dS is done
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int r = rg * 4 + i, n = cg + CG * j;
          if (n < N) sdS[r * NP + n] = acc[i][j];
        }
    }
    __syncthreads();  // srow, scol, sdw, sint and sred are complete

    // warp 0: d(cs), its reverse cumsum, ddt and da. Lane l takes steps
    // 63 - l and 31 - l, so that an inclusive scan over the lanes sums
    // each step's later ones.
    if (warp == 0) {
      float ww = sdw[lane] * sw[lane] + sdw[lane + 32] * sw[lane + 32];
      ww = warp_sum(ww);
      float ip = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) ip += sred[w];
      const float eL = secs[L - 1];
      float col[2], dcs[2];
      const int ts[2] = {L - 1 - lane, L / 2 - 1 - lane};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = ts[k];
        float cs = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) cs += scol[w * L + t];
        col[k] = cs;
        dcs[k] = srow[t] - sdt[t] * cs + sint[t] - sdw[t] * sw[t];
      }
      if (lane == 0) dcs[0] += ww + eL * ip;   // step L - 1: cs_L's own terms
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
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = ts[k];
        da_acc = fmaf(sdt[t], rc[k], da_acc);
        if (t0 + t < S)
          ddtp[(part + t0 + t) * H + h] =
              fmaf(A, rc[k], fmaf(sdw[t], expf(scs[L - 1] - scs[t]), col[k]));
      }
    }
  }

  if (dh0 != nullptr) {
    __syncthreads();  // the last update's rows were written by other threads
    for (int i = tid; i < PT * N; i += NT) {
      const int r = i / N, n = i % N, p = p0 + r;
      if (p < P) dh0[so + (long)p * N + n] = sdS[r * NP + n];
    }
  }
  if (warp == 0) {
    da_acc = warp_sum(da_acc);
    if (lane == 0) dap[((long)pt * B + b) * H + h] = da_acc;
  }
}

// dB and dC (B, S, G, N) as the sums of their heads' and p tiles' partials
// (p tiles, B, S, H, N), tile-major then head order: one thread an element
__global__ void __launch_bounds__(256)
ssd_bwd_reduce_bc_kernel(const float* __restrict__ dbp, const float* __restrict__ dcp,
                         float* __restrict__ db, float* __restrict__ dc, int NPT, int B, int S,
                         int H, int G, int N) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;   // (b, s, g, n) of dB
  const long n_out = (long)B * S * G * N;
  if (i >= n_out) return;
  const int n = (int)(i % N), g = (int)((i / N) % G);
  const long bs = i / ((long)N * G);   // b S + s
  const int rep = H / G;
  float sb = 0.f, sc = 0.f;
  for (int pt = 0; pt < NPT; ++pt) {
    const long row = ((long)pt * B * S + bs) * H + (long)g * rep;
    for (int r = 0; r < rep; ++r) {
      sb += dbp[(row + r) * N + n];
      sc += dcp[(row + r) * N + n];
    }
  }
  db[i] = sb;
  dc[i] = sc;
}

// ddt (B, S, H) as the sum of the p tiles' partials; da (H,) as the sum of
// the (p tile, batch) partials: one thread an element
__global__ void __launch_bounds__(256)
ssd_bwd_reduce_dt_kernel(const float* __restrict__ ddtp, const float* __restrict__ dap,
                         float* __restrict__ ddt, float* __restrict__ da, int NPT, int B, int S,
                         int H) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  const long n1 = (long)B * S * H;
  if (i < n1) {
    float v = 0.f;
    for (int pt = 0; pt < NPT; ++pt) v += ddtp[(long)pt * n1 + i];
    ddt[i] = v;
  } else if (i < n1 + H) {
    const int h = (int)(i - n1);
    float v = 0.f;
    for (int k = 0; k < NPT * B; ++k) v += dap[(long)k * H + h];
    da[h] = v;
  }
}

}  // namespace

// All fp32. x, dy, dx (B, S, H, P); dt, ddt (B, S, H); a, da (H,); b, c,
// db, dc (B, S, G, N); h0, dstate, dh0 (B, H, P, N), each may be null. The
// workspaces: states (B, H, ceil(S / 64), P, N); dbp and dcp (p tiles, B,
// S, H, N); ddtp (p tiles, B, S, H); dap (p tiles, B, H), p tiles being
// ceil(P / 64). Launches the three kernels on `stream` and does not
// synchronise; returns cudaGetLastError() after each launch (0 on success).
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* a, const void* b,
                            const void* c, const void* h0, const void* dy, const void* dstate,
                            void* dx, void* ddt, void* da, void* db, void* dc, void* dh0,
                            void* states, void* dbp, void* dcp, void* ddtp, void* dap, int B,
                            int S, int H, int P, int G, int N, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 || N <= 0 || N > NMAX ||
      B > 65535 || H > 65535 || (h0 == nullptr) != (dh0 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The shared-memory opt-in is per device, for the largest N; it is set on
  // a device's first launch and remembered in a bit mask.
  static std::atomic<unsigned long long> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(opted_in.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(NMAX));
    if (err != cudaSuccess) return (int)err;
    opted_in.fetch_or(bit, std::memory_order_relaxed);
  }
  const int NPT = (P + PT - 1) / PT, NC = (S + L - 1) / L;
  ssd_bwd_chunk_kernel<<<dim3(NPT, H, B), NT, smem_bytes(N), st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(c), static_cast<const float*>(h0),
      static_cast<const float*>(dy), static_cast<const float*>(dstate), static_cast<float*>(dx),
      static_cast<float*>(dh0), static_cast<float*>(states), static_cast<float*>(dbp),
      static_cast<float*>(dcp), static_cast<float*>(ddtp), static_cast<float*>(dap), B, S, H, P,
      G, N, NC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n_bc = (long)B * S * G * N;
  ssd_bwd_reduce_bc_kernel<<<(unsigned)((n_bc + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(dbp), static_cast<const float*>(dcp), static_cast<float*>(db),
      static_cast<float*>(dc), NPT, B, S, H, G, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n_dt = (long)B * S * H + H;
  ssd_bwd_reduce_dt_kernel<<<(unsigned)((n_dt + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ddtp), static_cast<const float*>(dap), static_cast<float*>(ddt),
      static_cast<float*>(da), NPT, B, S, H);
  return (int)cudaGetLastError();
}
