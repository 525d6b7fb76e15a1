// The pieces of K3's fp32 route (`ssd_scan.cu`) and K3-bwd
// (`ssd_scan_bwd.cu`) that both use: the chunk-parallel split of the SSD
// scan that Mamba2's own kernels use (Dao and Gu, arXiv:2405.21060, section
// 7), on Hopper's tensor cores as 3xTF32 `mma.sync.m16n8k8` (`mma_tf32.cuh`).
// Per (batch, head), chunks c of L = 64 steps, cs the inclusive cumsum of
// dt a within a chunk, cs_L its last value:
// (a) each chunk's own summary, one CTA per (chunk, 64 columns p, head,
//     batch): `state_chunk` computes s_c = sum_s w_s x_s B_s^T (w_s =
//     exp(cs_L - cs_s) dt_s) or, for the backward, its share of the state's
//     gradient, ds_c = sum_t exp(cs_t) dy_t^T C_t; both a (P x N) product
//     over the chunk's 64 steps, into a workspace (B, H, chunks, P, N);
// (b) the passing across chunks, `pass_chunks`: S_c = exp(cs_L) S_{c-1} +
//     s_c forward from h0, or dS_{c-1} = exp(cs_L) dS_c + ds_c backward from
//     d(final state), one thread 16 elements of the (P, N) state, each
//     chunk's entry replaced in place by the state entering it (S_{c-1}) or
//     the gradient leaving it (dS_c); what is left at the end is the final
//     state, or dh0.
// The third pass (the chunk's outputs given S_{c-1}, or its gradients given
// S_{c-1} and dS_c) is each file's own.
//
// Tiles: fp32 in shared memory, fed by `cp.async` (16-byte copies where
// every row is 16-byte aligned, else 4-byte ones), zeros past S, P and N.
// A bf16 operand (K3-bwd's bf16 route: x, B, C and dy) is widened to fp32
// as it is staged, which is exact, by plain loads (16 bytes, 8 values, where
// every row is 16-byte aligned, else one value a load) and stores; the
// products then take it as any fp32 operand.
// Row pitches are 4 (mod 32) floats, or 20 for the 16-column slabs the
// third passes stream: either keeps the 8 rows an ldmatrix reads, and the
// rows 2 t and 2 t + 1 below, on distinct banks. Two orders of a product's
// k serve the two ways an operand is read:
// - K-major operands (a row of the tile runs along k) load by `ldmatrix`
//   (`load_a`, `load_b_nk` of `mma_tf32.cuh`) in the natural k order (lane
//   4 g + t holding k = t and t + 4), conflict-free at such a pitch; its
//   partner, where MN-major, reads rows t and t + 4 (`load_b_kn`, two-way
//   conflicts).
// - Where both operands are MN-major (a row of the tile runs along m or
//   n), or A is an accumulator fragment, each lane takes k = 2 t and 2 t +
//   1 (`load_a_km2`, `load_b_kn2`): an accumulator's columns 2 t, 2 t + 1
//   are then its A fragment as it stands, and the reads of rows 2 t and
//   2 t + 1 fall on banks 8 t + g (+ 4), conflict-free.
// The sum over k does not depend on which k a lane holds, as long as A and
// B agree.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "mma_tf32.cuh"

namespace ssd {

using tf32x3::FragA;
using tf32x3::FragB;

constexpr int L = 64;        // steps a chunk
constexpr int PT = 64;       // head columns p a CTA
constexpr int NMAX = 128;    // largest state size N
constexpr int XP = PT + 4;   // row pitch of a (64 steps x 64 p) tile, and of L-wide tiles
constexpr int NP = NMAX + 4; // row pitch of a (64 x N) tile held whole
constexpr int STATE_NT = 256;   // threads of `state_chunk`'s CTA
constexpr int PASS_NT = 256;    // threads of `pass_chunks`'s CTA

static_assert(XP % 32 == 4 && NP % 32 == 4, "pitches 4 (mod 32) keep the reads conflict-free");

// the dynamic shared memory of every kernel of the route, 16-byte aligned
// for cp.async and ldmatrix
__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ __align__(16) float ssd_dyn[];
  return ssd_dyn;
}

// ---- fragments in the (2 t, 2 t + 1) k order ---------------------------------

// A[m][k] from a row-major (k, m) tile at `s` (its row 0 is k0, column 0
// is m0), each k row scaled by `scale` (null: 1), split
__device__ __forceinline__ FragA load_a_km2(const float* s, int pitch, int g, int t,
                                            const float* scale = nullptr) {
  const float k0 = scale ? scale[2 * t] : 1.f, k1 = scale ? scale[2 * t + 1] : 1.f;
  const float* r0 = s + (2 * t) * pitch + g;
  const float* r1 = r0 + pitch;
  FragA f;
  tf32x3::split_tf32(r0[0] * k0, f.big[0], f.small[0]);
  tf32x3::split_tf32(r0[8] * k0, f.big[1], f.small[1]);
  tf32x3::split_tf32(r1[0] * k1, f.big[2], f.small[2]);
  tf32x3::split_tf32(r1[8] * k1, f.big[3], f.small[3]);
  return f;
}

// B[k][n] from a row-major (k, n) tile at `s` (row 0 is k0, column 0 n0)
__device__ __forceinline__ FragB load_b_kn2(const float* s, int pitch, int g, int t) {
  FragB f;
  tf32x3::split_tf32(s[(2 * t) * pitch + g], f.big[0], f.small[0]);
  tf32x3::split_tf32(s[(2 * t + 1) * pitch + g], f.big[1], f.small[1]);
  return f;
}

// An accumulator tile (rows g, g + 8; columns 2 t, 2 t + 1) as the A
// fragment of a product over those columns, split
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  FragA f;
  tf32x3::split_tf32(c[0], f.big[0], f.small[0]);
  tf32x3::split_tf32(c[2], f.big[1], f.small[1]);
  tf32x3::split_tf32(c[1], f.big[2], f.small[2]);
  tf32x3::split_tf32(c[3], f.big[3], f.small[3]);
  return f;
}

// ---- copies ------------------------------------------------------------------

// Rows r0 .. r0 + rows - 1 and columns 0 .. width - 1 (width a multiple of
// 4) of a matrix whose row r starts at src + r ld, into `dst` (row pitch
// `pitch`), zeros at rows >= nrows or columns >= ncols. With `vec`, every
// row start is 16-byte aligned and ncols a multiple of 4, so a 16-byte copy
// is whole or empty; without it, 4-byte copies. A CTA of NT threads issues
// the copies; the caller commits and waits.
template <int NT>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const float* __restrict__ src,
                                          long ld, int r0, int rows, int nrows, int width,
                                          int ncols, bool vec) {
  const int cpr = width / 4;
  for (int i = threadIdx.x; i < rows * cpr; i += NT) {
    const int r = i / cpr, col = (i % cpr) * 4, row = r0 + r;
    const bool rin = row < nrows;
    const float* s = src + (rin ? (long)row * ld : 0);
    float* d = dst + r * pitch + col;
    if (vec) {
      const bool in = rin && col < ncols;
      tf32x3::cp_async16(d, in ? s + col : src, in);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = rin && col + j < ncols;
        tf32x3::cp_async4(d + j, in ? s + col + j : src, in);
      }
    }
  }
}

// The same from a bf16 matrix, widened to fp32: width a multiple of 8; with
// `vec`, every row start 16-byte aligned and ncols a multiple of 8, so that
// a 16-byte load of 8 values is whole or empty. Synchronous: the caller's
// barrier makes the stores visible.
template <int NT>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const __nv_bfloat16* __restrict__ src, long ld, int r0,
                                          int rows, int nrows, int width, int ncols, bool vec) {
  const int cpr = width / 8;
  for (int i = threadIdx.x; i < rows * cpr; i += NT) {
    const int r = i / cpr, col = (i % cpr) * 8, row = r0 + r;
    const bool rin = row < nrows;
    float v[8];
    if (vec) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (rin && col < ncols) u = *reinterpret_cast<const uint4*>(src + (long)row * ld + col);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // the lower address in the low half
        v[2 * j] = __uint_as_float(w[j] << 16);
        v[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = rin && col + j < ncols ? __bfloat162float(src[(long)row * ld + col + j]) : 0.f;
    }
    float* d = dst + r * pitch + col;
    *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(d + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// an fp32 result stored in the output's dtype
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void put(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float4 v) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(v.x, v.y);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(v.z, v.w);
}

// ---- the chunk's scan --------------------------------------------------------

// warp 0: the inclusive cumsum of dt a over the chunk (lane l holding steps
// l and l + 32), into scs; w_s = exp(cs_L - cs_s) dt_s into sw and exp(cs_t)
// into secs, each where not null
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
  if (sw != nullptr) {
    sw[lane] = expf(last - v0) * sdt[lane];
    sw[lane + 32] = expf(last - v1) * sdt[lane + 32];
  }
  if (secs != nullptr) {
    secs[lane] = expf(v0);
    secs[lane + 32] = expf(v1);
  }
}

// the chunk's dt (zeros past S) into sdt, by threads 0 .. 63
__device__ __forceinline__ void load_dt(float* sdt, const float* __restrict__ dtb, int t0, int S,
                                        int H) {
  const int i = threadIdx.x;
  if (i < L) sdt[i] = t0 + i < S ? dtb[(long)(t0 + i) * H] : 0.f;
}

// ---- (a) a chunk's own state, or its share of the state's gradient -----------

// Shared memory of `state_chunk`: the (64 steps x 64 p) tile, the (64 x N)
// tile, dt, cs and the step weights.
constexpr size_t STATE_SMEM = sizeof(float) * (L * XP + L * NP + 3 * L);

// out[p][n] = sum_s v[s][p] k_s u[s][n] over the chunk's 64 steps, for
// columns p0 .. p0 + 63: with v = x, u = B, k_s = w_s (kind 0: the chunk's
// state s_c), or v = dy, u = C, k_s = exp(cs_t) (kind 1: its share ds_c of
// the state's gradient). One CTA of 256 threads per (chunk, p tile, head,
// batch); warp w takes rows p 16 (w % 4) .. + 15 and one half of N's
// 8-column tiles. Writes out (B, H, chunks, P, N) and, kind 0 from p tile
// 0, cs_L into decay (B, H, chunks). v and u fp32, or bf16 (K3-bwd's bf16
// route), staged as fp32.
template <typename T>
__device__ __forceinline__ void state_chunk(int kind, const T* __restrict__ v,
                                            const T* __restrict__ u,
                                            const float* __restrict__ dt, float A,
                                            float* __restrict__ out, float* __restrict__ decay,
                                            int b, int h, int c, int pt, int S, int H, int P,
                                            int G, int N, int NC, bool vec) {
  float* sV = dyn_smem();         // [L][XP]
  float* sU = sV + L * XP;        // [L][NP]
  float* sdt = sU + L * NP;       // [L]
  float* scs = sdt + L;           // [L]
  float* sk = scs + L;            // [L] the step weights k_s

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int t0 = c * L, p0 = pt * PT, grp = h / (H / G);
  const int width = (N + 15) / 16 * 16;    // N in whole 16-column pairs of n tiles
  load_tile<STATE_NT>(sV, XP, v + (long)b * S * H * P + (long)h * P + p0, (long)H * P, t0, L, S,
                      PT, P - p0, vec);
  load_tile<STATE_NT>(sU, NP, u + (long)b * S * G * N + (long)grp * N, (long)G * N, t0, L, S,
                      width, N, vec);
  tf32x3::cp_async_commit();
  load_dt(sdt, dt + (long)b * S * H + h, t0, S, H);
  __syncthreads();
  if (warp == 0) {
    scan_chunk(sdt, A, scs, kind == 0 ? sk : nullptr, kind == 0 ? nullptr : sk, lane);
    if (kind == 0 && pt == 0 && lane == 0) decay[((long)b * H + h) * NC + c] = scs[L - 1];
  }
  tf32x3::cp_async_wait<0>();
  __syncthreads();

  const int m0 = 16 * (warp % 4), half = width / 16, j0 = (warp / 4) * half;
  float acc[8][4] = {};
#pragma unroll 2
  for (int kk = 0; kk < L / 8; ++kk) {
    const FragA fa = load_a_km2(sV + kk * 8 * XP + m0, XP, g, t, sk + kk * 8);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < half)
        tf32x3::mma3(acc[j], fa, load_b_kn2(sU + kk * 8 * NP + (j0 + j) * 8, NP, g, t));
  }
  // the tile leaves through shared memory (where u was), so that the stores
  // are whole rows: 16 bytes a thread with vec
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= half) break;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sU[(m0 + g + 8 * (i / 2)) * NP + (j0 + j) * 8 + 2 * t + i % 2] = acc[j][i];
  }
  __syncthreads();
  float* o = out + (((long)b * H + h) * NC + c) * P * N + (long)p0 * N;
  const int rows = min(PT, P - p0);
  if (vec) {
    for (int i = threadIdx.x; i < rows * (N / 4); i += STATE_NT) {
      const int r = i / (N / 4), n = (i % (N / 4)) * 4;
      *reinterpret_cast<float4*>(o + (long)r * N + n) =
          *reinterpret_cast<const float4*>(sU + r * NP + n);
    }
  } else {
    for (int i = threadIdx.x; i < rows * N; i += STATE_NT) {
      const int r = i / N, n = i % N;
      o[(long)r * N + n] = sU[r * NP + n];
    }
  }
}

// ---- (b) the passing across chunks -------------------------------------------

constexpr int PASS_GROUP = 4;   // chunks whose summaries a thread loads before it writes
constexpr int PASS_WIDE = 4;    // vectors a thread, PASS_NT vectors apart

__device__ __forceinline__ float4 fma4(float e, float4 r, float4 s) {
  return make_float4(fmaf(e, r.x, s.x), fmaf(e, r.y, s.y), fmaf(e, r.z, s.z), fmaf(e, r.w, s.w));
}
__device__ __forceinline__ float fma4(float e, float r, float s) { return fmaf(e, r, s); }

// One thread PASS_WIDE vectors V (float4, 16-byte aligned, or float) of a
// head's (P, N) state, at offsets e0 + j step below PN, chunks in order
// (reverse: last first): each chunk's entry of ws, its own summary, is
// replaced by the running value before it, which then becomes exp(cs_L) run
// + summary. A thread loads PASS_GROUP chunks' summaries of its vectors
// before it writes any, so that the loads are in flight together. init
// seeds the run (null: zeros); fin receives what is left (null: dropped).
template <typename V>
__device__ __forceinline__ void pass_elems(bool reverse, float* __restrict__ ws,
                                           const float* __restrict__ dec,
                                           const float* __restrict__ init,
                                           float* __restrict__ fin, long PN, int NC, long e0,
                                           long step) {
  bool in[PASS_WIDE];
  V run[PASS_WIDE];
#pragma unroll
  for (int j = 0; j < PASS_WIDE; ++j) {
    in[j] = e0 + j * step < PN;
    run[j] = V{};
    if (init != nullptr && in[j]) run[j] = *reinterpret_cast<const V*>(init + e0 + j * step);
  }
  for (int c0 = 0; c0 < NC; c0 += PASS_GROUP) {
    V v[PASS_GROUP][PASS_WIDE];
#pragma unroll
    for (int k = 0; k < PASS_GROUP; ++k) {
      const int c = reverse ? NC - 1 - (c0 + k) : c0 + k;
#pragma unroll
      for (int j = 0; j < PASS_WIDE; ++j)
        if (c0 + k < NC && in[j])
          v[k][j] = *reinterpret_cast<const V*>(ws + c * PN + e0 + j * step);
    }
#pragma unroll
    for (int k = 0; k < PASS_GROUP; ++k) {
      const int c = reverse ? NC - 1 - (c0 + k) : c0 + k;
      if (c0 + k >= NC) break;
      const float e = expf(dec[c]);
#pragma unroll
      for (int j = 0; j < PASS_WIDE; ++j)
        if (in[j]) {
          *reinterpret_cast<V*>(ws + c * PN + e0 + j * step) = run[j];
          run[j] = fma4(e, run[j], v[k][j]);
        }
    }
  }
  if (fin != nullptr)
#pragma unroll
    for (int j = 0; j < PASS_WIDE; ++j)
      if (in[j]) *reinterpret_cast<V*>(fin + e0 + j * step) = run[j];
}

// The passing for head (b, h) of ws (B, H, chunks, P, N), decay (B, H,
// chunks) holding cs_L, init and fin (B, H, P, N); `vec4`: P N and every
// pointer's offset a multiple of 4 floats. A CTA covers PASS_NT PASS_WIDE
// vectors of 4 (vec4) or 1 elements.
__device__ __forceinline__ void pass_chunks(bool reverse, float* __restrict__ ws,
                                            const float* __restrict__ decay,
                                            const float* __restrict__ init,
                                            float* __restrict__ fin, int b, int h, int H,
                                            int P, int N, int NC, bool vec4) {
  const long PN = (long)P * N, head = (long)b * H + h, vs = vec4 ? 4 : 1;
  const long e0 = ((long)blockIdx.x * PASS_NT * PASS_WIDE + threadIdx.x) * vs;
  if (e0 >= PN) return;
  float* w = ws + head * NC * PN;
  const float* in = init != nullptr ? init + head * PN : nullptr;
  float* out = fin != nullptr ? fin + head * PN : nullptr;
  if (vec4)
    pass_elems<float4>(reverse, w, decay + head * NC, in, out, PN, NC, e0, PASS_NT * vs);
  else
    pass_elems<float>(reverse, w, decay + head * NC, in, out, PN, NC, e0, PASS_NT);
}

// CTAs of the passing along grid x
inline unsigned pass_ctas(int P, int N, bool vec4) {
  const long per = (long)PASS_NT * PASS_WIDE * (vec4 ? 4 : 1);
  return (unsigned)(((long)P * N + per - 1) / per);
}

// every pointer (null ones aside) 16-byte aligned
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// 16-byte copies are whole or empty for every tile of a call: every row
// start a multiple of 4 floats (8 bf16 values, `per`) from an aligned base
inline bool vec_ok(int P, int N, std::initializer_list<const void*> ptrs, int per = 4) {
  return P % per == 0 && N % per == 0 && aligned16(ptrs);
}

}  // namespace ssd
