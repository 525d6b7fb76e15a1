// fp32 products on Hopper's tensor cores as 3xTF32 `mma.sync.m16n8k8`, and
// the streamed fp32 tiles that feed them: the building blocks shared by K1's
// fp32 route (`flash_attention.cu`, `flash_tf32x3_kernel`) and K1-bwd
// (`flash_attention_bwd.cu`). Raw PTX, as in NVIDIA's PTX ISA for sm_80 and
// later; nothing here is a finished kernel.
//
// Arithmetic: each fp32 operand x is split in registers into big = x rounded
// to TF32 (to nearest, as cvt.rna.tf32.f32) and small = x - big (which the
// tensor core truncates to TF32), and each product is taken as
// a_small b_big + a_big b_small, then a_big b_big, into fp32 accumulators
// ("3xTF32"; the a_small b_small term, about 2^-21 of the product, is
// dropped). This is the arithmetic of SDPA's fp32 path, PyTorch's
// memory-efficient attention, whose fp32 operator is CUTLASS's
// OpMultiplyAddFastF32 on GemmShape<16, 8, 8>: fp32-grade error, where one
// TF32 product (a 10-bit mantissa) would not keep it.
//
// Layout: a tile is 32 rows of D fp32 values in shared memory, rows padded
// to D + 4 floats (`row_pitch<D>`), so that ldmatrix (which reads an fp32
// fragment of 8 rows x 4 columns as an 8 x 8 b16 matrix: the A operand, and
// B from a row-major (n, k) tile) finds its 8 rows in distinct banks, a
// scalar read of 4 rows x 8 columns (B from a row-major (k, n) tile)
// conflicts at most two ways, and every row start stays 16-byte aligned for
// cp.async and ldmatrix. Each PTX instruction sits in a helper of its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace tf32x3 {

template <int D>
constexpr int row_pitch = D + 4;   // floats a row of a staged tile

// ---- the tensor-core product ---------------------------------------------------

// x = big + small, each a TF32 operand: big is x rounded to TF32 (10
// mantissa bits) to nearest, ties away from zero, the value cvt.rna.tf32.f32
// gives, here in two integer ops (the conversion is a quarter-rate
// instruction, and two of them an element would limit the kernels);
// small = x - big is exact in fp32, and the tensor core reads its top 19
// bits (truncation toward zero). CUTLASS's OpMultiplyAddFastF32 rounds the
// same way (big: round_half_ulp_truncate, small: round_toward_zero).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment (16 x 8, rows g and g + 8, columns t and t + 4 of lane
// 4 g + t) and B fragment (8 x 8, rows t and t + 4, column g), split
struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

// ldmatrix of 8 x 8 b16 matrices is, in 32-bit words, 8 rows x 4 fp32
// columns, lane 4 g + t taking row g, column t: an fp32 fragment's layout.
// Lane l gives the row address of row l % 8 of matrix l / 8; every address
// 16-byte aligned.
__device__ __forceinline__ void ldsm_x4(const float* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(const float* p, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(hopper::smem_u32(p)));
}

// A from a row-major tile at `s` (row pitch `pitch`): 8 rows x 4 columns,
// as four ldmatrix matrices (rows 0-7 and 8-15 at columns 0 and 4)
__device__ __forceinline__ FragA load_a(const float* s, int pitch, int lane) {
  const int m = lane / 8;
  uint32_t x[4];
  ldsm_x4(s + (lane % 8 + 8 * (m & 1)) * pitch + 4 * (m >> 1), x);
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), f.big[i], f.small[i]);
  return f;
}

// B[k][n] from a row-major (n, k) tile: 8 rows x 4 columns, as two
// ldmatrix matrices (columns 0 and 4)
__device__ __forceinline__ FragB load_b_nk(const float* s, int pitch, int lane) {
  uint32_t x[2];
  ldsm_x2(s + (lane % 8) * pitch + 4 * ((lane / 8) & 1), x);
  FragB f;
  split_tf32(__uint_as_float(x[0]), f.big[0], f.small[0]);
  split_tf32(__uint_as_float(x[1]), f.big[1], f.small[1]);
  return f;
}

// B[k][n] from a row-major (k, n) tile: 4 rows x 8 columns
__device__ __forceinline__ FragB load_b_kn(const float* s, int pitch, int g, int t) {
  FragB f;
  split_tf32(s[t * pitch + g], f.big[0], f.small[0]);
  split_tf32(s[(t + 4) * pitch + g], f.big[1], f.small[1]);
  return f;
}

// c += a . b as 3xTF32: the small terms first, then the big one
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// the same into two accumulators, small terms and big, for two shorter
// chains of dependent mma in the score products' long k-loops
__device__ __forceinline__ void mma3_two(float (&lo)[4], float (&hi)[4], const FragA& a,
                                         const FragB& b) {
  mma_tf32(lo, a.small, b.big);
  mma_tf32(lo, a.big, b.small);
  mma_tf32(hi, a.big, b.big);
}

// A warp's m16n8 tile of A.B^T over D columns, A rows at `a`, B rows at
// `b` (both row-major (row, d), pitch row_pitch<D>), in four accumulator
// chains; returns the sums: element i is row g + 8 (i / 2), column
// 2 t + i % 2
template <int D>
__device__ __forceinline__ void score_tile(const float* a, const float* b, int lane,
                                           float (&x)[4]) {
  constexpr int P = row_pitch<D>;
  float lo[2][4] = {}, hi[2][4] = {};
#pragma unroll 4
  for (int kk = 0; kk < D / 8; ++kk)
    mma3_two(lo[kk & 1], hi[kk & 1], load_a(a + kk * 8, P, lane), load_b_nk(b + kk * 8, P, lane));
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = (lo[0][i] + hi[0][i]) + (lo[1][i] + hi[1][i]);
}

// A D-wide product's KS k-splits summed in a fixed order: splits 1 .. KS - 1
// write their accumulators to their regions of `red` (32 x row_pitch<D>
// each), and after the CTA's barrier split 0 adds them in order. Every
// thread calls it; acc (element i: row rm + g + 8 (i / 2), dim
// (n0 + j) * 8 + 2 t + i % 2) holds the sum only in split 0's warps
// afterwards.
template <int D, int KS, int NTW>
__device__ __forceinline__ void sum_k_splits(float (&acc)[NTW][4], float* red, int region,
                                             int split, int rm, int n0, int g, int t) {
  constexpr int P = row_pitch<D>, TILE = 32 * P;
  if (KS == 1) return;
  if (split > 0) {
    float* r = red + (region * (KS - 1) + split - 1) * TILE;
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[(rm + g + 8 * (i / 2)) * P + (n0 + j) * 8 + 2 * t + i % 2] = acc[j][i];
  }
  __syncthreads();
  if (split > 0) return;
  for (int s = 1; s < KS; ++s) {
    const float* r = red + (region * (KS - 1) + s - 1) * TILE;
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[j][i] += r[(rm + g + 8 * (i / 2)) * P + (n0 + j) * 8 + 2 * t + i % 2];
  }
}

// ---- copies ------------------------------------------------------------------

// 16 or 4 bytes from global to shared memory, zeros when !in (src is then
// not read, but kept a valid address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows r0 .. r0 + 31 of a (B, S, heads, D) fp32 tensor at (b, head) (`src`
// its row 0) into a tile of fp32 rows of row_pitch<D>, zeros past S, by
// 16-byte cp.async (awaited with cp_async_wait); a CTA of NT threads
// issues the copies
template <int D, int NT>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int r0, int S,
                                          long stride) {
  constexpr int CPR = D / 4;   // 16-byte copies a row
  for (int i = threadIdx.x; i < 32 * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 4, row = r0 + r;
    const bool in = row < S;
    cp_async16(dst + r * row_pitch<D> + c, src + (long)(in ? row : 0) * stride + c, in);
  }
}

// the same rows of a bf16 tensor, by 16-byte loads widened to fp32 on the
// way, which is exact (a bf16 value is a TF32 value: its small part is 0);
// the stores land before the barrier that follows, as cp.async's do once
// awaited
template <int D, int NT>
__device__ __forceinline__ void load_tile(float* dst, const __nv_bfloat16* __restrict__ src,
                                          int r0, int S, long stride) {
  constexpr int CPR = D / 8;   // 16-byte loads a row
  for (int i = threadIdx.x; i < 32 * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 8, row = r0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row < S) raw = *reinterpret_cast<const uint4*>(src + (long)row * stride + c);
    // a word holds two bf16, the first in its low half; a bf16 is the top
    // half of the fp32 of the same value
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    float f[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
    float4* d = reinterpret_cast<float4*>(dst + r * row_pitch<D> + c);
    d[0] = make_float4(f[0], f[1], f[2], f[3]);
    d[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// one or two fp32 values stored as fp32, or rounded to bf16 (to nearest
// even)
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// whether the tile of BQ query rows q0.. and BK keys k0.. needs its mask: it
// crosses the diagonal, the window's edge or S
template <int BQ, int BK>
__device__ __forceinline__ bool edge_tile(int q0, int k0, int S, int causal, int window) {
  return q0 + BQ > S || k0 + BK > S || (causal && k0 + BK - 1 > q0) ||
         (window > 0 && q0 + BQ - 1 - k0 >= window);
}

}  // namespace tf32x3
