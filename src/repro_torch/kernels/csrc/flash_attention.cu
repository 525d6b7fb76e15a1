// K1: causal flash attention for prefill, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/flash_attention.py::flash_attention`
// (body `_flash_kernel`). Same function: scores (q . k^T) * scale in fp32,
// the gemma2 softcap cap*tanh(s/cap) before the mask, an optional causal
// mask and sliding window (row - col < window) with masked logits at -1e30,
// an online softmax, and out = acc / max(l, 1e-30) in q's dtype.
//
// Layout: q and o are (B, S, H, D); k and v are (B, S_kv, KH, D) with KH
// dividing H, query head h reading kv head h / (H / KH). The head-expanded
// cache of the TPU kernel is the case KH == H, so GQA never materialises an
// expanded copy. Any S is accepted: keys past S_kv get -inf (distinct from
// a masked key's -1e30) and rows past S are not stored (the Pallas kernel
// asserted S % block == 0).
//
// S_kv, the keys' own length, is S but for the encoder-decoder's
// cross-attention (queries from the text, keys and values from the
// encoder's frames), which the Pallas kernel did not take (the JAX model
// runs it as plain attention); it is unmasked, so S_kv != S comes without
// a causal mask or a window, and the entry point refuses the two together.
// Both routes take it the same way: K and V are walked to S_kv, their loads
// stop there (the wgmma route's tensor maps have S_kv rows, so TMA fills the
// last tile's rows past S_kv with zeros), and the last key tile masks its
// columns at or past S_kv. A simple extension, not a tuned one.
//
// Two routes, chosen by dtype and head_dim alone (`flash_attention_route`):
// - bf16 at D 64, 128 and 256, which every serving path calls, takes
//   `flash_wgmma_kernel`: both products on the tensor cores in bf16.
// - fp32 at any D, which the training path calls, and bf16 at D 16 take
//   `flash_tf32x3_kernel`: both products on the tensor cores as 3xTF32
//   `mma.sync` (`mma_tf32.cuh`), which keeps the fp32 checks' 2e-5 where
//   one TF32 product (about three decimal digits) would not.
// Both routes write each row's log-sum-exp when asked, which K1-bwd reads:
// the fp32 K1-bwd after the 3xTF32 route, the bf16 K1-bwd after the wgmma
// route (bf16 training at the reference's production dtypes).
//
// Bound on the H100 SXM (989 TFLOP/s bf16 tensor cores, 3.35 TB/s): causal
// FLOPs = 2 * BH * S^2 * D (two products over half the score matrix). At
// qwen3's call (B 4, S 256, 40/8 heads, D 128, bf16) that is 2.7 GFLOP, 2.7
// us on the tensor cores, against 25 MB of q, k, v and o read or written
// once, 7.5 us. At RecurrentGemma's (B 4, S 512, 10 query heads on 1 kv
// head, D 256, window 2048 > S) it is 5.4 GFLOP, 5.4 us, against 23.1 MB (q
// and o 21.0 MB, the single kv head 2.1 MB), 6.9 us. Both calls are bound
// by the bytes; on the fp32 CUDA cores (67 TFLOP/s) the same FLOPs would
// take 40 and 80 us, 5-12x that bound, which is why bf16 goes to wgmma.
//
// Tensor-core design (`flash_wgmma_kernel`): one CTA of one warpgroup per
// (64 query rows, head, batch), one wgmma m64 tile; query tiles launch
// last-first, so the longest rows of the causal triangle start first. TMA
// brings the q tile once and then K and V tiles of BK keys (32 at D <= 128,
// 64 at D 256) as 128B-swizzled slabs, one thread issuing each copy on an
// mbarrier; 4-D tensor maps (D, heads, S, B) zero-fill positions past S.
// S = Q K^T is one wgmma m64nBKk16 per 16 of D, both operands K-major in
// shared memory, scaled in fp32 afterwards; the row max and sum run on the
// accumulator fragment with two quad shuffles; the masks are evaluated only
// on tiles that cross the diagonal, the window's edge or S, and tiles
// wholly above the diagonal or outside the window are never loaded. P,
// rounded to bf16 pairs, is the A operand of O += P V straight from
// registers (its layout is the accumulator's), V the transposed B operand
// (MN-major) from shared memory, one m64n64k16 per 64-wide slab of D. The
// only rounding beyond the fp32 reference is P's (2^-9 relative), far
// inside bf16's 2e-2. A CTA holds one K/V tile (33 KB of shared memory at
// D 128, 97 KB at D 256), so with their registers four CTAs share an SM at
// D 128 and two at D 256, and one CTA's loads overlap the others' products:
// at the serving calls' short S (one to eight K/V tiles a CTA) that
// measured faster on the H100 than a two-stage ring with fewer CTAs, and
// than two warpgroups sharing 128-key tiles.
//
// 3xTF32 design (`flash_tf32x3_kernel`), after K1-bwd's dQ kernel: one
// CTA of 8 warps per (32 query rows, head, batch), the last query tiles
// (which walk the most keys) first. Q stays in shared memory as fp32; K and
// V tiles of 32 keys stream in by 16-byte cp.async into one stage, the next
// tile's copies issued once every warp is done with the current one; tiles
// wholly outside the mask are never loaded, and only tiles that cross the
// diagonal, the window's edge or S compute the mask. S = Q K^T: one m16n8
// tile a warp over D / 8 k-steps, each fp32 operand split in registers into
// TF32 big and small parts and each product taken as three TF32 mma. The
// online softmax runs on the accumulator fragment in fp32: the row max over
// a warp's 8 keys by quad shuffles, over the tile's 32 by one pass through
// shared memory; each thread keeps its rows' max (the same in the four
// warps that share them) and a partial sum over its own score columns, the
// partials summed in a fixed order at the end. P goes to a 32 x 36 shared
// tile (the accumulator's layout is not the A operand's), then O += P V:
// each warp 16 rows x D / 4 dims in registers, rescaled by exp(m_old -
// m_new) before each tile's product; at D 16 the warps split the tile's
// keys as well and sum the splits through shared memory. bf16 (at D 16) is
// widened to fp32 as it is staged, exactly, and rounded to bf16 on store.
// Shared memory at D 256: Q, K and V (3 x 33.3 KB) and P, 103 KB, so two
// CTAs share an SM and one's loads overlap the other's products; at most
// 128 registers a thread (__launch_bounds__(256, 2)).
//
// Why one stage: the only fp32 call on any path is the training call below
// (D 256), where a second K/V stage (174 KB, one CTA an SM, the next tile
// loading behind the current tile's products) measured slower on the H100
// (NVIDIA H100 80GB HBM3, 700 W; tools/k1_fwd_variants.py, which builds it
// as the patch `two_stages`): 0.0576 and 0.0574 ms with one stage, 0.0594
// and 0.0595 with two, in one call. At qwen3's shape in fp32 (B 4, S 256,
// 40/8 heads, D 128), which no path launches, two stages would be faster
// (0.0943 against 0.0994). A 16-warp variant that split the score
// product's D over two warp groups was slower at both shapes and is gone.
// PR 21's fp32 CUDA-core kernel, which this route replaced, took 0.1670
// at the training call in the same call. Registers: 122 at D 256, 73-105
// at the others, no spills.
//
// Bound at the training call (B 4, S 256, 10 query heads on 1 kv head,
// D 256, fp32, window 2048 > S): two products over the 32896 pairs of each
// (batch, head) that the mask keeps, 1.35 GFLOP; as 3xTF32 (495 / 3
// TFLOP/s) 8.2 us against 23.1 MB of q, k, v, o and lse, 6.9 us: bound by
// the operations. On the fp32 CUDA cores (67 TFLOP/s) the same FLOPs take
// 20.1 us.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr float NEG_INF = -1e30f;   // a masked logit, as in the Pallas kernel

// ---- the 3xTF32 route (fp32 at every D, bf16 at D 16) ---------------------

namespace x3 {

using namespace tf32x3;

constexpr int NT = 256;        // threads a CTA: 8 warps
constexpr int BQ = 32;         // query rows a CTA
constexpr int BK = 32;         // keys a K/V tile
constexpr int SP = 36;         // padded row of the P tile

// The warps of a CTA: in S = Q K^T warp w takes one m16n8 tile, rows
// 16 (w & 1) .. and keys 8 (w / 2) .. of the 32 x 32 tile, over all of D;
// in O += P V it takes the same 16 rows by NTW n-tiles of 8 dims (n-block
// NB of them) over 32 / KS of the tile's keys (k-split KS), the splits
// summed at the end in a fixed order. A thread holds the same two rows in
// both products.
template <int D>
struct Cfg {
  static constexpr int P = row_pitch<D>;          // padded row of Q, K and V
  static constexpr int TILE = 32 * P;             // floats of one 32-row tile
  static constexpr int NB = D / 8 < 4 ? D / 8 : 4;   // n-blocks of O
  static constexpr int NTW = D / (8 * NB);        // n-tiles of 8 dims a warp
  static constexpr int KS = 4 / NB;               // 8 warps = 2 x NB x KS
  // Q, K, V, P, and the four key quarters' row partials
  static constexpr int SMEM = (int)sizeof(float) * (3 * TILE + BQ * SP + 4 * BQ);
  static_assert(D % 16 == 0 && BQ == 32 && BK == 32 && NT == 256,
                "the warp layout assumes these");
  static_assert(KS - 1 <= 3, "the k-splits' partial sums go through Q, K and V");
};

// the largest of the four key quarters' partials of tile row r
__device__ __forceinline__ float quarters_max(const float* srow, int r) {
  return fmaxf(fmaxf(srow[r], srow[BQ + r]), fmaxf(srow[2 * BQ + r], srow[3 * BQ + r]));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 2)
flash_tf32x3_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, float* __restrict__ lse, int B, int S, int Skv, int H,
                    int KH, float scale, int causal, int window, float softcap) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                      // [BQ][P]
  float* sk = sq + C::TILE;              // [BK][P]
  float* sv = sk + C::TILE;              // [BK][P]
  float* sp = sv + C::TILE;              // [BQ][SP]: P of the current tile
  float* srow = sp + BQ * SP;            // [4][BQ]: each key quarter's row max; at the end, row sum

  // last query tiles first: under a causal mask they walk the most keys
  const int n_qt = (S + BQ - 1) / BQ;
  const int h = blockIdx.x % H, b = (blockIdx.x / H) % B;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / ((unsigned)H * B))) * BQ;
  const int kh = h / (H / KH);
  const long qs = (long)H * D, ks = (long)KH * D;
  const T* kb = k + (long)b * Skv * ks + (long)kh * D;
  const T* vb = v + (long)b * Skv * ks + (long)kh * D;

  // Tiles wholly above the diagonal or wholly outside the window hold only
  // masked logits; with at least one valid key per row they add exp(-1e30 -
  // m) == 0, so skipping them is exact.
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;

  load_tile<D, NT>(sq, q + (long)b * S * qs + (long)h * D, q0, S, qs);
  load_tile<D, NT>(sk, kb, kv_begin, Skv, ks);
  load_tile<D, NT>(sv, vb, kv_begin, Skv, ks);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wm = warp & 1;                           // rows wm * 16 ..
  const int wn = warp / 2;                           // scores: keys wn * 8 ..
  const int nblk = warp / 2 % C::NB, split = warp / 2 / C::NB;   // P V: dims and keys
  constexpr int KPS = BK / 8 / C::KS;                // k-steps of a split
  const int r0 = wm * 16 + g, r1 = r0 + 8;           // this thread's two rows of the tile
  float acc[C::NTW][4];
#pragma unroll
  for (int j = 0; j < C::NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // the rows' running max (the same in every warp of rows wm * 16 ..) and
  // the running sum over the thread's two columns
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    cp_async_wait<0>();
    __syncthreads();   // tile k0 has landed

    // S = Q K^T: element i of the fragment is row r0 (i < 2) or r1, key
    // wn * 8 + 2 t + i % 2; then scaled, capped and (on edge tiles) masked
    float x[4];
    score_tile<D>(sq + wm * 16 * C::P, sk + wn * 8 * C::P, lane, x);
    const bool edge = edge_tile<BQ, BK>(q0, k0, S, causal, window) || k0 + BK > Skv;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float s = x[i] * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      if (edge) {
        const int row = q0 + (i < 2 ? r0 : r1), col = k0 + wn * 8 + 2 * t + i % 2;
        bool ok = true;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && (row - col) < window;
        s = ok ? s : NEG_INF;
        if (col >= Skv) s = -INFINITY;  // past the ragged end: no key at all
      }
      x[i] = s;
      if (i < 2)
        mx0 = fmaxf(mx0, s);
      else
        mx1 = fmaxf(mx1, s);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    if (t == 0) {
      srow[wn * BQ + r0] = mx0;
      srow[wn * BQ + r1] = mx1;
    }
    __syncthreads();

    // the online softmax: the new row max, P into shared memory, its sums,
    // and the accumulator rescaled by exp(m_old - m_new)
    const float mn0 = fmaxf(m0, quarters_max(srow, r0)), mn1 = fmaxf(m1, quarters_max(srow, r1));
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    const float p0 = expf(x[0] - mn0), p1 = expf(x[1] - mn0);
    const float p2 = expf(x[2] - mn1), p3 = expf(x[3] - mn1);
    l0 = l0 * c0 + (p0 + p1);
    l1 = l1 * c1 + (p2 + p3);
    store2(sp + r0 * SP + wn * 8 + 2 * t, p0, p1);
    store2(sp + r1 * SP + wn * 8 + 2 * t, p2, p3);
#pragma unroll
    for (int j = 0; j < C::NTW; ++j) {
      acc[j][0] *= c0;
      acc[j][1] *= c0;
      acc[j][2] *= c1;
      acc[j][3] *= c1;
    }
    __syncthreads();

    // O += P V over the split's keys: rows wm * 16 .., dims (nblk NTW + j) * 8 ..
#pragma unroll
    for (int kk = split * KPS; kk < (split + 1) * KPS; ++kk) {
      const FragA fa = load_a(sp + wm * 16 * SP + kk * 8, SP, lane);
#pragma unroll
      for (int j = 0; j < C::NTW; ++j)
        mma3(acc[j], fa, load_b_kn(sv + kk * 8 * C::P + (nblk * C::NTW + j) * 8, C::P, g, t));
    }
    if (k0 + BK < kv_end) {   // the next tile, once every warp is done with this one
      __syncthreads();
      load_tile<D, NT>(sk, kb, k0 + BK, Skv, ks);
      load_tile<D, NT>(sv, vb, k0 + BK, Skv, ks);
      cp_async_commit();
    }
  }
  // the k-splits' partials go through Q, K and V once every warp is done
  // with them; srow holds the row sums (its maxima were last read before
  // the last tile's second barrier)
  if (C::KS > 1) __syncthreads();
  sum_k_splits<D, C::KS, C::NTW>(acc, smem, 0, split, wm * 16, nblk * C::NTW, g, t);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (t == 0) {
    srow[wn * BQ + r0] = l0;
    srow[wn * BQ + r1] = l1;
  }
  __syncthreads();
  if (split > 0) return;

  T* ob = o + (long)b * S * qs + (long)h * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = hr ? r1 : r0, row = q0 + r;
    if (row >= S) continue;
    const float den =
        fmaxf((srow[r] + srow[BQ + r]) + (srow[2 * BQ + r] + srow[3 * BQ + r]), 1e-30f);
#pragma unroll
    for (int j = 0; j < C::NTW; ++j)
      store2(ob + (long)row * qs + (nblk * C::NTW + j) * 8 + 2 * t, acc[j][2 * hr] / den,
             acc[j][2 * hr + 1] / den);
    // the row's log-sum-exp of the scaled, capped, masked logits, which
    // the backward (flash_attention_bwd.cu) recomputes P from
    if (lse && nblk == 0 && t == 0) lse[((long)b * H + h) * S + row] = (hr ? m1 : m0) + logf(den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S, int Skv,
           int H, int KH, float scale, int causal, int window, float softcap, cudaStream_t stream) {
  using C = Cfg<D>;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = hopper::opt_in_smem((const void*)flash_tf32x3_kernel<T, D>, C::SMEM, opted_in);
  if (err != cudaSuccess) return (int)err;
  const unsigned ctas = (unsigned)((S + BQ - 1) / BQ) * B * H;
  flash_tf32x3_kernel<T, D><<<ctas, NT, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), B, S, Skv, H, KH, scale, causal, window,
      softcap);
  return (int)cudaGetLastError();
}

}  // namespace x3

// ---- the tensor-core route (bf16, D 64 / 128 / 256) ------------------------

namespace tc {

constexpr int THREADS = 128;   // one warpgroup
constexpr int BQ = 64;         // query rows per CTA: one wgmma m64 tile

template <int D>
struct Cfg {
  static constexpr int BK = D > 128 ? 64 : 32;    // keys per KV tile
  static constexpr int NS = D / 64;               // 128-byte slabs per row
  static constexpr int Q_SLAB = BQ * 128;         // bytes
  static constexpr int KV_SLAB = BK * 128;
  static constexpr int Q_BYTES = NS * Q_SLAB;
  static constexpr int KV_BYTES = NS * KV_SLAB;   // K (or V) of one tile
  // 1024 bytes of slack to align the slabs, then q, K, V and two barriers
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * KV_BYTES + 16;
};

// S (64 x BK) (+)= Q (64 x 16) . K^T (16 x BK), both K-major in shared memory.
template <int BK>
__device__ __forceinline__ void qk_step(float (&s)[BK / 2], uint64_t a, uint64_t b,
                                        int accumulate) {
  if constexpr (BK == 64)
    hopper::wgmma_m64n64k16_ss(s, a, b, accumulate);
  else
    hopper::wgmma_m64n32k16_ss(s, a, b, accumulate);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, int S, int Skv, int H, int KH, float scale,
                   int causal, int window, float softcap) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, NS = C::NS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;  // q: NS slabs
  const uint32_t sk = sq + C::Q_BYTES, sv = sk + C::KV_BYTES;          // K, V: NS slabs each
  const uint32_t qbar = sv + C::KV_BYTES, kvbar = qbar + 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // last query tile first
  const int kh = h / (H / KH);

  // Tiles wholly above the diagonal or wholly outside the window hold only
  // masked logits; with at least one valid key per row they add exp(-1e30 -
  // m) == 0, so skipping them is exact.
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int n_tiles = (kv_end - kv_begin + BK - 1) / BK;

  auto load_kv = [&](int tile) {
    const int k0 = kv_begin + tile * BK;
    hopper::mbar_arrive_expect_tx(kvbar, 2 * C::KV_BYTES);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      hopper::tma_load_4d(sk + s * C::KV_SLAB, &tk, kvbar, 64 * s, kh, k0, b);
      hopper::tma_load_4d(sv + s * C::KV_SLAB, &tv, kvbar, 64 * s, kh, k0, b);
    }
  };

  if (tid == 0) {
    hopper::prefetch_tensormap(&tq);
    hopper::prefetch_tensormap(&tk);
    hopper::prefetch_tensormap(&tv);
    hopper::mbar_init(qbar, 1);
    hopper::mbar_init(kvbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
    for (int s = 0; s < NS; ++s)
      hopper::tma_load_4d(sq + s * C::Q_SLAB, &tq, qbar, 64 * s, h, q0, b);
    load_kv(0);
  }
  __syncwarp();

  // This thread's two rows of the accumulator fragments.
  const int row0 = q0 + 16 * warp + lane / 4, row1 = row0 + 8;
  float oacc[NS][32];
  float sacc[BK / 2];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[s][i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // l: this thread's partial sums

  hopper::mbar_wait(qbar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_begin + it * BK;
    // one K/V buffer: the previous tile's readers finished at the end of
    // the last iteration; the other CTAs on the SM hide this load
    if (tid == 0 && it > 0) load_kv(it);
    __syncwarp();
    hopper::mbar_wait(kvbar, it & 1);
    __syncwarp();

    // S = Q K^T: D/16 k-steps, four per 64-wide slab, 32 bytes apart
    hopper::reg_fence(sacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const uint64_t da = hopper::desc_sw128(sq + (j / 4) * C::Q_SLAB + (j % 4) * 32, 16, 1024);
      const uint64_t db = hopper::desc_sw128(sk + (j / 4) * C::KV_SLAB + (j % 4) * 32, 16, 1024);
      qk_step<BK>(sacc, da, db, j > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::reg_fence(sacc);

    // scale, softcap and (on edge tiles only) the masks; the row maxima
    const bool edge = (causal && k0 + BK - 1 > q0) || (window > 0 && q0 + BQ - 1 - k0 >= window) ||
                      k0 + BK > Skv;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = sacc[i] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      if (edge) {
        const int col = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const int row = (i % 4) < 2 ? row0 : row1;
        bool ok = true;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && (row - col) < window;
        x = ok ? x : NEG_INF;
        if (col >= Skv) x = -INFINITY;  // past the ragged end: no key at all
      }
      sacc[i] = x;
      if ((i % 4) < 2)
        mx0 = fmaxf(mx0, x);
      else
        mx1 = fmaxf(mx1, x);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;

    // P in bf16 pairs: registers 8kk .. 8kk+7 of S are A's k16 block kk
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const bool first = (i % 4) < 2;
      const float mm = first ? mn0 : mn1;
      const float p0 = __expf(sacc[i] - mm), p1 = __expf(sacc[i + 1] - mm);
      if (first)
        l0 += p0 + p1;
      else
        l1 += p0 + p1;
      pf[i / 8][(i % 8) / 2] = hopper::pack_bf16(p0, p1);
    }
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[s][i] *= (i % 4) < 2 ? c0 : c1;

    // O += P V: per 16 keys, one m64n64k16 per 64-wide slab of D
#pragma unroll
    for (int s = 0; s < NS; ++s) hopper::reg_fence(oacc[s]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const uint64_t db =
            hopper::desc_sw128(sv + s * C::KV_SLAB + kk * 16 * 128, C::KV_SLAB, 1024);
        hopper::wgmma_m64n64k16_rs_tb(oacc[s], pf[kk], db);
      }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < NS; ++s) hopper::reg_fence(oacc[s]);
    __syncthreads();  // every warp is done with this K/V tile: it may be refilled
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / den0, inv1 = 1.f / den1;
  const long qs = (long)H * D;  // stride of one position in q / o
  __nv_bfloat16* ob = o + (long)b * S * qs + (long)h * D;
  // each row's log-sum-exp of the scaled, capped, masked logits, for the
  // bf16 backward (flash_attention_bwd.cu), as the 3xTF32 route writes it:
  // the quad of lanes that holds a row has its max and whole sum
  if (lse != nullptr && lane % 4 == 0) {
    float* lb = lse + ((long)b * H + h) * S;
    if (row0 < S) lb[row0] = m0 + logf(den0);
    if (row1 < S) lb[row1] = m1 + logf(den1);
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * s + 8 * j + 2 * (lane % 4);
      if (row0 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long)row0 * qs + col) =
            __floats2bfloat162_rn(oacc[s][4 * j] * inv0, oacc[s][4 * j + 1] * inv0);
      if (row1 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long)row1 * qs + col) =
            __floats2bfloat162_rn(oacc[s][4 * j + 2] * inv1, oacc[s][4 * j + 3] * inv1);
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S, int Skv,
           int H, int KH, float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = hopper::tma_map_bshd(&tq, q, B, S, H, D, BQ);
  if (err == cudaSuccess) err = hopper::tma_map_bshd(&tk, k, B, Skv, KH, D, C::BK);
  if (err == cudaSuccess) err = hopper::tma_map_bshd(&tv, v, B, Skv, KH, D, C::BK);
  if (err != cudaSuccess) return (int)err;
  static std::atomic<unsigned long long> opted_in{0};
  err = hopper::opt_in_smem((const void*)flash_wgmma_kernel<D>, C::SMEM, opted_in);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_wgmma_kernel<D><<<grid, THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S, Skv, H, KH, scale,
      causal, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// 1 if (dtype, D) takes the wgmma route, 0 if the 3xTF32 one.
extern "C" int flash_attention_route(int dtype, int D) {
  return dtype == 1 && (D == 64 || D == 128 || D == 256);
}

// dtype: 0 float32, 1 bfloat16. q and o have S rows, k and v S_kv; S_kv !=
// S is refused with a causal mask or a window. `lse`, null or fp32 (B, H,
// S), receives each row's log-sum-exp for the backward, on both routes. The 3xTF32 route
// copies q, k and v in 16-byte pieces: every pointer must be 16-byte
// aligned. Returns cudaGetLastError() after the launch (0 on success);
// launches on `stream` and does not synchronise.
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v, void* o,
                               int B, int S, int S_kv, int H, int KH, int D, float scale,
                               int causal, int window, float softcap, void* lse, void* stream) {
  if (B <= 0 || S <= 0 || S_kv <= 0 || H <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  if (S_kv != S && (causal || window > 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flash_attention_route(dtype, D)) {
    switch (D) {
#define K1_TC_ARGS q, k, v, o, lse, B, S, S_kv, H, KH, scale, causal, window, softcap, st
      case 64: return tc::launch<64>(K1_TC_ARGS);
      case 128: return tc::launch<128>(K1_TC_ARGS);
      default: return tc::launch<256>(K1_TC_ARGS);
#undef K1_TC_ARGS
    }
  }
  if ((long)((S + 31) / 32) * B * H > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, (const void*)o, (const void*)lse})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
#define K1_X3_ARGS q, k, v, o, lse, B, S, S_kv, H, KH, scale, causal, window, softcap, st
  if (dtype == 0) {
    switch (D) {
      case 16: return x3::launch<float, 16>(K1_X3_ARGS);
      case 64: return x3::launch<float, 64>(K1_X3_ARGS);
      case 128: return x3::launch<float, 128>(K1_X3_ARGS);
      case 256: return x3::launch<float, 256>(K1_X3_ARGS);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1 && D == 16) return x3::launch<__nv_bfloat16, 16>(K1_X3_ARGS);
#undef K1_X3_ARGS
  return (int)cudaErrorInvalidValue;
}
