// K1-bwd: the gradient of causal flash attention, hand-written for Hopper
// (sm_90a), fp32 in and out, its products on the tensor cores as 3xTF32
// (the same kernels also take bf16 at head_dim 16, below); and a bf16 route
// (namespace `bf`, below: `wgmma` on TMA-fed 64-row tiles) for training in
// bf16 at head_dim 64, 128 and 256.
//
// The TPU kernel `repro/kernels/flash_attention.py::flash_attention` has no
// backward: the JAX package differentiates its plain attention
// (`repro/nn/attention.py::attend_ref`). This computes what `jax.vjp` of
// that function computes, for the forward of `flash_attention.cu`: with
// x = (q . k) * scale, t = cap * tanh(x / cap) (or x without a softcap),
// the causal mask and the window (row - col < window) at -1e30, and
// P = exp(t - lse) from the forward's log-sum-exp per row,
//   dV_j = sum_i P_ij dO_i
//   dT_ij = P_ij (dO_i . V_j - Delta_i),   Delta_i = dO_i . O_i
//   dX_ij = dT_ij (1 - tanh^2(x_ij / cap))  (dT_ij without a softcap)
//   dQ_i = scale sum_j dX_ij K_j,  dK_j = scale sum_i dX_ij Q_i
// where dK and dV of a kv head sum over its H / KH query heads. Masked
// pairs and keys past S_kv have P = 0, so they add nothing.
//
// Layout: q, o, dO and dQ are (B, S, H, D); k, v, dK and dV (B, S_kv, KH,
// D) with KH dividing H; lse and Delta (B, H, S). All fp32, every pointer
// 16-byte aligned.
//
// bf16 at head_dim 16 (the smoke configs' width, which no wgmma tile
// takes; K1's forward runs it on its 3xTF32 route too) takes these kernels
// with the element type T a template argument: q, k, v, o and dO are read
// as bf16 and widened to fp32 exactly as they are staged (a bf16 value is a
// TF32 value, its small part 0, so the products are exact products of the
// inputs), and dQ, dK and dV are rounded to bf16 once on their store; dK
// and dV always go through the fp32 workspace of query heads' shares and
// the reduce kernel, which rounds their sums. So the result is the fp32
// route's on the widened inputs, rounded once: the plain version's
// (``ops.flash_attention_bwd_plain`` on bf16 inputs). Entry
// `flash_attention_bwd_tf32x3_bf16`. S_kv, the keys' own length, is S but for the
// encoder-decoder's cross-attention (text queries over the encoder's
// frames), which is unmasked, as in the forward: no causal mask and no
// window with S_kv != S. The delta pass walks the S query rows, the dK/dV
// kernel the S_kv keys (its grid and its stores), the dQ walk ends at S_kv,
// and a tile crossing S or S_kv masks its rows or keys.
//
// Arithmetic: the five products (K.Q^T, V.dO^T, P^T.dO, dX^T.Q, dX.K) run
// on the tensor cores, `mma.sync.m16n8k8` in TF32, each fp32 operand x
// split in registers into big = x rounded to TF32 (to nearest, as
// cvt.rna.tf32.f32) and small = x - big (which the tensor core truncates to
// TF32), and each product taken as a_small b_big + a_big b_small, then
// a_big b_big, into fp32 accumulators ("3xTF32"; the a_small b_small term,
// about 2^-21 of the product, is dropped). This is the arithmetic of SDPA's
// fp32 path, PyTorch's memory-efficient attention, whose fp32 operator is
// CUTLASS's OpMultiplyAddFastF32 on GemmShape<16, 8, 8>: it keeps fp32-grade
// error, where one TF32 product (a 10-bit mantissa) would not. The helpers
// (the split, the fragments, the products, the streamed copies) are in
// `mma_tf32.cuh`, shared with K1's fp32 route. The softmax
// recompute, the softcap's derivative, the mask and Delta stay in fp32 on
// the CUDA cores.
//
// Why mma.sync and not wgmma: TF32 wgmma takes A and B only K-major from
// shared memory (the transpose bits exist only for 16-bit types). With the
// key tile as M, three of the five products would need a transposed copy of
// an operand in shared memory (P^T.dO needs dO^T, dX^T.Q needs Q^T, dX.K
// needs K^T), and the big/small split doubles every operand held there: at
// D 256 one 64-row fp32 tile is 64 KB, and K, V, Q and dO with their
// transposes and splits do not fit in 227 KB. mma.sync fragments load with
// scalar ld.shared from one fp32 copy in either orientation and split in
// registers.
//
// Kernels launched by one C call, the FlashAttention-2 backward:
// 1. `flash_bwd_delta_kernel`: Delta_i, one warp a row.
// 2. `flash_bwd_dkdv_kernel`: one CTA of 16 warps per (32 keys, query head,
//    batch), the heaviest key tiles (the first, under a causal mask) first.
//    K and V stay in shared memory; the query tiles that the mask lets see
//    its keys stream in, 32 rows of Q, dO, lse and Delta at a time, by
//    16-byte cp.async, double-buffered behind the compute. Per tile:
//    S^T = K.Q^T (warps 0-7) and dP^T = V.dO^T (warps 8-15), one m16n8
//    tile a warp over D / 8 k-steps; P^T and dX^T into shared memory (the
//    dP warps hand dP^T to the S warps there); then dV += P^T.dO (warps
//    0-7) and dK += dX^T.Q (warps 8-15), each warp 16 keys x D / 4 dims,
//    accumulated in registers. With KH == H it writes dK and dV; with
//    KH < H it writes each query head's share to a workspace (B, S, H, D),
//    and
// 3. `flash_bwd_reduce_kernel` sums the H / KH shares of each kv head in
//    a fixed order. No atomics: every element has one writer, so the
//    result is the same from run to run. A CTA per query head rather than
//    per kv head gives RecurrentGemma's call (one kv head) 320 CTAs where
//    it would have 32.
// 4. `flash_bwd_dq_kernel`: one CTA of 16 warps per (32 query rows, head,
//    batch), the last tiles (which walk the most keys) first. Q, dO, lse
//    and Delta stay in shared memory; the key tiles the forward walks
//    stream in, K and V double-buffered. Per tile: S and dP (warps 0-7 and
//    8-15, one m16n8 tile each), dX into shared memory, then dQ += dX.K,
//    each warp 16 rows x D / 4 dims over one half of the tile's keys; at
//    the end the halves are summed through shared memory in a fixed order.
// At D 16 a D-wide product has fewer n-tiles than its warps, so they split
// its k as well (Tc::KS_DKDV, KS_DQ) and sum the splits the same way.
// Tiles wholly outside the mask are not visited; only tiles that cross the
// diagonal, the window's edge, S or S_kv compute the mask.
//
// Shared memory, fp32: rows of Q, dO, K and V padded to D + 4 floats, so
// that ldmatrix (which reads an fp32 fragment of 8 rows x 4 columns as an
// 8 x 8 b16 matrix: the A operand, and B from a row-major (n, k) tile)
// finds its 8 rows in distinct banks, a scalar read of 4 rows x 8 columns
// (B from a row-major (k, n) tile) conflicts at most two ways, and every
// row start stays 16-byte aligned for cp.async and ldmatrix; P^T, dX^T and
// dX in 32 x 36 tiles. At D 256 the dK/dV kernel holds K, V and two stages
// of Q and dO (6 x 33.3 KB) plus 9.7 KB, 209 KB; the dQ kernel 204 KB: one
// CTA of 16 warps an SM, at most 128 registers a thread.
//
// Bound on the H100 SXM, at RecurrentGemma's training call (B 4, S 256,
// 10 query heads on 1 kv head, D 256, window 2048 > S): five products over
// the pairs the mask keeps, 10 D flops a pair, 3.37 GFLOP. As 3xTF32 that
// is three TF32 products at 495 TFLOP/s dense: 20.4 us (operations); the
// same flops on the fp32 CUDA cores (67 TFLOP/s) would take 50.3 us. The
// bytes are 46.2 MB (q, o, dO, dQ 10.5 MB each; k, v, dK, dV 1.0 MB each;
// lse) at 3.35 TB/s, 13.8 us: bound by the operations. Where the time goes
// instead (tools/k1_bwd_variants.py, which times copies of this source
// with one piece taken out): the score products about a third, the D-wide
// products a fifth, and what is left of the two main kernels with neither,
// each CTA's prologue (K and V, or Q and dO, with the first streamed tile,
// 133 KB, before any product), barriers and the last CTAs' tail, about two
// fifths; the tensor pipe and the integer ops that split the operands each
// a fifth at most.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <mutex>
#include <type_traits>

#include "hopper.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace tf32x3;

constexpr int NT = 512;   // threads a CTA of the two main kernels: 16 warps
constexpr int BQ = 32;    // query rows a tile
constexpr int BKV = 32;   // keys a tile
constexpr int SP = 36;    // padded row of the P^T, dX^T and dX tiles

// The warps of a CTA: in the score products, warps 0-7 take S and 8-15
// dP, each one m16n8 tile (2 x 4 of them cover 32 x 32); in a D-wide
// product, a warp takes 16 rows (m-tile w & 1) by NTW n-tiles of 8 dims
// (n-block NB of them) over 32 / KS of the tile's 32 k (k-split KS), and
// the KS splits are summed at the end in a fixed order.
template <int D>
struct Tc {
  static constexpr int P = row_pitch<D>;   // padded row of Q, dO, K and V
  static constexpr int TILE = 32 * P;      // floats of one 32-row tile
  static constexpr int NB = D / 8 < 4 ? D / 8 : 4;   // n-blocks of a D-wide product
  static constexpr int NTW = D / (8 * NB);            // n-tiles of 8 dims a warp
  static constexpr int KS_DKDV = 8 / (2 * NB);        // k-splits: 8 warps a product
  static constexpr int KS_DQ = 16 / (2 * NB);         // k-splits: 16 warps on dQ
  // K, V, two stages of Q and dO, P^T and dX^T, two stages of lse and Delta
  static constexpr int SMEM_DKDV = (int)sizeof(float) * (6 * TILE + 2 * BKV * SP + 4 * BQ);
  // Q, dO, two stages of K and V, dX, lse and Delta
  static constexpr int SMEM_DQ = (int)sizeof(float) * (6 * TILE + BQ * SP + 2 * BQ);
  static_assert(D % 16 == 0 && BQ == 32 && BKV == 32 && NT == 512,
                "the warp layout assumes these");
  // the k-splits' partial sums go through the streaming stages (4 tiles)
  static_assert(2 * (KS_DKDV - 1) <= 4 && KS_DQ - 1 <= 4, "no room to sum the k-splits");
};

// lse and Delta of rows r0 .. r0 + 31 of (b, h) (`lse`, `delta` their row
// 0), zeros past S
__device__ __forceinline__ void load_stats(float* sl, float* sdel, const float* __restrict__ lse,
                                           const float* __restrict__ delta, int r0, int S) {
  const int i = threadIdx.x;
  if (i < 64) {
    const int r = i % 32, row = r0 + r;
    const bool in = row < S;
    cp_async4((i < 32 ? sl : sdel) + r, (i < 32 ? lse : delta) + (in ? row : 0), in);
  }
}

// Whether the tile at query row q0 and key k0 needs the mask: it crosses S
// or S_kv, the diagonal or the window's edge
__device__ __forceinline__ bool edge_of(int q0, int k0, int S, int Skv, int causal, int window) {
  return q0 + BQ > S || k0 + BKV > Skv || (causal && k0 + BKV - 1 > q0) ||
         (window > 0 && q0 + BQ - 1 - k0 >= window);
}

// P of the score element at query row `row`, key `key`, from its logit s
// (unscaled) and the row's lse, and the softcap's derivative dxdt; then
// dX = P (dP - Delta) dxdt
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void p_of(float s, float l, int row, int key, int S, int Skv,
                                     bool edge, float scale, int causal, int window,
                                     float softcap, float& p, float& dxdt) {
  float x = s * scale;
  dxdt = 1.f;
  if (softcap > 0.f) {
    const float th = tanhf(x / softcap);
    x = softcap * th;
    dxdt = 1.f - th * th;
  }
  bool ok = true;
  if (edge) {
    ok = row < S && key < Skv;
    if (causal) ok = ok && key <= row;
    if (window > 0) ok = ok && (row - key) < window;
  }
  p = ok ? expf(x - l) : 0.f;
}

// ---- kernels -------------------------------------------------------------------

// Delta_i = dO_i . O_i into (B, H, S): one warp a (b, s, h) row
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int B, int S, int H, int D) {
  const long row = (long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;   // (b, s, h)
  const int lane = threadIdx.x % 32;
  if (row >= (long)B * S * H) return;
  const T* orow = o + row * D;
  const T* drow = dout + row * D;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum = fmaf(to_f32(orow[d]), to_f32(drow[d]), sum);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long bs = row / H;
    const int s = (int)(bs % S), b = (int)(bs / S);
    delta[((long)b * H + h) * S + s] = sum;
  }
}

// dK and dV of keys k0 .. k0 + 31 from query head h alone, into dkh and
// dvh, (B, S_kv, H, D) fp32: dK and dV themselves when KH == H (fp32), else
// the workspace that flash_bwd_reduce_kernel sums
template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dkh, float* __restrict__ dvh, int B, int S, int Skv,
                      int H, int KH, float scale, int causal, int window, float softcap) {
  using C = Tc<D>;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;                  // [BKV][P]
  float* sv = sk + C::TILE;          // [BKV][P]
  float* sq = sv + C::TILE;          // [2][BQ][P]
  float* sdo = sq + 2 * C::TILE;     // [2][BQ][P]
  float* spt = sdo + 2 * C::TILE;    // [BKV][SP]: P^T
  float* sdxt = spt + BKV * SP;      // [BKV][SP]: dX^T
  float* sl = sdxt + BKV * SP;       // [2][BQ]
  float* sdel = sl + 2 * BQ;         // [2][BQ]

  // the first key tiles, which the most query rows see, first
  const int h = blockIdx.x % H, b = (blockIdx.x / H) % B;
  const int k0 = (int)(blockIdx.x / ((unsigned)H * B)) * BKV;
  const int kh = h / (H / KH);
  const long qs = (long)H * D, ks = (long)KH * D;
  const T* qb = q + (long)b * S * qs + (long)h * D;
  const T* db = dout + (long)b * S * qs + (long)h * D;
  const float* lb = lse + ((long)b * H + h) * S;
  const float* eb = delta + ((long)b * H + h) * S;

  // the query rows that can see keys k0 .. k0 + 31: none before k0 if
  // causal, none at or past k0 + 31 + window with a window
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + BKV - 1 + window) : S;

  load_tile<D, NT>(sk, k + (long)b * Skv * ks + (long)kh * D, k0, Skv, ks);
  load_tile<D, NT>(sv, v + (long)b * Skv * ks + (long)kh * D, k0, Skv, ks);
  load_tile<D, NT>(sq, qb, q_begin, S, qs);
  load_tile<D, NT>(sdo, db, q_begin, S, qs);
  load_stats(sl, sdel, lb, eb, q_begin, S);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wm = warp & 1;                           // keys wm * 16 .. of the tile
  const int wn = (warp >> 1) & 3;                    // scores: query rows wn * 8 ..
  const int second = warp >> 3;                      // scores: dP^T; products: dK
  const int nblk = ((warp >> 1) & 3) % C::NB, split = ((warp >> 1) & 3) / C::NB;
  constexpr int KPS = BQ / 8 / C::KS_DKDV;           // k-steps of a split
  float acc[C::NTW][4];
#pragma unroll
  for (int j = 0; j < C::NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int stage = 0;
  for (int q0 = q_begin; q0 < q_end; q0 += BQ, stage ^= 1) {
    // the next tile into the other stage, which the last tile's readers
    // left at its closing barrier
    if (q0 + BQ < q_end) {
      const int ns = stage ^ 1;
      load_tile<D, NT>(sq + ns * C::TILE, qb, q0 + BQ, S, qs);
      load_tile<D, NT>(sdo + ns * C::TILE, db, q0 + BQ, S, qs);
      load_stats(sl + ns * BQ, sdel + ns * BQ, lb, eb, q0 + BQ, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* tq = sq + stage * C::TILE;
    const float* tdo = sdo + stage * C::TILE;
    const float* tl = sl + stage * BQ;
    const float* tdel = sdel + stage * BQ;

    // S^T = K.Q^T (warps 0-7) or dP^T = V.dO^T (8-15): keys wm * 16 .., rows
    // wn * 8 ..; element i of the fragment is key wm * 16 + g + 8 (i / 2),
    // row wn * 8 + 2 t + i % 2
    float x[4];
    score_tile<D>((second ? sv : sk) + wm * 16 * C::P, (second ? tdo : tq) + wn * 8 * C::P,
                  lane, x);
    const bool edge = edge_of(q0, k0, S, Skv, causal, window);
    float p[4], dxdt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = wm * 16 + g + 8 * (i / 2), qc = wn * 8 + 2 * t + i % 2;
      if (second) {
        sdxt[kr * SP + qc] = x[i];   // dP^T, for the S warp of this element
      } else {
        p_of(x[i], tl[qc], q0 + qc, k0 + kr, S, Skv, edge, scale, causal, window, softcap, p[i],
             dxdt[i]);
        spt[kr * SP + qc] = p[i];
      }
    }
    __syncthreads();
    if (!second) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = wm * 16 + g + 8 * (i / 2), qc = wn * 8 + 2 * t + i % 2;
        sdxt[kr * SP + qc] = p[i] * (sdxt[kr * SP + qc] - tdel[qc]) * dxdt[i];
      }
    }
    __syncthreads();

    // dV += P^T.dO (warps 0-7), dK += dX^T.Q (8-15): keys wm * 16 .., dims
    // (nblk NTW + j) * 8 .., over the split's rows of the tile
    const float* sa = second ? sdxt : spt;
    const float* sb = second ? tq : tdo;
#pragma unroll
    for (int kk = split * KPS; kk < (split + 1) * KPS; ++kk) {
      const FragA fa = load_a(sa + wm * 16 * SP + kk * 8, SP, lane);
#pragma unroll
      for (int j = 0; j < C::NTW; ++j)
        mma3(acc[j], fa, load_b_kn(sb + kk * 8 * C::P + (nblk * C::NTW + j) * 8, C::P, g, t));
    }
    __syncthreads();
  }
  // the streaming stages are free after the last barrier
  sum_k_splits<D, C::KS_DKDV, C::NTW>(acc, sq, second, split, wm * 16, nblk * C::NTW, g, t);
  if (split > 0) return;

  // accumulator element i: key wm * 16 + g + 8 (i / 2), dim (nblk NTW + j) * 8 + 2 t + i % 2
  float* out = (second ? dkh : dvh) + (long)b * Skv * qs + (long)h * D;
  const float mul = second ? scale : 1.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + wm * 16 + g + 8 * half;
    if (key >= Skv) continue;
#pragma unroll
    for (int j = 0; j < C::NTW; ++j)
      *reinterpret_cast<float2*>(out + (long)key * qs + (nblk * C::NTW + j) * 8 + 2 * t) =
          make_float2(acc[j][2 * half] * mul, acc[j][2 * half + 1] * mul);
  }
}

// dK and dV (B, S_kv, KH, D), fp32 or rounded to bf16, as the sums of
// their G = H / KH query heads' shares (B, S_kv, H, D), g = 0 .. G - 1 in
// order: one thread an element
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_reduce_kernel(const float* __restrict__ dkh, const float* __restrict__ dvh,
                        T* __restrict__ dk, T* __restrict__ dv, long n, int G, int D) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;   // (b, s, kh, d) of dK
  if (i >= n) return;
  // kv head kh's query heads kh G .. kh G + G - 1 sit side by side in a row
  const long src = (i / D) * G * D + i % D;
  float sk = 0.f, sv = 0.f;
  for (int g = 0; g < G; ++g) {
    sk += dkh[src + (long)g * D];
    sv += dvh[src + (long)g * D];
  }
  store1(dk + i, sk);
  store1(dv + i, sv);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int B, int S, int Skv, int H, int KH, float scale,
                    int causal, int window, float softcap) {
  using C = Tc<D>;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                  // [BQ][P]
  float* sdo = sq + C::TILE;         // [BQ][P]
  float* sk = sdo + C::TILE;         // [2][BKV][P]
  float* sv = sk + 2 * C::TILE;      // [2][BKV][P]
  float* sdx = sv + 2 * C::TILE;     // [BQ][SP]: dX
  float* sl = sdx + BQ * SP;         // [BQ]
  float* sdel = sl + BQ;             // [BQ]

  // last tiles first: under a causal mask they walk the most keys
  const int n_qt = (S + BQ - 1) / BQ;
  const int h = blockIdx.x % H, b = (blockIdx.x / H) % B;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / ((unsigned)H * B))) * BQ;
  const int kh = h / (H / KH);
  const long qs = (long)H * D, ks = (long)KH * D;
  const T* kb = k + (long)b * Skv * ks + (long)kh * D;
  const T* vb = v + (long)b * Skv * ks + (long)kh * D;

  // the key tiles the forward walks: none past the diagonal if causal, none
  // wholly outside the window, none past S_kv
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BKV * BKV : 0;

  load_tile<D, NT>(sq, q + (long)b * S * qs + (long)h * D, q0, S, qs);
  load_tile<D, NT>(sdo, dout + (long)b * S * qs + (long)h * D, q0, S, qs);
  load_stats(sl, sdel, lse + ((long)b * H + h) * S, delta + ((long)b * H + h) * S, q0, S);
  load_tile<D, NT>(sk, kb, kv_begin, Skv, ks);
  load_tile<D, NT>(sv, vb, kv_begin, Skv, ks);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wm = warp & 1;                           // rows wm * 16 .. of the tile
  const int wn = (warp >> 1) & 3;                    // scores: keys wn * 8 ..
  const int second = warp >> 3;                      // scores: dP
  const int nblk = ((warp >> 1) & 7) % C::NB, split = ((warp >> 1) & 7) / C::NB;
  constexpr int KPS = BKV / 8 / C::KS_DQ;            // k-steps of a split
  float acc[C::NTW][4];
#pragma unroll
  for (int j = 0; j < C::NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int stage = 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV, stage ^= 1) {
    if (k0 + BKV < kv_end) {
      const int ns = stage ^ 1;
      load_tile<D, NT>(sk + ns * C::TILE, kb, k0 + BKV, Skv, ks);
      load_tile<D, NT>(sv + ns * C::TILE, vb, k0 + BKV, Skv, ks);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* tk = sk + stage * C::TILE;
    const float* tv = sv + stage * C::TILE;

    // S = Q.K^T (warps 0-7) or dP = dO.V^T (8-15): rows wm * 16 .., keys
    // wn * 8 ..; element i of the fragment is row wm * 16 + g + 8 (i / 2),
    // key wn * 8 + 2 t + i % 2
    float x[4];
    score_tile<D>((second ? sdo : sq) + wm * 16 * C::P, (second ? tv : tk) + wn * 8 * C::P,
                  lane, x);
    const bool edge = edge_of(q0, k0, S, Skv, causal, window);
    float p[4], dxdt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = wm * 16 + g + 8 * (i / 2), kc = wn * 8 + 2 * t + i % 2;
      if (second)
        sdx[qr * SP + kc] = x[i];   // dP, for the S warp of this element
      else
        p_of(x[i], sl[qr], q0 + qr, k0 + kc, S, Skv, edge, scale, causal, window, softcap, p[i],
             dxdt[i]);
    }
    __syncthreads();
    if (!second) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qr = wm * 16 + g + 8 * (i / 2), kc = wn * 8 + 2 * t + i % 2;
        sdx[qr * SP + kc] = p[i] * (sdx[qr * SP + kc] - sdel[qr]) * dxdt[i];
      }
    }
    __syncthreads();

    // dQ += dX.K over the split's keys: rows wm * 16 .., dims
    // (nblk NTW + j) * 8 ..
#pragma unroll
    for (int kk = split * KPS; kk < (split + 1) * KPS; ++kk) {
      const FragA fa = load_a(sdx + wm * 16 * SP + kk * 8, SP, lane);
#pragma unroll
      for (int j = 0; j < C::NTW; ++j)
        mma3(acc[j], fa, load_b_kn(tk + kk * 8 * C::P + (nblk * C::NTW + j) * 8, C::P, g, t));
    }
    __syncthreads();
  }
  // the K and V stages are free after the last barrier
  sum_k_splits<D, C::KS_DQ, C::NTW>(acc, sk, 0, split, wm * 16, nblk * C::NTW, g, t);
  if (split > 0) return;

  T* dqb = dq + (long)b * S * qs + (long)h * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + wm * 16 + g + 8 * hr;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < C::NTW; ++j)
      store2(dqb + (long)row * qs + (nblk * C::NTW + j) * 8 + 2 * t, acc[j][2 * hr] * scale,
             acc[j][2 * hr + 1] * scale);
  }
}

// T float: fp32 in and out; T bf16: bf16 in and out, fp32 inside (dK and dV
// always through the workspace, which the reduce kernel rounds)
template <typename T, int D>
int launch(const T* q, const T* k, const T* v, const T* o, const float* lse, const T* dout,
           T* dq, T* dk, T* dv, float* delta, float* dkh, float* dvh, int B, int S, int Skv,
           int H, int KH, float scale, int causal, int window, float softcap, cudaStream_t st) {
  using C = Tc<D>;
  static std::atomic<unsigned long long> dkdv_in{0}, dq_in{0};
  cudaError_t err =
      hopper::opt_in_smem((const void*)flash_bwd_dkdv_kernel<T, D>, C::SMEM_DKDV, dkdv_in);
  if (err == cudaSuccess)
    err = hopper::opt_in_smem((const void*)flash_bwd_dq_kernel<T, D>, C::SMEM_DQ, dq_in);
  if (err != cudaSuccess) return (int)err;
  const long rows = (long)B * S * H;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(o, dout, delta, B, S, H,
                                                                        D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // dK, dV sum query heads' shares from the workspace (and are rounded there)
  constexpr bool fp32 = std::is_same_v<T, float>;
  const bool shared_kv = KH < H || !fp32;
  const unsigned heads = (unsigned)B * H;
  float* dk_out = nullptr;
  float* dv_out = nullptr;
  if constexpr (fp32) {
    dk_out = dk;
    dv_out = dv;
  }
  flash_bwd_dkdv_kernel<T, D>
      <<<(unsigned)((Skv + BKV - 1) / BKV) * heads, NT, C::SMEM_DKDV, st>>>(
          q, k, v, dout, lse, delta, shared_kv ? dkh : dk_out, shared_kv ? dvh : dv_out, B, S,
          Skv, H, KH, scale, causal, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (shared_kv) {
    const long n = (long)B * Skv * KH * D;
    flash_bwd_reduce_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(dkh, dvh, dk, dv, n,
                                                                            H / KH, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  flash_bwd_dq_kernel<T, D><<<(unsigned)((S + BQ - 1) / BQ) * heads, NT, C::SMEM_DQ, st>>>(
      q, k, v, dout, lse, delta, dq, B, S, Skv, H, KH, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

// ---- the bf16 route (D 64, 128 and 256): wgmma on TMA-fed 64-row tiles ------
//
// What the fp32 kernels compute, for the bf16 forward's wgmma route, with
// bf16 operands on the tensor cores as `wgmma` m64 (bf16 in, fp32
// accumulators) and the roundings of the plain version
// (`ops.flash_attention_bwd_bf16_plain`): P rounded to bf16 before dV +=
// P^T dO; dX formed from the unrounded P and dP, then rounded before dK +=
// dX^T Q and dQ += dX K; dK and dV summed over a kv head's query heads in
// fp32 and rounded once. The softmax recompute, the softcap's derivative,
// the mask and Delta stay fp32.
//
// Bound on the H100 SXM at qwen3-14b's training call (a micro-batch of 4 x
// 256, 40 query heads on 8 kv heads of 128, causal): five products over
// the 32896 pairs of each (batch, head), 6.74 GFLOP, 6.8 us at 989 TFLOP/s;
// q, o, dO, dQ (10.5 MB each), k, v, dK, dV (2.1 MB each) and lse, 50.5
// MB, 15.1 us at 3.35 TB/s: bound by the bytes.
//
// Every operand is a tile that TMA loads as 64-row slabs of 64 features,
// 128-byte swizzled (`hopper::tma_map_bshd`). The score products (S^T = K
// Q^T and dP^T = V dO^T in the dK/dV kernel, S = Q K^T and dP = dO V^T in
// the dQ kernel) read both operands K-major from shared memory. In the
// D-wide products (dV += P^T dO, dK += dX^T Q, dQ += dX K) A is a score
// accumulator packed to bf16 pairs in registers (the accumulator's
// fragment is wgmma's A fragment) and B (dO, Q or K) is read MN-major from
// the same swizzled tile, as the forward reads V. So P, dP and dX never
// leave registers: no shared-memory tile, no transposed copy, no barrier
// between warps inside a step.
//
// Kernels launched by one C call:
// 1. `flash_bwd_bf16_delta_kernel`: Delta = dO . O per query row, D / 8
//    lanes a row reading 16 bytes each, into the stats workspace (B, H, 2,
//    S64) fp32 beside a copy of the forward's lse (S64: S rounded up to 64
//    rows, the rows past S zero), so that a 64-row tile's lse and Delta
//    arrive by two 256-byte bulk copies beside its tiles.
// 2. `flash_bwd_wgmma_dkdv_kernel<D>`: one CTA per (64-key tile, kv head,
//    batch); at D 256 two CTAs a key tile, each writing 128 features of dK
//    and dV and recomputing the scores. K and V stay in shared memory. The
//    CTA walks the G = H / KH query heads of its kv head in order, each
//    over the query tiles the mask lets see its keys. Its two consumer
//    warpgroups take the walk's steps in turn (steps 0, 2, 4, ... and 1, 3,
//    5, ...), each with its own ring of Q, dO, lse and Delta stages (two at
//    D 64 and 128, one at D 256) that its first thread refills by TMA once
//    the warpgroup's four warps are done with a stage (a named barrier),
//    and each keeps dK and dV of the 64 keys in fp32 registers over all its
//    steps. At the end the second warpgroup hands its sums to the first
//    through its own stages; the first adds them (first + second: a fixed
//    order, so two calls give the same bits) and writes bf16 dK and dV
//    once. No workspace, no reduce kernel, no atomics.
// 3. `flash_bwd_wgmma_dq_kernel<D>`: one CTA of one warpgroup per (64
//    query rows, query head, batch), the last tiles (which walk the most
//    keys) first. Q, dO, lse and Delta stay in shared memory; the key
//    tiles the forward walks stream in by TMA through two stages of K and
//    V, the next but one issued once the warpgroup is done with a stage.
//    dQ stays in fp32 registers and is written once in bf16.
// The dK/dV and dQ kernels need only Delta's stats, not each other: the
// dK/dV kernel runs on a stream of the highest priority beside the
// caller's, forked after the Delta kernel and joined back, so that its
// CTAs take their SMs first and the dQ CTAs fill the SMs that its lighter
// key tiles leave (under the causal mask key tile 0 walks 4 query tiles a
// head at qwen3's call, tile 3 one). Tiles wholly outside the mask are not
// visited; only tiles that cross the diagonal, the window's edge, S or
// S_kv compute the mask, chosen with the softcap outside the loop over a
// fragment's 32 elements, which is then straight-line code.
//
// The CTA plan at qwen3's call: 128 dK/dV CTAs for 132 SMs, the heaviest
// (key tile 0: 4 query tiles x 5 heads) 10 steps a warpgroup, the lightest
// 5 steps in all. Two warpgroups of one CTA split its steps, which halves
// the longest walk and overlaps one warpgroup's softmax with the other's
// products; a split of the heads over CTAs would need the GQA sum in a
// workspace and a second pass, which is what this design removes. The dQ
// grid is 640 CTAs, two an SM, on the SMs the dK/dV kernel leaves.
// Registers: dK and dV of 64 keys x 128 features take 128 a thread, the
// two score accumulators 64, P and dX packed 32; 256 threads a CTA allow
// 255 a thread, so neither setmaxnreg nor a producer warp is needed (a TMA
// issue costs its thread a few instructions), and no room is left to hold
// K and V as register operands. At D 256 dK and dV of 256 features would
// need 256 a thread, hence the two CTAs a key tile.
// Shared memory: dK/dV at D 128 K and V 32 KB, four Q/dO stages 128 KB,
// their stats 2 KB, 163 KB (D 256: two stages, 194 KB; D 64 82 KB): one
// CTA an SM. dQ at D 128: Q, dO and two K/V stages, 97 KB, two CTAs an SM
// (D 256 193 KB, one).
// Where the time goes at qwen3's call (tools/k1_bwd_variants.py --bf16,
// copies of this source with one piece taken out): the Delta kernel a
// sixth; the D-wide products (and the P and dX work that only they use) a
// quarter; the score products an eighth (each m64n64k16 reads both
// operands from shared memory, 4 KB in 32 tensor-core cycles, the SM's
// shared-memory rate); the P and dX arithmetic a few percent; the rest is
// loads, prologues and tails that the two kernels do not hide.

namespace bf {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;          // query rows of a tile, keys of a key tile: one wgmma m64
constexpr int CONSUMERS = 2;    // warpgroups of a dK/dV CTA, taking its steps in turn
constexpr int WG = 128;         // threads a warpgroup
constexpr int SLAB = BM * 128;  // bytes of a 64-row slab of 64 features
constexpr int STATS = 2 * BM * (int)sizeof(float);   // bytes of a tile's lse and Delta

template <int D>
struct Cfg {
  static constexpr int NS = D / 64;                 // slabs a row
  static constexpr int DV = D > 128 ? 128 : D;      // dK/dV features a CTA, dQ's a product
  static constexpr int NSPLIT = D / DV;             // dK/dV CTAs a key tile
  static constexpr int TILE = NS * SLAB;            // bytes of a 64-row tile
  static constexpr int NST = D > 128 ? 2 : 4;       // Q/dO stages, NST / CONSUMERS each
  // dK/dV: 1024 bytes to align the slabs, K, V, the stages, their stats,
  // the K/V barrier and one a stage
  static constexpr int SMEM_DKDV = 1024 + 2 * TILE + NST * (2 * TILE + STATS) + 8 * (1 + NST);
  // dQ: Q, dO, two stages of K and V, the rows' stats, three barriers
  static constexpr int SMEM_DQ = 1024 + 6 * TILE + STATS + 8 * 3;
  static_assert(D % 64 == 0 && CONSUMERS == 2 && NST % CONSUMERS == 0,
                "the layout assumes these");
  // the second consumer hands its dK and dV sums over through its stages
  static_assert(NST / CONSUMERS * 2 * TILE >= 2 * BM * DV * (int)sizeof(float),
                "no room to hand the sums over");
  static_assert(SMEM_DKDV <= 232448 && SMEM_DQ <= 232448, "over the SM's shared memory");
};


// Whether the 64 x 64 tile at query row q0 and key k0 needs the mask
__device__ __forceinline__ bool edge_of(int q0, int k0, int S, int Skv, int causal, int window) {
  return q0 + BM > S || k0 + BM > Skv || (causal && k0 + BM - 1 > q0) ||
         (window > 0 && q0 + BM - 1 - k0 >= window);
}

// acc (64 x 64, fp32) = X (64 x D) . Y^T (D x 64) for 64-row tiles X and Y
// at shared addresses x and y, both K-major: D / 16 wgmma k-steps, four a
// slab, 32 bytes apart; issued, not waited for
template <int D>
__device__ __forceinline__ void score(float (&acc)[32], uint32_t x, uint32_t y) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    hopper::wgmma_m64n64k16_ss(
        acc, hopper::desc_sw128(x + (j / 4) * SLAB + (j % 4) * 32, 16, 1024),
        hopper::desc_sw128(y + (j / 4) * SLAB + (j % 4) * 32, 16, 1024), j > 0);
}

// acc (64 x N, fp32) += A (64 x 64: four k16 blocks of bf16 pairs in
// registers) . B (64 rows x N features, N 64 or 128, MN-major from the
// slabs of a 64-row tile at shared address b); issued, not waited for
template <int N>
__device__ __forceinline__ void wide(float (&acc)[N / 2], const uint32_t (&a)[4][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = hopper::desc_sw128(b + kk * 16 * 128, SLAB, 1024);
    if constexpr (N == 128)
      hopper::wgmma_m64n128k16_rs_tb(acc, a[kk], db);
    else
      hopper::wgmma_m64n64k16_rs_tb(acc, a[kk], db);
  }
}

// exp(x) as 2^(x log2 e) on the special-function unit (ex2.approx.ftz:
// about 2^-22 relative error, results under 2^-126 flushed to zero), as the
// forward's __expf computes P
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// P and dX of a 64 x 64 score tile from the accumulators s (the logits,
// unscaled) and dp (dO . V), packed to bf16 pairs as wgmma's A: element i
// of this thread is at tile row r0 + 8 ((i / 2) % 2), column 8 (i / 4) + 2
// (lane % 4) + i % 2. KEYS_ROWS: rows are keys and columns query rows (the
// dK/dV kernel), else the other way round. stat(row) gives a query row's
// lse and Delta (`row` within the tile). What p_of computes (its
// exponential on the SFU), with the softcap (CAP) and the mask (EDGE)
// chosen outside the loop and the mask as a select, so that the 32
// elements are one block of straight-line code that the compiler can
// interleave.
template <bool KEYS_ROWS, bool EDGE, bool CAP, typename Stat>
__device__ __forceinline__ void p_and_dx_tile(const float (&s)[32], const float (&dp)[32], int r0,
                                              int lane, int q0, int k0, int S, int Skv,
                                              float scale, int causal, int window, float softcap,
                                              Stat stat, uint32_t (&pa)[4][4],
                                              uint32_t (&xa)[4][4]) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    float p[2], dx[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r0 + 8 * ((i / 2) % 2), c = 8 * (i / 4) + 2 * (lane % 4) + e;
      const int row = KEYS_ROWS ? c : r, key = KEYS_ROWS ? r : c;
      float l, del;
      stat(row, l, del);
      float x = s[i + e] * scale, dxdt = 1.f;
      if constexpr (CAP) {
        const float th = tanhf(x / softcap);
        x = softcap * th;
        dxdt = 1.f - th * th;
      }
      p[e] = exp_sfu(x - l);
      if constexpr (EDGE) {
        const int qr = q0 + row, kc = k0 + key;
        const bool ok = (qr < S) & (kc < Skv) & (!causal | (kc <= qr)) &
                        ((window <= 0) | (qr - kc < window));
        p[e] = ok ? p[e] : 0.f;
      }
      dx[e] = p[e] * (dp[i + e] - del) * dxdt;
    }
    pa[i / 8][(i % 8) / 2] = hopper::pack_bf16(p[0], p[1]);
    xa[i / 8][(i % 8) / 2] = hopper::pack_bf16(dx[0], dx[1]);
  }
}

template <bool KEYS_ROWS, typename Stat>
__device__ __forceinline__ void p_and_dx(const float (&s)[32], const float (&dp)[32], int r0,
                                         int lane, int q0, int k0, int S, int Skv, bool edge,
                                         float scale, int causal, int window, float softcap,
                                         Stat stat, uint32_t (&pa)[4][4], uint32_t (&xa)[4][4]) {
#define K1_BWD_TILE(E, CAP)                                                                       \
  p_and_dx_tile<KEYS_ROWS, E, CAP>(s, dp, r0, lane, q0, k0, S, Skv, scale, causal, window,       \
                                   softcap, stat, pa, xa)
  if (softcap > 0.f) {
    if (edge)
      K1_BWD_TILE(true, true);
    else
      K1_BWD_TILE(false, true);
  } else {
    if (edge)
      K1_BWD_TILE(true, false);
    else
      K1_BWD_TILE(false, false);
  }
#undef K1_BWD_TILE
}

// Each query row's lse and Delta into stats (B, H, 2, S64): [.., 0, s] the
// forward's lse, [.., 1, s] Delta = dO . O (bf16 rows, fp32 sum), zeros for
// S <= s < S64. D / 8 lanes a (b, s, h) row, 16 bytes each of o and dO.
__global__ void __launch_bounds__(256)
flash_bwd_bf16_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                            const float* __restrict__ lse, float* __restrict__ stats, int B,
                            int S, int S64, int H, int D) {
  const int lpr = D / 8;   // lanes a row: 8, 16 or 32, so a row's lanes share a warp
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) / lpr;   // (b, s, h)
  const int part = threadIdx.x % lpr;
  const int h = (int)(row % H);
  const long bs = row / H;
  const int s = (int)(bs % S64), b = (int)(bs / S64);
  const bool live = row < (long)B * S64 * H, in = live && s < S;
  float sum = 0.f;
  if (in) {
    const long off = (((long)b * S + s) * H + h) * D + part * 8;
    const uint4 ov = *reinterpret_cast<const uint4*>(o + off);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + off);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(op[j]), c = __bfloat1622float2(dp[j]);
      sum = fmaf(a.x, c.x, sum);
      sum = fmaf(a.y, c.y, sum);
    }
  }
  for (int off = lpr / 2; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (live && part == 0) {
    float* st = stats + ((long)b * H + h) * 2 * S64;
    st[s] = in ? lse[((long)b * H + h) * S + s] : 0.f;
    st[S64 + s] = sum;
  }
}

template <int D>
__global__ void __launch_bounds__(CONSUMERS * WG, 1)
flash_bwd_wgmma_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ stats, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, int S, int Skv, int S64, int H, int KH,
                            float scale, int causal, int window, float softcap) {
  using C = Cfg<D>;
  constexpr int HALF = C::NST / CONSUMERS;   // stages a consumer
  constexpr int DV = C::DV;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t sk = (raw + 1023u) & ~1023u, sv = sk + C::TILE;
  const uint32_t ring = sv + C::TILE;                   // stage t: Q, then dO, at ring + 2 t TILE
  const uint32_t sstat = ring + C::NST * 2 * C::TILE;   // stage t: lse, then Delta, at + t STATS
  const uint32_t kvbar = sstat + C::NST * STATS, full0 = kvbar + 8;
  const float* stat_f = reinterpret_cast<const float*>(smem_raw + (sstat - raw));

  const int tid = threadIdx.x, wg = tid / WG, wtid = tid % WG, lane = tid % 32;
  const int split = (int)blockIdx.x % C::NSPLIT, k0 = (int)blockIdx.x / C::NSPLIT * BM;
  const int kh = blockIdx.y, b = blockIdx.z, G = H / KH;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + BM - 1 + window) : S;
  const int n_q = (q_end - q_begin + BM - 1) / BM;   // query tiles a head
  const int n = G * n_q;                              // steps of the walk
  const int m = n > wg ? (n - wg + CONSUMERS - 1) / CONSUMERS : 0;   // this consumer's

  // step l of this consumer: walk step wg + CONSUMERS l, its head and first row
  auto step_of = [&](int l, int& h, int& q0) {
    const int i = wg + CONSUMERS * l;
    h = kh * G + i / n_q;
    q0 = q_begin + (i % n_q) * BM;
  };
  auto issue = [&](int l) {
    int h, q0;
    step_of(l, h, q0);
    const int t = wg * HALF + l % HALF;
    const uint32_t bar = full0 + 8 * t, dst = ring + 2 * t * C::TILE;
    hopper::mbar_arrive_expect_tx(bar, 2 * C::TILE + STATS);
#pragma unroll
    for (int s = 0; s < C::NS; ++s) {
      hopper::tma_load_4d(dst + s * SLAB, &tq, bar, 64 * s, h, q0, b);
      hopper::tma_load_4d(dst + C::TILE + s * SLAB, &tdo, bar, 64 * s, h, q0, b);
    }
    const float* src = stats + ((long)b * H + h) * 2 * S64 + q0;
    hopper::bulk_load(sstat + t * STATS, src, BM * 4, bar);
    hopper::bulk_load(sstat + t * STATS + BM * 4, src + S64, BM * 4, bar);
  };

  if (tid == 0) {
    hopper::prefetch_tensormap(&tq);
    hopper::prefetch_tensormap(&tk);
    hopper::prefetch_tensormap(&tv);
    hopper::prefetch_tensormap(&tdo);
    hopper::mbar_init(kvbar, 1);
#pragma unroll
    for (int t = 0; t < C::NST; ++t) hopper::mbar_init(full0 + 8 * t, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(kvbar, 2 * C::TILE);
#pragma unroll
    for (int s = 0; s < C::NS; ++s) {
      hopper::tma_load_4d(sk + s * SLAB, &tk, kvbar, 64 * s, kh, k0, b);
      hopper::tma_load_4d(sv + s * SLAB, &tv, kvbar, 64 * s, kh, k0, b);
    }
  }
  if (wtid == 0)
    for (int l = 0; l < HALF && l < m; ++l) issue(l);

  float dva[DV / 2], dka[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dva[i] = dka[i] = 0.f;
  const int r0 = 16 * (wtid / 32) + lane / 4;   // this thread's first key of the tile
  hopper::mbar_wait(kvbar, 0);

  for (int l = 0; l < m; ++l) {
    int h, q0;
    step_of(l, h, q0);
    const int t = wg * HALF + l % HALF;
    const uint32_t tq_s = ring + 2 * t * C::TILE, tdo_s = tq_s + C::TILE;
    hopper::mbar_wait(full0 + 8 * t, (l / HALF) & 1);

    // S^T = K Q^T, dP^T = V dO^T: keys by query rows
    float sacc[32], pacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;
    hopper::wgmma_fence();
    score<D>(sacc, sk, tq_s);
    score<D>(pacc, sv, tdo_s);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::reg_fence(sacc);
    hopper::reg_fence(pacc);

    // P^T and dX^T; a query row's lse and Delta from the stage's stats
    const float* st = stat_f + t * 2 * BM;
    uint32_t pa[4][4], xa[4][4];
    p_and_dx<true>(sacc, pacc, r0, lane, q0, k0, S, Skv,
                   edge_of(q0, k0, S, Skv, causal, window), scale, causal, window, softcap,
                   [&](int row, float& l_, float& d_) {
                     l_ = st[row];
                     d_ = st[BM + row];
                   },
                   pa, xa);

    // dV += P^T dO and dK += dX^T Q over this CTA's DV features
    hopper::reg_fence(dva);
    hopper::reg_fence(dka);
    hopper::wgmma_fence();
    wide<DV>(dva, pa, tdo_s + split * (DV / 64) * SLAB);
    wide<DV>(dka, xa, tq_s + split * (DV / 64) * SLAB);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::reg_fence(dva);
    hopper::reg_fence(dka);

    // this consumer's four warps are done with the stage: refill it
    hopper::bar_sync(1 + wg, WG);
    if (wtid == 0 && l + HALF < m) issue(l + HALF);
  }

  // the two consumers' sums, first + second: the second's go through its
  // own stages, which no load fills any more
  float* hand = reinterpret_cast<float*>(smem_raw + (ring + HALF * 2 * C::TILE - raw));
  if (wg == 1) {
    hopper::fence_proxy_async();
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) {
      hand[i * WG + wtid] = dva[i];
      hand[(DV / 2 + i) * WG + wtid] = dka[i];
    }
  }
  __syncthreads();
  if (wg != 0) return;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) {
    dva[i] += hand[i * WG + wtid];
    dka[i] += hand[(DV / 2 + i) * WG + wtid];
  }
  // accumulator register 4 j + 2 half + e: key r0 + 8 half, feature 8 j + 2 (lane % 4) + e
  const long ks = (long)KH * D;
  const long base = (long)b * Skv * ks + (long)kh * D + split * DV;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + r0 + 8 * half;
    if (key >= Skv) continue;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const long at = base + (long)key * ks + 8 * j + 2 * (lane % 4);
      const int i = 4 * j + 2 * half;
      store2(dk + at, dka[i] * scale, dka[i + 1] * scale);
      store2(dv + at, dva[i], dva[i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(WG, 1)
flash_bwd_wgmma_dq_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ stats, bf16* __restrict__ dq, int S, int Skv,
                          int S64, int H, int KH, float scale, int causal, int window,
                          float softcap) {
  using C = Cfg<D>;
  constexpr int DV = C::DV, NC = D / DV;   // dQ as NC products of DV features
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u, sdo = sq + C::TILE;
  const uint32_t skv = sdo + C::TILE;          // stage t: K, then V, at skv + 2 t TILE
  const uint32_t sstat = skv + 4 * C::TILE;    // the rows' lse, then Delta
  const uint32_t qbar = sstat + STATS, kvbar0 = qbar + 8;
  const float* stat_f = reinterpret_cast<const float*>(smem_raw + (sstat - raw));

  const int tid = threadIdx.x, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (int)(gridDim.z - 1 - blockIdx.z) * BM;   // the last query tile first
  const int kh = h / (H / KH);
  const int kv_end = causal ? min(Skv, q0 + BM) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BM * BM : 0;
  const int n = (kv_end - kv_begin + BM - 1) / BM;

  auto issue = [&](int it) {
    const int t = it & 1, k0 = kv_begin + it * BM;
    const uint32_t bar = kvbar0 + 8 * t, dst = skv + 2 * t * C::TILE;
    hopper::mbar_arrive_expect_tx(bar, 2 * C::TILE);
#pragma unroll
    for (int s = 0; s < C::NS; ++s) {
      hopper::tma_load_4d(dst + s * SLAB, &tk, bar, 64 * s, kh, k0, b);
      hopper::tma_load_4d(dst + C::TILE + s * SLAB, &tv, bar, 64 * s, kh, k0, b);
    }
  };

  if (tid == 0) {
    hopper::prefetch_tensormap(&tq);
    hopper::prefetch_tensormap(&tk);
    hopper::prefetch_tensormap(&tv);
    hopper::prefetch_tensormap(&tdo);
    hopper::mbar_init(qbar, 1);
    hopper::mbar_init(kvbar0, 1);
    hopper::mbar_init(kvbar0 + 8, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(qbar, 2 * C::TILE + STATS);
#pragma unroll
    for (int s = 0; s < C::NS; ++s) {
      hopper::tma_load_4d(sq + s * SLAB, &tq, qbar, 64 * s, h, q0, b);
      hopper::tma_load_4d(sdo + s * SLAB, &tdo, qbar, 64 * s, h, q0, b);
    }
    const float* src = stats + ((long)b * H + h) * 2 * S64 + q0;
    hopper::bulk_load(sstat, src, BM * 4, qbar);
    hopper::bulk_load(sstat + BM * 4, src + S64, BM * 4, qbar);
    issue(0);
    if (n > 1) issue(1);
  }

  float dqa[NC][DV / 2];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dqa[c][i] = 0.f;
  const int r0 = 16 * (tid / 32) + lane / 4;   // this thread's first row of the tile
  hopper::mbar_wait(qbar, 0);
  const float l0 = stat_f[r0], l1 = stat_f[r0 + 8];
  const float d0 = stat_f[BM + r0], d1 = stat_f[BM + r0 + 8];

  for (int it = 0; it < n; ++it) {
    const int t = it & 1, k0 = kv_begin + it * BM;
    const uint32_t sk = skv + 2 * t * C::TILE, sv = sk + C::TILE;
    hopper::mbar_wait(kvbar0 + 8 * t, (it >> 1) & 1);

    // S = Q K^T, dP = dO V^T: query rows by keys
    float sacc[32], pacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;
    hopper::wgmma_fence();
    score<D>(sacc, sq, sk);
    score<D>(pacc, sdo, sv);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::reg_fence(sacc);
    hopper::reg_fence(pacc);

    uint32_t pa[4][4], xa[4][4];
    p_and_dx<false>(sacc, pacc, r0, lane, q0, k0, S, Skv,
                    edge_of(q0, k0, S, Skv, causal, window), scale, causal, window, softcap,
                    [&](int row, float& l_, float& d_) {
                      l_ = row == r0 ? l0 : l1;
                      d_ = row == r0 ? d0 : d1;
                    },
                    pa, xa);

    // dQ += dX K
#pragma unroll
    for (int c = 0; c < NC; ++c) hopper::reg_fence(dqa[c]);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c) wide<DV>(dqa[c], xa, sk + c * (DV / 64) * SLAB);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) hopper::reg_fence(dqa[c]);

    // every warp is done with this stage: the next but one tile may fill it
    __syncthreads();
    if (tid == 0 && it + 2 < n) issue(it + 2);
  }

  const long qs = (long)H * D;
  bf16* dqb = dq + (long)b * S * qs + (long)h * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + 8 * half;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const int i = 4 * j + 2 * half;
        store2(dqb + (long)row * qs + c * DV + 8 * j + 2 * (lane % 4), dqa[c][i] * scale,
               dqa[c][i + 1] * scale);
      }
  }
}

// A stream of the highest priority beside the caller's, and two events to
// fork to it and join back, one set per device, made at first use and kept
// for the process. Calls hold side_mutex() from here to their join, so that
// two host threads launching on one device take turns with the events.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

inline std::mutex& side_mutex() {
  static std::mutex m;
  return m;
}

inline cudaError_t side_of_device(Side& out) {
  static Side sides[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  Side& s = sides[dev];
  if (s.stream == nullptr) {
    int least = 0, greatest = 0;
    err = cudaDeviceGetStreamPriorityRange(&least, &greatest);
    if (err == cudaSuccess)
      err = cudaStreamCreateWithPriority(&s.stream, cudaStreamNonBlocking, greatest);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&s.fork, cudaEventDisableTiming);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&s.join, cudaEventDisableTiming);
    if (err != cudaSuccess) {
      s = Side();
      return err;
    }
  }
  out = s;
  return cudaSuccess;
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const float* lse,
           const bf16* dout, bf16* dq, bf16* dk, bf16* dv, float* stats, int B, int S, int Skv,
           int H, int KH, float scale, int causal, int window, float softcap, cudaStream_t st) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = hopper::tma_map_bshd(&tq, q, B, S, H, D, BM);
  if (err == cudaSuccess) err = hopper::tma_map_bshd(&tk, k, B, Skv, KH, D, BM);
  if (err == cudaSuccess) err = hopper::tma_map_bshd(&tv, v, B, Skv, KH, D, BM);
  if (err == cudaSuccess) err = hopper::tma_map_bshd(&tdo, dout, B, S, H, D, BM);
  static std::atomic<unsigned long long> dkdv_in{0}, dq_in{0};
  if (err == cudaSuccess)
    err = hopper::opt_in_smem((const void*)flash_bwd_wgmma_dkdv_kernel<D>, C::SMEM_DKDV, dkdv_in);
  if (err == cudaSuccess)
    err = hopper::opt_in_smem((const void*)flash_bwd_wgmma_dq_kernel<D>, C::SMEM_DQ, dq_in);
  std::lock_guard<std::mutex> guard(side_mutex());
  Side side;
  if (err == cudaSuccess) err = side_of_device(side);
  if (err != cudaSuccess) return (int)err;
  const int S64 = (S + BM - 1) / BM * BM;
  const long lanes = (long)B * S64 * H * (D / 8);
  flash_bwd_bf16_delta_kernel<<<(unsigned)((lanes + 255) / 256), 256, 0, st>>>(o, dout, lse, stats,
                                                                               B, S, S64, H, D);
  err = cudaGetLastError();
  // dK/dV on the side stream, dQ on the caller's, both after Delta: the two
  // kernels share the card, the dQ CTAs taking the SMs that the dK/dV
  // kernel's lighter key tiles leave; the caller's stream joins the side's
  if (err == cudaSuccess) err = cudaEventRecord(side.fork, st);
  if (err == cudaSuccess) err = cudaStreamWaitEvent(side.stream, side.fork, 0);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_wgmma_dkdv_kernel<D>
      <<<dim3((unsigned)((Skv + BM - 1) / BM * C::NSPLIT), KH, B), CONSUMERS * WG, C::SMEM_DKDV,
         side.stream>>>(tq, tk, tv, tdo, stats, dk, dv, S, Skv, S64, H, KH, scale, causal,
                        window, softcap);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaEventRecord(side.join, side.stream);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_wgmma_dq_kernel<D><<<dim3(H, B, (S + BM - 1) / BM), WG, C::SMEM_DQ, st>>>(
      tq, tk, tv, tdo, stats, dq, S, Skv, S64, H, KH, scale, causal, window, softcap);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaStreamWaitEvent(st, side.join, 0);
  return (int)err;
}

}  // namespace bf

}  // namespace

namespace {

// the 3xTF32 kernels' checks and launch, for T's head_dims (fp32: 16, 64,
// 128 and 256; bf16: 16)
template <typename T>
int tf32x3_call(const void* q, const void* k, const void* v, const void* o, const void* lse,
                const void* dout, void* dq, void* dk, void* dv, void* delta, void* dkh,
                void* dvh, int B, int S, int S_kv, int H, int KH, int D, float scale, int causal,
                int window, float softcap, void* stream) {
  constexpr bool fp32 = std::is_same_v<T, float>;
  if (B <= 0 || S <= 0 || S_kv <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || B > 65535 ||
      H > 65535 || (long)(((S > S_kv ? S : S_kv) + 31) / 32) * B * H > 0x7fffffffL ||
      ((KH < H || !fp32) && !(dkh && dvh)) || (S_kv != S && (causal || window > 0)))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, dout, (const void*)dq, (const void*)dk, (const void*)dv,
                        (const void*)dkh, (const void*)dvh})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K1_BWD_ARGS                                                                           \
  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),               \
      static_cast<const T*>(o), static_cast<const float*>(lse), static_cast<const T*>(dout),  \
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),                          \
      static_cast<float*>(delta), static_cast<float*>(dkh), static_cast<float*>(dvh), B, S,   \
      S_kv, H, KH, scale, causal, window, softcap, st
  if (D == 16) return launch<T, 16>(K1_BWD_ARGS);
  if constexpr (fp32) {
    switch (D) {
      case 64: return launch<T, 64>(K1_BWD_ARGS);
      case 128: return launch<T, 128>(K1_BWD_ARGS);
      case 256: return launch<T, 256>(K1_BWD_ARGS);
      default: break;
    }
  }
#undef K1_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// fp32 q, o, dout, dq (B, S, H, D); k, v, dk, dv (B, S_kv, KH, D); lse and
// the workspace delta (B, H, S); with KH < H the workspaces dkh and dvh (B,
// S_kv, H, D), else they may be null. S_kv != S only without a causal mask
// and a window. q, k, v, dout and the outputs must be 16-byte aligned.
// Launches the kernels on `stream` and does not synchronise; returns
// cudaGetLastError() after each launch (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* lse, const void* dout, void* dq, void* dk,
                                   void* dv, void* delta, void* dkh, void* dvh, int B, int S,
                                   int S_kv, int H, int KH, int D, float scale, int causal,
                                   int window, float softcap, void* stream) {
  return tf32x3_call<float>(q, k, v, o, lse, dout, dq, dk, dv, delta, dkh, dvh, B, S, S_kv, H,
                            KH, D, scale, causal, window, softcap, stream);
}

// The same kernels on bf16 at head_dim 16 (bf16 q, k, v, o, dout, dq, dk,
// dv; lse and the workspaces fp32 as above, dkh and dvh always given: dK
// and dV are rounded once, after the sum over each kv head's query heads).
extern "C" int flash_attention_bwd_tf32x3_bf16(const void* q, const void* k, const void* v,
                                               const void* o, const void* lse, const void* dout,
                                               void* dq, void* dk, void* dv, void* delta,
                                               void* dkh, void* dvh, int B, int S, int S_kv,
                                               int H, int KH, int D, float scale, int causal,
                                               int window, float softcap, void* stream) {
  return tf32x3_call<__nv_bfloat16>(q, k, v, o, lse, dout, dq, dk, dv, delta, dkh, dvh, B, S,
                                    S_kv, H, KH, D, scale, causal, window, softcap, stream);
}

// The bf16 route: bf16 q, k, v, o, dout, dq, dk, dv in the layouts above;
// lse (B, H, S) fp32; the workspace stats (B, H, 2, S64) fp32, S64 = S
// rounded up to a multiple of 64. D 64, 128 or 256, the bf16 forward's
// wgmma widths. Every pointer 16-byte aligned. Launches the kernels on
// `stream` and does not synchronise; returns cudaGetLastError() after each
// launch (0 on success).
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* o, const void* lse, const void* dout,
                                        void* dq, void* dk, void* dv, void* stats, int B, int S,
                                        int S_kv, int H, int KH, int D, float scale, int causal,
                                        int window, float softcap, void* stream) {
  if (B <= 0 || S <= 0 || S_kv <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || B > 65535 ||
      KH > 65535 || (S + 63) / 64 > 65535 || (S_kv != S && (causal || window > 0)))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, o, dout, (const void*)dq, (const void*)dk, (const void*)dv,
                        (const void*)stats})
    if (p == nullptr || reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf::bf16;
#define K1_BWD_BF16_ARGS                                                                      \
  static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),      \
      static_cast<const bf16*>(o), static_cast<const float*>(lse),                            \
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<bf16*>(dk),         \
      static_cast<bf16*>(dv), static_cast<float*>(stats), B, S, S_kv, H, KH, scale, causal,   \
      window, softcap, st
  switch (D) {
    case 64: return bf::launch<64>(K1_BWD_BF16_ARGS);
    case 128: return bf::launch<128>(K1_BWD_BF16_ARGS);
    case 256: return bf::launch<256>(K1_BWD_BF16_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K1_BWD_BF16_ARGS
}
