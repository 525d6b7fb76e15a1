// K1-bwd: the gradient of causal flash attention, hand-written for Hopper
// (sm_90a), fp32 in and out, its products on the tensor cores as 3xTF32.
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
// pairs and keys past S have P = 0, so they add nothing.
//
// Layout: q, o, dO and dQ are (B, S, H, D); k, v, dK and dV (B, S, KH, D)
// with KH dividing H; lse and Delta (B, H, S). All fp32, every pointer
// 16-byte aligned.
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
// diagonal, the window's edge or S compute the mask.
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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

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

// P of the score element at query row `row`, key `key`, from its logit s
// (unscaled) and the row's lse, and the softcap's derivative dxdt; then
// dX = P (dP - Delta) dxdt
__device__ __forceinline__ void p_of(float s, float l, int row, int key, int S, bool edge,
                                     float scale, int causal, int window, float softcap,
                                     float& p, float& dxdt) {
  float x = s * scale;
  dxdt = 1.f;
  if (softcap > 0.f) {
    const float th = tanhf(x / softcap);
    x = softcap * th;
    dxdt = 1.f - th * th;
  }
  bool ok = true;
  if (edge) {
    ok = row < S && key < S;
    if (causal) ok = ok && key <= row;
    if (window > 0) ok = ok && (row - key) < window;
  }
  p = ok ? expf(x - l) : 0.f;
}

// ---- kernels -------------------------------------------------------------------

// Delta_i = dO_i . O_i into (B, H, S): one warp a (b, s, h) row
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                       float* __restrict__ delta, int B, int S, int H, int D) {
  const long row = (long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;   // (b, s, h)
  const int lane = threadIdx.x % 32;
  if (row >= (long)B * S * H) return;
  const float* orow = o + row * D;
  const float* drow = dout + row * D;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum = fmaf(orow[d], drow[d], sum);
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
// dvh, (B, S, H, D): dK and dV themselves when KH == H, else the workspace
// that flash_bwd_reduce_kernel sums
template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dkh, float* __restrict__ dvh, int B, int S, int H,
                      int KH, float scale, int causal, int window, float softcap) {
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
  const float* qb = q + (long)b * S * qs + (long)h * D;
  const float* db = dout + (long)b * S * qs + (long)h * D;
  const float* lb = lse + ((long)b * H + h) * S;
  const float* eb = delta + ((long)b * H + h) * S;

  // the query rows that can see keys k0 .. k0 + 31: none before k0 if
  // causal, none at or past k0 + 31 + window with a window
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + BKV - 1 + window) : S;

  load_tile<D, NT>(sk, k + (long)b * S * ks + (long)kh * D, k0, S, ks);
  load_tile<D, NT>(sv, v + (long)b * S * ks + (long)kh * D, k0, S, ks);
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
    const bool edge = edge_tile<BQ, BKV>(q0, k0, S, causal, window);
    float p[4], dxdt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = wm * 16 + g + 8 * (i / 2), qc = wn * 8 + 2 * t + i % 2;
      if (second) {
        sdxt[kr * SP + qc] = x[i];   // dP^T, for the S warp of this element
      } else {
        p_of(x[i], tl[qc], q0 + qc, k0 + kr, S, edge, scale, causal, window, softcap, p[i],
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
  float* out = (second ? dkh : dvh) + (long)b * S * qs + (long)h * D;
  const float mul = second ? scale : 1.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + wm * 16 + g + 8 * half;
    if (key >= S) continue;
#pragma unroll
    for (int j = 0; j < C::NTW; ++j)
      *reinterpret_cast<float2*>(out + (long)key * qs + (nblk * C::NTW + j) * 8 + 2 * t) =
          make_float2(acc[j][2 * half] * mul, acc[j][2 * half + 1] * mul);
  }
}

// dK and dV (B, S, KH, D) as the sums of their G = H / KH query heads'
// shares (B, S, H, D), g = 0 .. G - 1 in order: one thread an element
__global__ void __launch_bounds__(256)
flash_bwd_reduce_kernel(const float* __restrict__ dkh, const float* __restrict__ dvh,
                        float* __restrict__ dk, float* __restrict__ dv, long n, int G, int D) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;   // (b, s, kh, d) of dK
  if (i >= n) return;
  // kv head kh's query heads kh G .. kh G + G - 1 sit side by side in a row
  const long src = (i / D) * G * D + i % D;
  float sk = 0.f, sv = 0.f;
  for (int g = 0; g < G; ++g) {
    sk += dkh[src + (long)g * D];
    sv += dvh[src + (long)g * D];
  }
  dk[i] = sk;
  dv[i] = sv;
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int B, int S, int H, int KH, float scale, int causal,
                    int window, float softcap) {
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
  const float* kb = k + (long)b * S * ks + (long)kh * D;
  const float* vb = v + (long)b * S * ks + (long)kh * D;

  // the key tiles the forward walks: none past the diagonal if causal, none
  // wholly outside the window
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BKV * BKV : 0;

  load_tile<D, NT>(sq, q + (long)b * S * qs + (long)h * D, q0, S, qs);
  load_tile<D, NT>(sdo, dout + (long)b * S * qs + (long)h * D, q0, S, qs);
  load_stats(sl, sdel, lse + ((long)b * H + h) * S, delta + ((long)b * H + h) * S, q0, S);
  load_tile<D, NT>(sk, kb, kv_begin, S, ks);
  load_tile<D, NT>(sv, vb, kv_begin, S, ks);
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
      load_tile<D, NT>(sk + ns * C::TILE, kb, k0 + BKV, S, ks);
      load_tile<D, NT>(sv + ns * C::TILE, vb, k0 + BKV, S, ks);
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
    const bool edge = edge_tile<BQ, BKV>(q0, k0, S, causal, window);
    float p[4], dxdt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = wm * 16 + g + 8 * (i / 2), kc = wn * 8 + 2 * t + i % 2;
      if (second)
        sdx[qr * SP + kc] = x[i];   // dP, for the S warp of this element
      else
        p_of(x[i], sl[qr], q0 + qr, k0 + kc, S, edge, scale, causal, window, softcap, p[i],
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

  float* dqb = dq + (long)b * S * qs + (long)h * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + wm * 16 + g + 8 * hr;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < C::NTW; ++j)
      *reinterpret_cast<float2*>(dqb + (long)row * qs + (nblk * C::NTW + j) * 8 + 2 * t) =
          make_float2(acc[j][2 * hr] * scale, acc[j][2 * hr + 1] * scale);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o, const float* lse,
           const float* dout, float* dq, float* dk, float* dv, float* delta, float* dkh,
           float* dvh, int B, int S, int H, int KH, float scale, int causal, int window,
           float softcap, cudaStream_t st) {
  using C = Tc<D>;
  static std::atomic<unsigned long long> dkdv_in{0}, dq_in{0};
  cudaError_t err =
      hopper::opt_in_smem((const void*)flash_bwd_dkdv_kernel<D>, C::SMEM_DKDV, dkdv_in);
  if (err == cudaSuccess)
    err = hopper::opt_in_smem((const void*)flash_bwd_dq_kernel<D>, C::SMEM_DQ, dq_in);
  if (err != cudaSuccess) return (int)err;
  const long rows = (long)B * S * H;
  flash_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(o, dout, delta, B, S, H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool shared_kv = KH < H;   // dK, dV sum query heads' shares from the workspace
  const unsigned heads = (unsigned)B * H;
  flash_bwd_dkdv_kernel<D><<<(unsigned)((S + BKV - 1) / BKV) * heads, NT, C::SMEM_DKDV, st>>>(
      q, k, v, dout, lse, delta, shared_kv ? dkh : dk, shared_kv ? dvh : dv, B, S, H, KH, scale,
      causal, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (shared_kv) {
    const long n = (long)B * S * KH * D;
    flash_bwd_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(dkh, dvh, dk, dv, n,
                                                                         H / KH, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  flash_bwd_dq_kernel<D><<<(unsigned)((S + BQ - 1) / BQ) * heads, NT, C::SMEM_DQ, st>>>(
      q, k, v, dout, lse, delta, dq, B, S, H, KH, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 q, o, dout, dq (B, S, H, D); k, v, dk, dv (B, S, KH, D); lse and the
// workspace delta (B, H, S); with KH < H the workspaces dkh and dvh (B, S,
// H, D), else they may be null. q, k, v, dout and the outputs must be
// 16-byte aligned. Launches the kernels on `stream` and does not
// synchronise; returns cudaGetLastError() after each launch (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* lse, const void* dout, void* dq, void* dk,
                                   void* dv, void* delta, void* dkh, void* dvh, int B, int S,
                                   int H, int KH, int D, float scale, int causal, int window,
                                   float softcap, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || B > 65535 || H > 65535 ||
      (long)((S + 31) / 32) * B * H > 0x7fffffffL || (KH < H && !(dkh && dvh)))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, dout, (const void*)dq, (const void*)dk, (const void*)dv,
                        (const void*)dkh, (const void*)dvh})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K1_BWD_ARGS                                                                           \
  static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),   \
      static_cast<const float*>(o), static_cast<const float*>(lse),                           \
      static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(dk),      \
      static_cast<float*>(dv), static_cast<float*>(delta), static_cast<float*>(dkh),          \
      static_cast<float*>(dvh), B, S, H, KH, scale, causal, window, softcap, st
  switch (D) {
    case 16: return launch<16>(K1_BWD_ARGS);
    case 64: return launch<64>(K1_BWD_ARGS);
    case 128: return launch<128>(K1_BWD_ARGS);
    case 256: return launch<256>(K1_BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K1_BWD_ARGS
}
