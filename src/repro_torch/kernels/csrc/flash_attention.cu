// K1: causal flash attention for prefill, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/flash_attention.py::flash_attention`
// (body `_flash_kernel`). Same function: scores (q . k^T) * scale in fp32,
// the gemma2 softcap cap*tanh(s/cap) before the mask, an optional causal
// mask and sliding window (row - col < window) with masked logits at -1e30,
// an online softmax, and out = acc / max(l, 1e-30) in q's dtype.
//
// Layout: q and o are (B, S, H, D); k and v are (B, S, KH, D) with KH
// dividing H, query head h reading kv head h / (H / KH). The head-expanded
// cache of the TPU kernel is the case KH == H, so GQA never materialises an
// expanded copy. Any S is accepted: keys past S get -inf (distinct from a
// masked key's -1e30) and rows past S are not stored (the Pallas kernel
// asserted S % block == 0).
//
// Two routes, chosen by dtype and head_dim alone (`flash_attention_route`):
// - bf16 at D 64, 128 and 256, which every serving path calls, takes
//   `flash_wgmma_kernel`: both products on the tensor cores.
// - fp32 at any D, and bf16 at D 16, take `flash_kernel`, on the fp32 CUDA
//   cores. fp32 on the tensor cores would be TF32, about three decimal
//   digits, where the fp32 checks hold the kernel to 2e-5.
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
// CUDA-core design (`flash_kernel`): one CTA per (q tile of BQ rows, head,
// batch) loops over 32-key KV tiles staged in shared memory as fp32,
// carrying the running max m, sum l and the accumulator in registers, with
// the same tile skipping. Each thread owns a RPT x 4 block of scores and a
// RPT x D/8 block of the output; the 8 lanes that share a row group reduce
// the row max and sum with warp shuffles. Shared-memory rows are padded so
// that neither product has bank conflicts. Up to D = 128 a tile is 64 rows
// (RPT 4); at D = 256 it is 32 rows (RPT 2), which keeps the accumulator at
// 64 registers a thread and the shared memory at 103 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int BK = 32;         // keys per KV tile
constexpr int NT = 128;        // threads per CTA
constexpr int CG = 8;          // lanes sharing one row group
constexpr int CPT = BK / CG;   // score columns per thread
constexpr int SP = BK + 2;     // padded row of the probability tile
constexpr float NEG_INF = -1e30f;

// Rows per thread and query rows per CTA, by head dim: (NT / CG) * RPT == BQ.
template <int D> __host__ __device__ constexpr int rows_per_thread() { return D > 128 ? 2 : 4; }
template <int D> __host__ __device__ constexpr int q_rows() { return (NT / CG) * rows_per_thread<D>(); }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  constexpr int BQ = q_rows<D>();
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * SP);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int S, int H, int KH, float scale, int causal, int window,
             float softcap) {
  constexpr int RPT = rows_per_thread<D>();
  constexpr int BQ = q_rows<D>();
  constexpr int DP = D + 1;       // padded row: column reads hit distinct banks
  constexpr int DPT = D / CG;     // output dims per thread
  extern __shared__ float smem[];
  float* sq = smem;               // [BQ][DP]
  float* sk = sq + BQ * DP;       // [BK][DP]
  float* sv = sk + BK * DP;       // [BK][D]
  float* sp = sv + BK * D;        // [BQ][SP]

  const int tid = threadIdx.x;
  const int rg = tid / CG;        // row group: rows rg*RPT .. rg*RPT+RPT-1
  const int cg = tid % CG;        // columns cg + CG*j, output dims cg + CG*j
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const long qs = (long)H * D;    // stride of one position in q / o
  const long ks = (long)KH * D;   // stride of one position in k / v
  const T* qb = q + (long)b * S * qs + (long)h * D;
  const T* kb = k + (long)b * S * ks + (long)kh * D;
  const T* vb = v + (long)b * S * ks + (long)kh * D;
  T* ob = o + (long)b * S * qs + (long)h * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, row = q0 + r;
    sq[r * DP + c] = row < S ? to_f(qb[(long)row * qs + c]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < DPT; ++t) acc[i][t] = 0.f;
  }

  // Tiles wholly above the diagonal or wholly outside the window hold only
  // masked logits; with at least one valid key per row they add exp(-1e30 -
  // m) == 0, so skipping them is exact.
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done (and sq is staged)
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, key = k0 + r;
      const bool in = key < S;
      sk[r * DP + c] = in ? to_f(kb[(long)key * ks + c]) : 0.f;
      sv[r * D + c] = in ? to_f(vb[(long)key * ks + c]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sq[(rg * RPT + i) * DP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sk[(cg + CG * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + rg * RPT + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + cg + CG * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = true;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && (row - col) < window;
        x = ok ? x : NEG_INF;
        if (col >= S) x = -INFINITY;  // past the ragged end: no key at all
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        sp[(rg * RPT + i) * SP + cg + CG * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int t = 0; t < DPT; ++t) acc[i][t] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sp[(rg * RPT + i) * SP + c];
#pragma unroll
      for (int t = 0; t < DPT; ++t) {
        const float vv = sv[c * D + cg + CG * t];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][t] = fmaf(pv[i], vv, acc[i][t]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg * RPT + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int t = 0; t < DPT; ++t) ob[(long)row * qs + cg + CG * t] = from_f<T>(acc[i][t] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KH,
           float scale, int causal, int window, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = hopper::opt_in_smem((const void*)flash_kernel<T, D>, (int)smem, opted_in);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + q_rows<D>() - 1) / q_rows<D>(), H, B);
  flash_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, KH, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int S, int H,
               int KH, float scale, int causal, int window, float softcap, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KH, scale, causal, window, softcap, st);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KH, scale, causal, window, softcap, st);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KH, scale, causal, window, softcap, st);
    case 256: return launch<T, 256>(q, k, v, o, B, S, H, KH, scale, causal, window, softcap, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int S,
                   int H, int KH, float scale, int causal, int window, float softcap) {
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
  const int kv_end = causal ? min(S, q0 + BQ) : S;
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
                      k0 + BK > S;
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
        if (col >= S) x = -INFINITY;  // past the ragged end: no key at all
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
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const long qs = (long)H * D;  // stride of one position in q / o
  __nv_bfloat16* ob = o + (long)b * S * qs + (long)h * D;
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
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KH,
           float scale, int causal, int window, float softcap, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = hopper::tma_map_bshd(&tq, q, B, S, H, D, BQ);
  if (err == cudaSuccess) err = hopper::tma_map_bshd(&tk, k, B, S, KH, D, C::BK);
  if (err == cudaSuccess) err = hopper::tma_map_bshd(&tv, v, B, S, KH, D, C::BK);
  if (err != cudaSuccess) return (int)err;
  static std::atomic<unsigned long long> opted_in{0};
  err = hopper::opt_in_smem((const void*)flash_wgmma_kernel<D>, C::SMEM, opted_in);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_wgmma_kernel<D><<<grid, THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, H, KH, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// 1 if (dtype, D) takes the tensor-core route, 0 if the CUDA-core one.
extern "C" int flash_attention_route(int dtype, int D) {
  return dtype == 1 && (D == 64 || D == 128 || D == 256);
}

// dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError() after
// the launch (0 on success); launches on `stream` and does not synchronise.
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v, void* o,
                               int B, int S, int H, int KH, int D, float scale, int causal,
                               int window, float softcap, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flash_attention_route(dtype, D)) {
    switch (D) {
      case 64: return tc::launch<64>(q, k, v, o, B, S, H, KH, scale, causal, window, softcap, st);
      case 128: return tc::launch<128>(q, k, v, o, B, S, H, KH, scale, causal, window, softcap, st);
      default: return tc::launch<256>(q, k, v, o, B, S, H, KH, scale, causal, window, softcap, st);
    }
  }
  switch (dtype) {
    case 0: return dispatch_d<float>(D, q, k, v, o, B, S, H, KH, scale, causal, window, softcap, st);
    case 1:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, S, H, KH, scale, causal, window, softcap,
                                       st);
    default: return (int)cudaErrorInvalidValue;
  }
}
