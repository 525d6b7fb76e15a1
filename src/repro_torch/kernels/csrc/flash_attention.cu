// K1: causal flash attention for prefill, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/flash_attention.py::flash_attention`
// (body `_flash_kernel`). Same function: online-softmax attention with an
// optional causal mask, sliding window (row - col < window) and gemma2
// softcap cap*tanh(s/cap) applied before the mask; masked logits are -1e30;
// the output is acc / max(l, 1e-30) in q's dtype. All arithmetic is fp32.
//
// Layout: q and o are (B, S, H, D); k and v are (B, S, KH, D) with KH
// dividing H, query head h reading kv head h / (H / KH). The head-expanded
// cache of the TPU kernel is the case KH == H, so GQA never materialises an
// expanded copy. Any S is accepted: the ragged tail of the last query and
// key tiles is masked here (the Pallas kernel asserted S % block == 0).
//
// Bound on the H100 SXM (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s fp32
// CUDA cores, 3.35 TB/s): causal FLOPs = 2 * BH * S^2 * D (two products,
// half the score matrix). This kernel uses the fp32 CUDA cores, so its own
// floor is FLOPs / 67e12; the card's floor is FLOPs / 989e12. At qwen3's
// serving shapes (BH = 4*40, S = 256, D = 128, bf16) that is 2.7 GFLOP a
// call, 40 us on CUDA cores and 2.7 us on tensor cores; q, k, v and o, each
// read or written once, are 25 MB, 7.5 us at 3.35 TB/s, so at this short S
// the card's bound is the bytes. At RecurrentGemma's (B 4, S 512, 10 query
// heads on 1 kv head, D 256, window 2048 > S, bf16) it is 5.4 GFLOP, 80 us
// on CUDA cores and 5.4 us on tensor cores, against 23.1 MB (q and o 21.0
// MB, the single kv head 2.1 MB), 6.9 us: the bytes again.
//
// Design against that bound: one CTA per (q tile of BQ rows, head, batch)
// loops over 32-key KV tiles staged in shared memory as fp32, carrying the
// running max m, sum l and the accumulator in registers; tiles entirely
// above the causal diagonal (or entirely outside the window) are never
// loaded, which halves the work of the causal case. Each thread owns a
// RPT x 4 block of scores and a RPT x D/8 block of the output; the 8 lanes
// that share a row group reduce the row max and sum with warp shuffles.
// Shared-memory rows are padded so that neither product has bank conflicts.
// Up to D = 128 a tile is 64 rows (RPT 4). At D = 256 it is 32 rows (RPT
// 2): the accumulator stays at 64 registers a thread instead of 128, so it
// does not spill, and the 103 KB of shared memory let two CTAs share an SM.
// Moving the two products onto wgmma with TMA-fed tiles is the next step,
// in a later change: this kernel's own CUDA-core floor is 5-12x the card's
// bound at these shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

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
  // The shared-memory opt-in is per device; it is set on a device's first
  // launch of this instantiation and remembered in a bit mask.
  static std::atomic<unsigned long long> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(opted_in.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(flash_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in.fetch_or(bit, std::memory_order_relaxed);
  }
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

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError() after
// the launch (0 on success); launches on `stream` and does not synchronise.
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v, void* o,
                               int B, int S, int H, int KH, int D, float scale, int causal,
                               int window, float softcap, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(D, q, k, v, o, B, S, H, KH, scale, causal, window, softcap, st);
    case 1:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, S, H, KH, scale, causal, window, softcap,
                                       st);
    default: return (int)cudaErrorInvalidValue;
  }
}
