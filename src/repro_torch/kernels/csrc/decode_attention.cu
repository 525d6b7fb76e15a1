// K2: decode attention (one query token per head against a KV cache),
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/decode_attention.py::decode_attention`
// (body `_decode_kernel`). Same function: for every (batch b, head h), an
// online softmax over cache positions, with positions at or past lengths[b]
// masked to -1e30, and the output acc / max(l, 1e-30) in q's dtype. A row
// whose length is 0 has every logit masked, so it returns the mean of all S
// cached V rows, as the Pallas kernel and its oracle do. All arithmetic is
// fp32.
//
// Layout: q and o are (B, H, D); k and v are (B, S, KH, D) with KH dividing
// H, query head h reading kv head h / (H / KH). The head-expanded cache of
// the TPU kernel is the case KH == H; the serving path passes the
// unexpanded GQA cache, so the expanded copy is never built. Any S is
// accepted.
//
// Bound on the H100 SXM (3.35 TB/s): the bytes of K and V that the lengths
// make valid, 2 * B * KH * min(len, S) * D * sizeof(T), plus q and o; the
// operations (4 * B * H * len * D) are far below the compute roof. At
// qwen3's serving shapes (B = 4, KH = 8, D = 128, bf16, len ~ 256..272) that
// is about 4.5 MB a call, 1.3 us; at RecurrentGemma's (B 4, 10 query heads
// on KH = 1, D 256, a ring of 576 slots with len ~ 520) about 2.2 MB, 0.64
// us.
//
// Design against that bound: one CTA per (kv head, block of query heads,
// batch row) reads each valid K and V row once and serves the query heads
// of its block that share it. A block holds up to HB heads (8 up to D 128,
// 5 at D 256), so qwen3's 5 heads per kv head are one block and GQA costs
// no extra bytes; RecurrentGemma's 10 are two blocks, which read the kv
// head twice (from L2 the second time) and double the CTAs. The block
// bounds both the per-lane registers (q and the accumulator are HB x D/32
// floats) and the static shared memory (NW x HB x D floats for the merge,
// 40 KB at D 256), so any number of query heads per kv head is served.
// Eight warps stride over positions, PPW positions per warp per step (4, or
// 2 at D 256 to keep K and V's registers at 32 a lane), so 2 * PPW * D/32
// independent loads a lane are in flight; each lane holds D / 32
// dimensions, and a dot product is finished with warp shuffles. Positions
// past the valid length are not read at all: their logits are -1e30 and add
// exp(-1e30 - m) == 0 next to a valid one. The warps' partial (m, l, acc)
// are merged through shared memory. With only B * KH * blocks CTAs (32 at
// qwen3's shapes, 8 at RecurrentGemma's) the card is far from full;
// splitting S across more CTAs, with a combine pass, is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NW = 8;          // warps per CTA
constexpr float NEG_INF = -1e30f;

// Query heads per CTA and positions per warp per step, by head dim.
template <int D> __host__ __device__ constexpr int heads_per_cta() { return D > 128 ? 5 : 8; }
template <int D> __host__ __device__ constexpr int positions_per_warp() { return D > 128 ? 2 : 4; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ lengths, T* __restrict__ o, int S, int H, int KH,
              float scale) {
  constexpr int MAXG = heads_per_cta<D>();
  constexpr int PPW = positions_per_warp<D>();
  constexpr int DPL = D >= 32 ? D / 32 : 1;   // dims per lane
  constexpr int LANES = D / DPL;              // lanes that hold dims
  __shared__ float sm_acc[NW][MAXG][D];
  __shared__ float sm_m[NW][MAXG];
  __shared__ float sm_l[NW][MAXG];

  // this CTA serves query heads kh * GQ + g0 .. + G - 1 of kv head kh
  const int GQ = H / KH;
  const int NB = (GQ + MAXG - 1) / MAXG;       // head blocks per kv head
  const int kh = blockIdx.x / NB, g0 = (blockIdx.x % NB) * MAXG, b = blockIdx.y;
  const int G = min(MAXG, GQ - g0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool active = lane < LANES;
  const int d0 = lane * DPL;

  const int len = lengths[b];
  const bool empty = len <= 0;                 // every logit masked
  const int n = empty ? S : min(len, S);       // positions this row reads

  const T* qb = q + ((long)b * H + (long)kh * GQ + g0) * D;
  const long ps = (long)KH * D;                // stride of one cache position
  const T* kb = k + (long)b * S * ps + (long)kh * D;
  const T* vb = v + (long)b * S * ps + (long)kh * D;

  float qf[MAXG][DPL], acc[MAXG][DPL], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      acc[g][t] = 0.f;
      qf[g][t] = (g < G && active) ? to_f(qb[(long)g * D + d0 + t]) : 0.f;
    }
  }

  for (int p0 = warp * PPW; p0 < n; p0 += NW * PPW) {
    float kf[PPW][DPL], vf[PPW][DPL];
#pragma unroll
    for (int u = 0; u < PPW; ++u) {
      const int pos = p0 + u;
      const bool in = pos < n && active;
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        kf[u][t] = in ? to_f(kb[(long)pos * ps + d0 + t]) : 0.f;
        vf[u][t] = in ? to_f(vb[(long)pos * ps + d0 + t]) : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) continue;  // G is uniform: no divergence; g stays a constant
      float s[PPW];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < PPW; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int t = 0; t < DPL; ++t) dot = fmaf(qf[g][t], kf[u][t], dot);
        dot = warp_sum(dot) * scale;
        if (empty) dot = NEG_INF;
        if (p0 + u >= n) dot = -INFINITY;      // not a position of this row
        s[u] = dot;
        mx = fmaxf(mx, dot);
      }
      const float m_new = fmaxf(m[g], mx);
      const float corr = expf(m[g] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < DPL; ++t) acc[g][t] *= corr;
#pragma unroll
      for (int u = 0; u < PPW; ++u) {
        const float p = expf(s[u] - m_new);
        psum += p;
#pragma unroll
        for (int t = 0; t < DPL; ++t) acc[g][t] = fmaf(p, vf[u][t], acc[g][t]);
      }
      l[g] = l[g] * corr + psum;
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) continue;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
    if (active) {
#pragma unroll
      for (int t = 0; t < DPL; ++t) sm_acc[warp][g][d0 + t] = acc[g][t];
    }
  }
  __syncthreads();

  T* ob = o + ((long)b * H + (long)kh * GQ + g0) * D;
  for (int i = threadIdx.x; i < G * D; i += NW * 32) {
    const int g = i / D, d = i % D;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, sm_m[w][g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(sm_m[w][g] - mm);
      ll = fmaf(sm_l[w][g], c, ll);
      aa = fmaf(sm_acc[w][g][d], c, aa);
    }
    ob[(long)g * D + d] = from_f<T>(aa / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* o, int B,
           int S, int H, int KH, float scale, cudaStream_t stream) {
  constexpr int MAXG = heads_per_cta<D>();
  dim3 grid(KH * ((H / KH + MAXG - 1) / MAXG), B);
  decode_kernel<T, D><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(o), S, H, KH, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, const void* lengths, void* o,
               int B, int S, int H, int KH, float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, lengths, o, B, S, H, KH, scale, st);
    case 64: return launch<T, 64>(q, k, v, lengths, o, B, S, H, KH, scale, st);
    case 128: return launch<T, 128>(q, k, v, lengths, o, B, S, H, KH, scale, st);
    case 256: return launch<T, 256>(q, k, v, lengths, o, B, S, H, KH, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; lengths is int32 on the device.
// Returns cudaGetLastError() after the launch (0 on success); launches on
// `stream` and does not synchronise.
extern "C" int decode_attention(int dtype, const void* q, const void* k, const void* v,
                                const void* lengths, void* o, int B, int S, int H, int KH, int D,
                                float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(D, q, k, v, lengths, o, B, S, H, KH, scale, st);
    case 1: return dispatch_d<__nv_bfloat16>(D, q, k, v, lengths, o, B, S, H, KH, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
