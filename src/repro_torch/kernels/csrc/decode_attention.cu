// K2: decode attention (one query token per head against a KV cache),
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/decode_attention.py::decode_attention`
// (body `_decode_kernel`). Same function: for every (batch b, head h), a
// softmax over cache positions, with positions at or past lengths[b] masked
// to -1e30, and the output acc / max(l, 1e-30) in q's dtype. A row whose
// length is 0 has every logit masked, so it returns the mean of all S cached
// V rows, as the Pallas kernel and its oracle do; a length past S counts as
// S. All arithmetic is fp32. With softcap > 0 each logit is capped after
// the scale, cap * tanh(s / cap), before the mask and the softmax, as the
// reference's decode (`repro/nn/attention.py::attend_ref`, gemma2's
// attention softcap) does; the Pallas kernel has no softcap. softcap 0
// skips it, so the uncapped arithmetic is the same as without it.
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
// qwen3's serving call (B 4, KH 8, D 128, bf16, length 264) that is about
// 4.5 MB, 1.3 us; at RecurrentGemma's (B 4, 10 query heads on KH 1, D 256,
// a ring of 576 slots, length 520) about 2.2 MB, 0.65 us; at gemma2's (B 4,
// 16 query heads on KH 8, D 256, length 4360 of a 4416-slot cache) about
// 143 MB, 43 us, where the softcap's one tanhf a logit (0.28 M of them) is
// far below the bytes.
//
// Why the earlier design could not reach it: one CTA per (kv head, block of
// query heads, batch row) gave 32 CTAs at qwen3's call and 8 at
// RecurrentGemma's on 132 SMs, each streaming its whole row alone, a few
// positions a warp at a time with a shuffle reduction over D per position
// (0.21 and 0.03 TB/s on an H100 SXM at 700 W). The split-S design below
// spreads S over CTAs and merges their partial softmaxes in a second pass:
//
// - Plan (host, decode_attention.py::plan, from shapes alone, so a CUDA
//   graph can capture the call): each split covers `chunk` positions, the
//   largest power of two >= 16 for which B * KH * ceil(S / chunk) >=
//   2 * SMs, else 16, within shared memory. At 132 SMs: qwen3 chunk 32, 16
//   splits, 512 CTAs (288 of them live at length 264); RecurrentGemma chunk
//   16, 36 splits, 144 CTAs (132 live at length 520).
// - decode_split_kernel, grid (splits, KH, B): a CTA serves all G = H / KH
//   query heads of its kv head, so every K and V row is read from HBM once
//   at any G. A CTA whose chunk starts at or past the row's length returns
//   at once. Otherwise it stages its valid rows of K, then of V, as two
//   groups of 16-byte cp.async copies (K rows padded by 16 bytes, so the
//   lanes reading one column of different rows hit different banks), and q
//   in its own dtype (the products are fp32 either way). Once K has landed
//   it computes the G x chunk logits with one thread per (head, position)
//   pair, each a dot product over D from shared memory with no shuffle;
//   then per head m = max and l = sum exp(s - m), and, once V has landed,
//   the unnormalised acc = sum exp(s - m) V, written in fp32 to the
//   workspace, laid out (splits, B, H, D + 2): acc, then m and l. No TMA:
//   a tensor map is encoded on the host for every call, which a host-bound
//   decode step cannot afford for 16 KB a CTA.
// - decode_combine_kernel, grid (H, B), one thread per dimension: it reads
//   lengths[b] and only the ceil(n / chunk) live splits (split 0 is live
//   whenever n >= 1, so no sentinel and no -inf - -inf), and writes
//   sum exp(m_s - M) acc_s / max(sum exp(m_s - M) l_s, 1e-30) in q's dtype.
//   It is a programmatic dependent launch: its grid is launched while the
//   split pass runs and waits (griddepcontrol.wait) for that pass's end and
//   its writes, which hides the second launch's latency. Asked for the
//   log-sum-exp (a non-null `lse`), it runs its instantiation that writes
//   the output in fp32, not in q's dtype, and M + log L, each row's
//   log-sum-exp over its valid (and capped) logits, beside it: what a rank
//   holding one chunk of a sequence-sharded cache contributes to the
//   combine over the ranks (nn/attention.py::_decode_call). A length-0
//   row's is -1e30 + log S, which is -1e30 in fp32, so such a rank weighs
//   exactly 0 there.
//
// Both kernels launch from one C call on the caller's stream; the workspace
// and the output are the caller's. Nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;           // threads of a split CTA
constexpr int MIN_CHUNK = 16;
constexpr int SMEM_MAX = 232448;  // shared memory a block may opt into on an H100
constexpr int CB = 16;            // splits whose partials a combine thread loads at once
constexpr float NEG = -1e30f;     // a masked logit, as in the Pallas kernel

// Bytes of shared memory of a split CTA. decode_attention.py's plan uses
// a copy of this rule, of SMEM_MAX and of MIN_CHUNK, which
// tests/test_torch_kernels.py holds equal to these.
long smem_bytes(int chunk, int G, int D, int esz) {
  return (long)G * D * esz + 4L * G * chunk + (long)chunk * (D * esz + 16) +
         (long)chunk * D * esz;
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The two bf16 values packed in a 32-bit word, the lower address first.
__device__ __forceinline__ float bf_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(bf_lo(x), bf_hi(x));
}

// q row . K row, both of one dtype in shared memory, 16 bytes of each a
// step, four partial sums in fp32.
template <int D>
__device__ __forceinline__ float dot_row(const float* __restrict__ qr,
                                         const float* __restrict__ kr) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    const float4 kk = *reinterpret_cast<const float4*>(kr + c);
    const float4 qq = *reinterpret_cast<const float4*>(qr + c);
    s0 = fmaf(qq.x, kk.x, s0);
    s1 = fmaf(qq.y, kk.y, s1);
    s2 = fmaf(qq.z, kk.z, s2);
    s3 = fmaf(qq.w, kk.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

template <int D>
__device__ __forceinline__ float dot_row(const __nv_bfloat16* __restrict__ qr,
                                         const __nv_bfloat16* __restrict__ kr) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += 8) {
    const uint4 kk = *reinterpret_cast<const uint4*>(kr + c);
    const uint4 qq = *reinterpret_cast<const uint4*>(qr + c);
    s0 = fmaf(bf_lo(qq.x), bf_lo(kk.x), s0);
    s1 = fmaf(bf_hi(qq.x), bf_hi(kk.x), s1);
    s2 = fmaf(bf_lo(qq.y), bf_lo(kk.y), s2);
    s3 = fmaf(bf_hi(qq.y), bf_hi(kk.y), s3);
    s0 = fmaf(bf_lo(qq.z), bf_lo(kk.z), s0);
    s1 = fmaf(bf_hi(qq.z), bf_hi(kk.z), s1);
    s2 = fmaf(bf_lo(qq.w), bf_lo(kk.w), s2);
    s3 = fmaf(bf_hi(qq.w), bf_hi(kk.w), s3);
  }
  return (s0 + s1) + (s2 + s3);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's committed copy groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ lengths, float* __restrict__ ws, int B, int S,
                    int H, int KH, int chunk, float scale, float softcap) {
  constexpr int E = 16 / sizeof(T);  // values in 16 bytes
  constexpr int KS = D + E;          // a K row in shared memory, padded by 16 bytes
  constexpr int PIECES = D / E;      // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char smem[];

  // every split CTA has started once all have passed this: the combine
  // grid may launch and wait for this one's end (griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int len = lengths[b];
  const bool empty = len <= 0;              // every logit masked
  const int n = empty ? S : min(len, S);    // positions this row reads
  const int p0 = split * chunk;
  if (p0 >= n) return;                      // a dead split: the combine skips it
  const int cnt = min(chunk, n - p0);       // positions of this split the row reads
  const int G = H / KH;

  T* qs = reinterpret_cast<T*>(smem);                   // G x D
  float* ps = reinterpret_cast<float*>(qs + G * D);     // G x chunk logits, then weights
  T* ks = reinterpret_cast<T*>(ps + G * chunk);         // chunk x KS
  T* vs = ks + chunk * KS;                              // chunk x D

  // K, then V, as two copy groups: the logits start once K has landed
  const long pstride = (long)KH * D;                    // stride of one cache position
  const long base = ((long)b * S + p0) * pstride + (long)kh * D;
  for (int i = threadIdx.x; i < cnt * PIECES; i += NT) {
    const int r = i / PIECES, c = (i % PIECES) * E;
    cp_async16(ks + r * KS + c, k + base + r * pstride + c);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < cnt * PIECES; i += NT) {
    const int r = i / PIECES, c = (i % PIECES) * E;
    cp_async16(vs + r * D + c, v + base + r * pstride + c);
  }
  cp_async_commit();
  const T* qb = q + ((long)b * H + (long)kh * G) * D;  // while the copies fly
  for (int i = threadIdx.x; i < G * D; i += NT) qs[i] = qb[i];
  cp_async_wait<1>();
  __syncthreads();

  for (int i = threadIdx.x; i < G * chunk; i += NT) {
    const int g = i / chunk, p = i - g * chunk;
    float s = -INFINITY;                    // not a position of this row
    if (p < cnt) {
      if (empty) {
        s = NEG;
      } else {
        s = dot_row<D>(qs + g * D, ks + p * KS) * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      }
    }
    ps[i] = s;
  }
  __syncthreads();

  // one warp a head: m and l over the chunk, the weights in place
  float* wb = ws + (((long)split * B + b) * H + (long)kh * G) * (D + 2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += NT / 32) {
    float* pr = ps + g * chunk;
    float m = -INFINITY;
    for (int p = lane; p < cnt; p += 32) m = fmaxf(m, pr[p]);
    m = warp_max(m);
    float l = 0.f;
    for (int p = lane; p < cnt; p += 32) {
      const float e = expf(pr[p] - m);
      pr[p] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) *reinterpret_cast<float2*>(wb + (long)g * (D + 2) + D) = make_float2(m, l);
  }
  cp_async_wait<0>();
  __syncthreads();

  // acc over (head, pair of dimensions), V rows past cnt never read
  constexpr int DP = D / 2;
  for (int i = threadIdx.x; i < G * DP; i += NT) {
    const int g = i / DP, d = (i - g * DP) * 2;
    const float* pr = ps + g * chunk;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int p = 0; p < cnt; ++p) {
      const float w = pr[p];
      const float2 vv = load2(vs + p * D + d);
      a0 = fmaf(w, vv.x, a0);
      a1 = fmaf(w, vv.y, a1);
    }
    *reinterpret_cast<float2*>(wb + (long)g * (D + 2) + d) = make_float2(a0, a1);
  }
}

// TO is the output's type: q's without the log-sum-exp, fp32 with it (LSE).
template <typename TO, int D, bool LSE>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ ws, const int* __restrict__ lengths,
                      TO* __restrict__ o, float* __restrict__ lse, int B, int S, int H,
                      int chunk) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = lengths[b];
  const int n = len <= 0 ? S : min(len, S);
  const int live = (n + chunk - 1) / chunk;
  const long sstride = (long)B * H * (D + 2);           // from one split's partials to the next
  const float* w = ws + ((long)b * H + h) * (D + 2);
  asm volatile("griddepcontrol.wait;" ::: "memory");    // the split pass has ended
  float M = -INFINITY, L = 0.f, A = 0.f;
  for (int s0 = 0; s0 < live; s0 += CB) {
    float ms[CB], ls[CB], as[CB];
#pragma unroll
    for (int u = 0; u < CB; ++u) {        // CB splits' loads in flight at once
      const bool in = s0 + u < live;
      const float* p = w + (s0 + u) * sstride;
      ms[u] = in ? p[D] : -INFINITY;
      ls[u] = in ? p[D + 1] : 0.f;
      as[u] = in ? p[d] : 0.f;
    }
    float mb = M;
#pragma unroll
    for (int u = 0; u < CB; ++u) mb = fmaxf(mb, ms[u]);
    const float c = expf(M - mb);         // 0 on the first batch, which holds split 0
    L *= c;
    A *= c;
#pragma unroll
    for (int u = 0; u < CB; ++u) {
      const float e = expf(ms[u] - mb);
      L = fmaf(e, ls[u], L);
      A = fmaf(e, as[u], A);
    }
    M = mb;
  }
  o[((long)b * H + h) * D + d] = from_f<TO>(A / fmaxf(L, 1e-30f));
  if constexpr (LSE) {
    if (d == 0) lse[(long)b * H + h] = M + logf(L);   // L >= 1: the max's own term
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* o,
           void* lse, void* ws, int B, int S, int H, int KH, int chunk, float scale,
           float softcap, cudaStream_t stream) {
  const long smem = smem_bytes(chunk, H / KH, D, (int)sizeof(T));
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err =
      hopper::opt_in_smem((const void*)decode_split_kernel<T, D>, SMEM_MAX, opted_in);
  if (err != cudaSuccess) return (int)err;
  const int splits = (S + chunk - 1) / chunk;
  decode_split_kernel<T, D><<<dim3(splits, KH, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<float*>(ws), B, S, H, KH, chunk, scale,
      softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // a programmatic dependent launch: the combine grid launches while the
  // split pass runs, and waits for its end before reading the partials
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B);
  cfg.blockDim = dim3(D);
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const float* wsf = static_cast<const float*>(ws);
  const int* len = static_cast<const int*>(lengths);
  if (lse)
    return (int)cudaLaunchKernelEx(&cfg, decode_combine_kernel<float, D, true>, wsf, len,
                                   static_cast<float*>(o), static_cast<float*>(lse), B, S, H,
                                   chunk);
  return (int)cudaLaunchKernelEx(&cfg, decode_combine_kernel<T, D, false>, wsf, len,
                                 static_cast<T*>(o), static_cast<float*>(nullptr), B, S, H,
                                 chunk);
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, const void* lengths, void* o,
               void* lse, void* ws, int B, int S, int H, int KH, int chunk, float scale,
               float cap, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, lengths, o, lse, ws, B, S, H, KH, chunk, scale, cap, st);
    case 64:
      return launch<T, 64>(q, k, v, lengths, o, lse, ws, B, S, H, KH, chunk, scale, cap, st);
    case 128:
      return launch<T, 128>(q, k, v, lengths, o, lse, ws, B, S, H, KH, chunk, scale, cap, st);
    case 256:
      return launch<T, 256>(q, k, v, lengths, o, lse, ws, B, S, H, KH, chunk, scale, cap, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; lengths is int32 on the device; o is
// (B, H, D) in q's dtype when lse is null, else fp32, and lse (B, H) fp32
// or null; ws is an fp32 workspace of (ceil(S / chunk), B, H, D + 2);
// chunk is a power of two >= 16 whose CTA fits the shared memory; softcap
// > 0 caps the scaled logits, 0 leaves them. Returns cudaGetLastError()
// after the launches (0 on success); launches on `stream` and does not
// synchronise.
extern "C" int decode_attention(int dtype, const void* q, const void* k, const void* v,
                                const void* lengths, void* o, void* lse, void* ws, int B,
                                int S, int H, int KH, int D, int chunk, float scale,
                                float softcap, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || B > 65535 || KH > 65535 ||
      !(softcap >= 0.f))
    return (int)cudaErrorInvalidValue;
  if (chunk < MIN_CHUNK || (chunk & (chunk - 1)) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_d<float>(D, q, k, v, lengths, o, lse, ws, B, S, H, KH, chunk, scale,
                               softcap, st);
    case 1:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, lengths, o, lse, ws, B, S, H, KH, chunk,
                                       scale, softcap, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
