// K1-bwd: the gradient of causal flash attention, hand-written for Hopper
// (sm_90a), fp32 on the CUDA cores.
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
// with KH dividing H; lse and Delta (B, H, S). All fp32: the training
// configs are fp32, and fp32 products on the tensor cores would be TF32.
//
// Kernels launched by one C call, the FlashAttention-2 backward:
// 1. `flash_bwd_delta_kernel`: Delta_i, one warp a row.
// 2. `flash_bwd_dkdv_kernel`: one CTA per (BKV keys, query head, batch).
//    It holds its K and V tile in shared memory and its head's share of
//    dK and dV in registers, and walks the query tiles of its head that
//    the mask lets see its keys, recomputing P and dX a tile at a time.
//    With KH == H it writes dK and dV; with KH < H it writes each query
//    head's share to a workspace (B, S, H, D), and
// 3. `flash_bwd_reduce_kernel` sums the H / KH shares of each kv head in
//    a fixed order. No atomics: every element has one writer, so the
//    result is the same from run to run. A CTA per query head rather than
//    per kv head gives RecurrentGemma's call (one kv head) 640 CTAs where
//    it would have 64 walking ten heads each.
// 4. `flash_bwd_dq_kernel`: one CTA per (BQ rows, head, batch), holding Q,
//    dO, lse and Delta, walking the key tiles the forward walks and
//    accumulating dQ in registers; the last query tiles, which walk the
//    most keys, launch first.
// A score tile is computed by each thread owning BQ * BKV / 256 of its
// elements, each two D-long dot products (q . k and dO . v) read from
// shared memory whose rows are padded by one value, so that the BKV keys a
// warp reads at one d fall in distinct banks. The products into dK, dV and
// dQ give each thread DPT dims (consecutive across the warp) times KPT keys
// or RPT rows.
//
// Shared memory, fp32, rows of D + 1 (both main kernels): Q and dO (BQ rows each), K and V
// (BKV rows each), P and dX (BQ x BKV + 1), lse and Delta; at D 256 (BQ 32,
// BKV 16) 103 KB, two CTAs an SM at up to 128 registers a thread.
//
// Bound on the H100 SXM (67 TFLOP/s fp32, 3.35 TB/s): five products over
// the pairs the mask keeps (q.k, dO.v, P^T dO, dX^T Q, dX K), 10 D flops a
// pair; at RecurrentGemma's training call (B 4, S 256, 10 query heads on
// 1 kv head, D 256, window 2048 > S) that is 3.4 GFLOP, 50 us, against
// 46.2 MB of inputs and outputs (q, o, dO, dQ 10.5 MB each; k, v, dK, dV
// 1.0 MB each; lse), 13.8 us: bound by the operations. This simple
// kernel reads both operands of every product from shared memory and is
// limited by shared-memory bandwidth, well above that bound.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;   // threads a CTA of the two main kernels

template <int D>
struct Bwd {
  static constexpr int BQ = D > 64 ? 32 : 64;     // query rows a tile
  static constexpr int BKV = D > 128 ? 16 : 32;   // keys a tile
  static constexpr int DP = D + 1;                // padded row of Q, dO, K, V
  static constexpr int SP = BKV + 1;              // padded row of P and dX
  static constexpr int TD = D < 64 ? D : 64;      // threads across D in the products
  static constexpr int GROUPS = NT / TD;          // thread groups across keys or rows
  static constexpr int DPT = D / TD;              // dims a thread
  static constexpr int KPT = BKV / GROUPS;        // keys a thread (dK, dV)
  static constexpr int RPT = BQ / GROUPS;         // rows a thread (dQ)
  static constexpr int EPT = BQ * BKV / NT;       // score elements a thread
  static constexpr int SMEM =
      (int)sizeof(float) * (2 * BQ * DP + 2 * BKV * DP + 2 * BQ * SP + 2 * BQ);
  static_assert(NT % TD == 0 && D % TD == 0 && BKV % GROUPS == 0 && BQ % GROUPS == 0 &&
                    (BQ * BKV) % NT == 0,
                "tile shapes must split evenly over the threads");
};

// rows r0 .. r0 + n - 1 of a (B, S, heads, D) tensor at (b, head) into
// shared memory rows of DP, zeros past S
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0,
                                          int n, int S, long stride) {
  for (int i = threadIdx.x; i < n * D; i += NT) {
    const int r = i / D, c = i % D, row = r0 + r;
    dst[r * Bwd<D>::DP + c] = row < S ? src[(long)row * stride + c] : 0.f;
  }
}

// lse and Delta of rows q0 .. q0 + BQ - 1 of (b, h), zeros past S
template <int D>
__device__ __forceinline__ void load_row_stats(float* sl, float* sdel,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta, int q0, int S) {
  for (int i = threadIdx.x; i < Bwd<D>::BQ; i += NT) {
    const int row = q0 + i;
    sl[i] = row < S ? lse[row] : 0.f;
    sdel[i] = row < S ? delta[row] : 0.f;
  }
}

// P and dX of the score tile of query rows q0.. against keys k0.., into sp
// and sdx (rows of SP); P only if WRITE_P
template <int D, bool WRITE_P>
__device__ __forceinline__ void score_tile(const float* sq, const float* sdo, const float* sk,
                                           const float* sv, const float* sl, const float* sdel,
                                           float* sp, float* sdx, int q0, int k0, int S,
                                           float scale, int causal, int window, float softcap) {
  using C = Bwd<D>;
#pragma unroll
  for (int e = 0; e < C::EPT; ++e) {
    const int idx = threadIdx.x + NT * e;
    const int r = idx / C::BKV, c = idx % C::BKV;
    const float* qr = sq + r * C::DP;
    const float* dr = sdo + r * C::DP;
    const float* kr = sk + c * C::DP;
    const float* vr = sv + c * C::DP;
    float s = 0.f, dp = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      s = fmaf(qr[d], kr[d], s);
      dp = fmaf(dr[d], vr[d], dp);
    }
    const int row = q0 + r, col = k0 + c;
    float x = s * scale, dxdt = 1.f;
    if (softcap > 0.f) {
      const float th = tanhf(x / softcap);
      x = softcap * th;
      dxdt = 1.f - th * th;
    }
    bool ok = row < S && col < S;
    if (causal) ok = ok && col <= row;
    if (window > 0) ok = ok && (row - col) < window;
    const float p = ok ? expf(x - sl[r]) : 0.f;
    if (WRITE_P) sp[r * C::SP + c] = p;
    sdx[r * C::SP + c] = p * (dp - sdel[r]) * dxdt;
  }
}

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

// dK and dV of keys k0 .. k0 + BKV - 1 from query head h alone, into dkh
// and dvh, (B, S, H, D): dK and dV themselves when KH == H, else the
// workspace that flash_bwd_reduce_kernel sums
template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dkh, float* __restrict__ dvh, int S, int H, int KH,
                      float scale, int causal, int window, float softcap) {
  using C = Bwd<D>;
  extern __shared__ float smem[];
  float* sq = smem;                    // [BQ][DP]
  float* sdo = sq + C::BQ * C::DP;     // [BQ][DP]
  float* sk = sdo + C::BQ * C::DP;     // [BKV][DP]
  float* sv = sk + C::BKV * C::DP;     // [BKV][DP]
  float* sp = sv + C::BKV * C::DP;     // [BQ][SP]
  float* sdx = sp + C::BQ * C::SP;     // [BQ][SP]
  float* sl = sdx + C::BQ * C::SP;     // [BQ]
  float* sdel = sl + C::BQ;            // [BQ]

  const int k0 = blockIdx.x * C::BKV, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const long qs = (long)H * D, ks = (long)KH * D;
  load_rows<D>(sk, k + (long)b * S * ks + (long)kh * D, k0, C::BKV, S, ks);
  load_rows<D>(sv, v + (long)b * S * ks + (long)kh * D, k0, C::BKV, S, ks);

  const int td = threadIdx.x % C::TD, grp = threadIdx.x / C::TD;
  float adk[C::KPT][C::DPT], adv[C::KPT][C::DPT];
#pragma unroll
  for (int i = 0; i < C::KPT; ++i)
#pragma unroll
    for (int j = 0; j < C::DPT; ++j) adk[i][j] = adv[i][j] = 0.f;

  // the query rows that can see keys k0 .. k0 + BKV - 1: none before k0 if
  // causal, none at or past k0 + BKV - 1 + window with a window
  const int q_begin = causal ? k0 / C::BQ * C::BQ : 0;
  const int q_end = window > 0 ? min(S, k0 + C::BKV - 1 + window) : S;
  const float* qb = q + (long)b * S * qs + (long)h * D;
  const float* db = dout + (long)b * S * qs + (long)h * D;
  const float* lb = lse + ((long)b * H + h) * S;
  const float* eb = delta + ((long)b * H + h) * S;
  for (int q0 = q_begin; q0 < q_end; q0 += C::BQ) {
    __syncthreads();   // the previous tile's readers are done (and K, V staged)
    load_rows<D>(sq, qb, q0, C::BQ, S, qs);
    load_rows<D>(sdo, db, q0, C::BQ, S, qs);
    load_row_stats<D>(sl, sdel, lb, eb, q0, S);
    __syncthreads();
    score_tile<D, true>(sq, sdo, sk, sv, sl, sdel, sp, sdx, q0, k0, S, scale, causal, window,
                        softcap);
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < C::BQ; ++r) {
      float qd[C::DPT], od[C::DPT];
#pragma unroll
      for (int j = 0; j < C::DPT; ++j) {
        qd[j] = sq[r * C::DP + td + C::TD * j];
        od[j] = sdo[r * C::DP + td + C::TD * j];
      }
#pragma unroll
      for (int i = 0; i < C::KPT; ++i) {
        const int c = grp + C::GROUPS * i;
        const float p = sp[r * C::SP + c], dx = sdx[r * C::SP + c];
#pragma unroll
        for (int j = 0; j < C::DPT; ++j) {
          adv[i][j] = fmaf(p, od[j], adv[i][j]);
          adk[i][j] = fmaf(dx, qd[j], adk[i][j]);
        }
      }
    }
  }

  float* dkb = dkh + (long)b * S * qs + (long)h * D;
  float* dvb = dvh + (long)b * S * qs + (long)h * D;
#pragma unroll
  for (int i = 0; i < C::KPT; ++i) {
    const int key = k0 + grp + C::GROUPS * i;
    if (key >= S) continue;
#pragma unroll
    for (int j = 0; j < C::DPT; ++j) {
      dkb[(long)key * qs + td + C::TD * j] = adk[i][j] * scale;
      dvb[(long)key * qs + td + C::TD * j] = adv[i][j];
    }
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
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int S, int H, int KH, float scale, int causal,
                    int window, float softcap) {
  using C = Bwd<D>;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + C::BQ * C::DP;
  float* sk = sdo + C::BQ * C::DP;
  float* sv = sk + C::BKV * C::DP;
  float* sp = sv + C::BKV * C::DP;     // unused here: the layout is the dK/dV kernel's
  float* sdx = sp + C::BQ * C::SP;
  float* sl = sdx + C::BQ * C::SP;
  float* sdel = sl + C::BQ;

  // last tiles first: under a causal mask they walk the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const long qs = (long)H * D, ks = (long)KH * D;
  load_rows<D>(sq, q + (long)b * S * qs + (long)h * D, q0, C::BQ, S, qs);
  load_rows<D>(sdo, dout + (long)b * S * qs + (long)h * D, q0, C::BQ, S, qs);
  load_row_stats<D>(sl, sdel, lse + ((long)b * H + h) * S, delta + ((long)b * H + h) * S, q0,
                    S);
  const float* kb = k + (long)b * S * ks + (long)kh * D;
  const float* vb = v + (long)b * S * ks + (long)kh * D;

  const int td = threadIdx.x % C::TD, grp = threadIdx.x / C::TD;
  float adq[C::RPT][C::DPT];
#pragma unroll
  for (int i = 0; i < C::RPT; ++i)
#pragma unroll
    for (int j = 0; j < C::DPT; ++j) adq[i][j] = 0.f;

  // the key tiles the forward walks: none past the diagonal if causal, none
  // wholly outside the window
  const int kv_end = causal ? min(S, q0 + C::BQ) : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / C::BKV * C::BKV : 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += C::BKV) {
    __syncthreads();   // the previous tile's readers are done (and Q, dO staged)
    load_rows<D>(sk, kb, k0, C::BKV, S, ks);
    load_rows<D>(sv, vb, k0, C::BKV, S, ks);
    __syncthreads();
    score_tile<D, false>(sq, sdo, sk, sv, sl, sdel, sp, sdx, q0, k0, S, scale, causal, window,
                         softcap);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < C::BKV; ++c) {
      float kd[C::DPT];
#pragma unroll
      for (int j = 0; j < C::DPT; ++j) kd[j] = sk[c * C::DP + td + C::TD * j];
#pragma unroll
      for (int i = 0; i < C::RPT; ++i) {
        const float dx = sdx[(grp + C::GROUPS * i) * C::SP + c];
#pragma unroll
        for (int j = 0; j < C::DPT; ++j) adq[i][j] = fmaf(dx, kd[j], adq[i][j]);
      }
    }
  }

  float* dqb = dq + (long)b * S * qs + (long)h * D;
#pragma unroll
  for (int i = 0; i < C::RPT; ++i) {
    const int row = q0 + grp + C::GROUPS * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < C::DPT; ++j) dqb[(long)row * qs + td + C::TD * j] = adq[i][j] * scale;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o, const float* lse,
           const float* dout, float* dq, float* dk, float* dv, float* delta, float* dkh,
           float* dvh, int B, int S, int H, int KH, float scale, int causal, int window,
           float softcap, cudaStream_t st) {
  using C = Bwd<D>;
  static std::atomic<unsigned long long> dkdv_in{0}, dq_in{0};
  cudaError_t err = hopper::opt_in_smem((const void*)flash_bwd_dkdv_kernel<D>, C::SMEM, dkdv_in);
  if (err == cudaSuccess)
    err = hopper::opt_in_smem((const void*)flash_bwd_dq_kernel<D>, C::SMEM, dq_in);
  if (err != cudaSuccess) return (int)err;
  const long rows = (long)B * S * H;
  flash_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(o, dout, delta, B, S, H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool shared_kv = KH < H;   // dK, dV sum query heads' shares from the workspace
  flash_bwd_dkdv_kernel<D><<<dim3((S + C::BKV - 1) / C::BKV, H, B), NT, C::SMEM, st>>>(
      q, k, v, dout, lse, delta, shared_kv ? dkh : dk, shared_kv ? dvh : dv, S, H, KH, scale,
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
  flash_bwd_dq_kernel<D><<<dim3((S + C::BQ - 1) / C::BQ, H, B), NT, C::SMEM, st>>>(
      q, k, v, dout, lse, delta, dq, S, H, KH, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 q, o, dout, dq (B, S, H, D); k, v, dk, dv (B, S, KH, D); lse and the
// workspace delta (B, H, S); with KH < H the workspaces dkh and dvh (B, S,
// H, D), else they may be null. Launches the kernels on `stream` and does
// not synchronise; returns cudaGetLastError() after each launch (0 on
// success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* lse, const void* dout, void* dq, void* dk,
                                   void* dv, void* delta, void* dkh, void* dvh, int B, int S,
                                   int H, int KH, int D, float scale, int causal, int window,
                                   float softcap, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || B > 65535 || H > 65535 ||
      (KH < H && !(dkh && dvh)))
    return (int)cudaErrorInvalidValue;
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
