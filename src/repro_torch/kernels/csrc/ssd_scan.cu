// K3: the Mamba2 SSD chunked scan, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/ssd_scan.py::ssd_scan` (body
// `_ssd_kernel`), and computes what `repro/kernels/ref.py::ssd_ref` and
// `repro/nn/ssd.py::ssd_chunked` compute. Per chunk of L steps of one
// (batch, head), with state S (P, N) carried from the previous chunk:
//   cs = cumsum(dt * a)
//   y  = (C B^T .* exp(cs_t - cs_s) dt_s, masked to s <= t) X + exp(cs_t) C S^T
//   S <- exp(cs_L) S + X^T (w .* B),  w_s = exp(cs_L - cs_s) dt_s
// All arithmetic is fp32 after the load, as the TPU kernel casts first.
//
// Beyond the Pallas kernel, as the model needs: an optional initial state
// h0 (B, H, P, N) fp32 (null means zeros) and an optional final state out
// (B, H, P, N) fp32; b and c read unexpanded, (B, S, G, N) with G dividing
// H, head h reading group h / (H / G); any S, the ragged tail masked here
// (a step past S has dt = 0 and x = 0, so it neither decays nor updates the
// state, and no y is written for it). Layouts are the model's: x and y
// (B, S, H, P), dt (B, S, H), a (H,).
//
// The chunk length is this kernel's own, L = 64: the model asks for 256,
// but an fp32 (256, 256) tile alone is 256 KB, above the 227 KB a block may
// use. The function does not depend on the chunk length (up to rounding),
// so the ops-level `chunk` steers only the plain version.
//
// Bound on the H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 tensor cores, 67
// TFLOP/s fp32 CUDA cores) at the serving shape (B 4, S 512, H 80, P 64,
// N 128, G 1; bf16 x and y, fp32 dt, fp32 final state): x and y are 21 MB
// each, the final state 10.5 MB, b, c and dt 1.2 MB, so about 54 MB, 0.016
// ms. The recurrence needs 4 P N operations per token and head, 5.4 GFLOP,
// 0.0054 ms on bf16 tensor cores. So the card's bound is the bytes.
//
// Design against that bound: one CTA of 256 threads per (tile of 64 head
// columns p, head, batch) reads each input once from device memory and
// writes y and the final state once; the state never leaves shared memory
// between chunks. At the serving shape that is 320 CTAs for 132 SMs. Per
// chunk, the CTA stages dt, B, C and its x tile in shared memory as fp32,
// warp 0 scans cs, and the three products run on fp32 CUDA cores in 4x4
// (4x8 for the state) register tiles, with padded rows so that neither
// operand of a product has bank conflicts. The decay is masked before exp:
// for s > t it is positive and may overflow. The products are what bound
// this kernel (about 7 GFLOP at the serving shape on CUDA cores, and C B^T
// is recomputed by every head of a group); moving them onto wgmma, and
// sharing C B^T across the heads of a group, is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int L = 64;          // steps per chunk
constexpr int PT = 64;         // head-dim columns p per CTA
constexpr int NMAX = 128;      // largest state size N
constexpr int NT = 256;        // threads per CTA
constexpr int CG = 16;         // threads sharing one row group
constexpr int LP = L + 1;      // padded row of the M tile
constexpr int XP = PT + 1;     // padded row of the x tile
constexpr int NJ = NMAX / CG;  // state columns per thread in the update

static_assert(L == 64, "the cs scan covers the chunk with two values a lane");
static_assert((NT / CG) * 4 == L && (NT / CG) * 4 == PT, "row groups must cover the tiles");
static_assert(CG * 4 == L && CG * 4 == PT, "column groups must cover the tiles");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int N) {
  const size_t NP = N + 1;
  return sizeof(float) * (2 * L * NP + PT * NP + L * XP + L * LP + 3 * L);
}

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const T* __restrict__ bm,
                 const T* __restrict__ cm, const float* __restrict__ h0, T* __restrict__ y,
                 float* __restrict__ hout, int S, int H, int P, int G, int N) {
  const int NP = N + 1;            // padded row: column reads hit distinct banks
  extern __shared__ float smem[];
  float* sB = smem;                // [L][NP]
  float* sC = sB + L * NP;         // [L][NP]
  float* sS = sC + L * NP;         // [PT][NP] state rows p0 .. p0+PT-1
  float* sX = sS + PT * NP;        // [L][XP]
  float* sM = sX + L * XP;         // [L][LP]
  float* sdt = sM + L * LP;        // [L]
  float* scs = sdt + L;            // [L] inclusive cumsum of dt * a
  float* sw = scs + L;             // [L] exp(cs_L - cs_s) * dt_s

  const int tid = threadIdx.x;
  const int rg = tid / CG;         // rows rg*4 .. rg*4+3
  const int cg = tid % CG;         // columns cg + CG*j
  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const float A = a[h];
  const long xs = (long)H * P;     // stride of one step in x / y
  const long bs = (long)G * N;     // stride of one step in b / c
  const T* xb = x + (long)b * S * xs + (long)h * P;
  const float* dtb = dt + (long)b * S * H + h;
  const T* bb = bm + (long)b * S * bs + (long)g * N;
  const T* cb = cm + (long)b * S * bs + (long)g * N;
  T* yb = y + (long)b * S * xs + (long)h * P;
  const long so = ((long)b * H + h) * P * N;   // this head's state

  for (int i = tid; i < PT * N; i += NT) {
    const int r = i / N, n = i % N, p = p0 + r;
    sS[r * NP + n] = (h0 != nullptr && p < P) ? h0[so + (long)p * N + n] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += L) {
    __syncthreads();  // the previous chunk is done with every tile (and sS is staged)
    for (int i = tid; i < L * N; i += NT) {
      const int r = i / N, n = i % N, t = t0 + r;
      const bool in = t < S;
      sB[r * NP + n] = in ? to_f(bb[(long)t * bs + n]) : 0.f;
      sC[r * NP + n] = in ? to_f(cb[(long)t * bs + n]) : 0.f;
    }
    for (int i = tid; i < L * PT; i += NT) {
      const int r = i / PT, c = i % PT, t = t0 + r, p = p0 + c;
      sX[r * XP + c] = (t < S && p < P) ? to_f(xb[(long)t * xs + p]) : 0.f;
    }
    if (tid < L) sdt[tid] = t0 + tid < S ? dtb[(long)(t0 + tid) * H] : 0.f;
    __syncthreads();

    if (tid < 32) {  // warp 0: inclusive scan of dt * a, lane l holding steps l and l + 32
      float v0 = sdt[tid] * A, v1 = sdt[tid + 32] * A;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, o);
        if (tid >= o) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      const float last = __shfl_sync(0xffffffffu, v1, 31);
      scs[tid] = v0;
      scs[tid + 32] = v1;
      sw[tid] = expf(last - v0) * sdt[tid];
      sw[tid + 32] = expf(last - v1) * sdt[tid + 32];
    }
    __syncthreads();

    // M[t][s] = (C_t . B_s) exp(cs_t - cs_s) dt_s for s <= t, else 0
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(rg * 4 + i) * NP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sB[(cg + CG * j) * NP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = rg * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = cg + CG * j;
          sM[t * LP + s] = s <= t ? acc[i][j] * expf(scs[t] - scs[s]) * sdt[s] : 0.f;
        }
      }
    }
    __syncthreads();

    // y[t][p] = sum_s M[t][s] x[s][p] + exp(cs_t) sum_n C[t][n] S[p][n]
    {
      float yi[4][4], ye[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yi[i][j] = ye[i][j] = 0.f;
      const int s_end = rg * 4 + 4;  // M[t][s] == 0 for s > t
      for (int s = 0; s < s_end; ++s) {
        float mv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = sM[(rg * 4 + i) * LP + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = sX[s * XP + cg + CG * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) yi[i][j] = fmaf(mv[i], xv[j], yi[i][j]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(rg * 4 + i) * NP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = sS[(cg + CG * j) * NP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ye[i][j] = fmaf(cv[i], sv[j], ye[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = rg * 4 + i;
        if (t0 + t >= S) continue;
        const float e = expf(scs[t]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = p0 + cg + CG * j;
          if (p < P) yb[(long)(t0 + t) * xs + p] = from_f<T>(yi[i][j] + ye[i][j] * e);
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // S[p][n] = exp(cs_L) S[p][n] + sum_s x[s][p] w_s B[s][n]
    {
      float acc[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < L; ++s) {
        const float ws = sw[s];
        float xv[4], bv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = sX[s * XP + rg * 4 + i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = cg + CG * j;
          bv[j] = n < N ? sB[s * NP + n] * ws : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
      const float eL = expf(scs[L - 1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = cg + CG * j;
          if (n < N) sS[r * NP + n] = fmaf(eL, sS[r * NP + n], acc[i][j]);
        }
      }
    }
  }

  if (hout != nullptr) {
    __syncthreads();  // the last update's rows were written by other threads
    for (int i = tid; i < PT * N; i += NT) {
      const int r = i / N, n = i % N, p = p0 + r;
      if (p < P) hout[so + (long)p * N + n] = sS[r * NP + n];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
           const void* h0, void* y, void* hout, int B, int S, int H, int P, int G, int N,
           cudaStream_t stream) {
  // The shared-memory opt-in is per device, for the largest N; it is set
  // on a device's first launch of this instantiation and remembered in a
  // bit mask.
  static std::atomic<unsigned long long> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(opted_in.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(NMAX));
    if (err != cudaSuccess) return (int)err;
    opted_in.fetch_or(bit, std::memory_order_relaxed);
  }
  dim3 grid((P + PT - 1) / PT, H, B);
  ssd_chunk_kernel<T><<<grid, NT, smem_bytes(N), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(hout), S, H, P, G, N);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, b, c and y): 0 float32, 1 bfloat16. h0 and hout may be
// null. Returns cudaGetLastError() after the launch (0 on success);
// launches on `stream` and does not synchronise.
extern "C" int ssd_scan(int dtype, const void* x, const void* dt, const void* a, const void* b,
                        const void* c, const void* h0, void* y, void* hout, int B, int S, int H,
                        int P, int G, int N, void* stream) {
  if (B <= 0 || S < 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 || N <= 0 || N > NMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, dt, a, b, c, h0, y, hout, B, S, H, P, G, N, st);
    case 1: return launch<__nv_bfloat16>(x, dt, a, b, c, h0, y, hout, B, S, H, P, G, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
