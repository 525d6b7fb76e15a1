// K3: the Mamba2 SSD chunked scan, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/ssd_scan.py::ssd_scan` (body
// `_ssd_kernel`), and computes what `repro/kernels/ref.py::ssd_ref` and
// `repro/nn/ssd.py::ssd_chunked` compute. Per chunk of L steps of one
// (batch, head), with state S (P, N) carried from the previous chunk:
//   cs = cumsum(dt * a)
//   y  = (C B^T .* exp(cs_t - cs_s) dt_s, masked to s <= t) X + exp(cs_t) C S^T
//   S <- exp(cs_L) S + X^T (w .* B),  w_s = exp(cs_L - cs_s) dt_s
//
// Beyond the Pallas kernel, as the model needs: an optional initial state
// h0 (B, H, P, N) fp32 (null means zeros) and an optional final state out
// (B, H, P, N) fp32; b and c read unexpanded, (B, S, G, N) with G dividing
// H, head h reading group h / (H / G); any S, the ragged tail masked here
// (a step past S has dt = 0 and x = 0, so it neither decays nor updates the
// state, and no y is written for it). Layouts are the model's: x and y
// (B, S, H, P), dt (B, S, H), a (H,).
//
// The chunk length is this kernel's own, L = 64 (one wgmma m64 tile): the
// model asks for 256, but the function does not depend on the chunk length
// (up to rounding), so the ops-level `chunk` steers only the plain version.
//
// Bound on the H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 tensor cores, 67
// TFLOP/s fp32 CUDA cores) at the serving call (B 4, S 512, H 80, P 64, N
// 128, G 1; bf16 x and y, fp32 dt, h0 in and the final state out in fp32):
// x and y are 21.0 MB each, h0 and the final state 10.5 MB each, b, c, dt
// and a 1.2 MB, 64.6 MB in all, 0.0193 ms. The recurrence needs 4 P N
// operations a step and head, 5.4 GFLOP, 0.0054 ms on the tensor cores. So
// the card's bound is the bytes.
//
// Two routes, chosen by dtype, P and N alone (`ssd_scan_route`):
// - bf16 with P a multiple of 64 and N 64 or 128, which the serving path
//   calls, takes `ssd_wgmma_kernel`: the four products on the tensor cores.
// - fp32, and bf16 at other P or N, take `ssd_chunk_kernel` on the fp32
//   CUDA cores. fp32 on the tensor cores would be TF32, about three decimal
//   digits, where the fp32 checks hold the kernel to 3e-5.
//
// Precision of the tensor-core route, against the reference's own casts
// (`repro/nn/ssd.py:84-94`, `:112`): C B^T and C S^T contract bf16 operands in fp32,
// with S_prev rounded to bf16 as `prev_states.astype(cc.dtype)` rounds it;
// M is rounded to bf16 before M X (the reference rounds the scores C B^T,
// the same 2^-9 a term). The state stays fp32-accurate, since the model
// carries it across prefill and decode and the checks hold it to 3e-5 of
// its largest value: the update's A operand v = w_s x_s is formed in fp32
// and split into HALVES bf16 parts (hi = bf16(v), lo = bf16(v - hi)), each
// its own wgmma into the fp32 accumulator, so v is carried to 2^-17 of
// itself; B is bf16 already, so each product is exact.
//
// Tensor-core design (`ssd_wgmma_kernel`): one CTA of two warpgroups per
// (64 columns p of a head, head, batch) walks that head's chunks in order;
// the loop takes the place of the Pallas grid's sequential axis. The two
// warpgroups split a chunk's work by what it depends on:
// - the y path (warpgroup 0): C B^T and C S_prev^T, both operands K-major
//   in shared memory; on C B^T's accumulator the decay and dt weight,
//   masked to s <= t before exp (exp(cs_t - cs_s) overflows for s > t),
//   M packed into bf16 registers as the A operand of M X (X the MN-major
//   B operand), accumulated onto exp(cs_t) C S_prev^T; y leaves through a
//   bf16 tile in shared memory and a TMA store, which drops steps past S.
// - the state path (warpgroup 1): S (64 x N fp32, 64 registers a thread at
//   N 128) lives in registers as the update's accumulator: h0 in, scaled
//   by exp(cs_L) each chunk, v^T B added (v from x^T by ldmatrix.trans, w
//   in fp32, split hi + lo; B MN-major) in two passes of 32 steps so that
//   v's parts are held for half a chunk; then S is written once a chunk
//   as the bf16 tile the y path reads, and once at the end as fp32.
// Only C S_prev^T ties the two: named barriers hand the state tile over
// (written, then read) once a chunk, so the state path's update of chunk
// c overlaps the y path's mask and products of chunk c.
// - Loads: TMA brings each chunk's x (64 x 64), B and C (64 x N) as 128B-
//   swizzled slabs on one mbarrier, two stages deep, so chunk c+1's tiles
//   fly during chunk c's products; the y path refills a stage (chunk c+2)
//   once the state path has also signalled it done (an mbarrier). 4-D
//   tensor maps zero-fill steps past S. Every warp reads dt a chunk ahead
//   into registers, 0 past S, scans cs itself (in log2 units, for exp2)
//   and fetches the values it needs by shuffles: no shared-memory loads
//   next to the wgmmas, which on the H100 queued behind their operand
//   reads.
// - Heads a CTA: one. A CTA holds 105 KB of shared memory and 128
//   registers a thread (setmaxnreg moves 8 from the y path to the state
//   path: 120 and 136), so two share an SM: 264 at a time for the 320 CTAs of the
//   serving call, 1.2 waves. Two heads of a group a CTA would share the B
//   and C tiles and C B^T, but B and C are 1.2 MB read from L2, not HBM,
//   and C B^T is 2.7 GFLOP (3 us of peak) at the serving call; the cost
//   would be 160 CTAs of four warpgroups, one an SM, with the same
//   registers a thread. On the H100 one warpgroup doing both paths was
//   slower than two: the chain of a chunk, not the tensor cores, bounds a
//   CTA.
// Against the bound: every input byte is read once from HBM (B and C once
// a group, then from L2) and y and the state written once; the tensor-core
// work is 12.1 GFLOP at the serving call (the chunked form's four products
// with the update's two halves), 12 us of peak, against 19 us of bytes.
// The y path's chain (scan, C B^T, 32 exp2 a thread in the mask, M X, the
// y tile) is several times its tensor work, so the kernel sits at about
// three times the bound.
//
// CUDA-core design (`ssd_chunk_kernel`): one CTA of 256 threads per (tile
// of 64 head columns p, head, batch) reads each input once from device
// memory and writes y and the final state once; the state never leaves
// shared memory between chunks. Per chunk, the CTA stages dt, B, C and its
// x tile in shared memory as fp32, warp 0 scans cs, and the three products
// run on fp32 CUDA cores in 4x4 (4x8 for the state) register tiles, with
// padded rows so that neither operand of a product has bank conflicts. The
// decay is masked before exp, as above. All arithmetic is fp32 after the
// load, as the TPU kernel casts first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "hopper.cuh"

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

// ---- the tensor-core route (bf16, P a multiple of 64, N 64 or 128) --------

namespace tc {

constexpr int WG = 128;        // threads of a warpgroup; a CTA has two
constexpr int STAGES = 2;      // chunks of x, B and C in flight
constexpr int HALVES = 2;      // bf16 parts of v = w x in the state update
constexpr int SLAB = L * 128;  // 64 rows of 64 bf16, one 128-byte swizzle atom wide
constexpr float LOG2E = 1.4426950408889634f;
// named barriers (0 is __syncthreads): the state tile holds S_prev (the
// state path arrives, the y path waits); the y path is done reading it
// (the y path arrives, the state path waits); the y path's own
constexpr int BAR_READY = 1, BAR_FREE = 2, BAR_Y = 3;
// registers a thread: the launch gives each warpgroup 128 (two CTAs an
// SM); the state path, which holds the state (N / 2) and half a chunk of
// v's parts (8 HALVES), takes 8 from the y path, and neither spills
constexpr int REGS_Y = 120, REGS_STATE = 136;
static_assert(REGS_Y + REGS_STATE == 2 * 128, "the two paths share the CTA's registers");

static_assert(L == 64 && PT == 64, "a chunk and a p tile are one wgmma m64 tile each");

template <int N>
struct Cfg {
  static constexpr int NS = N / 64;                  // 64-wide slabs of a B, C or S row
  static constexpr int X_BYTES = SLAB;               // x: 64 steps x 64 columns p
  static constexpr int BC_BYTES = NS * SLAB;         // B (or C): 64 steps x N
  static constexpr int STAGE = X_BYTES + 2 * BC_BYTES;
  static constexpr int S_BYTES = NS * SLAB;          // the state in bf16: 64 rows p x N
  static constexpr int Y_BYTES = SLAB;               // y: 64 steps x 64 columns p
  // 1024 bytes of slack to align the slabs; the stages, the state, y, a
  // full and an empty barrier a stage
  static constexpr int SMEM = 1024 + STAGES * STAGE + S_BYTES + Y_BYTES + 16 * STAGES;
};

// Byte offset of element (row r, column c) in a 128B-swizzled slab: the
// 16-byte chunk c / 8 of row r sits at chunk (c / 8) ^ (r % 8).
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
}

__device__ __forceinline__ void st_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// The fp32 pair (v0, v1) as HALVES bf16 pairs, largest first: what is left
// after k parts is below 2^(-9 k) of the pair's values.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t (&out)[HALVES]) {
#pragma unroll
  for (int k = 0; k < HALVES; ++k) {
    const __nv_bfloat162 part = __floats2bfloat162_rn(v0, v1);
    out[k] = *reinterpret_cast<const uint32_t*>(&part);
    v0 -= __low2float(part);
    v1 -= __high2float(part);
  }
}

// An accumulator fragment of 64 rows and M columns (register i: row r0 +
// 8 ((i / 2) % 2), column 8 (i / 4) + c0 + i % 2) into a bf16 tile of
// 128B-swizzled 64-wide slabs, as pairs.
template <int M>
__device__ __forceinline__ void store_tile(uint32_t tile, const float (&acc)[M / 2], int r0,
                                           int c0) {
#pragma unroll
  for (int j = 0; j < M / 8; ++j) {
    const uint32_t slab = tile + (j / 8) * SLAB;
    const int col = 8 * (j % 8) + c0;
    st_b32(slab + sw128(r0, col), hopper::pack_bf16(acc[4 * j], acc[4 * j + 1]));
    st_b32(slab + sw128(r0 + 8, col), hopper::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]));
  }
}

// Inclusive scan over the warp of the chunk's dt * a (in log2 units), lane
// l holding steps l (v0) and l + 32 (v1); returns cs at the chunk's end.
__device__ __forceinline__ float scan_chunk(float& v0, float& v1, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u0 = __shfl_up_sync(0xffffffffu, v0, o);
    const float u1 = __shfl_up_sync(0xffffffffu, v1, o);
    if (lane >= o) {
      v0 += u0;
      v1 += u1;
    }
  }
  v1 += __shfl_sync(0xffffffffu, v0, 31);
  return __shfl_sync(0xffffffffu, v1, 31);
}

// 2^x to the hardware's approximation (relative error below 2^-22, results
// under 2^-126 flushed to 0): enough for y, which is rounded to bf16.
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Step s of the chunk from a pair held as (steps lane, lane + 32); whether
// s < 32 must be the same across the warp.
__device__ __forceinline__ float at_step(float lo, float hi, int s) {
  return __shfl_sync(0xffffffffu, s < 32 ? lo : hi, s & 31);
}

template <int N>
__global__ void __launch_bounds__(2 * WG, 2)
ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tcm, const __grid_constant__ CUtensorMap ty,
                 const float* __restrict__ dt, const float* __restrict__ a,
                 const float* __restrict__ h0, float* __restrict__ hout, int S, int H, int P,
                 int G) {
  using C = Cfg<N>;
  constexpr int NS = C::NS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;   // the stages
  const uint32_t stile = base + STAGES * C::STAGE;                       // the state, bf16
  const uint32_t ytile = stile + C::S_BYTES;                             // y, bf16
  const uint32_t full0 = ytile + C::Y_BYTES;        // a stage's tiles have landed
  const uint32_t empty0 = full0 + 8 * STAGES;       // the state path is done with a stage

  const int tid = threadIdx.x, wg = tid / WG, wt = tid % WG;
  const int warp = wt / 32, lane = tid % 32;
  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const float A2 = a[h] * LOG2E;   // cs in log2 units: exp(x) = exp2(x log2 e)
  const int nchunks = (S + L - 1) / L;
  const float* dtb = dt + (long)b * S * H + h;

  auto load = [&](int c) {   // chunk c's x, B and C tiles into stage c % STAGES
    const uint32_t sx = base + (c % STAGES) * C::STAGE, sb = sx + C::X_BYTES,
                   sc = sb + C::BC_BYTES, bar = full0 + 8 * (c % STAGES);
    hopper::mbar_arrive_expect_tx(bar, C::STAGE);
    hopper::tma_load_4d(sx, &tx, bar, p0, h, c * L, b);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      hopper::tma_load_4d(sb + s * SLAB, &tb, bar, 64 * s, g, c * L, b);
      hopper::tma_load_4d(sc + s * SLAB, &tcm, bar, 64 * s, g, c * L, b);
    }
  };

  if (tid == 0) {
    if (nchunks > 0) {
      hopper::prefetch_tensormap(&tx);
      hopper::prefetch_tensormap(&tb);
      hopper::prefetch_tensormap(&tcm);
      hopper::prefetch_tensormap(&ty);
    }
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      hopper::mbar_init(empty0 + 8 * s, 1);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < STAGES && c < nchunks; ++c) load(c);

  // This thread's accumulator rows r0 and r1 = r0 + 8, and columns
  // 8 j + c0 (+1): register i holds row r0 + 8 ((i / 2) % 2), column
  // 8 (i / 4) + c0 + i % 2.
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8, c0 = 2 * (lane % 4);

  // dt of the next chunk, steps lane and lane + 32 (0 past S)
  float dn0 = 0.f, dn1 = 0.f;
  if (nchunks > 0) {
    dn0 = lane < S ? dtb[(long)lane * H] : 0.f;
    dn1 = lane + 32 < S ? dtb[(long)(lane + 32) * H] : 0.f;
  }
  auto next_dt = [&](int c, float& d0, float& d1) {   // this chunk's dt; fetch the next
    d0 = dn0;
    d1 = dn1;
    if (c + 1 < nchunks) {
      const int t = (c + 1) * L + lane;
      dn0 = t < S ? dtb[(long)t * H] : 0.f;
      dn1 = t + 32 < S ? dtb[(long)(t + 32) * H] : 0.f;
    }
  };

  if (wg == 0) {
    // ---- the y path: y = (C B^T masked, weighted) X + exp(cs_t) C S_prev^T
    hopper::setmaxnreg_dec<REGS_Y>();
    float sacc[32], yacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = yacc[i] = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      const uint32_t sx = base + (c % STAGES) * C::STAGE, sb = sx + C::X_BYTES,
                     sc = sb + C::BC_BYTES;
      float d0, d1;
      next_dt(c, d0, d1);
      float v0 = d0 * A2, v1 = d1 * A2;
      scan_chunk(v0, v1, lane);
      const float cs_r0 = at_step(v0, v1, r0), cs_r1 = at_step(v0, v1, r1);

      // C B^T into sacc; once the state path has written S_prev, C S_prev^T
      // into yacc: N / 16 k-steps each, four per 64-wide slab, 32 bytes apart
      hopper::mbar_wait(full0 + 8 * (c % STAGES), (c / STAGES) & 1);
      hopper::reg_fence(sacc);
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        const uint32_t k = (j / 4) * SLAB + (j % 4) * 32;
        hopper::wgmma_m64n64k16_ss(sacc, hopper::desc_sw128(sc + k, 16, 1024),
                                   hopper::desc_sw128(sb + k, 16, 1024), j > 0);
      }
      hopper::wgmma_commit();
      hopper::bar_sync(BAR_READY, 2 * WG);
      hopper::reg_fence(yacc);
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        const uint32_t k = (j / 4) * SLAB + (j % 4) * 32;
        hopper::wgmma_m64n64k16_ss(yacc, hopper::desc_sw128(sc + k, 16, 1024),
                                   hopper::desc_sw128(stile + k, 16, 1024), j > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::reg_fence(sacc);

      // while C S_prev^T runs: M = C B^T exp(cs_t - cs_s) dt_s for s <= t,
      // masked before exp; in bf16 pairs, registers 8 kk .. 8 kk + 7 are
      // A's k16 block kk. Column groups wholly above this warp's rows are 0.
      uint32_t mf[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float cs_s0 = at_step(v0, v1, 8 * j + c0), cs_s1 = at_step(v0, v1, 8 * j + c0 + 1);
        const float dt_s0 = at_step(d0, d1, 8 * j + c0), dt_s1 = at_step(d0, d1, 8 * j + c0 + 1);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * j + 2 * half, t = half ? r1 : r0, s = 8 * j + c0;
          const float cst = half ? cs_r1 : cs_r0;
          float m0 = 0.f, m1 = 0.f;
          if (8 * j <= 16 * warp + 15) {   // warp-uniform
            m0 = s <= t ? sacc[i] * exp2_fast(cst - cs_s0) * dt_s0 : 0.f;
            m1 = s + 1 <= t ? sacc[i + 1] * exp2_fast(cst - cs_s1) * dt_s1 : 0.f;
          }
          mf[i / 8][(i % 8) / 2] = hopper::pack_bf16(m0, m1);
        }
      }

      // y starts as the inter-chunk term exp(cs_t) C S_prev^T, and the state
      // tile is free for the state path; then y += M X, X the MN-major B
      hopper::wgmma_wait<0>();
      hopper::reg_fence(yacc);
      hopper::bar_arrive(BAR_FREE, 2 * WG);
      const float e0 = exp2_fast(cs_r0), e1 = exp2_fast(cs_r1);
#pragma unroll
      for (int i = 0; i < 32; ++i) yacc[i] *= (i % 4) < 2 ? e0 : e1;
      hopper::reg_fence(yacc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_m64n64k16_rs_tb(yacc, mf[kk],
                                      hopper::desc_sw128(sx + kk * 16 * 128, SLAB, 1024));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(yacc);

      if (wt == 0) {
        // both paths are done with this stage: refill it
        if (c + STAGES < nchunks) {
          hopper::mbar_wait(empty0 + 8 * (c % STAGES), (c / STAGES) & 1);
          load(c + STAGES);
        }
        hopper::bulk_wait_read<0>();   // the last chunk's y has left the y tile
      }
      hopper::bar_sync(BAR_Y, WG);
      store_tile<64>(ytile, yacc, r0, c0);
      hopper::fence_proxy_async();
      hopper::bar_sync(BAR_Y, WG);
      if (wt == 0) {   // steps past S are not written
        hopper::tma_store_4d(&ty, ytile, p0, h, c * L, b);
        hopper::bulk_commit();
      }
    }
    if (wt == 0) hopper::bulk_wait<0>();
  } else {
    // ---- the state path: S <- exp(cs_L) S + v^T B, v = w x, in registers
    hopper::setmaxnreg_inc<REGS_STATE>();
    // The state, rows p0 + r0 / r1, columns n = 8 j + c0 (+1): the
    // update's accumulator, one m64nNk16 fragment.
    const long so = ((long)b * H + h) * P * N;
    float st[N / 2];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int n = 8 * j + c0;
      float2 u = make_float2(0.f, 0.f), v = make_float2(0.f, 0.f);
      if (h0 != nullptr) {
        u = *reinterpret_cast<const float2*>(h0 + so + (long)(p0 + r0) * N + n);
        v = *reinterpret_cast<const float2*>(h0 + so + (long)(p0 + r1) * N + n);
      }
      st[4 * j] = u.x;
      st[4 * j + 1] = u.y;
      st[4 * j + 2] = v.x;
      st[4 * j + 3] = v.y;
    }
    if (nchunks > 0) {   // S_prev of chunk 0
      store_tile<N>(stile, st, r0, c0);
      hopper::fence_proxy_async();
      hopper::bar_arrive(BAR_READY, 2 * WG);
    }

    for (int c = 0; c < nchunks; ++c) {
      const uint32_t sx = base + (c % STAGES) * C::STAGE, sb = sx + C::X_BYTES;
      float d0, d1;
      next_dt(c, d0, d1);
      float v0 = d0 * A2, v1 = d1 * A2;
      const float csL = scan_chunk(v0, v1, lane);
      const float w0 = exp2f(csL - v0) * d0, w1 = exp2f(csL - v1) * d1;   // w_s

      hopper::mbar_wait(full0 + 8 * (c % STAGES), (c / STAGES) & 1);
      const float eL = exp2f(csL);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) st[i] *= eL;

      // S += v^T B, v[p][s] = w_s x[s][p], in two passes of 32 steps s (so
      // that v's registers are held for half a chunk): v in HALVES bf16
      // parts, the A operand (rows p, k = s), from x^T as four transposed
      // 8x8 matrices a k16 block, register q of block kk holding columns
      // s = 16 kk + 8 (q / 2) + c0 (+1); B the MN-major operand; one wgmma
      // a part of v and k16 block
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        uint32_t vf[HALVES][2][4];
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {
          const int kk = 2 * pass + k2;
          uint32_t xt[4];
          const int m = lane / 8;
          hopper::ldmatrix_x4_trans(
              xt, sx + sw128(16 * kk + 8 * (m / 2) + lane % 8, 16 * warp + 8 * (m % 2)));
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int s = 16 * kk + 8 * (q / 2) + c0;
            uint32_t parts[HALVES];
            split_bf16(at_step(w0, w1, s) * __uint_as_float(xt[q] << 16),
                       at_step(w0, w1, s + 1) * __uint_as_float(xt[q] & 0xffff0000u), parts);
#pragma unroll
            for (int hv = 0; hv < HALVES; ++hv) vf[hv][k2][q] = parts[hv];
          }
        }
        hopper::reg_fence(st);
        hopper::wgmma_fence();
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
          for (int hv = 0; hv < HALVES; ++hv) {
            const uint64_t db =
                hopper::desc_sw128(sb + (2 * pass + k2) * 16 * 128, SLAB, 1024);
            if constexpr (N == 128)
              hopper::wgmma_m64n128k16_rs_tb(st, vf[hv][k2], db);
            else
              hopper::wgmma_m64n64k16_rs_tb(st, vf[hv][k2], db);
          }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::reg_fence(st);
      }
      if (wt == 0) hopper::mbar_arrive(empty0 + 8 * (c % STAGES));

      // once the y path has read S_prev, the tile takes this chunk's state,
      // rounded to bf16 as the reference rounds S_prev
      hopper::bar_sync(BAR_FREE, 2 * WG);
      if (c + 1 < nchunks) {
        store_tile<N>(stile, st, r0, c0);
        hopper::fence_proxy_async();
        hopper::bar_arrive(BAR_READY, 2 * WG);
      }
    }

    if (hout != nullptr) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int n = 8 * j + c0;
        *reinterpret_cast<float2*>(hout + so + (long)(p0 + r0) * N + n) =
            make_float2(st[4 * j], st[4 * j + 1]);
        *reinterpret_cast<float2*>(hout + so + (long)(p0 + r1) * N + n) =
            make_float2(st[4 * j + 2], st[4 * j + 3]);
      }
    }
  }
}

template <int N>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
           const void* h0, void* y, void* hout, int B, int S, int H, int P, int G,
           cudaStream_t stream) {
  using C = Cfg<N>;
  CUtensorMap tx{}, tb{}, tcm{}, ty{};   // S == 0 reads and writes nothing: the maps stay unset
  cudaError_t err = cudaSuccess;
  if (S > 0) {
    err = hopper::tma_map_bshd(&tx, x, B, S, H, P, L);
    if (err == cudaSuccess) err = hopper::tma_map_bshd(&tb, b, B, S, G, N, L);
    if (err == cudaSuccess) err = hopper::tma_map_bshd(&tcm, c, B, S, G, N, L);
    if (err == cudaSuccess) err = hopper::tma_map_bshd(&ty, y, B, S, H, P, L);
    if (err != cudaSuccess) return (int)err;
  }
  static std::atomic<unsigned long long> opted_in{0};
  err = hopper::opt_in_smem((const void*)ssd_wgmma_kernel<N>, C::SMEM, opted_in);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(P / PT, H, B);
  ssd_wgmma_kernel<N><<<grid, 2 * WG, C::SMEM, stream>>>(
      tx, tb, tcm, ty, static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const float*>(h0), static_cast<float*>(hout), S, H, P, G);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// 1 if (dtype, P, N) takes the tensor-core route, 0 if the CUDA-core one.
extern "C" int ssd_scan_route(int dtype, int P, int N) {
  return dtype == 1 && P % 64 == 0 && (N == 64 || N == 128);
}

// dtype (of x, b, c and y): 0 float32, 1 bfloat16. h0 and hout may be
// null. Returns cudaGetLastError() after the launch (0 on success);
// launches on `stream` and does not synchronise.
extern "C" int ssd_scan(int dtype, const void* x, const void* dt, const void* a, const void* b,
                        const void* c, const void* h0, void* y, void* hout, int B, int S, int H,
                        int P, int G, int N, void* stream) {
  if (B <= 0 || S < 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 || N <= 0 || N > NMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ssd_scan_route(dtype, P, N)) {
    if (N == 64) return tc::launch<64>(x, dt, a, b, c, h0, y, hout, B, S, H, P, G, st);
    return tc::launch<128>(x, dt, a, b, c, h0, y, hout, B, S, H, P, G, st);
  }
  switch (dtype) {
    case 0: return launch<float>(x, dt, a, b, c, h0, y, hout, B, S, H, P, G, N, st);
    case 1: return launch<__nv_bfloat16>(x, dt, a, b, c, h0, y, hout, B, S, H, P, G, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
