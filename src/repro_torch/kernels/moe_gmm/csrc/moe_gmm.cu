// Grouped expert matmul for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm/kernel.py:25
// (_gmm_kernel, launched by grouped_matmul at :42 through the pallas_call
// at :56, behind ops.py:18 expert_swiglu).  It computes the same function,
// not the same blocks: for x [E, C, d] and w [E, d, f],
//
//   out[e, c, :] = sum_k x[e, c, k] * w[e, k, :]
//
// with every product and sum in fp32 and the result stored in x's dtype
// (round to nearest even for bf16, as a torch cast).  x is fp32 or bf16;
// w is in x's dtype or fp32.  An fp32 weight under bf16 x is rounded to
// bf16 as it is loaded (__float2bfloat16_rn), which is the reference's
// w.astype(x.dtype) without a rounded copy of the weights in memory.
//
// Optional per-expert counts (int32 [E], each in [0, C]): the rows of
// expert e at or past counts[e] are zero in the output.  A row tile wholly
// past the count is not computed (it is written as zeros), and a tile that
// the count cuts computes only its threads' rows below it.  The capacity
// dispatch of the model zero-fills those rows of x, so the function on its
// inputs is the uncounted one.  A count outside [0, C] traps: the launch
// fails, and the next synchronise reports it.
//
// Bound on the H100 at deepseek-moe-16b's prefill (batch 4, prompt 2,048,
// top-6 of 64 experts: 49,152 (token, expert) pairs, d = 2,048, f = 1,408):
// 2 x 49,152 x 2,048 x 1,408 = 2.835e11 FLOP per gate or up launch, 0.287
// ms at the bf16 tensor-core peak of 989 TFLOP/s, against 0.212 ms for its
// bytes with bf16 weights (0.322 ms with the fp32 master weights read as
// they are stored): bound by operations, or by the fp32 weights' bytes.
// A decode step at batch 4 has at most 24 active experts: at most 277 MB
// of fp32 weights, 0.083 ms, bound by bytes.
//
// The design is the simple one that is right, on CUDA cores: one block of
// 256 threads per (64 output columns, 64 capacity rows, expert), each
// thread a 4 x 4 register block of fp32 accumulators; the contraction
// walked in slabs of 16, the x slab stored transposed (rows padded to 68
// floats) and the w slab as it is, both as fp32 in shared memory, read as
// float4; the next slab's global loads issued into registers before the
// current slab's products.  Blocks of one expert run together, so its w
// (11.5 MB in fp32 at deepseek's widths) stays in the 50 MB L2 across its
// row tiles.  It does the products at the CUDA cores' fp32 rate (67
// TFLOP/s), so it cannot come near the tensor-core bound.
//
// Two more kernels below take bf16 x with d % 8 == 0 and f % 8 == 0 on
// the tensor cores; the wrapper (ops.py) chooses by that rule, and this
// SIMT kernel keeps fp32 x and every other shape.
//
// The tensor-core kernels: the same function for bf16 x and bf16 or fp32
// w.  bf16 x bf16 products are exact in fp32, so wgmma with fp32
// accumulators computes the same products; only the order of the fp32
// sums changes.  One CTA of 288 threads per (row tile, 128-column tile,
// expert), the row tiles of one column strip adjacent in the grid so that
// the strip's weights (1 MB in fp32) stay in the 50 MB L2 while all its
// row tiles read them: each weight byte comes from device memory about
// once per expert.  A row tile wholly past the count writes its zeros and
// reads nothing (at decode, C = 4, so every inactive expert's weights stay
// unread); rows of a live tile at or past the count are multiplied and
// written as zeros.  Warp 8 is the producer: one lane keeps a ring of
// stages of the x and w tiles in flight by TMA.  Warpgroups 0 and 1 are
// the consumers, with fp32 accumulators in registers.  Rows past C and
// columns past d or f read as zeros from TMA.
//
// * moe_gmm_wgmma_bf16w (bf16 weights): 128-row tiles, 64 rows per
//   warpgroup; per stage 4 wgmma m64n128k16 with x K-major and w MN-major,
//   both from shared memory.
// * moe_gmm_wgmma_f32w (fp32 weights, as deepseek's 67.5 GB of master
//   weights are stored, with no room for a bf16 copy on the card).  TMA
//   cannot convert types, so the fp32 tiles land as they are and are
//   rounded to bf16 (__float2bfloat16_rn, the reference's astype) in
//   registers, as the A operand of the transposed product out^T = w^T x^T:
//   each warpgroup owns 64 output columns (the wgmma M) and the row tile,
//   256 rows (128 where C <= 128), is the wgmma N.  At 256 rows the 128
//   accumulators and 16 fragment registers a thread leave ptxas too few
//   registers to keep wgmmas in flight together, and it serialises them;
//   256 rows still ran faster than 128 or 192 rows on an NVIDIA H100 80GB
//   HBM3 at 700 W.  The other choice,
//   rounding into a swizzled bf16 tile in shared memory for a product of
//   the bf16 kernel's form, was this kernel's first version: its extra
//   write pass and barrier per stage made it shared-memory bound (0.9204
//   ms at deepseek's prefill shape against 0.6103 on bf16 weights, NVIDIA
//   H100 80GB HBM3 at 700 W, chip_smoke.py); in registers each fp32 weight
//   is read once, conflict-free through the 128-byte swizzle, and nothing
//   is written back.  Its epilogue stores the transposed tile element by
//   element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../hopper.cuh"

namespace {

constexpr int kBlockM = 64;         // capacity rows per block
constexpr int kBlockN = 64;         // output columns per block
constexpr int kBlockK = 16;         // contraction slab in shared memory
constexpr int kThreads = 256;       // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLdA = kBlockM + 4;   // padded row of the transposed x slab
constexpr int kPerThread = kBlockM * kBlockK / kThreads;   // = 4

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A weight as the product sees it: rounded to x's dtype first.
template <typename TX, typename TW>
struct WeightIn;
template <>
struct WeightIn<float, float> {
  static __device__ __forceinline__ float get(float v) { return v; }
};
template <>
struct WeightIn<__nv_bfloat16, __nv_bfloat16> {
  static __device__ __forceinline__ float get(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
};
template <>
struct WeightIn<__nv_bfloat16, float> {
  static __device__ __forceinline__ float get(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// This thread's 4 elements of the x slab (rows of the tile below `rows`,
// columns k0..k0+15 below d; zero elsewhere) and of the w slab (rows
// k0..k0+15 below d, columns below n_in).
template <typename TX, typename TW>
__device__ __forceinline__ void load_slab(
    const TX* __restrict__ xbase, const TW* __restrict__ wbase, int k0,
    int rows, int n_in, int d, int f, float (&ra)[kPerThread],
    float (&rb)[kPerThread]) {
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 4, ka = k0 + (idx & 15);
    ra[i] = (r < rows && ka < d) ? to_f32(xbase[(long long)r * d + ka]) : 0.f;
    const int kb = k0 + (idx >> 6), c = idx & 63;
    rb[i] = (kb < d && c < n_in)
                ? WeightIn<TX, TW>::get(wbase[(long long)kb * f + c])
                : 0.f;
  }
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
moe_gmm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               const int* __restrict__ counts, TX* __restrict__ out, int C,
               int d, int f) {
  __shared__ __align__(16) float as[kBlockK][kLdA];      // as[k][row]
  __shared__ __align__(16) float bs[kBlockK][kBlockN];   // bs[k][col]

  const int n0 = blockIdx.x * kBlockN;
  const int m0 = blockIdx.y * kBlockM;
  const int e = blockIdx.z;
  int valid = C;
  if (counts != nullptr) {
    valid = counts[e];
    if (valid < 0 || valid > C) __trap();
  }
  const int rows = min(kBlockM, max(0, valid - m0));   // rows to compute
  const int m_in = min(kBlockM, C - m0);               // rows inside C
  const int n_in = min(kBlockN, f - n0);               // columns inside f
  const int tx = threadIdx.x & 15;                     // columns tx*4 .. +3
  const int ty = threadIdx.x >> 4;                     // rows ty*4 .. +3

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (rows > 0) {
    const TX* xbase = x + ((long long)e * C + m0) * d;
    const TW* wbase = w + (long long)e * d * f + n0;
    const int n_slabs = (d + kBlockK - 1) / kBlockK;
    float ra[kPerThread], rb[kPerThread];
    load_slab<TX, TW>(xbase, wbase, 0, rows, n_in, d, f, ra, rb);
    for (int s = 0; s < n_slabs; ++s) {
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        as[idx & 15][idx >> 4] = ra[i];
        bs[idx >> 6][idx & 63] = rb[i];
      }
      __syncthreads();
      if (s + 1 < n_slabs)
        load_slab<TX, TW>(xbase, wbase, (s + 1) * kBlockK, rows, n_in, d, f,
                          ra, rb);
      if (ty * 4 < rows) {
#pragma unroll
        for (int k = 0; k < kBlockK; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
          const float4 b = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

  TX* obase = out + ((long long)e * C + m0) * f + n0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= m_in) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx * 4 + j;
      if (c < n_in)
        store(obase + (long long)r * f + c, r < rows ? acc[i][j] : 0.f);
    }
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, const int* counts, void* out, int e,
           int c, int d, int f, cudaStream_t stream) {
  const dim3 grid((unsigned)((f + kBlockN - 1) / kBlockN),
                  (unsigned)((c + kBlockM - 1) / kBlockM), (unsigned)e);
  moe_gmm_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), counts,
      static_cast<TX*>(out), c, d, f);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// the tensor-core kernels: bf16 x (see the header comment)
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 288;    // two consumer warpgroups + a producer
constexpr int kTcK = 64;           // contraction per stage
constexpr int kTcCols = 128;       // output columns per CTA

// Rows [0, m_in) x columns [0, n_in) of a tile at obase, zero (a row tile
// wholly past its expert's count: nothing is read for it).
__device__ __forceinline__ void zero_tile(__nv_bfloat16* obase, int m_in,
                                          int n_in, int f) {
  const __nv_bfloat162 z = __floats2bfloat162_rn(0.0f, 0.0f);
  for (int i = threadIdx.x; i < m_in * (n_in / 2); i += kTcThreads) {
    const int r = i / (n_in / 2), c = 2 * (i % (n_in / 2));
    *reinterpret_cast<__nv_bfloat162*>(obase + (long long)r * f + c) = z;
  }
}

// The count of expert e, checked: a count outside [0, C] traps.
__device__ __forceinline__ int expert_count(const int* counts, int e, int C) {
  if (counts == nullptr) return C;
  const int valid = counts[e];
  if (valid < 0 || valid > C) __trap();
  return valid;
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);   // one arrival per warpgroup
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// --- bf16 weights: out = x . w, both operands from shared memory ---------

constexpr int kBfRows = 128;                    // rows per CTA, 64 per WG
constexpr int kBfStages = 4;
constexpr int kBfA = kBfRows * kTcK * 2;        // x tile, 16 KB
constexpr int kBfBChunk = kTcK * 128;           // 64 columns of the w tile
constexpr int kBfStage = kBfA + 2 * kBfBChunk;  // + w tile, 16 KB
constexpr int kBfSmem = kBfStages * kBfStage + 1024;

__global__ void __launch_bounds__(kTcThreads, 1)
moe_gmm_wgmma_bf16w(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_w,
                    const int* __restrict__ counts,
                    __nv_bfloat16* __restrict__ out, int C, int d, int f) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_full[kBfStages];
  __shared__ __align__(8) uint64_t bar_empty[kBfStages];
  uint8_t* smem = hopper::align_1024(smem_raw);

  const int m0 = blockIdx.x * kBfRows;
  const int n0 = blockIdx.y * kTcCols;
  const int e = blockIdx.z;
  const int valid = expert_count(counts, e, C);
  const int m_in = min(kBfRows, C - m0);
  const int n_in = min(kTcCols, f - n0);
  __nv_bfloat16* obase = out + ((long long)e * C + m0) * f + n0;
  if (valid <= m0) {
    zero_tile(obase, m_in, n_in, f);
    return;
  }
  init_ring(bar_full, bar_empty, kBfStages);

  const int n_k = (d + kTcK - 1) / kTcK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 8) {
    // ---- producer: one lane keeps the stages of x and w tiles in flight
    if (lane == 0) {
      for (int t = 0; t < n_k; ++t) {
        const int s = t % kBfStages;
        hopper::mbar_wait(&bar_empty[s], ((t / kBfStages) & 1) ^ 1);
        uint8_t* stage = smem + s * kBfStage;
        hopper::mbar_expect_tx(&bar_full[s], kBfStage);
        hopper::tma_load_3d(stage, &tm_x, &bar_full[s], t * kTcK, m0, e);
        for (int c = 0; c < 2; ++c)
          hopper::tma_load_3d(stage + kBfA + c * kBfBChunk, &tm_w,
                              &bar_full[s], n0 + 64 * c, t * kTcK, e);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 (one whose
  // rows all lie past the count multiplies what TMA left there and stores
  // zeros: a branch around its wgmma would make ptxas serialize them all)
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  const uint32_t base = hopper::smem_u32(smem);
  // one stage's products stay in flight while the next stage's issue
  for (int t = 0; t < n_k; ++t) {
    const int s = t % kBfStages;
    hopper::mbar_wait(&bar_full[s], (t / kBfStages) & 1);
    const uint32_t a = base + s * kBfStage + wg * 64 * 128;
    const uint32_t b = base + s * kBfStage + kBfA;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk)
      hopper::wgmma_ss_n128<1>(
          acc, hopper::sw128_desc(a + kk * 32, 16, 1024),
          hopper::sw128_desc(b + kk * 16 * 128, kBfBChunk, 1024), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(acc);
    if (t > 0 && tid == 0)
      hopper::mbar_arrive(&bar_empty[(t - 1) % kBfStages]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // rows below the count get the products, rows from it to C zeros
  const int r_lane = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < kTcCols / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    if (c >= n_in) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lane + 8 * h;
      if (r >= m_in) continue;
      const bool keep = m0 + r < valid;
      *reinterpret_cast<__nv_bfloat162*>(obase + (long long)r * f + c) =
          __floats2bfloat162_rn(keep ? acc[4 * j + 2 * h] : 0.0f,
                                keep ? acc[4 * j + 2 * h + 1] : 0.0f);
    }
  }
}

// --- fp32 weights: out^T = w^T . x^T, w^T as the register operand -------
//
// The fp32 w tile [64 k][128 f] lands by TMA in four 32-column chunks in
// the 128-byte swizzle (a row of a chunk is 32 floats); each consumer
// thread reads its A fragments of w^T from it (the rows f of its lanes,
// the columns k of a k16 step), rounds them to bf16 in registers and
// issues wgmma m64n{R}k16 against the x tile [R rows][64 k], read
// K-major as B.  The swizzle makes the 32 lanes' reads hit 32 banks.

constexpr int kF32Stages = 3;
constexpr int kF32Rows = 256;                   // rows per CTA where C > 128
constexpr int kF32WChunk = kTcK * 128;           // 32 columns x 64 k fp32
constexpr int kF32W = 4 * kF32WChunk;            // 32 KB

template <int R>
struct F32Layout {
  static constexpr int kX = R * kTcK * 2;         // x tile, bf16
  static constexpr int kStage = kF32W + kX;
  static constexpr int kBytes = kF32Stages * kStage + 1024;
};

// w[k][f] of the landed tile, f in [0, 128)
__device__ __forceinline__ float w_at(const uint8_t* tile, int k, int f) {
  return *reinterpret_cast<const float*>(
      tile + (f / 32) * kF32WChunk + k * 128 +
      ((((f % 32) / 4) ^ (k % 8)) * 16) + (f % 4) * 4);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int R>
__device__ __forceinline__ void wgmma_rows(float (&acc)[R / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  if constexpr (R == 256)
    hopper::wgmma_rs_n256<0>(acc, a, desc_b, 1);
  else
    hopper::wgmma_rs_n128<0>(acc, a, desc_b, 1);
}

template <int R>
__global__ void __launch_bounds__(kTcThreads, 1)
moe_gmm_wgmma_f32w(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w,
                   const int* __restrict__ counts,
                   __nv_bfloat16* __restrict__ out, int C, int d, int f) {
  using L = F32Layout<R>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_full[kF32Stages];
  __shared__ __align__(8) uint64_t bar_empty[kF32Stages];
  uint8_t* smem = hopper::align_1024(smem_raw);

  const int m0 = blockIdx.x * R;
  const int n0 = blockIdx.y * kTcCols;
  const int e = blockIdx.z;
  const int valid = expert_count(counts, e, C);
  const int m_in = min(R, C - m0);
  const int n_in = min(kTcCols, f - n0);
  __nv_bfloat16* obase = out + ((long long)e * C + m0) * f + n0;
  if (valid <= m0) {
    zero_tile(obase, m_in, n_in, f);
    return;
  }
  init_ring(bar_full, bar_empty, kF32Stages);

  const int n_k = (d + kTcK - 1) / kTcK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 8) {
    if (lane == 0) {
      for (int t = 0; t < n_k; ++t) {
        const int s = t % kF32Stages;
        hopper::mbar_wait(&bar_empty[s], ((t / kF32Stages) & 1) ^ 1);
        uint8_t* stage = smem + s * L::kStage;
        hopper::mbar_expect_tx(&bar_full[s], L::kStage);
        for (int c = 0; c < 4; ++c)
          hopper::tma_load_3d(stage + c * kF32WChunk, &tm_w, &bar_full[s],
                              n0 + 32 * c, t * kTcK, e);
        hopper::tma_load_3d(stage + kF32W, &tm_x, &bar_full[s], t * kTcK,
                            m0, e);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns output columns n0 + 64 wg .. + 63
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int fr = wg * 64 + (warp % 4) * 16 + lane / 4;   // rows fr, fr + 8
  const int kq = 2 * (lane % 4);
  float acc[R / 2];
#pragma unroll
  for (int i = 0; i < R / 2; ++i) acc[i] = 0.0f;
  uint32_t a[kTcK / 16][4];
  const uint32_t base = hopper::smem_u32(smem);
  for (int t = 0; t < n_k; ++t) {
    const int s = t % kF32Stages;
    hopper::mbar_wait(&bar_full[s], (t / kF32Stages) & 1);
    const uint8_t* wt = smem + s * L::kStage;
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk) {
      const int k = 16 * kk + kq;
      a[kk][0] = pack_bf16(w_at(wt, k, fr), w_at(wt, k + 1, fr));
      a[kk][1] = pack_bf16(w_at(wt, k, fr + 8), w_at(wt, k + 1, fr + 8));
      a[kk][2] = pack_bf16(w_at(wt, k + 8, fr), w_at(wt, k + 9, fr));
      a[kk][3] = pack_bf16(w_at(wt, k + 8, fr + 8),
                           w_at(wt, k + 9, fr + 8));
    }
    const uint32_t xs = base + s * L::kStage + kF32W;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk)
      wgmma_rows<R>(acc, a[kk], hopper::sw128_desc(xs + kk * 32, 16, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk) hopper::fence_regs(a[kk]);
    if (tid == 0) hopper::mbar_arrive(&bar_empty[s]);
  }

  // acc holds out^T: columns fr, fr + 8; rows 8 j + kq (+ 1)
#pragma unroll
  for (int j = 0; j < R / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 8 * j + kq + (i % 2);
      const int c = fr + 8 * (i / 2);
      if (r < m_in && c < n_in)
        obase[(long long)r * f + c] =
            __float2bfloat16_rn(m0 + r < valid ? acc[4 * j + i] : 0.0f);
    }
  }
}

int launch_wgmma(const void* x, const void* w, int w_dtype, const int* counts,
                 void* out, int e, int c, int d, int f, cudaStream_t stream) {
  const bool f32w = w_dtype == 0;
  const int rows = !f32w ? kBfRows : (c > 128 ? kF32Rows : 128);
  const cuuint64_t we = f32w ? 4 : 2;
  CUtensorMap tm_x, tm_w;
  // x [E, C, d] as (d, C, E); w [E, d, f] as (f, d, E)
  const cuuint64_t x_dims[3] = {(cuuint64_t)d, (cuuint64_t)c, (cuuint64_t)e};
  const cuuint64_t x_strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)c * d * 2};
  const cuuint32_t x_box[3] = {kTcK, (cuuint32_t)rows, 1};
  int rc = hopper::tensor_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x,
                              x_dims, x_strides, x_box,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  const cuuint64_t w_dims[3] = {(cuuint64_t)f, (cuuint64_t)d, (cuuint64_t)e};
  const cuuint64_t w_strides[2] = {f * we, (cuuint64_t)d * f * we};
  const cuuint32_t w_box[3] = {f32w ? 32u : 64u, kTcK, 1};
  rc = hopper::tensor_map(&tm_w,
                          f32w ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          3, w, w_dims, w_strides, w_box,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)((c + rows - 1) / rows),
                  (unsigned)((f + kTcCols - 1) / kTcCols), (unsigned)e);
  const int* cnt = counts;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if (!f32w) {
    err = cudaFuncSetAttribute(moe_gmm_wgmma_bf16w,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBfSmem);
    if (err != cudaSuccess) return (int)err;
    moe_gmm_wgmma_bf16w<<<grid, kTcThreads, kBfSmem, stream>>>(
        tm_x, tm_w, cnt, o, c, d, f);
  } else if (rows == kF32Rows) {
    err = cudaFuncSetAttribute(moe_gmm_wgmma_f32w<kF32Rows>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               F32Layout<kF32Rows>::kBytes);
    if (err != cudaSuccess) return (int)err;
    moe_gmm_wgmma_f32w<kF32Rows><<<grid, kTcThreads,
                                   F32Layout<kF32Rows>::kBytes, stream>>>(
        tm_x, tm_w, cnt, o, c, d, f);
  } else {
    err = cudaFuncSetAttribute(moe_gmm_wgmma_f32w<128>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               F32Layout<128>::kBytes);
    if (err != cudaSuccess) return (int)err;
    moe_gmm_wgmma_f32w<128><<<grid, kTcThreads, F32Layout<128>::kBytes,
                              stream>>>(tm_x, tm_w, cnt, o, c, d, f);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int moe_gmm_row_tile() { return kBlockM; }

// dtypes: 0 = float32, 1 = bfloat16; w_dtype is x_dtype or 0.  counts may
// be null.  Returns a cudaError_t (0 = launched).
int moe_gmm_launch(const void* x, const void* w, const void* counts,
                   void* out, int x_dtype, int w_dtype, int e, int c, int d,
                   int f, void* stream) {
  if (e <= 0 || c <= 0 || d <= 0 || f <= 0 || e > 65535 ||
      (c + kBlockM - 1) / kBlockM > 65535)
    return (int)cudaErrorInvalidValue;
  const int* cnt = static_cast<const int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, w, cnt, out, e, c, d, f, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, cnt, out, e, c, d, f,
                                                 s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, cnt, out, e, c, d, f, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernel: bf16 x, w bf16 (w_dtype 1) or fp32 (0), d and f
// multiples of 8, 16-byte aligned tensors.  Returns a cudaError_t or a
// hopper.cuh error code.
int moe_gmm_wgmma_launch(const void* x, const void* w, const void* counts,
                         void* out, int w_dtype, int e, int c, int d, int f,
                         void* stream) {
  if (e <= 0 || c <= 0 || d <= 0 || f <= 0 || e > 65535 || d % 8 != 0 ||
      f % 8 != 0 || (c + 127) / 128 > 65535)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[3] = {x, w, out};
  for (int i = 0; i < 3; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  const int* cnt = static_cast<const int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype != 0 && w_dtype != 1) return (int)cudaErrorInvalidValue;
  return launch_wgmma(x, w, w_dtype, cnt, out, e, c, d, f, s);
}

const char* moe_gmm_error_string(int err) {
  return hopper::error_string(err);
}

}  // extern "C"
