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
// For the PR that makes it fast: bf16 x bf16 products are exact in fp32,
// so mma/wgmma with fp32 accumulation computes the same products (TMA
// loads of the weights, rounded to bf16 in shared memory when they are
// stored in fp32); only the order of the fp32 sums changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

const char* moe_gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
