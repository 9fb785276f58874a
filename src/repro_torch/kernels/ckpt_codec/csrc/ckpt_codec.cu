// Blockwise int8 checkpoint codec for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces the TPU kernels src/repro/kernels/ckpt_codec/kernel.py:22
// (_quant_kernel, launched by quantize_blocks at :42) and :30
// (_dequant_kernel, launched by dequantize_blocks at :63).  A flat tensor of
// n elements is seen as R = ceil(n / 128) rows of 128:
//
//   quantize    absmax = max|x| per row,
//               scale  = max(absmax, 1e-12) * fl32(1/127),
//               q      = clip(rint(x / scale), -127, 127) as int8,
//               one fp32 scale per row;
//   dequantize  q * scale in fp32, rounded to the output type (fp32 or bf16).
//
// Elements past n read as 0: that is the tail jnp.pad makes in the
// reference's quantize_array, so the caller never builds a padded copy.
//
// Bound on the H100: both are pure streaming.  Quantize reads 4n bytes and
// writes 128R + 4R; dequantize to fp32 reads 128R + 4R and writes 4n.  For
// the full internlm2-1.8b TrainState (~5.67e9 fp32 elements) that is ~28.5
// GB each way, ~8.5 ms at 3.35 TB/s.  The design is the simplest that
// streams: one warp per row, each lane one 16-byte load, a five-step
// __shfl_xor_sync absmax, lane 0 writes the scale, each lane packs its four
// codes into one 32-bit store, and a grid-stride loop over the rows.  TMA
// and wider vectors are later work.
//
// The arithmetic is chosen to be bit-identical to the reference's compiled
// function (quantize_array under jit), not to its eager oracle:
//   * XLA rewrites `max(absmax, 1e-12) / 127.0` into a multiply by the fp32
//     reciprocal, and the compiled scale is what the reference's codes and
//     dequantized values come from.  The eager division differs from it by
//     one ulp in ~4% of rows.  So the scale is a MULTIPLY by (1.0f/127.0f);
//     do not "fix" it back to a division.
//   * x / scale stays a correctly rounded division (__fdiv_rn), so no
//     --use_fast_math can turn it into an approximation that changes codes.
//   * jnp.round rounds half to even: rintf, never roundf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;              // elements per row (one scale each)
constexpr int kThreads = 256;           // 8 warps, one row each at a time
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kMaxBlocks = 132 * 32;    // grid-stride beyond this

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ uint32_t code(float x, float scale) {
  float r = rintf(__fdiv_rn(x, scale));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)(int)r;
}

__global__ void quantize_rows(const float* __restrict__ x, long long n,
                              long long rows, int8_t* __restrict__ q,
                              float* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kRowsPerBlock +
                         (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kRowsPerBlock;
  for (long long row = warp; row < rows; row += stride) {
    const long long base = row * kLane + 4 * lane;
    float4 v;
    if (row * kLane + kLane <= n) {
      v = __ldg(reinterpret_cast<const float4*>(x + base));
    } else {                                  // the partial last row
      v.x = base + 0 < n ? x[base + 0] : 0.0f;
      v.y = base + 1 < n ? x[base + 1] : 0.0f;
      v.z = base + 2 < n ? x[base + 2] : 0.0f;
      v.w = base + 3 < n ? x[base + 3] : 0.0f;
    }
    float m = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                    fmaxf(fabsf(v.z), fabsf(v.w)));
    m = warp_max(m);
    // multiply by the fp32 reciprocal: see the note at the top
    const float scale = __fmul_rn(fmaxf(m, 1e-12f), 1.0f / 127.0f);
    const uint32_t packed = code(v.x, scale) | (code(v.y, scale) << 8) |
                            (code(v.z, scale) << 16) | (code(v.w, scale) << 24);
    reinterpret_cast<uint32_t*>(q + row * kLane)[lane] = packed;
    if (lane == 0) scales[row] = scale;
  }
}

template <bool kBf16>
__global__ void dequantize_rows(const int8_t* __restrict__ q,
                                const float* __restrict__ scales, long long n,
                                long long rows, void* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kRowsPerBlock +
                         (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kRowsPerBlock;
  for (long long row = warp; row < rows; row += stride) {
    const long long base = row * kLane + 4 * lane;
    const char4 c = __ldg(reinterpret_cast<const char4*>(q + row * kLane) +
                          lane);
    const float s = __ldg(scales + row);
    const float y[4] = {__fmul_rn((float)c.x, s), __fmul_rn((float)c.y, s),
                        __fmul_rn((float)c.z, s), __fmul_rn((float)c.w, s)};
    const bool full = row * kLane + kLane <= n;
    if (kBf16) {
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
      if (full) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
        uint2 packed;
        packed.x = *reinterpret_cast<uint32_t*>(&lo);
        packed.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(o + base) = packed;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (base + k < n) o[base + k] = __float2bfloat16_rn(y[k]);
      }
    } else {
      float* o = static_cast<float*>(out);
      if (full) {
        *reinterpret_cast<float4*>(o + base) = make_float4(y[0], y[1], y[2],
                                                           y[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (base + k < n) o[base + k] = y[k];
      }
    }
  }
}

inline int grid_for(long long rows) {
  long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" {

int ckpt_codec_lane() { return kLane; }

// x: n fp32 elements (16-byte aligned); q: [R, 128] int8 (16-byte aligned);
// scales: [R] fp32, R = ceil(n / 128).  Returns a cudaError_t (0 = launched).
int ckpt_quantize_launch(const float* x, long long n, int8_t* q,
                         float* scales, cudaStream_t stream) {
  const long long rows = (n + kLane - 1) / kLane;
  if (rows == 0) return 0;
  quantize_rows<<<grid_for(rows), kThreads, 0, stream>>>(x, n, rows, q,
                                                         scales);
  return (int)cudaGetLastError();
}

// q: [R, 128] int8; scales: [R] fp32; out: n elements of fp32 (out_bf16 = 0)
// or bf16 (out_bf16 = 1), 16-byte aligned, R = ceil(n / 128).
int ckpt_dequantize_launch(const int8_t* q, const float* scales, long long n,
                           void* out, int out_bf16, cudaStream_t stream) {
  const long long rows = (n + kLane - 1) / kLane;
  if (rows == 0) return 0;
  if (out_bf16)
    dequantize_rows<true><<<grid_for(rows), kThreads, 0, stream>>>(
        q, scales, n, rows, out);
  else
    dequantize_rows<false><<<grid_for(rows), kThreads, 0, stream>>>(
        q, scales, n, rows, out);
  return (int)cudaGetLastError();
}

const char* ckpt_codec_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
