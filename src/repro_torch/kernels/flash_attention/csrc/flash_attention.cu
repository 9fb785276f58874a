// Flash-attention forward for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:34
// (_fwd_kernel, launched by flash_attention_fwd at :110 through the
// pallas_call at :138, behind ops.py:35 flash_attention).  It computes the
// same function, not the same blocks: per (batch * query head, query row)
//
//   s[j]  = (q_i . k_j) * sm_scale, fp32 products of the inputs as fp32;
//   s[j]  = -1e30 where key j is not visible to row i;
//   out_i = sum_j exp(s[j] - m) v_j / max(sum_j exp(s[j] - m), 1e-30),
//
// as an online softmax over key tiles with running m, l and acc in fp32,
// cast to q's dtype at the end.  Visibility takes the row and column index
// as positions (top-left aligned when Sq != Skv): j < Skv, j <= i when
// causal, and i - j < window or j < n_meta when window > 0.  GQA: the block
// for query head bh = b * Hq + h reads kv head bh / group.  A key tile with
// no visible (row, key) pair in the block is skipped, as the TPU kernel
// skips its fully masked blocks; V rows past Skv read as 0.  A row with no
// visible key at all is as undefined here as in the TPU kernel.
//
// Layout: q [B, Sq, Hq, d], k and v [B, Skv, Hkv, d], out [B, Sq, Hq, d],
// contiguous (the model's layout: no transposed copies), fp32 or bf16,
// any d <= 128 (no padding of d: the 128-lane padding was the TPU's).
//
// Bound on the H100 at the serving shape (B=4, S=2048, Hq=16, Hkv=8,
// d=128, causal, bf16): 2,098,176 visible pairs per head x 64 heads x 4d
// = 6.875e10 FLOP per launch, 0.0695 ms at the bf16 tensor-core peak of
// 989 TFLOP/s, against 100,663,296 bytes (0.030 ms at 3.35 TB/s): bound by
// operations.
//
// The design is the simple one that is right, on CUDA cores: one block of
// 256 threads per (bh, 64 query rows), the Q tile and one K-then-V tile in
// shared memory as fp32 (rows padded to d + 1 floats, so that the 16 lanes
// reading 16 different rows of a tile hit 16 banks), the 64 x 64 score
// tile as a 4 x 4 register block per thread, row max and row sum by
// __shfl_xor_sync over the 16 threads that share a row, P through shared
// memory into a 4 x 8 register block of acc per thread.  Query tiles are
// issued heaviest first (the last causal tiles see the most keys).  It
// does its ~3.4e10 FMA per launch at the CUDA-core rate (67 TFLOP/s fp32),
// so it cannot come near the tensor-core bound.
//
// For the PR that makes it fast: bf16 x bf16 products are exact in fp32, so
// mma/wgmma with fp32 accumulation computes the same Q.K^T.  P.V with P
// rounded to bf16 would not be this function (the TPU kernel multiplies
// fp32 P by fp32 V): a faster P.V has to keep P's fp32 precision, for
// example as a bf16 hi/lo split of P whose remaining error is measured.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;          // query rows per block
constexpr int kBlockK = 64;          // keys per tile
constexpr int kThreads = 256;        // 16 x 16 threads
constexpr int kMaxD = 128;
constexpr int kRows = 4;             // score/acc rows per thread
constexpr int kCols = 4;             // score columns per thread
constexpr int kAccCols = kMaxD / 16; // acc columns per thread (d <= 128)
constexpr int kPLd = kBlockK + 1;    // padded row of the P tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as a torch cast
}

__device__ __forceinline__ bool is_visible(int i, int j, int skv, int causal,
                                           int window, int n_meta) {
  bool vis = j < skv;
  if (causal) vis = vis && (j <= i);
  if (window > 0) {
    bool in_win = (i - j) < window;
    if (n_meta > 0) in_win = in_win || (j < n_meta);
    vis = vis && in_win;
  }
  return vis;
}

// Reduce over the 16 lanes that hold one row (lanes 0-15 and 16-31 of a
// warp are two row groups; xor offsets below 16 stay in the half).
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Copy a tile of 64 rows of d elements (row r at base + r * row_stride)
// into fp32 shared memory of row pitch ld; rows past `valid` are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ld,
                                          const T* __restrict__ base,
                                          long long row_stride, int valid,
                                          int d) {
  const int n = kBlockK * d;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / d;
    const int c = e - r * d;
    dst[r * ld + c] = r < valid ? to_f32(base[(long long)r * row_stride + c])
                                : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int n_bh, int n_qb,
          int sq, int skv, int hq, int hkv, int d, float sm_scale,
          int causal, int window, int n_meta) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;                          // [64][ld]
  float* kvs = qs + kBlockQ * ld;            // [64][ld], K then V
  float* ps = kvs + kBlockK * ld;            // [64][kPLd]

  // heaviest query tiles first: block L takes tile n_qb - 1 - L / n_bh
  const int bh = blockIdx.x % n_bh;
  const int qb = n_qb - 1 - blockIdx.x / n_bh;
  const int group = hq / hkv;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int kvbh = bh / group;               // = b * hkv + h / group
  const int kvh = kvbh - b * hkv;
  const int q0 = qb * kBlockQ;
  const int q_valid = min(kBlockQ, sq - q0);

  const long long q_stride = (long long)hq * d;   // between rows of S
  const long long kv_stride = (long long)hkv * d;
  const T* qbase = q + ((long long)b * sq + q0) * q_stride + (long long)h * d;
  const T* kbase = k + (long long)b * skv * kv_stride + (long long)kvh * d;
  const T* vbase = v + (long long)b * skv * kv_stride + (long long)kvh * d;

  const int tx = threadIdx.x & 15;           // column slot
  const int ty = threadIdx.x >> 4;           // row group: rows ty*4 .. +3

  load_tile(qs, ld, qbase, q_stride, q_valid, d);

  float m[kRows], l[kRows], acc[kRows][kAccCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) acc[r][c] = 0.0f;
  }

  const int n_kb = (skv + kBlockK - 1) / kBlockK;
  const int q_last = q0 + q_valid - 1;
  // under a causal mask no key past the block's last row is visible
  const int kb_end = causal ? min(n_kb, q_last / kBlockK + 1) : n_kb;

  for (int kb = 0; kb < kb_end; ++kb) {
    const int k0 = kb * kBlockK;
    const int k_valid = min(kBlockK, skv - k0);

    // does any (row, key) pair of this tile see each other?
    bool any = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int il = ty * kRows + r;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int jl = tx + 16 * c;
        any |= il < q_valid &&
               is_visible(q0 + il, k0 + jl, skv, causal, window, n_meta);
      }
    }
    if (!__syncthreads_or(any)) continue;   // also fences the last tile

    load_tile(kvs, ld, kbase + (long long)k0 * kv_stride, kv_stride, k_valid,
              d);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = 0.0f;
    const float* qrow = qs + (ty * kRows) * ld;
    const float* krow = kvs + tx * ld;
#pragma unroll 4
    for (int e = 0; e < d; ++e) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = qrow[r * ld + e];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = krow[16 * c * ld + e];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

    float corr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = q0 + ty * kRows + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = k0 + tx + 16 * c;
        s[r][c] = is_visible(i, j, skv, causal, window, n_meta)
                      ? s[r][c] * sm_scale
                      : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max16(mx));
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = expf(s[r][c] - m_new);
        ps[(ty * kRows + r) * kPLd + tx + 16 * c] = p;
        sum += p;
      }
      corr[r] = expf(m[r] - m_new);
      l[r] = l[r] * corr[r] + row_sum16(sum);
      m[r] = m_new;
    }
    __syncthreads();                         // K read; P written

    load_tile(kvs, ld, vbase + (long long)k0 * kv_stride, kv_stride, k_valid,
              d);
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kAccCols; ++c) acc[r][c] *= corr[r];
    const float* prow = ps + (ty * kRows) * kPLd;
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pv[r] = prow[r * kPLd + j];
      const float* vrow = kvs + j * ld;
#pragma unroll
      for (int c = 0; c < kAccCols; ++c) {
        const int col = tx + 16 * c;
        if (col < d) {
          const float vv = vrow[col];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r][c] = fmaf(pv[r], vv, acc[r][c]);
        }
      }
    }
  }

  T* obase = out + ((long long)b * sq + q0) * q_stride + (long long)h * d;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int il = ty * kRows + r;
    if (il >= q_valid) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d)
        from_f32(obase + (long long)il * q_stride + col, acc[r][c] * inv);
    }
  }
}

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)(kBlockQ + kBlockK) * (d + 1) +
                          (size_t)kBlockQ * kPLd);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int hq, int hkv, int d, float sm_scale, int causal,
           int window, int n_meta, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory needs the opt-in (per device)
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxD));
  if (err != cudaSuccess) return (int)err;
  const int n_bh = b * hq;
  const int n_qb = (sq + kBlockQ - 1) / kBlockQ;
  flash_fwd<T><<<(unsigned)((long long)n_bh * n_qb), kThreads, smem_bytes(d),
                 stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n_bh, n_qb, sq, skv, hq,
      hkv, d, sm_scale, causal, window, n_meta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_attention_max_head_dim() { return kMaxD; }

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* out, int dtype, int b, int sq, int skv,
                               int hq, int hkv, int d, float sm_scale,
                               int causal, int window, int n_meta,
                               void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 || d <= 0 ||
      d > kMaxD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, b, sq, skv, hq, hkv, d, sm_scale,
                         causal, window, n_meta, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, b, sq, skv, hq, hkv, d,
                                 sm_scale, causal, window, n_meta, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
