// Chunkwise-parallel mLSTM (xLSTM matrix memory) for Hopper (sm_90a), with
// a plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/mlstm_scan/kernel.py:46
// (_mlstm_kernel, launched by mlstm_scan at :127 through the pallas_call at
// :145, behind ops.py:14 mlstm_chunked).  It computes the same function,
// from a zero state (C = n = 0, m = -1e30, the TPU kernel's _init), for each
// (batch * head) and each chunk of L steps (the last one ragged):
//
//   b_t = sum_{u<=t} lf_u,      g_i = max(m0, max_{t<=i} (li_t - b_t)),
//   m_i = b_i + g_i,            D[i,t] = exp(li_t - b_t - g_i) for t <= i,
//   W = (Q K^T) . D,            inter_i = exp(m0 - g_i),
//   h_i = (W V + inter_i Q C0^T)_i / max(|q_i . n_i|, exp(-m_i)),
//   with q_i . n_i = sum_t W[i,t] + inter_i (q_i . n0),
//
// then carries C <- exp(m0 - g_L) C + sum_t exp(li_t - b_t - g_L) v_t k_t^T,
// n likewise with k_t, m0 <- m_L.  The TPU kernel pads the ragged tail with
// lf = 0, li = -1e30, k = v = 0 (kernel.py:66-70), which leaves b, g, m and
// the carry exactly as the valid steps alone give them; this kernel runs
// the valid steps only.  q . n_i is the row sum of W plus the carried term:
// the same sum as q . (D K + inter n0) in another order.  All fp32.
//
// Layout: q, k, v, h [BH, S, dh]; lf, li [BH, S]; C [BH, dh(v), dh(k)]; n
// [BH, dh]; m [BH]; contiguous, fp32, chunk <= 256, dh <= 1024.
//
// Design: the TPU kernel keeps the [dh, dh] C in VMEM across a sequential
// chunk axis; at xlstm-350m (dh = 512) C is 1 MiB per head, beyond a block's
// 227 KB of shared memory.  So the grid is (BH, dh / 64): each block owns 64
// rows (value dims) of C, kept in the output buffer (global memory; all of
// C is 16 MiB at xlstm-350m's prefill, inside the 50 MB L2), walks the
// chunks in order, and recomputes the chunk's gates and Q K^T, which need
// all of dk.  The products are 64 x 64 tiles on CUDA cores, 256 threads
// each holding a 4 x 4 register block (rows ty + 16 r, columns tx + 16 c),
// operands staged in shared memory as [depth][64 + 1]; Q K^T visits only
// the tiles on or below the diagonal.
//
// Bound on the H100 at xlstm-350m's prefill (BH = 16, S = 2,048, dh = 512,
// chunk 256), counted once per function, not per block: Q K^T and W V over
// the 32,896 causal pairs of a chunk (2 x 2 x 32,896 x 512 FLOP), the carry
// V^T K (2 x 256 x 512 x 512) and, from the second chunk on (C0 = 0 before
// it), Q C0^T (the same again): 4.09e10 FLOP in all, 0.61 ms at the
// 67 TFLOP/s fp32 rate of the CUDA cores (the function is fp32; the tensor
// cores' TF32 is not).  Bytes: q, k, v, h 268 MB and C 17 MB, 0.085 ms at
// 3.35 TB/s.  Bound by operations.  The recomputation multiplies Q K^T by
// dh / 64 = 8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // 16 x 16
constexpr int kTile = 64;        // rows and columns of a product tile
constexpr int kPad = kTile + 1;  // row pitch of a staged operand
constexpr int kDepth = 32;       // depth of one staged step over dh
constexpr int kMaxChunk = 256;
constexpr int kMaxDh = 1024;
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dst[e][r] = src[r * stride + e] for r < rows, e < depth (zeros past the
// valid rows): a tile of rows read along their contiguous axis.
__device__ __forceinline__ void load_t(float (*dst)[kPad],
                                       const float* __restrict__ src,
                                       int stride, int rows, int depth) {
  for (int idx = threadIdx.x; idx < kTile * depth; idx += kThreads) {
    const int r = idx / depth;
    const int e = idx - r * depth;
    dst[e][r] = r < rows ? src[(long long)r * stride + e] : 0.0f;
  }
}

// dst[e][c] = src[e * stride + c] * (scale ? scale[e] : 1) for e < depth,
// c < 64 (zeros past cols): rows of a matrix as the depth axis.
__device__ __forceinline__ void load_n(float (*dst)[kPad],
                                       const float* __restrict__ src,
                                       int stride, int depth, int cols,
                                       const float* scale) {
  for (int idx = threadIdx.x; idx < depth * kTile; idx += kThreads) {
    const int e = idx / kTile;
    const int c = idx - e * kTile;
    float val = c < cols ? src[(long long)e * stride + c] : 0.0f;
    if (scale != nullptr) val *= scale[e];
    dst[e][c] = val;
  }
}

// acc[r][c] += sum_{e < depth} a[e][ty + 16 r] * b[e][tx + 16 c]
__device__ __forceinline__ void mma_tile(float acc[4][4],
                                         const float (*a)[kPad],
                                         const float (*b)[kPad], int depth,
                                         int ty, int tx) {
#pragma unroll 4
  for (int e = 0; e < depth; ++e) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a[e][ty + 16 * r];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = b[e][tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
}

__global__ void __launch_bounds__(kThreads)
mlstm_scan_fwd(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ lf,
               const float* __restrict__ li, float* __restrict__ h,
               float* cst, float* __restrict__ n_out,
               float* __restrict__ m_out, int s, int dh, int chunk) {
  __shared__ float as[kTile][kPad];
  __shared__ float bs[kTile][kPad];
  __shared__ float gb[kMaxChunk];   // b: inclusive cumsum of lf
  __shared__ float ga[kMaxChunk];   // li - b, then the carry weights
  __shared__ float gg[kMaxChunk];   // g
  __shared__ float ns[kMaxDh];      // n over all of dk

  const int bh = blockIdx.x;
  const int v0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int dv = min(kTile, dh - v0);        // this block's rows of C
  const long long base = (long long)bh * s * dh;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  float* hb = h + base;
  const float* lfb = lf + (long long)bh * s;
  const float* lib = li + (long long)bh * s;
  float* cb = cst + (long long)bh * dh * dh + (long long)v0 * dh;

  for (int e = tid; e < dv * dh; e += kThreads) cb[e] = 0.0f;
  for (int e = tid; e < dh; e += kThreads) ns[e] = 0.0f;
  float m0 = kNegBig;
  __syncthreads();

  for (int cs = 0; cs < s; cs += chunk) {
    const int len = min(chunk, s - cs);
    if (tid == 0) {            // the gates, in order (every block alike)
      float run_b = 0.0f, run_max = kNegBig;
      for (int t = 0; t < len; ++t) {
        run_b += lfb[cs + t];
        const float a = lib[cs + t] - run_b;
        run_max = fmaxf(run_max, a);
        gb[t] = run_b;
        ga[t] = a;
        gg[t] = fmaxf(m0, run_max);
      }
    }
    __syncthreads();
    const float g_last = gg[len - 1];
    const float m_new = gb[len - 1] + g_last;
    const float* qc = qb + (long long)cs * dh;
    const float* kc = kb + (long long)cs * dh;
    const float* vc = vb + (long long)cs * dh;

    // ---- the chunk's outputs, 64 rows at a time ----
    for (int i0 = 0; i0 < len; i0 += kTile) {
      const int rows = min(kTile, len - i0);
      float acc[4][4], wsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      zero(acc);
      // the key tiles on or below the diagonal
      for (int t0 = 0; t0 <= i0; t0 += kTile) {
        const int cols = min(kTile, len - t0);
        float sc[4][4];
        zero(sc);
        for (int d0 = 0; d0 < dh; d0 += kDepth) {
          const int depth = min(kDepth, dh - d0);
          load_t(as, qc + (long long)i0 * dh + d0, dh, rows, depth);
          load_t(bs, kc + (long long)t0 * dh + d0, dh, cols, depth);
          __syncthreads();
          mma_tile(sc, as, bs, depth, ty, tx);
          __syncthreads();
        }
        // W = S . D on the causal triangle, into as[t][i]
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int t = t0 + tx + 16 * c;
            const float w = (t <= i && i < len)
                                ? sc[r][c] * expf(ga[t] - gg[i])
                                : 0.0f;
            wsum[r] += w;
            as[tx + 16 * c][ty + 16 * r] = w;
          }
        }
        load_n(bs, vc + (long long)t0 * dh + v0, dh, cols, dv, nullptr);
        __syncthreads();
        mma_tile(acc, as, bs, cols, ty, tx);
        __syncthreads();
      }
      // the carried state: Q C0^T and q . n0
      float qcz[4][4], qn0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      zero(qcz);
      for (int d0 = 0; d0 < dh; d0 += kDepth) {
        const int depth = min(kDepth, dh - d0);
        load_t(as, qc + (long long)i0 * dh + d0, dh, rows, depth);
        load_t(bs, cb + d0, dh, dv, depth);       // bs[e][v] = C[v0+v][d0+e]
        __syncthreads();
        mma_tile(qcz, as, bs, depth, ty, tx);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          for (int e = tx; e < depth; e += 16)
            qn0[r] = fmaf(as[e][ty + 16 * r], ns[d0 + e], qn0[r]);
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ws = sum16(wsum[r]);
        const float qn0s = sum16(qn0[r]);
        const int i = i0 + ty + 16 * r;
        if (i < len) {
          const float inter = expf(m0 - gg[i]);
          const float m_i = gb[i] + gg[i];
          const float qn = ws + inter * qn0s;
          const float denom = fmaxf(fabsf(qn), expf(-m_i));
          float* hrow = hb + (long long)(cs + i) * dh + v0;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = tx + 16 * c;
            if (col < dv) hrow[col] = (acc[r][c] + qcz[r][c] * inter) / denom;
          }
        }
      }
    }

    // ---- the carry ----
    const float decay = expf(m0 - g_last);
    for (int t = tid; t < len; t += kThreads) ga[t] = expf(ga[t] - g_last);
    __syncthreads();
    for (int d0 = 0; d0 < dh; d0 += kTile) {
      const int dcols = min(kTile, dh - d0);
      float cc[4][4];
      zero(cc);
      for (int t0 = 0; t0 < len; t0 += kTile) {
        const int depth = min(kTile, len - t0);
        load_n(as, vc + (long long)t0 * dh + v0, dh, depth, dv, ga + t0);
        load_n(bs, kc + (long long)t0 * dh + d0, dh, depth, dcols, nullptr);
        __syncthreads();
        mma_tile(cc, as, bs, depth, ty, tx);
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tx + 16 * c;
          if (row < dv && col < dcols) {
            float* p = cb + (long long)row * dh + d0 + col;
            *p = *p * decay + cc[r][c];
          }
        }
      }
    }
    for (int d = tid; d < dh; d += kThreads) {
      float acc = 0.0f;
      for (int t = 0; t < len; ++t)
        acc = fmaf(kc[(long long)t * dh + d], ga[t], acc);
      ns[d] = ns[d] * decay + acc;
    }
    m0 = m_new;
    __syncthreads();   // C, n and the gate arrays before the next chunk
  }

  if (blockIdx.y == 0) {
    for (int d = tid; d < dh; d += kThreads)
      n_out[(long long)bh * dh + d] = ns[d];
    if (tid == 0) m_out[bh] = m0;
  }
}

}  // namespace

extern "C" {

void mlstm_scan_limits(int* max_chunk, int* max_dh) {
  *max_chunk = kMaxChunk;
  *max_dh = kMaxDh;
}

// Returns a cudaError_t (0 = launched).
int mlstm_scan_launch(const void* q, const void* k, const void* v,
                      const void* lf, const void* li, void* h, void* c,
                      void* n, void* m, int bh, int s, int dh, int chunk,
                      void* stream) {
  if (bh <= 0 || s <= 0 || dh <= 0 || dh > kMaxDh || chunk <= 0 ||
      chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)bh, (unsigned)((dh + kTile - 1) / kTile));
  mlstm_scan_fwd<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lf),
      static_cast<const float*>(li), static_cast<float*>(h),
      static_cast<float*>(c), static_cast<float*>(n), static_cast<float*>(m),
      s, dh, chunk);
  return (int)cudaGetLastError();
}

const char* mlstm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
