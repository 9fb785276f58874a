// Chunkwise-parallel mLSTM (xLSTM matrix memory) for Hopper (sm_90a), with
// a plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/mlstm_scan/kernel.py:46
// (_mlstm_kernel, launched by mlstm_scan at :127 through the pallas_call at
// :145, behind ops.py:14 mlstm_chunked), and takes the carried state that
// kernel lacks.  From (C0, n0, m0) (or the TPU kernel's _init, C = n = 0,
// m = -1e30, when none is given), for each (batch * head) and each chunk
// of L steps (the last one ragged):
//
//   b_t = sum_{u<=t} lf_u,      g_i = max(m0, max_{t<=i} (li_t - b_t)),
//   m_i = b_i + g_i,            D[i,t] = exp(li_t - b_t - g_i) for t <= i,
//   W = (Q K^T) . D,            inter_i = exp(m0 - g_i),
//   h_i = (W V + inter_i Q C0^T)_i / max(|q_i . n_i|, exp(-m_i)),
//   with q_i . n_i = sum_t W[i,t] + inter_i (q_i . n0),
//
// then carries C <- exp(m0 - g_L) C + sum_t exp(li_t - b_t - g_L) v_t k_t^T,
// n likewise with k_t, m0 <- m_L: the reference model's chunk function
// (src/repro/models/xlstm.py:87 _mlstm_chunk) looped as its mlstm_forward
// loops it (:134).  The reference pads the ragged tail with lf = 0,
// li = -1e30, k = v = 0 (:168-173), which leaves b, g, m and the carry
// exactly as the valid steps alone give them; this kernel runs the valid
// steps only.  q . n_i is the row sum of W plus the carried term: the same
// sum as q . (D K + inter n0) in another order.  All fp32.
//
// Layout: q, k, v, h [BH, S, dh]; lf, li [BH, S]; C [BH, dh(v), dh(k)]; n
// [BH, dh]; m [BH]; contiguous, fp32, chunk <= 256, dh <= 1024, S >= 1.
//
// Design.  Only the carried state (C, n, m) crosses chunks: every chunk's
// outputs depend on the state at its start alone.  So one call is three
// grids on the caller's stream:
//   (a) mlstm_gates, one block per head: b = cumsum(lf) and
//       cummax(li - b) of each chunk as block-wide parallel prefixes
//       (warp shuffles, then the warps' totals), g, and m at every chunk
//       boundary; into a scratch of 3 x [BH, S] and [BH, chunks + 1].
//   (b) mlstm_carry, one CTA (two warpgroups, 64 rows each) per
//       [128 x 128] tile of C per head, (dh / 128)^2 x BH CTAs (256 at
//       xlstm-350m's prefill): the tile stays in wgmma accumulators while
//       the CTA walks the chunks, scaled by exp(m0 - g_L) and added
//       (V . w)^T K; it writes the state at every chunk boundary (the
//       wrapper's scratch) and the final one.  The CTAs of the first value
//       tile also carry n.  A tile depends only on the same tile of the
//       last state, so any tiling is exact; 128 wide reads each slice of
//       K and V from L2 dh / 128 times where 64 wide read it dh / 64
//       times, and was the faster on the H100.
//   (c) mlstm_out, one CTA (two warpgroups) per (head, chunk, 64 rows, 256
//       values), in parallel over all chunks: S = Q K^T on the key tiles on
//       or below the diagonal (each warpgroup 32 of the 64 keys), W = S . D
//       into shared memory, W V and then diag(inter) Q C0^T into one
//       accumulator (each warpgroup 128 of the 256 values), the row sums
//       of W and inter (q . n0) beside them.  Q K^T is computed once per
//       256 values: ceil(dh / 256) times in all, 2 at dh = 512 (8 before).
// Every product runs on the tensor cores as wgmma m64nNk8 .tf32 in
// error-compensated 3xTF32: a = a_hi + a_lo with a_hi = tf32(a), a_lo =
// tf32(a - a_hi), and a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, all
// accumulated in fp32 (about 2^-21 of each product, against TF32's 2^-11:
// the function stays fp32).  wgmma takes tf32 operands K-major only, and
// the products over time (W V and the carry) contract over rows of V and
// K, so the threads that stage them store them transposed (t contiguous);
// Q, K and C are K-major as stored.  Every tile is staged by threads: fp32
// loads from global memory into registers, the hi/lo split there, two
// stores into 128-byte-swizzled tiles (hopper.cuh); the next stage's loads
// are issued before the current stage's wgmmas are waited for, and V^T's
// before W is computed.  A stage is 64 deep (two 32-value chunks) where
// registers allow it: the carry's 64 steps, Q K^T's 64 of dk; W V and
// Q C0^T stage 32.  Staging and L2 reads, not the tensor cores, bound both
// grids (PERF.md).
//
// Bound on the H100 at xlstm-350m's prefill (BH = 16, S = 2,048, dh = 512,
// chunk 256), counted once per function: Q K^T and W V over the 32,896
// causal pairs of a chunk (2 x 2 x 32,896 x 512 FLOP), the carry V^T K
// (2 x 256 x 512 x 512) and, from the second chunk on (or from the first
// when a state is given), Q C0^T (the same again): 4.09e10 FLOP from the
// zero state, 0.61 ms at the 67 TFLOP/s fp32 rate of the CUDA cores.  This
// design's floor: 3 x 4.09e10 FLOP at 495 TFLOP/s (TF32) = 0.25 ms.
// Bytes: q, k, v, h 268 MB and C 17 MB, 0.085 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../hopper.cuh"

namespace {

constexpr int kTile = 64;                 // rows of a product tile
constexpr int kChunkBytes = kTile * 128;  // 64 rows x 32 four-byte values
constexpr int kMaxChunk = 256;
constexpr int kMaxDh = 1024;
constexpr float kNegBig = -1e30f;
constexpr int kCarryThreads = 256;        // two warpgroups
constexpr int kCarryTile = 128;           // rows and columns of C a CTA
constexpr int kOutThreads = 256;          // two warpgroups
constexpr int kSlice = 256;               // values per mlstm_out CTA
// mlstm_out's shared tiles, offsets from a 1,024-byte boundary
constexpr int kOffQ = 0;                  // Q hi, lo: 2 x 2 chunks
constexpr int kOffK = 4 * kChunkBytes;    // K hi, lo: 2 x 2 chunks
constexpr int kOffW = 8 * kChunkBytes;    // W hi, lo: 2 x 2 chunks
constexpr int kOffB = 12 * kChunkBytes;   // V^T or C hi, lo: 2 x 32 KB
constexpr int kOutSmem = kOffB + 2 * kSlice * 128 + 1024;
constexpr int kCarrySmem = 8 * kCarryTile * 128 + 1024;

// Row and column of accumulator element e of a thread in its warpgroup
// (hopper.cuh: warp w holds rows 16w + lane / 4 (+ 8); 8-column block
// e / 4 holds columns 2 (lane % 4) (+ 1)).
__device__ __forceinline__ int frag_row(int e) {
  const int t = threadIdx.x % 128;
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((e % 4) / 2);
}
__device__ __forceinline__ int frag_col(int e) {
  return 8 * (e / 4) + 2 * (threadIdx.x % 4) + (e % 2);
}

__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return hopper::sw128_desc(addr, 16, 1024);
}

// Four values along the contraction dim, split into hi and lo, into unit u
// of row r of the hi and lo tiles.
__device__ __forceinline__ void put4(uint8_t* hi, uint8_t* lo, int r, int u,
                                     float4 x) {
  uint4 a, b;
  hopper::split_tf32(x.x, a.x, b.x);
  hopper::split_tf32(x.y, a.y, b.y);
  hopper::split_tf32(x.z, a.z, b.z);
  hopper::split_tf32(x.w, a.w, b.w);
  const uint32_t off = hopper::sw128_offset(r, u);
  *reinterpret_cast<uint4*>(hi + off) = a;
  *reinterpret_cast<uint4*>(lo + off) = b;
}

// src[row * ld + col + j] for j < 4, zeros past `rows` rows and `cols`
// columns; vec: one 16-byte load (cols and col multiples of 4).
__device__ __forceinline__ float4 ld_row4(const float* src, long long ld,
                                          int row, int rows, int col,
                                          int cols, bool vec) {
  float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row >= rows || col >= cols) return o;
  const float* p = src + (long long)row * ld + col;
  if (vec) return *reinterpret_cast<const float4*>(p);
  o.x = p[0];
  if (col + 1 < cols) o.y = p[1];
  if (col + 2 < cols) o.z = p[2];
  if (col + 3 < cols) o.w = p[3];
  return o;
}

// src[(t + j) * ld + col] for j < 4 (a column read down four rows, each
// read coalesced across the warp's columns), zeros past `ts` rows and
// `cols` columns.
__device__ __forceinline__ float4 ld_col4(const float* src, long long ld,
                                          int t, int ts, int col, int cols) {
  float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (col >= cols) return o;
  const float* p = src + (long long)t * ld + col;
  if (t < ts) o.x = p[0];
  if (t + 1 < ts) o.y = p[ld];
  if (t + 2 < ts) o.z = p[2 * ld];
  if (t + 3 < ts) o.w = p[3 * ld];
  return o;
}

template <int N>
__device__ __forceinline__ void mma3(float (&d)[N], uint32_t a_hi,
                                     uint32_t a_lo, uint32_t b_hi,
                                     uint32_t b_lo);

// d += A . B^T over one 32-deep chunk, 3xTF32: four k8 steps of three
// products each (the small terms first).
#define MLSTM_MMA3(NCOLS, NREG)                                             \
  template <>                                                               \
  __device__ __forceinline__ void mma3<NREG>(float (&d)[NREG],              \
                                             uint32_t a_hi, uint32_t a_lo,  \
                                             uint32_t b_hi, uint32_t b_lo) {\
    _Pragma("unroll") for (int kk = 0; kk < 4; ++kk) {                      \
      const uint32_t o = 32 * kk;                                           \
      hopper::wgmma_tf32_n##NCOLS(d, desc(a_lo + o), desc(b_hi + o), 1);    \
      hopper::wgmma_tf32_n##NCOLS(d, desc(a_hi + o), desc(b_lo + o), 1);    \
      hopper::wgmma_tf32_n##NCOLS(d, desc(a_hi + o), desc(b_hi + o), 1);    \
    }                                                                       \
  }
MLSTM_MMA3(32, 16)
MLSTM_MMA3(128, 64)
#undef MLSTM_MMA3

// ---------------------------------------------------------------------------
// (a) the gates
// ---------------------------------------------------------------------------

// Inclusive block-wide prefix of x (sum, or max when kMax) over the
// block's kMaxChunk threads: within each warp by shuffles, then the warps'
// totals by warp 0.  `part` is 8 floats of shared memory.
template <bool kMax>
__device__ __forceinline__ float block_scan(float x, float* part) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x = kMax ? fmaxf(x, y) : x + y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kMaxChunk / 32 ? part[lane] : 0.0f;
#pragma unroll
    for (int off = 1; off < kMaxChunk / 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w = kMax ? fmaxf(w, y) : w + y;
    }
    if (lane < kMaxChunk / 32) part[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x = kMax ? fmaxf(x, part[warp - 1]) : x + part[warp - 1];
  return x;
}

// gates [3][BH][S]: b, li - b, g; mst [BH][chunks + 1]: m at each chunk
// boundary (m0 first).
__global__ void __launch_bounds__(kMaxChunk)
mlstm_gates(const float* __restrict__ lf, const float* __restrict__ li,
            const float* __restrict__ m0, float* __restrict__ gates,
            float* __restrict__ mst, float* __restrict__ m_out, int bh_n,
            int s, int chunk, int nch) {
  __shared__ float psum[kMaxChunk / 32], pmax[kMaxChunk / 32];
  __shared__ float m_next;
  const int bh = blockIdx.x, tid = threadIdx.x;
  const long long row = (long long)bh * s;
  const long long plane = (long long)bh_n * s;
  float m = m0 != nullptr ? m0[bh] : kNegBig;
  if (tid == 0) mst[(long long)bh * (nch + 1)] = m;
  for (int kc = 0; kc < nch; ++kc) {
    const int t0 = kc * chunk;
    const int len = min(chunk, s - t0);
    const bool ok = tid < len;
    const long long at = row + t0 + tid;
    const float b = block_scan<false>(ok ? lf[at] : 0.0f, psum);
    const float a = ok ? li[at] - b : -INFINITY;
    const float g = fmaxf(m, block_scan<true>(a, pmax));
    if (ok) {
      gates[at] = b;
      gates[plane + at] = a;
      gates[2 * plane + at] = g;
    }
    if (tid == len - 1) m_next = b + g;
    __syncthreads();
    m = m_next;
    if (tid == 0) mst[(long long)bh * (nch + 1) + kc + 1] = m;
    __syncthreads();   // m_next is read before the next chunk writes it
  }
  if (tid == 0) m_out[bh] = m;
}

// ---------------------------------------------------------------------------
// (b) the carried state
// ---------------------------------------------------------------------------

// One [128 v x 128 k] tile of C (and, for the first value tile, n over
// the same 128 k) for one head, over every chunk in order: warpgroup w
// holds rows 64 w .. 64 w + 63 in its accumulators.  cs / ns hold the
// state at the start of chunks 1 .. nch - 1.
__global__ void __launch_bounds__(kCarryThreads, 1)
mlstm_carry(const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ gates, const float* __restrict__ mst,
            const float* __restrict__ c0, const float* __restrict__ n0,
            float* __restrict__ cs, float* __restrict__ ns,
            float* __restrict__ c_out, float* __restrict__ n_out, int bh_n,
            int s, int dh, int chunk, int nch) {
  extern __shared__ uint8_t dyn[];
  __shared__ float w_s[kMaxChunk];
  __shared__ float red[kCarryThreads];
  // A = (V . w)^T and B = K^T, 128 rows each, hi then lo, two 32-step
  // chunks each
  constexpr int kC = kCarryTile * 128;       // one chunk: 16 KB
  uint8_t* a_hi = hopper::align_1024(dyn);
  uint8_t* a_lo = a_hi + 2 * kC;
  uint8_t* b_hi = a_hi + 4 * kC;
  uint8_t* b_lo = a_hi + 6 * kC;
  const uint32_t sa = hopper::smem_u32(a_hi);

  const int k0 = blockIdx.x * kCarryTile, v0 = blockIdx.y * kCarryTile;
  const int bh = blockIdx.z, tid = threadIdx.x, wg = tid / 128;
  const bool own_n = blockIdx.y == 0;
  const long long row0 = (long long)bh * s;
  const float* kb = k + row0 * dh;
  const float* vb = v + row0 * dh;
  const float* ga = gates + (long long)bh_n * s + row0;
  const float* gg = gates + 2LL * bh_n * s + row0;
  const long long dd = (long long)dh * dh;
  const int vw = v0 + 64 * wg;               // this warpgroup's rows of C

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int r = vw + frag_row(e), c = k0 + frag_col(e);
    acc[e] = (c0 != nullptr && r < dh && c < dh)
                 ? c0[bh * dd + (long long)r * dh + c]
                 : 0.0f;
  }
  const int srow = tid % kCarryTile;
  float n_run = 0.0f;
  if (own_n && tid < kCarryTile && k0 + tid < dh && n0 != nullptr)
    n_run = n0[(long long)bh * dh + k0 + tid];

  // staging, 64 steps a stage: thread tid owns row tid % 128 of both
  // tiles (a value of A, a key of B) and units tid / 128 + 2 r of each
  // 32-step chunk
  for (int kc = 0; kc < nch; ++kc) {
    const int t0 = kc * chunk;
    const int len = min(chunk, s - t0);
    const float g_last = gg[t0 + len - 1];
    const float decay = expf(mst[(long long)bh * (nch + 1) + kc] - g_last);
    __syncthreads();   // w_s of the last chunk is no longer read
    for (int t = tid; t < len; t += kCarryThreads)
      w_s[t] = expf(ga[t0 + t] - g_last);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] *= decay;
    float n_part = 0.0f;
    const float* kc_p = kb + (long long)t0 * dh;
    const float* vc_p = vb + (long long)t0 * dh;
    const int nst = (len + 63) / 64;
    float4 ra[2][4], rb[2][4];   // [chunk][unit]
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = 32 * c + 4 * (tid / kCarryTile + 2 * r);
        ra[c][r] = ld_col4(vc_p, dh, t, len, v0 + srow, dh);
        rb[c][r] = ld_col4(kc_p, dh, t, len, k0 + srow, dh);
      }
    for (int st = 0; st < nst; ++st) {
      __syncthreads();   // the last stage's wgmmas are done with the tiles
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int u = tid / kCarryTile + 2 * r;
          const int t = 64 * st + 32 * c + 4 * u;
          // zeros past len: w_s there is stale, the loads gave 0
          const float w0 = t < len ? w_s[t] : 0.0f;
          const float w1 = t + 1 < len ? w_s[t + 1] : 0.0f;
          const float w2 = t + 2 < len ? w_s[t + 2] : 0.0f;
          const float w3 = t + 3 < len ? w_s[t + 3] : 0.0f;
          const float4 x = ra[c][r], y = rb[c][r];
          put4(a_hi + c * kC, a_lo + c * kC, srow, u,
               make_float4(x.x * w0, x.y * w1, x.z * w2, x.w * w3));
          put4(b_hi + c * kC, b_lo + c * kC, srow, u, y);
          if (own_n)
            n_part += y.x * w0 + y.y * w1 + y.z * w2 + y.w * w3;
        }
      hopper::fence_proxy_async();
      __syncthreads();
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      // this warpgroup's 64 rows of A against all 128 rows of B
#pragma unroll
      for (int c = 0; c < 2; ++c)
        mma3(acc, sa + c * kC + wg * kChunkBytes,
             sa + (2 + c) * kC + wg * kChunkBytes, sa + (4 + c) * kC,
             sa + (6 + c) * kC);
      hopper::wgmma_commit();
      if (st + 1 < nst) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int t =
                64 * (st + 1) + 32 * c + 4 * (tid / kCarryTile + 2 * r);
            ra[c][r] = ld_col4(vc_p, dh, t, len, v0 + srow, dh);
            rb[c][r] = ld_col4(kc_p, dh, t, len, k0 + srow, dh);
          }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }
    if (own_n) {
      red[tid] = n_part;
      __syncthreads();
      if (tid < kCarryTile)
        n_run = n_run * decay + (red[tid] + red[tid + kCarryTile]);
    }
    const bool last = kc + 1 == nch;
    float* dst = last ? c_out + bh * dd
                      : cs + ((long long)bh * (nch - 1) + kc) * dd;
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const int r = vw + frag_row(e), c = k0 + frag_col(e);
      if (r < dh && c < dh) dst[(long long)r * dh + c] = acc[e];
    }
    if (own_n && tid < kCarryTile && k0 + tid < dh) {
      float* nd = last ? n_out + (long long)bh * dh
                       : ns + ((long long)bh * (nch - 1) + kc) * dh;
      nd[k0 + tid] = n_run;
    }
  }
}

// ---------------------------------------------------------------------------
// (c) the outputs
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kOutThreads, 1)
mlstm_out(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ gates,
          const float* __restrict__ mst, const float* __restrict__ c0,
          const float* __restrict__ n0, const float* __restrict__ cs,
          const float* __restrict__ ns, float* __restrict__ h, int bh_n,
          int s, int dh, int chunk, int nch, int has_state, int vec) {
  extern __shared__ uint8_t dyn[];
  __shared__ float a_t[kMaxChunk];      // li - b over the chunk
  __shared__ float g_row[kTile], b_row[kTile], inter[kTile];
  __shared__ float rsum[2][kTile];      // row sums of W, per warpgroup
  __shared__ float qn_c[kTile];         // inter (q . n0)
  uint8_t* base = hopper::align_1024(dyn);
  const uint32_t sbase = hopper::smem_u32(base);
  uint8_t* q_hi = base + kOffQ;
  uint8_t* q_lo = q_hi + 2 * kChunkBytes;
  uint8_t* k_hi = base + kOffK;
  uint8_t* k_lo = k_hi + 2 * kChunkBytes;
  uint8_t* w_hi = base + kOffW;
  uint8_t* w_lo = w_hi + 2 * kChunkBytes;
  uint8_t* b_hi = base + kOffB;
  uint8_t* b_lo = b_hi + kSlice * 128;

  const int vs0 = blockIdx.x * kSlice;
  const int i0 = blockIdx.y * kTile;
  const int kc = blockIdx.z % nch, bh = blockIdx.z / nch;
  const int t_beg = kc * chunk;
  const int len = min(chunk, s - t_beg);
  if (i0 >= len) return;                // a row tile past a ragged chunk
  const int rows = min(kTile, len - i0);
  const int tid = threadIdx.x, wg = tid / 128;
  const long long row0 = (long long)bh * s + t_beg;
  const long long plane = (long long)bh_n * s;
  const float m0 = mst[(long long)bh * (nch + 1) + kc];
  for (int t = tid; t < min(len, i0 + kTile); t += kOutThreads)
    a_t[t] = gates[plane + row0 + t];
  if (tid < kTile) {
    const int i = i0 + tid;
    const bool ok = i < len;
    const float g = ok ? gates[2 * plane + row0 + i] : 0.0f;
    g_row[tid] = g;
    b_row[tid] = ok ? gates[row0 + i] : 0.0f;
    inter[tid] = ok ? expf(m0 - g) : 0.0f;
  }
  __syncthreads();

  const float* qi = q + (row0 + i0) * dh;    // this CTA's 64 query rows
  const float* kc_p = k + row0 * dh;
  const float* vc_p = v + row0 * dh;
  const int nd = (dh + 31) / 32;
  // Q and K staging: thread tid owns rows tid / 8 and tid / 8 + 32, unit
  // tid % 8 of each 32-wide chunk of dk; Q K^T stages two chunks (64 dk)
  const int qr = tid / 8, qu = tid % 8;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  float rs[2] = {0.0f, 0.0f};

  // ---- W V over the key tiles on or below the diagonal ----
  for (int t0 = 0; t0 <= i0; t0 += kTile) {
    const int keys = min(kTile, len - t0);
    const float* kt = kc_p + (long long)t0 * dh;
    float sacc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) sacc[e] = 0.0f;
    float4 rq[2][2], rk[2][2];   // [chunk][row]
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rq[c][r] = ld_row4(qi, dh, qr + 32 * r, rows, 32 * c + 4 * qu, dh,
                           vec);
        rk[c][r] = ld_row4(kt, dh, qr + 32 * r, keys, 32 * c + 4 * qu, dh,
                           vec);
      }
    for (int st = 0; st < (nd + 1) / 2; ++st) {
      __syncthreads();   // the last stage's wgmmas (both warpgroups) are done
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          put4(q_hi + c * kChunkBytes, q_lo + c * kChunkBytes, qr + 32 * r,
               qu, rq[c][r]);
          put4(k_hi + c * kChunkBytes, k_lo + c * kChunkBytes, qr + 32 * r,
               qu, rk[c][r]);
        }
      hopper::fence_proxy_async();
      __syncthreads();
      hopper::fence_regs(sacc);
      hopper::wgmma_fence();
      // this warpgroup's 32 keys: rows 32 wg of each K chunk (a chunk past
      // dh holds zeros)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        mma3(sacc, sbase + kOffQ + c * kChunkBytes,
             sbase + kOffQ + (2 + c) * kChunkBytes,
             sbase + kOffK + c * kChunkBytes + 4096 * wg,
             sbase + kOffK + (2 + c) * kChunkBytes + 4096 * wg);
      hopper::wgmma_commit();
      if (2 * st + 2 < nd) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d0 = 32 * (2 * st + 2 + c) + 4 * qu;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            rq[c][r] = ld_row4(qi, dh, qr + 32 * r, rows, d0, dh, vec);
            rk[c][r] = ld_row4(kt, dh, qr + 32 * r, keys, d0, dh, vec);
          }
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sacc);
    }
    // V^T of the key tile's first 32 steps, in flight under W: thread tid
    // owns value vs0 + tid and all eight units of the 32 steps
    float4 rv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      rv[u] = ld_col4(vc_p, dh, t0 + 4 * u, len, vs0 + tid, dh);
    // W = S . D on the causal triangle, into this warpgroup's chunk of the
    // W tile (its 32 keys); both warpgroups' W V wgmmas of the last key
    // tile finished before the stage barriers above
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int r = frag_row(e), c = frag_col(e);
      const int i = i0 + r, t = t0 + 32 * wg + c;
      const float w = (t <= i && i < len) ? sacc[e] * expf(a_t[t] - g_row[r])
                                          : 0.0f;
      rs[(e % 4) / 2] += w;
      uint32_t whi, wlo;
      hopper::split_tf32(w, whi, wlo);
      const uint32_t off =
          wg * kChunkBytes + hopper::sw128_offset(r, c / 4) + 4 * (c % 4);
      *reinterpret_cast<uint32_t*>(w_hi + off) = whi;
      *reinterpret_cast<uint32_t*>(w_lo + off) = wlo;
    }
    // the key tile's two 32-step chunks of V^T, the second in flight under
    // the first's wgmmas
    for (int c2 = 0; c2 < 2 && t0 + 32 * c2 < len; ++c2) {
      if (c2 > 0) __syncthreads();   // the first chunk's wgmmas are done
#pragma unroll
      for (int u = 0; u < 8; ++u) put4(b_hi, b_lo, tid, u, rv[u]);
      hopper::fence_proxy_async();
      __syncthreads();
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      mma3(acc, sbase + kOffW + c2 * kChunkBytes,
           sbase + kOffW + (2 + c2) * kChunkBytes,
           sbase + kOffB + wg * 128 * 128,
           sbase + kOffB + kSlice * 128 + wg * 128 * 128);
      hopper::wgmma_commit();
      if (c2 == 0 && t0 + 32 < len) {
#pragma unroll
        for (int u = 0; u < 8; ++u)
          rv[u] = ld_col4(vc_p, dh, t0 + 32 + 4 * u, len, vs0 + tid, dh);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }
  }

  // ---- the carried state: diag(inter) Q C0^T and inter (q . n0) ----
  float qn_part[2] = {0.0f, 0.0f};
  if (kc > 0 || has_state) {
    const long long dd = (long long)dh * dh;
    const float* cst = kc > 0 ? cs + ((long long)bh * (nch - 1) + kc - 1) * dd
                              : c0 + bh * dd;
    const float* nst = kc > 0 ? ns + ((long long)bh * (nch - 1) + kc - 1) * dh
                              : n0 + (long long)bh * dh;
    const float* cv = cst + (long long)vs0 * dh;   // rows vs0.. of C
    const int vals = dh - vs0;
    float4 rq[2], rc[8];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      rq[r] = ld_row4(qi, dh, qr + 32 * r, rows, 4 * qu, dh, vec);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      rc[r] = ld_row4(cv, dh, qr + 32 * r, vals, 4 * qu, dh, vec);
    for (int st = 0; st < nd; ++st) {
      __syncthreads();
      const int d0 = 32 * st + 4 * qu;
      const float4 nv = ld_row4(nst, 0, 0, 1, d0, dh, vec);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float sc = inter[qr + 32 * r];
        const float4 x = make_float4(rq[r].x * sc, rq[r].y * sc,
                                     rq[r].z * sc, rq[r].w * sc);
        qn_part[r] += x.x * nv.x + x.y * nv.y + x.z * nv.z + x.w * nv.w;
        put4(q_hi, q_lo, qr + 32 * r, qu, x);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) put4(b_hi, b_lo, qr + 32 * r, qu, rc[r]);
      hopper::fence_proxy_async();
      __syncthreads();
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      mma3(acc, sbase + kOffQ, sbase + kOffQ + 2 * kChunkBytes,
           sbase + kOffB + wg * 128 * 128,
           sbase + kOffB + kSlice * 128 + wg * 128 * 128);
      hopper::wgmma_commit();
      if (st + 1 < nd) {
        const int dn = 32 * (st + 1) + 4 * qu;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          rq[r] = ld_row4(qi, dh, qr + 32 * r, rows, dn, dh, vec);
#pragma unroll
        for (int r = 0; r < 8; ++r)
          rc[r] = ld_row4(cv, dh, qr + 32 * r, vals, dn, dh, vec);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }
  }
  // q . n over the 8 threads of a row, the row sums of W over a quad
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      qn_part[r] += __shfl_xor_sync(0xffffffffu, qn_part[r], off);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], off);
  }
  if (qu == 0) {
    qn_c[qr] = qn_part[0];
    qn_c[qr + 32] = qn_part[1];
  }
  if (tid % 4 == 0) {
    rsum[wg][frag_row(0)] = rs[0];
    rsum[wg][frag_row(2)] = rs[1];
  }
  __syncthreads();

#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int r = frag_row(e);
    const int col = vs0 + 128 * wg + frag_col(e);
    if (r < rows && col < dh) {
      const float qn = (rsum[0][r] + rsum[1][r]) + qn_c[r];
      const float denom = fmaxf(fabsf(qn), expf(-(b_row[r] + g_row[r])));
      h[(row0 + i0 + r) * dh + col] = acc[e] / denom;
    }
  }
}

}  // namespace

extern "C" {

void mlstm_scan_limits(int* max_chunk, int* max_dh) {
  *max_chunk = kMaxChunk;
  *max_dh = kMaxDh;
}

// One call: the three grids on `stream`.  c0, n0, m0 are the carried state
// or all null (the zero state).  Scratch from the wrapper: gates [3, BH, S],
// mst [BH, chunks + 1], cs [BH, chunks - 1, dh, dh] and ns [BH, chunks - 1,
// dh] (null for one chunk).  Returns a cudaError_t (0 = launched).
int mlstm_scan_launch(const void* q, const void* k, const void* v,
                      const void* lf, const void* li, const void* c0,
                      const void* n0, const void* m0, void* h, void* c,
                      void* n, void* m, void* gates, void* mst, void* cs,
                      void* ns, int bh, int s, int dh, int chunk,
                      void* stream) {
  if (bh <= 0 || s <= 0 || dh <= 0 || dh > kMaxDh || chunk <= 0 ||
      chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  const bool has_state = c0 != nullptr;
  if (has_state != (n0 != nullptr) || has_state != (m0 != nullptr))
    return (int)cudaErrorInvalidValue;
  const int nch = (s + chunk - 1) / chunk;
  if (nch > 1 && (cs == nullptr || ns == nullptr))
    return (int)cudaErrorInvalidValue;
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(c0) |
      reinterpret_cast<uintptr_t>(n0) | reinterpret_cast<uintptr_t>(cs) |
      reinterpret_cast<uintptr_t>(ns);
  const int vec = (any % 16 == 0 && dh % 4 == 0) ? 1 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fc0 = static_cast<const float*>(c0);
  const float* fn0 = static_cast<const float*>(n0);
  float* fgates = static_cast<float*>(gates);
  float* fmst = static_cast<float*>(mst);

  mlstm_gates<<<bh, kMaxChunk, 0, st>>>(
      static_cast<const float*>(lf), static_cast<const float*>(li),
      static_cast<const float*>(m0), fgates, fmst, static_cast<float*>(m),
      bh, s, chunk, nch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(mlstm_carry,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kCarrySmem);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((dh + kCarryTile - 1) / kCarryTile);
  mlstm_carry<<<dim3(tiles, tiles, (unsigned)bh), kCarryThreads, kCarrySmem,
                st>>>(static_cast<const float*>(k),
                      static_cast<const float*>(v), fgates, fmst, fc0, fn0,
                      static_cast<float*>(cs), static_cast<float*>(ns),
                      static_cast<float*>(c), static_cast<float*>(n), bh, s,
                      dh, chunk, nch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(mlstm_out,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kOutSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((dh + kSlice - 1) / kSlice),
                  (unsigned)((chunk + kTile - 1) / kTile),
                  (unsigned)(nch * bh));
  mlstm_out<<<grid, kOutThreads, kOutSmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), fgates, fmst, fc0, fn0,
      static_cast<const float*>(cs), static_cast<const float*>(ns),
      static_cast<float*>(h), bh, s, dh, chunk, nch, has_state ? 1 : 0,
      vec);
  return (int)cudaGetLastError();
}

const char* mlstm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
