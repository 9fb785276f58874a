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
// A second kernel, flash_fwd_wgmma below, takes the bf16 inputs with
// d % 16 == 0 on the tensor cores; the wrapper (ops.py) chooses between the
// two by that rule, and this SIMT kernel keeps fp32 and every other shape.
//
// flash_fwd_wgmma: the same function for bf16 q, k, v on the tensor cores.
// Q.K^T: bf16 x bf16 products are exact in fp32, so wgmma with fp32
// accumulators computes the same scores up to the order of the sums.  P.V:
// the TPU kernel multiplies fp32 P by V upcast to fp32; rounding P to bf16
// would change the function, so P is split as P_hi + P_lo, each bf16
// (P_hi = bf16(P), P_lo = bf16(P - P_hi)), and both go through wgmma
// against the same V tile into the same fp32 accumulator.  What the split
// leaves out is |P - P_hi - P_lo| <= 2^-17 |P| or so, far below the bf16
// output's own rounding (2^-9).  The split does 1.5x the algorithm's
// tensor-core work, so the kernel's floor at the serving shape is about
// 0.104 ms against the 0.0695 ms bound.
//
// Design (the usual Hopper shape): one CTA of 288 threads per
// (b * Hq + h, 128 query rows), heaviest tiles first.  Warp 8 is the
// producer: one lane loads the Q tile once, then keeps a ring of three
// stages of K and V tiles (64 keys x d, bf16) in flight by TMA, each stage
// behind its own full barriers (K and V apart, so Q.K^T starts before V
// lands) and one empty barrier.  Warpgroups 0 and 1 are the consumers, 64
// query rows each: S = Q.K^T as d/16 wgmma m64n64k16 from shared memory,
// the online softmax on the accumulator registers (row max and sum over
// the 4 lanes of a row, exp2 of log2-scaled scores), then P_hi and P_lo
// as register A operands of 2 x 4 wgmma m64n{d'}k16 against V read
// MN-major, fp32 O in registers, cast to bf16 and stored at the end.  The
// loop is software-pipelined by one tile: the S of tile t + 1 and the P.V
// of tile t are issued together, and the softmax of t + 1 runs while the
// P.V is on the tensor cores.  d' is d rounded up to 64 (the served 64
// and 128 exactly): TMA reads columns past d as zeros.  The tensor maps
// are 4-D over (d, H, S, B) of the model's layout, so no transposed copy
// exists; rows past Sq or Skv read as zeros, which makes V rows at or past
// Skv contribute exactly 0.  A key tile with no visible (row, key) pair in
// the CTA is skipped by producer and consumers alike, and the visibility
// test per element runs only on tiles that the mask cuts.  Shared memory:
// 128 KB at d' = 128 (Q 32 KB, three stages of K and V at 32 KB), 64 KB at
// d' = 64; one CTA per SM.
//
// What bounds it beside the tensor cores: the softmax and the hi/lo split
// are CUDA-core work of about ten instructions per score, and each CTA
// reads its kv head's K and V tiles from L2 (32 KB per 64 keys).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../hopper.cuh"

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


// ---------------------------------------------------------------------------
// flash_fwd_wgmma: bf16 on the tensor cores (see the header comment)
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 288;      // two consumer warpgroups + a producer
constexpr int kTcBlockQ = 128;       // query rows per CTA, 64 per warpgroup
constexpr int kTcBlockK = 64;        // keys per tile
constexpr int kTcStages = 3;         // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the CTA, in bytes from its 1,024-aligned base: the Q
// tile (DP / 64 chunks of 128 rows), then the K ring, then the V ring
// (DP / 64 chunks of 64 rows per stage).
template <int DP>
struct TcSmem {
  static constexpr int kChunks = DP / 64;
  static constexpr int kQChunk = kTcBlockQ * 128;
  static constexpr int kKVChunk = kTcBlockK * 128;
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKVBytes = kChunks * kKVChunk;   // one K or V tile
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kTcStages * kKVBytes;
  static constexpr int kBytes = kV + kTcStages * kKVBytes + 1024;
};

// Does any (row, key) pair of rows [i0, i1] and keys [j0, j1] see each
// other?  (The rectangle holds every difference i - j between i0 - j1 and
// i1 - j0.)
__device__ __forceinline__ bool tile_visible(int i0, int i1, int j0, int j1,
                                             int causal, int window,
                                             int n_meta) {
  if (causal && j0 > i1) return false;
  if (window <= 0) return true;
  if (n_meta > 0 && j0 < n_meta) return true;
  return i0 - j1 < window;
}

// The first key tile at or after kb with a visible pair in the CTA's rows
// [q0, q1], or n_kb: the producer and the consumers walk the same tiles.
__device__ __forceinline__ int next_tile(int kb, int n_kb, int q0, int q1,
                                         int skv, int causal, int window,
                                         int n_meta) {
  for (; kb < n_kb; ++kb) {
    const int j0 = kb * kTcBlockK;
    if (tile_visible(q0, q1, j0, min(j0 + kTcBlockK, skv) - 1, causal,
                     window, n_meta))
      break;
  }
  return kb;
}

// S = Q . K^T for a warpgroup's 64 rows: d' / 16 wgmma m64n64k16, both
// operands K-major in shared memory.
template <int DP>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q_addr,
                                         uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;   // 16 columns = 32 bytes
    hopper::wgmma_ss_n64<0>(
        sc,
        hopper::sw128_desc(q_addr + (kk / 4) * TcSmem<DP>::kQChunk + off, 16,
                           1024),
        hopper::sw128_desc(k_addr + (kk / 4) * TcSmem<DP>::kKVChunk + off,
                           16, 1024),
        kk > 0);
  }
}

// O += P_hi . V + P_lo . V, P from registers, V MN-major in shared memory.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&p_hi)[4][4],
                                         const uint32_t (&p_lo)[4][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = hopper::sw128_desc(v_addr + kk * 16 * 128,
                                           TcSmem<DP>::kKVChunk, 1024);
    if constexpr (DP == 128) {
      hopper::wgmma_rs_n128<1>(o, p_hi[kk], db, 1);
      hopper::wgmma_rs_n128<1>(o, p_lo[kk], db, 1);
    } else {
      hopper::wgmma_rs_n64<1>(o, p_hi[kk], db, 1);
      hopper::wgmma_rs_n64<1>(o, p_lo[kk], db, 1);
    }
  }
}

// The online softmax of one score tile, in place, in log2 units: sc
// becomes P = exp2(s * scale_log2 - m_new), with the scores of invisible
// pairs at -1e30 first; m becomes m_new (the row max of s * scale_log2),
// corr exp2(m_old - m_new), and l this thread's partial row sums,
// rescaled.  Rows row0 and row0 + 8; columns col0 + 8 (i / 4) + (i % 2).
// Only a tile that the mask cuts takes the per-element test (kMasked).
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[32], float (&m)[2], float (&l)[2], float (&corr)[2],
    int row0, int col0, float scale_log2, int skv, int causal, int window,
    int n_meta) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i % 4) / 2;
    if (kMasked && !is_visible(row0 + 8 * r, col0 + 8 * (i / 4) + (i % 2),
                               skv, causal, window, n_meta))
      sc[i] = kNegInf;
    mx[r] = fmaxf(mx[r], sc[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    corr[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i % 4) / 2;
    sc[i] = exp2f(fmaf(sc[i], scale_log2, -m[r]));
    l[r] += sc[i];
  }
}

// Does the mask cut key tile kb for rows [wi0, wi1]?
__device__ __forceinline__ bool tile_cut(int kb, int wi0, int wi1, int skv,
                                         int causal, int window) {
  const int j0 = kb * kTcBlockK;
  return !(j0 + kTcBlockK - 1 < skv &&
           (!causal || j0 + kTcBlockK - 1 <= wi0) &&
           (window <= 0 || wi1 - j0 < window));
}

__device__ __forceinline__ void softmax_any(
    float (&sc)[32], float (&m)[2], float (&l)[2], float (&corr)[2],
    int kb, int wi0, int wi1, int row0, int col_lane, float scale_log2,
    int skv, int causal, int window, int n_meta) {
  const int col0 = kb * kTcBlockK + col_lane;
  if (tile_cut(kb, wi0, wi1, skv, causal, window))
    softmax_tile<true>(sc, m, l, corr, row0, col0, scale_log2, skv, causal,
                       window, n_meta);
  else
    softmax_tile<false>(sc, m, l, corr, row0, col0, scale_log2, skv, causal,
                        window, n_meta);
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ out, int n_bh, int n_qb, int sq,
                int skv, int hq, int hkv, int d, float scale_log2,
                int causal, int window, int n_meta) {
  using L = TcSmem<DP>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_k[kTcStages];
  __shared__ __align__(8) uint64_t bar_v[kTcStages];
  __shared__ __align__(8) uint64_t bar_empty[kTcStages];
  uint8_t* smem = hopper::align_1024(smem_raw);

  // heaviest query tiles first: block L takes tile n_qb - 1 - L / n_bh
  const int bh = blockIdx.x % n_bh;
  const int qb = n_qb - 1 - blockIdx.x / n_bh;
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int kvh = h / (hq / hkv);
  const int q0 = qb * kTcBlockQ;
  const int q1 = min(q0 + kTcBlockQ, sq) - 1;
  const int n_kb = (skv + kTcBlockK - 1) / kTcBlockK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&bar_q, 1);
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(&bar_k[s], 1);
      hopper::mbar_init(&bar_v[s], 1);
      hopper::mbar_init(&bar_empty[s], 2);   // one arrival per warpgroup
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 8) {
    // ---- producer: one lane issues every TMA load ----
    if (lane == 0) {
      hopper::mbar_expect_tx(&bar_q, L::kQBytes);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c)
        hopper::tma_load_4d(smem + c * L::kQChunk, &tm_q, &bar_q, c * 64, h,
                            q0, b);
      int t = 0;
      for (int kb = next_tile(0, n_kb, q0, q1, skv, causal, window, n_meta);
           kb < n_kb; kb = next_tile(kb + 1, n_kb, q0, q1, skv, causal,
                                     window, n_meta)) {
        const int j0 = kb * kTcBlockK;
        const int s = t % kTcStages;
        hopper::mbar_wait(&bar_empty[s], ((t / kTcStages) & 1) ^ 1);
        uint8_t* ks = smem + L::kK + s * L::kKVBytes;
        uint8_t* vs = smem + L::kV + s * L::kKVBytes;
        hopper::mbar_expect_tx(&bar_k[s], L::kKVBytes);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
          hopper::tma_load_4d(ks + c * L::kKVChunk, &tm_k, &bar_k[s], c * 64,
                              kvh, j0, b);
        hopper::mbar_expect_tx(&bar_v[s], L::kKVBytes);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
          hopper::tma_load_4d(vs + c * L::kKVChunk, &tm_v, &bar_v[s], c * 64,
                              kvh, j0, b);
        ++t;
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
  // Software-pipelined by one tile: while tile t's P.V runs on the tensor
  // cores, the warpgroup takes the softmax of tile t + 1, whose S was
  // issued just before it.
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int wi0 = q0 + wg * 64;                // the warpgroup's first row
  const int wi1 = min(wi0 + 63, sq - 1);       // and last (< wi0: none)
  const int row0 = wi0 + (warp % 4) * 16 + lane / 4;   // rows row0, row0 + 8
  const int col_lane = 2 * (lane % 4);
  constexpr int kO = DP / 2;                   // O accumulators per thread

  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};                   // this thread's partial sums
  float corr[2] = {1.0f, 1.0f};
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
  uint32_t p_hi[4][4], p_lo[4][4];

  const uint32_t q_addr = hopper::smem_u32(smem) + wg * 64 * 128;
  const uint32_t k_base = hopper::smem_u32(smem + L::kK);
  const uint32_t v_base = hopper::smem_u32(smem + L::kV);
  hopper::mbar_wait(&bar_q, 0);

  int kb = next_tile(0, n_kb, q0, q1, skv, causal, window, n_meta);
  if (kb < n_kb) {                             // S and P of the first tile
    hopper::mbar_wait(&bar_k[0], 0);
    hopper::wgmma_fence();
    issue_qk<DP>(sc, q_addr, k_base);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    softmax_any(sc, m, l, corr, kb, wi0, wi1, row0, col_lane, scale_log2,
                skv, causal, window, n_meta);
  }
  for (int t = 0; kb < n_kb; ++t) {
    const int s = t % kTcStages;
    const int nxt = next_tile(kb + 1, n_kb, q0, q1, skv, causal, window,
                              n_meta);
    const bool more = nxt < n_kb;
    // the previous tile's P.V has completed: O takes this tile's rescale
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] *= corr[(i % 4) / 2];
    // P as two bf16 register operands, P_hi and P_lo, per 16-key step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hopper::split_bf16x2(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1],
                             p_hi[kk][e], p_lo[kk][e]);
    // S of the next tile (of this tile again where none is left, dropped:
    // the wgmma stays outside any branch), then this tile's P.V
    const int s_next = more ? (t + 1) % kTcStages : s;
    if (more) hopper::mbar_wait(&bar_k[s_next], ((t + 1) / kTcStages) & 1);
    hopper::mbar_wait(&bar_v[s], (t / kTcStages) & 1);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
    issue_qk<DP>(sc, q_addr, k_base + s_next * L::kKVBytes);
    hopper::wgmma_commit();
    issue_pv<DP>(o, p_hi, p_lo, v_base + s * L::kKVBytes);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();                   // S done, P.V in flight
    hopper::fence_regs(sc);
    if (more)
      softmax_any(sc, m, l, corr, nxt, wi0, wi1, row0, col_lane,
                  scale_log2, skv, causal, window, n_meta);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::fence_regs(p_hi[kk]);
      hopper::fence_regs(p_lo[kk]);
    }
    if (tid == 0) hopper::mbar_arrive(&bar_empty[s]);
    kb = nxt;
  }

  // out = O / l, bf16, rows below Sq and columns below d
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
  }
  const long long q_stride = (long long)hq * d;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + col_lane;
    if (col >= d) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= sq) continue;
      __nv_bfloat16* dst = out + ((long long)b * sq + row) * q_stride +
                           (long long)h * d + col;
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
          o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int b, int sq, int skv, int hq, int hkv, int d,
                 float sm_scale, int causal, int window, int n_meta,
                 cudaStream_t stream) {
  // 4-D maps over the model's [B, S, H, d]: (d, H, S, B), innermost first
  const cuuint64_t e = sizeof(__nv_bfloat16);
  CUtensorMap tm[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t s_len = i == 0 ? sq : skv;
    const cuuint64_t heads = i == 0 ? hq : hkv;
    const cuuint64_t dims[4] = {(cuuint64_t)d, heads, s_len, (cuuint64_t)b};
    const cuuint64_t strides[3] = {d * e, heads * d * e, s_len * heads * d * e};
    const cuuint32_t box[4] = {64, 1,
                               (cuuint32_t)(i == 0 ? kTcBlockQ : kTcBlockK),
                               1};
    const int rc = hopper::tensor_map(&tm[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                      4, bases[i], dims, strides, box,
                                      CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc != 0) return rc;
  }
  const int smem = TcSmem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_bh = b * hq;
  const int n_qb = (sq + kTcBlockQ - 1) / kTcBlockQ;
  flash_fwd_wgmma<DP><<<(unsigned)((long long)n_bh * n_qb), kTcThreads, smem,
                        stream>>>(
      tm[0], tm[1], tm[2], static_cast<__nv_bfloat16*>(out), n_bh, n_qb, sq,
      skv, hq, hkv, d, sm_scale * kLog2e, causal, window, n_meta);
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

// The tensor-core kernel: bf16 only, d % 16 == 0 and d <= 128, 16-byte
// aligned tensors.  Returns a cudaError_t or a hopper.cuh error code.
int flash_attention_fwd_wgmma_launch(const void* q, const void* k,
                                     const void* v, void* out, int b, int sq,
                                     int skv, int hq, int hkv, int d,
                                     float sm_scale, int causal, int window,
                                     int n_meta, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 ||
      d <= 0 || d > kMaxD || d % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, out};
  for (int i = 0; i < 4; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch_wgmma<64>(q, k, v, out, b, sq, skv, hq, hkv, d, sm_scale,
                            causal, window, n_meta, s);
  return launch_wgmma<128>(q, k, v, out, b, sq, skv, hq, hkv, d, sm_scale,
                           causal, window, n_meta, s);
}

const char* flash_attention_error_string(int err) {
  return hopper::error_string(err);
}

}  // extern "C"
