// Fused victim-select + tier-placement plan (OMFS Algorithm 1, lines 32-36)
// for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/sched_select/kernel.py:59
// (sched_select_kernel), which carries all 8+T value rows through one
// VMEM-resident bitonic network.  At fleet scale (J = 100k..262k rows) that
// does not fit one block's shared memory, so this version:
//
//   1. build_keys      masked victim keys (priority, run_start, jid) or
//                      (eff_save[:,0], priority, run_start, jid), INT32_MAX
//                      on rows that cannot be evicted, plus the row index;
//   2. bitonic sort    of (key tuple, row) only — the row makes the order
//                      total.  A shared-memory launch sorts each 2048-row
//                      tile; while the compare distance spans more than a
//                      tile, one global compare-exchange launch per (k, j)
//                      stage, then one shared-memory launch for the inner
//                      stages of that k;
//   3. gather_freed    value columns are gathered by sorted row instead of
//                      being sorted along;
//   4. scan_tiles +    inclusive prefix sum of the freed CPUs: a block scan
//      scan_sums       per 1024 positions, then a scan of the block sums;
//   5. plan            planned = live & (cum - freed < max(need - idle, 0)),
//                      enough = idle + total >= need, the last planned
//                      position, the scatter back to row order, and the
//                      unbounded (pure argmin) placement;
//   6. place_bounded   one thread walks only the planned prefix: greedy
//                      cheapest-feasible tier, strict < so ties go to the
//                      faster tier, cap < 0 meaning unbounded.
//
// Bound on the H100: the function reads 4*J*(5+T) bytes of int32 columns
// (one column more with the cheap key) plus 2*J bytes of bool masks and
// writes 5*J bytes (4.3 MB at J=100k, T=4): ~1.3 us at 3.35 TB/s.  The
// ~34 dependent launches at J=100k (28 of them the sort) and the sequential
// placement walk are latency, not bandwidth, so the design keeps each pass
// a plain coalesced sweep and leaves fewer launches and a single-pass scan
// to later work.
//
// Everything is int32 (bool for the two masks), so the kernel is
// bit-identical to the plain version in ref.py by construction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMask = 0x7fffffff;
constexpr int kTile = 2048;          // rows per shared-memory sort tile
constexpr int kSortThreads = kTile / 2;
constexpr int kScanThreads = 1024;   // positions per scan block
constexpr int kThreads = 256;
constexpr int kMaxTiers = 8;

struct Key {
  int k0, k1, k2, k3, row;
};

struct Caps {
  int v[kMaxTiers];
};

__device__ __forceinline__ bool key_lt(const Key& a, const Key& b) {
  if (a.k0 != b.k0) return a.k0 < b.k0;
  if (a.k1 != b.k1) return a.k1 < b.k1;
  if (a.k2 != b.k2) return a.k2 < b.k2;
  if (a.k3 != b.k3) return a.k3 < b.k3;
  return a.row < b.row;
}

// ascending blocks of size k: the lower index keeps the smaller element
// iff bit k of its global index is clear
__device__ __forceinline__ void compare_exchange(Key& a, Key& b, bool up) {
  if (key_lt(b, a) == up) {
    Key t = a;
    a = b;
    b = t;
  }
}

__global__ void build_keys(const int* __restrict__ prio,
                           const int* __restrict__ rstart,
                           const int* __restrict__ jid,
                           const int* __restrict__ keycost,
                           const bool* __restrict__ evict, int J, int Jp,
                           int cheap, Key* __restrict__ keys,
                           int* __restrict__ stop) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) *stop = 0;
  if (i >= Jp) return;
  Key k;
  k.row = i;
  if (i < J && evict[i]) {
    if (cheap) {
      k.k0 = keycost[i];
      k.k1 = prio[i];
      k.k2 = rstart[i];
      k.k3 = jid[i];
    } else {
      k.k0 = prio[i];
      k.k1 = rstart[i];
      k.k2 = jid[i];
      k.k3 = 0;
    }
  } else {
    k.k0 = k.k1 = k.k2 = k.k3 = kMask;
  }
  keys[i] = k;
}

// All stages (k, j) with j < kTile for k in [k_lo, k_hi], inside one tile.
// k_lo = 2, k_hi = kTile sorts each tile from scratch (alternating
// direction by tile, which the next merge level needs); k_lo = k_hi = k
// finishes the inner stages of a global merge level.
__global__ void bitonic_tile(Key* __restrict__ keys, int k_lo, int k_hi) {
  __shared__ Key s[kTile];
  const int base = blockIdx.x * kTile;
  const int t = threadIdx.x;
  s[t] = keys[base + t];
  s[t + kSortThreads] = keys[base + t + kSortThreads];
  __syncthreads();
  for (int k = k_lo; k <= k_hi; k <<= 1) {
    for (int j = min(k >> 1, kTile >> 1); j > 0; j >>= 1) {
      int i = (t / j) * 2 * j + (t % j);
      bool up = ((base + i) & k) == 0;
      compare_exchange(s[i], s[i + j], up);
      __syncthreads();
    }
  }
  keys[base + t] = s[t];
  keys[base + t + kSortThreads] = s[t + kSortThreads];
}

// One global compare-exchange stage (k, j), j >= kTile: thread t owns the
// pair (i, i + j) with bit j of i clear.
__global__ void bitonic_global(Key* __restrict__ keys, int Jp, int k, int j) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (Jp >> 1)) return;
  int i = (t / j) * 2 * j + (t % j);
  bool up = (i & k) == 0;
  Key a = keys[i];
  Key b = keys[i + j];
  compare_exchange(a, b, up);
  keys[i] = a;
  keys[i + j] = b;
}

__global__ void gather_freed(const Key* __restrict__ keys,
                             const bool* __restrict__ evict,
                             const int* __restrict__ cpus, int J,
                             int* __restrict__ freed) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= J) return;
  int r = keys[p].row;
  freed[p] = (r < J && evict[r]) ? cpus[r] : 0;
}

// inclusive scan of x over a block of up to 1024 values (warp shuffles,
// then a scan of the 32 warp totals); every thread of the block calls it
__device__ int block_inclusive_scan(int x) {
  __shared__ int warp_tot[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int n_warps = (blockDim.x + 31) >> 5;
    int w = lane < n_warps ? warp_tot[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += warp_tot[warp - 1];
  __syncthreads();   // warp_tot is reused by the next call
  return x;
}

__global__ void scan_tiles(const int* __restrict__ freed, int J,
                           int* __restrict__ cum, int* __restrict__ sums) {
  int p = blockIdx.x * kScanThreads + threadIdx.x;
  int x = p < J ? freed[p] : 0;
  x = block_inclusive_scan(x);
  if (p < J) cum[p] = x;
  if (threadIdx.x == kScanThreads - 1) sums[blockIdx.x] = x;
}

// inclusive scan of the n block sums in place, one block, chunk by chunk
__global__ void scan_sums(int* __restrict__ sums, int n) {
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n; base += kScanThreads) {
    int p = base + threadIdx.x;
    int x = p < n ? sums[p] : 0;
    x = block_inclusive_scan(x) + carry;
    if (p < n) sums[p] = x;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = x;
    __syncthreads();
  }
}

__global__ void plan(const Key* __restrict__ keys,
                     const bool* __restrict__ evict,
                     const bool* __restrict__ ckpt,
                     const int* __restrict__ lat,
                     const int* __restrict__ freed,
                     const int* __restrict__ cum,
                     const int* __restrict__ sums,
                     const int* __restrict__ scal, int J, int T, int tiered,
                     int bounded, bool* __restrict__ planned,
                     bool* __restrict__ enough, int* __restrict__ tier,
                     int* __restrict__ stop) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= J) return;
  const int idle = scal[0];
  const int cpus_needed = scal[1];
  const int need = max(cpus_needed - idle, 0);
  const int blk = p / kScanThreads;
  const int c = cum[p] + (blk > 0 ? sums[blk - 1] : 0);
  const int f = freed[p];
  const int r = keys[p].row;
  const bool live = evict[r];
  const bool is_planned = live && (c - f < need);
  if (p == J - 1) *enough = idle + c >= cpus_needed;
  planned[r] = is_planned;
  int t_out = 0;
  if (is_planned) {
    atomicMax(stop, p + 1);
    if (tiered && !bounded && ckpt[r]) {
      const int* row_lat = lat + (size_t)r * T;
      int best_c = row_lat[0];
      for (int k = 1; k < T; ++k) {
        if (row_lat[k] < best_c) {   // strict: ties keep the faster tier
          best_c = row_lat[k];
          t_out = k;
        }
      }
    }
  }
  tier[r] = t_out;
}

// Greedy is sequential by nature (a skipped victim frees space a later,
// smaller one may claim), but only over the planned prefix.
__global__ void place_bounded(const Key* __restrict__ keys,
                              const bool* __restrict__ planned,
                              const bool* __restrict__ ckpt,
                              const int* __restrict__ mib,
                              const int* __restrict__ lat,
                              const int* __restrict__ scal,
                              const int* __restrict__ stop, int T, Caps caps,
                              int* __restrict__ tier) {
  int occ[kMaxTiers];
  for (int k = 0; k < T; ++k) occ[k] = scal[2 + k];
  const int n = *stop;
  for (int p = 0; p < n; ++p) {
    const int r = keys[p].row;
    if (!(planned[r] && ckpt[r])) continue;
    const int m = mib[r];
    const int* row_lat = lat + (size_t)r * T;
    int best_c = kMask;
    int best_t = 0;
    for (int k = 0; k < T; ++k) {
      const bool feasible = caps.v[k] < 0 || occ[k] + m <= caps.v[k];
      const int c = feasible ? row_lat[k] : kMask;
      if (c < best_c) {               // strict: ties keep the faster tier
        best_c = c;
        best_t = k;
      }
    }
    occ[best_t] += m;
    tier[r] = best_t;
  }
}

int padded_len(int J) {
  int jp = kTile;
  while (jp < J) jp <<= 1;
  return jp;
}

int n_scan_blocks(int J) { return (J + kScanThreads - 1) / kScanThreads; }

}  // namespace

extern "C" {

int sched_select_max_tiers() { return kMaxTiers; }

// int32 words of scratch the launch needs for J rows: the sorted keys
// (5 words each over the padded length), freed, cum, the block sums and
// the last planned position
long long sched_select_scratch_words(int J) {
  long long jp = padded_len(J);
  return jp * (long long)(sizeof(Key) / sizeof(int)) + 2LL * J +
         n_scan_blocks(J) + 1;
}

const char* sched_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns 0 or the first CUDA error code.  Inputs are int32 [J] columns
// (bool for evict/ckpt), lat is int32 [J, T] row-major, scal is the device
// pack (idle, cpus_needed, occ[0..T-1]) and caps_host T host ints.
int sched_select_launch(const int* prio, const int* rstart, const int* jid,
                        const int* keycost, const bool* evict,
                        const int* cpus, const int* mib, const bool* ckpt,
                        const int* lat, const int* scal,
                        const int* caps_host, int J, int T, int cheap,
                        int tiered, int bounded, int* scratch, bool* planned,
                        bool* enough, int* tier, void* stream_ptr) {
  if (J < 1 || T < 1 || T > kMaxTiers) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int jp = padded_len(J);
  const int nb = n_scan_blocks(J);
  Key* keys = reinterpret_cast<Key*>(scratch);
  int* freed = scratch + (size_t)jp * (sizeof(Key) / sizeof(int));
  int* cum = freed + J;
  int* sums = cum + J;
  int* stop = sums + nb;
  Caps caps;
  for (int k = 0; k < kMaxTiers; ++k) caps.v[k] = k < T ? caps_host[k] : -1;

  cudaError_t err;
#define SCHED_CHECK()                              \
  do {                                             \
    err = cudaGetLastError();                      \
    if (err != cudaSuccess) return (int)err;       \
  } while (0)

  build_keys<<<(jp + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      prio, rstart, jid, keycost, evict, J, jp, cheap, keys, stop);
  SCHED_CHECK();
  bitonic_tile<<<jp / kTile, kSortThreads, 0, stream>>>(keys, 2, kTile);
  SCHED_CHECK();
  for (int k = kTile << 1; k <= jp; k <<= 1) {
    for (int j = k >> 1; j >= kTile; j >>= 1) {
      bitonic_global<<<(jp / 2 + kThreads - 1) / kThreads, kThreads, 0,
                       stream>>>(keys, jp, k, j);
      SCHED_CHECK();
    }
    bitonic_tile<<<jp / kTile, kSortThreads, 0, stream>>>(keys, k, k);
    SCHED_CHECK();
  }
  const int eb = (J + kThreads - 1) / kThreads;
  gather_freed<<<eb, kThreads, 0, stream>>>(keys, evict, cpus, J, freed);
  SCHED_CHECK();
  scan_tiles<<<nb, kScanThreads, 0, stream>>>(freed, J, cum, sums);
  SCHED_CHECK();
  scan_sums<<<1, kScanThreads, 0, stream>>>(sums, nb);
  SCHED_CHECK();
  plan<<<eb, kThreads, 0, stream>>>(keys, evict, ckpt, lat, freed, cum, sums,
                                    scal, J, T, tiered, bounded, planned,
                                    enough, tier, stop);
  SCHED_CHECK();
  if (tiered && bounded) {
    place_bounded<<<1, 1, 0, stream>>>(keys, planned, ckpt, mib, lat, scal,
                                       stop, T, caps, tier);
    SCHED_CHECK();
  }
#undef SCHED_CHECK
  return 0;
}

}  // extern "C"
