// Fused victim-select + tier-placement plan (OMFS Algorithm 1, lines 32-36)
// for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/sched_select/kernel.py:59
// (sched_select_kernel), which carries all 8+T value rows of the padded
// table through one VMEM-resident bitonic network.  Only the evictable rows
// (the candidates, E of the J) can be planned and the others add nothing to
// the prefix sum, so this version sorts and scans the candidates alone, in
// ONE cooperative launch (sched_select_plan) whose phases meet at grid-wide
// barriers (cooperative_groups::this_grid().sync()):
//
//   1. compaction   each CTA counts the evictable flags of its slice of the
//                   J rows while cp.async stages the slice's key columns
//                   into shared memory; after a barrier every CTA takes its
//                   offset (the sum of the counts before it) and E, writes
//                   its candidates' (k0..k3, row) keys contiguously, and
//                   writes planned = 0, tier = 0 on every other row.  The
//                   keys are (priority, run_start, jid, 0) or, cheap,
//                   (eff_save[:,0], priority, run_start, jid); the row is the
//                   final tie-break, so the order is total and equals the
//                   stable lexsort restricted to the candidates;
//   2. sort         a CTA sorts up to 512 keys in registers, one a thread
//                   (bitonic: warp shuffles below a distance of 32, shared
//                   memory above).  E <= 512 (the fleet): CTA 0 sorts them
//                   all and the other CTAs leave.  Larger E: every CTA
//                   sorts 512-key tiles, then merge levels, one barrier
//                   each, merge pairs of runs; each CTA makes kMergeChunk
//                   outputs, its split found by a warp-wide 32-ary
//                   merge-path search;
//   3. scan + plan  the prefix sum of the freed CPUs over the sorted
//                   candidates (warp shuffles, one carry per 512 positions;
//                   across CTAs one barrier for the CTA sums), then
//                   planned = prefix_before < max(need - idle, 0),
//                   enough = idle + total >= cpus_needed, and the unbounded
//                   placement (the first-occurrence argmin of the lattice
//                   row), written back to row order;
//   4. placement    bounded: the planned checkpointable victims' (row, mib,
//                   lat[0..T-1]) records are written contiguously in victim
//                   order: beside the sorted keys in shared memory on the
//                   small path, else to global memory (one more barrier
//                   for their offsets across CTAs), from where CTA 0
//                   streams them through a cp.async double buffer.
//                   Four warps of CTA 0 walk the greedy 128 victims a round,
//                   one a lane, and meet at two barriers a round (their
//                   per-tier totals, then their first failures): each
//                   victim takes its cheapest tier that is
//                   feasible with the room the bounded tiers have at the
//                   round's start; per-tier prefix sums of mib over the
//                   round's victims give each the room it would actually
//                   meet; room only shrinks (a negative mib ends the round
//                   after its victim), so a choice stands iff its tier is
//                   still feasible there; the victims before the first that
//                   fails commit, the room shrinks by their sizes, and the
//                   next round starts at that victim.  The sequential walk's
//                   tiers by construction; strict < keeps ties on the faster
//                   tier; cap < 0 is unbounded; room is 64-bit, as the plain
//                   version's Python ints are exact.
//
// Bound on the H100, counted from a call's own inputs: the rows that are
// not candidates change no output, so the plan must read the J evictable
// flags, the keys and CPUs of the E candidates (16 or 20 bytes each), the
// checkpoint flag of each planned victim and the T lattice words (and,
// bounded, the size) of each victim that saves, and write planned, tier and
// enough once (5*J + 1 bytes): ~0.6 MB for the fleet's plan (J = 100k,
// E = 91, 25 victims), ~0.18 us at 3.35 TB/s; its E*log2(E) compares take
// less.  The compaction reads more than that (every row's key columns,
// staged with the flags).  The launch and its barriers (two on the fleet's
// path, 4 + the merge levels for large E) cost more still:
// `sched_select_floor`, an empty cooperative launch of the same grid, is
// the floor the smoke run prints beside the bound.  Past it the time goes
// to the dependent steps a single CTA or warp takes in turn: the barriers,
// the sort's stages and merge levels, and the walk's rounds.
//
// Everything is int32 (bool for the two masks, int64 room), so the kernel
// is bit-identical to the plain version in ref.py by construction.
//
// The batched launch (sched_select_launch_batch) plans many cells of [B, J]
// columns at once, the counterpart of the reference's vmapped pallas_call:
// the grid splits into cell-major groups of max(1, grid / n) CTAs, one group
// a cell, each planning its cell as the single launch plans its one table
// (the single launch is the batch of one).  Every CTA of the launch must
// meet the same grid barriers, so the path (one CTA a cell, or tiles and
// merge levels) and the number of merge levels follow the launch's largest
// E, read from the CTA counts after the first barrier; a cell with fewer
// candidates passes the levels it does not need.  A batch of more cells
// than the co-resident grid (or kMaxCells) goes out as several launches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMask = 0x7fffffff;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTiers = 8;
constexpr int kTile = kThreads;      // keys a CTA sorts at once (one a thread)
constexpr int kMergeChunk = 1024;    // outputs per CTA and merge step
constexpr int kStage = 2048;         // rows staged per compaction chunk
constexpr int kMaxGrid = 1024;       // CTAs at most (block-sum arrays)
constexpr int kWalkWarps = 4;        // warps of CTA 0 that walk, a victim a lane
constexpr int kKeyWords = 5;
constexpr int kSmemBytes = 80 * 1024;   // every phase's, the walk's buffers
constexpr int kMaxCells = 256;       // cells of one batched launch

static_assert(kStage * 4 * 4 <= kSmemBytes, "staging exceeds shared memory");
static_assert(kTile * (kKeyWords + 12) * 4 <= kSmemBytes,
              "a tile's keys and records exceed shared memory");
static_assert(kMergeChunk % kThreads == 0, "merge chunk per thread");
static_assert(kMergeChunk <= 2 * kTile, "a merge chunk spans one run pair");

struct Key {
  int k0, k1, k2, k3, row;
};

struct Params {
  const int* prio;
  const int* rstart;
  const int* jid;
  const int* keycost;
  const unsigned char* evict;
  const int* cpus;
  const int* mib;
  const unsigned char* ckpt;
  const int* lat;              // [J, T] row-major
  const int* occ;              // [T]
  const int* idle_ptr;         // 0-d tensors, or null: the values below
  const int* need_ptr;
  int idle_val;
  int need_val;
  int caps[kMaxTiers];
  int J, T, cheap, tiered, bounded;
  int group;                   // CTAs per cell
  int rows_per_cta;
  int* counts;                 // [kMaxGrid] candidates per CTA
  int* sums;                   // [kMaxGrid] freed CPUs per CTA
  int* wsums;                  // [kMaxGrid] placement records per CTA
  Key* keys_a;                 // [cells, J]
  Key* keys_b;                 // [cells, J]
  int* rec;                    // [cells, J, rec_words(T)], 16-byte aligned
  bool* planned;
  bool* enough;
  int* tier;
};

// The cells of one launch: group g of CTAs plans cell idx[g] of the batch.
struct Cells {
  int n;
  int idx[kMaxCells];
};

__host__ __device__ __forceinline__ int rec_words(int T) {
  return (2 + T + 3) & ~3;     // (row, mib, lat[T]) padded to 16 bytes
}

// Lexicographic (k0, k1, k2, k3, row), without branches: the lanes of a
// warp compare keys that differ in different fields.
__device__ __forceinline__ bool key_lt(const Key& a, const Key& b) {
  bool lt = a.row < b.row;
  lt = a.k3 < b.k3 || (a.k3 == b.k3 && lt);
  lt = a.k2 < b.k2 || (a.k2 == b.k2 && lt);
  lt = a.k1 < b.k1 || (a.k1 == b.k1 && lt);
  return a.k0 < b.k0 || (a.k0 == b.k0 && lt);
}

__device__ __forceinline__ Key sentinel() {
  Key k;
  k.k0 = k.k1 = k.k2 = k.k3 = k.row = kMask;  // above every real key
  return k;
}

__device__ __forceinline__ unsigned warp_incl_scan(unsigned x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    unsigned y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__device__ __forceinline__ long long warp_incl_scan64(long long x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    long long y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Exclusive prefix of x over the CTA in thread order, and the CTA's total
// (both modulo 2^32, as int32 sums wrap); every thread calls it.
__device__ unsigned cta_excl_scan(unsigned x, unsigned* total) {
  __shared__ unsigned warp_tot[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned incl = warp_incl_scan(x);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  const unsigned w = lane < kWarps ? warp_tot[lane] : 0u;
  const unsigned w_incl = warp_incl_scan(w);
  const unsigned before = __shfl_sync(0xffffffffu, w_incl, warp) -
                          __shfl_sync(0xffffffffu, w, warp);
  *total = __shfl_sync(0xffffffffu, w_incl, kWarps - 1);
  __syncthreads();   // warp_tot is reused by the next call
  return before + incl - x;
}

// Sum of v[0, n) and of v[0, upto) over the CTA (n up to kMaxGrid).
__device__ void cta_sum_prefix(const int* v, int n, int upto, unsigned* all,
                               unsigned* before) {
  unsigned a = 0, b = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const unsigned x = (unsigned)v[i];
    a += x;
    if (i < upto) b += x;
  }
  cta_excl_scan(a, all);
  cta_excl_scan(b, before);
}

// The largest of the launch's cells' candidate counts (every thread): the
// sum of each group's CTA counts, one cell a thread.
__device__ int launch_max_count(const int* counts, int cells, int group) {
  __shared__ int top;
  if (threadIdx.x == 0) top = 0;
  __syncthreads();
  if (threadIdx.x < cells) {
    unsigned e = 0;
    for (int k = 0; k < group; ++k) e += (unsigned)counts[threadIdx.x * group + k];
    atomicMax(&top, (int)e);
  }
  __syncthreads();
  const int m = top;
  __syncthreads();
  return m;
}

__device__ __forceinline__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__device__ __forceinline__ Key shfl_xor_key(const Key& k, int j) {
  Key o;
  o.k0 = __shfl_xor_sync(0xffffffffu, k.k0, j);
  o.k1 = __shfl_xor_sync(0xffffffffu, k.k1, j);
  o.k2 = __shfl_xor_sync(0xffffffffu, k.k2, j);
  o.k3 = __shfl_xor_sync(0xffffffffu, k.k3, j);
  o.row = __shfl_xor_sync(0xffffffffu, k.row, j);
  return o;
}

// Ascending bitonic sort of s[0, n2), n2 a power of two <= kThreads, one
// key per thread in registers: compare distances under 32 by warp
// shuffles, the others through shared memory.
__device__ void bitonic_sort_regs(Key* s, int n2) {
  const int t = threadIdx.x;
  const bool mine = t < n2;
  Key x = mine ? s[t] : sentinel();
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      Key y = x;
      if (j < 32) {
        if ((t & ~31) < n2) y = shfl_xor_key(x, j);   // warps with keys
      } else {
        __syncthreads();
        if (mine) s[t] = x;
        __syncthreads();
        y = mine ? s[t ^ j] : x;
      }
      // the lower index of a pair keeps the smaller key in ascending runs
      const bool keep_min = ((t & j) == 0) == ((t & k) == 0);
      if (key_lt(y, x) == keep_min) x = y;
    }
  }
  __syncthreads();
  if (mine) s[t] = x;
  __syncthreads();
}

// Load src[0, n), n <= kTile, into s, pad to a power of two with
// sentinels, sort, and return the padded length.
__device__ int sort_in_smem(const Key* src, int n, Key* s) {
  const int n2 = next_pow2(n > 1 ? n : 1);
  for (int i = threadIdx.x; i < n2; i += kThreads)
    s[i] = i < n ? src[i] : sentinel();
  __syncthreads();
  bitonic_sort_regs(s, n2);
  return n2;
}

// The number of A's keys among the first d of merge(A[0, na), B[0, nb))
// (keys distinct), by one warp: each round probes 32 points of the range
// at once, so a range of n shrinks to n / 32.  Every lane returns it.
__device__ int merge_split(const Key* A, int na, const Key* B, int nb, int d) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int n = hi - lo;
    const int off = (int)(((long long)(lane + 1) * n) >> 5);
    bool more_a = true;            // A[lo + off - 1] is among the first d
    if (off > 0) {
      const int i = lo + off - 1;
      more_a = key_lt(A[i], B[d - 1 - i]);
    }
    const int k = __popc(__ballot_sync(0xffffffffu, more_a));
    const int off_lo = k > 0 ? (int)(((long long)k * n) >> 5) : 0;
    const int off_hi = k < 32 ? (int)(((long long)(k + 1) * n) >> 5) : n + 1;
    hi = lo + off_hi - 1;
    lo = lo + off_lo;
  }
  return lo;
}

// Output chunk c (kMergeChunk keys) of the merge level that turns runs of
// w keys of src[0, E) into runs of 2w in dst.
__device__ void merge_chunk(const Key* src, Key* dst, int E, int w, int c,
                            Key* s) {
  __shared__ int split[2];
  const int warp = threadIdx.x >> 5;
  const int out0 = c * kMergeChunk;
  const int s0 = out0 / (2 * w) * (2 * w);
  const int a1 = min(s0 + w, E);
  const int na = a1 - s0;
  const int nb = min(s0 + 2 * w, E) - a1;
  const Key* A = src + s0;
  const Key* B = src + a1;
  const int d0 = out0 - s0;
  const int d1 = min(d0 + kMergeChunk, na + nb);
  if (warp < 2) {
    const int i = merge_split(A, na, B, nb, warp ? d1 : d0);
    if ((threadIdx.x & 31) == 0) split[warp] = i;
  }
  __syncthreads();
  const int ia0 = split[0], ia1 = split[1];
  const int ma = ia1 - ia0;
  const int mb = (d1 - ia1) - (d0 - ia0);
  for (int i = threadIdx.x; i < ma + mb; i += kThreads)
    s[i] = i < ma ? A[ia0 + i] : B[d0 - ia0 + i - ma];
  __syncthreads();
  constexpr int kPer = kMergeChunk / kThreads;
  const int dd = threadIdx.x * kPer;
  if (dd < ma + mb) {
    const Key* sa = s;
    const Key* sb = s + ma;
    int lo = max(0, dd - mb), hi = min(dd, ma);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (key_lt(sa[mid], sb[dd - 1 - mid])) lo = mid + 1;
      else hi = mid;
    }
    int i = lo, j = dd - lo;
    for (int e = 0; e < kPer && dd + e < ma + mb; ++e) {
      const bool take_a = j >= mb || (i < ma && key_lt(sa[i], sb[j]));
      dst[out0 + dd + e] = take_a ? sa[i++] : sb[j++];
    }
  }
  __syncthreads();   // s is reused by the next chunk
}

// Copy records [r0, r0 + n) into shared memory (every thread issues its
// part, then commits one group).
__device__ __forceinline__ void stage_recs(const Params& q, int r0, int n,
                                           int* dst) {
  const int rs = rec_words(q.T);
  const int* src = q.rec + (size_t)r0 * rs;
  for (int i = threadIdx.x; i < n * rs / 4; i += kThreads)
    hopper::cp_async16(dst + 4 * i, src + 4 * i);
  hopper::cp_async_commit();
}

// What the walking warps share in a round, double-buffered by the round's
// parity: a round's writes never meet the last round's reads, since a warp
// passes two barriers between them.
struct WalkShared {
  long long incl[2][kMaxTiers][kWalkWarps][32];  // running mib, by victim
  long long tot[2][kMaxTiers][kWalkWarps];       // each warp's total
  int cut[2][kWalkWarps];                        // each warp's first cut
};

__device__ __forceinline__ void walk_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(32 * kWalkWarps) : "memory");
}

// The first kWalkWarps warps walk records s[0, n) (see the header, step
// 4), 32 * kWalkWarps victims a round, warp w lane l taking victim
// p + 32 w + l; room[k] is what bounded tier k (bit k of `bounded`) has
// left, carried across tiles, the same in every walking thread.
template <int NT>
__device__ __forceinline__ void walk_tile(const Params& q, const int* s,
                                          int n, unsigned bounded,
                                          long long (&room)[kMaxTiers],
                                          WalkShared& sh) {
  constexpr int RS = (2 + NT + 3) & ~3;   // rec_words(NT)
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  for (int p = 0, b = 0; p < n; b ^= 1) {
    const int i = p + 32 * w + lane;
    const bool act = i < n;
    int row = 0, m = 0, t = 0;
    bool forced = false;
    if (p + 32 * w < n) {
      int rr[RS];                   // (row, mib, lat[NT]) as 16-byte loads
#pragma unroll
      for (int v = 0; v < RS / 4; ++v) {
        const int4 u = reinterpret_cast<const int4*>(s)[(act ? i : 0) *
                                                         (RS / 4) + v];
        rr[4 * v] = u.x;
        rr[4 * v + 1] = u.y;
        rr[4 * v + 2] = u.z;
        rr[4 * v + 3] = u.w;
      }
      row = rr[0];
      m = act ? rr[1] : 0;
      int best_c = kMask;
#pragma unroll
      for (int k = 0; k < NT; ++k) {
        const bool feasible = !((bounded >> k) & 1) || m <= room[k];
        const int c = feasible ? rr[2 + k] : kMask;
        if (c < best_c) {           // strict: ties keep the faster tier
          best_c = c;
          t = k;
        }
      }
      forced = best_c == kMask;     // nothing feasible: tier 0 regardless
    }
    // per bounded tier: the running mib of the warp's victims on it
    long long excl = 0;             // of the warps' victims before mine
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      if (!((bounded >> k) & 1)) continue;
      const bool on = act && t == k;
      const long long x = on ? m : 0;
      const long long c =
          __any_sync(0xffffffffu, on) ? warp_incl_scan64(x) : 0;
      if (on) excl = c - x;
      sh.incl[b][k][w][lane] = c;
      if (lane == 31) sh.tot[b][k][w] = c;
    }
    walk_barrier();
    // the room left before each victim if every earlier one stands
    long long left = 0x7fffffffffffffffLL;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      if (((bounded >> k) & 1) && act && t == k) {
        left = room[k] - excl;
        for (int v = 0; v < w; ++v) left -= sh.tot[b][k][v];
      }
    }
    // the first victim whose choice fails, or that follows a negative size
    const bool ok = !act || forced || m <= left;
    const unsigned bad = __ballot_sync(0xffffffffu, !ok);
    const unsigned neg = __ballot_sync(0xffffffffu, act && m < 0);
    int cut = 0x7fffffff;
    if (bad) cut = 32 * w + __ffs(bad) - 1;
    if (neg) cut = min(cut, 32 * w + __ffs(neg));
    if (lane == 0) sh.cut[b][w] = cut;
    walk_barrier();
    int f = min(n - p, 32 * kWalkWarps);
#pragma unroll
    for (int v = 0; v < kWalkWarps; ++v) f = min(f, sh.cut[b][v]);
    if (act && 32 * w + lane < f) q.tier[row] = t;
    // the committed victims' mib leave their tiers: every warp's total
    // before victim f - 1's warp, and that warp's running total there
    const int wf = (f - 1) >> 5, lf = (f - 1) & 31;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      if (!((bounded >> k) & 1)) continue;
      long long used = sh.incl[b][k][wf][lf];
      for (int v = 0; v < wf; ++v) used += sh.tot[b][k][v];
      room[k] -= used;
    }
    p += f;
  }
}

// CTA 0: the bounded walk over the W records: in place when `srec` holds
// them in shared memory, else streamed from q.rec through two buffers.
template <int NT>
__device__ void walk(const Params& q, int W, int* smem, const int* srec,
                     const int* occ, WalkShared& sh) {
  constexpr int RS = (2 + NT + 3) & ~3;
  constexpr int tile = (kSmemBytes / 4 / (2 * RS)) & ~31;
  const bool walker = threadIdx.x < 32 * kWalkWarps;
  long long room[kMaxTiers];
  unsigned bounded = 0;
#pragma unroll
  for (int k = 0; k < kMaxTiers; ++k) {
    room[k] = 0;
    if (k < NT && q.caps[k] >= 0) {
      bounded |= 1u << k;
      room[k] = (long long)q.caps[k] - occ[k];
    }
  }
  if (srec) {
    if (walker) walk_tile<NT>(q, srec, W, bounded, room, sh);
    return;
  }
  if (W > 0) stage_recs(q, 0, min(tile, W), smem);
  for (int t0 = 0, it = 0; t0 < W; t0 += tile, ++it) {
    const int n = min(tile, W - t0);
    const int* cur = smem + (it & 1) * tile * RS;
    if (t0 + tile < W) {
      stage_recs(q, t0 + tile, min(tile, W - t0 - tile),
                 smem + ((it + 1) & 1) * tile * RS);
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    if (walker) walk_tile<NT>(q, cur, n, bounded, room, sh);
    __syncthreads();   // the buffer is refilled two tiles on
  }
}

__device__ void walk_any(const Params& q, int W, int* smem, const int* srec,
                         const int* occ) {
  __shared__ WalkShared sh;
  switch (q.T) {
    case 1: walk<1>(q, W, smem, srec, occ, sh); break;
    case 2: walk<2>(q, W, smem, srec, occ, sh); break;
    case 3: walk<3>(q, W, smem, srec, occ, sh); break;
    case 4: walk<4>(q, W, smem, srec, occ, sh); break;
    case 5: walk<5>(q, W, smem, srec, occ, sh); break;
    case 6: walk<6>(q, W, smem, srec, occ, sh); break;
    case 7: walk<7>(q, W, smem, srec, occ, sh); break;
    default: walk<8>(q, W, smem, srec, occ, sh); break;
  }
}

__device__ __forceinline__ bool flag(const unsigned char* v, int i) {
  return v[i] != 0;
}

// Scan + plan over sorted candidates keys[p0, p1) whose earlier candidates
// free `carry` CPUs: planned, and the tier of every row the bounded walk
// does not place (the first-occurrence argmin of its lattice row when
// unbounded, else 0); with `records` (shared or global memory), also the
// walk's records from index `wcarry` on.  Returns the CPUs freed here
// (mod 2^32) and adds the records to *wcount.
__device__ unsigned plan_range(const Params& q, const Key* keys, int p0,
                               int p1, unsigned carry, int need, int* records,
                               unsigned wcarry, unsigned* wcount) {
  const int T = q.T;
  unsigned freed_here = 0, wn = 0;
  for (int b = p0; b < p1; b += kThreads) {
    const int p = b + threadIdx.x;
    const bool in = p < p1;
    const int r = in ? keys[p].row : 0;
    // the row's columns, loaded before the scan waits on its neighbours
    const unsigned f = in ? (unsigned)q.cpus[r] : 0u;
    const bool ck = in && q.tiered && flag(q.ckpt, r);
    const int m = ck && records ? q.mib[r] : 0;
    unsigned tot;
    const unsigned ex = cta_excl_scan(f, &tot) + carry + freed_here;
    freed_here += tot;
    const bool pl = in && (int)ex < need;
    const bool want = pl && ck && q.bounded;
    int lat[kMaxTiers];
#pragma unroll
    for (int k = 0; k < kMaxTiers; ++k)
      lat[k] = pl && ck && (records || !q.bounded) && k < T
                   ? q.lat[(size_t)r * T + k]
                   : 0;
    if (in) {
      q.planned[r] = pl;
      if (!want) {
        int t = 0, best = lat[0];
#pragma unroll
        for (int k = 1; k < kMaxTiers; ++k) {
          if (k < T && lat[k] < best) {   // strict: ties keep the faster tier
            best = lat[k];
            t = k;
          }
        }
        q.tier[r] = t;
      }
    }
    unsigned wtot;
    const unsigned w = cta_excl_scan(want ? 1u : 0u, &wtot);
    if (records && want) {
      int* out = records + (size_t)(wcarry + wn + w) * rec_words(T);
      out[0] = r;
      out[1] = m;
#pragma unroll
      for (int k = 0; k < kMaxTiers; ++k)
        if (k < T) out[2 + k] = lat[k];
    }
    wn += wtot;
  }
  *wcount += wn;
  return freed_here;
}

// The launch's parameters as cell `c` of the batch sees them from group
// `slot`: its columns, lattice, occupancy, scalars and outputs, its keys and
// records in the scratch, its group's CTA sums.
__device__ __forceinline__ Params cell_params(const Params& p, int slot,
                                              int c) {
  Params q = p;
  const size_t r = (size_t)c * p.J;
  q.prio += r;
  q.rstart += r;
  q.jid += r;
  q.keycost += r;
  q.evict += r;
  q.cpus += r;
  q.mib += r;
  q.ckpt += r;
  q.lat += r * p.T;
  q.occ += (size_t)c * p.T;
  if (q.idle_ptr) q.idle_ptr += c;
  if (q.need_ptr) q.need_ptr += c;
  q.planned += r;
  q.tier += r;
  q.enough += c;
  const size_t s = (size_t)slot * p.J;
  q.keys_a += s;
  q.keys_b += s;
  q.rec += s * rec_words(p.T);
  q.counts += slot * p.group;
  q.sums += slot * p.group;
  q.wsums += slot * p.group;
  return q;
}

__global__ void __launch_bounds__(kThreads)
    sched_select_plan(const Params launch, const Cells cells) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* smem = reinterpret_cast<int*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  // this CTA's cell and its place in the cell's group of G CTAs
  const int G = launch.group;
  const int cta = blockIdx.x % G;
  const int slot = blockIdx.x / G;
  const Params q = cell_params(launch, slot, cells.idx[slot]);
  const int tid = threadIdx.x;
  const int idle = q.idle_ptr ? *q.idle_ptr : q.idle_val;
  const int cpus_needed = q.need_ptr ? *q.need_ptr : q.need_val;
  const int need = max((int)((unsigned)cpus_needed - (unsigned)idle), 0);
  __shared__ int occ[kMaxTiers];   // the walk's, read while nothing waits
  if (tid < q.T) occ[tid] = q.occ[tid];

  // ---- 1. compaction --------------------------------------------------
  const int lo = min(q.J, cta * q.rows_per_cta);
  const int hi = min(q.J, lo + q.rows_per_cta);
  auto stage = [&](int c0) {
    const int n = min(kStage, hi - c0);
    for (int i = tid; i < n; i += kThreads) {
      hopper::cp_async4(smem + i, q.prio + c0 + i);
      hopper::cp_async4(smem + kStage + i, q.rstart + c0 + i);
      hopper::cp_async4(smem + 2 * kStage + i, q.jid + c0 + i);
      if (q.cheap)
        hopper::cp_async4(smem + 3 * kStage + i, q.keycost + c0 + i);
    }
    hopper::cp_async_commit();
  };
  if (lo < hi) stage(lo);
  unsigned mine = 0;
  for (int i = lo + tid; i < hi; i += kThreads) mine += flag(q.evict, i);
  unsigned count;
  cta_excl_scan(mine, &count);
  if (tid == 0) q.counts[cta] = (int)count;
  grid.sync();
  unsigned E_u, off;
  cta_sum_prefix(q.counts, G, cta, &E_u, &off);
  const int E = (int)E_u;
  // the path and the merge levels every CTA of the launch takes
  const int E_top = launch_max_count(launch.counts, cells.n, G);
  for (int c0 = lo; c0 < hi; c0 += kStage) {
    if (c0 != lo) stage(c0);
    hopper::cp_async_wait<0>();
    __syncthreads();
    const int n = min(kStage, hi - c0);
    for (int b = 0; b < n; b += kThreads) {
      const int i = b + tid;
      const int r = c0 + i;
      const bool in = i < n;
      const bool ev = in && flag(q.evict, r);
      unsigned tot;
      const unsigned pos = cta_excl_scan(ev ? 1u : 0u, &tot);
      if (ev) {
        Key k;
        k.row = r;
        if (q.cheap) {
          k.k0 = smem[3 * kStage + i];
          k.k1 = smem[i];
          k.k2 = smem[kStage + i];
          k.k3 = smem[2 * kStage + i];
        } else {
          k.k0 = smem[i];
          k.k1 = smem[kStage + i];
          k.k2 = smem[2 * kStage + i];
          k.k3 = 0;
        }
        q.keys_a[off + pos] = k;
      } else if (in) {
        q.planned[r] = false;
        q.tier[r] = 0;
      }
      off += tot;
    }
    __syncthreads();   // the stage buffer is refilled next
  }
  grid.sync();

  const bool walks = q.tiered && q.bounded;
  Key* sk = reinterpret_cast<Key*>(smem);
  unsigned W = 0;
  int* srec = nullptr;

  if (E_top <= kTile) {
    // ---- 2-4, small E: CTA 0 alone, the records beside the keys -------
    if (cta != 0) return;
    const int n2 = sort_in_smem(q.keys_a, E, sk);
    srec = smem + ((n2 * kKeyWords + 3) & ~3);
    const unsigned total = plan_range(q, sk, 0, E, 0u, need,
                                      walks ? srec : nullptr, 0u, &W);
    if (tid == 0)
      *q.enough = (int)((unsigned)idle + total) >= cpus_needed;
    __syncthreads();   // the records are read back through shared memory
  } else {
    // ---- 2, large E: tiles, then merge levels -------------------------
    const int n_tiles = (E + kTile - 1) / kTile;
    for (int t = cta; t < n_tiles; t += G) {
      const int base = t * kTile;
      const int n = min(kTile, E - base);
      sort_in_smem(q.keys_a + base, n, sk);
      for (int i = tid; i < n; i += kThreads) q.keys_a[base + i] = sk[i];
      __syncthreads();
    }
    grid.sync();
    Key* src = q.keys_a;
    Key* dst = q.keys_b;
    const int n_chunks = (E + kMergeChunk - 1) / kMergeChunk;
    for (int w = kTile; w < E_top; w <<= 1) {
      if (w < E)
        for (int c = cta; c < n_chunks; c += G)
          merge_chunk(src, dst, E, w, c, sk);
      grid.sync();
      if (w < E) {
        Key* t = src;
        src = dst;
        dst = t;
      }
    }
    // ---- 3, large E: CTA sums, then scan + plan -----------------------
    const int per = (E + G - 1) / G;
    const int p0 = min(E, cta * per);
    const int p1 = min(E, p0 + per);
    unsigned fsum = 0;
    for (int p = p0 + tid; p < p1; p += kThreads)
      fsum += (unsigned)q.cpus[src[p].row];
    unsigned ftot;
    cta_excl_scan(fsum, &ftot);
    if (tid == 0) q.sums[cta] = (int)ftot;
    grid.sync();
    unsigned total, carry;
    cta_sum_prefix(q.sums, G, cta, &total, &carry);
    if (cta == 0 && tid == 0)
      *q.enough = (int)((unsigned)idle + total) >= cpus_needed;
    unsigned wn = 0;
    plan_range(q, src, p0, p1, carry, need, nullptr, 0u, &wn);
    if (!walks) return;
    // ---- 4, large E: the records' offsets, then the records -----------
    if (tid == 0) q.wsums[cta] = (int)wn;
    grid.sync();
    unsigned wbefore;
    cta_sum_prefix(q.wsums, G, cta, &W, &wbefore);
    plan_range(q, src, p0, p1, carry, need, q.rec, wbefore, &wn);
    grid.sync();
    if (cta != 0) return;
  }
  if (walks) walk_any(q, (int)W, smem, srec, occ);
}

// The same grid with nothing in it: the launch and its residency, the
// reachable floor of any one-launch design.
__global__ void __launch_bounds__(kThreads) sched_select_floor_kernel(int) {}

struct DeviceInfo {
  int grid = 0;       // CTAs of one launch, 0 until set up
  int error = 0;
};

DeviceInfo g_info[64];

// The grid for the current device: one CTA per SM, all co-resident.
int setup(int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  DeviceInfo& info = g_info[dev];
  if (info.grid == 0 && info.error == 0) {
    int sms = 0, coop = 0, per_sm = 0;
    err = cudaFuncSetAttribute(sched_select_plan,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(sched_select_floor_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sched_select_plan, kThreads, kSmemBytes);
    if (err == cudaSuccess && (!coop || per_sm < 1))
      err = cudaErrorCooperativeLaunchTooLarge;
    if (err != cudaSuccess) {
      info.error = (int)err;
    } else {
      info.grid = sms < kMaxGrid ? sms : kMaxGrid;
    }
  }
  *grid = info.grid;
  return info.error;
}

size_t key_offset_words() { return 3 * (size_t)kMaxGrid; }

// `rows`: the rows of every cell of one launch (cells x J)
size_t rec_offset_words(size_t rows) {
  size_t end = key_offset_words() + 2 * rows * kKeyWords;
  return (end + 3) & ~(size_t)3;
}

size_t scratch_words(int J, int T, int cells) {
  const size_t rows = (size_t)J * cells;
  return rec_offset_words(rows) + rows * rec_words(T);
}

// One cooperative launch over `cells`: q's group, rows and scratch views
// are set here, the rest by the caller.
int launch_cells(Params& q, const Cells& cells, int grid, int* scratch,
                 cudaStream_t stream) {
  q.group = grid / cells.n;
  q.rows_per_cta = (((q.J + q.group - 1) / q.group) + 15) & ~15;
  const size_t rows = (size_t)q.J * cells.n;
  q.counts = scratch;
  q.sums = scratch + kMaxGrid;
  q.wsums = scratch + 2 * kMaxGrid;
  q.keys_a = reinterpret_cast<Key*>(scratch + key_offset_words());
  q.keys_b = q.keys_a + rows;
  q.rec = scratch + rec_offset_words(rows);
  void* args[] = {&q, const_cast<Cells*>(&cells)};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)sched_select_plan, dim3(cells.n * q.group), dim3(kThreads),
      args, kSmemBytes, stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

void fill_params(Params& q, const int* prio, const int* rstart,
                 const int* jid, const int* keycost, const bool* evict,
                 const int* cpus, const int* mib, const bool* ckpt,
                 const int* lat, const int* occ, const int* caps_host, int J,
                 int T, int cheap, int tiered, int bounded, bool* planned,
                 bool* enough, int* tier) {
  q.prio = prio;
  q.rstart = rstart;
  q.jid = jid;
  q.keycost = keycost;
  q.evict = reinterpret_cast<const unsigned char*>(evict);
  q.cpus = cpus;
  q.mib = mib;
  q.ckpt = reinterpret_cast<const unsigned char*>(ckpt);
  q.lat = lat;
  q.occ = occ;
  for (int k = 0; k < kMaxTiers; ++k) q.caps[k] = k < T ? caps_host[k] : -1;
  q.J = J;
  q.T = T;
  q.cheap = cheap;
  q.tiered = tiered;
  q.bounded = bounded;
  q.planned = planned;
  q.enough = enough;
  q.tier = tier;
}

}  // namespace

extern "C" {

int sched_select_max_tiers() { return kMaxTiers; }

// int32 words of scratch a plan over J rows and T tiers needs: the CTA
// sums, two key buffers and the placement records.
long long sched_select_scratch_words(int J, int T) {
  return (long long)scratch_words(J, T, 1);
}

// The same for one batched launch of `cells` cells.
long long sched_select_batch_scratch_words(int J, int T, int cells) {
  return (long long)scratch_words(J, T, cells);
}

// The most cells one batched launch plans (the co-resident grid, at most
// kMaxCells), or minus the CUDA error that setting up the grid met.
int sched_select_cells_per_launch() {
  int grid = 0;
  const int rc = setup(&grid);
  if (rc != 0) return -rc;
  return grid < kMaxCells ? grid : kMaxCells;
}

const char* sched_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns 0 or the first CUDA error code.  Inputs are int32 [J] columns
// (bool for evict/ckpt), lat is int32 [J, T] row-major, occ int32 [T] on
// the card; idle and cpus_needed are read from idle_ptr / need_ptr (0-d
// int32 on the card) when those are not null, else taken by value;
// caps_host is T host ints.  scratch holds sched_select_scratch_words(J, T)
// int32 words, 16-byte aligned.  One cooperative launch on `stream`.
int sched_select_launch(const int* prio, const int* rstart, const int* jid,
                        const int* keycost, const bool* evict,
                        const int* cpus, const int* mib, const bool* ckpt,
                        const int* lat, const int* occ, const int* idle_ptr,
                        int idle_val, const int* need_ptr, int need_val,
                        const int* caps_host, int J, int T, int cheap,
                        int tiered, int bounded, int* scratch, bool* planned,
                        bool* enough, int* tier, void* stream_ptr) {
  if (J < 1 || T < 1 || T > kMaxTiers) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(scratch) % 16) return cudaErrorInvalidValue;
  int grid = 0;
  int rc = setup(&grid);
  if (rc != 0) return rc;
  Params q;
  fill_params(q, prio, rstart, jid, keycost, evict, cpus, mib, ckpt, lat, occ,
              caps_host, J, T, cheap, tiered, bounded, planned, enough, tier);
  q.idle_ptr = idle_ptr;
  q.need_ptr = need_ptr;
  q.idle_val = idle_val;
  q.need_val = need_val;
  Cells cells;
  cells.n = 1;
  cells.idx[0] = 0;
  return launch_cells(q, cells, grid, scratch,
                      static_cast<cudaStream_t>(stream_ptr));
}

// The batched plan: columns are [B, J] (bool for evict/ckpt), lat [B, J, T],
// occ [B, T], idle and need [B], all int32 on the card; caps_host T host ints;
// cells_host the n_cells distinct batch indices to plan.  The other cells'
// outputs are left as they are.  scratch holds
// sched_select_batch_scratch_words(J, T, min(n_cells, per launch)) words,
// 16-byte aligned, reused by each launch in stream order.  Returns 0 or the
// first CUDA error code; ceil(n_cells / sched_select_cells_per_launch())
// cooperative launches on `stream`.
int sched_select_launch_batch(const int* prio, const int* rstart,
                              const int* jid, const int* keycost,
                              const bool* evict, const int* cpus,
                              const int* mib, const bool* ckpt,
                              const int* lat, const int* occ, const int* idle,
                              const int* need, const int* caps_host, int B,
                              int J, int T, int cheap, int tiered, int bounded,
                              const int* cells_host, int n_cells, int* scratch,
                              bool* planned, bool* enough, int* tier,
                              void* stream_ptr) {
  if (B < 1 || J < 1 || T < 1 || T > kMaxTiers || n_cells < 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(scratch) % 16) return cudaErrorInvalidValue;
  for (int i = 0; i < n_cells; ++i)
    if (cells_host[i] < 0 || cells_host[i] >= B) return cudaErrorInvalidValue;
  int grid = 0;
  int rc = setup(&grid);
  if (rc != 0) return rc;
  const int per = grid < kMaxCells ? grid : kMaxCells;
  Params q;
  fill_params(q, prio, rstart, jid, keycost, evict, cpus, mib, ckpt, lat, occ,
              caps_host, J, T, cheap, tiered, bounded, planned, enough, tier);
  q.idle_ptr = idle;
  q.need_ptr = need;
  q.idle_val = q.need_val = 0;
  Cells cells;
  for (int i0 = 0; i0 < n_cells; i0 += per) {
    cells.n = n_cells - i0 < per ? n_cells - i0 : per;
    for (int i = 0; i < cells.n; ++i) cells.idx[i] = cells_host[i0 + i];
    rc = launch_cells(q, cells, grid, scratch,
                      static_cast<cudaStream_t>(stream_ptr));
    if (rc != 0) return rc;
  }
  return 0;
}

// An empty cooperative launch of the plan's grid, block and shared memory
// on `stream`: what one launch costs before any work (the smoke run's
// floor_ms).
int sched_select_floor(void* stream_ptr) {
  int grid = 0;
  int rc = setup(&grid);
  if (rc != 0) return rc;
  int unused = 0;
  void* args[] = {&unused};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)sched_select_floor_kernel, dim3(grid), dim3(kThreads),
      args, kSmemBytes, static_cast<cudaStream_t>(stream_ptr));
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

}  // extern "C"
