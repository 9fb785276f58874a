// Mamba selective scan for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py:25
// (_ssm_kernel, launched by ssm_scan at :69 through the pallas_call at :90,
// behind ops.py:15 selective_scan).  It computes the same function: for each
// (batch b, channel i), from h = h0[b, i, :] and for t = 0 .. S-1,
//
//   h[s] <- exp(delta[b,t,i] * a[i,s]) * h[s]
//           + (delta[b,t,i] * x[b,t,i]) * B[b,t,s],
//   y[b,t,i] = sum_s h[s] * C[b,t,s],
//
// all in fp32, returning y and the final h.  The TPU kernel pads the time
// axis to whole chunks and freezes h on the padded steps; this kernel loops
// over exactly S steps, which is the same function.  The model calls it once
// per hybrid layer with the whole prefill (S = prompt + meta tokens) and with
// S = 1 for every decode step, from any h0.
//
// Rounding: the decay is 2^(delta * a'), a' = a * log2(e) rounded once
// per (channel, state) when the block starts, on the SFU's ex2.approx.ftz
// (at most 2 ulp, as CUDA's expf is; torch.exp calls expf on the card and
// a vectorised exp within 1 ulp on the CPU).  expf itself costs about ten
// more instructions a state-step, which bound the kernel (PERF.md has both
// builds' times and errors at the serving shape).  The update is fmaf(decay, h, dx * B),
// which rounds once where torch rounds twice, and y is summed over the
// states in another order than torch's: the two agree to a few fp32 ulp of
// h per step.
//
// Layout: delta, x, y [B, S, di]; B, C [B, S, ds]; a [di, ds]; h0, h
// [B, di, ds]; all fp32 and contiguous, ds <= 16.
//
// Design: d_state across lanes.  Each (batch, channel) owns a group of
// kLanes = 4 consecutive lanes of a warp; lane l keeps the states
// [4l, 4l + 4) (fewer where ds is smaller) and their a' in registers, so a
// step issues four independent exps per lane.  Each lane writes its part
// of y[t] to shared memory, and the parts are summed when the tile's y is
// stored.  A block of 64 threads serves 16 channels of one batch row (800
// blocks at hymba's prefill) and walks S in tiles of kSteps steps: delta and x
// ([kSteps x channels], coalesced across channels) and B and C ([kSteps x
// ds]) land in shared memory by cp.async, double-buffered, so that tile
// i + 1 is in flight while tile i is scanned; y leaves coalesced.  The step
// loop is unrolled, so the next step's exps, which do not depend on h,
// issue under this step's FMA chain; a lane reads its states' B and C as
// one 16-byte load each, and a build for ds = 16 tests no state index.  h0
// and h are read and written with consecutive lanes on consecutive states,
// which is also the S = 1 decode launch's whole traffic.  kLanes = 4 was
// the fastest of 2, 4, 8 and 16 on the H100 (tools/probe_ssm_lanes.py
// builds and times each; PERF.md has its times).
//
// Bound on the H100 at Hymba's prefill (B=4, S=2,176, di=3,200, ds=16):
// delta, x and y are 111,411,200 bytes each (337 MB with B, C, a, h0 and
// h: 0.10 ms at 3.35 TB/s) against 445.6 M exps, which the SFUs produce at
// 16 per clock per SM (0.11 ms over 132 SMs at 1.98 GHz).  With kLanes = 4,
// B x di x kLanes = 51,200 threads are ~12 warps per SM, each with four
// independent exp -> FMA chains a step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../hopper.cuh"

namespace {

constexpr int kLanes = 4;                // lanes per (batch, channel)
constexpr int kThreads = 64;
constexpr int kChannels = kThreads / kLanes;
constexpr int kSteps = 32;               // time steps per staged tile
constexpr int kMaxState = 16;
constexpr int kPer = kMaxState / kLanes; // states per lane: one float4
static_assert(kChannels % 4 == 0, "channels in 16-byte units");

struct Tile {
  float dl[kSteps][kChannels];
  float x[kSteps][kChannels];
  float b[kSteps][kMaxState];
  float c[kSteps][kMaxState];
};
// the tiles, then each lane's part of y for a tile: [kSteps][kThreads]
constexpr int kSmem = 2 * (int)sizeof(Tile) + kSteps * kThreads * 4;
static_assert(kSmem <= 48 * 1024, "within the default dynamic limit");

// row[q0 .. q0 + 4) of a staged B or C tile, in one 16-byte load
__device__ __forceinline__ void lds_states(const float* row,
                                           float (&out)[kPer]) {
  const float4 v = *reinterpret_cast<const float4*>(row);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;

// Issue the copies of steps [row0, row0 + n) of this block's channels
// [c0, c0 + kChannels) into `t`.  vec: di and ds are multiples of 4 and
// every pointer is on 16 bytes, so whole 16-byte units are copied.
// Channels past di are not copied (their lanes store nothing).
__device__ __forceinline__ void stage(Tile& t, const float* delta,
                                      const float* x, const float* bm,
                                      const float* cm, long long row0, int n,
                                      int c0, int di, int ds, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kUnits = kChannels / 4;
    for (int e = tid; e < n * kUnits; e += kThreads) {
      const int r = e / kUnits;
      const int u = (e - r * kUnits) * 4;
      if (c0 + u < di) {
        const long long idx = (row0 + r) * di + c0 + u;
        cp_async16(&t.dl[r][u], delta + idx);
        cp_async16(&t.x[r][u], x + idx);
      }
    }
    const int units = ds / 4;
    for (int e = tid; e < n * units; e += kThreads) {
      const int r = e / units;
      const int q = (e - r * units) * 4;
      const long long idx = (row0 + r) * ds + q;
      cp_async16(&t.b[r][q], bm + idx);
      cp_async16(&t.c[r][q], cm + idx);
    }
  } else {
    for (int e = tid; e < n * kChannels; e += kThreads) {
      const int r = e / kChannels;
      const int cc = e - r * kChannels;
      const bool ok = c0 + cc < di;
      const long long idx = ok ? (row0 + r) * di + c0 + cc : 0;
      cp_async4(&t.dl[r][cc], delta + idx, ok);
      cp_async4(&t.x[r][cc], x + idx, ok);
    }
    for (int e = tid; e < n * ds; e += kThreads) {
      const int r = e / ds;
      const int q = e - r * ds;
      const long long idx = (row0 + r) * ds + q;
      cp_async4(&t.b[r][q], bm + idx, true);
      cp_async4(&t.c[r][q], cm + idx, true);
    }
  }
  cp_async_commit();
}

// exp(dl * a) from a pre-scaled by log2(e)
__device__ __forceinline__ float decay_of(float dl, float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(dl * a));
  return r;
}

// kFull: ds == kMaxState, so every lane's states are live
template <bool kFull>
__global__ void __launch_bounds__(kThreads)
ssm_scan_fwd(const float* __restrict__ delta, const float* __restrict__ bm,
             const float* __restrict__ cm, const float* __restrict__ x,
             const float* __restrict__ a, const float* __restrict__ h0,
             float* __restrict__ y, float* __restrict__ hout, int s, int di,
             int ds, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  Tile* tiles = reinterpret_cast<Tile*>(smem);
  float (*yp_s)[kThreads] =
      reinterpret_cast<float (*)[kThreads]>(smem + 2 * sizeof(Tile));

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int g = tid / kLanes;           // channel within the block
  const int lane = tid - g * kLanes;    // lane within the group
  const int q0 = kPer * lane;           // this lane's first state
  const int ch = c0 + g;
  const bool live = ch < di;

  float h[kPer], av[kPer];
  const long long hbase = ((long long)b * di + ch) * ds;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const bool ok = live && q0 + j < ds;
    h[j] = ok ? h0[hbase + q0 + j] : 0.0f;
    av[j] = ok ? a[(long long)ch * ds + q0 + j] * 1.44269504088896341f
               : 0.0f;
  }

  const long long brow = (long long)b * s;
  const int tiles_n = (s + kSteps - 1) / kSteps;
  stage(tiles[0], delta, x, bm, cm, brow, min(kSteps, s), c0, di, ds, vec);
  for (int i = 0; i < tiles_n; ++i) {
    Tile& t = tiles[i & 1];
    const int t0 = i * kSteps;
    const int n = min(kSteps, s - t0);
    hopper::cp_async_wait<0>();
    // tile i has landed for every thread, and every thread has stored
    // tile i - 1's y, so its buffer is free for tile i + 1
    __syncthreads();
    if (i + 1 < tiles_n)
      stage(tiles[(i + 1) & 1], delta, x, bm, cm, brow + t0 + kSteps,
            min(kSteps, s - t0 - kSteps), c0, di, ds, vec);

    auto step = [&](int r) {
      const float dl = t.dl[r][g];
      const float dx = dl * t.x[r][g];
      float bq[kPer], cq[kPer];
      lds_states(&t.b[r][q0], bq);
      lds_states(&t.c[r][q0], cq);
      float yp = 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (kFull || q0 + j < ds) {
          h[j] = fmaf(decay_of(dl, av[j]), h[j], dx * bq[j]);
          yp = fmaf(h[j], cq[j], yp);
        }
      }
      yp_s[r][tid] = yp;
    };
    if (n == kSteps) {   // a whole tile: a constant trip count
#pragma unroll 4
      for (int r = 0; r < kSteps; ++r) step(r);
    } else {
#pragma unroll 4
      for (int r = 0; r < n; ++r) step(r);
    }
    __syncthreads();   // every lane's part of y is in yp_s

    // y = the sum of a channel's kLanes parts, stored coalesced
    for (int e = tid; e < n * kChannels; e += kThreads) {
      const int r = e / kChannels;
      const int cc = e - r * kChannels;
      if (c0 + cc < di) {
        const float* p = &yp_s[r][cc * kLanes];
        float sum = p[0];
#pragma unroll
        for (int l = 1; l < kLanes; ++l) sum += p[l];
        y[(brow + t0 + r) * di + c0 + cc] = sum;
      }
    }
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (q0 + j < ds) hout[hbase + q0 + j] = h[j];
  }
}

}  // namespace

extern "C" {

int ssm_scan_max_state() { return kMaxState; }

// Returns a cudaError_t (0 = launched).
int ssm_scan_launch(const void* delta, const void* bm, const void* cm,
                    const void* x, const void* a, const void* h0, void* y,
                    void* hout, int b, int s, int di, int ds, void* stream) {
  if (b <= 0 || s <= 0 || di <= 0 || ds <= 0 || ds > kMaxState)
    return (int)cudaErrorInvalidValue;
  const uintptr_t any = reinterpret_cast<uintptr_t>(delta) |
                        reinterpret_cast<uintptr_t>(bm) |
                        reinterpret_cast<uintptr_t>(cm) |
                        reinterpret_cast<uintptr_t>(x);
  const int vec = (any % 16 == 0 && di % 4 == 0 && ds % 4 == 0) ? 1 : 0;
  auto kernel = ds == kMaxState ? ssm_scan_fwd<true> : ssm_scan_fwd<false>;
  const dim3 grid((unsigned)((di + kChannels - 1) / kChannels), (unsigned)b);
  kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(delta), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(x),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hout), s, di, ds, vec);
  return (int)cudaGetLastError();
}

const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
