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
// Rounding: expf is CUDA's single-precision exp (at most 2 ulp, no fast-math
// flag here); torch.exp on a CUDA float tensor calls the same expf, and on
// the CPU a vectorised exp within 1 ulp.  The compiler contracts the update
// into fmaf(decay, h, dx * B), which rounds once where torch rounds twice:
// the two agree to a few fp32 ulp of h per step.
//
// Layout: delta, x, y [B, S, di]; B, C [B, S, ds]; a [di, ds]; h0, h
// [B, di, ds]; all fp32 and contiguous, ds <= 16.
//
// Design: one thread per (batch, channel) keeps h[ds] and a[ds] in registers
// and walks the S steps; a block of 64 channels stages 32 steps of delta and
// x (coalesced across channels) and of B and C in shared memory, computes
// them, and stores the 32 steps of y coalesced.  The time loop is the TPU
// kernel's sequential chunk axis moved inside the block.
//
// Bound on the H100 at Hymba's prefill (B=4, S=2,176, di=3,200, ds=16):
// delta, x and y are 111,411,200 bytes each (337 MB with B, C, a, h0 and
// h: 0.10 ms at 3.35 TB/s) against 445.6 M exps, which the SFUs produce at
// 16 per clock per SM (0.11 ms over 132 SMs at 1.98 GHz).  B x di = 12,800
// threads cannot fill the card's 132 SMs with enough warps to hide the
// per-step latency of 16 exps, so the kernel runs far from either bound;
// splitting ds across lanes is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 64;   // threads per block, one channel each
constexpr int kSteps = 32;      // time steps staged per tile
constexpr int kMaxState = 16;

__global__ void __launch_bounds__(kChannels)
ssm_scan_fwd(const float* __restrict__ delta, const float* __restrict__ bm,
             const float* __restrict__ cm, const float* __restrict__ x,
             const float* __restrict__ a, const float* __restrict__ h0,
             float* __restrict__ y, float* __restrict__ hout, int s, int di,
             int ds) {
  __shared__ float dl_s[kSteps][kChannels];
  __shared__ float x_s[kSteps][kChannels];
  __shared__ float y_s[kSteps][kChannels];
  __shared__ float b_s[kSteps][kMaxState];
  __shared__ float c_s[kSteps][kMaxState];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int ch = c0 + tid;
  const bool live = ch < di;

  float h[kMaxState], av[kMaxState];
  const long long hbase = ((long long)b * di + ch) * ds;
#pragma unroll
  for (int q = 0; q < kMaxState; ++q) {
    const bool ok = live && q < ds;
    h[q] = ok ? h0[hbase + q] : 0.0f;
    av[q] = ok ? a[(long long)ch * ds + q] : 0.0f;
  }

  for (int t0 = 0; t0 < s; t0 += kSteps) {
    const int n = min(kSteps, s - t0);
    const long long row0 = (long long)b * s + t0;
    for (int e = tid; e < n * kChannels; e += kChannels) {
      const int r = e / kChannels;
      const int cc = e - r * kChannels;
      const bool ok = c0 + cc < di;
      const long long idx = (row0 + r) * di + c0 + cc;
      dl_s[r][cc] = ok ? delta[idx] : 0.0f;
      x_s[r][cc] = ok ? x[idx] : 0.0f;
    }
    for (int e = tid; e < n * ds; e += kChannels) {
      const int r = e / ds;
      const int q = e - r * ds;
      const long long idx = (row0 + r) * ds + q;
      b_s[r][q] = bm[idx];
      c_s[r][q] = cm[idx];
    }
    __syncthreads();

    for (int r = 0; r < n; ++r) {
      const float dl = dl_s[r][tid];
      const float dx = dl * x_s[r][tid];
      float yv = 0.0f;
#pragma unroll
      for (int q = 0; q < kMaxState; ++q) {
        if (q < ds) {
          h[q] = expf(dl * av[q]) * h[q] + dx * b_s[r][q];
          yv += h[q] * c_s[r][q];
        }
      }
      y_s[r][tid] = yv;
    }
    __syncthreads();   // y_s complete; the staged inputs are free again

    for (int e = tid; e < n * kChannels; e += kChannels) {
      const int r = e / kChannels;
      const int cc = e - r * kChannels;
      if (c0 + cc < di) y[(row0 + r) * di + c0 + cc] = y_s[r][cc];
    }
    // the next tile's stores into y_s come after its staging barrier, which
    // every thread reaches only when its stores above are done
  }

  if (live) {
#pragma unroll
    for (int q = 0; q < kMaxState; ++q)
      if (q < ds) hout[hbase + q] = h[q];
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
  const dim3 grid((unsigned)((di + kChannels - 1) / kChannels), (unsigned)b);
  ssm_scan_fwd<<<grid, kChannels, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(delta), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(x),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hout), s, di, ds);
  return (int)cudaGetLastError();
}

const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
