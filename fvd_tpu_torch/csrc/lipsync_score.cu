// C1 lip-sync stage for Hopper (sm_90a): z-norm -> windows -> top-half mean,
// for a batch of videos, in one launch.
//
// Replaces the Pallas TPU kernel fvd_tpu/ops/lipsync.py _lipsync_window_kernel
// (launched by lip_sync_scores_pallas through pl.pallas_call) together with the
// jitted stage around it, lip_sync_score_pallas: z-normalisation, window
// gather, lag padding and the top-half mean, which XLA compiled into the same
// program as the kernel.  Same function, per video b of the raw [B, N] mouth
// and audio signals:
//   1. z-normalise both rows, (x - mean) / (population std + 1e-9);
//   2. per window w (start w*step, length `window`):
//      a. Bessel-corrected std of both z-windows; valid iff both >= silence_std;
//      b. for each of 2L+1 lags, dot(mouth window, lag-shifted audio window with
//         L zeros of padding on each side) / norm_div;
//      c. max and mean |c| over the lags; sharpness = max / (mean|c| + 1e-9);
//         score = max, times sharpness_penalty when sharpness < threshold;
//   3. n_valid = number of valid windows; k = max(1, n_valid / 2); the score is
//      the mean of the k best valid window scores, clamped at 0, and 0 when no
//      window is valid.
// Outputs: score f32 [B], n_valid i32 [B], win_score f32 [B, n_win],
// win_valid u8 [B, n_win].
//
// Bound on an H100.  The stage reads 2*B*N floats and writes a few bytes per
// window: at fvd_tpu_torch.entry (B=1, N=50, 3 windows of W=25, L=2) that is
// 400 B in and 23 B out; a 64-video batch of 60 s at 30 fps (N=1800, 23
// windows of W=150, L=15) is 922 KB in and about 17 MFLOP.  Bytes and
// operations both take well under a microsecond at these sizes, so what bounds
// the stage is launches and the host work around them: the composition of
// torch ops it replaces dispatched about 35 device ops per call.  Hence one
// launch that reads the raw signals and writes only the results, with every
// intermediate (z-rows, windows, lag products, scores) in registers or shared
// memory.  Lag products are a (2L+1) x W Toeplitz matrix times a vector, about
// 0.5 flop per shared-memory byte, so tensor cores do not apply, and rows of at
// most a few tens of KB gain nothing from TMA.
//
// Design.  One block of kThreads (16 warps) per video; all videos in one launch.
//   Phase 1: block reductions over the row give mean and population std of
//     both signals (two passes, as _znorm does).  The rows stream from device
//     memory with coalesced loads and are not staged, so N has no limit.
//   Phase 2: the first `slices` warps take windows in turn.  A warp stages its
//     window z-normalised on load into its own shared-memory slice, wm[wp] and
//     wa[wp + 2L] with zero lag padding (wp = window rounded up to 4, zeros in
//     the tail), takes both Bessel stds with warp shuffles, gives lags to lanes
//     (lane l computes lag l, l + 32, ...; 31 lags at 30 fps fit one warp), and
//     reduces max and sum |c| across the warp.  Lane 0 writes the window's
//     score and flag to device memory and to a shared-memory copy.
//   Phase 3: after __syncthreads, the top-half mean without a sort: window i is
//     kept iff it is valid and fewer than k valid windows beat it, where j
//     beats i if s_j > s_i, or s_j == s_i and j < i (the shared copy holds
//     -inf for an invalid window, so it beats no valid one).  Tied scores are
//     equal, so which of them is kept cannot change the sum.  The kept scores
//     are summed by a fixed-order block reduction: deterministic, no atomics.
//
// Limits (checked by the Python wrapper, and again here): shared memory is
// slices * slice + 5 * n_win bytes (slice = 4 * round4(2*wp + 2L) bytes) and
// must fit kMaxDynamicSmem; the wrapper picks slices = min(kWarps, n_win, what
// fits).  Phase 3 is quadratic in n_win (239 windows for 10 min at 30 fps).
// One video is one block on one SM: a 10-minute video at 30 fps takes about
// 70 us of device time on an H100 (700 W), most of it the latency of each
// warp's chain of 15 windows in phase 2.  More warps per block did not help
// (the register cap at 1024 threads); spreading one video's windows over a
// cluster of blocks would.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-9f;
// 227 KB a block may opt into on sm_90, less 1 KB kept for the static arrays
constexpr int kMaxDynamicSmem = 227 * 1024 - 1024;

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Sum of a and b over the block, in a fixed order; every thread gets both totals.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
  for (int w = 0; w < kWarps; ++w) {
    a += red[w];
    b += red[kWarps + w];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
lipsync_score_kernel(const float* __restrict__ mouth, const float* __restrict__ audio,
                     float* __restrict__ score, int* __restrict__ n_valid_out,
                     float* __restrict__ win_score, unsigned char* __restrict__ win_valid,
                     int n, int window, int step, int n_win, int max_lag, int slices,
                     float norm_div, float silence_std, float sharpness_threshold,
                     float sharpness_penalty) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[2 * kWarps];

  const int wp = round4(window);
  const int slice = round4(2 * wp + 2 * max_lag);  // floats: wm[wp], then wa[wp + 2L]
  float* s_score = smem + slices * slice;          // [n_win]
  unsigned char* s_valid = reinterpret_cast<unsigned char*>(s_score + n_win);  // [n_win]

  const int video = blockIdx.x;
  const float* xm = mouth + (long long)video * n;
  const float* xa = audio + (long long)video * n;

  // ---- phase 1: mean and population std of both rows
  float sm = 0.f, sa = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    sm += xm[i];
    sa += xa[i];
  }
  block_sum2(sm, sa, red);
  const float mean_m = sm / n, mean_a = sa / n;
  float vm = 0.f, va = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float dm = xm[i] - mean_m, da = xa[i] - mean_a;
    vm += dm * dm;
    va += da * da;
  }
  block_sum2(vm, va, red);
  const float div_m = sqrtf(vm / n) + kEps, div_a = sqrtf(va / n) + kEps;

  // ---- phase 2: one window per warp at a time
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_lags = 2 * max_lag + 1;
  if (warp < slices) {
    float* wm = smem + warp * slice;
    float* wa = wm + wp;
    for (int w = warp; w < n_win; w += slices) {
      const int start = w * step;
      // unrolled so that each lane has several loads from device memory in flight
#pragma unroll 4
      for (int j = lane; j < wp; j += 32)
        wm[j] = j < window ? (xm[start + j] - mean_m) / div_m : 0.f;
#pragma unroll 4
      for (int j = lane; j < wp + 2 * max_lag; j += 32) {
        const int k = j - max_lag;
        wa[j] = (k >= 0 && k < window) ? (xa[start + k] - mean_a) / div_a : 0.f;
      }
      __syncwarp();

      // Bessel-corrected std over the true window (the reference's torch.std);
      // window == 1 gives 0/0, NaN, and so an invalid window, as torch does.
      float s1 = 0.f, s2 = 0.f;
      for (int j = lane; j < window; j += 32) {
        s1 += wm[j];
        s2 += wa[max_lag + j];
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      const float mu_m = s1 / window, mu_a = s2 / window;
      float q1 = 0.f, q2 = 0.f;
      for (int j = lane; j < window; j += 32) {
        const float d1 = wm[j] - mu_m, d2 = wa[max_lag + j] - mu_a;
        q1 += d1 * d1;
        q2 += d2 * d2;
      }
      q1 = warp_sum(q1);
      q2 = warp_sum(q2);
      const float den = (float)(window - 1);
      const bool valid = sqrtf(q2 / den) >= silence_std && sqrtf(q1 / den) >= silence_std;

      // Lag l of lane: dot(wm, wa[l : l + wp]); wm's zero tail masks wa past the window.
      float mx = -INFINITY, sum_abs = 0.f;
      for (int l = lane; l < n_lags; l += 32) {
        const float* a = wa + l;
        float c = 0.f;
        for (int j = 0; j < wp; j += 4) {
          const float4 m4 = *reinterpret_cast<const float4*>(wm + j);
          c = fmaf(m4.x, a[j], c);
          c = fmaf(m4.y, a[j + 1], c);
          c = fmaf(m4.z, a[j + 2], c);
          c = fmaf(m4.w, a[j + 3], c);
        }
        c /= norm_div;
        mx = fmaxf(mx, c);
        sum_abs += fabsf(c);
      }
      mx = warp_max(mx);
      sum_abs = warp_sum(sum_abs);
      const float sharpness = mx / (sum_abs / n_lags + kEps);
      const float s = sharpness < sharpness_threshold ? mx * sharpness_penalty : mx;
      if (lane == 0) {
        const long long item = (long long)video * n_win + w;
        win_score[item] = s;
        win_valid[item] = valid ? 1 : 0;
        s_score[w] = valid ? s : -INFINITY;  // an invalid window beats no valid one
        s_valid[w] = valid ? 1 : 0;
      }
      __syncwarp();  // every lane is done with the slice before the next window
    }
  }
  __syncthreads();

  // ---- phase 3: top-half mean by rank selection
  int nv = 0;
  for (int base = 0; base < n_win; base += kThreads) {
    const int i = base + threadIdx.x;
    nv += __syncthreads_count(i < n_win && s_valid[i]);
  }
  const int k = nv / 2 > 1 ? nv / 2 : 1;
  float kept = 0.f, unused = 0.f;
  for (int i = threadIdx.x; i < n_win; i += kThreads) {
    if (!s_valid[i]) continue;
    const float si = s_score[i];
    int beaten_by = 0;
#pragma unroll 4
    for (int j = 0; j < n_win; ++j) {
      const float sj = s_score[j];
      beaten_by += (sj > si) | ((sj == si) & (j < i));
    }
    if (beaten_by < k) kept += si;
  }
  block_sum2(kept, unused, red);
  if (threadIdx.x == 0) {
    score[video] = nv > 0 ? fmaxf(kept / (float)k, 0.f) : 0.f;
    n_valid_out[video] = nv;
  }
}

}  // namespace

// The launcher's scalar arguments, passed by address so that the call from
// Python through ctypes converts eight arguments and not eighteen.
struct StageArgs {
  int batch, n, window, step, n_win, max_lag, slices;
  float norm_div, silence_std, sharpness_threshold, sharpness_penalty;
};

// mouth, audio: float32 [batch, n], contiguous, raw (not z-normalised).
// score: float32 [batch]; n_valid: int32 [batch]; win_score: float32
// [batch, n_win]; win_valid: uint8 [batch, n_win].  p->slices: warps that take
// windows, 1..kWarps, with the shared memory above within kMaxDynamicSmem.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int lipsync_score_launch(const void* mouth, const void* audio, void* score,
                                    void* n_valid, void* win_score, void* win_valid,
                                    const StageArgs* p, void* stream) {
  if (p->batch < 1 || p->n < 1 || p->window < 1 || p->step < 1 || p->n_win < 1 ||
      p->max_lag < 0 || p->slices < 1 || p->slices > kWarps ||
      (long long)(p->n_win - 1) * p->step + p->window > p->n)
    return (int)cudaErrorInvalidValue;
  const long long smem =
      4LL * p->slices * round4(2 * round4(p->window) + 2 * p->max_lag) + 5LL * p->n_win;
  if (smem > kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lipsync_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lipsync_score_kernel<<<p->batch, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)mouth, (const float*)audio, (float*)score, (int*)n_valid,
      (float*)win_score, (unsigned char*)win_valid, p->n, p->window, p->step, p->n_win,
      p->max_lag, p->slices, p->norm_div, p->silence_std, p->sharpness_threshold,
      p->sharpness_penalty);
  return (int)cudaGetLastError();
}
