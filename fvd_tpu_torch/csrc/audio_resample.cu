// Audio rematrix and rate conversion for Hopper (sm_90a): what the JAX
// package gets from libswresample in native/decode_shim.cc
// (fvd_extract_audio: mono float at target_sr, swr's defaults).
//
// audio_resample: one launch per track, one thread per output sample.  The
// input is the decoded PCM, 1 or 2 channels of float32 at the track's rate;
// two channels mix to one as swr's default matrix does, both times
// 1/sqrt(2).  Where the rates match that is all (``length`` 0).  Otherwise
// output k is the dot product of ``length`` input samples, from
// floor(k step / phases) - center on, with phase (k step) mod phases of the
// filter bank the host built as swr_init does (a Kaiser-windowed sinc per
// phase of the exact rational ratio, float32), the input mirrored about its
// first sample (x[-j] = x[j]) and past its last (x[n + j] = x[n - 1 - j]), as
// swr's initial buffer and flush do; the host gives the output count swr's
// calls yield.  Sums in float64, rounded to float32 once.
//
// Bound on an H100: each input sample is read once and each output written
// once (about 0.5 MB for 10 s of 48 kHz stereo), and 36 multiply-adds an
// output at 48 -> 44.1 kHz; the bytes bound it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct ResampleArgs {
  long long n_in, n_out, row_stride;
  int channels, phases, step, length;
};

__device__ __forceinline__ double mono_at(const float* x, long long j, const ResampleArgs& a) {
  if (j < 0) j = -j;
  if (j >= a.n_in) j = 2 * a.n_in - 1 - j;
  if (a.channels == 1) return (double)x[j];
  return ((double)x[j] + (double)x[a.row_stride + j]) * 0.70710678118654752440;
}

__global__ void audio_resample_kernel(const float* x, const float* taps, float* out, ResampleArgs a) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= a.n_out) return;
  if (a.length == 0) {
    out[k] = (float)mono_at(x, k, a);
    return;
  }
  const long long pos = k * a.step;
  const long long first = pos / a.phases - (a.length - 1) / 2;
  const float* h = taps + (pos % a.phases) * a.length;
  double acc = 0.0;
  for (int i = 0; i < a.length; ++i) acc += mono_at(x, first + i, a) * (double)h[i];
  out[k] = (float)acc;
}

}  // namespace

extern "C" int audio_resample_launch(const void* x, const void* taps, void* out, const void* args, void* stream) {
  const ResampleArgs* a = static_cast<const ResampleArgs*>(args);
  if (a->n_out <= 0 || a->n_in <= 0 || a->channels < 1 || a->channels > 2 || (a->length && a->phases <= 0))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  audio_resample_kernel<<<(unsigned)((a->n_out + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)taps, (float*)out, *a);
  return (int)cudaGetLastError();
}
