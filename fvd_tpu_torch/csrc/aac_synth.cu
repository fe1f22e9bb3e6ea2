// AAC synthesis for Hopper (sm_90a): the IMDCT, windowing and overlap-add
// that the JAX package gets from libavcodec's aac decoder
// (native/decode_shim.cc, fvd_extract_audio).  The spectra come from the
// host's parse (fvd_tpu_torch/utils/aac.py), dequantised, stereo-processed
// and TNS-filtered.
//
// aac_synth: one launch per track, one block of 256 threads per frame and
// channel.  Block (f, c) writes the 1024 output samples of frame f: frame f's
// first windowed half plus frame f - 1's second windowed half, both computed
// here from the two frames' spectra, so that no block waits on another.
// The IMDCT is the direct sum, in float64 (H100's double rate is half its
// single rate): x[i] = (2 / N) sum_k X[k] cos(pi / (2N) (2i + 1 + N/2)(2k + 1))
// over 32768 for a long frame (N = 2048), and for each of a short frame's
// eight windows (N = 256), the cosine read from a table of one turn in 8192
// steps (a short window's index times 8).  Windows as libavcodec's
// imdct_and_windowing applies them: a long window meets a long one only from
// an ONLY_LONG or LONG_STOP frame into an ONLY_LONG or LONG_START one; any
// other pair meets as short windows (the previous frame's right half flat to
// 448, falling over 128 with the short window, then 0; the current frame's
// left half the mirror; an EIGHT_SHORT frame's windows at 448 + 128 w, the
// first rising with the previous shape).  The rising halves of the sine and
// KBD windows (long 1024, short 128, float64) come from the host.
//
// Bound on an H100: a block reads 8 KB of spectra and writes 4 KB; the
// direct IMDCT is 2 x 1024 x 1024 multiply-adds a long frame (a quarter of
// that short), about 4 GFLOP of float64 for a 10 s stereo track, so the
// operations bound it at the card's float64 rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ONLY_LONG = 0, LONG_START = 1, EIGHT_SHORT = 2, LONG_STOP = 3;
constexpr double PCM_SCALE = 32768.0;
// the constant table: cos(pi m / 4096) for m < 8192, then the windows' rising
// halves: long sine, long KBD (1024 each), short sine, short KBD (128 each)
constexpr int TAB_COS = 0, TAB_LONG = 8192, TAB_SHORT = 8192 + 2048, TAB_LEN = 8192 + 2048 + 256;

struct SynthArgs {
  int frames, channels, tab_len;
};

__device__ __forceinline__ double wlong(const double* tab, int shape, int i) {
  return tab[TAB_LONG + 1024 * shape + i];
}
__device__ __forceinline__ double wshort(const double* tab, int shape, int i) {
  return tab[TAB_SHORT + 128 * shape + i];
}

// x[i] of a long frame's 2048-point IMDCT
__device__ double long_x(const double* X, const double* tab, int i) {
  const int a = 2 * i + 1 + 1024;
  double acc = 0.0;
  for (int k = 0; k < 1024; ++k) acc += X[k] * tab[TAB_COS + ((a * (2 * k + 1)) & 8191)];
  return acc * (2.0 / 2048.0) / PCM_SCALE;
}

// x_w[j] of a short frame's window w (256-point IMDCT of its 128 values)
__device__ double short_x(const double* X, const double* tab, int w, int j) {
  const int a = 2 * j + 1 + 128;
  const double* Xw = X + 128 * w;
  double acc = 0.0;
  for (int k = 0; k < 128; ++k) acc += Xw[k] * tab[TAB_COS + 8 * ((a * (2 * k + 1)) & 1023)];
  return acc * (2.0 / 256.0) / PCM_SCALE;
}

// sample m (< 2048) of an EIGHT_SHORT frame's windowed windows
__device__ double short_frame(const double* X, const double* tab, int m, int shape, int prev_shape) {
  double acc = 0.0;
  for (int w = 0; w < 8; ++w) {
    const int j = m - 448 - 128 * w;
    if (j < 0 || j >= 256) continue;
    const double win = j < 128 ? wshort(tab, w == 0 ? prev_shape : shape, j) : wshort(tab, shape, 255 - j);
    acc += short_x(X, tab, w, j) * win;
  }
  return acc;
}

__device__ __forceinline__ bool long_overlap(int prev_seq, int seq) {
  return (prev_seq == ONLY_LONG || prev_seq == LONG_STOP) && (seq == ONLY_LONG || seq == LONG_START);
}

__global__ void aac_synth_kernel(const float* coef, const int8_t* meta, const double* tab, float* out, SynthArgs a) {
  const int f = blockIdx.x, c = blockIdx.y;
  const int F = a.frames, C = a.channels;
  __shared__ double cur[1024], prev[1024];
  for (int k = threadIdx.x; k < 1024; k += blockDim.x) {
    cur[k] = coef[((long long)f * C + c) * 1024 + k];
    prev[k] = f > 0 ? coef[((long long)(f - 1) * C + c) * 1024 + k] : 0.0;
  }
  __syncthreads();
  // meta: [4, F, C] window sequence, shape, previous sequence, previous shape
  const long long fc = (long long)f * C + c, plane = (long long)F * C;
  const int seq = meta[fc], shape = meta[plane + fc], pseq = meta[2 * plane + fc], pshape = meta[3 * plane + fc];
  const int seq_p = f > 0 ? meta[fc - C] : ONLY_LONG, shape_p = f > 0 ? meta[plane + fc - C] : 0;
  const bool overlap = long_overlap(pseq, seq);
  for (int n = threadIdx.x; n < 1024; n += blockDim.x) {
    double left;
    if (seq == EIGHT_SHORT) {
      left = short_frame(cur, tab, n, shape, pshape);
    } else if (overlap) {
      left = long_x(cur, tab, n) * wlong(tab, pshape, n);
    } else {
      left = n < 448 ? 0.0 : (n < 576 ? long_x(cur, tab, n) * wshort(tab, pshape, n - 448) : long_x(cur, tab, n));
    }
    double right = 0.0;
    if (f > 0) {
      if (seq_p == EIGHT_SHORT) {
        right = short_frame(prev, tab, 1024 + n, shape_p, shape_p);
      } else if (overlap) {
        right = long_x(prev, tab, 1024 + n) * wlong(tab, pshape, 1023 - n);
      } else if (n < 448) {
        right = long_x(prev, tab, 1024 + n);
      } else if (n < 576) {
        right = long_x(prev, tab, 1024 + n) * wshort(tab, pshape, 127 - (n - 448));
      }
    }
    out[(long long)c * F * 1024 + (long long)f * 1024 + n] = (float)(left + right);
  }
}

}  // namespace

extern "C" int aac_synth_launch(const void* coef, const void* meta, const void* tab, void* out, const void* args,
                                void* stream) {
  const SynthArgs* a = static_cast<const SynthArgs*>(args);
  if (a->frames <= 0 || a->channels <= 0 || a->channels > 2 || a->tab_len != TAB_LEN) return (int)cudaErrorInvalidValue;
  dim3 grid(a->frames, a->channels);
  aac_synth_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>((const float*)coef, (const int8_t*)meta,
                                                           (const double*)tab, (float*)out, *a);
  return (int)cudaGetLastError();
}
