// MPEG-4 Part 2 (Simple Profile) forward path for Hopper (sm_90a): the
// parallel half of the encode that the JAX package gets from libavcodec's
// mpeg4 encoder and libswscale when OpenCV writes an 'mp4v' file
// (fvd_tpu/providers/media.py write_video).  The bitstream is written on the
// host (fvd_tpu_torch/utils/mpeg4v.py encode_vop), and the encoder rebuilds its
// reference frame with mpeg4_recon (mpeg4_decode.cu), so the encoder and the
// decoder share one reconstruction.
//
// mpeg4_forward: one launch per frame, one thread block of 384 threads per
// macroblock:
//   1. RGB -> YUV 4:2:0 of the macroblock (pixels past the frame's edge repeat
//      its last row and column): Y = ((RY r + GY g + BY b + 2^14) >> 15) + 16
//      with libswscale's rgb2rgb coefficients; Cb and Cr the same form on the
//      rounded means of each 2x2 quad, clipped to [0, 255];
//   2. for a P-VOP, the residual against the reference frame's co-located
//      block (the vector (0, 0));
//   3. an orthonormal integer 8x8 FDCT, its basis at 13 bits: a row pass
//      rounded by 10 bits and a column pass rounded by 16 (exact in int32);
//   4. H.263 quantisation at qscale q: an intra DC (F + s/2) / s for the
//      dc_scaler s, an intra AC level |F| / 2q, an inter level (2|F| - q) / 4q,
//      with F's sign and at most 2047.
// Output: int16 levels [n_blocks, 64], raster order.
//
// Bound on an H100: a 320x240 frame reads 230 KB of RGB (and the 115 KB
// reference) and writes 230 KB of levels, with about 3.7 M integer
// multiply-adds in the FDCT: well under a microsecond at the card's rates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct ForwardArgs {
  int width, height, mb_w, mb_h, q, has_ref;
};

constexpr int kShift = 15;

// the FDCT basis [u][x] (64) and the rgb2rgb coefficients RY GY BY RU GU BU
// RV GV BV (9), copied from the host at the first launch on each device
__constant__ int kConsts[73];
constexpr int kMaxDevices = 64;
bool consts_set[kMaxDevices];
#define kBasis kConsts
#define RY kConsts[64]
#define GY kConsts[65]
#define BY kConsts[66]
#define RU kConsts[67]
#define GU kConsts[68]
#define BU kConsts[69]
#define RV kConsts[70]
#define GV kConsts[71]
#define BV kConsts[72]

__device__ __forceinline__ int dc_scale(int q, bool luma) {
  if (q <= 4) return 8;
  if (luma) return q <= 8 ? 2 * q : (q <= 24 ? q + 8 : 2 * q - 16);
  return q <= 24 ? (q + 13) / 2 : q - 6;
}

__global__ void __launch_bounds__(384) mpeg4_forward_kernel(
    const uint8_t* __restrict__ rgb, const uint8_t* __restrict__ ref, int16_t* __restrict__ levels,
    ForwardArgs a) {
  __shared__ int blk[6][64];
  __shared__ int tmp[6][64];
  const int mb = blockIdx.x;
  const int mb_x = mb % a.mb_w, mb_y = mb / a.mb_w;
  const int t = threadIdx.x;
  const int lw = 16 * a.mb_w, lh = 16 * a.mb_h;

  // 1-2. colour and residual
  if (t < 256) {
    const int px = t & 15, py = t >> 4;
    const int x = min(16 * mb_x + px, a.width - 1), y = min(16 * mb_y + py, a.height - 1);
    const uint8_t* p = rgb + ((size_t)y * a.width + x) * 3;
    int v = ((RY * p[0] + GY * p[1] + BY * p[2] + (1 << (kShift - 1))) >> kShift) + 16;
    const int n = ((py >> 3) << 1) | (px >> 3);
    if (a.has_ref) v -= ref[(16 * mb_y + py) * lw + 16 * mb_x + px];
    blk[n][(py & 7) * 8 + (px & 7)] = v;
  } else if (t < 320) {
    const int qx = (t - 256) & 7, qy = (t - 256) >> 3;
    int r = 0, g = 0, b = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int x = min(16 * mb_x + 2 * qx + i, a.width - 1);
        const int y = min(16 * mb_y + 2 * qy + j, a.height - 1);
        const uint8_t* p = rgb + ((size_t)y * a.width + x) * 3;
        r += p[0]; g += p[1]; b += p[2];
      }
    r = (r + 2) >> 2; g = (g + 2) >> 2; b = (b + 2) >> 2;
    int u = ((RU * r + GU * g + BU * b + (1 << (kShift - 1))) >> kShift) + 128;
    int v = ((RV * r + GV * g + BV * b + (1 << (kShift - 1))) >> kShift) + 128;
    u = min(max(u, 0), 255);
    v = min(max(v, 0), 255);
    if (a.has_ref) {
      const int cw = lw / 2, ch = lh / 2;
      const int off = (8 * mb_y + qy) * cw + 8 * mb_x + qx;
      u -= ref[lw * lh + off];
      v -= ref[lw * lh + cw * ch + off];
    }
    blk[4][qy * 8 + qx] = u;
    blk[5][qy * 8 + qx] = v;
  }
  __syncthreads();

  // 3. FDCT: rows (y, u), then columns (v, u)
  const int n = t >> 6, k = t & 63;
  {
    const int y = k >> 3, u = k & 7;
    int s = 0;
#pragma unroll
    for (int x = 0; x < 8; ++x) s += kBasis[u * 8 + x] * blk[n][y * 8 + x];
    tmp[n][k] = (s + (1 << 9)) >> 10;
  }
  __syncthreads();
  const int v = k >> 3, u = k & 7;
  int s = 0;
#pragma unroll
  for (int y = 0; y < 8; ++y) s += kBasis[v * 8 + y] * tmp[n][y * 8 + u];
  const int f = (s + (1 << 15)) >> 16;

  // 4. quantise
  const int q = a.q;
  int l;
  if (!a.has_ref && k == 0) {
    const int sc = dc_scale(q, n < 4);
    const int num = f + (sc >> 1);
    l = num >= 0 ? num / sc : -((-num + sc - 1) / sc);
  } else {
    const int m = f < 0 ? -f : f;
    int lv = a.has_ref ? max(2 * m - q, 0) / (4 * q) : m / (2 * q);
    lv = min(lv, 2047);
    l = f < 0 ? -lv : lv;
  }
  levels[((size_t)mb * 6 + n) * 64 + k] = (int16_t)l;
}

}  // namespace

extern "C" int mpeg4_forward_launch(const void* rgb, const void* ref, void* levels, const void* consts,
                                    const void* args, void* stream) {
  const ForwardArgs* a = static_cast<const ForwardArgs*>(args);
  if (a->width <= 0 || a->height <= 0 || a->q < 1 || a->q > 31 || a->width > 16 * a->mb_w ||
      a->height > 16 * a->mb_h || (!a->has_ref && ref != nullptr))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!consts_set[dev]) {  // synchronous, once: a graph capture may follow
    e = cudaMemcpyToSymbol(kConsts, consts, sizeof(int) * 73);
    if (e != cudaSuccess) return (int)e;
    consts_set[dev] = true;
  }
  mpeg4_forward_kernel<<<a->mb_w * a->mb_h, 384, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rgb, (const uint8_t*)ref, (int16_t*)levels, *a);
  return (int)cudaGetLastError();
}
