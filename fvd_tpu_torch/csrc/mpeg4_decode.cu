// MPEG-4 Part 2 (Simple Profile) reconstruction and colour conversion for
// Hopper (sm_90a): the parallel half of the decode that the JAX package gets
// from libavcodec's mpeg4 decoder and libswscale, through
// native/decode_shim.cc (fvd_read_frames) or OpenCV's VideoCapture.  Entropy
// decoding runs on the card too (mpeg4_parse.cu), which leaves each VOP's
// quantised levels, vectors and a few values a macroblock on the card.
//
// A frame is one flat uint8 buffer of its planes at the macroblock-aligned
// size: Y (16 mb_h x 16 mb_w), then Cb and Cr (8 mb_h x 8 mb_w each).
// Blocks are in macroblock raster order, six to a macroblock (Y0 Y1 Y2 Y3 Cb Cr).
//
// mpeg4_recon: one launch per VOP, one thread block of 384 threads per
// macroblock (one thread per coefficient, then per pixel, of its six blocks).
// Steps 1 and 2 run for the coded blocks only (every block of an intra
// macroblock is coded); an uncoded block's levels are not read:
//   1. H.263 inverse quantisation into shared memory: an intra DC is
//      level * dc_scaler (Table 7-1); any other level l is
//      sign(l) * (2q|l| + ((q - 1) | 1)); clipped to [-2048, 2047].
//   2. libavcodec's simple_idct, bit for bit: the row pass (48 threads, one
//      row each, with its DC-only shortcut and int16 stores), then the column
//      pass (48 threads, one column each), in 32-bit wrapping arithmetic.
//   3. per pixel: the half-pel prediction from the reference frame, samples
//      past a plane's edge repeating the edge (unrestricted vectors),
//      (a + b + c + d + 2 - rounding_type) >> 2 of the four samples around it,
//      plus the residual where the block is coded, clipped to [0, 255]; an
//      intra block is its clipped residual.
// yuv420_rgb: one thread per 2x2 quad of the visible frame; libswscale's
// unscaled yuv420p -> rgb24 in the 16-bit fixed-point form of its x86 build
// (the JAX package's readers give exactly that; 8Y - 128 is not clamped, so a
// luma sample below 16 darkens its pixel's three channels).
//
// Bound on an H100.  A 320x240 VOP is 300 macroblocks, 1800 blocks: the
// kernel reads 128 bytes of int16 levels a coded block (230 KB when all are,
// as in an I-VOP), 5 KB of side data and at most the 115 KB reference, and
// writes the 115 KB frame; the IDCT is about 550 integer multiply-adds a
// coded block.  Either takes well under a microsecond at the card's rates, so
// the launch and the host's entropy decoding bound the decode.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;
constexpr int ROW_SHIFT = 11, COL_SHIFT = 20;

struct ReconArgs {
  int mb_w, mb_h, rounding, has_ref;
};

struct RgbArgs {
  int width, height, luma_w, luma_h;
};

__device__ __forceinline__ int dc_scale(int q, bool luma) {
  if (q <= 4) return 8;
  if (luma) return q <= 8 ? 2 * q : (q <= 24 ? q + 8 : 2 * q - 16);
  return q <= 24 ? (q + 13) / 2 : q - 6;
}

__device__ __forceinline__ int clip255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

__global__ void __launch_bounds__(384) mpeg4_recon_kernel(
    const int16_t* __restrict__ levels, const int16_t* __restrict__ qscale,
    const int16_t* __restrict__ intra, const int16_t* __restrict__ mv,
    const int16_t* __restrict__ coded, const uint8_t* __restrict__ ref,
    uint8_t* __restrict__ out, ReconArgs a) {
  __shared__ int16_t coef[6][64];
  __shared__ int res[6][64];
  const int mb = blockIdx.x;
  const int mb_x = mb % a.mb_w, mb_y = mb / a.mb_w;
  const int t = threadIdx.x;
  const int n = t >> 6, k = t & 63;
  const int blk = mb * 6 + n;
  const int q = qscale[mb];
  const bool is_intra = intra[mb] != 0;
  const bool has_res = coded[blk] != 0;

  // 1. dequantise
  if (has_res) {
    int l = levels[(size_t)blk * 64 + k];
    int v;
    if (k == 0 && is_intra) {
      v = l * dc_scale(q, n < 4);
    } else {
      int mag = 2 * q * (l < 0 ? -l : l) + ((q - 1) | 1);
      v = l > 0 ? mag : (l < 0 ? -mag : 0);
    }
    v = v < -2048 ? -2048 : (v > 2047 ? 2047 : v);
    coef[n][k] = (int16_t)v;
  }
  __syncthreads();

  // 2a. rows
  if (t < 48 && coded[mb * 6 + (t >> 3)]) {
    int16_t* row = &coef[t >> 3][(t & 7) * 8];
    bool dc_only = true;
#pragma unroll
    for (int i = 1; i < 8; ++i) dc_only &= row[i] == 0;
    if (dc_only) {
      int16_t v = (int16_t)(uint16_t)(((unsigned)(int)row[0] << 3) & 0xffffu);
#pragma unroll
      for (int i = 0; i < 8; ++i) row[i] = v;
    } else {
      unsigned a0 = (unsigned)W4 * row[0] + (1u << (ROW_SHIFT - 1));
      unsigned a1 = a0 + (unsigned)W6 * row[2];
      unsigned a2 = a0 - (unsigned)W6 * row[2];
      unsigned a3 = a0 - (unsigned)W2 * row[2];
      a0 += (unsigned)W2 * row[2];
      unsigned b0 = (unsigned)W1 * row[1] + (unsigned)W3 * row[3];
      unsigned b1 = (unsigned)W3 * row[1] - (unsigned)W7 * row[3];
      unsigned b2 = (unsigned)W5 * row[1] - (unsigned)W1 * row[3];
      unsigned b3 = (unsigned)W7 * row[1] - (unsigned)W5 * row[3];
      a0 += (unsigned)W4 * row[4] + (unsigned)W6 * row[6];
      a1 += -(unsigned)W4 * row[4] - (unsigned)W2 * row[6];
      a2 += -(unsigned)W4 * row[4] + (unsigned)W2 * row[6];
      a3 += (unsigned)W4 * row[4] - (unsigned)W6 * row[6];
      b0 += (unsigned)W5 * row[5] + (unsigned)W7 * row[7];
      b1 += -(unsigned)W1 * row[5] - (unsigned)W5 * row[7];
      b2 += (unsigned)W7 * row[5] + (unsigned)W3 * row[7];
      b3 += (unsigned)W3 * row[5] - (unsigned)W1 * row[7];
      row[0] = (int16_t)((int)(a0 + b0) >> ROW_SHIFT);
      row[7] = (int16_t)((int)(a0 - b0) >> ROW_SHIFT);
      row[1] = (int16_t)((int)(a1 + b1) >> ROW_SHIFT);
      row[6] = (int16_t)((int)(a1 - b1) >> ROW_SHIFT);
      row[2] = (int16_t)((int)(a2 + b2) >> ROW_SHIFT);
      row[5] = (int16_t)((int)(a2 - b2) >> ROW_SHIFT);
      row[3] = (int16_t)((int)(a3 + b3) >> ROW_SHIFT);
      row[4] = (int16_t)((int)(a3 - b3) >> ROW_SHIFT);
    }
  }
  __syncthreads();

  // 2b. columns
  if (t < 48 && coded[mb * 6 + (t >> 3)]) {
    const int16_t* col = &coef[t >> 3][t & 7];
    int* dst = &res[t >> 3][t & 7];
    unsigned a0 = (unsigned)W4 * (col[0] + ((1 << (COL_SHIFT - 1)) / W4));
    unsigned a1 = a0 + (unsigned)W6 * col[16];
    unsigned a2 = a0 - (unsigned)W6 * col[16];
    unsigned a3 = a0 - (unsigned)W2 * col[16];
    a0 += (unsigned)W2 * col[16];
    unsigned b0 = (unsigned)W1 * col[8] + (unsigned)W3 * col[24];
    unsigned b1 = (unsigned)W3 * col[8] - (unsigned)W7 * col[24];
    unsigned b2 = (unsigned)W5 * col[8] - (unsigned)W1 * col[24];
    unsigned b3 = (unsigned)W7 * col[8] - (unsigned)W5 * col[24];
    a0 += (unsigned)W4 * col[32]; a1 -= (unsigned)W4 * col[32];
    a2 -= (unsigned)W4 * col[32]; a3 += (unsigned)W4 * col[32];
    b0 += (unsigned)W5 * col[40]; b1 -= (unsigned)W1 * col[40];
    b2 += (unsigned)W7 * col[40]; b3 += (unsigned)W3 * col[40];
    a0 += (unsigned)W6 * col[48]; a1 -= (unsigned)W2 * col[48];
    a2 += (unsigned)W2 * col[48]; a3 -= (unsigned)W6 * col[48];
    b0 += (unsigned)W7 * col[56]; b1 -= (unsigned)W5 * col[56];
    b2 += (unsigned)W3 * col[56]; b3 -= (unsigned)W1 * col[56];
    dst[0] = (int)(a0 + b0) >> COL_SHIFT;
    dst[8] = (int)(a1 + b1) >> COL_SHIFT;
    dst[16] = (int)(a2 + b2) >> COL_SHIFT;
    dst[24] = (int)(a3 + b3) >> COL_SHIFT;
    dst[32] = (int)(a3 - b3) >> COL_SHIFT;
    dst[40] = (int)(a2 - b2) >> COL_SHIFT;
    dst[48] = (int)(a1 - b1) >> COL_SHIFT;
    dst[56] = (int)(a0 - b0) >> COL_SHIFT;
  }
  __syncthreads();

  // 3. predict, add, clip, store
  const int lw = 16 * a.mb_w, lh = 16 * a.mb_h;
  int base, stride, height, x, y;
  if (n < 4) {
    base = 0; stride = lw; height = lh;
    x = 16 * mb_x + 8 * (n & 1); y = 16 * mb_y + 8 * (n >> 1);
  } else {
    base = lw * lh + (n - 4) * (lw / 2) * (lh / 2); stride = lw / 2; height = lh / 2;
    x = 8 * mb_x; y = 8 * mb_y;
  }
  const int px = k & 7, py = k >> 3;
  int v = 0;
  if (!is_intra) {
    const int mx = mv[2 * blk], my = mv[2 * blk + 1];
    const int xs = x + (mx >> 1) + px, ys = y + (my >> 1) + py;
    const int xa = min(max(xs, 0), stride - 1), xb = min(max(xs + (mx & 1), 0), stride - 1);
    const int ya = min(max(ys, 0), height - 1), yb = min(max(ys + (my & 1), 0), height - 1);
    const uint8_t* p = ref + base;
    const int sum = p[ya * stride + xa] + p[ya * stride + xb] + p[yb * stride + xa] + p[yb * stride + xb];
    v = (sum + 2 - a.rounding) >> 2;
  }
  if (has_res) v += res[n][k];
  out[base + (y + py) * stride + x + px] = (uint8_t)clip255(v);
}

// libswscale's fixed-point coefficients (see fvd_tpu_torch/ops/mpeg4.py)
constexpr int Y_COEFF = 9539, VR_COEFF = 13075, UB_COEFF = 16525, UG_COEFF = -3209, VG_COEFF = -6660;
constexpr int Y_OFFSET = 128;

__global__ void yuv420_rgb_kernel(const uint8_t* __restrict__ frame, uint8_t* __restrict__ rgb,
                                  RgbArgs a) {
  const int qx = blockIdx.x * blockDim.x + threadIdx.x;
  const int qy = blockIdx.y * blockDim.y + threadIdx.y;
  if (2 * qx >= a.width || 2 * qy >= a.height) return;
  const int cw = a.luma_w / 2, ch = a.luma_h / 2;
  const int u = 8 * frame[a.luma_w * a.luma_h + qy * cw + qx] - 1024;
  const int v = 8 * frame[a.luma_w * a.luma_h + cw * ch + qy * cw + qx] - 1024;
  const int dr = (v * VR_COEFF) >> 16;
  const int dg = ((u * UG_COEFF) >> 16) + ((v * VG_COEFF) >> 16);
  const int db = (u * UB_COEFF) >> 16;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int yy = 2 * qy + j;
    if (yy >= a.height) break;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int xx = 2 * qx + i;
      if (xx >= a.width) break;
      const int yv = ((8 * frame[yy * a.luma_w + xx] - Y_OFFSET) * Y_COEFF) >> 16;  // not clamped
      uint8_t* o = rgb + ((size_t)yy * a.width + xx) * 3;
      o[0] = (uint8_t)clip255(yv + dr);
      o[1] = (uint8_t)clip255(yv + dg);
      o[2] = (uint8_t)clip255(yv + db);
    }
  }
}

}  // namespace

extern "C" int mpeg4_recon_launch(const void* levels, const void* qscale, const void* intra,
                                  const void* mv, const void* coded, const void* ref, void* out,
                                  const void* args, void* stream) {
  const ReconArgs* a = static_cast<const ReconArgs*>(args);
  if (a->mb_w <= 0 || a->mb_h <= 0 || (!a->has_ref && ref != nullptr)) return (int)cudaErrorInvalidValue;
  mpeg4_recon_kernel<<<a->mb_w * a->mb_h, 384, 0, (cudaStream_t)stream>>>(
      (const int16_t*)levels, (const int16_t*)qscale, (const int16_t*)intra, (const int16_t*)mv,
      (const int16_t*)coded, (const uint8_t*)ref, (uint8_t*)out, *a);
  return (int)cudaGetLastError();
}

extern "C" int yuv420_rgb_launch(const void* frame, void* rgb, const void* args, void* stream) {
  const RgbArgs* a = static_cast<const RgbArgs*>(args);
  if (a->width <= 0 || a->height <= 0 || a->width > a->luma_w || a->height > a->luma_h)
    return (int)cudaErrorInvalidValue;
  dim3 block(16, 8);
  dim3 grid(((a->width + 1) / 2 + block.x - 1) / block.x, ((a->height + 1) / 2 + block.y - 1) / block.y);
  yuv420_rgb_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((const uint8_t*)frame, (uint8_t*)rgb, *a);
  return (int)cudaGetLastError();
}
