// MPEG-4 Part 2 (Simple Profile) entropy decoding for Hopper (sm_90a): the
// serial half of the decode that the JAX package gets from libavcodec's mpeg4
// decoder (native/decode_shim.cc, fvd_read_frames, or OpenCV's VideoCapture).
//
// mpeg4_parse: one launch per range of VOPs, one thread per VOP.  VOPs parse
// independently of each other (a VOP's only state is its VOL), so each thread
// walks its own VOP's bits exactly as fvd_tpu_torch/utils/mpeg4v.py's
// Decoder._vop and _mbs do: the VOP header, MCBPC and CBPY, dquant, the
// vector differences against the median predictor (f_code, range wrap), the
// intra DC by its size VLC or as a TCOEF by intra_dc_vlc_thr, DC and AC
// prediction, and TCOEF by the intra and inter tables with the three escape
// modes.  It writes the packed int16 row that the reconstruction splits
// (levels [n_blocks, 64] after prediction, qscale and intra [n_mb], mv
// [n_blocks, 2], coded [n_blocks]) and, per VOP, its kind (0 I, 1 P, 2 not
// coded), rounding_type, a status (0, or a fault code with the marker's
// index in bits 8 and up) and the bit of the fault, from the sample's start.
//
// Inputs, in one buffer the host copies once: each VOP's (sample start, VOP
// payload start, sample end) as int64 into the range's bytes, each VOL's
// (time_bits, resync_marker_disable, quant_precision, 0) and each VOP's VOL
// index as int32, then the samples.  Bytes past a sample's end read as zero,
// as the host parser's reader pads them.  The packed rows and the scratch
// (per VOP: the DC predictors of the three block grids, stored less 1024 so
// that the zeroed buffer holds the default 1024; each intra block's first
// column and row; the luma vectors' grid with its zero border) come zeroed.
// The VLC lookup tables, the TCOEF (last, run, level) tables with their LMAX
// and RMAX, the scans and the DC scalers live in constant memory, laid out by
// fvd_tpu_torch/ops/mpeg4.py's _parse_tables (the host parser's tables).
//
// Bound on an H100: the kernel reads a VOP's compressed bytes (a few KB) and
// writes its packed row (242 KB at 320x240, most of it the zeroed levels);
// the bit walk is serial inside a thread, so a range is as fast as its
// longest VOP, a few thousand symbols at some tens of cycles each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T_MCBPC_I = 0, T_MCBPC_P = 512, T_CBPY = 1024, T_MVD = 1088, T_DC_LUMA = 5184,
              T_DC_CHROMA = 7232, T_TCOEF = 11328, T_RLL = 19520, T_LMAX = 19726, T_SCAN = 20238,
              T_DC_SCALE = 20430, T_DC_THR = 20494, T_CHROMA_ROUND = 20502, T_LEN = 20518;
constexpr int ESCAPE = 102;
constexpr int SCAN_ZIGZAG = 0, SCAN_ALT_H = 1, SCAN_ALT_V = 2;

// status codes (fvd_tpu_torch/ops/mpeg4.py PARSE_ERRORS)
constexpr int E_BVOP = 1, E_SVOP = 2, E_TRUNCATED = 3, E_MARKER = 4, E_QUANT0 = 5, E_FCODE0 = 6,
              E_RESYNC = 7, E_VLC = 8, E_TCOEF = 9, E_RUN = 10, E_ESCAPE = 11, E_LEVEL0 = 12;
constexpr int M_MODULO = 0, M_TIME = 1, M_DC = 2, M_ESC_RUN = 3, M_ESC_LEVEL = 4;

__constant__ int16_t kTab[T_LEN];

struct ParseArgs {
  int n_vops, n_vols, mb_w, mb_h, row_len, scratch_len, tab_len, vols_at, ids_at, data_at;
};

struct Bits {
  const uint8_t* p;    // the sample's first byte
  long long nbytes;
  long long size;      // bits in the sample
  long long pos;       // bit position from the sample's start
  int err;
  long long err_pos;

  __device__ uint32_t byte(long long k) const { return k < nbytes ? p[k] : 0u; }
  __device__ uint32_t peek(int n) const {  // n <= 32
    long long q = pos >> 3;
    uint64_t v = 0;
    for (int k = 0; k < 5; ++k) v = (v << 8) | byte(q + k);
    return (uint32_t)((v >> (40 - (int)(pos & 7) - n)) & ((1ull << n) - 1));
  }
  __device__ int read(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    pos += n;
    return (int)v;
  }
  __device__ int bit() {
    int v = (byte(pos >> 3) >> (7 - (int)(pos & 7))) & 1;
    pos += 1;
    return v;
  }
  __device__ void fail(int code, long long at) {
    if (!err) { err = code; err_pos = at; }
  }
  __device__ void marker(int what) {
    if (!bit()) fail(E_MARKER | (what << 8), pos);
  }
  // a prefix code of at most ``bits`` bits from the table at ``base``
  __device__ int vlc(int base, int bits) {
    int e = kTab[base + peek(bits)];
    if (e < 0 || pos + (e & 15) > size) { fail(E_VLC, pos); return 0; }
    pos += e & 15;
    return e >> 4;
  }
};

__device__ __forceinline__ int median3(int a, int b, int c) { return max(min(a, b), min(max(a, b), c)); }

__device__ __forceinline__ int rounded_div(int a, int b) {
  return a >= 0 ? (a + (b >> 1)) / b : -((-a + (b >> 1)) / b);
}

// (last, run, level) of an escaped TCOEF, the escape code read (Decoder._escape)
__device__ void escape(Bits& r, int table, int& last, int& run, int& level) {
  if (!r.bit()) {         // type 1: level offset
    int e = kTab[T_TCOEF + table * 4096 + r.peek(12)];
    if (e < 0 || (e >> 4) == ESCAPE) { r.fail(E_ESCAPE, r.pos); return; }
    r.pos += e & 15;
    int rll = kTab[T_RLL + table * 103 + (e >> 4)];
    last = rll >> 12; run = (rll >> 5) & 63; level = rll & 31;
    level += kTab[T_LMAX + table * 256 + last * 64 + run];
  } else if (!r.bit()) {  // type 2: run offset
    int e = kTab[T_TCOEF + table * 4096 + r.peek(12)];
    if (e < 0 || (e >> 4) == ESCAPE) { r.fail(E_ESCAPE, r.pos); return; }
    r.pos += e & 15;
    int rll = kTab[T_RLL + table * 103 + (e >> 4)];
    last = rll >> 12; run = (rll >> 5) & 63; level = rll & 31;
    run += kTab[T_LMAX + table * 256 + 128 + last * 64 + level] + 1;
  } else {                // type 3: fixed length
    last = r.bit();
    run = r.read(6);
    r.marker(M_ESC_RUN);
    level = r.read(12);
    if (level >= 2048) level -= 4096;
    r.marker(M_ESC_LEVEL);
    if (!r.err && level == 0) r.fail(E_LEVEL0, r.pos);
    return;
  }
  if (r.bit()) level = -level;
}

// run/level pairs into ``out`` (raster order) from scan position ``i``
// (Decoder._tcoef); ``table`` 0 intra, 1 inter
__device__ void tcoef(Bits& r, int* out, int i, int scan, int table) {
  const int16_t* order = kTab + T_SCAN + scan * 64;
  i -= 1;
  while (!r.err) {
    long long p = r.pos;
    int e = kTab[T_TCOEF + table * 4096 + r.peek(12)];
    if (e < 0 || p + (e & 15) > r.size) { r.fail(E_TCOEF, p); return; }
    r.pos = p + (e & 15);
    int last, run, level;
    if ((e >> 4) == ESCAPE) {
      escape(r, table, last, run, level);
      if (r.err) return;
    } else {
      int rll = kTab[T_RLL + table * 103 + (e >> 4)];
      last = rll >> 12; run = (rll >> 5) & 63; level = rll & 31;
      if (r.bit()) level = -level;
    }
    i += run + 1;
    if (i > 63) { r.fail(E_RUN, r.pos); return; }
    out[order[i]] = level;
    if (last) return;
  }
}

struct Vop {
  int mb_w, mb_h;
  int16_t *levels, *qs, *intra, *mv, *coded;
  int16_t* dc;     // the three DC grids, each with a border row and column, less 1024
  int16_t* ac;     // per grid position: the first column (8) then the first row (8)
  int16_t *mvx, *mvy;
  int grid_at[3], grid_stride[3];
};

// one intra block's levels after prediction (Decoder._intra_block)
__device__ void intra_block(Bits& r, const Vop& v, int n, int mb_x, int mb_y, int mb, int q, int coded,
                            int ac_pred, int use_dc_vlc, int* blk) {
  int g = n < 4 ? 0 : n - 3;
  int stride = v.grid_stride[g];
  int i = n < 4 ? (2 * mb_y + (n >> 1) + 1) * stride + 2 * mb_x + (n & 1) + 1 : (mb_y + 1) * stride + mb_x + 1;
  int scale = kTab[T_DC_SCALE + (n < 4 ? 0 : 32) + q];
  int16_t* d = v.dc + v.grid_at[g];
  int up = i - stride;
  int a = d[i - 1] + 1024, b = d[up - 1] + 1024, c = d[up] + 1024;
  int pred_dc, direction;
  if (abs(a - b) < abs(b - c)) {
    pred_dc = (c + (scale >> 1)) / scale; direction = 1;
  } else {
    pred_dc = (a + (scale >> 1)) / scale; direction = 0;
  }
  for (int k = 0; k < 64; ++k) blk[k] = 0;
  int scan = ac_pred ? (direction == 0 ? SCAN_ALT_V : SCAN_ALT_H) : SCAN_ZIGZAG;
  int dc;
  if (use_dc_vlc) {
    int size = r.vlc(n < 4 ? T_DC_LUMA : T_DC_CHROMA, n < 4 ? 11 : 12);
    if (r.err) return;
    int diff = 0;
    if (size) {
      int val = r.read(size);
      diff = (val >> (size - 1)) ? val : val - (1 << size) + 1;
      if (size > 8) r.marker(M_DC);
    }
    if (coded) tcoef(r, blk, 1, scan, 0);
    dc = pred_dc + diff;
  } else {
    if (coded) tcoef(r, blk, 0, scan, 0);
    dc = pred_dc + blk[0];
  }
  if (r.err) return;
  blk[0] = dc;
  int val = dc * scale;
  d[i] = (int16_t)((val < 0 ? 0 : val > 2047 ? 2047 : val) - 1024);
  int16_t* here = v.ac + 16 * (v.grid_at[g] + i);
  if (ac_pred) {
    if (direction == 0) {  // left: the first column
      const int16_t* nb = v.ac + 16 * (v.grid_at[g] + i - 1);
      int nq = mb_x > 0 ? v.qs[mb - 1] : q;
      bool rescale = !(mb_x == 0 || nq == q || n == 1 || n == 3);
      for (int k = 1; k < 8; ++k) blk[k * 8] += rescale ? rounded_div(nb[k] * nq, q) : nb[k];
    } else {               // top: the first row
      const int16_t* nb = v.ac + 16 * (v.grid_at[g] + up) + 8;
      int nq = mb_y > 0 ? v.qs[mb - v.mb_w] : q;
      bool rescale = !(mb_y == 0 || nq == q || n == 2 || n == 3);
      for (int k = 1; k < 8; ++k) blk[k] += rescale ? rounded_div(nb[k] * nq, q) : nb[k];
    }
  }
  // kept for the neighbours' AC prediction (zeros, the default, where the
  // block's first row and column hold none)
  for (int k = 0; k < 8; ++k) {
    here[k] = (int16_t)blk[k * 8];
    here[8 + k] = (int16_t)blk[k];
  }
}

// the median predictor of luma block n (Decoder._pred_mv)
__device__ void pred_mv(const Vop& v, int stride, int base, int mb_x, int mb_y, int n, int& px, int& py) {
  int i = base + (n >> 1) * stride + (n & 1);
  int a = i - 1;
  if (mb_y == 0 && n < 2) {
    if (n == 0 && mb_x == 0) { px = py = 0; return; }
    px = v.mvx[a]; py = v.mvy[a];
    return;
  }
  int b = i - stride;
  int c = n < 2 ? b + 2 - (n & 1) : b + 1 - 2 * (n & 1);
  px = median3(v.mvx[a], v.mvx[b], v.mvx[c]);
  py = median3(v.mvy[a], v.mvy[b], v.mvy[c]);
}

__device__ int mvd(Bits& r, int pred, int f_code) {
  int code = r.vlc(T_MVD, 12);
  if (r.err || code == 0) return pred;
  int sign = r.bit();
  int shift = f_code - 1;
  int val = code;
  if (shift) val = ((((val - 1) << shift) | r.read(shift)) + 1);
  if (sign) val = -val;
  val += pred;
  int bits = 5 + f_code;
  val &= (1 << bits) - 1;
  return val >= (1 << (bits - 1)) ? val - (1 << bits) : val;
}

__device__ int chroma_mv_1(int c) { return (c >> 1) | (c & 1); }

__device__ int chroma_mv_4(int total) {
  return kTab[T_CHROMA_ROUND + (total & 15)] + ((total >> 4) << 1);
}

// the macroblocks of one VOP (Decoder._mbs)
__device__ void macroblocks(Bits& r, const Vop& v, int ctype, int q, int f_code, int dc_thr, int resync_disable) {
  const int mb_w = v.mb_w, mb_h = v.mb_h;
  const int stride = 2 * mb_w + 2;
  const int resync_bits = resync_disable ? 0 : (ctype == 0 ? 17 : 16 + f_code);
  int blk[64];
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const int mb = mb_y * mb_w + mb_x;
      if (resync_bits && r.peek(resync_bits) == 1) { r.fail(E_RESYNC, r.pos); return; }
      const int b0 = mb * 6;
      int mb_type, cbpc, sym;
      if (ctype == 1) {
        // not_coded, then MCBPC; a stuffing code repeats both
        int not_coded;
        do {
          not_coded = r.bit();
          if (not_coded) break;
          sym = r.vlc(T_MCBPC_P, 9);
        } while (!r.err && sym == 20);
        if (not_coded) {  // the vector (0, 0), no residual
          v.qs[mb] = (int16_t)q;
          continue;
        }
        mb_type = sym >> 2; cbpc = sym & 3;
      } else {
        do { sym = r.vlc(T_MCBPC_I, 9); } while (!r.err && sym == 8);
        mb_type = 3 + (sym >> 2); cbpc = sym & 3;
      }
      if (r.err) return;
      const int is_intra = mb_type >= 3;
      const int ac_pred = is_intra ? r.bit() : 0;
      int cbpy = r.vlc(T_CBPY, 6);
      if (r.err) return;
      if (!is_intra) cbpy ^= 15;
      const int use_dc_vlc = q < dc_thr;
      if (mb_type == 1 || mb_type == 4) {
        const int dq[4] = {-1, -2, 1, 2};
        q = min(31, max(1, q + dq[r.read(2)]));
      }
      v.qs[mb] = (int16_t)q;
      const int cbp = (cbpy << 2) | cbpc;
      if (is_intra) {
        v.intra[mb] = 1;
        for (int n = 0; n < 6; ++n) {
          intra_block(r, v, n, mb_x, mb_y, mb, q, (cbp >> (5 - n)) & 1, ac_pred, use_dc_vlc, blk);
          if (r.err) return;
          int16_t* out = v.levels + (long long)(b0 + n) * 64;
          for (int k = 0; k < 64; ++k) out[k] = (int16_t)blk[k];
          v.coded[b0 + n] = 1;
        }
        continue;
      }
      const int base = (2 * mb_y + 1) * stride + 2 * mb_x + 1;
      int vx[4], vy[4], cx, cy;
      if (mb_type == 2) {
        int sx = 0, sy = 0;
        for (int n = 0; n < 4; ++n) {
          int px, py;
          pred_mv(v, stride, base, mb_x, mb_y, n, px, py);
          vx[n] = mvd(r, px, f_code);
          vy[n] = mvd(r, py, f_code);
          if (r.err) return;
          int i = base + (n >> 1) * stride + (n & 1);
          v.mvx[i] = (int16_t)vx[n]; v.mvy[i] = (int16_t)vy[n];
          sx += vx[n]; sy += vy[n];
        }
        cx = chroma_mv_4(sx); cy = chroma_mv_4(sy);
      } else {
        int px, py;
        pred_mv(v, stride, base, mb_x, mb_y, 0, px, py);
        int x = mvd(r, px, f_code), y = mvd(r, py, f_code);
        if (r.err) return;
        for (int n = 0; n < 4; ++n) { vx[n] = x; vy[n] = y; }
        const int cells[4] = {base, base + 1, base + stride, base + stride + 1};
        for (int k = 0; k < 4; ++k) { v.mvx[cells[k]] = (int16_t)x; v.mvy[cells[k]] = (int16_t)y; }
        cx = chroma_mv_1(x); cy = chroma_mv_1(y);
      }
      for (int n = 0; n < 4; ++n) {
        v.mv[2 * (b0 + n)] = (int16_t)vx[n]; v.mv[2 * (b0 + n) + 1] = (int16_t)vy[n];
      }
      for (int n = 4; n < 6; ++n) {
        v.mv[2 * (b0 + n)] = (int16_t)cx; v.mv[2 * (b0 + n) + 1] = (int16_t)cy;
      }
      for (int n = 0; n < 6; ++n) {
        if ((cbp >> (5 - n)) & 1) {
          for (int k = 0; k < 64; ++k) blk[k] = 0;
          tcoef(r, blk, 0, SCAN_ZIGZAG, 1);
          if (r.err) return;
          int16_t* out = v.levels + (long long)(b0 + n) * 64;
          for (int k = 0; k < 64; ++k) out[k] = (int16_t)blk[k];
          v.coded[b0 + n] = 1;
        }
      }
    }
  }
}

__global__ void mpeg4_parse_kernel(const uint8_t* blob, int16_t* packed, int16_t* scratch, int* info, ParseArgs a) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.n_vops) return;
  const long long* offsets = reinterpret_cast<const long long*>(blob);
  const int* vols = reinterpret_cast<const int*>(blob + a.vols_at);
  const int* ids = reinterpret_cast<const int*>(blob + a.ids_at);
  const uint8_t* data = blob + a.data_at;
  const long long start = offsets[3 * t], vop_at = offsets[3 * t + 1], end = offsets[3 * t + 2];
  const int vid = ids[t];
  int* out = info + 4 * t;
  if (vid < 0 || vid >= a.n_vols) { out[2] = -1; return; }
  const int time_bits = vols[4 * vid], resync_disable = vols[4 * vid + 1], quant_precision = vols[4 * vid + 2];

  Bits r{data + start, end - start, (end - start) * 8, (vop_at - start) * 8, 0, 0};
  Vop v;
  v.mb_w = a.mb_w; v.mb_h = a.mb_h;
  const int n_mb = a.mb_w * a.mb_h, n_blk = 6 * n_mb;
  int16_t* row = packed + (long long)t * a.row_len;
  v.levels = row; v.qs = row + 64 * n_blk; v.intra = v.qs + n_mb; v.mv = v.intra + n_mb; v.coded = v.mv + 2 * n_blk;
  v.grid_stride[0] = 2 * a.mb_w + 1; v.grid_stride[1] = v.grid_stride[2] = a.mb_w + 1;
  const int g0 = (2 * a.mb_h + 1) * (2 * a.mb_w + 1), g1 = (a.mb_h + 1) * (a.mb_w + 1);
  v.grid_at[0] = 0; v.grid_at[1] = g0; v.grid_at[2] = g0 + g1;
  const int grids = g0 + 2 * g1;
  int16_t* s = scratch + (long long)t * a.scratch_len;
  v.dc = s; v.ac = s + grids;
  v.mvx = s + 17 * grids; v.mvy = v.mvx + (2 * a.mb_h + 1) * (2 * a.mb_w + 2);

  int kind = 0, rounding = 0;
  const int ctype = r.read(2);
  if (ctype == 2) r.fail(E_BVOP, r.pos);
  else if (ctype == 3) r.fail(E_SVOP, r.pos);
  while (!r.err && r.bit()) {  // modulo_time_base
    if (r.size - r.pos <= 0) r.fail(E_TRUNCATED, r.pos);
  }
  if (!r.err) r.marker(M_MODULO);
  if (!r.err) { r.read(time_bits); r.marker(M_TIME); }
  if (!r.err) {
    if (!r.bit()) {  // vop_coded 0
      kind = 2;
    } else {
      kind = ctype == 1 ? 1 : 0;
      rounding = ctype == 1 ? r.bit() : 0;
      const int dc_thr = kTab[T_DC_THR + r.read(3)];
      const int q = r.read(quant_precision);
      if (q == 0) {
        r.fail(E_QUANT0, r.pos);
      } else {
        const int f_code = ctype == 1 ? r.read(3) : 1;
        if (f_code == 0) r.fail(E_FCODE0, r.pos);
        else macroblocks(r, v, ctype, q, f_code, dc_thr, resync_disable);
      }
    }
  }
  out[0] = kind;
  out[1] = rounding;
  out[2] = r.err;
  out[3] = (int)r.err_pos;
}

}  // namespace

extern "C" int mpeg4_parse_launch(const void* blob, void* packed, void* scratch, void* info, const void* tab,
                                  const void* args, void* stream) {
  const ParseArgs* a = static_cast<const ParseArgs*>(args);
  if (a->n_vops <= 0 || a->mb_w <= 0 || a->mb_h <= 0 || a->tab_len != T_LEN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // the tables, once a device (they never change)
  static bool uploaded[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!uploaded[dev]) {
    err = cudaMemcpyToSymbolAsync(kTab, tab, sizeof(int16_t) * T_LEN, 0, cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return (int)err;
    err = cudaStreamSynchronize(s);
    if (err != cudaSuccess) return (int)err;
    uploaded[dev] = true;
  }
  const int threads = 32;
  mpeg4_parse_kernel<<<(a->n_vops + threads - 1) / threads, threads, 0, s>>>(
      (const uint8_t*)blob, (int16_t*)packed, (int16_t*)scratch, (int*)info, *a);
  return (int)cudaGetLastError();
}
