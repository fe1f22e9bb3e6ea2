// H.264 decode on the card's NVDEC, and nv12_rgb, the colour conversion of
// its pictures, for Hopper (sm_90a).  The JAX package decodes H.264 with
// libavcodec and converts yuv420p -> rgb24 with libswscale
// (native/decode_shim.cc:147-204, fvd_read_frames; or OpenCV's
// VideoCapture, fvd_tpu/providers/media.py:541); no Pallas kernel is
// involved.  The port hands each access unit to the card's hardware decoder
// and converts the NV12 picture it gives with a kernel of its own.
//
// The session.  The toolkit ships no nvcuvid.h or cuviddec.h, so the subset
// of the Video Codec SDK's public API used here is declared below, and
// libnvcuvid.so.1 and libcuda.so.1 are opened at run time (no link flag).
// The parser's callbacks are C: the sequence callback checks the card's
// capabilities and creates the decoder (NV12, weave, the whole coded frame
// out: nv12_rgb reads the display rectangle); the decode callback passes the
// CUVIDPICPARAMS it is given, untouched, to cuvidDecodePicture; the display
// callback queues the picture, in display order.  The caller feeds one
// access unit at a time and reads every queued picture before the next feed
// (nvdec_map, then the kernel, then nvdec_unmap; or nvdec_skip), and an
// end-of-stream packet flushes the queue.  Each session holds its own parser
// and decoder and pushes the device's primary context in every call, so
// sessions run from several threads at once.  Every CUresult comes back to
// the caller, with a message (nvdec_message); nothing is retried.
//
// nv12_rgb: one thread per 2x2 quad of the display rectangle, luma and the
// interleaved Cb Cr plane read at the surface pitch (the chroma plane starts
// pitch x surface height after the luma); libswscale's unscaled yuv -> rgb24
// in the 16-bit fixed-point form of its x86 build, the arithmetic of
// yuv420_rgb in mpeg4_decode.cu (8Y - 128 not clamped).
//
// Bound on an H100.  A 320x240 picture: 76.8 KB of luma and 38.4 KB of chroma
// read, 230.4 KB of RGB written, about a million integer operations: 345.6 KB
// at 3.35 TB/s is 0.1 us, so the launch and the per-picture map, sync and
// unmap bound the conversion; the decode itself runs in NVDEC, beside the SMs.

#include <cuda.h>  // driver API types; the functions come from libcuda.so.1 at run time
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <deque>
#include <mutex>
#include <string>

namespace {

// ---------------------------------------------------------------- the SDK subset
// (nvcuvid.h and cuviddec.h of the NVIDIA Video Codec SDK; sizes on LP64)
typedef void* CUvideoparser;
typedef void* CUvideodecoder;
typedef long long CUvideotimestamp;

constexpr int kCodecH264 = 4;            // cudaVideoCodec_H264
constexpr int kChroma420 = 1;            // cudaVideoChromaFormat_420
constexpr int kSurfaceNV12 = 0;          // cudaVideoSurfaceFormat_NV12
constexpr int kDeinterlaceWeave = 0;     // cudaVideoDeinterlaceMode_Weave
constexpr int kCreatePreferCUVID = 4;    // cudaVideoCreate_PreferCUVID
constexpr unsigned long kPktEndOfStream = 0x01, kPktEndOfPicture = 0x08;

struct VideoFormat {  // CUVIDEOFORMAT
  int codec;
  struct { unsigned int numerator, denominator; } frame_rate;
  unsigned char progressive_sequence, bit_depth_luma_minus8, bit_depth_chroma_minus8, min_num_decode_surfaces;
  unsigned int coded_width, coded_height;
  struct { int left, top, right, bottom; } display_area;
  int chroma_format;
  unsigned int bitrate;
  struct { int x, y; } display_aspect_ratio;
  unsigned char video_signal_bits, color_primaries, transfer_characteristics, matrix_coefficients;
  unsigned int seqhdr_data_length;
};
static_assert(sizeof(VideoFormat) == 64, "CUVIDEOFORMAT is 64 bytes");

struct SourcePacket {  // CUVIDSOURCEDATAPACKET
  unsigned long flags;
  unsigned long payload_size;
  const unsigned char* payload;
  CUvideotimestamp timestamp;
};
static_assert(sizeof(SourcePacket) == 32, "CUVIDSOURCEDATAPACKET is 32 bytes");

struct DisplayInfo {  // CUVIDPARSERDISPINFO
  int picture_index, progressive_frame, top_field_first, repeat_first_field;
  CUvideotimestamp timestamp;
};
static_assert(sizeof(DisplayInfo) == 24, "CUVIDPARSERDISPINFO is 24 bytes");

typedef int (*SequenceCallback)(void*, VideoFormat*);
typedef int (*DecodeCallback)(void*, void*);  // CUVIDPICPARAMS*, opaque here
typedef int (*DisplayCallback)(void*, DisplayInfo*);

struct ParserParams {  // CUVIDPARSERPARAMS
  int codec_type;
  unsigned int max_num_decode_surfaces, clock_rate, error_threshold, max_display_delay;
  unsigned int annexb_and_reserved;
  unsigned int reserved1[4];
  void* user_data;
  SequenceCallback on_sequence;
  DecodeCallback on_decode;
  DisplayCallback on_display;
  void* on_operating_point;
  void* on_sei_message;
  void* reserved2[5];
  void* ext_video_info;
};
static_assert(sizeof(ParserParams) == 136, "CUVIDPARSERPARAMS is 136 bytes");

struct DecodeCaps {  // CUVIDDECODECAPS
  int codec_type, chroma_format;
  unsigned int bit_depth_minus8, reserved1[3];
  unsigned char is_supported, num_nvdecs;
  unsigned short output_format_mask;
  unsigned int max_width, max_height, max_mb_count;
  unsigned short min_width, min_height;
  unsigned char histogram_supported, counter_bit_depth;
  unsigned short max_histogram_bins;
  unsigned int reserved3[10];
};
static_assert(sizeof(DecodeCaps) == 88, "CUVIDDECODECAPS is 88 bytes");

struct Rect16 { short left, top, right, bottom; };

struct DecoderCreateInfo {  // CUVIDDECODECREATEINFO
  unsigned long width, height, num_decode_surfaces;
  int codec_type, chroma_format;
  unsigned long creation_flags, bit_depth_minus8, intra_decode_only, max_width, max_height, reserved1;
  Rect16 display_area;
  int output_format, deinterlace_mode;
  unsigned long target_width, target_height, num_output_surfaces;
  void* vid_lock;
  Rect16 target_rect;
  unsigned long enable_histogram, reserved2[4];
};
static_assert(sizeof(DecoderCreateInfo) == 176, "CUVIDDECODECREATEINFO is 176 bytes");

struct ProcParams {  // CUVIDPROCPARAMS
  int progressive_frame, second_field, top_field_first, unpaired_field;
  unsigned int reserved_flags, reserved_zero;
  unsigned long long raw_input_dptr;
  unsigned int raw_input_pitch, raw_input_format;
  unsigned long long raw_output_dptr;
  unsigned int raw_output_pitch, reserved1;
  CUstream output_stream;
  unsigned int reserved[46];
  unsigned long long* histogram_dptr;
  void* reserved2[1];
};
static_assert(sizeof(ProcParams) == 264, "CUVIDPROCPARAMS is 264 bytes");

// A struct the library reads, in zeroed room to spare: a newer SDK's longer
// struct finds zeros (its reserved fields) past the fields declared here.
template <class T>
struct Zeroed {
  union { T v; unsigned char room[1024]; };
  Zeroed() { memset(room, 0, sizeof room); }
};

struct Api {
  CUresult (*init)(unsigned int);
  CUresult (*device_get)(CUdevice*, int);
  CUresult (*ctx_retain)(CUcontext*, CUdevice);
  CUresult (*ctx_release)(CUdevice);
  CUresult (*ctx_push)(CUcontext);
  CUresult (*ctx_pop)(CUcontext*);
  CUresult (*create_parser)(CUvideoparser*, ParserParams*);
  CUresult (*parse)(CUvideoparser, SourcePacket*);
  CUresult (*destroy_parser)(CUvideoparser);
  CUresult (*create_decoder)(CUvideodecoder*, DecoderCreateInfo*);
  CUresult (*destroy_decoder)(CUvideodecoder);
  CUresult (*decode_picture)(CUvideodecoder, void*);
  CUresult (*get_caps)(DecodeCaps*);
  CUresult (*map)(CUvideodecoder, int, unsigned long long*, unsigned int*, ProcParams*);
  CUresult (*unmap)(CUvideodecoder, unsigned long long);
};

// the session's own error codes (a CUresult is >= 0)
constexpr int kErrNoCuda = -1, kErrNoNvcuvid = -2, kErrSymbol = -3, kErrFormat = -4, kErrReuse = -5,
              kErrEmpty = -6, kErrOrder = -7;

Api g_api;
int g_load_err = 0;
bool g_loaded = false;
std::string g_load_msg;
std::mutex g_load_lock;
thread_local std::string t_msg;  // what the last failed nvdec_open or nvdec_caps said

int load_symbols() {
  void* cuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
  if (!cuda) { g_load_msg = dlerror(); return kErrNoCuda; }
  void* cuvid = dlopen("libnvcuvid.so.1", RTLD_NOW | RTLD_LOCAL);
  if (!cuvid) { g_load_msg = dlerror(); return kErrNoNvcuvid; }
  struct { void* lib; void** slot; const char* name; } syms[] = {
      {cuda, (void**)&g_api.init, "cuInit"},
      {cuda, (void**)&g_api.device_get, "cuDeviceGet"},
      {cuda, (void**)&g_api.ctx_retain, "cuDevicePrimaryCtxRetain"},
      {cuda, (void**)&g_api.ctx_release, "cuDevicePrimaryCtxRelease_v2"},
      {cuda, (void**)&g_api.ctx_push, "cuCtxPushCurrent_v2"},
      {cuda, (void**)&g_api.ctx_pop, "cuCtxPopCurrent_v2"},
      {cuvid, (void**)&g_api.create_parser, "cuvidCreateVideoParser"},
      {cuvid, (void**)&g_api.parse, "cuvidParseVideoData"},
      {cuvid, (void**)&g_api.destroy_parser, "cuvidDestroyVideoParser"},
      {cuvid, (void**)&g_api.create_decoder, "cuvidCreateDecoder"},
      {cuvid, (void**)&g_api.destroy_decoder, "cuvidDestroyDecoder"},
      {cuvid, (void**)&g_api.decode_picture, "cuvidDecodePicture"},
      {cuvid, (void**)&g_api.get_caps, "cuvidGetDecoderCaps"},
      {cuvid, (void**)&g_api.map, "cuvidMapVideoFrame64"},
      {cuvid, (void**)&g_api.unmap, "cuvidUnmapVideoFrame64"},
  };
  for (auto& sym : syms) {
    *sym.slot = dlsym(sym.lib, sym.name);
    if (!*sym.slot) { g_load_msg = std::string("no symbol ") + sym.name; return kErrSymbol; }
  }
  return 0;
}

int load_api() {  // once a process
  std::lock_guard<std::mutex> lock(g_load_lock);
  if (!g_loaded) {
    g_load_err = load_symbols();
    g_loaded = true;
  }
  return g_load_err;
}

struct Session {
  CUdevice device = 0;
  CUcontext ctx = nullptr;
  CUvideoparser parser = nullptr;
  CUvideodecoder decoder = nullptr;
  std::deque<DisplayInfo> queue;  // pictures to show, in display order
  bool mapped = false;
  unsigned long long mapped_ptr = 0;
  unsigned int coded_w = 0, coded_h = 0, surfaces = 0;
  int left = 0, top = 0, width = 0, height = 0;
  int err = 0;
  std::string msg;

  int fail(int code, const std::string& what) {  // 0: what a callback returns on failure
    if (!err) { err = code; msg = what; }
    return 0;
  }
  int error(int code, const std::string& what) {  // the code: what an entry point returns
    fail(code, what);
    return code;
  }
};

struct Pushed {  // the session's context current on this thread for a scope
  CUresult r;
  explicit Pushed(Session* s) : r(g_api.ctx_push(s->ctx)) {}
  ~Pushed() { if (r == CUDA_SUCCESS) { CUcontext c; g_api.ctx_pop(&c); } }
};

// more decode surfaces than the parser's least, so a queued picture is not
// decoded over while it waits to be read (on_decode checks it is not)
constexpr int kSpareSurfaces = 4;

int on_sequence(void* user, VideoFormat* f) {
  Session* s = static_cast<Session*>(user);
  if (f->codec != kCodecH264) return s->fail(kErrFormat, "not an H.264 stream");
  if (f->chroma_format != kChroma420 || f->bit_depth_luma_minus8 || f->bit_depth_chroma_minus8)
    return s->fail(kErrFormat, "chroma other than 4:2:0 or more than 8 bits");
  if (!f->progressive_sequence) return s->fail(kErrFormat, "an interlaced sequence");
  const int left = f->display_area.left, top = f->display_area.top;
  const int width = f->display_area.right - left, height = f->display_area.bottom - top;
  if (s->decoder) {
    if (f->coded_width == s->coded_w && f->coded_height == s->coded_h && left == s->left && top == s->top &&
        width == s->width && height == s->height)
      return (int)s->surfaces;
    return s->fail(kErrFormat, "the picture size changes inside the stream");
  }
  Zeroed<DecodeCaps> caps;
  caps.v.codec_type = kCodecH264;
  caps.v.chroma_format = kChroma420;
  CUresult r = g_api.get_caps(&caps.v);
  if (r) return s->fail(r, "cuvidGetDecoderCaps");
  const DecodeCaps& c = caps.v;
  if (!c.is_supported || !(c.output_format_mask & (1 << kSurfaceNV12)) || f->coded_width > c.max_width ||
      f->coded_height > c.max_height || f->coded_width < c.min_width || f->coded_height < c.min_height ||
      (f->coded_width / 16) * (f->coded_height / 16) > c.max_mb_count)
    return s->fail(kErrFormat, "this card's NVDEC does not decode H.264 4:2:0 8-bit at " +
                                   std::to_string(f->coded_width) + "x" + std::to_string(f->coded_height) +
                                   " (at most " + std::to_string(c.max_width) + "x" + std::to_string(c.max_height) +
                                   ", at least " + std::to_string(c.min_width) + "x" + std::to_string(c.min_height) + ")");
  s->surfaces = std::max<int>(f->min_num_decode_surfaces, 1) + kSpareSurfaces;
  Zeroed<DecoderCreateInfo> ci;
  ci.v.width = ci.v.max_width = ci.v.target_width = f->coded_width;
  ci.v.height = ci.v.max_height = ci.v.target_height = f->coded_height;
  ci.v.num_decode_surfaces = s->surfaces;
  ci.v.codec_type = kCodecH264;
  ci.v.chroma_format = kChroma420;
  ci.v.creation_flags = kCreatePreferCUVID;
  ci.v.display_area = Rect16{0, 0, (short)f->coded_width, (short)f->coded_height};
  ci.v.output_format = kSurfaceNV12;
  ci.v.deinterlace_mode = kDeinterlaceWeave;
  ci.v.num_output_surfaces = 2;
  r = g_api.create_decoder(&s->decoder, &ci.v);
  if (r) { s->decoder = nullptr; return s->fail(r, "cuvidCreateDecoder"); }
  s->coded_w = f->coded_width;
  s->coded_h = f->coded_height;
  s->left = left; s->top = top; s->width = width; s->height = height;
  return (int)s->surfaces;
}

int on_decode(void* user, void* pic) {
  Session* s = static_cast<Session*>(user);
  if (!s->decoder) return s->fail(kErrOrder, "a picture before its sequence header");
  const int index = static_cast<const int*>(pic)[2];  // CUVIDPICPARAMS::CurrPicIdx
  for (const DisplayInfo& d : s->queue)
    if (d.picture_index == index)
      return s->fail(kErrReuse, "surface " + std::to_string(index) + " decoded over before it was read");
  CUresult r = g_api.decode_picture(s->decoder, pic);
  if (r) return s->fail(r, "cuvidDecodePicture");
  return 1;
}

int on_display(void* user, DisplayInfo* d) {
  if (d) static_cast<Session*>(user)->queue.push_back(*d);
  return 1;
}

void destroy(Session* s) {
  if (s->ctx) {
    Pushed p(s);
    if (s->mapped) g_api.unmap(s->decoder, s->mapped_ptr);
    if (s->parser) g_api.destroy_parser(s->parser);
    if (s->decoder) g_api.destroy_decoder(s->decoder);
  }
  if (s->ctx) g_api.ctx_release(s->device);
  delete s;
}

// libswscale's fixed-point coefficients (as in mpeg4_decode.cu)
constexpr int Y_COEFF = 9539, VR_COEFF = 13075, UB_COEFF = 16525, UG_COEFF = -3209, VG_COEFF = -6660;
constexpr int Y_OFFSET = 128;

struct Nv12Args {
  int width, height, luma_pitch, uv_pitch, out_pitch;
};

__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }

__global__ void nv12_rgb_kernel(const uint8_t* __restrict__ luma, const uint8_t* __restrict__ uv,
                                uint8_t* __restrict__ rgb, Nv12Args a) {
  const int qx = blockIdx.x * blockDim.x + threadIdx.x;
  const int qy = blockIdx.y * blockDim.y + threadIdx.y;
  if (2 * qx >= a.width || 2 * qy >= a.height) return;
  const uint8_t* c = uv + (size_t)qy * a.uv_pitch + 2 * qx;
  const int u = 8 * c[0] - 1024, v = 8 * c[1] - 1024;
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
      const int yv = ((8 * luma[(size_t)yy * a.luma_pitch + xx] - Y_OFFSET) * Y_COEFF) >> 16;  // not clamped
      uint8_t* o = rgb + (size_t)yy * a.out_pitch + 3 * xx;
      o[0] = (uint8_t)clip255(yv + dr);
      o[1] = (uint8_t)clip255(yv + dg);
      o[2] = (uint8_t)clip255(yv + db);
    }
  }
}

}  // namespace

extern "C" int nv12_rgb_launch(const void* luma, const void* uv, void* rgb, const void* args, void* stream) {
  const Nv12Args* a = static_cast<const Nv12Args*>(args);
  if (a->width <= 0 || a->height <= 0 || a->luma_pitch < a->width || a->uv_pitch < a->width ||
      a->out_pitch < 3 * a->width)
    return (int)cudaErrorInvalidValue;
  dim3 block(16, 8);
  dim3 grid(((a->width + 1) / 2 + block.x - 1) / block.x, ((a->height + 1) / 2 + block.y - 1) / block.y);
  nv12_rgb_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((const uint8_t*)luma, (const uint8_t*)uv,
                                                            (uint8_t*)rgb, *a);
  return (int)cudaGetLastError();
}

// A session on card `device`: libraries loaded, the primary context
// retained, the parser created.  On failure *out stays null and
// nvdec_message(NULL, ...) says why.
extern "C" int nvdec_open(int device, void** out) {
  *out = nullptr;
  if (int e = load_api()) { t_msg = g_load_msg; return e; }
  Session* s = new Session;
  CUresult r = g_api.init(0);
  if (!r) r = g_api.device_get(&s->device, device);
  if (!r) r = g_api.ctx_retain(&s->ctx, s->device);
  if (r) { s->ctx = nullptr; destroy(s); t_msg = "cuInit / cuDeviceGet / cuDevicePrimaryCtxRetain"; return r; }
  Zeroed<ParserParams> p;
  p.v.codec_type = kCodecH264;
  p.v.max_num_decode_surfaces = 1;  // on_sequence returns the number the stream needs
  p.v.max_display_delay = 0;
  p.v.user_data = s;
  p.v.on_sequence = on_sequence;
  p.v.on_decode = on_decode;
  p.v.on_display = on_display;
  {
    Pushed pushed(s);
    r = pushed.r ? pushed.r : g_api.create_parser(&s->parser, &p.v);
  }
  if (r) { s->parser = nullptr; destroy(s); t_msg = "cuvidCreateVideoParser"; return r; }
  *out = s;
  return 0;
}

extern "C" int nvdec_close(void* h) {
  if (h) destroy(static_cast<Session*>(h));
  return 0;
}

// Parse one Annex B access unit (or, with eos, flush): its picture is
// decoded and the pictures it lets out are queued.
extern "C" int nvdec_feed(void* h, const void* data, long long size, int eos) {
  Session* s = static_cast<Session*>(h);
  if (s->err) return s->err;
  if (s->mapped) return s->error(kErrOrder, "nvdec_feed while a picture is mapped");
  Pushed pushed(s);
  if (pushed.r) return s->error(pushed.r, "cuCtxPushCurrent");
  Zeroed<SourcePacket> pkt;
  pkt.v.flags = eos ? kPktEndOfStream : kPktEndOfPicture;
  pkt.v.payload = static_cast<const unsigned char*>(data);
  pkt.v.payload_size = eos ? 0 : (unsigned long)size;
  CUresult r = g_api.parse(s->parser, &pkt.v);
  if (s->err) return s->err;
  if (r) return s->error(r, "cuvidParseVideoData");
  return 0;
}

extern "C" int nvdec_pending(void* h) { return (int)static_cast<Session*>(h)->queue.size(); }

// Map the next picture to show, its NV12 surface ready on `stream`: info
// gets the device pointer, the pitch, the luma rows before the chroma plane,
// the display width, height, left and top, and the surface index.
extern "C" int nvdec_map(void* h, void* stream, long long* info) {
  Session* s = static_cast<Session*>(h);
  if (s->err) return s->err;
  if (s->queue.empty()) return s->error(kErrEmpty, "nvdec_map with no picture queued");
  if (s->mapped) return s->error(kErrOrder, "nvdec_map while a picture is mapped");
  Pushed pushed(s);
  if (pushed.r) return s->error(pushed.r, "cuCtxPushCurrent");
  const DisplayInfo d = s->queue.front();
  Zeroed<ProcParams> vpp;
  vpp.v.progressive_frame = d.progressive_frame;
  vpp.v.second_field = d.repeat_first_field + 1;
  vpp.v.top_field_first = d.top_field_first;
  vpp.v.unpaired_field = d.repeat_first_field < 0;
  vpp.v.output_stream = static_cast<CUstream>(stream);
  unsigned long long ptr = 0;
  unsigned int pitch = 0;
  CUresult r = g_api.map(s->decoder, d.picture_index, &ptr, &pitch, &vpp.v);
  if (r) return s->error(r, "cuvidMapVideoFrame64");
  s->mapped = true;
  s->mapped_ptr = ptr;
  const long long out[8] = {(long long)ptr, pitch, (long long)s->coded_h, s->width, s->height, s->left, s->top,
                            d.picture_index};
  memcpy(info, out, sizeof out);
  return 0;
}

// Unmap the mapped picture (the caller has synchronised the stream it read
// it on) and drop it from the queue.
extern "C" int nvdec_unmap(void* h) {
  Session* s = static_cast<Session*>(h);
  if (!s->mapped) return s->error(kErrOrder, "nvdec_unmap with no picture mapped");
  Pushed pushed(s);
  if (pushed.r) return s->error(pushed.r, "cuCtxPushCurrent");
  CUresult r = g_api.unmap(s->decoder, s->mapped_ptr);
  s->mapped = false;
  s->queue.pop_front();
  if (r) return s->error(r, "cuvidUnmapVideoFrame64");
  return 0;
}

// Drop the next picture to show without reading it.
extern "C" int nvdec_skip(void* h) {
  Session* s = static_cast<Session*>(h);
  if (s->queue.empty() || s->mapped) return s->error(kErrOrder, "nvdec_skip out of turn");
  s->queue.pop_front();
  return 0;
}

// The card's H.264 4:2:0 8-bit decode capabilities: out gets supported, the
// number of NVDECs, the NV12-and-others output mask, max width, max height,
// max macroblocks, min width, min height.
extern "C" int nvdec_caps(int device, int* out) {
  if (int e = load_api()) { t_msg = g_load_msg; return e; }
  Session s;
  CUresult r = g_api.init(0);
  if (!r) r = g_api.device_get(&s.device, device);
  if (!r) r = g_api.ctx_retain(&s.ctx, s.device);
  if (r) { t_msg = "cuInit / cuDeviceGet / cuDevicePrimaryCtxRetain"; return r; }
  Zeroed<DecodeCaps> caps;
  caps.v.codec_type = kCodecH264;
  caps.v.chroma_format = kChroma420;
  {
    Pushed pushed(&s);
    r = pushed.r ? pushed.r : g_api.get_caps(&caps.v);
  }
  g_api.ctx_release(s.device);
  if (r) { t_msg = "cuvidGetDecoderCaps"; return r; }
  const DecodeCaps& c = caps.v;
  const int v[8] = {c.is_supported, c.num_nvdecs, c.output_format_mask, (int)c.max_width, (int)c.max_height,
                    (int)c.max_mb_count, c.min_width, c.min_height};
  memcpy(out, v, sizeof v);
  return 0;
}

// What went wrong in session h (or, for null, in this thread's last failed
// nvdec_open or nvdec_caps).
extern "C" int nvdec_message(void* h, char* buf, int len) {
  const std::string& m = h ? static_cast<Session*>(h)->msg : t_msg;
  if (len > 0) {
    strncpy(buf, m.c_str(), len - 1);
    buf[len - 1] = '\0';
  }
  return 0;
}
