// Baseline JPEG decode and encode on the card through nvJPEG, the CUDA
// toolkit's JPEG library, for the frame reader and the scene writer
// (instag_torch/data/image_io.py). This is file I/O, not the counterpart of
// a TPU kernel: the JAX package decodes with libjpeg on the host
// (native/loader.cpp, PIL) and encodes with PIL. Decoded frames land on the
// card, where the frame batch lives.
//
// Decoding reproduces libjpeg's output stage: nvJPEG decodes to the native
// planes (Y, Cb, Cr at the file's subsampling), and ycc_to_rgb_kernel
// upsamples the chroma with libjpeg's "fancy" triangle filter (h2v2 for
// 4:2:0, h2v1 for 4:2:2: 3/4 nearer + 1/4 farther sample in each
// subsampled direction, edges replicated, libjpeg's rounding) and converts
// with libjpeg's fixed-point YCbCr -> RGB (jdcolor.c). nvJPEG's own RGB
// output upsamples otherwise and differs by up to ~33 levels along colour
// edges. What remains is the IDCT (libjpeg's islow against nvJPEG's).
// Other subsamplings (4:4:0, 4:1:1, 4:1:0) take nvJPEG's RGB output.
// The kernel is bound by bytes: it reads each plane sample about once
// (neighbours come from L1/L2) and writes 3 bytes a pixel.
//
// Plain C interface, loaded with ctypes (instag_torch/kernels.py, linked
// with -lnvjpeg):
//   jpeg_codec_image_info(data, len, &height, &width, &components)
//   jpeg_codec_decode(data, len, out, planes, height, width, stream)
//       host bitstream -> interleaved RGB uint8 [height, width, 3] at the
//       device pointer `out`, on `stream` (no synchronisation); `planes`
//       is device scratch of 3 * height * width bytes.
//   jpeg_codec_encode(img, height, width, quality, out, &length, stream)
//       interleaved RGB uint8 at the device pointer `img` -> a baseline
//       JPEG (4:2:0, standard Huffman tables) in the host buffer `out` of
//       capacity *length; *length becomes the size written (or needed).
//       Synchronises `stream`: the bitstream is read back to the host.
//   jpeg_codec_error_string(code)
// Each returns 0, a cudaError_t, or JPEG_CODEC_NVJPEG + an nvjpegStatus_t.
// One library handle and one decoder and encoder state per process; the
// calls are not thread-safe.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>
#include <cstdio>
#include <cstring>

namespace {

constexpr int JPEG_CODEC_NVJPEG = 10000;
constexpr int JPEG_CODEC_SIZE_MISMATCH = 20001;
constexpr int JPEG_CODEC_BUFFER_TOO_SMALL = 20002;

nvjpegHandle_t g_handle = nullptr;
nvjpegJpegState_t g_dec_state = nullptr;
nvjpegEncoderState_t g_enc_state = nullptr;
nvjpegEncoderParams_t g_enc_params = nullptr;

int nvj(nvjpegStatus_t s) {
  return s == NVJPEG_STATUS_SUCCESS ? 0 : JPEG_CODEC_NVJPEG + (int)s;
}

int ensure_handle() {
  if (g_handle != nullptr) return 0;
  return nvj(nvjpegCreateSimple(&g_handle));
}

// libjpeg's fancy upsampling of one chroma plane at output pixel (row, x):
// hs, vs the horizontal and vertical factors (1 or 2; vs = 2 only with
// hs = 2)
__device__ __forceinline__ int upsample(const unsigned char* p, int pitch,
                                        int cw, int ch, int hs, int vs,
                                        int row, int x) {
  int cx = x / hs, cy = row / vs;
  if (hs == 1) return p[cy * pitch + cx];
  int cxo = (x & 1) ? min(cx + 1, cw - 1) : max(cx - 1, 0);
  if (vs == 1) {
    int a = p[cy * pitch + cx], b = p[cy * pitch + cxo];
    return (3 * a + b + ((x & 1) ? 2 : 1)) >> 2;
  }
  int cyo = (row & 1) ? min(cy + 1, ch - 1) : max(cy - 1, 0);
  int col = 3 * p[cy * pitch + cx] + p[cyo * pitch + cx];
  int colo = 3 * p[cy * pitch + cxo] + p[cyo * pitch + cxo];
  return (3 * col + colo + ((x & 1) ? 7 : 8)) >> 4;
}

__device__ __forceinline__ unsigned char clamp255(int v) {
  return (unsigned char)min(max(v, 0), 255);
}

// one thread a pixel of one row (blockIdx.y); cb == nullptr: grayscale
__global__ void ycc_to_rgb_kernel(const unsigned char* __restrict__ y,
                                  const unsigned char* __restrict__ cb,
                                  const unsigned char* __restrict__ cr,
                                  int cpitch, int cw, int ch, int hs, int vs,
                                  int height, int width,
                                  unsigned char* __restrict__ out) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int row = blockIdx.y;
  if (x >= width || row >= height) return;
  int Y = y[row * width + x];
  unsigned char* o = out + ((size_t)row * width + x) * 3;
  if (cb == nullptr) {
    o[0] = o[1] = o[2] = (unsigned char)Y;
    return;
  }
  int b = upsample(cb, cpitch, cw, ch, hs, vs, row, x) - 128;
  int r = upsample(cr, cpitch, cw, ch, hs, vs, row, x) - 128;
  // libjpeg's FIX(1.40200), FIX(0.34414), FIX(0.71414), FIX(1.77200) at
  // 16 bits, ONE_HALF = 1 << 15
  o[0] = clamp255(Y + ((91881 * r + 32768) >> 16));
  o[1] = clamp255(Y + ((-22554 * b + 32768 - 46802 * r) >> 16));
  o[2] = clamp255(Y + ((116130 * b + 32768) >> 16));
}

}  // namespace

extern "C" int jpeg_codec_image_info(const unsigned char* data, size_t len,
                                     int* height, int* width,
                                     int* components) {
  int err = ensure_handle();
  if (err) return err;
  int n = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT];
  int heights[NVJPEG_MAX_COMPONENT];
  err = nvj(nvjpegGetImageInfo(g_handle, data, len, &n, &subsampling,
                               widths, heights));
  if (err) return err;
  *height = heights[0];
  *width = widths[0];
  *components = n;
  return 0;
}

extern "C" int jpeg_codec_decode(const unsigned char* data, size_t len,
                                 unsigned char* out, unsigned char* planes,
                                 int height, int width, cudaStream_t stream) {
  int err = ensure_handle();
  if (err) return err;
  int n = 0;
  nvjpegChromaSubsampling_t ss;
  int widths[NVJPEG_MAX_COMPONENT];
  int heights[NVJPEG_MAX_COMPONENT];
  err = nvj(nvjpegGetImageInfo(g_handle, data, len, &n, &ss, widths,
                               heights));
  if (err) return err;
  if (heights[0] != height || widths[0] != width)
    return JPEG_CODEC_SIZE_MISMATCH;
  if (g_dec_state == nullptr) {
    err = nvj(nvjpegJpegStateCreate(g_handle, &g_dec_state));
    if (err) return err;
  }
  int hs = 0, vs = 0;
  if (ss == NVJPEG_CSS_444) hs = vs = 1;
  else if (ss == NVJPEG_CSS_422) { hs = 2; vs = 1; }
  else if (ss == NVJPEG_CSS_420) hs = vs = 2;
  nvjpegImage_t dst;
  std::memset(&dst, 0, sizeof(dst));
  if (hs == 0 && ss != NVJPEG_CSS_GRAY) {
    // a subsampling libjpeg's output stage is not reproduced for
    dst.channel[0] = out;
    dst.pitch[0] = (size_t)width * 3;
    err = nvj(nvjpegDecode(g_handle, g_dec_state, data, len,
                           NVJPEG_OUTPUT_RGBI, &dst, stream));
    if (err) return err;
    return (int)cudaGetLastError();
  }
  int cw = ss == NVJPEG_CSS_GRAY ? 0 : widths[1];
  int ch = ss == NVJPEG_CSS_GRAY ? 0 : heights[1];
  unsigned char* cb = planes + (size_t)height * width;
  unsigned char* cr = cb + (size_t)cw * ch;
  dst.channel[0] = planes;
  dst.pitch[0] = (size_t)width;
  if (ss != NVJPEG_CSS_GRAY) {
    dst.channel[1] = cb;
    dst.pitch[1] = (size_t)cw;
    dst.channel[2] = cr;
    dst.pitch[2] = (size_t)cw;
  }
  err = nvj(nvjpegDecode(g_handle, g_dec_state, data, len,
                         NVJPEG_OUTPUT_YUV, &dst, stream));
  if (err) return err;
  dim3 grid((width + 127) / 128, height);
  ycc_to_rgb_kernel<<<grid, 128, 0, stream>>>(
      planes, ss == NVJPEG_CSS_GRAY ? nullptr : cb,
      ss == NVJPEG_CSS_GRAY ? nullptr : cr, cw, cw, ch, hs, vs, height,
      width, out);
  return (int)cudaGetLastError();
}

extern "C" int jpeg_codec_encode(const unsigned char* img, int height,
                                 int width, int quality, unsigned char* out,
                                 size_t* length, cudaStream_t stream) {
  int err = ensure_handle();
  if (err) return err;
  if (g_enc_state == nullptr) {
    err = nvj(nvjpegEncoderStateCreate(g_handle, &g_enc_state, stream));
    if (err) return err;
    err = nvj(nvjpegEncoderParamsCreate(g_handle, &g_enc_params, stream));
    if (err) return err;
  }
  err = nvj(nvjpegEncoderParamsSetQuality(g_enc_params, quality, stream));
  if (err) return err;
  err = nvj(nvjpegEncoderParamsSetSamplingFactors(g_enc_params,
                                                  NVJPEG_CSS_420, stream));
  if (err) return err;
  err = nvj(nvjpegEncoderParamsSetOptimizedHuffman(g_enc_params, 0, stream));
  if (err) return err;
  nvjpegImage_t src;
  std::memset(&src, 0, sizeof(src));
  src.channel[0] = const_cast<unsigned char*>(img);
  src.pitch[0] = (size_t)width * 3;
  err = nvj(nvjpegEncodeImage(g_handle, g_enc_state, g_enc_params, &src,
                              NVJPEG_INPUT_RGBI, width, height, stream));
  if (err) return err;
  size_t needed = 0;
  err = nvj(nvjpegEncodeRetrieveBitstream(g_handle, g_enc_state, nullptr,
                                          &needed, stream));
  if (err) return err;
  cudaError_t cerr = cudaStreamSynchronize(stream);
  if (cerr != cudaSuccess) return (int)cerr;
  if (needed > *length) {
    *length = needed;
    return JPEG_CODEC_BUFFER_TOO_SMALL;
  }
  err = nvj(nvjpegEncodeRetrieveBitstream(g_handle, g_enc_state, out,
                                          &needed, stream));
  if (err) return err;
  cerr = cudaStreamSynchronize(stream);
  if (cerr != cudaSuccess) return (int)cerr;
  *length = needed;
  return 0;
}

extern "C" const char* jpeg_codec_error_string(int code) {
  static char buf[96];
  if (code == JPEG_CODEC_SIZE_MISMATCH)
    return "JPEG size differs from the requested height and width";
  if (code == JPEG_CODEC_BUFFER_TOO_SMALL)
    return "output buffer too small for the encoded JPEG";
  if (code >= JPEG_CODEC_NVJPEG) {
    std::snprintf(buf, sizeof(buf), "nvJPEG status %d",
                  code - JPEG_CODEC_NVJPEG);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)code);
}
