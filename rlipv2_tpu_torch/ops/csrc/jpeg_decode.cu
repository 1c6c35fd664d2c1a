// JPEG decode with nvJPEG, behind a plain C interface for ctypes
// (data/image_io.py). The card's counterpart of PIL's `Image.open` +
// `convert("RGB")` in the JAX package's HICO loader: it replaces no TPU
// kernel (the JAX package decodes on the host) and holds no kernel of its
// own; nvJPEG does the Huffman decode on the calling host thread and the
// IDCT and colour conversion on the given stream.
//
// One handle serves every thread of the process; each decoding thread owns
// one nvjpegJpegState (nvJPEG's states are not thread-safe). The caller
// allocates the output on the card: (H, W, 3) uint8 interleaved RGB for a
// 3-component file, (H, W) uint8 luma for a grayscale one (the caller
// repeats it into RGB, as PIL's convert("RGB") does). Four-component
// (CMYK/YCCK) files are refused by the caller after `jpeg_info`.
//
// Every function returns 0 or an nvjpegStatus_t (< 1000) or 1000 + a
// cudaError_t from the launch check.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>

namespace {

int status(nvjpegStatus_t s) { return s == NVJPEG_STATUS_SUCCESS ? 0 : static_cast<int>(s); }

}  // namespace

extern "C" {

int jpeg_create(void** handle) {
  nvjpegHandle_t h = nullptr;
  int rc = status(nvjpegCreateSimple(&h));
  if (rc == 0) *handle = h;
  return rc;
}

int jpeg_destroy(void* handle) { return status(nvjpegDestroy(static_cast<nvjpegHandle_t>(handle))); }

int jpeg_state_create(void* handle, void** state) {
  nvjpegJpegState_t st = nullptr;
  int rc = status(nvjpegJpegStateCreate(static_cast<nvjpegHandle_t>(handle), &st));
  if (rc == 0) *state = st;
  return rc;
}

int jpeg_state_destroy(void* state) {
  return status(nvjpegJpegStateDestroy(static_cast<nvjpegJpegState_t>(state)));
}

// components: 1 (gray), 3 (YCbCr/RGB) or 4 (CMYK/YCCK); subsampling: the
// nvjpegChromaSubsampling_t code; width, height: of component 0.
int jpeg_info(void* handle, const unsigned char* data, size_t length, int* components,
              int* subsampling, int* width, int* height) {
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegChromaSubsampling_t ss = NVJPEG_CSS_UNKNOWN;
  int rc = status(nvjpegGetImageInfo(static_cast<nvjpegHandle_t>(handle), data, length, components,
                                     &ss, widths, heights));
  if (rc != 0) return rc;
  *subsampling = static_cast<int>(ss);
  *width = widths[0];
  *height = heights[0];
  return 0;
}

// gray = 0: interleaved RGB into out (pitch bytes a row, >= 3 * width);
// gray = 1: luma into out (pitch >= width).
int jpeg_decode(void* handle, void* state, const unsigned char* data, size_t length, int gray,
                unsigned char* out, int pitch, void* stream) {
  nvjpegImage_t dest;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    dest.channel[c] = nullptr;
    dest.pitch[c] = 0;
  }
  dest.channel[0] = out;
  dest.pitch[0] = pitch;
  int rc = status(nvjpegDecode(static_cast<nvjpegHandle_t>(handle), static_cast<nvjpegJpegState_t>(state),
                               data, length, gray ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI, &dest,
                               static_cast<cudaStream_t>(stream)));
  if (rc != 0) return rc;
  cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : 1000 + static_cast<int>(err);
}

}  // extern "C"
