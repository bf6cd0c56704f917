// JPEG decoding on the GPU with nvJPEG (part of the CUDA toolkit), for the
// port's file-backed datasets (imm_tpu_torch/data/decode.py).
//
// Not a port of a TPU kernel: the JAX package decodes on the host with
// OpenCV (imm_tpu/data/datasets.py:_load_image_with_hw). This is a host shim
// with a plain C interface, built by imm_tpu_torch/ops/_build.py like the
// kernels and linked with -lnvjpeg. nvJPEG parses the stream and runs the
// Huffman decode on the host, then dequantises, transforms and converts the
// colours on the card, writing interleaved RGB straight into the caller's
// uint8 buffer (a torch tensor on the device) on the caller's stream.
//
// One decoder state serves every call, under a mutex: a loader thread and the
// main thread may both decode. A decode returns once its work on the stream
// is done, because the next call reuses the state's buffers.
//
// Return codes: 0 on success, 1000 + nvjpegStatus_t for an nvJPEG error,
// 2000 + cudaError_t for a CUDA error.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstring>
#include <mutex>

namespace {

std::mutex g_mutex;
nvjpegHandle_t g_handle = nullptr;
nvjpegJpegState_t g_state = nullptr;

int nvjpeg_code(nvjpegStatus_t s) { return s == NVJPEG_STATUS_SUCCESS ? 0 : 1000 + static_cast<int>(s); }

// Creates the library handle and the decoder state once; call under g_mutex.
int ensure_decoder() {
  if (g_state != nullptr) return 0;
  if (g_handle == nullptr) {
    int code = nvjpeg_code(nvjpegCreateSimple(&g_handle));
    if (code != 0) {
      g_handle = nullptr;
      return code;
    }
  }
  int code = nvjpeg_code(nvjpegJpegStateCreate(g_handle, &g_state));
  if (code != 0) g_state = nullptr;
  return code;
}

}  // namespace

// The image's height, width and number of colour components, from its header.
extern "C" int jpeg_info(const unsigned char* data, size_t length, int* height, int* width,
                         int* components) {
  std::lock_guard<std::mutex> lock(g_mutex);
  int code = ensure_decoder();
  if (code != 0) return code;
  int n = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  code = nvjpeg_code(nvjpegGetImageInfo(g_handle, data, length, &n, &subsampling, widths, heights));
  if (code != 0) return code;
  *height = heights[0];
  *width = widths[0];
  *components = n;
  return 0;
}

// Decodes to interleaved RGB, (height, width, 3) uint8 with rows of 3 * width
// bytes, at `out` on the device. Height and width come from jpeg_info; a
// grayscale image is written with its gray value in all three channels.
extern "C" int jpeg_decode_rgbi(const unsigned char* data, size_t length, unsigned char* out,
                                int height, int width, void* stream) {
  std::lock_guard<std::mutex> lock(g_mutex);
  int code = ensure_decoder();
  if (code != 0) return code;
  if (height <= 0 || width <= 0) return 1000 + static_cast<int>(NVJPEG_STATUS_INVALID_PARAMETER);
  nvjpegImage_t image;
  std::memset(&image, 0, sizeof(image));
  image.channel[0] = out;
  image.pitch[0] = static_cast<size_t>(width) * 3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  code = nvjpeg_code(nvjpegDecode(g_handle, g_state, data, length, NVJPEG_OUTPUT_RGBI, &image, s));
  if (code != 0) return code;
  cudaError_t err = cudaStreamSynchronize(s);
  return err == cudaSuccess ? 0 : 2000 + static_cast<int>(err);
}
