// Batched bilinear warp forward for Hopper (sm_90a).
//
// Replaces imm_tpu/ops/warp_pallas.py:_warp_kernel, the Pallas TPU kernel
// launched by _warp_pallas_fwd. Resamples (B, H, W, C) images at a
// (B, Ho, Wo, 2) grid in (y, x) order, normalized to [-1, 1] with
// align-corners semantics; out-of-range coordinates clamp to the border.
// Images are f32 or bf16; the coordinate math and the lerp are f32 whatever
// the image type, and the result is rounded once into the image type.
//
// The TPU kernel turns the gather into one-hot matrix products because that
// chip gathers slowly; this card gathers well, so that schedule is not
// carried over. What bounds it here: device-memory bytes. At the training
// shape (128, 128, 128, 3) f32 it reads 25.2 MB of images and 16.8 MB of
// grid and writes 25.2 MB, about 20 us at 3.35 TB/s, against 30 FLOPs a
// pixel. Design: one thread per output pixel, covering all C channels. The
// grid is read as one 8-byte (y, x) pair per thread and the output written
// as C consecutive values per thread, both coalesced across the warp. The
// four neighbour reads are gathers, but a smooth warp sends neighbouring
// threads to neighbouring source pixels, so they hit the same cache lines and
// each image byte comes from device memory about once. The [-1, 1] -> pixel
// map and the clip run in the kernel: the grid is the only coordinate
// tensor that crosses device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// [-1, 1] -> pixel units of an axis of n samples, clipped to [0, n - 1]; the
// operations and their order are those of ops/image.py:bilinear_sample. A
// NaN clips to 0, so the indices below are always in range.
__device__ __forceinline__ float pixel(float g, int n) {
  const float f = (g + 1.0f) * 0.5f * (float)(n - 1);
  return fminf(fmaxf(f, 0.0f), (float)(n - 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_fwd_kernel(const T* __restrict__ img, const float2* __restrict__ grid,
                T* __restrict__ out, int H, int W, int C, long long Q, long long total) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float2 g = grid[i];  // .x holds y, .y holds x
  const float fy = pixel(g.x, H), fx = pixel(g.y, W);
  const float y0f = floorf(fy), x0f = floorf(fx);
  const float wy = fy - y0f, wx = fx - x0f;
  const int y0 = (int)y0f, x0 = (int)x0f;
  const int y1 = min(y0 + 1, H - 1), x1 = min(x0 + 1, W - 1);

  const T* base = img + (i / Q) * H * W * C;
  const T* p00 = base + ((long long)y0 * W + x0) * C;
  const T* p01 = base + ((long long)y0 * W + x1) * C;
  const T* p10 = base + ((long long)y1 * W + x0) * C;
  const T* p11 = base + ((long long)y1 * W + x1) * C;
  T* o = out + i * C;
  for (int c = 0; c < C; ++c) {
    const float top = load(p00 + c) * (1.0f - wx) + load(p01 + c) * wx;
    const float bot = load(p10 + c) * (1.0f - wx) + load(p11 + c) * wx;
    store(o + c, top * (1.0f - wy) + bot * wy);
  }
}

}  // namespace

// img (B, H, W, C) and out (B, Ho, Wo, C) in f32 or bf16 (is_bf16), grid
// (B, Ho, Wo, 2) f32: contiguous on the device. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int warp_fwd(const void* img, const void* grid, void* out, int B, int H, int W,
                        int C, int Ho, int Wo, int is_bf16, void* stream) {
  const long long q = (long long)Ho * Wo, total = q * B;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    warp_fwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)img, (const float2*)grid, (__nv_bfloat16*)out, H, W, C, q, total);
  } else {
    warp_fwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const float*)img, (const float2*)grid, (float*)out, H, W, C, q, total);
  }
  return (int)cudaGetLastError();
}
