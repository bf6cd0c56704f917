// Batched bilinear warp backward for Hopper (sm_90a).
//
// Replaces imm_tpu/ops/warp_pallas.py:_warp_bwd_kernel, the Pallas TPU kernel
// launched by _warp_pallas_bwd. For the resample of warp_fwd.cu and a
// cotangent g (B, Ho, Wo, C) it produces
//   d_images (B, H, W, C) f32: the transpose of the lerp, each output pixel's
//     g scattered to its four source pixels with the lerp weights;
//   d_fy, d_fx (B, Ho, Wo) f32: the cotangent of the clipped pixel
//     coordinates, summed over channels,
//       d_fy = sum_c g * (lerp_x(v[y1]) - lerp_x(v[y0])),
//       d_fx = sum_c g * (lerp_y(v[:, x1]) - lerp_y(v[:, x0])),
//     which is 0 where the upper neighbour is clamped onto the lower one.
// The clip's own gradient (0.5 at an exact tie) and the [-1, 1] -> pixel
// scale are chained outside the kernel, as the Pallas wrapper does.
//
// The TPU kernel writes the scatter as a dense matrix product against one-hot
// masks; here it is a scatter with atomics. What bounds it: device-memory
// bytes (images, grid and cotangent in, d_images, d_fy, d_fx out: 109 MB at
// (128, 128, 128, 3) f32, about 33 us at 3.35 TB/s); then the bytes a block
// keeps in flight, since its steps depend on one another; then atomics. A
// thread that adds its 4 x C products straight to device memory causes, with
// NHWC pixels 4 * C bytes apart, about one 32-byte sector operation in L2 per
// lane and instruction, and for a smooth warp most of them land on a cell
// that a neighbouring thread also adds to.
//
// Design: a block owns a kTileH x kTileW tile of output pixels of one image.
//   1. Each thread loads its grid point and its cotangent at once (the
//      cotangent waits in shared memory) and computes its four source pixels;
//      a block reduction gives the tile's bounding box in the source image,
//      over the clamped corners, and the largest |cotangent| of the tile.
//   2. If the box holds at most `footprint_floats` values, the block copies
//      that footprint of the image into shared memory (each row a contiguous
//      run in NHWC, so the reads are coalesced; four loads a thread under way
//      at a time), zeroes an accumulator of the same shape, takes every pixel
//      value from shared memory and scatters with shared-memory atomics,
//      which resolve the collisions between neighbouring threads on the SM.
//      The accumulator is 32-bit fixed point: on this card atomicAdd on a
//      float in shared memory compiles to a compare-and-swap loop
//      (ATOMS.CAST.SPIN), and the integer add (ATOMS.ADD) is the native one.
//      The scale is a power of two set by the tile's largest |cotangent| so
//      that kThreads products cannot overflow, and integer adds give the same
//      tile sum in whatever order they land. After a barrier the block adds
//      each non-zero accumulator entry to d_images once, neighbouring lanes
//      on neighbouring floats: the blocks meet only at tile borders.
//      Precision: each product is rounded to a multiple of 2^-21 of the
//      tile's largest |cotangent| (to the power of two below it), an absolute
//      error of at most 2^-22 of that value a product, where an f32 add
//      rounds to 2^-24 of the running sum. So a cell of d_images is as exact
//      as f32 adds make it relative to the largest cotangent of the tiles
//      that reach it, not relative to itself: a cotangent more than 2^23
//      times smaller than another of the same tile (1e-8 beside 1) adds
//      nothing, where the direct path keeps it.
//   3. If the box is larger (a wild grid, strong minification), or a
//      cotangent of the tile is not finite (it must reach d_images as it is),
//      the block adds its f32 products straight to device memory. The choice
//      is per block and by the data; `direct_blocks`, when given, counts the
//      blocks that took this path.
// d_images must be zeroed by the caller. Blocks still meet through f32 atomics
// in device memory, so the summation order varies from run to run: d_images
// is reproducible to a few f32 units in the last place of the largest partial
// sum only. One image holds fewer than 2^31 values.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// A block's tile of output pixels, one thread to a pixel (ops/warp.py knows it
// as BWD_TILE), and the blocks per SM that the register budget is held to.
constexpr int kTileW = 16, kTileH = 16;
constexpr int kThreads = kTileW * kTileH, kWarps = kThreads / 32;
constexpr int kMinBlocks = 6;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "a tile is a whole number of warps");

// Fixed point: a product below 2^(expo + 1), times 2^(kFixedBits - expo), stays
// below 2^(kFixedBits + 1), and kThreads of them below 2^30.
constexpr int ceil_log2(int n) { return n <= 1 ? 0 : 1 + ceil_log2((n + 1) / 2); }
constexpr int kFixedBits = 29 - ceil_log2(kThreads);

__device__ __forceinline__ void add(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void add(int* p, float v) { atomicAdd(p, __float2int_rn(v)); }

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// As in warp_fwd.cu: [-1, 1] -> pixel units, clipped to [0, n - 1].
__device__ __forceinline__ float pixel(float g, int n) {
  const float f = (g + 1.0f) * 0.5f * (float)(n - 1);
  return fminf(fmaxf(f, 0.0f), (float)(n - 1));
}

// One output pixel over its C channels: the four corners' values are read
// from `v` and the products of the cotangent, times `scale`, added to `acc`,
// both at offsets o00..o11; channel c of the cotangent is g[c * kThreads].
// -> (d_fy, d_fx).
template <typename V, typename A, typename O>
__device__ __forceinline__ float2 scatter_pixel(const V* __restrict__ v, A* __restrict__ acc,
                                                const float* __restrict__ g, int C, float wy,
                                                float wx, O o00, O o01, O o10, O o11,
                                                float scale) {
  float sy = 0.0f, sx = 0.0f;
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    const float gv = g[c * kThreads];
    const float v00 = load(v + o00 + c), v01 = load(v + o01 + c);
    const float v10 = load(v + o10 + c), v11 = load(v + o11 + c);
    const float top = v00 * (1.0f - wx) + v01 * wx;
    const float bot = v10 * (1.0f - wx) + v11 * wx;
    const float left = v00 * (1.0f - wy) + v10 * wy;
    const float right = v01 * (1.0f - wy) + v11 * wy;
    sy += gv * (bot - top);
    sx += gv * (right - left);
    const float gs = gv * scale;
    add(acc + o00 + c, gs * (1.0f - wy) * (1.0f - wx));
    add(acc + o01 + c, gs * (1.0f - wy) * wx);
    add(acc + o10 + c, gs * wy * (1.0f - wx));
    add(acc + o11 + c, gs * wy * wx);
  }
  return make_float2(sy, sx);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
warp_bwd_kernel(const T* __restrict__ img, const float2* __restrict__ grid,
                const T* __restrict__ cot, float* __restrict__ dimg,
                float* __restrict__ dfy, float* __restrict__ dfx,
                unsigned* __restrict__ direct_blocks, int H, int W, int C, int Ho, int Wo,
                int footprint_floats) {
  // this block's cotangents (C * kThreads), then the footprint of img and
  // its accumulator (footprint_floats each)
  extern __shared__ float smem[];
  __shared__ int box[5][kWarps];  // per warp: -ymin, ymax, -xmin, xmax, largest |g| (its bits)

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (Wo + kTileW - 1) / kTileW, tiles_y = (Ho + kTileH - 1) / kTileH;
  const int tile_x = blockIdx.x % tiles_x, tile_y = blockIdx.x / tiles_x % tiles_y;
  const int b = blockIdx.x / tiles_x / tiles_y;
  const int ox = tile_x * kTileW + threadIdx.x, oy = tile_y * kTileH + threadIdx.y;
  const bool valid = ox < Wo && oy < Ho;
  // a pixel off the output's edge reads the edge pixel's data and adds nothing
  const long long i = ((long long)b * Ho + min(oy, Ho - 1)) * Wo + min(ox, Wo - 1);

  // Every load of this pixel's own data is started before the first use: what
  // limits the kernel is how many bytes it keeps in flight. The cotangent
  // waits in shared memory, channel c at scot[c * kThreads].
  const float2 g = grid[i];  // .x holds y, .y holds x
  float* scot = smem + tid;
  int gmax = 0;
  for (int c0 = 0; c0 < C; c0 += 4) {
    float t[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) t[j] = c0 + j < C ? load(cot + i * C + c0 + j) : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < C) {
        scot[(c0 + j) * kThreads] = t[j];
        gmax = max(gmax, __float_as_int(fabsf(t[j])));  // ordered as the floats are; NaN on top
      }
  }

  const float fy = pixel(g.x, H), fx = pixel(g.y, W);
  const float y0f = floorf(fy), x0f = floorf(fx);
  const float wy = fy - y0f, wx = fx - x0f;
  const int y0 = (int)y0f, x0 = (int)x0f;
  const int y1 = min(y0 + 1, H - 1), x1 = min(x0 + 1, W - 1);

  // The tile's bounding box over the clamped corners (y0 <= y1, x0 <= x1) and
  // its largest |g|, as five maxima; a thread off the output's edge takes no
  // part.
  const int m0 = __reduce_max_sync(kFull, valid ? -y0 : INT_MIN);
  const int m1 = __reduce_max_sync(kFull, valid ? y1 : INT_MIN);
  const int m2 = __reduce_max_sync(kFull, valid ? -x0 : INT_MIN);
  const int m3 = __reduce_max_sync(kFull, valid ? x1 : INT_MIN);
  const int m4 = __reduce_max_sync(kFull, valid ? gmax : 0);
  if (lane == 0) {
    box[0][warp] = m0, box[1][warp] = m1, box[2][warp] = m2, box[3][warp] = m3;
    box[4][warp] = m4;
  }
  __syncthreads();
  int ymin = box[0][0], ymax = box[1][0], xmin = box[2][0], xmax = box[3][0], gbits = box[4][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    gbits = max(gbits, box[4][w]);
    ymin = max(ymin, box[0][w]), ymax = max(ymax, box[1][w]);
    xmin = max(xmin, box[2][w]), xmax = max(xmax, box[3][w]);
  }
  ymin = -ymin, xmin = -xmin;  // the block's first thread is always valid
  const int bh = ymax - ymin + 1, bw = xmax - xmin + 1, run = bw * C;
  const long long image = (long long)b * H * W * C;

  if ((long long)bh * run <= footprint_floats && gbits < 0x7f800000) {
    float* simg = smem + C * kThreads;
    int* sacc = reinterpret_cast<int*>(simg + footprint_floats);
    // |g| < 2^(expo + 1); below 2^-100 the products round to nothing
    const int expo = max((gbits >> 23) - 127, -100);
    const float scale = __int_as_float((127 + kFixedBits - expo) << 23);
    const float unscale = __int_as_float((127 - kFixedBits + expo) << 23);
    // Row r of the footprint is `run` contiguous values of the image. Four
    // loads a thread are under way before the first is stored.
    const long long corner = image + ((long long)ymin * W + xmin) * C;
    const int n = bh * run;
    for (int e0 = tid; e0 < n; e0 += 4 * kThreads) {
      float t[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = e0 + j * kThreads, r = e / run;
        t[j] = e < n ? load(img + corner + (long long)r * W * C + (e - r * run)) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = e0 + j * kThreads;
        if (e < n) simg[e] = t[j], sacc[e] = 0;
      }
    }
    __syncthreads();
    if (valid) {
      const int dx = (x1 - x0) * C, dy = (y1 - y0) * run;
      const int l00 = ((y0 - ymin) * bw + (x0 - xmin)) * C;
      const float2 d = scatter_pixel(simg, sacc, scot, C, wy, wx, l00, l00 + dx, l00 + dy,
                                     l00 + dy + dx, scale);
      dfy[i] = d.x;
      dfx[i] = d.y;
    }
    __syncthreads();
    for (int r = warp; r < bh; r += kWarps) {
      float* dst = dimg + corner + (long long)r * W * C;
      for (int c = lane; c < run; c += 32) {
        const int v = sacc[r * run + c];
        if (v != 0) atomicAdd(dst + c, (float)v * unscale);
      }
    }
  } else {
    if (tid == 0 && direct_blocks != nullptr) atomicAdd(direct_blocks, 1u);
    if (valid) {
      const long long dx = (x1 - x0) * C, dy = (long long)(y1 - y0) * W * C;
      const long long o00 = image + ((long long)y0 * W + x0) * C;
      const float2 d = scatter_pixel(img, dimg, scot, C, wy, wx, o00, o00 + dx, o00 + dy,
                                     o00 + dy + dx, 1.0f);
      dfy[i] = d.x;
      dfx[i] = d.y;
    }
  }
}

template <typename T>
int launch(const void* img, const void* grid, const void* cot, void* dimg, void* dfy, void* dfx,
           void* direct_blocks, int B, int H, int W, int C, int Ho, int Wo,
           int footprint_floats, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)footprint_floats + (size_t)kTileW * kTileH * C);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        warp_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks =
      (long long)B * ((Ho + kTileH - 1) / kTileH) * ((Wo + kTileW - 1) / kTileW);
  warp_bwd_kernel<T><<<(unsigned)blocks, dim3(kTileW, kTileH), smem, stream>>>(
      (const T*)img, (const float2*)grid, (const T*)cot, (float*)dimg, (float*)dfy,
      (float*)dfx, (unsigned*)direct_blocks, H, W, C, Ho, Wo, footprint_floats);
  return (int)cudaGetLastError();
}

}  // namespace

// img (B, H, W, C) and cot (B, Ho, Wo, C) in f32 or bf16 (is_bf16), grid
// (B, Ho, Wo, 2) f32, dimg (B, H, W, C) f32 zeroed by the caller, dfy and dfx
// (B, Ho, Wo) f32: contiguous on the device. footprint_floats is the largest
// source footprint (rows x columns x C) a tile may stage in shared memory (the
// block takes twice that many 4-byte values, and its cotangents); 0 sends
// every block down the direct path. direct_blocks is null or one u32 on the
// device, which gains the number of blocks that took the direct path.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int warp_bwd(const void* img, const void* grid, const void* cot, void* dimg,
                        void* dfy, void* dfx, void* direct_blocks, int B, int H, int W, int C,
                        int Ho, int Wo, int is_bf16, int footprint_floats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(img, grid, cot, dimg, dfy, dfx, direct_blocks, B, H, W,
                                         C, Ho, Wo, footprint_floats, s)
                 : launch<float>(img, grid, cot, dimg, dfy, dfx, direct_blocks, B, H, W, C, Ho,
                                 Wo, footprint_floats, s);
}
