// Runs a CUDA C++ source's kernels on the CPU, for tests: the blocks of a
// launch one after another, a block's threads as std::threads that meet at
// __syncthreads. Enough of the CUDA runtime and of cuda_bf16.h for
// imm_tpu_torch/csrc/batch_norm_relu.cu and adam_ema.cu, to be widened as
// another kernel's source needs; `<<<grid, block, ...>>>(args)` is rewritten to
// emu_launch(grid, block, ...) by tests/cuda_emu.py.
// Blocks never run at once, so this shows a kernel's arithmetic, indexing and
// block-level synchronisation, not races between blocks.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __grid_constant__

using std::isfinite;

struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local uint3 threadIdx;
inline uint3 blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* emu_barrier;

struct uint4 { unsigned x, y, z, w; };
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
typedef struct CUstream_st* cudaStream_t;
typedef int cudaError_t;
inline cudaError_t cudaGetLastError() { return 0; }

inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float rsqrtf(float a) { return 1.0f / std::sqrt(a); }
inline float __ldcg(const float* p) { return *p; }
inline unsigned atomicInc(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p = old >= v ? 0 : old + 1;
  return old;
}
inline void __threadfence() {}
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

struct __nv_bfloat16 { unsigned short bits; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 b) {
  const unsigned u = (unsigned)b.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {  // round to nearest even
  unsigned u;
  std::memcpy(&u, &f, 4);
  if (std::isnan(f)) return {(unsigned short)0x7fc0};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 h) {
  return {__bfloat162float(h.x), __bfloat162float(h.y)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}

template <class F>
void emu_launch(dim3 grid, dim3 block, F kernel) {
  gridDim = grid;
  blockDim = block;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = {bx, by, 0};
      std::barrier<> bar(block.x);
      emu_barrier = &bar;
      std::vector<std::thread> threads;
      for (unsigned t = 0; t < block.x; ++t)
        threads.emplace_back([&, t] {
          threadIdx = {t, 0, 0};
          kernel();
          bar.arrive_and_drop();
        });
      for (auto& th : threads) th.join();
    }
}
