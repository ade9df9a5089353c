// A CPU emulation of the CUDA features the port's kernels use, for
// tests/test_torch_kernels_emulated.py: the kernel sources compile with g++
// against this header in place of the CUDA toolkit's. Each CUDA thread of a
// block is an OS thread; blocks run one after another; __syncthreads is a
// barrier of the block's threads and a warp-collective operation (shuffle,
// ldmatrix, mma) a barrier of the warp's 32 threads around an exchange of
// the lanes' operands. cp.async copies at once.
#pragma once

#include <math.h>
#include <pthread.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <cstdio>
#include <cstdlib>
#include <thread>
#include <tuple>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct uint3_ {
  unsigned x, y, z;
};
inline thread_local uint3_ threadIdx, blockIdx;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline int min(int a, int b) { return a < b ? a : b; }

constexpr int kEmuMaxWarps = 8;
inline pthread_barrier_t g_block_barrier;
inline pthread_barrier_t g_warp_barrier[kEmuMaxWarps];
inline uint64_t g_lane_words[kEmuMaxWarps][32][8];  // what each lane shares with its warp

inline void __syncthreads() { pthread_barrier_wait(&g_block_barrier); }
inline void emu_warp_sync() { pthread_barrier_wait(&g_warp_barrier[threadIdx.x / 32]); }
inline uint64_t* emu_lane(int lane) { return g_lane_words[threadIdx.x / 32][lane]; }

inline float __shfl_xor_sync(unsigned, float x, int mask) {
  const int lane = threadIdx.x % 32;
  memcpy(emu_lane(lane), &x, 4);
  emu_warp_sync();
  float y;
  memcpy(&y, emu_lane(lane ^ mask), 4);
  emu_warp_sync();
  return y;
}

// Shared-memory addresses are 32-bit offsets from one host address.
inline char g_smem_origin[16];
inline size_t __cvta_generic_to_shared(const void* p) {
  return (size_t)(uint32_t)(int32_t)((const char*)p - g_smem_origin);
}
inline char* emu_smem(uint32_t addr) { return g_smem_origin + (int32_t)addr; }

struct __nv_bfloat16 {
  unsigned short v;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(unsigned short)0x7fc0};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = (uint32_t)b.v << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}

// kernel<<<grid, threads, smem, stream>>>(args...) becomes
// emu_launch(std::make_tuple(grid, threads, smem, stream), &kernel, args...).
template <class G, class B, class S, class St, class F, class... A>
void emu_launch(std::tuple<G, B, S, St> config, F kernel, A... args) {
  const dim3 grid = dim3(std::get<0>(config));
  const int threads = (int)std::get<1>(config);
  if (threads % 32 || threads > 32 * kEmuMaxWarps) abort();
  pthread_barrier_init(&g_block_barrier, nullptr, threads);
  for (int w = 0; w < threads / 32; ++w) pthread_barrier_init(&g_warp_barrier[w], nullptr, 32);
  std::vector<std::thread> block;
  for (int t = 0; t < threads; ++t) {
    block.emplace_back([=] {  // each thread runs its part of every block in turn
      threadIdx = {(unsigned)t, 0, 0};
      for (unsigned by = 0; by < grid.y; ++by) {
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          blockIdx = {bx, by, 0};
          kernel(args...);
          __syncthreads();  // the block's shared memory is free for the next
        }
      }
    });
  }
  for (auto& th : block) th.join();
  pthread_barrier_destroy(&g_block_barrier);
  for (int w = 0; w < threads / 32; ++w) pthread_barrier_destroy(&g_warp_barrier[w]);
}
