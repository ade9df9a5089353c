// A CPU emulation of the CUDA features the port's kernels use, for
// tests/test_torch_kernels_emulated.py: the kernel sources compile with g++
// against this header in place of the CUDA toolkit's. Each CUDA thread of a
// block is an OS thread. Blocks run one after another, except that the
// blocks of a cluster (cudaLaunchKernelEx with a cluster dimension) run
// together. __syncthreads is a barrier of the block's threads and a
// warp-collective operation (shuffle) a barrier of the warp's 32 threads
// around an exchange of the lanes' operands; a warpgroup operation (wgmma)
// likewise over its 128 threads.
//
// Shared memory: addresses are 32-bit offsets from one host address. Block
// r of a cluster has its dynamic shared memory at offset r << 20, 1024-byte
// aligned, filled with NaN bytes before it starts (a read of what no one
// wrote shows), so the 18-bit addresses of a wgmma descriptor name a place
// in the executing block's own window, as on the card.
#pragma once

#include <math.h>
#include <pthread.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <cstdio>
#include <cstdlib>
#include <map>
#include <thread>
#include <tuple>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __grid_constant__
#define CUDART_VERSION 12080

struct uint3_ {
  unsigned x, y, z;
};
inline thread_local uint3_ threadIdx, blockIdx;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline int min(int a, int b) { return a < b ? a : b; }

[[noreturn]] inline void emu_fail(const char* what) {
  fprintf(stderr, "cuda_emu: %s\n", what);
  abort();
}

// three warpgroups (the warp-specialised kernels: two consumers and a
// producer); clusters of up to 4 blocks
constexpr int kEmuMaxWarps = 12;
constexpr int kEmuMaxCluster = 4;
constexpr int kEmuSmemWindow = 1 << 20;
constexpr int kEmuMaxDynamicSmem = 232448;  // the H100's 227 KB a block

struct EmuNamedBarrier {
  int count = 0;
  unsigned generation = 0;
};

struct EmuBlock {
  EmuNamedBarrier named[16];  // bar.sync / bar.arrive ids
  int maxnreg[kEmuMaxWarps / 4];  // each warpgroup's setmaxnreg count (0: none)
  pthread_barrier_t block;
  pthread_barrier_t warp[kEmuMaxWarps];
  pthread_barrier_t group[(kEmuMaxWarps + 3) / 4];  // warpgroups
  uint64_t lane_words[kEmuMaxWarps][32][8];         // what each lane shares with its warp(group)
};
inline EmuBlock g_blocks[kEmuMaxCluster];
inline pthread_barrier_t g_cluster_barrier;
inline thread_local int emu_rank;  // the block's rank in its cluster

inline void __syncthreads() { pthread_barrier_wait(&g_blocks[emu_rank].block); }
inline void emu_warp_sync() { pthread_barrier_wait(&g_blocks[emu_rank].warp[threadIdx.x / 32]); }
inline void emu_group_sync() { pthread_barrier_wait(&g_blocks[emu_rank].group[threadIdx.x / 128]); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_sync(); }
inline uint64_t* emu_lane(int lane) { return g_blocks[emu_rank].lane_words[threadIdx.x / 32][lane]; }
inline uint64_t* emu_lane_of(int warp, int lane) { return g_blocks[emu_rank].lane_words[warp][lane]; }

inline float __shfl_xor_sync(unsigned, float x, int mask) {
  const int lane = threadIdx.x % 32;
  memcpy(emu_lane(lane), &x, 4);
  emu_warp_sync();
  float y;
  memcpy(&y, emu_lane(lane ^ mask), 4);
  emu_warp_sync();
  return y;
}

// The shared-memory windows of a cluster's blocks; address 0 is the first.
alignas(1024) inline char g_smem_origin[kEmuMaxCluster][kEmuSmemWindow];
inline size_t __cvta_generic_to_shared(const void* p) {
  return (size_t)(uint32_t)(int32_t)((const char*)p - &g_smem_origin[0][0]);
}
inline char* emu_smem(uint32_t addr) { return &g_smem_origin[0][0] + (int32_t)addr; }
inline char* emu_dynamic_smem() { return g_smem_origin[emu_rank]; }

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

struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(8) uint2 {
  unsigned x, y;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }

inline uint32_t __float_as_uint(float x) {
  uint32_t u;
  memcpy(&u, &x, 4);
  return u;
}
inline float __uint_as_float(uint32_t u) {
  float x;
  memcpy(&x, &u, 4);
  return x;
}
// byte i of the result is byte (s >> 4i) & 7 of the 8 bytes y:x
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t xy = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= (uint32_t)((xy >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}

// What a block leaves behind that a correct kernel never does (a wgmma
// still in flight); set by the wgmma emulation.
inline thread_local bool (*emu_block_leftovers)() = nullptr;

// The registers a thread of a `threads`-thread block has at launch where the
// kernel reallocates them (setmaxnreg): ptxas's count under
// __launch_bounds__(threads, 1), 65536 / threads rounded down to 8.
inline int emu_launch_regs(int threads) { return 65536 / threads / 8 * 8; }

// After a block ran: its warpgroups' setmaxnreg counts (a warpgroup that
// set none keeps the launch's) must fit in the SM's 65536 registers, or
// the card's setmaxnreg.inc would wait for ever.
inline void emu_check_registers(EmuBlock& b, int threads) {
  bool any = false;
  long total = 0;
  for (int w = 0; w < threads / 128; ++w) {
    any = any || b.maxnreg[w] != 0;
    total += 128L * (b.maxnreg[w] ? b.maxnreg[w] : emu_launch_regs(threads));
  }
  if (any && (threads % 128 || total > 65536)) emu_fail("setmaxnreg: more registers than the SM has");
  for (int& n : b.maxnreg) n = 0;
}

// Runs `body` for every block of `grid`, `threads` threads a block, the
// blocks of each cluster of `cluster` together.
template <class Body>
void emu_run(dim3 grid, int threads, int cluster, size_t dynamic_smem, Body body) {
  if (threads % 32 || threads > 32 * kEmuMaxWarps) emu_fail("block size not emulated");
  if (cluster < 1 || cluster > kEmuMaxCluster || grid.x % cluster) emu_fail("cluster shape");
  for (int r = 0; r < cluster; ++r) {
    pthread_barrier_init(&g_blocks[r].block, nullptr, threads);
    for (int w = 0; w < threads / 32; ++w) pthread_barrier_init(&g_blocks[r].warp[w], nullptr, 32);
    for (int w = 0; w < threads / 128; ++w)
      pthread_barrier_init(&g_blocks[r].group[w], nullptr, 128);
  }
  pthread_barrier_init(&g_cluster_barrier, nullptr, threads * cluster);
  std::vector<std::thread> all;
  for (int i = 0; i < threads * cluster; ++i) {
    all.emplace_back([=] {  // each thread runs its part of every cluster in turn
      emu_rank = i / threads;
      threadIdx = {(unsigned)(i % threads), 0, 0};
      for (unsigned by = 0; by < grid.y; ++by) {
        for (unsigned bx = 0; bx < grid.x; bx += cluster) {
          if (i == 0) {
            for (int r = 0; r < cluster; ++r) {
              emu_check_registers(g_blocks[r], threads);  // the previous block's
              memset(g_smem_origin[r], 0xff, dynamic_smem);
              for (EmuNamedBarrier& b : g_blocks[r].named) b = EmuNamedBarrier();
            }
          }
          pthread_barrier_wait(&g_cluster_barrier);
          blockIdx = {bx + emu_rank, by, 0};
          body();
          if (emu_block_leftovers && emu_block_leftovers()) emu_fail("a wgmma left in flight");
          pthread_barrier_wait(&g_cluster_barrier);  // shared memory is free for the next
        }
      }
    });
  }
  for (auto& th : all) th.join();
  for (int r = 0; r < cluster; ++r) {
    emu_check_registers(g_blocks[r], threads);
    pthread_barrier_destroy(&g_blocks[r].block);
    for (int w = 0; w < threads / 32; ++w) pthread_barrier_destroy(&g_blocks[r].warp[w]);
    for (int w = 0; w < threads / 128; ++w) pthread_barrier_destroy(&g_blocks[r].group[w]);
  }
  pthread_barrier_destroy(&g_cluster_barrier);
}

// kernel<<<grid, threads, smem, stream>>>(args...) becomes
// emu_launch(std::make_tuple(grid, threads, smem, stream), &kernel, args...).
template <class G, class B, class S, class St, class F, class... A>
void emu_launch(std::tuple<G, B, S, St> config, F kernel, A... args) {
  emu_run(dim3(std::get<0>(config)), (int)std::get<1>(config), 1, 0, [&] { kernel(args...); });
}

// ---- the runtime API of the Hopper launchers --------------------------------

enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct {
    unsigned x, y, z;
  } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

inline std::map<const void*, int> g_smem_allowed;  // kernel -> its dynamic shared memory limit

struct cudaFuncAttributes {
  int numRegs;
};
// The registers ptxas gives a thread of the warp-specialised kernels
// (__launch_bounds__(384, 1)); the emulation runs any block size, and checks
// the setmaxnreg counts against the SM's registers itself (emu.h
// emu_check_registers).
template <class... A>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* attr, void (*)(A...)) {
  attr->numRegs = emu_launch_regs(384);
  return cudaSuccess;
}

inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaSetDevice(int dev) { return dev == 0 ? cudaSuccess : cudaErrorInvalidValue; }
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr attr, int) {
  if (attr != cudaDevAttrMultiProcessorCount) return cudaErrorInvalidValue;
  *value = 132;  // the H100 SXM
  return cudaSuccess;
}
template <class... A>
cudaError_t cudaFuncSetAttribute(void (*kernel)(A...), cudaFuncAttribute attr, int value) {
  if (attr != cudaFuncAttributeMaxDynamicSharedMemorySize || value > kEmuMaxDynamicSmem)
    return cudaErrorInvalidValue;
  g_smem_allowed[(const void*)kernel] = value;
  return cudaSuccess;
}

template <class... Exp, class... Act>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(Exp...),
                               Act&&... args) {
  int cluster = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i) {
    if (cfg->attrs[i].id != cudaLaunchAttributeClusterDimension) return cudaErrorInvalidValue;
    const auto& c = cfg->attrs[i].val.clusterDim;
    if (c.y != 1 || c.z != 1 || c.x < 1 || c.x > 8) return cudaErrorInvalidValue;
    cluster = (int)c.x;
  }
  const auto allowed = g_smem_allowed.find((const void*)kernel);
  const size_t limit = allowed == g_smem_allowed.end() ? 48 * 1024 : allowed->second;
  if (cfg->dynamicSmemBytes > limit || cfg->gridDim.x % cluster) return cudaErrorInvalidValue;
  std::tuple<std::decay_t<Exp>...> params(std::forward<Act>(args)...);
  emu_run(cfg->gridDim, (int)cfg->blockDim.x, cluster, cfg->dynamicSmemBytes, [&] {
    std::apply(kernel, params);  // each thread's parameters are the launch's copy
  });
  return cudaSuccess;
}
