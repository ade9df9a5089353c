// Flash-attention forward for Hopper (sm_90a), over [BH, T, D] row-major.
//
// Replaces the Pallas TPU kernel `_kernel` launched by `_flash_bhtd` (the
// JAX package's ops/pallas/flash_attention.py:51,141): the
// online-softmax recurrence over key blocks, with the running max, normaliser
// and output accumulator kept in f32, sm_scale = 1/sqrt(D), and an optional
// per-query log-sum-exp. Padded keys are never visited instead of being
// masked to -1e30, and neither D nor the LSE is padded to 128 lanes: the LSE
// is a plain [BH, T] f32 array.
//
// What bounds it on the H100: at the UNet's shapes (T = 1024, D = 16 or 32)
// attention does 4*T*D flops for every 4*D*elt bytes of Q/K/V/O it must move,
// i.e. ~500 flops per byte at T = 1024 in bf16, so it is compute bound. This
// first kernel does that arithmetic on the CUDA cores in f32 (FMA), not on
// the tensor cores, so its ceiling is the 67 TFLOP/s f32 rate; mma/wgmma is
// later work. What the design does about it:
//   * one block owns one (bh, query tile); K and V stream through shared
//     memory a tile at a time, converted to f32 once on load, so each key is
//     read from device memory once per query tile and from shared memory by
//     every row of the tile;
//   * each query row is split over TPR = D/8 adjacent lanes that each hold 8
//     interleaved dims of q and of the accumulator in registers (interleaving
//     keeps the lanes of one row on different shared-memory banks); a row's
//     score is the xor-shuffle sum of its lanes' partial dot products, so
//     every lane holds the same running max and normaliser;
//   * keys are processed in chunks of 16: the chunk's scores sit in
//     registers, the accumulator is rescaled once per chunk, and exp2 with
//     log2(e) folded into the scale replaces exp.
//
// Build (plain C interface, no PyTorch headers; loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention_fwd.so flash_attention_fwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDimsPerLane = 8;
constexpr int kChunk = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int t_len, float scale_log2) {
  constexpr int TPR = D / kDimsPerLane;          // lanes per query row
  constexpr int ROWS = kThreads / TPR;           // query rows per block
  constexpr int BN = D >= 128 ? 32 : 64;         // keys per shared-memory tile
  __shared__ float k_s[BN][D];
  __shared__ float v_s[BN][D];

  const int bh = blockIdx.y;
  const int sub = threadIdx.x % TPR;
  const int row = blockIdx.x * ROWS + threadIdx.x / TPR;
  const bool row_ok = row < t_len;
  const size_t base = (size_t)bh * t_len * D;

  float qr[kDimsPerLane];
  float acc[kDimsPerLane];
#pragma unroll
  for (int j = 0; j < kDimsPerLane; ++j) {
    const int d = sub + j * TPR;
    qr[j] = row_ok ? to_f32(q[base + (size_t)row * D + d]) * scale_log2 : 0.f;
    acc[j] = 0.f;
  }
  float m = -INFINITY;  // running max, in log2 units
  float l = 0.f;        // running normaliser

  for (int k0 = 0; k0 < t_len; k0 += BN) {
    const int n_valid = min(BN, t_len - k0);
    __syncthreads();  // previous tile fully consumed
    for (int i = threadIdx.x; i < BN * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool ok = r < n_valid;
      const size_t g = base + (size_t)(k0 + r) * D + c;
      k_s[r][c] = ok ? to_f32(k[g]) : 0.f;
      v_s[r][c] = ok ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    for (int c0 = 0; c0 < n_valid; c0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < kDimsPerLane; ++e) a = fmaf(qr[e], k_s[c0 + j][sub + e * TPR], a);
        s[j] = a;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
      }
      float m_chunk = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (c0 + j >= n_valid) s[j] = -INFINITY;  // ragged last tile
        m_chunk = fmaxf(m_chunk, s[j]);
      }
      // m_chunk is finite: the chunk holds at least one real key.
      const float m_new = fmaxf(m, m_chunk);
      const float alpha = exp2f(m - m_new);
      l *= alpha;
#pragma unroll
      for (int e = 0; e < kDimsPerLane; ++e) acc[e] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = exp2f(s[j] - m_new);
        l += p;
#pragma unroll
        for (int e = 0; e < kDimsPerLane; ++e) acc[e] = fmaf(p, v_s[c0 + j][sub + e * TPR], acc[e]);
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float inv_l = 1.f / l;
#pragma unroll
    for (int j = 0; j < kDimsPerLane; ++j) {
      o[base + (size_t)row * D + sub + j * TPR] = from_f32<T>(acc[j] * inv_l);
    }
    if (lse != nullptr && sub == 0) {
      // back from log2 to natural units: lse = ln(2) * (m + log2(l))
      lse[(size_t)bh * t_len + row] = 0.69314718055994531f * (m + log2f(l));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int bh, int t, float sm_scale, cudaStream_t stream) {
  constexpr int ROWS = kThreads / (D / kDimsPerLane);
  const dim3 grid((t + ROWS - 1) / ROWS, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), t, sm_scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, void* lse,
                       int bh, int t, int d, float sm_scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, t, sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, t, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, t, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, t, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse may be null. Returns the launch's
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported d or dtype).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int bh, int t, int d, int dtype,
                                   float sm_scale, void* stream) {
  if (bh <= 0 || bh > 65535 || t <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(q, k, v, o, lse, bh, t, d, sm_scale, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, t, d, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
