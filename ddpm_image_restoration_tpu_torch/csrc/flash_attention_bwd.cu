// Flash-attention backward for Hopper (sm_90a), over [BH, T, D] row-major.
//
// Replaces the two Pallas TPU kernels launched by `_flash_bhtd_bwd` (the JAX
// package's ops/pallas/flash_attention.py:304): `_bwd_dq_kernel` (:207) and
// `_bwd_dkv_kernel` (:247). With S = scale*Q*K^T, P = exp(S - LSE) and
// Delta = rowsum(dO o O):
//
//   dQ = scale * (P o (dO*V^T - Delta)) * K          flash_bwd_dq_kernel
//   dV = P^T * dO,  dK = scale * dS^T * Q            flash_bwd_dkv_kernel
//
// LSE is the forward kernel's [BH, T] f32 log-sum-exp in natural units
// (csrc/flash_attention_fwd.cu stores ln2 * (m + log2 l) with m in log2
// units); both kernels multiply it by log2(e) and evaluate P as
// exp2(scale*log2(e) * q.k - LSE*log2(e)), the forward's own exp2 form.
// scale = 1/sqrt(real head dim), passed in by the wrapper, never taken from
// the padded D.
//
// The TPU grid runs in order on one core and carries the dQ (or dK/dV) sum
// in scratch across the inner grid axis. Here blocks run in parallel and in
// no order, so the inner axis becomes a loop inside the block: dQ takes one
// block per (bh, query tile) looping over key tiles, dK/dV one block per
// (bh, key tile) looping over query tiles. No atomics: every output element
// is written by one thread, once, and results are deterministic. Delta is
// computed by the dQ kernel (whose threads hold a whole dO row and O row)
// and written to a [BH, T] f32 buffer that the dK/dV kernel, launched after
// it on the same stream, reads; so there is no separate pre-pass.
//
// What bounds it on the H100: dQ does 6*T*D and dK/dV 8*T*D flops per query
// row against ~6*D*elt bytes per row, so at T = 1024 both are compute bound.
// Like the forward, this first version does the products on the CUDA cores
// in f32 FMA (67 TFLOP/s ceiling), not on the tensor cores; mma/wgmma is
// later work. Layout, as in the forward: each row owned by a block is split
// over TPR = D/8 adjacent lanes that each hold 8 interleaved dims (so the
// lanes of one row read different shared-memory banks); dot products are
// the xor-shuffle sum of the lanes' partials; the streamed operand tiles sit
// in shared memory converted to f32 once; 16 partner rows are processed per
// chunk so that their shuffles and exp2s overlap.
//
// Build (plain C interface, no PyTorch headers; loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDimsPerLane = 8;
constexpr int kChunk = 16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D> struct Tile {
  static constexpr int TPR = D / kDimsPerLane;   // lanes per owned row
  static constexpr int ROWS = kThreads / TPR;    // owned rows per block
  static constexpr int BN = D >= 128 ? 32 : 64;  // streamed rows per shared tile
};

// Loads rows [r0, r0 + BN) of a [T, D] slab into a f32 shared tile, zeros
// past n_valid.
template <typename T, int D, int BN>
__device__ __forceinline__ void load_tile(float (*dst)[D], const T* __restrict__ src,
                                          int n_valid) {
  for (int i = threadIdx.x; i < BN * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r][c] = r < n_valid ? to_f32(src[(size_t)r * D + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    T* __restrict__ dq, float* __restrict__ delta, int t_len,
                    float scale, float scale_log2) {
  constexpr int TPR = Tile<D>::TPR, ROWS = Tile<D>::ROWS, BN = Tile<D>::BN;
  __shared__ float k_s[BN][D];
  __shared__ float v_s[BN][D];

  const int bh = blockIdx.y;
  const int sub = threadIdx.x % TPR;
  const int row = blockIdx.x * ROWS + threadIdx.x / TPR;
  const bool row_ok = row < t_len;
  const size_t base = (size_t)bh * t_len * D;
  const size_t row_base = base + (size_t)(row_ok ? row : 0) * D;

  float qr[kDimsPerLane], dor[kDimsPerLane], acc[kDimsPerLane];
  float dsum = 0.f;
#pragma unroll
  for (int e = 0; e < kDimsPerLane; ++e) {
    const int d = sub + e * TPR;
    qr[e] = row_ok ? to_f32(q[row_base + d]) * scale_log2 : 0.f;
    dor[e] = row_ok ? to_f32(dout[row_base + d]) : 0.f;
    dsum = fmaf(dor[e], row_ok ? to_f32(o[row_base + d]) : 0.f, dsum);
    acc[e] = 0.f;
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
  const size_t stat = (size_t)bh * t_len + row;
  const float lse_log2 = row_ok ? lse[stat] * kLog2e : 0.f;
  if (row_ok && sub == 0) delta[stat] = dsum;

  for (int k0 = 0; k0 < t_len; k0 += BN) {
    const int n_valid = min(BN, t_len - k0);
    __syncthreads();  // previous tile fully consumed
    load_tile<T, D, BN>(k_s, k + base + (size_t)k0 * D, n_valid);
    load_tile<T, D, BN>(v_s, v + base + (size_t)k0 * D, n_valid);
    __syncthreads();

    for (int c0 = 0; c0 < n_valid; c0 += kChunk) {
      float s[kChunk], dp[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int e = 0; e < kDimsPerLane; ++e) {
          a = fmaf(qr[e], k_s[c0 + j][sub + e * TPR], a);
          b = fmaf(dor[e], v_s[c0 + j][sub + e * TPR], b);
        }
        s[j] = a;
        dp[j] = b;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
          dp[j] += __shfl_xor_sync(0xffffffffu, dp[j], off);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = (row_ok && c0 + j < n_valid) ? exp2f(s[j] - lse_log2) : 0.f;
        const float ds = p * (dp[j] - dsum);
#pragma unroll
        for (int e = 0; e < kDimsPerLane; ++e) acc[e] = fmaf(ds, k_s[c0 + j][sub + e * TPR], acc[e]);
      }
    }
  }

  if (row_ok) {
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) dq[row_base + sub + e * TPR] = from_f32<T>(acc[e] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int t_len, float scale,
                     float scale_log2) {
  constexpr int TPR = Tile<D>::TPR, ROWS = Tile<D>::ROWS, BN = Tile<D>::BN;
  __shared__ float q_s[BN][D];
  __shared__ float do_s[BN][D];
  __shared__ float lse_s[BN];    // log2 units
  __shared__ float delta_s[BN];

  const int bh = blockIdx.y;
  const int sub = threadIdx.x % TPR;
  const int row = blockIdx.x * ROWS + threadIdx.x / TPR;  // key row
  const bool row_ok = row < t_len;
  const size_t base = (size_t)bh * t_len * D;
  const size_t row_base = base + (size_t)(row_ok ? row : 0) * D;
  const size_t stat_base = (size_t)bh * t_len;

  float kr[kDimsPerLane], vr[kDimsPerLane], dk_acc[kDimsPerLane], dv_acc[kDimsPerLane];
#pragma unroll
  for (int e = 0; e < kDimsPerLane; ++e) {
    const int d = sub + e * TPR;
    kr[e] = row_ok ? to_f32(k[row_base + d]) * scale_log2 : 0.f;
    vr[e] = row_ok ? to_f32(v[row_base + d]) : 0.f;
    dk_acc[e] = 0.f;
    dv_acc[e] = 0.f;
  }

  for (int q0 = 0; q0 < t_len; q0 += BN) {
    const int n_valid = min(BN, t_len - q0);
    __syncthreads();  // previous tile fully consumed
    load_tile<T, D, BN>(q_s, q + base + (size_t)q0 * D, n_valid);
    load_tile<T, D, BN>(do_s, dout + base + (size_t)q0 * D, n_valid);
    for (int i = threadIdx.x; i < BN; i += kThreads) {
      const bool ok = i < n_valid;
      lse_s[i] = ok ? lse[stat_base + q0 + i] * kLog2e : 0.f;
      delta_s[i] = ok ? delta[stat_base + q0 + i] : 0.f;
    }
    __syncthreads();

    for (int c0 = 0; c0 < n_valid; c0 += kChunk) {
      float s[kChunk], dp[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int e = 0; e < kDimsPerLane; ++e) {
          a = fmaf(kr[e], q_s[c0 + j][sub + e * TPR], a);
          b = fmaf(vr[e], do_s[c0 + j][sub + e * TPR], b);
        }
        s[j] = a;
        dp[j] = b;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
          dp[j] += __shfl_xor_sync(0xffffffffu, dp[j], off);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int i = c0 + j;
        const float p = (row_ok && i < n_valid) ? exp2f(s[j] - lse_s[i]) : 0.f;
        const float ds = p * (dp[j] - delta_s[i]);
#pragma unroll
        for (int e = 0; e < kDimsPerLane; ++e) {
          dv_acc[e] = fmaf(p, do_s[i][sub + e * TPR], dv_acc[e]);
          dk_acc[e] = fmaf(ds, q_s[i][sub + e * TPR], dk_acc[e]);
        }
      }
    }
  }

  if (row_ok) {
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) {
      dk[row_base + sub + e * TPR] = from_f32<T>(dk_acc[e] * scale);
      dv[row_base + sub + e * TPR] = from_f32<T>(dv_acc[e]);
    }
  }
}

template <int D> dim3 grid_for(int bh, int t) {
  return dim3((t + Tile<D>::ROWS - 1) / Tile<D>::ROWS, bh);
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* dq, void* delta, int bh,
                      int t, float scale, cudaStream_t stream) {
  flash_bwd_dq_kernel<T, D><<<grid_for<D>(bh, t), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<T*>(dq), static_cast<float*>(delta), t,
      scale, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh,
                       int t, float scale, cudaStream_t stream) {
  flash_bwd_dkv_kernel<T, D><<<grid_for<D>(bh, t), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), t,
      scale, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dq_dispatch(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* dq, void* delta, int bh,
                        int t, int d, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch_dq<T, 16>(q, k, v, o, dout, lse, dq, delta, bh, t, scale, s);
    case 32: return launch_dq<T, 32>(q, k, v, o, dout, lse, dq, delta, bh, t, scale, s);
    case 64: return launch_dq<T, 64>(q, k, v, o, dout, lse, dq, delta, bh, t, scale, s);
    case 128: return launch_dq<T, 128>(q, k, v, o, dout, lse, dq, delta, bh, t, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dkv_dispatch(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int bh,
                         int t, int d, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch_dkv<T, 16>(q, k, v, dout, lse, delta, dk, dv, bh, t, scale, s);
    case 32: return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, bh, t, scale, s);
    case 64: return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, t, scale, s);
    case 128: return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, bh, t, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dQ and Delta = rowsum(dO o O) from q, k, v, o, dO ([BH, T, d], dtype 0 =
// float32, 1 = bfloat16) and the forward's [BH, T] f32 LSE. dq has q's
// dtype; delta is [BH, T] f32. Returns the launch's cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported d, dtype or size).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse,
                                      void* dq, void* delta, int bh, int t, int d, int dtype,
                                      float sm_scale, void* stream) {
  if (bh <= 0 || bh > 65535 || t <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dq_dispatch<float>(q, k, v, o, dout, lse, dq, delta, bh, t, d, sm_scale, s);
  if (dtype == 1)
    return (int)dq_dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, dq, delta, bh, t, d, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

// dK and dV from q, k, v, dO, the LSE and the Delta that
// flash_attention_bwd_dq wrote (launch this after it on the same stream).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int t, int d, int dtype,
                                       float sm_scale, void* stream) {
  if (bh <= 0 || bh > 65535 || t <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dkv_dispatch<float>(q, k, v, dout, lse, delta, dk, dv, bh, t, d, sm_scale, s);
  if (dtype == 1)
    return (int)dkv_dispatch<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh, t, d, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
